// What the f32 decode (fused_query.cu) and the bf16 decode
// (fused_query_bf16.cu) share: the activation, picked by an int code in the
// order of space_time_pde_torch/models/nonlinearities.py::NONLINEARITIES.

#pragma once

#include <math.h>

namespace {

__device__ __forceinline__ float activate(float x, int code, float ns) {
  switch (code) {
    case 0: return fmaxf(x, 0.f);                                 // relu
    case 1: return x >= 0.f ? x : ns * x;                         // leaky_relu
    case 2: return x > 0.f ? x : expm1f(x);                       // elu
    case 3: {                                                     // gelu
      const float c = 0.7978845608028654f;                        // sqrt(2/pi)
      return x * (0.5f * (1.f + tanhf(c * (x + 0.044715f * (x * x * x)))));
    }
    case 4:                                                       // silu
    case 5: return x * (1.f / (1.f + expf(-x)));                  // swish
    case 6: return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));       // softplus
    case 7: return tanhf(x);
    case 8: return 1.f / (1.f + expf(-x));                        // sigmoid
    default: return sinf(x);                                      // sin (9)
  }
}

}  // namespace
