// Fused local-implicit-grid decode + multilinear blend for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// space_time_pde_tpu/ops/fused_query.py:
//   _kernel_gather (fused_decode_blend_gather) -> stpde_decode_blend_gather
//   _kernel        (fused_decode_blend)        -> stpde_decode_blend
// They compute the same thing and differ only in where a point's 2^D corner
// latents come from: an indexed load of row cell_flat[p] of the cell-major
// table [n_cells, 2^D * C], or pre-gathered rows [N * 2^D, C].
//
// Per point, per corner k (row r = p * 2^D + k of a block):
//   layer i pre-activation = h_{i-1} @ Wh_i + feats @ Wx_feat[:, sl_i]
//                            + frac @ Wx_rel[:, sl_i] + corner_bias[k, sl_i]
//   h_i = act(pre), widths nf * (16, 8, 4, 2, 1)
// The coordinate projection is factored through corner_bias
// (rel_k = frac - offset_k, folded on the host by pack_imnet_params), the
// multilinear weights come from frac in the kernel, and the blend runs
// BEFORE the linear head (weights sum to 1):
//   out[p] = (sum_k w_k h_4[p, k]) @ W5 + b5.
// f32 operands, f32 accumulation. The activation is picked by an int code in
// the order of space_time_pde_torch/models/nonlinearities.py::NONLINEARITIES.
//
// What bounds it on an H100: arithmetic. At the flagship widths (C = 64,
// nf = 64, D = 3) a point costs 8 corners x ~0.82 M multiply-adds
// (13.2 MFLOP), against ~2.5 KB of input, so the kernel sits far above the
// memory roofline; the ImNet weights (3.3 MB f32) stay in L2 and are streamed
// by every block. The design keeps all activations on chip: a block owns
// kRows = 32 corner rows (32 / 2^D points) and holds two ping-pong activation
// buffers in shared memory, [16 nf] and [8 nf] columns of 32 rows (196 KB at
// nf = 64, hence the dynamic-shared-memory attribute), plus the block's
// latents. Each layer's skip term is computed when that layer runs, so the
// TPU kernel's [R, 31 nf] skip buffer is never stored. 256 threads each own
// an 8-row x 4-column register tile; activations are stored column-major so a
// thread reads its 8 rows with two 16-byte shared loads (warp-wide
// broadcasts), and weight columns are read by a warp as 128-byte coalesced
// loads that the block's other row groups then hit in L1. (A 4 x 8 tile,
// 12 loads per 32 multiply-adds, took 78.7 ms per 65,536 flagship points on
// an H100 80GB HBM3 at 700 W; this 8 x 4 tile 58.1 ms, cuBLAS-backed plain
// PyTorch 31.5 ms.)
//
// TPU workarounds deliberately NOT carried over: the one-hot MXU gather and
// the sorted 2 x 128-cell windows (corner_tables, window anchors, base_tile,
// the fits-check and its lax.cond fallback) -- a Hopper thread just loads
// the row; _augmented_xs/_augment_params and the 8-lane frac padding
// (_FRAC_LANES); 128-lane width padding (pad_to); keeping the whole MLP and
// the [R, 31 nf] skip buffer resident in VMEM. No wgmma, TMA or bf16 yet.
//
// A cell id outside [0, n_cells) decodes NaN instead of reading out of
// bounds. Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (space_time_pde_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 32;                        // corner rows per block
constexpr int kRowsPerThread = 8;               // a multiple of 4
constexpr int kLanes = 64;                       // threads along columns
constexpr int kColsPerThread = 4;
constexpr int kTileCols = kLanes * kColsPerThread;          // 256
constexpr int kThreads = (kRows / kRowsPerThread) * kLanes;  // 256

struct Weights {
  const float* wx_feat;      // [C, S], S = 31 nf
  const float* wx_rel;       // [D, S]
  const float* corner_bias;  // [2^D, S]
  const float* wh[4];        // wh_i: [nf * 2^(5-i), nf * 2^(4-i)]
  const float* w5;           // [nf, out]
  const float* b5;           // [out]
};

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

// acc[j][q] += sum_i a[i][row0 + j] * w[i * ldw + col_q] for i < k_in, with
// `a` column-major [k_in][kRows] in shared memory and col_q = tx + kLanes q.
__device__ __forceinline__ void accumulate(
    float (&acc)[kRowsPerThread][kColsPerThread], const float* a, int k_in,
    const float* __restrict__ w, int ldw, int row0, int tx,
    const bool (&valid)[kColsPerThread]) {
#pragma unroll 4
  for (int i = 0; i < k_in; ++i) {
    float av[kRowsPerThread];
#pragma unroll
    for (int v = 0; v < kRowsPerThread; v += 4) {
      const float4 t =
          *reinterpret_cast<const float4*>(a + i * kRows + row0 + v);
      av[v] = t.x, av[v + 1] = t.y, av[v + 2] = t.z, av[v + 3] = t.w;
    }
    const float* wrow = w + (size_t)i * ldw + tx;
    float b[kColsPerThread];
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q)
      b[q] = valid[q] ? __ldg(wrow + q * kLanes) : 0.f;
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q)
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) acc[j][q] += av[j] * b[q];
  }
}

template <bool kGather>
__global__ void __launch_bounds__(kThreads)
decode_blend_kernel(const float* __restrict__ src,      // table or feats2
                    const int* __restrict__ cell_flat,  // gather only
                    const float* __restrict__ frac,     // [N, D]
                    Weights wt, float* __restrict__ out, int n, int n_cells,
                    int c, int dim, int nf, int out_dim, int act_code,
                    float ns) {
  extern __shared__ __align__(16) float smem[];
  const int n_corners = 1 << dim;
  const int ppb = kRows / n_corners;           // points per block
  const int s_tot = 31 * nf;
  float* buf_a = smem;                         // [16 nf][kRows]
  float* buf_b = buf_a + 16 * nf * kRows;      // [8 nf][kRows]
  float* feats = buf_b + 8 * nf * kRows;       // [C][kRows]
  float* fr = feats + c * kRows;               // [ppb][D]

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * ppb;

  for (int i = tid; i < ppb * dim; i += kThreads) {
    const int gp = p0 + i / dim;
    fr[i] = gp < n ? frac[(size_t)p0 * dim + i] : 0.f;
  }
  for (int i = tid; i < kRows * c; i += kThreads) {
    const int r = i / c, ch = i - r * c;
    const int pp = r / n_corners, k = r - pp * n_corners;
    const int gp = p0 + pp;
    float v = 0.f;
    if (gp < n) {
      if (kGather) {
        const int cell = cell_flat[gp];
        v = (cell >= 0 && cell < n_cells)
                ? src[((size_t)cell * n_corners + k) * c + ch]
                : __int_as_float(0x7fc00000);  // NaN
      } else {
        v = src[((size_t)gp * n_corners + k) * c + ch];
      }
    }
    feats[ch * kRows + r] = v;
  }
  __syncthreads();

  const int tx = tid % kLanes;
  const int row0 = (tid / kLanes) * kRowsPerThread;
  int pt[kRowsPerThread], corner[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    pt[j] = (row0 + j) / n_corners;
    corner[j] = (row0 + j) - pt[j] * n_corners;
  }

  const float* in = nullptr;
  float* dst = buf_a;
  int off = 0;
  for (int layer = 0; layer < 5; ++layer) {
    const int width = nf << (4 - layer);
    for (int col0 = 0; col0 < width; col0 += kTileCols) {
      bool valid[kColsPerThread];
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q)
        valid[q] = col0 + tx + q * kLanes < width;
      float acc[kRowsPerThread][kColsPerThread] = {};
      // Skip term of this layer: latent rows, coordinate rows, corner bias.
      accumulate(acc, feats, c, wt.wx_feat + off + col0, s_tot, row0, tx,
                 valid);
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) {
        if (!valid[q]) continue;
        const int col = off + col0 + tx + q * kLanes;
        for (int d = 0; d < dim; ++d) {
          const float wr = __ldg(wt.wx_rel + (size_t)d * s_tot + col);
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j)
            acc[j][q] += fr[pt[j] * dim + d] * wr;
        }
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j)
          acc[j][q] += __ldg(wt.corner_bias + (size_t)corner[j] * s_tot + col);
      }
      if (layer > 0)
        accumulate(acc, in, width << 1, wt.wh[layer - 1] + col0, width, row0,
                   tx, valid);
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) {
        if (!valid[q]) continue;
        const int col = col0 + tx + q * kLanes;
#pragma unroll
        for (int v = 0; v < kRowsPerThread; v += 4)
          *reinterpret_cast<float4*>(dst + col * kRows + row0 + v) =
              make_float4(activate(acc[v][q], act_code, ns),
                          activate(acc[v + 1][q], act_code, ns),
                          activate(acc[v + 2][q], act_code, ns),
                          activate(acc[v + 3][q], act_code, ns));
      }
    }
    __syncthreads();
    in = dst;
    dst = dst == buf_a ? buf_b : buf_a;
    off += width;
  }
  // h_4 is in buf_a ([nf][kRows]); blend the corners into buf_b ([ppb][nf]).
  for (int i = tid; i < ppb * nf; i += kThreads) {
    const int pp = i / nf, j = i - pp * nf;
    float s = 0.f;
    for (int k = 0; k < n_corners; ++k) {
      float w = 1.f;
      for (int d = 0; d < dim; ++d) {
        const float f = fr[pp * dim + d];
        w *= ((k >> (dim - 1 - d)) & 1) ? f : 1.f - f;
      }
      s += buf_a[j * kRows + pp * n_corners + k] * w;
    }
    buf_b[pp * nf + j] = s;
  }
  __syncthreads();
  for (int i = tid; i < ppb * out_dim; i += kThreads) {
    const int pp = i / out_dim, o = i - pp * out_dim;
    const int gp = p0 + pp;
    if (gp >= n) continue;
    float s = 0.f;
    for (int j = 0; j < nf; ++j)
      s += buf_b[pp * nf + j] * __ldg(wt.w5 + j * out_dim + o);
    out[(size_t)gp * out_dim + o] = s + __ldg(wt.b5 + o);
  }
}

template <bool kGather>
int launch(const float* src, const int* cell_flat, const float* frac,
           const Weights& wt, float* out, int n, int n_cells, int c, int dim,
           int nf, int out_dim, int act_code, float ns, void* stream) {
  if (n <= 0) return 0;
  if (dim < 1 || (1 << dim) > kRows) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)(24 * nf + c) * kRows + (kRows >> dim) * dim);
  cudaError_t e = cudaFuncSetAttribute(
      decode_blend_kernel<kGather>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int ppb = kRows >> dim;
  const unsigned blocks = (unsigned)((n + ppb - 1) / ppb);
  decode_blend_kernel<kGather><<<blocks, kThreads, smem,
                                 (cudaStream_t)stream>>>(
      src, cell_flat, frac, wt, out, n, n_cells, c, dim, nf, out_dim,
      act_code, ns);
  return (int)cudaGetLastError();
}

Weights pack(const float* wx_feat, const float* wx_rel,
             const float* corner_bias, const float* wh1, const float* wh2,
             const float* wh3, const float* wh4, const float* w5,
             const float* b5) {
  return Weights{wx_feat, wx_rel, corner_bias, {wh1, wh2, wh3, wh4}, w5, b5};
}

}  // namespace

extern "C" {

int stpde_decode_blend_gather(
    const float* table, const int* cell_flat, const float* frac,
    const float* wx_feat, const float* wx_rel, const float* corner_bias,
    const float* wh1, const float* wh2, const float* wh3, const float* wh4,
    const float* w5, const float* b5, float* out, int n, int n_cells, int c,
    int dim, int nf, int out_dim, int act_code, float negative_slope,
    void* stream) {
  return launch<true>(table, cell_flat, frac,
                      pack(wx_feat, wx_rel, corner_bias, wh1, wh2, wh3, wh4,
                           w5, b5),
                      out, n, n_cells, c, dim, nf, out_dim, act_code,
                      negative_slope, stream);
}

int stpde_decode_blend(
    const float* feats2, const float* frac, const float* wx_feat,
    const float* wx_rel, const float* corner_bias, const float* wh1,
    const float* wh2, const float* wh3, const float* wh4, const float* w5,
    const float* b5, float* out, int n, int c, int dim, int nf, int out_dim,
    int act_code, float negative_slope, void* stream) {
  return launch<false>(feats2, nullptr, frac,
                       pack(wx_feat, wx_rel, corner_bias, wh1, wh2, wh3, wh4,
                            w5, b5),
                       out, n, 0, c, dim, nf, out_dim, act_code,
                       negative_slope, stream);
}

// Corner rows a block decodes (points per block = this >> D); the launch
// sizes its dynamic shared memory from it and returns the CUDA error when
// nf and C need more than the card has.
int stpde_block_rows(void) { return kRows; }

const char* stpde_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
