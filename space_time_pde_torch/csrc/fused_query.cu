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
// The activation is picked by an int code in the order of
// space_time_pde_torch/models/nonlinearities.py::NONLINEARITIES.
//
// What bounds it on an H100: arithmetic. At the flagship widths (C = 64,
// nf = 64) a corner row costs ~0.83 M multiply-adds against ~2.5 KB of
// input a point, far above the memory roofline: 12.98 ms per 65,536 points
// at D = 3 in f32 FFMA (67 TFLOP/s), which the previous, FFMA version of
// this kernel reached at 22% (58.1 ms).
//
// Route: 3xTF32 on the tensor cores (mma.sync.m16n8k8). Every operand x is
// split in registers into hi = tf32_rna(x) and lo = x - hi (rounded to TF32
// for activations; for weights passed as is, the tensor cores read its top
// bits), and a product is lo_a hi_b + hi_a lo_b + hi_a hi_b. Each k8 step's
// three products accumulate in a zeroed temporary that is added to the f32
// accumulator with round-to-nearest (mma3). That makes the products
// f32-grade (the flagship model's latents reach 1e6, so plain TF32, ~3e-3
// of max |out| from float64, is not an option) at 3x the TF32 work: a bound
// of 5.27 ms per 65,536 points at D = 3 and 10.57 ms at D = 4 (495 TFLOP/s
// dense TF32). Shared memory holds f32 values or their split planes.
//
// Block: 64 corner rows (8 points at D = 3, 4 at D = 4), 512 threads = 16
// warps, 2 along rows x 8 along columns, each warp a 32-row x (width / 8)
// column accumulator tile in registers (64 floats a thread in layer 1). A
// layer's output lives in registers until its K loop ends and then
// overwrites the one activation buffer H [64][8 nf + 4], so only h_1 and
// narrower are ever resident: layer 0 (16 nf wide) is fused into layer 1's
// K loop. A 32-column chunk of h_0 is computed on the tensor cores from the
// latents, activated, split once into hi and lo planes, and read as layer
// 1's A operand in the next K step, while the block computes the chunk
// after it (two chunk buffers, one barrier a step). Each layer's skip term
// is part of its K loop: the kernel's weight matrix of layer i is
// [Wh_i ; Wx_feat[:, sl_i]] (kernel_weights in ops/fused_query.py stacks
// and zero-pads it), and A runs over [h_{i-1} | latents]; the coordinate
// term and the corner bias are added in f32 in the epilogue. Weights are
// staged in 32-row tiles by cp.async into a double buffer (no weight loads
// from global memory in the inner loop; layer 0's chunks two steps ahead):
// layer 1's tiles use H's space while h_1 is still in registers. Row
// strides are padded (+4 for A, +8 for B) so every fragment load is free of
// bank conflicts. Widths are padded to multiples of 64 and C to a multiple
// of 32 (zero weights), which the kernel derives from nf and C. Shared
// memory at C = 64, nf = 64: 218,368 bytes, one block per SM; ptxas: 128
// registers a thread (65,536 a block, the whole register file), 4 bytes of
// spill. The blend spreads the point x column products over the block and
// the head gives one warp to each output (shuffle reduction).
//
// On an NVIDIA H100 80GB HBM3 at 700 W, 65,536 flagship points: 29.5 ms at
// D = 3 (the cuBLAS-backed plain twin 31.1 ms), 59.2 ms at D = 4 (twin
// 61.7 ms): 18% of the 3xTF32 bound, the TF32 work at ~88 of 495
// TFLOP/s, so the tensor cores are idle most of the time. What holds it
// back: the register file. Accumulating 3 x 136
// products into one tensor-core accumulator instead of a temporary drifted
// 20x farther from float64 than f32 FFMA, and the temporary leaves no
// registers to keep more than one k8 step in flight; wgmma with its
// accumulator promoted every few steps needs a second accumulator set that
// does not fit beside the first at this tile.
//
// Limits: 8 nf rounded up to 64 must be at most 512 and the buffers must fit
// the card's 227 KB: at C <= 96, nf <= 64 decodes and nf = 65 does not; at
// nf = 64, C <= 96 decodes and C = 97 does not. A shape beyond them returns
// the CUDA error of the refused attribute (cudaErrorInvalidValue).
//
// TPU workarounds deliberately NOT carried over: the one-hot MXU gather and
// the sorted 2 x 128-cell windows (corner_tables, window anchors, base_tile,
// the fits-check and its lax.cond fallback) -- a Hopper thread just loads
// the row; _augmented_xs/_augment_params and the 8-lane frac padding
// (_FRAC_LANES); 128-lane width padding (pad_to); keeping the whole MLP and
// the [R, 31 nf] skip buffer resident in VMEM. No wgmma or TMA yet.
//
// A cell id outside [0, n_cells) decodes NaN instead of reading out of
// bounds. Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (space_time_pde_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;          // corner rows per block
constexpr int kThreads = 512;      // 16 warps: 2 along rows x 8 along columns
constexpr int kWarpsN = 8;
constexpr int kKc = 32;            // weight rows per staged tile
constexpr int kMaxNt = 8;          // 8-column MMA tiles per warp
constexpr int kWidthAlign = 8 * kWarpsN;    // 64
constexpr int kLdH0 = kKc + 4;     // h_0 chunk [kRows][kLdH0]
constexpr int kLdW0 = kKc + 8;     // layer 0 weight chunk [Cp][kLdW0]

struct Weights {
  const float* wx0;     // [Cp, W0]: Wx_feat[:, sl_0]
  const float* rel;     // [D, Sp]: Wx_rel, each layer's columns padded
  const float* cb;      // [2^D, Sp]: corner_bias, likewise
  const float* wb[4];   // layer i + 1: [W_i + Cp, W_{i+1}] = [Wh ; Wx_feat]
  const float* w5;      // [nf, out]
  const float* b5;      // [out]
};

// Padded sizes and the shared-memory plan (in floats); R1 starts at 0.
struct Shape {
  int c, cp, dim, nf, out_dim;
  int w[5];     // layer widths, padded to kWidthAlign
  int off[5];   // each layer's first column in rel / cb
  int sp;       // sum of w
  int ldh;      // row stride of H
  int r2, f, fr, total;
};

int round_up(int x, int m) { return (x + m - 1) / m * m; }
int imax(int a, int b) { return a > b ? a : b; }

Shape make_shape(int c, int dim, int nf, int out_dim) {
  Shape s{};
  s.c = c, s.cp = round_up(c, kKc), s.dim = dim, s.nf = nf;
  s.out_dim = out_dim;
  for (int i = 0, off = 0; i < 5; ++i) {
    s.w[i] = round_up(nf << (4 - i), kWidthAlign);
    s.off[i] = off;
    off += s.w[i];
    s.sp = off;
  }
  s.ldh = s.w[1] + 4;
  // R1: H, or layer 1's two weight tiles. R2: layers 2-4's two weight
  // tiles, or layer 0's two weight chunks and two split h_0 chunks.
  const int r1 = imax(kRows * s.ldh, 2 * kKc * (s.w[1] + 8));
  const int r2 = imax(2 * kKc * (s.w[2] + 8),
                      2 * s.cp * kLdW0 + 4 * kRows * kLdH0);
  s.r2 = r1;
  s.f = r1 + r2;
  s.fr = s.f + kRows * (s.cp + 4);
  s.total = s.fr + kRows;
  return s;
}

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

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b for one k8 step in 3xTF32. The three products (the two small
// ones first) accumulate in a zeroed temporary, which is then added to d
// in f32 with round-to-nearest: the tensor cores' own accumulation
// truncates, and fed d itself at every step it drifted 20x farther from
// float64 than f32 FFMA (measured on an H100).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma(p, al, bh[0], bh[1]);
  mma(p, ah, bl[0], bl[1]);
  mma(p, ah, bh[0], bh[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += p[e];
}

// The m16 x k8 A fragment at (row0, k0) of a row-major [*, ld] tile, split.
__device__ __forceinline__ void load_a(const float* a, int ld, int row0,
                                       int k0, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* p = a + (row0 + g) * ld + k0 + t;
  split(p[0], hi[0], lo[0]);
  split(p[8 * ld], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * ld + 4], hi[3], lo[3]);
}

// The A fragment of a tile stored already split: hi and lo planes.
__device__ __forceinline__ void load_a_split(const float* hp,
                                             const float* lp, int ld,
                                             int row0, int k0, int g, int t,
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  const int o = (row0 + g) * ld + k0 + t;
  const int os[4] = {o, o + 8 * ld, o + 4, o + 8 * ld + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = __float_as_uint(hp[os[i]]);
    lo[i] = __float_as_uint(lp[os[i]]);
  }
}

// The k8 x n8 B fragment at (k0, n0) of a row-major [K][ld] tile, split.
// The weights' low part is passed unrounded (the tensor cores read its
// top 10 mantissa bits): one conversion fewer per element, and no
// measurable loss against float64 on an H100.
__device__ __forceinline__ void load_b(const float* b, int ld, int k0,
                                       int n0, int g, int t,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float* p = b + (k0 + t) * ld + n0 + g;
  const float x[2] = {p[0], p[4 * ld]};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    hi[i] = tf32(x[i]);
    lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i]));
  }
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [k0, k0 + kKc) of a row-major [*, w] matrix -> dst [kKc][w + 8].
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int k0, int w) {
  const int q = w >> 2;
  for (int i = threadIdx.x; i < kKc * q; i += kThreads) {
    const int r = i / q, c4 = i - r * q;
    cp16(dst + r * (w + 8) + 4 * c4, src + (size_t)(k0 + r) * w + 4 * c4);
  }
}

// Columns [c0, c0 + kKc) of a row-major [rows, w] matrix -> dst
// [rows][kLdW0].
__device__ __forceinline__ void stage_cols(float* dst, const float* src,
                                           int rows, int c0, int w) {
  for (int i = threadIdx.x; i < rows * (kKc / 4); i += kThreads) {
    const int r = i >> 3, c4 = i & 7;
    cp16(dst + r * kLdW0 + 4 * c4, src + (size_t)r * w + c0 + 4 * c4);
  }
}

// What the f32 and bf16 instantiations share: the block's frac and corner
// latents in shared memory, the corner blend and the head. T is the
// element type of the table (or rows) and of the head's weights.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float nan_f32() {
  return __int_as_float(0x7fc00000);
}

// The block's frac [ppb][D], 0 past point n.
__device__ __forceinline__ void stage_frac(float* fr, const float* frac,
                                           int p0, int n, int dim) {
  const int ppb = kRows >> dim;
  for (int i = threadIdx.x; i < ppb * dim; i += kThreads) {
    const int gp = p0 + i / dim;
    fr[i] = gp < n ? frac[(size_t)p0 * dim + i] : 0.f;
  }
}

// The block's corner latents -> feats [kRows][ldf]: row r is corner
// r & (2^D - 1) of point p0 + (r >> D), from row cell_flat[p] of the
// cell-major table (kGather; NaN for a cell outside [0, n_cells)) or from
// the pre-gathered rows; 0 past point n and in the padding columns.
template <typename T, bool kGather>
__device__ __forceinline__ void stage_feats(T* feats, int ldf, const T* src,
                                            const int* cell_flat, int p0,
                                            int n, int n_cells, int c, int cp,
                                            int dim) {
  const int n_corners = 1 << dim;
  for (int i = threadIdx.x; i < kRows * cp; i += kThreads) {
    const int r = i / cp, ch = i - r * cp;
    const int gp = p0 + (r >> dim), k = r & (n_corners - 1);
    T v = from_f32<T>(0.f);
    if (gp < n && ch < c) {
      if (kGather) {
        const int cell = cell_flat[gp];
        v = (cell >= 0 && cell < n_cells)
                ? src[((size_t)cell * n_corners + k) * c + ch]
                : from_f32<T>(nan_f32());
      } else {
        v = src[((size_t)gp * n_corners + k) * c + ch];
      }
    }
    feats[r * ldf + ch] = v;
  }
}

// The last layer's f32 h [kRows][ldh] blended over the corners with the
// multilinear weights of fr -> hb [ppb][nf], rounded to T (the head's
// operand type).
template <typename T>
__device__ __forceinline__ void blend_corners(float* hb, const float* h,
                                              int ldh, const float* fr,
                                              int nf, int dim) {
  const int n_corners = 1 << dim, ppb = kRows >> dim;
  for (int i = threadIdx.x; i < ppb * nf; i += kThreads) {
    const int pp = i / nf, j = i - pp * nf;
    float v = 0.f;
    for (int k = 0; k < n_corners; ++k) {
      float w = 1.f;
      for (int d = 0; d < dim; ++d) {
        const float f = fr[pp * dim + d];
        w *= ((k >> (dim - 1 - d)) & 1) ? f : 1.f - f;
      }
      v += h[(pp * n_corners + k) * ldh + j] * w;
    }
    hb[i] = to_f32(from_f32<T>(v));
  }
}

// The head, out[p] = hb[p] @ w5 + b5: one warp per (point, output), lanes
// over nf, f32 sums, b5 f32.
template <typename T>
__device__ __forceinline__ void head(float* out, const float* hb,
                                     const T* w5, const float* b5, int p0,
                                     int n, int nf, int out_dim, int dim) {
  const int ppb = kRows >> dim;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < ppb * out_dim; i += kThreads / 32) {
    const int pp = i / out_dim, o = i - pp * out_dim;
    float v = 0.f;
    for (int j = lane; j < nf; j += 32)
      v += hb[pp * nf + j] * to_f32(__ldg(w5 + (size_t)j * out_dim + o));
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    const int gp = p0 + pp;
    if (lane == 0 && gp < n) out[(size_t)gp * out_dim + o] = v + __ldg(b5 + o);
  }
}

// Coordinate term and corner bias of row `row` at columns col, col + 1
// (absolute columns of rel / cb).
__device__ __forceinline__ float2 skip_bias(const Weights& wt,
                                            const Shape& s, const float* fr,
                                            int row, int col) {
  const int pp = row >> s.dim, k = row & ((1 << s.dim) - 1);
  float2 v = __ldg(reinterpret_cast<const float2*>(
      wt.cb + (size_t)k * s.sp + col));
  for (int d = 0; d < s.dim; ++d) {
    const float f = fr[pp * s.dim + d];
    const float2 r = __ldg(reinterpret_cast<const float2*>(
        wt.rel + (size_t)d * s.sp + col));
    v.x += f * r.x;
    v.y += f * r.y;
  }
  return v;
}

using Acc = float[2][kMaxNt][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < kMaxNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
}

// acc += A[a_row0 : +32, a_k0 : +kKc] @ B[0 : kKc, b_col0 : +8 nt] for the
// warp's two m-tiles and nt n-tiles. kSplit: A is stored as hi and lo
// planes (lo at a + a_plane), else as f32 and split here.
template <bool kSplit>
__device__ __forceinline__ void mma_tile(Acc& acc, const float* a, int lda,
                                         int a_plane, int a_row0, int a_k0,
                                         const float* b, int ldb, int b_col0,
                                         int nt, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < kKc; ks += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (kSplit)
        load_a_split(a, a + a_plane, lda, a_row0 + 16 * m, a_k0 + ks, g, t,
                     ah[m], al[m]);
      else
        load_a(a, lda, a_row0 + 16 * m, a_k0 + ks, g, t, ah[m], al[m]);
    }
#pragma unroll
    for (int j = 0; j < kMaxNt; ++j) {
      if (j < nt) {
        uint32_t bh[2], bl[2];
        load_b(b, ldb, ks, b_col0 + 8 * j, g, t, bh, bl);
        mma3(acc[0][j], ah[0], al[0], bh, bl);
        mma3(acc[1][j], ah[1], al[1], bh, bl);
      }
    }
  }
}

// h[row][col] = act(acc + skip terms) for the warp's tile of a layer whose
// columns start at `off` in rel / cb.
__device__ __forceinline__ void store_layer(const Acc& acc, float* h,
                                            const Shape& s,
                                            const Weights& wt,
                                            const float* fr, int off, int nt,
                                            int wm, int wn, int g, int t,
                                            int act, float ns) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < kMaxNt; ++j) {
      if (j >= nt) continue;
      const int col = (wn * nt + j) * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm * 32 + m * 16 + g + 8 * half;
        const float2 b = skip_bias(wt, s, fr, row, off + col);
        *reinterpret_cast<float2*>(h + row * s.ldh + col) = make_float2(
            activate(acc[m][j][2 * half] + b.x, act, ns),
            activate(acc[m][j][2 * half + 1] + b.y, act, ns));
      }
    }
}

// Columns [kc, kc + kKc) of h_0 for all kRows rows -> h0c, split once into
// a TF32 hi plane and a lo plane [kRows][kLdH0] each (layer 1 reads every
// element from 8 warps), from the latents and the staged chunk w0s
// [Cp][kLdW0]. Warp w owns the 16 x 8 tile (w / 4, w % 4).
__device__ __forceinline__ void layer0_chunk(const float* feats, int ldf,
                                             const float* w0s, float* h0c,
                                             const Shape& s,
                                             const Weights& wt,
                                             const float* fr, int kc,
                                             int warp, int g, int t, int act,
                                             float ns) {
  const int row0 = (warp >> 2) * 16, col0 = (warp & 3) * 8;
  float c0[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int k0 = 0; k0 < s.cp; k0 += 8) {
    uint32_t ah[4], al[4], bh[2], bl[2];
    load_a(feats, ldf, row0, k0, g, t, ah, al);
    load_b(w0s, kLdW0, k0, col0, g, t, bh, bl);
    mma3(c0, ah, al, bh, bl);
  }
  const int col = col0 + 2 * t;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    const float2 b = skip_bias(wt, s, fr, row, kc + col);
    const float v[2] = {activate(c0[2 * half] + b.x, act, ns),
                        activate(c0[2 * half + 1] + b.y, act, ns)};
    uint32_t hi[2], lo[2];
    split(v[0], hi[0], lo[0]);
    split(v[1], hi[1], lo[1]);
    float* o = h0c + row * kLdH0 + col;
    *reinterpret_cast<float2*>(o) =
        make_float2(__uint_as_float(hi[0]), __uint_as_float(hi[1]));
    *reinterpret_cast<float2*>(o + kRows * kLdH0) =
        make_float2(__uint_as_float(lo[0]), __uint_as_float(lo[1]));
  }
}

template <bool kGather>
__global__ void __launch_bounds__(kThreads, 1)
decode_blend_kernel(const float* __restrict__ src,      // table or feats2
                    const int* __restrict__ cell_flat,  // gather only
                    const float* __restrict__ frac,     // [N, D]
                    Weights wt, float* __restrict__ out, int n, int n_cells,
                    Shape s, int act_code, float ns) {
  extern __shared__ __align__(16) float smem[];
  float* r1 = smem;                  // H, or layer 1's weight tiles
  float* r2 = smem + s.r2;           // weight tiles of layers 0 and 2-4
  float* feats = smem + s.f;         // [kRows][Cp + 4]
  float* fr = smem + s.fr;           // [ppb][D]
  float* w0s = r2;                   // [2][Cp][kLdW0]
  float* h0c = r2 + 2 * s.cp * kLdW0;  // [2][hi, lo][kRows][kLdH0]
  constexpr int kPlane = kRows * kLdH0;
  const int ldf = s.cp + 4;
  const int ppb = kRows >> s.dim;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp / kWarpsN,
            wn = warp % kWarpsN;
  const int p0 = blockIdx.x * ppb;

  // Layer 1's first weight tile and layer 0's first two chunks fly while
  // the latents load.
  const int ld1 = s.w[1] + 8, nh = s.w[0] / kKc;
  stage_rows(r1, wt.wb[0], 0, s.w[1]);
  stage_cols(w0s, wt.wx0, s.cp, 0, s.w[0]);
  if (nh > 1) stage_cols(w0s + s.cp * kLdW0, wt.wx0, s.cp, kKc, s.w[0]);
  cp_commit();
  stage_frac(fr, frac, p0, n, s.dim);
  stage_feats<float, kGather>(feats, ldf, src, cell_flat, p0, n, n_cells,
                              s.c, s.cp, s.dim);

  cp_wait_all();
  __syncthreads();
  layer0_chunk(feats, ldf, w0s, h0c, s, wt, fr, 0, warp, g, t, act_code, ns);

  // Layer 1, layer 0 fused: K runs over h_0 and then the latents. Chunk j
  // of h_0 was computed in the step before; this step computes chunk j + 1
  // (its weights staged two steps ahead) beside the products of chunk j.
  Acc acc;
  zero(acc);
  int nt = s.w[1] / (8 * kWarpsN);
  const int n1 = (s.w[0] + s.cp) / kKc;
  for (int j = 0; j < n1; ++j) {
    if (j > 0) cp_wait_all();
    __syncthreads();
    if (j + 1 < n1)
      stage_rows(r1 + ((j + 1) & 1) * kKc * ld1, wt.wb[0], (j + 1) * kKc,
                 s.w[1]);
    if (j + 2 < nh)
      stage_cols(w0s + (j & 1) * s.cp * kLdW0, wt.wx0, s.cp, (j + 2) * kKc,
                 s.w[0]);
    cp_commit();
    if (j + 1 < nh)
      layer0_chunk(feats, ldf, w0s + ((j + 1) & 1) * s.cp * kLdW0,
                   h0c + ((j + 1) & 1) * 2 * kPlane, s, wt, fr,
                   (j + 1) * kKc, warp, g, t, act_code, ns);
    const float* bst = r1 + (j & 1) * kKc * ld1;
    if (j < nh)
      mma_tile<true>(acc, h0c + (j & 1) * 2 * kPlane, kLdH0, kPlane, wm * 32,
                     0, bst, ld1, wn * nt * 8, nt, g, t);
    else
      mma_tile<false>(acc, feats, ldf, 0, wm * 32, j * kKc - s.w[0], bst,
                      ld1, wn * nt * 8, nt, g, t);
  }
  __syncthreads();
  stage_rows(r2, wt.wb[1], 0, s.w[2]);
  cp_commit();
  store_layer(acc, r1, s, wt, fr, s.off[1], nt, wm, wn, g, t, act_code, ns);

  // Layers 2-4: A runs over H (h_{i-1}) and then the latents.
#pragma unroll 1
  for (int layer = 2; layer < 5; ++layer) {
    const int wprev = s.w[layer - 1], w = s.w[layer], ld = w + 8;
    const int nk = (wprev + s.cp) / kKc;
    const float* wb = wt.wb[layer - 1];
    nt = w / (8 * kWarpsN);
    zero(acc);
    for (int j = 0; j < nk; ++j) {
      const int kc = j * kKc;
      cp_wait_all();
      __syncthreads();
      if (j + 1 < nk) {
        stage_rows(r2 + ((j + 1) & 1) * kKc * ld, wb, kc + kKc, w);
        cp_commit();
      }
      const bool from_h = kc < wprev;
      mma_tile<false>(acc, from_h ? r1 : feats, from_h ? s.ldh : ldf, 0,
                      wm * 32, from_h ? kc : kc - wprev,
                      r2 + (j & 1) * kKc * ld, ld, wn * nt * 8, nt, g, t);
    }
    __syncthreads();
    if (layer < 4) {
      stage_rows(r2, wt.wb[layer], 0, s.w[layer + 1]);
      cp_commit();
    }
    store_layer(acc, r1, s, wt, fr, s.off[layer], nt, wm, wn, g, t,
                act_code, ns);
  }
  __syncthreads();

  // h_4 is in H; blend the corners into hb = R2 [ppb][nf], then the head.
  float* hb = r2;
  blend_corners<float>(hb, r1, s.ldh, fr, s.nf, s.dim);
  __syncthreads();
  head(out, hb, wt.w5, wt.b5, p0, n, s.nf, s.out_dim, s.dim);
}

template <bool kGather>
int launch(const float* src, const int* cell_flat, const float* frac,
           const Weights& wt, float* out, int n, int n_cells, int c, int dim,
           int nf, int out_dim, int act_code, float ns, void* stream) {
  if (n <= 0) return 0;
  if (dim < 1 || (1 << dim) > kRows) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(c, dim, nf, out_dim);
  const size_t smem = sizeof(float) * (size_t)s.total;
  cudaError_t e = cudaFuncSetAttribute(
      decode_blend_kernel<kGather>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return (int)e;
  }
  if (s.w[1] > kWidthAlign * kMaxNt) return (int)cudaErrorInvalidValue;
  const int ppb = kRows >> dim;
  const unsigned blocks = (unsigned)((n + ppb - 1) / ppb);
  decode_blend_kernel<kGather><<<blocks, kThreads, smem,
                                 (cudaStream_t)stream>>>(
      src, cell_flat, frac, wt, out, n, n_cells, s, act_code, ns);
  return (int)cudaGetLastError();
}

Weights pack(const float* wx0, const float* rel, const float* cb,
             const float* wb1, const float* wb2, const float* wb3,
             const float* wb4, const float* w5, const float* b5) {
  return Weights{wx0, rel, cb, {wb1, wb2, wb3, wb4}, w5, b5};
}

}  // namespace

// ---------------------------------------------------------------------------
// The bf16 instantiation of the gather entry (stpde_decode_blend_gather_bf16):
// what _kernel_gather computes at compute_dtype=bfloat16, on Hopper's bf16
// tensor cores, one mma.sync.m16n8k16 (bf16 operands, f32 accumulators) per
// k16 step and no split planes. It rounds where the TPU kernel rounds (the
// plain twin, ops/fused_query.py::decode_blend_gather_plain, rounds at the
// same points): the table is read as bf16 (half the f32 table's bytes); the
// weights arrive rounded to bf16 (corner_bias from the unrounded wx_rel,
// b5 f32); frac is rounded for the coordinate term, the blend weights take
// the f32 frac; a layer's skip term and pre-activation are summed in f32
// (the latent part of the skip in the same K loop as the hidden product, as
// the f32 kernel does, the coordinate term and the corner bias in the
// epilogue), the activation runs in f32 and h is rounded to bf16 where it is
// stored as the next layer's A operand; the last layer's h stays f32 for
// the blend, and hblend is rounded to bf16 before the head.
//
// Bound: arithmetic, 0.88 ms per 65,536 flagship points at D = 3 (8.7e11
// operations at 989 TFLOP/s dense bf16), 1.76 ms at D = 4.
//
// Layout: the same 64 corner rows a block and 16 warps (2 along rows x 8
// along columns) as the f32 kernel, but layer by layer: h_0 (16 nf wide)
// fits in shared memory as bf16 (64 x 1,032 x 2 bytes at nf = 64), so each
// layer's output overwrites the one activation buffer H after its K loop,
// and layer 0 runs in two column passes of at most 512 (a warp's 8 n-tiles
// of accumulators). The B operands come transposed ([W, K], K contiguous;
// kernel_weights(dtype=bfloat16)), so a fragment is two 32-bit loads; they
// are staged in 32-row K tiles by cp.async into a double buffer, a tile
// per block once (row stride K tile + 8: the fragment loads are free of
// bank conflicts, as are A's with the +8 row padding of H and the
// latents). Shared memory at C = 64, nf = 64: 223,488 bytes. The same
// limits as the f32 kernel: 8 nf rounded up to 64 at most 512 and the
// buffers within 227 KB (C <= 128 at nf = 64). No wgmma or TMA yet.
//
// The pre-gathered entry's bf16 instantiation (stpde_decode_blend_bf16,
// replacing _kernel (:400, pallas_call :510) at compute_dtype=bfloat16) is
// the same kernel (kPre) at _kernel's rounding points, which differ from
// _kernel_gather's: the rows arrive pre-gathered ([N * 2^D, C] bf16), the
// corner bias stays f32 (kernel_weights(dtype=bfloat16, f32=("b5", "cb"))),
// and the whole skip term is rounded to bf16 before the hidden product is
// added (_kernel stores its skip buffer xs in bf16, fused_query.py:425-428):
// each pass runs the latents' K tiles first, rounds the accumulators with
// the coordinate term and the corner bias in registers, then accumulates
// the hidden product onto them. Same bound and limits.
// ---------------------------------------------------------------------------

namespace {

constexpr int kBfKc = 32;                 // K rows per staged weight tile
constexpr int kBfLdB = kBfKc + 8;         // staged tile row stride (bf16)
constexpr int kBfPass = kWidthAlign * kMaxNt;   // 512 columns per pass

struct WeightsBf16 {
  const bf16* wx0;      // [W0, Cp]: Wx_feat[:, sl_0], transposed
  const bf16* rel;      // [D, Sp]
  const void* cb;       // [2^D, Sp]: bf16 (gather), f32 (pre-gathered)
  const bf16* wb[4];    // layer i + 1: [W_{i+1}, W_i + Cp], transposed
  const bf16* w5;       // [nf, out]
  const float* b5;      // [out]
};

// Padded sizes and the shared-memory plan (bytes).
struct ShapeBf16 {
  int c, cp, dim, nf, out_dim;
  int w[5], off[5], sp;
  int ldh;      // H row stride (bf16); as f32, h_4 uses w[4] + 4
  int ldf;      // latent row stride (bf16)
  int pass;     // columns a pass stages
  int o_w, o_f, o_fr, total;
};

ShapeBf16 make_shape_bf16(int c, int dim, int nf, int out_dim) {
  ShapeBf16 s{};
  s.c = c, s.cp = round_up(c, kBfKc), s.dim = dim, s.nf = nf;
  s.out_dim = out_dim;
  for (int i = 0, off = 0; i < 5; ++i) {
    s.w[i] = round_up(nf << (4 - i), kWidthAlign);
    s.off[i] = off;
    off += s.w[i];
    s.sp = off;
  }
  s.ldh = s.w[0] + 8;
  s.ldf = s.cp + 8;
  s.pass = s.w[0] < kBfPass ? s.w[0] : kBfPass;
  const int h = imax(2 * kRows * s.ldh, 4 * kRows * (s.w[4] + 4));
  s.o_w = round_up(h, 16);
  s.o_f = s.o_w + 2 * (2 * s.pass * kBfLdB);
  s.o_fr = s.o_f + round_up(2 * kRows * s.ldf, 16);
  s.total = s.o_fr + 4 * kRows;
  return s;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp16b(bf16* dst, const bf16* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// K rows [k0, k0 + kBfKc) of columns [c0, c0 + pw) of a transposed [W, K]
// weight -> dst [pw][kBfLdB].
__device__ __forceinline__ void stage_bt(bf16* dst, const bf16* src, int k,
                                         int c0, int pw, int k0) {
  for (int i = threadIdx.x; i < pw * (kBfKc / 8); i += kThreads) {
    const int r = i >> 2, q = i & 3;
    cp16b(dst + r * kBfLdB + 8 * q, src + (size_t)(c0 + r) * k + k0 + 8 * q);
  }
}

// acc += A[row0 : +32, a_k0 : +kBfKc] @ Bt[n0 : +8 nt, 0 : kBfKc]^T.
__device__ __forceinline__ void mma_tile_bf16(Acc& acc, const bf16* a,
                                              int lda, int row0, int a_k0,
                                              const bf16* bt, int n0, int nt,
                                              int g, int t) {
#pragma unroll
  for (int ks = 0; ks < kBfKc; ks += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const bf16* p = a + (row0 + 16 * m + g) * lda + a_k0 + ks + 2 * t;
      af[m][0] = ld32(p);
      af[m][1] = ld32(p + 8 * lda);
      af[m][2] = ld32(p + 8);
      af[m][3] = ld32(p + 8 * lda + 8);
    }
#pragma unroll
    for (int j = 0; j < kMaxNt; ++j) {
      if (j < nt) {
        const bf16* q = bt + (n0 + 8 * j + g) * kBfLdB + ks + 2 * t;
        const uint32_t b0 = ld32(q), b1 = ld32(q + 8);
        mma_bf16(acc[0][j], af[0], b0, b1);
        mma_bf16(acc[1][j], af[1], b0, b1);
      }
    }
  }
}

// Coordinate term (frac rounded to bf16) and corner bias of row `row` at
// columns col, col + 1 of rel / cb, in f32; the corner bias is bf16 (kPre
// false) or f32 (kPre true).
template <bool kPre>
__device__ __forceinline__ float2 skip_bias_bf16(const WeightsBf16& wt,
                                                 const ShapeBf16& s,
                                                 const float* fr, int row,
                                                 int col) {
  const int pp = row >> s.dim, k = row & ((1 << s.dim) - 1);
  const size_t o = (size_t)k * s.sp + col;
  float2 v = kPre ? __ldg(reinterpret_cast<const float2*>(
                        static_cast<const float*>(wt.cb) + o))
                  : __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                        static_cast<const bf16*>(wt.cb) + o));
  for (int d = 0; d < s.dim; ++d) {
    const float f = __bfloat162float(__float2bfloat16_rn(fr[pp * s.dim + d]));
    const float2 r = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(wt.rel + (size_t)d * s.sp +
                                                 col));
    v.x += f * r.x;
    v.y += f * r.y;
  }
  return v;
}

// kPre: the pre-gathered entry (src: feats2 rows; corner bias f32; the
// skip term rounded to bf16 before the hidden product is added), else the
// gather entry (src: the cell-major table).
template <bool kPre>
__global__ void __launch_bounds__(kThreads, 1)
decode_blend_bf16_kernel(const bf16* __restrict__ src,
                         const int* __restrict__ cell_flat,
                         const float* __restrict__ frac, WeightsBf16 wt,
                         float* __restrict__ out, int n, int n_cells,
                         ShapeBf16 s, int act_code, float ns) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* h = reinterpret_cast<bf16*>(smem_b);           // [kRows][ldh]
  float* h4 = reinterpret_cast<float*>(smem_b);        // [kRows][w4 + 4]
  bf16* wbuf = reinterpret_cast<bf16*>(smem_b + s.o_w);  // [2][pass][kBfLdB]
  bf16* feats = reinterpret_cast<bf16*>(smem_b + s.o_f);  // [kRows][ldf]
  float* fr = reinterpret_cast<float*>(smem_b + s.o_fr);  // [ppb][D]
  const int ld4 = s.w[4] + 4;
  const int ppb = kRows >> s.dim;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp / kWarpsN,
            wn = warp % kWarpsN;
  const int p0 = blockIdx.x * ppb;

  stage_frac(fr, frac, p0, n, s.dim);
  stage_feats<bf16, !kPre>(feats, s.ldf, src, cell_flat, p0, n, n_cells,
                           s.c, s.cp, s.dim);

  Acc acc;
#pragma unroll 1
  for (int layer = 0; layer < 5; ++layer) {
    const int w = s.w[layer], wprev = layer ? s.w[layer - 1] : 0;
    const int k = wprev + s.cp, nk = k / kBfKc;
    const bf16* wb = layer ? wt.wb[layer - 1] : wt.wx0;
    // K tile j's offset: in order, or (kPre) the latents' tiles first.
    const int nkl = s.cp / kBfKc;
    auto k_at = [&](int j) {
      return kPre ? (j < nkl ? wprev + j * kBfKc : (j - nkl) * kBfKc)
                  : j * kBfKc;
    };
#pragma unroll 1
    for (int c0 = 0; c0 < w; c0 += kBfPass) {
      const int pw = w - c0 < kBfPass ? w - c0 : kBfPass;
      const int nt = pw / (8 * kWarpsN);
      zero(acc);
      stage_bt(wbuf, wb, k, c0, pw, k_at(0));
      cp_commit();
      for (int j = 0; j < nk; ++j) {
        cp_wait_all();
        __syncthreads();
        if (j + 1 < nk) {
          stage_bt(wbuf + ((j + 1) & 1) * s.pass * kBfLdB, wb, k, c0, pw,
                   k_at(j + 1));
          cp_commit();
        }
        const int k0 = k_at(j);
        const bool from_h = k0 < wprev;
        mma_tile_bf16(acc, from_h ? h : feats, from_h ? s.ldh : s.ldf,
                      wm * 32, from_h ? k0 : k0 - wprev,
                      wbuf + (j & 1) * s.pass * kBfLdB, wn * nt * 8, nt, g,
                      t);
        if (kPre && j == nkl - 1) {
          // The skip term is complete: xs = bf16(feats Wx_feat + frac_b
          // Wx_rel + corner_bias), and the hidden product adds to it.
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int jj = 0; jj < kMaxNt; ++jj) {
              if (jj >= nt) continue;
              const int col = c0 + (wn * nt + jj) * 8 + 2 * t;
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const float2 b = skip_bias_bf16<true>(
                    wt, s, fr, wm * 32 + m * 16 + g + 8 * half,
                    s.off[layer] + col);
                float& v0 = acc[m][jj][2 * half];
                float& v1 = acc[m][jj][2 * half + 1];
                v0 = __bfloat162float(__float2bfloat16_rn(v0 + b.x));
                v1 = __bfloat162float(__float2bfloat16_rn(v1 + b.y));
              }
            }
        }
      }
      __syncthreads();  // every read of H and of the tiles is done
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < kMaxNt; ++j) {
          if (j >= nt) continue;
          const int col = c0 + (wn * nt + j) * 8 + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = wm * 32 + m * 16 + g + 8 * half;
            const float2 b =
                kPre ? make_float2(0.f, 0.f)
                     : skip_bias_bf16<false>(wt, s, fr, row,
                                             s.off[layer] + col);
            const float v0 = activate(acc[m][j][2 * half] + b.x, act_code, ns);
            const float v1 =
                activate(acc[m][j][2 * half + 1] + b.y, act_code, ns);
            if (layer < 4)
              *reinterpret_cast<__nv_bfloat162*>(h + row * s.ldh + col) =
                  __floats2bfloat162_rn(v0, v1);
            else
              *reinterpret_cast<float2*>(h4 + row * ld4 + col) =
                  make_float2(v0, v1);
          }
        }
    }
  }
  __syncthreads();

  // h_4 (f32) is in H; blend the corners in f32, rounded to bf16, into
  // hb [ppb][nf] (the weight buffer's space), then the head on bf16 x bf16
  // products.
  float* hb = reinterpret_cast<float*>(wbuf);
  blend_corners<bf16>(hb, h4, ld4, fr, s.nf, s.dim);
  __syncthreads();
  head(out, hb, wt.w5, wt.b5, p0, n, s.nf, s.out_dim, s.dim);
}

template <bool kPre>
int launch_bf16(const bf16* src, const int* cell_flat, const float* frac,
                const WeightsBf16& wt, float* out, int n, int n_cells, int c,
                int dim, int nf, int out_dim, int act_code, float ns,
                void* stream) {
  if (n <= 0) return 0;
  if (dim < 1 || (1 << dim) > kRows) return (int)cudaErrorInvalidValue;
  const ShapeBf16 s = make_shape_bf16(c, dim, nf, out_dim);
  if (s.w[1] > kBfPass) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      decode_blend_bf16_kernel<kPre>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, s.total);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  const int ppb = kRows >> dim;
  const unsigned blocks = (unsigned)((n + ppb - 1) / ppb);
  decode_blend_bf16_kernel<kPre><<<blocks, kThreads, s.total,
                                   (cudaStream_t)stream>>>(
      src, cell_flat, frac, wt, out, n, n_cells, s, act_code, ns);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Weights in the layout of ops/fused_query.py::kernel_weights.
int stpde_decode_blend_gather(
    const float* table, const int* cell_flat, const float* frac,
    const float* wx0, const float* rel, const float* cb, const float* wb1,
    const float* wb2, const float* wb3, const float* wb4, const float* w5,
    const float* b5, float* out, int n, int n_cells, int c, int dim, int nf,
    int out_dim, int act_code, float negative_slope, void* stream) {
  return launch<true>(table, cell_flat, frac,
                      pack(wx0, rel, cb, wb1, wb2, wb3, wb4, w5, b5), out, n,
                      n_cells, c, dim, nf, out_dim, act_code, negative_slope,
                      stream);
}

int stpde_decode_blend(
    const float* feats2, const float* frac, const float* wx0,
    const float* rel, const float* cb, const float* wb1, const float* wb2,
    const float* wb3, const float* wb4, const float* w5, const float* b5,
    float* out, int n, int c, int dim, int nf, int out_dim, int act_code,
    float negative_slope, void* stream) {
  return launch<false>(feats2, nullptr, frac,
                       pack(wx0, rel, cb, wb1, wb2, wb3, wb4, w5, b5), out,
                       n, 0, c, dim, nf, out_dim, act_code, negative_slope,
                       stream);
}

// The bf16 instantiation: table [n_cells, 2^D * C] bf16, weights in the
// layout of kernel_weights(dtype=bfloat16) (b5 f32), frac and out f32.
int stpde_decode_blend_gather_bf16(
    const void* table, const int* cell_flat, const float* frac,
    const void* wx0, const void* rel, const void* cb, const void* wb1,
    const void* wb2, const void* wb3, const void* wb4, const void* w5,
    const float* b5, float* out, int n, int n_cells, int c, int dim, int nf,
    int out_dim, int act_code, float negative_slope, void* stream) {
  auto p = [](const void* q) { return static_cast<const bf16*>(q); };
  return launch_bf16<false>(
      p(table), cell_flat, frac,
      WeightsBf16{p(wx0), p(rel), cb, {p(wb1), p(wb2), p(wb3), p(wb4)},
                  p(w5), b5},
      out, n, n_cells, c, dim, nf, out_dim, act_code, negative_slope,
      stream);
}

// The pre-gathered entry's bf16 instantiation: feats2 [N * 2^D, C] bf16,
// weights in the layout of kernel_weights(dtype=bfloat16, f32=("b5",
// "cb")) (corner bias and b5 f32), frac and out f32.
int stpde_decode_blend_bf16(
    const void* feats2, const float* frac, const void* wx0, const void* rel,
    const float* cb, const void* wb1, const void* wb2, const void* wb3,
    const void* wb4, const void* w5, const float* b5, float* out, int n,
    int c, int dim, int nf, int out_dim, int act_code, float negative_slope,
    void* stream) {
  auto p = [](const void* q) { return static_cast<const bf16*>(q); };
  return launch_bf16<true>(
      p(feats2), nullptr, frac,
      WeightsBf16{p(wx0), p(rel), cb, {p(wb1), p(wb2), p(wb3), p(wb4)},
                  p(w5), b5},
      out, n, 0, c, dim, nf, out_dim, act_code, negative_slope, stream);
}

// Dynamic shared memory a bf16 block takes at these widths (bytes).
int stpde_decode_bf16_smem_bytes(int c, int dim, int nf) {
  return make_shape_bf16(c, dim, nf, 0).total;
}

// Corner rows a block decodes (points per block = this >> D).
int stpde_block_rows(void) { return kRows; }

// Dynamic shared memory a block takes at these widths (bytes).
int stpde_decode_smem_bytes(int c, int dim, int nf) {
  return (int)sizeof(float) * make_shape(c, dim, nf, 0).total;
}

const char* stpde_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
