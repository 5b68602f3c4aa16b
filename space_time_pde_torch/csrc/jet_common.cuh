// What the jet kernels of csrc/fused_jet.cu (f32, 3xTF32) and
// csrc/fused_jet_bf16.cu (bf16) share: the chain layout, the jet-block
// coefficients, the two head kernels and the bias-side sums (templated on
// the compute type T: float, or __nv_bfloat16 where the TPU kernel rounds a
// value to bf16 before a product), the fixed-order reduction, and the host
// helpers. Each .cu file includes it once; everything is in an anonymous
// namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxOut = 8;
constexpr int kLayers = 5;
constexpr int kMults[kLayers] = {16, 8, 4, 2, 1};

constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;  // 256
constexpr int kT = kWarpsM * 16;                  // 32 rows a slot

// The chain layout of dimension D (see the header).
template <int D>
struct Jet {
  static constexpr int kDim = D;
  static constexpr int kCorners = 1 << D;                    // 8 / 16
  static constexpr int kChains = D + 1;                      // primal + D
  static constexpr int kRowsPerPoint = kCorners * kChains;   // 32 / 80
  static constexpr int kBlocksOut = 1 + D + D * (D + 1) / 2;  // 10 / 15
};

// Blocks a split-K reduction aims for (four waves of one block per SM).
constexpr int kTargetBlocks = 4 * 132;

__host__ __device__ inline int cdiv(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A value of the compute type T read as f32, and an f32 value rounded to T
// and read back (the identity for float).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (std::is_same_v<T, float>)
    return x;
  else
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void warp_coords(int& wm, int& wn, int& g,
                                            int& t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  wm = warp % kWarpsM, wn = warp / kWarpsM, g = lane >> 2, t = lane & 3;
}

// ---------------------------------------------------------------------------
// Jet-block coefficients of one point: coef[blk][k * CH + c] (zeroed by the
// caller) so that block blk = sum_{k,c} coef X4[p, k, c]. Thread k < 2^D
// fills corner k's columns.
template <int D>
__device__ void fill_coefs(const float* fr, float* coef, int k) {
  using J = Jet<D>;
  float f[D], sg[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const bool bit = (k >> (D - 1 - d)) & 1;
    f[d] = bit ? fr[d] : 1.f - fr[d];
    sg[d] = bit ? 1.f : -1.f;
  }
  // Product over axes in axis order, skipping up to two of them.
  auto prod = [&](int e1, int e2) {
    float v = 1.f;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d != e1 && d != e2) v *= f[d];
    return v;
  };
  const int col = k * J::kChains;
  coef[0 * J::kRowsPerPoint + col] = prod(-1, -1);
  for (int a = 0; a < D; ++a) {
    coef[(1 + a) * J::kRowsPerPoint + col] = sg[a] * prod(a, -1);
    coef[(1 + a) * J::kRowsPerPoint + col + 1 + a] = prod(-1, -1);
  }
  int blk = 1 + D;
  for (int a = 0; a < D; ++a) {
    for (int b = a; b < D; ++b, ++blk) {
      float* row = coef + blk * J::kRowsPerPoint + col;
      row[1 + b] += sg[a] * prod(a, -1);
      row[1 + a] += sg[b] * prod(b, -1);
      if (a != b) row[0] = sg[a] * sg[b] * prod(a, b);
    }
  }
}

// Offset of chain row (corner k, chain c) of point p in a chain-plane
// buffer of R corner rows and width nf.
template <int D>
__device__ __forceinline__ long long chain_row(long long rows, long long p,
                                               int kc) {
  using J = Jet<D>;
  return (kc % J::kChains) * rows + p * J::kCorners + kc / J::kChains;
}

// Forward head: blend the chain rows (f32) into the jet blocks, then W5 (+ b5
// on the value block); at bf16 the blocks are rounded before the head, as
// the TPU kernel rounds `stacked`. One column j per thread; a block walks
// `ppb` points.
template <int D, typename T>
__global__ void jet_head_fwd_kernel(const float* __restrict__ x4,
                                    const float* __restrict__ frac,
                                    const T* __restrict__ w5,
                                    const float* __restrict__ b5,
                                    float* __restrict__ out, int n, int nf,
                                    int out_dim, int ppb) {
  using J = Jet<D>;
  extern __shared__ float sm[];
  float* coef = sm;                                    // [blocks][rows/pt]
  float* stk = sm + J::kBlocksOut * J::kRowsPerPoint;  // [blocks][nf]
  const int j = threadIdx.x;
  const long long rows = (long long)n * J::kCorners;
  const int p_begin = (int)blockIdx.x * ppb;
  const int p_end = min(n, p_begin + ppb);
  for (int p = p_begin; p < p_end; ++p) {
    __syncthreads();
    for (int i = j; i < J::kBlocksOut * J::kRowsPerPoint; i += blockDim.x)
      coef[i] = 0.f;
    __syncthreads();
    if (j < J::kCorners) fill_coefs<D>(frac + (long long)p * D, coef, j);
    __syncthreads();
    if (j < nf) {
      float acc[J::kBlocksOut] = {};
      for (int kc = 0; kc < J::kRowsPerPoint; ++kc) {
        const float x = x4[chain_row<D>(rows, p, kc) * nf + j];
#pragma unroll
        for (int b = 0; b < J::kBlocksOut; ++b)
          acc[b] += coef[b * J::kRowsPerPoint + kc] * x;
      }
#pragma unroll
      for (int b = 0; b < J::kBlocksOut; ++b) stk[b * nf + j] = rnd<T>(acc[b]);
    }
    __syncthreads();
    for (int t = j; t < J::kBlocksOut * out_dim; t += blockDim.x) {
      const int b = t / out_dim, o = t % out_dim;
      float s = 0.f;
      for (int jj = 0; jj < nf; ++jj)
        s += stk[b * nf + jj] * to_f32(w5[jj * out_dim + o]);
      if (b == 0) s += b5[o];
      out[((long long)p * J::kBlocksOut + b) * out_dim + o] = s;
    }
  }
}

// Backward head: ybar -> P_4 = Xbar_4 * m_4 (chain planes p4 of type T; at
// bf16 also the primal plane in f32, p4f), and per-block partial sums of
// dW5 ([nf, out]) and db5 ([out]), laid out [blocks][nf * out + out]. At
// bf16, ybar and the blocks are rounded where the TPU kernel rounds them
// before a product (db5 sums ybar in f32).
template <int D, typename T>
__global__ void jet_head_bwd_kernel(const float* __restrict__ x4,
                                    const uint8_t* __restrict__ mask4,
                                    const float* __restrict__ frac,
                                    const T* __restrict__ w5,
                                    const float* __restrict__ ybar,
                                    T* __restrict__ p4,
                                    float* __restrict__ p4f,
                                    float* __restrict__ part, int n, int nf,
                                    int out_dim, float slope, int ppb) {
  using J = Jet<D>;
  __shared__ float coef[J::kBlocksOut * J::kRowsPerPoint];
  __shared__ float yb[J::kBlocksOut * kMaxOut];
  const int j = threadIdx.x;
  const long long rows = (long long)n * J::kCorners;
  float dw5[kMaxOut] = {};
  float db5 = 0.f;
  const int p_begin = (int)blockIdx.x * ppb;
  const int p_end = min(n, p_begin + ppb);
  for (int p = p_begin; p < p_end; ++p) {
    __syncthreads();
    for (int i = j; i < J::kBlocksOut * J::kRowsPerPoint; i += blockDim.x)
      coef[i] = 0.f;
    for (int i = j; i < J::kBlocksOut * out_dim; i += blockDim.x)
      yb[(i / out_dim) * kMaxOut + i % out_dim] =
          ybar[(long long)p * J::kBlocksOut * out_dim + i];
    __syncthreads();
    if (j < J::kCorners) fill_coefs<D>(frac + (long long)p * D, coef, j);
    __syncthreads();
    if (j < out_dim) db5 += yb[j];
    if (j >= nf) continue;
    float bar[J::kBlocksOut], stk[J::kBlocksOut];
#pragma unroll
    for (int b = 0; b < J::kBlocksOut; ++b) {
      float s = 0.f;
      for (int o = 0; o < out_dim; ++o)
        s += rnd<T>(yb[b * kMaxOut + o]) * to_f32(w5[j * out_dim + o]);
      bar[b] = s;
      stk[b] = 0.f;
    }
    for (int kc = 0; kc < J::kRowsPerPoint; ++kc) {
      const long long idx = chain_row<D>(rows, p, kc) * nf + j;
      const float x = x4[idx];
      float xb = 0.f;
#pragma unroll
      for (int b = 0; b < J::kBlocksOut; ++b) {
        const float cf = coef[b * J::kRowsPerPoint + kc];
        stk[b] += cf * x;
        xb += cf * bar[b];
      }
      const long long r = (long long)p * J::kCorners + kc / J::kChains;
      const float v = mask4[r * nf + j] ? xb : slope * xb;
      if constexpr (std::is_same_v<T, float>) {
        p4[idx] = v;
      } else {
        p4[idx] = __float2bfloat16_rn(v);
        if (kc % J::kChains == 0) p4f[idx] = v;  // plane 0: the primal
      }
    }
    for (int o = 0; o < out_dim; ++o) {
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < J::kBlocksOut; ++b)
        s += rnd<T>(stk[b]) * rnd<T>(yb[b * kMaxOut + o]);
      dw5[o] += s;
    }
  }
  float* dst = part + (long long)blockIdx.x * (nf * out_dim + out_dim);
  if (j < nf)
    for (int o = 0; o < out_dim; ++o) dst[j * out_dim + o] = dw5[o];
  if (j < out_dim) dst[nf * out_dim + j] = db5;
}

// Per-chunk partials of the layer's bias-side gradients, [chunks][K + D][w]:
// rows k < K: sum_p P[p, k, primal]; rows K + a: sum_p frac_pa
// sum_k P[p, k, primal] + sum_{p,k} P[p, k, tangent a]. P: the primal plane
// in f32 (prim) and the chain planes of type T (tang; at f32 the same
// buffer); at bf16 frac and sum_k P[primal] are rounded before their
// product, as the TPU kernel rounds them. A
// block is kBiasCols column threads (V adjacent columns each, 16-byte loads
// where w allows) by kBiasLanes point lanes: lane y sums the chunk's points
// y, y + kBiasLanes, ... in order, then the lanes' sums are added pairwise
// in a fixed tree through shared memory (lanes y and y + 4, then y and
// y + 2, then 0 and 1), so a chunk's partial is a short run and a tree, not
// one run over all its points: bitwise the same in every run.
constexpr int kBiasCols = 32, kBiasLanes = 8;

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p,
                                       float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int D, int V, typename T>
__global__ void __launch_bounds__(kBiasCols * kBiasLanes)
    bias_grad_kernel(const float* __restrict__ prim, const T* __restrict__ tang,
                     const float* __restrict__ frac, int n, int w, int ppc,
                     float* __restrict__ part) {
  using J = Jet<D>;
  constexpr int R = J::kCorners + D;  // partial rows
  __shared__ float tree[kBiasLanes / 2][R][V][kBiasCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = (blockIdx.x * kBiasCols + tx) * V;
  const bool live = j < w;
  const long long plane = (long long)n * J::kCorners * w;
  float acc[R][V] = {};
  const int p_begin = (int)blockIdx.y * ppc;
  const int p_end = min(n, p_begin + ppc);
  for (int p = p_begin + ty; live && p < p_end; p += kBiasLanes) {
    float s[V] = {};
#pragma unroll
    for (int k = 0; k < J::kCorners; ++k) {
      const long long o = ((long long)p * J::kCorners + k) * w + j;
      float v[V];
      load_v<V>(prim + o, v);
#pragma unroll
      for (int c = 0; c < V; ++c) acc[k][c] += v[c], s[c] += v[c];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        load_v<V>(tang + o + (d + 1) * plane, v);
#pragma unroll
        for (int c = 0; c < V; ++c) acc[J::kCorners + d][c] += v[c];
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float f = rnd<T>(frac[(long long)p * D + d]);
#pragma unroll
      for (int c = 0; c < V; ++c) acc[J::kCorners + d][c] += f * rnd<T>(s[c]);
    }
  }
#pragma unroll
  for (int half = kBiasLanes / 2; half >= 1; half /= 2) {
    if (ty >= half && ty < 2 * half) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < V; ++c) tree[ty - half][r][c][tx] = acc[r][c];
    }
    __syncthreads();
    if (ty < half) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < V; ++c) acc[r][c] += tree[ty][r][c][tx];
    }
    __syncthreads();
  }
  if (ty != 0 || !live) return;
  float* dst = part + (long long)blockIdx.y * R * w + j;
#pragma unroll
  for (int c = 0; c < V; ++c) {
#pragma unroll
    for (int r = 0; r < R; ++r) dst[(long long)r * w + c] = acc[r][c];
  }
}

// out[e / cols, e % cols] (stride ldo) = sum_z part[z * stride + e]. A
// block sums 32 elements, warp q of kReduceWarps over the chunks z = q mod
// kReduceWarps; the warps' sums are added in warp order: bitwise the same
// in every run.
constexpr int kReduceWarps = 8;

__global__ void __launch_bounds__(32 * kReduceWarps)
    reduce_kernel(const float* __restrict__ part, int chunks, long long stride,
                  int rows, int cols, float* __restrict__ out,
                  long long ldo) {
  __shared__ float sums[kReduceWarps][32];
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const long long e = (long long)blockIdx.x * 32 + lane;
  const bool ok = e < (long long)rows * cols;
  float s = 0.f;
  if (ok)
    for (int z = q; z < chunks; z += kReduceWarps) s += part[z * stride + e];
  sums[q][lane] = s;
  __syncthreads();
  if (q == 0 && ok) {
    float v = sums[0][lane];
#pragma unroll
    for (int w = 1; w < kReduceWarps; ++w) v += sums[w][lane];
    out[(e / cols) * ldo + e % cols] = v;
  }
}

// ---------------------------------------------------------------------------
// Host side. Every entry point returns cudaGetLastError() of its launches
// (the first failure stops the sequence).

#define STPDE_LAUNCH_CHECK()                       \
  do {                                             \
    const cudaError_t e_ = cudaGetLastError();     \
    if (e_ != cudaSuccess) return (int)e_;         \
  } while (0)

struct Shape {
  int n, c, dim, nf, out_dim;
  long long rows;  // R = N * 2^D corner rows
  int s;           // 31 nf
  int w[kLayers];
  int off[kLayers];
};

bool make_shape(int n, int c, int dim, int nf, int out_dim, Shape* sh) {
  if ((dim != 3 && dim != 4) || n < 0 || c < 1 || nf < 1 || out_dim < 1 ||
      out_dim > kMaxOut || nf > 1024)
    return false;
  sh->n = n, sh->c = c, sh->dim = dim, sh->nf = nf, sh->out_dim = out_dim;
  sh->rows = (long long)n << dim;
  int off = 0;
  for (int i = 0; i < kLayers; ++i) {
    sh->w[i] = nf * kMults[i];
    sh->off[i] = off;
    off += sh->w[i];
  }
  sh->s = off;
  return true;
}

// f(Jet<D>{}) for the shape's D (make_shape admits 3 and 4 only).
template <typename F>
auto by_dim(const Shape& sh, F&& f) {
  return sh.dim == 3 ? f(Jet<3>{}) : f(Jet<4>{});
}

// A refused attribute's error, cleared so that it does not stick to the
// next launch.
int attr_error(cudaError_t e) {
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
#define STPDE_SMEM(kernel, bytes)                                      \
  do {                                                                 \
    const int e_ = attr_error(cudaFuncSetAttribute(                    \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));  \
    if (e_) return e_;                                                 \
  } while (0)

// Row chunks of a reduction over `m` rows into `tiles` output tiles, each a
// multiple of `depth` (a stage of the product).
long long chunk_rows(long long m, int tiles, int depth, int* chunks) {
  int want = kTargetBlocks / tiles;
  const int most = cdiv(m, depth);
  want = want < 1 ? 1 : (want > most ? most : want);
  long long chunk = (long long)cdiv(cdiv(m, want), depth) * depth;
  if (chunk < depth) chunk = depth;
  *chunks = m > 0 ? cdiv(m, chunk) : 1;
  return chunk;
}

// The bias-side sums: V columns a thread, kBiasCols x kBiasLanes threads a
// block, enough point chunks for about 8 blocks per SM, at least one point
// a lane.
int bias_vec(int w) { return w % 4 == 0 ? 4 : 1; }

int bias_chunks(const Shape& sh, int w, int* ppc) {
  const int xblocks = cdiv(cdiv(w, bias_vec(w)), kBiasCols);
  int chunks = cdiv(2 * kTargetBlocks, xblocks);
  const int most = cdiv(sh.n, kBiasLanes);
  if (chunks > most) chunks = most > 0 ? most : 1;
  *ppc = sh.n > 0 ? cdiv(sh.n, chunks) : 1;
  return sh.n > 0 ? cdiv(sh.n, *ppc) : 1;
}

constexpr int kHeadPoints = 4;  // points a head block walks

int head_threads(int nf) { return cdiv(nf, 32) * 32; }

int reduce(const float* part, int chunks, long long stride, int rows,
           int cols, float* out, long long ldo, cudaStream_t st) {
  const long long e = (long long)rows * cols;
  if (e == 0) return 0;
  reduce_kernel<<<cdiv(e, 32), 32 * kReduceWarps, 0, st>>>(
      part, chunks, stride, rows, cols, out, ldo);
  STPDE_LAUNCH_CHECK();
  return 0;
}

}  // namespace
