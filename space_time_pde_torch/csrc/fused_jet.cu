// Derivative jet of the local-implicit-grid decode, forward and backward,
// for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of space_time_pde_tpu/ops/fused_jet.py:
//   _jet_fwd_kernel (make_fused_jet's forward) -> stpde_jet_fwd
//   _jet_bwd_kernel (its custom-VJP backward)  -> stpde_jet_bwd
//
// Math (ops/fused_jet.py and ops/jet.py derive it). Per corner row r = p*K+k
// (point p, corner k of 2^D = K) there are D + 1 chains: the primal and one
// tangent per frac axis a, all through the same ImNet layers:
//   xs_i      = feats_r @ Wx_feat[:, sl_i] + frac_p @ Wx_rel[:, sl_i]
//               + corner_bias[k, sl_i]
//   pre_0     = xs_0,                      m_i = pre_i >= 0 ? 1 : slope
//   pre_i     = h_{i-1} @ Wh_i + xs_i,     h_i = m_i * pre_i
//   g^a_0     = m_0 * Wx_rel[a, sl_0]
//   g^a_i     = m_i * (g^a_{i-1} @ Wh_i + Wx_rel[a, sl_i])
// and the 1 + D + D(D+1)/2 jet blocks of a point are fixed combinations of
// its K*(D+1) chain rows of layer 4 (the multilinear weight w_k, its frac
// derivatives dw_ak and d2w_abk), each through the linear head:
//   out[p, blk] = (sum_{k,c} coef[blk, k, c] X4[p, k, c]) @ W5 (+ b5, value).
// Derivatives are in frac units; the caller rescales by d frac / d p.
//
// Design: one hand-written kernel per layer over all rows, through global
// memory, not one block per point chain. A point's chains hold 8 rows x 4
// chains x 31 nf activations (~250 KB at nf = 64), more than a block's
// shared memory, so the chains are stored in a workspace and every layer is
// a tiled f32 matrix product over all R*(D+1) chain rows at once:
//   * the chain rows of one corner row are interleaved ([R, D+1, w]), so a
//     thread's register tile holds the primal and its D tangents of two
//     corner rows, and the layer's epilogue applies the primal's mask to the
//     tangents in registers;
//   * the forward writes every layer's chains (X_i) and masks to the
//     workspace: R*(D+1)*31nf f32 + R*31nf bytes (2.21 GB at the flagship
//     step, N = 8192 points), and the backward reads them instead of
//     recomputing the forward (the TPU kernel recomputes because VMEM cannot
//     hold them);
//   * parameter gradients are sums over all rows. Blocks run in parallel, so
//     each block writes the partial sum of its slice of rows, and a second
//     kernel adds the partials in a fixed order: bitwise reproducible, no
//     atomics. The partial counts depend on the shapes only.
// Backward, per layer i = 4..0, with P_i = Xbar_i * m_i (all chains):
//   dWh_i   = X_{i-1}^T P_i                       (reduction over R*(D+1) rows)
//   Xbar_{i-1} = P_i Wh_i^T, then P_{i-1} = Xbar_{i-1} * m_{i-1}
//   dWx_feat[:, sl_i] = feats^T P_i[primal],  dfeats += P_i[primal] Wx_feat^T
//   dcorner_bias[k, sl_i] = sum_p P_i[p, k, primal]
//   dWx_rel[a, sl_i] = sum_p frac_pa sum_k P_i[p, k, primal]
//                      + sum_{p,k} P_i[p, k, tangent a]
// and the head: dW5 = sum_p stacked^T ybar, db5 = sum_p ybar[p, value].
//
// What bounds it on an H100: arithmetic in f32 on the CUDA cores. The
// forward is ~2.9 M multiply-adds per corner row (4 chains through the
// hidden layers plus the latent projection), 190 G at the flagship step;
// the backward about twice that again. Each product kernel keeps a
// 256 x 64 output tile per block in registers (8 x 8 per thread) and streams
// 16-deep slices of both operands through shared memory, so a thread does
// 64 multiply-adds per four 16-byte shared loads. No wgmma, TMA, TF32 or
// bf16 yet: f32 operands and f32 accumulation throughout.
//
// TPU workarounds deliberately NOT carried over: _axis_onehot (tangent
// injections are indexed rows here), the _rep mask tiling (the tangents sit
// beside their primal), pad_to = 128 lane padding, the block-major
// per-grid-block output layout and block_pts padding (the output is
// [N, blocks, O], any N), the sequential-grid accumulation of the parameter
// gradients (partials + fixed-order reduction instead).
//
// Both dimensions on the card: D = 3 (8 corners, the rb2d model family) and
// D = 4 (16 corners, the turb3d family), each a template instantiation of
// every kernel below (struct Jet<D>), so one build serves both. What D
// changes:
//   * a corner row has D + 1 chains, so the layer kernel's register tile of
//     2 corner rows x chains is 8 rows at D = 3 and 10 at D = 4. Ten rows
//     are not a multiple of four, so at D = 4 a thread reads its A column as
//     five 8-byte float2 loads (a 10-float offset keeps 8-byte alignment)
//     instead of two float4s, and a tile is 32 x 10 = 320 chain rows
//     (256 is not a multiple of 5), still 64 corner rows. Four corner rows
//     a thread (20 rows) would need 160 accumulators; two need 80, near
//     the 64 of D = 3.
//   * the generic products of the backward (gemm_nt / gemm_tn) keep their
//     8 x 8 tile at both D; only the layer mask's row -> corner-row divisor
//     (row / (D + 1)) is a template parameter.
//   * the head's coefficient buffer is (1 + D + D(D+1)/2) x 2^D (D + 1)
//     floats: 10 x 32 at D = 3, 15 x 80 at D = 4.
// Any other D is rejected (cudaErrorInvalidValue; -1 workspace bytes).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (space_time_pde_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOut = 8;
constexpr int kLayers = 5;
constexpr int kMults[kLayers] = {16, 8, 4, 2, 1};

// Product-kernel tiling: 256 threads as 32 row groups x 8 column groups,
// each with a kTM x 8 register tile (kTM = 8 in the generic products).
constexpr int kBK = 16;
constexpr int kTN = 8;
constexpr int kRowThreads = 32, kColThreads = 8;
constexpr int kThreads = kRowThreads * kColThreads;  // 256
constexpr int kBN = kColThreads * kTN;               // 64
constexpr int kPadN = kBN + 4;
constexpr int kTM = 8;                               // generic products
constexpr int kBM = kRowThreads * kTM;               // 256
constexpr int kPadM = kBM + 4;                       // keeps float4 alignment

// The chain layout of dimension D (see the header).
template <int D>
struct Jet {
  static constexpr int kDim = D;
  static constexpr int kCorners = 1 << D;                    // 8 / 16
  static constexpr int kChains = D + 1;                      // primal + D
  static constexpr int kRowsPerPoint = kCorners * kChains;   // 32 / 80
  static constexpr int kBlocksOut = 1 + D + D * (D + 1) / 2;  // 10 / 15
  // Layer kernel: a thread holds 2 corner rows x chains.
  static constexpr int kTM = 2 * kChains;                    // 8 / 10
  static constexpr int kBM = kRowThreads * kTM;              // 256 / 320
  static constexpr int kPadM = kBM + 4;   // row stride stays 16-byte aligned
  static constexpr int kPointRows = kBM / kChains;           // 64
  static_assert(kTM % 2 == 0 && kPadM % 4 == 0, "vector loads");
};

// Blocks the row reductions aim for (about four per SM of an H100).
constexpr int kTargetBlocks = 528;

struct Weights {
  const float* wx_feat;      // [C, S], S = 31 nf
  const float* wx_rel;       // [D, S]
  const float* corner_bias;  // [2^D, S]
  const float* wh[4];        // wh_i: [nf * 2^(5-i), nf * 2^(4-i)]
  const float* w5;           // [nf, out]
  const float* b5;           // [out]
};

struct Grads {
  float* wx_feat;
  float* wx_rel;
  float* corner_bias;
  float* wh[4];
  float* w5;
  float* b5;
};

__host__ __device__ inline int cdiv(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

// acc[j][q] += A[k][row0 + j] * B[k][col0 + q] over one kBK slice. A tile
// of TM rows a multiple of 4 reads A as float4s, otherwise as float2s.
template <int TM, int PadM>
__device__ __forceinline__ void mma_tile(float (&acc)[TM][kTN],
                                         const float (*As)[PadM],
                                         const float (*Bs)[kPadN], int ty,
                                         int tx) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    float av[TM], bv[kTN];
    if constexpr (TM % 4 == 0) {
#pragma unroll
      for (int v = 0; v < TM; v += 4) {
        const float4 a =
            *reinterpret_cast<const float4*>(&As[k][ty * TM + v]);
        av[v] = a.x, av[v + 1] = a.y, av[v + 2] = a.z, av[v + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int v = 0; v < TM; v += 2) {
        const float2 a =
            *reinterpret_cast<const float2*>(&As[k][ty * TM + v]);
        av[v] = a.x, av[v + 1] = a.y;
      }
    }
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * kTN]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][tx * kTN + 4]);
    bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
    bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
#pragma unroll
    for (int j = 0; j < TM; ++j)
#pragma unroll
      for (int q = 0; q < kTN; ++q) acc[j][q] += av[j] * bv[q];
  }
}

// ---------------------------------------------------------------------------
// Forward: one ImNet layer for every chain row.

struct LayerArgs {
  const float* xprev;  // [R*CH, kp] chains of layer i-1 (null at layer 0)
  const float* wh;     // [kp, w]
  int kp;
  const float* feats;  // [R, C]
  const float* wxf;    // wx_feat + off_i, row stride s
  const float* wxr;    // wx_rel + off_i, row stride s
  const float* cb;     // corner_bias + off_i, row stride s
  int c, s;
  const float* frac;   // [N, D]
  float* x;            // [R*CH, w] chains of layer i
  uint8_t* mask;       // [R, w] 1 where the primal pre-activation >= 0
  int rows, w;
  float slope;
};

template <int D>
__global__ void __launch_bounds__(kThreads) jet_layer_kernel(LayerArgs a) {
  using J = Jet<D>;
  __shared__ __align__(16) float As[kBK][J::kPadM];
  __shared__ __align__(16) float Bs[kBK][kPadN];
  __shared__ __align__(16) float Fs[kBK][J::kPointRows + 4];
  const int tid = threadIdx.x;
  const int tx = tid % kColThreads, ty = tid / kColThreads;
  const long long q0 = (long long)blockIdx.x * J::kBM;
  const long long r0 = q0 / J::kChains;
  const int n0 = blockIdx.y * kBN;
  const long long mrows = (long long)a.rows * J::kChains;
  float acc[J::kTM][kTN] = {};

  // All chains: X_{i-1} @ Wh_i.
  for (int k0 = 0; k0 < a.kp; k0 += kBK) {
    for (int i = tid; i < J::kBM * kBK; i += kThreads) {
      const int m = i / kBK, k = i % kBK;
      const long long gq = q0 + m;
      const int gk = k0 + k;
      As[k][m] = (gq < mrows && gk < a.kp) ? a.xprev[gq * a.kp + gk] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN, n = i % kBN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < a.kp && gn < a.w) ? a.wh[(long long)gk * a.w + gn]
                                         : 0.f;
    }
    __syncthreads();
    mma_tile<J::kTM, J::kPadM>(acc, As, Bs, ty, tx);
    __syncthreads();
  }
  // Primal chains only: feats @ Wx_feat[:, sl_i].
  for (int k0 = 0; k0 < a.c; k0 += kBK) {
    for (int i = tid; i < J::kPointRows * kBK; i += kThreads) {
      const int m = i / kBK, k = i % kBK;
      const long long gr = r0 + m;
      const int gk = k0 + k;
      Fs[k][m] = (gr < a.rows && gk < a.c) ? a.feats[gr * a.c + gk] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN, n = i % kBN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < a.c && gn < a.w) ? a.wxf[(long long)gk * a.s + gn]
                                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float f0 = Fs[k][ty * 2], f1 = Fs[k][ty * 2 + 1];
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * kTN]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[k][tx * kTN + 4]);
      const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int q = 0; q < kTN; ++q) {
        acc[0][q] += f0 * bv[q];
        acc[J::kChains][q] += f1 * bv[q];
      }
    }
    __syncthreads();
  }
  // Epilogue: coordinate projection + corner bias, mask, chain outputs.
#pragma unroll
  for (int s2 = 0; s2 < 2; ++s2) {
    const long long r = r0 + ty * 2 + s2;
    if (r >= a.rows) continue;
    const long long p = r / J::kCorners;
    const int k = (int)(r % J::kCorners);
    float fr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) fr[d] = a.frac[p * D + d];
#pragma unroll
    for (int q = 0; q < kTN; ++q) {
      const int n = n0 + tx * kTN + q;
      if (n >= a.w) continue;
      float pre = acc[s2 * J::kChains][q];
#pragma unroll
      for (int d = 0; d < D; ++d) pre += fr[d] * a.wxr[(long long)d * a.s + n];
      pre += a.cb[(long long)k * a.s + n];
      const bool pos = pre >= 0.f;
      const float m = pos ? 1.f : a.slope;
      const long long base = r * J::kChains * a.w + n;
      a.x[base] = m * pre;
#pragma unroll
      for (int t = 0; t < D; ++t)
        a.x[base + (long long)(t + 1) * a.w] =
            m * (acc[s2 * J::kChains + 1 + t][q] +
                 a.wxr[(long long)t * a.s + n]);
      a.mask[r * a.w + n] = pos ? 1 : 0;
    }
  }
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

// Forward head: blend the chain rows into the jet blocks, then W5 (+ b5 on
// the value block). One column j per thread; a block walks `ppb` points.
template <int D>
__global__ void jet_head_fwd_kernel(const float* __restrict__ x4,
                                    const float* __restrict__ frac,
                                    const float* __restrict__ w5,
                                    const float* __restrict__ b5,
                                    float* __restrict__ out, int n, int nf,
                                    int out_dim, int ppb) {
  using J = Jet<D>;
  extern __shared__ float sm[];
  float* coef = sm;                                    // [blocks][rows/pt]
  float* stk = sm + J::kBlocksOut * J::kRowsPerPoint;  // [blocks][nf]
  const int j = threadIdx.x;
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
        const float x = x4[((long long)p * J::kRowsPerPoint + kc) * nf + j];
#pragma unroll
        for (int b = 0; b < J::kBlocksOut; ++b)
          acc[b] += coef[b * J::kRowsPerPoint + kc] * x;
      }
#pragma unroll
      for (int b = 0; b < J::kBlocksOut; ++b) stk[b * nf + j] = acc[b];
    }
    __syncthreads();
    for (int t = j; t < J::kBlocksOut * out_dim; t += blockDim.x) {
      const int b = t / out_dim, o = t % out_dim;
      float s = 0.f;
      for (int jj = 0; jj < nf; ++jj) s += stk[b * nf + jj] * w5[jj * out_dim + o];
      if (b == 0) s += b5[o];
      out[((long long)p * J::kBlocksOut + b) * out_dim + o] = s;
    }
  }
}

// Backward head: ybar -> P_4 = Xbar_4 * m_4, and per-block partial sums of
// dW5 ([nf, out]) and db5 ([out]), laid out [blocks][nf * out + out].
template <int D>
__global__ void jet_head_bwd_kernel(const float* __restrict__ x4,
                                    const uint8_t* __restrict__ mask4,
                                    const float* __restrict__ frac,
                                    const float* __restrict__ w5,
                                    const float* __restrict__ ybar,
                                    float* __restrict__ p4,
                                    float* __restrict__ part, int n, int nf,
                                    int out_dim, float slope, int ppb) {
  using J = Jet<D>;
  __shared__ float coef[J::kBlocksOut * J::kRowsPerPoint];
  __shared__ float yb[J::kBlocksOut * kMaxOut];
  const int j = threadIdx.x;
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
      for (int o = 0; o < out_dim; ++o) s += yb[b * kMaxOut + o] * w5[j * out_dim + o];
      bar[b] = s;
      stk[b] = 0.f;
    }
    for (int kc = 0; kc < J::kRowsPerPoint; ++kc) {
      const long long idx = ((long long)p * J::kRowsPerPoint + kc) * nf + j;
      const float x = x4[idx];
      float xb = 0.f;
#pragma unroll
      for (int b = 0; b < J::kBlocksOut; ++b) {
        const float cf = coef[b * J::kRowsPerPoint + kc];
        stk[b] += cf * x;
        xb += cf * bar[b];
      }
      const long long r = (long long)p * J::kCorners + kc / J::kChains;
      p4[idx] = mask4[r * nf + j] ? xb : slope * xb;
    }
    for (int o = 0; o < out_dim; ++o) {
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < J::kBlocksOut; ++b) s += stk[b] * yb[b * kMaxOut + o];
      dw5[o] += s;
    }
  }
  float* dst = part + (long long)blockIdx.x * (nf * out_dim + out_dim);
  if (j < nf)
    for (int o = 0; o < out_dim; ++o) dst[j * out_dim + o] = dw5[o];
  if (j < out_dim) dst[nf * out_dim + j] = db5;
}

// ---------------------------------------------------------------------------
// C[M, N] (+)= A[M, K] @ B[N, K]^T, optionally times the layer mask
// (row q of C belongs to corner row q / Chains).
struct NTArgs {
  const float* a;
  long long lda;
  const float* b;
  long long ldb;
  float* c;
  long long ldc;
  long long m;
  int n, k;
  int accumulate;
  const uint8_t* mask;  // [M / Chains, mask_ld] or null
  int mask_ld;
  float slope;
};

template <int Chains>
__global__ void __launch_bounds__(kThreads) gemm_nt_kernel(NTArgs g) {
  __shared__ __align__(16) float As[kBK][kPadM];
  __shared__ __align__(16) float Bs[kBK][kPadN];
  const int tid = threadIdx.x;
  const int tx = tid % kColThreads, ty = tid / kColThreads;
  const long long q0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[kTM][kTN] = {};
  for (int k0 = 0; k0 < g.k; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int m = i / kBK, k = i % kBK;
      const long long gq = q0 + m;
      const int gk = k0 + k;
      As[k][m] = (gq < g.m && gk < g.k) ? g.a[gq * g.lda + gk] : 0.f;
    }
    for (int i = tid; i < kBN * kBK; i += kThreads) {
      const int n = i / kBK, k = i % kBK;
      const int gn = n0 + n, gk = k0 + k;
      Bs[k][n] = (gn < g.n && gk < g.k) ? g.b[gn * g.ldb + gk] : 0.f;
    }
    __syncthreads();
    mma_tile<kTM, kPadM>(acc, As, Bs, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kTM; ++j) {
    const long long row = q0 + ty * kTM + j;
    if (row >= g.m) continue;
#pragma unroll
    for (int q = 0; q < kTN; ++q) {
      const int col = n0 + tx * kTN + q;
      if (col >= g.n) continue;
      float v = acc[j][q];
      if (g.mask && !g.mask[(row / Chains) * g.mask_ld + col]) v *= g.slope;
      float* dst = g.c + row * g.ldc + col;
      *dst = g.accumulate ? *dst + v : v;
    }
  }
}

// part[z][KA, NB] = sum over rows m of chunk z of A[m, :]^T B[m, :].
struct TNArgs {
  const float* a;
  long long lda;
  const float* b;
  long long ldb;
  float* part;
  long long m;
  int ka, nb;
  long long chunk;
};

__global__ void __launch_bounds__(kThreads) gemm_tn_kernel(TNArgs g) {
  __shared__ __align__(16) float As[kBK][kPadM];
  __shared__ __align__(16) float Bs[kBK][kPadN];
  const int tid = threadIdx.x;
  const int tx = tid % kColThreads, ty = tid / kColThreads;
  const int i0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const long long m_begin = (long long)blockIdx.z * g.chunk;
  const long long m_end = min(g.m, m_begin + g.chunk);
  float acc[kTM][kTN] = {};
  for (long long m0 = m_begin; m0 < m_end; m0 += kBK) {
    for (int t = tid; t < kBK * kBM; t += kThreads) {
      const int k = t / kBM, i = t % kBM;
      const long long gm = m0 + k;
      const int gi = i0 + i;
      As[k][i] = (gm < m_end && gi < g.ka) ? g.a[gm * g.lda + gi] : 0.f;
    }
    for (int t = tid; t < kBK * kBN; t += kThreads) {
      const int k = t / kBN, n = t % kBN;
      const long long gm = m0 + k;
      const int gn = n0 + n;
      Bs[k][n] = (gm < m_end && gn < g.nb) ? g.b[gm * g.ldb + gn] : 0.f;
    }
    __syncthreads();
    mma_tile<kTM, kPadM>(acc, As, Bs, ty, tx);
    __syncthreads();
  }
  float* dst = g.part + (long long)blockIdx.z * g.ka * g.nb;
#pragma unroll
  for (int j = 0; j < kTM; ++j) {
    const int i = i0 + ty * kTM + j;
    if (i >= g.ka) continue;
#pragma unroll
    for (int q = 0; q < kTN; ++q) {
      const int n = n0 + tx * kTN + q;
      if (n < g.nb) dst[(long long)i * g.nb + n] = acc[j][q];
    }
  }
}

// Per-chunk partials of the layer's bias-side gradients, [chunks][K + D][w]:
// rows k < K: sum_p P[p, k, primal]; rows K + a: sum_p frac_pa
// sum_k P[p, k, primal] + sum_{p,k} P[p, k, tangent a].
template <int D>
__global__ void bias_grad_kernel(const float* __restrict__ pbuf,
                                 const float* __restrict__ frac, int n,
                                 int w, int ppc, float* __restrict__ part) {
  using J = Jet<D>;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= w) return;
  float cb[J::kCorners] = {}, xr[D] = {};
  const int p_begin = (int)blockIdx.y * ppc;
  const int p_end = min(n, p_begin + ppc);
  for (int p = p_begin; p < p_end; ++p) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < J::kCorners; ++k) {
      const long long base =
          ((long long)p * J::kRowsPerPoint + k * J::kChains) * w + j;
      const float v = pbuf[base];
      cb[k] += v;
      s += v;
#pragma unroll
      for (int d = 0; d < D; ++d) xr[d] += pbuf[base + (long long)(d + 1) * w];
    }
#pragma unroll
    for (int d = 0; d < D; ++d) xr[d] += frac[(long long)p * D + d] * s;
  }
  float* dst = part + (long long)blockIdx.y * (J::kCorners + D) * w + j;
#pragma unroll
  for (int k = 0; k < J::kCorners; ++k) dst[(long long)k * w] = cb[k];
#pragma unroll
  for (int d = 0; d < D; ++d) dst[(long long)(J::kCorners + d) * w] = xr[d];
}

// out[e / cols, e % cols] (stride ldo) = sum_z part[z * stride + e], z in
// order.
__global__ void reduce_kernel(const float* __restrict__ part, int chunks,
                              long long stride, int rows, int cols,
                              float* __restrict__ out, long long ldo) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)rows * cols) return;
  float s = 0.f;
  for (int z = 0; z < chunks; ++z) s += part[z * stride + e];
  out[(e / cols) * ldo + e % cols] = s;
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

// Row chunks of a reduction over `m` rows into `tiles` output tiles.
long long chunk_rows(long long m, int tiles, int* chunks) {
  int want = cdiv(kTargetBlocks, tiles);
  const int most = cdiv(m, kBK);
  want = want < 1 ? 1 : (want > most ? most : want);
  long long chunk = (long long)cdiv(cdiv(m, want), kBK) * kBK;
  if (chunk < kBK) chunk = kBK;
  *chunks = m > 0 ? cdiv(m, chunk) : 1;
  return chunk;
}

int tn_tiles(int ka, int nb) { return cdiv(ka, kBM) * cdiv(nb, kBN); }

long long tn_partial_floats(long long m, int ka, int nb) {
  int chunks;
  chunk_rows(m, tn_tiles(ka, nb), &chunks);
  return (long long)chunks * ka * nb;
}

int bias_chunks(const Shape& sh, int w, int* ppc) {
  const int xblocks = cdiv(w, 128);
  int chunks = cdiv(kTargetBlocks, xblocks);
  if (chunks > sh.n) chunks = sh.n > 0 ? sh.n : 1;
  *ppc = sh.n > 0 ? cdiv(sh.n, chunks) : 1;
  return sh.n > 0 ? cdiv(sh.n, *ppc) : 1;
}

constexpr int kHeadPoints = 64;  // points a head block walks

int head_threads(int nf) { return cdiv(nf, 32) * 32; }

long long fwd_workspace_bytes(const Shape& sh) {
  return sh.rows * (sh.dim + 1) * sh.s * (long long)sizeof(float) +
         sh.rows * sh.s;
}

// Backward scratch (floats): two chain buffers for P_i (widths 16 nf and
// 8 nf alternate) and one partial-sum buffer shared by every reduction.
void bwd_layout(const Shape& sh, long long* buf_a, long long* buf_b,
                long long* part) {
  const int chains = sh.dim + 1, corners = 1 << sh.dim;
  *buf_a = sh.rows * chains * sh.w[0];
  *buf_b = sh.rows * chains * sh.w[1];
  long long p = (long long)cdiv(sh.n, kHeadPoints) *
                (sh.nf * sh.out_dim + sh.out_dim);
  for (int i = 0; i < kLayers; ++i) {
    const int w = sh.w[i];
    if (i > 0) {
      const long long t = tn_partial_floats(sh.rows * chains, sh.w[i - 1], w);
      p = t > p ? t : p;
    }
    const long long f = tn_partial_floats(sh.rows, sh.c, w);
    p = f > p ? f : p;
    int ppc;
    const long long b =
        (long long)bias_chunks(sh, w, &ppc) * (corners + sh.dim) * w;
    p = b > p ? b : p;
  }
  *part = p;
}

long long bwd_workspace_bytes(const Shape& sh) {
  long long a, b, p;
  bwd_layout(sh, &a, &b, &p);
  return (a + b + p) * (long long)sizeof(float);
}

// Forward workspace views.
void fwd_views(const Shape& sh, void* ws, float* x[kLayers],
               uint8_t* mask[kLayers]) {
  float* xf = static_cast<float*>(ws);
  long long fo = 0;
  for (int i = 0; i < kLayers; ++i) {
    x[i] = xf + fo;
    fo += sh.rows * (sh.dim + 1) * sh.w[i];
  }
  uint8_t* mb = reinterpret_cast<uint8_t*>(xf + fo);
  long long mo = 0;
  for (int i = 0; i < kLayers; ++i) {
    mask[i] = mb + mo;
    mo += sh.rows * sh.w[i];
  }
}

int reduce(const float* part, int chunks, long long stride, int rows,
           int cols, float* out, long long ldo, cudaStream_t st) {
  const long long e = (long long)rows * cols;
  if (e == 0) return 0;
  reduce_kernel<<<cdiv(e, 256), 256, 0, st>>>(part, chunks, stride, rows,
                                               cols, out, ldo);
  STPDE_LAUNCH_CHECK();
  return 0;
}

// out[KA, NB] (row stride ldo) = A[m, KA]^T B[m, NB], deterministic.
int gemm_tn(const float* a, long long lda, const float* b, long long ldb,
            long long m, int ka, int nb, float* part, float* out,
            long long ldo, cudaStream_t st) {
  int chunks;
  const long long chunk = chunk_rows(m, tn_tiles(ka, nb), &chunks);
  TNArgs g{a, lda, b, ldb, part, m, ka, nb, chunk};
  dim3 grid(cdiv(ka, kBM), cdiv(nb, kBN), chunks);
  gemm_tn_kernel<<<grid, kThreads, 0, st>>>(g);
  STPDE_LAUNCH_CHECK();
  return reduce(part, chunks, (long long)ka * nb, ka, nb, out, ldo, st);
}

template <int Chains>
int gemm_nt(const float* a, long long lda, const float* b, long long ldb,
            float* c, long long ldc, long long m, int n, int k, int accumulate,
            const uint8_t* mask, int mask_ld, float slope, cudaStream_t st) {
  if (m == 0) return 0;
  NTArgs g{a, lda, b, ldb, c, ldc, m, n, k, accumulate, mask, mask_ld, slope};
  dim3 grid(cdiv(m, kBM), cdiv(n, kBN));
  gemm_nt_kernel<Chains><<<grid, kThreads, 0, st>>>(g);
  STPDE_LAUNCH_CHECK();
  return 0;
}

template <class J>
int run_forward(const Shape& sh, const float* feats, const float* frac,
                const Weights& wt, float* out, void* ws, float slope,
                cudaStream_t st) {
  constexpr int D = J::kDim;
  float* x[kLayers];
  uint8_t* mask[kLayers];
  fwd_views(sh, ws, x, mask);
  for (int i = 0; i < kLayers; ++i) {
    LayerArgs a{i ? x[i - 1] : nullptr, i ? wt.wh[i - 1] : nullptr,
                i ? sh.w[i - 1] : 0, feats, wt.wx_feat + sh.off[i],
                wt.wx_rel + sh.off[i], wt.corner_bias + sh.off[i], sh.c,
                sh.s, frac, x[i], mask[i], (int)sh.rows, sh.w[i], slope};
    dim3 grid(cdiv(sh.rows * J::kChains, J::kBM), cdiv(sh.w[i], kBN));
    jet_layer_kernel<D><<<grid, kThreads, 0, st>>>(a);
    STPDE_LAUNCH_CHECK();
  }
  const int threads = head_threads(sh.nf);
  const size_t smem =
      sizeof(float) * (size_t)J::kBlocksOut * (J::kRowsPerPoint + sh.nf);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  jet_head_fwd_kernel<D><<<cdiv(sh.n, kHeadPoints), threads, smem, st>>>(
      x[kLayers - 1], frac, wt.w5, wt.b5, out, sh.n, sh.nf, sh.out_dim,
      kHeadPoints);
  STPDE_LAUNCH_CHECK();
  return 0;
}

template <class J>
int run_backward(const Shape& sh, const float* feats, const float* frac,
                 const Weights& wt, void* fws, const float* ybar,
                 float* dfeats, const Grads& gr, void* bws, float slope,
                 cudaStream_t st) {
  constexpr int D = J::kDim;
  float* x[kLayers];
  uint8_t* mask[kLayers];
  fwd_views(sh, fws, x, mask);
  long long na, nb, np;
  bwd_layout(sh, &na, &nb, &np);
  float* buf_a = static_cast<float*>(bws);
  float* buf_b = buf_a + na;
  float* part = buf_b + nb;
  const long long mrows = sh.rows * J::kChains;

  // Head: P_4 into buf_a (layer widths alternate buffers: 4, 2, 0 -> a).
  const int hblocks = cdiv(sh.n, kHeadPoints);
  if (sh.n > 0) {
    jet_head_bwd_kernel<D><<<hblocks, head_threads(sh.nf), 0, st>>>(
        x[4], mask[4], frac, wt.w5, ybar, buf_a, part, sh.n, sh.nf,
        sh.out_dim, slope, kHeadPoints);
    STPDE_LAUNCH_CHECK();
  }
  const long long hstride = (long long)sh.nf * sh.out_dim + sh.out_dim;
  int e = reduce(part, sh.n > 0 ? hblocks : 0, hstride, sh.nf, sh.out_dim,
                 gr.w5, sh.out_dim, st);
  if (e) return e;
  e = reduce(part + (long long)sh.nf * sh.out_dim, sh.n > 0 ? hblocks : 0,
             hstride, 1, sh.out_dim, gr.b5, sh.out_dim, st);
  if (e) return e;

  float* cur = buf_a;
  for (int i = kLayers - 1; i >= 0; --i) {
    const int w = sh.w[i];
    const long long ldp = (long long)J::kChains * w;  // primal-row stride
    float* nxt = cur == buf_a ? buf_b : buf_a;
    if (i > 0) {
      e = gemm_tn(x[i - 1], sh.w[i - 1], cur, w, mrows, sh.w[i - 1], w, part,
                  gr.wh[i - 1], w, st);
      if (e) return e;
    }
    e = gemm_tn(feats, sh.c, cur, ldp, sh.rows, sh.c, w, part,
                gr.wx_feat + sh.off[i], sh.s, st);
    if (e) return e;
    int ppc;
    const int bchunks = bias_chunks(sh, w, &ppc);
    if (sh.n > 0) {
      dim3 grid(cdiv(w, 128), bchunks);
      bias_grad_kernel<D><<<grid, 128, 0, st>>>(cur, frac, sh.n, w, ppc,
                                                part);
      STPDE_LAUNCH_CHECK();
    }
    const long long bstride = (long long)(J::kCorners + D) * w;
    e = reduce(part, sh.n > 0 ? bchunks : 0, bstride, J::kCorners, w,
               gr.corner_bias + sh.off[i], sh.s, st);
    if (e) return e;
    e = reduce(part + (long long)J::kCorners * w, sh.n > 0 ? bchunks : 0,
               bstride, D, w, gr.wx_rel + sh.off[i], sh.s, st);
    if (e) return e;
    e = gemm_nt<J::kChains>(cur, ldp, wt.wx_feat + sh.off[i], sh.s, dfeats,
                            sh.c, sh.rows, sh.c, w, i != kLayers - 1,
                            nullptr, 0, slope, st);
    if (e) return e;
    if (i > 0) {
      e = gemm_nt<J::kChains>(cur, w, wt.wh[i - 1], w, nxt, sh.w[i - 1],
                              mrows, sh.w[i - 1], w, 0, mask[i - 1],
                              sh.w[i - 1], slope, st);
      if (e) return e;
      cur = nxt;
    }
  }
  return 0;
}

Weights pack(const float* wx_feat, const float* wx_rel,
             const float* corner_bias, const float* wh1, const float* wh2,
             const float* wh3, const float* wh4, const float* w5,
             const float* b5) {
  return Weights{wx_feat, wx_rel, corner_bias, {wh1, wh2, wh3, wh4}, w5, b5};
}

}  // namespace

extern "C" {

// Workspace bytes the forward writes (and the backward reads): every
// layer's chains and masks. -1 for a shape the kernels do not take.
long long stpde_jet_fwd_workspace(int n, int c, int dim, int nf,
                                  int out_dim) {
  Shape sh;
  return make_shape(n, c, dim, nf, out_dim, &sh) ? fwd_workspace_bytes(sh)
                                                 : -1;
}

// Scratch bytes of the backward.
long long stpde_jet_bwd_workspace(int n, int c, int dim, int nf,
                                  int out_dim) {
  Shape sh;
  return make_shape(n, c, dim, nf, out_dim, &sh) ? bwd_workspace_bytes(sh)
                                                 : -1;
}

// feats2 [N * 2^D, C], frac [N, D], packed weights -> out
// [N, 1 + D + D(D+1)/2, out_dim]; workspace: stpde_jet_fwd_workspace bytes.
// D is 3 or 4.
int stpde_jet_fwd(const float* feats2, const float* frac,
                  const float* wx_feat, const float* wx_rel,
                  const float* corner_bias, const float* wh1,
                  const float* wh2, const float* wh3, const float* wh4,
                  const float* w5, const float* b5, float* out,
                  void* workspace, int n, int c, int dim, int nf,
                  int out_dim, float slope, void* stream) {
  Shape sh;
  if (!make_shape(n, c, dim, nf, out_dim, &sh))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Weights wt =
      pack(wx_feat, wx_rel, corner_bias, wh1, wh2, wh3, wh4, w5, b5);
  return by_dim(sh, [&](auto j) {
    return run_forward<decltype(j)>(sh, feats2, frac, wt, out, workspace,
                                    slope, (cudaStream_t)stream);
  });
}

// Backward of stpde_jet_fwd for the cotangent ybar (same layout as out),
// reading the forward's workspace: d feats2 and the 9 packed-param grads,
// each written whole (no accumulation into the caller's buffers).
int stpde_jet_bwd(const float* feats2, const float* frac,
                  const float* wx_feat, const float* wx_rel,
                  const float* corner_bias, const float* wh1,
                  const float* wh2, const float* wh3, const float* wh4,
                  const float* w5, const float* b5, void* fwd_workspace,
                  const float* ybar, float* dfeats, float* d_wx_feat,
                  float* d_wx_rel, float* d_corner_bias, float* d_wh1,
                  float* d_wh2, float* d_wh3, float* d_wh4, float* d_w5,
                  float* d_b5, void* workspace, int n, int c, int dim,
                  int nf, int out_dim, float slope, void* stream) {
  Shape sh;
  if (!make_shape(n, c, dim, nf, out_dim, &sh))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 0) {
    // No rows: every gradient is zero.
    const size_t sizes[] = {
        (size_t)c * sh.s, (size_t)dim * sh.s, ((size_t)1 << dim) * sh.s,
        (size_t)sh.w[0] * sh.w[1], (size_t)sh.w[1] * sh.w[2],
        (size_t)sh.w[2] * sh.w[3], (size_t)sh.w[3] * sh.w[4],
        (size_t)nf * out_dim, (size_t)out_dim};
    float* ptrs[] = {d_wx_feat, d_wx_rel, d_corner_bias, d_wh1, d_wh2,
                     d_wh3, d_wh4, d_w5, d_b5};
    for (int i = 0; i < 9; ++i) {
      const cudaError_t e =
          cudaMemsetAsync(ptrs[i], 0, sizes[i] * sizeof(float), st);
      if (e != cudaSuccess) return (int)e;
    }
    return 0;
  }
  const Weights wt =
      pack(wx_feat, wx_rel, corner_bias, wh1, wh2, wh3, wh4, w5, b5);
  const Grads gr{d_wx_feat, d_wx_rel, d_corner_bias,
                 {d_wh1, d_wh2, d_wh3, d_wh4}, d_w5, d_b5};
  return by_dim(sh, [&](auto j) {
    return run_backward<decltype(j)>(sh, feats2, frac, wt, fwd_workspace,
                                     ybar, dfeats, gr, workspace, slope, st);
  });
}

}  // extern "C"
