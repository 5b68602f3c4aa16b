// Derivative jet of the local-implicit-grid decode, forward and backward,
// for Hopper (sm_90a): every matrix product in 3xTF32 on the tensor cores.
//
// Replaces the two Pallas TPU kernels of space_time_pde_tpu/ops/fused_jet.py:
//   _jet_fwd_kernel (:175, pallas_call :436; make_fused_jet's forward)
//     -> stpde_jet_fwd
//   _jet_bwd_kernel (:219, pallas_call :507; its custom-VJP backward)
//     -> stpde_jet_bwd
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
// Backward, per layer i = 4..0, with P_i = Xbar_i * m_i (all chains):
//   dWh_i   = X_{i-1}^T P_i                       (reduction over R*(D+1) rows)
//   Xbar_{i-1} = P_i Wh_i^T, then P_{i-1} = Xbar_{i-1} * m_{i-1}
//   dWx_feat[:, sl_i] = feats^T P_i[primal],  dfeats += P_i[primal] Wx_feat^T
//   dcorner_bias[k, sl_i] = sum_p P_i[p, k, primal]
//   dWx_rel[a, sl_i] = sum_p frac_pa sum_k P_i[p, k, primal]
//                      + sum_{p,k} P_i[p, k, tangent a]
// and the head: dW5 = sum_p stacked^T ybar, db5 = sum_p ybar[p, value].
//
// WHAT BOUNDS THEM (chip_smoke.py::bound; C = 64, nf = 64, O = 4, 8,192
// points at D = 3 and 4,096 at D = 4; H100 SXM peaks). Operations: the
// hidden layers on D + 1 chains are ~98% of the forward; the backward does
// two products a layer. In 3xTF32 (three TF32 products each, 495 TFLOP/s)
// the forward needs 2.32 / 2.88 ms and the backward 4.63 / 5.74 ms at
// D = 3 / 4; in f32 FFMA (67 TFLOP/s) 5.71 / 7.08 and 11.41 / 14.14 ms.
// Bytes: the forward's inputs and outputs are 22 MB (0.006 ms at 3.35
// TB/s), but it also writes the workspace that the backward reads back
// (every layer's chains and masks, 2.21 / 2.73 GB: 0.66 / 0.82 ms each
// way). Both are bound by operations. In the 3xTF32 pattern below,
// mma.sync issues at most 245 of the card's 495 TFLOP/s of TF32, 81.6 of
// products (scripts/profile_torch_step.py --mma-ceiling): only wgmma
// reaches the bound.
//
// DESIGN.
// - One product core (mainloop + mma_stage): mma.sync.m16n8k8 TF32 with
//   f32 accumulation. Activations split into hi = TF32(x) and lo =
//   TF32(x - hi), weights' lo passed unrounded (the tensor cores read its
//   top bits); a k8 step's three products go into a zeroed temporary that
//   is added to the f32 accumulator in round-to-nearest (the tensor cores'
//   own accumulation truncates, and across all of K it drifts 20x farther
//   from float64 than f32: csrc/fused_query.cu). A block is 8 warps, 2
//   along rows x 4 along columns; a warp holds MT m16 x NT n8 tiles.
// - Staging: a 3-deep ring of cp.async stages 32 deep, in 16-byte copies
//   with zero fill past the ragged edges (4-byte copies where a pointer or
//   a stride is not 16-byte aligned, so C = 4 or widths below 8 work), at
//   padded strides (36 floats for [rows][k] tiles read by ldmatrix, W + 8
//   for [k][W] tiles) that keep every fragment load free of bank
//   conflicts. One barrier a stage.
// - Forward (jet_layer_kernel, one launch a layer over all chain rows): a
//   block is 32 corner rows x (D + 1) chains x 128 columns, its rows
//   ordered [chain][corner row], so a warp's m-tile s holds chain s of the
//   same 16 corner rows at the same fragment positions: the primal's sign
//   picks every chain's mask in registers, and the mask bytes are written
//   from there. The skip product feats @ Wx_feat[:, sl_i] runs as two more
//   K stages on the primal m-tile alone; the coordinate term and the
//   corner bias are added in f32 in the epilogue, which stores column
//   pairs. Layer 0, whose tangents are constants, runs the primal m-tile
//   alone, two blocks an SM.
// - Backward (run_backward): the head kernel gives P_4; then per layer
//   i = 4..0, dWh_i = X_{i-1}^T P_i over all R (D+1) chain rows and
//   dWx_feat on the primal rows (gemm_tn: split-K, each block summing its
//   own chunk of rows, about 4 x 132 blocks in all; both operands k-major
//   and split once a stage in shared memory, since 32-bit elements have no
//   ldmatrix.trans), the bias-side sums (bias_grad_kernel), dfeats +=
//   P_i[primal] Wx_feat^T and P_{i-1} = (P_i Wh_i^T) * m_{i-1} (gemm_nt;
//   the mask applied in registers from the mask bytes). Every parameter
//   gradient is per-block partials reduced in a fixed order
//   (reduce_kernel): no atomics, bitwise the same in every run.
// - Head kernels: 4 points a block (2,048 blocks at D = 3, 1,024 at D = 4).
//
// WORKSPACE (stpde_jet_fwd_workspace bytes): every layer's chain planes,
// f32 [D+1][R][w_i] (R = N 2^D corner rows, plane 0 the primal), then every
// layer's masks, bytes [R][w_i] (1 where the primal pre-activation >= 0;
// ops/fused_jet.py::workspace_masks reads them). The backward's scratch
// (stpde_jet_bwd_workspace bytes): two chain buffers for P (16 nf and 8 nf
// wide, alternating layers) and one partial-sum buffer for every reduction.
//
// MEASURED (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phases 4 and 11,
// the FFMA body this file replaced from scripts/profile_torch_step.py
// --sources):
//   jet_fwd  D = 3:  8.69 ms (plain twin 19.0, FFMA body 20.9), 26.7% of
//                    the 3xTF32 bound; D = 4: 10.45 ms (21.1, 37.1), 27.5%
//   jet_bwd  D = 3: 17.37 ms (45.8, 53.0), 26.7%; D = 4: 21.30 ms (55.0,
//                    66.1), 27.0%
// Layer 1's product (~65% of the forward) and the backward's two largest
// (X_0^T P_1, P_1 Wh_1^T) at 60-63% of the mma.sync ceiling (81.6 TFLOP/s
// of 3xTF32 products); the rest goes to per-block set-up and epilogues of
// the smaller layers.

#include "jet_common.cuh"

namespace {

// Tensor-core tiling. A block is 8 warps, 2 along rows x 4 along columns;
// a warp holds MT m16 tiles x NT n8 tiles of f32 accumulators, so a block
// is MT x 32 rows by 32 NT columns. The rows of a block tile are MT slots
// of kT rows; warp wm's m-tile s covers rows [s kT + 16 wm, +16) of the
// tile. In the chain kernels a slot is a chain (the rows of slot s are
// chain s of the block's kT corner rows), so a warp's m-tiles hold the
// primal and its tangents of the same 16 corner rows at the same fragment
// positions. In the plain products a slot is just the next kT rows.
constexpr int kBK = 32;                           // depth of a stage
constexpr int kStages = 3;                        // cp.async ring
// n8 tiles a warp (the block is 32 NT columns wide), measured per product:
// kLayerNT in the forward's layer product, kBackNT in the backward's
// P Wh^T, kPlainNT in the TN product, kFeatNT in P[primal] Wx_feat^T
// (C = 64 columns).
constexpr int kLayerNT = 4, kBackNT = 8, kPlainNT = 4, kFeatNT = 2;
constexpr int kPlainMT = 4;  // slots of a plain tile: 128 rows
// Padded strides: every fragment load below is free of bank conflicts.
constexpr int kLdRow = kBK + 4;        // [rows][kBK]: row-major A, [n][k] B
constexpr int kRowTile = kT * kLdRow;  // one slot of a [rows][kBK] tile
template <int NT>
__host__ __device__ constexpr int block_cols() { return kWarpsN * NT * 8; }
// [kBK][W] tiles (k-major A, [k][n] B): W + 8 floats a row.
template <int W>
__host__ __device__ constexpr int col_tile() { return kBK * (W + 8); }


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


// A matrix operand in device memory. Row rr of slot s of a tile whose
// first row is r0 is rr = r0 + s * step + j (j < kT), at
// p + s * plane + rr * ld; rows >= `rows` and columns >= `cols` read as 0.
// Chain planes: plane = the chain stride, step = 0. Plain rows: plane = 0,
// step = kT. vec: p, ld and plane are 16-byte aligned, so a tile moves in
// 16-byte copies (else in 4-byte ones).
struct Mat {
  const float* p;
  long long ld, plane, step, rows;
  int cols;
  int vec;
};

// ---------------------------------------------------------------------------
// Staging: cp.async with zero fill (src_bytes < copy size fills with 0).

__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

// Each thread stages the same rows and 16-byte column chunk at every stage:
// row tid / 8 of every slot of a [rows][kBK] tile; rows tid / (W / 4) + i
// kThreads / (W / 4) of a [kBK][W] tile.
static_assert(kThreads == kT * (kBK / 4), "one chunk per thread and row");

// dst[s kT + j][kLdRow] <- columns [k0, k0 + kBK) of row j of slot s, for
// kSlots slots.
template <int kSlots>
__device__ __forceinline__ void load_rows(float* dst, const Mat& m,
                                          long long r0, int k0) {
  if (m.vec) {
    const int j = threadIdx.x >> 3, c4 = (threadIdx.x & 7) * 4;
    const int col = k0 + c4;
    const int n = col < m.cols ? min(4, m.cols - col) : 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const long long rr = r0 + s * m.step + j;
      const bool ok = rr < m.rows && n > 0;
      cp16(dst + (s * kT + j) * kLdRow + c4,
           ok ? m.p + s * m.plane + rr * m.ld + col : m.p, ok ? 4 * n : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kSlots * kT * kBK; i += kThreads) {
      const int s = i / (kT * kBK), j = (i / kBK) % kT, c = i % kBK;
      const long long rr = r0 + s * m.step + j;
      const int col = k0 + c;
      const bool ok = rr < m.rows && col < m.cols;
      cp4(dst + (s * kT + j) * kLdRow + c,
          ok ? m.p + s * m.plane + rr * m.ld + col : m.p, ok ? 4 : 0);
    }
  }
}

// dst[k][W + 8] <- columns [c0, c0 + W) of rows k0 + k, k < kBK, rows below
// kend only.
template <int W>
__device__ __forceinline__ void load_cols(float* dst, const Mat& m,
                                          long long k0, long long kend,
                                          int c0) {
  constexpr int kChunks = W / 4, kPass = kThreads / kChunks, kLd = W + 8;
  static_assert(kThreads % kChunks == 0 && kBK % kPass == 0, "tiling");
  if (m.vec) {
    const int k = threadIdx.x / kChunks, c4 = (threadIdx.x % kChunks) * 4;
    const int col = c0 + c4;
    const int n = col < m.cols ? min(4, m.cols - col) : 0;
    const float* src = m.p + (k0 + k) * m.ld + col;
#pragma unroll
    for (int i = 0; i < kBK / kPass; ++i) {
      const bool ok = k0 + k + kPass * i < kend && n > 0;
      cp16(dst + (k + kPass * i) * kLd + c4,
           ok ? src + kPass * i * m.ld : m.p, ok ? 4 * n : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * W; i += kThreads) {
      const int k = i / W, c = i % W;
      const long long row = k0 + k;
      const int col = c0 + c;
      const bool ok = row < kend && col < m.cols;
      cp4(dst + k * kLd + c, ok ? m.p + row * m.ld + col : m.p, ok ? 4 : 0);
    }
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 products on the tensor cores (as csrc/fused_query.cu): x splits
// into hi = tf32_rna(x) and lo = x - hi, rounded to TF32 for activations and
// passed unrounded for weights (the tensor cores read its top bits); a
// product is lo_a hi_b + hi_a lo_b + hi_a hi_b, and each k8 step's three
// products go into a zeroed temporary that is added to the f32 accumulator
// with round-to-nearest (the tensor cores' own accumulation truncates).

// Round to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32 for
// every finite x (and inf), in two integer operations where ptxas lowers
// the cvt to four (an inf test, an add, a select, a mask).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <bool kRoundLo>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  const float r = x - __uint_as_float(hi);
  lo = kRoundLo ? tf32(r) : __float_as_uint(r);
}

// The TN product's activations are split once a stage, in shared memory:
// each thread splits the 16-byte chunks it staged (the loaders' mapping, so
// after its own cp.async wait no barrier is needed), hi in place and lo
// into a plane of the same layout.
__device__ __forceinline__ void split4(float* hi, float* lo) {
  const float4 v = *reinterpret_cast<float4*>(hi);
  uint32_t h[4], l[4];
  split<true>(v.x, h[0], l[0]);
  split<true>(v.y, h[1], l[1]);
  split<true>(v.z, h[2], l[2]);
  split<true>(v.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

template <int W>
__device__ __forceinline__ void split_cols(float* hi, float* lo) {
  constexpr int kChunks = W / 4, kPass = kThreads / kChunks, kLd = W + 8;
  const int o = (threadIdx.x / kChunks) * kLd + (threadIdx.x % kChunks) * 4;
#pragma unroll
  for (int i = 0; i < kBK / kPass; ++i)
    split4(hi + o + kPass * i * kLd, lo + o + kPass * i * kLd);
}

// Four 8 x 4 f32 matrices (8 x 8 b16) from shared memory: lane i gives the
// address of row i % 8 of matrix i / 8 and receives element (i / 4, i % 4)
// of each.
__device__ __forceinline__ void ldsm4(const float* p, uint32_t (&r)[4]) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// Operand tiles of one stage in shared memory.
template <int MT, int NT, bool kACols, bool kBCols>
struct Tiles {
  static constexpr int kBN = block_cols<NT>();
  // A: k-major [kBK][MT kT + 8] (the TN product's transposed operand) or
  // row-major [MT kT][kLdRow]; B: [kBK][kBN + 8] or [kBN][kLdRow].
  static constexpr int kLdA = MT * kT + 8, kLdB = kBN + 8;
  static constexpr int kASize = kACols ? col_tile<MT * kT>() : MT * kRowTile;
  static constexpr int kBSize = kBCols ? col_tile<kBN>() : kBN * kLdRow;
};

// One stage (kBK deep) of acc[mi][j] += A[rows of m-tile mi] B[cols of n-tile
// j] for the first `active` m-tiles. A is an activation; kPre: both
// operands are activations split once in shared memory (hi in as / bs, lo
// in al_s / bl_s); else A is split here (row-major, read by ldmatrix) and B
// is a weight split here with its lo unrounded. kBCols: B is stored [k][n],
// else [n][k] (ldmatrix).
template <int MT, int NT, bool kACols, bool kBCols, bool kPre>
__device__ __forceinline__ void mma_stage(float (&acc)[MT][NT][4],
                                          const float* __restrict__ as,
                                          const float* __restrict__ al_s,
                                          const float* __restrict__ bs,
                                          const float* __restrict__ bl_s,
                                          int active, int wm, int wn, int g,
                                          int t) {
  using L = Tiles<MT, NT, kACols, kBCols>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 8) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      // b0, b1 of n-tile j, then of n-tile j + 1.
      if (kBCols) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int o = (ks + t + 4 * (q & 1)) * L::kLdB +
                        (wn * NT + j + (q >> 1)) * 8 + g;
          if (kPre) {
            bh[j + (q >> 1)][q & 1] = __float_as_uint(bs[o]);
            bl[j + (q >> 1)][q & 1] = __float_as_uint(bl_s[o]);
          } else {
            split<false>(bs[o], bh[j + (q >> 1)][q & 1],
                         bl[j + (q >> 1)][q & 1]);
          }
        }
      } else {
        uint32_t r[4];
        ldsm4(bs + ((wn * NT + j + (lane >> 4)) * 8 + (lane & 7)) * kLdRow +
                  ks + ((lane >> 3) & 1) * 4,
              r);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split<false>(__uint_as_float(r[q]), bh[j + (q >> 1)][q & 1],
                       bl[j + (q >> 1)][q & 1]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (mi >= active) break;
      const int r = mi * kT + wm * 16;
      uint32_t ah[4], al[4];
      if (kACols) {
        const int o = (ks + t) * L::kLdA + r + g;
        const int os[4] = {o, o + 8, o + 4 * L::kLdA, o + 4 * L::kLdA + 8};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = __float_as_uint(as[os[e]]);
          al[e] = __float_as_uint(al_s[os[e]]);
        }
      } else {
        uint32_t v[4];
        ldsm4(as + (r + (lane & 15)) * kLdRow + ks + (lane >> 4) * 4, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) split<true>(__uint_as_float(v[e]), ah[e], al[e]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma3(acc[mi][j], ah, al, bh[j], bl[j]);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
}

// Shared memory of a mainloop: the ring, then (kPre) two lo planes of each
// operand.
template <int MT, int NT, bool kACols, bool kBCols, bool kPre>
constexpr int mainloop_smem() {
  using L = Tiles<MT, NT, kACols, kBCols>;
  return (kStages + (kPre ? 2 : 0)) * (L::kASize + L::kBSize) *
         (int)sizeof(float);
}

// The mainloop: `nk` stages through a kStages-deep cp.async ring. stage(kt,
// as, bs) issues stage kt's copies; active(kt) is its m-tile count. With
// kPre, each landed stage is split (both operands k-major [kBK][W] tiles)
// into hi in place and lo in one of two planes (alternating stages) before
// the barrier that publishes it. `vec`: every operand moved in 16-byte
// copies, so each thread splits what it staged itself; else a barrier
// comes first.
template <int MT, int NT, bool kACols, bool kBCols, bool kPre, class Stage,
          class Active>
__device__ __forceinline__ void mainloop(float (&acc)[MT][NT][4],
                                         float* smem, int nk, bool vec,
                                         Stage stage, Active active, int wm,
                                         int wn, int g, int t) {
  using L = Tiles<MT, NT, kACols, kBCols>;
  static_assert(!kPre || (kACols && kBCols), "split planes are k-major");
  constexpr int kSlot = L::kASize + L::kBSize;
  float* lo = smem + kStages * kSlot;  // [2][kSlot] if kPre
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) stage(s, smem + s * kSlot, smem + s * kSlot + L::kASize);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();
    float* as = smem + (kt % kStages) * kSlot;
    float* bs = as + L::kASize;
    float* al = lo + (kt & 1) * kSlot;
    float* bl = al + L::kASize;
    if constexpr (kPre) {
      if (!vec) __syncthreads();
      split_cols<MT * kT>(as, al);
      split_cols<L::kBN>(bs, bl);
    }
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      float* base = smem + (nxt % kStages) * kSlot;
      stage(nxt, base, base + L::kASize);
    }
    cp_commit();
    mma_stage<MT, NT, kACols, kBCols, kPre>(acc, as, al, bs, bl, active(kt),
                                            wm, wn, g, t);
  }
  cp_wait<0>();
}


// ---------------------------------------------------------------------------
// Forward: one ImNet layer for every chain row. Block: kT corner rows x
// D + 1 chains x 128 columns. K runs over X_{i-1} (all chains), then over
// the latents for the primal m-tile alone (the skip product).

struct LayerArgs {
  Mat a;               // X_{i-1}: chain planes [D+1][R][w_{i-1}]
  Mat b;               // Wh_i [w_{i-1}, w_i]
  Mat fa;              // feats [R, C]
  Mat fb;              // Wx_feat[:, sl_i] (row stride S)
  int kh, c;           // K of the hidden and of the skip product
  const float* frac;   // [N, D]
  const float* wxr;    // wx_rel + off_i, row stride s
  const float* cb;     // corner_bias + off_i, row stride s
  int s;
  float* x;            // X_i: [D+1][R][w]
  uint8_t* mask;       // [R, w] 1 where the primal pre-activation >= 0
  long long rows;
  int w, col_blocks;
  float slope;
};

// MT = D + 1 m-tiles (every chain) for the hidden layers; MT = 1 for layer
// 0, whose tangents are constants (m_0 Wx_rel[a, sl_0]) and whose product
// is the primal's skip term alone: its 16-float accumulator lets two
// blocks share an SM, so one block's loads and stores overlap the other's.
template <int D, int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 2 : 1)
    jet_layer_kernel(LayerArgs a) {
  using J = Jet<D>;
  constexpr int NT = kLayerNT, kBN = block_cols<NT>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int wm, wn, g, t;
  warp_coords(wm, wn, g, t);
  const long long r0 = (long long)(blockIdx.x / a.col_blocks) * kT;
  const int n0 = (blockIdx.x % a.col_blocks) * kBN;
  const int nkh = cdiv(a.kh, kBK), nk = nkh + cdiv(a.c, kBK);
  float acc[MT][NT][4];
  zero(acc);
  mainloop<MT, NT, false, true, false>(
      acc, smem, nk, true,
      [&](int kt, float* as, float* bs) {
        if (kt < nkh) {
          load_rows<MT>(as, a.a, r0, kt * kBK);
          load_cols<kBN>(bs, a.b, (long long)kt * kBK, a.kh, n0);
        } else {
          const int k0 = (kt - nkh) * kBK;
          load_rows<1>(as, a.fa, r0, k0);
          load_cols<kBN>(bs, a.fb, k0, a.c, n0);
        }
      },
      [&](int kt) { return kt < nkh ? MT : 1; }, wm, wn, g, t);

  // Epilogue: coordinate projection + corner bias on the primal, its mask
  // on every chain, in registers. A thread holds columns n, n + 1 of a
  // row: one 8-byte store a chain (and a 2-byte mask store) where w is
  // even.
  const long long plane = a.rows * a.w;
  const bool pair = a.w % 2 == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long r = r0 + wm * 16 + g + 8 * half;
    if (r >= a.rows) continue;
    const long long p = r >> D;
    const int k = (int)(r & (J::kCorners - 1));
    float fr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) fr[d] = a.frac[p * D + d];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + (wn * NT + j) * 8 + 2 * t;
      if (n >= a.w) continue;
      float v[D + 1][2];
      uint8_t pos[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = min(n + e, a.w - 1);  // in range; stored if < w
        float wr[D];
#pragma unroll
        for (int d = 0; d < D; ++d) wr[d] = a.wxr[(long long)d * a.s + col];
        float pre = acc[0][j][2 * half + e];
#pragma unroll
        for (int d = 0; d < D; ++d) pre += fr[d] * wr[d];
        pre += a.cb[(long long)k * a.s + col];
        pos[e] = pre >= 0.f;
        const float m = pos[e] ? 1.f : a.slope;
        v[0][e] = m * pre;
#pragma unroll
        for (int c = 1; c <= D; ++c) {
          float tan = wr[c - 1];
          if constexpr (MT > 1) tan += acc[c][j][2 * half + e];
          v[c][e] = m * tan;
        }
      }
      const long long o = r * a.w + n;
      if (pair) {
#pragma unroll
        for (int c = 0; c <= D; ++c)
          *reinterpret_cast<float2*>(a.x + o + c * plane) =
              make_float2(v[c][0], v[c][1]);
        *reinterpret_cast<uchar2*>(a.mask + o) = make_uchar2(pos[0], pos[1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= a.w) continue;
#pragma unroll
          for (int c = 0; c <= D; ++c) a.x[o + e + c * plane] = v[c][e];
          a.mask[o + e] = pos[e];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C (+)= A @ B^T for B given as rows [N, K]: the backward's P_i Wh_i^T, with
// the next layer's mask applied in registers (kChain: A and C are chain
// planes and the mask of corner row r covers every chain), and P_i[primal]
// Wx_feat^T into d feats (plain rows).

struct NTArgs {
  Mat a;                // [rows, K] (chain planes or plain rows)
  Mat b;                // [N, K]
  float* c;             // row rr of slot s at c + s * cplane + rr * ldc
  long long ldc, cplane, cstep;
  int n, k, accumulate, col_blocks;
  const uint8_t* mask;  // [R, mask_ld] or null
  int mask_ld;
  float slope;
};

template <int MT, int NT, bool kChain>
__global__ void __launch_bounds__(kThreads, 1) gemm_nt_kernel(NTArgs a) {
  constexpr int kBN = block_cols<NT>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int wm, wn, g, t;
  warp_coords(wm, wn, g, t);
  const long long r0 =
      (long long)(blockIdx.x / a.col_blocks) * (kChain ? kT : MT * kT);
  const int n0 = (blockIdx.x % a.col_blocks) * kBN;
  float acc[MT][NT][4];
  zero(acc);
  mainloop<MT, NT, false, false, false>(
      acc, smem, cdiv(a.k, kBK), true,
      [&](int kt, float* as, float* bs) {
        load_rows<MT>(as, a.a, r0, kt * kBK);
        load_rows<kBN / kT>(bs, a.b, n0, kt * kBK);
      },
      [&](int) { return MT; }, wm, wn, g, t);
  // A thread holds columns n, n + 1 of a row: one 8-byte store where the
  // output's strides are even.
  const bool pair = a.ldc % 2 == 0 && a.cplane % 2 == 0 &&
                    (uintptr_t)a.c % 8 == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + (wn * NT + j) * 8 + 2 * t;
      if (n >= a.n) continue;
      const long long rw = r0 + wm * 16 + g + 8 * half;
      float m[2] = {1.f, 1.f};
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (kChain && a.mask && rw < a.a.rows && n + e < a.n &&
            !a.mask[rw * a.mask_ld + n + e])
          m[e] = a.slope;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const long long rr = rw + mi * a.cstep;
        if (rr >= a.a.rows) continue;
        float* dst = a.c + mi * a.cplane + rr * a.ldc + n;
        float v[2] = {m[0] * acc[mi][j][2 * half],
                      m[1] * acc[mi][j][2 * half + 1]};
        if (pair && n + 1 < a.n) {
          float2* d2 = reinterpret_cast<float2*>(dst);
          if (a.accumulate) {
            const float2 o = *d2;
            v[0] = o.x + v[0], v[1] = o.y + v[1];
          }
          *d2 = make_float2(v[0], v[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < a.n) dst[e] = a.accumulate ? dst[e] + v[e] : v[e];
        }
      }
    }
  }
}

// part[z][KA, NB] = sum over rows m of chunk z of A[m, :]^T B[m, :]: split-K
// partials, each over at most `chunk` rows.
struct TNArgs {
  Mat a, b;           // [m, ka], [m, nb]
  float* part;
  long long m, chunk;
  int ka, nb, col_blocks;
};

template <int MT>
__global__ void __launch_bounds__(kThreads, 1) gemm_tn_kernel(TNArgs a) {
  constexpr int NT = kPlainNT, kBN = block_cols<NT>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int wm, wn, g, t;
  warp_coords(wm, wn, g, t);
  const int i0 = (blockIdx.x / a.col_blocks) * (MT * kT);
  const int n0 = (blockIdx.x % a.col_blocks) * kBN;
  const long long m0 = (long long)blockIdx.y * a.chunk;
  const long long m1 = min(a.m, m0 + a.chunk);
  float acc[MT][NT][4];
  zero(acc);
  mainloop<MT, NT, true, true, true>(
      acc, smem, cdiv(m1 - m0, kBK), a.a.vec && a.b.vec,
      [&](int kt, float* as, float* bs) {
        const long long k0 = m0 + (long long)kt * kBK;
        load_cols<MT * kT>(as, a.a, k0, m1, i0);
        load_cols<kBN>(bs, a.b, k0, m1, n0);
      },
      [&](int) { return MT; }, wm, wn, g, t);
  float* dst = a.part + (long long)blockIdx.y * a.ka * a.nb;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + mi * kT + wm * 16 + g + 8 * half;
      if (i >= a.ka) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + (wn * NT + j) * 8 + 2 * t + e;
          if (n < a.nb) dst[(long long)i * a.nb + n] = acc[mi][j][2 * half + e];
        }
    }
}




Mat mat(const float* p, long long ld, long long rows, int cols,
        long long plane = 0, long long step = 0) {
  const bool vec = ((uintptr_t)p % 16 == 0) && ld % 4 == 0 && plane % 4 == 0;
  return Mat{p, ld, plane, step, rows, cols, vec ? 1 : 0};
}

// Shared memory of the three products.
template <int MT>
constexpr int layer_smem() {
  return mainloop_smem<MT, kLayerNT, false, true, false>();
}
template <int MT, int NT>
constexpr int nt_smem() {
  return mainloop_smem<MT, NT, false, false, false>();
}
template <int MT>
constexpr int tn_smem() {
  return mainloop_smem<MT, kPlainNT, true, true, true>();
}


// Slots of the TN product's A tile: 64 rows where KA is at most 64 (the
// latent width C of the skip products), else 128.
int tn_mt(int ka) { return ka <= 2 * kT ? 2 : kPlainMT; }

int tn_tiles(int ka, int nb) {
  return cdiv(ka, tn_mt(ka) * kT) * cdiv(nb, block_cols<kPlainNT>());
}

long long tn_partial_floats(long long m, int ka, int nb) {
  int chunks;
  chunk_rows(m, tn_tiles(ka, nb), kBK, &chunks);
  return (long long)chunks * ka * nb;
}


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

// Forward workspace views: every layer's chain planes [D+1][R][w_i], then
// every layer's masks [R][w_i].
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


// out[KA, NB] (row stride ldo) = A[m, KA]^T B[m, NB], deterministic.
int gemm_tn(const Mat& a, const Mat& b, long long m, int ka, int nb,
            float* part, float* out, long long ldo, cudaStream_t st) {
  int chunks;
  const long long chunk = chunk_rows(m, tn_tiles(ka, nb), kBK, &chunks);
  const int cb = cdiv(nb, block_cols<kPlainNT>());
  TNArgs g{a, b, part, m, chunk, ka, nb, cb};
  dim3 grid(cdiv(ka, tn_mt(ka) * kT) * cb, chunks);
  if (tn_mt(ka) == 2) {
    STPDE_SMEM(gemm_tn_kernel<2>, tn_smem<2>());
    gemm_tn_kernel<2><<<grid, kThreads, tn_smem<2>(), st>>>(g);
  } else {
    STPDE_SMEM(gemm_tn_kernel<kPlainMT>, tn_smem<kPlainMT>());
    gemm_tn_kernel<kPlainMT><<<grid, kThreads, tn_smem<kPlainMT>(), st>>>(g);
  }
  STPDE_LAUNCH_CHECK();
  return reduce(part, chunks, (long long)ka * nb, ka, nb, out, ldo, st);
}

// C = A B^T (or C += ...). kChain: A and C are chain planes of MT chains
// (rows = corner rows), else plain rows.
template <int MT, int NT, bool kChain>
int gemm_nt(const Mat& a, const Mat& b, float* c, long long ldc,
            long long cplane, int n, int k, int accumulate,
            const uint8_t* mask, int mask_ld, float slope, cudaStream_t st) {
  if (a.rows == 0) return 0;
  const int cb = cdiv(n, block_cols<NT>());
  const int row_blocks = cdiv(a.rows, kChain ? kT : MT * kT);
  NTArgs g{a, b, c, ldc, cplane, kChain ? 0 : kT, n, k, accumulate, cb,
           mask, mask_ld, slope};
  STPDE_SMEM((gemm_nt_kernel<MT, NT, kChain>), (nt_smem<MT, NT>()));
  gemm_nt_kernel<MT, NT, kChain>
      <<<row_blocks * cb, kThreads, nt_smem<MT, NT>(), st>>>(g);
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
  constexpr int MT = J::kChains;
  STPDE_SMEM((jet_layer_kernel<D, 1>), layer_smem<1>());
  STPDE_SMEM((jet_layer_kernel<D, MT>), layer_smem<MT>());
  const Mat fa = mat(feats, sh.c, sh.rows, sh.c);
  for (int i = 0; i < kLayers; ++i) {
    const int kp = i ? sh.w[i - 1] : 0, w = sh.w[i];
    const Mat a = i ? mat(x[i - 1], kp, sh.rows, kp, sh.rows * kp)
                    : mat(feats, sh.c, 0, 0);
    const Mat b = i ? mat(wt.wh[i - 1], w, kp, w) : mat(feats, sh.c, 0, 0);
    const int cb = cdiv(w, block_cols<kLayerNT>());
    LayerArgs a_{a, b, fa, mat(wt.wx_feat + sh.off[i], sh.s, sh.c, w), kp,
                 sh.c, frac, wt.wx_rel + sh.off[i],
                 wt.corner_bias + sh.off[i], sh.s, x[i], mask[i], sh.rows,
                 w, cb, slope};
    const int blocks = cdiv(sh.rows, kT) * cb;
    if (i == 0)
      jet_layer_kernel<D, 1><<<blocks, kThreads, layer_smem<1>(), st>>>(a_);
    else
      jet_layer_kernel<D, MT><<<blocks, kThreads, layer_smem<MT>(), st>>>(a_);
    STPDE_LAUNCH_CHECK();
  }
  const int threads = head_threads(sh.nf);
  const size_t smem =
      sizeof(float) * (size_t)J::kBlocksOut * (J::kRowsPerPoint + sh.nf);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  jet_head_fwd_kernel<D, float><<<cdiv(sh.n, kHeadPoints), threads, smem, st>>>(
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
    jet_head_bwd_kernel<D, float><<<hblocks, head_threads(sh.nf), 0, st>>>(
        x[4], mask[4], frac, wt.w5, ybar, buf_a, nullptr, part, sh.n, sh.nf,
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

  const Mat fa = mat(feats, sh.c, sh.rows, sh.c);
  float* cur = buf_a;
  for (int i = kLayers - 1; i >= 0; --i) {
    const int w = sh.w[i];
    float* nxt = cur == buf_a ? buf_b : buf_a;
    const Mat pm = mat(cur, w, sh.rows, w, 0, kT);  // P_i[primal] rows
    if (i > 0) {
      const int kp = sh.w[i - 1];
      e = gemm_tn(mat(x[i - 1], kp, mrows, kp), mat(cur, w, mrows, w), mrows,
                  kp, w, part, gr.wh[i - 1], w, st);
      if (e) return e;
    }
    e = gemm_tn(fa, pm, sh.rows, sh.c, w, part, gr.wx_feat + sh.off[i], sh.s,
                st);
    if (e) return e;
    int ppc;
    const int bchunks = bias_chunks(sh, w, &ppc);
    if (sh.n > 0) {
      const int v = bias_vec(w);
      const dim3 grid(cdiv(cdiv(w, v), kBiasCols), bchunks);
      const dim3 block(kBiasCols, kBiasLanes);
      if (v == 4)
        bias_grad_kernel<D, 4, float><<<grid, block, 0, st>>>(
            cur, cur, frac, sh.n, w, ppc, part);
      else
        bias_grad_kernel<D, 1, float><<<grid, block, 0, st>>>(
            cur, cur, frac, sh.n, w, ppc, part);
      STPDE_LAUNCH_CHECK();
    }
    const long long bstride = (long long)(J::kCorners + D) * w;
    e = reduce(part, sh.n > 0 ? bchunks : 0, bstride, J::kCorners, w,
               gr.corner_bias + sh.off[i], sh.s, st);
    if (e) return e;
    e = reduce(part + (long long)J::kCorners * w, sh.n > 0 ? bchunks : 0,
               bstride, D, w, gr.wx_rel + sh.off[i], sh.s, st);
    if (e) return e;
    e = gemm_nt<kPlainMT, kFeatNT, false>(
        pm, mat(wt.wx_feat + sh.off[i], sh.s, sh.c, w, 0, kT), dfeats, sh.c,
        0, sh.c, w, i != kLayers - 1, nullptr, 0, slope, st);
    if (e) return e;
    if (i > 0) {
      const int kp = sh.w[i - 1];
      e = gemm_nt<J::kChains, kBackNT, true>(
          mat(cur, w, sh.rows, w, sh.rows * w), mat(wt.wh[i - 1], w, kp, w, 0, kT),
          nxt, kp, sh.rows * kp, kp, w, 0, mask[i - 1], kp, slope, st);
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
