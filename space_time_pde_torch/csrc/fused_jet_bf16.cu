// The bf16 instantiation of the jet kernels for Hopper (sm_90a): the jet
// forward and backward of csrc/fused_jet.cu at compute_dtype=bfloat16, on
// the bf16 tensor cores (mma.sync.m16n8k16, bf16 operands, f32
// accumulators), rounding where the TPU kernels round.
//
// Replaces the bf16 instantiations of the two Pallas TPU kernels of
// space_time_pde_tpu/ops/fused_jet.py (the jet under --use_bf16 --pde_bf16,
// space_time_pde_tpu/train/trainer.py:209-211):
//   _jet_fwd_kernel (:175, pallas_call :436) -> stpde_jet_fwd_bf16
//   _jet_bwd_kernel (:219, pallas_call :507) -> stpde_jet_bwd_bf16
//
// The math is csrc/fused_jet.cu's. The rounding points are
// _forward_chains' (fused_jet.py:130-172) and _jet_bwd_kernel's (:256-353);
// ops/fused_jet.py::jet_fwd_plain and jet_bwd_bf16_plain write them out:
// - operands: feats2 bf16, the packed weights wx_feat, wx_rel, wh1..4 and
//   w5 bf16 (corner_bias and b5 f32), frac rounded to bf16 for the skip
//   term (the blend weights take the f32 frac);
// - forward: the skip buffer xs_i = feats @ Wx_feat[:, sl_i] + frac @
//   Wx_rel[:, sl_i] + corner_bias[k, sl_i] summed in f32 and rounded to
//   bf16 as a whole; pre_i = bf16(h_{i-1}) @ Wh_i + xs_i; the tangents
//   bf16(g_{i-1}) @ Wh_i + Wx_rel[a, sl_i]; the masks from the f32 pre;
//   h and g in f32, stored rounded to bf16 for layers 0-3 (the backward and
//   the next layer read them only as bf16 operands) and in f32 for layer 4
//   (the blend); the blocks blended in f32 and rounded before the head;
// - backward: ybar, the blocks, P_i (pv, pt), X_{i-1}, xsbar and
//   sum_k xsbar rounded to bf16 at every product; db5, corner_bias's sums,
//   the spread and P in f32; every gradient summed in f32 and returned f32
//   (the wrapper rounds the bf16 parameters' ones, as make_fused_jet's
//   jet_bwd casts them).
//
// WHAT BOUNDS THEM (chip_smoke.py::bound at math "bf16"; C = 64, nf = 64,
// O = 4, 8,192 points at D = 3 and 4,096 at D = 4; H100 SXM peaks): the
// products, 0.388 / 0.482 ms forward and 0.775 / 0.960 ms backward at
// 989 TFLOP/s; the forward's workspace (the chains of layers 0-3 in bf16,
// layer 4 in f32, the masks: 1.20 / 1.48 GB) written once and read back by
// the backward (0.36 / 0.44 ms each way at 3.35 TB/s) is close behind.
//
// DESIGN. The structure of csrc/fused_jet.cu (one launch a layer over all
// chain rows, a block 32 corner rows x (D + 1) chains x 128 columns with
// rows [chain][corner row], the primal's sign picking every chain's mask in
// registers; the backward's TN / NT products, bias sums and fixed-order
// reductions: no atomics, bitwise the same in every run), with bf16 operand
// tiles: a 3-deep cp.async ring of 64-deep stages in 16-byte copies with
// zero fill (2-byte loads where a pointer or a stride is not 16-byte
// aligned), fragments by ldmatrix (.trans for k-major tiles: bf16 has it,
// so the TN product needs no split planes), row strides padded by 8 values
// (conflict-free). The skip product cannot ride in the layer's accumulator
// as in the f32 kernel, because xs is rounded before it is added: the
// forward runs it first on the primal m-tile, rounds it with the coordinate
// term and corner bias in registers, keeps it there (the primal's 16
// values a thread) and then runs the hidden product. The backward writes
// each P_i twice: all chains in bf16 (the products' operand) and the
// primal plane in f32 (the bias sums).
//
// WORKSPACE (stpde_jet_fwd_bf16_workspace bytes): the chain planes of
// layers 0-3, bf16 [D+1][R][w_i] each (R = N 2^D corner rows, plane 0 the
// primal), then layer 4's, f32 [D+1][R][nf], then every layer's masks,
// bytes [R][w_i] (ops/fused_jet.py::workspace_masks reads them). The
// backward's scratch (stpde_jet_bwd_bf16_workspace bytes): one partial-sum
// buffer, two f32 primal planes (16 nf and 8 nf wide, alternating layers)
// and two bf16 chain buffers of the same widths.

#include "jet_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;             // depth of a stage (bf16 values)
constexpr int kStages = 3;          // cp.async ring
constexpr int kLdRow = kBK + 8;     // [rows][kBK] tiles: 144-byte rows
constexpr int kLayerNT = 4, kBackNT = 8, kPlainNT = 4, kFeatNT = 2;
constexpr int kPlainMT = 4;         // slots of a plain tile: 128 rows
template <int NT>
__host__ __device__ constexpr int block_cols() { return kWarpsN * NT * 8; }
// [kBK][W] tiles (k-major A, [k][n] B): W + 8 values a row.
template <int W>
__host__ __device__ constexpr int col_tile() { return kBK * (W + 8); }

struct Weights {
  const bf16* wx_feat;        // [C, S], S = 31 nf
  const bf16* wx_rel;         // [D, S]
  const float* corner_bias;   // [2^D, S]
  const bf16* wh[4];          // wh_i: [nf * 2^(5-i), nf * 2^(4-i)]
  const bf16* w5;             // [nf, out]
  const float* b5;            // [out]
};

struct Grads {                // f32, every one
  float* wx_feat;
  float* wx_rel;
  float* corner_bias;
  float* wh[4];
  float* w5;
  float* b5;
};

// A bf16 matrix operand in device memory (csrc/fused_jet.cu's Mat): row rr
// of slot s of a tile whose first row is r0 is rr = r0 + s * step + j, at
// p + s * plane + rr * ld; rows >= `rows` and columns >= `cols` read as 0.
// vec: p, ld and plane are 16-byte aligned (16-byte copies), else 2-byte
// loads.
struct Mat {
  const bf16* p;
  long long ld, plane, step, rows;
  int cols;
  int vec;
};

Mat mat(const bf16* p, long long ld, long long rows, int cols,
        long long plane = 0, long long step = 0) {
  const bool vec = ((uintptr_t)p % 16 == 0) && ld % 8 == 0 && plane % 8 == 0;
  return Mat{p, ld, plane, step, rows, cols, vec ? 1 : 0};
}

__device__ __forceinline__ void cp16(bf16* dst, const bf16* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

// dst[s kT + j][kLdRow] <- columns [k0, k0 + kBK) of row j of slot s, for
// kSlots slots.
template <int kSlots>
__device__ __forceinline__ void load_rows(bf16* dst, const Mat& m,
                                          long long r0, int k0) {
  constexpr int kChunks = kBK / 8;
  if (m.vec) {
    for (int i = threadIdx.x; i < kSlots * kT * kChunks; i += kThreads) {
      const int s = i / (kT * kChunks), j = (i / kChunks) % kT;
      const int c8 = (i % kChunks) * 8, col = k0 + c8;
      const long long rr = r0 + s * m.step + j;
      const int n = col < m.cols ? min(8, m.cols - col) : 0;
      const bool ok = rr < m.rows && n > 0;
      cp16(dst + (s * kT + j) * kLdRow + c8,
           ok ? m.p + s * m.plane + rr * m.ld + col : m.p, ok ? 2 * n : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kSlots * kT * kBK; i += kThreads) {
      const int s = i / (kT * kBK), j = (i / kBK) % kT, c = i % kBK;
      const long long rr = r0 + s * m.step + j;
      const int col = k0 + c;
      dst[(s * kT + j) * kLdRow + c] =
          rr < m.rows && col < m.cols ? m.p[s * m.plane + rr * m.ld + col]
                                      : __float2bfloat16_rn(0.f);
    }
  }
}

// dst[k][W + 8] <- columns [c0, c0 + W) of rows k0 + k, k < kBK, rows below
// kend only.
template <int W>
__device__ __forceinline__ void load_cols(bf16* dst, const Mat& m,
                                          long long k0, long long kend,
                                          int c0) {
  constexpr int kChunks = W / 8, kLd = W + 8;
  if (m.vec) {
    for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
      const int k = i / kChunks, c8 = (i % kChunks) * 8, col = c0 + c8;
      const long long row = k0 + k;
      const int n = col < m.cols ? min(8, m.cols - col) : 0;
      const bool ok = row < kend && n > 0;
      cp16(dst + k * kLd + c8, ok ? m.p + row * m.ld + col : m.p,
           ok ? 2 * n : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * W; i += kThreads) {
      const int k = i / W, c = i % W;
      const long long row = k0 + k;
      const int col = c0 + c;
      dst[k * kLd + c] = row < kend && col < m.cols
                             ? m.p[row * m.ld + col]
                             : __float2bfloat16_rn(0.f);
    }
  }
}

// Four 8 x 8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8. Plain: lane i receives (i / 4, 2 (i % 4) + {0,
// 1}) of each; .trans: (2 (i % 4) + {0, 1}, i / 4).
__device__ __forceinline__ void ldsm4(const bf16* p, uint32_t (&r)[4]) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm4t(const bf16* p, uint32_t (&r)[4]) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Operand tiles of one stage in shared memory (bf16 values).
template <int MT, int NT, bool kACols, bool kBCols>
struct Tiles {
  static constexpr int kBN = block_cols<NT>();
  // A: k-major [kBK][MT kT + 8] or row-major [MT kT][kLdRow]; B: [kBK][kBN
  // + 8] or [kBN][kLdRow].
  static constexpr int kLdA = MT * kT + 8, kLdB = kBN + 8;
  static constexpr int kASize =
      kACols ? col_tile<MT * kT>() : MT * kT * kLdRow;
  static constexpr int kBSize = kBCols ? col_tile<kBN>() : kBN * kLdRow;
};

// One stage (kBK deep) of acc[mi][j] += A[rows of m-tile mi] B[cols of n-tile
// j] for the first `active` m-tiles. kACols: A is stored k-major, else
// row-major; kBCols: B is stored [k][n], else [n][k].
template <int MT, int NT, bool kACols, bool kBCols>
__device__ __forceinline__ void mma_stage(float (&acc)[MT][NT][4],
                                          const bf16* __restrict__ as,
                                          const bf16* __restrict__ bs,
                                          int active, int wm, int wn) {
  using L = Tiles<MT, NT, kACols, kBCols>;
  static_assert(NT % 2 == 0, "B fragments load two n-tiles at a time");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 16) {
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t r[4];
      const int n0 = (wn * NT + j) * 8;
      if (kBCols)
        ldsm4t(bs + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * L::kLdB + n0 +
                   (lane >> 4) * 8,
               r);
      else
        ldsm4(bs + (n0 + (lane & 7) + (lane >> 4) * 8) * kLdRow + ks +
                  ((lane >> 3) & 1) * 8,
              r);
      b[j][0] = r[0], b[j][1] = r[1], b[j + 1][0] = r[2], b[j + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (mi >= active) break;
      const int r0 = mi * kT + wm * 16;
      uint32_t a[4];
      if (kACols)
        ldsm4t(as + (ks + (lane & 7) + (lane >> 4) * 8) * L::kLdA + r0 +
                   ((lane >> 3) & 1) * 8,
               a);
      else
        ldsm4(as + (r0 + (lane & 15)) * kLdRow + ks + (lane >> 4) * 8, a);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(acc[mi][j], a, b[j][0], b[j][1]);
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

template <int MT, int NT, bool kACols, bool kBCols>
constexpr int mainloop_smem() {
  using L = Tiles<MT, NT, kACols, kBCols>;
  return kStages * (L::kASize + L::kBSize) * (int)sizeof(bf16);
}

// The mainloop: `nk` stages through a kStages-deep cp.async ring. stage(kt,
// as, bs) issues stage kt's copies (or, unaligned, stores them); active(kt)
// is its m-tile count. Ends with every copy landed but no barrier: a caller
// that reuses the ring next synchronises first.
template <int MT, int NT, bool kACols, bool kBCols, class Stage, class Active>
__device__ __forceinline__ void mainloop(float (&acc)[MT][NT][4], bf16* smem,
                                         int nk, Stage stage, Active active,
                                         int wm, int wn) {
  using L = Tiles<MT, NT, kACols, kBCols>;
  constexpr int kSlot = L::kASize + L::kBSize;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) stage(s, smem + s * kSlot, smem + s * kSlot + L::kASize);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      bf16* base = smem + (nxt % kStages) * kSlot;
      stage(nxt, base, base + L::kASize);
    }
    cp_commit();
    const bf16* as = smem + (kt % kStages) * kSlot;
    mma_stage<MT, NT, kACols, kBCols>(acc, as, as + L::kASize, active(kt), wm,
                                      wn);
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------------------
// Forward: one ImNet layer for every chain row. Block: kT corner rows x
// D + 1 chains x 128 columns. First the skip product on the primal m-tile
// (K over the latents), rounded with its coordinate term and corner bias;
// then the hidden product over all chains (K over X_{i-1}).

struct LayerArgs {
  Mat a;               // X_{i-1}: bf16 chain planes [D+1][R][w_{i-1}]
  Mat b;               // Wh_i [w_{i-1}, w_i]
  Mat fa;              // feats [R, C]
  Mat fb;              // Wx_feat[:, sl_i] (row stride S)
  int kh, c;           // K of the hidden and of the skip product
  const float* frac;   // [N, D]
  const bf16* wxr;     // wx_rel + off_i, row stride s
  const float* cb;     // corner_bias + off_i, row stride s
  int s;
  bf16* xb;            // X_i in bf16 (layers 0-3), or null
  float* xf;           // X_i in f32 (layer 4), or null
  uint8_t* mask;       // [R, w] 1 where the primal pre-activation >= 0
  long long rows;
  int w, col_blocks;
  float slope;
};

// MT = D + 1 m-tiles for the hidden layers; MT = 1 for layer 0 (the skip
// term alone; its tangents are constants), two blocks an SM.
template <int D, int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 2 : 1)
    jet_layer_kernel(LayerArgs a) {
  using J = Jet<D>;
  constexpr int NT = kLayerNT, kBN = block_cols<NT>();
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  int wm, wn, g, t;
  warp_coords(wm, wn, g, t);
  const long long r0 = (long long)(blockIdx.x / a.col_blocks) * kT;
  const int n0 = (blockIdx.x % a.col_blocks) * kBN;
  float acc[MT][NT][4];
  zero(acc);
  mainloop<MT, NT, false, true>(
      acc, smem, cdiv(a.c, kBK),
      [&](int kt, bf16* as, bf16* bs) {
        load_rows<1>(as, a.fa, r0, kt * kBK);
        load_cols<kBN>(bs, a.fb, (long long)kt * kBK, a.c, n0);
      },
      [&](int) { return 1; }, wm, wn);

  // xs = bf16(feats Wx_feat + frac_b Wx_rel + corner_bias), the primal's
  // elements of this thread, kept in f32 registers.
  float xs[NT][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long r = min(r0 + wm * 16 + g + 8 * half, a.rows - 1);
    const long long p = r >> D;
    const int k = (int)(r & (J::kCorners - 1));
    float fr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) fr[d] = rnd<bf16>(a.frac[p * D + d]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = min(n0 + (wn * NT + j) * 8 + 2 * t + e, a.w - 1);
        float xr = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d)
          xr += fr[d] * to_f32(a.wxr[(long long)d * a.s + col]);
        const float cb = a.cb[(long long)k * a.s + col];
        xs[j][2 * half + e] = rnd<bf16>(acc[0][j][2 * half + e] + (xr + cb));
        acc[0][j][2 * half + e] = 0.f;
      }
  }
  if constexpr (MT > 1) {
    __syncthreads();  // every warp is done with the ring
    mainloop<MT, NT, false, true>(
        acc, smem, cdiv(a.kh, kBK),
        [&](int kt, bf16* as, bf16* bs) {
          load_rows<MT>(as, a.a, r0, kt * kBK);
          load_cols<kBN>(bs, a.b, (long long)kt * kBK, a.kh, n0);
        },
        [&](int) { return MT; }, wm, wn);
  }

  // Epilogue: pre = hidden product + xs on the primal, tangents + Wx_rel
  // row; the primal's mask on every chain, in registers. A thread holds
  // columns n, n + 1 of a row: one pair store a chain where w is even.
  const long long plane = a.rows * a.w;
  const bool pair = a.w % 2 == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long r = r0 + wm * 16 + g + 8 * half;
    if (r >= a.rows) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + (wn * NT + j) * 8 + 2 * t;
      if (n >= a.w) continue;
      float v[D + 1][2];
      uint8_t pos[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = min(n + e, a.w - 1);  // in range; stored if < w
        const float pre = acc[0][j][2 * half + e] + xs[j][2 * half + e];
        pos[e] = pre >= 0.f;
        const float m = pos[e] ? 1.f : a.slope;
        v[0][e] = m * pre;
#pragma unroll
        for (int c = 1; c <= D; ++c) {
          float tan = to_f32(a.wxr[(long long)(c - 1) * a.s + col]);
          if constexpr (MT > 1) tan = acc[c][j][2 * half + e] + tan;
          v[c][e] = m * tan;
        }
      }
      const long long o = r * a.w + n;
      if (pair) {
#pragma unroll
        for (int c = 0; c <= D; ++c) {
          if (a.xb)
            *reinterpret_cast<__nv_bfloat162*>(a.xb + o + c * plane) =
                __floats2bfloat162_rn(v[c][0], v[c][1]);
          else
            *reinterpret_cast<float2*>(a.xf + o + c * plane) =
                make_float2(v[c][0], v[c][1]);
        }
        *reinterpret_cast<uchar2*>(a.mask + o) = make_uchar2(pos[0], pos[1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= a.w) continue;
#pragma unroll
          for (int c = 0; c <= D; ++c) {
            if (a.xb)
              a.xb[o + e + c * plane] = __float2bfloat16_rn(v[c][e]);
            else
              a.xf[o + e + c * plane] = v[c][e];
          }
          a.mask[o + e] = pos[e];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C (+)= A @ B^T for B given as rows [N, K]: the backward's P_i Wh_i^T with
// the next layer's mask applied in registers (kChain: A is chain planes, C
// is written in bf16 chain planes and its primal plane also in f32), and
// P_i[primal] Wx_feat^T added to d feats (f32 plain rows).

struct NTArgs {
  Mat a;                // [rows, K] (chain planes or plain rows)
  Mat b;                // [N, K]
  bf16* cb;             // kChain: row rr of slot s at cb + s cplane + rr ldc
  float* c;             // kChain: the primal plane; else the output rows
  long long ldc, cplane, cstep;
  int n, k, accumulate, col_blocks;
  const uint8_t* mask;  // [R, mask_ld] (kChain)
  int mask_ld;
  float slope;
};

template <int MT, int NT, bool kChain>
__global__ void __launch_bounds__(kThreads, 1) gemm_nt_kernel(NTArgs a) {
  constexpr int kBN = block_cols<NT>();
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  int wm, wn, g, t;
  warp_coords(wm, wn, g, t);
  const long long r0 =
      (long long)(blockIdx.x / a.col_blocks) * (kChain ? kT : MT * kT);
  const int n0 = (blockIdx.x % a.col_blocks) * kBN;
  float acc[MT][NT][4];
  zero(acc);
  mainloop<MT, NT, false, false>(
      acc, smem, cdiv(a.k, kBK),
      [&](int kt, bf16* as, bf16* bs) {
        load_rows<MT>(as, a.a, r0, kt * kBK);
        load_rows<kBN / kT>(bs, a.b, n0, kt * kBK);
      },
      [&](int) { return MT; }, wm, wn);
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
        if (kChain && rw < a.a.rows && n + e < a.n &&
            !a.mask[rw * a.mask_ld + n + e])
          m[e] = a.slope;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const long long rr = rw + mi * a.cstep;
        if (rr >= a.a.rows) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= a.n) continue;
          const float v = m[e] * acc[mi][j][2 * half + e];
          const long long o = rr * a.ldc + n + e;
          if (kChain) {
            a.cb[mi * a.cplane + o] = __float2bfloat16_rn(v);
            if (mi == 0) a.c[o] = v;
          } else {
            a.c[o] = a.accumulate ? a.c[o] + v : v;
          }
        }
      }
    }
  }
}

// part[z][KA, NB] = sum over rows m of chunk z of A[m, :]^T B[m, :]: split-K
// partials, each over at most `chunk` rows; both operands k-major.
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
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  int wm, wn, g, t;
  warp_coords(wm, wn, g, t);
  const int i0 = (blockIdx.x / a.col_blocks) * (MT * kT);
  const int n0 = (blockIdx.x % a.col_blocks) * kBN;
  const long long m0 = (long long)blockIdx.y * a.chunk;
  const long long m1 = min(a.m, m0 + a.chunk);
  float acc[MT][NT][4];
  zero(acc);
  mainloop<MT, NT, true, true>(
      acc, smem, cdiv(m1 - m0, kBK),
      [&](int kt, bf16* as, bf16* bs) {
        const long long k0 = m0 + (long long)kt * kBK;
        load_cols<MT * kT>(as, a.a, k0, m1, i0);
        load_cols<kBN>(bs, a.b, k0, m1, n0);
      },
      [&](int) { return MT; }, wm, wn);
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

// ---------------------------------------------------------------------------
// Host side.

template <int MT>
constexpr int layer_smem() {
  return mainloop_smem<MT, kLayerNT, false, true>();
}
template <int MT, int NT>
constexpr int nt_smem() {
  return mainloop_smem<MT, NT, false, false>();
}
template <int MT>
constexpr int tn_smem() {
  return mainloop_smem<MT, kPlainNT, true, true>();
}

int tn_mt(int ka) { return ka <= 2 * kT ? 2 : kPlainMT; }

int tn_tiles(int ka, int nb) {
  return cdiv(ka, tn_mt(ka) * kT) * cdiv(nb, block_cols<kPlainNT>());
}

long long tn_partial_floats(long long m, int ka, int nb) {
  int chunks;
  chunk_rows(m, tn_tiles(ka, nb), kBK, &chunks);
  return (long long)chunks * ka * nb;
}

// Forward workspace: bf16 chains of layers 0-3, f32 chains of layer 4,
// masks (bytes).
long long fwd_workspace_bytes(const Shape& sh) {
  const long long chains = sh.rows * (sh.dim + 1);
  return chains * (sh.s - sh.w[kLayers - 1]) * 2 +
         chains * sh.w[kLayers - 1] * 4 + sh.rows * sh.s;
}

void fwd_views(const Shape& sh, void* ws, bf16* xb[kLayers - 1], float** x4,
               uint8_t* mask[kLayers]) {
  const long long chains = sh.rows * (sh.dim + 1);
  bf16* b = static_cast<bf16*>(ws);
  for (int i = 0; i < kLayers - 1; ++i) {
    xb[i] = b;
    b += chains * sh.w[i];
  }
  *x4 = reinterpret_cast<float*>(b);
  uint8_t* m = reinterpret_cast<uint8_t*>(*x4 + chains * sh.w[kLayers - 1]);
  for (int i = 0; i < kLayers; ++i) {
    mask[i] = m;
    m += sh.rows * sh.w[i];
  }
}

// Backward scratch: partial sums (floats), the f32 primal planes of P (16 nf
// and 8 nf wide, alternating layers), then P's bf16 chain buffers.
struct BwdLayout {
  long long part, fa, fb, ba, bb;  // element counts
};

BwdLayout bwd_layout(const Shape& sh) {
  const int chains = sh.dim + 1, corners = 1 << sh.dim;
  BwdLayout l{};
  l.fa = sh.rows * sh.w[0];
  l.fb = sh.rows * sh.w[1];
  l.ba = l.fa * chains;
  l.bb = l.fb * chains;
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
  l.part = (p + 3) / 4 * 4;  // keeps the planes after it 16-byte aligned
  return l;
}

long long bwd_workspace_bytes(const Shape& sh) {
  const BwdLayout l = bwd_layout(sh);
  return (l.part + l.fa + l.fb) * 4 + (l.ba + l.bb) * 2;
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

template <int MT, int NT, bool kChain>
int gemm_nt(const Mat& a, const Mat& b, bf16* cb, float* c, long long ldc,
            long long cplane, int n, int k, int accumulate,
            const uint8_t* mask, int mask_ld, float slope, cudaStream_t st) {
  if (a.rows == 0) return 0;
  const int cbk = cdiv(n, block_cols<NT>());
  const int row_blocks = cdiv(a.rows, kChain ? kT : MT * kT);
  NTArgs g{a, b, cb, c, ldc, cplane, kChain ? 0 : kT, n, k, accumulate, cbk,
           mask, mask_ld, slope};
  STPDE_SMEM((gemm_nt_kernel<MT, NT, kChain>), (nt_smem<MT, NT>()));
  gemm_nt_kernel<MT, NT, kChain>
      <<<row_blocks * cbk, kThreads, nt_smem<MT, NT>(), st>>>(g);
  STPDE_LAUNCH_CHECK();
  return 0;
}

template <class J>
int run_forward(const Shape& sh, const bf16* feats, const float* frac,
                const Weights& wt, float* out, void* ws, float slope,
                cudaStream_t st) {
  constexpr int D = J::kDim, MT = J::kChains;
  bf16* xb[kLayers - 1];
  float* x4;
  uint8_t* mask[kLayers];
  fwd_views(sh, ws, xb, &x4, mask);
  STPDE_SMEM((jet_layer_kernel<D, 1>), layer_smem<1>());
  STPDE_SMEM((jet_layer_kernel<D, MT>), layer_smem<MT>());
  const Mat fa = mat(feats, sh.c, sh.rows, sh.c);
  for (int i = 0; i < kLayers; ++i) {
    const int kp = i ? sh.w[i - 1] : 0, w = sh.w[i];
    const Mat a = i ? mat(xb[i - 1], kp, sh.rows, kp, sh.rows * kp) : fa;
    const Mat b = i ? mat(wt.wh[i - 1], w, kp, w) : fa;
    const int cb = cdiv(w, block_cols<kLayerNT>());
    const bool last = i == kLayers - 1;
    LayerArgs a_{a, b, fa, mat(wt.wx_feat + sh.off[i], sh.s, sh.c, w), kp,
                 sh.c, frac, wt.wx_rel + sh.off[i],
                 wt.corner_bias + sh.off[i], sh.s, last ? nullptr : xb[i],
                 last ? x4 : nullptr, mask[i], sh.rows, w, cb, slope};
    const int blocks = cdiv(sh.rows, kT) * cb;
    if (i == 0)
      jet_layer_kernel<D, 1><<<blocks, kThreads, layer_smem<1>(), st>>>(a_);
    else
      jet_layer_kernel<D, MT><<<blocks, kThreads, layer_smem<MT>(), st>>>(a_);
    STPDE_LAUNCH_CHECK();
  }
  const size_t smem =
      sizeof(float) * (size_t)J::kBlocksOut * (J::kRowsPerPoint + sh.nf);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  jet_head_fwd_kernel<D, bf16>
      <<<cdiv(sh.n, kHeadPoints), head_threads(sh.nf), smem, st>>>(
          x4, frac, wt.w5, wt.b5, out, sh.n, sh.nf, sh.out_dim, kHeadPoints);
  STPDE_LAUNCH_CHECK();
  return 0;
}

template <class J>
int run_backward(const Shape& sh, const bf16* feats, const float* frac,
                 const Weights& wt, void* fws, const float* ybar,
                 float* dfeats, const Grads& gr, void* bws, float slope,
                 cudaStream_t st) {
  constexpr int D = J::kDim;
  bf16* x[kLayers - 1];
  float* x4;
  uint8_t* mask[kLayers];
  fwd_views(sh, fws, x, &x4, mask);
  const BwdLayout l = bwd_layout(sh);
  float* part = static_cast<float*>(bws);
  float* pf[2] = {part + l.part, part + l.part + l.fa};
  bf16* pb[2] = {reinterpret_cast<bf16*>(pf[1] + l.fb), nullptr};
  pb[1] = pb[0] + l.ba;
  const long long mrows = sh.rows * J::kChains;

  // Head: P_4 into buffer 0 (layer widths alternate buffers: 4, 2, 0 -> 0).
  const int hblocks = cdiv(sh.n, kHeadPoints);
  jet_head_bwd_kernel<D, bf16><<<hblocks, head_threads(sh.nf), 0, st>>>(
      x4, mask[4], frac, wt.w5, ybar, pb[0], pf[0], part, sh.n, sh.nf,
      sh.out_dim, slope, kHeadPoints);
  STPDE_LAUNCH_CHECK();
  const long long hstride = (long long)sh.nf * sh.out_dim + sh.out_dim;
  int e = reduce(part, hblocks, hstride, sh.nf, sh.out_dim, gr.w5,
                 sh.out_dim, st);
  if (e) return e;
  e = reduce(part + (long long)sh.nf * sh.out_dim, hblocks, hstride, 1,
             sh.out_dim, gr.b5, sh.out_dim, st);
  if (e) return e;

  const Mat fa = mat(feats, sh.c, sh.rows, sh.c);
  int cur = 0;
  for (int i = kLayers - 1; i >= 0; --i) {
    const int w = sh.w[i];
    const Mat pm = mat(pb[cur], w, sh.rows, w, 0, kT);  // P_i[primal] rows
    if (i > 0) {
      const int kp = sh.w[i - 1];
      e = gemm_tn(mat(x[i - 1], kp, mrows, kp), mat(pb[cur], w, mrows, w),
                  mrows, kp, w, part, gr.wh[i - 1], w, st);
      if (e) return e;
    }
    e = gemm_tn(fa, pm, sh.rows, sh.c, w, part, gr.wx_feat + sh.off[i], sh.s,
                st);
    if (e) return e;
    int ppc;
    const int bchunks = bias_chunks(sh, w, &ppc);
    const int v = bias_vec(w);
    const dim3 grid(cdiv(cdiv(w, v), kBiasCols), bchunks);
    const dim3 block(kBiasCols, kBiasLanes);
    if (v == 4)
      bias_grad_kernel<D, 4, bf16><<<grid, block, 0, st>>>(
          pf[cur], pb[cur], frac, sh.n, w, ppc, part);
    else
      bias_grad_kernel<D, 1, bf16><<<grid, block, 0, st>>>(
          pf[cur], pb[cur], frac, sh.n, w, ppc, part);
    STPDE_LAUNCH_CHECK();
    const long long bstride = (long long)(J::kCorners + D) * w;
    e = reduce(part, bchunks, bstride, J::kCorners, w,
               gr.corner_bias + sh.off[i], sh.s, st);
    if (e) return e;
    e = reduce(part + (long long)J::kCorners * w, bchunks, bstride, D, w,
               gr.wx_rel + sh.off[i], sh.s, st);
    if (e) return e;
    e = gemm_nt<kPlainMT, kFeatNT, false>(
        pm, mat(wt.wx_feat + sh.off[i], sh.s, sh.c, w, 0, kT), nullptr,
        dfeats, sh.c, 0, sh.c, w, i != kLayers - 1, nullptr, 0, slope, st);
    if (e) return e;
    if (i > 0) {
      const int kp = sh.w[i - 1];
      e = gemm_nt<J::kChains, kBackNT, true>(
          mat(pb[cur], w, sh.rows, w, sh.rows * w),
          mat(wt.wh[i - 1], w, kp, w, 0, kT), pb[1 - cur], pf[1 - cur], kp,
          sh.rows * kp, kp, w, 0, mask[i - 1], kp, slope, st);
      if (e) return e;
      cur = 1 - cur;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Workspace bytes the bf16 forward writes (and its backward reads): the
// chains of every layer and the masks. -1 for a shape the kernels do not
// take.
long long stpde_jet_fwd_bf16_workspace(int n, int c, int dim, int nf,
                                       int out_dim) {
  Shape sh;
  return make_shape(n, c, dim, nf, out_dim, &sh) ? fwd_workspace_bytes(sh)
                                                 : -1;
}

// Scratch bytes of the bf16 backward.
long long stpde_jet_bwd_bf16_workspace(int n, int c, int dim, int nf,
                                       int out_dim) {
  Shape sh;
  return make_shape(n, c, dim, nf, out_dim, &sh) ? bwd_workspace_bytes(sh)
                                                 : -1;
}

// feats2 [N * 2^D, C] bf16, frac [N, D] f32, packed weights (wx_feat,
// wx_rel, wh1..4, w5 bf16; corner_bias, b5 f32) -> out [N, 1 + D +
// D(D+1)/2, out_dim] f32; workspace: stpde_jet_fwd_bf16_workspace bytes.
int stpde_jet_fwd_bf16(const void* feats2, const float* frac,
                       const void* wx_feat, const void* wx_rel,
                       const float* corner_bias, const void* wh1,
                       const void* wh2, const void* wh3, const void* wh4,
                       const void* w5, const float* b5, float* out,
                       void* workspace, int n, int c, int dim, int nf,
                       int out_dim, float slope, void* stream) {
  Shape sh;
  if (!make_shape(n, c, dim, nf, out_dim, &sh))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  auto p = [](const void* q) { return static_cast<const bf16*>(q); };
  const Weights wt{p(wx_feat), p(wx_rel), corner_bias,
                   {p(wh1), p(wh2), p(wh3), p(wh4)}, p(w5), b5};
  return by_dim(sh, [&](auto j) {
    return run_forward<decltype(j)>(sh, p(feats2), frac, wt, out, workspace,
                                    slope, (cudaStream_t)stream);
  });
}

// Backward of stpde_jet_fwd_bf16 for the f32 cotangent ybar (same layout as
// out), reading the forward's workspace: d feats2 and the 9 packed-param
// grads, every one f32, each written whole.
int stpde_jet_bwd_bf16(const void* feats2, const float* frac,
                       const void* wx_feat, const void* wx_rel,
                       const float* corner_bias, const void* wh1,
                       const void* wh2, const void* wh3, const void* wh4,
                       const void* w5, const float* b5, void* fwd_workspace,
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
  auto p = [](const void* q) { return static_cast<const bf16*>(q); };
  const Weights wt{p(wx_feat), p(wx_rel), corner_bias,
                   {p(wh1), p(wh2), p(wh3), p(wh4)}, p(w5), b5};
  const Grads gr{d_wx_feat, d_wx_rel, d_corner_bias,
                 {d_wh1, d_wh2, d_wh3, d_wh4}, d_w5, d_b5};
  return by_dim(sh, [&](auto j) {
    return run_backward<decltype(j)>(sh, p(feats2), frac, wt, fwd_workspace,
                                     ybar, dfeats, gr, workspace, slope, st);
  });
}

}  // extern "C"
