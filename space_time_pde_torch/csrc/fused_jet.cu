// Derivative jet of the local-implicit-grid decode, forward and backward,
// for Hopper (sm_90a): every matrix product in 3xTF32 on wgmma, each k8
// step's products promoted into an f32 accumulator.
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
// D = 3 / 4. Bytes: the forward's inputs and outputs are 22 MB, but it
// also writes the workspace that the backward reads back (every layer's
// chains and masks, 2.21 / 2.73 GB: 0.66 / 0.82 ms each way). Both are
// bound by operations, which only wgmma issues at the card's TF32 rate.
//
// 3xTF32, promoted (as csrc/fused_query.cu): an operand x splits into hi =
// tf32(x) and lo = tf32(x - hi) (round to nearest, ties away), a product is
// lo_a hi_b + hi_a lo_b + hi_a hi_b (small ones first). The tensor cores
// truncate as they accumulate, so each k8 step's three products go into a
// 16-register temporary that only wgmma writes (its first product
// overwrites), and the temporary is added to an f32 accumulator that only
// that FADD writes (round to nearest).
//
// DESIGN. Every product of both kernels runs through one persistent,
// warp-specialised kernel (gemm_kernel<P>), templated on the problem P,
// which gives the operand boxes of each stage and the epilogue of each
// item (the shape of csrc/fused_jet_bf16.cu):
//   FwdLayer<D>  layer i of the forward, an item = 64 corner rows x (D + 1)
//                chains x 2 kN columns: the accumulators start at the skip
//                term's coordinate part and corner bias (primal) and the
//                Wx_rel rows (tangents), in f32; the skip product feats
//                Wx_feat[:, sl_i] on the primal (K = C), then the hidden
//                product X_{i-1} Wh_i on every chain (K = w_{i-1}; none at
//                layer 0); the primal's sign picks every chain's mask;
//   Nt<D+1, true>  P_{i-1} = (P_i Wh_i^T) * mask_{i-1}, the same item;
//   Nt<4, false>   d feats2 (+)= P_i[primal] Wx_feat[:, sl_i]^T, 256 plain
//                rows x 2 kFeatCols columns an item;
//   Tn<MT>       split-K partials of A^T B over rows (dWh_i = X_{i-1}^T P_i
//                over (D + 1) R chain rows, dWx_feat = feats^T P_i[primal]
//                over R): 64 MT x 128 outputs an item (MT = 1, 2 or 4 by
//                the width), one chunk of rows (a multiple of a stage) an
//                item, each chunk's partial written once and summed by
//                reduce_kernel in a fixed order.
// The head, the bias-side sums and the reductions stay the FFMA kernels of
// csrc/jet_common.cuh.
// - wgmma.mma_async m64n32k8 .tf32, A from registers, B from shared memory.
//   .tf32 takes both operands K-major only (no transpose bit).
// - A CTA is 3 warpgroups (384 threads), one a SM, the grid min(items,
//   SMs), each CTA walking items t = blockIdx.x + k gridDim.x. Warpgroup 0
//   produces (56 registers after setmaxnreg) into a ring of `stages`
//   slots, each MT A tiles (8 KB: 64 rows x 32 f32, the 128-byte swizzle)
//   and the two consumers' B blocks (kN columns x 32 K, hi and lo); full /
//   empty mbarriers. Thread 0 issues the A tiles as TMA boxes through 3-D
//   tensor maps (a chain operand's planes are its chains; zero past the
//   edges) where every A operand is 16-byte aligned, else all 128 producer
//   threads copy them into the same swizzled image (C = 5, widths below 4);
//   then every producer thread arrives (129 arrivals a phase with the
//   expect_tx).
// - The weights' B (forward: Wx_feat[:, sl_i]^T and Wh_i^T; backward: Wh_i
//   and Wx_feat[:, sl_i]) is one image, split on the device at the start of
//   stpde_jet_fwd (weight_image_kernel: a step's work, no host tensor, so
//   the captured step rebuilds it from the updated weights) into the exact
//   shared-memory image of wgmma's K-major, no-swizzle B: per item column
//   block and stage, both consumers' blocks, each 4 k8 steps of [hi plane,
//   lo plane] x [8-column group][2 k halves][8 columns][4 k]. A stage's B
//   is one contiguous bulk copy. The image follows the forward's masks in
//   its workspace (ops/fused_jet.py::workspace_masks and every reader of
//   the chains are unchanged); the backward reads it there.
// - The TN products' B is an activation (P_i), whose rows are the
//   reduction: the producer threads copy each value of its f32 tile into
//   its K-major place in the hi plane (cp.async, 4 bytes; a warp's copy
//   reads 128 contiguous bytes of a row), and a stage later, once the
//   copies landed, split them there into the hi and lo planes (16 bytes a
//   thread and access), fence them to the async proxy and arrive: the
//   copies' latency hides behind a stage. A thread moves 4 K values of one
//   column at a time: with one value a thread and access, the producer's
//   instructions (on sub-partitions it shares with the consumers) held the
//   weight gradients at 29-31% of their bound; without the transform they
//   ran at 53%.
// - A's fragment comes from the f32 tile in shared memory: row-major A
//   (activations [rows][K]) as two 16-byte loads a row, its 4 k8 steps'
//   fragments at once (a step's k = t and t + 4 of a thread are columns 8t
//   + 2s and 8t + 2s + 1 of the 32-column tile: the weight image permutes
//   K the same way); the TN products' A (X^T, read from [K rows][M]) as
//   4-byte loads, a step's k = t and t + 4 at rows 2t and 2t + 1 (the
//   producer's B the same). Either way free of bank conflicts under the
//   swizzle. Split into hi / lo in registers, double-buffered.
// - Consumers: two warpgroups (224 registers), each kN columns of the
//   item: kN = 64 at D = 3 (4 x 32 accumulators), 32 at D = 4 (5 x 16), 32
//   for d feats, 64 for the TN products. Per k8 step, m tile and 32-column
//   block, the three products go into one of two 16-register temporaries:
//   block b's wgmmas fly while block b - 1's temporary is added. Every
//   wgmma sits on no conditional path; ptxas serializes none (its C7520).
// - Epilogues stage the chain planes through each consumer warp's own 16
//   rows of shared memory and store whole rows in 16-byte stores, chain by
//   chain, then the mask (the store loop rolled). They take 12-14% of the
//   forward and 7% of the backward (a build without them); TMA stores from
//   the same rows, with these stores kept for unaligned widths, made ptxas
//   spill 0.4-2 KB in the chain problems and ran the forward 1.6x slower.
// - Deterministic: every output element is computed by the same operations
//   wherever its item lands and written once; the split-K chunk plan is a
//   function of the shape (jet_common.cuh::chunk_rows); no atomics.
//
// BUDGET (f32_ring; ops/fused_jet.py::f32_ring mirrors it): a stage is MT
// 8 KB A tiles and 2 x kN x 256 B of B; the ring takes as many stages as
// fit 227 KB, 2 to 6, with 1 KB of alignment, 1 KB of mbarriers and
// (forward, chain product) 8 warps x 16 rows x 4 kN B of staging. Forward
// and chain product at D = 3 (MT = 4, kN = 64): 3 stages of 64 KB,
// 231,424 B; at D = 4 (MT = 5, kN = 32): 3 of 56 KB, 190,464 B; Tn<4>: 3 x
// 64 KB; Tn<2>: 4 x 48 KB; Tn<1>: 5 x 40 KB; Nt<4, false>: 4 x 48 KB. A
// plan with fewer than 2 stages is refused (cudaErrorInvalidValue).
//
// WORKSPACE (stpde_jet_fwd_workspace bytes): every layer's chain planes,
// f32 [D+1][R][w_i] (R = N 2^D corner rows, plane 0 the primal), then every
// layer's masks, bytes [R][w_i] (1 where the primal pre-activation >= 0),
// then, 128-byte aligned, the weight image (stpde_jet_f32_image_layout).
// The backward's scratch (stpde_jet_bwd_workspace bytes): two chain
// buffers for P (16 nf and 8 nf wide, alternating layers) and one
// partial-sum buffer for every reduction.
//
// Limits: make_shape's (D = 3 or 4, C >= 1, 1 <= nf <= 1024, out <= 8).
// Times, shares of the bound, registers and spills: PERF.md section 6
// (scripts/time_bf16_jet.py --dtype float32, chip_smoke.py phases 2, 4, 11).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (space_time_pde_torch/ops/_build.py). wgmma and setmaxnreg exist
// only on sm_90a.

#include <cuda.h>
#include <cudaTypedefs.h>

#include "jet_common.cuh"

namespace {

constexpr int kTileRows = 64;                      // rows of an A tile (m64)
constexpr int kBK = 32;                            // K of a stage: 128 B of f32
constexpr int kTileBytes = kTileRows * kBK * 4;    // 8 KB
constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kProducerThreads = 128;
constexpr int kGemmThreads = 128 * (1 + kConsumers);
constexpr int kFullArrivals = 1 + kProducerThreads;
constexpr int kMinStages = 2, kMaxStages = 6;
constexpr int kMaxSmem = 232448;                   // 227 KB, a CTA's most
constexpr int kAlign = 1024;                       // a 128-byte-swizzle atom
constexpr int kBarBytes = 1024;                    // the ring's mbarriers
constexpr int kStagingRows = 16;                   // a consumer warp's rows
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kMaxBoxes = 8;
constexpr int kImageAlign = 128;                   // the image's offset
constexpr int kSegments = 4 * kLayers;             // image segments, at most
constexpr int kTN = 32;                            // columns of a temporary

// Columns a consumer warpgroup owns: the forward layers and the chain
// product 64 at D = 3 and 32 at D = 4 (five chains of accumulators), d
// feats 32 (C = 64 is one item), the weight gradients 64.
__host__ __device__ constexpr int chain_cols(int dim) {
  return dim == 3 ? 64 : 32;
}
constexpr int kFeatCols = 32, kTnCols = 64;

// Bytes of a consumer's B block a stage: kn columns x kBK, hi and lo.
__host__ __device__ constexpr int b_bytes(int kn) { return kn * kBK * 8; }
// Staging bytes of the epilogues that store chain planes.
__host__ __device__ constexpr int staging_bytes(int kn) {
  return 4 * kConsumers * kStagingRows * 4 * kn;
}

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

// An f32 A operand in device memory: `planes` matrices `plane` values
// apart, each [rows, cols] with row stride ld: (plane z, row r, column c)
// at p + z plane + r ld + c, zero outside. Tiles of box_rows x 32 columns.
// vec: p is 16-byte aligned and ld and plane are multiples of 4, so it
// loads by TMA through `map` (a 3-D tensor map, 128-byte swizzle), else by
// the producer threads' 4-byte loads.
struct Operand {
  CUtensorMap map;
  const float* p;
  long long ld, plane, rows;
  int cols, box_rows, vec;
};

// One box of a stage: rows [row, row + box_rows) x columns [col, col + 32)
// of plane z of operand `op`, at byte `off` of the slot.
struct Box {
  int op, off, z;
  long long row, col;
};

// --- host: tensor maps -------------------------------------------------------

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    cudaGetLastError();
  }
  return fn;
}

// The operand, its tensor map encoded where it is TMA-aligned. False if
// cuTensorMapEncodeTiled is missing or refused the map.
bool operand(Operand* o, const float* p, long long ld, long long rows,
             int cols, int box_rows, long long planes = 1,
             long long plane = 0) {
  if (planes == 1) plane = rows * ld;
  o->p = p, o->ld = ld, o->plane = plane, o->rows = rows, o->cols = cols;
  o->box_rows = box_rows;
  o->vec = (uintptr_t)p % 16 == 0 && ld % 4 == 0 && plane % 4 == 0 &&
           rows > 0 && cols > 0;
  if (!o->vec) return true;
  const auto fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)plane * 4};
  const cuuint32_t box[3] = {kBK, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(&o->map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<float*>(p), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// --- PTX ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the phase of parity `parity` to complete. A wait that outlasts
// 10 s (far beyond any stage's time) traps, so that a schedule fault ends
// the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// A box of a 3-D tensor map into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16) into shared memory, counted
// on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A 4-byte copy into shared memory (0 where bytes is 0), in the current
// cp.async group.
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kN_>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kN_) : "memory");
}

// Keeps the compiler from reading a temporary before the wait that ends
// the wgmmas writing it.
template <int kR>
__device__ __forceinline__ void fence_regs(float (&d)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Round to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32 for
// every finite x), in two integer operations; ops/fused_jet.py::_tf32
// rounds the image's mirror the same way.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// A K-major, no-swizzle shared-memory operand: 8-row x 16-byte core
// matrices of 128 contiguous bytes, the two k halves of a k8 step 128
// bytes apart (leading byte offset), 8-column groups 256 bytes apart.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// m64n32k8, tf32 x tf32 -> f32, A from registers (its m64 x k8 fragment:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of each
// warp's 16 rows), B from shared memory (K-major): D = A B + (scale_d ? D :
// 0).
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// --- the ring and the producer ----------------------------------------------

// The ring's position, the same sequence in the producer and the consumers.
struct Ring {
  uint32_t slots, bars;  // slot 0; full[i] at bars + 8 i, empty after them
  int n, bytes, stage, phase;
  __device__ uint32_t full() const { return bars + 8 * stage; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (n + s); }
  __device__ uint32_t slot() const { return slots + stage * bytes; }
  __device__ void advance() {
    if (++stage == n) stage = 0, phase ^= 1;
  }
};

// The copying path, for an A operand that is not TMA-aligned: the box into
// the swizzled image TMA writes (row r at dst + 128 r, its 16-byte chunk j
// at chunk j ^ (r & 7)), zero outside the operand. All producer threads.
__device__ __forceinline__ void copy_box(unsigned char* dst,
                                         const Operand& o, const Box& b,
                                         int tid) {
  const float* p = o.p + b.z * o.plane;
  for (int i = tid; i < o.box_rows * kBK; i += kProducerThreads) {
    const int r = i / kBK, c = i % kBK;
    const long long rr = b.row + r, cc = b.col + c;
    const float v = rr < o.rows && cc < o.cols ? p[rr * o.ld + cc] : 0.f;
    *reinterpret_cast<float*>(dst + r * 128 + (((c >> 2) ^ (r & 7)) << 4) +
                              4 * (c & 3)) = v;
  }
}

// The producer (warpgroup 0): every stage of every item and pass of P, in
// the consumers' order. Thread 0 counts the stage's asynchronous bytes on
// its full barrier (TMA boxes, the B block's bulk copy) and issues them;
// every producer thread then copies what TMA does not (unaligned A
// operands), fences it to the async proxy and arrives. The TN products'
// B (kTransform) is copied by cp.async into place and split a stage later:
// each stage's copies are issued before the previous stage's are waited
// for, split and published, so their latency hides behind a stage.
template <class P>
__device__ __forceinline__ void produce(const P& p, Ring w,
                                        unsigned char* gbase, int tid) {
  constexpr int kB = kConsumers * b_bytes(P::kN);
  const int items = p.items();
  unsigned char* pend = nullptr;  // kTransform: the stage to split next
  uint32_t pend_full = 0;
  for (int t = blockIdx.x; t < items; t += gridDim.x)
    for (int pass = 0; pass < P::kPasses; ++pass) {
      const int nk = p.stages_of(t, pass);
      for (int kt = 0; kt < nk; ++kt) {
        Box bx[kMaxBoxes];
        const int nb = p.boxes(t, pass, kt, bx);
        mbar_wait(w.empty(w.stage), w.phase ^ 1);
        unsigned char* slot = gbase + (w.slot() - w.slots);
        if (tid == 0) {
          int tx = P::kTransform ? 0 : kB;
          if (p.tma)
            for (int i = 0; i < nb; ++i) tx += 128 * p.op[bx[i].op].box_rows;
          if (tx)
            mbar_expect_tx(w.full(), tx);
          else
            mbar_arrive(w.full());
          if (p.tma)
            for (int i = 0; i < nb; ++i)
              tma_load(w.slot() + bx[i].off, &p.op[bx[i].op].map,
                       (int)bx[i].col, (int)bx[i].row, bx[i].z, w.full());
          if constexpr (!P::kTransform)
            bulk_load(w.slot() + P::kMT * kTileBytes, p.b_src(t, pass, kt),
                      kB, w.full());
        }
        if (!p.tma)
          for (int i = 0; i < nb; ++i)
            copy_box(slot + bx[i].off, p.op[bx[i].op], bx[i], tid);
        if constexpr (P::kTransform) {
          p.issue(t, kt, slot + P::kMT * kTileBytes, tid);
          if (pend) {
            cp_wait<1>();
            p.split(pend + P::kMT * kTileBytes, tid);
            fence_async_smem();
            mbar_arrive(pend_full);
          }
          pend = slot, pend_full = w.full();
        } else {
          fence_async_smem();
          mbar_arrive(w.full());
        }
        w.advance();
      }
    }
  if constexpr (P::kTransform) {
    if (pend) {
      cp_wait<0>();
      p.split(pend + P::kMT * kTileBytes, tid);
      fence_async_smem();
      mbar_arrive(pend_full);
    }
  }
}

// --- the consumers' mainloop ---------------------------------------------------

// What a consumer thread knows.
struct Consumer {
  int q;           // warpgroup: which kN columns of an item
  int warp, g, t;  // warp in the warpgroup; lane / 4, lane % 4
  int lane;
  bool releaser;   // arrives on a slot's empty barrier for the warpgroup
  unsigned char* out;  // the warp's staging rows
};

// A k8 step's A fragment, split into TF32 hi and lo.
struct Frag {
  uint32_t hi[4], lo[4];
};

// A row-major A tile's values of this thread for the stage's 4 k8 steps:
// rows g and g + 8 of the warp's 16, columns 8t .. 8t + 7 (two 16-byte
// loads a row). Step s takes k = t from column 8t + 2s and k = t + 4 from
// 8t + 2s + 1: raw[8h + 2s] and raw[8h + 2s + 1] for row g + 8h.
__device__ __forceinline__ void load_rows(float (&raw)[16],
                                          const unsigned char* tile,
                                          const Consumer& cs) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * cs.warp + cs.g + 8 * h;
    const unsigned char* row = tile + r * 128;
    const float4 u =
        *reinterpret_cast<const float4*>(row + (((2 * cs.t) ^ (r & 7)) << 4));
    const float4 v = *reinterpret_cast<const float4*>(
        row + (((2 * cs.t + 1) ^ (r & 7)) << 4));
    raw[8 * h + 0] = u.x, raw[8 * h + 1] = u.y, raw[8 * h + 2] = u.z;
    raw[8 * h + 3] = u.w, raw[8 * h + 4] = v.x, raw[8 * h + 5] = v.y;
    raw[8 * h + 6] = v.z, raw[8 * h + 7] = v.w;
  }
}

// The TN products' A (X^T) from an X tile [32 K rows][64 M] held as two
// boxes of 32 columns (4 KB apart): M rows g and g + 8 of the warp's 16;
// step s takes k = t from row 8s + 2t and k = t + 4 from row 8s + 2t + 1,
// in the same raw order as load_rows.
__device__ __forceinline__ void load_cols(float (&raw)[16],
                                          const unsigned char* tile,
                                          const Consumer& cs) {
  const unsigned char* box = tile + (cs.warp >> 1) * (kTileBytes / 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = 16 * (cs.warp & 1) + cs.g + 8 * h;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * s + 2 * cs.t + e;
        raw[8 * h + 2 * s + e] = *reinterpret_cast<const float*>(
            box + k * 128 + (((c >> 2) ^ (k & 7)) << 4) + 4 * (c & 3));
      }
  }
}

__device__ __forceinline__ void split_step(const float (&raw)[16], int s,
                                           Frag& f) {
  const float x[4] = {raw[2 * s], raw[8 + 2 * s], raw[2 * s + 1],
                      raw[9 + 2 * s]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = tf32(x[i]);
    f.lo[i] = tf32(x[i] - __uint_as_float(f.hi[i]));
  }
}

// acc[0 : MTP] += A tile m x this consumer's B block over `nk` stages, each
// k8 step promoted. Per stage: wait for its slot; per m tile, its 4 steps'
// A values; per step and 32-column block, the three products into one of
// NB temporaries (the first overwrites), committed, and the temporary of
// block NB - 1 blocks back added to its accumulators once its group is
// done (NB - 1 groups stay in flight; the A fragments rotate through NB
// buffers, so a fragment is rewritten only after its products are done);
// the last ones after the stage's final wait, then the slot is released
// (one arrive per warpgroup). Each accumulator takes its steps in K order.
template <int MTP, bool kTn, int NB, int MT, int NC>
__device__ __forceinline__ void mma_pass(float (&acc)[MT][NC], Ring& r,
                                         int nk, const Consumer& cs,
                                         const unsigned char* gbase) {
  static_assert(MTP <= MT, "more products than A tiles");
  static_assert(NB == 2 || NB == 3, "two or three temporaries");
  constexpr int NW = 2 * NC, H = NW / kTN, kBlocks = 4 * MTP * H;
  float tmp[NB][kTN / 2];
  Frag f[NB];
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(r.full(), r.phase);
    const uint32_t slot = r.slot();
    const unsigned char* a = gbase + (slot - r.slots);
    const uint32_t b = slot + MT * kTileBytes + cs.q * b_bytes(NW);
#pragma unroll
    for (int m = 0; m < MTP; ++m) {
      float raw[16];
      if constexpr (kTn)
        load_cols(raw, a + m * kTileBytes, cs);
      else
        load_rows(raw, a + m * kTileBytes, cs);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        Frag& fr = f[(4 * m + s) % NB];
        split_step(raw, s, fr);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int blk = (4 * m + s) * H + h;
          // This step's hi plane, then its lo plane, at this block's
          // columns.
          const uint32_t hi = b + s * (64 * NW) + h * (32 * kTN);
          const uint32_t lo = hi + 32 * NW;
          wg_fence();
          wgmma_n32(tmp[blk % NB], fr.lo, sdesc(hi), 0);
          wgmma_n32(tmp[blk % NB], fr.hi, sdesc(lo), 1);
          wgmma_n32(tmp[blk % NB], fr.hi, sdesc(hi), 1);
          wg_commit();
          if (blk >= NB - 1) {
            wg_wait<NB - 1>();  // block blk - NB + 1's products are done
            const int pb = blk - NB + 1, pm = pb / (4 * H), ph = pb % H;
            fence_regs(tmp[pb % NB]);
#pragma unroll
            for (int i = 0; i < kTN / 2; ++i)
              acc[pm][(kTN / 2) * ph + i] += tmp[pb % NB][i];
          }
        }
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int pb = kBlocks - NB + 1; pb < kBlocks; ++pb) {
      if (pb < 0) continue;
      const int pm = pb / (4 * H), ph = pb % H;
      fence_regs(tmp[pb % NB]);
#pragma unroll
      for (int i = 0; i < kTN / 2; ++i)
        acc[pm][(kTN / 2) * ph + i] += tmp[pb % NB][i];
    }
    if (cs.releaser) mbar_arrive(r.empty(r.stage));
    r.advance();
  }
}

template <int MT, int NC>
__device__ __forceinline__ void zero(float (&acc)[MT][NC]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[m][i] = 0.f;
}

// --- epilogue staging ------------------------------------------------------------
//
// A consumer warp holds rows g and g + 8 of its 16 rows of a tile, two
// adjacent columns in each 8-column group. Its outputs go through its own
// 16-row staging buffer (rows kRow bytes apart, 16-byte chunk c of row r
// at chunk c ^ (r & 7)) and leave as 16-byte stores, whole rows at a time.

template <int kRow>
__device__ __forceinline__ unsigned char* staged(unsigned char* buf, int r,
                                                 int byte) {
  return buf + r * kRow + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
}

// The edge of a row that 16-byte stores cannot take, out of line: the
// epilogues' code stays small.
__device__ __noinline__ void copy_bytes(unsigned char* g,
                                        const unsigned char* s, int n) {
  for (int e = 0; e < n; ++e) g[e] = s[e];
}

// The warp's staged rows (kRowBytes bytes each, kRow apart) to dst (row 0
// of the warp, its first column), rows_left rows and bytes_left bytes a
// row in range; 16-byte stores where `vec` (dst and ld 16-byte aligned),
// else bytes. The loop stays rolled.
template <int kRowBytes, int kRow>
__device__ __forceinline__ void flush(const unsigned char* buf,
                                      unsigned char* dst, long long ld,
                                      long long rows_left, int bytes_left,
                                      bool vec, int lane) {
  constexpr int kChunks = kRowBytes / 16;
  __syncwarp();
#pragma unroll 1
  for (int i = lane; i < kStagingRows * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks, b0 = 16 * c;
    if (r >= rows_left || b0 >= bytes_left) continue;
    const unsigned char* s = buf + r * kRow + ((c ^ (r & 7)) << 4);
    unsigned char* g = dst + r * ld + b0;
    if (vec && b0 + 16 <= bytes_left)
      *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(s);
    else
      copy_bytes(g, s, bytes_left - b0 < 16 ? bytes_left - b0 : 16);
  }
  __syncwarp();
}

// The warp's 16 rows x kN columns of m * acc (m: 1 where the bit of
// `bits` is set, else slope) as f32 rows at dst (row stride ld floats).
template <int kN>
__device__ __forceinline__ void store_chain(const float (&acc)[kN / 2],
                                            uint32_t bits, float slope,
                                            float* dst, long long ld,
                                            long long left, int cols,
                                            bool vec, const Consumer& cs) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int i = 4 * j + 2 * h, col = 8 * j + 2 * cs.t;
      *reinterpret_cast<float2*>(
          staged<4 * kN>(cs.out, cs.g + 8 * h, 4 * col)) =
          make_float2(((bits >> i) & 1 ? 1.f : slope) * acc[i],
                      ((bits >> (i + 1)) & 1 ? 1.f : slope) * acc[i + 1]);
    }
  flush<4 * kN, 4 * kN>(cs.out, reinterpret_cast<unsigned char*>(dst),
                        4 * ld, left, 4 * cols, vec, cs.lane);
}

// --- the kernel ------------------------------------------------------------------

// The persistent product kernel of problem P (see the header).
template <class P>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_kernel(const __grid_constant__ P p) {
  extern __shared__ __align__(kAlign) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  unsigned char* gbase = smem_raw + (base - raw);
  const int bytes = P::kMT * kTileBytes + kConsumers * b_bytes(P::kN);
  Ring r{base, base + p.stages * bytes, p.stages, bytes, 0, 0};
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(r.bars + 8 * i, kFullArrivals);
      mbar_init(r.bars + 8 * (p.stages + i), kConsumers);
    }
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    produce(p, r, gbase, (int)threadIdx.x);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int ct = threadIdx.x - 128, lane = ct & 31;
    Consumer cs{ct >> 7, (ct & 127) >> 5, lane >> 2, lane & 3, lane,
                (ct & 127) == 0,
                gbase + p.stages * bytes + kBarBytes +
                    (ct >> 5) * kStagingRows * 4 * P::kN};
    float acc[P::kMT][P::kN / 2];
    const int items = p.items();
    for (int t = blockIdx.x; t < items; t += gridDim.x)
      p.tile(t, acc, r, cs, gbase);
  }
}

// --- the problems ----------------------------------------------------------------

// Forward layer i of the jet: X_i for every chain row (see the header).
// Operands: 0 feats [R, C], 1 X_{i-1} (D + 1 planes [R, kp]); B: the
// image's segments of Wx_feat[:, sl_i]^T (pass 0) and Wh_i^T (pass 1).
template <int D>
struct FwdLayer {
  static constexpr int kMT = D + 1, kPasses = 2, kN = chain_cols(D);
  static constexpr int kOut = staging_bytes(kN), kBufs = D == 3 ? 2 : 3;
  static constexpr bool kTransform = false;
  Operand op[2];
  const float* img[2];
  long long rows;
  int kp, c, w, s, col_blocks, stages, tma, vec_out;
  const float* frac;   // [N, D]
  const float* wxr;    // wx_rel + off_i, row stride s
  const float* cb;     // corner_bias + off_i, row stride s
  float* x;            // X_i: [D+1][R][w]
  uint8_t* mask;       // [R, w] 1 where the primal pre-activation >= 0
  float slope;

  __host__ __device__ int items() const {
    return cdiv(rows, kTileRows) * col_blocks;
  }
  __device__ int stages_of(int, int pass) const {
    return cdiv(pass == 0 ? c : kp, kBK);
  }
  __device__ int boxes(int t, int pass, int kt, Box (&b)[kMaxBoxes]) const {
    const long long r0 = (long long)(t / col_blocks) * kTileRows;
    if (pass == 0) {
      b[0] = Box{0, 0, 0, r0, (long long)kt * kBK};
      return 1;
    }
    for (int u = 0; u < kMT; ++u)
      b[u] = Box{1, u * kTileBytes, u, r0, (long long)kt * kBK};
    return kMT;
  }
  __device__ const float* b_src(int t, int pass, int kt) const {
    return img[pass] + ((long long)(t % col_blocks) * stages_of(t, pass) +
                        kt) * (kConsumers * b_bytes(kN) / 4);
  }

  __device__ void tile(int t, float (&acc)[kMT][kN / 2], Ring& r,
                       const Consumer& cs, const unsigned char* gbase) const {
    using J = Jet<D>;
    const long long r0 = (long long)(t / col_blocks) * kTileRows;
    const int n0 = (t % col_blocks) * 2 * kN + cs.q * kN;
    // The accumulators start at corner_bias + frac @ Wx_rel (primal) and
    // the Wx_rel rows (tangents), in f32.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long rr = min(r0 + 16 * cs.warp + cs.g + 8 * h, rows - 1);
      const long long pt = rr >> D;
      const float* cbk = cb + (rr & (J::kCorners - 1)) * s;
      float fr[D];
#pragma unroll
      for (int d = 0; d < D; ++d) fr[d] = frac[pt * D + d];
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const int col = min(n0 + 8 * j + 2 * cs.t + e, w - 1);
          float v = cbk[col];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float wr = wxr[(long long)d * s + col];
            v += fr[d] * wr;
            acc[d + 1][i] = wr;
          }
          acc[0][i] = v;
        }
    }
    mma_pass<1, false, kBufs>(acc, r, stages_of(t, 0), cs, gbase);
    mma_pass<kMT, false, kBufs>(acc, r, stages_of(t, 1), cs, gbase);

    uint32_t pos = 0;
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) pos |= (uint32_t)(acc[0][i] >= 0.f) << i;
    const long long rw0 = r0 + 16 * cs.warp;
    if (rw0 >= rows || n0 >= w) return;
    const long long left = rows - rw0;
    const int cols = w - n0 < kN ? w - n0 : kN;
    const long long plane = rows * w;
#pragma unroll
    for (int c1 = 0; c1 <= D; ++c1)
      store_chain<kN>(acc[c1], pos, slope, x + c1 * plane + rw0 * w + n0, w,
                      left, cols, vec_out, cs);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<uchar2*>(staged<4 * kN>(cs.out, cs.g + 8 * h,
                                                  8 * j + 2 * cs.t)) =
            make_uchar2((pos >> i) & 1, (pos >> (i + 1)) & 1);
      }
    flush<kN, 4 * kN>(cs.out, mask + rw0 * w + n0, w, left, cols, vec_out,
                      cs.lane);
  }
};

// C = A B^T for B given as rows [n, k] (the image's segment). kChain: A is
// MT chain planes of 64-row tiles, and C = (A B^T) * mask is written as f32
// chain planes (cplane apart; the backward's P_{i-1}; n is even). Else A
// is plain rows, MT 64-row tiles an item, and C is f32 rows, added to
// (accumulate) or written. Operand 0: A.
template <int MT, bool kChain>
struct Nt {
  static constexpr int kMT = MT, kPasses = 1;
  static constexpr int kN = kChain ? chain_cols(MT - 1) : kFeatCols;
  static constexpr int kOut = kChain ? staging_bytes(kN) : 0;
  static constexpr bool kTransform = false;
  static constexpr int kRows = kChain ? kTileRows : MT * kTileRows;
  static constexpr int kBufs = MT * kN <= 160 ? 3 : 2;
  Operand op[1];
  const float* img;
  long long rows, cplane;
  int n, k, col_blocks, stages, tma, accumulate, vec_out;
  float* c;
  const uint8_t* mask;   // kChain: [rows, n]
  float slope;

  __host__ __device__ int items() const {
    return cdiv(rows, kRows) * col_blocks;
  }
  __device__ int stages_of(int, int) const { return cdiv(k, kBK); }
  __device__ int boxes(int t, int, int kt, Box (&b)[kMaxBoxes]) const {
    const long long r0 = (long long)(t / col_blocks) * kRows;
    for (int u = 0; u < MT; ++u)
      b[u] = kChain ? Box{0, u * kTileBytes, u, r0, (long long)kt * kBK}
                    : Box{0, u * kTileBytes, 0, r0 + kTileRows * u,
                          (long long)kt * kBK};
    return MT;
  }
  __device__ const float* b_src(int t, int, int kt) const {
    return img + ((long long)(t % col_blocks) * cdiv(k, kBK) + kt) *
                     (kConsumers * b_bytes(kN) / 4);
  }

  __device__ void tile(int t, float (&acc)[MT][kN / 2], Ring& r,
                       const Consumer& cs, const unsigned char* gbase) const {
    const long long r0 = (long long)(t / col_blocks) * kRows;
    const int n0 = (t % col_blocks) * 2 * kN + cs.q * kN;
    zero(acc);
    mma_pass<MT, false, kBufs>(acc, r, stages_of(t, 0), cs, gbase);
    if (n0 >= n) return;
    if constexpr (kChain) {
      const long long rw0 = r0 + 16 * cs.warp;
      if (rw0 >= rows) return;
      const long long left = rows - rw0;
      const int cols = n - n0 < kN ? n - n0 : kN;
      // The mask of the layer below, this thread's pairs as bits.
      uint32_t bits = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          const long long rw = min(rw0 + cs.g + 8 * h, rows - 1);
          const int col = min(n0 + 8 * j + 2 * cs.t, n - 2);
          const uchar2 mk =
              *reinterpret_cast<const uchar2*>(mask + rw * n + col);
          bits |= (uint32_t)(mk.x != 0) << (4 * j + 2 * h);
          bits |= (uint32_t)(mk.y != 0) << (4 * j + 2 * h + 1);
        }
#pragma unroll
      for (int c1 = 0; c1 < MT; ++c1)
        store_chain<kN>(acc[c1], bits, slope, c + c1 * cplane + rw0 * n + n0,
                        n, left, cols, vec_out, cs);
    } else {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long rw =
              r0 + kTileRows * m + 16 * cs.warp + cs.g + 8 * h;
          if (rw >= rows) continue;
#pragma unroll
          for (int j = 0; j < kN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = n0 + 8 * j + 2 * cs.t + e;
              if (col >= n) continue;
              const float v = acc[m][4 * j + 2 * h + e];
              const long long o = rw * n + col;
              c[o] = accumulate ? c[o] + v : v;
            }
        }
    }
  }
};

// part[z][ka, nb] = sum over rows of chunk z of A[row, :]^T B[row, :]: the
// split-K partials of A^T B (their rows are the reduction). An item is one
// chunk x one 64 MT x 128 output tile; a chunk's tiles are adjacent items.
// Chunks are multiples of a stage, so a stage never reads past its chunk.
// Operand 0: A [m, ka] (TMA boxes of 32 rows x 32 columns); B [m, nb] is
// read and split by the producer threads (transform).
template <int MT>
struct Tn {
  static constexpr int kMT = MT, kPasses = 1, kN = kTnCols, kOut = 0;
  static constexpr int kBufs = MT == 4 ? 2 : 3;
  static constexpr bool kTransform = true;
  Operand op[1];
  const float* b;      // [m, nb], row stride ldb
  long long ldb;
  float* part;
  long long m, chunk;
  int ka, nb, mtiles, ntiles, chunks, stages, tma;

  __host__ __device__ int items() const { return chunks * mtiles * ntiles; }
  __device__ long long first_row(int t) const {
    return (long long)(t / (mtiles * ntiles)) * chunk;
  }
  __device__ int stages_of(int t, int) const {
    const long long m0 = first_row(t);
    return cdiv(min(m, m0 + chunk) - m0, kBK);
  }
  __device__ int boxes(int t, int, int kt, Box (&bx)[kMaxBoxes]) const {
    const long long k0 = first_row(t) + (long long)kt * kBK;
    const int i0 = ((t % (mtiles * ntiles)) / ntiles) * MT * kTileRows;
    for (int u = 0; u < MT; ++u)
      for (int v = 0; v < 2; ++v)
        bx[2 * u + v] = Box{0, u * kTileBytes + v * (kTileBytes / 2), 0, k0,
                            i0 + kTileRows * u + kBK * v};
    return 2 * MT;
  }
  // The stage's B, [32 rows][2 kN columns] of the chunk, as the two
  // consumers' K-major hi and lo planes; row k of the stage at k8 step k /
  // 8, position (k % 8) / 2 + 4 ((k % 8) & 1) (as load_cols reads A), so
  // positions 4h .. 4h + 3 of a column are its rows 8s + h, + 2, + 4, + 6,
  // 16 contiguous bytes of a core matrix. Warp w takes the 32 columns 32w
  // .. 32w + 31 (lane l column 32w + l) and, per unit, one step s and half
  // h: issue() copies the unit's 4 values into place in the hi plane
  // (cp.async, 0 past the rows or columns of B; each of the warp's 4 copies
  // reads a row's 128 contiguous bytes) and commits the group; split(),
  // once the group has landed, rounds them in place with one 16-byte load
  // and writes the lo plane (each thread the values it copied).
  __device__ float* unit_at(unsigned char* dst, int warp, int lane, int s,
                            int h) const {
    const int q = warp >> 1, grp = 4 * (warp & 1) + (lane >> 3);
    return reinterpret_cast<float*>(dst) + q * (b_bytes(kN) / 4) +
           s * (16 * kN) + grp * 64 + h * 32 + (lane & 7) * 4;
  }

  __device__ void issue(int t, int kt, unsigned char* dst, int tid) const {
    const long long k0 = first_row(t) + (long long)kt * kBK;
    const int warp = tid >> 5, lane = tid & 31;
    const int col = ((t % (mtiles * ntiles)) % ntiles) * kConsumers * kN +
                    32 * warp + lane;
    const bool in = col < nb;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* d = unit_at(dst, warp, lane, s, h);
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const long long row = k0 + 8 * s + 2 * q4 + h;
          const bool ok = in && row < m;
          cp4(d + q4, ok ? b + row * ldb + col : b, ok ? 4 : 0);
        }
      }
    cp_commit();
  }

  __device__ void split(unsigned char* dst, int tid) const {
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4* hi = reinterpret_cast<float4*>(unit_at(dst, warp, lane, s, h));
        const float4 v = *hi;
        const uint32_t h0 = tf32(v.x), h1 = tf32(v.y), h2 = tf32(v.z),
                       h3 = tf32(v.w);
        *hi = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                          __uint_as_float(h2), __uint_as_float(h3));
        hi[2 * kN] = make_float4(__uint_as_float(tf32(v.x - __uint_as_float(h0))),
                                 __uint_as_float(tf32(v.y - __uint_as_float(h1))),
                                 __uint_as_float(tf32(v.z - __uint_as_float(h2))),
                                 __uint_as_float(tf32(v.w - __uint_as_float(h3))));
      }
  }

  __device__ void tile(int t, float (&acc)[MT][kN / 2], Ring& r,
                       const Consumer& cs, const unsigned char* gbase) const {
    zero(acc);
    mma_pass<MT, true, kBufs>(acc, r, stages_of(t, 0), cs, gbase);
    const int tt = t % (mtiles * ntiles);
    const int i0 = (tt / ntiles) * MT * kTileRows;
    const int n0 = (tt % ntiles) * kConsumers * kN + cs.q * kN;
    float* dst = part + (long long)(t / (mtiles * ntiles)) * ka * nb;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + kTileRows * mi + 16 * cs.warp + cs.g + 8 * h;
        if (i >= ka) continue;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + 8 * j + 2 * cs.t + e;
            if (col < nb)
              dst[(long long)i * nb + col] = acc[mi][4 * j + 2 * h + e];
          }
      }
  }
};

// --- the weight image ----------------------------------------------------------
//
// Segment after segment, each the B operand [n][k] of one product, read at
// base[n sn + k sk] (0 past n or k): per item column block (2 kn columns)
// and stage (32 K), both consumers' blocks, each 4 k8 steps of [hi plane,
// lo plane] x [8-column group][2 k halves][8 columns][4 k]; position p = 4
// half + k of step s is K column 8 p + 2 s (p < 4) or 8 (p - 4) + 2 s + 1
// of the stage (load_rows reads A so).

struct Segment {
  const float* base;
  long long sn, sk;
  long long pairs;  // hi / lo pairs of the segments before this one
  int n, k, kn;
};

struct ImageArgs {
  Segment seg[kSegments];
  int count;
  long long pairs;
  float* out;
};

__global__ void __launch_bounds__(256)
    weight_image_kernel(const __grid_constant__ ImageArgs a) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < a.pairs; e += (long long)gridDim.x * blockDim.x) {
    int i = 0;
    while (i + 1 < a.count && e >= a.seg[i + 1].pairs) ++i;
    const Segment& sg = a.seg[i];
    const long long local = e - sg.pairs;
    const int step = 8 * sg.kn;  // pairs a step's plane
    const int pidx = (int)(local % step);
    long long l = local / step;
    const int s = (int)(l % 4);
    l /= 4;
    const int q = (int)(l % 2);
    l /= 2;
    const int nkt = cdiv(sg.k, kBK);
    const int kt = (int)(l % nkt);
    const long long cb = l / nkt;
    const int grp = pidx >> 6, h = (pidx >> 5) & 1, r = (pidx >> 2) & 7;
    const int p = 4 * h + (pidx & 3);
    const long long n = cb * 2 * sg.kn + q * sg.kn + 8 * grp + r;
    const long long k =
        (long long)kBK * kt + (p < 4 ? 8 * p + 2 * s : 8 * (p - 4) + 2 * s + 1);
    const float v = n < sg.n && k < sg.k ? sg.base[n * sg.sn + k * sg.sk] : 0.f;
    const uint32_t hi = tf32(v);
    float* o = a.out + 2 * sg.pairs + 2 * (local - pidx) + pidx;
    o[0] = __uint_as_float(hi);
    o[step] = __uint_as_float(tf32(v - __uint_as_float(hi)));
  }
}

// ---------------------------------------------------------------------------
// Host side.

// The ring of the product kernel with `mt` A tiles and `kn` columns a
// consumer a stage and `out` bytes of epilogue staging: {stage bytes,
// stages (0 if fewer than kMinStages fit), dynamic shared-memory bytes}.
struct RingPlan {
  int bytes, stages, smem;
};

RingPlan f32_ring(int mt, int kn, int out) {
  RingPlan p;
  p.bytes = mt * kTileBytes + kConsumers * b_bytes(kn);
  int st = (kMaxSmem - kAlign - kBarBytes - out) / p.bytes;
  st = st > kMaxStages ? kMaxStages : st;
  p.stages = st < kMinStages ? 0 : st;
  p.smem = kAlign + st * p.bytes + kBarBytes + out;
  return p;
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
    cudaGetLastError();
  }
  return n > 0 ? n : 1;
}

// Launches problem p (its operands set, their maps encoded): TMA if every
// A operand is aligned, else the copying producer.
template <class P>
int launch(P p, cudaStream_t st) {
  const int items = p.items();
  if (items <= 0) return 0;
  const RingPlan rp = f32_ring(P::kMT, P::kN, P::kOut);
  if (rp.stages == 0) return (int)cudaErrorInvalidValue;
  p.stages = rp.stages;
  p.tma = 1;
  for (const Operand& o : p.op) p.tma &= o.vec;
  STPDE_SMEM(gemm_kernel<P>, rp.smem);
  const int grid = items < num_sms() ? items : num_sms();
  gemm_kernel<P><<<grid, kGemmThreads, rp.smem, st>>>(p);
  STPDE_LAUNCH_CHECK();
  return 0;
}

#define STPDE_OPERAND(...)                                        \
  do {                                                            \
    if (!operand(__VA_ARGS__)) return (int)cudaErrorInvalidValue; \
  } while (0)

// The split-K plan of A^T B over m rows into [ka, nb]: MT A tiles an item
// (1, 2 or 4 by ka), the output tiles, and the chunk rows (a multiple of a
// stage) and chunks.
struct TnPlan {
  int mt, mtiles, ntiles, chunks;
  long long chunk;
};

TnPlan tn_plan(long long m, int ka, int nb) {
  TnPlan p;
  p.mt = ka <= kTileRows ? 1 : (ka <= 2 * kTileRows ? 2 : 4);
  p.mtiles = cdiv(ka, p.mt * kTileRows);
  p.ntiles = cdiv(nb, kConsumers * kTnCols);
  p.chunk = chunk_rows(m, p.mtiles * p.ntiles, kBK, &p.chunks);
  return p;
}

long long tn_partial_floats(long long m, int ka, int nb) {
  return (long long)tn_plan(m, ka, nb).chunks * ka * nb;
}

// The weight image's segments, in order: per layer i, the forward's skip
// (Wx_feat[:, sl_i]^T) and hidden (Wh_i^T, i > 0) B, then the backward's
// chain product (Wh_i, i > 0) and d feats (Wx_feat[:, sl_i]) B. `off`:
// each segment's first float; {fwd skip, fwd hidden, bwd hidden, bwd
// feats} of layer i at index[i][0..3] (-1: none).
struct ImageLayout {
  ImageArgs args;
  long long off[kSegments];
  int index[kLayers][4];
  long long floats;
};

ImageLayout image_layout(const Shape& sh, const Weights* wt) {
  ImageLayout L{};
  const int kc = chain_cols(sh.dim);
  long long pairs = 0;
  int nseg = 0;
  auto add = [&](int layer, int kind, const float* base, long long sn,
                 long long sk, int n, int k, int kn) {
    Segment& s = L.args.seg[nseg];
    s.base = base, s.sn = sn, s.sk = sk, s.pairs = pairs;
    s.n = n, s.k = k, s.kn = kn;
    L.off[nseg] = 2 * pairs;
    L.index[layer][kind] = nseg++;
    pairs += (long long)cdiv(n, 2 * kn) * cdiv(k, kBK) * 64 * kn;
  };
  for (int i = 0; i < kLayers; ++i) {
    for (int j = 0; j < 4; ++j) L.index[i][j] = -1;
    const int w = sh.w[i], kp = i ? sh.w[i - 1] : 0;
    const float* wxf = wt ? wt->wx_feat + sh.off[i] : nullptr;
    const float* wh = wt && i ? wt->wh[i - 1] : nullptr;
    add(i, 0, wxf, 1, sh.s, w, sh.c, kc);
    if (i) add(i, 1, wh, 1, w, w, kp, kc);
    if (i) add(i, 2, wh, w, 1, kp, w, kc);
    add(i, 3, wxf, sh.s, 1, sh.c, w, kFeatCols);
  }
  L.args.count = nseg;
  L.args.pairs = pairs;
  L.floats = 2 * pairs;
  return L;
}

long long chains_bytes(const Shape& sh) {
  return sh.rows * (sh.dim + 1) * sh.s * (long long)sizeof(float);
}

// The image's first byte in the forward workspace, after the masks.
long long image_offset(const Shape& sh) {
  const long long end = chains_bytes(sh) + sh.rows * sh.s;
  return (end + kImageAlign - 1) / kImageAlign * kImageAlign;
}

long long fwd_workspace_bytes(const Shape& sh) {
  return image_offset(sh) +
         image_layout(sh, nullptr).floats * (long long)sizeof(float);
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
// every layer's masks [R][w_i], then the weight image.
float* fwd_views(const Shape& sh, void* ws, float* x[kLayers],
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
  return reinterpret_cast<float*>(static_cast<char*>(ws) + image_offset(sh));
}

// 16-byte stores of `elem`-byte values at rows ld apart from p are aligned.
bool vec_rows(const void* p, long long ld, int elem) {
  return (uintptr_t)p % 16 == 0 && (ld * elem) % 16 == 0;
}

// out[ka, nb] (row stride ldo) = A[m, ka]^T B[m, nb] for A rows a (row
// stride lda) and B rows b (ldb), deterministic: the chunks' partials, then
// their fixed-order sum.
template <int MT>
int tn_launch(const float* a, long long lda, const float* b, long long ldb,
              long long m, int ka, int nb, const TnPlan& pl, float* part,
              cudaStream_t st) {
  Tn<MT> g{};
  STPDE_OPERAND(&g.op[0], a, lda, m, ka, kBK);
  g.b = b, g.ldb = ldb, g.part = part;
  g.m = m, g.chunk = pl.chunk;
  g.ka = ka, g.nb = nb, g.mtiles = pl.mtiles, g.ntiles = pl.ntiles;
  g.chunks = pl.chunks;
  return launch(g, st);
}

int gemm_tn(const float* a, long long lda, const float* b, long long ldb,
            long long m, int ka, int nb, float* part, float* out,
            long long ldo, cudaStream_t st) {
  const TnPlan pl = tn_plan(m, ka, nb);
  const int e =
      pl.mt == 1   ? tn_launch<1>(a, lda, b, ldb, m, ka, nb, pl, part, st)
      : pl.mt == 2 ? tn_launch<2>(a, lda, b, ldb, m, ka, nb, pl, part, st)
                   : tn_launch<4>(a, lda, b, ldb, m, ka, nb, pl, part, st);
  if (e) return e;
  return reduce(part, pl.chunks, (long long)ka * nb, ka, nb, out, ldo, st);
}

template <class J>
int run_forward(const Shape& sh, const float* feats, const float* frac,
                const Weights& wt, float* out, void* ws, float slope,
                cudaStream_t st) {
  constexpr int D = J::kDim;
  float* x[kLayers];
  uint8_t* mask[kLayers];
  float* img = fwd_views(sh, ws, x, mask);
  ImageLayout L = image_layout(sh, &wt);
  L.args.out = img;
  const long long blocks = cdiv(L.args.pairs, 256);
  weight_image_kernel<<<blocks < 4 * 132 ? (int)blocks : 4 * 132, 256, 0,
                        st>>>(L.args);
  STPDE_LAUNCH_CHECK();
  for (int i = 0; i < kLayers; ++i) {
    const int kp = i ? sh.w[i - 1] : 0, w = sh.w[i];
    FwdLayer<D> f{};
    STPDE_OPERAND(&f.op[0], feats, sh.c, sh.rows, sh.c, kTileRows);
    if (i)
      STPDE_OPERAND(&f.op[1], x[i - 1], kp, sh.rows, kp, kTileRows, D + 1,
                    sh.rows * kp);
    else
      f.op[1] = f.op[0];  // unused: no hidden product
    f.img[0] = img + L.off[L.index[i][0]];
    f.img[1] = i ? img + L.off[L.index[i][1]] : f.img[0];
    f.rows = sh.rows;
    f.kp = kp, f.c = sh.c, f.w = w, f.s = sh.s;
    f.col_blocks = cdiv(w, 2 * FwdLayer<D>::kN);
    f.frac = frac;
    f.wxr = wt.wx_rel + sh.off[i];
    f.cb = wt.corner_bias + sh.off[i];
    f.x = x[i];
    f.mask = mask[i];
    f.vec_out = vec_rows(x[i], w, 4) && vec_rows(mask[i], w, 1) &&
                (sh.rows * w * 4) % 16 == 0;
    f.slope = slope;
    const int e = launch(f, st);
    if (e) return e;
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
  const float* img = fwd_views(sh, fws, x, mask);
  const ImageLayout L = image_layout(sh, nullptr);
  long long na, nb, np;
  bwd_layout(sh, &na, &nb, &np);
  float* buf_a = static_cast<float*>(bws);
  float* buf_b = buf_a + na;
  float* part = buf_b + nb;
  const long long mrows = sh.rows * J::kChains;

  // Head: P_4 into buf_a (layer widths alternate buffers: 4, 2, 0 -> a).
  const int hblocks = cdiv(sh.n, kHeadPoints);
  jet_head_bwd_kernel<D, float><<<hblocks, head_threads(sh.nf), 0, st>>>(
      x[4], mask[4], frac, wt.w5, ybar, buf_a, nullptr, part, sh.n, sh.nf,
      sh.out_dim, slope, kHeadPoints);
  STPDE_LAUNCH_CHECK();
  const long long hstride = (long long)sh.nf * sh.out_dim + sh.out_dim;
  int e = reduce(part, hblocks, hstride, sh.nf, sh.out_dim, gr.w5,
                 sh.out_dim, st);
  if (e) return e;
  e = reduce(part + (long long)sh.nf * sh.out_dim, hblocks, hstride, 1,
             sh.out_dim, gr.b5, sh.out_dim, st);
  if (e) return e;

  float* cur = buf_a;
  for (int i = kLayers - 1; i >= 0; --i) {
    const int w = sh.w[i];
    float* nxt = cur == buf_a ? buf_b : buf_a;
    if (i > 0) {
      // dWh_i = X_{i-1}^T P_i over the chain rows.
      const int kp = sh.w[i - 1];
      e = gemm_tn(x[i - 1], kp, cur, w, mrows, kp, w, part, gr.wh[i - 1], w,
                  st);
      if (e) return e;
    }
    e = gemm_tn(feats, sh.c, cur, w, sh.rows, sh.c, w, part,
                gr.wx_feat + sh.off[i], sh.s, st);
    if (e) return e;
    int ppc;
    const int bchunks = bias_chunks(sh, w, &ppc);
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
    const long long bstride = (long long)(J::kCorners + D) * w;
    e = reduce(part, bchunks, bstride, J::kCorners, w,
               gr.corner_bias + sh.off[i], sh.s, st);
    if (e) return e;
    e = reduce(part + (long long)J::kCorners * w, bchunks, bstride, D, w,
               gr.wx_rel + sh.off[i], sh.s, st);
    if (e) return e;
    // d feats2 (+)= P_i[primal] Wx_feat[:, sl_i]^T.
    Nt<4, false> nf{};
    STPDE_OPERAND(&nf.op[0], cur, w, sh.rows, w, kTileRows);
    nf.img = img + L.off[L.index[i][3]];
    nf.rows = sh.rows;
    nf.n = sh.c, nf.k = w;
    nf.col_blocks = cdiv(sh.c, 2 * Nt<4, false>::kN);
    nf.accumulate = i != kLayers - 1;
    nf.c = dfeats;
    e = launch(nf, st);
    if (e) return e;
    if (i > 0) {
      // P_{i-1} = (P_i Wh_i^T) * mask_{i-1}, into the other buffer.
      using C = Nt<J::kChains, true>;
      const int kp = sh.w[i - 1];
      C nc{};
      STPDE_OPERAND(&nc.op[0], cur, w, sh.rows, w, kTileRows, J::kChains,
                    sh.rows * w);
      nc.img = img + L.off[L.index[i][2]];
      nc.rows = sh.rows;
      nc.cplane = sh.rows * kp;
      nc.n = kp, nc.k = w;
      nc.col_blocks = cdiv(kp, 2 * C::kN);
      nc.c = nxt;
      nc.mask = mask[i - 1];
      nc.slope = slope;
      nc.vec_out = vec_rows(nxt, kp, 4) && (sh.rows * kp * 4) % 16 == 0;
      e = launch(nc, st);
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
// layer's chains and masks, and the weight image. -1 for a shape the
// kernels do not take.
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

// The weight image in the forward workspace: {its first byte, its f32
// values}; -1s for a shape the kernels do not take.
void stpde_jet_f32_image_layout(int n, int c, int dim, int nf,
                                long long* out) {
  Shape sh;
  if (!make_shape(n, c, dim, nf, 1, &sh)) {
    out[0] = out[1] = -1;
    return;
  }
  out[0] = image_offset(sh);
  out[1] = image_layout(sh, nullptr).floats;
}

// The product kernel's ring with `mt` A tiles and `kn` columns a consumer a
// stage and (staging != 0) the epilogue's staging rows: {stage bytes, ring
// stages, dynamic shared-memory bytes, threads a CTA}.
void stpde_jet_f32_ring(int mt, int kn, int staging, long long* out) {
  const RingPlan p = f32_ring(mt, kn, staging ? staging_bytes(kn) : 0);
  const long long v[4] = {p.bytes, p.stages, p.smem, kGemmThreads};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
}

// The split-K plan of A^T B over m rows into [ka, nb]: {A tiles an item,
// output tiles along ka, along nb, chunk rows, chunks}.
void stpde_jet_f32_tn_plan(long long m, int ka, int nb, long long* out) {
  const TnPlan p = tn_plan(m, ka, nb);
  const long long v[5] = {p.mt, p.mtiles, p.ntiles, p.chunk, p.chunks};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
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
// reading the forward's workspace (its chains, masks and weight image): d
// feats2 and the 9 packed-param grads, each written whole (no accumulation
// into the caller's buffers).
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
