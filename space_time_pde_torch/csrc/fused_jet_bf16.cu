// The bf16 instantiation of the jet kernels for Hopper (sm_90a): the jet
// forward and backward of csrc/fused_jet.cu at compute_dtype=bfloat16, on
// Hopper's bf16 tensor cores through wgmma (bf16 operands, f32
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
// products, 0.387 / 0.480 ms forward and 0.773 / 0.958 ms backward at
// 989 TFLOP/s. The hidden products are 96% of them (layer 1,
// [4R, 1024] x [1024, 512], 72% of the forward's). The forward's workspace
// (the chains of layers 0-3 in bf16, layer 4 in f32, the masks: 1.20 /
// 1.48 GB) written once and read back by the backward (0.36 / 0.44 ms each
// way at 3.35 TB/s) is close behind.
//
// DESIGN. Every matrix product of both kernels runs through one persistent,
// warp-specialised wgmma kernel (gemm_kernel<P>), templated on the problem
// P, which gives the operand boxes of each stage and the epilogue of each
// item:
//   FwdLayer<D, f32>  layer i of the forward, an item = 64 corner rows x
//                (D + 1) chains x 128 columns: the skip product feats
//                Wx_feat[:, sl_i] on the primal (K = C) rounded with its
//                coordinate term and corner bias into xs (bf16 pairs in
//                registers), then the hidden product X_{i-1} Wh_i on every
//                chain (K = w_{i-1}; none at layer 0), the primal's sign
//                picking every chain's mask in registers;
//   Nt<D+1, true>  P_{i-1} = (P_i Wh_i^T) * mask_{i-1}, the same item, written
//                as bf16 chains and the primal plane in f32;
//   Nt<4, false>   d feats2 (+)= P_i[primal] Wx_feat[:, sl_i]^T, 256 plain rows
//                x 128 columns an item;
//   Tn<MT>       split-K partials of A^T B over chain rows (dWh_i = X_{i-1}^T
//                P_i over 4R rows, dWx_feat = feats^T P_i[primal] over R):
//                64 MT x 128 outputs an item (MT = 1, 2 or 4 by the width),
//                one chunk of rows (a multiple of a stage) an item, each
//                chunk's partial written once and summed by reduce_kernel in
//                a fixed order.
// The skip side (the C-wide products of feats, Nt<4, false> and Tn<1>)
// rides the same kernel; the head, the bias sums and the reductions stay
// the FFMA kernels of csrc/jet_common.cuh. The forward makes 6 launches
// (5 layers, the head), the backward 45.
// A CTA is 3 warpgroups (384 threads), one a SM; the grid is min(items,
// SMs) and each CTA walks items t = blockIdx.x + k gridDim.x (the
// 128-column blocks of a row block, or the tiles of one chunk, are adjacent
// items, so the rows they share come from L2).
// - Warp 0 is the producer (warpgroup 0 gives registers away with
//   setmaxnreg; warps 1-3 exit). It walks the consumers' item / pass /
//   stage sequence and fills a ring of `stages` slots, each (MT + 2)
//   64 x 64 bf16 tiles (8 KB, 128-byte swizzle: row r of a tile at 128 r,
//   its 16-byte chunk j at chunk j ^ (r & 7)): MT A tiles and the two
//   consumers' B tiles. Where every operand is 16-byte aligned (rows a
//   multiple of 8 values), lane 0 issues one TMA box a tile through 3-D
//   tensor maps ([planes][rows][cols]: a chain operand's planes are its
//   chains), zero-filled past the operand's edges, counted on the slot's
//   full mbarrier (expect_tx). cuTensorMapEncodeTiled comes from the
//   runtime (cudaGetDriverEntryPoint), so the library does not link
//   -lcuda; the maps are encoded per launch and passed in the
//   __grid_constant__ problem. Otherwise (unaligned test shapes, C = 4,
//   widths below 8) the warp fills the same image with 2-byte loads, zero
//   past the edges, fences it to the async proxy and arrives. Either way it
//   waits on the slot's empty mbarrier before refilling it and runs ahead
//   across stages, passes and items, so the next item's loads overlap this
//   item's epilogue.
// - Warpgroups 1 and 2 consume (224 registers after setmaxnreg; the
//   producer's warpgroup keeps 56). Each owns 64 of the item's 128 columns
//   and reads every A tile of the stage: wgmma.mma_async m64n64k16, bf16 x
//   bf16 -> f32, both operands from shared memory through 128-byte-swizzle
//   descriptors, K-major (A and B of the skip, A of the hidden and NT
//   products, B of NT) or MN-major with the transpose bit (B of the
//   forward, both operands of TN, whose rows are the reduction). MT
//   accumulators of 32 f32 a thread (128 at D = 3, 160 at D = 4, + 16
//   registers of xs pairs in the forward). A stage issues 4 k16 steps x MT
//   products, commits, waits for the previous stage's group and releases
//   that slot (one arrive per warpgroup at CTA scope): no block-wide
//   barrier per K step. Every wgmma sits on no conditional path; the first
//   product of a pass overwrites the accumulators (scale-d 0), nothing else
//   writes them inside a pass, and they are zeroed between items (so their
//   old values are not kept alive through the next prologue): ptxas
//   serializes none (its C7520).
// - Epilogues stage their outputs through each consumer warp's own 16 rows
//   of shared memory (swizzled by 16-byte chunk, no bank conflicts) and
//   store whole rows in 16-byte stores, chain by chain, then the mask. The
//   epilogue's code is kept small: the forward's output type is a template
//   parameter (layer 4's f32 apart from layers 0-3's bf16), its store loop
//   rolled, the bytes of a ragged row edge copied out of line. Smaller
//   epilogues ran faster and cut FwdLayer<4>'s spills.
// - Layer 0's tangent planes stay stored (mask x one Wx_rel row):
//   regenerating them in the producer would remove 0.40 GB of writes and
//   two reads at D = 3, but the producer issues TMA from one lane and would
//   have to compute and store three tiles a stage in the generic proxy, in
//   the forward's layer 1 and the backward's dWh_1; the workspace layout
//   stays, so ops/fused_jet.py::workspace_masks and every reader of the
//   chains are unchanged.
// - Deterministic: every output element is computed by the same operations
//   wherever its item lands and written once; the split-K chunk plan is a
//   function of the shape (jet_common.cuh::chunk_rows); no atomics.
//
// BUDGET (gemm_ring; ops/fused_jet.py::bf16_ring mirrors it): a stage is
// (MT + 2) 8 KB tiles; the ring takes as many stages as fit 227 KB, 3 to 6,
// with 1 KB of alignment, 1 KB of mbarriers and (forward, chain product)
// 32 KB of staging rows. Forward and chain product at D = 3 (MT = 4): 4
// stages of 48 KB, 231,424 B; at D = 4 (MT = 5): 3 of 56 KB, 206,848 B;
// Tn<4> and Nt<4, false>: 4 x 48 KB, 198,656 B; Tn<2>: 6 x 32 KB, 198,656
// B; Tn<1>: 6 x 24 KB, 149,504 B.
//
// MEASURED on an NVIDIA H100 80GB HBM3 at 700.00 W (nvidia-smi's
// power.limit), 8,192 flagship points at D = 3 and 4,096 at D = 4
// (scripts/time_bf16_jet.py, in turns with the previous body of bf16
// mma.sync.m16n8k16 products fed by a 3-deep cp.async ring): forward
// 1.499 / 1.898 ms, 25.8% / 25.3% of the bound (the previous body 3.812 /
// 4.699 ms); backward 3.419 / 3.967 ms, 22.6% / 24.1% (6.870 / 8.302 ms).
// Layer 1's hidden product takes 0.584 ms at D = 3 (471 TFLOP/s;
// scripts/profile_torch_step.py --jets --each --dtype bf16). What holds
// the backward below 25%: the chain product's epilogue (D + 1 bf16 planes
// and the f32 primal staged and stored, 0.717 ms at layer 1), layer 1's
// items re-reading their rows from L2 once per 128-column block, and the
// FFMA bias sums (0.50 ms at D = 3).
//
// WORKSPACE (stpde_jet_fwd_bf16_workspace bytes): the chain planes of
// layers 0-3, bf16 [D+1][R][w_i] each (R = N 2^D corner rows, plane 0 the
// primal), then layer 4's, f32 [D+1][R][nf], then every layer's masks,
// bytes [R][w_i] (ops/fused_jet.py::workspace_masks reads them). The
// backward's scratch (stpde_jet_bwd_bf16_workspace bytes): one partial-sum
// buffer, two f32 primal planes (16 nf and 8 nf wide, alternating layers)
// and two bf16 chain buffers of the same widths.
//
// Limits: make_shape's (D = 3 or 4, C >= 1, 1 <= nf <= 1024, out <= 8); a
// shape the kernels refuse returns the CUDA error of the refused launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (space_time_pde_torch/ops/_build.py). wgmma and setmaxnreg exist
// only on sm_90a.

#include <cuda.h>
#include <cudaTypedefs.h>

#include "jet_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                       // rows and depth of a tile
constexpr int kTileBytes = kTile * kTile * 2;   // 8 KB of bf16
constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kN = 64;                          // columns a consumer
constexpr int kBN = kConsumers * kN;            // columns a tile
constexpr int kGemmThreads = 128 * (1 + kConsumers);
constexpr int kMinStages = 3, kMaxStages = 6;
constexpr int kMaxSmem = 232448;                // 227 KB, a CTA's most
constexpr int kAlign = 1024;                    // a 128-byte-swizzle atom
constexpr int kBarBytes = 1024;                 // the ring's mbarriers
constexpr int kOutRow = 256;                    // staging: bytes a row
constexpr int kOutWarp = 16 * kOutRow;          // a consumer warp's rows
constexpr int kOutBytes = 4 * kConsumers * kOutWarp;  // 32 KB
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

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

// A bf16 operand in device memory: `planes` matrices `plane` values apart,
// each [rows, cols] with row stride ld: (plane z, row r, column c) at p + z
// plane + r ld + c, zero outside. vec: p is 16-byte aligned and ld and plane
// are multiples of 8, so it loads by TMA through `map` (a 3-D tensor map,
// 64 x 64 boxes, 128-byte swizzle), else by 2-byte loads.
struct Operand {
  CUtensorMap map;
  const bf16* p;
  long long ld, plane, rows;
  int cols, vec;
};

// One 64 x 64 tile of a stage: rows [row, row + 64) x columns [col, col +
// 64) of plane z of operand `op` into the stage's tile `slot`.
struct Box {
  int op, slot, z;
  long long row, col;
};
constexpr int kMaxBoxes = 8;

// --- host: tensor maps ---------------------------------------------------------

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
bool operand(Operand* o, const bf16* p, long long ld, long long rows,
             int cols, long long planes = 1, long long plane = 0) {
  if (planes == 1) plane = rows * ld;
  o->p = p, o->ld = ld, o->plane = plane, o->rows = rows, o->cols = cols;
  o->vec = (uintptr_t)p % 16 == 0 && ld % 8 == 0 && plane % 8 == 0 &&
           rows > 0 && cols > 0;
  if (!o->vec) return true;
  const auto fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)plane * 2};
  const cuuint32_t box[3] = {kTile, kTile, 1}, elem[3] = {1, 1, 1};
  return fn(&o->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<bf16*>(p), dims, strides, box, elem,
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

// Waits for the phase of parity `parity` to complete. A wait that outlasts
// 2^31 tries (far beyond any stage's time) traps, so that a schedule fault
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (long long i = 0; !mbar_try(bar, parity); ++i)
    if (i > (1ll << 31)) __trap();
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

// A 64 x 64 box of a 3-D tensor map into shared memory, counted on `bar`.
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

// Keeps the compiler from moving accumulator reads or writes across a wait.
template <int MTP, int MT>
__device__ __forceinline__ void fence_acc(float (&d)[MT][32]) {
#pragma unroll
  for (int m = 0; m < MTP; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[m][i])::"memory");
}

// A 128-byte-swizzle shared-memory operand of wgmma (layout type 1). K-major
// (a tile's rows are M or N, 64 K values each): a k16 step starts 32 bytes
// further along the row, 8-row groups 1024 bytes apart. MN-major (a tile's
// rows are K, 64 M or N values each): a k16 step starts 16 rows (2048
// bytes) further, 8-row K groups 1024 bytes apart; the next 64 M / N values
// would be a tile (8 KB) away.
template <bool kMN>
__device__ __forceinline__ uint64_t desc(uint32_t tile, int ks) {
  const uint32_t addr = tile + (kMN ? 2048 : 32) * ks;
  const uint32_t lbo = kMN ? kTileBytes : 16;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// m64n64k16, bf16 x bf16 -> f32, A and B from shared memory: D = A B +
// (scale_d ? D : 0); kTA / kTB: the operand is MN-major (wgmma's transpose
// bit).
template <bool kTA, bool kTB>
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t a,
                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA ? 1 : 0), "n"(kTB ? 1 : 0));
}

// --- the ring and the producer ---------------------------------------------------

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

// The copying path, for an operand that is not TMA-aligned: rows [row, row
// + 64) x columns [col, col + 64) of plane z into the swizzled tile at dst
// (the image TMA writes: row r at dst + 128 r, its 16-byte chunk j at chunk
// j ^ (r & 7)), zero outside the operand. One warp: lane l fills chunk l & 7
// of rows (l >> 3) + 4 i, i < 16, with 2-byte loads and shared stores.
__device__ __forceinline__ void copy_tile(unsigned char* dst,
                                          const Operand& o, const Box& b,
                                          int lane) {
  const int j = lane & 7, r0 = lane >> 3;
  const long long c = b.col + 8 * j;
  const long long left = o.cols - c;
  const int nc = left < 0 ? 0 : (left > 8 ? 8 : (int)left);
  const bf16* p = o.p + b.z * o.plane;
#pragma unroll 1
  for (int i = 0; i < 16; ++i) {
    const int r = r0 + 4 * i;
    const long long rr = b.row + r;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t lo = 0, hi = 0;
      if (rr < o.rows && 2 * e < nc)
        lo = __bfloat16_as_ushort(p[rr * o.ld + c + 2 * e]);
      if (rr < o.rows && 2 * e + 1 < nc)
        hi = __bfloat16_as_ushort(p[rr * o.ld + c + 2 * e + 1]);
      v[e] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst + r * 128 + ((j ^ (r & 7)) << 4)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// The producer (warp 0): every stage of every item and pass of P, in the
// consumers' order. With TMA (every operand aligned) lane 0 issues one box
// a tile, counted on the slot's full barrier; else the warp copies the
// stage, fences it to the async proxy and arrives (32 arrivals a phase).
template <class P>
__device__ __forceinline__ void produce(const P& p, Ring w,
                                        unsigned char* gbase, int lane) {
  const int items = p.items();
  for (int t = blockIdx.x; t < items; t += gridDim.x)
    for (int pass = 0; pass < P::kPasses; ++pass) {
      const int nk = p.stages_of(t, pass);
      for (int kt = 0; kt < nk; ++kt) {
        Box bx[kMaxBoxes];
        const int nb = p.boxes(t, pass, kt, bx);
        mbar_wait(w.empty(w.stage), w.phase ^ 1);
        if (p.tma) {
          if (lane == 0) {
            mbar_expect_tx(w.full(), nb * kTileBytes);
            for (int i = 0; i < nb; ++i)
              tma_load(w.slot() + bx[i].slot * kTileBytes,
                       &p.op[bx[i].op].map, (int)bx[i].col, (int)bx[i].row,
                       bx[i].z, w.full());
          }
        } else {
          unsigned char* s = gbase + (w.slot() - w.slots);
          for (int i = 0; i < nb; ++i)
            copy_tile(s + bx[i].slot * kTileBytes, p.op[bx[i].op], bx[i],
                      lane);
          fence_async_smem();
          mbar_arrive(w.full());
        }
        w.advance();
      }
    }
}

// What a consumer thread knows.
struct Consumer {
  int q;           // warpgroup: which 64 columns of a tile
  int warp, g, t;  // warp in the warpgroup; lane / 4, lane % 4
  int lane;
  bool releaser;   // arrives on a slot's empty barrier for the warpgroup
  unsigned char* out;  // the warp's staging rows (kOutWarp bytes)
};

// acc[0 : MTP] = sum over `nk` stages of A tile m x this consumer's B tile.
// kAT / kBT: the operands are MN-major. Each stage: wait for its slot, 4
// k16 steps of MTP products (the first product of the pass overwrites),
// commit, wait for the previous stage's group and release its slot.
template <int MTP, bool kAT, bool kBT, int MT>
__device__ __forceinline__ void mma_pass(float (&acc)[MT][32], Ring& r,
                                         int nk, const Consumer& cs) {
  static_assert(MTP <= MT, "more products than A tiles");
  // The accumulators' last writer before the wgmmas, at a point where the
  // warpgroup is converged.
  fence_acc<MTP>(acc);
  int prev = -1;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(r.full(), r.phase);
    const uint32_t a = r.slot(), b = a + (MT + cs.q) * kTileBytes;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      const uint64_t db = desc<kBT>(b, ks);
#pragma unroll
      for (int m = 0; m < MTP; ++m)
        wgmma64<kAT, kBT>(acc[m], desc<kAT>(a + m * kTileBytes, ks), db,
                          kt > 0 || ks > 0);
    }
    wg_commit();
    wg_wait<1>();  // the previous stage's products are done
    if (prev >= 0 && cs.releaser) mbar_arrive(r.empty(prev));
    prev = r.stage;
    r.advance();
  }
  wg_wait<0>();
  fence_acc<MTP>(acc);
  if (prev >= 0 && cs.releaser) mbar_arrive(r.empty(prev));
}

// --- epilogue staging ------------------------------------------------------------
//
// A consumer warp holds rows g and g + 8 of its 16 rows of a tile, two
// adjacent columns in each 8-column group. Its outputs go through its own
// 16-row staging buffer (16-byte chunk c of row r at chunk c ^ (r & 7): no
// bank conflicts either way) and leave as 16-byte stores, whole rows at a
// time, instead of 4-byte stores scattered over 8 rows.

__device__ __forceinline__ unsigned char* staged(unsigned char* buf, int r,
                                                 int byte) {
  return buf + r * kOutRow + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
}

// A bf16 pair as 32 bits, and its element e (0: low) read as f32.
__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_at(uint32_t v, int e) {
  return __uint_as_float(e ? v & 0xffff0000u : v << 16);
}

// The edge of a row that 16-byte stores cannot take, out of line: the
// epilogues' code stays small.
__device__ __noinline__ void copy_bytes(unsigned char* g,
                                        const unsigned char* s, int n) {
  for (int e = 0; e < n; ++e) g[e] = s[e];
}

// The warp's staged rows (kRowBytes bytes each) to dst (row 0 of the warp,
// its first column), rows_left rows and bytes_left bytes a row in range;
// 16-byte stores where `vec` (dst and ld 16-byte aligned), else bytes.
// kRolled keeps the loop rolled (the forward's epilogues run faster so;
// the chain product's slower).
template <int kRowBytes, bool kRolled = false>
__device__ __forceinline__ void flush(const unsigned char* buf,
                                      unsigned char* dst, long long ld,
                                      long long rows_left, int bytes_left,
                                      bool vec, int lane) {
  constexpr int kChunks = kRowBytes / 16;
  auto chunk = [&](int i) {
    const int r = i / kChunks, c = i % kChunks, b0 = 16 * c;
    if (r >= rows_left || b0 >= bytes_left) return;
    const unsigned char* s = buf + r * kOutRow + ((c ^ (r & 7)) << 4);
    unsigned char* g = dst + r * ld + b0;
    if (vec && b0 + 16 <= bytes_left)
      *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(s);
    else
      copy_bytes(g, s, bytes_left - b0 < 16 ? bytes_left - b0 : 16);
  };
  __syncwarp();
  if constexpr (kRolled) {
#pragma unroll 1
    for (int i = lane; i < 16 * kChunks; i += 32) chunk(i);
  } else {
#pragma unroll
    for (int i = lane; i < 16 * kChunks; i += 32) chunk(i);
  }
  __syncwarp();
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][32]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
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
  const int bytes = (P::kMT + kConsumers) * kTileBytes;
  Ring r{base, base + p.stages * bytes, p.stages, bytes, 0, 0};
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(r.bars + 8 * i, p.tma ? 1 : 32);
      mbar_init(r.bars + 8 * (p.stages + i), kConsumers);
    }
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) produce(p, r, gbase, (int)threadIdx.x);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int ct = threadIdx.x - 128, lane = ct & 31;
    Consumer cs{ct >> 7, (ct & 127) >> 5, lane >> 2, lane & 3, lane,
                (ct & 127) == 0,
                gbase + p.stages * bytes + kBarBytes + (ct >> 5) * kOutWarp};
    // Zero between items: every pass's first product overwrites the
    // accumulators, but wgmma's operands read them, so without this their
    // old values would stay live (and spill) through the next prologue.
    float acc[P::kMT][32];
    zero(acc);
    const int items = p.items();
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      p.tile(t, acc, r, cs);
      zero(acc);
    }
  }
}

// --- the problems ----------------------------------------------------------------

// Forward layer i of the jet: X_i for every chain row (see the header).
// Operands: 0 feats [R, C], 1 Wx_feat[:, sl_i] [C, w] (row stride S), 2
// X_{i-1} (D + 1 planes [R, kp]), 3 Wh_i [kp, w]. The output's type is a
// parameter, so that each kernel holds one epilogue (half the code).
template <int D, bool kF32_>
struct FwdLayer {
  static constexpr int kMT = D + 1, kPasses = 2, kOut = kOutBytes;
  static constexpr bool kF32 = kF32_;  // X_i in f32 (layer 4), else bf16
  Operand op[4];
  long long rows;
  int kp, c, w, s, col_blocks, stages, tma, vec_out;
  const float* frac;   // [N, D]
  const bf16* wxr;     // wx_rel + off_i, row stride s
  const float* cb;     // corner_bias + off_i, row stride s
  bf16* xb;            // X_i in bf16 (layers 0-3), or null
  float* xf;           // X_i in f32 (layer 4), or null
  uint8_t* mask;       // [R, w] 1 where the primal pre-activation >= 0
  float slope;

  __host__ __device__ int items() const {
    return cdiv(rows, kTile) * col_blocks;
  }
  __device__ int stages_of(int, int pass) const {
    return cdiv(pass == 0 ? c : kp, kTile);
  }
  __device__ int boxes(int t, int pass, int kt, Box (&b)[kMaxBoxes]) const {
    const long long r0 = (long long)(t / col_blocks) * kTile;
    const int n0 = (t % col_blocks) * kBN, k0 = kt * kTile;
    int n = 0;
    if (pass == 0) {
      b[n++] = Box{0, 0, 0, r0, k0};
    } else {
      for (int u = 0; u < kMT; ++u) b[n++] = Box{2, u, u, r0, k0};
    }
    for (int u = 0; u < kConsumers; ++u)
      b[n++] = Box{pass == 0 ? 1 : 3, kMT + u, 0, k0, n0 + kN * u};
    return n;
  }

  __device__ void tile(int t, float (&acc)[kMT][32], Ring& r,
                       const Consumer& cs) const {
    using J = Jet<D>;
    const long long r0 = (long long)(t / col_blocks) * kTile;
    const int n0 = (t % col_blocks) * kBN + cs.q * kN;
    mma_pass<1, false, true>(acc, r, stages_of(t, 0), cs);

    // xs = bf16(feats Wx_feat + frac_b Wx_rel + corner_bias), this thread's
    // primal elements, kept as bf16 pairs (xs is a bf16 value).
    uint32_t xs[16];
    {
      uint32_t in[D][8];
#pragma unroll
      for (int d = 0; d < D; ++d) pairs(in[d], wxr + (long long)d * s, n0, cs);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long rr =
            min(r0 + 16 * cs.warp + cs.g + 8 * h, rows - 1);
        const long long pt = rr >> D;
        const float* cbk = cb + (rr & (J::kCorners - 1)) * s;
        float fr[D];
#pragma unroll
        for (int d = 0; d < D; ++d) fr[d] = rnd<bf16>(frac[pt * D + d]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float xr = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d) xr += fr[d] * bf16_at(in[d][j], e);
            const float cbv = cbk[min(n0 + 8 * j + 2 * cs.t + e, w - 1)];
            v[e] = acc[0][4 * j + 2 * h + e] + (xr + cbv);
          }
          xs[2 * j + h] = pack(__floats2bfloat162_rn(v[0], v[1]));
        }
      }
    }
    const bool hidden = kp > 0;  // layer 0 has no hidden product
    mma_pass<kMT, false, true>(acc, r, stages_of(t, 1), cs);

    // acc[0] = pre = hidden product + xs (layer 0: xs); the mask's bits.
    uint32_t pos = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = bf16_at(xs[i >> 1], i & 1);
      acc[0][i] = hidden ? acc[0][i] + x : x;
      pos |= (uint32_t)(acc[0][i] >= 0.f) << i;
    }
    fence_acc<1>(acc);

    // Each chain plane (the primal m pre, a tangent m (hidden product +
    // Wx_rel row)), then the mask, staged and stored by rows.
    const long long rw0 = r0 + 16 * cs.warp;
    if (rw0 >= rows || n0 >= w) return;
    const long long left = rows - rw0;
    const int cols = w - n0 < kN ? w - n0 : kN;
    const long long plane = rows * w;
#pragma unroll
    for (int c1 = 0; c1 <= D; ++c1) {
      uint32_t in[8];
      if (c1 > 0) pairs(in, wxr + (long long)(c1 - 1) * s, n0, cs);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * cs.t, row = cs.g + 8 * h;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const float m = (pos >> i) & 1 ? 1.f : slope;
            float x = acc[0][i];
            if (c1 > 0) {
              const float inj = bf16_at(in[j], e);
              x = hidden ? acc[c1][i] + inj : inj;
            }
            v[e] = m * x;
          }
          if constexpr (!kF32)
            *reinterpret_cast<__nv_bfloat162*>(staged(cs.out, row, 2 * col)) =
                __floats2bfloat162_rn(v[0], v[1]);
          else
            *reinterpret_cast<float2*>(staged(cs.out, row, 4 * col)) =
                make_float2(v[0], v[1]);
        }
      const long long o = c1 * plane + rw0 * w + n0;
      if constexpr (!kF32)
        flush<2 * kN, true>(cs.out, reinterpret_cast<unsigned char*>(xb + o), 2 * w,
                      left, 2 * cols, vec_out, cs.lane);
      else
        flush<4 * kN, true>(cs.out, reinterpret_cast<unsigned char*>(xf + o), 4 * w,
                      left, 4 * cols, vec_out, cs.lane);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<uchar2*>(staged(cs.out, cs.g + 8 * h,
                                          8 * j + 2 * cs.t)) =
            make_uchar2((pos >> i) & 1, (pos >> (i + 1)) & 1);
      }
    flush<kN, true>(cs.out, mask + rw0 * w + n0, w, left, cols, vec_out, cs.lane);
  }

  // The thread's 16 values of a Wx_rel row (columns n0 + 8 j + 2 t + e,
  // clamped into the layer) as 8 bf16 pairs.
  __device__ void pairs(uint32_t (&v)[8], const bf16* row, int n0,
                        const Consumer& cs) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + 8 * j + 2 * cs.t;
      v[j] = pack(__halves2bfloat162(row[min(c, w - 1)], row[min(c + 1, w - 1)]));
    }
  }
};

// C = A B^T for B given as rows [n, k] (both operands K-major). kChain: A is
// MT chain planes of 64-row tiles, and C = (A B^T) * mask is written as bf16
// chain planes (cplane apart) and its primal plane in f32 (the backward's
// P_{i-1}; n is even). Else A is plain rows, MT 64-row tiles an item, and C
// is f32 rows, added to (accumulate) or written. Operands: 0 A, 1 B.
template <int MT, bool kChain>
struct Nt {
  static constexpr int kMT = MT, kPasses = 1, kOut = kChain ? kOutBytes : 0;
  static constexpr int kRows = kChain ? kTile : MT * kTile;  // rows an item
  Operand op[2];
  long long rows, cplane;
  int n, k, col_blocks, stages, tma, accumulate, vec_out;
  bf16* cb;              // kChain
  float* c;              // kChain: the primal plane; else the output
  const uint8_t* mask;   // kChain: [rows, n]
  float slope;

  __host__ __device__ int items() const {
    return cdiv(rows, kRows) * col_blocks;
  }
  __device__ int stages_of(int, int) const { return cdiv(k, kTile); }
  __device__ int boxes(int t, int, int kt, Box (&b)[kMaxBoxes]) const {
    const long long r0 = (long long)(t / col_blocks) * kRows;
    const int n0 = (t % col_blocks) * kBN, k0 = kt * kTile;
    int nb = 0;
    for (int u = 0; u < MT; ++u)
      b[nb++] = kChain ? Box{0, u, u, r0, k0}
                       : Box{0, u, 0, r0 + kTile * u, k0};
    for (int u = 0; u < kConsumers; ++u)
      b[nb++] = Box{1, MT + u, 0, n0 + kN * u, k0};
    return nb;
  }

  __device__ void tile(int t, float (&acc)[MT][32], Ring& r,
                       const Consumer& cs) const {
    const long long r0 = (long long)(t / col_blocks) * kRows;
    const int n0 = (t % col_blocks) * kBN + cs.q * kN;
    mma_pass<MT, false, false>(acc, r, stages_of(t, 0), cs);
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
        for (int j = 0; j < 8; ++j) {
          const long long rw = min(rw0 + cs.g + 8 * h, rows - 1);
          const int col = min(n0 + 8 * j + 2 * cs.t, n - 2);
          const uchar2 mk =
              *reinterpret_cast<const uchar2*>(mask + rw * n + col);
          bits |= (uint32_t)(mk.x != 0) << (4 * j + 2 * h);
          bits |= (uint32_t)(mk.y != 0) << (4 * j + 2 * h + 1);
        }
      const long long o = rw0 * n + n0;
#pragma unroll
      for (int c1 = 0; c1 < MT; ++c1) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int i = 4 * j + 2 * h, col = 8 * j + 2 * cs.t;
            const float v0 = ((bits >> i) & 1 ? 1.f : slope) * acc[c1][i];
            const float v1 =
                ((bits >> (i + 1)) & 1 ? 1.f : slope) * acc[c1][i + 1];
            *reinterpret_cast<__nv_bfloat162*>(
                staged(cs.out, cs.g + 8 * h, 2 * col)) =
                __floats2bfloat162_rn(v0, v1);
          }
        flush<2 * kN>(cs.out, reinterpret_cast<unsigned char*>(
                                  cb + c1 * cplane + o),
                      2 * n, left, 2 * cols, vec_out, cs.lane);
      }
      // The primal plane in f32.
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 4 * j + 2 * h, col = 8 * j + 2 * cs.t;
          *reinterpret_cast<float2*>(staged(cs.out, cs.g + 8 * h, 4 * col)) =
              make_float2(((bits >> i) & 1 ? 1.f : slope) * acc[0][i],
                          ((bits >> (i + 1)) & 1 ? 1.f : slope) *
                              acc[0][i + 1]);
        }
      flush<4 * kN>(cs.out, reinterpret_cast<unsigned char*>(c + o), 4 * n,
                    left, 4 * cols, vec_out, cs.lane);
    } else {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long rw = r0 + kTile * m + 16 * cs.warp + cs.g + 8 * h;
          if (rw >= rows) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j)
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
// split-K partials of A^T B (both operands MN-major: their rows are the
// reduction). An item is one chunk x one 64 MT x 128 output tile; a chunk's
// tiles are adjacent items. Chunks are multiples of a stage, so a stage
// never reads past its chunk. Operands: 0 A [m, ka], 1 B [m, nb].
template <int MT>
struct Tn {
  static constexpr int kMT = MT, kPasses = 1, kOut = 0;
  Operand op[2];
  float* part;
  long long m, chunk;
  int ka, nb, mtiles, ntiles, chunks, stages, tma;

  __host__ __device__ int items() const { return chunks * mtiles * ntiles; }
  __device__ int stages_of(int t, int) const {
    const long long m0 = (long long)(t / (mtiles * ntiles)) * chunk;
    return cdiv(min(m, m0 + chunk) - m0, kTile);
  }
  __device__ int boxes(int t, int, int kt, Box (&b)[kMaxBoxes]) const {
    const long long k0 =
        (long long)(t / (mtiles * ntiles)) * chunk + (long long)kt * kTile;
    const int tt = t % (mtiles * ntiles);
    const int i0 = (tt / ntiles) * MT * kTile, n0 = (tt % ntiles) * kBN;
    int n = 0;
    for (int u = 0; u < MT; ++u) b[n++] = Box{0, u, 0, k0, i0 + kTile * u};
    for (int u = 0; u < kConsumers; ++u)
      b[n++] = Box{1, MT + u, 0, k0, n0 + kN * u};
    return n;
  }

  __device__ void tile(int t, float (&acc)[MT][32], Ring& r,
                       const Consumer& cs) const {
    mma_pass<MT, true, true>(acc, r, stages_of(t, 0), cs);
    const int tt = t % (mtiles * ntiles);
    const int i0 = (tt / ntiles) * MT * kTile;
    const int n0 = (tt % ntiles) * kBN + cs.q * kN;
    float* dst = part + (long long)(t / (mtiles * ntiles)) * ka * nb;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + kTile * mi + 16 * cs.warp + cs.g + 8 * h;
        if (i >= ka) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + 8 * j + 2 * cs.t + e;
            if (col < nb)
              dst[(long long)i * nb + col] = acc[mi][4 * j + 2 * h + e];
          }
      }
  }
};

// ---------------------------------------------------------------------------
// Host side.

// The ring of the product kernel with `mt` A tiles a stage and `out` bytes
// of epilogue staging: {stage bytes, stages (0 if fewer than kMinStages
// fit), dynamic shared-memory bytes}.
struct RingPlan {
  int bytes, stages, smem;
};

RingPlan gemm_ring(int mt, int out) {
  RingPlan p;
  p.bytes = (mt + kConsumers) * kTileBytes;
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
// operand is aligned, else the copying producer.
template <class P>
int launch(P p, cudaStream_t st) {
  const int items = p.items();
  if (items <= 0) return 0;
  const RingPlan rp = gemm_ring(P::kMT, P::kOut);
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

#define STPDE_OPERAND(...)                                   \
  do {                                                       \
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
  p.mt = ka <= kTile ? 1 : (ka <= 2 * kTile ? 2 : 4);
  p.mtiles = cdiv(ka, p.mt * kTile);
  p.ntiles = cdiv(nb, kBN);
  p.chunk = chunk_rows(m, p.mtiles * p.ntiles, kTile, &p.chunks);
  return p;
}

long long tn_partial_floats(long long m, int ka, int nb) {
  return (long long)tn_plan(m, ka, nb).chunks * ka * nb;
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

// 16-byte stores of `elem`-byte values at rows ld apart from p are aligned.
bool vec_rows(const void* p, long long ld, int elem) {
  return (uintptr_t)p % 16 == 0 && (ld * elem) % 16 == 0;
}

// out[ka, nb] (row stride ldo) = A[m, ka]^T B[m, nb] for A rows a (row
// stride lda) and B rows b (ldb), deterministic: the chunks' partials, then
// their fixed-order sum.
template <int MT>
int tn_launch(const bf16* a, long long lda, const bf16* b, long long ldb,
              long long m, int ka, int nb, const TnPlan& pl, float* part,
              cudaStream_t st) {
  Tn<MT> g{};
  STPDE_OPERAND(&g.op[0], a, lda, m, ka);
  STPDE_OPERAND(&g.op[1], b, ldb, m, nb);
  g.part = part;
  g.m = m, g.chunk = pl.chunk;
  g.ka = ka, g.nb = nb, g.mtiles = pl.mtiles, g.ntiles = pl.ntiles;
  g.chunks = pl.chunks;
  return launch(g, st);
}

int gemm_tn(const bf16* a, long long lda, const bf16* b, long long ldb,
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

// Layer i of the forward as problem F (FwdLayer<D, i == 4>).
template <class F>
int fwd_layer(const Shape& sh, const bf16* feats, const float* frac,
              const Weights& wt, bf16* const* xb, float* x4,
              uint8_t* const* mask, int i, float slope, cudaStream_t st) {
  const int kp = i ? sh.w[i - 1] : 0, w = sh.w[i];
  F f{};
  STPDE_OPERAND(&f.op[0], feats, sh.c, sh.rows, sh.c);
  STPDE_OPERAND(&f.op[1], wt.wx_feat + sh.off[i], sh.s, sh.c, w);
  if (i) {
    STPDE_OPERAND(&f.op[2], xb[i - 1], kp, sh.rows, kp, F::kMT,
                  sh.rows * kp);
    STPDE_OPERAND(&f.op[3], wt.wh[i - 1], w, kp, w);
  } else {
    f.op[2] = f.op[0], f.op[3] = f.op[1];  // unused: no hidden product
  }
  f.rows = sh.rows;
  f.kp = kp, f.c = sh.c, f.w = w, f.s = sh.s;
  f.col_blocks = cdiv(w, kBN);
  f.frac = frac;
  f.wxr = wt.wx_rel + sh.off[i];
  f.cb = wt.corner_bias + sh.off[i];
  f.xb = F::kF32 ? nullptr : xb[i];
  f.xf = F::kF32 ? x4 : nullptr;
  f.mask = mask[i];
  const int elem = F::kF32 ? 4 : 2;
  f.vec_out = vec_rows(F::kF32 ? (const void*)x4 : (const void*)xb[i], w,
                       elem) &&
              vec_rows(mask[i], w, 1) && (sh.rows * w * elem) % 16 == 0;
  f.slope = slope;
  return launch(f, st);
}

template <class J>
int run_forward(const Shape& sh, const bf16* feats, const float* frac,
                const Weights& wt, float* out, void* ws, float slope,
                cudaStream_t st) {
  constexpr int D = J::kDim;
  bf16* xb[kLayers - 1];
  float* x4;
  uint8_t* mask[kLayers];
  fwd_views(sh, ws, xb, &x4, mask);
  for (int i = 0; i < kLayers; ++i) {
    const int e = i == kLayers - 1
                      ? fwd_layer<FwdLayer<D, true>>(sh, feats, frac, wt, xb,
                                                     x4, mask, i, slope, st)
                      : fwd_layer<FwdLayer<D, false>>(sh, feats, frac, wt, xb,
                                                      x4, mask, i, slope, st);
    if (e) return e;
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

  int cur = 0;
  for (int i = kLayers - 1; i >= 0; --i) {
    const int w = sh.w[i];
    if (i > 0) {
      // dWh_i = X_{i-1}^T P_i over the chain rows.
      const int kp = sh.w[i - 1];
      e = gemm_tn(x[i - 1], kp, pb[cur], w, mrows, kp, w, part, gr.wh[i - 1],
                  w, st);
      if (e) return e;
    }
    e = gemm_tn(feats, sh.c, pb[cur], w, sh.rows, sh.c, w, part,
                gr.wx_feat + sh.off[i], sh.s, st);
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
    // d feats2 (+)= P_i[primal] Wx_feat[:, sl_i]^T.
    Nt<4, false> nf{};
    STPDE_OPERAND(&nf.op[0], pb[cur], w, sh.rows, w);
    STPDE_OPERAND(&nf.op[1], wt.wx_feat + sh.off[i], sh.s, sh.c, w);
    nf.rows = sh.rows;
    nf.n = sh.c, nf.k = w, nf.col_blocks = cdiv(sh.c, kBN);
    nf.accumulate = i != kLayers - 1;
    nf.c = dfeats;
    e = launch(nf, st);
    if (e) return e;
    if (i > 0) {
      // P_{i-1} = (P_i Wh_i^T) * mask_{i-1}, into the other buffers.
      const int kp = sh.w[i - 1];
      Nt<J::kChains, true> nc{};
      STPDE_OPERAND(&nc.op[0], pb[cur], w, sh.rows, w, J::kChains,
                    sh.rows * w);
      STPDE_OPERAND(&nc.op[1], wt.wh[i - 1], w, kp, w);
      nc.rows = sh.rows;
      nc.cplane = sh.rows * kp;
      nc.n = kp, nc.k = w, nc.col_blocks = cdiv(kp, kBN);
      nc.cb = pb[1 - cur];
      nc.c = pf[1 - cur];
      nc.mask = mask[i - 1];
      nc.slope = slope;
      nc.vec_out = vec_rows(pb[1 - cur], kp, 2) &&
                   vec_rows(pf[1 - cur], kp, 4) &&
                   (sh.rows * kp * 2) % 16 == 0;
      e = launch(nc, st);
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

// The product kernel's ring with `mt` A tiles a stage and (staging != 0)
// the epilogue's staging rows: {stage bytes, ring stages, dynamic
// shared-memory bytes, threads a CTA}.
void stpde_jet_bf16_ring(int mt, int staging, long long* out) {
  const RingPlan p = gemm_ring(mt, staging ? kOutBytes : 0);
  const long long v[4] = {p.bytes, p.stages, p.smem, kGemmThreads};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
}

// The split-K plan of A^T B over m rows into [ka, nb]: {A tiles an item,
// output tiles along ka, along nb, chunk rows, chunks}.
void stpde_jet_bf16_tn_plan(long long m, int ka, int nb, long long* out) {
  const TnPlan p = tn_plan(m, ka, nb);
  const long long v[5] = {p.mt, p.mtiles, p.ntiles, p.chunk, p.chunks};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
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
