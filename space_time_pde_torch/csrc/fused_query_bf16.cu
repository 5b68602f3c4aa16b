// The bf16 fused local-implicit-grid decode + multilinear blend for Hopper
// (sm_90a): both bf16 entries, stpde_decode_blend_gather_bf16 and
// stpde_decode_blend_bf16.
//
// Replaces the Pallas TPU kernels of space_time_pde_tpu/ops/fused_query.py
// at compute_dtype=bfloat16: _kernel_gather (:244, pallas_call :389; the
// gather entry, cell-major table + flat cell ids) and _kernel (:400,
// pallas_call :510; the pre-gathered entry, kPre). Per corner row the ImNet
// chain of csrc/fused_query.cu's note, at the TPU kernels' rounding points
// (the plain twins, ops/fused_query.py::decode_blend_gather_plain and
// decode_blend_plain at bf16, round at the same points): the table (rows)
// bf16; the weights bf16, corner_bias bf16 for the gather entry and f32 for
// kPre, b5 f32; frac rounded to bf16 for the coordinate term, the blend
// weights from the f32 frac; every sum and activation in f32; h_0..h_3
// rounded to bf16 where they are stored, h_4 f32; hblend rounded to bf16
// before the head. kPre rounds the whole skip term (latents, coordinate
// term and corner bias) to bf16 before the hidden product is added.
//
// Bound: arithmetic, 0.88 ms per 65,536 flagship points (C = 64, nf = 64)
// at D = 3 (8.7e11 operations at 989 TFLOP/s dense bf16), 1.76 ms at D = 4.
// A 64-row tile needs all five layers' weights (1.71 MB of bf16 with the
// skip columns) for 106 MFLOP: 62 operations a byte, so the weights' path
// from L2 into shared memory, not HBM, is what a design must keep up.
//
// Design:
// - The skip term is part of every layer's product. A tile's X operand is
//   [latents | bf16(frac) | corner one-hots | 0], kx = C + D + P 2^D
//   columns padded to 16 (P = 1 bf16 piece of corner_bias for the gather
//   entry, 3 for kPre, whose f32 corner_bias is split exactly into three
//   bf16 pieces), and layer i's B is [Wx_feat_i ; Wx_rel_i ; cb_i ; 0 ;
//   Wh_i]: the coordinate term and the corner bias are products with
//   exact operands summed in f32 on the tensor cores, and the epilogue is
//   only the activation and the store. K runs over X first, then h_{i-1},
//   so kPre rounds its accumulators between the two.
// - The weights are pre-tiled on the host (ops/fused_query.py::
//   decode_tiles, once per decoder) into the exact shared-memory image of
//   wgmma's K-major, no-swizzle B operand, stage by stage in the order the
//   kernel consumes them: layer, column pass (at most 512 columns), then
//   16 KB stages of 8192 / columns K rows (16 at 512 columns; a layer's
//   last stage ragged), each stage [k16 block][8-column group][2 k
//   halves][8 x 8 core matrix]. No tensor map: each CTA's share of a
//   stage is one contiguous bulk copy.
// - Thread-block clusters of kCluster = 2 CTAs (__cluster_dims__): each
//   CTA loads half of every stage with one
//   cp.async.bulk...multicast::cluster, which lands in both CTAs: the
//   weights leave L2 once per cluster, not once per tile. (Clusters of 4
//   fit only 120 CTAs on the card at this shared-memory size, and ran
//   slower.)
// - A ring of `stages` 16 KB slots with full / empty mbarriers: thread 0
//   (warpgroup 0, 40 registers after setmaxnreg) runs ahead through a
//   fixed sequence (every tile walks the same image) across stages,
//   passes, layers and tiles. A slot is refilled once the two consumer
//   warpgroups of every CTA in the cluster have released it (remote
//   mbarrier arrives at CTA scope); no block-wide barrier per K step.
// - Warps 1-3 of warpgroup 0 gather each tile's X and frac (cp.async from
//   the table) into a double buffer, two tiles ahead at most, with their
//   own full / empty mbarriers.
// - Two consumer warpgroups (232 registers) split each pass's columns,
//   wgmma.mma_async m64nNk16 (N <= 256, at most 128 f32 accumulators a
//   thread), A and B from shared memory through descriptors, the previous
//   stage's products in flight while a stage issues. Every wgmma sits on
//   no conditional path and nothing but wgmma writes the accumulators
//   between a pass's first product (which overwrites them) and its last
//   wait: otherwise ptxas serializes every wgmma (its info C7520).
// - Layer by layer at 64 rows: h_i is stored (bf16, in the A operand's
//   core-matrix layout) over the one activation buffer H after both
//   warpgroups finish the layer's K loop; h_0 (16 nf wide) takes it whole.
//   The epilogue's activation is a functor (leaky_relu and relu have their
//   own; activate()'s switch, unrolled over 128 values, is if-converted
//   and runs all ten).
// - Persistent: one CTA per SM (as many clusters as fit at once), each
//   cluster walking groups of kCluster tiles with a fixed
//   stride; the producer fetches the next tile's first stages during the
//   blend and head. Every row is computed by the same operations wherever
//   it lands and written once: the output is the same bit for bit from
//   launch to launch.
//
// Budget at C = 64, nf = 64, D = 3 (gather): H 131,072 B (64 x 1024 bf16;
// h_4 as f32 and the blended rows reuse it), X 2 x 10,240 B (kx = 80),
// frac 512 B, 4 ring stages of 16,384 B, 96 B of mbarriers: 217,696 B of
// the 232,448 a CTA may take; ptxas: 168 registers a thread at launch
// (12-20 bytes of spill, chip_smoke.py's ptxas line), then 40 for
// warpgroup 0 and 232 for the consumers. The ring
// takes what the rest leaves, 3 to 8 stages; a shape that leaves fewer
// than 3 is refused. Limits: nf <= 64 (widths padded to powers of two >=
// 32, 16 nf at most 1024), 2^D <= 64, and the plan within 227 KB (at
// nf = 64, D = 3: C <= 181 for the gather entry, C <= 165 pre-gathered). A
// shape beyond them returns the CUDA error of the refused launch
// (cudaErrorInvalidValue), which the wrapper raises.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (nvidia-smi's power.limit), 65,536
// flagship points (chip_smoke.py phases G and L, CUDA events): the gather
// entry 2.32 ms at D = 3 and 4.62 ms at D = 4, 38% of the bound (the
// mma.sync body before this design: 11.88 / 24.96 ms, 7%); the
// pre-gathered entry 2.76 / 5.50 ms (its X is wider: kx 96 / 128). What
// holds it at 38%, derived from the design and not measured: at 64 rows
// a tile every 16 KB stage is written into shared memory once and read by
// both warpgroups' wgmmas, about 144 bytes a clock against the SM's 128;
// each of a tile's six layer passes drains the wgmma pipeline for its
// epilogue, with the tensor cores idle through it and through the blend
// and head; and the narrow layers 2-4 (N = 128, 64, 32 a warpgroup) give
// each wgmma less work for the same issue and wait.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (space_time_pde_torch/ops/_build.py). wgmma, setmaxnreg and the
// multicast bulk copy exist only on sm_90a.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                  // corner rows a tile (wgmma m64)
constexpr int kCluster = 2;                // CTAs a cluster
constexpr int kConsumers = 2;              // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kXThreads = 96;              // warps 1-3 of warpgroup 0
constexpr int kPass = 512;                 // columns a layer pass
constexpr int kStageBytes = 16384;         // a ring slot
constexpr int kMinStages = 3, kMaxStages = 8;
constexpr int kMaxSmem = 232448;           // 227 KB, a CTA's most
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Sizes and the shared-memory plan (bytes); the ring sits at 0.
struct Plan {
  int c, dim, nf, out_dim, pieces;
  int w[5];       // layer widths, padded to powers of two >= 32
  int kx;         // X columns: C + D + pieces 2^D, padded to 16
  int stages;     // ring slots
  int x_bytes;    // one X buffer
  int o_h, o_x, o_fr, o_bar, total;
  long long image;  // elements of the tile image
};

int pow2_at_least(int x, int lo) {
  int p = lo;
  while (p < x) p <<= 1;
  return p;
}

Plan make_plan(int c, int dim, int nf, int out_dim, int pieces) {
  Plan s{};
  s.c = c, s.dim = dim, s.nf = nf, s.out_dim = out_dim, s.pieces = pieces;
  for (int i = 0; i < 5; ++i) s.w[i] = pow2_at_least(nf << (4 - i), 32);
  s.kx = (c + dim + (pieces << dim) + 15) / 16 * 16;
  s.image = 0;
  for (int i = 0; i < 5; ++i)
    s.image += (long long)s.w[i] * (s.kx + (i ? s.w[i - 1] : 0));
  const int ld4 = s.w[4] + 4;
  int h = 2 * kRows * s.w[0];
  const int h4 = 4 * (kRows * ld4 + (kRows >> dim) * nf);
  if (h4 > h) h = h4;
  h = (h + 127) / 128 * 128;
  s.x_bytes = 2 * kRows * s.kx;
  const int rest = h + 2 * s.x_bytes + 2 * 4 * kRows;
  int st = (kMaxSmem - rest - 32) / (kStageBytes + 16);
  st = st < kMinStages ? kMinStages : (st > kMaxStages ? kMaxStages : st);
  s.stages = st;
  s.o_h = st * kStageBytes;
  s.o_x = s.o_h + h;
  s.o_fr = s.o_x + 2 * s.x_bytes;
  s.o_bar = s.o_fr + 2 * 4 * kRows;
  s.total = s.o_bar + 16 * st + 32;  // + X's full and empty barriers
  return s;
}

// --- PTX ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ int cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int n_clusters() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Arrive on the mbarrier at the same offset in CTA `cta` of the cluster
// (release at CTA scope: what it orders, wgmma's reads of the slot, has
// completed at wgmma.wait_group; a cluster-scope release stalls every
// stage).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar,
                                                   uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// `bytes` from global memory to the same offset in every CTA of the
// cluster, each CTA's mbarrier at `bar` counting them.
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src,
                                               int bytes, uint32_t bar) {
  const uint16_t mask = (uint16_t)((1u << kCluster) - 1);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The consumer warpgroups' own barrier (the producer never waits on it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");
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
template <int kN>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kN) : "memory");
}

// Keeps the compiler from moving accumulator reads across a wait.
template <int kR>
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A K-major, no-swizzle shared-memory operand: 8 x 8 core matrices of
// 128 contiguous bytes, the two k halves of a k16 step 128 bytes apart
// (leading byte offset), 8-row groups `sbo` bytes apart.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// m64nNk16, bf16 x bf16 -> f32, A and B from shared memory (K-major):
// D = A B + (scale_d ? D : 0).
__device__ __forceinline__ void wgmma_n16(float (&d)[128], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[128], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[128], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[128], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t a,
                                      uint64_t b, int scale_d) {
  if constexpr (N == 256) wgmma_n256(d, a, b, scale_d);
  else if constexpr (N == 128) wgmma_n128(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_n64(d, a, b, scale_d);
  else if constexpr (N == 32) wgmma_n32(d, a, b, scale_d);
  else wgmma_n16(d, a, b, scale_d);
}

// --- the kernel ----------------------------------------------------------------

// The ring's position, the same sequence in the producer and the consumers.
struct Ring {
  uint32_t slots, bars;  // slot 0; full[i] at bars + 8 i, empty after them
  int n, stage, phase;
  __device__ uint32_t full() const { return bars + 8 * stage; }
  __device__ uint32_t empty() const { return bars + 8 * (n + stage); }
  __device__ uint32_t slot() const { return slots + stage * kStageBytes; }
  __device__ void advance() {
    if (++stage == n) stage = 0, phase ^= 1;
  }
};

// Layer i's width, K depth and pass columns. Selects, not s.w[i]: an
// array indexed at run time would put the plan in local memory, and
// ptxas then treats every branch on it as divergent (which serializes the
// wgmmas after it).
__device__ __forceinline__ int width(const Plan& s, int i) {
  return i == 0 ? s.w[0]
                : i == 1 ? s.w[1] : i == 2 ? s.w[2] : i == 3 ? s.w[3] : s.w[4];
}
__device__ __forceinline__ int layer_k(const Plan& s, int layer) {
  return s.kx + (layer ? width(s, layer - 1) : 0);
}
__device__ __forceinline__ int pass_cols(const Plan& s, int layer) {
  const int w = width(s, layer);
  return w < kPass ? w : kPass;
}

// The producer: every stage of the image, tile after tile, its 1 / kCluster
// slice multicast to the cluster once every consumer there released the
// slot.
__device__ __forceinline__ void produce(const Plan& s, const char* image, Ring r, int iters,
                        uint32_t rank) {
  for (int it = 0; it < iters; ++it) {
    const char* p = image;
    for (int layer = 0; layer < 5; ++layer) {
      const int np = pass_cols(s, layer), k = layer_k(s, layer);
      const int kd = kStageBytes / (2 * np);
      for (int c0 = 0; c0 < width(s, layer); c0 += np)
        for (int k0 = 0; k0 < k; k0 += kd) {
          const int bytes = 2 * np * (k - k0 < kd ? k - k0 : kd);
          const int slice = bytes / kCluster;
          mbar_wait(r.empty(), r.phase ^ 1);
          mbar_expect_tx(r.full(), bytes);
          bulk_multicast(r.slot() + rank * slice, p + rank * slice, slice,
                         r.full());
          p += bytes;
          r.advance();
        }
    }
  }
}

// What a consumer thread knows about its tile.
struct Consumer {
  int ct;              // 0..255 over both consumer warpgroups
  int q;               // warpgroup: which half of a pass's columns
  int warp, lane;      // within the warpgroup
  uint32_t h, x;       // H and the tile's X buffer
  unsigned char* hp;   // H
  int act;
  float ns;
};

// acc[0 : N / 2] = X W_x + h_{i-1} W_h over the consumer's N columns of
// the pass (kPre: the X part rounded to bf16 before the h part adds).
template <int N, bool kPre>
__device__ __forceinline__ void mma_pass(float (&acc)[128], const Plan& s,
                                         const Consumer& c, int layer,
                                         Ring& r) {
  constexpr int R = N / 2;
  // The accumulators' last writer before the wgmmas, at a point where the
  // whole warpgroup is converged: ptxas injects its register fence here
  // and not in a divergent loop (which serializes every wgmma).
  fence_acc<R>(acc);
  const int np = 2 * N, kd = kStageBytes / (2 * np);
  const int k = layer_k(s, layer), kin = k - s.kx;
  const uint32_t sbo_x = 16 * s.kx, sbo_h = 16 * kin;
  int prev = -1;
  uint32_t b = 0;
  // One k16 block: a new stage starts every kd rows (wait for it), the
  // product, and a stage's last block commits its products, waits for the
  // previous stage's and releases that stage's slot in every CTA of the
  // cluster. The wgmma itself is on no conditional path.
  auto block = [&](int kk) {
    if (kk % kd == 0) {
      mbar_wait(r.full(), r.phase);
      b = r.slot() + c.q * N * 32;
    }
    const uint64_t da = kk < s.kx ? sdesc(c.x + 16 * kk, sbo_x)
                                  : sdesc(c.h + 16 * (kk - s.kx), sbo_h);
    wg_fence();
    // The first product overwrites acc: no other instruction writes the
    // accumulators while wgmma owns them.
    wgmma<N>(acc, da, sdesc(b + 2 * np * (kk % kd), 256), kk > 0);
    if ((kk + 16) % kd == 0 || kk + 16 == k) {
      wg_commit();
      wg_wait<1>();  // the previous stage's products are done; not acc,
                     // which this stage's are still writing (no fence_acc)
      if (prev >= 0 && c.warp == 0 && c.lane < kCluster)
        mbar_arrive_remote(r.bars + 8 * (r.n + prev), c.lane);
      prev = r.stage;
      r.advance();
    }
  };
  for (int kk = 0; kk < s.kx; kk += 16) block(kk);
  if (kPre) {
    // The skip term is complete: xs = bf16(X W_x), and h W_h adds to it.
    wg_commit();
    wg_wait<0>();
    fence_acc<R>(acc);
#pragma unroll
    for (int i = 0; i < R; ++i)
      acc[i] = __bfloat162float(__float2bfloat16_rn(acc[i]));
    fence_acc<R>(acc);
  }
  for (int kk = s.kx; kk < k; kk += 16) block(kk);
  wg_wait<0>();
  fence_acc<R>(acc);
  if (c.warp == 0 && c.lane < kCluster)
    mbar_arrive_remote(r.bars + 8 * (r.n + prev), c.lane);
}

// act(acc) of a pass stored over H: bf16 in the A operand's core-matrix
// layout (layers 0-3, the next layer's K = this layer's width), or f32
// rows [kRows][w4 + 4] (layer 4). Act is the activation as a functor, so
// that the unrolled loop runs only its own code (activate()'s switch over
// all ten, unrolled over 128 values, is if-converted and runs them all).
template <int N, typename Act>
__device__ __forceinline__ void store_pass(const float (&acc)[128],
                                           const Consumer& c, int layer,
                                           int w, int c0, Act act) {
  const int g = c.lane >> 2, t = c.lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = c0 + c.q * N + 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * c.warp + g + 8 * half;
      const float v0 = act(acc[4 * j + 2 * half]);
      const float v1 = act(acc[4 * j + 2 * half + 1]);
      if (layer < 4)
        *reinterpret_cast<__nv_bfloat162*>(
            c.hp + (row >> 3) * 16 * w + (col >> 3) * 128 + (row & 7) * 16 +
            (col & 7) * 2) = __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(c.hp) +
                                   row * (w + 4) + col) = make_float2(v0, v1);
    }
  }
}

struct Relu {
  __device__ float operator()(float x) const { return fmaxf(x, 0.f); }
};
struct LeakyRelu {
  float ns;
  __device__ float operator()(float x) const { return x >= 0.f ? x : ns * x; }
};
struct AnyActivation {
  int code;
  float ns;
  __device__ float operator()(float x) const { return activate(x, code, ns); }
};

// One pass of a layer: the products, then the store. Layers >= 1 read H,
// so both warpgroups finish before either stores.
template <int N, bool kPre>
__device__ __forceinline__ void layer_pass(float (&acc)[128], const Plan& s,
                                           const Consumer& c, int layer,
                                           int c0, Ring& r) {
  mma_pass<N, kPre>(acc, s, c, layer, r);
  if (layer > 0) consumer_sync();
  const int w = width(s, layer);
  if (c.act == 1)
    store_pass<N>(acc, c, layer, w, c0, LeakyRelu{c.ns});
  else if (c.act == 0)
    store_pass<N>(acc, c, layer, w, c0, Relu{});
  else
    store_pass<N>(acc, c, layer, w, c0, AnyActivation{c.act, c.ns});
}

template <bool kPre>
__device__ __forceinline__ void run_layer(float (&acc)[128], const Plan& s,
                                          const Consumer& c, int layer,
                                          Ring& r) {
  const int np = pass_cols(s, layer);
  for (int c0 = 0; c0 < width(s, layer); c0 += np) {
    switch (np) {
      case 512: layer_pass<256, kPre>(acc, s, c, layer, c0, r); break;
      case 256: layer_pass<128, kPre>(acc, s, c, layer, c0, r); break;
      case 128: layer_pass<64, kPre>(acc, s, c, layer, c0, r); break;
      case 64: layer_pass<32, kPre>(acc, s, c, layer, c0, r); break;
      default: layer_pass<16, kPre>(acc, s, c, layer, c0, r); break;
    }
  }
}

// Tile `tile`'s X [kRows][kx] (core-matrix layout) and frac [ppt][D]: row
// r is corner r & (2^D - 1) of point tile ppt + (r >> D), its latents
// from row cell_flat[p] of the cell-major table (NaN for a cell outside
// [0, n_cells)) or from the pre-gathered rows (kPre), then bf16(frac), the
// corner's one-hot over `pieces` columns, zeros; all 0 past point n. The
// latents go by cp.async where rows are 16-byte aligned (the caller waits).
// Thread t of kXThreads.
template <bool kPre>
__device__ __forceinline__ void stage_x(unsigned char* x, float* fr,
                                        const bf16* __restrict__ src,
                                        const int* __restrict__ cell_flat,
                                        const float* __restrict__ frac,
                                        long long tile, int n, int n_cells,
                                        const Plan& s, int t) {
  const int dim = s.dim, nk = 1 << dim, ppt = kRows >> dim;
  const long long p0 = tile * ppt;
  for (int i = t; i < ppt * dim; i += kXThreads)
    fr[i] = p0 + i / dim < n ? frac[p0 * dim + i] : 0.f;
  auto at = [&](int r, int k) {
    return reinterpret_cast<bf16*>(x + (r >> 3) * 16 * s.kx + (k >> 3) * 128 +
                                   (r & 7) * 16 + (k & 7) * 2);
  };
  // The row's latents, or null (0 past n; NaN for a bad cell).
  auto row_src = [&](int r, bool& bad) -> const bf16* {
    const long long gp = p0 + (r >> dim);
    const int k = r & (nk - 1);
    bad = false;
    if (gp >= n) return nullptr;
    if (kPre) return src + ((size_t)gp * nk + k) * s.c;
    const int cell = cell_flat[gp];
    bad = cell < 0 || cell >= n_cells;
    return bad ? nullptr : src + ((size_t)cell * nk + k) * s.c;
  };
  const bf16 nan = __ushort_as_bfloat16((unsigned short)0x7fc0);
  const bf16 zero = __ushort_as_bfloat16((unsigned short)0);
  if ((s.c & 7) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int q8 = s.c >> 3;
#pragma unroll 4
    for (int i = t; i < kRows * q8; i += kXThreads) {
      const int r = i / q8, q = i - r * q8;
      bool bad;
      const bf16* g = row_src(r, bad);
      bf16* d = at(r, 8 * q);
      if (g) {
        cp16(d, g + 8 * q);
      } else {
        const uint32_t u = bad ? 0x7fc07fc0u : 0u;
        *reinterpret_cast<uint4*>(d) = make_uint4(u, u, u, u);
      }
    }
  } else {
    for (int i = t; i < kRows * s.c; i += kXThreads) {
      const int r = i / s.c, ch = i - r * s.c;
      bool bad;
      const bf16* g = row_src(r, bad);
      *at(r, ch) = g ? g[ch] : (bad ? nan : zero);
    }
  }
  const int na = s.kx - s.c;
#pragma unroll 4
  for (int i = t; i < kRows * na; i += kXThreads) {
    const int r = i / na, j = i - r * na;
    const long long gp = p0 + (r >> dim);
    const int k = r & (nk - 1);
    float v = 0.f;
    if (gp < n) {
      if (j < dim)
        v = frac[gp * dim + j];
      else if (j - dim < (s.pieces << dim))
        v = (j - dim) / s.pieces == k ? 1.f : 0.f;
    }
    *at(r, s.c + j) = __float2bfloat16_rn(v);
  }
}

// Warps 1-3 of warpgroup 0: each tile's X and frac into the buffer the
// consumers freed two tiles ago, signalled through X's full barrier.
template <bool kPre>
__device__ __forceinline__ void load_x(const Plan& s, unsigned char* smem,
                                       uint32_t xbars, int iters,
                                       long long first, long long stride,
                                       const bf16* src, const int* cell_flat,
                                       const float* frac, int n, int n_cells,
                                       int t) {
  for (int it = 0; it < iters; ++it) {
    const int b = it & 1;
    mbar_wait(xbars + 8 * (2 + b), ((it >> 1) & 1) ^ 1);  // X[b] is free
    stage_x<kPre>(smem + s.o_x + b * s.x_bytes,
                  reinterpret_cast<float*>(smem + s.o_fr) + b * kRows, src,
                  cell_flat, frac, first + it * stride, n, n_cells, s, t);
    cp_commit_wait_all();
    fence_async_smem();
    mbar_arrive(xbars + 8 * b);
  }
}

template <bool kPre>
__device__ __forceinline__ void consume(const Plan& s, unsigned char* smem,
                                        Ring r, uint32_t xbars, int iters,
                                        long long first, long long stride,
                                        const bf16* w5, const float* b5,
                                        float* out, int n, int act,
                                        float ns) {
  Consumer c;
  c.ct = threadIdx.x - 128;
  c.q = c.ct >> 7;
  c.warp = (c.ct & 127) >> 5;
  c.lane = c.ct & 31;
  c.hp = smem + s.o_h;
  c.h = smem_u32(c.hp);
  c.act = act;
  c.ns = ns;
  const int dim = s.dim, nk = 1 << dim, ppt = kRows >> dim, nf = s.nf;
  auto xbuf = [&](int b) { return smem + s.o_x + b * s.x_bytes; };
  auto frbuf = [&](int b) {
    return reinterpret_cast<float*>(smem + s.o_fr) + b * kRows;
  };
  float acc[128];
  for (int it = 0; it < iters; ++it) {
    const int b = it & 1;
    const long long tile = first + it * stride;
    mbar_wait(xbars + 8 * b, (it >> 1) & 1);  // X[b] holds this tile
    c.x = smem_u32(xbuf(b));
    for (int layer = 0; layer < 5; ++layer) {
      run_layer<kPre>(acc, s, c, layer, r);
      if (layer < 4) fence_async_smem();
      consumer_sync();
    }

    // h_4 (f32) is in H; blend the corners in f32, rounded to bf16, into
    // hb [ppt][nf] after it, then the head on bf16 x bf16 products.
    const float* fr = frbuf(b);
    const float* h4 = reinterpret_cast<const float*>(c.hp);
    const int ld4 = s.w[4] + 4;
    float* hb = reinterpret_cast<float*>(c.hp) + kRows * ld4;
    for (int i = c.ct; i < ppt * nf; i += kConsumerThreads) {
      const int pp = i / nf, j = i - pp * nf;
      float v = 0.f;
      for (int k = 0; k < nk; ++k) {
        float wk = 1.f;
        for (int d = 0; d < dim; ++d) {
          const float f = fr[pp * dim + d];
          wk *= ((k >> (dim - 1 - d)) & 1) ? f : 1.f - f;
        }
        v += h4[(pp * nk + k) * ld4 + j] * wk;
      }
      hb[i] = __bfloat162float(__float2bfloat16_rn(v));
    }
    consumer_sync();
    const int warp = c.ct >> 5;
    for (int i = warp; i < ppt * s.out_dim; i += kConsumerThreads / 32) {
      const int pp = i / s.out_dim, o = i - pp * s.out_dim;
      float v = 0.f;
      for (int j = c.lane; j < nf; j += 32)
        v += hb[pp * nf + j] *
             __bfloat162float(__ldg(w5 + (size_t)j * s.out_dim + o));
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, m);
      const long long gp = tile * ppt + pp;
      if (c.lane == 0 && gp < n)
        out[(size_t)gp * s.out_dim + o] = v + __ldg(b5 + o);
    }
    consumer_sync();  // H, X[b] and frac[b] are free again
    if (c.ct == 0) mbar_arrive(xbars + 8 * (2 + b));
  }
}

// kPre: the pre-gathered entry (src: feats2 rows, corner_bias f32 in three
// bf16 pieces, the skip term rounded to bf16), else the gather entry (src:
// the cell-major table).
template <bool kPre>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 1)
    decode_bf16_kernel(const bf16* __restrict__ src,
                       const int* __restrict__ cell_flat,
                       const float* __restrict__ frac,
                       const bf16* __restrict__ image,
                       const bf16* __restrict__ w5,
                       const float* __restrict__ b5,
                       float* __restrict__ out, int n, int n_cells, Plan s,
                       int act, float ns) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t rank = cluster_rank();
  const int ppt = kRows >> s.dim;
  const long long n_tiles = ((long long)n + ppt - 1) / ppt;
  const long long groups = (n_tiles + kCluster - 1) / kCluster;
  const int cid = cluster_id(), ncl = n_clusters();
  const int iters =
      cid < groups ? (int)((groups - cid + ncl - 1) / ncl) : 0;
  Ring r{smem_u32(smem), smem_u32(smem + s.o_bar), s.stages, 0, 0};
  // X's barriers after the ring's: full[2] (the loader warps arrive), then
  // empty[2] (a consumer arrives when a tile is done with its buffer).
  const uint32_t xbars = r.bars + 16 * s.stages;
  const long long first = (long long)cid * kCluster + rank;
  const long long stride = (long long)ncl * kCluster;
  if (threadIdx.x == 0) {
    for (int i = 0; i < s.stages; ++i) {
      mbar_init(r.bars + 8 * i, 1);
      mbar_init(r.bars + 8 * (s.stages + i), kConsumers * kCluster);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(xbars + 8 * b, kXThreads);
      mbar_init(xbars + 8 * (2 + b), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers are set before any copy or arrive
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      produce(s, reinterpret_cast<const char*>(image), r, iters, rank);
    else if (threadIdx.x >= 32)
      load_x<kPre>(s, smem, xbars, iters, first, stride, src, cell_flat,
                   frac, n, n_cells, threadIdx.x - 32);
    cluster_sync();
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<kPre>(s, smem, r, xbars, iters, first, stride, w5, b5, out, n,
                  act, ns);
    cluster_sync();  // no peer still multicasts or arrives into this CTA
  }
}

// Clusters that fit on the card at once at this plan (cached per kernel and
// shared-memory size).
template <bool kPre>
int max_clusters(int smem, cudaError_t& e) {
  static int cached_smem = -1, cached = 0;
  e = cudaSuccess;
  if (smem == cached_smem) return cached;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int m = 0;
  e = cudaOccupancyMaxActiveClusters(&m, decode_bf16_kernel<kPre>, &cfg);
  if (e != cudaSuccess) return 0;
  cached_smem = smem, cached = m;
  return m;
}

template <bool kPre>
int launch(const bf16* src, const int* cell_flat, const float* frac,
           const bf16* image, long long image_elems, const bf16* w5,
           const float* b5, float* out, int n, int n_cells, int c, int dim,
           int nf, int out_dim, int act, float ns, void* stream) {
  if (n <= 0) return 0;
  if (dim < 1 || (1 << dim) > kRows || nf < 1 || c < 1)
    return (int)cudaErrorInvalidValue;
  const Plan s = make_plan(c, dim, nf, out_dim, kPre ? 3 : 1);
  if (s.w[0] > 2 * kPass || image_elems != s.image)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      decode_bf16_kernel<kPre>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      s.total);
  int clusters = e == cudaSuccess ? max_clusters<kPre>(s.total, e) : 0;
  if (e == cudaSuccess && clusters < 1) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return (int)e;
  }
  const int ppt = kRows >> dim;
  const long long groups =
      (((long long)n + ppt - 1) / ppt + kCluster - 1) / kCluster;
  if (groups < clusters) clusters = (int)groups;
  decode_bf16_kernel<kPre><<<clusters * kCluster, kThreads, s.total,
                             (cudaStream_t)stream>>>(
      src, cell_flat, frac, image, w5, b5, out, n, n_cells, s, act, ns);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table [n_cells, 2^D * C] bf16, the tile image of
// ops/fused_query.py::decode_tiles(pregathered=False) (image_elems bf16
// values), w5 [nf, out] bf16, b5 f32, frac and out f32.
int stpde_decode_blend_gather_bf16(
    const void* table, const int* cell_flat, const float* frac,
    const void* image, long long image_elems, const void* w5,
    const float* b5, float* out, int n, int n_cells, int c, int dim, int nf,
    int out_dim, int act_code, float negative_slope, void* stream) {
  auto p = [](const void* q) { return static_cast<const bf16*>(q); };
  return launch<false>(p(table), cell_flat, frac, p(image), image_elems,
                       p(w5), b5, out, n, n_cells, c, dim, nf, out_dim,
                       act_code, negative_slope, stream);
}

// feats2 [N * 2^D, C] bf16, the image of decode_tiles(pregathered=True);
// the rest as above.
int stpde_decode_blend_bf16(const void* feats2, const float* frac,
                            const void* image, long long image_elems,
                            const void* w5, const float* b5, float* out,
                            int n, int c, int dim, int nf, int out_dim,
                            int act_code, float negative_slope,
                            void* stream) {
  auto p = [](const void* q) { return static_cast<const bf16*>(q); };
  return launch<true>(p(feats2), nullptr, frac, p(image), image_elems,
                      p(w5), b5, out, n, 0, c, dim, nf, out_dim, act_code,
                      negative_slope, stream);
}

// Corner rows a CTA decodes at a time (points a tile = this >> D).
int stpde_block_rows_bf16(void) { return kRows; }

// The plan of an entry at these widths: {shared-memory bytes a CTA, ring
// stages, kx, tile-image elements, CTAs a cluster, corner rows a tile}.
void stpde_decode_bf16_plan(int c, int dim, int nf, int pregathered,
                            long long* out) {
  const Plan s = make_plan(c, dim, nf, 0, pregathered ? 3 : 1);
  const long long v[6] = {s.total, s.stages, s.kx, s.image, kCluster, kRows};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

}  // extern "C"
