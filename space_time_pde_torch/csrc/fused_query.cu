// The f32 fused local-implicit-grid decode + multilinear blend for Hopper
// (sm_90a): both f32 entries, stpde_decode_blend_gather and
// stpde_decode_blend.
//
// Replaces the two Pallas TPU kernels of
// space_time_pde_tpu/ops/fused_query.py at f32:
//   _kernel_gather (:244, pallas_call :389) -> stpde_decode_blend_gather
//   _kernel        (:400, pallas_call :510) -> stpde_decode_blend
// They compute the same function and differ only in where a point's 2^D
// corner latents come from: row cell_flat[p] of the cell-major table
// [n_cells, 2^D * C], or the pre-gathered rows [N * 2^D, C] (kGather false).
//
// Per point, per corner k (row r = p * 2^D + k of a tile):
//   layer i pre-activation = h_{i-1} @ Wh_i + feats @ Wx_feat[:, sl_i]
//                            + frac @ Wx_rel[:, sl_i] + corner_bias[k, sl_i]
//   h_i = act(pre), widths nf * (16, 8, 4, 2, 1)
// and the rows are blended before the linear head (the weights sum to 1):
//   out[p] = (sum_k w_k h_4[p, k]) @ W5 + b5.
// The activation is picked by an int code in the order of
// space_time_pde_torch/models/nonlinearities.py::NONLINEARITIES.
//
// Bound: arithmetic. At the flagship widths (C = 64, nf = 64) a corner row
// needs ~0.83 M multiply-adds; in 3xTF32 (three TF32 products for each f32
// one, at 495 TFLOP/s dense) 65,536 points take at least 5.27 ms at D = 3
// and 10.57 ms at D = 4 (chip_smoke.py::bound). A 64-row tile needs all
// five layers' weights as TF32 hi and lo planes, 6.8 MB at D = 3, for
// 318 MFLOP of tensor work: the weights' path from L2 into shared memory
// must keep up with the tensor cores.
//
// 3xTF32: every operand x is split into hi = tf32_rna(x) and lo =
// tf32_rna(x - hi), and a product is lo_a hi_b + hi_a lo_b + hi_a hi_b
// (the small ones first). The flagship model's latents reach 1e6, so plain
// TF32 (~3e-3 of max |out| from float64) is not an option. The tensor
// cores truncate as they accumulate: fed every product of a 1,000-deep K
// loop, one accumulator drifted 20x farther from float64 than f32 FFMA (an
// earlier mma.sync design of this kernel, on an H100). So each k8 step's
// three products go into a small temporary that wgmma overwrites with its
// first product, and the temporary is added to an f32 accumulator outside
// the tensor cores (FADD, round to nearest): the promotion of public fp8
// Hopper GEMMs, here every k8 step.
//
// Design:
// - wgmma.mma_async m64nNk8 .tf32 (N = 64 where a warpgroup has 64
//   columns or more, else its column count: 32 for h_0's chunks, down to
//   8 for layer 4 at nf <= 16), A from registers, B from shared memory.
//   .tf32 takes both operands K-major only. The consumers load a k8
//   step's A fragment from f32 shared memory with one 16-byte load a
//   thread (the activations are stored in the fragment's own order,
//   below) and split it in registers.
// - The weights are split once per decoder on the host
//   (ops/fused_query.py::decode_tiles at f32) into the exact shared-memory
//   image of wgmma's K-major, no-swizzle B operand: for every k8 step the
//   hi plane then the lo plane, each [8-column group][2 k halves][8
//   columns][4 k], segment after segment in the order the kernel consumes
//   them (one contiguous run a ring slot).
// - The widths: those of nf = base, the smallest of 16, 32 and 64 that
//   holds nf (base * (16, 8, 4, 2, 1), zero-padded above nf), one
//   instantiation of the kernel each, so a narrow model does no more than
//   the next power of two's work.
// - The latents' skip product runs in each layer's K loop through the
//   tensor cores: a tile's X operand is its corner rows' latents, kx = C
//   columns padded to 8, and layer i's B is [Wx_feat_i ; 0 ; Wh_i] (K: X
//   first, then h_{i-1}). The coordinate term and the corner bias are
//   not: the accumulator starts at frac @ Wx_rel_i + corner_bias_i
//   computed in f32 (rel and cb follow the weight image), as the TPU
//   kernel adds them.
//   Through the tensor cores (a one-hot column per corner), their TF32
//   pieces put a random-init model 2.15x the f32 twin's distance from
//   float64 (limit 2x; an H100 run of this kernel). The epilogue is the
//   activation and the store.
// - The activations never need a transpose: a thread's accumulator holds
//   columns 2t, 2t + 1 of each 8-column block, which the next layer reads
//   as its A fragment's k = t and t + 4 (rows g and g + 8). The host
//   permutes each 8-row block of Wh_i to match ([0, 2, 4, 6, 1, 3, 5, 7]),
//   so a layer stores act(acc) as one float4 a thread and block, and the
//   next loads it as one: no bank conflicts, no padding.
// - Layer 0 (16 base: 1,024 wide, 256 KB at 64 rows in f32) is never stored
//   whole: it is computed in 64-column chunks from X into one of two 16 KB
//   buffers and consumed as layer 1's K steps (chunk j is computed before
//   layer 1's products of chunk j - 1; one barrier a chunk).
// - Thread-block clusters of kCluster = 2 CTAs: each CTA loads half of
//   every ring slot with one cp.async.bulk...multicast::cluster, which lands
//   in both: the weights leave L2 once per cluster, not once per tile.
// - A ring of `stages` slots (one k8 step of layer 1's columns, hi and lo:
//   32 KB at base 64) with full / empty mbarriers:
//   thread 0 (warpgroup 0, 40 registers after setmaxnreg) runs ahead
//   through the fixed sequence across slots, segments, layers and tiles; a
//   slot is refilled once the two consumer warpgroups of every CTA in the
//   cluster released it (remote arrives at CTA scope).
// - Warps 1-3 of warpgroup 0 gather each tile's X (4-byte cp.async, into
//   the fragment order) and frac once the consumers are done with the
//   previous tile's X, while they blend it.
// - Two consumer warpgroups (232 registers) split each layer's columns: a
//   warpgroup holds 64 x (w_i / 2) f32 accumulators (128 a thread in layer
//   1). Per k8 step and 64-column block the three products go into one of
//   two 32-register temporaries: block b's wgmmas are in flight while
//   block b - 1's temporary is waited on and added. Only wgmma writes the
//   temporaries (the first product of a group overwrites) and only the
//   FADD writes the accumulators; no wgmma sits on a conditional path, so
//   ptxas serializes none (its info C7520).
// - Persistent: one CTA per SM, each cluster walking groups of kCluster
//   tiles with a fixed stride. Every row is computed by the same
//   operations wherever it lands and written once: the output is the same
//   bit for bit from launch to launch.
//
// Budget at C = 64, nf = 64, D = 3 (both entries): H 131,072 B (h_1 as 64 x
// 512 f32; h_0's two chunks, h_2, h_3, h_4 and the blended rows reuse it),
// X 16,384 B (kx = 64), frac 512 B, 2 ring slots of 32,768 B, barriers:
// 213,552 B of the 232,448 a CTA may take. The ring takes what the rest
// leaves, at least 2 slots (more at a smaller base: 22 of 8 KB at base
// 16); a plan past 227 KB with 2 slots is refused by the launch.
// Limits: nf <= 64, 2^D <= 64, and the plan within 227 KB: C <= 136 at
// base 64 (C = 137 refused), C <= 520 at base 32 and C <= 712 at base 16.
// A shape beyond them returns the CUDA error of the refused launch
// (cudaErrorInvalidValue), which the wrapper raises.
//
// Times, float64 distances and the promotion intervals tried (every k8
// step ships; 2 was slower, 4 does not fit): PERF.md section 6, measured
// with scripts/time_bf16_decode.py --dtype float32 on an NVIDIA H100.
// What holds it there, derived from the design and not measured: two ring
// slots at base 64, so each refill's L2 latency shows; a drain every k8
// step; the one-block products of h_0's chunks and layers 3-4, which no
// other block's wgmma overlaps; and the skip term's loads at each chunk.
//
// TPU workarounds deliberately NOT carried over: the one-hot MXU gather and
// the sorted 2 x 128-cell windows (corner_tables, window anchors, base_tile,
// the fits-check and its lax.cond fallback) -- a Hopper thread just loads
// the row; the 8-lane frac padding (_FRAC_LANES); 128-lane width padding
// (pad_to); keeping the whole MLP and the [R, 31 nf] skip buffer resident.
//
// A cell id outside [0, n_cells) decodes NaN in its point's row instead of
// reading out of bounds. Build: nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -shared -Xcompiler -fPIC (space_time_pde_torch/ops/_build.py);
// wgmma, setmaxnreg and the multicast bulk copy exist only on sm_90a.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace {

constexpr int kRows = 64;                  // corner rows a tile (wgmma m64)
constexpr int kCluster = 2;                // CTAs a cluster
constexpr int kConsumers = 2;              // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kXThreads = 96;              // warps 1-3 of warpgroup 0
constexpr int kChunk = 64;                 // h_0 columns a chunk
constexpr int kN0 = kChunk / 2;            // a warpgroup's of a chunk
constexpr int kMaxNf = 64;
constexpr int kMaxDim = 6;                 // 2^D <= kRows
constexpr int kMinStages = 2;              // ring slots a plan must have
constexpr int kMaxSmem = 232448;           // 227 KB, a CTA's most
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// The widths run for nf: those of `base`, the smallest of 16, 32 and 64
// that holds nf (zero-padded above nf).
int nf_base(int nf) { return nf <= 16 ? 16 : nf <= 32 ? 32 : 64; }
// Layer i's width (base * 16, 8, 4, 2, 1) and its first column in the
// rel / cb rows (31 base columns in all).
__host__ __device__ constexpr int width(int base, int i) {
  return base << (4 - i);
}
__host__ __device__ constexpr int skip_offset(int base, int i) {
  return base * (32 - (32 >> i));
}
// A ring slot: one k8 step of layer 1's columns, hi and lo planes.
__host__ __device__ constexpr int slot_bytes(int base) {
  return 8 * width(base, 1) * 8;
}
// H: h_1 (64 x width 1 f32), which the two h_0 chunks, h_2, h_3, h_4's
// rows and the blended rows fit in.
constexpr int h_bytes(int base) { return 4 * kRows * width(base, 1); }
constexpr bool h_holds(int base) {
  return 2 * 4 * kRows * kChunk <= h_bytes(base) &&
         4 * (kRows * (base + 4) + kRows * base) <= h_bytes(base);
}
static_assert(h_holds(16) && h_holds(32) && h_holds(64),
              "H holds the h_0 chunks, h_4's rows and the blend");

// Sizes and the shared-memory plan (bytes); the ring sits at 0.
struct Plan {
  int c, dim, nf, out_dim;
  int base;       // nf_base(nf)
  int kx;         // X columns: C, padded to 8
  int stages;     // ring slots
  int slot;       // bytes a slot
  int x_bytes;    // the X buffer
  int o_h, o_x, o_fr, o_bar, total;
  long long weights;  // floats of the weight segments
  long long image;    // and with rel [D, 31 base] and cb [2^D, 31 base]
};

int round_up(int x, int m) { return (x + m - 1) / m * m; }

Plan make_plan(int c, int dim, int nf, int out_dim) {
  Plan s{};
  s.c = c, s.dim = dim, s.nf = nf, s.out_dim = out_dim;
  s.base = nf_base(nf);
  s.kx = round_up(c, 8);
  s.slot = slot_bytes(s.base);
  s.weights = 0;
  for (int i = 0; i < 5; ++i)
    s.weights += 2LL * width(s.base, i) *
                 (s.kx + (i ? width(s.base, i - 1) : 0));
  s.image = s.weights + (long long)(dim + (1 << dim)) * 31 * s.base;
  s.x_bytes = 4 * kRows * s.kx;
  const int rest = h_bytes(s.base) + s.x_bytes + 2 * 4 * kRows;
  const int st = (kMaxSmem - rest - 16) / (s.slot + 16);
  // Fewer than kMinStages slots fit: the plan takes kMinStages anyway, so
  // that its size passes 227 KB and the launch is refused.
  s.stages = st < kMinStages ? kMinStages : st;
  s.o_h = s.stages * s.slot;
  s.o_x = s.o_h + h_bytes(s.base);
  s.o_fr = s.o_x + s.x_bytes;
  s.o_bar = s.o_fr + 2 * 4 * kRows;
  s.total = s.o_bar + 16 * s.stages + 16;  // + X's barriers
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
// completed at wgmma.wait_group).
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

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
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

// Keeps the compiler from reading a temporary before the wait that ends
// the wgmmas writing it.
template <int kR>
__device__ __forceinline__ void fence_regs(float (&d)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// A K-major, no-swizzle shared-memory operand: 8-row x 16-byte core
// matrices of 128 contiguous bytes, the two k halves of a k8 step 128
// bytes apart (leading byte offset), 8-column groups 256 bytes apart.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// m64nNk8, tf32 x tf32 -> f32, A from registers (its m64 x k8 fragment:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of each
// warp's 16 rows), B from shared memory (K-major): D = A B + (scale_d ? D :
// 0).
__device__ __forceinline__ void wgmma_n8(float (&d)[4],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n16(float (&d)[8],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

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

__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  if constexpr (N == 64) wgmma_n64(d, a, b, scale_d);
  else if constexpr (N == 32) wgmma_n32(d, a, b, scale_d);
  else if constexpr (N == 16) wgmma_n16(d, a, b, scale_d);
  else wgmma_n8(d, a, b, scale_d);
}

// --- the kernel ----------------------------------------------------------------

// The ring's position, the same sequence in the producer and the consumers.
struct Ring {
  uint32_t slots, bars;  // slot 0; full[i] at bars + 8 i, empty after them
  int n, stage, phase;
  int bytes;             // a slot's
  __device__ uint32_t full() const { return bars + 8 * stage; }
  __device__ uint32_t empty() const { return bars + 8 * (n + stage); }
  __device__ uint32_t slot() const { return slots + stage * bytes; }
  // K rows a slot holds of a segment np columns wide (a multiple of 8).
  __device__ int rows(int np) const { return bytes / (8 * np); }
  __device__ void advance() {
    if (++stage == n) stage = 0, phase ^= 1;
  }
};

// The producer: every slot of every segment, tile after tile, its
// 1 / kCluster slice multicast to the cluster once every consumer there
// released the slot. The segments, in the consumers' order: layer 0's
// first 64-column chunk; layer 1's X rows; then for each further chunk,
// the chunk and the layer-1 rows of the chunk before it; layer 1's rows
// of the last chunk; then layers 2-4, each its X rows and its h rows.
__device__ __forceinline__ void produce(const Plan& s, const char* image,
                                        Ring r, int iters, uint32_t rank) {
  auto seg = [&](const char*& p, int np, int k) {
    const int kd = r.rows(np);
    for (int k0 = 0; k0 < k; k0 += kd) {
      const int bytes = 8 * np * (k - k0 < kd ? k - k0 : kd);
      const int slice = bytes / kCluster;
      mbar_wait(r.empty(), r.phase ^ 1);
      mbar_expect_tx(r.full(), bytes);
      bulk_multicast(r.slot() + rank * slice, p + rank * slice, slice,
                     r.full());
      p += bytes;
      r.advance();
    }
  };
  const int nch = width(s.base, 0) / kChunk, w1 = width(s.base, 1);
  for (int it = 0; it < iters; ++it) {
    const char* p = image;
    seg(p, kChunk, s.kx);
    seg(p, w1, s.kx);
#pragma unroll 1
    for (int j = 0; j + 1 < nch; ++j) {
      seg(p, kChunk, s.kx);
      seg(p, w1, kChunk);
    }
    seg(p, w1, kChunk);
    for (int layer = 2; layer < 5; ++layer) {
      seg(p, width(s.base, layer), s.kx);
      seg(p, width(s.base, layer), width(s.base, layer - 1));
    }
  }
}

// What a consumer thread knows.
struct Consumer {
  int ct;          // 0..255 over both consumer warpgroups
  int q;           // warpgroup: which half of a layer's columns
  int warp, lane;  // within the warpgroup
  int act;
  float ns;
};

// Index (in floats) of element (r, col) of a [kRows x K] operand stored in
// the order of wgmma's A fragments: [k8 block][warp][lane][a0..a3].
__device__ __forceinline__ int frag_index(int r, int col) {
  const int kb = col >> 3, cc = col & 7, rr = r & 15;
  return (((kb * 4 + (r >> 4)) * 32 + (rr & 7) * 4 + (cc & 3)) << 2) +
         (rr >> 3) + 2 * (cc >> 2);
}

// A k8 step's A fragment, split into TF32 hi and lo.
struct Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void load_frag(Frag& f, const float4* a, int kb,
                                          const Consumer& c) {
  const float4 v = a[(kb * 4 + c.warp) * 32 + c.lane];
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = tf32(x[i]);
    f.lo[i] = tf32(x[i] - __uint_as_float(f.hi[i]));
  }
}

// acc += [A0 | A1] @ B over this warpgroup's NWG columns of `parts`
// consecutive segments 2 NWG wide (A0 k0 deep, then A1 k1 deep), whose
// rows arrive in ring slots; each A in fragment order. Per k8 step and
// BN-column block, the three products go into one of two temporaries
// (wgmma's first product overwrites it), and the temporary is added to
// acc once its products are done: block b's wgmmas fly while block
// b - 1's temporary is added. One body for both parts keeps the code (and
// ptxas's time) small. kNf: the widths' base, so that a slot's rows and
// offsets are constants.
template <int kNf, int NWG>
__device__ __forceinline__ void mma_seg(float (&acc)[NWG / 2],
                                        const float4* a0, int k0n,
                                        const float4* a1, int k1n, int parts,
                                        Ring& r, const Consumer& c) {
  constexpr int BN = NWG < 64 ? NWG : 64, NB = NWG / BN, R = BN / 2;
  constexpr int np = 2 * NWG;
  constexpr int kSlot = slot_bytes(kNf), kd = kSlot / (8 * np);
  float t[2][R];
  for (int part = 0; part < parts; ++part) {
    const float4* a = part ? a1 : a0;
    const int k = part ? k1n : k0n;
    for (int k0 = 0; k0 < k; k0 += kd) {
      const int kn = k - k0 < kd ? k - k0 : kd;
      mbar_wait(r.full(), r.phase);
      // This warpgroup's first 8-column group in the hi plane of step 0.
      const uint32_t base = r.slots + r.stage * kSlot + c.q * NWG * 32;
      for (int s = 0; s < kn; s += 8) {
        Frag f;
        load_frag(f, a, (k0 + s) / 8, c);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          wg_fence();
          const uint32_t hi = base + s * 8 * np + b * BN * 32;
          const uint32_t lo = hi + 32 * np;
          wgmma<BN>(t[b & 1], f.lo, sdesc(hi), 0);
          wgmma<BN>(t[b & 1], f.hi, sdesc(lo), 1);
          wgmma<BN>(t[b & 1], f.hi, sdesc(hi), 1);
          wg_commit();
          if (b > 0) {
            wg_wait<1>();  // block b - 1's products are done
            fence_regs(t[(b - 1) & 1]);
#pragma unroll
            for (int i = 0; i < R; ++i)
              acc[(b - 1) * R + i] += t[(b - 1) & 1][i];
          }
        }
        wg_wait<0>();
        fence_regs(t[(NB - 1) & 1]);
#pragma unroll
        for (int i = 0; i < R; ++i)
          acc[(NB - 1) * R + i] += t[(NB - 1) & 1][i];
      }
      // Every product reading the slot is done: release it in every CTA.
      if (c.warp == 0 && c.lane < kCluster)
        mbar_arrive_remote(r.empty(), c.lane);
      r.advance();
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
struct Identity {
  __device__ float operator()(float x) const { return x; }
};

// act(acc) of this warpgroup's NWG columns, stored at h in fragment order:
// the next layer's A, k permuted within each 8-column block (columns 2t,
// 2t + 1 are its k = t, t + 4).
template <int NWG, typename Act>
__device__ __forceinline__ void store_frag_act(const float (&acc)[NWG / 2],
                                               float4* h, const Consumer& c,
                                               Act act) {
#pragma unroll
  for (int j = 0; j < NWG / 8; ++j) {
    const int kb = c.q * (NWG / 8) + j;
    h[(kb * 4 + c.warp) * 32 + c.lane] =
        make_float4(act(acc[4 * j]), act(acc[4 * j + 2]),
                    act(acc[4 * j + 1]), act(acc[4 * j + 3]));
  }
}

// act(acc) as f32 rows [kRows][ld] (layer 4, for the blend).
template <int NWG, typename Act>
__device__ __forceinline__ void store_rows_act(const float (&acc)[NWG / 2],
                                               float* h, int ld,
                                               const Consumer& c, Act act) {
  const int g = c.lane >> 2, t = c.lane & 3;
#pragma unroll
  for (int j = 0; j < NWG / 8; ++j) {
    const int col = c.q * NWG + 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * c.warp + g + 8 * half;
      *reinterpret_cast<float2*>(h + row * ld + col) =
          make_float2(act(acc[4 * j + 2 * half]),
                      act(acc[4 * j + 2 * half + 1]));
    }
  }
}

// activate() over the values this thread stored (the other activations'
// path): one rolled loop, so the switch's code is there once and not once
// for each of the NWG / 2 values (which took ptxas minutes a store).
template <int NWG, bool kRowsOut>
__device__ __forceinline__ void activate_own(void* h, int ld,
                                             const Consumer& c) {
  const int g = c.lane >> 2, t = c.lane & 3;
#pragma unroll 1
  for (int e = 0; e < NWG / 2; ++e) {
    const int j = e >> 2, v = e & 3;
    float* p;
    if (kRowsOut)
      p = static_cast<float*>(h) + (16 * c.warp + g + 8 * (v >> 1)) * ld +
          c.q * NWG + 8 * j + 2 * t + (v & 1);
    else
      p = static_cast<float*>(h) +
          (((c.q * (NWG / 8) + j) * 4 + c.warp) * 32 + c.lane) * 4 + v;
    *p = activate(*p, c.act, c.ns);
  }
}

// The store with the activation as a functor, so that the unrolled loop
// runs only its own code; relu and leaky_relu are applied as the values
// are stored, any other activation afterwards by activate_own. Only the
// stores sit under the branch.
template <int NWG, bool kRowsOut>
__device__ __forceinline__ void store(const float (&acc)[NWG / 2], void* h,
                                      int ld, const Consumer& c) {
  auto go = [&](auto act) {
    if constexpr (kRowsOut)
      store_rows_act<NWG>(acc, static_cast<float*>(h), ld, c, act);
    else
      store_frag_act<NWG>(acc, static_cast<float4*>(h), c, act);
  };
  if (c.act == 1) {
    go(LeakyRelu{c.ns});
  } else if (c.act == 0) {
    go(Relu{});
  } else {
    go(Identity{});
    activate_own<NWG, kRowsOut>(h, ld, c);
  }
}

// Where a tile's skip term comes from: rel [D, 31 base] and cb [2^D, 31
// base] (each layer's columns at its offset) and the tile's frac [ppt][D]
// in shared memory.
struct Skip {
  const float* rel;
  const float* cb;
  const float* fr;
  int dim;
};

// acc = frac @ Wx_rel + corner_bias over this warpgroup's NWG columns of
// the columns starting at `off`, in f32: the corner bias loaded straight
// into acc, then each coordinate's product added in order. The loads are
// issued in batches (all coordinates at once for NWG <= 64, predicated to
// D; one coordinate at a time above, for the registers): each batch costs
// one trip to L2, and the layer-0 chunks take 16 of these a tile.
template <int kNf, int NWG>
__device__ __forceinline__ void init_skip(float (&acc)[NWG / 2],
                                          const Skip& k, int off,
                                          const Consumer& c) {
  constexpr int J = NWG / 8, ld = 31 * kNf;
  const int g = c.lane >> 2, t = c.lane & 3, dim = k.dim;
  const int col0 = off + c.q * NWG + 2 * t;
  const float* f[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = 16 * c.warp + g + 8 * half;
    f[half] = k.fr + (row >> dim) * dim;
    const float* cb = k.cb + (size_t)(row & ((1 << dim) - 1)) * ld + col0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(cb + 8 * j));
      acc[4 * j + 2 * half] = v.x;
      acc[4 * j + 2 * half + 1] = v.y;
    }
  }
  auto add = [&](int d, const float2 (&w)[J]) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        acc[4 * j + 2 * half] += f[half][d] * w[j].x;
        acc[4 * j + 2 * half + 1] += f[half][d] * w[j].y;
      }
  };
  if constexpr (NWG <= 64) {
    float2 w[kMaxDim][J];
#pragma unroll
    for (int d = 0; d < kMaxDim; ++d)
#pragma unroll
      for (int j = 0; j < J; ++j)
        w[d][j] = d < dim ? __ldg(reinterpret_cast<const float2*>(
                                k.rel + (size_t)d * ld + col0 + 8 * j))
                          : make_float2(0.f, 0.f);
#pragma unroll
    for (int d = 0; d < kMaxDim; ++d)
      if (d < dim) add(d, w[d]);
  } else {
    for (int d = 0; d < dim; ++d) {
      float2 w[J];
#pragma unroll
      for (int j = 0; j < J; ++j)
        w[j] = __ldg(reinterpret_cast<const float2*>(
            k.rel + (size_t)d * ld + col0 + 8 * j));
      add(d, w);
    }
  }
}

// h_0's chunk j (64 columns) from X into h0c (fragment order, 8 k8
// blocks): each warpgroup its 32 columns.
template <int kNf>
__device__ __forceinline__ void h0_chunk(const float4* x, float4* h0c,
                                         int j, const Plan& s,
                                         const Skip& k, Ring& r,
                                         const Consumer& c) {
  float acc[kN0 / 2];
  init_skip<kNf, kN0>(acc, k, kChunk * j, c);
  mma_seg<kNf, kN0>(acc, x, s.kx, x, 0, 1, r, c);
  store<kN0, false>(acc, h0c, 0, c);
}

// Layer i >= 2 (columns from `off` of rel / cb): X rows, then h_{i-1}
// from H; h_i over H once both warpgroups are done reading it (as rows for
// layer 4).
template <int kNf, int NWG>
__device__ __forceinline__ void layer(float4* h, const float4* x,
                                      const Plan& s, int i, int off,
                                      const Skip& k, Ring& r,
                                      const Consumer& c, uint32_t xempty) {
  float acc[NWG / 2];
  init_skip<kNf, NWG>(acc, k, off, c);
  mma_seg<kNf, NWG>(acc, x, s.kx, h, width(kNf, i - 1), 2, r, c);
  consumer_sync();
  if (i == 4) {
    if (c.ct == 0) mbar_arrive(xempty);  // X is free for the next tile
    store<NWG, true>(acc, h, width(kNf, 4) + 4, c);
  } else {
    store<NWG, false>(acc, h, 0, c);
  }
  consumer_sync();
}

// kNf: the widths' base (Plan::base).
template <int kNf>
__device__ __forceinline__ void consume(const Plan& s, unsigned char* smem,
                                        Ring r, uint32_t xbars, int iters,
                                        long long first, long long stride,
                                        const float* image, const float* w5,
                                        const float* b5, float* out, int n,
                                        int act, float ns) {
  Consumer c;
  c.ct = threadIdx.x - 128;
  c.q = c.ct >> 7;
  c.warp = (c.ct & 127) >> 5;
  c.lane = c.ct & 31;
  c.act = act;
  c.ns = ns;
  // A warpgroup's columns of layers 1-4 (each layer's width / 2) and of
  // a layer-0 chunk.
  constexpr int kN1 = width(kNf, 1) / 2, kN2 = kN1 / 2, kN3 = kN2 / 2,
                kN4 = kN3 / 2;
  float4* h = reinterpret_cast<float4*>(smem + s.o_h);
  float4* h0c = h;  // two 16 KB chunk buffers at H's start, in layer 1
  constexpr int kChunkF4 = kRows * kChunk / 4;
  const float4* x = reinterpret_cast<const float4*>(smem + s.o_x);
  const int dim = s.dim, nk = 1 << dim, ppt = kRows >> dim, nf = s.nf;
  constexpr int nch = width(kNf, 0) / kChunk;
  Skip sk;
  sk.rel = image + s.weights;
  sk.cb = sk.rel + (size_t)dim * 31 * kNf;
  sk.dim = dim;
  for (int it = 0; it < iters; ++it) {
    const long long tile = first + it * stride;
    const float* fr = reinterpret_cast<const float*>(smem + s.o_fr) +
                      (it & 1) * kRows;
    sk.fr = fr;
    mbar_wait(xbars, it & 1);  // X and frac hold this tile

    // Layer 1 with layer 0 fused: K runs over X, then h_0 chunk by chunk.
    // Step j computes chunk j (j < nch) into buffer j & 1, then runs
    // layer 1's products over X (j = 0) or chunk j - 1.
    {
      float acc[kN1 / 2];
      init_skip<kNf, kN1>(acc, sk, skip_offset(kNf, 1), c);
#pragma unroll 1
      for (int j = 0; j <= nch; ++j) {
        if (j < nch)
          h0_chunk<kNf>(x, h0c + (j & 1) * kChunkF4, j, s, sk, r, c);
        mma_seg<kNf, kN1>(acc, j ? h0c + ((j - 1) & 1) * kChunkF4 : x,
                          j ? kChunk : s.kx, x, 0, 1, r, c);
        consumer_sync();
      }
      store<kN1, false>(acc, h, 0, c);
      consumer_sync();
    }
    layer<kNf, kN2>(h, x, s, 2, skip_offset(kNf, 2), sk, r, c, xbars + 8);
    layer<kNf, kN3>(h, x, s, 3, skip_offset(kNf, 3), sk, r, c, xbars + 8);
    layer<kNf, kN4>(h, x, s, 4, skip_offset(kNf, 4), sk, r, c, xbars + 8);

    // h_4 rows are in H: blend the corners into hb after them, then the
    // head, f32 throughout.
    const float* h4 = reinterpret_cast<const float*>(h);
    const int ld4 = width(kNf, 4) + 4;
    float* hb = reinterpret_cast<float*>(h) + kRows * ld4;
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
      hb[i] = v;
    }
    consumer_sync();
    const int warp = c.ct >> 5;
    for (int i = warp; i < ppt * s.out_dim; i += kConsumerThreads / 32) {
      const int pp = i / s.out_dim, o = i - pp * s.out_dim;
      float v = 0.f;
      for (int j = c.lane; j < nf; j += 32)
        v += hb[pp * nf + j] * __ldg(w5 + (size_t)j * s.out_dim + o);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, m);
      const long long gp = tile * ppt + pp;
      if (c.lane == 0 && gp < n)
        out[(size_t)gp * s.out_dim + o] = v + __ldg(b5 + o);
    }
    consumer_sync();  // H is free for the next tile's h_0 chunks
  }
}

__device__ __forceinline__ float nan_f32() {
  return __int_as_float(0x7fc00000);
}

// Tile `tile`'s X [kRows][kx] (fragment order) and frac [ppt][D]: row r is
// corner r & (2^D - 1) of point tile ppt + (r >> D), its latents from row
// cell_flat[p] of the cell-major table (kGather; NaN for a cell outside
// [0, n_cells)) or from the pre-gathered rows, then zeros; all 0 past
// point n. The latents go by 4-byte cp.async (the caller waits). Thread t
// of kXThreads.
template <bool kGather>
__device__ __forceinline__ void stage_x(float* x, float* fr,
                                        const float* __restrict__ src,
                                        const int* __restrict__ cell_flat,
                                        const float* __restrict__ frac,
                                        long long tile, int n, int n_cells,
                                        const Plan& s, int t) {
  const int dim = s.dim, nk = 1 << dim, ppt = kRows >> dim;
  const long long p0 = tile * ppt;
  for (int i = t; i < ppt * dim; i += kXThreads)
    fr[i] = p0 + i / dim < n ? frac[p0 * dim + i] : 0.f;
#pragma unroll 4
  for (int i = t; i < kRows * s.c; i += kXThreads) {
    const int r = i / s.c, ch = i - r * s.c;
    const long long gp = p0 + (r >> dim);
    const int k = r & (nk - 1);
    float* d = x + frag_index(r, ch);
    const float* g = nullptr;
    bool bad = false;
    if (gp < n) {
      if (kGather) {
        const int cell = cell_flat[gp];
        bad = cell < 0 || cell >= n_cells;
        if (!bad) g = src + ((size_t)cell * nk + k) * s.c;
      } else {
        g = src + ((size_t)gp * nk + k) * s.c;
      }
    }
    if (g)
      cp4(d, g + ch);
    else
      *d = bad ? nan_f32() : 0.f;
  }
  const int na = s.kx - s.c;
  for (int i = t; i < kRows * na; i += kXThreads)
    x[frag_index(i / na, s.c + i % na)] = 0.f;
}

// Warps 1-3 of warpgroup 0: each tile's X once the consumers are done with
// the previous tile's (X's empty barrier), and its frac into the buffer
// the blend of the tile before does not read; then X's full barrier.
template <bool kGather>
__device__ __forceinline__ void load_x(const Plan& s, unsigned char* smem,
                                       uint32_t xbars, int iters,
                                       long long first, long long stride,
                                       const float* src, const int* cell_flat,
                                       const float* frac, int n, int n_cells,
                                       int t) {
  for (int it = 0; it < iters; ++it) {
    mbar_wait(xbars + 8, (it & 1) ^ 1);  // X is free
    stage_x<kGather>(reinterpret_cast<float*>(smem + s.o_x),
                     reinterpret_cast<float*>(smem + s.o_fr) +
                         (it & 1) * kRows,
                     src, cell_flat, frac, first + it * stride, n, n_cells,
                     s, t);
    cp_commit_wait_all();
    mbar_arrive(xbars);
  }
}

// kGather: the gather entry (src: the cell-major table), else the
// pre-gathered one (src: feats2 rows); kNf: the widths' base.
template <int kNf, bool kGather>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 1)
    decode_blend_kernel(const float* __restrict__ src,
                        const int* __restrict__ cell_flat,
                        const float* __restrict__ frac,
                        const float* __restrict__ image,
                        const float* __restrict__ w5,
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
  Ring r{smem_u32(smem), smem_u32(smem + s.o_bar), s.stages, 0, 0, s.slot};
  // X's barriers after the ring's: full (the loader warps arrive), then
  // empty (a consumer arrives when the tile's layers are done with X).
  const uint32_t xbars = r.bars + 16 * s.stages;
  const long long first = (long long)cid * kCluster + rank;
  const long long stride = (long long)ncl * kCluster;
  if (threadIdx.x == 0) {
    for (int i = 0; i < s.stages; ++i) {
      mbar_init(r.bars + 8 * i, 1);
      mbar_init(r.bars + 8 * (s.stages + i), kConsumers * kCluster);
    }
    mbar_init(xbars, kXThreads);
    mbar_init(xbars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers are set before any copy or arrive
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      produce(s, reinterpret_cast<const char*>(image), r, iters, rank);
    else if (threadIdx.x >= 32)
      load_x<kGather>(s, smem, xbars, iters, first, stride, src, cell_flat,
                      frac, n, n_cells, threadIdx.x - 32);
    cluster_sync();
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<kNf>(s, smem, r, xbars, iters, first, stride, image, w5, b5, out,
                 n, act, ns);
    cluster_sync();  // no peer still multicasts or arrives into this CTA
  }
}

// Clusters that fit on the card at once at this plan (cached per kernel and
// shared-memory size).
template <int kNf, bool kGather>
int max_clusters(int smem, cudaError_t& e) {
  static int cached_smem = -1, cached = 0;
  e = cudaSuccess;
  if (smem == cached_smem) return cached;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int m = 0;
  e = cudaOccupancyMaxActiveClusters(&m, decode_blend_kernel<kNf, kGather>,
                                     &cfg);
  if (e != cudaSuccess) return 0;
  cached_smem = smem, cached = m;
  return m;
}

template <int kNf, bool kGather>
int launch_at(const Plan& s, const float* src, const int* cell_flat,
              const float* frac, const float* image, const float* w5,
              const float* b5, float* out, int n, int n_cells, int act,
              float ns, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      decode_blend_kernel<kNf, kGather>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, s.total);
  int clusters = e == cudaSuccess ? max_clusters<kNf, kGather>(s.total, e)
                                  : 0;
  if (e == cudaSuccess && clusters < 1) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return (int)e;
  }
  const int ppt = kRows >> s.dim;
  const long long groups =
      (((long long)n + ppt - 1) / ppt + kCluster - 1) / kCluster;
  if (groups < clusters) clusters = (int)groups;
  decode_blend_kernel<kNf, kGather><<<clusters * kCluster, kThreads, s.total,
                                      stream>>>(
      src, cell_flat, frac, image, w5, b5, out, n, n_cells, s, act, ns);
  return (int)cudaGetLastError();
}

template <bool kGather>
int launch(const float* src, const int* cell_flat, const float* frac,
           const float* image, long long image_elems, const float* w5,
           const float* b5, float* out, int n, int n_cells, int c, int dim,
           int nf, int out_dim, int act, float ns, void* stream) {
  if (n <= 0) return 0;
  if (dim < 1 || dim > kMaxDim || nf < 1 || nf > kMaxNf || c < 1)
    return (int)cudaErrorInvalidValue;
  const Plan s = make_plan(c, dim, nf, out_dim);
  if (image_elems != s.image) return (int)cudaErrorInvalidValue;
  auto at = [&](auto f) {
    return f(s, src, cell_flat, frac, image, w5, b5, out, n, n_cells, act,
             ns, (cudaStream_t)stream);
  };
  if (s.base == 16) return at(launch_at<16, kGather>);
  if (s.base == 32) return at(launch_at<32, kGather>);
  return at(launch_at<64, kGather>);
}

}  // namespace

extern "C" {

// table [n_cells, 2^D * C] f32, the weight image of
// ops/fused_query.py::decode_tiles(compute_dtype=float32) (image_elems f32
// values), w5 [nf, out], b5, frac and out f32.
int stpde_decode_blend_gather(const float* table, const int* cell_flat,
                              const float* frac, const float* image,
                              long long image_elems, const float* w5,
                              const float* b5, float* out, int n,
                              int n_cells, int c, int dim, int nf,
                              int out_dim, int act_code,
                              float negative_slope, void* stream) {
  return launch<true>(table, cell_flat, frac, image, image_elems, w5, b5,
                      out, n, n_cells, c, dim, nf, out_dim, act_code,
                      negative_slope, stream);
}

// feats2 [N * 2^D, C] f32 and the same image; the rest as above.
int stpde_decode_blend(const float* feats2, const float* frac,
                       const float* image, long long image_elems,
                       const float* w5, const float* b5, float* out, int n,
                       int c, int dim, int nf, int out_dim, int act_code,
                       float negative_slope, void* stream) {
  return launch<false>(feats2, nullptr, frac, image, image_elems, w5, b5,
                       out, n, 0, c, dim, nf, out_dim, act_code,
                       negative_slope, stream);
}

// Corner rows a CTA decodes at a time (points a tile = this >> D).
int stpde_block_rows(void) { return kRows; }

// The plan at these widths: {shared-memory bytes a CTA, ring slots, kx,
// weight-image floats, CTAs a cluster, corner rows a tile, the widths'
// base, slot bytes}.
void stpde_decode_plan(int c, int dim, int nf, long long* out) {
  const Plan s = make_plan(c, dim, nf, 0);
  const long long v[8] = {s.total, s.stages, s.kx, s.image,
                          kCluster, kRows, s.base, s.slot};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

const char* stpde_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
