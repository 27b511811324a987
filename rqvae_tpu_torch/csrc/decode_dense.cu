// The dense half of a decode transformer layer on Hopper (sm_90a), one
// launch per call, with bf16 weights or int8 weights and one bf16 scale s
// per output channel (a weight row):
//
//   rq_fused_ln_qkv:   qkv = bf16(LN1(x) @ wqkv^T + bqkv)
//                     (int8: bf16(acc * s + bqkv), acc = LN1(x) @ q^T in fp32)
//   rq_fused_proj_mlp: x2  = x + bf16(bf16(y @ wo^T) + bo)  (int8: x + bf16(acc_o * s_o + bo))
//                      t   = bf16(gelu(LN2(x2) @ w1^T + b1))  (int8: bf16(gelu(acc_1 * s_1 + b1)))
//                      out = x2 + bf16(t @ w2^T + b2)  (int8: x2 + bf16(acc_2 * s_2 + b2))
//
// Replace the TPU kernels rqvae_tpu/ops/decode_layer_kernel.py::fused_ln_qkv
// (:109) and ::fused_proj_mlp (:329), and with int8 weights
// ::fused_ln_qkv_q8_ring (:246) / ::fused_ln_qkv_q8 (:161) and
// ::fused_proj_mlp_q8_ring (:451) / ::fused_proj_mlp_q8 (:559) (each pair
// differs only in TPU DMA depth), at their rounding points (one-pass fp32
// LayerNorm cast to bf16; fp32 products; QKV's bias on the fp32 sum before
// its one cast; the bf16 projection cast before + bo and the residual, the
// int8 one scaled and biased in fp32 before its cast; gelu in fp32, then
// the cast; + b2 in fp32, the cast, the residual; an int8 weight's scale on
// the whole fp32 sum of its channel, after the cluster's reduction). The
// weights come in the nn.Linear [out, in] layout. The split-K kernels
// these replace stay in csrc/decode_layer.cu (rq_*_splitk) as the A/B
// baseline.
//
// Bound on the H100: weight bytes. At C 1536 and B 100 a call streams 14 MB
// (wqkv) or 42 MB (wo, w1, w2) for ~200 FLOP per weight element, below the
// card's ~295 FLOP/byte ridge. So the design keeps the weight stream busy
// and every other byte out of device memory:
//
// - wgmma with A and B swapped: a 64-row tile of the weight is the A
//   operand, K-major with the 128-byte swizzle; the activation rows are the
//   N operand (a row tile of MT rows, MT a multiple of 8, one
//   m64nMTk16 instruction per 16-deep step); fp32 accumulators in
//   registers. M above one row tile loops over row tiles (the weights are
//   streamed once per row tile).
// - Weights by TMA (one tensor map per weight tensor, encoded once by the
//   wrapper and cached) into a ring of `stages` (4-16, as many as shared
//   memory holds) 64 x 64 tiles, with full/empty mbarriers. One producer
//   warp issues the copies; two consumer warpgroups: the first runs wgmma,
//   the second applies the epilogue of the tile before while the first
//   runs the next tile's K loop; both stage the activations.
// - Activations by TMA too, from a tensor map per activation address (the
//   wrapper caches them; the allocator hands out few addresses), swizzled
//   into a resident panel of this CTA's K-slice, MT rows x C / cluster.
// - A grid of at most one wave: `clusters` clusters of `cluster` CTAs
//   (1-8; all co-resident for proj_mlp). Cluster c owns the weight row
//   tiles c, c + clusters, ...; CTA rank r of the cluster owns the r-th
//   K-slice of every product (split-K). The partial tiles are reduced in
//   distributed shared memory: each CTA pushes (st.async, counted on the
//   receiver's mbarrier) the rows of its fp32 partial that rank q owns
//   into q's buffer, and q sums them over ranks 0, 1, ... in that order
//   (deterministic), then applies the epilogue in registers. No fp32
//   workspace, no second launch, no cluster-scope fence.
// - LN1 (fused_ln_qkv): each CTA stages its K-slice of x once per row tile
//   and pushes the per-row (sum, sum of squares) of its slice to the
//   cluster; every CTA sums them in rank order for the whole row's
//   one-pass statistics and normalises its slice in place to bf16 (the
//   JAX rounding point). No CTA reads rows beyond its own slice.
// - fused_proj_mlp is one persistent launch of three phases split by two
//   grid-wide barriers (a hand-rolled arrival count + generation flag in
//   device globals, so one launch of it runs at a time on a device; the
//   launch checks co-residency with cudaOccupancyMaxActiveClusters and
//   fails when the grid cannot be co-resident):
//   1. x2 (bf16) to a scratch buffer, and each weight tile's per-row
//      partial (sum, sum of squares) of its 64 bf16 x2 values to an
//      [M, C/64] float2 buffer;
//   2. LN2 statistics from those partials, summed in tile order (x2 is not
//      re-read for them) while x2's K-slice arrives, then normalised in
//      place; t = bf16(gelu(...)) written to a scratch buffer already in
//      the swizzled [H/64, rows, 64] image of a wgmma B tile;
//   3. w2's K of H is split over the cluster and reduced in DSMEM; the
//      t tiles travel with the weight tiles through the ring (one 1-D bulk
//      copy each).
//   The producer runs ahead across both barriers: the weights do not depend
//   on the activations, so the ring fills with w1's (then w2's) first
//   tiles while the consumers wait at a barrier; the t copies of phase 3
//   wait for a gate the consumers open after the second barrier.
//   The JAX kernel's H-chunk loop (acc += t_j @ w2_j, sequential on the TPU)
//   is not carried over: on 132 parallel CTAs each H-slice would leave a
//   [B, C] fp32 partial, ~96 x 600 KB to reduce at B 100, C 1536, more than
//   the weights themselves.
//
// int8 weights halve the bytes that bound the kernel: at C 1536 and B 100 a
// call moves 8.3 MB (ln_qkv) or 22.4 MB (proj_mlp), at least 0.0025 ms or
// 0.0066 ms at 3.35 TB/s. The int8 tile (64 rows x 64 bytes) comes by TMA
// with the 64-byte swizzle, so a ring stage is 4 KB and the ring holds twice
// the tiles of the bf16 one in the same bytes. The products stay bf16 x
// bf16 -> fp32 on wgmma (int8 values are exact in bf16, so the sums equal
// those on the weight dequantized before its scale); the widening runs in
// the wgmma warpgroup's registers: each lane reads its A fragment bytes
// (mma.m16n8k16's A layout, two 32-bit loads a row, no bank conflict under
// the swizzle), widens them with byte permutes and an fp32 magic-number
// subtraction (2.75 instructions an element), and issues wgmma with A from
// registers and B from shared memory; a k16 step's fragment is widened
// while the step before runs (two fragments alternate). No bf16 copy of a
// weight tile exists anywhere, and the epilogue reads the scales beside the
// biases.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                    // weight rows per tile (the wgmma M)
constexpr int kBK = 64;                      // reduction elements per stage: one 128-byte row
constexpr int kRowBytes = kBK * 2;           // one activation row of a B tile
constexpr int kConsumers = 256;              // two warpgroups: the first runs wgmma
constexpr int kThreads = kConsumers + 32;    // + the producer warp
constexpr int kMinStages = 4;
constexpr int kMaxStages = 16;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;

// Offsets in dynamic shared memory from its 1024-aligned base (the Python
// plan, ops/decode_layer_kernel.py::_smem_bytes, mirrors `total`).
struct Layout {
  int stage_bytes;  // one ring stage: a weight tile (+ a t tile for proj_mlp)
  int tile_bytes;   // a weight tile: 64 x 64 elements of wbytes each
  int panel;        // the resident B operand: k_slice / 64 blocks of [mt, 64] swizzled
  int red;          // the partial tiles pushed to this CTA: red_bytes(mt)
  int norm;         // float2 [mt]: (mean, rstd)
  int lnp;          // float2 [k_slice]: the LN (weight, bias) of this CTA's K-slice
  int bars;         // full[stages], empty[stages], xfull, xempty, gate, pbar
  int total;        // bytes to request, with the base's alignment slack
};

// The reduction buffer: every CTA of the cluster pushes the rows of its
// fp32 partial tile that rank r owns (row pairs [r P / s, (r + 1) P / s) of
// the P = mt / 2 pairs) into slot q (its rank) of r's buffer; a row pair is
// 32 x 16 bytes, (o, m), (o, m + 1), (o + 8, m), (o + 8, m + 1) for each of
// the 32 column pairs (o, o + 8), as one lane's wgmma fragment holds them.
// s slots of ceil(P / s) pairs fit in P + kMaxCluster pairs. LN1's row sums
// use it too: slot q of every CTA gets q's float2 [mt].
__host__ __device__ inline int red_bytes(int mt) { return (mt / 2 + kMaxCluster) * 512; }

__host__ __device__ inline Layout layout(int mt, int k_slice, int stages, bool mlp, int wbytes) {
  Layout l;
  l.tile_bytes = kTile * kBK * wbytes;
  l.stage_bytes = l.tile_bytes + (mlp ? mt * kRowBytes : 0);
  l.panel = stages * l.stage_bytes;
  l.red = l.panel + (k_slice / kBK) * mt * kRowBytes;
  l.norm = l.red + red_bytes(mt);
  l.lnp = l.norm + mt * 8;
  l.bars = l.lnp + k_slice * 8;
  l.total = l.bars + (2 * stages + 4) * 8 + 1024;
  return l;
}

struct Params {
  const bf16* x;     // [M, C]: LN1's input (ln_qkv), the residual (proj_mlp)
  const bf16* y;     // [M, C]: the attention output (proj_mlp)
  const bf16* ln_w;  // [C]
  const bf16* ln_b;  // [C]
  const bf16* b0;    // bqkv [N] (ln_qkv), bo [C] (proj_mlp)
  const bf16* b1;    // [H]
  const bf16* b2;    // [C]
  const bf16* s0;    // the int8 weights' scales: wqkv's [N] (ln_qkv), wo's [C] (proj_mlp)
  const bf16* s1;    // w1's [H]
  const bf16* s2;    // w2's [C]
  bf16* out;         // [M, N] (ln_qkv), [M, C] (proj_mlp)
  bf16* x2;          // [M, C] scratch
  bf16* t;           // [H / 64, row_tiles * mt, 64] scratch, swizzled B tiles
  float2* stats;     // [M, C / 64] scratch
  int M, C, N;       // N: 3C (ln_qkv), H (proj_mlp)
  int row_tiles, stages, gelu_sigmoid;
  float eps;
};

// ---- shared memory, barriers, copies -------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// the same shared memory offset in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait for the phase of parity `parity` to complete (cta-scope acquire)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  while (!mbar_try(bar, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// arrive on a barrier of any CTA of the cluster (a mapa address)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t cluster_addr) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(cluster_addr) : "memory");
}

// 16 / 8 bytes into the shared memory of a CTA of the cluster, counted on
// that CTA's barrier (both mapa addresses) as transaction bytes
__device__ __forceinline__ void st_async4(uint32_t addr, float a, float b, float c, float d, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
               ::"r"(addr), "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void st_async2(uint32_t addr, float a, float b, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];"
               ::"r"(addr), "f"(a), "f"(b), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

// a 64 x 64 tile of a weight [rows, K] (box of the tensor map) at (k0, row0)
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int k0, int row0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes from global memory
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
               : "memory");
}

// the consumer warpgroup's own barrier (the producer warp is not in it)
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;" ::: "memory"); }

// generic-proxy writes made visible to the async proxy (wgmma, bulk copies)
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }
__device__ __forceinline__ void fence_async_global() { asm volatile("fence.proxy.async.global;" ::: "memory"); }

// ---- wgmma ----------------------------------------------------------------

// shared memory descriptor of a K-major operand with the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms of 1024 bytes (stride byte offset 1024)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_acc(float* acc) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> fp32, A and B from shared memory
// (descriptors), not transposed (both K-major), D scaled by 1 (accumulate)

// D[64 x N] += A[64 x 16] * B[16 x N] for the row tiles the kernels are built
// for (RQ_TILES_*), one instruction per k16 step
template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db);


template <>
__device__ __forceinline__ void wgmma<8>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<16>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<24>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<40>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, %20, %21, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<48>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<56>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27"
      "}, %28, %29, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<72>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, %36, %37, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<80>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<88>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %46, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43"
      "}, %44, %45, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<96>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<104>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51"
      "}, %52, %53, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<112>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<120>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %62, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59"
      "}, %60, %61, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<160>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<192>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<224>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, %112, %113, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<256>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> fp32, A from registers (the int8
// weight tile widened to bf16: four 32-bit registers a lane, the
// mma.m16n8k16 A layout, warp w holding rows 16 w .. 16 w + 15), B from
// shared memory as above, D scaled by 1 (accumulate); N of 8, 16, ..., 256
template <int N>
__device__ __forceinline__ void wgmma_rs_shape(float* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs_shape<8>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_shape<16>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_shape<32>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_shape<64>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_shape<128>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_shape<256>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x N] += A[64 x 16] * B[16 x N] with A from registers, for every row
// tile the kernels are built for: N as a sum of the shapes above, widest
// first (104 = 64 + 32 + 8), each on its own columns of D and rows of B
// (N-row c0 of a B tile starts c0 * 128 bytes on)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  constexpr int W = N >= 256 ? 256 : N >= 128 ? 128 : N >= 64 ? 64 : N >= 32 ? 32 : N >= 16 ? 16 : 8;
  wgmma_rs_shape<W>(d, a, db);
  if constexpr (N > W) wgmma_rs<N - W>(d + W / 2, a, db + (uint64_t)(W * kRowBytes >> 4));
}

// ---- small helpers --------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// four int8 (bytes of v) -> two bf16 pairs, exactly: each byte, its sign bit
// flipped (x + 128), goes under the exponent of 2^23 and 2^23 + 128 is taken
// off in fp32; the upper halves of the exact floats are their bf16 values.
// lo = (byte 0, byte 1), hi = (byte 2, byte 3), the lower byte in the low half
__device__ __forceinline__ void widen4(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// The A fragment of k16 step kk of the int8 weight tile at `tile` (64 rows
// x 64 bytes, the TMA 64-byte swizzle: 16-byte chunk c of row r at r * 64 +
// ((c ^ (r / 2 % 4)) << 4)), widened to bf16, for the wgmma warpgroup's
// lane l of warp w: rows r = 16 w + l / 4 and r + 8, K pairs (2q, 2q + 1)
// and (2q + 8, 2q + 9) of the step, q = l % 4, in a = {(r, lo), (r + 8, lo),
// (r, hi), (r + 8, hi)}. A row's two words (K 4 (q / 2) .. + 3 and 8 + 4 (q /
// 2) .. + 3) give its four bytes by one byte permute; across the warp the
// 32-bit loads fall on 32 distinct banks.
__device__ __forceinline__ void load_a_q8(uint32_t* a, uint32_t tile, int kk) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int q = lane & 3;
  const uint32_t word = tile + r * 64 + ((kk ^ ((r >> 1) & 3)) << 4) + 4 * (q >> 1);
  const uint32_t sel = (q & 1) ? 0x7632u : 0x5410u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows r and r + 8: the same swizzle, 512 bytes on
    const uint32_t v = __byte_perm(lds_u32(word + h * 512), lds_u32(word + h * 512 + 8), sel);
    widen4(v, a[h], a[2 + h]);
  }
}

// byte offset of 16-byte chunk c (of 8) of row m in a swizzled [rows, 64] B tile
__device__ __forceinline__ int swz(int m, int c) { return m * kRowBytes + ((c ^ (m & 7)) << 4); }

// ---- the grid-wide barrier of fused_proj_mlp ------------------------------

__device__ unsigned int g_grid_count = 0;
__device__ unsigned int g_grid_gen = 0;

// consumer threads of every CTA; the grid is co-resident (checked at launch)
__device__ __forceinline__ void grid_sync() {
  consumer_sync();
  if (threadIdx.x == 0) {
    const unsigned int n = gridDim.x;
    const unsigned int gen = *reinterpret_cast<volatile unsigned int*>(&g_grid_gen);
    __threadfence();
    if (atomicAdd(&g_grid_count, 1u) == n - 1) {
      atomicExch(&g_grid_count, 0u);
      __threadfence();
      atomicAdd(&g_grid_gen, 1u);
    } else {
      while (*reinterpret_cast<volatile unsigned int*>(&g_grid_gen) == gen) __nanosleep(32);
    }
    __threadfence();
  }
  consumer_sync();
}

// ---- phase stamps ------------------------------------------------------------

// globaltimer stamps of CTA 0's consumer thread 0 in the last launch:
// ln_qkv: start, LN1 staged, end; proj_mlp: start, phase 1 done, barrier 1
// passed, phase 2 done, barrier 2 passed, end (rq_dense_phase_ns)
__device__ unsigned long long g_stamps[6];

__device__ __forceinline__ void stamp(int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[i] = t;
  }
}

// ---- the cluster exchange -------------------------------------------------

// One round: every CTA pushes data into the reduction buffers of the CTAs of
// the cluster with st.async, which counts the bytes on the receiver's xfull
// barrier (the receiver expects them); then reads its own buffer. xempty
// completes when every CTA has read its buffer, so the next round may push.
// No fence: the bytes' arrival completes xfull, and a CTA reads before it
// signals xempty (the values are used before the signal is issued).
struct Exchange {
  uint32_t full, empty;
  int size, round;

  // the previous round read everywhere; expect this round's `bytes`
  __device__ __forceinline__ void begin(uint32_t bytes) {
    if (threadIdx.x == 0) {
      if (round > 0) mbar_wait(empty, (round - 1) & 1);
      mbar_expect_tx(full, bytes);
    }
    consumer_sync();
  }
  // every push into this CTA's buffer has landed
  __device__ __forceinline__ void wait() { mbar_wait(full, round & 1); }
  __device__ __forceinline__ void end() {
    consumer_sync();
    if (threadIdx.x == 0)
      for (int q = 0; q < size; ++q) mbar_arrive_remote(mapa(empty, q));
    ++round;
  }
  __device__ __forceinline__ void finish() {
    if (threadIdx.x == 0 && round > 0) mbar_wait(empty, (round - 1) & 1);
    consumer_sync();
  }
};

// ---- the kernel ------------------------------------------------------------

// The products of one launch, in the order the producer and the consumers
// walk them: fused_ln_qkv has one (wqkv), fused_proj_mlp three (wo, w1,
// w2). For each: row tiles rt, then the cluster's weight tiles j = cid,
// cid + clusters, ..., then the CTA's K-chunks.
struct Product {
  int tiles;     // weight rows / 64
  int k;         // reduction length
  bool streamed; // B tiles through the ring (w2's t) instead of the panel
};

__device__ __forceinline__ Product product(bool mlp, int i, const Params& p) {
  if (!mlp) return {p.N / kTile, p.C, false};
  if (i == 0) return {p.C / kTile, p.C, false};
  if (i == 1) return {p.N / kTile, p.C, false};
  return {p.C / kTile, p.N, true};
}

struct Ring {
  uint32_t base, full, empty;
  int stages, stage_bytes, tile_bytes;
};

// The producer: lane 0 of the last warp issues every weight tile (and, in
// phase 3, t tile) of this CTA in the consumers' order, `stages` ahead.
template <int MT, bool kMlp>
__device__ __forceinline__ void producer(const CUtensorMap* map0, const CUtensorMap* map1, const CUtensorMap* map2,
                                         const Params& p, const Ring& ring, uint32_t gate,
                                         int s, int rank, int cid, int G) {
  const int m_pad = p.row_tiles * MT;
  int it = 0;
  int first = -1;       // the first streamed unit
  bool open = false;    // the gate: the consumers passed the second grid barrier
  int n_def = 0;        // streamed units whose t copy waits for the gate
  int def_stage[kMaxStages];
  const bf16* def_src[kMaxStages];
  const auto open_gate = [&]() {
    mbar_wait(gate, 0);
    fence_async_global();
    for (int d = 0; d < n_def; ++d)
      bulk_copy(ring.base + def_stage[d] * ring.stage_bytes + ring.tile_bytes, def_src[d], MT * kRowBytes,
                ring.full + def_stage[d] * 8);
    n_def = 0;
    open = true;
  };
  for (int pi = 0; pi < (kMlp ? 3 : 1); ++pi) {
    const Product pr = product(kMlp, pi, p);
    const CUtensorMap* map = pi == 0 ? map0 : pi == 1 ? map1 : map2;
    const int ks = pr.k / s;
    const int k_lo = rank * ks;
    const int chunks = ks / kBK;
    const uint32_t bytes = ring.tile_bytes + (pr.streamed ? MT * kRowBytes : 0);
    for (int rt = 0; rt < p.row_tiles; ++rt) {
      for (int j = cid; j < pr.tiles; j += G) {
        for (int kc = 0; kc < chunks; ++kc, ++it) {
          const int stage = it % ring.stages;
          if (pr.streamed) {
            if (first < 0) first = it;
            // unit it - stages, whose slot this one takes, is a deferred one
            if (!open && it >= first + ring.stages) open_gate();
          }
          mbar_wait(ring.empty + stage * 8, ((it / ring.stages) & 1) ^ 1);
          const uint32_t full = ring.full + stage * 8;
          const uint32_t dst = ring.base + stage * ring.stage_bytes;
          mbar_expect_tx(full, bytes);
          tma_tile(dst, map, k_lo + kc * kBK, j * kTile, full);
          if (pr.streamed) {
            const bf16* src = p.t + ((size_t)(k_lo / kBK + kc) * m_pad + (size_t)rt * MT) * kBK;
            if (open) {
              bulk_copy(dst + ring.tile_bytes, src, MT * kRowBytes, full);
            } else {
              def_stage[n_def] = stage;
              def_src[n_def] = src;
              ++n_def;
            }
          }
        }
      }
    }
  }
  if (kMlp && !open && n_def > 0) open_gate();
}

// One weight tile's K loop over this CTA's chunks, by the first warpgroup:
// acc = its partial product. B comes from the panel (block kc at panel + kc
// * MT * 128) or, when streamed, from the stage itself (after the weight
// tile). A bf16 weight tile is wgmma's A operand in shared memory, a chunk
// one commit group; an int8 one is widened into registers a k16 step at a
// time (load_a_q8), a step one commit group, the next step's fragment
// widened while the step runs.
template <int MT, bool kQ8>
__device__ __forceinline__ void k_loop(float* acc, int chunks, const Ring& ring, uint32_t panel, bool streamed,
                                       int& it) {
#pragma unroll
  for (int i = 0; i < MT / 2; ++i) acc[i] = 0.f;
  const int lane = threadIdx.x & 31;
  int prev = -1;
  for (int kc = 0; kc < chunks; ++kc, ++it) {
    const int stage = it % ring.stages;
    mbar_wait(ring.full + stage * 8, (it / ring.stages) & 1);
    const uint32_t a = ring.base + stage * ring.stage_bytes;
    const uint32_t b = streamed ? a + ring.tile_bytes : panel + kc * MT * kRowBytes;
    const uint64_t db = sw128_desc(b);
    if constexpr (kQ8) {
      uint32_t frag[2][4];
      load_a_q8(frag[0], a, 0);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        fence_acc<MT / 2>(acc);
        wgmma_fence();
        wgmma_rs<MT>(acc, frag[kk & 1], db + 2 * kk);  // +32 bytes per k16
        wgmma_commit();
        wgmma_wait<1>();  // the step before is done: its fragment may be rewritten
        if (kk == 0 && prev >= 0 && lane == 0) mbar_arrive(ring.empty + prev * 8);  // and the chunk before
        if (kk + 1 < kBK / 16) load_a_q8(frag[(kk + 1) & 1], a, kk + 1);
      }
    } else {
      const uint64_t da = sw128_desc(a);
      fence_acc<MT / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma<MT>(acc, da + 2 * kk, db + 2 * kk);  // +32 bytes per k16
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(ring.empty + prev * 8);
    }
    prev = stage;
  }
  wgmma_wait<0>();
  fence_acc<MT / 2>(acc);
  if (prev >= 0 && lane == 0) mbar_arrive(ring.empty + prev * 8);
}

// Rank r owns row pairs [pair_lo(r), pair_lo(r + 1)) of a tile's P = MT / 2
// (s, the cluster size, is a power of two)
__device__ __forceinline__ int pair_lo(int r, int P, int s) { return (r * P) >> (__ffs(s) - 1); }

// Push the first warpgroup's partial tile (acc, the wgmma layout) to the
// owners of its rows: lane (w, l) of fragment J holds row pair 4 J + l % 4,
// column pair 8 w + l / 4, as one 16-byte cell of the owner's slot `rank`.
template <int MT>
__device__ __forceinline__ void push_partial(const float* acc, uint32_t red_u32, uint32_t full, int s, int rank) {
  constexpr int P = MT / 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = (P + s - 1) / s;
  const int cp = 8 * warp + (lane >> 2);
#pragma unroll
  for (int J = 0; J < MT / 8; ++J) {
    const int mp = 4 * J + (lane & 3);
    const int r = ((mp + 1) * s - 1) / P;  // the owner: pair_lo(r) <= mp < pair_lo(r + 1)
    const uint32_t off = (uint32_t)((rank * slot + mp - pair_lo(r, P, s)) * 32 + cp) * 16;
    st_async4(mapa(red_u32 + off, r), acc[4 * J], acc[4 * J + 1], acc[4 * J + 2], acc[4 * J + 3], mapa(full, r));
  }
}

// bytes a CTA receives in a tile's round: s slots of its row pairs
__device__ __forceinline__ uint32_t partial_bytes(int MT, int s, int rank) {
  const int P = MT / 2;
  return (uint32_t)(s * (pair_lo(rank + 1, P, s) - pair_lo(rank, P, s)) * 512);
}

enum Epilogue { kQkv, kProj, kGelu, kOut };

__device__ __forceinline__ float bf16_at(const bf16* p) { return __bfloat162float(*p); }

// data another CTA of this launch wrote before a grid barrier: through L2
__device__ __forceinline__ float bf16_at_cg(const bf16* p) {
  const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(u));
}

__device__ __forceinline__ void store_bf16(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// After the round: this CTA sums its row pairs over the s slots in rank
// order and applies the epilogue. Of the consumer warps from warp0 on
// (nwarps of them), warp w takes pairs lo + w, lo + w + nwarps, ...; lane l
// the column pair (o, o + 8), o = 16 (l / 8) + l % 8, of both rows. With
// int8 weights (kQ8) each channel's sum is scaled before the bias.
template <int MT, Epilogue E, bool kQ8>
__device__ __forceinline__ void epilogue(const Params& p, const float4* red, int s, int rank, int m0, int j,
                                         int warp0, int nwarps) {
  constexpr int P = MT / 2;
  const int warp = (threadIdx.x >> 5) - warp0;
  const int lane = threadIdx.x & 31;
  const int lo = pair_lo(rank, P, s);
  const int hi = pair_lo(rank + 1, P, s);
  const int slot = (P + s - 1) / s;
  const int o = 16 * (lane >> 3) + (lane & 7);
  const int n = j * kTile + o;  // columns n and n + 8
  const int m_pad = p.row_tiles * MT;
  const bf16* bias = (E == kQkv || E == kProj) ? p.b0 : E == kGelu ? p.b1 : p.b2;
  const float b0 = bf16_at(bias + n), b8 = bf16_at(bias + n + 8);
  float sc0 = 1.f, sc8 = 1.f;
  if (kQ8) {
    const bf16* scale = (E == kQkv || E == kProj) ? p.s0 : E == kGelu ? p.s1 : p.s2;
    sc0 = bf16_at(scale + n);
    sc8 = bf16_at(scale + n + 8);
  }
  for (int mp = lo + warp; mp < hi; mp += nwarps) {
    float4 v = red[(mp - lo) * 32 + lane];
    for (int q = 1; q < s; ++q) {
      const float4 d = red[(q * slot + mp - lo) * 32 + lane];
      v.x += d.x;
      v.y += d.y;
      v.z += d.z;
      v.w += d.w;
    }
    // (row, column): v.x (m, n), v.y (m + 1, n), v.z (m, n + 8), v.w (m + 1, n + 8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + 2 * mp + h;
      const bool ok = E == kGelu ? true : gm < p.M;
      const float a = h ? v.y : v.x;
      const float c = h ? v.w : v.z;
      // the fp32 sum plus the bias (int8: times the scale, then plus the bias)
      const float y0 = kQ8 ? __fadd_rn(__fmul_rn(a, sc0), b0) : a + b0;
      const float y8 = kQ8 ? __fadd_rn(__fmul_rn(c, sc8), b8) : c + b8;
      if (E == kQkv) {
        if (ok) {
          store_bf16(p.out + (size_t)gm * p.N + n, y0);
          store_bf16(p.out + (size_t)gm * p.N + n + 8, y8);
        }
      } else if (E == kProj) {
        float x0 = 0.f, x8 = 0.f;
        if (ok) {  // bf16 weights: the product is cast before + bo
          const bf16* xr = p.x + (size_t)gm * p.C + n;
          x0 = round_bf16(bf16_at(xr) + round_bf16(kQ8 ? y0 : round_bf16(a) + b0));
          x8 = round_bf16(bf16_at(xr + 8) + round_bf16(kQ8 ? y8 : round_bf16(c) + b8));
          store_bf16(p.x2 + (size_t)gm * p.C + n, x0);
          store_bf16(p.x2 + (size_t)gm * p.C + n + 8, x8);
        }
        const float s1 = warp_sum(x0 + x8);  // the tile's 64 columns of row gm (warp-uniform row)
        const float s2 = warp_sum(x0 * x0 + x8 * x8);
        if (ok && lane == 0) p.stats[(size_t)gm * (p.C / kTile) + j] = make_float2(s1, s2);
      } else if (E == kGelu) {
        float t0 = y0, t8 = y8;
        if (p.gelu_sigmoid) {
          t0 = t0 / (1.f + expf(-1.702f * t0));
          t8 = t8 / (1.f + expf(-1.702f * t8));
        } else {
          t0 = 0.5f * t0 * (1.f + erff(t0 * 0.70710678118654752f));
          t8 = 0.5f * t8 * (1.f + erff(t8 * 0.70710678118654752f));
        }
        // t tile j (w2's K-block j), row gm, swizzled as a wgmma B tile
        bf16* tile = p.t + ((size_t)j * m_pad + gm) * kBK;
        store_bf16(tile + ((((o >> 3) ^ (gm & 7)) << 3) | (o & 7)), t0);
        store_bf16(tile + (((((o + 8) >> 3) ^ (gm & 7)) << 3) | (o & 7)), t8);
      } else if (ok) {
        const bf16* x2r = p.x2 + (size_t)gm * p.C + n;
        store_bf16(p.out + (size_t)gm * p.C + n, bf16_at_cg(x2r) + round_bf16(y0));
        store_bf16(p.out + (size_t)gm * p.C + n + 8, bf16_at_cg(x2r + 8) + round_bf16(y8));
      }
    }
  }
}

// Rows [m0, m0 + MT) of an activation [M, C] (its tensor map: boxes of MT
// rows x 64 columns, the 128-byte swizzle; rows past M read as zeros),
// columns [k_lo, k_lo + ks), into the panel by TMA, on `bar`: thread 0
// issues, every thread waits for phase `parity`.
template <int MT>
__device__ __forceinline__ void load_panel(uint32_t panel, const CUtensorMap* map, int k_lo, int ks, int m0,
                                           uint32_t bar, int parity) {
  if (threadIdx.x == 0) {
    fence_async_global();  // the activation may come from other CTAs' generic stores (x2)
    mbar_expect_tx(bar, (uint32_t)(ks / kBK * MT * kRowBytes));
    for (int kb = 0; kb < ks / kBK; ++kb) tma_tile(panel + kb * MT * kRowBytes, map, k_lo + kb * kBK, m0, bar);
  }
  mbar_wait(bar, parity);
}

// each panel row's (sum, sum of squares) over the slice, by kSplit threads
// per row (eight partial sums each, one per position in a 16-byte chunk,
// added pairwise, then the threads' in lane order), pushed into slot `rank`
// of every CTA's reduction buffer as float2 [MT]
template <int MT>
__device__ __forceinline__ void push_row_sums(const uint8_t* panel, int ks, uint32_t red_u32, uint32_t full, int s,
                                              int rank) {
  constexpr int kSplit = MT <= kConsumers / 2 ? 2 : 1;
  const int m = threadIdx.x / kSplit;
  const int part = threadIdx.x % kSplit;
  const int chunks = ks / 8;
  float s1[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.f;
  if (m < MT) {
    for (int ch = part * chunks / kSplit; ch < (part + 1) * chunks / kSplit; ++ch) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(panel + (size_t)(ch >> 3) * MT * kRowBytes + swz(m, ch & 7)), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s1[e] += f[e];
        s2[e] = fmaf(f[e], f[e], s2[e]);
      }
    }
  }
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int e = 0; e < w; ++e) {
      s1[e] += s1[e + w];
      s2[e] += s2[e + w];
    }
  if (kSplit == 2) {  // the pair's sum, the same on both lanes (a + b == b + a)
    s1[0] += __shfl_xor_sync(0xffffffffu, s1[0], 1);
    s2[0] += __shfl_xor_sync(0xffffffffu, s2[0], 1);
  }
  if (m < MT && part == 0)
    for (int q = 0; q < s; ++q)
      st_async2(mapa(red_u32 + (uint32_t)(rank * MT + m) * 8, q), s1[0], s2[0], mapa(full, q));
}

// LayerNorm in place on the first `rows` rows of the panel: (v - mean) *
// rstd * w + b in fp32, cast to bf16; norm[m] = (mean, rstd), lnp[k] = (w, b)
template <int MT>
__device__ __forceinline__ void normalise_panel(uint8_t* panel, int ks, int rows, const float2* norm,
                                                const float2* lnp) {
  // thread t keeps chunk column t % cols (its eight (w, b) in registers; then
  // + cols, ...) and walks the rows t / cols, + per, ...; two rows in flight
  const int chunks = ks / 8;
  const int cols = min(chunks, kConsumers);
  const int per = kConsumers / cols;  // rows a pass covers
  for (int ch = threadIdx.x % cols; threadIdx.x < per * cols && ch < chunks; ch += cols) {
    float w[8], b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float2 wb = lnp[ch * 8 + e];
      w[e] = wb.x;
      b[e] = wb.y;
    }
    uint8_t* col = panel + (size_t)(ch >> 3) * MT * kRowBytes;
    for (int m = threadIdx.x / cols; m < rows; m += 2 * per) {
      const int m2 = m + per;
      uint4* c1 = reinterpret_cast<uint4*>(col + swz(m, ch & 7));
      uint4* c2 = reinterpret_cast<uint4*>(col + swz(m2 < rows ? m2 : m, ch & 7));
      const uint4 u1 = *c1, u2 = *c2;
      const float2 n1 = norm[m], n2 = norm[m2 < rows ? m2 : m];
      float f1[8], f2[8];
      unpack8(u1, f1);
      unpack8(u2, f2);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        f1[e] = (f1[e] - n1.x) * n1.y * w[e] + b[e];
        f2[e] = (f2[e] - n2.x) * n2.y * w[e] + b[e];
      }
      *c1 = pack8(f1);
      if (m2 < rows) *c2 = pack8(f2);
    }
  }
  fence_async_shared();
  consumer_sync();
}

__device__ __forceinline__ float2 ln_stats(float s1, float s2, int C, float eps) {
  const float mean = s1 / (float)C;
  const float var = fmaxf(s2 / (float)C - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// LN2's statistics of rows [m0, m0 + rows) from phase 1's per-tile partial
// sums stats [M][C / 64], one thread per row, every load issued before the
// sums, which run in tile order
template <int MT>
__device__ __forceinline__ void ln2_stats(const Params& p, int m0, int rows, float2* norm) {
  constexpr int kBatch = 8;  // float4 loads (two tiles each) in flight per thread
  const int T = p.C / kTile;
  for (int m = threadIdx.x; m < MT; m += kConsumers) {
    float s1 = 0.f, s2 = 0.f;
    if (m < rows) {
      const float4* src = reinterpret_cast<const float4*>(p.stats + (size_t)(m0 + m) * T);
      for (int b = 0; b < T / 2; b += kBatch) {
        float4 d[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (b + i < T / 2) d[i] = __ldcg(src + b + i);
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (b + i < T / 2) {
            s1 += d[i].x;
            s2 += d[i].y;
            s1 += d[i].z;
            s2 += d[i].w;
          }
      }
    }
    norm[m] = ln_stats(s1, s2, p.C, p.eps);
  }
  consumer_sync();
}

// The weight tiles j = cid, cid + G, ... of one product for the row tile at
// m0. The first warpgroup runs tile j's K loop while the second applies the
// epilogue of tile j - G (its round's pushes having landed meanwhile); then
// the first pushes tile j's partial. The last tile's epilogue runs on all
// consumer warps.
template <int MT, Epilogue E, bool kQ8>
__device__ __forceinline__ void run_tiles(const Params& p, float* acc, int tiles, int cid, int G, int chunks,
                                          const Ring& ring, uint32_t panel, bool streamed, int& it, Exchange& xc,
                                          const float4* red, uint32_t red_u32, int s, int rank, int m0) {
  const bool mma = threadIdx.x < 128;
  int pending = -1;
  for (int j = cid; j < tiles; j += G) {
    if (mma) {
      k_loop<MT, kQ8>(acc, chunks, ring, panel, streamed, it);
    } else if (pending >= 0) {
      xc.wait();
      epilogue<MT, E, kQ8>(p, red, s, rank, m0, pending, 4, 4);
    }
    if (pending >= 0) xc.end();  // the consumer barrier first
    xc.begin(partial_bytes(MT, s, rank));
    if (mma) push_partial<MT>(acc, red_u32, xc.full, s, rank);
    pending = j;
  }
  if (pending >= 0) {
    xc.wait();
    epilogue<MT, E, kQ8>(p, red, s, rank, m0, pending, 0, kConsumers / 32);
    xc.end();
  }
}

// W: the weights' element type, bf16 or int8_t (scaled per output channel)
template <int MT, bool kMlp, typename W>
__global__ void __launch_bounds__(kThreads, 1)
    dense_kernel(const __grid_constant__ CUtensorMap map0, const __grid_constant__ CUtensorMap map1,
                 const __grid_constant__ CUtensorMap map2, const __grid_constant__ CUtensorMap amap0,
                 const __grid_constant__ CUtensorMap amap1, const Params p) {
  constexpr bool kQ8 = sizeof(W) == 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int s = (int)(gridDim.x / cluster_count());
  const int rank = (int)cluster_rank();
  const int cid = (int)cluster_id();
  const int G = (int)cluster_count();
  const int k_slice = p.C / s;  // this CTA's K of every product over C
  const Layout L = layout(MT, k_slice, p.stages, kMlp, (int)sizeof(W));
  uint8_t* panel = smem + L.panel;
  float* red = reinterpret_cast<float*>(smem + L.red);
  float2* norm = reinterpret_cast<float2*>(smem + L.norm);
  float2* lnp = reinterpret_cast<float2*>(smem + L.lnp);
  const uint32_t bars = smem_u32(smem + L.bars);
  const Ring ring{smem_u32(smem), bars, bars + p.stages * 8, p.stages, L.stage_bytes, L.tile_bytes};
  const uint32_t xfull = bars + 2 * p.stages * 8;
  const uint32_t xempty = xfull + 8;
  const uint32_t gate = xempty + 8;

  const uint32_t pbar = gate + 8;  // the panel's TMA copies

  if (threadIdx.x == 0) {  // full: 1 arrival; empty: the first warpgroup's warps; xempty: the cluster's CTAs
    for (int i = 0; i < 2 * p.stages + 4; ++i)
      mbar_init(bars + i * 8, i < p.stages ? 1 : i < 2 * p.stages ? 4 : i == 2 * p.stages + 1 ? s : 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_sync_all();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      // the tensor maps stay in parameter space: TMA reads them there
      producer<MT, kMlp>(&map0, &map1, &map2, p, ring, gate, s, rank, cid, G);
    }
    __syncwarp();
  } else {
    stamp(0);
    Exchange xc{xfull, xempty, s, 0};
    const uint32_t red_u32 = smem_u32(red);
    const float4* red4 = reinterpret_cast<const float4*>(red);
    const uint32_t panel_u32 = smem_u32(panel);
    const int k_lo = rank * k_slice;
    for (int k = threadIdx.x; k < k_slice; k += kConsumers)  // LN1 / LN2 (weight, bias) of the slice
      lnp[k] = make_float2(__bfloat162float(p.ln_w[k_lo + k]), __bfloat162float(p.ln_b[k_lo + k]));
    int loads = 0;  // pbar's phases so far
    float acc[MT / 2];
    int it = 0;
    if (!kMlp) {
      const Product pr = product(false, 0, p);
      for (int rt = 0; rt < p.row_tiles; ++rt) {
        const int m0 = rt * MT;
        const int rows = min(MT, p.M - m0);
        // LN1: stage the raw slice, exchange its partial row sums
        load_panel<MT>(panel_u32, &amap0, k_lo, k_slice, m0, pbar, loads++ & 1);
        consumer_sync();  // lnp
        xc.begin(s * MT * 8);
        push_row_sums<MT>(panel, k_slice, red_u32, xfull, s, rank);
        xc.wait();
        for (int m = threadIdx.x; m < MT; m += kConsumers) {
          const float2* sums = reinterpret_cast<const float2*>(red);
          float s1 = 0.f, s2 = 0.f;
          for (int q = 0; q < s; ++q) {
            s1 += sums[q * MT + m].x;
            s2 += sums[q * MT + m].y;
          }
          norm[m] = ln_stats(s1, s2, p.C, p.eps);
        }
        xc.end();  // includes the consumer barrier: norm is complete
        normalise_panel<MT>(panel, k_slice, rows, norm, lnp);
        if (rt == 0) stamp(1);
        run_tiles<MT, kQkv, kQ8>(p, acc, pr.tiles, cid, G, k_slice / kBK, ring, panel_u32, false, it, xc, red4, red_u32,
                            s, rank, m0);
      }
    } else {
      // phase 1: x2 = x + bf16(bf16(y wo^T) + bo) (int8: x + bf16(acc_o s_o + bo)), with LN2's partial sums
      const Product p0 = product(true, 0, p);
      for (int rt = 0; rt < p.row_tiles && cid < p0.tiles; ++rt) {
        const int m0 = rt * MT;
        load_panel<MT>(panel_u32, &amap0, k_lo, k_slice, m0, pbar, loads++ & 1);
        run_tiles<MT, kProj, kQ8>(p, acc, p0.tiles, cid, G, k_slice / kBK, ring, panel_u32, false, it, xc, red4,
                             red_u32, s, rank, m0);
      }
      stamp(1);
      grid_sync();
      stamp(2);
      // phase 2: t = bf16(gelu(LN2(x2) w1^T + b1)) into the swizzled t tiles
      const Product p1 = product(true, 1, p);
      for (int rt = 0; rt < p.row_tiles && cid < p1.tiles; ++rt) {
        const int m0 = rt * MT;
        const int rows = min(MT, p.M - m0);
        if (threadIdx.x == 0) {  // x2's copies fly while the statistics load
          fence_async_global();
          mbar_expect_tx(pbar, (uint32_t)(k_slice / kBK * MT * kRowBytes));
          for (int kb = 0; kb < k_slice / kBK; ++kb)
            tma_tile(panel_u32 + kb * MT * kRowBytes, &amap1, k_lo + kb * kBK, m0, pbar);
        }
        ln2_stats<MT>(p, m0, rows, norm);
        mbar_wait(pbar, loads++ & 1);
        normalise_panel<MT>(panel, k_slice, rows, norm, lnp);
        run_tiles<MT, kGelu, kQ8>(p, acc, p1.tiles, cid, G, k_slice / kBK, ring, panel_u32, false, it, xc, red4,
                             red_u32, s, rank, m0);
      }
      fence_async_global();  // t is read by bulk copies after the barrier
      stamp(3);
      grid_sync();
      if (threadIdx.x == 0) mbar_arrive(gate);
      stamp(4);
      // phase 3: out = x2 + bf16(t w2^T + b2), t tiles through the ring
      const Product p2 = product(true, 2, p);
      for (int rt = 0; rt < p.row_tiles; ++rt)
        run_tiles<MT, kOut, kQ8>(p, acc, p2.tiles, cid, G, p2.k / s / kBK, ring, 0u, true, it, xc, red4, red_u32, s,
                            rank, rt * MT);
    }
    stamp(kMlp ? 5 : 2);
    xc.finish();  // every CTA has read this one's buffers
  }
  cluster_sync_all();
}


// ---- host side -------------------------------------------------------------

// cuTensorMapEncodeTiled, a driver entry point, reached through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// the dynamic shared memory each kernel may use, set once per kernel
template <int MT, bool kMlp, typename W>
cudaError_t allow_smem(int smem) {
  static int allowed = 0;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute((const void*)dense_kernel<MT, kMlp, W>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

cudaLaunchConfig_t config(int cluster, int clusters, int smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of `cluster` CTAs with `smem` bytes each that the device holds at once
template <int MT, bool kMlp, typename W>
cudaError_t max_clusters(int cluster, int smem, int* out) {
  static int keys[32], values[32], n = 0;  // (cluster, smem) -> count, per kernel
  const int key = cluster * (kMaxSmem + 1) + smem;
  for (int i = 0; i < n; ++i)
    if (keys[i] == key) {
      *out = values[i];
      return cudaSuccess;
    }
  cudaError_t e = allow_smem<MT, kMlp, W>(smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, 1, smem, nullptr, attr);
  e = cudaOccupancyMaxActiveClusters(out, (const void*)dense_kernel<MT, kMlp, W>, &cfg);
  if (e == cudaSuccess && n < 32) {
    keys[n] = key;
    values[n++] = *out;
  }
  return e;
}

template <int MT, bool kMlp, typename W>
int launch(const void* const* maps, const Params& p, int cluster, int clusters, int smem, cudaStream_t stream) {
  const int k_slice = p.C / cluster;
  if (cluster < 1 || cluster > kMaxCluster || clusters < 1 || p.stages < kMinStages || p.stages > kMaxStages ||
      k_slice % kBK || layout(MT, k_slice, p.stages, kMlp, (int)sizeof(W)).total > smem || smem > kMaxSmem ||
      (kMlp && (p.N / cluster) % kBK) || p.row_tiles * MT < p.M)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem<MT, kMlp, W>(smem);
  if (e != cudaSuccess) return (int)e;
  if (kMlp) {  // the grid barriers need every CTA resident at once
    int most = 0;
    e = max_clusters<MT, kMlp, W>(cluster, smem, &most);
    if (e != cudaSuccess) return (int)e;
    if (clusters > most) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  CUtensorMap t[5];
  for (int i = 0; i < 5; ++i) memcpy(&t[i], maps[i], sizeof(CUtensorMap));
  Params params = p;
  void* args[] = {&t[0], &t[1], &t[2], &t[3], &t[4], &params};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, clusters, smem, stream, attr);
  e = cudaLaunchKernelExC(&cfg, (const void*)dense_kernel<MT, kMlp, W>, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the row tiles each kernel is built for (ops/decode_layer_kernel.py
// ROW_TILES_QKV / ROW_TILES_MLP)
#define RQ_TILES_MLP(X) \
  X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(72) X(80) X(88) X(96) X(104) X(112) X(120) X(128)
#define RQ_TILES_QKV(X) RQ_TILES_MLP(X) X(160) X(192) X(224) X(256)

// launch() and max_clusters() of the kernel built for row tile mt
template <bool kMlp, typename W>
int launch_tile(int mt, const void* const* maps, const Params& p, int cluster, int clusters, int smem,
                cudaStream_t stream) {
#define RQ_CASE(T) \
  case T:          \
    return launch<T, kMlp, W>(maps, p, cluster, clusters, smem, stream);
  if constexpr (kMlp) {
    switch (mt) { RQ_TILES_MLP(RQ_CASE) }
  } else {
    switch (mt) { RQ_TILES_QKV(RQ_CASE) }
  }
#undef RQ_CASE
  return (int)cudaErrorInvalidValue;
}

template <bool kMlp, typename W>
int max_clusters_tile(int mt, int cluster, int smem, int* out) {
#define RQ_CASE(T) \
  case T:          \
    return (int)max_clusters<T, kMlp, W>(cluster, smem, out);
  if constexpr (kMlp) {
    switch (mt) { RQ_TILES_MLP(RQ_CASE) }
  } else {
    switch (mt) { RQ_TILES_QKV(RQ_CASE) }
  }
#undef RQ_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Encode the TMA tensor map of a matrix [rows, cols] (row-major, 16-byte
// aligned) of bf16 (elem_bytes 2) or int8 (1) in boxes of box_rows rows x
// 64 columns, with the 128-byte (bf16) or 64-byte (int8) swizzle, into out
// (128 bytes): a weight's (box_rows 64) or an activation's (the row tile).
// Rows past `rows` read as zeros. Returns 0, or a CUDA error code.
extern "C" int rq_dense_tensor_map(const void* w, int rows, int cols, int box_rows, int elem_bytes, void* out) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  if (elem_bytes != 1 && elem_bytes != 2) return (int)cudaErrorInvalidValue;
  const bool int8 = elem_bytes == 1;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap map;  // 64-byte aligned here; out need not be
  const CUresult r = encode(&map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            const_cast<void*>(w), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            int8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out-of-bounds elements read as zeros
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  memcpy(out, &map, sizeof(map));
  return 0;
}

// How many clusters of `cluster` CTAs of the row-tile-`mt` kernel (mlp: the
// proj_mlp one; int8: for int8 weights) with `smem` bytes of shared memory
// the device holds at once.
extern "C" int rq_dense_max_clusters(int mlp, int mt, int cluster, int smem, int int8, int* out) {
  if (mlp)
    return int8 ? max_clusters_tile<true, int8_t>(mt, cluster, smem, out)
                : max_clusters_tile<true, bf16>(mt, cluster, smem, out);
  return int8 ? max_clusters_tile<false, int8_t>(mt, cluster, smem, out)
              : max_clusters_tile<false, bf16>(mt, cluster, smem, out);
}

// qkv = bf16(LN1(x) @ w^T + bqkv), or with int8 weights bf16((LN1(x) @ q^T)
// * ws + bqkv). x: [M, C] and x_map, its tensor map in boxes of mt rows;
// ln_w, ln_b: [C]; w_map: the tensor map of the weight [N, C] (bf16, or
// int8 when ws is given); ws: the int8 weight's scales [N], or null; bqkv:
// [N]; out: [M, N]; all else bf16. One launch of `clusters` clusters of
// `cluster` CTAs, row tiles of `mt` rows (row_tiles * mt >= M), a ring of
// `stages` weight tiles, `smem` bytes of dynamic shared memory (the plan of
// ops/decode_layer_kernel.py::dense_plan).
extern "C" int rq_fused_ln_qkv(const void* x, const void* x_map, const void* ln_w, const void* ln_b, const void* w_map,
                               const void* ws, const void* bqkv, void* out, int M, int C, int N, int cluster,
                               int clusters, int mt, int row_tiles, int stages, int smem, float eps, void* stream) {
  Params p = {};
  p.x = static_cast<const bf16*>(x);
  p.ln_w = static_cast<const bf16*>(ln_w);
  p.ln_b = static_cast<const bf16*>(ln_b);
  p.b0 = static_cast<const bf16*>(bqkv);
  p.s0 = static_cast<const bf16*>(ws);
  p.out = static_cast<bf16*>(out);
  p.M = M;
  p.C = C;
  p.N = N;
  p.row_tiles = row_tiles;
  p.stages = stages;
  p.eps = eps;
  const void* maps[5] = {w_map, w_map, w_map, x_map, x_map};
  const cudaStream_t st = (cudaStream_t)stream;
  return ws ? launch_tile<false, int8_t>(mt, maps, p, cluster, clusters, smem, st)
            : launch_tile<false, bf16>(mt, maps, p, cluster, clusters, smem, st);
}

// x2 = x + bf16(bf16(y @ wo^T) + bo); out = x2 + bf16(bf16(gelu(LN2(x2) @
// w1^T + b1)) @ w2^T + b2); with int8 weights (their scales wo_s [C], w1_s
// [H], w2_s [C] given; all three null for bf16 weights) x2 = x + bf16((y @
// wo_q^T) * wo_s + bo), t = bf16(gelu((LN2(x2) @ w1_q^T) * w1_s + b1)), out
// = x2 + bf16((t @ w2_q^T) * w2_s + b2). x, y, out, x2 (scratch): [M, C],
// and the tensor maps of y and x2 in boxes of mt rows; the tensor maps of
// wo [C, C], w1 [H, C], w2 [C, H]; biases and LN2 [C] or [H]; t (scratch):
// [H / 64, row_tiles * mt, 64]; stats (scratch): fp32 [M, C / 64, 2]; all
// else bf16. gelu_sigmoid selects t * sigmoid(1.702 t) over the exact erf.
// One persistent launch, co-resident or refused; the plan as for
// rq_fused_ln_qkv.
extern "C" int rq_fused_proj_mlp(const void* x, const void* y, const void* y_map, const void* wo_map, const void* wo_s,
                                 const void* bo, const void* ln_w, const void* ln_b, const void* w1_map,
                                 const void* w1_s, const void* b1, const void* w2_map, const void* w2_s, const void* b2,
                                 void* out, void* x2, const void* x2_map, void* t, void* stats, int M, int C, int H,
                                 int cluster, int clusters, int mt, int row_tiles, int stages, int smem,
                                 int gelu_sigmoid, float eps, void* stream) {
  if ((wo_s == nullptr) != (w1_s == nullptr) || (wo_s == nullptr) != (w2_s == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = static_cast<const bf16*>(x);
  p.y = static_cast<const bf16*>(y);
  p.ln_w = static_cast<const bf16*>(ln_w);
  p.ln_b = static_cast<const bf16*>(ln_b);
  p.b0 = static_cast<const bf16*>(bo);
  p.b1 = static_cast<const bf16*>(b1);
  p.b2 = static_cast<const bf16*>(b2);
  p.s0 = static_cast<const bf16*>(wo_s);
  p.s1 = static_cast<const bf16*>(w1_s);
  p.s2 = static_cast<const bf16*>(w2_s);
  p.out = static_cast<bf16*>(out);
  p.x2 = static_cast<bf16*>(x2);
  p.t = static_cast<bf16*>(t);
  p.stats = static_cast<float2*>(stats);
  p.M = M;
  p.C = C;
  p.N = H;
  p.row_tiles = row_tiles;
  p.stages = stages;
  p.gelu_sigmoid = gelu_sigmoid;
  p.eps = eps;
  const void* maps[5] = {wo_map, w1_map, w2_map, y_map, x2_map};
  const cudaStream_t st = (cudaStream_t)stream;
  return wo_s ? launch_tile<true, int8_t>(mt, maps, p, cluster, clusters, smem, st)
              : launch_tile<true, bf16>(mt, maps, p, cluster, clusters, smem, st);
}

// The globaltimer stamps of the last launch (g_stamps) into out (6 x u64).
extern "C" int rq_dense_phase_ns(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}

