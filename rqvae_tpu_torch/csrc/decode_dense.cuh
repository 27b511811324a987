// The shared machinery of csrc/decode_dense.cu, csrc/decode_fused.cu, csrc/dense_mlp.cu and
// csrc/dense_w8a8.cu

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
  int panel;        // the resident B operand: k_slice / 64 blocks of [mt, 64] swizzled; also
                    // what reuses its bytes (layout's reuse_bytes; the larger of the two sizes)
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

// reuse_bytes: what else takes the panel's bytes (0: nothing): the fused
// kernels' attention scores, between the QKV product and the wo panel;
// dense_mlp.cu's phase-B t slots, once phase A is done
__host__ __device__ inline Layout layout(int mt, int k_slice, int stages, bool mlp, int wbytes, int reuse_bytes = 0) {
  Layout l;
  l.tile_bytes = kTile * kBK * wbytes;
  l.stage_bytes = l.tile_bytes + (mlp ? mt * kRowBytes : 0);
  l.panel = stages * l.stage_bytes;
  const int panel_bytes = (k_slice / kBK) * mt * kRowBytes;
  l.red = l.panel + (panel_bytes > reuse_bytes ? panel_bytes : reuse_bytes);
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
  // the fused kernels of csrc/decode_fused.cu only
  const bf16* ln2_w;  // [C]: LN2 of the layer step (LN1's in ln_w, ln_b)
  const bf16* ln2_b;
  const bf16* bqkv;   // [3C]: the layer step's QKV bias (bo in b0)
  bf16* qkv;          // [M, 3C] scratch: the layer step's q, k, v
  bf16* att;          // [M, C] scratch: the attention output, wo's input
  const bf16* aq;     // the attention's q, k_new, v_new: rows of ld_a elements
  const bf16* ak;
  const bf16* av;
  void* kc;           // the layer's caches [M, T, C]: bf16, or int8 with
  void* vc;           //   bf16 scales ks, vs [M, T, n_head]
  bf16* ks;
  bf16* vs;
  int ld_a, T, n_head, window, n_valid, cur_len;
  // kProjMlp's w2 product only: w2 packed [nc, C, chunk], read through a
  // tensor map of [nc C, chunk] (0: w2 [C, H])
  int chunk;
  // csrc/dense_w8a8.cu only (t holds the s8 images of the tq tiles there)
  int8_t* hq;         // [row_tiles * mt, C]: LN2's output quantized per row
  float* hs;          // [row_tiles * mt]: its row scales
  float* tf;          // [H / 64, row_tiles * mt, 64]: phase A's t in fp32
  float* tmax;        // [H / 64, row_tiles * mt]: each row's max |t| over each 64-unit tile
  float* ts;          // [H / act_chunk, row_tiles * mt]: each row's activation scale of each chunk
  int act_chunk;      // the hidden units that share a row's activation scale
};

// The fused kernels' attention: the consumer warps that attend (all 8, or
// fewer for a window so long that their scores would take more than 64 KB)
// and their scores, window + 1 floats and as many V scales for each of a
// warp's 4 heads
__host__ __device__ inline int attn_warps(int window) {
  const int w = 65536 / (32 * (window + 1));
  return w < 1 ? 1 : w > kConsumers / 32 ? kConsumers / 32 : w;
}
__host__ __device__ inline int score_bytes(int window) { return attn_warps(window) * 32 * (window + 1); }

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

// wgmma.mma_async m64n256k8, tf32 x tf32 -> fp32, A and B from shared memory
// (descriptors; both K-major, which tf32 requires: it takes no transpose),
// D scaled by 1 (accumulate). The operands are fp32 words already rounded
// to tf32 (csrc/nearest_code.cu), their low 13 mantissa bits zero; a k8
// step is 32 bytes of a 128-byte swizzled row.
__device__ __forceinline__ void wgmma_tf32_256(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1;\n}\n"
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

// gelu by form: 0 none, 1 the exact erf, 2 the sigmoid form t * sigmoid(1.702 t)
__device__ __forceinline__ float gelu_of(float v, int form) {
  if (form == 1) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  if (form == 2) return v / (1.f + expf(-1.702f * v));
  return v;
}

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
// ((c ^ (r / 2 % 4)) << 4)), widened to bf16, for a wgmma warpgroup's lane
// l of its warp w (warp % 4): rows r = 16 w + l / 4 and r + 8, K pairs (2q, 2q + 1)
// and (2q + 8, 2q + 9) of the step, q = l % 4, in a = {(r, lo), (r + 8, lo),
// (r, hi), (r + 8, hi)}. A row's two words (K 4 (q / 2) .. + 3 and 8 + 4 (q /
// 2) .. + 3) give its four bytes by one byte permute; across the warp the
// 32-bit loads fall on 32 distinct banks.
__device__ __forceinline__ void load_a_q8(uint32_t* a, uint32_t tile, int kk) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
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

// globaltimer stamps of CTA 0's consumer thread 0 in the last launch of
// the library's kernels: ln_qkv: start, LN1 staged, end; proj_mlp: start,
// phase 1 done, barrier 1 passed, phase 2 done, barrier 2 passed, end
// (rq_dense_phase_ns); the fused kernels' phases (rq_fused_phase_ns)
constexpr int kStamps = 16;
__device__ unsigned long long g_stamps[kStamps];

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

// What a launch computes: fused_ln_qkv (kLnQkv), fused_proj_mlp
// (kProjMlp), the fused kernels of csrc/decode_fused.cu: the whole layer
// step (kLayer) and the q8 attention with wo (kAttnWo), and
// csrc/dense_w8a8.cu's proj + MLP on int8 activations (kW8A8: kProjMlp's
// products, its streamed B tiles s8), and csrc/stream_probe.cu's weight
// stream alone (kStream: kProjMlp's w1 and packed w2 tiles, no products)
enum Kind { kLnQkv, kProjMlp, kLayer, kAttnWo, kW8A8, kStream };

__host__ __device__ constexpr int n_products(int kind) {
  return kind == kLnQkv || kind == kAttnWo ? 1 : kind == kStream ? 2 : kind == kProjMlp || kind == kW8A8 ? 3 : 4;
}

// bytes of one activation row of a streamed B tile: 64 bf16, or 64 s8 (kW8A8)
__host__ __device__ constexpr int b_row_bytes(int kind) { return kind == kW8A8 ? kBK : kRowBytes; }

// The products of one launch, in the order the producer and the consumers
// walk them: fused_ln_qkv has one (wqkv), fused_proj_mlp three (wo, w1,
// w2), the layer step four (wqkv, wo, w1, w2), the attention with wo one
// (wo), the stream probe two (w1, w2; w2 neither streams t nor waits for a
// gate). For each: row tiles rt, then the cluster's weight tiles j = cid,
// cid + clusters, ..., then the CTA's K-chunks.
struct Product {
  int tiles;     // weight rows / 64
  int k;         // reduction length
  bool streamed; // B tiles through the ring (w2's t) instead of the panel
};

__device__ __forceinline__ Product product(int kind, int i, const Params& p) {
  if (kind == kStream) return i == 0 ? Product{p.N / kTile, p.C, false} : Product{p.C / kTile, p.N, false};
  if (kind == kLnQkv) return {p.N / kTile, p.C, false};
  if (kind == kAttnWo) return {p.C / kTile, p.C, false};
  if (kind == kLayer) {
    if (i == 0) return {3 * p.C / kTile, p.C, false};
    --i;  // then fused_proj_mlp's three
  }
  if (i == 0) return {p.C / kTile, p.C, false};
  if (i == 1) return {p.N / kTile, p.C, false};
  return {p.C / kTile, p.N, true};
}

struct Ring {
  uint32_t base, full, empty;
  int stages, stage_bytes, tile_bytes;
};

// The producer: lane 0 of the last warp issues every weight tile (and, in
// w2's product, t tile) of this CTA in the consumers' order, `stages`
// ahead; maps[i] is product i's weight. kProjMlp's (and kStream's) w2 may be packed
// (p.chunk): its tile at (K k0, rows j * 64 ..) lies at column k0 mod chunk,
// row (k0 div chunk) C + j * 64 of the [nc C, chunk] map. kW8A8 copies a t
// tile's rows below M alone (the rest of the stage's tile is left as it
// is: it meets only output rows that are never stored).
template <int MT, int kKind>
__device__ __forceinline__ void producer(const CUtensorMap* const* maps, const Params& p, const Ring& ring,
                                         uint32_t gate, int s, int rank, int cid, int G) {
  constexpr uint32_t kTBytes = MT * b_row_bytes(kKind);  // a streamed t tile
  const int m_pad = p.row_tiles * MT;
  int it = 0;
  int first = -1;       // the first streamed unit
  bool open = false;    // the gate: the consumers passed the last grid barrier
  int n_def = 0;        // streamed units whose t copy waits for the gate
  int def_stage[kMaxStages];
  const uint8_t* def_src[kMaxStages];
  uint32_t def_bytes[kMaxStages];  // kW8A8's
  const auto open_gate = [&]() {
    mbar_wait(gate, 0);
    fence_async_global();
    for (int d = 0; d < n_def; ++d)
      bulk_copy(ring.base + def_stage[d] * ring.stage_bytes + ring.tile_bytes, def_src[d],
                kKind == kW8A8 ? def_bytes[d] : kTBytes, ring.full + def_stage[d] * 8);
    n_def = 0;
    open = true;
  };
  for (int pi = 0; pi < n_products(kKind); ++pi) {
    const Product pr = product(kKind, pi, p);
    const CUtensorMap* map = maps[pi];
    const int ks = pr.k / s;
    const int k_lo = rank * ks;
    const int chunks = ks / kBK;
    const bool packed = p.chunk && ((kKind == kProjMlp && pr.streamed) || (kKind == kStream && pi == 1));
    for (int rt = 0; rt < p.row_tiles; ++rt) {
      const uint32_t t_bytes = kKind == kW8A8 ? (uint32_t)min(MT, p.M - rt * MT) * kBK : kTBytes;
      const uint32_t bytes = ring.tile_bytes + (pr.streamed ? t_bytes : 0);
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
          const int k0 = k_lo + kc * kBK;
          if (packed)
            tma_tile(dst, map, k0 % p.chunk, (k0 / p.chunk) * p.C + j * kTile, full);
          else
            tma_tile(dst, map, k0, j * kTile, full);
          if (pr.streamed) {
            const uint8_t* src = reinterpret_cast<const uint8_t*>(p.t) +
                                 ((size_t)(k0 / kBK) * m_pad + (size_t)rt * MT) * b_row_bytes(kKind);
            if (open) {
              bulk_copy(dst + ring.tile_bytes, src, t_bytes, full);
            } else {
              def_stage[n_def] = stage;
              def_src[n_def] = src;
              if constexpr (kKind == kW8A8) def_bytes[n_def] = t_bytes;
              ++n_def;
            }
          }
        }
      }
    }
  }
  if (!open && n_def > 0) open_gate();
}

// Where a K loop finds its B operand: block kc of the panel (panel + kc *
// MT * 128); the ring stage itself, after its weight tile (streamed); or,
// when slots > 0, t slot (it - first) mod slots of the panel's bytes
// (dense_mlp.cu's phase B, `first` its first unit)
struct BSource {
  uint32_t panel;
  bool streamed;
  int slots, first;
};

// One weight tile's K loop over this CTA's chunks: acc = its partial
// product, by the first warpgroup or, when the row tile is split (NW < MT),
// by both, each on NW rows of it (the second's start NW rows into every B
// tile). A bf16 weight tile is wgmma's A operand in shared memory, a chunk
// one commit group; an int8 one is widened into registers a k16 step at a
// time (load_a_q8), a step one commit group, the next step's fragment
// widened while the step runs.
template <int MT, bool kQ8, int NW = MT>
__device__ __forceinline__ void k_loop(float* acc, int chunks, const Ring& ring, const BSource& src, int& it) {
  const uint32_t half = NW < MT ? (threadIdx.x >> 7) * (NW * kRowBytes) : 0;
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  const int lane = threadIdx.x & 31;
  int prev = -1;
  for (int kc = 0; kc < chunks; ++kc, ++it) {
    const int stage = it % ring.stages;
    mbar_wait(ring.full + stage * 8, (it / ring.stages) & 1);
    const uint32_t a = ring.base + stage * ring.stage_bytes;
    const uint32_t b = src.streamed ? a + ring.tile_bytes
                       : src.slots  ? src.panel + (uint32_t)((it - src.first) % src.slots) * (MT * kRowBytes)
                                    : src.panel + kc * MT * kRowBytes;
    const uint64_t db = sw128_desc(b + half);
    if constexpr (kQ8) {
      uint32_t frag[2][4];
      load_a_q8(frag[0], a, 0);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        fence_acc<NW / 2>(acc);
        wgmma_fence();
        wgmma_rs<NW>(acc, frag[kk & 1], db + 2 * kk);  // +32 bytes per k16
        wgmma_commit();
        wgmma_wait<1>();  // the step before is done: its fragment may be rewritten
        if (kk == 0 && prev >= 0 && lane == 0) mbar_arrive(ring.empty + prev * 8);  // and the chunk before
        if (kk + 1 < kBK / 16) load_a_q8(frag[(kk + 1) & 1], a, kk + 1);
      }
    } else {
      const uint64_t da = sw128_desc(a);
      fence_acc<NW / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma<NW>(acc, da + 2 * kk, db + 2 * kk);  // +32 bytes per k16
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(ring.empty + prev * 8);
    }
    prev = stage;
  }
  wgmma_wait<0>();
  fence_acc<NW / 2>(acc);
  if (prev >= 0 && lane == 0) mbar_arrive(ring.empty + prev * 8);
}

// Rank r owns row pairs [pair_lo(r), pair_lo(r + 1)) of a tile's P = MT / 2
// (s, the cluster size, is a power of two)
__device__ __forceinline__ int pair_lo(int r, int P, int s) { return (r * P) >> (__ffs(s) - 1); }

__device__ __forceinline__ float word_bits(float v) { return v; }
__device__ __forceinline__ float word_bits(int v) { return __int_as_float(v); }

// Push a warpgroup's partial tile (acc, the wgmma layout, NW rows of it:
// see k_loop; fp32, or s32 sums moved as their 32-bit words) to the owners
// of its rows: lane (w, l) of fragment J holds row pair pair0 + 4 J + l %
// 4, column pair 8 (w % 4) + l / 4, as one 16-byte cell of the owner's slot
// `rank` (pair0: NW / 2 for the second warpgroup of a split tile, else 0).
template <int MT, int NW = MT, typename Acc>
__device__ __forceinline__ void push_partial(const Acc* acc, uint32_t red_u32, uint32_t full, int s, int rank) {
  constexpr int P = MT / 2;
  const int lane = threadIdx.x & 31;
  const int pair0 = NW < MT ? (threadIdx.x >> 7) * (NW / 2) : 0;
  const int slot = (P + s - 1) / s;
  const int cp = 8 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int J = 0; J < NW / 8; ++J) {
    const int mp = pair0 + 4 * J + (lane & 3);
    const int r = ((mp + 1) * s - 1) / P;  // the owner: pair_lo(r) <= mp < pair_lo(r + 1)
    const uint32_t off = (uint32_t)((rank * slot + mp - pair_lo(r, P, s)) * 32 + cp) * 16;
    st_async4(mapa(red_u32 + off, r), word_bits(acc[4 * J]), word_bits(acc[4 * J + 1]), word_bits(acc[4 * J + 2]),
              word_bits(acc[4 * J + 3]), mapa(full, r));
  }
}

// bytes a CTA receives in a tile's round: s slots of its row pairs
__device__ __forceinline__ uint32_t partial_bytes(int MT, int s, int rank) {
  const int P = MT / 2;
  return (uint32_t)(s * (pair_lo(rank + 1, P, s) - pair_lo(rank, P, s)) * 512);
}

// kProjF: kProj with the bias on the fp32 product before its one cast, for
// bf16 weights too (the fused kernels' rounding)
enum Epilogue { kQkv, kProj, kProjF, kGelu, kOut };

__device__ __forceinline__ float bf16_at(const bf16* p) { return __bfloat162float(*p); }

// data another CTA of this launch wrote before a grid barrier: through L2
__device__ __forceinline__ float bf16_at_cg(const bf16* p) {
  const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(u));
}

__device__ __forceinline__ void store_bf16(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// cell `cell` of this CTA's row pairs (pair - lo) * 32 + lane, summed over
// the s slots of `slot` pairs in rank order
__device__ __forceinline__ float4 sum_slots(const float4* red, int cell, int slot, int s) {
  float4 v = red[cell];
  for (int q = 1; q < s; ++q) {
    const float4 d = red[q * slot * 32 + cell];
    v.x += d.x;
    v.y += d.y;
    v.z += d.z;
    v.w += d.w;
  }
  return v;
}

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
  // kQkv: the layer step's q, k, v go to its qkv scratch, with its bqkv
  const bf16* bias = E == kQkv && p.qkv ? p.bqkv : (E == kQkv || E == kProj || E == kProjF) ? p.b0 : E == kGelu ? p.b1 : p.b2;
  const float b0 = bf16_at(bias + n), b8 = bf16_at(bias + n + 8);
  float sc0 = 1.f, sc8 = 1.f;
  if (kQ8) {
    const bf16* scale = (E == kQkv || E == kProj || E == kProjF) ? p.s0 : E == kGelu ? p.s1 : p.s2;
    sc0 = bf16_at(scale + n);
    sc8 = bf16_at(scale + n + 8);
  }
  for (int mp = lo + warp; mp < hi; mp += nwarps) {
    const float4 v = sum_slots(red, (mp - lo) * 32 + lane, slot, s);
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
          bf16* row = p.qkv ? p.qkv + (size_t)gm * 3 * p.C : p.out + (size_t)gm * p.N;
          store_bf16(row + n, y0);
          store_bf16(row + n + 8, y8);
        }
      } else if (E == kProj || E == kProjF) {
        float x0 = 0.f, x8 = 0.f;
        if (ok) {  // kProj, bf16 weights: the product is cast before + bo
          const bf16* xr = p.x + (size_t)gm * p.C + n;
          const bool fp32_bias = kQ8 || E == kProjF;
          x0 = round_bf16(bf16_at(xr) + round_bf16(fp32_bias ? y0 : round_bf16(a) + b0));
          x8 = round_bf16(bf16_at(xr + 8) + round_bf16(fp32_bias ? y8 : round_bf16(c) + b8));
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
// issues, every thread waits for phase `parity`. kRow: a panel row's bytes
// (64 for an s8 activation, its map with the 64-byte swizzle).
template <int MT, int kRow = kRowBytes>
__device__ __forceinline__ void load_panel(uint32_t panel, const CUtensorMap* map, int k_lo, int ks, int m0,
                                           uint32_t bar, int parity) {
  if (threadIdx.x == 0) {
    fence_async_global();  // the activation may come from other CTAs' generic stores (x2)
    mbar_expect_tx(bar, (uint32_t)(ks / kBK * MT * kRow));
    for (int kb = 0; kb < ks / kBK; ++kb) tma_tile(panel + kb * MT * kRow, map, k_lo + kb * kBK, m0, bar);
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

// The weight tiles j = cid, cid + G, ... of one product for one row tile;
// loop() runs a tile's K loop into acc (the wgmma layout, NW rows of the
// tile), epi(j, warp0, nwarps) applies tile j's epilogue on the consumer
// warps from warp0 on. Unsplit (NW == MT): the first warpgroup runs tile
// j's K loop while the second applies the epilogue of tile j - G (its
// round's pushes having landed meanwhile); then the first pushes tile j's
// partial. Split (see k_loop): both warpgroups run the K loop and push, and
// tile j - G's epilogue runs on all eight warps in between. The last tile's
// epilogue runs on all consumer warps. CTA 0 stamps its first n_st tiles
// from stamp `st` on: K loop done, exchange open (every CTA of the cluster
// has read the round before).
template <int MT, int NW, typename Acc, typename Loop, typename Epi>
__device__ __forceinline__ void tile_loop(const Acc* acc, int tiles, int cid, int G, const Loop& loop, Exchange& xc,
                                          uint32_t red_u32, int s, int rank, const Epi& epi, int st, int n_st) {
  int pending = -1;
  if constexpr (NW < MT) {
    for (int j = cid, n = 0; j < tiles; j += G, ++n) {
      loop();
      if (n < n_st) stamp(st + 2 * n);
      if (pending >= 0) {
        xc.wait();
        epi(pending, 0, kConsumers / 32);
        xc.end();
      }
      xc.begin(partial_bytes(MT, s, rank));
      if (n < n_st) stamp(st + 2 * n + 1);
      push_partial<MT, NW>(acc, red_u32, xc.full, s, rank);
      pending = j;
    }
  } else {
    const bool mma = threadIdx.x < 128;
    for (int j = cid, n = 0; j < tiles; j += G, ++n) {
      if (mma) {
        loop();
        if (n < n_st) stamp(st + 2 * n);
      } else if (pending >= 0) {
        xc.wait();
        epi(pending, 4, 4);
      }
      if (pending >= 0) xc.end();  // the consumer barrier first
      xc.begin(partial_bytes(MT, s, rank));
      if (n < n_st) stamp(st + 2 * n + 1);
      if (mma) push_partial<MT>(acc, red_u32, xc.full, s, rank);
      pending = j;
    }
  }
  if (pending >= 0) {
    xc.wait();
    epi(pending, 0, kConsumers / 32);
    xc.end();
  }
}

// tile_loop with decode_dense.cuh's K loop (k_loop) over `chunks` chunks
template <int MT, bool kQ8, int NW, typename Epi>
__device__ __forceinline__ void for_tiles(float* acc, int tiles, int cid, int G, int chunks, const Ring& ring,
                                          const BSource& src, int& it, Exchange& xc, uint32_t red_u32, int s, int rank,
                                          const Epi& epi, int st = 0, int n_st = 0) {
  const auto loop = [&]() { k_loop<MT, kQ8, NW>(acc, chunks, ring, src, it); };
  tile_loop<MT, NW>(acc, tiles, cid, G, loop, xc, red_u32, s, rank, epi, st, n_st);
}

// for_tiles over the epilogues of decode_dense.cu and decode_fused.cu, for
// the row tile at m0, B from the panel or streamed
template <int MT, Epilogue E, bool kQ8>
__device__ __forceinline__ void run_tiles(const Params& p, float* acc, int tiles, int cid, int G, int chunks,
                                          const Ring& ring, uint32_t panel, bool streamed, int& it, Exchange& xc,
                                          const float4* red, uint32_t red_u32, int s, int rank, int m0) {
  const auto epi = [&](int j, int w0, int nw) { epilogue<MT, E, kQ8>(p, red, s, rank, m0, j, w0, nw); };
  for_tiles<MT, kQ8, MT>(acc, tiles, cid, G, chunks, ring, BSource{panel, streamed, 0, 0}, it, xc, red_u32, s, rank, epi);
}

// ---- host side -------------------------------------------------------------

// a launch of `clusters` clusters of `cluster` CTAs
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

// the dynamic shared memory `kernel` may use, raised once per kernel and size
inline cudaError_t allow_smem(const void* kernel, int smem) {
  constexpr int kSlots = 128;
  static const void* kernels[kSlots];
  static int allowed[kSlots], n = 0;
  int i = 0;
  while (i < n && kernels[i] != kernel) ++i;
  if (i < n && smem <= allowed[i]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && i < kSlots) {
    if (i == n) kernels[n++] = kernel;
    allowed[i] = smem;
  }
  return e;
}

// clusters of `cluster` CTAs of `kernel` with `smem` bytes each that the
// device holds at once, asked once per (kernel, cluster, smem)
inline cudaError_t max_clusters(const void* kernel, int cluster, int smem, int* out) {
  constexpr int kSlots = 256;
  static const void* kernels[kSlots];
  static int keys[kSlots], values[kSlots], n = 0;
  const int key = cluster * (kMaxSmem + 1) + smem;
  for (int i = 0; i < n; ++i)
    if (kernels[i] == kernel && keys[i] == key) {
      *out = values[i];
      return cudaSuccess;
    }
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, 1, smem, nullptr, attr);
  e = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  if (e == cudaSuccess && n < kSlots) {
    kernels[n] = kernel;
    keys[n] = key;
    values[n++] = *out;
  }
  return e;
}

}  // namespace
