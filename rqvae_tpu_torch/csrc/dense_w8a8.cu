// The W8A8 decode proj + LN2 + MLP on Hopper (sm_90a), one persistent
// launch per call, on the machinery of csrc/decode_dense.cu
// (decode_dense.cuh): int8 weights with a bf16 scale per output channel,
// and the two MLP products on int8 activations too, s8 x s8 -> s32 on the
// int8 tensor cores (wgmma .s32.s8.s8), no weight widened:
//
//   x2   = x + bf16(acc_o * s_o + bo),   acc_o = y @ wo^T in fp32 (#6's step)
//   h    = LN2(x2) in fp32 (never rounded to bf16)
//   hq   = clip(rint(h / hs), +-127),     hs = max(max_c |h| / 127, 1e-8) per row
//   t_j  = gelu(s32(hq @ w1[chunk j]^T) * hs * s_1j + b1_j) in fp32
//   tq_j = clip(rint(t_j / ts_j), +-127), ts_j = max(max over chunk j |t_j| / 127, 1e-8) per row
//   acc  = sum_j s32(tq_j @ w2[:, chunk j]^T) * ts_j in fp32
//   out  = x2 + bf16(acc * s_2 + b2)
//
// Replaces tools/exp_w8a8.py::fused_proj_mlp_q8a8 (#16, :107). Its first
// design, csrc/w8a8.cu (rq_w8a8_mlp: a cooperative launch, a cp.async chunk
// ring, mma.sync s8 with the activations read from L2 by every block, two
// grid barriers per chunk, at most 512 rows), stays as the A/B baseline
// that only chip_smoke.py runs. `chunk` (act_chunk) is part of the result:
// ts_j is taken per row over the chunk's hidden units.
//
// Bound on the H100: weight bytes. At B 100, C 1536, H 6144 a call reads
// 21.2 MB of int8 weights, 6.3 us at 3.35 TB/s; the s8 products take 2 B 2
// C H = 3.8 GOP, 1.9 us at 1,979 TOP/s, the bf16 wo product 0.5 us at 989
// TFLOP/s.
//
// Design: decode_dense.cu's fused_proj_mlp with int8 weights (the same
// producer, ring, cluster split-K, exchange and tile loop), its MLP
// products on s8 wgmma, four grid barriers:
// 1. x2 and LN2's per-tile partial sums: #6's phase 1 (the int8 wo tile
//    widened to bf16 in registers, the bf16 y panel).
// 2. LN2 and hq, one row a CTA (rows b, b + grid, ...): the row's
//    statistics from those partial sums in tile order, h in fp32, its max
//    |h| over the block, hs, hq into a [rows, C] s8 buffer and hs beside
//    it. Each row once: a first draft took them in every cluster on its
//    K-slice, and the IEEE division of every element, repeated in every
//    cluster, took more of a call than this pass and its barrier.
// 3. Phase A (w1): per row tile, hq's K-slice by TMA (the 64-byte swizzle)
//    as the resident B panel of k_slice / 64 s8 tiles of [mt, 64 B] in the
//    bf16 y panel's bytes (half of them); wgmma m64nNk32 with the w1 tile straight from
//    the TMA ring (64-byte swizzle) as A. The split-K partials are s32,
//    pushed through the cluster as 32-bit words and summed as integers
//    (exact; fp32 holds integers only to 2^24, and C 127^2 is 2.5e7 at C
//    1536). The epilogue writes t in fp32 and each row's max |t| over the
//    tile's 64 columns into tmax [H / 64, rows]: a store (each (row, tile)
//    has one owner), so no atomics and nothing to zero between launches.
// 4. Each CTA quantizes the t it wrote: ts_j from the max of the row's tile
//    maxima over chunk j (exact in any order), tq into s8 B-tile images [H
//    / 64, rows, 64 B], ts_j into ts. Quantizing t as each block loaded it
//    cost the first design 2.5x (csrc/w8a8.cu).
// 5. Phase B (w2): s8 wgmma with the w2 tile as A and the tq tiles streamed
//    through the ring as decode_dense's t tiles are (their rows below M
//    alone). A 64-wide K tile lies
//    in one chunk, so at each chunk's last tile in a CTA's K-slice the s32
//    sums fold into fp32 (acc += float(s32) * ts_j[row], rounded step by
//    step) and restart; the fp32 partials are reduced in rank order, then
//    out = x2 + bf16(acc * s_2 + b2). The fp32 sums over chunks thus
//    associate by rank, not in the plain version's chunk order (fp32 ulps).
// Row tiles are the N values the s8 wgmma takes (RQ_TILES_W8A8); above 64
// rows a tile is split between the two consumer warpgroups: phase B keeps
// s32 and fp32 sums side by side, which at 96 or 112 rows on one warpgroup
// passed the registers nine warps leave a thread (ptxas spilled).
// Divisions are IEEE (__fdiv_rn; no --use_fast_math), rounding rint
// (__float2int_rn), and the scale, bias and accumulate steps rounded one
// by one (__fmul_rn / __fadd_rn) in the plain version's order.
//
// CTA 0's consumer thread 0 stamps the globaltimer at the start, after
// each phase and each grid barrier, and at the K loop's end and the
// exchange's opening of phase A's first three tiles (rq_dense_w8a8_phase_ns).

#include "decode_dense.cuh"

namespace {

constexpr int kSplitRows = 64;  // larger row tiles are split between the consumer warpgroups

// wgmma.mma_async m64nNk32, s8 x s8 -> s32, A and B from shared memory
// (descriptors, both K-major), D accumulated; N of the row tiles' halves
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_s8<8>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<16>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<24>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<48>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<80>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<112>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55])
      : "l"(da), "l"(db), "r"(1));
}

// shared memory descriptor of a K-major s8 operand with the 64-byte
// swizzle: rows of 64 bytes, 8-row atoms of 512 bytes (stride byte offset 512)
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

template <int R>
__device__ __forceinline__ void fence_acc_s32(int* acc) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

// a row's activation scale from its max |value|: divide, then the floor
// (tools/exp_w8a8.py:72-73; the weight quantizer floors first)
__device__ __forceinline__ float act_scale(float amax) { return fmaxf(__fdiv_rn(amax, 127.f), 1e-8f); }

// clip(rint(v / s), -127, 127) in the low byte
__device__ __forceinline__ uint32_t quant_byte(float v, float s) {
  return (uint32_t)min(max(__float2int_rn(__fdiv_rn(v, s)), -127), 127) & 0xFFu;
}

// four values quantized into the bytes of a word, the first in the low byte
__device__ __forceinline__ uint32_t quant4(float a, float b, float c, float d, float s) {
  return quant_byte(a, s) | quant_byte(b, s) << 8 | quant_byte(c, s) << 16 | quant_byte(d, s) << 24;
}

// Offsets in dynamic shared memory from its 1024-aligned base (the Python
// plan, ops/w8a8_kernel.py::smem_bytes, mirrors `total`)
struct W8Layout {
  int stage_bytes;  // one ring stage: an int8 weight tile + an s8 tq tile (phase B), rounded up to 1024
  int tile_bytes;   // an int8 weight tile: 64 x 64 bytes
  int panel;        // the bf16 y panel: k_slice / 64 blocks of [mt, 64] (128-byte swizzle); in
                    // phase A the s8 hq panel: k_slice / 64 blocks of [mt, 64 B] (64-byte swizzle)
  int red;          // the partial tiles pushed to this CTA: red_bytes(mt)
  int hs;           // float [mt]: the rows' activation scales (the hq pass: its warps' maxima)
  int bars;         // full[stages], empty[stages], xfull, xempty, gate, pbar
  int total;        // bytes to request, with the base's alignment slack
};

__host__ __device__ inline W8Layout w8_layout(int mt, int k_slice, int stages) {
  W8Layout l;
  l.tile_bytes = kTile * kBK;
  l.stage_bytes = (l.tile_bytes + mt * kBK + 1023) & ~1023;  // 1024-aligned, as the panel after the ring
  l.panel = stages * l.stage_bytes;
  l.red = l.panel + (k_slice / kBK) * mt * kRowBytes;
  l.hs = l.red + red_bytes(mt);
  l.bars = l.hs + mt * 4;
  l.total = l.bars + (2 * stages + 4) * 8 + 1024;
  return l;
}

// the rows of a tile this thread's warpgroup multiplies
template <int MT>
__host__ __device__ constexpr int wg_rows() { return MT > kSplitRows ? MT / 2 : MT; }

// One weight tile's K loop over this CTA's chunks on s8 wgmma: acc = its
// s32 partial product, by the first warpgroup or, when the row tile is
// split (NW < MT), by both, each on NW rows of it. A is the weight tile of
// the ring stage, B the hq panel's block kc (phase A) or the stage's tq tile
// (kFold: phase B); a 64-byte K tile is two k32 steps, one commit group.
// kFold: at the last tile of each activation chunk in the slice (K from
// k_lo on, chunks of act_chunk) the s32 sums fold into facc, row by row
// times the chunk's scale (ts: [H / act_chunk, m_pad] from the row tile's
// first row on), and restart.
template <int MT, int NW, bool kFold>
__device__ __forceinline__ void k_loop_s8(int* acc, float* facc, int chunks, const Ring& ring, uint32_t panel, int& it,
                                          const float* ts, int k_lo, int act_chunk, int m_pad) {
  const int rows0 = NW < MT ? (threadIdx.x >> 7) * NW : 0;  // the warpgroup's first row of the tile
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    acc[i] = 0;
    if (kFold) facc[i] = 0.f;
  }
  const int lane = threadIdx.x & 31;
  int prev = -1;
  for (int kc = 0; kc < chunks; ++kc, ++it) {
    const int stage = it % ring.stages;
    mbar_wait(ring.full + stage * 8, (it / ring.stages) & 1);
    const uint32_t a = ring.base + stage * ring.stage_bytes;
    const uint32_t b = (kFold ? a + ring.tile_bytes : panel + kc * MT * kBK) + rows0 * kBK;
    const uint64_t da = sw64_desc(a), db = sw64_desc(b);
    fence_acc_s32<NW / 2>(acc);
    wgmma_fence();
    wgmma_s8<NW>(acc, da, db);
    wgmma_s8<NW>(acc, da + 2, db + 2);  // K bytes 32 .. 63: +32 bytes
    wgmma_commit();
    wgmma_wait<1>();  // the chunk before is done: its stage may be refilled
    if (prev >= 0 && lane == 0) mbar_arrive(ring.empty + prev * 8);
    prev = stage;
    if constexpr (kFold) {
      const int k0 = k_lo + kc * kBK;
      if ((k0 + kBK) % act_chunk == 0 || kc + 1 == chunks) {
        wgmma_wait<0>();
        fence_acc_s32<NW / 2>(acc);
        // lane (w, l) of fragment J holds rows 8 J + 2 (l % 4) and + 1 of the warpgroup's
        const float* tr = ts + (size_t)(k0 / act_chunk) * m_pad + rows0 + 2 * (lane & 3);
#pragma unroll
        for (int J = 0; J < NW / 8; ++J) {
          const float2 sc = __ldcg(reinterpret_cast<const float2*>(tr + 8 * J));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            facc[4 * J + e] = __fadd_rn(facc[4 * J + e], __fmul_rn((float)acc[4 * J + e], (e & 1) ? sc.y : sc.x));
            acc[4 * J + e] = 0;
          }
        }
      }
    }
  }
  wgmma_wait<0>();
  fence_acc_s32<NW / 2>(acc);
  if (prev >= 0 && lane == 0) mbar_arrive(ring.empty + prev * 8);
}

// LN2 and its int8 form for row m, by the consumer threads of one CTA: the
// row's statistics from phase 1's per-tile partial sums in tile order
// (decode_dense.cuh ln2_stats), h = ((x2 - mean) * rstd) * w + b in fp32
// with each step rounded, 8 values a thread and step; the row's max |h|
// over the block (exact in any order; wmax: the warps' maxima), hs =
// act_scale(max), hq = quant(h, hs) into p.hq [m_pad, C], hs into p.hs.
// Rows past M (a row tile's padding) get hq 0 and the floor scale.
__device__ __forceinline__ void ln_quant_row(const Params& p, int m, float* wmax) {
  constexpr int kPer = 4;  // chunks of 8 a thread holds: C <= kPer * 8 * kConsumers
  const int chunks = p.C / 8;
  float h[kPer][8];
  float mx = 0.f;
  if (m < p.M) {
    float s1 = 0.f, s2 = 0.f;
    const float2* st = p.stats + (size_t)m * (p.C / kTile);
    for (int j = 0; j < p.C / kTile; ++j) {
      const float2 d = __ldcg(st + j);
      s1 += d.x;
      s2 += d.y;
    }
    const float2 nm = ln_stats(s1, s2, p.C, p.eps);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int ch = threadIdx.x + i * kConsumers;
      if (ch < chunks) {
        const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p.x2 + (size_t)m * p.C + ch * 8));
        float f[8];
        unpack8(u, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float w = bf16_at(p.ln_w + ch * 8 + e), b = bf16_at(p.ln_b + ch * 8 + e);
          h[i][e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[e], nm.x), nm.y), w), b);
          mx = fmaxf(mx, fabsf(h[i][e]));
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = mx;
  consumer_sync();
  mx = 0.f;
#pragma unroll
  for (int w = 0; w < kConsumers / 32; ++w) mx = fmaxf(mx, wmax[w]);
  const float sc = act_scale(mx);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int ch = threadIdx.x + i * kConsumers;
    if (ch < chunks) {
      uint2 q = make_uint2(0u, 0u);
      if (m < p.M)
        q = make_uint2(quant4(h[i][0], h[i][1], h[i][2], h[i][3], sc), quant4(h[i][4], h[i][5], h[i][6], h[i][7], sc));
      *reinterpret_cast<uint2*>(p.hq + (size_t)m * p.C + ch * 8) = q;
    }
  }
  if (threadIdx.x == 0) p.hs[m] = sc;
  consumer_sync();  // wmax is free for the next row
}

// Phase A's epilogue: this CTA sums its row pairs of tile j over the s
// slots (s32, exact) and takes t = gelu(float(sum) * hs * s1 + b1) in fp32
// into tf, and each row's max |t| over the tile into tmax (a store: every
// (row, tile) has one owner); warp w (of nwarps from warp0) takes pairs lo
// + w, lo + w + nwarps, ...; lane l the column pair (o, o + 8) of both rows
// (decode_dense.cuh's epilogue)
template <int MT>
__device__ __forceinline__ void t_epilogue(const Params& p, const int4* red, const float* hs, int s, int rank, int m0,
                                           int j, int warp0, int nwarps) {
  constexpr int P = MT / 2;
  const int warp = (threadIdx.x >> 5) - warp0;
  const int lane = threadIdx.x & 31;
  const int lo = pair_lo(rank, P, s);
  const int hi = pair_lo(rank + 1, P, s);
  const int slot = (P + s - 1) / s;
  const int o = 16 * (lane >> 3) + (lane & 7);
  const int n = j * kTile + o;  // hidden units n and n + 8
  const int m_pad = p.row_tiles * MT;
  const float sc0 = bf16_at(p.s1 + n), sc8 = bf16_at(p.s1 + n + 8);
  const float b0 = bf16_at(p.b1 + n), b8 = bf16_at(p.b1 + n + 8);
  const int form = p.gelu_sigmoid ? 2 : 1;
  float* tile = p.tf + (size_t)j * m_pad * kBK;
  for (int mp = lo + warp; mp < hi; mp += nwarps) {
    const int cell = (mp - lo) * 32 + lane;
    int4 v = red[cell];
    for (int q = 1; q < s; ++q) {
      const int4 d = red[q * slot * 32 + cell];
      v.x += d.x;
      v.y += d.y;
      v.z += d.z;
      v.w += d.w;
    }
    // (row, column): v.x (m, n), v.y (m + 1, n), v.z (m, n + 8), v.w (m + 1, n + 8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 2 * mp + h;
      const int gm = m0 + m;  // every row of the tile: phase B reads the whole tq tile
      const float t0 = gelu_of(__fadd_rn(__fmul_rn(__fmul_rn((float)(h ? v.y : v.x), hs[m]), sc0), b0), form);
      const float t8 = gelu_of(__fadd_rn(__fmul_rn(__fmul_rn((float)(h ? v.w : v.z), hs[m]), sc8), b8), form);
      tile[(size_t)gm * kBK + o] = t0;
      tile[(size_t)gm * kBK + o + 8] = t8;
      float mx = fmaxf(fabsf(t0), fabsf(t8));
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      if (lane == 0) p.tmax[(size_t)j * m_pad + gm] = mx;
    }
  }
}

// After phase A's grid barrier: tq = quant(t, ts_j) of the (row, tile)
// units this CTA's epilogues wrote (its cluster's tiles j = cid, cid + G,
// ..., the row pairs its rank owns, every row tile), 16 values a thread
// and step, into the swizzled s8 tile images p.t [H / 64, m_pad, 64];
// ts_j = act_scale of the max of the row's tile maxima over chunk j (exact
// in any order), which the chunk's first tile also writes into ts.
template <int MT>
__device__ __forceinline__ void quantize_t(const Params& p, int s, int rank, int cid, int G) {
  constexpr int P = MT / 2;
  const int r0 = 2 * pair_lo(rank, P, s);
  const int nr = 2 * pair_lo(rank + 1, P, s) - r0;  // this CTA's rows of each of its tiles
  const int m_pad = p.row_tiles * MT;
  const int per_chunk = p.act_chunk / kTile;
  const int n_own = (p.N / kTile - cid + G - 1) / G;
  const int items = p.row_tiles * n_own * nr * 4;
  for (int i = threadIdx.x; i < items; i += kConsumers) {
    const int qd = i & 3;  // the 16 values of the row's 64 in this tile
    const int r = (i >> 2) % nr;
    const int u = (i >> 2) / nr;
    const int j = cid + (u % n_own) * G;
    const int gm = (u / n_own) * MT + r0 + r;
    const int ch = j / per_chunk;
    float mx = 0.f;
    for (int k = ch * per_chunk; k < (ch + 1) * per_chunk; ++k) mx = fmaxf(mx, __ldcg(p.tmax + (size_t)k * m_pad + gm));
    const float sc = act_scale(mx);
    const float4* src = reinterpret_cast<const float4*>(p.tf + ((size_t)j * m_pad + gm) * kBK + 16 * qd);
    float4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __ldcg(src + k);
    uint4 q;
    q.x = quant4(v[0].x, v[0].y, v[0].z, v[0].w, sc);
    q.y = quant4(v[1].x, v[1].y, v[1].z, v[1].w, sc);
    q.z = quant4(v[2].x, v[2].y, v[2].z, v[2].w, sc);
    q.w = quant4(v[3].x, v[3].y, v[3].z, v[3].w, sc);
    // the 64-byte swizzle of an s8 [rows, 64] tile (a tile's rows start at a multiple of 8)
    uint8_t* row = reinterpret_cast<uint8_t*>(p.t) + ((size_t)j * m_pad + gm) * kBK;
    *reinterpret_cast<uint4*>(row + ((qd ^ ((gm >> 1) & 3)) << 4)) = q;
    if (j % per_chunk == 0 && qd == 0) p.ts[(size_t)ch * m_pad + gm] = sc;
  }
}

// Tensor maps: wo [C, C], w1 [H, C], w2 [C, H] (int8, boxes of 64 rows); y
// (bf16) and hq (s8) in boxes of MT rows.
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_kernel(const __grid_constant__ CUtensorMap wo_map, const __grid_constant__ CUtensorMap w1_map,
                const __grid_constant__ CUtensorMap w2_map, const __grid_constant__ CUtensorMap y_map,
                const __grid_constant__ CUtensorMap hq_map, const Params p) {
  constexpr int NW = wg_rows<MT>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int s = (int)(gridDim.x / cluster_count());
  const int rank = (int)cluster_rank();
  const int cid = (int)cluster_id();
  const int G = (int)cluster_count();
  const int k_slice = p.C / s;  // this CTA's K of the products over C
  const W8Layout L = w8_layout(MT, k_slice, p.stages);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  const uint32_t bars = smem_u32(smem + L.bars);
  const Ring ring{smem_u32(smem), bars, bars + p.stages * 8, p.stages, L.stage_bytes, L.tile_bytes};
  const uint32_t xfull = bars + 2 * p.stages * 8;
  const uint32_t xempty = xfull + 8;
  const uint32_t gate = xempty + 8;
  const uint32_t pbar = gate + 8;  // the panels' TMA copies

  if (threadIdx.x == 0) {  // full 1, empty the multiplying warps (4 or 8), xempty the cluster's CTAs
    const int warps = NW < MT ? 8 : 4;
    for (int i = 0; i < 2 * p.stages + 4; ++i)
      mbar_init(bars + i * 8, i < p.stages ? 1 : i < 2 * p.stages ? warps : i == 2 * p.stages + 1 ? s : 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_sync_all();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const CUtensorMap* maps[3] = {&wo_map, &w1_map, &w2_map};
      producer<MT, kW8A8>(maps, p, ring, gate, s, rank, cid, G);
    }
    __syncwarp();
  } else {
    stamp(0);
    Exchange xc{xfull, xempty, s, 0};
    const uint32_t red_u32 = smem_u32(red);
    const float4* red4 = reinterpret_cast<const float4*>(red);
    const uint32_t panel_u32 = smem_u32(smem + L.panel);
    const uint32_t qpanel_u32 = panel_u32;  // y is read no more after phase 1
    const int k_lo = rank * k_slice;
    const int m_pad = p.row_tiles * MT;
    int loads = 0;  // pbar's phases so far
    int acc[NW / 2];     // s32 sums (phases A and B)
    float facc[NW / 2];  // fp32: phase 1's sums, phase B's folded chunk sums
    int it = 0;
    // phase 1: x2 = x + bf16(acc_o s_o + bo), with LN2's partial sums (#6's)
    const Product p0 = product(kW8A8, 0, p);
    for (int rt = 0; rt < p.row_tiles && cid < p0.tiles; ++rt) {
      const int m0 = rt * MT;
      load_panel<MT>(panel_u32, &y_map, k_lo, k_slice, m0, pbar, loads++ & 1);
      const auto epi = [&](int j, int w0, int nw) { epilogue<MT, kProj, true>(p, red4, s, rank, m0, j, w0, nw); };
      for_tiles<MT, true, NW>(facc, p0.tiles, cid, G, k_slice / kBK, ring, BSource{panel_u32, false, 0, 0}, it, xc,
                              red_u32, s, rank, epi);
    }
    stamp(1);
    grid_sync();  // x2 and its partial sums are whole
    stamp(2);
    // LN2 and hq, a row a CTA: every row once, by the same operations
    for (int m = blockIdx.x; m < m_pad; m += gridDim.x) ln_quant_row(p, m, hs);
    fence_async_global();  // hq is read by TMA after the barrier
    stamp(3);
    grid_sync();
    stamp(4);
    // phase A: t = gelu(s32(hq w1^T) hs s1 + b1) in fp32, with the rows' max |t| per tile
    const Product p1 = product(kW8A8, 1, p);
    for (int rt = 0; rt < p.row_tiles && cid < p1.tiles; ++rt) {
      const int m0 = rt * MT;
      load_panel<MT, kBK>(qpanel_u32, &hq_map, k_lo, k_slice, m0, pbar, loads++ & 1);
      for (int m = threadIdx.x; m < MT; m += kConsumers) hs[m] = __ldcg(p.hs + m0 + m);
      consumer_sync();
      const auto loop = [&]() {
        k_loop_s8<MT, NW, false>(acc, facc, k_slice / kBK, ring, qpanel_u32, it, nullptr, 0, 0, 0);
      };
      const auto epi = [&](int j, int w0, int nw) {
        t_epilogue<MT>(p, reinterpret_cast<const int4*>(red), hs, s, rank, m0, j, w0, nw);
      };
      tile_loop<MT, NW>(acc, p1.tiles, cid, G, loop, xc, red_u32, s, rank, epi, 10, rt == 0 ? 3 : 0);
    }
    stamp(5);
    grid_sync();  // t and the rows' tile maxima are whole
    stamp(6);
    quantize_t<MT>(p, s, rank, cid, G);
    fence_async_global();  // tq is read by bulk copies after the barrier
    stamp(7);
    grid_sync();
    if (threadIdx.x == 0) mbar_arrive(gate);
    stamp(8);
    // phase B: out = x2 + bf16(acc s2 + b2), acc the chunks' s32 sums folded with ts_j, tq tiles through the ring
    const Product p2 = product(kW8A8, 2, p);
    for (int rt = 0; rt < p.row_tiles; ++rt) {
      const int m0 = rt * MT;
      const auto loop = [&]() {
        k_loop_s8<MT, NW, true>(acc, facc, p2.k / s / kBK, ring, 0u, it, p.ts + m0, rank * (p2.k / s), p.act_chunk,
                                m_pad);
      };
      const auto epi = [&](int j, int w0, int nw) { epilogue<MT, kOut, true>(p, red4, s, rank, m0, j, w0, nw); };
      tile_loop<MT, NW>(facc, p2.tiles, cid, G, loop, xc, red_u32, s, rank, epi, 0, 0);
    }
    stamp(9);
    xc.finish();  // every CTA has read this one's buffers
  }
  cluster_sync_all();
}

// ---- host side -------------------------------------------------------------

template <int MT>
int launch(const void* const* maps, const Params& p, int cluster, int clusters, int smem, cudaStream_t stream) {
  const int k_slice = p.C / cluster;
  if (cluster < 1 || cluster > kMaxCluster || clusters < 1 || clusters > p.N / kTile || p.stages < kMinStages ||
      p.stages > kMaxStages || k_slice % kBK || (p.N / cluster) % kBK || p.C % kTile || p.N % kTile ||
      p.C > 32 * kConsumers || p.act_chunk <= 0 || p.act_chunk % kBK || p.N % p.act_chunk ||
      w8_layout(MT, k_slice, p.stages).total > smem || smem > kMaxSmem || p.row_tiles * MT < p.M)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem((const void*)w8a8_kernel<MT>, smem);
  if (e != cudaSuccess) return (int)e;
  int most = 0;  // the grid barriers need every CTA resident at once
  e = max_clusters((const void*)w8a8_kernel<MT>, cluster, smem, &most);
  if (e != cudaSuccess) return (int)e;
  if (clusters > most) return (int)cudaErrorCooperativeLaunchTooLarge;
  CUtensorMap t[5];
  for (int i = 0; i < 5; ++i) memcpy(&t[i], maps[i], sizeof(CUtensorMap));
  Params params = p;
  void* args[] = {&t[0], &t[1], &t[2], &t[3], &t[4], &params};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, clusters, smem, stream, attr);
  e = cudaLaunchKernelExC(&cfg, (const void*)w8a8_kernel<MT>, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the row tiles the kernel is built for: N values of the s8 wgmma up to
// kSplitRows, above it twice one (ops/w8a8_kernel.py ROW_TILES)
#define RQ_TILES_W8A8(X) X(8) X(16) X(24) X(32) X(48) X(64) X(96) X(128) X(160) X(192)

}  // namespace

// How many clusters of `cluster` CTAs of the row-tile-`mt` kernel with
// `smem` bytes of shared memory the device holds at once.
extern "C" int rq_dense_w8a8_max_clusters(int mt, int cluster, int smem, int* out) {
#define RQ_CASE(T) \
  case T:          \
    return (int)max_clusters((const void*)w8a8_kernel<T>, cluster, smem, out);
  switch (mt) { RQ_TILES_W8A8(RQ_CASE) }
#undef RQ_CASE
  return (int)cudaErrorInvalidValue;
}

// The W8A8 proj + LN2 + MLP (the source note). x, y, out, x2 (scratch):
// [M, C] bf16, and the tensor map of y in boxes of mt rows; the tensor maps
// of wo [C, C], w1 [H, C], w2 [C, H] (int8) and their bf16 scales wo_s,
// w1_s, w2_s; bo, b2, ln_w, ln_b [C] and b1 [H] bf16; chunk: the hidden
// units of one activation scale (% 64 == 0, dividing H). Scratch, rows =
// row_tiles * mt: hq [rows, C] s8 and its tensor map in boxes of mt rows,
// hs [rows] fp32, tq [H / 64, rows, 64] s8, tf the same in fp32, tmax [H /
// 64, rows] and ts [H / chunk, rows] fp32, stats [M, C / 64, 2] fp32.
// gelu_sigmoid selects t * sigmoid(1.702 t) over the exact erf. One
// persistent launch of `clusters` clusters of `cluster` CTAs, row tiles of
// mt rows (row_tiles * mt >= M), a ring of `stages` stages, `smem` bytes of
// dynamic shared memory (ops/w8a8_kernel.py::w8a8_plan), co-resident or
// refused.
extern "C" int rq_dense_w8a8(const void* x, const void* y, const void* y_map, const void* wo_map, const void* wo_s,
                             const void* bo, const void* ln_w, const void* ln_b, const void* w1_map, const void* w1_s,
                             const void* b1, const void* w2_map, const void* w2_s, const void* b2, void* out, void* x2,
                             void* hq, const void* hq_map, void* hs, void* tq, void* tf, void* tmax, void* ts,
                             void* stats, int M, int C, int H, int chunk, int cluster, int clusters, int mt,
                             int row_tiles, int stages, int smem, int gelu_sigmoid, float eps, void* stream) {
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
  p.hq = static_cast<int8_t*>(hq);
  p.hs = static_cast<float*>(hs);
  p.t = static_cast<bf16*>(tq);
  p.tf = static_cast<float*>(tf);
  p.tmax = static_cast<float*>(tmax);
  p.ts = static_cast<float*>(ts);
  p.stats = static_cast<float2*>(stats);
  p.M = M;
  p.C = C;
  p.N = H;
  p.act_chunk = chunk;
  p.row_tiles = row_tiles;
  p.stages = stages;
  p.gelu_sigmoid = gelu_sigmoid;
  p.eps = eps;
  const void* maps[5] = {wo_map, w1_map, w2_map, y_map, hq_map};
  const cudaStream_t st = (cudaStream_t)stream;
#define RQ_CASE(T) \
  case T:          \
    return launch<T>(maps, p, cluster, clusters, smem, st);
  switch (mt) { RQ_TILES_W8A8(RQ_CASE) }
#undef RQ_CASE
  return (int)cudaErrorInvalidValue;
}

// The globaltimer stamps of the last launch (g_stamps) into out (16 x u64):
// start, phase 1 done, barrier 1 passed, the hq rows done, barrier 2
// passed, phase A done, barrier 3 passed, tq written, barrier 4 passed, end
// (0-9); then the K loop's end and the exchange's opening of phase A's
// first three tiles (10-15).
extern "C" int rq_dense_w8a8_phase_ns(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
