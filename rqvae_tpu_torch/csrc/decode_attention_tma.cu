// Single-token (decode) attention over a KV cache, with the new row written
// or read-only, for the RQ-Transformer on Hopper (sm_90a): the second design
// of the bf16 and int8 attention kernels, each batch row's window staged
// through shared memory by bulk async copies (cp.async.bulk, mbarrier
// completion).
//
// Replaces the TPU kernels of rqvae_tpu/ops/attention_kernel.py:
//   - decode_attention_update (:316; math in _attn_math, :85):
//     rq_attention_tma_update (kQ8 = false, kWrite = true), bf16 cache [B, T, C];
//   - decode_attention_q8_update (:577; math in _attn_math_q8_val, :446):
//     rq_attention_tma_q8_update (kQ8 = true, kWrite = true), int8 cache kq, vq
//     [B, T, C] with a bf16 scale per (row, head) in ks, vs [B, T, n_head];
//   - decode_attention (:209) and decode_attention_stacked (:149, the same
//     on layer l's base pointer of an [L, B, T, C] stack): rq_attention_tma_read
//     (kQ8 = false, kWrite = false);
//   - decode_attention_q8 (:830): rq_attention_tma_q8_read (kQ8 = true,
//     kWrite = false).
// The first design of all four (csrc/decode_attention.cu,
// decode_attention_q8.cu) stays as the A/B baseline.
//
// What it computes, for batch row b and head h (head size hs = C / n_head,
// 64 or 104), n_valid = min(cur_len, window):
//   bf16: s_t = <q, k_t> / sqrt(hs) (fp32), t < n_valid, and s_self from
//         k_new; p = softmax(s) in fp32; y = sum_t p_t v_t + p_self v_new in
//         fp32, one cast to bf16;
//   int8: s_t = sum_i bf16(kq[t, i] q[i]) ks_t / sqrt(hs) (fp32 sums),
//         s_self = sum_i bf16(k_new[i] q[i]) / sqrt(hs); e = exp(s - max),
//         denom = sum e; w_t = bf16((e_t / denom) vs_t); y = sum_t
//         bf16(vq[t, i] w_t) + v_new[i] e_self / denom. w_t needs the final
//         denominator, so the softmax is explicit (no online rescaling) in
//         both kernels: one code path, two passes over the window.
// With kWrite, row cur_len (< T) is then set to k_new / v_new (bf16), or to
// their per-head quantization (int8): scale = max(absmax / 127, 1e-8) in
// fp32, q = round-half-even(x / scale) with IEEE division, the scale stored
// as bf16, bit-equal to ops/attention_kernel.py::quantize_kv. Without it the
// caches are only read, and cur_len may reach T.
//
// Bound on the H100: cache bytes, 2 B n_valid C (int8) or twice that (bf16)
// against a few operations per byte: at B 100, C 1536, cur_len 63, 6.4 us
// (int8) and 12.1 us (bf16) at 3.35 TB/s; at the f16 stacked sampler's
// longest window (cur_len 256), 47.3 us (bf16).
//
// Design. For batch row b, rows [0, n_valid) of k_cache[b] are one
// contiguous run, and a head group's columns of one row are one contiguous
// piece. The work is B x groups units (batch row b, head group g of hpc =
// n_head / groups heads), taken round-robin by a persistent grid of `ctas`
// CTAs (a few per SM): CTA c takes units c, c + ctas, ... A producer warp
// streams the CTA's whole sequence of windows, unit after unit, through a
// ring of `stages` shared-memory stages of `rows` cache rows: for each unit
// its K chunks, then its V chunks, each one bulk copy (a whole group: rows
// x C contiguous bytes) or one bulk copy per cache row (the group's piece),
// completing on the stage's full mbarrier; it refills a stage once each of
// the 8 consumer warps has arrived on its empty mbarrier. So the copies run
// ahead into V and into the next unit while the consumers compute, the
// consumers never wait for a copy to be issued, and no cache byte passes
// through registers before it is used. A bulk copy of a few hundred bytes
// costs its SM about as much as a large one (36 ns measured on the H100,
// PERF.md), so the plan prefers few groups (large pieces; whole rows at
// one group), and the producer's 32 lanes issue a chunk's row copies.
// The 256 consumer threads map onto the rows in flight: a team of 8 lanes
// (16 at head size 104, 13 of them holding 8 columns each) per head, hpc
// teams per row, 256 / (8 or 16 hpc) rows at once; each lane takes a
// partial dot of 8 (16) rows of its slot, a butterfly over the team leaves
// each lane one row's score, and each thread keeps its 8 q values and 8 y
// sums in registers. What a unit needs besides the window (q, k_new,
// v_new, the int8 scales) is loaded into registers during the previous
// unit; the new row (kWrite) is written at the unit's start, while its
// first chunk is in flight. Between the passes a team of 8-32 lanes per
// head takes the head's max, denominator and every row's weight (at int8
// the bf16 w_t) over the scores in shared memory. The int8 products are
// bf16x2 multiplies of int8 pairs widened to bf16 without conversion
// instructions (exact), each product rounded to bf16 as the JAX kernel
// rounds it, summed in fp32. The launch plan (groups, rows, stages, ctas)
// comes from ops/attention_kernel.py::attention_plan, which mirrors
// tma_layout below. The window's scores (at int8 also its scales) live in
// shared memory: the update form takes windows of up to 512 rows, the
// read-only form any window whose scores one head group's CTA holds (at
// int8 also whose scales its threads hold), so the stacked sampler's T =
// cond_len + H W, up to 1024 positions, included.
//
// Alignment. Bulk copies take 16-byte addresses and sizes: C x (element
// bytes) and a group's piece hpc x hs x (element bytes) must be multiples of
// 16, every pointer 16-byte aligned. bf16 at head size 64 or 104 and int8 at
// 64 always are; int8 at head size 104 needs an even head count per group,
// and the wrapper raises ValueError for an odd n_head (C 1560 B a row) before
// the launch; there is no tail path.
//
// Races: a CTA reads only cache rows < n_valid <= cur_len; row cur_len (and
// its scales) of a unit's heads is written (kWrite) only by the CTA that
// takes the unit, each head's slice by one team. So reads and the write
// never touch the same bytes, and no two CTAs write the same bytes. The
// read-only form writes y alone.

#include "decode_dense.cuh"  // bf16, kConsumers / kThreads, barriers, bulk copies, widen4, stamps

namespace {

constexpr int kVals = 8;        // cache values per lane: 16 bytes of bf16, 8 of int8
constexpr int kMaxScales = 8;   // int8 scales of a unit a consumer thread holds: rows x hpc <= 8 x 256
constexpr int kRedFloats = 2;   // per head: the self score and its weight p_self

__host__ __device__ inline int round_up(int v, int a) { return (v + a - 1) / a * a; }

// lanes of one head's team: 8 at head size 64, 16 at 104 (13 active)
__host__ __device__ inline int team_lanes(int hs) { return hs <= 64 ? 8 : 16; }

// Offsets in dynamic shared memory (ops/attention_kernel.py::_tma_smem
// mirrors `total`).
struct TmaLayout {
  int stage_bytes;  // `rows` pieces of `piece` bytes, 128-byte aligned
  int bars;         // full[stages], then empty[stages] mbarriers
  int ypart;        // float [n_sub][cols]: the partial y sums, after the V pass, where the scores were
  int scores;       // float [window][hpc]: (int8: the K scales,) the scores, e, the weights
  int vscale;       // float [window][hpc] (int8)
  int red;          // float [kRedFloats][hpc]
  int total;
};

__host__ __device__ inline TmaLayout tma_layout(int piece, int hpc, int window, int rows, int stages, bool q8) {
  TmaLayout L;
  L.stage_bytes = round_up(rows * piece, 128);
  L.bars = stages * L.stage_bytes;
  L.ypart = round_up(L.bars + 2 * stages * 8, 16);
  L.scores = L.ypart;  // the weights are read for the last time in the V pass, before y
  const int per_row = round_up(window * hpc * 4, 16);
  L.vscale = L.scores + max(per_row, kConsumers * kVals * 4);
  L.red = L.vscale + (q8 ? per_row : 0);
  L.total = L.red + round_up(kRedFloats * hpc * 4, 16);
  return L;
}

struct TmaParams {
  const bf16* q;
  const bf16* k_new;
  const bf16* v_new;
  unsigned char* kc;  // [B, T, C] bf16 or int8
  unsigned char* vc;
  bf16* ks;  // [B, T, n_head] (int8 cache)
  bf16* vs;
  bf16* y;
  int T, C, n_head, window, n_valid, cur_len;
  int groups, hpc, rows, stages, units;
  int probe;  // 1: the copies and the ring alone, nothing computed or written (a measurement)
  float scale;
};

// the sum (max) over one head's team of kLanes lanes (aligned in the warp)
template <int kLanes>
__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int kLanes>
__device__ __forceinline__ float team_max(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The K pass's butterfly over a team: lane l holds partial sums of the
// team's kLanes rows in part[]; after the folds at offsets O, O / 2, .., 1
// part[0] of lane l is row l's whole sum. Each fold keeps the half of the
// rows its side of offset O owns and adds the other side's. (A template, so
// that every loop bound is a constant and part[] stays in registers.)
template <int O, int N>
__device__ __forceinline__ void fold(float (&part)[N], int l) {
  if constexpr (O >= 1) {
    const bool upper = l & O;
#pragma unroll
    for (int j = 0; j < O; ++j) {
      const float send = upper ? part[j] : part[j + O];
      const float keep = upper ? part[j + O] : part[j];
      part[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    fold<O / 2>(part, l);
  }
}

// the two bf16 of a pair as floats (exact: a bf16 is the upper half of its float)
__device__ __forceinline__ float lo_f32(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f32(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// sum over 8 products of bf16 pairs a[i] * b[i], each product rounded to
// bf16 (the JAX kernel's bf16 multiply), summed in fp32
__device__ __forceinline__ float dot_bf16_rounded(const uint32_t (&a)[4], const uint32_t (&b)[4]) {
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t m = bf16x2_mul(a[i], b[i]);
    d += lo_f32(m) + hi_f32(m);
  }
  return d;
}

// <x, q> over this lane's 8 values (bf16 pairs x): fp32 products (bf16
// cache), or each product rounded to bf16 (int8 cache)
template <bool kQ8>
__device__ __forceinline__ float dot8(const uint32_t (&x)[4], const uint32_t (&qw)[4], const float (&qf)[kVals]) {
  if constexpr (kQ8) {
    return dot_bf16_rounded(x, qw);
  } else {
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) d += lo_f32(x[j]) * qf[2 * j] + hi_f32(x[j]) * qf[2 * j + 1];
    return d;
  }
}

// eight int8 values (the bytes of u) as four exact bf16 pairs (widen4)
__device__ __forceinline__ void widen8(uint2 u, uint32_t (&w)[4]) {
  widen4(u.x, w[0], w[1]);
  widen4(u.y, w[2], w[3]);
}

__device__ __forceinline__ void words(uint4 u, uint32_t (&w)[4]) {
  w[0] = u.x;
  w[1] = u.y;
  w[2] = u.z;
  w[3] = u.w;
}

// one head's new row quantized as quantize_kv does: the team's absmax, scale
// = max(absmax / 127, 1e-8) and round-half-even(x / scale) with IEEE
// division; this lane's 8 values to q (when `store`), the scale as bf16 to
// *s (when `store_scale`)
template <int kLanes>
__device__ __forceinline__ void quantize8(const float (&x)[kVals], bool store, bool store_scale, unsigned char* q,
                                          bf16* s) {
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < kVals; ++i) a = fmaxf(a, fabsf(x[i]));
  const float sc = fmaxf(team_max<kLanes>(a) / 127.0f, 1e-8f);
  if (store) {
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < kVals; ++i) w[i / 4] |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(x[i] / sc) << (8 * (i % 4));
    *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[1]);
  }
  if (store_scale) *s = __float2bfloat16_rn(sc);
}

// 16 bytes at p, or zeros
__device__ __forceinline__ uint4 load16(const bf16* p, bool on) {
  return on ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

// this consumer thread's K and V scales (bf16 bits) of unit u: entries at
// = tid + j kConsumers of the unit's [n_valid][hpc] scales
template <int N>
__device__ __forceinline__ void load_scales(const TmaParams& p, int u, int n_scales, unsigned short (&ksr)[N],
                                            unsigned short (&vsr)[N]) {
  const size_t s0 = (size_t)(u / p.groups) * p.T * p.n_head + (size_t)(u % p.groups) * p.hpc;
  const unsigned short* ks = reinterpret_cast<const unsigned short*>(p.ks);
  const unsigned short* vs = reinterpret_cast<const unsigned short*>(p.vs);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int at = threadIdx.x + j * kConsumers;
    const size_t src = s0 + (size_t)(at / p.hpc) * p.n_head + at % p.hpc;
    ksr[j] = at < n_scales ? ks[src] : 0;
    vsr[j] = at < n_scales ? vs[src] : 0;
  }
}

// the producer warp: the CTA's chunks in order, chunk c (unit c / (2 nck);
// its K chunks, then its V chunks) into stage c % stages once the consumers
// have freed it; lane 0 arms the stage's full barrier, the lanes issue its
// row copies in turn (a whole group's rows: one copy, by lane 0)
__device__ __forceinline__ void produce(const TmaParams& p, uint32_t ring, uint32_t full, uint32_t empty,
                                        int stage_bytes, int piece, int row_bytes, int nck, int n_chunks) {
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % p.stages;
    if (c >= p.stages) mbar_wait(empty + 8 * s, (c / p.stages - 1) & 1);
    const int u = blockIdx.x + (c / (2 * nck)) * gridDim.x;
    const int k = c % (2 * nck);
    const bool v = k >= nck;
    const int r0 = (v ? k - nck : k) * p.rows;
    const int nr = min(p.rows, p.n_valid - r0);
    const uint32_t dst = ring + s * stage_bytes;
    const unsigned char* src =
        (v ? p.vc : p.kc) + ((size_t)(u / p.groups) * p.T + r0) * row_bytes + (size_t)(u % p.groups) * piece;
    if (lane == 0) mbar_expect_tx(full + 8 * s, nr * piece);
    __syncwarp();  // the stage is armed before any of its copies is issued
    if (piece == row_bytes) {
      if (lane == 0) bulk_copy(dst, src, nr * piece, full + 8 * s);  // the whole rows: one contiguous run
    } else {
      for (int r = lane; r < nr; r += 32)
        bulk_copy(dst + r * piece, src + (size_t)r * row_bytes, piece, full + 8 * s);
    }
  }
}

template <bool kQ8, bool kWrite, int kHeadSize>
__global__ void __launch_bounds__(kThreads, 2) attention_tma_kernel(TmaParams p) {
  constexpr int kLanes = kHeadSize <= 64 ? 8 : 16;  // team_lanes(kHeadSize)
  constexpr int kActive = kHeadSize / kVals;        // lanes of a team that hold columns
  constexpr int kBytes = kQ8 ? 1 : 2;
  static_assert(kHeadSize % kVals == 0 && kActive <= kLanes, "8 columns per lane, one team per head");
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int hpc = p.hpc;
  const int cols = hpc * kHeadSize;
  const int piece = cols * kBytes;
  const TmaLayout L = tma_layout(piece, hpc, p.window, p.rows, p.stages, kQ8);
  float* ypart = reinterpret_cast<float*>(smem + L.ypart);
  float* scores = reinterpret_cast<float*>(smem + L.scores);
  float* vscale = reinterpret_cast<float*>(smem + L.vscale);
  float* self_s = reinterpret_cast<float*>(smem + L.red);  // the self score per head
  float* p_self = self_s + hpc;                              // its weight e_self / denom
  const uint32_t full = smem_u32(smem + L.bars);
  const uint32_t empty = full + 8 * p.stages;

  const int nck = (p.n_valid + p.rows - 1) / p.rows;  // chunks per pass
  const int n_units = blockIdx.x < p.units ? (p.units - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int n_chunks = n_units * 2 * nck;

  stamp(0);
  if (blockIdx.x == 0 && tid == 0) g_stamps[8] = 0;  // the last CTA to finish sets it
  if (tid == 0) {  // full: the producer's arrival; empty: one arrival per consumer warp
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid >= kConsumers) {
    produce(p, smem_u32(smem), full, empty, L.stage_bytes, piece, p.C * kBytes, nck, n_chunks);
    return;
  }

  // chunk c: wait for it; every warp frees its stage once done with it
  auto chunk_in = [&](int c) -> const unsigned char* {
    mbar_wait(full + 8 * (c % p.stages), (c / p.stages) & 1);
    return smem + (c % p.stages) * L.stage_bytes;
  };
  auto chunk_done = [&](int c) {
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty + 8 * (c % p.stages));
  };

  // this thread: row slot `sub` of n_sub, head hh of the group, lane l of its team
  const int tpr = hpc * kLanes;
  const int n_sub = kConsumers / tpr;
  const int sub = tid / tpr;
  const int hh = (tid % tpr) / kLanes;
  const int l = tid % kLanes;
  const bool active = sub < n_sub && l < kActive;
  const bool lead = sub == 0;                  // the team that holds k_new / v_new (and writes row cur_len)
  const bool lead_warp = (tid & ~31) < tpr;   // a warp with lead threads (warp-uniform)
  const int col0 = hh * kHeadSize + l * kVals;  // in the group's columns
  auto io = [&](int u) {  // this lane's first column of unit u in a [B, C] row
    return (size_t)(u / p.groups) * p.C + (size_t)(u % p.groups) * cols + col0;
  };
  int sl = 32;  // the softmax's lanes per head
  while (sl > 1 && sl * hpc > kConsumers) sl >>= 1;
  const int n_scales = p.n_valid * hpc;

  // what unit i + 1 needs, loaded during unit i (unit 0's here)
  uint4 q_raw = load16(p.q + io(blockIdx.x), active && n_units > 0);
  uint4 kn = load16(p.k_new + io(blockIdx.x), lead && active && n_units > 0);
  uint4 vn = load16(p.v_new + io(blockIdx.x), lead && active && n_units > 0);
  unsigned short ksr[kQ8 ? kMaxScales : 1], vsr[kQ8 ? kMaxScales : 1];  // bf16 bits
  if constexpr (kQ8) {
    if (n_units > 0) load_scales(p, blockIdx.x, n_scales, ksr, vsr);
  }

  for (int i = 0; i < n_units; ++i) {
    const int u = blockIdx.x + i * gridDim.x;
    const int b = u / p.groups, g = u % p.groups;
    const int c0 = i * 2 * nck;
    uint32_t qw[4];
    words(q_raw, qw);
    float qf[kVals];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      qf[2 * j] = lo_f32(qw[j]);
      qf[2 * j + 1] = hi_f32(qw[j]);
    }

    // the self score and (kWrite) the new row cur_len (the lead teams), and
    // the unit's int8 scales, while its first chunk is in flight
    if (!p.probe) {
      if (lead_warp) {
        uint32_t kw[4];
        words(kn, kw);
        const float d = team_sum<kLanes>(dot8<kQ8>(kw, qw, qf));
        if (lead && l == 0) self_s[hh] = d * p.scale;
        if constexpr (kWrite) {
          const size_t dst_row = ((size_t)b * p.T + p.cur_len) * p.C + (size_t)g * cols + col0;
          if constexpr (kQ8) {
            uint32_t vw[4];
            words(vn, vw);
            float kf[kVals], vf[kVals];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              kf[2 * j] = lo_f32(kw[j]);
              kf[2 * j + 1] = hi_f32(kw[j]);
              vf[2 * j] = lo_f32(vw[j]);
              vf[2 * j + 1] = hi_f32(vw[j]);
            }
            const size_t dst_s = ((size_t)b * p.T + p.cur_len) * p.n_head + (size_t)g * hpc + hh;
            quantize8<kLanes>(kf, lead && active, lead && l == 0, p.kc + dst_row, p.ks + dst_s);
            quantize8<kLanes>(vf, lead && active, lead && l == 0, p.vc + dst_row, p.vs + dst_s);
          } else if (lead && active) {
            *reinterpret_cast<uint4*>(p.kc + dst_row * 2) = kn;
            *reinterpret_cast<uint4*>(p.vc + dst_row * 2) = vn;
          }
        }
      }
      if constexpr (kQ8) {  // the K scales where the scores go, each score's lane scales it
#pragma unroll
        for (int j = 0; j < kMaxScales; ++j) {
          const int at = tid + j * kConsumers;
          if (at < n_scales) {
            scores[at] = __uint_as_float((uint32_t)ksr[j] << 16);
            vscale[at] = __uint_as_float((uint32_t)vsr[j] << 16);
          }
        }
        consumer_sync();
      }
    }

    // K pass: scores[t][hh] = <q, k_t> (times 1 / sqrt(hs) at bf16). A team
    // takes kLanes of its row slot's rows at once, each lane a partial dot
    // of each, and a butterfly over the team leaves lane j with row j's sum
    for (int k = 0; k < nck; ++k) {
      const unsigned char* st = chunk_in(c0 + k);
      if (i == 0 && k == 0) stamp(1);
      if (!p.probe) {
        const int r0 = k * p.rows;
        const int nr = min(p.rows, p.n_valid - r0);
        for (int rr0 = 0; rr0 < nr; rr0 += n_sub * kLanes) {
          float part[kLanes];
#pragma unroll
          for (int j = 0; j < kLanes; ++j) {
            const int rr = rr0 + sub + n_sub * j;
            part[j] = 0.f;
            if (active && rr < nr) {
              const unsigned char* x = st + (size_t)rr * piece + col0 * kBytes;
              uint32_t xw[4];
              if constexpr (kQ8) {
                widen8(*reinterpret_cast<const uint2*>(x), xw);
              } else {
                words(*reinterpret_cast<const uint4*>(x), xw);
              }
              part[j] = dot8<kQ8>(xw, qw, qf);
            }
          }
          fold<kLanes / 2>(part, l);
          const int rr = rr0 + sub + n_sub * l;
          if (sub < n_sub && rr < nr) {
            float* sc = scores + (r0 + rr) * hpc + hh;
            *sc = kQ8 ? part[0] * *sc * p.scale : part[0] * p.scale;
          }
        }
      }
      chunk_done(c0 + k);
    }
    if (i == 0) stamp(2);
    if (p.probe) {
      for (int k = 0; k < nck; ++k) {
        chunk_in(c0 + nck + k);
        chunk_done(c0 + nck + k);
      }
      continue;
    }
    if (i + 1 < n_units) q_raw = load16(p.q + io(u + gridDim.x), active);
    consumer_sync();  // the scores, the scales and the self scores
    if (i == 0) stamp(3);

    // a team of sl lanes per head (a power of two, as many as fill the
    // consumers): its max, e, denominator, and every row's weight
    for (int h0 = 0; h0 < hpc; h0 += kConsumers / sl) {
      const int h = h0 + tid / sl;
      const bool on = h < hpc;
      const int j = tid % sl;
      float m = on ? self_s[h] : 0.f;
      for (int t = j; on && t < p.n_valid; t += sl) m = fmaxf(m, scores[t * hpc + h]);
      for (int o = sl / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
      for (int t = j; on && t < p.n_valid; t += sl) {
        const float e = expf(scores[t * hpc + h] - m);
        scores[t * hpc + h] = e;
        sum += e;
      }
      for (int o = sl / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float e_self = on ? expf(self_s[h] - m) : 0.f;
      const float den = sum + e_self;
      const float inv = 1.f / den;
      for (int t = j; on && t < p.n_valid; t += sl) {
        const float e = scores[t * hpc + h];
        scores[t * hpc + h] = kQ8 ? round_bf16((e / den) * vscale[t * hpc + h]) : e * inv;
      }
      if (on && j == 0) p_self[h] = kQ8 ? e_self / den : e_self * inv;
    }
    consumer_sync();
    if (i == 0) stamp(4);

    // V pass: this thread's 8 columns of y over its rows, the self term on
    // the lead teams
    float acc[kVals];
    {
      uint32_t vw[4];
      words(vn, vw);
      const float ps = lead ? p_self[hh] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[2 * j] = lo_f32(vw[j]) * ps;
        acc[2 * j + 1] = hi_f32(vw[j]) * ps;
      }
    }
    if (i + 1 < n_units) {  // the next unit's k_new, v_new and scales
      kn = load16(p.k_new + io(u + gridDim.x), lead && active);
      vn = load16(p.v_new + io(u + gridDim.x), lead && active);
      if constexpr (kQ8) load_scales(p, u + gridDim.x, n_scales, ksr, vsr);
    }
    for (int k = 0; k < nck; ++k) {
      const unsigned char* st = chunk_in(c0 + nck + k);
      const int r0 = k * p.rows;
      const int nr = min(p.rows, p.n_valid - r0);
#pragma unroll 4
      for (int rr0 = 0; rr0 < nr; rr0 += n_sub) {
        const int rr = rr0 + sub;
        if (active && rr < nr) {
          const float w = scores[(r0 + rr) * hpc + hh];
          const unsigned char* x = st + (size_t)rr * piece + col0 * kBytes;
          uint32_t xw[4];
          if constexpr (kQ8) {
            widen8(*reinterpret_cast<const uint2*>(x), xw);
            const uint32_t ww = __float_as_uint(w) >> 16 | (__float_as_uint(w) & 0xffff0000u);  // (w, w), bf16
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint32_t m = bf16x2_mul(xw[j], ww);
              acc[2 * j] += lo_f32(m);
              acc[2 * j + 1] += hi_f32(m);
            }
          } else {
            words(*reinterpret_cast<const uint4*>(x), xw);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[2 * j] += w * lo_f32(xw[j]);
              acc[2 * j + 1] += w * hi_f32(xw[j]);
            }
          }
        }
      }
      chunk_done(c0 + nck + k);
    }
    if (i == 0) stamp(5);

    // y: the partial sums of the row slots, where the weights were (every
    // warp done with them first)
    consumer_sync();
    if (active) {
#pragma unroll
      for (int j = 0; j < kVals; ++j) ypart[sub * cols + col0 + j] = acc[j];
    }
    consumer_sync();
    bf16* yrow = p.y + (size_t)b * p.C + (size_t)g * cols;
    for (int col = tid; col < cols; col += kConsumers) {
      float s = 0.f;
      for (int w = 0; w < n_sub; ++w) s += ypart[w * cols + col];
      yrow[col] = __float2bfloat16_rn(s);
    }
    consumer_sync();  // y read from ypart before the next unit's scores go there
    if (i == 0) stamp(6);
  }
  stamp(7);
  if (tid == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    atomicMax(&g_stamps[8], t);
  }
}

template <bool kQ8, bool kWrite, int kHeadSize>
int launch_tma(const TmaParams& params, int ctas, int smem, cudaStream_t stream) {
  static bool allowed = false;
  const void* kernel = (const void*)attention_tma_kernel<kQ8, kWrite, kHeadSize>;
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  TmaParams p = params;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchKernel(kernel, dim3(ctas), dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the shared-memory bytes of a plan; -1 for a plan outside the kernel's
// contract (a head size other than 64 / 104, a group whose team rows exceed
// the consumers, copies off 16 bytes, no row or stage, more int8 scales in
// a unit than its threads hold)
int plan_smem(int C, int n_head, int q8, int window, int groups, int rows, int stages) {
  if (n_head <= 0 || C % n_head || groups <= 0 || n_head % groups) return -1;
  const int hs = C / n_head, hpc = n_head / groups, eb = q8 ? 1 : 2;
  if ((hs != 64 && hs != 104) || hpc * team_lanes(hs) > kConsumers || (C * eb) % 16 || (hpc * hs * eb) % 16 ||
      rows < 1 || stages < 1 || window < 0)
    return -1;
  if (q8 && window * hpc > kMaxScales * kConsumers) return -1;
  const int total = tma_layout(hpc * hs * eb, hpc, window, rows, stages, q8 != 0).total;
  return total <= kMaxSmem ? total : -1;
}

template <bool kQ8, bool kWrite>
int launch(const TmaParams& base, int B, int groups, int rows, int stages, int ctas, cudaStream_t stream) {
  const int smem = plan_smem(base.C, base.n_head, kQ8, base.window, groups, rows, stages);
  if (smem < 0 || B < 1 || base.window > base.T || base.cur_len < 0 || (kWrite && base.cur_len >= base.T) ||
      ctas < 1)
    return (int)cudaErrorInvalidValue;
  TmaParams p = base;
  const int hs = p.C / p.n_head;
  p.groups = groups;
  p.hpc = p.n_head / groups;
  p.rows = rows;
  p.stages = stages;
  p.units = B * groups;
  p.n_valid = min(p.cur_len, p.window);
  p.scale = 1.0f / sqrtf((float)hs);
  return hs == 64 ? launch_tma<kQ8, kWrite, 64>(p, ctas, smem, stream)
                  : launch_tma<kQ8, kWrite, 104>(p, ctas, smem, stream);
}

TmaParams base_params(const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache, void* y,
                      int T, int C, int n_head, int window, int cur_len, int probe) {
  TmaParams p = {};
  p.q = static_cast<const bf16*>(q);
  p.k_new = static_cast<const bf16*>(k_new);
  p.v_new = static_cast<const bf16*>(v_new);
  p.kc = static_cast<unsigned char*>(k_cache);
  p.vc = static_cast<unsigned char*>(v_cache);
  p.y = static_cast<bf16*>(y);
  p.T = T;
  p.C = C;
  p.n_head = n_head;
  p.window = window;
  p.cur_len = cur_len;
  p.probe = probe;
  return p;
}

}  // namespace

// q, k_new, v_new, y: [B, C] bf16; k_cache, v_cache: [B, T, C] bf16; all
// contiguous and 16-byte aligned. C / n_head is 64 or 104. Attends rows <
// min(cur_len, window) (window <= T) and writes row cur_len (< T), on the
// launch plan (groups, rows, stages, ctas) of attention_plan; probe 1
// streams the windows through the ring and computes and writes nothing (a
// measurement of the copies alone). Returns the launch's cudaError_t,
// cudaErrorInvalidValue for a plan outside the contract, or
// cudaGetLastError() after the launch.
extern "C" int rq_attention_tma_update(const void* q, const void* k_new, const void* v_new, void* k_cache,
                                       void* v_cache, void* y, int B, int T, int C, int n_head, int window,
                                       int cur_len, int groups, int rows, int stages, int ctas, int probe,
                                       void* stream) {
  const TmaParams p = base_params(q, k_new, v_new, k_cache, v_cache, y, T, C, n_head, window, cur_len, probe);
  return launch<false, true>(p, B, groups, rows, stages, ctas, (cudaStream_t)stream);
}

// The read-only form: the same attention, the caches only read, cur_len
// any row count (n_valid = min(cur_len, window)).
extern "C" int rq_attention_tma_read(const void* q, const void* k_new, const void* v_new, const void* k_cache,
                                     const void* v_cache, void* y, int B, int T, int C, int n_head, int window,
                                     int cur_len, int groups, int rows, int stages, int ctas, int probe,
                                     void* stream) {
  const TmaParams p = base_params(q, k_new, v_new, const_cast<void*>(k_cache), const_cast<void*>(v_cache), y, T, C,
                                  n_head, window, cur_len, probe);
  return launch<false, false>(p, B, groups, rows, stages, ctas, (cudaStream_t)stream);
}

// The int8 cache: kq, vq [B, T, C] int8, ks, vs [B, T, n_head] bf16, the
// rest as rq_attention_tma_update; row cur_len of all four is written.
extern "C" int rq_attention_tma_q8_update(const void* q, const void* k_new, const void* v_new, void* kq, void* ks,
                                          void* vq, void* vs, void* y, int B, int T, int C, int n_head, int window,
                                          int cur_len, int groups, int rows, int stages, int ctas, int probe,
                                          void* stream) {
  TmaParams p = base_params(q, k_new, v_new, kq, vq, y, T, C, n_head, window, cur_len, probe);
  p.ks = static_cast<bf16*>(ks);
  p.vs = static_cast<bf16*>(vs);
  return launch<true, true>(p, B, groups, rows, stages, ctas, (cudaStream_t)stream);
}

// The read-only int8 form.
extern "C" int rq_attention_tma_q8_read(const void* q, const void* k_new, const void* v_new, const void* kq,
                                        const void* ks, const void* vq, const void* vs, void* y, int B, int T, int C,
                                        int n_head, int window, int cur_len, int groups, int rows, int stages,
                                        int ctas, int probe, void* stream) {
  TmaParams p = base_params(q, k_new, v_new, const_cast<void*>(kq), const_cast<void*>(vq), y, T, C, n_head, window,
                            cur_len, probe);
  p.ks = static_cast<bf16*>(const_cast<void*>(ks));
  p.vs = static_cast<bf16*>(const_cast<void*>(vs));
  return launch<true, false>(p, B, groups, rows, stages, ctas, (cudaStream_t)stream);
}

// The shared-memory bytes of a plan (what the launch requests), or -1 for
// a plan the kernels do not take: the check that the Python mirror
// (ops/attention_kernel.py::_tma_smem) agrees with tma_layout.
extern "C" int rq_attention_tma_smem(int C, int n_head, int q8, int window, int groups, int rows, int stages) {
  return plan_smem(C, n_head, q8, window, groups, rows, stages);
}

// The globaltimer stamps (ns) of the last launch, into host memory out[16]:
// consumer thread 0 of CTA 0 at its start, at its first chunk, after its
// first unit's K pass, self term (and row write), softmax, V pass and y, at
// its end; [8] the last CTA's end. Synchronous.
extern "C" int rq_attention_tma_phase_ns(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
