// The decode MLP alone on Hopper (sm_90a), one persistent launch per call,
// on the machinery of csrc/decode_dense.cu (decode_dense.cuh), in two forms:
//
//   kMlp (#15, bf16 weights; LN's scale and bias fp32):
//     h   = bf16(LN(x))                          (one-pass fp32 statistics)
//     t   = bf16(gelu(h @ w1^T + b1))            (fp32 sums, gelu v1 erf or v2 sigmoid)
//     out = bf16((x + acc) + b2),  acc = t @ w2^T in fp32, rounded once
//   kRing (#20, int8 or bf16 weights; no LN, bias or residual):
//     t   = bf16(gelu?(acc_1 * s1?)),  acc_1 = h @ w1^T in fp32 (h = x as given)
//     out = bf16(acc_2),  acc_2 = t @ w2^T in fp32 (w2's scale never read)
//
// Replace tools/exp_mlp_kernel.py::pallas_mlp (:75, kernel :43-72) and
// tools/exp_q8_pipeline.py::ablate_ring (:379, kernel :333-373). Their first
// designs (csrc/mlp.cu::rq_mlp; the MLP-only form of
// csrc/q8_pipeline.cu::rq_q8_ring_mlp: a cooperative launch of one block an
// SM, a cp.async ring of each block's 8-row weight tiles, mma.sync with the
// activations read from L2 by every block, a grid barrier per chunk) stay
// as the A/B baselines that only chip_smoke.py runs. Weights in the port's
// nn.Linear layout: w1 [H, C], w2 [C, H]; #20's packed w1 [nc, chunk, C]
// has the bytes of [H, C], and its packed w2 [nc, C, chunk] is read through
// a tensor map of the matrix [nc * C, chunk]: the 64 x 64 tile of w2's
// output channels c .. c + 63 and reduction elements k .. k + 63 sits at
// (column k mod chunk, row (k div chunk) * C + c), whole when chunk % 64 ==
// 0 (ops/dense_mlp_kernel.py::w2_coords).
//
// Bound on the H100: at B 100, C 1536, H 6144 weight bytes (37.7 MB bf16,
// 0.0113 ms at 3.35 TB/s; 18.9 MB int8, 0.0056 ms); at B 500 operations
// (2 B 2 C H = 18.9 GFLOP, 0.0191 ms at 989 TFLOP/s).
//
// Design: decode_dense.cu's fused_proj_mlp without its wo product and first
// grid barrier: two products split by one grid barrier.
// - Phase A (w1): each CTA stages its K-slice of x's row tile into the panel
//   by TMA; #15 takes the one-pass row statistics through the cluster
//   exchange (each CTA pushes its slice's (sum, sum of squares) of every
//   row to the cluster, every CTA sums them in rank order), normalises the
//   slice in place with the fp32 scale and bias and casts to bf16; #20 uses
//   the panel as given. wgmma with the w1 tile as A (TMA ring, one producer
//   warp), split-K over C in the cluster, the partial tiles reduced in
//   distributed shared memory in rank order; the epilogue writes t already
//   in the swizzled [H / 64, rows, 64] image of a wgmma B tile.
// - One grid barrier (every CTA co-resident, checked at launch; this
//   library's own counters: one launch of it at a time per device).
// - Phase B (w2): split-K over H in the cluster; each unit (weight tile, K
//   chunk) brings its t tile by one bulk copy.
// Rows: the plan (ops/dense_mlp_kernel.py::mlp_plan) takes the fewest row
// tiles of up to 256 rows that shared memory holds, so B 500 streams the
// weights twice (128-row tiles: four times). A 256-row tile at cluster 8
// needs a 96 KB panel and a 68 KB reduction buffer, which leave no room for
// a ring stage of a weight tile and a 32 KB t tile: the t tiles of phase B
// therefore take the panel's bytes, idle once phase A is done, in `t_slots`
// slots of their own (at least 2, at most the ring's stages). The ring
// holds weight tiles alone; the producer issues the t copy of phase-B unit
// u into slot u mod t_slots once unit u - t_slots has been released, and
// defers the copies of the first t_slots units until the consumers have
// passed the grid barrier (the panel is free and t complete). Row tiles
// above 160 rows are split between the two consumer warpgroups (halves): a
// 256-row tile on one warpgroup would hold 128 fp32 accumulators a thread,
// more than the 168 registers that nine warps leave a thread. chip_smoke.py
// (check_mlp, B 500) times the plan of 256-row tiles against the plan the
// planner makes of 128-row tiles alone (four passes; PERF.md, row 15).
// What holds B 500 back: each 256-row tile's split-K partials (64 KB a CTA)
// cross the cluster's shared memory, 14 tiles a CTA in phase A, and every
// cluster re-reads t for each of its w2 tiles in phase B (24 x 6.3 MB).
//
// CTA 0's consumer thread 0 stamps the globaltimer at the start, when the
// first row tile's panel has landed, its LN statistics are exchanged and it
// is normalised, at the end of phase A, after the grid barrier and at the
// end, and at the K loop's end and the exchange's opening of phase A's
// first three tiles and phase B's first (rq_dense_mlp_phase_ns).

#include "decode_dense.cuh"

namespace {

enum Form { kMlp = 0, kRing = 1 };

struct MlpParams {
  const bf16* x;       // [M, C]: LN's input and the residual (kMlp), h (kRing)
  const float* ln_w;   // [C] fp32 (kMlp)
  const float* ln_b;
  const bf16* b1;      // [H] (kMlp)
  const bf16* b2;      // [C] (kMlp)
  const bf16* s1;      // [H]: w1's scales (kRing, read when use_scale)
  bf16* out;           // [M, C]
  bf16* t;             // [H / 64, row_tiles * mt, 64] scratch, swizzled B tiles
  int M, C, H;
  int chunk;           // kRing's packed w2 [nc, C, chunk] (0: w2 [C, H])
  int row_tiles, stages, t_slots;
  int gelu;            // 0 none, 1 erf, 2 sigmoid form
  int use_scale;
  float eps;
};

// Dynamic shared memory: decode_dense.cuh's layout without a t tile in a
// ring stage, the t_slots t tiles of phase B in the panel's bytes (the Python
// plan, ops/dense_mlp_kernel.py::smem_bytes, mirrors `total`)
__host__ __device__ inline Layout mlp_layout(int mt, int k_slice, int stages, int t_slots, int wbytes) {
  return layout(mt, k_slice, stages, false, wbytes, t_slots * mt * kRowBytes);
}

// The producer: lane 0 of the last warp issues the first row tile's panel
// (x's K-slice, ahead of the weights: the consumers wait for it first), then
// this CTA's weight tiles in the consumers' order (phase A: w1's, phase B:
// w2's with their t tiles), `stages` ahead; a t copy waits for its slot (the
// unit t_slots before it released) and, for the first t_slots units, for
// the gate.
template <int MT>
__device__ __forceinline__ void mlp_producer(const CUtensorMap* w1, const CUtensorMap* w2, const CUtensorMap* x,
                                             const MlpParams& p, const Ring& ring, uint32_t slots, uint32_t pbar,
                                             uint32_t gate, int s, int rank, int cid, int G) {
  const int m_pad = p.row_tiles * MT;
  const uint32_t t_bytes = MT * kRowBytes;
  const int ka = p.C / s;  // phase A's K-slice
  mbar_expect_tx(pbar, (uint32_t)(ka / kBK * MT * kRowBytes));
  for (int kb = 0; kb < ka / kBK; ++kb) tma_tile(slots + kb * MT * kRowBytes, x, rank * ka + kb * kBK, 0, pbar);
  int it = 0;
  const auto issue = [&](const CUtensorMap* map, int k0, int row0, uint32_t extra) {
    const int stage = it % ring.stages;
    mbar_wait(ring.empty + stage * 8, ((it / ring.stages) & 1) ^ 1);
    const uint32_t full = ring.full + stage * 8;
    mbar_expect_tx(full, ring.tile_bytes + extra);
    tma_tile(ring.base + stage * ring.stage_bytes, map, k0, row0, full);
    return full;
  };
  // phase A: w1's row tiles j (hidden units)
  for (int rt = 0; rt < p.row_tiles; ++rt)
    for (int j = cid; j < p.H / kTile; j += G)
      for (int kc = 0; kc < ka / kBK; ++kc, ++it) issue(w1, rank * ka + kc * kBK, j * kTile, 0);
  // phase B: w2's row tiles j (output channels), this CTA's K-slice of H
  const int ks = p.H / s;
  const int first = it;
  bool open = false;
  int n_def = 0;
  uint32_t def_dst[kMaxStages], def_bar[kMaxStages];
  const bf16* def_src[kMaxStages];
  const auto open_gate = [&]() {
    mbar_wait(gate, 0);
    fence_async_global();  // t, written by every CTA's generic stores before the barrier
    for (int d = 0; d < n_def; ++d) bulk_copy(def_dst[d], def_src[d], t_bytes, def_bar[d]);
    n_def = 0;
    open = true;
  };
  for (int rt = 0; rt < p.row_tiles; ++rt)
    for (int j = cid; j < p.C / kTile; j += G)
      for (int kc = 0; kc < ks / kBK; ++kc, ++it) {
        const int u = it - first;
        if (u >= p.t_slots) {
          if (!open) open_gate();
          const int v = it - p.t_slots;  // the slot's previous unit: released
          mbar_wait(ring.empty + (v % ring.stages) * 8, (v / ring.stages) & 1);
        }
        const int k0 = rank * ks + kc * kBK;
        const uint32_t full = p.chunk ? issue(w2, k0 % p.chunk, (k0 / p.chunk) * p.C + j * kTile, t_bytes)
                                      : issue(w2, k0, j * kTile, t_bytes);
        const uint32_t dst = slots + (uint32_t)(u % p.t_slots) * t_bytes;
        const bf16* src = p.t + ((size_t)(k0 / kBK) * m_pad + (size_t)rt * MT) * kBK;
        if (open) {
          bulk_copy(dst, src, t_bytes, full);
        } else {
          def_dst[n_def] = dst;
          def_src[n_def] = src;
          def_bar[n_def++] = full;
        }
      }
  if (!open && n_def > 0) open_gate();
}

// Row tiles above 160 rows are split between the two consumer warpgroups
// (decode_dense.cuh k_loop with NW = MT / 2): each multiplies its half of
// the rows against the same weight tile, MT / 4 accumulators a thread, and
// the epilogue of tile j - G runs on all eight warps after tile j's K loop
template <int MT>
__host__ __device__ constexpr bool halves() { return MT > 160; }

// the rows of a tile this thread's warpgroup multiplies
template <int MT>
__host__ __device__ constexpr int wg_rows() { return halves<MT>() ? MT / 2 : MT; }

// the epilogues: phase A's t (kT), phase B's out (kOutput)
enum MlpEpilogue { kT, kOutput };

// decode_dense.cuh's epilogue for these forms: this CTA sums its row pairs
// over the s slots in rank order; warp w (of nwarps from warp0) takes pairs
// lo + w, lo + w + nwarps, ...; lane l the column pair (o, o + 8)
template <int MT, int kForm, MlpEpilogue E>
__device__ __forceinline__ void mlp_epilogue(const MlpParams& p, const float4* red, int s, int rank, int m0, int j,
                                             int warp0, int nwarps) {
  constexpr int P = MT / 2;
  const int warp = (threadIdx.x >> 5) - warp0;
  const int lane = threadIdx.x & 31;
  const int lo = pair_lo(rank, P, s);
  const int hi = pair_lo(rank + 1, P, s);
  const int slot = (P + s - 1) / s;
  const int o = 16 * (lane >> 3) + (lane & 7);
  const int n = j * kTile + o;  // columns n and n + 8: hidden units (kT), output channels (kOutput)
  const int m_pad = p.row_tiles * MT;
  float b0 = 0.f, b8 = 0.f, sc0 = 1.f, sc8 = 1.f;
  if (kForm == kMlp) {
    const bf16* bias = E == kT ? p.b1 : p.b2;
    b0 = bf16_at(bias + n);
    b8 = bf16_at(bias + n + 8);
  } else if (E == kT && p.use_scale) {
    sc0 = bf16_at(p.s1 + n);
    sc8 = bf16_at(p.s1 + n + 8);
  }
  for (int mp = lo + warp; mp < hi; mp += nwarps) {
    const float4 v = sum_slots(red, (mp - lo) * 32 + lane, slot, s);
    // (row, column): v.x (m, n), v.y (m + 1, n), v.z (m, n + 8), v.w (m + 1, n + 8)
    float xs[2][2] = {};  // kMlp's residual of both rows, loaded before any store
    if (E == kOutput && kForm == kMlp)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (m0 + 2 * mp + h < p.M) {
          const bf16* xr = p.x + (size_t)(m0 + 2 * mp + h) * p.C + n;
          xs[h][0] = __bfloat162float(__ldg(xr));
          xs[h][1] = __bfloat162float(__ldg(xr + 8));
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + 2 * mp + h;
      const float a = h ? v.y : v.x;
      const float c = h ? v.w : v.z;
      if (E == kT) {  // every row of the tile: phase B reads the whole t tile
        const bool scaled = kForm == kRing && p.use_scale;
        const float t0 = gelu_of(kForm == kMlp ? a + b0 : scaled ? __fmul_rn(a, sc0) : a, p.gelu);
        const float t8 = gelu_of(kForm == kMlp ? c + b8 : scaled ? __fmul_rn(c, sc8) : c, p.gelu);
        bf16* tile = p.t + ((size_t)j * m_pad + gm) * kBK;  // t tile j (w2's K-block j), row gm, swizzled
        store_bf16(tile + ((((o >> 3) ^ (gm & 7)) << 3) | (o & 7)), t0);
        store_bf16(tile + (((((o + 8) >> 3) ^ (gm & 7)) << 3) | (o & 7)), t8);
      } else if (gm < p.M) {
        bf16* row = p.out + (size_t)gm * p.C + n;
        if (kForm == kMlp) {  // (x + acc) + b2, rounded once
          store_bf16(row, __fadd_rn(__fadd_rn(xs[h][0], a), b0));
          store_bf16(row + 8, __fadd_rn(__fadd_rn(xs[h][1], c), b8));
        } else {
          store_bf16(row, a);
          store_bf16(row + 8, c);
        }
      }
    }
  }
}

// kForm: kMlp (W bf16) or kRing (W bf16 or int8). Tensor maps: w1 [H, C],
// w2 [C, H] (kRing packed: [nc * C, chunk]), x in boxes of MT rows.
template <int MT, int kForm, typename W>
__global__ void __launch_bounds__(kThreads, 1)
    dense_mlp_kernel(const __grid_constant__ CUtensorMap w1_map, const __grid_constant__ CUtensorMap w2_map,
                     const __grid_constant__ CUtensorMap x_map, const MlpParams p) {
  constexpr bool kQ8 = sizeof(W) == 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int s = (int)(gridDim.x / cluster_count());
  const int rank = (int)cluster_rank();
  const int cid = (int)cluster_id();
  const int G = (int)cluster_count();
  const int k_slice = p.C / s;  // this CTA's K of phase A
  const Layout L = mlp_layout(MT, k_slice, p.stages, p.t_slots, (int)sizeof(W));
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

  if (threadIdx.x == 0) {  // full 1, empty the multiplying warps (4 or 8), xempty the cluster's CTAs
    const int warps = halves<MT>() ? 8 : 4;
    for (int i = 0; i < 2 * p.stages + 4; ++i)
      mbar_init(bars + i * 8, i < p.stages ? 1 : i < 2 * p.stages ? warps : i == 2 * p.stages + 1 ? s : 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_sync_all();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      mlp_producer<MT>(&w1_map, &w2_map, &x_map, p, ring, smem_u32(panel), pbar, gate, s, rank, cid, G);
    __syncwarp();
  } else {
    stamp(0);
    Exchange xc{xfull, xempty, s, 0};
    const uint32_t red_u32 = smem_u32(red);
    const float4* red4 = reinterpret_cast<const float4*>(red);
    const uint32_t panel_u32 = smem_u32(panel);
    const int k_lo = rank * k_slice;
    int loads = 0;  // pbar's phases so far
    constexpr int NW = wg_rows<MT>();
    float acc[NW / 2];
    int it = 0;
    // phase A: t = bf16(gelu(LN(x) w1^T + b1)) (kMlp), bf16(gelu?(x w1^T * s1?)) (kRing)
    for (int rt = 0; rt < p.row_tiles; ++rt) {
      const int m0 = rt * MT;
      if (rt > 0 && threadIdx.x == 0) {  // x's copies fly while LN's (weight, bias) load (row tile 0: the producer's)
        mbar_expect_tx(pbar, (uint32_t)(k_slice / kBK * MT * kRowBytes));
        for (int kb = 0; kb < k_slice / kBK; ++kb)
          tma_tile(panel_u32 + kb * MT * kRowBytes, &x_map, k_lo + kb * kBK, m0, pbar);
      }
      if (kForm == kMlp && rt == 0)
        for (int k = threadIdx.x; k < k_slice; k += kConsumers)
          lnp[k] = make_float2(p.ln_w[k_lo + k], p.ln_b[k_lo + k]);
      mbar_wait(pbar, loads++ & 1);
      if (rt == 0) stamp(1);
      if (kForm == kMlp) {  // LN: the slice's partial row sums through the cluster, then in place
        consumer_sync();    // lnp
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
        if (rt == 0) stamp(2);
        normalise_panel<MT>(panel, k_slice, min(MT, p.M - m0), norm, lnp);
      }
      if (kForm == kRing && rt == 0) stamp(2);
      if (rt == 0) stamp(3);
      const auto epi = [&](int j, int warp0, int nwarps) {
        mlp_epilogue<MT, kForm, kT>(p, red4, s, rank, m0, j, warp0, nwarps);
      };
      for_tiles<MT, kQ8, NW>(acc, p.H / kTile, cid, G, k_slice / kBK, ring, BSource{panel_u32, false, 0, 0}, it, xc,
                             red_u32, s, rank, epi, 7, rt == 0 ? 3 : 0);
    }
    fence_async_global();  // t is read by bulk copies after the barrier
    stamp(4);
    grid_sync();
    if (threadIdx.x == 0) mbar_arrive(gate);  // the panel is free: the t slots may fill
    stamp(5);
    // phase B: out = bf16((x + t w2^T) + b2) (kMlp), bf16(t w2^T) (kRing), t tiles through the slots
    const BSource slots{panel_u32, false, p.t_slots, it};  // unit u = it - first in slot u mod t_slots, as issued
    for (int rt = 0; rt < p.row_tiles; ++rt) {
      const auto epi = [&](int j, int warp0, int nwarps) {
        mlp_epilogue<MT, kForm, kOutput>(p, red4, s, rank, rt * MT, j, warp0, nwarps);
      };
      for_tiles<MT, kQ8, NW>(acc, p.C / kTile, cid, G, p.H / s / kBK, ring, slots, it, xc, red_u32, s, rank, epi, 13,
                             rt == 0 ? 1 : 0);
    }
    stamp(6);
    xc.finish();  // every CTA has read this one's buffers
  }
  cluster_sync_all();
}

// ---- host side -------------------------------------------------------------

template <int MT, int kForm, typename W>
int launch(const void* const* maps, const MlpParams& p, int cluster, int clusters, int smem, cudaStream_t stream) {
  const int k_slice = p.C / cluster;
  if (cluster < 1 || cluster > kMaxCluster || clusters < 1 || p.stages < kMinStages || p.stages > kMaxStages ||
      p.t_slots < 2 || p.t_slots > p.stages || k_slice % kBK || (p.H / cluster) % kBK || p.H % kTile ||
      p.C % kTile || (p.chunk && (p.chunk % kBK || p.H % p.chunk)) ||
      mlp_layout(MT, k_slice, p.stages, p.t_slots, (int)sizeof(W)).total > smem || smem > kMaxSmem ||
      p.row_tiles * MT < p.M || p.gelu < 0 || p.gelu > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem((const void*)dense_mlp_kernel<MT, kForm, W>, smem);
  if (e != cudaSuccess) return (int)e;
  int most = 0;  // the grid barrier needs every CTA resident at once
  e = max_clusters((const void*)dense_mlp_kernel<MT, kForm, W>, cluster, smem, &most);
  if (e != cudaSuccess) return (int)e;
  if (clusters > most) return (int)cudaErrorCooperativeLaunchTooLarge;
  CUtensorMap t[3];
  for (int i = 0; i < 3; ++i) memcpy(&t[i], maps[i], sizeof(CUtensorMap));
  MlpParams params = p;
  void* args[] = {&t[0], &t[1], &t[2], &params};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, clusters, smem, stream, attr);
  e = cudaLaunchKernelExC(&cfg, (const void*)dense_mlp_kernel<MT, kForm, W>, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the row tiles the kernel is built for (ops/dense_mlp_kernel.py ROW_TILES)
#define RQ_TILES_DENSE_MLP(X) X(8) X(16) X(24) X(32) X(40) X(48) X(64) X(80) X(104) X(128) X(160) X(192) X(256)

template <int kForm, typename W>
int launch_tile(int mt, const void* const* maps, const MlpParams& p, int cluster, int clusters, int smem,
                cudaStream_t stream) {
#define RQ_CASE(T) \
  case T:          \
    return launch<T, kForm, W>(maps, p, cluster, clusters, smem, stream);
  switch (mt) { RQ_TILES_DENSE_MLP(RQ_CASE) }
#undef RQ_CASE
  return (int)cudaErrorInvalidValue;
}

template <int kForm, typename W>
int max_clusters_tile(int mt, int cluster, int smem, int* out) {
#define RQ_CASE(T) \
  case T:          \
    return (int)max_clusters((const void*)dense_mlp_kernel<T, kForm, W>, cluster, smem, out);
  switch (mt) { RQ_TILES_DENSE_MLP(RQ_CASE) }
#undef RQ_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// How many clusters of `cluster` CTAs of the row-tile-`mt` kernel (ring 0:
// #15's form, bf16; ring 1: #20's, int8 when int8 is 1) with `smem` bytes
// of shared memory the device holds at once.
extern "C" int rq_dense_mlp_max_clusters(int ring, int mt, int cluster, int smem, int int8, int* out) {
  if (!ring) return int8 ? (int)cudaErrorInvalidValue : max_clusters_tile<kMlp, bf16>(mt, cluster, smem, out);
  return int8 ? max_clusters_tile<kRing, int8_t>(mt, cluster, smem, out)
              : max_clusters_tile<kRing, bf16>(mt, cluster, smem, out);
}

// The decode MLP alone (the source note). ring 0 (#15): x [M, C] bf16,
// ln_w, ln_b [C] fp32, the tensor maps of w1 [H, C] and w2 [C, H] (bf16,
// boxes of 64 rows), b1 [H], b2 [C]; s1 null; gelu 1 (erf) or 2 (sigmoid
// form). ring 1 (#20): x = h [M, C], w1 [H, C] and w2 packed [nc, C,
// chunk] (its map that of [nc * C, chunk]), bf16 or int8 (int8 1), s1 [H]
// read when use_scale; ln_w, ln_b, b1, b2 null; gelu 0 or 1. x_map: x's
// map in boxes of mt rows; out [M, C]; t (scratch) [H / 64, row_tiles *
// mt, 64] bf16. One persistent launch of `clusters` clusters of `cluster`
// CTAs, row tiles of mt rows (row_tiles * mt >= M), a ring of `stages`
// weight tiles, t_slots t tiles in the panel's bytes, `smem` bytes of
// dynamic shared memory (ops/dense_mlp_kernel.py::mlp_plan), co-resident or
// refused.
extern "C" int rq_dense_mlp(int ring, const void* x, const void* x_map, const void* ln_w, const void* ln_b,
                            const void* w1_map, const void* b1, const void* s1, const void* w2_map, const void* b2,
                            void* out, void* t, int M, int C, int H, int chunk, int cluster, int clusters, int mt,
                            int row_tiles, int stages, int t_slots, int smem, int gelu, int use_scale, int int8,
                            float eps, void* stream) {
  if (!ring && (ln_w == nullptr || ln_b == nullptr || b1 == nullptr || b2 == nullptr || int8 || chunk))
    return (int)cudaErrorInvalidValue;
  if (ring && use_scale && s1 == nullptr) return (int)cudaErrorInvalidValue;
  MlpParams p = {};
  p.x = static_cast<const bf16*>(x);
  p.ln_w = static_cast<const float*>(ln_w);
  p.ln_b = static_cast<const float*>(ln_b);
  p.b1 = static_cast<const bf16*>(b1);
  p.b2 = static_cast<const bf16*>(b2);
  p.s1 = static_cast<const bf16*>(s1);
  p.out = static_cast<bf16*>(out);
  p.t = static_cast<bf16*>(t);
  p.M = M;
  p.C = C;
  p.H = H;
  p.chunk = chunk;
  p.row_tiles = row_tiles;
  p.stages = stages;
  p.t_slots = t_slots;
  p.gelu = gelu;
  p.use_scale = use_scale;
  p.eps = eps;
  const void* maps[3] = {w1_map, w2_map, x_map};
  const cudaStream_t st = (cudaStream_t)stream;
  if (!ring) return launch_tile<kMlp, bf16>(mt, maps, p, cluster, clusters, smem, st);
  return int8 ? launch_tile<kRing, int8_t>(mt, maps, p, cluster, clusters, smem, st)
              : launch_tile<kRing, bf16>(mt, maps, p, cluster, clusters, smem, st);
}

// The globaltimer stamps of the last launch (g_stamps) into out (16 x u64):
// start, the first row tile's panel landed, its LN statistics exchanged,
// staged, phase A done, grid barrier passed, end (0-6); then for phase A's
// first three tiles and phase B's first, the K loop's end and the
// exchange's opening (7-12, 13-14).
extern "C" int rq_dense_mlp_phase_ns(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
