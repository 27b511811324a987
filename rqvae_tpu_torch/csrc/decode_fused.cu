// The fused body-layer decode steps on Hopper (sm_90a), one persistent
// launch each, on the machinery of csrc/decode_dense.cu (decode_dense.cuh):
//
//   rq_fused_layer_step (kLayer): the whole bf16 body layer at S = 1
//     qkv = bf16(LN1(x) @ wqkv^T + bqkv)
//     y   = attention of q over cache rows t < n_valid = min(cur_len, W)
//           and its own k, v (below); k, v written into row cur_len
//     x2  = x + bf16(y @ wo^T + bo);  h2 = LN2(x2)
//     t   = bf16(gelu(h2 @ w1^T + b1));  out = x2 + bf16(t @ w2^T + b2)
//   rq_fused_attn_wo (kAttnWo): the attention over an int8 cache, the new
//     row quantized and written, then x2 = x + bf16(y @ wo^T * wo_s + bo)
//     (int8 wo and its scales; a bf16 wo without them) and h2 = LN2(x2)
//
// Replace the TPU kernels rqvae_tpu/ops/decode_megakernel.py::
// decode_layer_step (:215) and rqvae_tpu/ops/attention_kernel.py::
// decode_attention_q8_update_wo (:728). Their first, cooperative design
// (phases of wmma split-K tiles over grid barriers, csrc/decode_megakernel.cu
// and rq_decode_attention_q8_update_wo in csrc/decode_attention_q8.cu)
// stays as the A/B baseline that only chip_smoke.py runs. Rounding points:
// the JAX kernels' (decode_megakernel.py:70-206; attention_kernel.py:680-
// 699, math _attn_math_q8_val), as the plain versions state them: the QKV
// sum is the one reordered (the cluster's split-K, as fused_ln_qkv's); wo's
// bias goes on the fp32 product before its one cast (kProjF); the attention
// rounds each product k * q and v * w to bf16 and sums in fp32, in another
// order than the plain versions.
//
// Bound on the H100: bytes. At B 100, C 1536, H 6144, W 64, cur_len 63 the
// layer step streams 56.6 MB of bf16 weights and 39.3 MB of cache window,
// 0.0288 ms at 3.35 TB/s; the attention with wo 19.4 MB of int8 cache and
// 2.4 (int8) or 4.7 MB (bf16) of wo, 0.0073 / 0.0080 ms. The design keeps
// the weight stream of the dense kernels and the cache stream of the
// attention kernels busy, one after the other, in one launch:
//
// - One plan for every product (ops/decode_layer_kernel.py::fused_plan):
//   `clusters` clusters of `cluster` CTAs, one row tile size, one ring; the
//   products are those of fused_ln_qkv and fused_proj_mlp (decode_dense.cu's
//   source note: wgmma with the weight tile as A, TMA into the ring with
//   one producer warp, split-K reduced in the cluster's shared memory, LN
//   partial sums per weight tile, int8 tiles widened in registers). The
//   grid is co-resident (cudaOccupancyMaxActiveClusters, checked at every
//   launch) for its hand-rolled grid barriers (4 in the layer step, 2 in the
//   attention with wo), whose counters are this library's own: one launch
//   of a decode_fused.cu kernel at a time per device, but it may run beside
//   decode_dense.cu's kernels.
// - The producer runs ahead across every barrier: wqkv's tiles, then wo's
//   fill the ring while the consumers attend; w1's while they wait for x2.
// - Attention on the consumer warps, after a grid barrier (q, k, v of
//   every head are ready): a warp per (row, 4 adjacent heads), a row group
//   of 8 lanes per head, each lane 8 values (a 16-byte bf16 or 8-byte int8
//   load), so that a warp's load of one cache row reads 4 heads' slices
//   contiguously; two batches of rows' loads in flight per lane (8 bf16 or
//   16 int8 rows each, 64 registers), the scales a batch ahead too; a
//   batch's partial row sums reduced over the row group in a butterfly that
//   leaves each lane whole rows (N - 1 shuffles for N rows); products on
//   bf16 pairs (one rounding of the exact product, as the plain version's
//   bf16 product; int8 values widened exactly by byte permutes, no
//   conversion instructions). A CTA attends whole rows, a warp per 4 heads
//   (at B 100 x 24 heads, 6 warps on each of 100 CTAs). The scores and V
//   scales (window + 1 floats each per head) live in the panel's bytes,
//   idle from the end of the QKV product to the wo panel's copies. y goes
//   to a bf16 scratch, read after the next barrier by the wo panel's TMA
//   copies (fence.proxy.async.global on both sides). What holds the phase
//   back: a few warps per SM walk a 64-row window in serial batches, each
//   waiting on its loads (PERF.md, §6-§7).
// - The int8 row (kAttnWo): per head, scale = max(absmax / 127, 1e-8) and
//   q = round-half-even(x / scale) in IEEE fp32, bit-equal to quantize_kv.
//
// Races: a unit reads cache rows < n_valid <= cur_len and writes row
// cur_len of its own head only; qkv, y, x2, t and the LN partial sums are
// written in one phase and read only after the grid barrier that ends it;
// the scores' bytes are written by generic stores and then by TMA (wo's
// panel) only after fence.proxy.async.shared::cta and a barrier.
//
// CTA 0's consumer thread 0 stamps the globaltimer at the start, at each
// barrier's arrival and departure, at the end, and at the steps of its
// first attention task (rq_fused_phase_ns).

#include "decode_dense.cuh"

namespace {

constexpr int kHead = 64;  // the head size served: 8 lanes x 8 values

// 8 cache values of one lane: bf16 (16 bytes) or int8 (8 bytes, in x and y)
template <bool kQ8C>
__device__ __forceinline__ uint4 load_row(const void* cache, size_t elem) {
  if constexpr (kQ8C) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(static_cast<const int8_t*>(cache) + elem));
    return make_uint4(u.x, u.y, 0u, 0u);
  } else {
    return __ldg(reinterpret_cast<const uint4*>(static_cast<const bf16*>(cache) + elem));
  }
}

// a lane's 8 cache values as 4 bf16 pairs: bf16 as they are, int8 widened
// exactly (decode_dense.cuh widen4: byte permutes and fp32 adds, no
// conversion instructions)
template <bool kQ8C>
__device__ __forceinline__ void row_pairs(const uint4& row, uint32_t* h) {
  if constexpr (kQ8C) {
    widen4(row.x, h[0], h[1]);
    widen4(row.y, h[2], h[3]);
  } else {
    h[0] = row.x;
    h[1] = row.y;
    h[2] = row.z;
    h[3] = row.w;
  }
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) { return *reinterpret_cast<__nv_bfloat162*>(&u); }

// sum over this lane's 8 values of bf16(row_i * x_i), x as 4 bf16 pairs: a
// bf16 pair product rounds the exact product once, as round_bf16(a * b)
template <bool kQ8C>
__device__ __forceinline__ float dot8(const uint4& row, const __nv_bfloat162* x) {
  uint32_t h[4];
  row_pairs<kQ8C>(row, h);
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(__hmul2(as_bf2(h[i]), x[i]));
    d += f.x + f.y;
  }
  return d;
}

// acc_i += bf16(row_i * w) over this lane's 8 values (w a bf16 value)
template <bool kQ8C>
__device__ __forceinline__ void axpy8(float* acc, const uint4& row, float w) {
  uint32_t h[4];
  row_pairs<kQ8C>(row, h);
  const __nv_bfloat162 w2 = __float2bfloat162_rn(w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(__hmul2(as_bf2(h[i]), w2));
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

// p ? a : b in registers (a select the compiler may not turn into an
// indexed load from local memory)
__device__ __forceinline__ float sel(bool p, float a, float b) {
  float r;
  asm("{\n.reg .pred q;\nsetp.ne.b32 q, %3, 0;\nselp.f32 %0, %1, %2, q;\n}\n" : "=f"(r) : "f"(a), "f"(b), "r"((int)p));
  return r;
}

// v[j]: this lane's partial sums of the N rows of a batch; leaves in v[0 ..
// N / 8) the whole sums over the row group's 8 lanes of rows N / 8 col + i
// (lane col's): three butterfly stages that halve the values each, N - 1
// shuffles for N rows
template <int N>
__device__ __forceinline__ void transpose_sum(float (&v)[N], int col) {
#pragma unroll
  for (int d = 4, w = N / 2; d >= 1; d >>= 1, w >>= 1) {
    const bool hi = col & d;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const float keep = sel(hi, v[i + w], v[i]);
      const float send = sel(hi, v[i], v[i + w]);
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, d);
    }
  }
}

// over the 8 lanes of a row group
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// one head's 8 values of this lane, quantized per head (the row group holds
// the head): int8 into q (8 bytes), the head's bf16 scale into *s (col 0)
__device__ __forceinline__ void quantize8(const float* x, int8_t* q, bf16* s, int col) {
  float a = fabsf(x[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) a = fmaxf(a, fabsf(x[i]));
  const float amax = group_max(a);
  const float scale = fmaxf(amax / 127.0f, 1e-8f);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i >> 2] |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(x[i] / scale) << (8 * (i & 3));
  *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[1]);
  if (col == 0) *s = __float2bfloat16_rn(scale);
}

// The attention phase on the first attn_warps(window) consumer warps.
// kQ8C: the int8 cache with its scales (decode_attention_q8_update's math),
// else the bf16 cache (decode_attention_update's). A warp attends four
// heads 4 q .. 4 q + 3 of a row b at a time: CTA c takes rows b = c, c +
// grid, ..., its warp w quads q = w, w + attn_warps, ..., so that the warps
// of a CTA read a cache row's heads side by side. Row group g (8 lanes)
// holds head 4 q + g, lane col its values 8 col .. 8 col + 7: a warp's load
// of cache row t reads 4 heads' slices, 512 (bf16) or 256 (int8)
// contiguous bytes. Rows come in
// batches of kB, the next batch's loads issued before this one is used (64
// registers of loads in flight). After the transposed sum lane col holds
// the scores of rows kB / 8 col + i of the batch, and loads their scales a
// batch ahead. Each row group keeps window + 1 scores and, for the int8
// cache, as many V scales in shared memory. CTA 0's thread 0 stamps the
// ends of its first task's K pass, softmax and V pass (g_stamps kSub ..
// kSub + 2).
template <bool kQ8C, int kSub>
__device__ void attention_phase(const Params& p, float* scores) {
  constexpr int kB = kQ8C ? 16 : 8;  // rows per batch
  constexpr int kL = kB / 8;         // rows a lane scores
  const int aw = attn_warps(p.window);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp >= aw) return;
  const int g = lane >> 3, col = lane & 7;
  const int n = p.n_valid;
  const int C = p.C;
  const int nb = (n + kB - 1) / kB;  // batches
  const float scale = 0.125f;  // 1 / sqrt(64)
  float* sc = scores + (warp * 4 + g) * 2 * (p.window + 1);
  float* vsc = sc + p.window + 1;
  const int quads = p.n_head / 4;
  const int qw = (quads + aw - 1) / aw;  // quads per warp
  const int rows_c = blockIdx.x < p.M ? (p.M - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  for (int r = 0; r < rows_c * qw; ++r) {
    const int b = blockIdx.x + gridDim.x * (r / qw);
    const int q = warp + aw * (r % qw);
    if (q >= quads) continue;  // warp-uniform
    const int h = 4 * q + g;
    const int c0 = h * kHead + 8 * col;
    // q, k_new, v_new: written by other CTAs before the barrier (the layer step): through L2
    const uint4 qu = __ldcg(reinterpret_cast<const uint4*>(p.aq + (size_t)b * p.ld_a + c0));
    const uint4 ku = __ldcg(reinterpret_cast<const uint4*>(p.ak + (size_t)b * p.ld_a + c0));
    const uint4 vu = __ldcg(reinterpret_cast<const uint4*>(p.av + (size_t)b * p.ld_a + c0));
    const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qu);
    const size_t row0 = (size_t)b * p.T * C + c0;        // (b, 0, c0) of the caches
    const size_t srow0 = (size_t)b * p.T * p.n_head + h;  // (b, 0, h) of the scales
    const bool sub = blockIdx.x == 0 && threadIdx.x == 0 && r == 0;
    const auto load = [&](uint4(&buf)[kB], const void* cache, int bi) {
#pragma unroll
      for (int j = 0; j < kB; ++j) buf[j] = load_row<kQ8C>(cache, row0 + (size_t)min(bi * kB + j, n - 1) * C);
    };
    // the scales of the rows this lane scores (int8 cache)
    const auto load_scales = [&](float(&ks_)[kL], float(&vs_)[kL], int bi) {
#pragma unroll
      for (int i = 0; i < kL; ++i) {
        const size_t t = min(bi * kB + kL * col + i, n - 1);
        ks_[i] = kQ8C ? __bfloat162float(p.ks[srow0 + t * p.n_head]) : 1.f;
        vs_[i] = kQ8C ? __bfloat162float(p.vs[srow0 + t * p.n_head]) : 1.f;
      }
    };

    // K pass: the scores (and the V scales) into shared memory
    float m = -INFINITY;
    uint4 cur[kB], nxt[kB];
    float ks_t[kL], vs_t[kL], ks_n[kL], vs_n[kL];
    if (nb > 0) {
      load(cur, p.kc, 0);
      load_scales(ks_t, vs_t, 0);
    }
    for (int bi = 0; bi < nb; ++bi) {
      if (bi + 1 < nb) {
        load(nxt, p.kc, bi + 1);
        load_scales(ks_n, vs_n, bi + 1);
      }
      float d[kB];
#pragma unroll
      for (int j = 0; j < kB; ++j) d[j] = dot8<kQ8C>(cur[j], q2);
      transpose_sum<kB>(d, col);
#pragma unroll
      for (int i = 0; i < kL; ++i) {
        const int t = bi * kB + kL * col + i;
        const float s = kQ8C ? d[i] * ks_t[i] * scale : d[i] * scale;
        if (t < n) {
          sc[t] = s;
          if (kQ8C) vsc[t] = vs_t[i];
          m = fmaxf(m, s);
        }
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) cur[j] = nxt[j];
#pragma unroll
      for (int i = 0; i < kL; ++i) {
        ks_t[i] = ks_n[i];
        vs_t[i] = vs_n[i];
      }
    }
    const float s_self = group_sum(dot8<false>(ku, q2)) * scale;  // the self term: the bf16 k_new
    m = fmaxf(group_max(m), s_self);
    if (sub) stamp(kSub);
    __syncwarp();
    // softmax: e = exp(s - m) and its sum; the weights in bf16 into sc:
    // bf16(e) (bf16 cache), bf16((e / denom) * vs) (int8 cache)
    float l = 0.f;
#pragma unroll 4
    for (int t = col; t < n; t += 8) {
      const float e = expf(sc[t] - m);
      l += e;
      sc[t] = kQ8C ? e : round_bf16(e);
    }
    const float e_self = expf(s_self - m);
    const float denom = group_sum(l) + e_self;
    if constexpr (kQ8C) {
#pragma unroll 4
      for (int t = col; t < n; t += 8) sc[t] = round_bf16((sc[t] / denom) * vsc[t]);
    }
    if (sub) stamp(kSub + 1);
    __syncwarp();

    // V pass: acc_i = sum_t bf16(v_t,i * w_t)
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    if (nb > 0) load(cur, p.vc, 0);
    for (int bi = 0; bi < nb; ++bi) {
      if (bi + 1 < nb) load(nxt, p.vc, bi + 1);
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const int t = bi * kB + j;
        axpy8<kQ8C>(acc, cur[j], t < n ? sc[t] : 0.f);
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) cur[j] = nxt[j];
    }
    if (sub) stamp(kSub + 2);
    float kn[8], vn[8], f[8];
    unpack8(ku, kn);
    unpack8(vu, vn);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = kQ8C ? acc[i] + vn[i] * (e_self / denom) : (acc[i] + vn[i] * e_self) / denom;
    *reinterpret_cast<uint4*>(p.att + (size_t)b * C + c0) = pack8(f);
    const size_t dst = row0 + (size_t)p.cur_len * C;
    if constexpr (kQ8C) {
      const size_t dst_s = srow0 + (size_t)p.cur_len * p.n_head;
      quantize8(kn, static_cast<int8_t*>(p.kc) + dst, p.ks + dst_s, col);
      quantize8(vn, static_cast<int8_t*>(p.vc) + dst, p.vs + dst_s, col);
    } else {
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.kc) + dst) = ku;
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.vc) + dst) = vu;
    }
    __syncwarp();  // the scores are free for this warp's next task
  }
}

// h2 = LN2(x2) (kAttnWo's last phase): a warp per row, LN2's statistics
// from the wo epilogue's per-tile partial sums, summed lane-strided
__device__ void ln2_rows(const Params& p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = p.C / kTile;
  constexpr int kWarps = kConsumers / 32;
  for (int r = blockIdx.x * kWarps + warp; r < p.M; r += gridDim.x * kWarps) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = lane; j < tiles; j += 32) {
      const float2 v = __ldcg(p.stats + (size_t)r * tiles + j);
      s1 += v.x;
      s2 += v.y;
    }
    const float2 nm = ln_stats(warp_sum(s1), warp_sum(s2), p.C, p.eps);
    for (int c = 8 * lane; c < p.C; c += 256) {
      float f[8], w[8], bb[8];
      unpack8(__ldcg(reinterpret_cast<const uint4*>(p.x2 + (size_t)r * p.C + c)), f);
      unpack8(*reinterpret_cast<const uint4*>(p.ln_w + c), w);
      unpack8(*reinterpret_cast<const uint4*>(p.ln_b + c), bb);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = (f[i] - nm.x) * nm.y * w[i] + bb[i];
      *reinterpret_cast<uint4*>(p.out + (size_t)r * p.C + c) = pack8(f);
    }
  }
}

// kKind: kLayer (W bf16) or kAttnWo (W: wo's type). Tensor maps: the
// weights of the products in order (kLayer wqkv, wo, w1, w2; kAttnWo wo),
// then the activations x (LN1's input), att and x2 in boxes of MT rows.
template <int MT, int kKind, typename W>
__global__ void __launch_bounds__(kThreads, 1)
    fused_kernel(const __grid_constant__ CUtensorMap map0, const __grid_constant__ CUtensorMap map1,
                 const __grid_constant__ CUtensorMap map2, const __grid_constant__ CUtensorMap map3,
                 const __grid_constant__ CUtensorMap amap_x, const __grid_constant__ CUtensorMap amap_att,
                 const __grid_constant__ CUtensorMap amap_x2, const Params p) {
  constexpr bool kQ8 = sizeof(W) == 1;
  constexpr bool kL = kKind == kLayer;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int s = (int)(gridDim.x / cluster_count());
  const int rank = (int)cluster_rank();
  const int cid = (int)cluster_id();
  const int G = (int)cluster_count();
  const int k_slice = p.C / s;
  const Layout L = layout(MT, k_slice, p.stages, kL, (int)sizeof(W), score_bytes(p.window));
  uint8_t* panel = smem + L.panel;
  float* red = reinterpret_cast<float*>(smem + L.red);
  float2* norm = reinterpret_cast<float2*>(smem + L.norm);
  float2* lnp = reinterpret_cast<float2*>(smem + L.lnp);
  const uint32_t bars = smem_u32(smem + L.bars);
  const Ring ring{smem_u32(smem), bars, bars + p.stages * 8, p.stages, L.stage_bytes, L.tile_bytes};
  const uint32_t xfull = bars + 2 * p.stages * 8;
  const uint32_t xempty = xfull + 8;
  const uint32_t gate = xempty + 8;
  const uint32_t pbar = gate + 8;

  if (threadIdx.x == 0) {  // as dense_kernel's
    for (int i = 0; i < 2 * p.stages + 4; ++i)
      mbar_init(bars + i * 8, i < p.stages ? 1 : i < 2 * p.stages ? 4 : i == 2 * p.stages + 1 ? s : 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_sync_all();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const CUtensorMap* maps[4] = {&map0, &map1, &map2, &map3};
      producer<MT, kKind>(maps, p, ring, gate, s, rank, cid, G);
    }
    __syncwarp();
  } else {
    int st = 0;
    stamp(st++);
    Exchange xc{xfull, xempty, s, 0};
    const uint32_t red_u32 = smem_u32(red);
    const float4* red4 = reinterpret_cast<const float4*>(red);
    const uint32_t panel_u32 = smem_u32(panel);
    const int k_lo = rank * k_slice;
    int loads = 0;  // pbar's phases so far
    float acc[MT / 2];
    int it = 0;
    const auto grid_barrier = [&]() {
      stamp(st++);
      grid_sync();
      stamp(st++);
    };
    if constexpr (kL) {
      // phase 1: qkv = bf16(LN1(x) wqkv^T + bqkv) into the qkv scratch, as fused_ln_qkv
      for (int k = threadIdx.x; k < k_slice; k += kConsumers)
        lnp[k] = make_float2(__bfloat162float(p.ln_w[k_lo + k]), __bfloat162float(p.ln_b[k_lo + k]));
      const Product pr = product(kKind, 0, p);
      for (int rt = 0; rt < p.row_tiles; ++rt) {
        const int m0 = rt * MT;
        const int rows = min(MT, p.M - m0);
        load_panel<MT>(panel_u32, &amap_x, k_lo, k_slice, m0, pbar, loads++ & 1);
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
        xc.end();
        normalise_panel<MT>(panel, k_slice, rows, norm, lnp);
        run_tiles<MT, kQkv, kQ8>(p, acc, pr.tiles, cid, G, k_slice / kBK, ring, panel_u32, false, it, xc, red4,
                                 red_u32, s, rank, m0);
      }
      grid_barrier();
      // LN2's (weight, bias) of the slice, for phase 4 (no thread normalises with LN1's any more)
      for (int k = threadIdx.x; k < k_slice; k += kConsumers)
        lnp[k] = make_float2(__bfloat162float(p.ln2_w[k_lo + k]), __bfloat162float(p.ln2_b[k_lo + k]));
    }
    // phase 2: attention; y into the att scratch, the new row into the caches
    attention_phase<!kL, kL ? 10 : 6>(p, reinterpret_cast<float*>(panel));
    fence_async_global();  // att is read by the wo panel's TMA copies after the barrier
    fence_async_shared();  // the scores' bytes take those copies
    grid_barrier();
    // phase 3: x2 = x + bf16(att wo^T (* wo_s) + bo), with LN2's partial sums per weight tile
    const Product pw = product(kKind, kL ? 1 : 0, p);
    for (int rt = 0; rt < p.row_tiles && cid < pw.tiles; ++rt) {
      const int m0 = rt * MT;
      load_panel<MT>(panel_u32, &amap_att, k_lo, k_slice, m0, pbar, loads++ & 1);
      run_tiles<MT, kProjF, kQ8>(p, acc, pw.tiles, cid, G, k_slice / kBK, ring, panel_u32, false, it, xc, red4,
                                 red_u32, s, rank, m0);
    }
    grid_barrier();
    if constexpr (kL) {
      // phase 4: t = bf16(gelu(LN2(x2) w1^T + b1)) into the swizzled t tiles, as fused_proj_mlp's phase 2
      const Product p1 = product(kKind, 2, p);
      for (int rt = 0; rt < p.row_tiles && cid < p1.tiles; ++rt) {
        const int m0 = rt * MT;
        const int rows = min(MT, p.M - m0);
        if (threadIdx.x == 0) {
          fence_async_global();
          mbar_expect_tx(pbar, (uint32_t)(k_slice / kBK * MT * kRowBytes));
          for (int kb = 0; kb < k_slice / kBK; ++kb)
            tma_tile(panel_u32 + kb * MT * kRowBytes, &amap_x2, k_lo + kb * kBK, m0, pbar);
        }
        ln2_stats<MT>(p, m0, rows, norm);
        mbar_wait(pbar, loads++ & 1);
        normalise_panel<MT>(panel, k_slice, rows, norm, lnp);
        run_tiles<MT, kGelu, kQ8>(p, acc, p1.tiles, cid, G, k_slice / kBK, ring, panel_u32, false, it, xc, red4,
                                  red_u32, s, rank, m0);
      }
      fence_async_global();  // t is read by bulk copies after the barrier
      grid_barrier();
      if (threadIdx.x == 0) mbar_arrive(gate);
      // phase 5: out = x2 + bf16(t w2^T + b2), t tiles through the ring
      const Product p2 = product(kKind, 3, p);
      for (int rt = 0; rt < p.row_tiles; ++rt)
        run_tiles<MT, kOut, kQ8>(p, acc, p2.tiles, cid, G, p2.k / s / kBK, ring, 0u, true, it, xc, red4, red_u32, s,
                                 rank, rt * MT);
    } else {
      // phase 4: h2 = LN2(x2)
      ln2_rows(p);
    }
    stamp(st);
    xc.finish();  // every CTA has read this one's buffers
  }
  cluster_sync_all();
}

// ---- host side -------------------------------------------------------------

template <int MT, int kKind, typename W>
int launch(const void* const* maps, const Params& p, int cluster, int clusters, int smem, cudaStream_t stream) {
  const int k_slice = p.C / cluster;
  if (cluster < 1 || cluster > kMaxCluster || clusters < 1 || p.stages < kMinStages || p.stages > kMaxStages ||
      k_slice % kBK || p.C != p.n_head * kHead || p.n_head % 4 || p.n_valid > p.window ||
      p.cur_len < 0 || p.cur_len >= p.T ||
      layout(MT, k_slice, p.stages, kKind == kLayer, (int)sizeof(W), score_bytes(p.window)).total > smem ||
      smem > kMaxSmem || (kKind == kLayer && (p.N / cluster) % kBK) || p.row_tiles * MT < p.M)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem((const void*)fused_kernel<MT, kKind, W>, smem);
  if (e != cudaSuccess) return (int)e;
  int most = 0;  // the grid barriers need every CTA resident at once
  e = max_clusters((const void*)fused_kernel<MT, kKind, W>, cluster, smem, &most);
  if (e != cudaSuccess) return (int)e;
  if (clusters > most) return (int)cudaErrorCooperativeLaunchTooLarge;
  CUtensorMap t[7];
  for (int i = 0; i < 7; ++i) memcpy(&t[i], maps[i], sizeof(CUtensorMap));
  Params params = p;
  void* args[] = {&t[0], &t[1], &t[2], &t[3], &t[4], &t[5], &t[6], &params};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, clusters, smem, stream, attr);
  e = cudaLaunchKernelExC(&cfg, (const void*)fused_kernel<MT, kKind, W>, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the row tiles the fused kernels are built for (ops/decode_layer_kernel.py ROW_TILES_FUSED)
#define RQ_TILES_FUSED(X) X(8) X(16) X(24) X(32) X(40) X(48) X(64) X(80) X(104) X(128)

template <int kKind, typename W>
int launch_tile(int mt, const void* const* maps, const Params& p, int cluster, int clusters, int smem,
                cudaStream_t stream) {
#define RQ_CASE(T) \
  case T:          \
    return launch<T, kKind, W>(maps, p, cluster, clusters, smem, stream);
  switch (mt) { RQ_TILES_FUSED(RQ_CASE) }
#undef RQ_CASE
  return (int)cudaErrorInvalidValue;
}

template <int kKind, typename W>
int max_clusters_tile(int mt, int cluster, int smem, int* out) {
#define RQ_CASE(T) \
  case T:          \
    return (int)max_clusters((const void*)fused_kernel<T, kKind, W>, cluster, smem, out);
  switch (mt) { RQ_TILES_FUSED(RQ_CASE) }
#undef RQ_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// How many clusters of `cluster` CTAs of the row-tile-`mt` fused kernel
// (layer: the layer step, else the attention with wo; int8: its int8-wo
// form) with `smem` bytes of shared memory the device holds at once.
extern "C" int rq_fused_max_clusters(int layer, int mt, int cluster, int smem, int int8, int* out) {
  if (layer) return max_clusters_tile<kLayer, bf16>(mt, cluster, smem, out);
  return int8 ? max_clusters_tile<kAttnWo, int8_t>(mt, cluster, smem, out)
              : max_clusters_tile<kAttnWo, bf16>(mt, cluster, smem, out);
}

// The whole bf16 layer step (the source note). x, out: [M, C]; k_cache,
// v_cache: [M, T, C]; the tensor maps of wqkv [3C, C], wo [C, C], w1 [H,
// C], w2 [C, H] (boxes of 64 rows) and of x, att, x2 (boxes of mt rows);
// LN and bias vectors of their widths; scratch: qkv [M, 3C], att, x2 [M,
// C], t [H / 64, row_tiles * mt, 64], stats fp32 [M, C / 64, 2]; all else
// bf16. C == n_head * 64. Attends rows < min(cur_len, window), writes row
// cur_len (< T). One persistent launch of the plan of ops/
// decode_layer_kernel.py::fused_plan, co-resident or refused.
extern "C" int rq_fused_layer_step(const void* x, const void* x_map, void* k_cache, void* v_cache, const void* ln1_w,
                                   const void* ln1_b, const void* wqkv_map, const void* bqkv, const void* wo_map,
                                   const void* bo, const void* ln2_w, const void* ln2_b, const void* w1_map,
                                   const void* b1, const void* w2_map, const void* b2, void* out, void* qkv, void* att,
                                   const void* att_map, void* x2, const void* x2_map, void* t, void* stats, int M,
                                   int T, int C, int H, int n_head, int window, int cur_len, int cluster, int clusters,
                                   int mt, int row_tiles, int stages, int smem, int gelu_sigmoid, float eps,
                                   void* stream) {
  Params p = {};
  p.x = static_cast<const bf16*>(x);
  p.ln_w = static_cast<const bf16*>(ln1_w);
  p.ln_b = static_cast<const bf16*>(ln1_b);
  p.ln2_w = static_cast<const bf16*>(ln2_w);
  p.ln2_b = static_cast<const bf16*>(ln2_b);
  p.bqkv = static_cast<const bf16*>(bqkv);
  p.b0 = static_cast<const bf16*>(bo);
  p.b1 = static_cast<const bf16*>(b1);
  p.b2 = static_cast<const bf16*>(b2);
  p.out = static_cast<bf16*>(out);
  p.qkv = static_cast<bf16*>(qkv);
  p.att = static_cast<bf16*>(att);
  p.x2 = static_cast<bf16*>(x2);
  p.t = static_cast<bf16*>(t);
  p.stats = static_cast<float2*>(stats);
  p.aq = p.qkv;
  p.ak = p.qkv + C;
  p.av = p.qkv + 2 * C;
  p.ld_a = 3 * C;
  p.kc = k_cache;
  p.vc = v_cache;
  p.M = M;
  p.C = C;
  p.N = H;
  p.T = T;
  p.n_head = n_head;
  p.window = window;
  p.n_valid = cur_len < window ? cur_len : window;
  p.cur_len = cur_len;
  p.row_tiles = row_tiles;
  p.stages = stages;
  p.gelu_sigmoid = gelu_sigmoid;
  p.eps = eps;
  const void* maps[7] = {wqkv_map, wo_map, w1_map, w2_map, x_map, att_map, x2_map};
  return launch_tile<kLayer, bf16>(mt, maps, p, cluster, clusters, smem, (cudaStream_t)stream);
}

// The q8 attention with wo, residual and LN2 (the source note). q, k_new,
// v_new, x, x2, h2: [M, C]; kq, vq int8 [M, T, C] and their scales ks, vs
// [M, T, n_head]; wo_map: the tensor map of wo [C, C], int8 with its
// scales wo_s [C], or bf16 (wo_s null); bo, ln2_w, ln2_b: [C]; scratch: att
// [M, C] and its tensor map (boxes of mt rows), stats fp32 [M, C / 64, 2];
// all else bf16. C == n_head * 64. Attends rows < min(cur_len, window),
// writes row cur_len (< T) of the four caches. One persistent launch of the
// plan of fused_plan, co-resident or refused.
extern "C" int rq_fused_attn_wo(const void* q, const void* k_new, const void* v_new, void* kq, void* ks, void* vq,
                                void* vs, const void* x, const void* wo_map, const void* wo_s, const void* bo,
                                const void* ln2_w, const void* ln2_b, void* x2, void* h2, void* att,
                                const void* att_map, void* stats, int M, int T, int C, int n_head, int window,
                                int cur_len, int cluster, int clusters, int mt, int row_tiles, int stages,
                                int smem, float eps, void* stream) {
  Params p = {};
  p.x = static_cast<const bf16*>(x);
  p.ln_w = static_cast<const bf16*>(ln2_w);
  p.ln_b = static_cast<const bf16*>(ln2_b);
  p.b0 = static_cast<const bf16*>(bo);
  p.s0 = static_cast<const bf16*>(wo_s);
  p.out = static_cast<bf16*>(h2);
  p.x2 = static_cast<bf16*>(x2);
  p.att = static_cast<bf16*>(att);
  p.stats = static_cast<float2*>(stats);
  p.aq = static_cast<const bf16*>(q);
  p.ak = static_cast<const bf16*>(k_new);
  p.av = static_cast<const bf16*>(v_new);
  p.ld_a = C;
  p.kc = kq;
  p.vc = vq;
  p.ks = static_cast<bf16*>(ks);
  p.vs = static_cast<bf16*>(vs);
  p.M = M;
  p.C = C;
  p.N = C;
  p.T = T;
  p.n_head = n_head;
  p.window = window;
  p.n_valid = cur_len < window ? cur_len : window;
  p.cur_len = cur_len;
  p.row_tiles = row_tiles;
  p.stages = stages;
  p.eps = eps;
  const void* maps[7] = {wo_map, wo_map, wo_map, wo_map, att_map, att_map, att_map};
  const cudaStream_t st = (cudaStream_t)stream;
  return wo_s ? launch_tile<kAttnWo, int8_t>(mt, maps, p, cluster, clusters, smem, st)
              : launch_tile<kAttnWo, bf16>(mt, maps, p, cluster, clusters, smem, st);
}

// The globaltimer stamps of the last fused launch (g_stamps) into out (16 x
// u64): the layer step's start, the arrival at and departure from each of
// its four barriers, its end (0-9), then the ends of CTA 0's first
// attention task's K pass, softmax and V pass (10-12); the attention with
// wo's start, two barriers and end (0-5), then those of its attention (6-8).
extern "C" int rq_fused_phase_ns(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
