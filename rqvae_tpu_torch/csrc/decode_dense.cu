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
// differs only in TPU DMA depth), and tools/exp_q8_pipeline.py::
// fused_proj_mlp_q8_ring (:115) / ::fused_proj_mlp_q8_packed (:216), which
// compute :451's function over hand-built rings of weight chunks (the
// packed one on w1 / w2 packed one chunk per block: w2 comes through a
// tensor map of [nc C, chunk], `chunk`), at their rounding points
// (one-pass fp32 LayerNorm cast to bf16; fp32 products; QKV's bias on the fp32 sum before
// its one cast; the bf16 projection cast before + bo and the residual, the
// int8 one scaled and biased in fp32 before its cast; gelu in fp32, then
// the cast; + b2 in fp32, the cast, the residual; an int8 weight's scale on
// the whole fp32 sum of its channel, after the cluster's reduction). The
// weights come in the nn.Linear [out, in] layout. The split-K kernels
// these replace stay in csrc/decode_layer.cu (rq_*_splitk) as the A/B
// baseline, and the cooperative chunk-ring kernel of the two experiment
// functions in csrc/q8_pipeline.cu (rq_q8_ring_mlp) as theirs. The
// machinery below (layout, ring, producer, K loop, cluster exchange,
// epilogues, grid barrier) lives in decode_dense.cuh, which
// csrc/decode_fused.cu's layer-step kernels share; each library has its
// own copy of the barrier's counters.
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

#include "decode_dense.cuh"

namespace {

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
      const CUtensorMap* maps[3] = {&map0, &map1, &map2};
      producer<MT, kMlp ? kProjMlp : kLnQkv>(maps, p, ring, gate, s, rank, cid, G);
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
      const Product pr = product(kLnQkv, 0, p);
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
      const Product p0 = product(kProjMlp, 0, p);
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
      const Product p1 = product(kProjMlp, 1, p);
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
      const Product p2 = product(kProjMlp, 2, p);
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

template <int MT, bool kMlp, typename W>
int launch(const void* const* maps, const Params& p, int cluster, int clusters, int smem, cudaStream_t stream) {
  const int k_slice = p.C / cluster;
  if (cluster < 1 || cluster > kMaxCluster || clusters < 1 || p.stages < kMinStages || p.stages > kMaxStages ||
      k_slice % kBK || layout(MT, k_slice, p.stages, kMlp, (int)sizeof(W)).total > smem || smem > kMaxSmem ||
      (kMlp && (p.N / cluster) % kBK) || p.row_tiles * MT < p.M ||
      (p.chunk && (!kMlp || p.chunk % kBK || p.N % p.chunk)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem((const void*)dense_kernel<MT, kMlp, W>, smem);
  if (e != cudaSuccess) return (int)e;
  if (kMlp) {  // the grid barriers need every CTA resident at once
    int most = 0;
    e = max_clusters((const void*)dense_kernel<MT, kMlp, W>, cluster, smem, &most);
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
    return (int)max_clusters((const void*)dense_kernel<T, kMlp, W>, cluster, smem, out);
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
// 64 columns, with the 128-byte (bf16) or 64-byte (int8) swizzle, or of
// fp32 (4) in boxes of box_rows x 32 columns with the 128-byte swizzle
// (csrc/nearest_code.cu's operands), into out (128 bytes): a weight's
// (box_rows 64) or an activation's (the row tile). Rows past `rows` read
// as zeros. Returns 0, or a CUDA error code.
extern "C" int rq_dense_tensor_map(const void* w, int rows, int cols, int box_rows, int elem_bytes, void* out) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  if (elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const bool int8 = elem_bytes == 1;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(elem_bytes == 4 ? 32 : kBK), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type = int8              ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap map;  // 64-byte aligned here; out need not be
  const CUtensorMapSwizzle swizzle = int8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUresult r = encode(&map, type, 2, const_cast<void*>(w), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out-of-bounds elements read as zeros
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
// wo [C, C], w1 [H, C], w2 [C, H] (chunk 0) or w2 packed [nc, C, chunk] as
// the matrix [nc C, chunk] (chunk % 64 == 0, dividing H; the packed w1
// [nc, chunk, C] has w1's bytes); biases and LN2 [C] or [H]; t (scratch):
// [H / 64, row_tiles * mt, 64]; stats (scratch): fp32 [M, C / 64, 2]; all
// else bf16. gelu_sigmoid selects t * sigmoid(1.702 t) over the exact erf.
// One persistent launch, co-resident or refused; the plan as for
// rq_fused_ln_qkv.
extern "C" int rq_fused_proj_mlp(const void* x, const void* y, const void* y_map, const void* wo_map, const void* wo_s,
                                 const void* bo, const void* ln_w, const void* ln_b, const void* w1_map,
                                 const void* w1_s, const void* b1, const void* w2_map, const void* w2_s, const void* b2,
                                 void* out, void* x2, const void* x2_map, void* t, void* stats, int M, int C, int H,
                                 int chunk, int cluster, int clusters, int mt, int row_tiles, int stages, int smem,
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
  p.chunk = chunk;
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
  return (int)cudaMemcpyFromSymbol(out, g_stamps, 6 * sizeof(unsigned long long));
}
