// The int8 weight-chunk stream of the dense kernels alone, on Hopper
// (sm_90a): decode_dense.cuh's TMA ring with the products taken out.
//
// Replaces the TPU kernel tools/exp_q8_pipeline.py::stream_probe (#19),
// what it computes in the port's layout (JAX's w1 chunk [C, chunk] is the
// port's [chunk, C] transposed, its w2 chunk [chunk, C] the port's [C,
// chunk] transposed), over packed w1p [nc, chunk, C] and w2p [nc, C, chunk]
// int8 bytes:
//   dma:     every lane = the sum over chunks of column 0 of the first
//            min(128, chunk) w1p rows and the first min(128, C) w2p rows
//   dma-i32: the same bytes seen as int32 (the wrapper's int32 tensors):
//            the sum of the int32 values whose bytes are column 0 of rows
//            4l .. 4l + 3, l < min(128, rows / 4), of each chunk's w1p and
//            w2p: JAX's row 0 viewed as int32
//   dequant: lane l = the sum over chunks of w1p row l and w2p row l
//            (l < 128), every landed row widened to bf16 and summed
// Integer sums, exact (fp64 or int32), cast to fp32 once.
//
// Bound on the H100: bytes. At C 1536, H 6144 a call reads 18.9 MB of
// int8 weights: 5.6 us at 3.35 TB/s. Design: the ring that
// csrc/decode_dense.cu's #6 fused_proj_mlp_q8 streams its weights through,
// with the products taken out, so its rate answers what bounds the dense
// kernels' K loop. The same plan as #6's at B 100 (the wrapper's, from
// ops/decode_layer_kernel.py::dense_plan): `clusters` groups of `cluster`
// CTAs, one CTA an SM (the same shared memory), group g streaming weight
// row tiles g, g + clusters, ... of each product and CTA rank r its r-th
// K-slice of them; the same ring of `stages` full/empty mbarrier stages;
// decode_dense.cuh's producer (its kStream kind: w1 [H, C] from w1p's
// bytes, then the packed w2 through a map of [nc C, chunk]) issues every
// 64 x 64 tile by TMA with the 64-byte swizzle. The first consumer
// warpgroup takes each landed tile as #6's K loop does and releases the
// stage: in dma, 64 threads read one byte of each of its rows (column 0:
// the lanes' values where the tile holds a chunk's column 0, the rest into
// a sink); in dma-i32, 16 threads read the column-0 bytes of four rows
// each as one int32; in dequant, the K loop's fragment reads and widening
// (load_a_q8, widen4) of all 64 x 64 bytes, summed per row. No grid
// barrier: each CTA adds its sums to device-global fp64 lanes (exact for
// these integers) and the last CTA to take a ticket casts them into the
// output and zeroes the lanes and the ticket for the next launch (so, as
// for #6's grid barrier, one launch at a time on a device). CTA 0's
// globaltimer stamps: start, first stage landed, w1 streamed, end.

#include "decode_dense.cuh"

namespace {

enum Mode { kDma, kDequant, kDmaI32 };
constexpr int kLanes = 128;

__device__ double g_acc[kLanes];  // the launch's sums, zero between launches
__device__ unsigned int g_ticket;  // CTAs done, zero between launches
__device__ unsigned int g_sink;    // bytes read for nothing else, kept alive here

// the consumer warpgroup's own barrier (the second warpgroup and the
// producer warp leave early)
__device__ __forceinline__ void wg_sync() { asm volatile("bar.sync 2, 128;" ::: "memory"); }

__device__ __forceinline__ int lds_s8(uint32_t addr) {
  int v;
  asm volatile("ld.shared.s8 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// column 0 of row r of a landed 64 x 64 int8 tile (the 64-byte swizzle
// puts 16-byte chunk c of row r at r * 64 + ((c ^ (r / 2 % 4)) << 4))
__device__ __forceinline__ uint32_t col0(uint32_t tile, int r) { return tile + r * 64 + (((r >> 1) & 3) << 4); }

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    stream_probe_kernel(const __grid_constant__ CUtensorMap w1_map, const __grid_constant__ CUtensorMap w2_map,
                        const Params p, int mt, int s, float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int lanes[kLanes];
  __shared__ bool last;
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int rank = (int)blockIdx.x % s;
  const int cid = (int)blockIdx.x / s;
  const int G = (int)gridDim.x / s;
  const Layout L = layout(mt, p.C / s, p.stages, true, 1);  // #6's int8 ring
  const uint32_t bars = smem_u32(smem + L.bars);
  const Ring ring{smem_u32(smem), bars, bars + p.stages * 8, p.stages, L.stage_bytes, L.tile_bytes};

  if (threadIdx.x == 0) {  // full: 1 arrival; empty: the consumer warpgroup's warps
    for (int i = 0; i < 2 * p.stages; ++i) mbar_init(bars + i * 8, i < p.stages ? 1 : 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x < kLanes) lanes[threadIdx.x] = 0;
  __syncthreads();

  if (threadIdx.x == kConsumers) {
    const CUtensorMap* maps[2] = {&w1_map, &w2_map};
    producer<8, kStream>(maps, p, ring, 0u, s, rank, cid, G);
  }
  if (threadIdx.x >= 128) return;

  stamp(0);
  const int lane = threadIdx.x & 31;
  const int t = threadIdx.x;
  long long mine = 0;  // dma, dma-i32: this thread's share of the one sum
  unsigned int sink = 0;
  int it = 0;
  for (int pi = 0; pi < 2; ++pi) {
    const Product pr = product(kStream, pi, p);
    const int ks = pr.k / s;
    const int k_lo = rank * ks;
    const int rows = pi == 0 ? p.chunk : p.C;  // rows of one chunk of w1p / w2p
    const int limit = min(kMode == kDmaI32 ? 4 * kLanes : kLanes, rows);  // rows that feed the lanes
    for (int j = cid; j < pr.tiles; j += G) {
      const int r0 = pi == 0 ? (j * kTile) % p.chunk : j * kTile;  // the tile's first row in its chunk
      for (int kc = 0; kc < ks / kBK; ++kc, ++it) {
        const int k0 = k_lo + kc * kBK;
        const bool first_col = (pi == 0 ? k0 : k0 % p.chunk) == 0;
        const int stage = it % ring.stages;
        mbar_wait(ring.full + stage * 8, (it / ring.stages) & 1);
        if (it == 0) stamp(1);
        const uint32_t tile = ring.base + stage * ring.stage_bytes;
        if constexpr (kMode == kDma) {
          if (t < kTile) {
            const int v = lds_s8(col0(tile, t));
            if (first_col && r0 + t < limit)
              mine += v;
            else
              sink += (unsigned int)v;
          }
        } else if constexpr (kMode == kDmaI32) {
          if (t < kTile / 4) {
            uint32_t u = 0;  // little-endian: row 4 t in the low byte
#pragma unroll
            for (int b = 0; b < 4; ++b) u |= (uint32_t)(lds_s8(col0(tile, 4 * t + b)) & 0xFF) << (8 * b);
            const int v = (int)u;
            if (first_col && r0 + 4 * t < limit)
              mine += v;
            else
              sink += (unsigned int)v;
          }
        } else {
          // the K loop's widening: rows rr and rr + 8 of the tile, 16 bf16 each per lane
          float sum[2] = {0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            uint32_t a[4];
            load_a_q8(a, tile, kk);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[i]));
              sum[i & 1] += f.x + f.y;
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
            sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
            const int rr = 16 * (t >> 5) + (lane >> 2) + 8 * h;
            if ((lane & 3) == 0) {
              if (r0 + rr < limit)
                atomicAdd(&lanes[r0 + rr], (int)sum[h]);
              else
                sink += (unsigned int)(int)sum[h];
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(ring.empty + stage * 8);
      }
    }
    if (pi == 0) stamp(2);
  }

  // this CTA's sums into the device-global lanes (fp64 adds of integers: exact in any order)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mine += __shfl_xor_sync(0xffffffffu, mine, o);
    sink += __shfl_xor_sync(0xffffffffu, sink, o);
  }
  if (lane == 0) {
    if (mine != 0) atomicAdd(g_acc, (double)mine);
    atomicAdd(&g_sink, sink);
  }
  wg_sync();
  if (kMode == kDequant && lanes[t] != 0) atomicAdd(g_acc + t, (double)lanes[t]);
  __threadfence();
  wg_sync();
  if (t == 0) last = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;
  wg_sync();
  if (last) {  // every other CTA has added its sums
    __threadfence();
    out[t] = (float)__ldcg(g_acc + (kMode == kDequant ? t : 0));
    wg_sync();
    g_acc[t] = 0.0;
    if (t == 0) g_ticket = 0;
  }
  stamp(3);
}

}  // namespace

// The stream alone over packed w1p [nc, chunk, C] and w2p [nc, C, chunk]
// int8 bytes through their tensor maps from rq_dense_tensor_map (w1p as
// [H, C], w2p as [nc C, chunk], boxes of 64 rows); mode 0 dma, 1 dequant, 2
// dma-i32; out: fp32 [128]. The plan is #6's (decode_layer_kernel.
// dense_plan with int8 weights): `clusters` x `cluster` CTAs, its row tile
// mt (which sets the ring's stage stride), `stages`, `smem` bytes. chunk %
// 64 == 0, H % chunk == 0, C / cluster and H / cluster multiples of 64.
// Returns a CUDA error code, or 0.
extern "C" int rq_stream_probe(const void* w1_map, const void* w2_map, void* out, int C, int H, int chunk,
                               int cluster, int clusters, int mt, int stages, int smem, int mode, void* stream) {
  if (mode < kDma || mode > kDmaI32 || cluster < 1 || cluster > kMaxCluster || clusters < 1 || chunk < kBK ||
      chunk % kBK || H % chunk || (C / cluster) % kBK || C % cluster || (H / cluster) % kBK || H % cluster ||
      stages < kMinStages || stages > kMaxStages || layout(mt, C / cluster, stages, true, 1).total > smem ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.C = C;
  p.N = H;
  p.chunk = chunk;
  p.row_tiles = 1;
  p.stages = stages;
  const void* kernel = mode == kDma       ? (const void*)stream_probe_kernel<kDma>
                       : mode == kDequant ? (const void*)stream_probe_kernel<kDequant>
                                          : (const void*)stream_probe_kernel<kDmaI32>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap m1, m2;
  memcpy(&m1, w1_map, sizeof(m1));
  memcpy(&m2, w2_map, sizeof(m2));
  float* o = static_cast<float*>(out);
  void* args[] = {&m1, &m2, &p, &mt, &cluster, &o};
  e = cudaLaunchKernel(kernel, dim3(cluster * clusters), dim3(kThreads), args, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// CTA 0's globaltimer stamps of the last launch (start, first stage landed,
// w1 streamed, end) into out (4 x u64).
extern "C" int rq_stream_probe_phase_ns(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, 4 * sizeof(unsigned long long));
}
