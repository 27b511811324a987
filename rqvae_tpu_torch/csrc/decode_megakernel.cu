// One whole decode transformer layer step in one launch, for the
// RQ-Transformer body on Hopper (sm_90a):
//
//   h1  = LN1(x);  q, k, v = bf16(h1 @ wqkv^T + bqkv)
//   att = bf16(y / l): attention of q over cache rows t < n_valid =
//         min(cur_len, W) plus its own k, v:
//           s_t = sum bf16(k_t * q) / 8 (fp32 sum), e = exp(s - max s),
//           l = sum e, y = sum_t bf16(v_t * bf16(e_t)) + v * e_self (fp32)
//   x2  = bf16(x + bf16(att @ wo^T + bo));  h2 = LN2(x2)
//   t1  = bf16(gelu(h2 @ w1^T + b1))        (exact erf, or t * sigmoid(1.702 t))
//   out = bf16(x2 + bf16(t1 @ w2^T + b2))
// and k, v written into row cur_len of the layer's bf16 caches in place.
//
// Replaces the TPU kernel rqvae_tpu/ops/decode_megakernel.py::
// decode_layer_step (one pallas_call whose sequential grid runs QKV, the
// cache chunks with an online softmax, wo + LN2, and the MLP chunks, with
// the intermediates in VMEM scratch). The rounding points are the JAX
// kernel's (decode_megakernel.py:70-206); the softmax is not chunked here,
// which moves only roundings of the bf16 weights.
//
// Bound on the H100: bytes. At B=100, C=1536, H=6144, W=64 one step reads
// 56.6 MB of bf16 weights (wqkv 14.2, wo 4.7, w1 18.9, w2 18.9) and 39.3 MB
// of cache window for 5.7 GFLOP: about 29 us at 3.35 TB/s against 6 us of
// bf16 tensor-core time. Design: the TPU kernel's sequential grid carried
// its scratch from step to step; Hopper blocks run in no order and each
// phase needs all of the previous one (QKV needs LN1 of every column, wo
// every head, LN2 a whole row), and h1 alone (300 KB) exceeds one SM's
// shared memory. So this is one cooperative persistent launch
// (fused_layer.cuh) of nine phases separated by grid barriers:
//   0 LN1 (block per row)             -> act
//   1 QKV GEMM, split-K               -> part
//   2 attention, warp per (row, head): q/k/v from the partial sums + bias,
//     the cache row written           -> act
//   3 wo GEMM                         -> part
//   4 residual + LN2 (block per row)  -> x2, act
//   5 w1 GEMM                         -> part
//   6 bias + gelu (elementwise)       -> t1
//   7 w2 GEMM                         -> part
//   8 bias + residual (elementwise)   -> out
// Every weight byte and every cache byte is read once per call; the
// intermediates (act, x2, t1, the partial sums) stay in L2. The launch
// count, not the bytes, was what the layer step of three kernels and the
// dense half's split launches paid for: here the host issues one call per
// layer.
//
// Races: phase 2 reads cache rows < cur_len and writes row cur_len; every
// buffer a phase writes was last read before the barrier in front of it.
//
// Block 0 stamps the globaltimer at the start and after each barrier, and
// the last block to finish at the end (phase_ns, read by
// rq_decode_layer_step_phase_ns): where the time of the last launch went,
// phase by phase, for a few 8-byte stores.

#include "fused_layer.cuh"

namespace {

using namespace fused;
namespace cg = cooperative_groups;

__device__ unsigned long long phase_ns[10];

struct Params {
  const bf16* x;
  bf16* k_cache;
  bf16* v_cache;
  const bf16 *ln1_w, *ln1_b, *wqkv, *bqkv, *wo, *bo, *ln2_w, *ln2_b, *w1, *b1, *w2, *b2;
  bf16* out;
  float* part;  // [kMaxSplits, M, max(3C, H)] fp32 partial sums
  bf16* act;    // [M, C]: h1, then att, then h2
  bf16* x2;     // [M, C]
  bf16* t1;     // [M, H]
  int M, T, C, H, n_head, n_valid, cur_len, gelu_sigmoid;
  int s_qkv, s_o, s_1, s_2;  // split-K factors of the four GEMMs
  float eps, scale;
};

__device__ __forceinline__ float gelu(float t, int sigmoid) {
  return sigmoid ? t / (1.f + expf(-1.702f * t)) : 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
}

// bf16(sum of the QKV partials + bias) at columns col, col + 1 of row b
__device__ __forceinline__ float2 qkv_at(const Params& p, int b, int col) {
  const size_t n3 = 3 * (size_t)p.C;
  const float2 s = sum_parts2(p.part, p.s_qkv, (size_t)p.M * n3, (size_t)b * n3 + col);
  const float2 bias = load_bf16x2(p.bqkv + col);
  return make_float2(round_bf16(s.x + bias.x), round_bf16(s.y + bias.y));
}

// phase 2 for batch row b, head h, on one warp. scores: this warp's
// n_valid + 1 floats of shared memory
__device__ void attend(const Params& p, int b, int h, float* scores) {
  const int lane = threadIdx.x & 31;
  const int col = h * kHeadSize + 2 * lane;  // this lane's two columns
  const float2 q = qkv_at(p, b, col);
  const float2 k = qkv_at(p, b, p.C + col);
  const float2 v = qkv_at(p, b, 2 * p.C + col);
  const size_t cache0 = (size_t)b * p.T * p.C + col;
  const int n_valid = p.n_valid;

  // scores of rows t0 .. t0 + kRowBatch: all their loads in flight before
  // the first sum, and the same V rows prefetched into L2 meanwhile
  float m = -INFINITY;
  for (int t0 = 0; t0 < n_valid; t0 += kRowBatch) {
    __nv_bfloat162 kv[kRowBatch];
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      const size_t off = cache0 + (size_t)min(t0 + j, n_valid - 1) * p.C;
      kv[j] = *reinterpret_cast<const __nv_bfloat162*>(p.k_cache + off);
      prefetch_l2(p.v_cache + off);
    }
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      if (t0 + j >= n_valid) break;
      const float2 kc = __bfloat1622float2(kv[j]);
      const float s = warp_sum(round_bf16(kc.x * q.x) + round_bf16(kc.y * q.y)) * p.scale;
      if (lane == 0) scores[t0 + j] = s;
      m = fmaxf(m, s);
    }
  }
  const float s_self = warp_sum(round_bf16(k.x * q.x) + round_bf16(k.y * q.y)) * p.scale;
  m = fmaxf(m, s_self);
  __syncwarp();
  float l = 0.f;
  for (int t = lane; t < n_valid; t += 32) {
    const float e = expf(scores[t] - m);
    scores[t] = e;
    l += e;
  }
  const float e_self = expf(s_self - m);
  l = warp_sum(l) + e_self;
  __syncwarp();

  float2 acc = make_float2(0.f, 0.f);
  for (int t0 = 0; t0 < n_valid; t0 += kRowBatch) {
    __nv_bfloat162 vv[kRowBatch];
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j)
      vv[j] = *reinterpret_cast<const __nv_bfloat162*>(p.v_cache + cache0 +
                                                      (size_t)min(t0 + j, n_valid - 1) * p.C);
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      if (t0 + j >= n_valid) break;
      const float w = round_bf16(scores[t0 + j]);
      const float2 vc = __bfloat1622float2(vv[j]);
      acc.x += round_bf16(vc.x * w);
      acc.y += round_bf16(vc.y * w);
    }
  }
  store_bf16x2(p.act + (size_t)b * p.C + col, (acc.x + v.x * e_self) / l, (acc.y + v.y * e_self) / l);
  const size_t dst = cache0 + (size_t)p.cur_len * p.C;
  store_bf16x2(p.k_cache + dst, k.x, k.y);
  store_bf16x2(p.v_cache + dst, v.x, v.y);
  __syncwarp();  // scores are free for this warp's next unit
}

__global__ void __launch_bounds__(kThreads) decode_layer_step_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  __shared__ float red[kWarps];
  cg::grid_group grid = cg::this_grid();
  const auto sync = [&](int phase) {  // the barrier after phase - 1
    grid.sync();
    if (blockIdx.x == 0 && threadIdx.x == 0) phase_ns[phase] = global_ns();
  };
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    phase_ns[0] = global_ns();
    phase_ns[9] = 0;  // the last block to finish sets it (atomicMax below)
  }
  const int M = p.M, C = p.C, H = p.H;
  const size_t thread0 = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t threads = (size_t)gridDim.x * kThreads;

  for (int r = blockIdx.x; r < M; r += gridDim.x)  // 0: LN1
    layer_norm_row(p.x + (size_t)r * C, p.ln1_w, p.ln1_b, p.act + (size_t)r * C, C, p.eps, red);
  sync(1);
  gemm_phase<bf16>(sm, p.act, p.wqkv, p.part, M, 3 * C, C, p.s_qkv);  // 1: QKV
  sync(2);
  const int warp = threadIdx.x >> 5;
  float* scores = reinterpret_cast<float*>(smem_raw) + warp * (p.n_valid + 1);
  for (int u = blockIdx.x * kWarps + warp; u < M * p.n_head; u += gridDim.x * kWarps)  // 2: attention
    attend(p, u / p.n_head, u % p.n_head, scores);
  sync(3);
  gemm_phase<bf16>(sm, p.act, p.wo, p.part, M, C, C, p.s_o);  // 3: wo
  sync(4);
  for (int r = blockIdx.x; r < M; r += gridDim.x)  // 4: residual + LN2
    residual_ln_row(p.part, p.s_o, nullptr, p.bo, p.x, p.x2, p.ln2_w, p.ln2_b, p.act, r, M, C, p.eps, red);
  sync(5);
  gemm_phase<bf16>(sm, p.act, p.w1, p.part, M, H, C, p.s_1);  // 5: w1
  sync(6);
  for (size_t i = thread0; i < (size_t)M * H / 2; i += threads) {  // 6: bias + gelu
    const size_t idx = 2 * i;
    const float2 s = sum_parts2(p.part, p.s_1, (size_t)M * H, idx);
    const float2 b = load_bf16x2(p.b1 + idx % H);
    store_bf16x2(p.t1 + idx, gelu(s.x + b.x, p.gelu_sigmoid), gelu(s.y + b.y, p.gelu_sigmoid));
  }
  sync(7);
  gemm_phase<bf16>(sm, p.t1, p.w2, p.part, M, C, H, p.s_2);  // 7: w2
  sync(8);
  for (size_t i = thread0; i < (size_t)M * C / 2; i += threads) {  // 8: bias + residual
    const size_t idx = 2 * i;
    const float2 s = sum_parts2(p.part, p.s_2, (size_t)M * C, idx);
    const float2 b = load_bf16x2(p.b2 + idx % C);
    const float2 xv = load_bf16x2_cg(p.x2 + idx);
    store_bf16x2(p.out + idx, xv.x + round_bf16(s.x + b.x), xv.y + round_bf16(s.y + b.y));
  }
  if (threadIdx.x == 0) atomicMax(&phase_ns[9], global_ns());
}

int grid_cache[16];

}  // namespace

// x, out: [M, C]; k_cache, v_cache: [M, T, C]; wqkv: [3C, C]; wo: [C, C];
// w1: [H, C]; w2: [C, H]; biases and LN parameters of their widths; all bf16
// and contiguous. C == n_head * 64, H % 64 == 0, window <= fused::kMaxWindow.
// work: kMaxSplits * M * max(3C, H) fp32, then 2 * M * C + M * H bf16.
// Attends rows < min(cur_len, window), writes row cur_len (< T). Returns the
// launch's cudaError_t (cudaErrorCooperativeLaunchTooLarge if the grid
// cannot be co-resident), or cudaGetLastError() after it.
extern "C" int rq_decode_layer_step(const void* x, void* k_cache, void* v_cache, const void* ln1_w,
                                    const void* ln1_b, const void* wqkv, const void* bqkv,
                                    const void* wo, const void* bo, const void* ln2_w,
                                    const void* ln2_b, const void* w1, const void* b1,
                                    const void* w2, const void* b2, void* out, void* work, int M,
                                    int T, int C, int H, int n_head, int window, int cur_len,
                                    int gelu_sigmoid, float eps, void* stream) {
  int grid = 0;
  int err = coop_grid((const void*)decode_layer_step_kernel, grid_cache, &grid);
  if (err) return err;
  const int n_mt = (M + kBM - 1) / kBM;
  const size_t part_elems = (size_t)kMaxSplits * M * (3 * C > H ? 3 * C : H);
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.k_cache = static_cast<bf16*>(k_cache);
  p.v_cache = static_cast<bf16*>(v_cache);
  p.ln1_w = static_cast<const bf16*>(ln1_w);
  p.ln1_b = static_cast<const bf16*>(ln1_b);
  p.wqkv = static_cast<const bf16*>(wqkv);
  p.bqkv = static_cast<const bf16*>(bqkv);
  p.wo = static_cast<const bf16*>(wo);
  p.bo = static_cast<const bf16*>(bo);
  p.ln2_w = static_cast<const bf16*>(ln2_w);
  p.ln2_b = static_cast<const bf16*>(ln2_b);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.out = static_cast<bf16*>(out);
  p.part = static_cast<float*>(work);
  p.act = reinterpret_cast<bf16*>(p.part + part_elems);
  p.x2 = p.act + (size_t)M * C;
  p.t1 = p.x2 + (size_t)M * C;
  p.M = M;
  p.T = T;
  p.C = C;
  p.H = H;
  p.n_head = n_head;
  p.n_valid = cur_len < window ? cur_len : window;
  p.cur_len = cur_len;
  p.gelu_sigmoid = gelu_sigmoid;
  p.s_qkv = pick_splits(n_mt * (3 * C / kBN), C, grid);
  p.s_o = pick_splits(n_mt * (C / kBN), C, grid);
  p.s_1 = pick_splits(n_mt * (H / kBN), C, grid);
  p.s_2 = pick_splits(n_mt * (C / kBN), H, grid);
  p.eps = eps;
  p.scale = 1.0f / sqrtf((float)kHeadSize);
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)decode_layer_step_kernel, dim3(grid),
                                                    dim3(kThreads), args, kSmemBytes,
                                                    (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The globaltimer (ns) at the start of the last rq_decode_layer_step launch
// and after each of its nine phases, into host memory out[10]. Synchronous.
extern "C" int rq_decode_layer_step_phase_ns(void* out) {
  return (int)cudaMemcpyFromSymbol(out, phase_ns, sizeof(phase_ns));
}
