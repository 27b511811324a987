// The decode-shape MLP on bf16 weights, on Hopper (sm_90a):
//
//   h   = bf16(LN(x))                          (fp32 one-pass statistics, fp32 scale and bias)
//   t_j = bf16(gelu(h @ w1[chunk j]^T + b1_j))  (fp32 sums, gelu in fp32)
//   out = bf16(x + acc + b2),                  acc = sum_j t_j @ w2[:, chunk j]^T in fp32
//
// Replaces tools/exp_mlp_kernel.py::pallas_mlp (#15): the decode MLP with
// no wo, the output rounded once (where #3, #6 and #17 round the MLP's
// output before the residual). Weights in the port's nn.Linear layout: w1
// [H, C], w2 [C, H], bf16.
//
// Bound on the H100: at B 100 weight bytes, 37.7 MB of bf16 w1 + w2, 11.3
// us at 3.35 TB/s; at B 500 operations, 2 B 2 C H = 18.9 GFLOP, 19.1 us
// at 989 TFLOP/s.
//
// Design: csrc/q8_pipeline.cu's full form (#17) on bf16 weights, through
// csrc/ring.cuh: one cooperative launch of one block per SM, the per-chunk
// cp.async weight ring (n_buf stages; bf16 chunk 1536 takes 98,816 B a
// stage at 132 blocks, so two fit), a block owning 8-row tiles of each
// chunk's w1 rows and of w2's rows (its output columns), t_j made whole by
// one grid barrier per chunk, bf16 tensor-core products (mma.sync
// m16n8k16, fp32 sums) with the activations read from L2. What is new:
// no wo step (LN reads x, after no barrier), LN's scale and bias in fp32,
// the one-rounding epilogue, and rows in groups of 128 (8 warps x 16), the
// w2 sums of each group in registers across the chunks, for B up to 512
// (the experiment's B 500): the weights are still read once per call. Each
// block reads all of h and t once per chunk and group (from L2), which at
// B 500 is 0.8 GB a call for each product against 38 MB of weights.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ring.cuh"

namespace {

using namespace ring;

struct Params {
  const bf16* x;              // [M, C]
  const float *ln_w, *ln_b;   // [C]
  const bf16 *w1, *b1;        // [H, C], [H]
  const bf16 *w2, *b2;        // [C, H], [C]
  bf16 *out, *h, *t;          // out, h [M, C]; t [M, H]
  int M, C, H, chunk, n_buf;
  float eps;
};

template <int kGelu>
__global__ void __launch_bounds__(kMlpThreads, 1) mlp_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * kMlpWarps];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x;
  const int M = p.M, C = p.C, H = p.H, chunk = p.chunk, nc = H / chunk;
  const Ring ring = make_ring(p.w1, p.w2, smem, C, H, chunk, 2, p.n_buf, false, b, G);
  const int c0 = ring.lo2 * 8;  // this block's first output column

  ring.prologue(nc);
  for (int r = b; r < M; r += G)
    layer_norm_row<float>(p.x + (size_t)r * C, p.ln_w, p.ln_b, p.h + (size_t)r * C, C, p.eps, red);
  grid.sync();  // h is whole

  float acc2[kMaxGroups][kNT][4];
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) zero(acc2[gi]);
  for (int j = 0; j < nc; ++j) {
    const int slot = j % p.n_buf;
    ring.wait();
    if (ring.n1 > 0) {
      const int h0 = j * chunk + ring.lo1 * 8;  // this block's first hidden unit of chunk j
#pragma unroll 1
      for (int g0 = 0; g0 < M; g0 += kGroupRows) {
        float acc1[kNT][4];
        zero(acc1);
        mma_rows<bf16, 4>(acc1, p.h + (size_t)g0 * C, C, M - g0, ring.stage1(slot), ring.g.ld1, ring.n1, C);
        for_pairs(acc1, ring.n1, M - g0, [&](int row, int col, float v0, float v1) {
          const int c = h0 + col;
          const float2 bb = fused::load_bf16x2(p.b1 + c);
          fused::store_bf16x2(p.t + (size_t)(g0 + row) * H + c, gelu<kGelu>(v0 + bb.x), gelu<kGelu>(v1 + bb.y));
        });
      }
    }
    grid.sync();  // t[:, chunk j] is whole
    if (ring.n2 > 0) {
#pragma unroll
      for (int gi = 0; gi < kMaxGroups; ++gi) {
        const int g0 = gi * kGroupRows;
        if (g0 >= M) break;
        mma_rows<bf16, 4>(acc2[gi], p.t + (size_t)g0 * H + (size_t)j * chunk, H, M - g0, ring.stage2(slot),
                          ring.g.ld2, ring.n2, chunk);
      }
    }
    ring.refill(j, nc);
  }

  // out = bf16((x + acc) + b2) for the own output columns: one rounding
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
    const int g0 = gi * kGroupRows;
    if (g0 >= M) break;
    for_pairs(acc2[gi], ring.n2, M - g0, [&](int row, int col, float v0, float v1) {
      const int c = c0 + col;
      const size_t i = (size_t)(g0 + row) * C + c;
      const float2 xv = fused::load_bf16x2(p.x + i), bb = fused::load_bf16x2(p.b2 + c);
      fused::store_bf16x2(p.out + i, __fadd_rn(__fadd_rn(xv.x, v0), bb.x), __fadd_rn(__fadd_rn(xv.y, v1), bb.y));
    });
  }
}

template <int kGelu>
int launch(Params& p, int grid, cudaStream_t stream) {
  const size_t smem = (size_t)p.n_buf * stage_geom(p.C, p.chunk, 2, grid).bytes;
  void* args[] = {&p};
  return coop_launch((const void*)mlp_kernel<kGelu>, grid, kMlpThreads, smem, args, stream);
}

}  // namespace

// The bf16 decode MLP over `grid` blocks (at most one per SM), n_buf stages
// (1..8). x [M, C], w1 [H, C], b1 [H], w2 [C, H], b2 [C] bf16; ln_w, ln_b
// [C] fp32; gelu 1 (erf) or 2 (sigmoid form). 1 <= M <= 512, C % 32 == 0,
// chunk % 32 == 0, H % chunk == 0, at most 4 eight-row tiles per block and
// share. Scratch: h [M, C], t [M, H] bf16. Returns the launch's
// cudaError_t (cudaErrorInvalidValue: the stages overflow a block's shared
// memory, or an unsupported shape), or cudaGetLastError() after it.
extern "C" int rq_mlp(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* out, void* h, void* t, int M, int C, int H, int chunk,
                      int n_buf, int grid, int gelu, float eps, void* stream) {
  if (n_buf < 1 || n_buf > 8 || M < 1 || M > kMaxGroups * kGroupRows || C % 32 || chunk % 32 || H % chunk ||
      max_share(chunk / 8, grid) > kNT || max_share(C / 8, grid) > kNT || (gelu != 1 && gelu != 2))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = in<bf16>(x);
  p.ln_w = in<float>(ln_w);
  p.ln_b = in<float>(ln_b);
  p.w1 = in<bf16>(w1);
  p.b1 = in<bf16>(b1);
  p.w2 = in<bf16>(w2);
  p.b2 = in<bf16>(b2);
  p.out = static_cast<bf16*>(out);
  p.h = static_cast<bf16*>(h);
  p.t = static_cast<bf16*>(t);
  p.M = M;
  p.C = C;
  p.H = H;
  p.chunk = chunk;
  p.n_buf = n_buf;
  p.eps = eps;
  const cudaStream_t s = (cudaStream_t)stream;
  return gelu == 1 ? launch<1>(p, grid, s) : launch<2>(p, grid, s);
}
