// The int8 weight-streaming MLP with an explicit pipeline of weight-chunk
// copies, on Hopper (sm_90a): the first design of #17, #18 and #20, kept
// only as the A/B baselines that chip_smoke.py runs:
//
//   rq_q8_ring_mlp, full form (#17 / #18):
//     x2  = x + bf16(acc_o * s_o + bo),        acc_o = y @ wo^T
//     h   = LN2(x2)
//     t_j = bf16(gelu(acc_1j * s_1j + b1_j)),  acc_1j = h @ w1[chunk j]^T
//     out = x2 + bf16(acc_2 * s_2 + b2),       acc_2 = sum_j t_j @ w2[:, chunk j]^T
//   rq_q8_ring_mlp, MLP-only form (#20, int8 or bf16 weights):
//     t_j = bf16(gelu?(acc_1j * s_1j?)),  out = bf16(sum_j t_j @ w2[:, chunk j]^T)
//
// The first design of tools/exp_q8_pipeline.py::fused_proj_mlp_q8_ring
// (#17, w2 in the [C, H] layout, its chunk j the strided columns
// j*chunk..) and ::fused_proj_mlp_q8_packed (#18, w2 packed [nc, C, chunk],
// one contiguous block per chunk), and of ::ablate_ring (#20): one kernel,
// templated on the w2 chunk address (kPacked). #17 / #18 now launch
// csrc/decode_dense.cu::rq_fused_proj_mlp (#6's kernel, #18 through a
// tensor map of the packed w2) and #20 csrc/dense_mlp.cu; this kernel stays
// as their A/B baseline (fused_proj_mlp_q8_ring_v1, _packed_v1,
// ablate_ring_v1), which only chip_smoke.py runs; #19 ::stream_probe, which
// this file's cp.async ring also served, is csrc/stream_probe.cu on
// decode_dense.cuh's TMA ring. w1 is [H, C] in the port's nn.Linear
// layout, so its chunk j (rows j*chunk..) is contiguous in both layouts, and
// packing it [nc, chunk, C] changes no byte. The stream loop (Ring) is
// csrc/ring.cuh's.
//
// Bound on the H100: weight bytes. At B 100, C 1536, H 6144 a call streams
// 21.2 MB of int8 weights (2.4 MB wo, 18.9 MB w1 + w2) for ~2 * B = 200
// FLOP per weight element, far below the ~295 FLOP/B ridge: 6.3 us at
// 3.35 TB/s. The port's shipped #6 (csrc/decode_layer.cu) takes ~216 us:
// six launches, split-K partials through device memory, and no pipelining.
//
// Design. One cooperative persistent launch of G = (number of SMs) blocks,
// one per SM, 8 warps each. The unit of the weight stream is the chunk,
// the hidden slice whose w1 rows and w2 columns travel together, as on the
// TPU. Each chunk is split across the blocks: block b owns a balanced range
// of 8-row tiles of the chunk's w1 rows (its hidden units) and a range of
// 8-row tiles of w2's rows (its output columns, the same for every chunk
// and for wo). A stage is the block's share of one chunk: n1 * 8 rows of C
// weights and n2 * 8 rows of `chunk` weights, each row padded by 16 bytes
// (conflict-free fragment reads). n_buf stages are kept in flight with
// 16-byte cp.async.cg copies, one commit group per chunk: the prologue
// issues chunks 0 .. n_buf-1 before anything else (before the wo product,
// as the TPU ring fills before its projection), chunk j is waited for with
// cp.async.wait_group(n_buf - 1), and its stage is refilled with chunk
// j + n_buf only after both products that read it, so n_buf - 1 chunk
// copies are in flight while one chunk computes. Stage bytes at G = 132,
// int8: chunk 1536: 2 * 8 * (1536 + 16) * 2 = 49,664 B (n_buf 4: 194 KB);
// chunk 768: 24,960 B (n_buf 6: 146 KB); chunk 512: 20,864 B (n_buf 6: 122
// KB); chunk 3072: 3 * 8 * 1552 + 2 * 8 * 3088 = 86,656 B (n_buf 2: 169
// KB, n_buf 3: 254 KB, over the 227 KB a block may hold: refused); bf16
// weights double the row bytes (chunk 1536, n_buf 2: 193 KB).
//
// The sum over H stays inside the blocks: t_j (bf16 [B, chunk], 0.3 MB) is
// written to device memory by the w1 product, one grid barrier per chunk
// makes it whole, and each block then adds t_j @ w2-share^T into fp32
// registers for its own output columns, so the w2 product needs no
// partial sums and its order is fixed (deterministic). LN2 needs all of x2
// (grid barrier after the wo product), the w1 product all of h (barrier
// after LN2). The copies of later chunks stay in flight across every
// barrier. Products are bf16 tensor-core products (mma.sync m16n8k16, fp32
// accumulation): activations are the A operand, read from L2 (h, t and y
// are 0.3 MB), warp w taking rows 16 w .. 16 w + 15 (M <= 128); weights
// the B operand, widened from int8 to bf16 as each fragment is read from
// the landed stage (exact); for bf16 weights the widening is compiled out.
// Column scales multiply the fp32 sums at the JAX rounding points. wo
// (2.4 MB, read once before the loop) is read straight from device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ring.cuh"

namespace {

using namespace ring;
struct MlpParams {
  const bf16 *x, *y;                // full form: [M, C]
  const int8_t* wo;                 // [C, C]
  const bf16 *wo_s, *bo, *ln_w, *ln_b;
  const void* w1;                   // [H, C] (= packed [nc, chunk, C])
  const bf16 *w1_s, *b1;            // [H]
  const void* w2;                   // [C, H] or packed [nc, C, chunk]
  const bf16 *w2_s, *b2;            // [C]
  const bf16* h_in;                 // MLP-only form: the input [M, C]
  bf16 *out, *x2, *h, *t;           // out, x2, h [M, C]; t [M, H]
  int M, C, H, chunk, n_buf;
  float eps;
};

template <typename WT, bool kPacked, bool kFull, int kGelu, bool kScale>
__global__ void __launch_bounds__(kMlpThreads, 1) ring_mlp_kernel(MlpParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * kMlpWarps];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x;
  const int M = p.M, C = p.C, H = p.H, chunk = p.chunk, nc = H / chunk;
  const Ring ring = make_ring(p.w1, p.w2, smem, C, H, chunk, (int)sizeof(WT), p.n_buf, kPacked, b, G);
  const int c0 = ring.lo2 * 8;  // this block's first output column

  ring.prologue(nc);

  const bf16* h = p.h_in;
  if constexpr (kFull) {
    // x2[:, own columns] = x + bf16(y @ wo^T * s_o + bo)
    float acc[kNT][4];
    zero(acc);
    mma_rows<int8_t>(acc, p.y, C, M, reinterpret_cast<const unsigned char*>(p.wo + (size_t)c0 * C), C,
                     ring.n2, C);
    for_pairs(acc, ring.n2, M, [&](int row, int col, float v0, float v1) {
      const int c = c0 + col;
      const float2 s = fused::load_bf16x2(p.wo_s + c), bb = fused::load_bf16x2(p.bo + c);
      const float2 xv = fused::load_bf16x2(p.x + (size_t)row * C + c);
      fused::store_bf16x2(p.x2 + (size_t)row * C + c, xv.x + fused::round_bf16(v0 * s.x + bb.x),
                          xv.y + fused::round_bf16(v1 * s.y + bb.y));
    });
    grid.sync();
    for (int r = b; r < M; r += G)
      layer_norm_row<bf16>(p.x2 + (size_t)r * C, p.ln_w, p.ln_b, p.h + (size_t)r * C, C, p.eps, red);
    grid.sync();
    h = p.h;
  }

  float acc2[kNT][4];
  zero(acc2);
  for (int j = 0; j < nc; ++j) {
    const int slot = j % p.n_buf;
    ring.wait();
    if (ring.n1 > 0) {
      // t[:, own hidden units of chunk j] = bf16(gelu(h @ w1_j^T * s_1 + b1))
      float acc1[kNT][4];
      zero(acc1);
      mma_rows<WT>(acc1, h, C, M, ring.stage1(slot), ring.g.ld1, ring.n1, C);
      const int h0 = j * chunk + ring.lo1 * 8;
      for_pairs(acc1, ring.n1, M, [&](int row, int col, float v0, float v1) {
        const int c = h0 + col;
        if constexpr (kScale) {
          const float2 s = fused::load_bf16x2(p.w1_s + c);
          v0 *= s.x;
          v1 *= s.y;
        }
        if constexpr (kFull) {
          const float2 bb = fused::load_bf16x2(p.b1 + c);
          v0 += bb.x;
          v1 += bb.y;
        }
        fused::store_bf16x2(p.t + (size_t)row * H + c, gelu<kGelu>(v0), gelu<kGelu>(v1));
      });
    }
    grid.sync();  // t[:, chunk j] is whole
    if (ring.n2 > 0) mma_rows<WT>(acc2, p.t + (size_t)j * chunk, H, M, ring.stage2(slot), ring.g.ld2, ring.n2, chunk);
    ring.refill(j, nc);
  }

  for_pairs(acc2, ring.n2, M, [&](int row, int col, float v0, float v1) {
    const int c = c0 + col;
    bf16* o = p.out + (size_t)row * C + c;
    if constexpr (kFull) {
      const float2 s = fused::load_bf16x2(p.w2_s + c), bb = fused::load_bf16x2(p.b2 + c);
      const float2 xv = fused::load_bf16x2_cg(p.x2 + (size_t)row * C + c);
      fused::store_bf16x2(o, xv.x + fused::round_bf16(v0 * s.x + bb.x), xv.y + fused::round_bf16(v1 * s.y + bb.y));
    } else {
      fused::store_bf16x2(o, v0, v1);
    }
  });
}

template <typename WT, bool kPacked, bool kFull, int kGelu, bool kScale>
int launch_mlp(MlpParams& p, int grid, cudaStream_t stream) {
  const size_t smem = (size_t)p.n_buf * stage_geom(p.C, p.chunk, (int)sizeof(WT), grid).bytes;
  void* args[] = {&p};
  return coop_launch((const void*)ring_mlp_kernel<WT, kPacked, kFull, kGelu, kScale>, grid, kMlpThreads, smem,
                     args, stream);
}

template <typename WT>
int launch_ablate(MlpParams& p, int grid, int gelu, int scale, cudaStream_t s) {
  if (gelu && scale) return launch_mlp<WT, true, false, 1, true>(p, grid, s);
  if (gelu) return launch_mlp<WT, true, false, 1, false>(p, grid, s);
  if (scale) return launch_mlp<WT, true, false, 0, true>(p, grid, s);
  return launch_mlp<WT, true, false, 0, false>(p, grid, s);
}

}  // namespace

// The ring MLP over `grid` blocks (at most one per SM), n_buf stages
// (2..8). full = 1: #17 / #18, int8 weights: x, y [M, C]; wo [C, C]; w1
// [H, C]; w2 [C, H] (packed = 0) or [nc, C, chunk] (packed = 1); scales and
// biases of their widths; LN2 [C]; gelu 1 (erf) or 2 (sigmoid form); h_in
// unused. full = 0: #20, packed weights only, int8 (bf16_weights = 0) or
// bf16: h_in [M, C]; w1_s [H] (read when scale = 1); gelu 0 or 1; x, y, wo,
// the biases, LN2 and w2_s unused. Activations bf16, M <= 128, C % 32 ==
// 0, chunk % 32 == 0, H % chunk == 0, at most 4 eight-row tiles per block
// and share. Scratch: x2, h [M, C], t [M, H] bf16. Returns the launch's
// cudaError_t (cudaErrorInvalidValue: the stages overflow a block's shared
// memory, or an unsupported form), or cudaGetLastError() after it.
extern "C" int rq_q8_ring_mlp(const void* x, const void* y, const void* wo, const void* wo_s,
                              const void* bo, const void* ln_w, const void* ln_b, const void* w1,
                              const void* w1_s, const void* b1, const void* w2, const void* w2_s,
                              const void* b2, const void* h_in, void* out, void* x2, void* h, void* t,
                              int M, int C, int H, int chunk, int n_buf, int grid, int packed, int full,
                              int gelu, int scale, int bf16_weights, float eps, void* stream) {
  if (n_buf < 1 || n_buf > 8 || M > kMlpWarps * 16 || C % 32 || chunk % 32 || H % chunk ||
      max_share(chunk / 8, grid) > kNT || max_share(C / 8, grid) > kNT)
    return (int)cudaErrorInvalidValue;
  MlpParams p;
  p.x = in<bf16>(x);
  p.y = in<bf16>(y);
  p.wo = in<int8_t>(wo);
  p.wo_s = in<bf16>(wo_s);
  p.bo = in<bf16>(bo);
  p.ln_w = in<bf16>(ln_w);
  p.ln_b = in<bf16>(ln_b);
  p.w1 = w1;
  p.w1_s = in<bf16>(w1_s);
  p.b1 = in<bf16>(b1);
  p.w2 = w2;
  p.w2_s = in<bf16>(w2_s);
  p.b2 = in<bf16>(b2);
  p.h_in = in<bf16>(h_in);
  p.out = static_cast<bf16*>(out);
  p.x2 = static_cast<bf16*>(x2);
  p.h = static_cast<bf16*>(h);
  p.t = static_cast<bf16*>(t);
  p.M = M;
  p.C = C;
  p.H = H;
  p.chunk = chunk;
  p.n_buf = n_buf;
  p.eps = eps;
  const cudaStream_t s = (cudaStream_t)stream;
  if (full) {
    if (bf16_weights || !scale || (gelu != 1 && gelu != 2)) return (int)cudaErrorInvalidValue;
    if (packed)
      return gelu == 1 ? launch_mlp<int8_t, true, true, 1, true>(p, grid, s)
                       : launch_mlp<int8_t, true, true, 2, true>(p, grid, s);
    return gelu == 1 ? launch_mlp<int8_t, false, true, 1, true>(p, grid, s)
                     : launch_mlp<int8_t, false, true, 2, true>(p, grid, s);
  }
  if (!packed || gelu > 1) return (int)cudaErrorInvalidValue;
  return bf16_weights ? launch_ablate<bf16>(p, grid, gelu, scale, s)
                      : launch_ablate<int8_t>(p, grid, gelu, scale, s);
}
