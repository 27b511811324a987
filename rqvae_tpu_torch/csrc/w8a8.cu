// The W8A8 decode proj + LN2 + MLP on Hopper (sm_90a): int8 weights and
// int8 activations, both MLP products on the int8 tensor cores
// (mma.sync m16n8k32 s8 x s8 -> s32), nothing widened to bf16:
//
//   x2   = x + bf16(acc_o * s_o + bo),        acc_o = y @ wo^T (bf16 product, #6's step)
//   h    = LN2(x2) in fp32 (never rounded to bf16)
//   hq   = clip(rint(h / hs), +-127),          hs = max(max_c |h| / 127, 1e-8) per row
//   t_j  = gelu(s32(hq @ w1[chunk j]^T) * hs * s_1j + b1_j) in fp32
//   tq_j = clip(rint(t_j / ts_j), +-127),      ts_j = max(max over chunk j |t_j| / 127, 1e-8) per row
//   acc  = sum_j s32(tq_j @ w2[:, chunk j]^T) * ts_j   (fp32, in chunk order)
//   out  = x2 + bf16(acc * s_2 + b2)
//
// The first design of tools/exp_w8a8.py::fused_proj_mlp_q8a8 (#16): #16
// now launches csrc/dense_w8a8.cu (s8 wgmma on csrc/decode_dense.cu's
// machinery, one persistent launch); this kernel stays as its A/B baseline
// (fused_proj_mlp_q8a8_v1), which only chip_smoke.py runs. Weights in the
// port's nn.Linear layout: wo [C, C], w1 [H, C], w2 [C, H], int8 with bf16
// per-output-channel scales. `chunk` is part of the result, not only a
// tiling: ts_j is taken per row over the chunk's hidden units.
//
// Bound on the H100: weight bytes. At B 100, C 1536, H 6144 a call reads
// 21.2 MB of int8 weights, 6.3 us at 3.35 TB/s; the int8 products take
// 2 B 2 C H = 3.8 GOP, 1.9 us at 1,979 TOP/s, the bf16 wo product 0.5 us
// at 989 TFLOP/s.
//
// Design: csrc/q8_pipeline.cu's (#17), through csrc/ring.cuh: one
// cooperative launch of one block per SM, the per-chunk cp.async weight
// ring, n_buf stages in flight, a block owning 8-row tiles of each chunk's
// w1 rows and of w2's rows (its output columns). What is new:
// - hq is made once, after LN2's barrier, one block per row: the row's
//   fp32 LN values are computed twice (max, then quantize) by the same
//   rounded operations, so the two passes agree bit for bit.
// - The row max of |t_j| over the whole chunk is needed before any block
//   can quantize t_j. Each block writes its t_j columns in fp32 [M, H] and
//   does one atomicMax per row on the bits of its max |t| (non-negative
//   floats order like their bits) into a [nc, M] buffer the wrapper zeroes,
//   before the chunk's grid barrier, so ts_j does not depend on the order
//   of the atomics. After that barrier each block quantizes its own columns
//   of t_j into tq [M, H] int8, and a second barrier per chunk makes tq_j
//   whole for the w2 product. (A first version quantized t_j as each block
//   loaded it as the A operand, with no second barrier: every block then
//   read all of t_j in fp32 from L2 and did M x chunk IEEE divisions per
//   chunk, 0.378 ms a call against this form's; PERF.md.)
// - Products: lane 4g + q reads 16 neighbouring int8 k (one 16-byte load)
//   of rows g and g + 8 of A and row g of W per 64-wide k block, two
//   m16n8k32 steps; A and W see the same permutation of k, and integer sums
//   are exact whatever their order, so kernel and plain version differ only
//   where an fp32 value lands on the other side of a rounding half in hq or
//   tq (different LN sums, rsqrtf, erff).
// - Rows in groups of 128 (8 warps x 16): M <= 512, the w2 sums of each
//   group in registers across the chunks.
// Divisions are IEEE (__fdiv_rn: the build has no --use_fast_math),
// rounding is rint (__float2int_rn, half to even), and the scale, bias
// and accumulate steps are rounded one by one (__fmul_rn / __fadd_rn) in
// the plain version's order, so that no contraction into an FMA moves a
// value across a rounding half.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ring.cuh"

namespace {

using namespace ring;

struct A8Params {
  const bf16 *x, *y;          // [M, C]
  const int8_t* wo;           // [C, C]
  const bf16 *wo_s, *bo, *ln_w, *ln_b;  // [C]
  const int8_t *w1, *w2;      // [H, C], [C, H]
  const bf16 *w1_s, *b1;      // [H]
  const bf16 *w2_s, *b2;      // [C]
  bf16 *out, *x2;             // [M, C]
  int8_t* hq;                 // [M, C]
  float* hs;                  // [M]
  float* t;                   // [M, H]
  int8_t* tq;                 // [M, H]
  unsigned* tmax;             // [nc, M], zero at launch: bits of max |t_j| per row
  int M, C, H, chunk, n_buf;
  float eps;
};

__device__ __forceinline__ void mma16832(int (&d)[4], unsigned a0, unsigned a1, unsigned a2, unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// a row's activation scale from its max |value|: divide, then the floor
// (tools/exp_w8a8.py:72-73; the weight quantizer floors first)
__device__ __forceinline__ float act_scale(float amax) { return fmaxf(__fdiv_rn(amax, 127.f), 1e-8f); }

// clip(rint(v / s), -127, 127) in the low byte
__device__ __forceinline__ unsigned quant_byte(float v, float s) {
  return (unsigned)min(max(__float2int_rn(__fdiv_rn(v, s)), -127), 127) & 0xFFu;
}

// acc[n] += A[rows 16 warp .. 16 warp + 16, 0:K] @ W[8 n .. 8 n + 8, 0:K]^T
// in int32 for n < nt, K % 64 == 0. A: int8 rows of stride lda bytes,
// written before the last grid barrier (read through L2; rows >= M are
// zeros). W: int8 rows of stride ldw bytes in shared memory. The A loads
// of kU k blocks are issued together. Lane 4g + q reads k 16q .. 16q + 15
// of each 64-wide k block: the first m16n8k32 takes 16q .. 16q + 3 where
// the instruction expects 4q .. 4q + 3 and 16q + 4 .. 16q + 7 where it
// expects 16 + 4q .. 16 + 4q + 3, the second 16q + 8 .. 16q + 15 the same
// way. The fragment sums rows g, g + 8 x columns 2q, 2q + 1.
__device__ __forceinline__ void imma_rows(int (&acc)[kNT][4], const int8_t* A, size_t lda, int M,
                                          const unsigned char* W, int ldw, int nt, int K) {
  constexpr int kU = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = 16 * warp + g;
  if (16 * warp >= M) return;
  for (int k = 0; k < K; k += 64 * kU) {
    uint4 a[kU][2];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kk = k + 64 * u + 16 * q;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        a[u][i] = k + 64 * u < K && r < M ? __ldcg(reinterpret_cast<const uint4*>(A + (size_t)r * lda + kk))
                                          : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (k + 64 * u >= K) break;
      const int kk = k + 64 * u + 16 * q;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        if (n < nt) {
          const uint4 w = *reinterpret_cast<const uint4*>(W + (size_t)(8 * n + g) * ldw + kk);
          mma16832(acc[n], a[u][0].x, a[u][1].x, a[u][0].y, a[u][1].y, w.x, w.y);
          mma16832(acc[n], a[u][0].z, a[u][1].z, a[u][0].w, a[u][1].w, w.z, w.w);
        }
      }
    }
  }
}

// one LN2 value in fp32: ((x - mean) * rstd) * g + b, each step rounded
__device__ __forceinline__ float ln_value(float x, float2 st, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, st.x), st.y), g), b);
}

// row r: h = LN2(x2) in fp32, hs = act_scale(max |h|), hq = quant(h, hs)
__device__ void quant_ln_row(const A8Params& p, int r, float* red) {
  const int C = p.C;
  const bf16* xr = p.x2 + (size_t)r * C;
  const float2 st = row_stats(xr, C, p.eps, red);
  float mx = 0.f;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * kMlpThreads) {
    const float2 v = fused::load_bf16x2_cg(xr + c), g = load2(p.ln_w + c), b = load2(p.ln_b + c);
    mx = fmaxf(mx, fmaxf(fabsf(ln_value(v.x, st, g.x, b.x)), fabsf(ln_value(v.y, st, g.y, b.y))));
  }
  mx = fused::warp_max(mx);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  mx = 0.f;
#pragma unroll
  for (int i = 0; i < kMlpWarps; ++i) mx = fmaxf(mx, red[i]);
  __syncthreads();  // red is free for the next row
  const float s = act_scale(mx);
  for (int c = 2 * threadIdx.x; c < C; c += 2 * kMlpThreads) {
    const float2 v = fused::load_bf16x2_cg(xr + c), g = load2(p.ln_w + c), b = load2(p.ln_b + c);
    const unsigned q = quant_byte(ln_value(v.x, st, g.x, b.x), s) | (quant_byte(ln_value(v.y, st, g.y, b.y), s) << 8);
    *reinterpret_cast<unsigned short*>(p.hq + (size_t)r * C + c) = (unsigned short)q;
  }
  if (threadIdx.x == 0) p.hs[r] = s;
}

template <int kGelu>
__global__ void __launch_bounds__(kMlpThreads, 1) w8a8_kernel(A8Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * kMlpWarps];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x;
  const int M = p.M, C = p.C, H = p.H, chunk = p.chunk, nc = H / chunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Ring ring = make_ring(p.w1, p.w2, smem, C, H, chunk, 1, p.n_buf, false, b, G);
  const int c0 = ring.lo2 * 8;  // this block's first output column

  ring.prologue(nc);

  // x2[:, own columns] = x + bf16(y @ wo^T * s_o + bo): #6's step, wo read
  // once from device memory and widened (exact) into bf16 products
  const unsigned char* wo = reinterpret_cast<const unsigned char*>(p.wo + (size_t)c0 * C);
#pragma unroll 1
  for (int g0 = 0; g0 < M; g0 += kGroupRows) {
    float acc[kNT][4];
    zero(acc);
    mma_rows<int8_t>(acc, p.y + (size_t)g0 * C, C, M - g0, wo, C, ring.n2, C);
    for_pairs(acc, ring.n2, M - g0, [&](int row, int col, float v0, float v1) {
      const int c = c0 + col;
      const size_t i = (size_t)(g0 + row) * C + c;
      const float2 s = fused::load_bf16x2(p.wo_s + c), bb = fused::load_bf16x2(p.bo + c);
      const float2 xv = fused::load_bf16x2(p.x + i);
      fused::store_bf16x2(p.x2 + i, xv.x + fused::round_bf16(v0 * s.x + bb.x),
                          xv.y + fused::round_bf16(v1 * s.y + bb.y));
    });
  }
  grid.sync();  // x2 is whole
  for (int r = b; r < M; r += G) quant_ln_row(p, r, red);
  grid.sync();  // hq and hs are whole

  float acc2[kMaxGroups][kNT][4];
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) zero(acc2[gi]);
  for (int j = 0; j < nc; ++j) {
    const int slot = j % p.n_buf;
    unsigned* amax = p.tmax + (size_t)j * M;
    ring.wait();
    if (ring.n1 > 0) {
      const int h0 = j * chunk + ring.lo1 * 8;  // this block's first hidden unit of chunk j
#pragma unroll 1
      for (int g0 = 0; g0 < M; g0 += kGroupRows) {
        int acc1[kNT][4];
        zero(acc1);
        imma_rows(acc1, p.hq + (size_t)g0 * C, C, M - g0, ring.stage1(slot), ring.g.ld1, ring.n1, C);
        // t = gelu(float(acc) * hs * s_1 + b1) for the own hidden units, in
        // fp32, and each row's max |t| over them
        const int r = g0 + 16 * warp + (lane >> 2);
        float mx[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (n >= ring.n1) continue;
          const int c = h0 + 8 * n + 2 * (lane & 3);
          const float2 s = fused::load_bf16x2(p.w1_s + c), bb = fused::load_bf16x2(p.b1 + c);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = r + 8 * i;
            if (row >= M) continue;
            const float hs = __ldcg(p.hs + row);
            const float t0 = gelu<kGelu>(__fadd_rn(__fmul_rn(__fmul_rn((float)acc1[n][2 * i], hs), s.x), bb.x));
            const float t1 = gelu<kGelu>(__fadd_rn(__fmul_rn(__fmul_rn((float)acc1[n][2 * i + 1], hs), s.y), bb.y));
            *reinterpret_cast<float2*>(p.t + (size_t)row * H + c) = make_float2(t0, t1);
            mx[i] = fmaxf(mx[i], fmaxf(fabsf(t0), fabsf(t1)));
          }
        }
        // the 4 lanes of a row hold its columns: one atomic per row and block
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          if ((lane & 3) == 0 && r + 8 * i < M) atomicMax(amax + r + 8 * i, __float_as_uint(mx[i]));
        }
      }
    }
    grid.sync();  // t[:, chunk j] and its row maxima are whole
    if (ring.n1 > 0) {
      // tq[:, own hidden units of chunk j] = quant(t, ts_j), two at a time
      const int h0 = j * chunk + ring.lo1 * 8, half = ring.n1 * 4;
      for (int i = threadIdx.x; i < M * half; i += kMlpThreads) {
        const int row = i / half;
        const size_t at = (size_t)row * H + h0 + 2 * (i % half);
        const float s = act_scale(__uint_as_float(__ldcg(amax + row)));
        const float2 v = __ldcg(reinterpret_cast<const float2*>(p.t + at));
        *reinterpret_cast<unsigned short*>(p.tq + at) = (unsigned short)(quant_byte(v.x, s) | (quant_byte(v.y, s) << 8));
      }
    }
    grid.sync();  // tq[:, chunk j] is whole
    if (ring.n2 > 0) {
#pragma unroll
      for (int gi = 0; gi < kMaxGroups; ++gi) {
        const int g0 = gi * kGroupRows;
        if (g0 >= M) break;
        int m32[kNT][4];
        zero(m32);
        imma_rows(m32, p.tq + (size_t)g0 * H + (size_t)j * chunk, H, M - g0, ring.stage2(slot), ring.g.ld2, ring.n2,
                  chunk);
        // acc += float(m32) * ts_j, row by row
        const int r = g0 + 16 * warp + (lane >> 2);
        float ts[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ts[i] = r + 8 * i < M ? act_scale(__uint_as_float(__ldcg(amax + r + 8 * i))) : 0.f;
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc2[gi][n][e] = __fadd_rn(acc2[gi][n][e], __fmul_rn((float)m32[n][e], ts[e >> 1]));
      }
    }
    ring.refill(j, nc);
  }

  // out = x2 + bf16(acc * s_2 + b2) for the own output columns
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
    const int g0 = gi * kGroupRows;
    if (g0 >= M) break;
    for_pairs(acc2[gi], ring.n2, M - g0, [&](int row, int col, float v0, float v1) {
      const int c = c0 + col;
      const size_t i = (size_t)(g0 + row) * C + c;
      const float2 s = fused::load_bf16x2(p.w2_s + c), bb = fused::load_bf16x2(p.b2 + c);
      const float2 xv = fused::load_bf16x2_cg(p.x2 + i);
      fused::store_bf16x2(p.out + i, xv.x + fused::round_bf16(__fadd_rn(__fmul_rn(v0, s.x), bb.x)),
                          xv.y + fused::round_bf16(__fadd_rn(__fmul_rn(v1, s.y), bb.y)));
    });
  }
}

template <int kGelu>
int launch(A8Params& p, int grid, cudaStream_t stream) {
  const size_t smem = (size_t)p.n_buf * stage_geom(p.C, p.chunk, 1, grid).bytes;
  void* args[] = {&p};
  return coop_launch((const void*)w8a8_kernel<kGelu>, grid, kMlpThreads, smem, args, stream);
}

}  // namespace

// The W8A8 proj + LN2 + MLP over `grid` blocks (at most one per SM), n_buf
// stages (1..8). x, y [M, C] bf16; wo [C, C], w1 [H, C], w2 [C, H] int8;
// wo_s, bo, ln_w, ln_b, w2_s, b2 [C] and w1_s, b1 [H] bf16; gelu 1 (erf)
// or 2 (sigmoid form). 1 <= M <= 512, C % 64 == 0, chunk % 64 == 0, H %
// chunk == 0, at most 4 eight-row tiles per block and share. Scratch: x2
// [M, C] bf16, hq [M, C] int8, hs [M] and t [M, H] fp32, tq [M, H] int8,
// tmax [H / chunk, M] 32-bit words, zero. Returns the launch's cudaError_t
// (cudaErrorInvalidValue: the stages overflow a block's shared memory, or
// an unsupported shape), or cudaGetLastError() after it.
extern "C" int rq_w8a8_mlp(const void* x, const void* y, const void* wo, const void* wo_s, const void* bo,
                           const void* ln_w, const void* ln_b, const void* w1, const void* w1_s, const void* b1,
                           const void* w2, const void* w2_s, const void* b2, void* out, void* x2, void* hq, void* hs,
                           void* t, void* tq, void* tmax, int M, int C, int H, int chunk, int n_buf, int grid, int gelu,
                           float eps, void* stream) {
  if (n_buf < 1 || n_buf > 8 || M < 1 || M > kMaxGroups * kGroupRows || C % 64 || chunk % 64 || H % chunk ||
      max_share(chunk / 8, grid) > kNT || max_share(C / 8, grid) > kNT || (gelu != 1 && gelu != 2))
    return (int)cudaErrorInvalidValue;
  A8Params p;
  p.x = in<bf16>(x);
  p.y = in<bf16>(y);
  p.wo = in<int8_t>(wo);
  p.wo_s = in<bf16>(wo_s);
  p.bo = in<bf16>(bo);
  p.ln_w = in<bf16>(ln_w);
  p.ln_b = in<bf16>(ln_b);
  p.w1 = in<int8_t>(w1);
  p.w1_s = in<bf16>(w1_s);
  p.b1 = in<bf16>(b1);
  p.w2 = in<int8_t>(w2);
  p.w2_s = in<bf16>(w2_s);
  p.b2 = in<bf16>(b2);
  p.out = static_cast<bf16*>(out);
  p.x2 = static_cast<bf16*>(x2);
  p.hq = static_cast<int8_t*>(hq);
  p.hs = static_cast<float*>(hs);
  p.t = static_cast<float*>(t);
  p.tq = static_cast<int8_t*>(tq);
  p.tmax = static_cast<unsigned*>(tmax);
  p.M = M;
  p.C = C;
  p.H = H;
  p.chunk = chunk;
  p.n_buf = n_buf;
  p.eps = eps;
  const cudaStream_t s = (cudaStream_t)stream;
  return gelu == 1 ? launch<1>(p, grid, s) : launch<2>(p, grid, s);
}
