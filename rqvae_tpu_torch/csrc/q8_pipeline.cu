// The int8 weight-streaming MLP with an explicit pipeline of weight-chunk
// copies, and its two isolation probes, on Hopper (sm_90a):
//
//   rq_q8_ring_mlp, full form (#17 / #18):
//     x2  = x + bf16(acc_o * s_o + bo),        acc_o = y @ wo^T
//     h   = LN2(x2)
//     t_j = bf16(gelu(acc_1j * s_1j + b1_j)),  acc_1j = h @ w1[chunk j]^T
//     out = x2 + bf16(acc_2 * s_2 + b2),       acc_2 = sum_j t_j @ w2[:, chunk j]^T
//   rq_q8_ring_mlp, MLP-only form (#20, int8 or bf16 weights):
//     t_j = bf16(gelu?(acc_1j * s_1j?)),  out = bf16(sum_j t_j @ w2[:, chunk j]^T)
//   rq_q8_stream_probe (#19): the chunk stream alone ("dma": copy every
//     chunk, touch one value per row; "dequant": widen and sum every row).
//
// Replace tools/exp_q8_pipeline.py::fused_proj_mlp_q8_ring (#17, w2 in the
// [C, H] layout, its chunk j the strided columns j*chunk..) and
// ::fused_proj_mlp_q8_packed (#18, w2 packed [nc, C, chunk], one
// contiguous block per chunk): one kernel, templated on the w2 chunk
// address (kPacked). w1 is [H, C] in the port's nn.Linear layout, so its
// chunk j (rows j*chunk..) is contiguous in both layouts, and packing it
// [nc, chunk, C] changes no byte. ::stream_probe (#19) and ::ablate_ring
// (#20) reuse the same stream loop (Ring below).
//
// Bound on the H100: weight bytes. At B 100, C 1536, H 6144 a call streams
// 21.2 MB of int8 weights (2.4 MB wo, 18.9 MB w1 + w2) for ~2 * B = 200
// FLOP per weight element, far below the ~295 FLOP/B ridge: 6.3 us at
// 3.35 TB/s. The port's shipped #6 (csrc/decode_layer.cu) takes ~216 us:
// six launches, split-K partials through device memory, and no pipelining.
//
// Design. One cooperative persistent launch of G = (number of SMs) blocks,
// one per SM, 8 warps each (the probe: 4). The unit of the weight stream is the chunk,
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "fused_layer.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using fused::kThreads;  // the probe's block
using fused::kWarps;

constexpr int kMlpWarps = 8;  // the ring MLP's block: one 16-row tile of activations per warp
constexpr int kMlpThreads = kMlpWarps * 32;

constexpr int kNT = 4;          // most 8-row tiles a block owns in one share
constexpr int kRowPad = 16;     // bytes after each staged row
constexpr int kProbeLanes = 128;

// block b's balanced share [lo, lo + n) of `tiles` tiles over G blocks
__device__ __forceinline__ void share(int tiles, int b, int G, int& lo, int& n) {
  lo = (int)((long long)b * tiles / G);
  n = (int)((long long)(b + 1) * tiles / G) - lo;
}

// the largest share of `tiles` tiles over G blocks (host side too)
__host__ __device__ __forceinline__ int max_share(int tiles, int G) { return (tiles + G - 1) / G; }

__host__ __device__ __forceinline__ size_t align16(size_t v) { return (v + 15) & ~(size_t)15; }

// one stage: w1 rows (n1max * 8 rows of C weights) then w2 rows (n2max * 8
// rows of chunk weights); ld1 / ld2 are row strides in bytes
struct StageGeom {
  int ld1, ld2;
  size_t off2, bytes;
};

__host__ __device__ __forceinline__ StageGeom stage_geom(int C, int chunk, int wbytes, int G) {
  StageGeom s;
  s.ld1 = C * wbytes + kRowPad;
  s.ld2 = chunk * wbytes + kRowPad;
  s.off2 = align16((size_t)max_share(chunk / 8, G) * 8 * s.ld1);
  s.bytes = s.off2 + align16((size_t)max_share(C / 8, G) * 8 * s.ld2);
  return s;
}

// cp.async.wait_group with a run-time depth (n_buf - 1 <= 7)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// The weight stream of one block: where chunk j's share lives in device
// memory and in which stage it lands. w1 [H, C] (or packed [nc, chunk, C],
// the same bytes); w2 [C, H] (kPacked false: chunk j is the columns
// j*chunk.., a strided block) or packed [nc, C, chunk] (one contiguous
// block). Byte addressing; wbytes is the element size.
struct Ring {
  const unsigned char* w1;
  const unsigned char* w2;
  unsigned char* smem;
  StageGeom g;
  int C, H, chunk, wbytes, n_buf, lo1, n1, lo2, n2;
  bool packed;

  __device__ unsigned char* stage1(int slot) const { return smem + (size_t)slot * g.bytes; }
  __device__ unsigned char* stage2(int slot) const { return smem + (size_t)slot * g.bytes + g.off2; }

  // issue the 16-byte copies of chunk j's share into stage `slot` (no commit)
  __device__ void issue(int slot, int j) const {
    const int row1 = C * wbytes / 16, row2 = chunk * wbytes / 16;  // 16-byte pieces per row
    const int r1 = n1 * 8, r2 = n2 * 8;
    unsigned char* s1 = stage1(slot);
    unsigned char* s2 = stage2(slot);
    const unsigned char* src1 = w1 + ((size_t)j * chunk + (size_t)lo1 * 8) * C * wbytes;
    for (int i = threadIdx.x; i < r1 * row1; i += blockDim.x) {
      const int r = i / row1, c = i % row1;
      fused::cp_async16(s1 + (size_t)r * g.ld1 + c * 16, src1 + (size_t)r * C * wbytes + c * 16, true);
    }
    for (int i = threadIdx.x; i < r2 * row2; i += blockDim.x) {
      const int r = i / row2, c = i % row2;
      const size_t col = (size_t)lo2 * 8 + r;  // a row of w2: an output column
      const size_t off = packed ? ((size_t)j * C + col) * chunk : col * H + (size_t)j * chunk;
      fused::cp_async16(s2 + (size_t)r * g.ld2 + c * 16, w2 + off * wbytes + c * 16, true);
    }
  }

  // fill the ring: chunks 0 .. n_buf-1, one commit group each (empty past nc)
  __device__ void prologue(int nc) const {
    for (int s = 0; s < n_buf; ++s) {
      if (s < nc) issue(s, s);
      fused::cp_async_commit();
    }
  }

  // wait until chunk j has landed in its stage, for the whole block: n_buf +
  // j groups are committed, the oldest j + 1 must be complete
  __device__ void wait() const {
    cp_async_wait(n_buf - 1);
    __syncthreads();
  }

  // after every read of chunk j's stage: refill it with chunk j + n_buf
  // (always one commit, so the group count stays n_buf + j + 1)
  __device__ void refill(int j, int nc) const {
    __syncthreads();
    if (j + n_buf < nc) issue(j % n_buf, j + n_buf);
    fused::cp_async_commit();
  }
};

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}

// eight neighbouring weights of a row (8-byte aligned int8, 16-byte aligned
// bf16) as the two B-fragment register pairs of two k-steps
template <typename WT>
__device__ __forceinline__ void b_octet(const unsigned char* row, int k, unsigned (&b)[4]) {
  if constexpr (std::is_same<WT, int8_t>::value) {
    const int2 v = *reinterpret_cast<const int2*>(row + k);
    const int w[2] = {v.x, v.y};
#pragma unroll
    for (int i = 0; i < 2; ++i)  // int8 -> bf16, exact
      b[2 * i] = pack_bf16x2((float)(int8_t)w[i], (float)(int8_t)(w[i] >> 8)),
      b[2 * i + 1] = pack_bf16x2((float)(int8_t)(w[i] >> 16), (float)(int8_t)(w[i] >> 24));
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(row + 2 * k);
    b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
  }
}

__device__ __forceinline__ uint4 a_octet(const bf16* a, size_t lda, int row, int M, int k) {
  return row < M ? __ldcg(reinterpret_cast<const uint4*>(a + (size_t)row * lda + k)) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void mma16816(float (&d)[4], unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[n] += A[rows 16 warp .. 16 warp + 16, 0:K] @ W[8 n .. 8 n + 8, 0:K]^T
// for n < nt; K % 32 == 0. A: bf16 rows of stride lda (read through L2;
// rows >= M are zeros). W: rows of stride ldw bytes, in shared or device
// memory. Lane 4 g + q holds rows g and g + 8 (of A) and g (of W), and
// reads the eight neighbouring k 8q .. 8q + 7 of each 32-wide k block in
// one load: the first k-step takes 8q .. 8q + 3 where m16n8k16 expects k
// 2q, 2q + 1, 2q + 8, 2q + 9, the second 8q + 4 .. 8q + 7. A and W see the
// same permutation of k, so the sums are those of the plain order, up to
// fp32 association; the fragment sums rows g, g + 8 x columns 2q, 2q + 1.
// The A loads of kU k blocks are issued together: the loop is bound by the
// latency of L2, so the loads in flight set its pace.
template <typename WT>
__device__ __forceinline__ void mma_rows(float (&acc)[kNT][4], const bf16* A, size_t lda, int M,
                                         const unsigned char* W, int ldw, int nt, int K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = 16 * warp + g;
  if (16 * warp >= M) return;
  constexpr int kU = 8;
  for (int k = 0; k < K; k += 32 * kU) {
    uint4 a[kU][2];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kk = k + 32 * u + 8 * q;
      const bool ok = kk < K;
      a[u][0] = a_octet(A, lda, ok ? r0 : M, M, kk);
      a[u][1] = a_octet(A, lda, ok ? r0 + 8 : M, M, kk);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kk = k + 32 * u + 8 * q;
      if (k + 32 * u >= K) break;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        if (n < nt) {
          unsigned b[4];
          b_octet<WT>(W + (size_t)(8 * n + g) * ldw, kk, b);
          mma16816(acc[n], a[u][0].x, a[u][1].x, a[u][0].y, a[u][1].y, b[0], b[1]);
          mma16816(acc[n], a[u][0].z, a[u][1].z, a[u][0].w, a[u][1].w, b[2], b[3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kNT][4]) {
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// f(row, col, v0, v1) for each pair of neighbouring sums this lane holds
// (rows < M only); col is the first of the two columns within the share
template <typename F>
__device__ __forceinline__ void for_pairs(const float (&acc)[kNT][4], int nt, int M, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = 16 * warp + (lane >> 2);
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    if (n >= nt) continue;
    const int col = 8 * n + 2 * (lane & 3);
    if (row < M) f(row, col, acc[n][0], acc[n][1]);
    if (row + 8 < M) f(row + 8, col, acc[n][2], acc[n][3]);
  }
}

// y = LayerNorm(xr) of one row of C values (C even), one-pass fp32
// statistics as fused::layer_norm_row, over this kernel's kMlpThreads
__device__ void layer_norm_row(const bf16* xr, const bf16* w, const bf16* b, bf16* y, int C, float eps,
                               float* red) {
  float s1 = 0.f, s2 = 0.f;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * kMlpThreads) {
    const float2 v = fused::load_bf16x2_cg(xr + c);
    s1 += v.x + v.y;
    s2 += v.x * v.x + v.y * v.y;
  }
  s1 = fused::warp_sum(s1);
  s2 = fused::warp_sum(s2);
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s1, red[kMlpWarps + (threadIdx.x >> 5)] = s2;
  __syncthreads();
  s1 = s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kMlpWarps; ++i) s1 += red[i], s2 += red[kMlpWarps + i];
  const float mean = s1 / (float)C;
  const float rstd = rsqrtf(fmaxf(s2 / (float)C - mean * mean, 0.f) + eps);
  for (int c = 2 * threadIdx.x; c < C; c += 2 * kMlpThreads) {
    const float2 v = fused::load_bf16x2_cg(xr + c);
    const float2 g = fused::load_bf16x2(w + c), bb = fused::load_bf16x2(b + c);
    fused::store_bf16x2(y + c, (v.x - mean) * rstd * g.x + bb.x, (v.y - mean) * rstd * g.y + bb.y);
  }
}

template <int kGelu>
__device__ __forceinline__ float gelu(float t) {
  if constexpr (kGelu == 1) return 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
  if constexpr (kGelu == 2) return t / (1.f + expf(-1.702f * t));
  return t;
}

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
  Ring ring;
  ring.w1 = static_cast<const unsigned char*>(p.w1);
  ring.w2 = static_cast<const unsigned char*>(p.w2);
  ring.smem = smem;
  ring.g = stage_geom(C, chunk, (int)sizeof(WT), G);
  ring.C = C;
  ring.H = H;
  ring.chunk = chunk;
  ring.wbytes = (int)sizeof(WT);
  ring.n_buf = p.n_buf;
  ring.packed = kPacked;
  share(chunk / 8, b, G, ring.lo1, ring.n1);
  share(C / 8, b, G, ring.lo2, ring.n2);
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
      layer_norm_row(p.x2 + (size_t)r * C, p.ln_w, p.ln_b, p.h + (size_t)r * C, C, p.eps, red);
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

struct ProbeParams {
  const void* w1;  // packed [nc, chunk, C] bytes (int8, or the same bytes viewed as int32)
  const void* w2;  // packed [nc, C, chunk] bytes
  double* acc;     // [kProbeLanes] sums, zero at launch
  unsigned long long* ticket;  // blocks done, zero at launch
  float* sink;     // [G, kWarps]
  float* out;      // [kProbeLanes]
  int C, H, chunk, n_buf;
};

// the sum of one staged row of n int8 weights, each widened to bf16 (exact;
// a sum of at most 2^17 values of |v| <= 127 is exact in fp32); one warp
__device__ __forceinline__ float widened_row_sum(const unsigned char* row, int n) {
  float s = 0.f;
  for (int c = 16 * (threadIdx.x & 31); c < n; c += 16 * 32) {
    const int4 v = *reinterpret_cast<const int4*>(row + c);
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s += __bfloat162float(__float2bfloat16_rn((float)(int8_t)(w[i] >> (8 * k))));
  }
  return fused::warp_sum(s);
}

// the int32 whose little-endian bytes are column 0 of staged rows r .. r + 3
__device__ __forceinline__ double i32_of_rows(const unsigned char* stage, int ld, int r) {
  const unsigned v = (unsigned)stage[(size_t)r * ld] | ((unsigned)stage[(size_t)(r + 1) * ld] << 8) |
                     ((unsigned)stage[(size_t)(r + 2) * ld] << 16) | ((unsigned)stage[(size_t)(r + 3) * ld] << 24);
  return (double)(int)v;
}

// The chunk stream of rq_q8_ring_mlp alone (#19), over packed w1 / w2, with
// the same shares, stages and ring; what the TPU probe computes, in the
// port's layout (JAX's w1 chunk [C, chunk] is the port's [chunk, C]
// transposed, its w2 chunk [chunk, C] the port's [C, chunk] transposed):
//   dma, int8:   every lane += sum over chunks of column 0 of the first
//                min(128, chunk) w1 rows and the first min(128, C) w2 rows
//   dma, int32:  the same over the int32 values whose bytes are column 0
//                of w1 rows 4l .. 4l + 3 (l < min(128, chunk / 4)), and of
//                w2 rows (l < min(128, C / 4)): JAX's row 0 viewed as int32
//   dequant:     lane l += the sums of w1 row l and w2 row l, every staged
//                row widened to bf16 and summed (rows >= 128 into a sink)
// Sums run in fp64 (exact for these integers) and are cast to fp32 once,
// by the last block to finish (no grid barrier).
template <bool kDequant, bool kI32>
__global__ void __launch_bounds__(kThreads, 1) stream_probe_kernel(ProbeParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double lanes[kProbeLanes];
  __shared__ double scalar;
  const int G = gridDim.x, b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = p.C, chunk = p.chunk, nc = p.H / chunk;
  Ring ring;
  ring.w1 = static_cast<const unsigned char*>(p.w1);
  ring.w2 = static_cast<const unsigned char*>(p.w2);
  ring.smem = smem;
  ring.g = stage_geom(C, chunk, 1, G);
  ring.C = C;
  ring.H = p.H;
  ring.chunk = chunk;
  ring.wbytes = 1;
  ring.n_buf = p.n_buf;
  ring.packed = true;
  share(chunk / 8, b, G, ring.lo1, ring.n1);
  share(C / 8, b, G, ring.lo2, ring.n2);
  const int r1 = ring.lo1 * 8, r2 = ring.lo2 * 8;  // this block's first row of each share
  const int div = kI32 ? 4 : 1;
  const int l1 = min(kProbeLanes, chunk / div), l2 = min(kProbeLanes, C / div);

  ring.prologue(nc);
  for (int l = threadIdx.x; l < kProbeLanes; l += kThreads) lanes[l] = 0.0;
  if (threadIdx.x == 0) scalar = 0.0;
  float sink = 0.f;
  for (int j = 0; j < nc; ++j) {
    const int slot = j % p.n_buf;
    ring.wait();
    const unsigned char* s1 = ring.stage1(slot);
    const unsigned char* s2 = ring.stage2(slot);
    if constexpr (kDequant) {
      for (int r = warp; r < ring.n1 * 8; r += kWarps) {
        const float s = widened_row_sum(s1 + (size_t)r * ring.g.ld1, C);
        sink += s;
        if (lane == 0 && r1 + r < l1) lanes[r1 + r] += s;
      }
      __syncthreads();  // a w1 row and a w2 row may feed the same lane
      for (int r = warp; r < ring.n2 * 8; r += kWarps) {
        const float s = widened_row_sum(s2 + (size_t)r * ring.g.ld2, chunk);
        sink += s;
        if (lane == 0 && r2 + r < l2) lanes[r2 + r] += s;
      }
    } else if constexpr (kI32) {
      const int t = threadIdx.x;  // one group of four rows
      if (4 * t < ring.n1 * 8 && r1 / 4 + t < l1) atomicAdd(&scalar, i32_of_rows(s1, ring.g.ld1, 4 * t));
      if (4 * t < ring.n2 * 8 && r2 / 4 + t < l2) atomicAdd(&scalar, i32_of_rows(s2, ring.g.ld2, 4 * t));
    } else {
      const int t = threadIdx.x;  // one row
      if (t < ring.n1 * 8 && r1 + t < l1) atomicAdd(&scalar, (double)(int8_t)s1[(size_t)t * ring.g.ld1]);
      if (t < ring.n2 * 8 && r2 + t < l2) atomicAdd(&scalar, (double)(int8_t)s2[(size_t)t * ring.g.ld2]);
    }
    ring.refill(j, nc);
  }
  // fp64 atomics of integers: exact, so the order does not matter
  __syncthreads();
  if (kDequant) {
    for (int l = threadIdx.x; l < kProbeLanes; l += kThreads)
      if (lanes[l] != 0.0) atomicAdd(p.acc + l, lanes[l]);
  } else if (threadIdx.x == 0 && scalar != 0.0) {
    atomicAdd(p.acc, scalar);
  }
  if (lane == 0) p.sink[b * kWarps + warp] = sink;  // keeps the widening of rows >= 128 alive
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) last = atomicAdd(p.ticket, 1ull) == (unsigned long long)(G - 1);
  __syncthreads();
  if (last) {  // every other block has added its sums
    __threadfence();
    for (int l = threadIdx.x; l < kProbeLanes; l += kThreads) p.out[l] = (float)__ldcg(p.acc + (kDequant ? l : 0));
  }
}

// host side: the per-kernel launch state (dynamic shared memory set, and
// whether the grid fits at once), so that a launch inside a CUDA-graph
// capture makes no attribute or occupancy call once the same shape ran
struct LaunchCache {
  const void* kernel;
  int dev;
  size_t smem;
};
LaunchCache launch_cache[64];
int n_cached = 0;

// a cooperative launch of `grid` blocks with `smem` bytes of dynamic shared
// memory; cudaErrorInvalidValue when the block cannot hold that much,
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be resident at once
int coop_launch(const void* kernel, int grid, int threads, size_t smem, void** args, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  bool known = false;
  for (int i = 0; i < n_cached; ++i)
    if (launch_cache[i].kernel == kernel && launch_cache[i].dev == dev && launch_cache[i].smem >= smem) known = true;
  if (!known) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
    if (n_cached < 64) launch_cache[n_cached++] = {kernel, dev, smem};
  }
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
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

// The chunk stream alone over packed w1 [nc, chunk, C] and w2 [nc, C,
// chunk] int8 bytes (i32 = 1: the same bytes viewed as int32; dma only),
// `grid` blocks, n_buf stages; out: fp32 [128]; work: 8-byte words, at
// least 129 + 2 grid of them, the first 129 zero (the sums and a ticket;
// the last block to finish casts the sums into out). C, chunk: the int8
// widths. Returns as rq_q8_ring_mlp.
extern "C" int rq_q8_stream_probe(const void* w1, const void* w2, void* work, void* out, int C, int H,
                                  int chunk, int n_buf, int grid, int dequant, int i32, void* stream) {
  if (n_buf < 1 || n_buf > 8 || C % 32 || chunk % 32 || H % chunk || (dequant && i32) ||
      max_share(chunk / 8, grid) > kNT || max_share(C / 8, grid) > kNT)
    return (int)cudaErrorInvalidValue;
  ProbeParams p;
  p.w1 = w1;
  p.w2 = w2;
  p.acc = static_cast<double*>(work);
  p.ticket = reinterpret_cast<unsigned long long*>(p.acc + kProbeLanes);
  p.sink = reinterpret_cast<float*>(p.acc + kProbeLanes + 1);
  p.out = static_cast<float*>(out);
  p.C = C;
  p.H = H;
  p.chunk = chunk;
  p.n_buf = n_buf;
  const size_t smem = (size_t)n_buf * stage_geom(C, chunk, 1, grid).bytes;
  void* args[] = {&p};
  const void* k = dequant ? (const void*)stream_probe_kernel<true, false>
                          : (i32 ? (const void*)stream_probe_kernel<false, true>
                                 : (const void*)stream_probe_kernel<false, false>);
  return coop_launch(k, grid, kThreads, smem, args, (cudaStream_t)stream);
}
