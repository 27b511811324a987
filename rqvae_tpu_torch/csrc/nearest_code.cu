// Nearest codebook entry (fused fp32 distance + argmin) for residual
// quantization, on Hopper (sm_90a).
//
// Replaces the TPU kernel rqvae_tpu/ops/rq_kernel.py::_nearest_code_pallas
// (body _nearest_kernel).
//
// What it computes, for every row x_n of x [N, dim] against cb [E, dim]:
//   code[n] = argmin_e  cb_sq[e] - 2 <x_n, c_e>,   cb_sq[e] = <c_e, c_e>
// in fp32 throughout (the JAX kernel asks for Precision.HIGHEST: no TF32,
// no bf16), the ||x_n||^2 term left out as in the JAX kernel (it does not
// move the argmin), ties to the lowest e.
//
// Bound on the H100: operations. At the encode path's shapes (N = 6400 rows,
// dim 256, E = 16384) a launch is 2 N E dim = 53.7 GFLOP of fp32 FMAs
// against ~23 MB of inputs, 0.80 ms at the 67 TFLOP/s fp32 peak and ~7 us of
// HBM traffic. Design: an SGEMM-style tile of 128 rows x 128 codes per
// 256-thread block, dim staged through shared memory 16 at a time, 8 x 8
// outputs per thread accumulated in registers with fmaf in ascending k, so
// every (row, code) dot is summed in the same order and two identical
// codebook rows give bit-identical distances. The [N, E] distance matrix
// never leaves registers: each thread folds its distances into a running
// (distance, index) minimum per row.
//
// Hopper blocks run in no order, so nothing is carried between them as the
// TPU kernel carries (minval, minidx) across its sequential grid. The
// codebook axis is split over gridDim.y (the row tiles alone would give 50
// blocks at N = 6400 for 132 SMs); each block writes one partial
// (distance, index) per row, and a second small kernel reduces the splits.
// Every reduction, within a thread, across the threads of a row and across
// splits, is the lexicographic (distance, index) minimum, which gives the
// first index among equal distances whatever order the codes are seen in.
// Ragged edges are masked here: rows >= N and k >= dim load zeros (adding
// 0 * 0 leaves a sum unchanged), codes >= E are never compared. No padding
// to tiles, no FLT_MAX/2 sentinel codes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // rows of x per block
constexpr int kBN = 128;  // codes per tile
constexpr int kBK = 16;   // dim staged per step
constexpr int kPad = 4;   // shared row padding: the transposing stores hit distinct banks
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kNoCode = 0x7fffffff;

__device__ __forceinline__ bool before(float d, int e, float best_d, int best_e) {
  return d < best_d || (d == best_d && e < best_e);
}

// cb_sq[e] = sum_k cb[e, k]^2, one warp per code, the same order for every code
__global__ void code_norms_kernel(const float* __restrict__ cb, float* __restrict__ cb_sq,
                                  int E, int dim) {
  const int e = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (e >= E) return;
  const float* c = cb + (size_t)e * dim;
  float s = 0.f;
  for (int k = lane; k < dim; k += 32) s = fmaf(c[k], c[k], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) cb_sq[e] = s;
}

// One block: rows [row0, row0 + 128) against the codes of split blockIdx.y,
// tiles_per_split tiles of 128 codes. Writes one partial per row.
__global__ void __launch_bounds__(kThreads) nearest_code_partial_kernel(
    const float* __restrict__ x, const float* __restrict__ cb, const float* __restrict__ cb_sq,
    float* __restrict__ part_d, int* __restrict__ part_e, int N, int E, int dim,
    int tiles_per_split) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];  // x tile, k-major
  __shared__ __align__(16) float cs[kBK][kBN + kPad];  // codebook tile, k-major

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // code group: codes 4 tx + {0..3} and 64 + 4 tx + {0..3}
  const int ty = tid >> 4;  // row group: rows 4 ty + {0..3} and 64 + 4 ty + {0..3}
  const int row0 = blockIdx.x * kBM;
  const int e_begin = blockIdx.y * tiles_per_split * kBN;
  const int e_end = min(E, e_begin + tiles_per_split * kBN);

  float best_d[8];
  int best_e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_d[i] = INFINITY;
    best_e[i] = kNoCode;
  }

  for (int e0 = e_begin; e0 < e_end; e0 += kBN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < dim; k0 += kBK) {
      // 128 x 16 values of each operand, 8 per thread; neighbouring threads
      // read neighbouring k of one row (64 contiguous bytes per row)
#pragma unroll
      for (int l = 0; l < kBM * kBK / kThreads; ++l) {
        const int i = tid + l * kThreads;
        const int m = i / kBK;
        const int k = i % kBK;
        const int kk = k0 + k;
        const int r = row0 + m;
        const int e = e0 + m;
        xs[k][m] = (r < N && kk < dim) ? x[(size_t)r * dim + kk] : 0.f;
        cs[k][m] = (e < E && kk < dim) ? cb[(size_t)e * dim + kk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[k][4 * ty]);
        const float4 a1 = *reinterpret_cast<const float4*>(&xs[k][64 + 4 * ty]);
        const float4 b0 = *reinterpret_cast<const float4*>(&cs[k][4 * tx]);
        const float4 b1 = *reinterpret_cast<const float4*>(&cs[k][64 + 4 * tx]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // fold this tile's distances into the running minimum of each row
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = e0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (e < E) {
        const float c = cb_sq[e];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = c - 2.f * acc[i][j];
          if (before(d, e, best_d[i], best_e[i])) {
            best_d[i] = d;
            best_e[i] = e;
          }
        }
      }
    }
  }

  // the 16 threads of a row group are lanes 0-15 or 16-31 of one warp
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float d = __shfl_xor_sync(0xffffffffu, best_d[i], o);
      const int e = __shfl_xor_sync(0xffffffffu, best_e[i], o);
      if (before(d, e, best_d[i], best_e[i])) {
        best_d[i] = d;
        best_e[i] = e;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
      if (r < N) {
        part_d[(size_t)blockIdx.y * N + r] = best_d[i];
        part_e[(size_t)blockIdx.y * N + r] = best_e[i];
      }
    }
  }
}

// code[n] = the lexicographic minimum of the splits' partials of row n
__global__ void nearest_code_reduce_kernel(const float* __restrict__ part_d,
                                           const int* __restrict__ part_e,
                                           int64_t* __restrict__ code, int N, int splits) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float best_d = INFINITY;
  int best_e = kNoCode;
  for (int s = 0; s < splits; ++s) {
    const float d = part_d[(size_t)s * N + n];
    const int e = part_e[(size_t)s * N + n];
    if (before(d, e, best_d, best_e)) {
      best_d = d;
      best_e = e;
    }
  }
  code[n] = best_e == kNoCode ? 0 : best_e;  // only a row of NaN distances keeps no code
}

}  // namespace

// x [N, dim], cb [E, dim]: fp32, contiguous. Scratch from the caller:
// cb_sq [E] fp32, part_d [splits, N] fp32, part_e [splits, N] int32 with
// splits = ceil(ceil(E / 128) / tiles_per_split). Output code [N] int64.
// Three launches on `stream`; returns the first cudaGetLastError() that is
// not cudaSuccess, else cudaSuccess.
extern "C" int rq_nearest_code(const void* x, const void* cb, void* cb_sq, void* part_d,
                               void* part_e, void* code, int N, int E, int dim,
                               int tiles_per_split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (E + kBN - 1) / kBN;
  const int splits = (tiles + tiles_per_split - 1) / tiles_per_split;

  code_norms_kernel<<<(E + 7) / 8, 256, 0, s>>>(static_cast<const float*>(cb),
                                                static_cast<float*>(cb_sq), E, dim);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  const dim3 grid((N + kBM - 1) / kBM, splits);
  nearest_code_partial_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(cb),
      static_cast<const float*>(cb_sq), static_cast<float*>(part_d),
      static_cast<int*>(part_e), N, E, dim, tiles_per_split);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  nearest_code_reduce_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_e),
      static_cast<int64_t*>(code), N, splits);
  return (int)cudaGetLastError();
}
