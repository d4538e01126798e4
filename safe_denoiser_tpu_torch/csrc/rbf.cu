// kernel_fast repellency score against a negative-latent bank, f32.
//
//   w[n,m]  = exp(-||x_n - r_m|| / (2 sigma^2))
//   num[n]  = sum_m w[n,m] r_m          beta[n] = sum_m w[n,m]
//   score   = num / (beta + eps)        (or the raw partials)
//
// Replaces: safe_denoiser_tpu/ops/repellency_kernels.py::_rbf_kernel (via
// rbf_negative_score_pallas <- rbf_negative_score <- apply_repellency).
//
// Bound on an H100: one read of the bank (515 x 16384 f32 = 33.75 MB on the
// SD-v1.4 path) at 3.35 TB/s, ~10 us; the 4*N*M*D operations are far
// below the f32 rate.
//
// Design: the TPU walks the bank's M-tiles in order on one core and
// carries the sums in VMEM. Here blocks run in parallel with no carried
// state, so the work is two launches:
//   1. rbf_weights: one block per bank row m reduces over D the Gram terms
//      x_n . r_m, ||r_m||^2 and ||x_n||^2 for every n in one read of the
//      row, then writes w[n,m] with the same d^2 = |x|^2 + |r|^2 - 2G
//      formula and clamp at 0 as the reference (so both agree near the
//      bank, where the difference cancels).
//   2. rbf_accumulate: a D-tiled pass, one thread per column d, walks m
//      with the weights staged in shared memory and accumulates sum_m w r;
//      each block also sums w over m, then normalizes. The bank's second
//      read mostly hits the 50 MB L2.
// All arithmetic is f32 FMA: the reference runs at Precision.HIGHEST, so
// no TF32. N (the batch of x) is limited to NMAX rows.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NMAX = 16;
constexpr int W_THREADS = 256;
constexpr int A_THREADS = 128;
constexpr int MCHUNK = 256;

__global__ void __launch_bounds__(W_THREADS)
rbf_weights(const float* __restrict__ x, const float* __restrict__ r,
            float* __restrict__ w, int N, int M, int D, float two_s2) {
  const int m = blockIdx.x;
  const float* rm = r + (size_t)m * D;
  float g[NMAX], xx[NMAX], rr = 0.f;
#pragma unroll
  for (int n = 0; n < NMAX; ++n) g[n] = xx[n] = 0.f;
  for (int d = threadIdx.x; d < D; d += W_THREADS) {
    const float rv = rm[d];
    rr = fmaf(rv, rv, rr);
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        const float xv = x[(size_t)n * D + d];
        g[n] = fmaf(xv, rv, g[n]);
        xx[n] = fmaf(xv, xv, xx[n]);
      }
    }
  }
  // block reduction of the 2N+1 partial sums
  __shared__ float red[W_THREADS / 32][2 * NMAX + 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    rr += __shfl_xor_sync(0xffffffffu, rr, off);
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      g[n] += __shfl_xor_sync(0xffffffffu, g[n], off);
      xx[n] += __shfl_xor_sync(0xffffffffu, xx[n], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      red[warp][n] = g[n];
      red[warp][NMAX + n] = xx[n];
    }
    red[warp][2 * NMAX] = rr;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    const int n = threadIdx.x;
    float gs = 0.f, xs = 0.f, rs = 0.f;
    for (int i = 0; i < W_THREADS / 32; ++i) {
      gs += red[i][n];
      xs += red[i][NMAX + n];
      rs += red[i][2 * NMAX];
    }
    const float d2 = fmaxf(xs + rs - 2.f * gs, 0.f);
    w[(size_t)n * M + m] = expf(-sqrtf(d2) / two_s2);
  }
}

__global__ void __launch_bounds__(A_THREADS)
rbf_accumulate(const float* __restrict__ r, const float* __restrict__ w,
               float* __restrict__ num, float* __restrict__ beta, int N,
               int M, int D, float eps, int normalize) {
  __shared__ float ws[NMAX * MCHUNK];
  __shared__ float bsum[NMAX];
  const int d = blockIdx.x * A_THREADS + threadIdx.x;
  float acc[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) acc[n] = 0.f;
  float bpart = 0.f;  // sum of w[threadIdx.x, :] for threads < N
  for (int m0 = 0; m0 < M; m0 += MCHUNK) {
    const int mc = min(MCHUNK, M - m0);
    for (int i = threadIdx.x; i < N * MCHUNK; i += A_THREADS) {
      const int n = i / MCHUNK, mm = i % MCHUNK;
      ws[i] = mm < mc ? w[(size_t)n * M + m0 + mm] : 0.f;
    }
    __syncthreads();
    if (threadIdx.x < N) {
      for (int mm = 0; mm < mc; ++mm) bpart += ws[threadIdx.x * MCHUNK + mm];
    }
    if (d < D) {
      const float* rp = r + (size_t)m0 * D + d;
      for (int mm = 0; mm < mc; ++mm) {
        const float rv = rp[(size_t)mm * D];
#pragma unroll
        for (int n = 0; n < NMAX; ++n)
          if (n < N) acc[n] = fmaf(ws[n * MCHUNK + mm], rv, acc[n]);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < N) bsum[threadIdx.x] = bpart;
  __syncthreads();
  if (d < D) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N)
        num[(size_t)n * D + d] =
            normalize ? acc[n] / (bsum[n] + eps) : acc[n];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < N)
    beta[threadIdx.x] = normalize ? bpart + eps : bpart;
}

}  // namespace

// x [N, D], refs [M, D], w_scratch [N, M], num [N, D], beta [N]; all f32,
// contiguous; two_sigma2 = 2*sigma^2 rounded once to f32 by the caller.
// Returns a cudaError_t.
extern "C" int sdt_rbf_score_f32(const float* x, const float* refs,
                                 float* w_scratch, float* num, float* beta,
                                 int N, int M, int D, float two_sigma2,
                                 float eps, int normalize, void* stream) {
  if (N < 1 || N > NMAX || M < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rbf_weights<<<M, W_THREADS, 0, st>>>(x, refs, w_scratch, N, M, D,
                                       two_sigma2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rbf_accumulate<<<(D + A_THREADS - 1) / A_THREADS, A_THREADS, 0, st>>>(
      refs, w_scratch, num, beta, N, M, D, eps, normalize);
  return (int)cudaGetLastError();
}
