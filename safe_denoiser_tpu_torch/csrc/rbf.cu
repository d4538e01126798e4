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
// SD-v1.4 path, 10.1 us; 16 x 262144 = 16.8 MB on SD3's, 5.0 us) at
// 3.35 TB/s; the 4*N*M*D operations are far below the f32 rate.
//
// Design: the TPU walks the bank's M-tiles in order on one core and carries
// the sums in VMEM. Here blocks run in parallel with no carried state, so
// the work is two launches, each spread over the whole card in one wave
// (plan from ops/repellency_kernels.py::rbf_plan) and each reducing across
// a thread-block cluster (a power of two blocks) in rank order
// through distributed shared memory (csrc/cluster.cuh): no atomics, so the
// result is deterministic.
//   1. rbf_gram: a cluster of cl1 blocks splits D into slices of ds
//      columns; a block takes mr bank rows (8 for SD-v1's 515, so x is
//      read from L2 65 times; 1 for SD3's 16, so that 16 x 16 blocks fill
//      the card), its 8 warps split the slice, and each lane reads x's
//      vectors once for all the block's rows, streaming the bank with
//      16-byte loads and keeping f32 FMA sums of x_n . r_m, ||r_m||^2 and
//      ||x_n||^2; a warp adds its lanes (xor butterfly), the block its
//      warps in order, the cluster its blocks in rank order. Then w[n,m]
//      with the reference's d^2 = (|x|^2 + |r|^2) - 2G, clamped at 0 (so
//      the two agree near the bank, where the difference cancels).
//   2. rbf_accumulate: a block takes a tile of 128 * vec columns (one
//      float4 a thread) and a cluster of cl2 blocks splits M in runs of
//      ms rows (SD-v1's 32 tiles take cl2 = 16, SD3's 512 take 2); each
//      thread sums w r over its rows in order, with the weights
//      staged in shared memory; the cluster adds its blocks' partials in
//      rank order, each block finishing 1/cl2 of the tile's columns, and
//      normalizes there. The bank's second read mostly hits the 50 MB L2.
//      It is a programmatic dependent launch: its blocks start as pass 1's
//      finish, and wait for pass 1's weights before reading them.
// All arithmetic is f32 FMA: the reference runs at Precision.HIGHEST, so
// no TF32. N (the batch of x) is limited to NMAX rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

constexpr int NMAX = 16;
constexpr int G_THREADS = 256;
constexpr int G_WARPS = G_THREADS / 32;
constexpr int A_THREADS = 128;
constexpr int A_MCHUNK = 128;
constexpr int CL1_MAX = 16;
constexpr int CL2_MAX = 16;

template <int VEC> struct Vf;
template <> struct Vf<4> {
  float e[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
  }
};
template <> struct Vf<1> {
  float e[1];
  __device__ __forceinline__ void load(const float* p) { e[0] = __ldg(p); }
};

// rows a pass-1 block can take: its lanes keep MR x NT Gram sums each
template <int NT>
__host__ __device__ constexpr int mr_max() {
  return NT > 8 ? 4 : 8;
}

// block (rank, chunk): D-slice [rank * ds, (rank + 1) * ds) of bank rows
// [chunk * mr, (chunk + 1) * mr); warp w takes part w of the slice's
// vectors for all of them
// three blocks a SM (at most 85 registers a thread): with two, the
// clusters of SD3's 256 blocks did not all fit at once on an H100
template <int NT, int VEC>
__global__ void __launch_bounds__(G_THREADS, 3)
rbf_gram(const float* __restrict__ x, const float* __restrict__ r,
         float* __restrict__ w, int N, int M, int D, int ds, int mr,
         float two_s2) {
  constexpr int MR = mr_max<NT>();
  constexpr int NV = MR * NT + MR + NT;            // sums a lane keeps
  __shared__ float part[G_WARPS][NV];
  __shared__ float blk[NV];                        // peers read
  const int cl = gridDim.x;
  const int rank = (int)sdt_cluster::rank();
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  const int m0 = blockIdx.y * mr;
  const int rows = min(mr, M - m0);
  const int d0 = rank * ds;
  const int nvec = max(0, min(ds, D - d0)) / VEC;
  const int per = (nvec + G_WARPS - 1) / G_WARPS;
  const int v0 = warp * per, v1 = min(nvec, v0 + per);
  sdt_cluster::launch_dependents();  // pass 2 may start launching

  // sums: g[i][n] = x_n . r_{m0+i}, rr[i] = |r_{m0+i}|^2, xx[n] = |x_n|^2
  float acc[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) acc[e] = 0.f;
  float* g = acc;
  float* rr = acc + MR * NT;
  float* xx = rr + MR;
  const float* xp = x + d0;
  const float* rp = r + (size_t)m0 * D + d0;
#pragma unroll 2
  for (int v = v0 + ln; v < v1; v += 32) {
    Vf<VEC> xv[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < N) {
        xv[n].load(xp + (size_t)n * D + v * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          xx[n] = fmaf(xv[n].e[e], xv[n].e[e], xx[n]);
      }
    }
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      if (i < rows) {
        Vf<VEC> rv;
        rv.load(rp + (size_t)i * D + v * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e) rr[i] = fmaf(rv.e[e], rv.e[e], rr[i]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n < N) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              g[i * NT + n] = fmaf(xv[n].e[e], rv.e[e], g[i * NT + n]);
          }
        }
      }
    }
  }
  // the warp's lanes (xor butterfly), then the block's warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int e = 0; e < NV; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  if (ln == 0) {
#pragma unroll
    for (int e = 0; e < NV; ++e) part[warp][e] = acc[e];
  }
  __syncthreads();
  for (int e = tid; e < NV; e += G_THREADS) {
    float s = 0.f;
    for (int q = 0; q < G_WARPS; ++q) s += part[q][e];
    blk[e] = s;
  }
  sdt_cluster::sync();
  // entry (row i, n) of the block's rows, on rank (i * N + n) % cl: the
  // cluster's sums in rank order, then the weight
  for (int e = rank + tid * cl; e < rows * N; e += G_THREADS * cl) {
    const int i = e / N, n = e % N;
    const float gs = sdt_cluster::sum_peers(&blk[i * NT + n], cl);
    const float rs = sdt_cluster::sum_peers(&blk[MR * NT + i], cl);
    const float xs = sdt_cluster::sum_peers(&blk[MR * NT + MR + n], cl);
    const float d2 =
        fmaxf(__fsub_rn(__fadd_rn(xs, rs), __fmul_rn(2.f, gs)), 0.f);
    w[(size_t)n * M + m0 + i] = expf(-sqrtf(d2) / two_s2);
  }
  sdt_cluster::arrive();
  sdt_cluster::wait();
}

template <int NT, int VEC>
__global__ void __launch_bounds__(A_THREADS)
rbf_accumulate(const float* __restrict__ r, const float* __restrict__ w,
               float* __restrict__ num, float* __restrict__ beta, int N,
               int M, int D, int ms, float eps, int normalize) {
  constexpr int TD = A_THREADS * VEC;
  extern __shared__ __align__(16) float part[];  // [N][TD], peers read
  __shared__ float ws[NT][A_MCHUNK];
  __shared__ float bb[NT], bt[NT];                // bb: peers read
  const int cl = gridDim.x;
  const int rank = (int)sdt_cluster::rank();
  const int tid = threadIdx.x;
  const int tile = blockIdx.y;
  const int col = tile * TD + tid * VEC;
  const int m0 = rank * ms, m1 = min(M, m0 + ms);
  sdt_cluster::wait_previous();      // pass 1's weights

  float acc[NT][VEC];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[n][e] = 0.f;
  float bpart = 0.f;  // sum of w[tid, m0:m1] for threads < N
  for (int mc = m0; mc < m1; mc += A_MCHUNK) {
    const int nm = min(A_MCHUNK, m1 - mc);
    for (int i = tid; i < N * A_MCHUNK; i += A_THREADS) {
      const int n = i / A_MCHUNK, j = i % A_MCHUNK;
      ws[n][j] = j < nm ? w[(size_t)n * M + mc + j] : 0.f;
    }
    __syncthreads();
    if (tid < N)
      for (int j = 0; j < nm; ++j) bpart += ws[tid][j];
    if (col < D) {
      const float* rp = r + (size_t)mc * D + col;
#pragma unroll 8
      for (int j = 0; j < nm; ++j) {
        Vf<VEC> rv;
        rv.load(rp + (size_t)j * D);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n < N) {
            const float wv = ws[n][j];
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[n][e] = fmaf(wv, rv.e[e], acc[n][e]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < N) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) part[n * TD + tid * VEC + e] = acc[n][e];
    }
  }
  if (tid < N) bb[tid] = bpart;
  sdt_cluster::sync();
  if (tid < N) bt[tid] = sdt_cluster::sum_peers(&bb[tid], cl);
  __syncthreads();
  // this rank's share of the tile's columns: the cluster's partials in rank
  // order, then normalized
  const int chunk = (TD + cl - 1) / cl;
  const int c0 = rank * chunk, nc = max(0, min(TD, c0 + chunk) - c0);
  for (int i = tid; i < N * nc; i += A_THREADS) {
    const int n = i / nc, c = c0 + (i - n * nc);
    const int gc = tile * TD + c;
    if (gc < D) {
      const float s = sdt_cluster::sum_peers(part + n * TD + c, cl);
      num[(size_t)n * D + gc] = normalize ? s / (bt[n] + eps) : s;
    }
  }
  if (tile == 0 && rank == 0 && tid < N)
    beta[tid] = normalize ? bt[tid] + eps : bt[tid];
  sdt_cluster::arrive();
  sdt_cluster::wait();
}

template <int NT, int VEC>
cudaError_t launch_passes(const float* x, const float* refs, float* w,
                          float* num, float* beta, int N, int M, int D,
                          float two_s2, float eps, int normalize, int mr,
                          int cl1, int ds, int cl2, int ms, cudaStream_t st) {
  if (mr > mr_max<NT>()) return cudaErrorInvalidValue;
  cudaError_t e = sdt_cluster::launch<rbf_gram<NT, VEC>>(
      dim3(cl1, (M + mr - 1) / mr), G_THREADS, cl1, 0, st, false, x, refs, w,
      N, M, D, ds, mr, two_s2);
  if (e != cudaSuccess) return e;
  const int td = A_THREADS * VEC;
  return sdt_cluster::launch<rbf_accumulate<NT, VEC>>(
      dim3(cl2, (D + td - 1) / td), A_THREADS, cl2, N * td * 4, st, true,
      refs, w, num, beta, N, M, D, ms, eps, normalize);
}

template <int NT>
cudaError_t launch_nt(int vec, const float* x, const float* refs, float* w,
                      float* num, float* beta, int N, int M, int D,
                      float two_s2, float eps, int normalize, int mr, int cl1,
                      int ds, int cl2, int ms, cudaStream_t st) {
  if (vec == 4)
    return launch_passes<NT, 4>(x, refs, w, num, beta, N, M, D, two_s2, eps,
                                normalize, mr, cl1, ds, cl2, ms, st);
  return launch_passes<NT, 1>(x, refs, w, num, beta, N, M, D, two_s2, eps,
                              normalize, mr, cl1, ds, cl2, ms, st);
}

}  // namespace

// x [N, D], refs [M, D], w_scratch [N, M], num [N, D], beta [N]; all f32,
// contiguous; two_sigma2 = 2*sigma^2 rounded once to f32 by the caller.
// Plan (ops/repellency_kernels.py::rbf_plan): vec 4 (16-byte loads: D % 4
// == 0 and x, refs 16-byte aligned) or 1; pass 1 with clusters of cl1
// D-slices of ds columns (ds % 4 == 0) and mr bank rows a block (<= 8, <= 4
// for N > 8); pass 2 with clusters of cl2 runs of ms bank rows (trailing
// slices and runs may be empty). Returns a
// cudaError_t (cudaErrorInvalidValue for a plan the shape or the pointers
// do not take).
extern "C" int sdt_rbf_score_f32(const float* x, const float* refs,
                                 float* w_scratch, float* num, float* beta,
                                 int N, int M, int D, float two_sigma2,
                                 float eps, int normalize, int vec, int mr,
                                 int cl1, int ds, int cl2, int ms,
                                 void* stream) {
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(refs);
  if (N < 1 || N > NMAX || M < 1 || D < 1 || (vec != 1 && vec != 4) ||
      (vec == 4 && (D % 4 || ptrs % 16)) || mr < 1 || mr > 8 ||
      (M + mr - 1) / mr > 65535 || cl1 < 1 || cl1 > CL1_MAX || ds < 4 ||
      ds % 4 || (long long)ds * cl1 < D || cl2 < 1 || cl2 > CL2_MAX ||
      ms < 1 || (long long)ms * cl2 < M ||
      (D + A_THREADS * vec - 1) / (A_THREADS * vec) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SDT_RBF_LAUNCH(NT)                                                 \
  return (int)launch_nt<NT>(vec, x, refs, w_scratch, num, beta, N, M, D,  \
                            two_sigma2, eps, normalize, mr, cl1, ds, cl2, \
                            ms, st)
  if (N <= 1) SDT_RBF_LAUNCH(1);
  if (N <= 2) SDT_RBF_LAUNCH(2);
  if (N <= 4) SDT_RBF_LAUNCH(4);
  if (N <= 8) SDT_RBF_LAUNCH(8);
  SDT_RBF_LAUNCH(16);
#undef SDT_RBF_LAUNCH
}
