// Fused GroupNorm (+SiLU) of a [B, S, C] activation with f32 statistics,
// in one launch: per-group sum and sum of squares, a = rsqrt(var + eps) *
// scale and b = bias - mean * a per channel, y = x * a + b (then SiLU).
//
// Replaces: safe_denoiser_tpu/ops/group_norm.py::_gn_kernel (via
// group_norm_pallas <- group_norm under SDT_FUSED_GN=1), which keeps a
// whole batch row of x in VMEM, reads it once and writes y once.
//
// Bound on an H100: one read and one write of x (41.9 MB, 12.5 us, at the
// UNet's [8, 4096, 320] bf16); the arithmetic is a few operations a byte.
//
// Design (plan from ops/group_norm.py::gn_plan):
//   - Grid: each batch row is cut along C into tiles of `ct` channels, whole
//     groups each; one tile is one cluster of `cl` blocks (the plan takes
//     1 or 2: clusters of 4-8 blocks this large started in two waves on an
//     H100), which split the rows, `rows` each (the last one fewer).
//   - One read ("resident" plan): a block copies its [rows, ct] slice of x
//     into dynamic shared memory in passes of `pass_rows` rows, all in
//     flight at once, with asynchronous copies of `vb` bytes (16 where the
//     row segment, the row pitch and both pointers allow, else 8, 4, or
//     2-byte plain copies), consecutive threads on consecutive vectors (and
//     an L2 prefetch hint on the 16-byte ones); it sums
//     each pass while the next ones arrive, and writes y from the slice.
//     Where the slice does not fit, the passes go through two buffers, two
//     in flight, and the output reads x again (mostly from L2): the
//     "re-read" plan, with the same sums.
//   - Sums: with cw = min(ct, 1024) and nq = 1024 / cw row chunks, thread
//     t sums channel t % cw (and + 1024, ... where ct > 1024) over chunk
//     q = t / cw of the block's rows, rows q, q + nq, ... (so every pass
//     keeps every thread busy), in row order; the block adds the chunks
//     per channel in chunk order, and a group's channels in runs of 8 in
//     order, then the runs in order. All of it in f64 (x^2 by FMA), exact
//     for bf16 x and no slower on an H100: with f32 sums the coefficients
//     came out an f32 ulp or so from the plain version's, enough to move
//     y across bf16 rounding midpoints (a 1.5-ulp difference after SiLU at
//     one of phase 3's elements).
//   - Output walk: thread t holds column vector t % slots of the tile
//     (slots = min(vectors a row, 1024)) for rows t / slots + i * lanes
//     (lanes = 1024 / slots), so its a and b stay in registers. 1024
//     threads, since one block a SM holds a one-read slice.
//   - Cluster reduction: the per-group partials go to shared memory; after a
//     cluster barrier every block reads all CL blocks' partials through
//     DSMEM and adds them in rank order, so every block derives bit-identical
//     statistics (no atomics: the result is deterministic). Then per channel
//     a and b, each rounded once to f32 (the formulas of
//     ops/group_norm.py::_affine_from_sums).
//   - Apply: y = x * a + b in f32 (separate rounding of the product and the
//     sum, as the plain version); SiLU in f32, or (fast: bf16 under
//     SDT_FAST_SILU=1) on y rounded to bf16 with the sigmoid rounded to
//     bf16, two values a conversion instruction (one at a time, the three
//     roundings an element cost 13 us at [8, 4096, 320] on an H100); vector
//     stores of y. The block
//     arrives on the cluster barrier
//     once it has read its peers and waits on it before exiting, so its
//     partials stay alive while they are read.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "cluster.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int CH_MAX = 4;          // channels a thread sums: ct <= 4096
constexpr int SUB = 8;             // channels a run of a group's sum
constexpr int CLUSTER_MAX = 8;

// element types: storage bits <-> f32. round() rounds f32 values to the
// type and back, out() converts them to its bits, two at a time where the
// count is even (one packed conversion instruction for two values)
struct F32 {
  using bits = uint32_t;
  static __device__ __forceinline__ float in(bits b) {
    return __uint_as_float(b);
  }
  template <int V>
  static __device__ __forceinline__ void round(float (&)[V]) {}
  template <int V>
  static __device__ __forceinline__ void out(const float (&t)[V],
                                             bits (&b)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) b[j] = __float_as_uint(t[j]);
  }
};

// T: the 16-bit type's conversions (pack two, unpack low and high, one
// value and its bits)
template <typename T>
struct Half16 {
  using bits = uint16_t;
  template <int V>
  static __device__ __forceinline__ void round(float (&t)[V]) {
    if constexpr (V % 2 == 0) {
#pragma unroll
      for (int j = 0; j < V; j += 2) {
        const auto p = T::pack(t[j], t[j + 1]);
        t[j] = T::lo(p);
        t[j + 1] = T::hi(p);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) t[j] = T::back(T::one(t[j]));
    }
  }
  template <int V>
  static __device__ __forceinline__ void out(const float (&t)[V],
                                             bits (&b)[V]) {
    if constexpr (V % 2 == 0) {
#pragma unroll
      for (int j = 0; j < V; j += 2) {
        const auto p = T::pack(t[j], t[j + 1]);
        memcpy(&b[j], &p, 4);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) b[j] = T::bits_of(T::one(t[j]));
    }
  }
};

struct BF16Conv {
  static __device__ __forceinline__ __nv_bfloat162 pack(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float lo(__nv_bfloat162 p) {
    return __low2float(p);
  }
  static __device__ __forceinline__ float hi(__nv_bfloat162 p) {
    return __high2float(p);
  }
  static __device__ __forceinline__ __nv_bfloat16 one(float a) {
    return __float2bfloat16_rn(a);
  }
  static __device__ __forceinline__ float back(__nv_bfloat16 h) {
    return __bfloat162float(h);
  }
  static __device__ __forceinline__ uint16_t bits_of(__nv_bfloat16 h) {
    return __bfloat16_as_ushort(h);
  }
};

struct F16Conv {
  static __device__ __forceinline__ __half2 pack(float a, float b) {
    return __floats2half2_rn(a, b);
  }
  static __device__ __forceinline__ float lo(__half2 p) {
    return __low2float(p);
  }
  static __device__ __forceinline__ float hi(__half2 p) {
    return __high2float(p);
  }
  static __device__ __forceinline__ __half one(float a) {
    return __float2half_rn(a);
  }
  static __device__ __forceinline__ float back(__half h) {
    return __half2float(h);
  }
  static __device__ __forceinline__ uint16_t bits_of(__half h) {
    return __half_as_ushort(h);
  }
};

struct BF16 : Half16<BF16Conv> {
  static __device__ __forceinline__ float in(bits b) {
    return __uint_as_float((uint32_t)b << 16);
  }
};

struct F16 : Half16<F16Conv> {
  static __device__ __forceinline__ float in(bits b) {
    return __half2float(__ushort_as_half(b));
  }
};

template <int VB> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };

// VB bytes of elements
template <typename E, int VB>
struct Vec {
  static constexpr int V = VB / (int)sizeof(typename E::bits);
  typename E::bits b[V];
  __device__ __forceinline__ void load(const void* p) {
    const typename Raw<VB>::type r =
        *static_cast<const typename Raw<VB>::type*>(p);
    memcpy(b, &r, VB);
  }
  __device__ __forceinline__ void store(void* p) const {
    typename Raw<VB>::type r;
    memcpy(&r, b, VB);
    *static_cast<typename Raw<VB>::type*>(p) = r;
  }
};

// VB bytes global -> shared: cp.async for 4, 8 and 16 bytes, a plain copy
// for 2
template <int VB>
__device__ __forceinline__ void stage(void* dst, const void* src) {
  if constexpr (VB == 2) {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  } else {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    if constexpr (VB == 16)
      asm volatile(
          "cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(d),
          "l"(src)
          : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                   "l"(src), "n"(VB)
                   : "memory");
  }
}

// wait until at most `left` (clamped to 7) of this thread's copy groups are
// in flight
__device__ __forceinline__ void wait_groups(int left) {
  switch (left < 7 ? left : 7) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// as the plain version computes it (expf, IEEE division): the fast SiLU
// rounds it to bf16, where a few ulp of f32 can change which way
__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// block (rank, tile, b): rows [rank * rows, min(S, (rank + 1) * rows)) of
// channels [tile * ct, (tile + 1) * ct) of batch row b
template <typename E, int VB>
__global__ void __launch_bounds__(THREADS)
gn_fused_kernel(const typename E::bits* __restrict__ x,
                const float* __restrict__ scale,
                const float* __restrict__ bias,
                typename E::bits* __restrict__ y,
                int S, int C, int cg, int ct, int rows, int pass_rows,
                int resident, int stage_bytes, double n_per_group, float eps,
                int silu, int fast) {
  using Bits = typename E::bits;
  using VecT = Vec<E, VB>;
  constexpr int V = VecT::V;
  extern __shared__ __align__(16) unsigned char smem[];

  const int cl = gridDim.x;
  const int rank = (int)sdt_cluster::rank();
  const int tid = threadIdx.x;
  const int k = ct / cg;                        // groups a tile
  const int r0 = rank * rows;
  const int nr = max(0, min(S, r0 + rows) - r0);
  // the sums' walk: channel c0 + i * THREADS, rows q, q + nq, ...
  const int cw = ct < THREADS ? ct : THREADS;
  const int nq = THREADS / cw;                  // row chunks
  const int c0 = tid % cw, q = tid / cw;
  // the output's walk: column vector slot, rows lane, lane + lanes, ...
  const int vpr = ct / V;                       // vectors a tile row
  const int slots = vpr < THREADS ? vpr : THREADS;
  const int lanes = THREADS / slots;
  const int slot = tid % slots, lane = tid / slots;

  Bits* xs = reinterpret_cast<Bits*>(smem);     // the slice or two passes
  const int nsub = (cg + SUB - 1) / SUB;        // runs of a group
  double* p1 = reinterpret_cast<double*>(smem + stage_bytes);  // [nq][ct]
  double* p2 = p1 + nq * ct;
  float* af = reinterpret_cast<float*>(p1);     // then a, b per channel
  float* bf = reinterpret_cast<float*>(p2);
  double* ch1 = p2 + nq * ct;                   // [ct]
  double* ch2 = ch1 + ct;
  double* run1 = ch2 + ct;                      // [k][nsub]
  double* run2 = run1 + k * nsub;
  double* gp1 = run2 + k * nsub;                // [k], peers read
  double* gp2 = gp1 + k;

  const Bits* xb = x + (size_t)blockIdx.z * S * C + (size_t)blockIdx.y * ct;
  Bits* yb = y + (size_t)blockIdx.z * S * C + (size_t)blockIdx.y * ct;
  auto src = [&](int r, int cv) {
    return xb + (size_t)(r0 + r) * C + cv * V;
  };

  // the slice in passes of pass_rows rows: kept in place, all in flight
  // (resident), or through two buffers, two in flight; vector i of a pass
  // on thread i % THREADS, consecutive threads on consecutive vectors
  const int np = (nr + pass_rows - 1) / pass_rows;
  auto held_pass = [&](int p) {
    return xs + (size_t)(resident ? p : p & 1) * pass_rows * ct;
  };
  auto issue = [&](int p) {
    if (p < np) {
      const int n = min(pass_rows, nr - p * pass_rows) * vpr;
      Bits* d = held_pass(p);
      for (int i = tid; i < n; i += THREADS)
        stage<VB>(d + (size_t)i * V, src(p * pass_rows + i / vpr, i % vpr));
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  double s1[CH_MAX], s2[CH_MAX];
#pragma unroll
  for (int i = 0; i < CH_MAX; ++i) s1[i] = s2[i] = 0.0;
  // resident: every pass in flight at once; else two, through two buffers
  const int ahead = resident ? np : 2;
  for (int p = 0; p < ahead; ++p) issue(p);
  for (int p = 0; p < np; ++p) {
    wait_groups(resident ? np - 1 - p : 1);
    __syncthreads();
    // this thread's rows of the pass, in order, per channel
    const Bits* buf = held_pass(p);
    const int lo = p * pass_rows, hi = min(nr, lo + pass_rows);
    const int first = q < nq ? lo + ((q - lo) % nq + nq) % nq : hi;
#pragma unroll
    for (int i = 0; i < CH_MAX; ++i) {
      const int c = c0 + i * THREADS;
      if (c < ct) {
#pragma unroll 4
        for (int r = first; r < hi; r += nq) {
          const double f = E::in(buf[(size_t)(r - p * pass_rows) * ct + c]);
          s1[i] += f;
          s2[i] = fma(f, f, s2[i]);
        }
      }
    }
    if (!resident) {
      __syncthreads();
      issue(p + 2);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // this thread's channels of the a/b pass (read now, used after the
  // cluster barrier)
  float sc[CH_MAX], bi[CH_MAX];
#pragma unroll
  for (int i = 0; i < CH_MAX; ++i) {
    const int c = tid + i * THREADS;
    sc[i] = c < ct ? scale[blockIdx.y * ct + c] : 0.f;
    bi[i] = c < ct ? bias[blockIdx.y * ct + c] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < CH_MAX; ++i) {
    const int c = c0 + i * THREADS;
    if (q < nq && c < ct) {
      p1[q * ct + c] = s1[i];
      p2[q * ct + c] = s2[i];
    }
  }
  __syncthreads();
  // the chunks in order, then a group's channels in runs of SUB in order
  // and the runs in order, then the cluster's blocks in rank order
  for (int c = tid; c < ct; c += THREADS) {
    double a1 = 0.0, a2 = 0.0;
    for (int j = 0; j < nq; ++j) {
      a1 += p1[j * ct + c];
      a2 += p2[j * ct + c];
    }
    ch1[c] = a1;
    ch2[c] = a2;
  }
  __syncthreads();
  for (int e = tid; e < k * nsub; e += THREADS) {
    const int g = e / nsub, u = e % nsub;
    const int j1 = min(cg, (u + 1) * SUB);
    double a1 = 0.0, a2 = 0.0;
    for (int j = u * SUB; j < j1; ++j) {
      a1 += ch1[g * cg + j];
      a2 += ch2[g * cg + j];
    }
    run1[e] = a1;
    run2[e] = a2;
  }
  __syncthreads();
  for (int g = tid; g < k; g += THREADS) {
    double a1 = 0.0, a2 = 0.0;
    for (int u = 0; u < nsub; ++u) {
      a1 += run1[g * nsub + u];
      a2 += run2[g * nsub + u];
    }
    gp1[g] = a1;
    gp2[g] = a2;
  }
  sdt_cluster::sync();

  // the cluster's sums in rank order, then a and b per channel: a =
  // scale / sqrt(var + eps) rounded once to f32, b = bias - mean * a
#pragma unroll
  for (int i = 0; i < CH_MAX; ++i) {
    const int c = tid + i * THREADS;
    if (c >= ct) break;
    const int g = c / cg;
    const double mean = sdt_cluster::sum_peers(gp1 + g, cl) / n_per_group;
    const double var =
        sdt_cluster::sum_peers(gp2 + g, cl) / n_per_group - mean * mean;
    const float a = (float)(sc[i] / sqrt(var + (double)eps));
    af[c] = a;
    bf[c] = (float)(bi[i] - mean * a);
  }
  sdt_cluster::arrive();  // done reading the peers' partials
  __syncthreads();

  // the output: a thread keeps its vectors' a and b in registers
  if (lane < lanes) {
    for (int cv = slot; cv < vpr; cv += slots) {
      float a[V], b[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a[j] = af[cv * V + j];
        b[j] = bf[cv * V + j];
      }
#pragma unroll 4
      for (int r = lane; r < nr; r += lanes) {
        VecT v;
        v.load(resident ? xs + (size_t)r * ct + cv * V : src(r, cv));
        float t[V];
#pragma unroll
        for (int j = 0; j < V; ++j)
          t[j] = __fadd_rn(__fmul_rn(E::in(v.b[j]), a[j]), b[j]);
        if (silu) {
          if (fast) {  // at bf16: y and its sigmoid rounded first
            float sg[V];
            E::round(t);
#pragma unroll
            for (int j = 0; j < V; ++j) sg[j] = sigmoid(t[j]);
            E::round(sg);
#pragma unroll
            for (int j = 0; j < V; ++j) t[j] = t[j] * sg[j];
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j) t[j] = t[j] * sigmoid(t[j]);
          }
        }
        E::out(t, v.b);
        v.store(yb + (size_t)(r0 + r) * C + cv * V);
      }
    }
  }
  sdt_cluster::wait();
}

// the staged bytes: the slice (resident) or two passes, padded to 16
long long stage_bytes(int esize, int ct, int rows, int pass_rows,
                      int resident) {
  const long long n = resident ? rows : 2 * pass_rows;
  return (n * ct * esize + 15) / 16 * 16;
}

// dynamic shared memory of a launch: the staged rows, the row chunks'
// per-channel sums, the channels' and the group partials
// (ops/group_norm.py::gn_plan computes the same)
long long smem_bytes(int esize, int ct, int cg, int rows, int pass_rows,
                     int resident) {
  const int nq = ct < THREADS ? THREADS / ct : 1;
  const int k = ct / cg, nsub = (cg + SUB - 1) / SUB;
  return stage_bytes(esize, ct, rows, pass_rows, resident) + 16 * nq * ct +
         16 * (ct + k * nsub + k);
}

template <typename E, int VB>
cudaError_t launch_vb(const void* x, const float* scale, const float* bias,
                      void* y, int B, int S, int C, int cg, int ct, int cl,
                      int rows, int pass_rows, int resident, int staged,
                      int smem, float eps, int silu, int fast,
                      cudaStream_t st) {
  using Bits = typename E::bits;
  return sdt_cluster::launch<gn_fused_kernel<E, VB>>(
      dim3(cl, C / ct, B), THREADS, cl, smem, st, false,
      static_cast<const Bits*>(x), scale, bias, static_cast<Bits*>(y), S, C,
      cg, ct, rows, pass_rows, resident, staged, (double)S * cg, eps,
      silu, fast);
}

template <typename E>
cudaError_t launch_type(int vb, const void* x, const float* scale,
                        const float* bias, void* y, int B, int S, int C,
                        int cg, int ct, int cl, int rows, int pass_rows,
                        int resident, int staged, int smem, float eps,
                        int silu, int fast, cudaStream_t st) {
#define SDT_GN_LAUNCH(VB)                                                    \
  return launch_vb<E, VB>(x, scale, bias, y, B, S, C, cg, ct, cl, rows,      \
                          pass_rows, resident, staged, smem, eps, silu, fast, \
                          st)
  switch (vb) {
    case 16: SDT_GN_LAUNCH(16);
    case 8: SDT_GN_LAUNCH(8);
    case 4: SDT_GN_LAUNCH(4);
    default:
      if constexpr (sizeof(typename E::bits) == 2) {
        SDT_GN_LAUNCH(2);
      } else {
        return cudaErrorInvalidValue;
      }
  }
#undef SDT_GN_LAUNCH
}

}  // namespace

// x, y [B, S, C] contiguous, of dtype 0 f32, 1 bf16, 2 f16; scale, bias [C]
// f32. Plan (ops/group_norm.py::gn_plan): tiles of ct channels (whole
// groups of C / G, ct <= 4096), clusters of cl blocks of `rows` rows,
// staged in passes of pass_rows rows, vb-byte vectors, resident 1 for the
// one-read form. silu 1 applies SiLU, fast 1 its bf16 form. Returns a
// cudaError_t (cudaErrorInvalidValue for a plan the shape, the pointers or
// the card do not take).
extern "C" int sdt_group_norm_fused(const void* x, const float* scale,
                                    const float* bias, void* y, int dtype,
                                    int B, int S, int C, int G, int ct,
                                    int cl, int rows, int pass_rows, int vb,
                                    int resident, float eps, int silu,
                                    int fast, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || B < 1 || B > 65535 || S < 1 || G < 1 ||
      C < G || C % G || ct < 1 || ct > CH_MAX * THREADS || C % ct ||
      ct % (C / G) || cl < 1 || cl > CLUSTER_MAX || rows < 1 ||
      (long long)rows * cl < S || (long long)rows * (cl - 1) >= S ||
      pass_rows < 1 || (vb != 2 && vb != 4 && vb != 8 && vb != 16) ||
      vb < esize || (ct * esize) % vb || (C * esize) % vb ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) %
          vb)
    return (int)cudaErrorInvalidValue;
  const int cg = C / G;
  const long long staged = stage_bytes(esize, ct, rows, pass_rows, resident);
  const long long smem = smem_bytes(esize, ct, cg, rows, pass_rows, resident);
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > max_smem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SDT_GN_TYPE(E)                                                     \
  return (int)launch_type<E>(vb, x, scale, bias, y, B, S, C, cg, ct, cl,  \
                             rows, pass_rows, resident, (int)staged,      \
                             (int)smem, eps, silu, fast, st)
  switch (dtype) {
    case 0: SDT_GN_TYPE(F32);
    case 1: SDT_GN_TYPE(BF16);
    default: SDT_GN_TYPE(F16);
  }
#undef SDT_GN_TYPE
}
