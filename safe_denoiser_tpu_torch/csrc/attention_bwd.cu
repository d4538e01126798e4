// The backward of B1 (unmasked self-attention, csrc/attention.cu): dQ, dK,
// dV of O = softmax(s Q K^T) V over bf16 [B, S, H, D] q/k/v, with f32
// accumulation on the warp-level tensor-core instruction mma.sync
// m16n8k16 (bf16 in, f32 out).
//
// Replaces no TPU kernel: the JAX package's _attn_kernel
// (safe_denoiser_tpu/ops/attention.py:36) has no VJP, so its trainer
// differentiates only XLA's einsum path. This kernel computes the gradient
// of the function B1 computes, what jax.vjp gives on that einsum path, so
// that training runs through B1 on the card.
//
// Three launches, one wrapper call (ops/attention.py::_attention_bwd_cuda):
//   1. prep: per query row, its logsumexp L (log2 domain, recomputed from
//      Q K^T: the forward kernel keeps none) and Delta = rowsum(dO * O);
//   2. dkdv: a block owns 64 keys and walks every 64-query block:
//      P^T = exp2(c K Q^T - L), dV += P^T dO, dS^T = P^T (V dO^T - Delta),
//      dK += dS^T Q;
//   3. dq: a block owns 64 queries and walks every 64-key block:
//      dQ += dS K.
// Every output element is summed by one thread in a fixed order: no
// atomics, so two calls give the same bits. Keys at or past S are masked
// (P = 0), query rows at or past S are neither read nor written, so any S
// works (SD3's 4429). D is zero-padded to a multiple of 16 in shared
// memory (DP <= 128).
//
// Bound on an H100: operations. The backward's necessary work is five
// S x S x D products per head, 10 B H S^2 D FLOP (0.054 ms at
// [1,4096,8,40]); this first form does eight (the prep's Q K^T and the dq
// pass's Q K^T and dO V^T are recomputed), on mma.sync from shared memory
// without a copy pipeline: right first, fast later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BR = 64;        // rows a block owns (queries or keys)
constexpr int BC = 64;        // rows of the block walked by the inner loop
constexpr int THREADS = 128;  // four warps, 16 rows each
constexpr int PT = BC + 8;    // pitch of the transposed tiles

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 16, row-major) of rows r0.. and k columns k0.. of a
// row-major shared tile of pitch p; g = lane / 4, t = lane % 4.
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* tile, int p,
                                       int r0, int k0, int g, int t) {
  const bf16* s = tile + (r0 + g) * p + k0 + 2 * t;
  a[0] = ld32(s);
  a[1] = ld32(s + 8 * p);
  a[2] = ld32(s + 8);
  a[3] = ld32(s + 8 * p + 8);
}

// B fragment (16 x 8) of n columns n0.. and k rows k0.. from a tile that
// holds row n with its k values contiguous.
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* tile, int p, int n0,
                                       int k0, int g, int t) {
  const bf16* s = tile + (n0 + g) * p + k0 + 2 * t;
  b0 = ld32(s);
  b1 = ld32(s + 8);
}

// An A fragment from two f32 accumulator tiles (16 x 8 each, columns
// 0..7 and 8..15 of the k range), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* lo,
                                         const float* hi) {
  a[0] = pack2(lo[0], lo[1]);
  a[1] = pack2(lo[2], lo[3]);
  a[2] = pack2(hi[0], hi[1]);
  a[3] = pack2(hi[2], hi[3]);
}

// Rows row0 .. row0+63 of one head of a [B, S, H, D] tensor (src points at
// its (b, 0, h, 0), row stride rs) into a [64][DP + 8] tile and, if tt is
// set, its transpose [DP][PT]; zeros past S and past D.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* tile, bf16* tt,
                                          const bf16* src, int row0, int S,
                                          int D, long long rs) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < BR * DP; i += THREADS) {
    const int r = i / DP, d = i - r * DP;
    bf16 v = zero;
    if (row0 + r < S && d < D) v = src[(long long)(row0 + r) * rs + d];
    tile[r * (DP + 8) + d] = v;
    if (tt) tt[d * PT + r] = v;
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
    attn_bwd_prep(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ o, const bf16* __restrict__ dout,
                  float* __restrict__ lse, float* __restrict__ delta, int S,
                  int H, int D, float c) {
  constexpr int P = DP + 8;
  __shared__ __align__(16) bf16 qs[BR * P];
  __shared__ __align__(16) bf16 ks[BC * P];
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const long long rs = (long long)H * D;
  const long long base = (long long)b * S * rs + (long long)h * D;
  const int row0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  {  // Delta: two threads a row, the halves added by one shuffle
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    float acc = 0.f;
    if (row0 + r < S) {
      const long long off = base + (long long)(row0 + r) * rs;
      for (int d = half; d < D; d += 2)
        acc += __bfloat162float(o[off + d]) * __bfloat162float(dout[off + d]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0 && row0 + r < S) delta[(long long)bh * S + row0 + r] = acc;
  }

  load_rows<DP>(qs, nullptr, q + base, row0, S, D, rs);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < S; k0 += BC) {
    __syncthreads();
    load_rows<DP>(ks, nullptr, k + base, k0, S, D, rs);
    __syncthreads();
    float s[BC / 8][4];
#pragma unroll
    for (int n = 0; n < BC / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4];
      frag_a(a, qs, P, warp * 16, kk, g, t);
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, ks, P, n * 8, kk, g, t);
        mma(s[n], a, b0, b1);
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const float v = key < S ? s[n][e] * c : -INFINITY;
        s[n][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      l[i] *= exp2f(m[i] - mx[i]);  // the block's key k0 < S is finite
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[n][e] - m[e >> 1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = row0 + warp * 16 + g + 8 * i;
    if (t == 0 && r < S) lse[(long long)bh * S + r] = m[i] + log2f(l[i]);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
    attn_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int S, int H, int D, float c,
                  float scale) {
  constexpr int P = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BR * P;
  bf16* qs = vs + BR * P;
  bf16* dos = qs + BC * P;
  bf16* qt = dos + BC * P;
  bf16* dot = qt + DP * PT;
  float* ls = reinterpret_cast<float*>(dot + DP * PT);
  float* dl = ls + BC;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const long long rs = (long long)H * D;
  const long long base = (long long)b * S * rs + (long long)h * D;
  const int key0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  load_rows<DP>(ks, nullptr, k + base, key0, S, D, rs);
  load_rows<DP>(vs, nullptr, v + base, key0, S, D, rs);
  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int q0 = 0; q0 < S; q0 += BC) {
    __syncthreads();
    load_rows<DP>(qs, qt, q + base, q0, S, D, rs);
    load_rows<DP>(dos, dot, dout + base, q0, S, D, rs);
    for (int i = threadIdx.x; i < BC; i += THREADS) {
      const bool in = q0 + i < S;
      // a row past S gets L = +inf: its P and dS are 0
      ls[i] = in ? lse[(long long)bh * S + q0 + i] : INFINITY;
      dl[i] = in ? delta[(long long)bh * S + q0 + i] : 0.f;
    }
    __syncthreads();
    float st[BC / 8][4], dpt[BC / 8][4];
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t ak[4], av[4];
      frag_a(ak, ks, P, warp * 16, kk, g, t);
      frag_a(av, vs, P, warp * 16, kk, g, t);
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, qs, P, n * 8, kk, g, t);
        mma(st[n], ak, b0, b1);
        frag_b(b0, b1, dos, P, n * 8, kk, g, t);
        mma(dpt[n], av, b0, b1);
      }
    }
    // P^T and dS^T; column = the query
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + 2 * t + (e & 1);
        const float p = exp2f(st[n][e] * c - ls[qi]);
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - dl[qi]);
      }
#pragma unroll
    for (int kq = 0; kq < BC / 16; ++kq) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, st[2 * kq], st[2 * kq + 1]);
      acc_to_a(sa, dpt[2 * kq], dpt[2 * kq + 1]);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, dot, PT, n * 8, kq * 16, g, t);
        mma(dva[n], pa, b0, b1);
        frag_b(b0, b1, qt, PT, n * 8, kq * 16, g, t);
        mma(dka[n], sa, b0, b1);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + warp * 16 + g + 8 * (e >> 1);
      const int d = n * 8 + 2 * t + (e & 1);
      if (key < S && d < D) {
        const long long off = base + (long long)key * rs + d;
        dk[off] = __float2bfloat16(dka[n][e] * scale);
        dv[off] = __float2bfloat16(dva[n][e]);
      }
    }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
    attn_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq, int S,
                int H, int D, float c, float scale) {
  constexpr int P = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + BR * P;
  bf16* ks = dos + BR * P;
  bf16* vs = ks + BC * P;
  bf16* kt = vs + BC * P;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const long long rs = (long long)H * D;
  const long long base = (long long)b * S * rs + (long long)h * D;
  const int row0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  load_rows<DP>(qs, nullptr, q + base, row0, S, D, rs);
  load_rows<DP>(dos, nullptr, dout + base, row0, S, D, rs);
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + g + 8 * i;
    lr[i] = r < S ? lse[(long long)bh * S + r] : INFINITY;
    dr[i] = r < S ? delta[(long long)bh * S + r] : 0.f;
  }
  float dqa[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BC) {
    __syncthreads();
    load_rows<DP>(ks, kt, k + base, k0, S, D, rs);
    load_rows<DP>(vs, nullptr, v + base, k0, S, D, rs);
    __syncthreads();
    float s[BC / 8][4], dp[BC / 8][4];
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t aq[4], ao[4];
      frag_a(aq, qs, P, warp * 16, kk, g, t);
      frag_a(ao, dos, P, warp * 16, kk, g, t);
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, ks, P, n * 8, kk, g, t);
        mma(s[n], aq, b0, b1);
        frag_b(b0, b1, vs, P, n * 8, kk, g, t);
        mma(dp[n], ao, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const float p =
            key < S ? exp2f(s[n][e] * c - lr[e >> 1]) : 0.f;
        s[n][e] = p * (dp[n][e] - dr[e >> 1]);  // dS
      }
#pragma unroll
    for (int kq = 0; kq < BC / 16; ++kq) {
      uint32_t sa[4];
      acc_to_a(sa, s[2 * kq], s[2 * kq + 1]);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, kt, PT, n * 8, kq * 16, g, t);
        mma(dqa[n], sa, b0, b1);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + warp * 16 + g + 8 * (e >> 1);
      const int d = n * 8 + 2 * t + (e & 1);
      if (r < S && d < D)
        dq[base + (long long)r * rs + d] = __float2bfloat16(dqa[n][e] * scale);
    }
}

template <int DP>
constexpr int dkdv_smem() {
  return (2 * BR + 2 * BC) * (DP + 8) * 2 + 2 * DP * PT * 2 + 2 * BC * 4;
}

template <int DP>
constexpr int dq_smem() {
  return (2 * BR + 2 * BC) * (DP + 8) * 2 + DP * PT * 2;
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, bf16* dq, bf16* dk, bf16* dv, float* lse,
           float* delta, int B, int S, int H, int D, float sm_scale,
           cudaStream_t stream) {
  static_assert(dkdv_smem<DP>() <= 232448, "dkdv tiles exceed shared memory");
  const float c = sm_scale * 1.4426950408889634f;  // log2(e)
  const dim3 grid((S + BR - 1) / BR, B * H);
  attn_bwd_prep<DP><<<grid, THREADS, 0, stream>>>(q, k, o, dout, lse, delta,
                                                  S, H, D, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkdv<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_smem<DP>());
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv<DP><<<grid, THREADS, dkdv_smem<DP>(), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, H, D, c, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dq<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem<DP>());
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq<DP><<<grid, THREADS, dq_smem<DP>(), stream>>>(
      q, k, v, dout, lse, delta, dq, S, H, D, c, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o (B1's output), dout, and the outputs dq, dk, dv: contiguous
// bf16 [B, S, H, D] with 4-byte aligned bases; lse and delta: f32 scratch
// of B*H*S each. Needs 1 <= D <= 128 and B*H <= 65535. Returns a
// cudaError_t.
extern "C" int sdt_attention_bwd_bf16(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, void* dq, void* dk,
                                      void* dv, float* lse, float* delta,
                                      int B, int S, int H, int D,
                                      float sm_scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > 128 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const bf16 *q_ = (const bf16*)q, *k_ = (const bf16*)k, *v_ = (const bf16*)v,
             *o_ = (const bf16*)o, *g_ = (const bf16*)dout;
  bf16 *dq_ = (bf16*)dq, *dk_ = (bf16*)dk, *dv_ = (bf16*)dv;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 15) / 16) {
    case 1: return launch<16>(q_, k_, v_, o_, g_, dq_, dk_, dv_, lse, delta, B, S, H, D, sm_scale, s);
    case 2: return launch<32>(q_, k_, v_, o_, g_, dq_, dk_, dv_, lse, delta, B, S, H, D, sm_scale, s);
    case 3: return launch<48>(q_, k_, v_, o_, g_, dq_, dk_, dv_, lse, delta, B, S, H, D, sm_scale, s);
    case 4: return launch<64>(q_, k_, v_, o_, g_, dq_, dk_, dv_, lse, delta, B, S, H, D, sm_scale, s);
    case 5: return launch<80>(q_, k_, v_, o_, g_, dq_, dk_, dv_, lse, delta, B, S, H, D, sm_scale, s);
    case 6: return launch<96>(q_, k_, v_, o_, g_, dq_, dk_, dv_, lse, delta, B, S, H, D, sm_scale, s);
    case 7: return launch<112>(q_, k_, v_, o_, g_, dq_, dk_, dv_, lse, delta, B, S, H, D, sm_scale, s);
    default: return launch<128>(q_, k_, v_, o_, g_, dq_, dk_, dv_, lse, delta, B, S, H, D, sm_scale, s);
  }
}
