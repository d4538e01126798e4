// Unmasked self-attention softmax(Q K^T * scale) V over [B, S, H, D], bf16
// on the tensor cores; f32 inputs take the CUDA-core kernel further down.
//
// Replaces: safe_denoiser_tpu/ops/attention.py::_attn_kernel (reached
// through _self_attention_bhsd <- self_attention), the UNet's spatial
// self-attention at head dim 40 (S=4096) and 80 (S=1024).
//
// Bound on an H100: 4*B*H*S^2*D operations against ~2*B*S*H*D*4 bytes, so
// at S=4096, D=40 it is compute-bound (172 GFLOP, ~0.17 ms at 989 TFLOP/s
// bf16 dense).
//
// Design: one block of 4 warps per (b*h, 64-query tile); each warp owns 16
// query rows. The block walks the keys in 64-row tiles staged in shared
// memory (K as [key][d], V transposed to [d][key] so both mma operands are
// 32-bit shared loads). Q K^T and P V run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 accumulate). The softmax is online in the
// exp2 domain with sm_scale*log2(e) folded into one multiply, f32 running
// max / sum / accumulator, one reciprocal at the end -- the same numerics
// as the TPU kernel. The head dim is zero-padded inside shared memory to a
// multiple of 16 (40 -> 48) with masked loads; keys past S are masked to
// -inf (the valid_kv tail mask); query rows past S are never stored.
// Global rows of one head are D*2 bytes apart (80 / 160 bytes), so 16-byte
// vector loads are used only when every base and stride is 16-byte
// aligned; otherwise the loads fall back to 2-byte elements.
// Not yet done (later work): cp.async/TMA double buffering, wgmma.

#include "attention_tile.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int NTHREADS = 128;
constexpr int LDT = BK + 8;  // row pitch of the transposed V tile

using sdt_tile::ld32;
using sdt_tile::mma16816;
using sdt_tile::pack_bf16;

// [64 rows x DP cols] of one head into shared [row][ld]; zero past S / D.
template <int DP>
__device__ void load_rows(__nv_bfloat16* dst, int ld,
                          const __nv_bfloat16* src, long long row_stride,
                          int row0, int S, int D, bool vec) {
  constexpr int CH = DP / 8;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int idx = threadIdx.x; idx < BQ * CH; idx += NTHREADS) {
    int r = idx / CH, c = (idx % CH) * 8;
    int s = row0 + r;
    __nv_bfloat16* d = dst + r * ld + c;
    if (vec && s < S && c + 8 <= D) {
      *reinterpret_cast<uint4*>(d) =
          *reinterpret_cast<const uint4*>(src + s * row_stride + c);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        int cc = c + e;
        d[e] = (s < S && cc < D) ? src[s * row_stride + cc] : zero;
      }
    }
  }
}

// [64 keys x DP] of V, stored transposed as [d][key].
template <int DP>
__device__ void load_vt(__nv_bfloat16* vt, const __nv_bfloat16* src,
                        long long row_stride, int row0, int S, int D) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int idx = threadIdx.x; idx < BK * DP; idx += NTHREADS) {
    int r = idx / DP, c = idx % DP;
    int s = row0 + r;
    vt[c * LDT + r] = (s < S && c < D) ? src[s * row_stride + c] : zero;
  }
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS)
attn_kernel(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
            int S, int H, int D, long long sb, long long ss, long long sh,
            float c_log2, bool vec) {
  constexpr int LD = DP + 8;
  constexpr int KSTEPS = DP / 16;
  constexpr int NT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vt = Ks + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;

  load_rows<DP>(Qs, LD, q + base, ss, q0, S, D, vec);
  __syncthreads();

  uint32_t qf[KSTEPS][4];
  {
    const __nv_bfloat16* r0 = Qs + (warp * 16 + g) * LD + t4 * 2;
    const __nv_bfloat16* r1 = r0 + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      qf[kk][0] = ld32(r0 + kk * 16);
      qf[kk][1] = ld32(r1 + kk * 16);
      qf[kk][2] = ld32(r0 + kk * 16 + 8);
      qf[kk][3] = ld32(r1 + kk * 16 + 8);
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    load_rows<DP>(Ks, LD, k + base, ss, k0, S, D, vec);
    load_vt<DP>(Vt, v + base, ss, k0, S, D);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kp = Ks + (n * 8 + g) * LD + kk * 16 + t4 * 2;
        uint32_t bfrag[2] = {ld32(kp), ld32(kp + 8)};
        mma16816(s[n], qf[kk], bfrag);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + n * 8 + t4 * 2 + e < S;
        float a = valid ? s[n][e] * c_log2 : -INFINITY;
        float c = valid ? s[n][2 + e] * c_log2 : -INFINITY;
        s[n][e] = a;
        s[n][2 + e] = c;
        mx0 = fmaxf(mx0, a);
        mx1 = fmaxf(mx1, c);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // the first tile always holds key 0, so the running max is finite here
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
    // P (16 x 64, bf16) @ V (64 x DP): the S accumulator layout of two
    // adjacent n-tiles is exactly the A-fragment layout of one k-step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t afrag[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* vp = Vt + (j * 8 + g) * LDT + kk * 16 + t4 * 2;
        uint32_t bfrag[2] = {ld32(vp), ld32(vp + 8)};
        mma16816(acc[j], afrag, bfrag);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  // output is contiguous [B, S, H, D]
  __nv_bfloat16* o0 = o + (((long long)b * S + r0) * H + h) * D;
  __nv_bfloat16* o1 = o + (((long long)b * S + r1) * H + h) * D;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = j * 8 + t4 * 2 + e;
      if (d < D) {
        if (r0 < S) o0[d] = __float2bfloat16(acc[j][e] * inv0);
        if (r1 < S) o1[d] = __float2bfloat16(acc[j][2 + e] * inv1);
      }
    }
  }
}

// f32 inputs (the f32 pipelines; the TPU kernel takes both types): one warp
// per query row, the head dim spread over the lanes (up to F32_VPL values
// each), keys read straight from global memory (one head's K/V stays in
// L2) with the same exp2 online softmax. CUDA-core FMA in full f32, so the
// result matches an f32 reference to round-off; off the bf16 main path,
// so it is kept simple rather than fast.
constexpr int F32_WARPS = 4;
constexpr int F32_VPL = 8;  // 32 lanes x 8 values covers D <= 256

__global__ void __launch_bounds__(F32_WARPS * 32)
attn_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int S,
                int H, int D, long long sb, long long ss, long long sh,
                float c_log2) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * F32_WARPS + warp;
  if (row >= S) return;  // the whole warp leaves together
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long base = b * sb + h * sh;
  float qv[F32_VPL], acc[F32_VPL];
#pragma unroll
  for (int i = 0; i < F32_VPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? q[base + row * ss + d] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < S; ++j) {
    const float* kr = k + base + j * ss;
    const float* vr = v + base + j * ss;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < F32_VPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) s = fmaf(qv[i], kr[d], s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    s *= c_log2;
    const float mn = fmaxf(m, s);
    const float al = exp2f(m - mn), p = exp2f(s - mn);
    l = l * al + p;
    m = mn;
#pragma unroll
    for (int i = 0; i < F32_VPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc[i] = fmaf(p, vr[d], acc[i] * al);
    }
  }
  const float inv = 1.f / l;
  float* orow = o + (((long long)b * S + row) * H + h) * D;
#pragma unroll
  for (int i = 0; i < F32_VPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) orow[d] = acc[i] * inv;
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int D, long long sb, long long ss, long long sh, float c,
           bool vec, cudaStream_t stream) {
  const size_t smem =
      (size_t)(BQ + BK) * (DP + 8) * sizeof(__nv_bfloat16) +
      (size_t)DP * LDT * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + BQ - 1) / BQ, B * H);
  attn_kernel<DP><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      H, D, sb, ss, sh, c, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v share the element strides (sb, ss, sh) and a unit last stride;
// o is a contiguous [B, S, H, D]. Returns a cudaError_t.
extern "C" int sdt_self_attention_bf16(const void* q, const void* k,
                                       const void* v, void* o, int B, int S,
                                       int H, int D, long long sb,
                                       long long ss, long long sh,
                                       float sm_scale, void* stream) {
  const float c = sm_scale * 1.4426950408889634f;  // log2(e)
  const uintptr_t align = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const bool vec = D % 8 == 0 && align % 16 == 0 && sb % 8 == 0 &&
                   ss % 8 == 0 && sh % 8 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0) return (int)cudaErrorInvalidValue;
  if (D <= 48) return launch<48>(q, k, v, o, B, S, H, D, sb, ss, sh, c, vec, st);
  if (D <= 64) return launch<64>(q, k, v, o, B, S, H, D, sb, ss, sh, c, vec, st);
  if (D <= 80) return launch<80>(q, k, v, o, B, S, H, D, sb, ss, sh, c, vec, st);
  if (D <= 128) return launch<128>(q, k, v, o, B, S, H, D, sb, ss, sh, c, vec, st);
  if (D <= 160) return launch<160>(q, k, v, o, B, S, H, D, sb, ss, sh, c, vec, st);
  if (D <= 256) return launch<256>(q, k, v, o, B, S, H, D, sb, ss, sh, c, vec, st);
  return (int)cudaErrorInvalidValue;
}

// The same contract for f32 q, k, v and o.
extern "C" int sdt_self_attention_f32(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int D, long long sb,
                                      long long ss, long long sh,
                                      float sm_scale, void* stream) {
  if (D <= 0 || D > 32 * F32_VPL) return (int)cudaErrorInvalidValue;
  const float c = sm_scale * 1.4426950408889634f;  // log2(e)
  dim3 grid((S + F32_WARPS - 1) / F32_WARPS, B * H);
  attn_kernel_f32<<<grid, F32_WARPS * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, D, sb, ss,
      sh, c);
  return (int)cudaGetLastError();
}
