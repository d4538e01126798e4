// Unmasked self-attention softmax(Q K^T * scale) V over [B, S, H, D] with
// Q K^T in int8 on the tensor cores and P V in bf16.
//
// Replaces: safe_denoiser_tpu/ops/attention.py::_attn_kernel(quant_i8=True)
// (SDT_INT8_ATTN=1, reached through _self_attention_bhsd <- self_attention),
// the SD3 MMDiT's joint attention at [2, 4429, 24, 64] (and the SD-v1
// UNet's at head dim 40 / 80 when the switch is on).
//
// Arithmetic, as the TPU kernel: Q is quantized per query row and K per key
// token over D, both with r = 127 / max(amax, 1e-20), round half to even
// (rintf) and a clip to +-127; Q K^T is an exact int32 sum; the logit in
// the exp2 domain is (float(s32) * q_amax * c/127) * (k_amax * 1/127) with
// c = sm_scale * log2(e); keys past S are masked to -inf; the softmax is
// online in f32; P is rounded to bf16 for P V, which accumulates in f32;
// the output is bf16.
//
// Bound on an H100: QK^T 2*B*H*S^2*D int8 operations at 1,979 TOP/s plus
// P V 2*B*H*S^2*D bf16 at 989 TFLOP/s; at [2,4429,24,64] ~0.18 ms,
// compute-bound (the inputs are 7 MB).
//
// Design: B1's (csrc/attention.cu) with the first product swapped. One
// block of 4 warps per (b*h, 64-query tile); each warp owns 16 query rows.
// The Q tile is staged in bf16, quantized once into shared memory (two
// threads per row: amax over their half, one shuffle, then round), and its
// A fragments stay in registers for the whole key loop. Per 64-key tile,
// K is staged in bf16 and quantized the same way into shared memory with
// its per-key dequant factor; V is stored transposed [d][key] in bf16.
// Q K^T runs mma.sync m16n8k32 s8*s8->s32, P V mma.sync m16n8k16 bf16->f32
// with the S accumulator reused as P. The head dim is zero-padded in
// shared memory to a multiple of 32 (40 -> 64, 80 -> 96); zeros quantize
// to zero and add nothing, as the TPU kernel's pad to 64.
// Not yet done (later work): cp.async/TMA double buffering, wgmma, a
// quantize pass that does not stall the tensor cores.

#include "attention_tile.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int NTHREADS = 128;
constexpr int LDT = BK + 8;  // row pitch of the transposed V tile (bf16)

using sdt_tile::ld32;
using sdt_tile::mma16816;
using sdt_tile::pack_bf16;

__device__ __forceinline__ void mma16832_s8(int* c, const uint32_t* a,
                                            const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// [64 rows x DP cols] of one head into shared bf16 [row][ld]; zero past S
// and past D.
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

// Quantize the 64 staged bf16 rows to int8 rows of dst (pitch ldi), two
// threads per row; deq[row] = amax * dscale.
template <int DP>
__device__ void quantize_rows(const __nv_bfloat16* stage, int ldh,
                              int8_t* dst, int ldi, float* deq,
                              float dscale) {
  constexpr int HALF = DP / 2;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const __nv_bfloat16* src = stage + r * ldh + half * HALF;
  float amax = 0.f;
#pragma unroll 8
  for (int c = 0; c < HALF; ++c)
    amax = fmaxf(amax, fabsf(__bfloat162float(src[c])));
  amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
  const float rr = 127.f / fmaxf(amax, 1e-20f);
  int8_t* d = dst + r * ldi + half * HALF;
#pragma unroll 8
  for (int c = 0; c < HALF; ++c) {
    const float x = rintf(__bfloat162float(src[c]) * rr);  // half to even
    d[c] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(x, -127.f),
                                                      127.f)));
  }
  if (half == 0) deq[r] = amax * dscale;
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS)
attn_i8_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int S, int H, int D,
               long long sb, long long ss, long long sh, float cq, float ck,
               bool vec) {
  static_assert(DP % 32 == 0, "the int8 contraction steps by 32");
  constexpr int LDH = DP + 8;     // bf16 staging pitch
  constexpr int LDI = DP + 16;    // int8 pitch: rows 4 words off mod 32
  constexpr int KSTEPS = DP / 32;
  constexpr int NT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vt = stage + BQ * LDH;
  int8_t* Qi = reinterpret_cast<int8_t*>(Vt + DP * LDT);
  int8_t* Ki = Qi + BQ * LDI;
  float* qdeq = reinterpret_cast<float*>(Ki + BK * LDI);
  float* kdeq = qdeq + BQ;

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;

  load_rows<DP>(stage, LDH, q + base, ss, q0, S, D, vec);
  __syncthreads();
  quantize_rows<DP>(stage, LDH, Qi, LDI, qdeq, cq);
  __syncthreads();

  uint32_t qf[KSTEPS][4];
  {
    const int8_t* r0 = Qi + (warp * 16 + g) * LDI + t4 * 4;
    const int8_t* r1 = r0 + 8 * LDI;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      qf[kk][0] = ld32(r0 + kk * 32);
      qf[kk][1] = ld32(r1 + kk * 32);
      qf[kk][2] = ld32(r0 + kk * 32 + 16);
      qf[kk][3] = ld32(r1 + kk * 32 + 16);
    }
  }
  const float qd0 = qdeq[warp * 16 + g], qd1 = qdeq[warp * 16 + g + 8];

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    load_rows<DP>(stage, LDH, k + base, ss, k0, S, D, vec);
    load_vt<DP>(Vt, v + base, ss, k0, S, D);
    __syncthreads();
    quantize_rows<DP>(stage, LDH, Ki, LDI, kdeq, ck);
    __syncthreads();

    int si[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) si[n][0] = si[n][1] = si[n][2] = si[n][3] = 0;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int8_t* kp = Ki + (n * 8 + g) * LDI + kk * 32 + t4 * 4;
        uint32_t bfrag[2] = {ld32(kp), ld32(kp + 16)};
        mma16832_s8(si[n], qf[kk], bfrag);
      }
    }

    // dequantize in the TPU kernel's order, (s32 * q_deq) * k_deq, and
    // mask the tail keys
    float s[8][4];
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + t4 * 2 + e;
        const bool valid = k0 + col < S;
        const float kd = kdeq[col];
        const float a = valid ? (static_cast<float>(si[n][e]) * qd0) * kd
                              : -INFINITY;
        const float c = valid ? (static_cast<float>(si[n][2 + e]) * qd1) * kd
                              : -INFINITY;
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

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int D, long long sb, long long ss, long long sh, float cq,
           float ck, bool vec, cudaStream_t stream) {
  const size_t smem = (size_t)BQ * (DP + 8) * sizeof(__nv_bfloat16) +
                      (size_t)DP * LDT * sizeof(__nv_bfloat16) +
                      (size_t)(BQ + BK) * (DP + 16) +
                      (size_t)(BQ + BK) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_i8_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + BQ - 1) / BQ, B * H);
  attn_i8_kernel<DP><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      H, D, sb, ss, sh, cq, ck, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 sharing the element strides (sb, ss, sh) and a unit last
// stride; o a contiguous [B, S, H, D]. cq = sm_scale * log2(e) / 127 and
// ck = 1 / 127, the dequant factors of the query and key amax. Returns a
// cudaError_t.
extern "C" int sdt_self_attention_i8_bf16(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int S, int H, int D, long long sb,
                                          long long ss, long long sh,
                                          float cq, float ck, void* stream) {
  const uintptr_t align = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const bool vec = D % 8 == 0 && align % 16 == 0 && sb % 8 == 0 &&
                   ss % 8 == 0 && sh % 8 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0) return (int)cudaErrorInvalidValue;
  if (D <= 64) return launch<64>(q, k, v, o, B, S, H, D, sb, ss, sh, cq, ck, vec, st);
  if (D <= 96) return launch<96>(q, k, v, o, B, S, H, D, sb, ss, sh, cq, ck, vec, st);
  if (D <= 128) return launch<128>(q, k, v, o, B, S, H, D, sb, ss, sh, cq, ck, vec, st);
  if (D <= 160) return launch<160>(q, k, v, o, B, S, H, D, sb, ss, sh, cq, ck, vec, st);
  if (D <= 256) return launch<256>(q, k, v, o, B, S, H, D, sb, ss, sh, cq, ck, vec, st);
  return (int)cudaErrorInvalidValue;
}
