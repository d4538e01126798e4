// Unmasked self-attention softmax(Q K^T * scale) V over [B, S, H, D] with
// Q K^T in int8 on the tensor cores and P V in bf16 (B8): a quantize pass
// over Q and K, then the int8 form of the Hopper attention core
// (attention_hopper.cuh: TMA tensor maps, a producer warp, two wgmma
// warpgroups taking turns).
//
// Replaces: safe_denoiser_tpu/ops/attention.py::_attn_kernel(quant_i8=True)
// (SDT_INT8_ATTN=1, reached through _self_attention_bhsd <- self_attention),
// the SD3 MMDiT's joint attention at [2, 4429, 24, 64] (and the SD-v1
// UNet's at head dim 40 / 80 when the switch is on).
//
// Arithmetic, as the TPU kernel: Q is quantized per query row and K per key
// token over D, both with r = 127 / max(amax, 1e-20) in f32, round half to
// even (rintf, as jnp.round) and a clip to +-127; the head dim is
// zero-padded to a multiple of 64 (40 -> 64, 80 -> 128; zeros quantize to
// zero). Q K^T is an exact int32 sum; the logit in the exp2 domain is
// (float(s32) * q_amax * c/127) * (k_amax * 1/127) with c = sm_scale *
// log2(e); keys past S are masked to -inf; the softmax is online in f32; P
// is rounded to bf16 for P V, which accumulates in f32; the output is bf16.
// The TPU kernel quantizes K per key token, so the int8 values and factors
// do not depend on the query block: the pass quantizes each key once per
// call, where the TPU kernel redoes it in every query block.
//
// Bound on an H100: Q K^T 2*B*H*S^2*D int8 operations at 1,979 TOP/s plus
// P V 2*B*H*S^2*D bf16 at 989 TFLOP/s; at [2,4429,24,64] 0.18 ms,
// compute-bound (the inputs are 7 MB). The quantize pass moves ~41 MB there
// (Q, K in bf16 read, int8 written), ~12 us at 3.35 TB/s.
//
// Design: the quantize pass runs L = 8, 16 or 32 lanes per row (8 values a
// lane, one 16-byte load where the strides allow), the row's amax by
// shuffles, and writes int8 rows [B*H, S, NV] (NV = D padded to 64: the
// 64-byte swizzled rows the core's tensor maps read) and the f32 factors
// beside them. The core's int8 form then runs S = Q K^T on wgmma
// m64nBKk32 s8 x s8 -> s32 with both operands K-major from shared memory,
// converts s32 to f32 exactly with an integer add (no conversion unit),
// dequantizes in the TPU kernel's order and takes B1's online softmax, P V
// (V straight from the caller's tensor through B1's map) and epilogue.
// The wrapper (ops/attention.py) allocates the scratch.

#include <stdint.h>

#include "attention_hopper.cuh"

// the host side of the core's int8 form (its kernel, attn_i8_kernel, is in
// attention_hopper.cuh)
namespace sdt_attn {

// the padded head dim of the int8 tiles and the P V width: D rounded up to
// 64; the row pitch of the dequant factors: S rounded up to 4 (a 16-byte
// multiple, as a tensor map's stride must be)
inline int i8_width(int D) { return (D + 63) / 64 * 64; }
inline int i8_pitch(int S) { return (S + 3) / 4 * 4; }

template <int NV>
int launch_i8_nv(const void* qi, const void* ki, const float* deq,
                 const void* v, void* o, int B, int S, int H, int D,
                 long long sb, long long ss, long long sh,
                 cudaStream_t stream) {
  using C = CfgI8<NV>;
  const int BH = B * H, sp4 = i8_pitch(S);
  const cuuint64_t dims_i8[3] = {(cuuint64_t)NV, (cuuint64_t)S,
                                 (cuuint64_t)BH};
  const cuuint64_t str_i8[2] = {(cuuint64_t)NV, (cuuint64_t)S * NV};
  const cuuint32_t box_q[3] = {64, BQ, 1}, box_k[3] = {64, C::BK, 1};
  const cuuint64_t dims_kd[2] = {(cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t str_kd[1] = {(cuuint64_t)sp4 * 4};
  const cuuint32_t box_kd[2] = {C::BK, 1};
  alignas(64) CUtensorMap mq, mk, mv, mkd;
  if (!make_map_tiled(&mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, qi, 3, dims_i8,
                      str_i8, box_q, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map_tiled(&mk, CU_TENSOR_MAP_DATA_TYPE_UINT8, ki, 3, dims_i8,
                      str_i8, box_k, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map(&mv, v, B, S, H, D, sb, ss, sh, C::BK) ||
      !make_map_tiled(&mkd, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                      deq + (long long)BH * sp4, 2, dims_kd, str_kd, box_kd,
                      CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attn_i8_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BQ - 1) / BQ, BH);
  attn_i8_kernel<NV><<<grid, NTHREADS, C::SMEM, stream>>>(
      mq, mk, mv, mkd, deq, static_cast<__nv_bfloat16*>(o), S, H, D, sp4);
  return (int)cudaGetLastError();
}

// The int8 form over quantized qi, ki ([B*H, S, i8_width(D)] int8,
// 16-byte aligned) and deq (qdeq then kdeq, each [B*H, i8_pitch(S)] f32),
// with v under launch_bf16's contract (element strides (sb, ss, sh), unit
// last stride; D % 8 == 0, 16-byte aligned, strides multiples of 8) and o
// a contiguous [B, S, H, D]. Anything else returns cudaErrorInvalidValue.
inline int launch_i8(const void* qi, const void* ki, const float* deq,
                     const void* v, void* o, int B, int S, int H, int D,
                     long long sb, long long ss, long long sh,
                     cudaStream_t st) {
  const uintptr_t align = (uintptr_t)qi | (uintptr_t)ki | (uintptr_t)deq |
                          (uintptr_t)v | (uintptr_t)o;
  if (D <= 0 || D > 256 || D % 8 != 0 || S < 1 || B < 1 || H < 1 ||
      (long long)B * H > MAX_GRID_Y || align % 16 != 0 || sb % 8 != 0 ||
      ss % 8 != 0 || sh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  switch (i8_width(D)) {
    case 64:
      return launch_i8_nv<64>(qi, ki, deq, v, o, B, S, H, D, sb, ss, sh, st);
    case 128:
      return launch_i8_nv<128>(qi, ki, deq, v, o, B, S, H, D, sb, ss, sh, st);
    case 192:
      return launch_i8_nv<192>(qi, ki, deq, v, o, B, S, H, D, sb, ss, sh, st);
    default:
      return launch_i8_nv<256>(qi, ki, deq, v, o, B, S, H, D, sb, ss, sh, st);
  }
}

// The dynamic shared memory of a block of the int8 form at head dim D, or
// -1 if it takes no D.
inline int smem_i8(int D) {
  if (D <= 0 || D > 256) return -1;
  switch (i8_width(D)) {
    case 64: return CfgI8<64>::SMEM;
    case 128: return CfgI8<128>::SMEM;
    case 192: return CfgI8<192>::SMEM;
    default: return CfgI8<256>::SMEM;
  }
}

}  // namespace sdt_attn

namespace {

constexpr int QT = 256;  // threads a block of the quantize pass

// Quantize rows of q (blockIdx.y 0) or k (1), [B, S, H, D] with element
// strides (sb, ss, sh), into xi[which] [B*H, S, nv] int8 and deq[which]
// [B*H, sp4] f32 (amax * dscale[which]). L lanes per row, 8 columns each.
template <int L>
__global__ void __launch_bounds__(QT)
quantize_i8_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   int8_t* __restrict__ qi, int8_t* __restrict__ ki,
                   float* __restrict__ deq, int S, int H, int D, int nv,
                   int sp4, long long rows, long long sb, long long ss,
                   long long sh, float cq, float ck, int vec) {
  const int which = blockIdx.y;
  const __nv_bfloat16* x = which ? k : q;
  int8_t* xi = which ? ki : qi;
  const long long row = ((long long)blockIdx.x * QT + threadIdx.x) / L;
  const int li = threadIdx.x % L, c = li * 8;
  // rows past the end compute zeros and store nothing: every lane of a row
  // group takes part in its shuffles
  const bool valid = row < rows;
  const long long bh = valid ? row / S : 0;
  const int s = valid ? (int)(row - bh * S) : 0;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const __nv_bfloat16* src = x + b * sb + s * ss + h * sh + c;
  float v[8];
  if (valid && vec && c + 8 <= D) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = valid && c + e < D ? __bfloat162float(src[e]) : 0.f;
  }
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float r = 127.f / fmaxf(amax, 1e-20f);  // IEEE division
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float t = fminf(fmaxf(rintf(v[e] * r), -127.f), 127.f);
    packed[e / 4] |= ((uint32_t)(int)t & 0xFFu) << (8 * (e % 4));
  }
  if (valid && c < nv)
    *reinterpret_cast<uint2*>(xi + row * nv + c) =
        make_uint2(packed[0], packed[1]);
  if (valid && li == 0)
    deq[(which * (rows / S) + bh) * sp4 + s] = amax * (which ? ck : cq);
}

template <int L>
int launch_quantize(const void* q, const void* k, void* qi, void* ki,
                    float* deq, int B, int S, int H, int D, long long sb,
                    long long ss, long long sh, float cq, float ck, int vec,
                    cudaStream_t stream) {
  const long long rows = (long long)B * H * S;
  const long long blocks = (rows * L + QT - 1) / QT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  quantize_i8_kernel<L><<<dim3((unsigned)blocks, 2), QT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<int8_t*>(qi),
      static_cast<int8_t*>(ki), deq, S, H, D, sdt_attn::i8_width(D),
      sdt_attn::i8_pitch(S), rows, sb, ss, sh, cq, ck, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// The quantize pass alone: q, k bf16 [B, S, H, D] sharing the element
// strides (sb, ss, sh) and a unit last stride, any alignment, D <= 256;
// qi, ki: int8 scratch of B*H*S*NV bytes each and deq: f32 scratch of
// 2*B*H*SP floats (qdeq then kdeq), NV = D rounded up to 64 and SP = S
// rounded up to 4, all 16-byte aligned. cq = sm_scale * log2(e) / 127 and
// ck = 1 / 127, the dequant factors of the query and key amax. Returns a
// cudaError_t.
extern "C" int sdt_quantize_i8_bf16(const void* q, const void* k, void* qi,
                                    void* ki, void* deq, int B, int S, int H,
                                    int D, long long sb, long long ss,
                                    long long sh, float cq, float ck,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D > 256 || S < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)q | (uintptr_t)k;
  const int vec = D % 8 == 0 && align % 16 == 0 && sb % 8 == 0 &&
                  ss % 8 == 0 && sh % 8 == 0;
  float* fdeq = static_cast<float*>(deq);
  const int nv = sdt_attn::i8_width(D);
  if (nv == 64)
    return launch_quantize<8>(q, k, qi, ki, fdeq, B, S, H, D, sb, ss, sh, cq,
                              ck, vec, st);
  if (nv == 128)
    return launch_quantize<16>(q, k, qi, ki, fdeq, B, S, H, D, sb, ss, sh,
                               cq, ck, vec, st);
  return launch_quantize<32>(q, k, qi, ki, fdeq, B, S, H, D, sb, ss, sh, cq,
                             ck, vec, st);
}

// The core's int8 form alone on the pass's qi, ki and deq, with v
// (element strides (sb, ss, sh), unit last stride) and o a contiguous
// [B, S, H, D]; v and o need D % 8 == 0, 16-byte aligned bases and strides
// that are multiples of 8 elements. Returns a cudaError_t.
extern "C" int sdt_attention_i8_quantized_bf16(const void* qi,
                                               const void* ki,
                                               const void* deq,
                                               const void* v, void* o, int B,
                                               int S, int H, int D,
                                               long long sb, long long ss,
                                               long long sh, void* stream) {
  return sdt_attn::launch_i8(qi, ki, static_cast<const float*>(deq), v, o, B,
                             S, H, D, sb, ss, sh,
                             static_cast<cudaStream_t>(stream));
}

// Both: the pass over q and k, then the int8 form. q, k, v share the
// element strides (sb, ss, sh); the scratch and the contracts as above.
// Returns a cudaError_t.
extern "C" int sdt_self_attention_i8_bf16(
    const void* q, const void* k, const void* v, void* o, void* qi, void* ki,
    void* deq, int B, int S, int H, int D, long long sb, long long ss,
    long long sh, float cq, float ck, void* stream) {
  const int err = sdt_quantize_i8_bf16(q, k, qi, ki, deq, B, S, H, D, sb, ss,
                                       sh, cq, ck, stream);
  if (err != 0) return err;
  return sdt_attention_i8_quantized_bf16(qi, ki, deq, v, o, B, S, H, D, sb,
                                         ss, sh, stream);
}

// The dynamic shared memory of a block of the int8 form at head dim D, or
// -1 if it takes no D.
extern "C" int sdt_self_attention_i8_bf16_smem(int D) {
  return sdt_attn::smem_i8(D);
}
