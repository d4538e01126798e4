// Self-attention softmax(Q K^T * scale) V over head-major [BH, S, D] q, k,
// v (all three contiguous, K in its natural layout, as V), keys at or past
// valid_kv masked; bf16 on the tensor cores, f32 on the CUDA cores.
//
// Replaces: safe_denoiser_tpu/ops/attention.py::_attn_kernel_nt (reached
// through _self_attention_nt <- self_attention under
// SDT_FLASH2_LAYOUT=nt), SD3's joint attention padded to [48, 4608, 64]
// with valid_kv 4429, SD-v1's [64, 4096, 40] and [64, 1024, 80].
//
// Bound on an H100: 4*BH*S*valid_kv*D operations against 4*BH*S*D*2 bytes;
// compute-bound at these shapes (SD3: 2.41e11 valid operations, 0.2437 ms
// at 989 TFLOP/s bf16 dense).
//
// Design: one block of 4 warps per (head, 64-query tile), each warp 16
// query rows (attention_tile.cuh). A head's K/V tile is one contiguous run
// of 64*D elements (D*2 = 80 / 128 / 160 bytes a row, 16-byte multiples),
// so it is staged with 16-byte cp.async copies, double-buffered: tile t+1
// loads while tile t is multiplied. V stays [key][d] in shared memory and
// ldmatrix.trans gives the P V operand, so no transpose is staged. The
// block stops at the last tile holding a valid key; the padded query rows
// are computed (they are finite) and sliced off by the caller. The output
// tile, contiguous in [BH, S, D], leaves in 16-byte stores.
// Not yet done (later work): TMA and wgmma.

#include "attention_tile.cuh"

namespace {

using sdt_tile::BQ;

template <int DP>
__global__ void __launch_bounds__(128)
attn_nt_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int S, int D, int valid_kv,
               float c_log2, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long base = (long long)blockIdx.y * S * D;
  sdt_tile::attend_block<DP>(q + base, k + base, v + base, o + base, D, S,
                             blockIdx.x * BQ, 1, D, valid_kv, c_log2, vec,
                             smem_raw);
}

// f32: one warp per query row, the head dim over the lanes (up to 8 values
// each), keys read from global memory (one head's K/V stays in L2), the
// same exp2 online softmax in full f32 on the CUDA cores.
constexpr int F32_WARPS = 4;
constexpr int F32_VPL = 8;

__global__ void __launch_bounds__(F32_WARPS * 32)
attn_nt_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int S,
                   int D, int valid_kv, float c_log2) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * F32_WARPS + warp;
  if (row >= S) return;  // the whole warp leaves together
  const long long base = (long long)blockIdx.y * S * D;
  float qv[F32_VPL], acc[F32_VPL];
#pragma unroll
  for (int i = 0; i < F32_VPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? q[base + (long long)row * D + d] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < valid_kv; ++j) {
    const float* kr = k + base + (long long)j * D;
    const float* vr = v + base + (long long)j * D;
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
  float* orow = o + base + (long long)row * D;
#pragma unroll
  for (int i = 0; i < F32_VPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) orow[d] = acc[i] * inv;
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int D, int valid_kv, float c, bool vec,
           cudaStream_t stream) {
  const size_t smem = sdt_tile::block_smem(DP, 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_nt_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + BQ - 1) / BQ, BH);
  attn_nt_kernel<DP><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      D, valid_kv, c, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o contiguous [BH, S, D]; keys valid_kv .. S-1 are masked
// (1 <= valid_kv <= S). Returns a cudaError_t.
extern "C" int sdt_attention_nt_bf16(const void* q, const void* k,
                                     const void* v, void* o, int BH, int S,
                                     int D, int valid_kv, float sm_scale,
                                     void* stream) {
  if (D <= 0 || valid_kv < 1 || valid_kv > S) return (int)cudaErrorInvalidValue;
  const float c = sm_scale * 1.4426950408889634f;  // log2(e)
  const uintptr_t align =
      (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
  const bool vec = D % 8 == 0 && align % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 48) return launch<48>(q, k, v, o, BH, S, D, valid_kv, c, vec, st);
  if (D <= 64) return launch<64>(q, k, v, o, BH, S, D, valid_kv, c, vec, st);
  if (D <= 80) return launch<80>(q, k, v, o, BH, S, D, valid_kv, c, vec, st);
  if (D <= 128) return launch<128>(q, k, v, o, BH, S, D, valid_kv, c, vec, st);
  if (D <= 160) return launch<160>(q, k, v, o, BH, S, D, valid_kv, c, vec, st);
  if (D <= 256) return launch<256>(q, k, v, o, BH, S, D, valid_kv, c, vec, st);
  return (int)cudaErrorInvalidValue;
}

// The same contract for f32 q, k, v and o.
extern "C" int sdt_attention_nt_f32(const void* q, const void* k,
                                    const void* v, void* o, int BH, int S,
                                    int D, int valid_kv, float sm_scale,
                                    void* stream) {
  if (D <= 0 || D > 32 * F32_VPL || valid_kv < 1 || valid_kv > S)
    return (int)cudaErrorInvalidValue;
  const float c = sm_scale * 1.4426950408889634f;  // log2(e)
  dim3 grid((S + F32_WARPS - 1) / F32_WARPS, BH);
  attn_nt_kernel_f32<<<grid, F32_WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, D, valid_kv,
      c);
  return (int)cudaGetLastError();
}
