// Self-attention softmax(Q K^T * scale) V on the natural [B, S, H, D]
// layout, output [B, S, H*D] (the same memory as [B, S, H, D]), no mask,
// S % 512 == 0; bf16 on the tensor cores, f32 on the CUDA cores.
//
// Replaces: safe_denoiser_tpu/ops/attention.py::_attn_kernel_bshd (reached
// through _self_attention_bshd <- self_attention under
// SDT_FLASH2_LAYOUT=bshd), SD-v1's [8, 4096, 8, 40] and [8, 1024, 8, 80].
//
// Bound on an H100: as B1 at the same shapes, 4*B*H*S^2*D operations
// against 4*B*S*H*D*2 bytes, compute-bound (0.1737 ms at [8,4096,8,40],
// 0.0217 ms at [8,1024,8,80], 989 TFLOP/s bf16 dense).
//
// Design: the TPU kernel takes all H heads of a query block at once and
// walks KV through a sequential grid axis, carrying m / l / acc in VMEM
// scratch. Its sizes do not fit here: at H=8, D=80 an f32 accumulator for
// [64, H*D] is 160 KB and the bf16 K+V tile [64, 640] another 160 KB. The
// split: one block per (batch row, 64-query tile, group of hg heads), hg
// the largest divisor of H up to 4 whose tiles fit (4 at D <= 80, so SD-v1's
// 8 heads take two groups); 4 warps per head, each 16 query rows, with its
// m / l / accumulator in registers; the KV axis is a loop inside the block.
// Each K/V tile is the contiguous hg*D run of 64 key rows, staged once by
// 16-byte cp.async copies (double-buffered) and shared by the group's
// heads; the output tile is staged in shared memory and leaves as whole
// hg*D row runs in 16-byte stores (attention_tile.cuh). Shared memory per
// block: 5 tiles of 64 x (hg*DP + 8) bf16, 210 KB at D=80 (DP 80, hg 4),
// 128 KB at D=40 (DP 48), above 48 KB only after cudaFuncSetAttribute.
// Not yet done (later work): TMA and wgmma.

#include "attention_tile.cuh"

namespace {

using sdt_tile::BQ;

constexpr size_t SMEM_MAX = 232448;  // 227 KB a block on Hopper

template <int DP, int MAXT>
__global__ void __launch_bounds__(MAXT)
attn_bshd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int S, int H, int D, int hg,
                 float c_log2, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int groups = H / hg;
  const int b = blockIdx.y / groups, grp = blockIdx.y % groups;
  const long long base = (long long)b * S * H * D + (long long)grp * hg * D;
  sdt_tile::attend_block<DP>(q + base, k + base, v + base, o + base,
                             (long long)H * D, S, blockIdx.x * BQ, hg, D, S,
                             c_log2, vec, smem_raw);
}

// f32: one warp per query row, walking all H heads of the row in turn
// (the row's output is one contiguous H*D run); the head dim over the
// lanes (up to 8 values each), keys from global memory, the same exp2
// online softmax in full f32 on the CUDA cores.
constexpr int F32_WARPS = 4;
constexpr int F32_VPL = 8;

__global__ void __launch_bounds__(F32_WARPS * 32)
attn_bshd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int S, int H, int D, float c_log2) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * F32_WARPS + warp;
  if (row >= S) return;  // the whole warp leaves together
  const long long hd = (long long)H * D;
  const long long base = (long long)blockIdx.y * S * hd;
  for (int h = 0; h < H; ++h) {
    const long long col = (long long)h * D;
    float qv[F32_VPL], acc[F32_VPL];
#pragma unroll
    for (int i = 0; i < F32_VPL; ++i) {
      const int d = lane + 32 * i;
      qv[i] = d < D ? q[base + row * hd + col + d] : 0.f;
      acc[i] = 0.f;
    }
    float m = -INFINITY, l = 0.f;
    for (int j = 0; j < S; ++j) {
      const float* kr = k + base + j * hd + col;
      const float* vr = v + base + j * hd + col;
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
    float* orow = o + base + row * hd + col;
#pragma unroll
    for (int i = 0; i < F32_VPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = acc[i] * inv;
    }
  }
}

// the head group: the largest divisor of H up to hg_max whose tiles fit
int head_group(int H, int DP, int hg_max) {
  for (int hg = hg_max; hg > 1; --hg)
    if (H % hg == 0 && sdt_tile::block_smem(DP, hg) <= SMEM_MAX) return hg;
  return 1;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int D, float c, bool vec, cudaStream_t stream) {
  // up to 16 warps (4 heads) at DP <= 80, where 128 registers a thread
  // hold the fragments; one head (4 warps) for the wider heads
  constexpr int MAXT = DP <= 80 ? 512 : 128;
  const int hg = head_group(H, DP, MAXT / 128);
  const size_t smem = sdt_tile::block_smem(DP, hg);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_bshd_kernel<DP, MAXT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(S / BQ, B * (H / hg));
  attn_bshd_kernel<DP, MAXT><<<grid, 128 * hg, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      H, D, hg, c, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v contiguous [B, S, H, D] with S % 512 == 0; o contiguous
// [B, S, H*D]. Returns a cudaError_t.
extern "C" int sdt_attention_bshd_bf16(const void* q, const void* k,
                                       const void* v, void* o, int B, int S,
                                       int H, int D, float sm_scale,
                                       void* stream) {
  if (D <= 0 || H <= 0 || S <= 0 || S % 512) return (int)cudaErrorInvalidValue;
  const float c = sm_scale * 1.4426950408889634f;  // log2(e)
  const uintptr_t align =
      (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
  const bool vec = D % 8 == 0 && align % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 48) return launch<48>(q, k, v, o, B, S, H, D, c, vec, st);
  if (D <= 64) return launch<64>(q, k, v, o, B, S, H, D, c, vec, st);
  if (D <= 80) return launch<80>(q, k, v, o, B, S, H, D, c, vec, st);
  if (D <= 128) return launch<128>(q, k, v, o, B, S, H, D, c, vec, st);
  if (D <= 160) return launch<160>(q, k, v, o, B, S, H, D, c, vec, st);
  if (D <= 256) return launch<256>(q, k, v, o, B, S, H, D, c, vec, st);
  return (int)cudaErrorInvalidValue;
}

// The same contract for f32 q, k, v and o.
extern "C" int sdt_attention_bshd_f32(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int D, float sm_scale,
                                      void* stream) {
  if (D <= 0 || D > 32 * F32_VPL || H <= 0 || S <= 0 || S % 512)
    return (int)cudaErrorInvalidValue;
  const float c = sm_scale * 1.4426950408889634f;  // log2(e)
  dim3 grid((S + F32_WARPS - 1) / F32_WARPS, B);
  attn_bshd_kernel_f32<<<grid, F32_WARPS * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, D, c);
  return (int)cudaGetLastError();
}
