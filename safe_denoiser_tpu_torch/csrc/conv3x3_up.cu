// conv3x3_SAME(nearest_2x_upsample(h), w) + bias for NHWC bf16 h, without
// materializing the upsampled tensor.
//
// Replaces: safe_denoiser_tpu/ops/conv3x3.py::_up_kernel_planar (via
// conv3x3_up <- unet.UpsampleT, vae.Upsample): the UNet's 640-channel
// 32->64 upsample conv and the VAE decoder's three upsample convs.
//
// Bound on an H100: operations. Each output parity (py, px) is a 2x2-tap
// conv of the half-res input with pre-summed weights (4/9 of the MACs of
// the 3x3 conv on the upsampled tensor): 2 * B*H2*W2 * Co * 4*Ci * 4
// FLOP, 107 GFLOP at the UNet's [8,32,32,640] (~0.11 ms at 989 TFLOP/s)
// and 550 GFLOP at the VAE's [4,256,256,256].
//
// Design: an implicit GEMM per parity, M = B*H2*W2 output pixels, N = Co,
// K = 4*Ci (the four taps), all four parities in one launch (grid.z) that
// writes standard NHWC [B, 2*H2, 2*W2, Co] -- the TPU's planar split and
// XLA de-interleave were a Mosaic workaround. Block tile 64x64, K step 32,
// 4 warps of 32x32, tensor cores through mma.sync m16n8k16 (bf16 in, f32
// accumulate). A tiles are gathered im2col-style with zeros outside the
// image (the SAME padding); Ci % 32 == 0 keeps each K step inside one tap
// so every gather is one 16-byte row piece. Weights arrive as
// [4 parities, Co, 4*Ci] so B tiles load K-contiguous. Bias in the f32
// epilogue, bf16 out. Not yet done (later work): multi-stage cp.async /
// TMA pipelining and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64, TN = 64, TK = 32, NTHREADS = 128;
constexpr int LDS = TK + 8;  // smem row pitch (bf16), conflict-free frags

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(NTHREADS)
up_conv_kernel(const __nv_bfloat16* __restrict__ h,
               const __nv_bfloat16* __restrict__ wt,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
               int B, int H2, int W2, int Ci, int Co) {
  __shared__ __align__(16) __nv_bfloat16 As[TM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[TN * LDS];

  const int parity = blockIdx.z;
  const int py = parity >> 1, px = parity & 1;
  const int M = B * H2 * W2;
  const int K = 4 * Ci;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const __nv_bfloat16* wp = wt + (size_t)parity * Co * K;

  // each thread gathers two 8-element row pieces of A and of B per K step
  int a_row[2], a_col[2], a_b[2], a_r[2], a_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;  // 0..255
    a_row[i] = idx / (TK / 8);
    a_col[i] = (idx % (TK / 8)) * 8;
    const int mrow = m0 + a_row[i];
    a_b[i] = mrow < M ? mrow / (H2 * W2) : -1;
    const int rem = mrow % (H2 * W2);
    a_r[i] = rem / W2;
    a_m[i] = rem % W2;
  }

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int k0 = 0; k0 < K; k0 += TK) {
    const int tap = k0 / Ci, ci0 = k0 % Ci;
    const int dy = (tap >> 1) - 1 + py, dx = (tap & 1) - 1 + px;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int hy = a_r[i] + dy, hx = a_m[i] + dx;
      uint4 val = zero4;
      if (a_b[i] >= 0 && hy >= 0 && hy < H2 && hx >= 0 && hx < W2) {
        val = *reinterpret_cast<const uint4*>(
            h + (((size_t)a_b[i] * H2 + hy) * W2 + hx) * Ci + ci0 + a_col[i]);
      }
      *reinterpret_cast<uint4*>(As + a_row[i] * LDS + a_col[i]) = val;
      // B: row n (output channel), K-contiguous
      *reinterpret_cast<uint4*>(Bs + a_row[i] * LDS + a_col[i]) =
          *reinterpret_cast<const uint4*>(
              wp + (size_t)(n0 + a_row[i]) * K + k0 + a_col[i]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* p = As + (wm + i * 16 + g) * LDS + kk + t4 * 2;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * LDS);
        af[i][2] = ld32(p + 8);
        af[i][3] = ld32(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = Bs + (wn + j * 8 + g) * LDS + kk + t4 * 2;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // epilogue: + bias, bf16, scatter to out[b, 2r+py, 2m+px, :]
  const int W = 2 * W2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int mrow = m0 + wm + i * 16 + g + half * 8;
      if (mrow >= M) continue;
      const int b = mrow / (H2 * W2), rem = mrow % (H2 * W2);
      const int y = 2 * (rem / W2) + py, x = 2 * (rem % W2) + px;
      __nv_bfloat16* op = out + (((size_t)b * (2 * H2) + y) * W + x) * Co;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + t4 * 2;
        const float v0 = acc[i][j][half * 2] + bias[n];
        const float v1 = acc[i][j][half * 2 + 1] + bias[n + 1];
        *reinterpret_cast<__nv_bfloat162*>(op + n) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// h [B, H2, W2, Ci] bf16 contiguous, 16-byte aligned; wt [4, Co, 4*Ci] bf16
// (parity p = 2*py + px, K index = (2*j + k)*Ci + ci); bias [Co] f32;
// out [B, 2*H2, 2*W2, Co] bf16. Needs Ci % 32 == 0 and Co % 64 == 0.
// Returns a cudaError_t.
extern "C" int sdt_conv3x3_up_bf16(const void* h, const void* wt,
                                   const float* bias, void* out, int B,
                                   int H2, int W2, int Ci, int Co,
                                   void* stream) {
  if (Ci % TK != 0 || Co % TN != 0 || B < 1 || H2 < 1 || W2 < 1)
    return (int)cudaErrorInvalidValue;
  const int M = B * H2 * W2;
  dim3 grid((M + TM - 1) / TM, Co / TN, 4);
  up_conv_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(wt), bias,
      static_cast<__nv_bfloat16*>(out), B, H2, W2, Ci, Co);
  return (int)cudaGetLastError();
}
