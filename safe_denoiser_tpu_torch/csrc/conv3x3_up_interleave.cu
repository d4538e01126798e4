// conv3x3_SAME(nearest_2x_upsample(h), w) + bias for NHWC bf16 h, all four
// output parities of a half-res patch from one staged band, written
// interleaved, on Hopper's warpgroup tensor-core instructions (wgmma). The
// kernel is the conv core of conv_hopper.cuh in its interleave form
// (up4_kernel: a 4 x 16 half-res patch and 64 output channels a block,
// warpgroup w the parities (w, 0) and (w, 1), 8 weight stages a 64-channel
// chunk; the design notes are there); this file is its C entry.
//
// Replaces: safe_denoiser_tpu/ops/conv3x3.py::_up_kernel (conv3x3_up with
// form="interleave", via vae.Upsample under SDT_UP_FORM=interleave): the
// VAE decoder's three upsample convs.
//
// Bound on an H100: operations, as the planar kernel (conv3x3_up.cu): each
// output parity (py, px) is a 2x2-tap conv of the half-res input with
// pre-summed weights, 2 * B*H2*W2 * Co * 4*Ci * 4 FLOP (137 GFLOP, 0.139 ms
// at 989 TFLOP/s, at [4,64,64,512]; 550 GFLOP at [4,128,128,512] and at
// [4,256,256,256]). Against B3 (one parity a block) a block reads each
// band pixel once for four parities, but N = 64 channels a wgmma instead
// of 128, so twice the block barriers per product.

#include "conv_hopper.cuh"

// h [B, H2, W2, Ci] bf16 contiguous, 16-byte aligned; wt [4, Co, 4*Ci] bf16
// (parity p = 2*py + px, K index = (2*j + k)*Ci + ci), 16-byte aligned;
// bias [Co] f32, 16-byte aligned; out [B, 2*H2, 2*W2, Co] bf16. Needs
// Ci % 32 == 0 and Co % 64 == 0. Returns a cudaError_t.
extern "C" int sdt_conv3x3_up_interleave_bf16(const void* h, const void* wt,
                                              const float* bias, void* out,
                                              int B, int H2, int W2, int Ci,
                                              int Co, void* stream) {
  using namespace sdt_conv::up4;
  if (Ci % 32 != 0 || Ci < 32 || Co % TN4 != 0 || Co < TN4 || B < 1 ||
      H2 < 1 || W2 < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (W2 + PW - 1) / PW, tiles_y = (H2 + PH - 1) / PH;
  const long long tiles = (long long)B * tiles_x * tiles_y;
  if (tiles >= (1LL << 31) || 4LL * B * H2 * W2 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  auto kernel = sdt_conv::up4_kernel<TN4>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM4_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)tiles, Co / TN4);
  kernel<<<grid, sdt_conv::NTHREADS, SMEM4_BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(wt), bias,
      static_cast<__nv_bfloat16*>(out), H2, W2, Ci, Co, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a block of sdt_conv3x3_up_interleave_bf16's
// kernel.
extern "C" int sdt_conv3x3_up_interleave_bf16_smem() {
  return sdt_conv::up4::SMEM4_BYTES;
}
