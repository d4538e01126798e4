// conv3x3_SAME(nearest_2x_upsample(h), w) + bias for NHWC bf16 h, without
// materializing the upsampled tensor, on Hopper's warpgroup tensor-core
// instructions (wgmma). The kernel is the conv core of conv_hopper.cuh in
// its upsample form (UP = true: one output parity a block, four taps a
// chunk at band offsets (j + py, k + px), no prologue or residual); this
// file is its C entry.
//
// Replaces: safe_denoiser_tpu/ops/conv3x3.py::_up_kernel_planar (via
// conv3x3_up <- unet.UpsampleT, vae.Upsample): the UNet's 640-channel
// 32->64 upsample conv and the VAE decoder's three upsample convs.
//
// Bound on an H100: operations. Each output parity (py, px) is a 2x2-tap
// conv of the half-res input with pre-summed weights (4/9 of the MACs of
// the 3x3 conv on the upsampled tensor): 2 * B*H2*W2 * Co * 4*Ci * 4
// FLOP, 107 GFLOP at the UNet's [8,32,32,640] (~0.11 ms at 989 TFLOP/s)
// and 550 GFLOP at the VAE's [4,256,256,256]. All four parities run in one
// launch (grid.z) that writes standard NHWC [B, 2*H2, 2*W2, Co] -- the
// TPU's planar split and XLA de-interleave were a Mosaic workaround. The
// half-res band is read once per parity (from L2), as the TPU's planar
// kernel does.

#include "conv_hopper.cuh"

// h [B, H2, W2, Ci] bf16 contiguous, 16-byte aligned; wt [4, Co, 4*Ci] bf16
// (parity p = 2*py + px, K index = (2*j + k)*Ci + ci), 16-byte aligned;
// bias [Co] f32, 16-byte aligned; out [B, 2*H2, 2*W2, Co] bf16. Needs
// Ci % 32 == 0 and Co % 64 == 0. Returns a cudaError_t.
extern "C" int sdt_conv3x3_up_bf16(const void* h, const void* wt,
                                   const float* bias, void* out, int B,
                                   int H2, int W2, int Ci, int Co,
                                   void* stream) {
  if (Ci % 32 != 0 || Ci < 32 || Co % 64 != 0 || Co < 64 || B < 1 ||
      H2 < 1 || W2 < 1)
    return (int)cudaErrorInvalidValue;
  return sdt_conv::launch<true>(h, wt, bias, nullptr, nullptr, nullptr, out,
                                B, H2, W2, Ci, Co, 0, stream);
}

// The dynamic shared memory of a block of sdt_conv3x3_up_bf16's kernel.
extern "C" int sdt_conv3x3_up_bf16_smem() { return sdt_conv::SMEM_BYTES; }
