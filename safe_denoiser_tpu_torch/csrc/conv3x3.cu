// out = residual + conv3x3_SAME(act(x * a + b), w) + bias for NHWC bf16 x:
// the VAE resnets' GroupNorm-affine + SiLU prologue and residual epilogue
// fused around one 3x3 conv, on Hopper's warpgroup tensor-core
// instructions (wgmma). The kernel is the conv core of conv_hopper.cuh
// (its nine-tap form, which holds the design notes); this file is its C
// entry.
//
// Replaces: safe_denoiser_tpu/ops/conv3x3.py::_kernel (via conv3x3 <-
// vae.Conv3x3 <- vae.ResnetBlock): the VAE encoder's and decoder's resnet
// convs, Ci/Co in {128, 256, 512}, H = W in 64..1024.
//
// Bound on an H100: operations, 2 * B*H*W * 9*Ci * Co FLOP at 989 TFLOP/s
// bf16 (309 GFLOP, ~0.31 ms, at the decoder's [4,512,512,128] -> 128); the
// bytes (x, residual and output once each) take a quarter of that or less.

#include "conv_hopper.cuh"

// x [B, H, W, Ci] bf16 contiguous, 16-byte aligned; wt [Co, 9*Ci] bf16
// (K index = (3*dy + dx)*Ci + ci); bias [Co] f32, 16-byte aligned; pre_a,
// pre_b [B, Ci] bf16 or both null; res [B, H, W, Co] bf16 or null; out
// [B, H, W, Co] bf16; silu 0 or 1. Needs Ci % 32 == 0 and Co % 128 == 0.
// Returns a cudaError_t.
extern "C" int sdt_conv3x3_bf16(const void* x, const void* wt,
                                const float* bias, const void* pre_a,
                                const void* pre_b, const void* res, void* out,
                                int B, int H, int W, int Ci, int Co, int silu,
                                void* stream) {
  if (Ci % 32 != 0 || Ci < 32 || Co % sdt_conv::TN != 0 || B < 1 || H < 1 ||
      W < 1 || (pre_a == nullptr) != (pre_b == nullptr))
    return (int)cudaErrorInvalidValue;
  return sdt_conv::launch<false>(x, wt, bias, pre_a, pre_b, res, out, B, H, W,
                                 Ci, Co, silu, stream);
}

// The dynamic shared memory of a block of sdt_conv3x3_bf16's kernel.
extern "C" int sdt_conv3x3_bf16_smem() { return sdt_conv::SMEM_BYTES; }
