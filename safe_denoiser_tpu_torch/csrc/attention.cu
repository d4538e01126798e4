// Unmasked self-attention softmax(Q K^T * scale) V over [B, S, H, D] views
// (B1): bf16 on the Hopper attention core (attention_hopper.cuh: TMA
// tensor maps, a producer warp, two wgmma warpgroups taking turns), f32 on
// its CUDA-core kernel, every key weighed (kv_len = S).
//
// Replaces: safe_denoiser_tpu/ops/attention.py::_attn_kernel (reached
// through _self_attention_bhsd <- self_attention), the UNet's spatial
// self-attention at head dim 40 (S=4096) and 80 (S=1024) and SD3's joint
// attention at head dim 64 (S=4429).
//
// Bound on an H100: 4*B*H*S^2*D operations against ~2*B*S*H*D*4 bytes,
// compute-bound at every main-path shape (SD3's [2,4429,24,64]: 241 GFLOP,
// 0.24 ms at 989 TFLOP/s bf16 dense).
//
// Strides: q, k, v come as the projections' views (rows 640 or 3072
// bytes apart), which the core's maps take as they are; the wrapper
// (ops/attention.py::_self_attention_cuda) copies other views first.

#include "attention_hopper.cuh"

// q, k, v share the element strides (sb, ss, sh) and a unit last stride;
// o is a contiguous [B, S, H, D]. The bf16 kernel's tensor maps need D %
// 8 == 0, 16-byte aligned pointers and strides that are multiples of 8
// elements; anything else returns cudaErrorInvalidValue (the wrapper
// copies such views first). Returns a cudaError_t.
extern "C" int sdt_self_attention_bf16(const void* q, const void* k,
                                       const void* v, void* o, int B, int S,
                                       int H, int D, long long sb,
                                       long long ss, long long sh,
                                       float sm_scale, void* stream) {
  return sdt_attn::launch_bf16(q, k, v, o, B, S, S, H, D, sb, ss, sh,
                               sm_scale, static_cast<cudaStream_t>(stream));
}

// The bf16 entry under autograd (ops/attention.py::SelfAttention): the same
// output bit for bit, and each row's logsumexp in the exp2 domain written
// to lse, f32 [B*H, lse_pitch] (lse_pitch >= S, a multiple of 4), which the
// backward (attention_bwd.cu) reads. D <= 128.
extern "C" int sdt_self_attention_lse_bf16(const void* q, const void* k,
                                           const void* v, void* o, float* lse,
                                           int B, int S, int H, int D,
                                           long long sb, long long ss,
                                           long long sh, float sm_scale,
                                           int lse_pitch, void* stream) {
  return sdt_attn::launch_bf16_lse(q, k, v, o, lse, B, S, H, D, sb, ss, sh,
                                   sm_scale, lse_pitch,
                                   static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of a block of the bf16 kernel at head dim D
// (the template sdt_self_attention_bf16 launches), or -1 if it takes no D.
extern "C" int sdt_self_attention_bf16_smem(int D) {
  return sdt_attn::smem_bf16(D);
}

// The same contract for f32 q, k, v and o (any strides).
extern "C" int sdt_self_attention_f32(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int D, long long sb,
                                      long long ss, long long sh,
                                      float sm_scale, void* stream) {
  return sdt_attn::launch_f32(q, k, v, o, B, S, S, H, D, sb, ss, sh,
                              sm_scale, static_cast<cudaStream_t>(stream));
}
