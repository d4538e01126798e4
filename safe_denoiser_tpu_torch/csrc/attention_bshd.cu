// Self-attention softmax(Q K^T * scale) V on the natural [B, S, H, D]
// layout, output [B, S, H*D] (the same memory as [B, S, H, D]), no mask,
// S % 512 == 0 (B10): the Hopper attention core (attention_hopper.cuh)
// over contiguous strides.
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
// scratch; its [bq, H*D] tiles do not fit a block's 227 KB here. The
// core's tensor maps over (D, H, S, B) read one head's [rows, D] tile
// straight out of the interleaved rows, so a block takes one (batch row,
// head, 128 queries) and the KV axis is a loop inside the block; the
// output rows land in place in [B, S, H*D].

#include "attention_hopper.cuh"

// q, k, v contiguous [B, S, H, D] with S % 512 == 0; o contiguous
// [B, S, H*D]. The bf16 kernel needs D % 8 == 0, 16-byte aligned pointers
// and B*H <= 65535; anything else returns cudaErrorInvalidValue (the
// wrapper copies such inputs first). Returns a cudaError_t.
extern "C" int sdt_attention_bshd_bf16(const void* q, const void* k,
                                       const void* v, void* o, int B, int S,
                                       int H, int D, float sm_scale,
                                       void* stream) {
  if (S <= 0 || S % 512) return (int)cudaErrorInvalidValue;
  const long long ss = (long long)H * D;
  return sdt_attn::launch_bf16(q, k, v, o, B, S, S, H, D, S * ss, ss, D,
                               sm_scale, static_cast<cudaStream_t>(stream));
}

// The same contract for f32 q, k, v and o, any D <= 256 and alignment.
extern "C" int sdt_attention_bshd_f32(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int D, float sm_scale,
                                      void* stream) {
  if (S <= 0 || S % 512) return (int)cudaErrorInvalidValue;
  const long long ss = (long long)H * D;
  return sdt_attn::launch_f32(q, k, v, o, B, S, S, H, D, S * ss, ss, D,
                              sm_scale, static_cast<cudaStream_t>(stream));
}
