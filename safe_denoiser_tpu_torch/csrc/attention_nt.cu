// Self-attention softmax(Q K^T * scale) V over head-major [BH, S, D] q, k,
// v (all three contiguous, K in its natural layout, as V), keys at or past
// valid_kv masked (B9): the Hopper attention core (attention_hopper.cuh)
// with one head per batch row (H = 1) and valid_kv as its key count.
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
// Design: [BH, S, D] is the core's (D, H, S, B) map with H = 1, B = BH and
// strides (D, D, S*D) elements; the K and V maps end at valid_kv rows, so
// TMA zero-fills the padded keys of the last tile, the core masks them to
// -inf before the max and loads no tile past valid_kv. The padded query
// rows are computed (they are finite) and sliced off by the caller. The
// output [BH, S, D] is the core's [B, S, H, D] with H = 1.

#include "attention_hopper.cuh"

// q, k, v, o contiguous [BH, S, D]; keys valid_kv .. S-1 are masked
// (1 <= valid_kv <= S). The bf16 kernel needs D % 8 == 0, 16-byte aligned
// pointers and BH <= 65535; anything else returns cudaErrorInvalidValue
// (the wrapper copies such inputs first). Returns a cudaError_t.
extern "C" int sdt_attention_nt_bf16(const void* q, const void* k,
                                     const void* v, void* o, int BH, int S,
                                     int D, int valid_kv, float sm_scale,
                                     void* stream) {
  const long long ss = D;
  return sdt_attn::launch_bf16(q, k, v, o, BH, S, valid_kv, 1, D, S * ss, ss,
                               ss, sm_scale,
                               static_cast<cudaStream_t>(stream));
}

// The same contract for f32 q, k, v and o, any D <= 256 and alignment.
extern "C" int sdt_attention_nt_f32(const void* q, const void* k,
                                    const void* v, void* o, int BH, int S,
                                    int D, int valid_kv, float sm_scale,
                                    void* stream) {
  const long long ss = D;
  return sdt_attn::launch_f32(q, k, v, o, BH, S, valid_kv, 1, D, S * ss, ss,
                              ss, sm_scale,
                              static_cast<cudaStream_t>(stream));
}
