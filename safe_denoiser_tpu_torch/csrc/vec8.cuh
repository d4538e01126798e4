// Vectors of 8 values (bf16, f16 or f32) read and written as 16-byte
// accesses and converted to and from f32 registers: the row kernels'
// (adaln.cu, qk_rope.cu) element types. ``E::V`` is one vector of 8 values;
// ``E::load`` widens it into 8 floats, ``E::store`` rounds 8 floats to it
// (round to nearest even; f32 unrounded).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace sdt_vec8 {

// two packed 16-bit values <-> f32
struct BF16Pair {
  static __device__ __forceinline__ void unpack(uint32_t w, float& a,
                                                float& b) {
    a = __uint_as_float(w << 16);
    b = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    uint32_t w;
    memcpy(&w, &h, 4);
    return w;
  }
};

struct F16Pair {
  static __device__ __forceinline__ void unpack(uint32_t w, float& a,
                                                float& b) {
    __half2 h;
    memcpy(&h, &w, 4);
    const float2 f = __half22float2(h);
    a = f.x;
    b = f.y;
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    __half2 h = __floats2half2_rn(a, b);
    uint32_t w;
    memcpy(&w, &h, 4);
    return w;
  }
};

// a vector of 8 16-bit values (one 16-byte access) <-> 8 f32
template <class P>
struct Half8 {
  using V = uint4;
  static __device__ __forceinline__ void load(const V& q, float* v) {
    P::unpack(q.x, v[0], v[1]);
    P::unpack(q.y, v[2], v[3]);
    P::unpack(q.z, v[4], v[5]);
    P::unpack(q.w, v[6], v[7]);
  }
  static __device__ __forceinline__ V store(const float* v) {
    return make_uint4(P::pack(v[0], v[1]), P::pack(v[2], v[3]),
                      P::pack(v[4], v[5]), P::pack(v[6], v[7]));
  }
};
struct BF16 : Half8<BF16Pair> {};
struct F16 : Half8<F16Pair> {};

// a vector of 8 f32 (two 16-byte accesses), nothing rounded
struct F32 {
  struct alignas(16) V {
    float4 a, b;
  };
  static __device__ __forceinline__ void load(const V& q, float* v) {
    v[0] = q.a.x;
    v[1] = q.a.y;
    v[2] = q.a.z;
    v[3] = q.a.w;
    v[4] = q.b.x;
    v[5] = q.b.y;
    v[6] = q.b.z;
    v[7] = q.b.w;
  }
  static __device__ __forceinline__ V store(const float* v) {
    return V{make_float4(v[0], v[1], v[2], v[3]),
             make_float4(v[4], v[5], v[6], v[7])};
  }
};

}  // namespace sdt_vec8
