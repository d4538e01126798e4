// Device helpers of the attention kernels: the bf16 mma.sync wrappers
// (attention.cu and attention_i8.cu use them too) and, for the layout
// kernels (attention_nt.cu, attention_bshd.cu), the ldmatrix and cp.async
// staging of 64-row tiles, the exp2 online softmax of one warp's 16 query
// rows over a 64-key tile, and the block-level loop that double-buffers the
// K/V tiles.
//
// A block handles one 64-query tile of `hg` heads that sit side by side in
// each row (head hh at column hh*D), rows `row_stride` elements apart:
// head-major [BH, S, D] is hg = 1 with row_stride = D, natural [B, S, H, D]
// is a group of hg heads with row_stride = H*D. Each K/V row's hg*D run is
// staged once and shared by the hg heads. 4*hg warps: warp w owns 16 query
// rows (w % 4) of head w / 4. In shared memory each head's slice is padded
// with zeros from D to DP (a multiple of 16, the mma depth) and each row by
// 8 more elements, so the 32-bit fragment loads and the ldmatrix rows of 8
// consecutive rows fall in distinct banks.
//
// Numerics as the TPU kernels: Q K^T and P V on the tensor cores
// (m16n8k16, bf16 in, f32 accumulate), sm_scale*log2(e) folded into one
// multiply, exp2, f32 running max / sum / accumulator, one reciprocal at
// the end, P rounded to bf16 for the second product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sdt_tile {

constexpr int BQ = 64;  // query rows per block (16 per warp of a head)
constexpr int BK = 64;  // keys per tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 32 bits (two bf16, or four int8) from a 4-byte aligned address
__device__ __forceinline__ uint32_t ld32(const void* p) {
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

// Four 8x8 bf16 matrices, transposed, from shared memory: lane l gives the
// address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const __nv_bfloat16* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared, asynchronous; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [0, 64) of a tile: hg head slices of D elements per row into
// dst[r * ld + hh * DP + c]; rows at or past `nrows` become zeros. With
// `vec` (D % 8 == 0, 16-byte aligned base and stride) 16-byte cp.async
// copies, consecutive threads on consecutive chunks of a row; otherwise
// 2-byte loads and stores.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int nrows,
                                          int hg, int D, bool vec) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (vec) {
    const int cpr = D / 8, per_row = hg * cpr;
    for (int i = tid; i < BK * per_row; i += nt) {
      const int r = i / per_row, rem = i - r * per_row;
      const int hh = rem / cpr, c = (rem - hh * cpr) * 8;
      const bool ok = r < nrows;
      cp_async16(dst + r * ld + hh * DP + c,
                 ok ? src + r * row_stride + hh * D + c : src, ok ? 16 : 0);
    }
  } else {
    const int per_row = hg * D;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < BK * per_row; i += nt) {
      const int r = i / per_row, rem = i - r * per_row;
      const int hh = rem / D, c = rem - hh * D;
      dst[r * ld + hh * DP + c] =
          r < nrows ? src[r * row_stride + hh * D + c] : zero;
    }
  }
}

// One warp's 16 query rows (fragments qf) against one 64-key tile of its
// head (Ks / Vs at the head's column, row pitch ld); keys at or past
// `nvalid` within the tile are masked to -inf.
template <int DP>
__device__ __forceinline__ void attend_tile(
    const uint32_t (&qf)[DP / 16][4], const __nv_bfloat16* Ks,
    const __nv_bfloat16* Vs, int ld, int nvalid, float c_log2, float& m0,
    float& m1, float& l0, float& l1, float (&acc)[DP / 8][4]) {
  constexpr int KSTEPS = DP / 16, NT = DP / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* kp = Ks + (n * 8 + g) * ld + kk * 16 + t4 * 2;
      uint32_t bfrag[2] = {ld32(kp), ld32(kp + 8)};
      mma16816(s[n], qf[kk], bfrag);
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool valid = n * 8 + t4 * 2 + e < nvalid;
      const float a = valid ? s[n][e] * c_log2 : -INFINITY;
      const float c = valid ? s[n][2 + e] * c_log2 : -INFINITY;
      s[n][e] = a;
      s[n][2 + e] = c;
      mx0 = fmaxf(mx0, a);
      mx1 = fmaxf(mx1, c);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // every tile holds at least one valid key (the caller stops at valid_kv),
  // so the running max is finite from the first tile on
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  l0 *= al0;
  l1 *= al1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = exp2f(s[n][0] - mn0);
    s[n][1] = exp2f(s[n][1] - mn0);
    s[n][2] = exp2f(s[n][2] - mn1);
    s[n][3] = exp2f(s[n][3] - mn1);
    l0 += s[n][0] + s[n][1];
    l1 += s[n][2] + s[n][3];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] *= al0;
    acc[j][1] *= al0;
    acc[j][2] *= al1;
    acc[j][3] *= al1;
  }
  // P (16 x 64) @ V (64 x DP): two adjacent S n-tiles are one A fragment;
  // V stays [key][d] in shared memory and ldmatrix.trans hands each lane
  // the (key pair, d) entries of the B fragment, two d-tiles per call
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t afrag[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                         pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                         pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                         pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    const __nv_bfloat16* vrow = Vs + (kk * 16 + (lane & 15)) * ld;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, vrow + (j + (lane >> 4)) * 8);
      mma16816(acc[j], afrag, r);
      mma16816(acc[j + 1], afrag, r + 2);
    }
  }
}

// Shared memory of attend_block: the Q tile (reused to stage the output)
// and two stages of K and V tiles.
__host__ __device__ constexpr size_t block_smem(int DP, int hg) {
  return (size_t)5 * BK * (hg * DP + 8) * sizeof(__nv_bfloat16);
}

// The block loop. q, k, v, o point at row 0, head 0 of this block's batch
// row and head group; o has the inputs' layout. Keys run to valid_kv (<= S;
// the rest are zero padding and never weighed), query rows q0 .. q0+63 up
// to S. The block's output tile is staged in shared memory and written as
// whole rows of hg*D elements.
template <int DP>
__device__ __forceinline__ void attend_block(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    long long row_stride, int S, int q0, int hg, int D, int valid_kv,
    float c_log2, bool vec, unsigned char* smem_raw) {
  constexpr int KSTEPS = DP / 16, NT = DP / 8;
  const int ld = hg * DP + 8;
  const int tile = BK * ld;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks[2] = {Qs + tile, Qs + 3 * tile};
  __nv_bfloat16* Vs[2] = {Qs + 2 * tile, Qs + 4 * tile};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int hh = warp / 4, r16 = (warp % 4) * 16;

  // zero the pad columns D .. DP-1 of every head slice of the five tiles;
  // the copies never write them and Q K^T sums over them
  if (D < DP) {
    const int padw = DP - D, per_row = hg * padw;
    for (int i = threadIdx.x; i < 5 * BK * per_row; i += blockDim.x) {
      const int r = i / per_row, rem = i - r * per_row;
      const int h = rem / padw, c = D + rem - h * padw;
      Qs[r * ld + h * DP + c] = __float2bfloat16(0.f);
    }
  }
  load_tile<DP>(Qs, ld, q + q0 * row_stride, row_stride, S - q0, hg, D, vec);
  load_tile<DP>(Ks[0], ld, k, row_stride, S, hg, D, vec);
  load_tile<DP>(Vs[0], ld, v, row_stride, S, hg, D, vec);
  cp_async_commit();

  uint32_t qf[KSTEPS][4];
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int n_tiles = (valid_kv + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int k0 = (t + 1) * BK, b = (t + 1) & 1;
      load_tile<DP>(Ks[b], ld, k + k0 * row_stride, row_stride, S - k0, hg,
                    D, vec);
      load_tile<DP>(Vs[b], ld, v + k0 * row_stride, row_stride, S - k0, hg,
                    D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      const __nv_bfloat16* r0 = Qs + (r16 + g) * ld + hh * DP + t4 * 2;
      const __nv_bfloat16* r1 = r0 + 8 * ld;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        qf[kk][0] = ld32(r0 + kk * 16);
        qf[kk][1] = ld32(r1 + kk * 16);
        qf[kk][2] = ld32(r0 + kk * 16 + 8);
        qf[kk][3] = ld32(r1 + kk * 16 + 8);
      }
    }
    attend_tile<DP>(qf, Ks[t & 1] + hh * DP, Vs[t & 1] + hh * DP, ld,
                    valid_kv - t * BK, c_log2, m0, m1, l0, l1, acc);
    __syncthreads();  // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  // normalized bf16 output into the Q tile's place, then whole rows out
  __nv_bfloat16* st0 = Qs + (r16 + g) * ld + hh * DP;
  __nv_bfloat16* st1 = st0 + 8 * ld;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int d = j * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(st0 + d) =
        pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(st1 + d) =
        pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  __syncthreads();
  const int rows = min(BQ, S - q0);
  __nv_bfloat16* out = o + q0 * row_stride;
  if (vec) {
    const int cpr = D / 8, per_row = hg * cpr;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row, rem = i - r * per_row;
      const int h = rem / cpr, c = (rem - h * cpr) * 8;
      *reinterpret_cast<uint4*>(out + r * row_stride + h * D + c) =
          *reinterpret_cast<const uint4*>(Qs + r * ld + h * DP + c);
    }
  } else {
    const int per_row = hg * D;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row, rem = i - r * per_row;
      const int h = rem / D, c = rem - h * D;
      out[r * row_stride + h * D + c] = Qs[r * ld + h * DP + c];
    }
  }
}

}  // namespace sdt_tile
