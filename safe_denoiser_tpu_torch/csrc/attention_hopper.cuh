// The Hopper attention core: softmax(Q K^T * scale) V for bf16 q, k, v on
// the warpgroup tensor-core instructions (wgmma) fed by the Tensor Memory
// Accelerator (TMA), and the CUDA-core kernel for f32. Four entry points
// share it: B1 (attention.cu, [B, S, H, D] views), B9 (attention_nt.cu,
// head-major [BH, S, D] as H = 1, keys past valid_kv masked), B10
// (attention_bshd.cu, contiguous [B, S, H, D]) and, in an int8-QK^T form
// of the bf16 kernel (attn_i8_kernel, below the bf16 one), B8
// (attention_i8.cu).
//
// Queries and keys: S query rows, kv_len <= S key rows; keys at or past
// kv_len get no weight (B1 and B10 pass kv_len = S).
//
// Bound on an H100: 4*B*H*S*kv_len*D operations against ~2*B*S*H*D*4
// bytes, so every main-path shape is compute-bound (SD3's [2,4429,24,64]
// is 241 GFLOP, 0.24 ms at 989 TFLOP/s bf16 dense). Only wgmma reaches
// that rate; at D = 40..64 the softmax (an exp2 and a bf16 conversion per
// logit on the 16-a-clock special-function units) comes close to it too,
// so the softmax has to run while the tensor cores work.
//
// Design: one block per (b*h, 128 query rows), one block a SM: two
// consumer warpgroups (warpgroup w owns query rows 64w..64w+63 and keeps
// its own running max, sum and output accumulator in registers) and one
// producer warp.
//   Loads: one producer thread issues TMA copies through three 4-D tensor
//   maps over q, k, v as (D, H, rows, B) with the caller's strides (q over
//   S rows, k and v over kv_len): Q's tile once, then K and V tiles of BK
//   keys (128 at D <= 64, 64 for wider heads, whose accumulators leave no
//   room) into a ring of NS stages (4, or 3 / 2 for D > 128) behind
//   full/empty mbarriers. A box is 64 head-dim columns wide, written in the
//   128-byte swizzle wgmma reads (hopper.cuh); the map's bounds zero-fill
//   the columns past D (D = 40 and the second block of D = 80) and the
//   rows past S or kv_len, and keep a tile out of the next head's or
//   batch's memory.
//   S = Q K^T: wgmma m64nBKk16 with Q and K both K-major from shared
//   memory, D/16 steps (D = 40 is padded to 48, D = 80 runs 5 steps).
//   O += P V: P rounded to bf16 in registers (the S accumulator of two
//   8-key column blocks is the A-fragment of one 16-key step), then wgmma
//   with A from registers and V as the B operand MN-major from shared
//   memory (transpose bit set), so V is never transposed element by
//   element. The P V width is D rounded up to a whole 64-column block
//   (40 -> 64, 80 -> 128); V's zero-filled columns give outputs that are
//   dropped.
//   Overlap: in tile t a warpgroup issues S_t and P_{t-1} V_{t-1}
//   together, runs the softmax of S_t while P V is in flight, then
//   rescales O and releases tile t-1's stage to the producer. The two
//   warpgroups take turns at issuing (named barriers, FA3's ping-pong), so
//   one's softmax overlaps the other's products.
//   Softmax: as the TPU kernels, online in the exp2 domain with
//   sm_scale*log2(e) folded into one multiply, f32 running max / sum /
//   accumulator; keys at or past kv_len in the last tile are masked to
//   -inf before the max (the valid_kv tail mask), so a zero-filled key
//   gets no weight; whole tiles take a branch without the compare.
//   Output: one reciprocal of the sum per row, rows staged in the
//   warpgroup's own Q rows, then 16-byte stores; rows past S are not
//   stored.
// Strides: a tensor map needs a 16-byte aligned base and strides that are
// multiples of 16 bytes (every main-path q/k/v). The wrappers
// (ops/attention.py) copy other inputs (rows padded to D+4, D % 8 != 0,
// unaligned bases) into contiguous tensors first and count those copies.
// The map is built on the host by cuTensorMapEncodeTiled, looked up at
// run time through the CUDA runtime (no libcuda link; see hopper.cuh), and
// passed as a __grid_constant__ kernel parameter.
// Registers: 167 a thread at D <= 64 (BK = 128: a 64-float S tile, the
// 32-float output, P as 32 packed registers), of the 168 that 288 threads
// a block leave; D = 160 and 256 spill (ptxas in PERF.md), off the main
// path. Not done: a producer warpgroup with setmaxnreg for the wide
// heads, persistent blocks, FA3's intra-warpgroup softmax split.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace sdt_attn {

using namespace sdt_hopper;

constexpr int BQ = 128;  // query rows per block, 64 per consumer warpgroup
constexpr int NCONSUMER = 256;
constexpr int NTHREADS = NCONSUMER + 32;  // + the producer warp
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may take
constexpr int MAX_GRID_Y = 65535;   // blocks along gridDim.y (b*h)
// named barriers: each consumer warpgroup's turn to issue (1, 2), its
// epilogue (3, 4)
constexpr int BAR_TURN = 1, BAR_EPI = 3;

// DP: D rounded up to 16, the depth of Q K^T
template <int DP>
struct Cfg {
  static constexpr int NB = (DP + 63) / 64;  // 64-column blocks per row
  static constexpr int NV = NB * 64;         // width of P V
  static constexpr int KSTEPS = DP / 16;
  // keys per tile: 128 where the accumulators leave room (P V width 64),
  // else 64
  static constexpr int BK = NV == 64 ? 128 : 64;
  static constexpr int Q_BYTES = NB * BQ * 128;
  static constexpr int KV_BYTES = NB * BK * 128;  // one K or V tile
  // four K/V stages where they fit, else three or two
  static constexpr int NS = Q_BYTES + 4 * 2 * KV_BYTES + 1024 <= SMEM_LIMIT
                                ? 4
                            : Q_BYTES + 3 * 2 * KV_BYTES + 1024 <= SMEM_LIMIT
                                ? 3
                                : 2;
  static constexpr int SMEM = Q_BYTES + NS * 2 * KV_BYTES + 1024;  // + align
  static_assert(SMEM <= SMEM_LIMIT,
                "the attention tiles exceed a block's shared memory");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x; flushes results below 2^-126 to zero (they add nothing to an f32
// sum of terms up to 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one 16-deep step of S = Q K^T over a tile of 32 (the backward's query
// tiles at D > 64), 64 or 128 keys
__device__ __forceinline__ void qk_step(float (&s)[16], uint64_t da,
                                        uint64_t db, int scale_d) {
  wgmma_ss_m64n32k16(s, da, db, scale_d);
}

__device__ __forceinline__ void qk_step(float (&s)[32], uint64_t da,
                                        uint64_t db, int scale_d) {
  wgmma_ss_m64n64k16(s, da, db, scale_d);
}

__device__ __forceinline__ void qk_step(float (&s)[64], uint64_t da,
                                        uint64_t db, int scale_d) {
  wgmma_ss_m64n128k16(s, da, db, scale_d);
}

// S = Q K^T for a warpgroup's 64 query rows (Q tile at qrows) and one tile
// of BK keys (K tile at kst): KSTEPS wgmma, 16 values of D each
template <int DP, int BK = Cfg<DP>::BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t qrows,
                                         uint32_t kst) {
#pragma unroll
  for (int kk = 0; kk < Cfg<DP>::KSTEPS; ++kk) {
    const uint32_t koff = (kk & 3) * 32;  // 16 values along D
    const uint64_t da =
        desc_sw128(qrows + (kk >> 2) * BQ * 128 + koff, 16, 1024);
    const uint64_t db = desc_sw128(kst + (kk >> 2) * BK * 128 + koff, 16, 1024);
    qk_step(s, da, db, kk > 0 ? 1 : 0);
  }
}

// O += P V for a warpgroup: four 16-key steps; V (tile at vst) is the
// MN-major B operand: key rows 128 bytes apart, 8-key groups 1024 bytes,
// 64-column blocks BK * 128 bytes
template <int NV, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[NV / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vst) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = desc_sw128(vst + kk * 16 * 128, BK * 128, 1024);
    if constexpr (NV == 64) wgmma_rs_m64n64k16<1>(acc, pa[kk], dv, 1);
    if constexpr (NV == 128) wgmma_rs_m64n128k16<1>(acc, pa[kk], dv, 1);
    if constexpr (NV == 192) wgmma_rs_m64n192k16<1>(acc, pa[kk], dv, 1);
    if constexpr (NV == 256) wgmma_rs_m64n256k16<1>(acc, pa[kk], dv, 1);
  }
}

// The online softmax of one tile for a thread's two rows (g and g + 8):
// s[4n + e] holds row g (e < 2) or g + 8, key k0 + 8n + 2*t4 + (e & 1).
// Scales by c (sm_scale * log2 e; SCALE false: s is in the exp2 domain
// already and c is not read), masks keys at or past kv_len to -inf,
// updates the running max m and sum l, and leaves 2^(s - m) in s; returns
// each row's factor for the accumulator in al.
template <int BK, bool SCALE = true>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], int k0,
                                               int kv_len, float c, int t4,
                                               float& m0, float& m1,
                                               float& l0, float& l1,
                                               float& al0, float& al1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
  if (k0 + BK <= kv_len) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (SCALE) {
          s[4 * n + e] *= c;
          s[4 * n + 2 + e] *= c;
        }
        mx0 = fmaxf(mx0, s[4 * n + e]);
        mx1 = fmaxf(mx1, s[4 * n + 2 + e]);
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + n * 8 + t4 * 2 + e < kv_len;
        const float a =
            valid ? (SCALE ? s[4 * n + e] * c : s[4 * n + e]) : -INFINITY;
        const float b = valid ? (SCALE ? s[4 * n + 2 + e] * c
                                       : s[4 * n + 2 + e])
                              : -INFINITY;
        s[4 * n + e] = a;
        s[4 * n + 2 + e] = b;
        mx0 = fmaxf(mx0, a);
        mx1 = fmaxf(mx1, b);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // every tile holds at least one key below kv_len (the first holds key
  // 0), so the new max is finite; before the first tile m is -inf and the
  // factor 0
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  al0 = exp2_ftz(m0 - mn0);
  al1 = exp2_ftz(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    s[4 * n + 0] = exp2_ftz(s[4 * n + 0] - mn0);
    s[4 * n + 1] = exp2_ftz(s[4 * n + 1] - mn0);
    s[4 * n + 2] = exp2_ftz(s[4 * n + 2] - mn1);
    s[4 * n + 3] = exp2_ftz(s[4 * n + 3] - mn1);
    r0 += s[4 * n + 0] + s[4 * n + 1];
    r1 += s[4 * n + 2] + s[4 * n + 3];
  }
  l0 = l0 * al0 + r0;
  l1 = l1 * al1 + r1;
}

// P rounded to bf16: the S accumulator of two 8-key column blocks is the
// A-fragment of one 16-key step
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int NV, int BK>
__device__ __forceinline__ void fence_all(float (&acc)[NV / 2],
                                          uint32_t (&pa)[BK / 16][4]) {
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
}

// kv_len comes last: placed after S it moved H, D and c_log2 to other
// parameter offsets, and ptxas' code for them cost B1 4% at D = 40 on an
// H100 (same registers; PERF.md, PR 7)
// LSE (the forward under autograd, whose backward reads it): also write
// each row's logsumexp in the exp2 domain, m + log2(l) from the running
// max and sum, to lse[b*H + h][row] (rows lse_pitch apart); without it
// lse is not read and the kernel is the no-grad one.
template <int DP, bool LSE = false>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_kernel(const __grid_constant__ CUtensorMap map_q,
            const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v,
            __nv_bfloat16* __restrict__ o, int S, int H, int D, float c_log2,
            int kv_len, float* __restrict__ lse, int lse_pitch) {
  using C = Cfg<DP>;
  constexpr int NB = C::NB, NV = C::NV, NS = C::NS, BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * NS + 1];  // full, empty, Q
  // the swizzle atoms need 1024-byte aligned tiles
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  unsigned char* sp = smem_raw + (sbase - raw);
  const uint32_t sQ = sbase;
  const uint32_t sK = sQ + C::Q_BYTES;          // NS K tiles
  const uint32_t sV = sK + NS * C::KV_BYTES;    // NS V tiles
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + NS * 8;
  const uint32_t qbar = full0 + 2 * NS * 8;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int ntiles = (kv_len + BK - 1) / BK;

  if (tid == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(full0 + st * 8, 1);
      mbar_init(empty0 + st * 8, NCONSUMER / 32);  // one arrive a warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NCONSUMER) {
    // producer: one thread issues every copy of the block
    if (tid == NCONSUMER) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int j = 0; j < NB; ++j)
        tma_load_4d(sQ + j * BQ * 128, &map_q, qbar, j * 64, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % NS;
        if (t >= NS) mbar_wait(empty0 + st * 8, ((t / NS) - 1) & 1);
        const uint32_t fb = full0 + st * 8;
        mbar_expect_tx(fb, 2 * C::KV_BYTES);
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(sK + st * C::KV_BYTES + j * BK * 128, &map_k, fb,
                      j * 64, h, t * BK, b);
          tma_load_4d(sV + st * C::KV_BYTES + j * BK * 128, &map_v, fb,
                      j * 64, h, t * BK, b);
        }
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t qrows = sQ + wg * 64 * 128;  // this warpgroup's Q rows
  float acc[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;
  float s[BK / 2];
  uint32_t pa[BK / 16][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, al0, al1;

  // warpgroup 0 issues first
  if (wg == 1) named_bar_arrive(BAR_TURN + 0, NCONSUMER);
  mbar_wait(qbar, 0);
  mbar_wait(full0, 0);
  named_bar_sync(BAR_TURN + wg, NCONSUMER);
  fence_regs(s);
  wgmma_fence();
  issue_qk<DP>(s, qrows, sK);
  wgmma_commit();
  named_bar_arrive(BAR_TURN + (wg ^ 1), NCONSUMER);
  wgmma_wait<0>();
  fence_regs(s);
  online_softmax<BK>(s, 0, kv_len, c_log2, t4, m0, m1, l0, l1, al0, al1);
  pack_p<BK>(pa, s);

  for (int kt = 1; kt < ntiles; ++kt) {
    const int st = kt % NS, pst = (kt - 1) % NS;
    mbar_wait(full0 + st * 8, (kt / NS) & 1);  // tile kt landed
    named_bar_sync(BAR_TURN + wg, NCONSUMER);  // this warpgroup's turn
    fence_all<NV, BK>(acc, pa);
    fence_regs(s);
    wgmma_fence();
    issue_qk<DP>(s, qrows, sK + st * C::KV_BYTES);
    wgmma_commit();
    issue_pv<NV, BK>(acc, pa, sV + pst * C::KV_BYTES);
    wgmma_commit();
    named_bar_arrive(BAR_TURN + (wg ^ 1), NCONSUMER);
    wgmma_wait<1>();  // S_kt landed; P V still in flight
    fence_regs(s);
    online_softmax<BK>(s, kt * BK, kv_len, c_log2, t4, m0, m1, l0, l1, al0,
                       al1);
    wgmma_wait<0>();
    fence_all<NV, BK>(acc, pa);
    if (lane == 0) mbar_arrive(empty0 + pst * 8);  // tile kt-1 consumed
#pragma unroll
    for (int j = 0; j < NV / 8; ++j) {
      acc[4 * j + 0] *= al0;
      acc[4 * j + 1] *= al0;
      acc[4 * j + 2] *= al1;
      acc[4 * j + 3] *= al1;
    }
    pack_p<BK>(pa, s);
  }
  // balance the turn barriers: warpgroup 1 arrived once more than
  // warpgroup 0 waited
  if (wg == 0) named_bar_sync(BAR_TURN + 0, NCONSUMER);
  fence_all<NV, BK>(acc, pa);
  wgmma_fence();
  issue_pv<NV, BK>(acc, pa, sV + ((ntiles - 1) % NS) * C::KV_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_all<NV, BK>(acc, pa);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  // stage the bf16 output in this warpgroup's own Q rows (its wgmma reads
  // of them are complete), then store whole rows
  const int r0 = wg * 64 + warp * 16 + g;
  if constexpr (LSE) {  // each row's logsumexp, for the backward
    if (t4 == 0) {
      float* lrow = lse + (long long)blockIdx.y * lse_pitch + q0;
      if (q0 + r0 < S) lrow[r0] = m0 + log2f(l0);
      if (q0 + r0 + 8 < S) lrow[r0 + 8] = m1 + log2f(l1);
    }
  }
#pragma unroll
  for (int j = 0; j < NV / 8; ++j) {
    const int c = j * 8 + t4 * 2;
    unsigned char* blk = sp + (c >> 6) * BQ * 128;
    const int qc = (c & 63) >> 3;
    *reinterpret_cast<uint32_t*>(blk + swz(r0, qc) + (c & 7) * 2) =
        pack_bf16(acc[4 * j + 0] * inv0, acc[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(blk + swz(r0 + 8, qc) + (c & 7) * 2) =
        pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
  named_bar_sync(BAR_EPI + wg, 128);
  const int wt = tid % 128;
  const int cpr = D / 8;  // D % 8 == 0 (launch_bf16 checks)
  for (int i = wt; i < 64 * cpr; i += 128) {
    const int rl = i / cpr, qq = i - rl * cpr;
    const int r = wg * 64 + rl, srow = q0 + r;
    if (srow < S) {
      const uint4 val = *reinterpret_cast<const uint4*>(
          sp + (qq >> 3) * BQ * 128 + swz(r, qq & 7));
      *reinterpret_cast<uint4*>(
          o + (((long long)b * S + srow) * H + h) * D + qq * 8) = val;
    }
  }
}

// ---- the int8-QK^T form (B8, attention_i8.cu) ----
// Q and K arrive quantized (attention_i8.cu's pass, once per call): int8
// [B*H, S, NV] with the head dim zero-padded to NV (a multiple of 64, as
// the TPU kernel pads its int8 contraction), and f32 dequant factors
// qdeq [B*H, sp4] (q_amax * c/127) and kdeq [B*H, sp4] (k_amax / 127).
// Per tile: S = Q K^T on wgmma m64nBKk32 s8 x s8 -> s32 (exact), both
// operands K-major in the 64-byte swizzle (SW64, hopper.cuh), NV/32 steps;
// the logit (float(s32) * q_deq) * k_deq in the TPU kernel's order, in the
// exp2 domain already (c is in q_deq); then B1's softmax, P V and
// epilogue. The tile's kdeq (BK floats) travels with its K and V tiles.
// s32 -> f32 without the conversion unit: adding 0x4B400000 (1.5 * 2^23)
// to the integer's bits gives the float 1.5 * 2^23 + s32 exactly while
// -2^22 <= s32 < 2^22 (the mantissa holds 2^22 + s32), and subtracting
// 1.5 * 2^23 leaves float(s32) exactly; |s32| <= 127^2 * 256 < 2^22 for
// every padded head dim up to 256. An integer add and a float add run at
// the full rate, where I2F shares the 16-a-clock path with exp2.
template <int NV>
struct CfgI8 {
  static constexpr int NB = NV / 64;       // 64-column blocks per row
  static constexpr int KSTEPS = NV / 32;   // int8 steps of 32 along D
  static constexpr int BK = NV == 64 ? 128 : 64;
  static constexpr int Q_BYTES = NB * BQ * 64;    // int8, SW64
  static constexpr int K_BYTES = NB * BK * 64;    // int8, SW64
  static constexpr int V_BYTES = NB * BK * 128;   // bf16, SW128
  static constexpr int KD_BYTES = BK * 4;         // f32 k_deq of a tile
  static constexpr int O_BYTES = NB * BQ * 128;   // bf16 output staging
  static constexpr int STAGE = K_BYTES + V_BYTES + KD_BYTES;
  static constexpr int NS =
      Q_BYTES + O_BYTES + 4 * STAGE + 1024 <= SMEM_LIMIT   ? 4
      : Q_BYTES + O_BYTES + 3 * STAGE + 1024 <= SMEM_LIMIT ? 3
                                                           : 2;
  static constexpr int SMEM = Q_BYTES + O_BYTES + NS * STAGE + 1024;
  static_assert(SMEM <= SMEM_LIMIT,
                "the int8 attention tiles exceed a block's shared memory");
};

__device__ __forceinline__ void qk_step_i8(uint32_t (&s)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  wgmma_ss_m64n64k32_s8(s, da, db, scale_d);
}

__device__ __forceinline__ void qk_step_i8(uint32_t (&s)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  wgmma_ss_m64n128k32_s8(s, da, db, scale_d);
}

// S = Q K^T in int8 for a warpgroup's 64 query rows (at qrows) and a tile
// of BK keys (at kst): NV/32 wgmma, 32 values of D each
template <int NV, int BK = CfgI8<NV>::BK>
__device__ __forceinline__ void issue_qk_i8(uint32_t (&s)[BK / 2],
                                            uint32_t qrows, uint32_t kst) {
#pragma unroll
  for (int kk = 0; kk < CfgI8<NV>::KSTEPS; ++kk) {
    const uint32_t koff = (kk & 1) * 32;  // 32 values along D
    const uint64_t da = desc_sw64(qrows + (kk >> 1) * BQ * 64 + koff, 512);
    const uint64_t db = desc_sw64(kst + (kk >> 1) * BK * 64 + koff, 512);
    qk_step_i8(s, da, db, kk > 0 ? 1 : 0);
  }
}

// float(s32), exact for |s32| < 2^22 (see above)
__device__ __forceinline__ float s32_to_f32(uint32_t v) {
  return __uint_as_float(v + 0x4B400000u) - 12582912.f;
}

// the logits of a tile, (float(s32) * q_deq) * k_deq, for the thread's
// rows g (qd0) and g + 8 (qd1); kd: the tile's k_deq in shared memory
template <int BK>
__device__ __forceinline__ void dequant(float (&f)[BK / 2],
                                        const uint32_t (&si)[BK / 2],
                                        const float* kd, int t4, float qd0,
                                        float qd1) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    const float2 k2 = *reinterpret_cast<const float2*>(kd + 8 * n + 2 * t4);
    f[4 * n + 0] = (s32_to_f32(si[4 * n + 0]) * qd0) * k2.x;
    f[4 * n + 1] = (s32_to_f32(si[4 * n + 1]) * qd0) * k2.y;
    f[4 * n + 2] = (s32_to_f32(si[4 * n + 2]) * qd1) * k2.x;
    f[4 * n + 3] = (s32_to_f32(si[4 * n + 3]) * qd1) * k2.y;
  }
}

// B1's kernel with the first product in int8: maps over the quantized Q
// and K ([B*H, S, NV] int8, boxes of 64 columns), over v (B1's), and over
// kdeq ([B*H, S] f32, boxes of BK keys); qdeq read once per row
template <int NV>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_i8_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_kd,
               const float* __restrict__ qdeq, __nv_bfloat16* __restrict__ o,
               int S, int H, int D, int sp4) {
  using C = CfgI8<NV>;
  constexpr int NB = C::NB, NS = C::NS, BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * NS + 1];  // full, empty, Q
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  unsigned char* sp = smem_raw + (sbase - raw);
  const uint32_t sQ = sbase;
  const uint32_t sK = sQ + C::Q_BYTES;        // NS K tiles
  const uint32_t sV = sK + NS * C::K_BYTES;   // NS V tiles
  const uint32_t sO = sV + NS * C::V_BYTES;   // output staging
  const uint32_t sKD = sO + C::O_BYTES;       // NS k_deq tiles
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + NS * 8;
  const uint32_t qbar = full0 + 2 * NS * 8;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int ntiles = (S + BK - 1) / BK;

  if (tid == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(full0 + st * 8, 1);
      mbar_init(empty0 + st * 8, NCONSUMER / 32);  // one arrive a warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NCONSUMER) {
    // producer: one thread issues every copy of the block
    if (tid == NCONSUMER) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int j = 0; j < NB; ++j)
        tma_load_3d(sQ + j * BQ * 64, &map_q, qbar, j * 64, q0, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % NS;
        if (t >= NS) mbar_wait(empty0 + st * 8, ((t / NS) - 1) & 1);
        const uint32_t fb = full0 + st * 8;
        mbar_expect_tx(fb, C::STAGE);
        for (int j = 0; j < NB; ++j) {
          tma_load_3d(sK + st * C::K_BYTES + j * BK * 64, &map_k, fb, j * 64,
                      t * BK, bh);
          tma_load_4d(sV + st * C::V_BYTES + j * BK * 128, &map_v, fb,
                      j * 64, h, t * BK, b);
        }
        tma_load_2d(sKD + st * C::KD_BYTES, &map_kd, fb, t * BK, bh);
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t qrows = sQ + wg * 64 * 64;  // this warpgroup's Q rows
  const int row0 = q0 + wg * 64 + warp * 16 + g;
  const float qd0 = row0 < S ? qdeq[(long long)bh * sp4 + row0] : 0.f;
  const float qd1 = row0 + 8 < S ? qdeq[(long long)bh * sp4 + row0 + 8]
                                 : 0.f;
  const float* kd0 = reinterpret_cast<const float*>(sp + (sKD - sbase));
  float acc[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;
  uint32_t si[BK / 2];
  float s[BK / 2];
  uint32_t pa[BK / 16][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, al0, al1;

  // warpgroup 0 issues first
  if (wg == 1) named_bar_arrive(BAR_TURN + 0, NCONSUMER);
  mbar_wait(qbar, 0);
  mbar_wait(full0, 0);
  named_bar_sync(BAR_TURN + wg, NCONSUMER);
  fence_regs(si);
  wgmma_fence();
  issue_qk_i8<NV>(si, qrows, sK);
  wgmma_commit();
  named_bar_arrive(BAR_TURN + (wg ^ 1), NCONSUMER);
  wgmma_wait<0>();
  fence_regs(si);
  dequant<BK>(s, si, kd0, t4, qd0, qd1);
  online_softmax<BK, false>(s, 0, S, 0.f, t4, m0, m1, l0, l1, al0, al1);
  pack_p<BK>(pa, s);

  for (int kt = 1; kt < ntiles; ++kt) {
    const int st = kt % NS, pst = (kt - 1) % NS;
    mbar_wait(full0 + st * 8, (kt / NS) & 1);  // tile kt landed
    named_bar_sync(BAR_TURN + wg, NCONSUMER);  // this warpgroup's turn
    fence_all<NV, BK>(acc, pa);
    fence_regs(si);
    wgmma_fence();
    issue_qk_i8<NV>(si, qrows, sK + st * C::K_BYTES);
    wgmma_commit();
    issue_pv<NV, BK>(acc, pa, sV + pst * C::V_BYTES);
    wgmma_commit();
    named_bar_arrive(BAR_TURN + (wg ^ 1), NCONSUMER);
    wgmma_wait<1>();  // S_kt landed; P V still in flight
    fence_regs(si);
    dequant<BK>(s, si, kd0 + st * BK, t4, qd0, qd1);
    online_softmax<BK, false>(s, kt * BK, S, 0.f, t4, m0, m1, l0, l1, al0,
                              al1);
    wgmma_wait<0>();
    fence_all<NV, BK>(acc, pa);
    if (lane == 0) mbar_arrive(empty0 + pst * 8);  // tile kt-1 consumed
#pragma unroll
    for (int j = 0; j < NV / 8; ++j) {
      acc[4 * j + 0] *= al0;
      acc[4 * j + 1] *= al0;
      acc[4 * j + 2] *= al1;
      acc[4 * j + 3] *= al1;
    }
    pack_p<BK>(pa, s);
  }
  // balance the turn barriers: warpgroup 1 arrived once more than
  // warpgroup 0 waited
  if (wg == 0) named_bar_sync(BAR_TURN + 0, NCONSUMER);
  fence_all<NV, BK>(acc, pa);
  wgmma_fence();
  issue_pv<NV, BK>(acc, pa, sV + ((ntiles - 1) % NS) * C::V_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_all<NV, BK>(acc, pa);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  // stage the bf16 output in this warpgroup's rows of the staging tile,
  // then store whole rows
  unsigned char* so = sp + (sO - sbase);
  const int r0 = wg * 64 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < NV / 8; ++j) {
    const int c = j * 8 + t4 * 2;
    unsigned char* blk = so + (c >> 6) * BQ * 128;
    const int qc = (c & 63) >> 3;
    *reinterpret_cast<uint32_t*>(blk + swz(r0, qc) + (c & 7) * 2) =
        pack_bf16(acc[4 * j + 0] * inv0, acc[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(blk + swz(r0 + 8, qc) + (c & 7) * 2) =
        pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
  named_bar_sync(BAR_EPI + wg, 128);
  const int wt = tid % 128;
  const int cpr = D / 8;  // D % 8 == 0 (launch_i8 checks)
  for (int i = wt; i < 64 * cpr; i += 128) {
    const int rl = i / cpr, qq = i - rl * cpr;
    const int r = wg * 64 + rl, srow = q0 + r;
    if (srow < S) {
      const uint4 val = *reinterpret_cast<const uint4*>(
          so + (qq >> 3) * BQ * 128 + swz(r, qq & 7));
      *reinterpret_cast<uint4*>(
          o + (((long long)b * S + srow) * H + h) * D + qq * 8) = val;
    }
  }
}

// f32 inputs (the f32 pipelines; the TPU kernels take both types): one
// warp per query row, the head dim spread over the lanes (up to F32_VPL
// values each), keys read straight from global memory (one head's K/V
// stays in L2) with the same exp2 online softmax over keys 0..kv_len-1.
// CUDA-core FMA in full f32, so the result matches an f32 reference to
// round-off; off the bf16 main path, so it is kept simple rather than
// fast.
constexpr int F32_WARPS = 4;
constexpr int F32_VPL = 8;  // 32 lanes x 8 values covers D <= 256

__global__ void __launch_bounds__(F32_WARPS * 32)
attn_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int S,
                int kv_len, int H, int D, long long sb, long long ss,
                long long sh, float c_log2) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * F32_WARPS + warp;
  if (row >= S) return;  // the whole warp leaves together
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long base = b * sb + h * sh;
  float qv[F32_VPL], acc[F32_VPL];
#pragma unroll
  for (int i = 0; i < F32_VPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? q[base + row * ss + d] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < kv_len; ++j) {
    const float* kr = k + base + j * ss;
    const float* vr = v + base + j * ss;
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
  float* orow = o + (((long long)b * S + row) * H + h) * D;
#pragma unroll
  for (int i = 0; i < F32_VPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) orow[d] = acc[i] * inv;
  }
}

// a (D, H, rows, B) map over one of q/k/v, boxes of 64 columns x `box`
// rows of one head
inline bool make_map(CUtensorMap* map, const void* ptr, int B, int rows,
                     int H, int D, long long sb, long long ss, long long sh,
                     int box) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t boxdim[4] = {64, 1, (cuuint32_t)box, 1};
  return make_map_bf16(map, ptr, 4, dims, strides, boxdim);
}

template <int DP, bool LSE = false>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int kv_len, int H, int D, long long sb, long long ss, long long sh,
           float c, cudaStream_t stream, float* lse = nullptr,
           int lse_pitch = 0) {
  alignas(64) CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, S, H, D, sb, ss, sh, BQ) ||
      !make_map(&mk, k, B, kv_len, H, D, sb, ss, sh, Cfg<DP>::BK) ||
      !make_map(&mv, v, B, kv_len, H, D, sb, ss, sh, Cfg<DP>::BK))
    return (int)cudaErrorInvalidValue;
  const int smem = Cfg<DP>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<DP, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  attn_kernel<DP, LSE><<<grid, NTHREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), S, H, D, c, kv_len, lse,
      lse_pitch);
  return (int)cudaGetLastError();
}

// The bf16 kernel over q, k, v with element strides (sb, ss, sh) and a unit
// last stride, o a contiguous [B, S, H, D]; keys 0..kv_len-1 (1 <= kv_len
// <= S). The tensor maps need D % 8 == 0, 16-byte aligned pointers and
// strides that are multiples of 8 elements; B * H must fit gridDim.y.
// Anything else returns cudaErrorInvalidValue (the wrappers copy such
// inputs first). Returns a cudaError_t.
inline int launch_bf16(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int kv_len, int H, int D, long long sb,
                       long long ss, long long sh, float sm_scale,
                       cudaStream_t st) {
  const float c = sm_scale * 1.4426950408889634f;  // log2(e)
  const uintptr_t align =
      (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
  if (D <= 0 || D % 8 != 0 || S < 1 || kv_len < 1 || kv_len > S || B < 1 ||
      H < 1 || (long long)B * H > MAX_GRID_Y || align % 16 != 0 ||
      sb % 8 != 0 || ss % 8 != 0 || sh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (D <= 48)
    return launch<48>(q, k, v, o, B, S, kv_len, H, D, sb, ss, sh, c, st);
  if (D <= 64)
    return launch<64>(q, k, v, o, B, S, kv_len, H, D, sb, ss, sh, c, st);
  if (D <= 80)
    return launch<80>(q, k, v, o, B, S, kv_len, H, D, sb, ss, sh, c, st);
  if (D <= 128)
    return launch<128>(q, k, v, o, B, S, kv_len, H, D, sb, ss, sh, c, st);
  if (D <= 160)
    return launch<160>(q, k, v, o, B, S, kv_len, H, D, sb, ss, sh, c, st);
  if (D <= 256)
    return launch<256>(q, k, v, o, B, S, kv_len, H, D, sb, ss, sh, c, st);
  return (int)cudaErrorInvalidValue;
}

// launch_bf16 with kv_len = S that also writes each row's logsumexp (exp2
// domain) to lse, f32 [B*H, lse_pitch] (lse_pitch >= S, a multiple of 4),
// for the backward (attention_bwd.cu) at the head dims it takes, D <= 128.
// The output is launch_bf16's bit for bit.
inline int launch_bf16_lse(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int S, int H, int D,
                           long long sb, long long ss, long long sh,
                           float sm_scale, int lse_pitch, cudaStream_t st) {
  const float c = sm_scale * 1.4426950408889634f;  // log2(e)
  const uintptr_t align =
      (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
  if (D <= 0 || D > 128 || D % 8 != 0 || S < 1 || B < 1 || H < 1 ||
      (long long)B * H > MAX_GRID_Y || align % 16 != 0 || sb % 8 != 0 ||
      ss % 8 != 0 || sh % 8 != 0 || lse == nullptr || lse_pitch < S)
    return (int)cudaErrorInvalidValue;
  if (D <= 48)
    return launch<48, true>(q, k, v, o, B, S, S, H, D, sb, ss, sh, c, st, lse,
                            lse_pitch);
  if (D <= 64)
    return launch<64, true>(q, k, v, o, B, S, S, H, D, sb, ss, sh, c, st, lse,
                            lse_pitch);
  if (D <= 80)
    return launch<80, true>(q, k, v, o, B, S, S, H, D, sb, ss, sh, c, st, lse,
                            lse_pitch);
  return launch<128, true>(q, k, v, o, B, S, S, H, D, sb, ss, sh, c, st, lse,
                           lse_pitch);
}

// The dynamic shared memory of a block of the bf16 kernel at head dim D
// (the template launch_bf16 picks), or -1 if it takes no D.
inline int smem_bf16(int D) {
  if (D <= 0) return -1;
  if (D <= 48) return Cfg<48>::SMEM;
  if (D <= 64) return Cfg<64>::SMEM;
  if (D <= 80) return Cfg<80>::SMEM;
  if (D <= 128) return Cfg<128>::SMEM;
  if (D <= 160) return Cfg<160>::SMEM;
  if (D <= 256) return Cfg<256>::SMEM;
  return -1;
}

// The f32 kernel under launch_bf16's contract, for any strides and
// alignment.
inline int launch_f32(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int kv_len, int H, int D, long long sb,
                      long long ss, long long sh, float sm_scale,
                      cudaStream_t st) {
  if (D <= 0 || D > 32 * F32_VPL || S < 1 || kv_len < 1 || kv_len > S ||
      B < 1 || H < 1 || (long long)B * H > MAX_GRID_Y)
    return (int)cudaErrorInvalidValue;
  const float c = sm_scale * 1.4426950408889634f;  // log2(e)
  dim3 grid((S + F32_WARPS - 1) / F32_WARPS, B * H);
  attn_kernel_f32<<<grid, F32_WARPS * 32, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, kv_len, H, D,
      sb, ss, sh, c);
  return (int)cudaGetLastError();
}

}  // namespace sdt_attn
