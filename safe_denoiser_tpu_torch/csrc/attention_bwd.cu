// The backward of B1 (unmasked self-attention, csrc/attention.cu): dQ, dK,
// dV of O = softmax(s Q K^T) V over bf16 [B, S, H, D] q/k/v, on the
// warpgroup tensor-core instructions (wgmma) fed by the Tensor Memory
// Accelerator (TMA), with the row statistics the forward kept.
//
// Replaces no TPU kernel: the JAX package's _attn_kernel
// (safe_denoiser_tpu/ops/attention.py:36) has no VJP, so its trainer
// differentiates only XLA's einsum path. This kernel computes the gradient
// of the function B1 computes, what jax.vjp gives on that einsum path, so
// that training runs through B1 on the card.
//
// Bound on an H100: operations. The necessary work is five S x S x D
// products per head (Q K^T again, dO V^T, P^T dO, dS^T Q, dS K), 10 B H S^2
// D FLOP (0.30 ms at SD3's [1,4429,24,64] at 989 TFLOP/s bf16 dense),
// against 8 B S H D bf16 bytes moved; and, as in the forward, an exp2 per
// logit on the 16-a-clock special-function units, so the elementwise work
// has to run while the tensor cores work.
//
// Inputs: q, k, v, o (B1's output), dout and the outputs: contiguous bf16
// [B, S, H, D], D % 8 == 0 (the wrapper pads other head dims with zero
// columns); lse: each query row's logsumexp L in the exp2 domain, f32
// [B*H, sp] (sp >= S, a multiple of 4: a tensor map's row stride), which
// B1's forward wrote under autograd (attention_hopper.cuh, LSE), so no pass
// here recomputes Q K^T for it.
//
// Two launches, one wrapper call (ops/attention.py::_attention_bwd_cuda):
//   1. delta: Delta = rowsum(dO * O) per query row, f32 [B*H, sp]; one read
//      of dO and O (bytes).
//   2. bwd: the dK/dV pass and the dQ pass in one grid, blocks of both
//      kinds side by side (the dQ blocks fill the SMs the dK/dV blocks
//      leave idle: SD-v1's [1,1024,8,80] has 64 of each). A block is two
//      consumer warpgroups and a producer warp, one thread of which issues
//      every TMA copy into a ring of NS stages behind full/empty mbarriers.
//      dK/dV: a block owns 128 keys of one head, 64 a warpgroup, K and V
//      loaded once; Q, dO, L and Delta stream in tiles of BQ queries (64;
//      32 for D > 64, whose dK and dV accumulators leave no room for
//      more). Per tile and warpgroup:
//        S^T  = K Q^T       wgmma, both operands K-major in shared memory
//        dP^T = V dO^T      the same
//        P^T  = 2^(c S^T - L), dS^T = P^T (dP^T - Delta)   in registers
//        dV  += P^T dO      wgmma, A from registers (P^T rounded to bf16),
//                           dO the MN-major B operand (transpose bit)
//        dK  += dS^T Q      the same with dS^T and Q
//      dQ: a block owns 128 query rows, 64 a warpgroup, Q and dO loaded
//      once; K and V stream in tiles of BK = 64 keys: S = Q K^T, dP = dO
//      V^T, dS = P (dP - Delta), dQ += dS K (K the MN-major B operand).
//      The two warpgroups take turns at issuing their first products
//      (named barriers, FA3's ping-pong), so one's elementwise work
//      overlaps the other's products. The dQ pass also issues tile t's
//      first products with tile t-1's dQ product, so its own elementwise
//      work runs while that is in flight. The dK/dV pass does not: with
//      288 threads a block a thread has 168 registers, and that overlap
//      keeps S^T, dP^T, both fragments and both accumulators live (160 of
//      them at D <= 64, before addresses), which spilled and ran slower
//      in this design's trials; handing the producer's registers to the
//      consumers (setmaxnreg, 384 threads) did not lift ptxas' 168 there,
//      and a 128-key dQ tile spilled too.
// Seven products in all, two more than the five necessary: dQ is summed by
// its own pass over query blocks rather than added into an f32 accumulator
// by every key block. That keeps every output element summed by one thread
// in a fixed order (two calls give the same bits) without a turn counter
// per query block that key blocks spin on (FA3's deterministic mode), with
// no f32 dQ scratch and no conversion pass; the two recomputed products
// run on the same wgmma core at the same rate.
//
// Tails: the tensor maps zero-fill rows past S (SD3's 4429) and columns
// past D (40 -> 48, 80 -> the second 64-column block). A zero query row
// has S^T = 0, dO = 0 and Delta = 0, so its dS^T is 0 and it adds nothing
// to dK or dV; a zero key row's dK and dV rows are not stored. The dq pass
// masks keys at or past S to P = 0: 2^(0 - L) of a row with very negative
// logits could overflow, and inf * 0 is NaN. Outputs past S or D are not
// stored.
//
// Shapes: any S, 8 <= D <= 128 (D % 8 == 0), B * H <= 65535; tiles of
// DP = 48, 64, 80 or 128 head-dim columns (the forward's D classes).
// Registers (ptxas, as chip_smoke.py's phase 3 prints them): 164 a thread at
// D <= 64, no spill; at D = 80 and 128 the 128-column dK and dV
// accumulators spill 160 and 216 bytes and ptxas serializes the wgmma
// (C7512); SD3's D = 64 takes neither.

#include "attention_hopper.cuh"

namespace {

using namespace sdt_hopper;
using sdt_attn::exp2_ftz;
using sdt_attn::issue_pv;
using sdt_attn::issue_qk;
using sdt_attn::make_map;
using sdt_attn::pack_bf16;
using sdt_attn::pack_p;

typedef __nv_bfloat16 bf16;

constexpr int NCONSUMER = 256;            // two consumer warpgroups
constexpr int NTHREADS = NCONSUMER + 32;  // + the producer warp
constexpr int SMEM_LIMIT = 232448;
constexpr int BAR_TURN = 1;  // named barriers 1, 2: a warpgroup's turn
constexpr int ROWS = 128;    // keys (dkdv) or queries (dq) a block owns
constexpr int NS = 4;        // stages of the ring
constexpr int DELTA_THREADS = 256;

template <int DP>
struct Bwd {
  static constexpr int NB = (DP + 63) / 64;  // 64-column blocks per row
  static constexpr int NV = NB * 64;         // width of dK, dV, dQ
  static constexpr int BQ = NV == 64 ? 64 : 32;   // dkdv's query tile
  static constexpr int BK = 64;                   // dq's key tile
  static constexpr int OWN_BYTES = NB * ROWS * 128;  // K or V / Q or dO owned
  static constexpr int QT_BYTES = NB * BQ * 128;     // a streamed Q or dO tile
  static constexpr int KT_BYTES = NB * BK * 128;     // a streamed K or V tile
  static constexpr int STAT_BYTES = BQ * 4;          // an L or Delta tile
  static constexpr int DKDV_SMEM =
      2 * OWN_BYTES + NS * (2 * QT_BYTES + 2 * STAT_BYTES) + 1024;
  static constexpr int DQ_SMEM = 2 * OWN_BYTES + NS * 2 * KT_BYTES + 1024;
  static constexpr int SMEM = DKDV_SMEM > DQ_SMEM ? DKDV_SMEM : DQ_SMEM;
  static_assert(SMEM <= SMEM_LIMIT,
                "the backward's tiles exceed a block's shared memory");
};

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(a[i]);
}

// P^T and dS^T of one query tile in place, for the thread's key rows g
// (e < 2) and g + 8: s[4n + e] and dp[4n + e] hold query 8n + 2 t4 + (e & 1)
// of the tile, whose L and Delta lie in shared memory
template <int BQ>
__device__ __forceinline__ void grad_keys(float (&s)[BQ / 2],
                                          float (&dp)[BQ / 2], const float* L,
                                          const float* Dl, float c, int t4) {
#pragma unroll
  for (int n = 0; n < BQ / 8; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(L + 8 * n + 2 * t4);
    const float2 d = *reinterpret_cast<const float2*>(Dl + 8 * n + 2 * t4);
    const float p0 = exp2_ftz(fmaf(s[4 * n + 0], c, -l.x));
    const float p1 = exp2_ftz(fmaf(s[4 * n + 1], c, -l.y));
    const float p2 = exp2_ftz(fmaf(s[4 * n + 2], c, -l.x));
    const float p3 = exp2_ftz(fmaf(s[4 * n + 3], c, -l.y));
    s[4 * n + 0] = p0;
    s[4 * n + 1] = p1;
    s[4 * n + 2] = p2;
    s[4 * n + 3] = p3;
    dp[4 * n + 0] = p0 * (dp[4 * n + 0] - d.x);
    dp[4 * n + 1] = p1 * (dp[4 * n + 1] - d.y);
    dp[4 * n + 2] = p2 * (dp[4 * n + 2] - d.x);
    dp[4 * n + 3] = p3 * (dp[4 * n + 3] - d.y);
  }
}

// dS of one key tile in place (in dp), for the thread's query rows g (L0,
// D0) and g + 8 (L1, D1): s[4n + e] and dp[4n + e] hold key k0 + 8n + 2 t4
// + (e & 1); keys at or past S get P = 0
template <int BK>
__device__ __forceinline__ void grad_rows(const float (&s)[BK / 2],
                                          float (&dp)[BK / 2], int k0, int S,
                                          float c, int t4, float L0, float L1,
                                          float D0, float D1) {
  const bool tail = k0 + BK > S;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = !tail || k0 + 8 * n + 2 * t4 + e < S;
      const float p0 = in ? exp2_ftz(fmaf(s[4 * n + e], c, -L0)) : 0.f;
      const float p1 = in ? exp2_ftz(fmaf(s[4 * n + 2 + e], c, -L1)) : 0.f;
      dp[4 * n + e] = p0 * (dp[4 * n + e] - D0);
      dp[4 * n + 2 + e] = p1 * (dp[4 * n + 2 + e] - D1);
    }
  }
}

// the thread's two rows (row, row + 8) of a warpgroup's [64, NV]
// accumulator, times `mul`, as bf16 into out ([B, S, H, D] rows; `base`
// the (b, 0, h, 0) offset), rows at or past S and columns past D dropped
template <int NV>
__device__ __forceinline__ void store_rows(bf16* out, long long base,
                                           long long rs, const float (&a)[NV / 2],
                                           float mul, int row, int S, int D,
                                           int t4) {
#pragma unroll
  for (int j = 0; j < NV / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (col < D) {
      if (row < S)
        *reinterpret_cast<uint32_t*>(out + base + row * rs + col) =
            pack_bf16(a[4 * j + 0] * mul, a[4 * j + 1] * mul);
      if (row + 8 < S)
        *reinterpret_cast<uint32_t*>(out + base + (row + 8) * rs + col) =
            pack_bf16(a[4 * j + 2] * mul, a[4 * j + 3] * mul);
    }
  }
}

// Delta = rowsum(dO * O), one thread a (b, s, h) row, 16-byte loads, f32
// sums in column order
__global__ void __launch_bounds__(DELTA_THREADS)
    delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                 float* __restrict__ delta, int S, int H, int D, int sp,
                 long long rows) {
  const long long i = (long long)blockIdx.x * DELTA_THREADS + threadIdx.x;
  if (i >= rows) return;
  const int h = (int)(i % H);
  const long long bs = i / H;
  const int s = (int)(bs % S), b = (int)(bs / S);
  const uint4* op = reinterpret_cast<const uint4*>(o + i * D);
  const uint4* gp = reinterpret_cast<const uint4*>(dout + i * D);
  float acc = 0.f;
  for (int j = 0; j < D / 8; ++j) {
    const uint4 x = op[j], y = gp[j];
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(x2[e]), g = __bfloat1622float2(y2[e]);
      acc = fmaf(a.x, g.x, acc);
      acc = fmaf(a.y, g.y, acc);
    }
  }
  delta[((long long)b * H + h) * sp + s] = acc;
}

// the maps of both passes: dkdv streams Q, dO (boxes of BQ rows), L and
// Delta (BQ entries) and owns K, V (ROWS rows); dq owns Q, dO (ROWS) and
// streams K, V (BK)
struct Maps {
  CUtensorMap q_t, do_t, l, dl, k_own, v_own, q_own, do_own, k_t, v_t;
};

// the dK/dV pass of key block kb (keys kb*ROWS ..) of head blockIdx.y
template <int DP>
__device__ __forceinline__ void dkdv_block(
    const Maps& maps, unsigned char* smem_raw, uint64_t* bars, int kb,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int D,
    float c, float scale) {
  using C = Bwd<DP>;
  constexpr int NB = C::NB, NV = C::NV, BQ = C::BQ;
  // bars: NS full, NS empty, K/V; the swizzle atoms need 1024-byte
  // aligned tiles
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  const unsigned char* sp = smem_raw + (sbase - raw);
  const uint32_t sK = sbase, sV = sK + C::OWN_BYTES;
  const uint32_t sQ = sV + C::OWN_BYTES;         // NS Q tiles
  const uint32_t sO = sQ + NS * C::QT_BYTES;     // NS dO tiles
  const uint32_t sL = sO + NS * C::QT_BYTES;     // NS L tiles
  const uint32_t sD = sL + NS * C::STAT_BYTES;   // NS Delta tiles
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + NS * 8;
  const uint32_t kvbar = full0 + 2 * NS * 8;

  const int tid = threadIdx.x;
  const int k0 = kb * ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int ntiles = (S + BQ - 1) / BQ;

  if (tid == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(full0 + st * 8, 1);
      mbar_init(empty0 + st * 8, NCONSUMER / 32);  // one arrive a warp
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NCONSUMER) {
    // producer: one thread issues every copy of the block
    if (tid == NCONSUMER) {
      mbar_expect_tx(kvbar, 2 * C::OWN_BYTES);
      for (int j = 0; j < NB; ++j) {
        tma_load_4d(sK + j * ROWS * 128, &maps.k_own, kvbar, j * 64, h, k0,
                    b);
        tma_load_4d(sV + j * ROWS * 128, &maps.v_own, kvbar, j * 64, h, k0,
                    b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % NS;
        if (t >= NS) mbar_wait(empty0 + st * 8, ((t / NS) - 1) & 1);
        const uint32_t fb = full0 + st * 8;
        mbar_expect_tx(fb, 2 * C::QT_BYTES + 2 * C::STAT_BYTES);
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(sQ + st * C::QT_BYTES + j * BQ * 128, &maps.q_t, fb,
                      j * 64, h, t * BQ, b);
          tma_load_4d(sO + st * C::QT_BYTES + j * BQ * 128, &maps.do_t, fb,
                      j * 64, h, t * BQ, b);
        }
        tma_load_2d(sL + st * C::STAT_BYTES, &maps.l, fb, t * BQ, bh);
        tma_load_2d(sD + st * C::STAT_BYTES, &maps.dl, fb, t * BQ, bh);
      }
    }
    return;
  }


  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t krows = sK + wg * 64 * 128;  // this warpgroup's keys
  const uint32_t vrows = sV + wg * 64 * 128;
  const float* Ls = reinterpret_cast<const float*>(sp + (sL - sbase));
  const float* Ds = reinterpret_cast<const float*>(sp + (sD - sbase));
  float dka[NV / 2], dva[NV / 2];
  zero(dka);
  zero(dva);
  float s[BQ / 2], dp[BQ / 2];
  uint32_t pa[BQ / 16][4], sa[BQ / 16][4];

  // warpgroup 0 issues first
  if (wg == 1) named_bar_arrive(BAR_TURN + 0, NCONSUMER);
  mbar_wait(kvbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % NS;
    mbar_wait(full0 + st * 8, (t / NS) & 1);   // tile t landed
    named_bar_sync(BAR_TURN + wg, NCONSUMER);  // this warpgroup's turn
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_qk<DP, BQ>(s, krows, sQ + st * C::QT_BYTES);   // S^T = K Q^T
    issue_qk<DP, BQ>(dp, vrows, sO + st * C::QT_BYTES);  // dP^T = V dO^T
    wgmma_commit();
    named_bar_arrive(BAR_TURN + (wg ^ 1), NCONSUMER);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    grad_keys<BQ>(s, dp, Ls + st * BQ, Ds + st * BQ, c, t4);
    pack_p<BQ>(pa, s);
    pack_p<BQ>(sa, dp);
    fence_regs(dka);
    fence_regs(dva);
    fence_frags(pa);
    fence_frags(sa);
    wgmma_fence();
    issue_pv<NV, BQ>(dva, pa, sO + st * C::QT_BYTES);  // dV += P^T dO
    issue_pv<NV, BQ>(dka, sa, sQ + st * C::QT_BYTES);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    fence_frags(pa);
    fence_frags(sa);
    if (lane == 0) mbar_arrive(empty0 + st * 8);  // tile t consumed
  }
  // balance the turn barriers: warpgroup 1 arrived once more than
  // warpgroup 0 waited
  if (wg == 0) named_bar_sync(BAR_TURN + 0, NCONSUMER);

  const long long rs = (long long)H * D;
  const long long base = (long long)b * S * rs + (long long)h * D;
  const int key = k0 + wg * 64 + warp * 16 + g;
  store_rows<NV>(dk, base, rs, dka, scale, key, S, D, t4);
  store_rows<NV>(dv, base, rs, dva, 1.f, key, S, D, t4);
}

// the dQ pass of query block qb (rows qb*ROWS ..) of head blockIdx.y
template <int DP>
__device__ __forceinline__ void dq_block(
    const Maps& maps, unsigned char* smem_raw, uint64_t* bars, int qb,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int S, int H, int D, int sp, float c,
    float scale) {
  using C = Bwd<DP>;
  constexpr int NB = C::NB, NV = C::NV, BK = C::BK;
  // bars: NS full, NS empty, Q/dO
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  const uint32_t sQ = sbase, sO = sQ + C::OWN_BYTES;
  const uint32_t sK = sO + C::OWN_BYTES;       // NS K tiles
  const uint32_t sV = sK + NS * C::KT_BYTES;   // NS V tiles
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + NS * 8;
  const uint32_t qbar = full0 + 2 * NS * 8;

  const int tid = threadIdx.x;
  const int q0 = qb * ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int ntiles = (S + BK - 1) / BK;

  if (tid == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(full0 + st * 8, 1);
      mbar_init(empty0 + st * 8, NCONSUMER / 32);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NCONSUMER) {
    if (tid == NCONSUMER) {
      mbar_expect_tx(qbar, 2 * C::OWN_BYTES);
      for (int j = 0; j < NB; ++j) {
        tma_load_4d(sQ + j * ROWS * 128, &maps.q_own, qbar, j * 64, h, q0,
                    b);
        tma_load_4d(sO + j * ROWS * 128, &maps.do_own, qbar, j * 64, h, q0,
                    b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % NS;
        if (t >= NS) mbar_wait(empty0 + st * 8, ((t / NS) - 1) & 1);
        const uint32_t fb = full0 + st * 8;
        mbar_expect_tx(fb, 2 * C::KT_BYTES);
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(sK + st * C::KT_BYTES + j * BK * 128, &maps.k_t, fb,
                      j * 64, h, t * BK, b);
          tma_load_4d(sV + st * C::KT_BYTES + j * BK * 128, &maps.v_t, fb,
                      j * 64, h, t * BK, b);
        }
      }
    }
    return;
  }


  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t qrows = sQ + wg * 64 * 128;  // this warpgroup's queries
  const uint32_t orows = sO + wg * 64 * 128;
  const int row = q0 + wg * 64 + warp * 16 + g;
  const float* lrow = lse + (long long)bh * sp;
  const float* drow = delta + (long long)bh * sp;
  // rows past S: zero Q and dO rows, not stored
  const float L0 = row < S ? lrow[row] : 0.f;
  const float L1 = row + 8 < S ? lrow[row + 8] : 0.f;
  const float D0 = row < S ? drow[row] : 0.f;
  const float D1 = row + 8 < S ? drow[row + 8] : 0.f;
  float acc[NV / 2];
  zero(acc);
  float s[BK / 2], dp[BK / 2];
  uint32_t sa[BK / 16][4];

  if (wg == 1) named_bar_arrive(BAR_TURN + 0, NCONSUMER);
  mbar_wait(qbar, 0);
  mbar_wait(full0, 0);
  named_bar_sync(BAR_TURN + wg, NCONSUMER);
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
  issue_qk<DP, BK>(s, qrows, sK);   // S = Q K^T
  issue_qk<DP, BK>(dp, orows, sV);  // dP = dO V^T
  wgmma_commit();
  named_bar_arrive(BAR_TURN + (wg ^ 1), NCONSUMER);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  grad_rows<BK>(s, dp, 0, S, c, t4, L0, L1, D0, D1);
  pack_p<BK>(sa, dp);

  for (int t = 1; t < ntiles; ++t) {
    const int st = t % NS, pst = (t - 1) % NS;
    mbar_wait(full0 + st * 8, (t / NS) & 1);
    named_bar_sync(BAR_TURN + wg, NCONSUMER);
    fence_regs(acc);
    fence_frags(sa);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_qk<DP, BK>(s, qrows, sK + st * C::KT_BYTES);
    issue_qk<DP, BK>(dp, orows, sV + st * C::KT_BYTES);
    wgmma_commit();
    issue_pv<NV, BK>(acc, sa, sK + pst * C::KT_BYTES);  // dQ += dS K
    wgmma_commit();
    named_bar_arrive(BAR_TURN + (wg ^ 1), NCONSUMER);
    wgmma_wait<1>();
    fence_regs(s);
    fence_regs(dp);
    grad_rows<BK>(s, dp, t * BK, S, c, t4, L0, L1, D0, D1);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(sa);
    if (lane == 0) mbar_arrive(empty0 + pst * 8);
    pack_p<BK>(sa, dp);
  }
  if (wg == 0) named_bar_sync(BAR_TURN + 0, NCONSUMER);
  fence_regs(acc);
  fence_frags(sa);
  wgmma_fence();
  issue_pv<NV, BK>(acc, sa, sK + ((ntiles - 1) % NS) * C::KT_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  const long long rs = (long long)H * D;
  const long long base = (long long)b * S * rs + (long long)h * D;
  store_rows<NV>(dq, base, rs, acc, scale, row, S, D, t4);
}

// dkdv and dq in one launch, so that the dQ blocks fill the SMs the dK/dV
// blocks leave idle (SD-v1's [1,1024,8,80] has 64 of each): blocks
// blockIdx.x < nkb take dK/dV of key block blockIdx.x, the others dQ of
// query block blockIdx.x - nkb; blockIdx.y is the head
template <int DP>
__global__ void __launch_bounds__(NTHREADS, 1)
    bwd_kernel(const __grid_constant__ Maps maps,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dq,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
               int D, int sp, float c, float scale, int nkb) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * NS + 1];
  if ((int)blockIdx.x < nkb)
    dkdv_block<DP>(maps, smem_raw, bars, blockIdx.x, dk, dv, S, H, D, c,
                   scale);
  else
    dq_block<DP>(maps, smem_raw, bars, blockIdx.x - nkb, lse, delta, dq, S,
                 H, D, sp, c, scale);
}

// an [B*H, S] f32 map (rows sp apart) read in boxes of `box` entries
bool make_stat_map(CUtensorMap* map, const float* ptr, int BH, int S, int sp,
                   int box) {
  const cuuint64_t dims[2] = {(cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[1] = {(cuuint64_t)sp * 4};
  const cuuint32_t boxdim[2] = {(cuuint32_t)box, 1};
  return make_map_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, 2, dims,
                        strides, boxdim, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, bf16* dq, bf16* dk, bf16* dv, const float* lse,
           float* delta, int B, int S, int H, int D, int sp, float sm_scale,
           cudaStream_t stream) {
  using C = Bwd<DP>;
  const float c = sm_scale * 1.4426950408889634f;  // log2(e)
  const long long ss = (long long)H * D, sb = (long long)S * ss;
  const long long rows = (long long)B * S * H;
  const int BH = B * H;
  delta_kernel<<<(unsigned)((rows + DELTA_THREADS - 1) / DELTA_THREADS),
                 DELTA_THREADS, 0, stream>>>(o, dout, delta, S, H, D, sp,
                                             rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  alignas(64) Maps m;
  if (!make_map(&m.q_t, q, B, S, H, D, sb, ss, D, C::BQ) ||
      !make_map(&m.do_t, dout, B, S, H, D, sb, ss, D, C::BQ) ||
      !make_stat_map(&m.l, lse, BH, S, sp, C::BQ) ||
      !make_stat_map(&m.dl, delta, BH, S, sp, C::BQ) ||
      !make_map(&m.k_own, k, B, S, H, D, sb, ss, D, ROWS) ||
      !make_map(&m.v_own, v, B, S, H, D, sb, ss, D, ROWS) ||
      !make_map(&m.q_own, q, B, S, H, D, sb, ss, D, ROWS) ||
      !make_map(&m.do_own, dout, B, S, H, D, sb, ss, D, ROWS) ||
      !make_map(&m.k_t, k, B, S, H, D, sb, ss, D, C::BK) ||
      !make_map(&m.v_t, v, B, S, H, D, sb, ss, D, C::BK))
    return (int)cudaErrorInvalidValue;
  const int nblk = (S + ROWS - 1) / ROWS;
  err = cudaFuncSetAttribute(bwd_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<DP><<<dim3(2 * nblk, BH), NTHREADS, C::SMEM, stream>>>(
      m, lse, delta, dq, dk, dv, S, H, D, sp, c, sm_scale, nblk);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o (B1's output), dout, and the outputs dq, dk, dv: contiguous
// bf16 [B, S, H, D] with 16-byte aligned bases; lse: the forward's
// logsumexp in the exp2 domain, f32 [B*H, sp]; delta: f32 scratch of the
// same shape. Needs D % 8 == 0, 8 <= D <= 128, sp >= S a multiple of 4 and
// B*H <= 65535. Returns a cudaError_t.
extern "C" int sdt_attention_bwd_bf16(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, void* dq, void* dk,
                                      void* dv, const float* lse,
                                      float* delta, int B, int S, int H,
                                      int D, int sp, float sm_scale,
                                      void* stream) {
  const uintptr_t align = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                          (uintptr_t)o | (uintptr_t)dout | (uintptr_t)dq |
                          (uintptr_t)dk | (uintptr_t)dv | (uintptr_t)lse |
                          (uintptr_t)delta;
  if (B < 1 || S < 1 || H < 1 || D < 8 || D > 128 || D % 8 != 0 ||
      sp < S || sp % 4 != 0 || (long long)B * H > 65535 || align % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const bf16 *q_ = (const bf16*)q, *k_ = (const bf16*)k, *v_ = (const bf16*)v,
             *o_ = (const bf16*)o, *g_ = (const bf16*)dout;
  bf16 *dq_ = (bf16*)dq, *dk_ = (bf16*)dk, *dv_ = (bf16*)dv;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 48)
    return launch<48>(q_, k_, v_, o_, g_, dq_, dk_, dv_, lse, delta, B, S, H,
                      D, sp, sm_scale, s);
  if (D <= 64)
    return launch<64>(q_, k_, v_, o_, g_, dq_, dk_, dv_, lse, delta, B, S, H,
                      D, sp, sm_scale, s);
  if (D <= 80)
    return launch<80>(q_, k_, v_, o_, g_, dq_, dk_, dv_, lse, delta, B, S, H,
                      D, sp, sm_scale, s);
  return launch<128>(q_, k_, v_, o_, g_, dq_, dk_, dv_, lse, delta, B, S, H,
                     D, sp, sm_scale, s);
}
