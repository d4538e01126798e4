// The backward of B3 (y = conv3x3_SAME(nearest_2x(h), W) + b over NHWC
// bf16, csrc/conv3x3_up.cu): dh, dW and db from dy, on the warpgroup
// tensor-core instructions (wgmma, bf16 in, f32 accumulate) fed by the
// Tensor Memory Accelerator (TMA).
//
// Replaces no TPU kernel: the JAX package's _up_kernel_planar
// (safe_denoiser_tpu/ops/conv3x3.py:282) has no VJP, so its trainer
// differentiates only XLA's upsample + conv. These kernels compute the
// gradient of the function B3 computes, what jax.vjp gives on that path.
//
// dh (sdt_conv3x3_up_bwd_dx_bf16): the 2x2 sum-pool of the SAME 3x3 conv
// of dy with the flipped, transposed weights, folded into one 4x4
// stride-2 conv over dy:
//   dh[b,i,j,ci] = sum_{u,v in -1..2} sum_co dy[b, 2i+u, 2j+v, co]
//                  * W4[u,v][ci,co],
// W4[u,v] = sum of W[., ., ky, kx] over py - ky + 1 = u, px - kx + 1 = v
// (py, px in {0, 1}), folded on the card by fold_kernel
// (sdt_conv3x3_up_bwd_fold: ops/conv3x3.py::bwd_dx_weights bit for bit,
// one read of W and one write of W4). An implicit GEMM: M = B H W
// pixels, N = Ci, K = 16 Co.
//
// dW, db (sdt_conv3x3_up_bwd_dw_bf16): through B3's own split into four
// output parities (py, px), each a 2x2 conv of h with pre-summed weights
// Weff[py,px,j,k] (ops/conv3x3.py::w_eff_up). For each of the 16
// (py, px, j, k) the product
//   dWeff[co,ci] = sum_{b,i,jj} dy[b, 2i+py, 2jj+px, co]
//                  * h[b, i+py+j-1, jj+px+k-1, ci]
// (M = Co, N = Ci, K = B H W positions), then for each (ky, kx) the sum
// of the four dWeff whose groups hold it (group_of), in a fixed order;
// db sums dy per channel. No atomics: two calls give the same bits.
//
// Bound on an H100: operations. Each of dh and dW is 2 * (B H W) * Ci *
// 16 Co FLOP, 1.34e10 at the UNet's [1,32,32,640] (0.0136 ms at 989
// TFLOP/s); the bytes (dy 5.2 MB, W 7.4 MB, dW 14.7 MB in f32) take under
// half of that at 3.35 TB/s. Both kernels are one producer warp, one
// thread of which issues every TMA copy into a ring of stages behind
// full/empty mbarriers, and two consumer warpgroups that run wgmma on the
// stages that have landed.
//
// B3b-dx. A block owns 128 pixels (an 8 x 16 patch of one image) x TN
// input channels (128 or 160); the warpgroups take 64 pixels each
// (m64nTNk16, both operands K-major from shared memory). A k slice is one
// tap (u, v) and 64 output channels: the A tile is dy at rows 2i + u and
// columns 2j + v of the patch, the B tile W4[u,v] [TN ci x 64 co] (a 3-D
// map of [16, Ci, Co]). The A tile is one TMA box of dy viewed as [B, H,
// 2, W, 2 Co]: row 2i + u is (i + floor(u/2), parity u mod 2) and column
// 2j + v is (j + floor(v/2)) with channel offset (v mod 2) Co, so a tap
// is a shifted box of whole 128-byte rows, the rows land in the 128-byte
// swizzle that wgmma reads, and coordinates -1 and H (W) zero-fill: the
// SAME padding, with no row of a neighbouring image (the batch is a
// dimension of its own). Chosen over the conv core's halo band
// (conv_hopper.cuh): the band needs ldmatrix at each lane's stride-2
// address and A from registers, and 16 taps over one band keep the
// producer out of the loop; a box costs one instruction of one thread.
// Filling the card: at the UNet's shape there are only 40 output tiles of
// 128 x 128 (32 of 128 x 160), 30% of 132 SMs. The 16 x Co/64 k slices
// are split into `split` contiguous ranges, the blocks of one tile form
// a cluster, each stages its f32 tile in shared memory, and block r sums
// pixels r, r + split, ... over the cluster's blocks in rank order
// through DSMEM (cluster.cuh), rounds once to bf16 and stores 16 bytes at
// a time. dx_plan picks TN and the split from the clusters the card holds
// at once (cudaOccupancyMaxActiveClusters): an H100 holds 39 clusters of
// three of these blocks and 30 of four, so 40 tiles x 3 or 32 x 4 would
// run in two waves; the UNet's shape takes 160 channels and 3 blocks a
// tile (96 blocks, one wave). The plan depends on the shape and the card
// only, so two calls add in the same order.
//
// B3b-dw. A cluster of four blocks, one per parity (its rank), owns 128
// output x 64 input channels; each warpgroup 64 output channels, and for
// its parity the four (j, k) as four m64n64 accumulators (128 registers).
// A stage is 64 positions (a 4 x 16 patch of one image): dy at the
// block's parity, [64 positions x 128 co], once for all four products
// (two boxes of the same [B, H, 2, W, 2 Co] view at parity (py, px)), and
// h at the four shifts (py + j - 1, px + k - 1), [64 positions x 64 ci]
// each (boxes of h's 4-D map, zeros outside the image). Positions are
// the rows of both tiles, channels contiguous: both are MN-major
// operands, which wgmma reads with its transpose bits, so nothing is
// transposed by hand. After the loop each block stages its four f32
// partials in shared memory; block r folds output channels 32 r .. +31:
// for each tap the four peers' partials in rank order (py, px) = (0, 0),
// (0, 1), (1, 0), (1, 1), staged as [co][ci][9] and written as whole rows
// of dW [Co, Ci, 3, 3] (coalesced). db is fused: the blocks of input
// tile 0 also sum their dy tiles per channel (each thread one channel,
// half the rows, in position order), add the halves, and block r adds
// the four parities' sums in rank order. Nothing goes through global
// memory but dy, h, dW and db. At the UNet's shape: 50 clusters, two
// waves (an H100 holds 30 clusters of four). Tried and dropped: dy^T as
// register fragments (ldmatrix .trans, once for the four products) so
// that each wgmma reads only h from shared memory; short of registers,
// ptxas serialized the wgmma (C7512) and spilled, and it ran slower.
//
// Shapes: Ci % 64 == 0 and Co % 64 == 0 (ops/conv3x3.py pads Co % 64 ==
// 32 for dx with zero channels), any B, H, W. Patches past the image read
// zeros and are not stored; B3b-dw's last output tile is masked where
// Co % 128 == 64.

#include "cluster.cuh"
#include "hopper.cuh"

namespace {

using namespace sdt_hopper;

typedef __nv_bfloat16 bf16;

constexpr int NCONSUMER = 256;            // two consumer warpgroups
constexpr int NTHREADS = NCONSUMER + 32;  // + the producer warp
constexpr int SMEM_LIMIT = 232448;
constexpr int CK = 64;                    // channels of a tile row
constexpr int ROW = CK * 2;               // its bytes

// B3b-dx's tiles: TN input channels a block (128 or 160)
template <int TN>
struct Dx {
  static constexpr int TH = 8, TW = 16, TM = TH * TW;  // pixels (M)
  static constexpr int NS = 4;                          // ring stages
  static constexpr int A_BYTES = TM * ROW;
  static constexpr int B_BYTES = TN * ROW;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = NS * STAGE;
  static constexpr int PITCH = TN + 4;  // f32 partial row pitch
  static constexpr int PART_BYTES = TM * PITCH * 4;
  static constexpr int SMEM =
      (RING > PART_BYTES ? RING : PART_BYTES) + 1024;
  static_assert(SMEM <= SMEM_LIMIT, "B3b-dx's tiles exceed shared memory");
  static_assert(STAGE % 1024 == 0 && A_BYTES % 1024 == 0,
                "tiles start on swizzle atoms");
};

namespace dw {
constexpr int PH = 4, PW = 16, TK = PH * PW;  // positions a stage (K)
constexpr int TMO = 128;                       // output channels (M)
constexpr int TNI = 64;                        // input channels (N)
constexpr int NS = 4;
constexpr int DY_BYTES = 2 * TK * ROW;         // two 64-channel blocks
constexpr int H_BYTES = TK * ROW;              // h at one shift
constexpr int STAGE = DY_BYTES + 4 * H_BYTES;
constexpr int RING = NS * STAGE;
constexpr int PP = TNI + 4;                    // f32 partial row pitch
constexpr int PART_FLOATS = 4 * TMO * PP;      // [jk][co][ci]
constexpr int ROWS_OUT = TMO / 4;              // output channels a block folds
constexpr int TAP_FLOATS = ROWS_OUT * TNI * 9; // [co][ci][9]
constexpr int DB_FLOATS = 3 * TMO;             // two halves, their sum
constexpr int EPI = (PART_FLOATS + TAP_FLOATS + DB_FLOATS) * 4;
constexpr int SMEM = (RING > EPI ? RING : EPI) + 1024;
static_assert(SMEM <= SMEM_LIMIT, "B3b-dw's tiles exceed shared memory");
}  // namespace dw

// The 2x2 index j of B3's parity split that holds tap ky of the 3x3
// kernel at output parity py (ops/conv3x3.py::_GROUPS).
__device__ __forceinline__ int group_of(int py, int ky) {
  return py == 0 ? (ky == 0 ? 0 : 1) : (ky == 2 ? 1 : 0);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a warpgroup's accumulator into rows m and m + 8 of an f32 tile of
// `pitch` floats a row: a[4j + e] is row m (e < 2) or m + 8, column
// 8j + 2 t4 + (e & 1)
template <int N>
__device__ __forceinline__ void stage_acc(float* tile, int pitch,
                                          const float (&a)[N], int m,
                                          int t4) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int c = j * 8 + t4 * 2;
    *reinterpret_cast<float2*>(tile + m * pitch + c) =
        make_float2(a[4 * j + 0], a[4 * j + 1]);
    *reinterpret_cast<float2*>(tile + (m + 8) * pitch + c) =
        make_float2(a[4 * j + 2], a[4 * j + 3]);
  }
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// W4 [16, Ci, Co] bf16 from W [Co, Ci, 3, 3] (bf16 or f32): the fold of
// ops/conv3x3.py::bwd_dx_weights in its order (f32 sums over ky, then over
// kx, each in increasing tap order; one rounding), so its bits. A block
// takes 32 output x 32 input channels: their 9 taps read as whole rows
// (co, ci0 .. ci0 + 31, 9 contiguous) into shared memory, then one thread
// a (co, ci) writes its 16 values, 32 consecutive co a warp.
template <typename T>
__global__ void __launch_bounds__(256)
    fold_kernel(const T* __restrict__ w, bf16* __restrict__ w4, int Ci,
                int Co) {
  constexpr int FT = 32, ROWF = FT * 9;
  __shared__ float s[FT][ROWF + 1];
  const int co0 = blockIdx.y * FT, ci0 = blockIdx.x * FT;
  for (int i = threadIdx.x; i < FT * ROWF; i += 256) {
    const int r = i / ROWF, e = i % ROWF;
    const bool ok = co0 + r < Co && ci0 + e / 9 < Ci;
    s[r][e] = ok ? to_f32(w[((long long)(co0 + r) * Ci + ci0) * 9 + e]) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < FT * FT; i += 256) {
    const int c = i % FT, k = i / FT;
    if (co0 + c >= Co || ci0 + k >= Ci) continue;
    const float* v = &s[c][k * 9];  // v[3 ky + kx]
    float r[4][3];                  // over ky: the rows of _FOLD
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      r[0][x] = v[6 + x];
      r[1][x] = v[3 + x] + v[6 + x];
      r[2][x] = v[x] + v[3 + x];
      r[3][x] = v[x];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float q[4] = {r[u][2], r[u][1] + r[u][2], r[u][0] + r[u][1],
                          r[u][0]};
#pragma unroll
      for (int vv = 0; vv < 4; ++vv)
        w4[((long long)(u * 4 + vv) * Ci + ci0 + k) * Co + co0 + c] =
            __float2bfloat16_rn(q[vv]);
    }
  }
}

// dh: grid (tiles * split, ceil(Ci / TN)), clusters of `split` blocks
// along x; block x takes pixel tile x / split and k slices
// [r n / split, (r + 1) n / split) of the n = 16 Co / 64, r its rank
template <int TN>
__global__ void __launch_bounds__(NTHREADS, 1)
    dx_kernel(const __grid_constant__ CUtensorMap map_dy,
              const __grid_constant__ CUtensorMap map_w,
              bf16* __restrict__ dh, int H, int W, int Ci, int Co,
              int tiles_x, int tiles_y, int split) {
  using C = Dx<TN>;
  constexpr int NS = C::NS, TH = C::TH, TW = C::TW, TM = C::TM;
  constexpr int STAGE = C::STAGE, A_BYTES = C::A_BYTES, PITCH = C::PITCH;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * NS];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* sp = smem_raw + (sbase - raw);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + NS * 8;

  const int tid = threadIdx.x;
  const int rank = (int)sdt_cluster::rank();
  int tile = blockIdx.x / split;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  const int img = tile / tiles_y;
  const int y0 = ty * TH, x0 = tx * TW, ci0 = blockIdx.y * TN;
  const int nch = Co / CK, nsl = 16 * nch;
  const int s0 = rank * nsl / split, n = (rank + 1) * nsl / split - s0;

  if (tid == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(full0 + st * 8, 1);
      mbar_init(empty0 + st * 8, NCONSUMER / 32);  // one arrive a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  if (tid >= NCONSUMER) {
    // producer: slice s0 + t = (tap, chunk), tap = 4 (u + 1) + v + 1
    if (tid == NCONSUMER) {
      for (int t = 0; t < n; ++t) {
        const int st = t % NS;
        if (t >= NS) mbar_wait(empty0 + st * 8, ((t / NS) - 1) & 1);
        const uint32_t fb = full0 + st * 8;
        const uint32_t a = sbase + st * STAGE;
        const int sl = s0 + t, tap = sl / nch, c0 = (sl - tap * nch) * CK;
        const int u2 = tap / 4 + 1, v2 = tap % 4 + 1;  // u + 2, v + 2
        mbar_expect_tx(fb, STAGE);
        // dy[img, 2 (y0 + i) + u, 2 (x0 + j) + v, c0 ..] as [B, H, 2, W,
        // 2 Co]: (i + floor(u/2), u mod 2), (j + floor(v/2), (v mod 2) Co)
        tma_load_5d(a, &map_dy, fb, (v2 & 1) * Co + c0, x0 + (v2 >> 1) - 1,
                    u2 & 1, y0 + (u2 >> 1) - 1, img);
        tma_load_3d(a + A_BYTES, &map_w, fb, c0, ci0, tap);
      }
    }
  } else {
    for (int t = 0; t < n; ++t) {
      const int st = t % NS;
      mbar_wait(full0 + st * 8, (t / NS) & 1);  // slice t landed
      const uint32_t a = sbase + st * STAGE + wg * 64 * ROW;
      const uint32_t b = sbase + st * STAGE + A_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_sw128(a + kk * 32, 16, 1024);
        const uint64_t db = desc_sw128(b + kk * 32, 16, 1024);
        if constexpr (TN == 128) wgmma_ss_m64n128k16(acc, da, db, 1);
        if constexpr (TN == 160) wgmma_ss_m64n160k16(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // slice t - 1's products are done
      fence_regs(acc);
      if (t > 0 && lane == 0) mbar_arrive(empty0 + ((t - 1) % NS) * 8);
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }
  // every product is done and every copy landed: the ring becomes the f32
  // partial [pixel][ci]
  __syncthreads();
  float* part = reinterpret_cast<float*>(sp);
  if (tid < NCONSUMER)
    stage_acc(part, PITCH, acc, wg * 64 + warp * 16 + (lane >> 2), lane & 3);
  sdt_cluster::sync();  // every block's partial is written
  // pixels rank, rank + split, ...: the cluster's partials in rank order,
  // one bf16 rounding, 16 bytes a store
  const int mine = (TM - rank + split - 1) / split;
  for (int i = tid; i < mine * (TN / 8); i += NTHREADS) {
    const int m = rank + split * (i / (TN / 8)), q = i % (TN / 8);
    const int y = y0 + m / TW, x = x0 + m % TW, ci = ci0 + q * 8;
    if (y >= H || x >= W || ci >= Ci) continue;
    const float* src = part + m * PITCH + q * 8;
    float4 lo = sdt_cluster::ld_peer_v4(src, 0);
    float4 hi = sdt_cluster::ld_peer_v4(src + 4, 0);
    for (int p = 1; p < split; ++p) {
      add4(lo, sdt_cluster::ld_peer_v4(src, (uint32_t)p));
      add4(hi, sdt_cluster::ld_peer_v4(src + 4, (uint32_t)p));
    }
    const uint4 ov = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                                pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
    *reinterpret_cast<uint4*>(
        dh + (((long long)img * H + y) * W + x) * Ci + ci) = ov;
  }
  sdt_cluster::sync();  // the peers have read this block's partial
}

// dW, db: grid (4 * Ci / TNI, ceil(Co / TMO)), clusters of the four
// parities along x (rank = 2 py + px); blockIdx.x / 4 is the input tile
__global__ void __launch_bounds__(NTHREADS, 1)
    dw_kernel(const __grid_constant__ CUtensorMap map_dy,
              const __grid_constant__ CUtensorMap map_h,
              float* __restrict__ dwt, float* __restrict__ db, int B, int H,
              int W, int Ci, int Co, int tiles_x, int tiles_y) {
  using namespace dw;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * NS];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  unsigned char* sp = smem_raw + (sbase - raw);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + NS * 8;

  const int tid = threadIdx.x;
  const int par = (int)sdt_cluster::rank();
  const int py = par >> 1, px = par & 1;
  const int ci0 = (blockIdx.x >> 2) * TNI, co0 = blockIdx.y * TMO;
  const bool with_db = blockIdx.x < 4;  // the cluster of input tile 0
  const int nst = B * tiles_y * tiles_x;

  if (tid == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(full0 + st * 8, 1);
      mbar_init(empty0 + st * 8, NCONSUMER / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int col = tid & (TMO - 1), half = tid / TMO;  // db: channel, rows
  float acc0[32], acc1[32], acc2[32], acc3[32];  // (j, k) = 2 j + k
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = acc2[i] = acc3[i] = 0.f;
  float dbs = 0.f;
  if (tid >= NCONSUMER) {
    if (tid == NCONSUMER) {
      for (int t = 0; t < nst; ++t) {
        const int st = t % NS;
        if (t >= NS) mbar_wait(empty0 + st * 8, ((t / NS) - 1) & 1);
        const uint32_t fb = full0 + st * 8;
        const uint32_t a = sbase + st * STAGE, hs = a + DY_BYTES;
        int r = t;
        const int x0 = (r % tiles_x) * PW;
        r /= tiles_x;
        const int y0 = (r % tiles_y) * PH, b = r / tiles_y;
        mbar_expect_tx(fb, STAGE);
        // dy[b, 2 (y0 + i) + py, 2 (x0 + j) + px, co0 ..] as [B, H, 2, W,
        // 2 Co], 64 output channels a box
        tma_load_5d(a, &map_dy, fb, px * Co + co0, x0, py, y0, b);
        tma_load_5d(a + TK * ROW, &map_dy, fb, px * Co + co0 + CK, x0, py,
                    y0, b);
        // h[b, y0 + i + py + j - 1, x0 + jj + px + k - 1, ci0 ..]
        for (int jk = 0; jk < 4; ++jk)
          tma_load_4d(hs + jk * H_BYTES, &map_h, fb, ci0,
                      x0 + px + (jk & 1) - 1, y0 + py + (jk >> 1) - 1, b);
      }
    }
  } else {
    for (int t = 0; t < nst; ++t) {
      const int st = t % NS;
      mbar_wait(full0 + st * 8, (t / NS) & 1);
      const uint32_t a = sbase + st * STAGE + wg * TK * ROW;
      const uint32_t hs = sbase + st * STAGE + DY_BYTES;
      fence_regs(acc0);
      fence_regs(acc1);
      fence_regs(acc2);
      fence_regs(acc3);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // 16 positions a step: rows kk * 16 .. of both tiles
        const uint32_t hk = hs + kk * 2048;
        const uint64_t h0 = desc_sw128(hk, H_BYTES, 1024);
        const uint64_t h1 = desc_sw128(hk + H_BYTES, H_BYTES, 1024);
        const uint64_t h2 = desc_sw128(hk + 2 * H_BYTES, H_BYTES, 1024);
        const uint64_t h3 = desc_sw128(hk + 3 * H_BYTES, H_BYTES, 1024);
        const uint64_t da = desc_sw128(a + kk * 2048, TK * ROW, 1024);
        wgmma_ss_m64n64k16_mn(acc0, da, h0, 1);
        wgmma_ss_m64n64k16_mn(acc1, da, h1, 1);
        wgmma_ss_m64n64k16_mn(acc2, da, h2, 1);
        wgmma_ss_m64n64k16_mn(acc3, da, h3, 1);
      }
      wgmma_commit();
      if (with_db) {
        // channel `col` of the stage's dy tile, rows half * 32 .. + 31
        const unsigned char* blk =
            sp + (st * STAGE + (col >> 6) * TK * ROW);
        const int qc = (col & 63) >> 3, e = col & 7;
        for (int r = half * 32; r < half * 32 + 32; ++r)
          dbs += __bfloat162float(
              *reinterpret_cast<const bf16*>(blk + swz(r, qc) + e * 2));
      }
      wgmma_wait<1>();  // stage t - 1's products are done
      fence_regs(acc0);
      fence_regs(acc1);
      fence_regs(acc2);
      fence_regs(acc3);
      if (t > 0 && lane == 0) mbar_arrive(empty0 + ((t - 1) % NS) * 8);
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    fence_regs(acc2);
    fence_regs(acc3);
  }
  __syncthreads();  // the ring becomes the partials
  float* part = reinterpret_cast<float*>(sp);  // [jk][co][ci], PP a row
  float* taps = part + PART_FLOATS;            // [co][ci][9]
  float* dbp = taps + TAP_FLOATS;              // [2][TMO], then the sum
  if (tid < NCONSUMER) {
    // acc[4j + e]: output channel row g (e < 2) or g + 8 of the warp's
    // 16, input channel 8j + 2 t4 + (e & 1)
    const int m = wg * 64 + warp * 16 + (lane >> 2), t4 = lane & 3;
    stage_acc(part, PP, acc0, m, t4);
    stage_acc(part + TMO * PP, PP, acc1, m, t4);
    stage_acc(part + 2 * TMO * PP, PP, acc2, m, t4);
    stage_acc(part + 3 * TMO * PP, PP, acc3, m, t4);
    if (with_db) dbp[half * TMO + col] = dbs;
  }
  __syncthreads();
  if (with_db && tid < TMO) dbp[2 * TMO + tid] = dbp[tid] + dbp[TMO + tid];
  sdt_cluster::sync();  // every parity's partials are written

  // output channels par * ROWS_OUT .. + ROWS_OUT - 1, four input channels
  // a unit: the 16 partials, then each tap over the peers in rank order
  const int rowc = par * ROWS_OUT;
  for (int i = tid; i < ROWS_OUT * (TNI / 4); i += NTHREADS) {
    const int row = i / (TNI / 4), c4 = (i % (TNI / 4)) * 4;
    float4 v[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int jk = 0; jk < 4; ++jk)
        v[p][jk] = sdt_cluster::ld_peer_v4(
            part + (jk * TMO + rowc + row) * PP + c4, (uint32_t)p);
    float* out = taps + (row * TNI + c4) * 9;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float4 s = v[0][2 * group_of(0, ky) + group_of(0, kx)];
        add4(s, v[1][2 * group_of(0, ky) + group_of(1, kx)]);
        add4(s, v[2][2 * group_of(1, ky) + group_of(0, kx)]);
        add4(s, v[3][2 * group_of(1, ky) + group_of(1, kx)]);
        const int k = ky * 3 + kx;
        out[k] = s.x;
        out[9 + k] = s.y;
        out[18 + k] = s.z;
        out[27 + k] = s.w;
      }
  }
  if (with_db && tid < ROWS_OUT && co0 + rowc + tid < Co) {
    const float* src = dbp + 2 * TMO + rowc + tid;
    float s = sdt_cluster::ld_peer(src, 0);
    for (int p = 1; p < 4; ++p) s += sdt_cluster::ld_peer(src, (uint32_t)p);
    db[co0 + rowc + tid] = s;
  }
  __syncthreads();
  // whole rows of dW [Co, Ci, 3, 3]: output channel co, input channels
  // ci0 .. ci0 + 63, 9 taps each, contiguous
  for (int i = tid; i < ROWS_OUT * (TNI * 9 / 4); i += NTHREADS) {
    const int row = i / (TNI * 9 / 4), q = i % (TNI * 9 / 4);
    const int co = co0 + rowc + row;
    if (co >= Co) continue;
    reinterpret_cast<float4*>(dwt + ((long long)co * Ci + ci0) * 9)[q] =
        reinterpret_cast<const float4*>(taps + row * TNI * 9)[q];
  }
  sdt_cluster::sync();  // the peers have read this block's partials
}

// dy viewed as [B, H, 2, W, 2 Co] (H, W: h's): boxes of 64 channels x
// bw columns x 1 parity x bh rows
bool make_dy_map(CUtensorMap* map, const void* dy, int B, int H, int W,
                 int Co, int bh, int bw) {
  const cuuint64_t e = 2;  // bytes of a bf16
  const cuuint64_t dims[5] = {(cuuint64_t)2 * Co, (cuuint64_t)W, 2,
                              (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[4] = {2 * Co * e, 2 * (cuuint64_t)W * Co * e,
                                 4 * (cuuint64_t)W * Co * e,
                                 4 * (cuuint64_t)H * W * Co * e};
  const cuuint32_t box[5] = {CK, (cuuint32_t)bw, 1, (cuuint32_t)bh, 1};
  return make_map_bf16(map, dy, 5, dims, strides, box);
}

template <int TN>
int launch_dx(const void* dy, const void* w4, void* dh, int B, int H, int W,
              int Ci, int Co, int split, cudaStream_t stream) {
  using C = Dx<TN>;
  const int tiles_x = (W + C::TW - 1) / C::TW;
  const int tiles_y = (H + C::TH - 1) / C::TH;
  const long long blocks = (long long)B * tiles_x * tiles_y * split;
  if (blocks >= (1LL << 31) || (Ci + TN - 1) / TN > 65535)
    return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap map_dy, map_w;
  const cuuint64_t wdims[3] = {(cuuint64_t)Co, (cuuint64_t)Ci, 16};
  const cuuint64_t wstrides[2] = {(cuuint64_t)Co * 2,
                                  (cuuint64_t)Ci * Co * 2};
  const cuuint32_t wbox[3] = {CK, TN, 1};
  if (!make_dy_map(&map_dy, dy, B, H, W, Co, C::TH, C::TW) ||
      !make_map_bf16(&map_w, w4, 3, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  return (int)sdt_cluster::launch<dx_kernel<TN>>(
      dim3((unsigned)blocks, (Ci + TN - 1) / TN), NTHREADS, split, C::SMEM,
      stream, false, map_dy, map_w, (bf16*)dh, H, W, Ci, Co, tiles_x,
      tiles_y, split);
}

// the clusters of `split` blocks of dx_kernel<TN> that the current device
// holds at once (0 where the query fails), kept per device
template <int TN>
int dx_clusters(int split) {
  static int known[sdt_cluster::MAX_DEVICES][5];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 ||
      dev >= sdt_cluster::MAX_DEVICES || split < 1 || split > 4)
    return 0;
  if (known[dev][split] == 0) {
    if (cudaFuncSetAttribute(dx_kernel<TN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Dx<TN>::SMEM) != cudaSuccess)
      return 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(split, 1, 1);
    cfg.blockDim = dim3(NTHREADS, 1, 1);
    cfg.dynamicSmemBytes = Dx<TN>::SMEM;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = split;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, dx_kernel<TN>, &cfg) !=
            cudaSuccess || n < 1)
      return 0;
    known[dev][split] = n;
  }
  return known[dev][split];
}

// B3b-dx's plan for a shape: the tile width TN (128 or 160 input channels)
// and the split (1..4 blocks a cluster) whose waves times a block's work,
// ceil(tiles / clusters held at once) * TN * ceil(16 Co / 64 / split), is
// least (ties: the smaller TN, then the smaller split). Depends only on
// the shape and the device, so two calls sum in the same order. False
// where no occupancy query succeeded.
bool dx_plan(int B, int H, int W, int Ci, int Co, int* tn, int* split) {
  long long best = -1;
  for (int t = 0; t < 2; ++t) {
    const int TN = t == 0 ? 128 : 160;
    const long long tiles = (long long)B * ((H + Dx<128>::TH - 1) /
                                            Dx<128>::TH) *
                            ((W + Dx<128>::TW - 1) / Dx<128>::TW) *
                            ((Ci + TN - 1) / TN);
    for (int s = 1; s <= 4; ++s) {
      const int held = TN == 128 ? dx_clusters<128>(s) : dx_clusters<160>(s);
      if (held < 1) continue;
      const long long cost = (tiles + held - 1) / held * TN *
                             ((16LL * (Co / CK) + s - 1) / s);
      if (best < 0 || cost < best) {
        best = cost;
        *tn = TN;
        *split = s;
      }
    }
  }
  return best >= 0;
}

}  // namespace

// dy [B, 2H, 2W, Co] and w4 [16, Ci, Co] (ops/conv3x3.py::bwd_dx_weights)
// bf16 contiguous, 16-byte aligned; dh [B, H, W, Ci] bf16, 16-byte
// aligned. Needs Ci % 64 == 0 and Co % 64 == 0. Returns a cudaError_t.
extern "C" int sdt_conv3x3_up_bwd_dx_bf16(const void* dy, const void* w4,
                                          void* dh, int B, int H, int W,
                                          int Ci, int Co, void* stream) {
  const uintptr_t align = (uintptr_t)dy | (uintptr_t)w4 | (uintptr_t)dh;
  if (B < 1 || H < 1 || W < 1 || Ci < CK || Ci % CK || Co < CK || Co % CK ||
      align % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int tn, split;
  if (!dx_plan(B, H, W, Ci, Co, &tn, &split)) {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
  }
  cudaStream_t s = (cudaStream_t)stream;
  return tn == 128 ? launch_dx<128>(dy, w4, dh, B, H, W, Ci, Co, split, s)
                   : launch_dx<160>(dy, w4, dh, B, H, W, Ci, Co, split, s);
}

// w [Co, Ci, 3, 3] (bf16, or f32 where w_f32), contiguous; w4 [16, Ci, Co]
// bf16: B3b-dx's folded weights (ops/conv3x3.py::bwd_dx_weights, bit for
// bit). Returns a cudaError_t.
extern "C" int sdt_conv3x3_up_bwd_fold(const void* w, void* w4, int Ci,
                                       int Co, int w_f32, void* stream) {
  if (Ci < 1 || Co < 1 || (Ci + 31) / 32 > 65535 || (Co + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Ci + 31) / 32, (Co + 31) / 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (w_f32)
    fold_kernel<float><<<grid, 256, 0, s>>>((const float*)w, (bf16*)w4, Ci,
                                            Co);
  else
    fold_kernel<bf16><<<grid, 256, 0, s>>>((const bf16*)w, (bf16*)w4, Ci, Co);
  return (int)cudaGetLastError();
}

// B3b-dx's plan for a shape on the current device: 8 * TN + split (see
// dx_plan), 0 where the occupancy query fails.
extern "C" int sdt_conv3x3_up_bwd_dx_plan(int B, int H, int W, int Ci,
                                          int Co) {
  int tn, split;
  return dx_plan(B, H, W, Ci, Co, &tn, &split) ? 8 * tn + split : 0;
}

// B3b-dx's conv with a given tile width and split (tn 128 or 160, split
// 1..4), and the clusters of a split that the device holds at once: for
// holding the plan's choice against the others (chip_smoke.py).
extern "C" int sdt_conv3x3_up_bwd_dx_tiled(const void* dy, const void* w4,
                                         void* dh, int B, int H, int W,
                                         int Ci, int Co, int tn, int split,
                                         void* stream) {
  if (split < 1 || split > 4 || (tn != 128 && tn != 160) || Ci % CK ||
      Co % CK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return tn == 128 ? launch_dx<128>(dy, w4, dh, B, H, W, Ci, Co, split, s)
                   : launch_dx<160>(dy, w4, dh, B, H, W, Ci, Co, split, s);
}

extern "C" int sdt_conv3x3_up_bwd_dx_clusters(int tn, int split) {
  return tn == 128 ? dx_clusters<128>(split) : dx_clusters<160>(split);
}

// dy [B, 2H, 2W, Co] and h [B, H, W, Ci] bf16 contiguous, 16-byte aligned;
// dw [Co, Ci, 3, 3] and db [Co] f32, 16-byte aligned. Needs Co % 64 == 0
// and Ci % 64 == 0. One launch. Returns a cudaError_t.
extern "C" int sdt_conv3x3_up_bwd_dw_bf16(const void* dy, const void* h,
                                          float* dw, float* db, int B, int H,
                                          int W, int Ci, int Co,
                                          void* stream) {
  using namespace dw;
  const uintptr_t align =
      (uintptr_t)dy | (uintptr_t)h | (uintptr_t)dw | (uintptr_t)db;
  if (B < 1 || H < 1 || W < 1 || Ci < TNI || Ci % TNI || Co < CK ||
      Co % CK || align % 16 != 0 || 4LL * (Ci / TNI) >= (1LL << 31) ||
      (Co + TMO - 1) / TMO > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + PW - 1) / PW, tiles_y = (H + PH - 1) / PH;
  if ((long long)B * tiles_x * tiles_y >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap map_dy, map_h;
  const cuuint64_t hdims[4] = {(cuuint64_t)Ci, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)B};
  const cuuint64_t hstrides[3] = {(cuuint64_t)Ci * 2,
                                  (cuuint64_t)W * Ci * 2,
                                  (cuuint64_t)H * W * Ci * 2};
  const cuuint32_t hbox[4] = {CK, PW, PH, 1};
  if (!make_dy_map(&map_dy, dy, B, H, W, Co, PH, PW) ||
      !make_map_bf16(&map_h, h, 4, hdims, hstrides, hbox))
    return (int)cudaErrorInvalidValue;
  return (int)sdt_cluster::launch<dw_kernel>(
      dim3(4 * (Ci / TNI), (Co + TMO - 1) / TMO), NTHREADS, 4, SMEM,
      (cudaStream_t)stream, false, map_dy, map_h, dw, db, B, H, W, Ci, Co,
      tiles_x, tiles_y);
}
