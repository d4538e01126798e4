// The 3x3 conv core of B4 (conv3x3.cu), B3 (conv3x3_up.cu) and B7
// (conv3x3_up_interleave.cu): an implicit GEMM on Hopper's warpgroup
// tensor-core instructions (wgmma) over NHWC bf16 activations, f32
// accumulation, one bf16 rounding at the end. B7's interleave form
// (up4_kernel, at the end of this file) reuses the core's band, ring and
// epilogue scheme in a kernel of its own, so that B4's and B3's code does
// not move.
//
// Two forms of one kernel (template argument UP):
// - UP = false (B4): out = residual + conv3x3_SAME(act(x * a + b), w) +
//   bias; nine taps, tap (dy, dx) in {0,1,2}^2, K index (3*dy + dx)*Ci + ci
//   of wt [Co, 9*Ci]; the GroupNorm-affine + SiLU prologue and the residual
//   where the caller asks for them.
// - UP = true (B3): out = conv3x3_SAME(nearest_2x(x), w) + bias without the
//   upsampled tensor. Output parity (py, px) = blockIdx.z is a 2x2-tap conv
//   of the half-res x with pre-summed weights; tap (j, k) reads half-res
//   pixel (r + j - 1 + py, c + k - 1 + px), i.e. band offset (j + py,
//   k + px), K index (2*j + k)*Ci + ci of parity p's slice wt[p] of
//   [4, Co, 4*Ci]. Half-res pixel (y, x) is stored at (2y + py, 2x + px) of
//   out [B, 2H, 2W, Co]. No prologue, no residual. Co % 128 == 64 is taken
//   by masking the upper half of the last channel tile (zero weight rows,
//   channels past Co not stored): only off-path shapes have it (every
//   model's upsample has Co % 128 == 0), so it costs no second
//   instantiation.
//
// Design: a block of two warpgroups computes a patch of 8 x 16 output
// pixels (warpgroup w: patch rows 4w..4w+3, warp i of it one row of 16
// pixels) for 128 output channels, so M = 128 pixels and N = 128 of the
// implicit GEMM; two blocks a SM.
//   Halo band: Ci is walked in chunks of 64 channels. Each chunk's raw
//   10 x 18-pixel band of x, origin (y0 - 1, x0 - 1), is copied once with
//   16-byte cp.async copies into one of two band buffers; every tap of
//   either form reads inside it. Band positions outside the image (and
//   channels past Ci) keep the zeros the copies wrote: the SAME padding,
//   and no row of a neighbouring image is read. B4's prologue runs once per
//   band element, in place: x*a and +b each rounded to bf16 (the TPU
//   kernel's bf16 affine), then x/(1+exp(-x)) rounded once; padding comes
//   after it, never act(0*a+b). Chunk c+1's band is copied at chunk c's
//   first tap and (B4) activated in seven parts while chunk c's taps 2..8
//   are on the tensor cores, so only chunk 0's prologue runs alone.
//   Weights: the slice of one (chunk, tap), [128 out channels x 64], is a
//   K-major wgmma B operand in the 128-byte swizzle; slices stream through
//   a ring of four stages, copied two slices ahead. One cp.async group and
//   one block barrier per slice hand the stages (and, at a chunk's first
//   tap, the next band) over.
//   Products: per slice and warpgroup four wgmma m64n128k16 with A from
//   registers. A tap shifts a warp's 16 A rows by dy band rows and dx
//   pixels; a one-pixel shift breaks the 8-row alignment that a
//   shared-memory descriptor's swizzle atoms need, so each warp loads its
//   rows with ldmatrix at the tap's offset and hands them to wgmma as
//   register fragments. Band pixels are 128-byte rows in the XOR swizzle
//   of the tiles (hopper.cuh), so the 8 rows of one 8x8 matrix fall in
//   distinct banks at every shift. A slice's products are waited for
//   before the next slice's ldmatrix: ptxas serializes wgmma whose A
//   registers are written while earlier wgmma are in flight.
//   A chunk holds 64 channels; with Ci % 64 == 32 the last chunk's upper
//   32 channels are zeros in both the band and the weight slice.
//   Epilogue: f32 accumulators staged in shared memory, then + bias (f32)
//   (+ residual, bf16, read as 16-byte vectors), rounded once to bf16, and
//   stored 16 bytes at a time (a pixel's 128 channels are 256 contiguous
//   bytes in either form); pixels outside the image (ragged patches at the
//   right and bottom edges) are not stored.
// Tried and dropped for B4 (PERF.md): a TMA producer warp with mbarriers at
// 8 x 16 and 16 x 16 pixels a block; at 288 or 384 threads a block ptxas
// leaves 96 or 168 registers a thread, and the accumulators then spill.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace sdt_conv {

using namespace sdt_hopper;

constexpr int TH = 8, TW = 16;          // output patch: 8 rows x 16 columns
constexpr int TM = TH * TW;             // 128 pixels
constexpr int TN = 128;                 // output channels per block
constexpr int CK = 64;                  // input channels per chunk
constexpr int BH = TH + 2, BW = TW + 2, BPIX = BH * BW;  // halo band
constexpr int BUNITS = BPIX * (CK / 8);  // 16-byte pieces of a band
constexpr int NPARTS = 7;               // band activated over taps 2..8
constexpr int PART = (BUNITS + NPARTS - 1) / NPARTS;
constexpr int NSTAGE = 4;               // weight-slice ring
constexpr int NTHREADS = 256;
constexpr int SLICE_BYTES = TN * CK * 2;                  // 16 KB
constexpr int RING_BYTES = NSTAGE * SLICE_BYTES;
constexpr int BAND_BYTES = BPIX * CK * 2;                 // 23,040
constexpr int EPI_PITCH = TN + 4;       // f32 staging row pitch
constexpr int EPI_BYTES = TM * EPI_PITCH * 4;
constexpr int MAIN_BYTES = RING_BYTES + 2 * BAND_BYTES;
constexpr int SMEM_BYTES =
    (MAIN_BYTES > EPI_BYTES ? MAIN_BYTES : EPI_BYTES) + 1024;  // + align
// two blocks a SM: each takes SMEM_BYTES and 1 KB for the system of an
// H100 SM's 228 KB
static_assert(2 * (SMEM_BYTES + 1024) <= 233472,
              "two blocks of the conv core exceed an SM's shared memory");

__device__ __forceinline__ float rbf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// act(x * a + b) on 8 bf16 values, rounded as the TPU kernel rounds: x*a
// and +b each rounded to bf16, then the SiLU in f32 (a fast divide; the
// result is rounded to bf16), rounded once
__device__ __forceinline__ uint4 prologue(uint4 xv, uint4 av, uint4 bv,
                                          bool has_pre, bool silu) {
  const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&xv);
  const __nv_bfloat162* as = reinterpret_cast<const __nv_bfloat162*>(&av);
  const __nv_bfloat162* bs = reinterpret_cast<const __nv_bfloat162*>(&bv);
  uint4 out;
  __nv_bfloat162* os = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 v = __bfloat1622float2(xs[i]);
    if (has_pre) {
      const float2 a = __bfloat1622float2(as[i]);
      const float2 b = __bfloat1622float2(bs[i]);
      v.x = rbf16(rbf16(v.x * a.x) + b.x);
      v.y = rbf16(rbf16(v.y * a.y) + b.y);
    }
    if (silu) {
      v.x = __fdividef(v.x, 1.f + __expf(-v.x));
      v.y = __fdividef(v.y, 1.f + __expf(-v.y));
    }
    os[i] = __floats2bfloat162_rn(v.x, v.y);
  }
  return out;
}

// H, W: x's rows and columns (half-res for UP); out [B, H, W, Co], or
// [B, 2H, 2W, Co] for UP
template <bool UP>
__global__ void __launch_bounds__(NTHREADS, 2)
conv_kernel(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ wt,
            const float* __restrict__ bias,
            const __nv_bfloat16* __restrict__ pre_a,
            const __nv_bfloat16* __restrict__ pre_b,
            const __nv_bfloat16* __restrict__ res,
            __nv_bfloat16* __restrict__ out, int H, int W, int Ci, int Co,
            int silu, int tiles_x, int tiles_y) {
  constexpr int NTAPS = UP ? 4 : 9;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* sp = smem_raw + (sbase - raw);
  const uint32_t ring = sbase;
  const uint32_t band0 = sbase + RING_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  const int img = tile / tiles_y;
  const int y0 = ty * TH, x0 = tx * TW;
  const int n0 = blockIdx.y * TN;
  const long long K = (long long)NTAPS * Ci;
  // UP: this block's output parity and its [Co, 4*Ci] weight slice
  const int par_y = UP ? (int)blockIdx.z >> 1 : 0;
  const int par_x = UP ? (int)blockIdx.z & 1 : 0;
  if (UP) wt += (long long)blockIdx.z * Co * K;
  const int nchunks = (Ci + CK - 1) / CK;
  const int nslices = NTAPS * nchunks;
  const bool has_pre = !UP && pre_a != nullptr;
  const bool act = !UP && silu != 0;

  // raw x of chunk `chunk` into band buffer `buf`; zeros outside the image
  // and past Ci
  auto load_band = [&](int chunk, int buf) {
    const int c0 = chunk * CK;
    const uint32_t dst = band0 + buf * BAND_BYTES;
    for (int i = tid; i < BUNITS; i += NTHREADS) {
      const int p = i >> 3, qc = i & 7;
      const int yy = y0 - 1 + p / BW, xx = x0 - 1 + p % BW;
      const int c = c0 + qc * 8;
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W && c < Ci;
      cp_async16(dst + swz(p, qc),
                 ok ? x + (((long long)img * H + yy) * W + xx) * Ci + c : x,
                 ok ? 16 : 0);
    }
  };
  // weight slice `sl` = (chunk, tap) into ring stage `stage`:
  // rows n0..n0+127, columns tap*Ci + chunk*64 .. +63 (zeros past Ci and,
  // for UP, in rows past Co)
  auto load_slice = [&](int sl, int stage) {
    const int chunk = sl / NTAPS, tap = sl - chunk * NTAPS;
    const int qc = tid & 7, c = chunk * CK + qc * 8;
    const bool ok = c < Ci;
    const __nv_bfloat16* src =
        wt + (long long)(n0 + (tid >> 3)) * K + tap * Ci + c;
    const uint32_t dst = ring + stage * SLICE_BYTES;
#pragma unroll
    for (int j = 0; j < TN * (CK / 8) / NTHREADS; ++j) {
      const int n = (tid >> 3) + j * (NTHREADS / 8);
      const bool okn = ok && (!UP || n0 + n < Co);
      cp_async16(dst + swz(n, qc), okn ? src + j * (NTHREADS / 8) * K : wt,
                 okn ? 16 : 0);
    }
  };
  // the prologue on band pieces [u0, u1) of chunk `chunk` in buffer
  // `buf`, once per piece inside the image (in place)
  auto activate = [&](int chunk, int buf, int u0, int u1) {
    const int c0 = chunk * CK;
    unsigned char* bp = sp + RING_BYTES + buf * BAND_BYTES;
    for (int i = u0 + tid; i < u1; i += NTHREADS) {
      const int p = i >> 3, qc = i & 7;
      const int yy = y0 - 1 + p / BW, xx = x0 - 1 + p % BW;
      const int c = c0 + qc * 8;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W && c < Ci) {
        uint4* e = reinterpret_cast<uint4*>(bp + swz(p, qc));
        uint4 av = make_uint4(0u, 0u, 0u, 0u), bv = av;
        if (has_pre) {
          av = *reinterpret_cast<const uint4*>(pre_a + (long long)img * Ci + c);
          bv = *reinterpret_cast<const uint4*>(pre_b + (long long)img * Ci + c);
        }
        *e = prologue(*e, av, bv, has_pre, act);
      }
    }
  };

  // chunk 0's band and the first two slices; chunk 0 is activated alone
  load_band(0, 0);
  load_slice(0, 0);
  cp_async_commit();
  if (1 < nslices) load_slice(1, 1);
  cp_async_commit();
  if (has_pre || act) {
    cp_async_wait<1>();
    __syncthreads();
    activate(0, 0, 0, BUNITS);
  }

  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  const int py = wg * 4 + warp;  // this warp's patch row
  uint32_t a[4][4];

  for (int sl = 0; sl < nslices; ++sl) {
    const int chunk = sl / NTAPS, tap = sl - chunk * NTAPS;
    cp_async_wait<1>();   // slice sl (and from tap 2 the next band) landed
    fence_async_smem();   // copies -> wgmma operand reads
    __syncthreads();      // ... for every thread; stage (sl+2)%4 is free
    if (sl + 2 < nslices) load_slice(sl + 2, (sl + 2) % NSTAGE);
    if (tap == 0 && chunk + 1 < nchunks) load_band(chunk + 1, (chunk + 1) & 1);
    cp_async_commit();

    // the tap's band offset: B4's (dy, dx); B3's (j + py, k + px)
    const int dy = UP ? (tap >> 1) + par_y : tap / 3;
    const int dx = UP ? (tap & 1) + par_x : tap - dy * 3;
    const uint32_t band = band0 + (chunk & 1) * BAND_BYTES;
    // lane l: pixel l % 16 of the warp's row shifted by the tap, channels
    // 8 * (l / 16) .. +7 of each 16-channel step (swizzled band rows)
    const int prow = (py + dy) * BW + dx + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(a[kk], band + swz(prow, kk * 2 + (lane >> 4)));
    const uint32_t wst = ring + (sl % NSTAGE) * SLICE_BYTES;
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_m64n128k16<0>(acc, a[kk], desc_sw128(wst + kk * 32, 16, 1024),
                             1);
    wgmma_commit();
    // while the products run: a seventh of the next chunk's band
    if (tap >= 2 && chunk + 1 < nchunks && (has_pre || act)) {
      const int u0 = (tap - 2) * PART;
      activate(chunk + 1, (chunk + 1) & 1, u0, min(u0 + PART, BUNITS));
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
  }
  cp_async_wait<0>();
  __syncthreads();  // ring and bands no longer read: reuse for the staging

  // acc[4j + e]: pixel row g (e < 2) or g + 8 of the warp's 16, channel
  // 8j + 2*t4 + (e & 1)
  float* stg = reinterpret_cast<float*>(sp);
  const int m0 = wg * 64 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int c = j * 8 + t4 * 2;
    *reinterpret_cast<float2*>(stg + m0 * EPI_PITCH + c) =
        make_float2(acc[4 * j + 0], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(stg + (m0 + 8) * EPI_PITCH + c) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  for (int i = tid; i < TM * (TN / 8); i += NTHREADS) {
    const int m = i / (TN / 8), qc = i % (TN / 8);
    const int yy = y0 + m / TW, xx = x0 + m % TW;
    if (yy >= H || xx >= W) continue;
    const int n = n0 + qc * 8;
    if (UP && n >= Co) continue;
    const float4 s0 =
        *reinterpret_cast<const float4*>(stg + m * EPI_PITCH + qc * 8);
    const float4 s1 =
        *reinterpret_cast<const float4*>(stg + m * EPI_PITCH + qc * 8 + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bias + n);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + n + 4);
    float v[8] = {s0.x + b0.x, s0.y + b0.y, s0.z + b0.z, s0.w + b0.w,
                  s1.x + b1.x, s1.y + b1.y, s1.z + b1.z, s1.w + b1.w};
    const long long off =
        UP ? (((long long)img * 2 * H + 2 * yy + par_y) * 2 * W + 2 * xx +
              par_x) * Co + n
           : (((long long)img * H + yy) * W + xx) * Co + n;
    if (!UP && res != nullptr) {
      const uint4 rv = *reinterpret_cast<const uint4*>(res + off);
      const __nv_bfloat162* rs = reinterpret_cast<const __nv_bfloat162*>(&rv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 r = __bfloat1622float2(rs[e]);
        v[2 * e] += r.x;
        v[2 * e + 1] += r.y;
      }
    }
    uint4 ov;
    __nv_bfloat162* os = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      os[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(out + off) = ov;
  }
}

// launch the form UP over x [B, H, W, Ci]: grid (patches, Co tiles) for
// B4, (patches, Co tiles, 4 parities) for B3. The caller has checked the
// contract; returns a cudaError_t.
template <bool UP>
inline int launch(const void* x, const void* wt, const float* bias,
                  const void* pre_a, const void* pre_b, const void* res,
                  void* out, int B, int H, int W, int Ci, int Co, int silu,
                  void* stream) {
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long tiles = (long long)B * tiles_x * tiles_y;
  if (tiles >= (1LL << 31) || (long long)B * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      conv_kernel<UP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)tiles, (Co + TN - 1) / TN, UP ? 4 : 1);
  conv_kernel<UP><<<grid, NTHREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wt), bias,
      static_cast<const __nv_bfloat16*>(pre_a),
      static_cast<const __nv_bfloat16*>(pre_b),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), H, W, Ci, Co, silu, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

// ---- the interleave form (B7, conv3x3_up_interleave.cu) ----
// out = conv3x3_SAME(nearest_2x(x), w) + bias as B3 computes it, but one
// block owns a half-res patch and all four output parities of it, so the
// patch's halo band is copied once per chunk for all 16 (parity, tap)
// products, and each half-res pixel's full-res 2x2 quad leaves the block
// together. A block of two warpgroups takes a patch of 4 x 16 half-res
// pixels (warp i of a warpgroup: patch row i) and 64 output channels:
// warpgroup w computes the parities (py = w, px = 0 and 1) as two m64n64
// accumulators (64 floats a thread, as B3's one m64n128), so the core's
// two blocks a SM and its 128 registers a thread hold.
//   Chunks of 64 input channels as B3; each chunk's 6 x 18-pixel band
//   (origin (y0 - 1, x0 - 1), zeros outside the image) is copied once with
//   cp.async into one of two band buffers. A ring stage (the core's 16 KB
//   slice) holds, for one (px, j, k), the [64 x 64] weight slices of
//   parities (0, px) and (1, px) one above the other, so warpgroup w reads
//   the half at w * 64 rows; 8 stages a chunk (px major), copied two
//   ahead. Warp i of warpgroup w reads its A rows at band offset
//   (i + j + w, k + px) with ldmatrix and issues four wgmma m64n64k16 into
//   the accumulator of px. Each half of a chunk's stages has its own code,
//   bound to one accumulator: a branch between the two made ptxas
//   serialize the wgmma (C7520).
//   Epilogue: the accumulators staged in f32 as the 8 x 32 full-res tile
//   (half-res pixel (y, x) of parity (py, px) at (2y + py, 2x + px)), then
//   + bias, one bf16 rounding, 16-byte stores; pixels outside the image
//   are not stored.
namespace up4 {
constexpr int PH = 4, PW = 16;               // half-res patch
constexpr int TN4 = 64;                      // output channels a block
constexpr int SLICES = 8;                    // ring stages a chunk
constexpr int BW4 = PW + 2, BPIX4 = (PH + 2) * BW4;  // 6 x 18 band
constexpr int BUNITS4 = BPIX4 * (CK / 8);
constexpr int BAND4_BYTES = BPIX4 * CK * 2;  // 13,824
constexpr int OUT_H = 2 * PH, OUT_W = 2 * PW;  // 8 x 32 full-res pixels
constexpr int EPI4_PITCH = TN4 + 4;
constexpr int EPI4_BYTES = OUT_H * OUT_W * EPI4_PITCH * 4;
constexpr int MAIN4_BYTES = RING_BYTES + 2 * BAND4_BYTES;
constexpr int SMEM4_BYTES =
    (MAIN4_BYTES > EPI4_BYTES ? MAIN4_BYTES : EPI4_BYTES) + 1024;
static_assert(2 * (SMEM4_BYTES + 1024) <= 233472,
              "two blocks of the interleave form exceed an SM's shared "
              "memory");
}  // namespace up4

// H, W: x's (half-res) rows and columns; wt [4, Co, 4*Ci] (parity p = 2*py
// + px, K index (2*j + k)*Ci + ci); out [B, 2H, 2W, Co]; Co % CT == 0 (CT:
// the output channels a block). A template (CT = up4::TN4 only) so that it
// is compiled only where it is launched, never into B4's or B3's library.
template <int CT>
__global__ void __launch_bounds__(NTHREADS, 2)
up4_kernel(const __nv_bfloat16* __restrict__ x,
           const __nv_bfloat16* __restrict__ wt,
           const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
           int H, int W, int Ci, int Co, int tiles_x, int tiles_y) {
  using namespace up4;
  static_assert(CT == TN4, "the products are m64n64");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* sp = smem_raw + (sbase - raw);
  const uint32_t ring = sbase;
  const uint32_t band0 = sbase + RING_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  const int img = tile / tiles_y;
  const int y0 = ty * PH, x0 = tx * PW;
  const int n0 = blockIdx.y * CT;
  const long long K = 4LL * Ci;
  const int nchunks = (Ci + CK - 1) / CK;
  const int nslices = SLICES * nchunks;

  // raw x of chunk `chunk` into band buffer `buf`; zeros outside the image
  // and past Ci
  auto load_band = [&](int chunk, int buf) {
    const int c0 = chunk * CK;
    const uint32_t dst = band0 + buf * BAND4_BYTES;
    for (int i = tid; i < BUNITS4; i += NTHREADS) {
      const int p = i >> 3, qc = i & 7;
      const int yy = y0 - 1 + p / BW4, xx = x0 - 1 + p % BW4;
      const int c = c0 + qc * 8;
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W && c < Ci;
      cp_async16(dst + swz(p, qc),
                 ok ? x + (((long long)img * H + yy) * W + xx) * Ci + c : x,
                 ok ? 16 : 0);
    }
  };
  // stage `sl` = (chunk, px, tap) into ring stage `stage`: rows 0..63 the
  // slice of parity (0, px), rows 64..127 that of (1, px), channels
  // n0..n0+63, columns tap*Ci + chunk*64 .. +63 (zeros past Ci)
  auto load_slice = [&](int sl, int stage) {
    const int chunk = sl / SLICES, r = sl - chunk * SLICES;
    const int px = r >> 2, tap = r & 3;
    const int qc = tid & 7, c = chunk * CK + qc * 8;
    const bool ok = c < Ci;
    const uint32_t dst = ring + stage * SLICE_BYTES;
#pragma unroll
    for (int j = 0; j < 2 * CT * (CK / 8) / NTHREADS; ++j) {
      const int n = (tid >> 3) + j * (NTHREADS / 8);
      const int par = 2 * (n / CT) + px;
      const __nv_bfloat16* src =
          wt + ((long long)par * Co + n0 + n % CT) * K + tap * Ci + c;
      cp_async16(dst + swz(n, qc), ok ? src : wt, ok ? 16 : 0);
    }
  };

  load_band(0, 0);
  load_slice(0, 0);
  cp_async_commit();
  if (1 < nslices) load_slice(1, 1);
  cp_async_commit();

  float acc0[CT / 2], acc1[CT / 2];  // px = 0, px = 1
#pragma unroll
  for (int i = 0; i < CT / 2; ++i) acc0[i] = acc1[i] = 0.f;
  uint32_t a[4][4];

  // stage sl = (chunk, px, tap) into acc, the accumulator of px
  auto step = [&](int sl, int chunk, int tap, int px, float(&acc)[CT / 2]) {
    cp_async_wait<1>();   // stage sl (and from its third the next band)
    fence_async_smem();   // copies -> wgmma operand reads
    __syncthreads();      // ... for every thread; stage (sl+2)%4 is free
    if (sl + 2 < nslices) load_slice(sl + 2, (sl + 2) % NSTAGE);
    if (px == 0 && tap == 0 && chunk + 1 < nchunks)
      load_band(chunk + 1, (chunk + 1) & 1);
    cp_async_commit();

    // band offset (j + py, k + px), py = wg; lane l: pixel l % 16 of the
    // warp's patch row, channels 8 * (l / 16) .. +7 of each 16-channel step
    const int dy = (tap >> 1) + wg, dx = (tap & 1) + px;
    const uint32_t band = band0 + (chunk & 1) * BAND4_BYTES;
    const int prow = (warp + dy) * BW4 + dx + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(a[kk], band + swz(prow, kk * 2 + (lane >> 4)));
    const uint32_t wst = ring + (sl % NSTAGE) * SLICE_BYTES + wg * CT * 128;
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_m64n64k16<0>(acc, a[kk], desc_sw128(wst + kk * 32, 16, 1024),
                            1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
  };
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    const int sl0 = chunk * SLICES;
#pragma unroll 1
    for (int tap = 0; tap < 4; ++tap) step(sl0 + tap, chunk, tap, 0, acc0);
#pragma unroll 1
    for (int tap = 0; tap < 4; ++tap) step(sl0 + 4 + tap, chunk, tap, 1, acc1);
  }
  cp_async_wait<0>();
  __syncthreads();  // ring and bands no longer read: reuse for the staging

  // acc_px[4j + e]: pixel column g (e < 2) or g + 8 of the warp's patch
  // row, channel 8j + 2*t4 + (e & 1); full-res row 2*warp + wg, column
  // 2 * pixel + px of the staged tile
  float* stg = reinterpret_cast<float*>(sp);
  const int fr = 2 * warp + wg;
#pragma unroll
  for (int j = 0; j < CT / 8; ++j) {
    const int c = j * 8 + t4 * 2;
    float* r0 = stg + (fr * OUT_W + 2 * g) * EPI4_PITCH + c;
    float* r1 = stg + (fr * OUT_W + 2 * (g + 8)) * EPI4_PITCH + c;
    *reinterpret_cast<float2*>(r0) = make_float2(acc0[4 * j], acc0[4 * j + 1]);
    *reinterpret_cast<float2*>(r1) =
        make_float2(acc0[4 * j + 2], acc0[4 * j + 3]);
    *reinterpret_cast<float2*>(r0 + EPI4_PITCH) =
        make_float2(acc1[4 * j], acc1[4 * j + 1]);
    *reinterpret_cast<float2*>(r1 + EPI4_PITCH) =
        make_float2(acc1[4 * j + 2], acc1[4 * j + 3]);
  }
  __syncthreads();
  const int H2 = 2 * H, W2 = 2 * W;
  for (int i = tid; i < OUT_H * OUT_W * (CT / 8); i += NTHREADS) {
    const int m = i / (CT / 8), qc = i % (CT / 8);
    const int yy = 2 * y0 + m / OUT_W, xx = 2 * x0 + m % OUT_W;
    if (yy >= H2 || xx >= W2) continue;
    const int n = n0 + qc * 8;
    const float4 s0 =
        *reinterpret_cast<const float4*>(stg + m * EPI4_PITCH + qc * 8);
    const float4 s1 =
        *reinterpret_cast<const float4*>(stg + m * EPI4_PITCH + qc * 8 + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bias + n);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + n + 4);
    uint4 ov;
    __nv_bfloat162* os = reinterpret_cast<__nv_bfloat162*>(&ov);
    os[0] = __floats2bfloat162_rn(s0.x + b0.x, s0.y + b0.y);
    os[1] = __floats2bfloat162_rn(s0.z + b0.z, s0.w + b0.w);
    os[2] = __floats2bfloat162_rn(s1.x + b1.x, s1.y + b1.y);
    os[3] = __floats2bfloat162_rn(s1.z + b1.z, s1.w + b1.w);
    *reinterpret_cast<uint4*>(
        out + (((long long)img * H2 + yy) * W2 + xx) * Co + n) = ov;
  }
}

}  // namespace sdt_conv
