// conv3x3_SAME(nearest_2x_upsample(h), w) + bias for NHWC bf16 h, all four
// output parities of a tile from one staged half-resolution band, written
// interleaved.
//
// Replaces: safe_denoiser_tpu/ops/conv3x3.py::_up_kernel (conv3x3_up with
// form="interleave", via vae.Upsample under SDT_UP_FORM=interleave): the
// VAE decoder's three upsample convs.
//
// Bound on an H100: operations, as the planar kernel (conv3x3_up.cu): each
// output parity (py, px) is a 2x2-tap conv of the half-res input with
// pre-summed weights, 2 * B*H2*W2 * Co * 4*Ci * 4 FLOP (137 GFLOP, 0.139 ms
// at 989 TFLOP/s, at [4,64,64,512]; 550 GFLOP at [4,128,128,512] and at
// [4,256,256,256]).
//
// Design: what sets the interleave form apart is that one block owns a
// half-res tile and all four parities of it. A block of 8 warps takes a
// tile of 4 x 16 half-res pixels and 64 output channels. Per K step of 32
// input channels it stages the tile's halo band, 6 x 18 pixels x 32
// channels, once in shared memory (zeros outside the image: the SAME
// padding), and the 16 (parity, tap) weight slices [64 Co x 32 Ci] beside
// it; warp w computes parity w/2 for half-res rows 2*(w%2) .. +1 (two m16
// tiles of 16 pixels) against all 64 channels with mma.sync m16n8k16 (bf16
// in, f32 accumulate), its A rows read straight from the band at the
// tap's offset. The planar kernel gathers each pixel's input once per
// (parity, tap), 16 times; here a band pixel is read from global memory
// once per block (108 of them for 64 pixels). The epilogue adds the bias,
// rounds to bf16 and stages the 8 x 32 full-res output tile in shared
// memory, so each output pixel's 64 channels leave as eight 16-byte
// stores, the 2x2 quad of every half-res pixel together. Weights arrive as
// conv3x3_up.cu's [4 parities, Co, 4*Ci] (K index (2*j + k)*Ci + ci).
// Not yet done (later work): cp.async / TMA double buffering and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH2 = 4, TW2 = 16;          // half-res pixel tile
constexpr int BH = TH2 + 2, BW = TW2 + 2;  // its halo band
constexpr int TN = 64, TK = 32, NTHREADS = 256;
constexpr int LDS = TK + 8;                // smem row pitch (bf16)
constexpr int OUT_PX = 4 * TH2 * TW2;      // full-res pixels of a tile
constexpr int LDO = TN + 8;                // output staging pitch (bf16)
constexpr int W_ELEMS = 16 * TN * LDS;     // (parity, tap) weight slices
constexpr int BAND_ELEMS = BH * BW * LDS;
constexpr size_t SMEM_BYTES = (size_t)(W_ELEMS + BAND_ELEMS) * 2;
static_assert(OUT_PX * LDO <= W_ELEMS, "output tile reuses the weights");

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
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

__global__ void __launch_bounds__(NTHREADS, 2)
up_interleave_kernel(const __nv_bfloat16* __restrict__ h,
                     const __nv_bfloat16* __restrict__ wt,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int B, int H2, int W2,
                     int Ci, int Co) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* Ws = smem;                 // [16][TN][LDS]
  __nv_bfloat16* Band = smem + W_ELEMS;     // [BH*BW][LDS]

  const int tiles_w = (W2 + TW2 - 1) / TW2;
  const int tiles_h = (H2 + TH2 - 1) / TH2;
  int t = blockIdx.x;
  const int tw = t % tiles_w;
  t /= tiles_w;
  const int th = t % tiles_h;
  const int b = t / tiles_h;
  const int r0 = th * TH2, c0 = tw * TW2, n0 = blockIdx.y * TN;
  const int K = 4 * Ci;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int parity = warp >> 1, py = parity >> 1, px = parity & 1;
  const int rw = (warp & 1) * 2;            // the warp's first tile row

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  const __nv_bfloat16* hb = h + (size_t)b * H2 * W2 * Ci;
  for (int ci0 = 0; ci0 < Ci; ci0 += TK) {
    // the halo band: BH x BW pixels x TK channels, 16 bytes a thread
    for (int idx = threadIdx.x; idx < BH * BW * (TK / 8); idx += NTHREADS) {
      const int pos = idx / (TK / 8), q = idx % (TK / 8);
      const int y = r0 - 1 + pos / BW, x = c0 - 1 + pos % BW;
      uint4 v = zero4;
      if (y >= 0 && y < H2 && x >= 0 && x < W2)
        v = *reinterpret_cast<const uint4*>(
            hb + ((size_t)y * W2 + x) * Ci + ci0 + q * 8);
      *reinterpret_cast<uint4*>(Band + pos * LDS + q * 8) = v;
    }
    // the 16 (parity, tap) weight slices: rows n0..n0+63, K-contiguous
    for (int idx = threadIdx.x; idx < 16 * TN * (TK / 8); idx += NTHREADS) {
      const int pt = idx / (TN * (TK / 8)), rem = idx % (TN * (TK / 8));
      const int n = rem / (TK / 8), q = rem % (TK / 8);
      const int p = pt >> 2, tap = pt & 3;
      *reinterpret_cast<uint4*>(Ws + (pt * TN + n) * LDS + q * 8) =
          *reinterpret_cast<const uint4*>(
              wt + ((size_t)p * Co + n0 + n) * K + tap * Ci + ci0 + q * 8);
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int j = tap >> 1, k = tap & 1;
      const __nv_bfloat16* wp = Ws + (parity * 4 + tap) * TN * LDS;
#pragma unroll
      for (int kk = 0; kk < TK; kk += 16) {
        uint32_t af[2][4], bf[8][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // m16 tile i = tile row rw + i; its rows are pixel columns g and
          // g + 8, read from the band at the tap's (j + py, k + px) offset
          const int br = rw + i + j + py;
          const __nv_bfloat16* p =
              Band + (br * BW + g + k + px) * LDS + kk + t4 * 2;
          af[i][0] = ld32(p);
          af[i][1] = ld32(p + 8 * LDS);
          af[i][2] = ld32(p + 8);
          af[i][3] = ld32(p + 8 * LDS + 8);
        }
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const __nv_bfloat16* p = wp + (jn * 8 + g) * LDS + kk + t4 * 2;
          bf[jn][0] = ld32(p);
          bf[jn][1] = ld32(p + 8);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jn = 0; jn < 8; ++jn) mma16816(acc[i][jn], af[i], bf[jn]);
      }
    }
    __syncthreads();
  }

  // epilogue: + bias, bf16, into the full-res tile [2*TH2][2*TW2][TN]
  __nv_bfloat16* Os = smem;                 // reuses the weight slices
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int yy = 2 * (rw + i) + py, xx = 2 * (g + half * 8) + px;
      __nv_bfloat16* op = Os + (yy * 2 * TW2 + xx) * LDO;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int n = jn * 8 + t4 * 2;
        *reinterpret_cast<__nv_bfloat162*>(op + n) = __floats2bfloat162_rn(
            acc[i][jn][half * 2] + bias[n0 + n],
            acc[i][jn][half * 2 + 1] + bias[n0 + n + 1]);
      }
    }
  }
  __syncthreads();
  const int W = 2 * W2;
  for (int idx = threadIdx.x; idx < OUT_PX * (TN / 8); idx += NTHREADS) {
    const int pix = idx / (TN / 8), q = idx % (TN / 8);
    const int yy = pix / (2 * TW2), xx = pix % (2 * TW2);
    const int y = 2 * r0 + yy, x = 2 * c0 + xx;
    if (y < 2 * H2 && x < W)
      *reinterpret_cast<uint4*>(
          out + (((size_t)b * 2 * H2 + y) * W + x) * Co + n0 + q * 8) =
          *reinterpret_cast<const uint4*>(Os + pix * LDO + q * 8);
  }
}

}  // namespace

// h [B, H2, W2, Ci] bf16 contiguous, 16-byte aligned; wt [4, Co, 4*Ci] bf16
// (parity p = 2*py + px, K index = (2*j + k)*Ci + ci); bias [Co] f32;
// out [B, 2*H2, 2*W2, Co] bf16. Needs Ci % 32 == 0 and Co % 64 == 0.
// Returns a cudaError_t.
extern "C" int sdt_conv3x3_up_interleave_bf16(const void* h, const void* wt,
                                              const float* bias, void* out,
                                              int B, int H2, int W2, int Ci,
                                              int Co, void* stream) {
  if (Ci % TK != 0 || Co % TN != 0 || B < 1 || H2 < 1 || W2 < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      up_interleave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)B * ((H2 + TH2 - 1) / TH2) *
                          ((W2 + TW2 - 1) / TW2);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, Co / TN);
  up_interleave_kernel<<<grid, NTHREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(wt), bias,
      static_cast<__nv_bfloat16*>(out), B, H2, W2, Ci, Co);
  return (int)cudaGetLastError();
}
