// The backward of B3 (y = conv3x3_SAME(nearest_2x(h), W) + b over NHWC
// bf16, csrc/conv3x3_up.cu): dh, dW and db from dy, with f32 accumulation
// on the warp-level tensor-core instruction mma.sync m16n8k16 (bf16 in,
// f32 out).
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
// (py, px in {0, 1}), folded once on the host (ops/conv3x3.py::
// bwd_dx_weights). An implicit GEMM: M = B H W pixels, N = Ci,
// K = 16 Co; a block owns 64 pixels x 64 input channels.
//
// dW, db (sdt_conv3x3_up_bwd_dw_bf16): through B3's own split into four
// output parities (py, px), each a 2x2 conv of h with pre-summed weights
// Weff[py,px,j,k] (ops/conv3x3.py::w_eff_up). Pass 1 computes, for each of
// the 16 (py, px, j, k) and each split of the B H W half-resolution
// positions, the partial
//   dWeff[co,ci] = sum_{b,i,jj} dy[b, 2i+py, 2jj+px, co]
//                  * h[b, i+py+j-1, jj+px+k-1, ci]
// (a block owns 64 x 64 of [Co, Ci]); pass 2 adds, for each (ky, kx),
// the four dWeff whose groups hold it over every split, in a fixed order;
// db sums dy per channel in a fixed tree. No atomics: two calls give the
// same bits.
//
// Bound on an H100: operations. Each of dh and dW is 2 * (B H W) * Ci *
// 16 Co FLOP, 1.34e10 at the UNet's [1,32,32,640] (0.0136 ms at 989
// TFLOP/s). This first form stages its tiles with plain 16-byte loads
// between block barriers (no copy pipeline).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TM = 64, TN = 64, TK = 32;  // block tile, k chunk
constexpr int THREADS = 128;              // four warps, 16 rows each
constexpr int P = TK + 8;                 // pitch of the staged tiles

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One TK-deep step of the warp's 16 x 64 product: A rows of `as` (m-major,
// k contiguous), B rows of `bs` (n-major, k contiguous).
__device__ __forceinline__ void tile_mma(float (*acc)[4], const bf16* as,
                                         const bf16* bs, int warp, int g,
                                         int t) {
#pragma unroll
  for (int kk = 0; kk < TK; kk += 16) {
    uint32_t a[4];
    const bf16* s = as + (warp * 16 + g) * P + kk + 2 * t;
    a[0] = ld32(s);
    a[1] = ld32(s + 8 * P);
    a[2] = ld32(s + 8);
    a[3] = ld32(s + 8 * P + 8);
#pragma unroll
    for (int n = 0; n < TN / 8; ++n) {
      const bf16* sb = bs + (n * 8 + g) * P + kk + 2 * t;
      mma(acc[n], a, ld32(sb), ld32(sb + 8));
    }
  }
}

// dh: grid (ceil(M / TM), Ci / TN); dy [B, 2H, 2W, Co], w4 [16, Ci, Co],
// dh [B, H, W, Ci]; Co % TK == 0, Ci % TN == 0.
__global__ void __launch_bounds__(THREADS)
    up_bwd_dx(const bf16* __restrict__ dy, const bf16* __restrict__ w4,
              bf16* __restrict__ dh, int B, int H, int W, int Ci, int Co) {
  __shared__ __align__(16) bf16 as[TM * P];
  __shared__ __align__(16) bf16 bs[TN * P];
  const int M = B * H * W;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float acc[TN / 8][4];
#pragma unroll
  for (int n = 0; n < TN / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // each thread stages 2 of the 256 16-byte vectors of a tile: row r,
  // channels 8 c8 .. 8 c8 + 7 of the chunk
  int pix_b[2], pix_i[2], pix_j[2];
  bool pix_ok[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = (threadIdx.x + e * THREADS) / (TK / 8);
    const int m = m0 + r;
    pix_ok[e] = m < M;
    const int mm = pix_ok[e] ? m : 0;
    pix_b[e] = mm / (H * W);
    pix_i[e] = (mm / W) % H;
    pix_j[e] = mm % W;
  }
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int tap = 0; tap < 16; ++tap) {
    const int u = tap / 4 - 1, v = tap % 4 - 1;
    for (int c0 = 0; c0 < Co; c0 += TK) {
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = threadIdx.x + e * THREADS;
        const int r = idx / (TK / 8), c8 = idx % (TK / 8);
        const int y = 2 * pix_i[e] + u, x = 2 * pix_j[e] + v;
        uint4 val = zero;
        if (pix_ok[e] && y >= 0 && y < 2 * H && x >= 0 && x < 2 * W)
          val = *reinterpret_cast<const uint4*>(
              dy + (((long long)pix_b[e] * 2 * H + y) * 2 * W + x) * Co + c0 +
              8 * c8);
        *reinterpret_cast<uint4*>(as + r * P + 8 * c8) = val;
        *reinterpret_cast<uint4*>(bs + r * P + 8 * c8) =
            *reinterpret_cast<const uint4*>(
                w4 + ((long long)tap * Ci + n0 + r) * Co + c0 + 8 * c8);
      }
      __syncthreads();
      tile_mma(acc, as, bs, warp, g, t);
    }
  }
#pragma unroll
  for (int n = 0; n < TN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int m = m0 + warp * 16 + g + 8 * (e >> 1);
      if (m < M) {
        __nv_bfloat162 pr = __floats2bfloat162_rn(acc[n][e], acc[n][e + 1]);
        *reinterpret_cast<__nv_bfloat162*>(
            dh + (long long)m * Ci + n0 + n * 8 + 2 * t) = pr;
      }
    }
}

// dW pass 1: grid (Ci / TN, Co / TM, 16 * nsplit); blockIdx.z = split * 16
// + combo, combo = ((py * 2 + px) * 2 + j) * 2 + k. part [nsplit * 16, Co,
// Ci] f32. A split covers `chunk` (a multiple of TK) of the B H W
// half-resolution positions.
__global__ void __launch_bounds__(THREADS)
    up_bwd_dw_part(const bf16* __restrict__ dy, const bf16* __restrict__ h,
                   float* __restrict__ part, int B, int H, int W, int Ci,
                   int Co, int chunk) {
  __shared__ __align__(16) bf16 as[TM * P];  // [co][pos]
  __shared__ __align__(16) bf16 bs[TN * P];  // [ci][pos]
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int combo = blockIdx.z % 16, split = blockIdx.z / 16;
  const int py = combo >> 3, px = (combo >> 2) & 1, j = (combo >> 1) & 1,
            k = combo & 1;
  const int M = B * H * W;
  const int p_begin = split * chunk;
  const int p_end = min(M, p_begin + chunk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float acc[TN / 8][4];
#pragma unroll
  for (int n = 0; n < TN / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += TK) {
    __syncthreads();
    // 256 vectors a tile: position p0 + idx / 8, channels 8 (idx % 8) ..
    // of the block's 64; stored transposed, channel-major
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int idx = threadIdx.x + e * THREADS;
      const int r = idx / 8, c8 = idx % 8;
      const int p = p0 + r;
      uint4 va = make_uint4(0, 0, 0, 0), vb = va;
      if (p < p_end) {
        const int b = p / (H * W), i = (p / W) % H, jj = p % W;
        va = *reinterpret_cast<const uint4*>(
            dy + (((long long)b * 2 * H + 2 * i + py) * 2 * W + 2 * jj + px) *
                     Co + m0 + 8 * c8);
        const int y = i + py + j - 1, x = jj + px + k - 1;
        if (y >= 0 && y < H && x >= 0 && x < W)
          vb = *reinterpret_cast<const uint4*>(
              h + (((long long)b * H + y) * W + x) * Ci + n0 + 8 * c8);
      }
      const bf16* ea = reinterpret_cast<const bf16*>(&va);
      const bf16* eb = reinterpret_cast<const bf16*>(&vb);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        as[(8 * c8 + q) * P + r] = ea[q];
        bs[(8 * c8 + q) * P + r] = eb[q];
      }
    }
    __syncthreads();
    tile_mma(acc, as, bs, warp, g, t);
  }
  float* out = part + (long long)blockIdx.z * Co * Ci;
#pragma unroll
  for (int n = 0; n < TN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int co = m0 + warp * 16 + g + 8 * (e >> 1);
      const int ci = n0 + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + (long long)co * Ci + ci) =
          make_float2(acc[n][e], acc[n][e + 1]);
    }
}

// The 2x2 index j of B3's parity split that holds tap ky of the 3x3
// kernel at output parity py (ops/conv3x3.py::_GROUPS).
__device__ __forceinline__ int group_of(int py, int ky) {
  return py == 0 ? (ky == 0 ? 0 : 1) : (ky == 2 ? 1 : 0);
}

// dW pass 2: one thread a (co, ci); dw [Co, Ci, 3, 3] f32.
__global__ void up_bwd_dw_fold(const float* __restrict__ part,
                               float* __restrict__ dw, int Ci, int Co,
                               int nsplit) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)Co * Ci) return;
  const long long plane = (long long)Co * Ci;
  for (int ky = 0; ky < 3; ++ky)
    for (int kx = 0; kx < 3; ++kx) {
      float s = 0.f;
      for (int sp = 0; sp < nsplit; ++sp)
        for (int py = 0; py < 2; ++py)
          for (int px = 0; px < 2; ++px) {
            const int combo =
                ((py * 2 + px) * 2 + group_of(py, ky)) * 2 + group_of(px, kx);
            s += part[(long long)(sp * 16 + combo) * plane + e];
          }
      dw[e * 9 + ky * 3 + kx] = s;
    }
}

// db: grid ceil(Co / 32), 256 threads = 8 rows x 32 channels; each row
// sums every 8th position, then row 0 adds the 8 in order.
__global__ void up_bwd_db(const bf16* __restrict__ dy, float* __restrict__ db,
                          int npos, int Co) {
  __shared__ float red[8][32];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int co = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (co < Co)
    for (int p = ty; p < npos; p += 8)
      s += __bfloat162float(dy[(long long)p * Co + co]);
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && co < Co) {
    float tot = 0.f;
    for (int r = 0; r < 8; ++r) tot += red[r][tx];
    db[co] = tot;
  }
}

}  // namespace

// dy [B, 2H, 2W, Co] and w4 [16, Ci, Co] (ops/conv3x3.py::bwd_dx_weights)
// bf16 contiguous, 16-byte aligned; dh [B, H, W, Ci] bf16, 4-byte aligned.
// Needs Co % 32 == 0 and Ci % 64 == 0. Returns a cudaError_t.
extern "C" int sdt_conv3x3_up_bwd_dx_bf16(const void* dy, const void* w4,
                                          void* dh, int B, int H, int W,
                                          int Ci, int Co, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Ci % TN || Co % TK || Ci < TN || Co < TK ||
      Ci / TN > 65535)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + TM - 1) / TM), Ci / TN);
  up_bwd_dx<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)dy, (const bf16*)w4, (bf16*)dh, B, H, W, Ci, Co);
  return (int)cudaGetLastError();
}

// dy [B, 2H, 2W, Co] and h [B, H, W, Ci] bf16 contiguous, 16-byte aligned;
// part f32 scratch of nsplit * 16 * Co * Ci (8-byte aligned); dw [Co, Ci,
// 3, 3] and db [Co] f32. The B H W half-resolution positions split into
// nsplit runs of `chunk` (a multiple of 32). Needs Co % 64 == 0 and
// Ci % 64 == 0. Returns a cudaError_t.
extern "C" int sdt_conv3x3_up_bwd_dw_bf16(const void* dy, const void* h,
                                          float* part, float* dw, float* db,
                                          int B, int H, int W, int Ci, int Co,
                                          int nsplit, int chunk,
                                          void* stream) {
  const long long M = (long long)B * H * W;
  if (B < 1 || H < 1 || W < 1 || Ci % TN || Co % TM || Ci < TN || Co < TM ||
      nsplit < 1 || chunk < TK || chunk % TK || (long long)nsplit * chunk < M ||
      (long long)(nsplit - 1) * chunk >= M || 16 * nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(Ci / TN, Co / TM, 16 * nsplit);
  up_bwd_dw_part<<<grid, THREADS, 0, s>>>((const bf16*)dy, (const bf16*)h,
                                          part, B, H, W, Ci, Co, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)Co * Ci;
  up_bwd_dw_fold<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, dw, Ci, Co,
                                                            nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  up_bwd_db<<<(Co + 31) / 32, 256, 0, s>>>((const bf16*)dy, db,
                                           (int)(4 * M), Co);
  return (int)cudaGetLastError();
}
