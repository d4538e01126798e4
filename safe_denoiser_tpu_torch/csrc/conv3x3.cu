// out = residual + conv3x3_SAME(act(x * a + b), w) + bias for NHWC bf16 x:
// the VAE resnets' GroupNorm-affine + SiLU prologue and residual epilogue
// fused around one 3x3 conv.
//
// Replaces: safe_denoiser_tpu/ops/conv3x3.py::_kernel (via conv3x3 <-
// vae.Conv3x3 <- vae.ResnetBlock): the VAE encoder's and decoder's resnet
// convs, Ci/Co in {128, 256, 512}, H = W in 64..512.
//
// Bound on an H100: operations, 2 * B*H*W * 9*Ci * Co FLOP at 989 TFLOP/s
// bf16 (309 GFLOP, ~0.31 ms, at the decoder's [4,512,512,128] -> 128); the
// bytes (x, residual and output once each) take a quarter of that or less.
//
// Design: an implicit GEMM, M = B*H*W output pixels, N = Co, K = 9*Ci
// (tap-major: K index = (3*dy + dx)*Ci + ci). Block tile 128x128, K step
// 32, 8 warps of 64x32, mma.sync m16n8k16 (bf16 in, f32 accumulate), at
// most 128 registers a thread so that two blocks share an SM (170 and one
// block took ~1.45x as long on an H100, at the cost of a 56-byte spill).
// Each K step lies inside one tap (Ci % 32 == 0), so a thread gathers whole
// 16-byte pieces of one input pixel's channels. The prologue runs while the
// piece is staged into shared memory: x*a and +b each rounded to bf16 (the
// TPU kernel's bf16 affine), then x/(1+exp(-x)) rounded once. SAME padding
// comes after the prologue: a tap outside the image stages zeros of the
// activated input, never act(0*a+b). Two shared-memory stages; the next K
// step's global loads are issued before the current step's MMAs and
// transformed after them. Epilogue: f32 bias plus the bf16 residual, one
// bf16 store per pair of channels. The TPU's halo-band DMA, flattened-band
// wrap fix-up dots, pad_cols and nofix were Mosaic tactics and are not
// carried over. Not yet done (later work): cp.async / TMA, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 128, TN = 128, TK = 32, NTHREADS = 256;
constexpr int LDS = TK + 8;  // smem row pitch (bf16), conflict-free frags
constexpr int PIECES = (TM * TK / 8) / NTHREADS;  // 16-byte pieces a thread

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

__device__ __forceinline__ float rbf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// act(x * a + b) on 8 bf16 values, rounded as the TPU kernel rounds
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
      v.x = v.x / (1.f + __expf(-v.x));
      v.y = v.y / (1.f + __expf(-v.y));
    }
    os[i] = __floats2bfloat162_rn(v.x, v.y);
  }
  return out;
}

__global__ void __launch_bounds__(NTHREADS, 2)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ wt,
               const float* __restrict__ bias,
               const __nv_bfloat16* __restrict__ pre_a,
               const __nv_bfloat16* __restrict__ pre_b,
               const __nv_bfloat16* __restrict__ res,
               __nv_bfloat16* __restrict__ out, int B, int H, int W, int Ci,
               int Co, int silu) {
  __shared__ __align__(16) __nv_bfloat16 As[2][TM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][TN * LDS];

  const int M = B * H * W;
  const int K = 9 * Ci;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const bool has_pre = pre_a != nullptr;
  const bool act = silu != 0;

  // the pieces this thread stages each K step: A row (output pixel) and B
  // row (output channel) p_row, channels p_col .. p_col+7 of the step
  int p_row[PIECES], p_col[PIECES], p_b[PIECES], p_y[PIECES], p_x[PIECES];
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    p_row[i] = idx / (TK / 8);
    p_col[i] = (idx % (TK / 8)) * 8;
    const int mrow = m0 + p_row[i];
    p_b[i] = mrow < M ? mrow / (H * W) : -1;
    const int rem = mrow % (H * W);
    p_y[i] = rem / W;
    p_x[i] = rem % W;
  }

  uint4 xr[PIECES], ar[PIECES], br[PIECES], wr[PIECES];
  bool ok[PIECES];
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  auto load = [&](int k0) {
    const int tap = k0 / Ci, ci0 = k0 - tap * Ci;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const int yy = p_y[i] + dy, xx = p_x[i] + dx;
      ok[i] = p_b[i] >= 0 && yy >= 0 && yy < H && xx >= 0 && xx < W;
      if (ok[i]) {
        const int c = ci0 + p_col[i];
        xr[i] = *reinterpret_cast<const uint4*>(
            x + (((size_t)p_b[i] * H + yy) * W + xx) * Ci + c);
        if (has_pre) {
          ar[i] = *reinterpret_cast<const uint4*>(pre_a + (size_t)p_b[i] * Ci
                                                  + c);
          br[i] = *reinterpret_cast<const uint4*>(pre_b + (size_t)p_b[i] * Ci
                                                  + c);
        }
      }
      wr[i] = *reinterpret_cast<const uint4*>(
          wt + (size_t)(n0 + p_row[i]) * K + k0 + p_col[i]);
    }
  };
  auto store = [&](int stage) {
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const uint4 v = ok[i] ? prologue(xr[i], ar[i], br[i], has_pre, act)
                            : zero4;
      *reinterpret_cast<uint4*>(&As[stage][p_row[i] * LDS + p_col[i]]) = v;
      *reinterpret_cast<uint4*>(&Bs[stage][p_row[i] * LDS + p_col[i]]) =
          wr[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int stage = 0;
  for (int k0 = 0; k0 < K; k0 += TK) {
    const bool more = k0 + TK < K;
    if (more) load(k0 + TK);
    const __nv_bfloat16* as = As[stage];
    const __nv_bfloat16* bs = Bs[stage];
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* p = as + (wm + i * 16 + g) * LDS + kk + t4 * 2;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * LDS);
        af[i][2] = ld32(p + 8);
        af[i][3] = ld32(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = bs + (wn + j * 8 + g) * LDS + kk + t4 * 2;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(acc[i][j], af[i], bf[j]);
    }
    // the other stage was last read before the previous barrier
    if (more) store(stage ^ 1);
    __syncthreads();
    stage ^= 1;
  }

  // epilogue: + bias (+ residual) in f32, bf16 out; out and res are [M, Co]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int mrow = m0 + wm + i * 16 + g + half * 8;
      if (mrow >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + t4 * 2;
        const size_t off = (size_t)mrow * Co + n;
        float v0 = acc[i][j][half * 2] + bias[n];
        float v1 = acc[i][j][half * 2 + 1] + bias[n + 1];
        if (res != nullptr) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(res + off));
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + off) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// x [B, H, W, Ci] bf16 contiguous, 16-byte aligned; wt [Co, 9*Ci] bf16
// (K index = (3*dy + dx)*Ci + ci); bias [Co] f32; pre_a, pre_b [B, Ci] bf16
// or both null; res [B, H, W, Co] bf16 or null; out [B, H, W, Co] bf16;
// silu 0 or 1. Needs Ci % 32 == 0 and Co % 128 == 0. Returns a cudaError_t.
extern "C" int sdt_conv3x3_bf16(const void* x, const void* wt,
                                const float* bias, const void* pre_a,
                                const void* pre_b, const void* res, void* out,
                                int B, int H, int W, int Ci, int Co, int silu,
                                void* stream) {
  if (Ci % TK != 0 || Co % TN != 0 || B < 1 || H < 1 || W < 1 ||
      (pre_a == nullptr) != (pre_b == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  if (M >= (1LL << 31)) return (int)cudaErrorInvalidValue;  // int pixel ids
  dim3 grid((unsigned)((M + TM - 1) / TM), Co / TN);
  conv3x3_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wt), bias,
      static_cast<const __nv_bfloat16*>(pre_a),
      static_cast<const __nv_bfloat16*>(pre_b),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), B, H, W, Ci, Co, silu);
  return (int)cudaGetLastError();
}
