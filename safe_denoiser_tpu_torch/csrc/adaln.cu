// The MMDiT's modulated LayerNorm and gated residual, each in one pass over
// a row of the token-major stream [B, S, D] (bf16, f16 or f32):
//   mode 0 (norm):          h  = LN(x) * (1 + scale) + shift
//   mode 1 (residual+norm): x' = x + gate * delta, h = LN(x') * (1 + scale)
//                           + shift (writes both)
//   mode 2 (residual):      x' = x + gate * delta
// LN without affine, eps as given; scale, shift and gate are per-batch-row
// [B, D] vectors read in place (a pointer and a batch stride: the chunks of
// the block's modulation Linear, no copy).
//
// Replaces no TPU kernel: the JAX package leaves these to XLA, which fuses
// them. The port's eager form was about ten launches a site, with an f32
// round trip of the row (models/mmdit.py::layer_norm_fp32).
//
// Numerics (ops/adaln.py::adaln_ref): f32 throughout; the residual rounded
// once to the stream's type, and the LayerNorm taken of that rounded x'
// (what the stream carries on); the row's mean, then the centred variance
// (two passes over the row held in registers, as layer_norm_fp32); the
// normalised value times (1 + scale) plus shift, each product and sum
// rounded to f32 as the plain version's (no contraction into FMAs), and
// h rounded once to the stream's type.
//
// Bound on an H100: bytes. Mode 1 at SD3-medium's [2, 4096, 1536] reads x
// and delta and writes x' and h: 100.7 MB, 30 us at 3.35 TB/s; the
// arithmetic is a few operations a byte.
//
// Design: one warp a row, 32 lanes on consecutive vectors of 8 values (16
// bytes of bf16/f16, 32 of f32), lane l holding vectors l, l + 32, ... (NV
// of them: D <= 256 * NV) in registers, so a row is read once and every load
// is a coalesced warp access, all of a lane's loads in flight together; the
// row's sums are warp shuffles in a fixed butterfly (deterministic). WARPS
// rows a block.

#include "vec8.cuh"

namespace sdt_modln {

constexpr int WARPS = 4;     // rows a block
constexpr int NV_MAX = 12;   // vectors a lane: D <= 32 * 8 * 12 = 3072

using sdt_vec8::BF16;
using sdt_vec8::F16;
using sdt_vec8::F32;

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Strides are in vectors of 8 values. MODE 0 reads x only; MODE 2 writes
// x_out only.
template <class E, int NV, int MODE, class Vec = typename E::V>
__global__ void __launch_bounds__(WARPS * 32)
    adaln_row_kernel(const Vec* __restrict__ x, long long x_bs,
                     long long x_ss, const Vec* __restrict__ d,
                     long long d_bs, long long d_ss,
                     const Vec* __restrict__ gate, long long g_bs,
                     const Vec* __restrict__ scale, long long sc_bs,
                     const Vec* __restrict__ shift, long long sh_bs,
                     Vec* __restrict__ x_out, Vec* __restrict__ h_out,
                     int rows, int S, int V, float D, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long b = row / S, s = row - b * S;
  const Vec* xr = x + b * x_bs + s * x_ss;

  float v[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < V) E::load(xr[c], v[i]);
  }
  if (MODE != 0) {
    const Vec* dr = d + b * d_bs + s * d_ss;
    const Vec* gr = gate + b * g_bs;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < V) {
        float dv[8], gv[8];
        E::load(dr[c], dv);
        E::load(gr[c], gv);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[i][j] = __fadd_rn(v[i][j], __fmul_rn(gv[j], dv[j]));
        const Vec o = E::store(v[i]);
        x_out[row * V + c] = o;
        // the LayerNorm sees x' as the stream holds it
        if (MODE == 1) E::load(o, v[i]);
      }
    }
  }
  if (MODE == 2) return;

  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < V)
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += v[i][j];
  const float mean = __fdiv_rn(warp_sum(sum), D);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < V)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float t = __fsub_rn(v[i][j], mean);
        sq = __fadd_rn(sq, __fmul_rn(t, t));
      }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), D), eps));

  const Vec* scr = scale + b * sc_bs;
  const Vec* shr = shift + b * sh_bs;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < V) {
      float sc[8], sh[8];
      E::load(scr[c], sc);
      E::load(shr[c], sh);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float y = __fmul_rn(__fsub_rn(v[i][j], mean), rstd);
        v[i][j] = __fadd_rn(__fmul_rn(y, __fadd_rn(1.f, sc[j])), sh[j]);
      }
      h_out[row * V + c] = E::store(v[i]);
    }
  }
}

template <class E, int NV>
cudaError_t launch_nv(int mode, const void* x, long long x_bs,
                      long long x_ss, const void* d, long long d_bs,
                      long long d_ss, const void* gate, long long g_bs,
                      const void* scale, long long sc_bs, const void* shift,
                      long long sh_bs, void* x_out, void* h_out, int rows,
                      int S, int V, float D, float eps, cudaStream_t st) {
  const dim3 grid((unsigned)(((long long)rows + WARPS - 1) / WARPS)),
      block(WARPS * 32);
  using Vec = typename E::V;
#define SDT_ADALN_ARGS                                                     \
  static_cast<const Vec*>(x), x_bs, x_ss, static_cast<const Vec*>(d),     \
      d_bs, d_ss, static_cast<const Vec*>(gate), g_bs,                     \
      static_cast<const Vec*>(scale), sc_bs,                               \
      static_cast<const Vec*>(shift), sh_bs, static_cast<Vec*>(x_out),     \
      static_cast<Vec*>(h_out), rows, S, V, D, eps
  switch (mode) {
    case 0: adaln_row_kernel<E, NV, 0><<<grid, block, 0, st>>>(SDT_ADALN_ARGS);
      break;
    case 1: adaln_row_kernel<E, NV, 1><<<grid, block, 0, st>>>(SDT_ADALN_ARGS);
      break;
    default:
      adaln_row_kernel<E, NV, 2><<<grid, block, 0, st>>>(SDT_ADALN_ARGS);
  }
#undef SDT_ADALN_ARGS
  return cudaGetLastError();
}

// the smallest instance whose NV covers the row's vectors a lane
template <class E>
cudaError_t launch_type(int nv, int mode, const void* x, long long x_bs,
                        long long x_ss, const void* d, long long d_bs,
                        long long d_ss, const void* gate, long long g_bs,
                        const void* scale, long long sc_bs, const void* shift,
                        long long sh_bs, void* x_out, void* h_out, int rows,
                        int S, int V, float D, float eps, cudaStream_t st) {
#define SDT_ADALN_NV(N)                                                    \
  if (nv <= N)                                                             \
  return launch_nv<E, N>(mode, x, x_bs, x_ss, d, d_bs, d_ss, gate, g_bs,  \
                         scale, sc_bs, shift, sh_bs, x_out, h_out, rows, S, \
                         V, D, eps, st)
  SDT_ADALN_NV(1);
  SDT_ADALN_NV(2);
  SDT_ADALN_NV(3);
  SDT_ADALN_NV(4);
  SDT_ADALN_NV(6);
  SDT_ADALN_NV(8);
  SDT_ADALN_NV(NV_MAX);
#undef SDT_ADALN_NV
  return cudaErrorInvalidValue;
}

}  // namespace sdt_modln

// dtype 0 bf16, 1 f16, 2 f32. Strides in elements; every pointer 16-byte
// aligned and every stride a multiple of 8 elements (0 broadcasts a
// modulation over the batch). Mode 0 ignores delta, gate and x_out; mode 2
// ignores scale, shift and h_out. x_out and h_out are contiguous [B*S, D].
extern "C" int sdt_adaln(const void* x, long long x_bs, long long x_ss,
                         const void* d, long long d_bs, long long d_ss,
                         const void* gate, long long g_bs, const void* scale,
                         long long sc_bs, const void* shift, long long sh_bs,
                         void* x_out, void* h_out, int dtype, int mode, int B,
                         int S, int D, float eps, void* stream) {
  using namespace sdt_modln;
  const bool res = mode != 0, norm = mode != 2;
  const long long strides[6] = {x_bs, x_ss, res ? d_bs : 0, res ? d_ss : 0,
                                res ? g_bs : 0, norm ? sc_bs | sh_bs : 0};
  uintptr_t ptrs = reinterpret_cast<uintptr_t>(x);
  if (res)
    ptrs |= reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(gate) |
            reinterpret_cast<uintptr_t>(x_out);
  if (norm)
    ptrs |= reinterpret_cast<uintptr_t>(scale) |
            reinterpret_cast<uintptr_t>(shift) |
            reinterpret_cast<uintptr_t>(h_out);
  bool bad = dtype < 0 || dtype > 2 || mode < 0 || mode > 2 || B < 1 ||
             S < 1 || D < 8 || D % 8 || D > 256 * NV_MAX ||
             (long long)B * S > 0x7fffffffLL || ptrs % 16 ||
             (res && (!d || !gate || !x_out)) ||
             (norm && (!scale || !shift || !h_out));
  for (long long s : strides) bad = bad || s < 0 || s % 8;
  if (bad) return (int)cudaErrorInvalidValue;
  const int V = D / 8, nv = (V + 31) / 32, rows = B * S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SDT_ADALN_TYPE(E)                                                    \
  return (int)launch_type<E>(nv, mode, x, x_bs / 8, x_ss / 8, d, d_bs / 8,  \
                             d_ss / 8, gate, g_bs / 8, scale, sc_bs / 8,    \
                             shift, sh_bs / 8, x_out, h_out, rows, S, V,    \
                             (float)D, eps, st)
  if (dtype == 0) SDT_ADALN_TYPE(BF16);
  if (dtype == 1) SDT_ADALN_TYPE(F16);
  SDT_ADALN_TYPE(F32);
#undef SDT_ADALN_TYPE
}
