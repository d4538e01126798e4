// FLUX's per-head RMSNorm and rotary position embedding on the attention's
// q and k, in one pass, written straight into the joint [B, S, H, D] q and k
// buffers the attention kernel (B1) reads:
//   y = x * rsqrt(mean(x^2) + eps) * w          (over the head's D values)
//   out[2i]   = y[2i]   * cos[s, 2i]   - y[2i+1] * sin[s, 2i]
//   out[2i+1] = y[2i+1] * cos[s, 2i+1] + y[2i]   * sin[s, 2i+1]
// for each head row of q (weight wq) and of k (weight wk), s the token's
// position in the joint sequence. The joint sequence is one or two
// segments (FLUX's double block: [text ; image], each stream's own
// projections and norm weights; the single block: one), so the two
// streams' torch.cat goes too; with two segments v's head rows are copied
// into the joint v buffer by the same launch.
//
// Replaces no TPU kernel: the JAX package has no FLUX. The eager form is an
// f32 RMSNorm (about five launches and an f32 copy of q or k), then the
// rotary (about six more), then the cat, at each of 57 attention sites a
// step.
//
// Numerics (ops/qk_rope.py::qk_rope_ref): f32 inside, each output rounded
// once to the stream's type; x * r rounded to f32, then times w, then the
// rotary's products and sum each rounded (no contraction into FMAs). The
// sum of squares is a fixed butterfly of shuffles (deterministic).
//
// Bound on an H100: bytes. FLUX.1-dev's double block at [1, 4608, 24, 128]
// bf16 reads q, k and v of both streams and writes the joint q, k and v
// (169.9 MB), and reads the f32 cos and sin tables (4.7 MB): 52 us at
// 3.35 TB/s; a few operations a byte.
//
// Design: G = D / 8 lanes a head row, each holding one 16-byte vector of 8
// values (32 bytes in f32), so a row is one coalesced access and its sum
// of squares a shuffle butterfly inside the G lanes; groups alternate q and
// k of one head row, so both read the same cos and sin row (from L1); the
// q group also copies v's row when there are two segments. 256 threads a
// block.

#include "vec8.cuh"

namespace sdt_qkrope {

constexpr int THREADS = 256;

// One segment of the joint sequence: q, k, v [B, S, H, D] (head rows
// contiguous, D values each; the batch and token strides bs and rs in
// vectors of 8 values, shared by q, k and v) and the norm weights [D].
template <class Vec>
struct Seg {
  const Vec* q;
  const Vec* k;
  const Vec* v;
  const Vec* wq;
  const Vec* wk;
  long long bs, rs;
  int S;
};

template <class E, int G, class Vec = typename E::V>
__global__ void __launch_bounds__(THREADS)
    qk_rope_kernel(const Seg<Vec> seg0, const Seg<Vec> seg1,
                   const float4* __restrict__ cos,
                   const float4* __restrict__ sin, Vec* __restrict__ q_out,
                   Vec* __restrict__ k_out, Vec* __restrict__ v_out, int S,
                   int H, long long items, float D, float eps) {
  const long long item =
      (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  // whole groups leave together; the shuffles name their own group's lanes
  if (item >= items) return;
  const unsigned mask =
      G == 32 ? 0xffffffffu
              : (((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1)));
  const bool is_k = item & 1;
  const long long row = item >> 1;  // (b, s, h) of the joint [B, S, H]
  const int h = (int)(row % H);
  const long long bsi = row / H;
  const int s = (int)(bsi % S);
  const long long b = bsi / S;
  // the segment's fields picked one by one (no copy of a parameter struct)
  const bool first = s < seg0.S;
  const int sl = first ? s : s - seg0.S;
  const long long src = b * (first ? seg0.bs : seg1.bs) +
                        (long long)sl * (first ? seg0.rs : seg1.rs) +
                        (long long)h * G + lane;
  const Vec* xs =
      is_k ? (first ? seg0.k : seg1.k) : (first ? seg0.q : seg1.q);
  const Vec* ws =
      is_k ? (first ? seg0.wk : seg1.wk) : (first ? seg0.wq : seg1.wq);

  float x[8], w[8];
  E::load(xs[src], x);
  E::load(ws[lane], w);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) ss = __fadd_rn(ss, __fmul_rn(x[j], x[j]));
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(mask, ss, o);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, D), eps));

  const float4* cr = cos + (long long)s * 2 * G + 2 * lane;
  const float4* sr = sin + (long long)s * 2 * G + 2 * lane;
  const float4 c0 = cr[0], c1 = cr[1], s0 = sr[0], s1 = sr[1];
  const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  float y[8], out[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = __fmul_rn(__fmul_rn(x[j], r), w[j]);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float a = y[2 * p], bb = y[2 * p + 1];
    out[2 * p] = __fsub_rn(__fmul_rn(a, c[2 * p]), __fmul_rn(bb, sn[2 * p]));
    out[2 * p + 1] =
        __fadd_rn(__fmul_rn(bb, c[2 * p + 1]), __fmul_rn(a, sn[2 * p + 1]));
  }
  const long long dst = row * G + lane;
  (is_k ? k_out : q_out)[dst] = E::store(out);
  if (v_out != nullptr && !is_k)
    v_out[dst] = (first ? seg0.v : seg1.v)[src];
}

template <class E, int G>
cudaError_t launch_g(const void* const* p0, long long bs0, long long rs0,
                     int s0, const void* const* p1, long long bs1,
                     long long rs1, int s1, const float* cos, const float* sin,
                     void* q_out, void* k_out, void* v_out, int B, int H,
                     int D, float eps, cudaStream_t st) {
  using Vec = typename E::V;
  auto seg = [](const void* const* p, long long bs, long long rs, int S) {
    return Seg<Vec>{static_cast<const Vec*>(p[0]),
                    static_cast<const Vec*>(p[1]),
                    static_cast<const Vec*>(p[2]),
                    static_cast<const Vec*>(p[3]),
                    static_cast<const Vec*>(p[4]), bs / 8, rs / 8, S};
  };
  const int S = s0 + s1;
  const long long items = 2LL * B * S * H;
  const long long blocks = (items + THREADS / G - 1) / (THREADS / G);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  qk_rope_kernel<E, G><<<(unsigned)blocks, THREADS, 0, st>>>(
      seg(p0, bs0, rs0, s0), seg(p1, bs1, rs1, s1),
      reinterpret_cast<const float4*>(cos),
      reinterpret_cast<const float4*>(sin), static_cast<Vec*>(q_out),
      static_cast<Vec*>(k_out), static_cast<Vec*>(v_out), S, H, items,
      (float)D, eps);
  return cudaGetLastError();
}

template <class E>
cudaError_t launch_type(const void* const* p0, long long bs0, long long rs0,
                        int s0, const void* const* p1, long long bs1,
                        long long rs1, int s1, const float* cos,
                        const float* sin, void* q_out, void* k_out,
                        void* v_out, int B, int H, int D, float eps,
                        cudaStream_t st) {
#define SDT_QKROPE_D(DD)                                                     \
  if (D == DD)                                                               \
  return launch_g<E, DD / 8>(p0, bs0, rs0, s0, p1, bs1, rs1, s1, cos, sin,   \
                             q_out, k_out, v_out, B, H, D, eps, st)
  SDT_QKROPE_D(32);
  SDT_QKROPE_D(64);
  SDT_QKROPE_D(128);
  SDT_QKROPE_D(256);
#undef SDT_QKROPE_D
  return cudaErrorInvalidValue;
}

}  // namespace sdt_qkrope

// dtype 0 bf16, 2 f32. Segment i: q, k, v, wq, wk pointers, batch and token
// strides in elements (multiples of 8; the head stride is D), S_i tokens;
// segment 1 absent when s1 == 0. cos and sin: f32 [s0 + s1, D] contiguous.
// q_out, k_out (and v_out, or null for no v copy): contiguous [B, s0 + s1,
// H, D]. Every pointer 16-byte aligned; D one of 32, 64, 128, 256.
extern "C" int sdt_qk_rope(const void* q0, const void* k0, const void* v0,
                           const void* wq0, const void* wk0, long long bs0,
                           long long rs0, int s0, const void* q1,
                           const void* k1, const void* v1, const void* wq1,
                           const void* wk1, long long bs1, long long rs1,
                           int s1, const float* cos, const float* sin,
                           void* q_out, void* k_out, void* v_out, int dtype,
                           int B, int H, int D, float eps, void* stream) {
  using namespace sdt_qkrope;
  const void* p0[5] = {q0, k0, v0, wq0, wk0};
  const void* p1[5] = {q1, k1, v1, wq1, wk1};
  const bool two = s1 > 0;
  uintptr_t ptrs = reinterpret_cast<uintptr_t>(cos) |
                   reinterpret_cast<uintptr_t>(sin) |
                   reinterpret_cast<uintptr_t>(q_out) |
                   reinterpret_cast<uintptr_t>(k_out) |
                   reinterpret_cast<uintptr_t>(v_out);
  bool bad = (dtype != 0 && dtype != 2) || B < 1 || H < 1 || s0 < 1 ||
             s1 < 0 || !cos || !sin || !q_out || !k_out ||
             (v_out && !(v0 && (!two || v1)));
  for (int i = 0; i < 5; ++i) {
    if (i == 2 && !v_out) continue;
    bad = bad || !p0[i] || (two && !p1[i]);
    ptrs |= reinterpret_cast<uintptr_t>(p0[i]) |
            (two ? reinterpret_cast<uintptr_t>(p1[i]) : 0);
  }
  const long long strides[4] = {bs0, rs0, two ? bs1 : 0, two ? rs1 : 0};
  for (long long s : strides) bad = bad || s < 0 || s % 8;
  if (bad || ptrs % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_type<sdt_vec8::BF16>(p0, bs0, rs0, s0, p1, bs1, rs1,
                                            s1, cos, sin, q_out, k_out, v_out,
                                            B, H, D, eps, st);
  return (int)launch_type<sdt_vec8::F32>(p0, bs0, rs0, s0, p1, bs1, rs1, s1,
                                         cos, sin, q_out, k_out, v_out, B, H,
                                         D, eps, st);
}
