// The head split and its inverse as copies: [B, S, H*D] -> [B, H, S, D]
// (to heads) and [B, H, S, D] -> [B, S, H*D] (from heads), 2- or 4-byte
// elements, bit-exact.
//
// Replaces: safe_denoiser_tpu/ops/attention.py::_repack_to_heads_kernel
// (repack_to_heads) and ::_repack_from_heads_kernel (repack_from_heads),
// reached from self_attention under SDT_FLASH2_LAYOUT=nt with
// SDT_ATTN_REPACK=1 (three to-heads and one from-heads per attention).
//
// Bound on an H100: pure data movement, 2 x bytes / 3.35 TB/s (16.9 us at
// SD3's [2, 4608, 1536] bf16, 12.5 us at [8, 4096, 320], 6.3 us at
// [8, 1024, 640]).
//
// Design: one thread per 16-byte chunk of the output, consecutive threads
// on consecutive chunks, so every store is a full 16-byte vector and a
// warp writes 512 contiguous bytes. A head slice is D * esize bytes (80 at
// D=40 bf16), a multiple of 16 at every shape of the model paths, so each
// output chunk is also one 16-byte run of the input: the loads are 16-byte
// vectors too, a warp's loads falling in runs of one head slice, whose
// neighbouring slices the neighbouring warps read (the L1/L2 sectors are
// used whole across the block). No shared memory is needed. Where the
// slice is not a 16-byte multiple, or a pointer is not 16-byte aligned,
// the same kernel moves single elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// T is the unit moved per thread (uint4 = 16 bytes, or one element); D is
// the head slice in units of T. To heads: blockIdx.y = b*H + h, whose
// output o[b, h] is one contiguous S*D run; from heads: blockIdx.y = b,
// whose output o[b] is one contiguous S*H*D run. 32-bit offsets within a
// run (the wrapper keeps a batch row under 2^31 units).
template <typename T, bool TO_HEADS>
__global__ void __launch_bounds__(256)
repack_kernel(const T* __restrict__ x, T* __restrict__ o, int S, int H,
              int D) {
  const int run = TO_HEADS ? S * D : S * H * D;
  const long long obase = (long long)blockIdx.y * run;
  long long ibase;
  if (TO_HEADS) {
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    ibase = (long long)b * run * H + (long long)h * D;
  } else {
    ibase = obase;
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < run;
       i += gridDim.x * blockDim.x) {
    int src;
    if (TO_HEADS) {  // o[b, h, s, d] <- x[b, s, h, d]
      const int s = i / D;
      src = s * H * D + (i - s * D);
    } else {  // o[b, s, h, d] <- x[b, h, s, d]
      const int s = i / (H * D), rem = i - s * H * D;
      const int h = rem / D;
      src = (h * S + s) * D + (rem - h * D);
    }
    o[obase + i] = x[ibase + src];
  }
}

template <bool TO_HEADS>
int launch(const void* x, void* o, int B, int S, int H, int D, int esize,
           void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || (esize != 2 && esize != 4) ||
      (long long)S * H * D * esize >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bytes = D * esize;
  const bool vec = bytes % 16 == 0 && ((uintptr_t)x | (uintptr_t)o) % 16 == 0;
  const int d = vec ? bytes / 16 : D;
  const int run = TO_HEADS ? S * d : S * H * d;
  const int ys = TO_HEADS ? B * H : B;
  // about 8 blocks of 256 threads on each of the 132 SMs in all
  int xs = (run + 255) / 256;
  const int cap = (132 * 8 + ys - 1) / ys;
  if (xs > cap) xs = cap;
  dim3 grid(xs, ys);
  if (vec)
    repack_kernel<uint4, TO_HEADS><<<grid, 256, 0, st>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(o), S, H, d);
  else if (esize == 2)
    repack_kernel<uint16_t, TO_HEADS><<<grid, 256, 0, st>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(o), S, H, d);
  else
    repack_kernel<uint32_t, TO_HEADS><<<grid, 256, 0, st>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(o), S, H, d);
  return (int)cudaGetLastError();
}

}  // namespace

// x contiguous [B, S, H*D] -> o contiguous [B, H, S, D]; elements of esize
// bytes (2 or 4). Returns a cudaError_t.
extern "C" int sdt_repack_to_heads(const void* x, void* o, int B, int S, int H,
                                   int D, int esize, void* stream) {
  return launch<true>(x, o, B, S, H, D, esize, stream);
}

// x contiguous [B, H, S, D] -> o contiguous [B, S, H*D].
extern "C" int sdt_repack_from_heads(const void* x, void* o, int B, int S,
                                     int H, int D, int esize, void* stream) {
  return launch<false>(x, o, B, S, H, D, esize, stream);
}
