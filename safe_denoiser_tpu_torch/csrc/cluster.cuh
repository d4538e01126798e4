// Thread-block clusters (sm_90): a block's rank in its cluster, the split
// cluster barrier, reads of a peer block's shared memory (distributed shared
// memory, DSMEM) and, on the host, a launch with a cluster dimension.
//
// Used by the kernels that reduce across the blocks of a cluster in rank
// order (group_norm.cu, rbf.cu): every block adds the peers' partials in
// the order 0, 1, ..., CL-1, so all of them derive bit-identical sums, with
// no atomics. A block's shared memory must stay alive while peers read it:
// each kernel arrives on the cluster barrier once it has read its peers
// and waits on it before exiting.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sdt_cluster {

__device__ __forceinline__ uint32_t rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster arrives (release: this
// block's earlier shared-memory writes become visible to the peers that
// wait); wait returns once all have arrived (acquire). Both in uniform
// control flow (.aligned).
__device__ __forceinline__ void arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void sync() {
  arrive();
  wait();
}

// the f32 (f64) at the same shared-memory offset as `local`, in block
// `peer` of this cluster (peer == rank() reads this block's own)
__device__ __forceinline__ float ld_peer(const float* local, uint32_t peer) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(a), "r"(peer));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// programmatic dependent launch: let the next kernel on the stream start
// launching (launch_dependents), and wait until the previous one has
// finished and its writes are visible (wait_previous)
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ double ld_peer(const double* local,
                                         uint32_t peer) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t remote;
  double v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(a), "r"(peer));
  asm volatile("ld.shared::cluster.f64 %0, [%1];\n"
               : "=d"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// sum over the cluster's blocks of the value at `local`, in rank order
template <typename T>
__device__ __forceinline__ T sum_peers(const T* local, int n_blocks) {
  T s = 0;
  for (int q = 0; q < n_blocks; ++q) s += ld_peer(local, (uint32_t)q);
  return s;
}

// Launch `Kernel` on `grid` with clusters of `cl` blocks along x (grid.x a
// multiple of cl) and `smem` bytes of dynamic shared memory. Sizes above 8
// blocks are allowed where the card takes them (16 on an H100). The
// kernel's attributes are set on its first launch on the current device
// and when a launch there needs more shared memory than set before (kept
// per kernel and device, since attributes belong to a device's context,
// so a call pays for no attribute calls once warm). `after_previous`: a
// programmatic dependent launch, whose blocks may start before the
// previous kernel on the stream has finished and must execute
// wait_previous() before they read what it wrote. Returns the launch's
// cudaError_t.
constexpr int MAX_DEVICES = 64;

template <auto Kernel, typename... Args>
cudaError_t launch(dim3 grid, int threads, int cl, int smem,
                   cudaStream_t stream, bool after_previous, Args... args) {
  // 1 + the shared-memory bytes set on each device; 0: nothing set yet
  static int smem_set[MAX_DEVICES];
  const auto kernel = Kernel;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem + 1 > smem_set[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    if (smem_set[dev] == 0) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
    }
    smem_set[dev] = smem + 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = after_previous ? 2 : 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace sdt_cluster
