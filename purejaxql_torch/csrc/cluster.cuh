// What every thread-block-cluster kernel of the port shares (the GRU scan,
// csrc/gru_cluster.cuh; the MinAtar CNN, csrc/minatar_cluster.cuh; the
// Pendulum rollout): the exchange between the CTAs of a cluster through
// distributed shared memory, and the cluster launch.
//
// The exchange. A CTA sends values into the shared memory of another CTA
// of its cluster (itself included) with st.async (4 or 16 bytes from its
// registers) or cp.async.bulk (a 16-byte-aligned block of its own shared
// memory); once written, each counts its bytes against an mbarrier in the
// receiving CTA.
// The receiver arms the mbarrier of a slot with the bytes the whole cluster
// sends into it (mbarrier.arrive.expect_tx, one arrival), and its threads
// wait on the slot's phase: a CTA waits for the data it reads and for
// nothing else, with no cluster-wide barrier. Each kernel alternates two
// slots and states why no slot is overwritten before it is read.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace dsmem {

namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the address of the same shared variable in CTA `rank` of the cluster
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// v into `dst` (a shared::cluster address), its 4 bytes counted on `bar`
__device__ __forceinline__ void st_async(unsigned dst, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// v (16 bytes) into `dst` (a shared::cluster address, 16-byte aligned),
// counted on `bar`
__device__ __forceinline__ void st_async4(unsigned dst, float4 v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
               :: "r"(dst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
                  "r"(__float_as_uint(v.w)), "r"(bar) : "memory");
}

// v into the same place in every CTA of the cluster (`local` is this CTA's
// shared address of it, `bar` of the slot's mbarrier)
__device__ __forceinline__ void send_all(unsigned local, float v, unsigned bar, int C) {
  for (int rank = 0; rank < C; ++rank) st_async(cluster_addr(local, rank), v, cluster_addr(bar, rank));
}

// this thread's shared-memory writes, seen by the async proxy (a bulk copy);
// each writing thread runs it before the block barrier that precedes the copy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` (a multiple of 16) from this CTA's `src` to the same offset `dst`
// (this CTA's address of it) in CTA `rank`, counted on that CTA's copy of
// the mbarrier `bar`
__device__ __forceinline__ void copy_to(int rank, const void* dst, const void* src, unsigned bytes,
                                        const void* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(cluster_addr(smem_addr(dst), rank)), "r"(smem_addr(src)), "r"(bytes),
         "r"(cluster_addr(smem_addr(bar), rank)) : "memory");
}

__device__ __forceinline__ void bar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
}

// one thread: the slot's next phase completes when `bytes` have arrived
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Wait for the phase of `bars[slot]` whose parity bit `slot` of `parity`
// holds, flip that bit, and let the block pass only when every thread has
// seen the phase complete (so that the slot can then be re-armed).
__device__ __forceinline__ void wait_slot(unsigned long long* bars, int slot, unsigned& parity) {
  bar_wait(smem_addr(&bars[slot]), (parity >> slot) & 1);
  parity ^= 1u << slot;
  __syncthreads();
}

// after the mbarriers' init (and first arming): every CTA of the cluster
// runs and sees them before any remote store reaches it
__device__ __forceinline__ void cluster_start() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  cg::this_cluster().sync();
}

// `kernel` set up for clusters of C CTAs with `smem` bytes of dynamic
// shared memory each, and `cfg` (whose attribute is `attr`) for `clusters`
// of them on `stream`; returns a cudaError_t.
template <typename... Params>
cudaError_t cluster_config(void (*kernel)(Params...), int C, int clusters, int threads, int smem,
                           cudaStream_t stream, cudaLaunchAttribute* attr, cudaLaunchConfig_t& cfg) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of C CTAs with `smem` bytes each the card places at
// once (cudaOccupancyMaxActiveClusters), or minus the cudaError_t.
template <typename... Params>
int active_clusters(void (*kernel)(Params...), int C, int threads, int smem) {
  (void)cudaGetLastError();
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(kernel, C, 1, threads, smem, 0, attr, cfg);
  int active = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  return err == cudaSuccess ? active : -(int)err;
}

// Launch `kernel` as clusters of C CTAs, `clusters` of them, with `smem`
// bytes of dynamic shared memory each. A cluster the card cannot place
// (size, shared memory, cudaOccupancyMaxActiveClusters = 0) returns its
// error; nothing retries with another plan. Returns a cudaError_t.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int C, int clusters, int threads, int smem,
                    cudaStream_t stream, Args... args) {
  // an error an earlier call returned is not this call's (each library links
  // its own runtime, so nothing else clears it; a fault on the device is
  // sticky and comes back from the launch)
  (void)cudaGetLastError();
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(kernel, C, clusters, threads, smem, stream, attr, cfg);
  if (err != cudaSuccess) return (int)err;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active == 0) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace dsmem
