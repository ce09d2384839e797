// What the two GRU scan kernels (gru_scan_fwd.cu, gru_scan_bwd.cu) share:
// the lane layout, the per-step exchange between the CTAs of a thread-block
// cluster, and the cluster launch.
//
// The exchange. Each step every CTA sends its units' values to every CTA of
// the cluster, itself included, with st.async: a store into the remote
// CTA's shared memory that, once written, counts its bytes against an
// mbarrier there. A CTA arms the mbarrier of a slot with the bytes the whole
// cluster sends into it (mbarrier.arrive.expect_tx, one arrival), and its
// threads wait on the slot's phase. So a CTA waits for the data it reads and
// for nothing else: no cluster-wide barrier a step. Two slots alternate. A
// CTA can write step t + 2 into a slot only after it has the step t + 1
// values of every CTA, and each CTA sends those only after it has read step
// t from that slot, so no value is overwritten before it is read. A block
// barrier after each wait keeps a thread from re-arming a slot before every
// thread of the CTA has seen its phase complete.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace gru {

namespace cg = cooperative_groups;

// a unit's dot products run on kLanes lanes, kUnitsPerWarp units to a warp
// (ops/gru_scan.py UNITS_PER_WARP)
constexpr int kLanes = 16;
constexpr int kUnitsPerWarp = 32 / kLanes;

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// the sum over a unit's kLanes lanes: the butterfly leaves the same sum, in
// the same order, in each of them
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int m = kLanes / 2; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

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

// v into the same place in every CTA of the cluster (`local` is this CTA's
// shared address of it, `bar` of the slot's mbarrier)
__device__ __forceinline__ void send_all(unsigned local, float v, unsigned bar, int C) {
  for (int rank = 0; rank < C; ++rank) st_async(cluster_addr(local, rank), v, cluster_addr(bar, rank));
}

// this thread's shared-memory writes, seen by the async proxy (a bulk copy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` (a multiple of 16) from this CTA's shared address `src` to the
// shared::cluster address `dst`, counted on the mbarrier `bar` there
__device__ __forceinline__ void bulk_copy(unsigned dst, unsigned src, unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
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

// after the mbarriers' init (and first arming): every CTA of the cluster
// runs and sees them before any st.async reaches it
__device__ __forceinline__ void cluster_start() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  cg::this_cluster().sync();
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
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (C > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active == 0) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace gru
