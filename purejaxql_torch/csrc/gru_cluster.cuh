// What the two GRU scan kernels (gru_scan_fwd.cu, gru_scan_bwd.cu) share:
// the lane layout, on top of the exchange between the CTAs of a
// thread-block cluster and the cluster launch of cluster.cuh.
//
// Each step every CTA sends its units' values to every CTA of the cluster,
// itself included, with st.async counted on the slot's mbarrier there. Two
// slots alternate. A CTA can write step t + 2 into a slot only after it
// has the step t + 1 values of every CTA, and each CTA sends those only
// after it has read step t from that slot, so no value is overwritten
// before it is read. A block barrier after each wait keeps a thread from
// re-arming a slot before every thread of the CTA has seen its phase
// complete.

#pragma once

#include "cluster.cuh"

namespace gru {

using namespace dsmem;

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

}  // namespace gru
