// Epsilon-greedy action selection over an (E, A) Q-matrix: per env, the
// greedy action (argmax, the lowest index on ties, a NaN counted as the
// maximum as torch.argmax and jnp.argmax count it), replaced by a uniform
// random action when a coin falls below eps.
//
// Replaces: purejaxql_tpu/ops/pallas_explore.py `_eps_greedy_kernel` (called
// by `eps_greedy_pallas`), which holds the whole (E, A) block in VMEM, pads E
// to 8 rows and draws two words per env from the TPU's hardware PRNG. Here
// the grid covers any E, and the words come from Philox4x32-10
// (csrc/philox.cuh): one call per env, counter (0, e, 0, 0), key the
// wrapper's 64-bit seed. Word 0 is the coin, u = (w0 >> 8) / 2^24; word 1
// the random action, (w1 >> 8) % A: the TPU kernel's use of its two words
// (pallas_explore.py:31-38). The plain twin (ops/eps_greedy.py) draws the
// same words.
//
// Bound on an H100: the work reads E * A floats and writes E ints, with one
// compare per element and one Philox call per env: bytes bound it (about
// 143 KB at the Craftax trainer's E 1024, A 34), and at that size the
// launch itself dominates: an empty kernel on the same grid takes about
// half of the first design's 1.75 us on the device.
//
// What held the first design back: lane 0 began its Philox call only after
// the argmax reduction, five rounds of two shuffles each through a
// branching comparison, so the row's load, the reduction and Philox ran one
// after another.
//
// Design: one warp per env row, 8 rows per block of 256 threads (one wave
// at E 1024). Each lane issues the loads of its elements (a, a + 32, ...)
// first; lane 0 runs the Philox call while they are in flight. Each lane
// takes its local best by the argmax rule, then maps it to an
// order-preserving 32-bit key (every NaN above +inf, -0.0 on +0.0's key),
// and two warp instructions finish the argmax: __reduce_max_sync of the
// keys, then __reduce_min_sync of the indices of the lanes that hold that
// key (each lane's index the first of its best key, so the minimum is the
// first index of the row's).

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// An order-preserving key of v for the argmax: a larger value a larger key,
// every NaN the largest key of all (above +inf) and -0.0 the key of +0.0,
// so that equal values, and NaNs of any payload, tie.
__device__ __forceinline__ unsigned argmax_key(float v) {
  if (v != v) return 0xffffffffu;
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void eps_greedy_kernel(const float* __restrict__ q,
                                  long long* __restrict__ out, int E, int A,
                                  float eps, uint32_t k0, uint32_t k1) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (e >= E) return;
  const float* row = q + (long long)e * A;
  // the row's first two elements of each lane in flight before Philox
  const float v0 = lane < A ? __ldg(row + lane) : 0.0f;
  const float v1 = lane + 32 < A ? __ldg(row + lane + 32) : 0.0f;
  U4 w{0u, 0u, 0u, 0u};
  if (lane == 0) w = philox4x32_10(U4{0u, (uint32_t)e, 0u, 0u}, k0, k1);
  // the lane's best: the first of its largest keys (key 0 where it has no
  // element; every real element's key is above it)
  unsigned best = 0u;
  int best_i = A;
  if (lane < A) {
    best = argmax_key(v0);
    best_i = lane;
  }
  if (lane + 32 < A) {
    const unsigned k = argmax_key(v1);
    if (k > best) {
      best = k;
      best_i = lane + 32;
    }
  }
  for (int a = lane + 64; a < A; a += 32) {
    const unsigned k = argmax_key(__ldg(row + a));
    if (k > best) {
      best = k;
      best_i = a;
    }
  }
  const unsigned top = __reduce_max_sync(0xffffffffu, best);
  const int greedy = (int)__reduce_min_sync(0xffffffffu, best == top ? (unsigned)best_i : 0xffffffffu);
  if (lane == 0) {
    const bool take_random = unit24(w.x) < eps;
    const int random_action = (int)((w.y >> 8) % (uint32_t)A);
    out[e] = take_random ? random_action : greedy;
  }
}

}  // namespace

extern "C" {

// Launches ceil(E / 8) blocks of 256 threads on `stream`; returns the
// launch's cudaError_t (0 on success). The wrapper checks q is a contiguous
// (E, A) float32 matrix with A >= 1 and out an (E,) int64 vector.
int eps_greedy_f32(const float* q, long long* out, int E, int A, float eps,
                   unsigned long long seed, void* stream) {
  const int blocks = (E + kWarpsPerBlock - 1) / kWarpsPerBlock;
  eps_greedy_kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      q, out, E, A, eps, (uint32_t)(seed & 0xffffffffull),
      (uint32_t)(seed >> 32));
  return (int)cudaGetLastError();
}

const char* eps_greedy_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
