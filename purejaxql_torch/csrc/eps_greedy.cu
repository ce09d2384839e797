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
// launch itself dominates.
//
// Design: one warp per env row, 8 rows per block of 256 threads. Lanes
// stride over A, so a warp reads its row's floats consecutively; a shuffle
// reduction keeps (max, lowest index); lane 0 draws the words and writes
// the action.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// Whether (v, i) beats (w, j) as the argmax: a NaN beats any number, a larger
// value beats a smaller one, and among equals (or two NaNs) the lower index.
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  const bool v_nan = v != v, w_nan = w != w;
  if (v_nan != w_nan) return v_nan;
  if (!v_nan && v != w) return v > w;
  return i < j;
}

__global__ void eps_greedy_kernel(const float* __restrict__ q,
                                  long long* __restrict__ out, int E, int A,
                                  float eps, uint32_t k0, uint32_t k1) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (e >= E) return;
  const float* row = q + (long long)e * A;
  float best = 0.0f;
  int best_i = A;  // no element yet: any real one beats it
  for (int a = lane; a < A; a += 32) {
    const float v = row[a];
    if (best_i == A || beats(v, a, best, best_i)) {
      best = v;
      best_i = a;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, best, off);
    const int i = __shfl_down_sync(0xffffffffu, best_i, off);
    if (i < A && (best_i == A || beats(v, i, best, best_i))) {
      best = v;
      best_i = i;
    }
  }
  if (lane == 0) {
    const U4 w = philox4x32_10(U4{0u, (uint32_t)e, 0u, 0u}, k0, k1);
    const bool take_random = unit24(w.x) < eps;
    const int random_action = (int)((w.y >> 8) % (uint32_t)A);
    out[e] = take_random ? random_action : best_i;
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
