// Philox4x32-10 (Salmon et al., SC'11): the counter-based generator of
// every fused rollout kernel. A kernel keys it by the wrapper's 64-bit seed
// and counts over (step, env, draw group), so a draw depends on nothing but
// its coordinates. The plain twins run the same function in torch
// (ops/philox.py, whose docstring lists each game's word layout: word w of
// step t for env b is lane w % 4 of the call with counter (t, b, w / 4, 0)).

#pragma once

#include <stdint.h>

struct U4 {
  uint32_t x, y, z, w;
};

static __device__ __forceinline__ U4 philox4x32_10(U4 c, uint32_t k0,
                                                   uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = U4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
  }
  return c;
}

// The first 4 * kCalls words of step t for env b into `words`, one call per
// thread: threads 0 .. kCalls - 1 each run one Philox call. The caller
// synchronizes the block before reading them.
template <int kCalls>
static __device__ __forceinline__ void step_words(uint32_t* words, int t, int b,
                                                  uint32_t k0, uint32_t k1) {
  const int k = threadIdx.x;
  if (k < kCalls) {
    const U4 r = philox4x32_10(U4{(uint32_t)t, (uint32_t)b, (uint32_t)k, 0u}, k0, k1);
    words[4 * k] = r.x;
    words[4 * k + 1] = r.y;
    words[4 * k + 2] = r.z;
    words[4 * k + 3] = r.w;
  }
}

// A word's top 24 bits as a float in [0, 1), in steps of 2^-24.
static __device__ __forceinline__ float unit24(uint32_t w) {
  return (float)(w >> 8) * (1.0f / 16777216.0f);
}
