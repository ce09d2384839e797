// Philox4x32-10 (Salmon et al., SC'11): the counter-based generator of
// every fused rollout kernel. A kernel keys it by the wrapper's 64-bit seed
// and counts over (step, env, draw group), so a draw depends on nothing but
// its coordinates. The plain twins run the same function in torch
// (ops/philox.py).

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
