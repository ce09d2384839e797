// Q(lambda) returns, gymnax form: the reverse recurrence of
// purejaxql_tpu/algo/returns.py:46-64 over (T, E).
//
// Replaces: purejaxql_tpu/ops/pallas_returns.py `_lambda_kernel` (called by
// `lambda_returns_pallas`), which keeps the (T, E) operands in VMEM and
// pads E to 128 lanes. The padding is a TPU layout; here a ragged E is
// masked instead.
//
// Bound on an H100: the work is 3 reads and 1 write of T*E floats (plus
// last_q) and about ten flops per element, far below both roofs at the
// trainer's (64, 32): the kernel is bound by latency, the T - 1 dependent
// steps of the recurrence plus the launch itself.
//
// Design: one thread per env, looping t = T-2 ... 0 with the carry
// (lambda-return, next max-Q) in registers. E is the minor dimension, so at
// each t a warp's loads and stores cover 32 consecutive floats. The loads
// of a step do not depend on the carry; unrolling lets the compiler issue
// them ahead of the dependent arithmetic.

#include <cuda_runtime.h>

namespace {

__global__ void lambda_returns_kernel(const float* __restrict__ last_q,
                                      const float* __restrict__ rewards,
                                      const float* __restrict__ dones,
                                      const float* __restrict__ max_qs,
                                      float* __restrict__ out, int T, int E,
                                      float gamma, float gamma_lam) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  // Each operation is rounded on its own (no fused multiply-add), in the
  // order of the plain twin, so the two agree to the last bit.
  const long last = (long)(T - 1) * E + e;
  float next_q = __fmul_rn(last_q[e], __fsub_rn(1.0f, dones[last]));
  float lam_ret = __fadd_rn(rewards[last], __fmul_rn(gamma, next_q));
  out[last] = lam_ret;
#pragma unroll 8
  for (int t = T - 2; t >= 0; --t) {
    const long i = (long)t * E + e;
    const float r = rewards[i];
    const float d = dones[i];
    const float not_done = __fsub_rn(1.0f, d);
    const float target_bootstrap =
        __fadd_rn(r, __fmul_rn(__fmul_rn(gamma, not_done), next_q));
    const float delta = __fsub_rn(lam_ret, next_q);
    lam_ret = __fadd_rn(target_bootstrap, __fmul_rn(gamma_lam, delta));
    lam_ret = __fadd_rn(__fmul_rn(not_done, lam_ret), __fmul_rn(d, r));
    out[i] = lam_ret;
    next_q = max_qs[i];
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the launch's cudaError_t (0 on success).
int lambda_returns_f32(const float* last_q, const float* rewards,
                       const float* dones, const float* max_qs, float* out,
                       int T, int E, float gamma, float gamma_lam,
                       void* stream) {
  const int threads = 128;
  const int blocks = (E + threads - 1) / threads;
  lambda_returns_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      last_q, rewards, dones, max_qs, out, T, E, gamma, gamma_lam);
  return (int)cudaGetLastError();
}

const char* lambda_returns_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
