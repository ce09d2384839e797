// Fused CartPole rollout: T env steps of Q forward, epsilon-greedy, Euler
// physics and auto-reset in one launch.
//
// Replaces: purejaxql_tpu/ops/pallas_rollout.py `_make_cartpole_kernel` and
// `cartpole_rollout_pallas`, which run the rollout as a sequential grid
// over T with the env batch on the 128 lanes, the weights in VMEM, a head
// padded to 8 sublanes with a -1e9 bias, and the TPU's hardware PRNG.
//
// Bound on an H100: per env step the Q forward is about 2 * (4*H + H*H +
// H*A) flops, 133 kflop at H = 256, and the weights are 0.27 MB; at the
// trainer's B = 32, T = 64 the least time is the float32 flops over the
// non-tensor-core peak (a few microseconds), while the data moved is far
// below the bandwidth roof. In practice the kernel is bound by latency:
// T dependent steps, each a chain of block-wide reductions and barriers,
// with only B blocks in flight.
//
// Design (simple and right first): one block per env, thread j owns hidden
// unit j. LayerNorm is a two-pass block reduction; h1 and h2 sit in shared
// memory. The 256x256 W2 (256 KiB) does not fit in the 227 KB a block may
// have, so it is read from global memory, where it stays in L2 across
// blocks and steps: one warp per output row, lanes striding the row, so
// each load instruction covers 128 contiguous bytes. Thread 0 then does
// the argmax (first index wins ties, as jnp.argmax), the epsilon coin, the
// physics and the reset. The physics is written with explicitly rounded
// operations (no fused multiply-add) so that it rounds as the plain
// PyTorch twin does, op for op.
//
// Randomness: Philox4x32-10 (philox.cuh) keyed by the wrapper's 64-bit
// seed, counting over (step, env, draw group): the counterpart of
// prng_seed(seed + t) at pallas_rollout.py:491. With use_prng = 0 the coin
// is 1, the random action 0 and the reset state zero, as at
// pallas_rollout.py:525-528.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kMaxActions = 8;
constexpr float kGravity = 9.8f;
constexpr float kPolemassLength = 0.05f;
constexpr float kTotalMass = 1.1f;
constexpr float kLength = 0.5f;
constexpr float kMasspole = 0.1f;
constexpr float kForce = 10.0f;
constexpr float kTau = 0.02f;
constexpr float kFourThirds = (float)(4.0 / 3.0);
constexpr float kXThreshold = 2.4f;
constexpr float kThetaThreshold = (float)(12 * 2 * 3.141592653589793 / 360);
constexpr float kUnit24 = 1.0f / 16777216.0f;
constexpr float kResetScale = (float)(0.1 / 16777216.0);

__device__ __forceinline__ float reset_draw(uint32_t w) {
  return __fsub_rn(__fmul_rn((float)(w >> 8), kResetScale), 0.05f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread gets the total. `red` holds 33 floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < nwarps ? red[lane] : 0.0f;
    s = warp_sum(s);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  return red[32];
}

// Two-pass LayerNorm (eps 1e-6) over the block's H units, then relu: the
// formula of pallas_rollout.py `_layer_norm0`.
__device__ float layer_norm_relu(float h, float scale, float bias, float* red,
                                 int H) {
  const float mu = block_sum(h, red) / (float)H;
  const float d = h - mu;
  const float var = block_sum(d * d, red) / (float)H;
  const float y = d * (1.0f / sqrtf(var + 1e-6f)) * scale + bias;
  return fmaxf(y, 0.0f);
}

__global__ void __launch_bounds__(1024) cartpole_rollout_kernel(
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ ln1_scale, const float* __restrict__ ln1_bias,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ ln2_scale, const float* __restrict__ ln2_bias,
    const float* __restrict__ head_w, const float* __restrict__ head_b,
    const float* __restrict__ stf0, const int* __restrict__ sti0,
    float* __restrict__ obs_out, int* __restrict__ act_out,
    float* __restrict__ rew_out, int* __restrict__ done_out,
    float* __restrict__ q_out, float* __restrict__ final_obs,
    float* __restrict__ stf_out, int* __restrict__ sti_out, int T, int B,
    int H, int A, uint32_t key0, uint32_t key1, float eps, int use_prng,
    int max_steps) {
  extern __shared__ float smem[];
  float* h1 = smem;              // H
  float* h2 = smem + H;          // H
  float* red = smem + 2 * H;     // 33
  float* q = red + 33;           // kMaxActions
  float* st = q + kMaxActions;   // x, x_dot, theta, theta_dot
  __shared__ int s_time;

  const int b = blockIdx.x, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, nwarps = blockDim.x >> 5;
  if (j < 4) st[j] = stf0[j * B + b];
  if (j == 0) s_time = sti0[b];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const long tb = (long)t * B + b;
    const float s0 = st[0], s1 = st[1], s2 = st[2], s3 = st[3];
    if (j < 4) obs_out[tb * 4 + j] = st[j];

    // layer 1 (4 -> H), LN, relu: thread j owns unit j
    const float* w1r = w1 + j * 4;
    float h = w1r[0] * s0 + w1r[1] * s1 + w1r[2] * s2 + w1r[3] * s3 + b1[j];
    h1[j] = layer_norm_relu(h, ln1_scale[j], ln1_bias[j], red, H);
    __syncthreads();

    // layer 2 (H -> H): one warp per output row, coalesced along the row
    for (int row = warp; row < H; row += nwarps) {
      const float* wr = w2 + (long)row * H;
      float acc = 0.0f;
      for (int k = lane; k < H; k += 32) acc += wr[k] * h1[k];
      acc = warp_sum(acc);
      if (lane == 0) h2[row] = acc + b2[row];
    }
    __syncthreads();
    h = layer_norm_relu(h2[j], ln2_scale[j], ln2_bias[j], red, H);
    h2[j] = h;
    __syncthreads();

    // head (H -> A): warp a computes q[a]
    if (warp < A) {
      const float* wr = head_w + (long)warp * H;
      float acc = 0.0f;
      for (int k = lane; k < H; k += 32) acc += wr[k] * h2[k];
      acc = warp_sum(acc);
      if (lane == 0) q[warp] = acc + head_b[warp];
    }
    __syncthreads();

    if (j == 0) {
      int greedy = 0;
      float best = q[0];
      q_out[tb * A] = q[0];
      for (int a = 1; a < A; ++a) {
        q_out[tb * A + a] = q[a];
        if (q[a] > best) {
          best = q[a];
          greedy = a;
        }
      }
      float u = 1.0f;
      int rand_act = 0;
      float reset[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (use_prng) {
        const U4 r0 = philox4x32_10(U4{(uint32_t)t, (uint32_t)b, 0u, 0u}, key0, key1);
        const U4 r1 = philox4x32_10(U4{(uint32_t)t, (uint32_t)b, 1u, 0u}, key0, key1);
        u = (float)(r0.x >> 8) * kUnit24;
        rand_act = (int)((r0.y >> 8) % (uint32_t)A);
        reset[0] = reset_draw(r0.z);
        reset[1] = reset_draw(r0.w);
        reset[2] = reset_draw(r1.x);
        reset[3] = reset_draw(r1.y);
      }
      const int action = u < eps ? rand_act : greedy;
      const float a_f = (float)action;

      // physics (cartpole.py step_env, Euler), rounded op by op
      const float x = s0, x_dot = s1, theta = s2, theta_dot = s3;
      const float force = __fsub_rn(__fmul_rn(kForce, a_f),
                                    __fmul_rn(kForce, __fsub_rn(1.0f, a_f)));
      const float costh = cosf(theta);
      const float sinth = sinf(theta);
      const float temp = __fdiv_rn(
          __fadd_rn(force, __fmul_rn(__fmul_rn(__fmul_rn(kPolemassLength, theta_dot),
                                               theta_dot),
                                     sinth)),
          kTotalMass);
      const float thacc = __fdiv_rn(
          __fsub_rn(__fmul_rn(kGravity, sinth), __fmul_rn(costh, temp)),
          __fmul_rn(kLength,
                    __fsub_rn(kFourThirds,
                              __fdiv_rn(__fmul_rn(__fmul_rn(kMasspole, costh), costh),
                                        kTotalMass))));
      const float xacc = __fsub_rn(
          temp, __fdiv_rn(__fmul_rn(__fmul_rn(kPolemassLength, thacc), costh),
                          kTotalMass));
      float nx = __fadd_rn(x, __fmul_rn(kTau, x_dot));
      float nx_dot = __fadd_rn(x_dot, __fmul_rn(kTau, xacc));
      float nth = __fadd_rn(theta, __fmul_rn(kTau, theta_dot));
      float nth_dot = __fadd_rn(theta_dot, __fmul_rn(kTau, thacc));
      int ntime = s_time + 1;

      const bool done = fabsf(nx) > kXThreshold || fabsf(nth) > kThetaThreshold ||
                        ntime >= max_steps;
      // reward: 1 unless the INCOMING state was terminal
      const bool prev_done = fabsf(x) > kXThreshold ||
                             fabsf(theta) > kThetaThreshold || s_time >= max_steps;
      act_out[tb] = action;
      rew_out[tb] = prev_done ? 0.0f : 1.0f;
      done_out[tb] = done ? 1 : 0;
      if (done) {
        nx = reset[0];
        nx_dot = reset[1];
        nth = reset[2];
        nth_dot = reset[3];
        ntime = 0;
      }
      st[0] = nx;
      st[1] = nx_dot;
      st[2] = nth;
      st[3] = nth_dot;
      s_time = ntime;
      if (t == T - 1) {
        for (int k = 0; k < 4; ++k) {
          stf_out[k * B + b] = st[k];
          final_obs[b * 4 + k] = st[k];
        }
        sti_out[b] = ntime;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches one block of H threads per env on `stream`; returns the launch's
// cudaError_t (0 on success). The wrapper checks shapes: H a multiple of 32
// in [32, 1024], 1 <= A <= min(8, H / 32).
int cartpole_rollout_f32(const float* w1, const float* b1,
                         const float* ln1_scale, const float* ln1_bias,
                         const float* w2, const float* b2,
                         const float* ln2_scale, const float* ln2_bias,
                         const float* head_w, const float* head_b,
                         const float* stf0, const int* sti0, float* obs_out,
                         int* act_out, float* rew_out, int* done_out,
                         float* q_out, float* final_obs, float* stf_out,
                         int* sti_out, int T, int B, int H, int A,
                         unsigned long long seed, float eps, int use_prng,
                         int max_steps, void* stream) {
  const size_t smem = (size_t)(2 * H + 33 + kMaxActions + 4) * sizeof(float);
  cartpole_rollout_kernel<<<B, H, smem, (cudaStream_t)stream>>>(
      w1, b1, ln1_scale, ln1_bias, w2, b2, ln2_scale, ln2_bias, head_w, head_b,
      stf0, sti0, obs_out, act_out, rew_out, done_out, q_out, final_obs,
      stf_out, sti_out, T, B, H, A, (uint32_t)(seed & 0xffffffffull),
      (uint32_t)(seed >> 32), eps, use_prng, max_steps);
  return (int)cudaGetLastError();
}

const char* cartpole_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
