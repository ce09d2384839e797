// Fused Pendulum actor-critic rollout: T env steps of the actor, the
// Gaussian noise ladder, the two-critic value, the Pendulum-v1 physics and
// auto-reset in one launch.
//
// Replaces: purejaxql_tpu/ops/pallas_rollout.py `_make_pendulum_ac_kernel`
// and `pendulum_ac_rollout_pallas`, which run the rollout as a sequential
// grid over T with the env batch on the 128 lanes (three MLPs as (H, B)
// matmuls in VMEM), a (T, 8, B) slab for the per-step scalars, and the TPU's
// hardware PRNG. The slab and the env-minor layout are sublane artefacts and
// are not kept: the outputs here are (T, B, ...) arrays.
//
// Bound on an H100: per env step the three MLPs are about 2 * (7 H + 3 H^2
// + 3 H) flops, 0.41 Mflop at H = 256, so about 0.8 Gflop a launch at the
// trainer's T = 32, B = 64; the float32 flops over the non-tensor-core peak
// give about 0.012 ms, while the 0.8 MB of weights are far below the
// bandwidth roof. In practice the kernel is bound by latency: T dependent
// steps, each three MLPs of block-wide reductions and barriers, with only B
// blocks in flight.
//
// Design (simple and right first, as csrc/cartpole_rollout.cu): one block
// per env, thread j owns hidden unit j. Each step runs the actor, then
// critic 0, then critic 1: layer 1 by thread j from the 3 or 4 inputs, a
// two-pass LayerNorm (eps 1e-6) as a block reduction, relu; layer 2 with one
// warp per output row reading the row from L2 as float4 (the H x H weights,
// 256 KiB each at H = 256, do not fit a block's shared memory together);
// LayerNorm, relu; the 256 -> 1 head as a block reduction. Thread 0 draws the
// step's Philox words, and after the critics runs the physics and the reset.
// The physics is written with explicitly rounded operations (no fused
// multiply-add) in the TPU kernel's order, as the plain twin computes it.
//
// Randomness: Philox4x32-10 (philox.cuh) keyed by the wrapper's 64-bit
// seed, one call per step and env at counter (t, env, 0, 0): words 0 and 1
// feed Box-Muller, words 2 and 3 are the reset draws (the counterpart of
// prng_seed(seed + t) at pallas_rollout.py:2184). With use_prng = 0 the
// noise is 0 and a reset goes to the zero state (pallas_rollout.py:2204-2207).

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr float kMaxSpeed = 8.0f;
constexpr float kMaxTorque = 2.0f;
constexpr float kDt = 0.05f;
constexpr float kGravityTerm = 15.0f;  // 3 g / (2 l)
constexpr float kTorqueTerm = 3.0f;    // 3 / (m l^2)
constexpr float kUnit24 = 1.0f / 16777216.0f;

// One MLP's weights in torch layout: W1 (H, n_in), b1, LN1 scale and bias,
// W2 (H, H), b2, LN2 scale and bias, head W (1, H), head b (1).
struct Mlp {
  const float *w1, *b1, *l1s, *l1b, *w2, *b2, *l2s, *l2b, *hw, *hb;
};

struct AcWeights {
  Mlp net[3];  // actor, critic 0, critic 1
};

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
__device__ float layer_norm_relu(float h, float scale, float bias, float* red, int H) {
  const float mu = block_sum(h, red) / (float)H;
  const float d = h - mu;
  const float var = block_sum(d * d, red) / (float)H;
  const float y = d * (1.0f / sqrtf(var + 1e-6f)) * scale + bias;
  return fmaxf(y, 0.0f);
}

// The MLP's scalar output at the N_IN inputs `x`, returned to every thread.
// `h1` and `h2` hold H floats each (16-byte aligned).
template <int N_IN>
__device__ float mlp2(const Mlp& w, const float (&x)[N_IN], float* h1, float* h2, float* red,
                      int H) {
  const int j = threadIdx.x, lane = j & 31, warp = j >> 5, nwarps = blockDim.x >> 5;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < N_IN; ++k) acc += w.w1[j * N_IN + k] * x[k];
  h1[j] = layer_norm_relu(acc + w.b1[j], w.l1s[j], w.l1b[j], red, H);
  __syncthreads();

  // layer 2 (H -> H): one warp per output row, float4 loads along the row
  const float4* h4 = reinterpret_cast<const float4*>(h1);
  for (int row = warp; row < H; row += nwarps) {
    const float4* wr = reinterpret_cast<const float4*>(w.w2 + (long)row * H);
    float s = 0.0f;
    for (int k = lane; k < H / 4; k += 32) {
      const float4 a = wr[k], b = h4[k];
      s += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    }
    s = warp_sum(s);
    if (lane == 0) h2[row] = s + w.b2[row];
  }
  __syncthreads();
  const float h = layer_norm_relu(h2[j], w.l2s[j], w.l2b[j], red, H);
  return block_sum(w.hw[j] * h, red) + w.hb[0];
}

__global__ void __launch_bounds__(1024) pendulum_ac_rollout_kernel(
    AcWeights wts, const float* __restrict__ stf0, const int* __restrict__ sti0,
    float* __restrict__ obs_out, float* __restrict__ u_out, float* __restrict__ greedy_out,
    float* __restrict__ value_out, float* __restrict__ rew_out, float* __restrict__ done_out,
    float* __restrict__ final_obs, float* __restrict__ stf_out, int* __restrict__ sti_out, int T,
    int B, int H, uint32_t key0, uint32_t key1, float noise, int use_prng, int max_steps,
    int linspace_noise) {
  extern __shared__ __align__(16) float smem[];
  float* h1 = smem;           // H
  float* h2 = smem + H;       // H
  float* red = smem + 2 * H;  // 33
  __shared__ float s_theta, s_thdot, s_last_u, s_z, s_rtheta, s_rthdot;
  __shared__ int s_time;

  const int b = blockIdx.x, j = threadIdx.x;
  if (j == 0) {
    s_theta = stf0[b];
    s_thdot = stf0[B + b];
    s_last_u = stf0[2 * B + b];
    s_time = sti0[b];
  }
  // the env's std on the ladder: lane * (noise / max(B - 1, 1))
  const float std = linspace_noise ? (float)b * __fdiv_rn(noise, (float)max(B - 1, 1)) : noise;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const long tb = (long)t * B + b;
    if (j == 0) {
      float z = 0.0f, rtheta = 0.0f, rthdot = 0.0f;
      if (use_prng) {
        const U4 r = philox4x32_10(U4{(uint32_t)t, (uint32_t)b, 0u, 0u}, key0, key1);
        const float u1 = (float)((r.x >> 8) + 1u) * kUnit24;  // (0, 1]
        const float u2 = (float)(r.y >> 8) * kUnit24;         // [0, 1)
        z = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
        rtheta = (unit24(r.z) * 2.0f - 1.0f) * kPi;
        rthdot = unit24(r.w) * 2.0f - 1.0f;
      }
      s_z = z;
      s_rtheta = rtheta;
      s_rthdot = rthdot;
    }
    const float theta = s_theta, theta_dot = s_thdot;
    const float obs[3] = {cosf(theta), sinf(theta), theta_dot};
    if (j < 3) obs_out[tb * 3 + j] = obs[j];

    // the actor, then the explored action (s_z is visible after the
    // actor's barriers)
    const float greedy = tanhf(mlp2<3>(wts.net[0], obs, h1, h2, red, H)) * kMaxTorque;
    const float u = fminf(fmaxf(greedy + s_z * std * kMaxTorque, -kMaxTorque), kMaxTorque);
    const float cx[4] = {obs[0], obs[1], obs[2], u};
    const float v0 = mlp2<4>(wts.net[1], cx, h1, h2, red, H);
    const float v1 = mlp2<4>(wts.net[2], cx, h1, h2, red, H);

    if (j == 0) {
      // physics (pendulum.py step_env) in pallas_rollout.py:2226-2241's order
      const float shifted = __fadd_rn(theta, kPi);
      const float angle = __fsub_rn(
          __fsub_rn(shifted, __fmul_rn(kTwoPi, floorf(__fdiv_rn(shifted, kTwoPi)))), kPi);
      const float cost = __fadd_rn(
          __fadd_rn(__fmul_rn(angle, angle), __fmul_rn(__fmul_rn(0.1f, theta_dot), theta_dot)),
          __fmul_rn(__fmul_rn(0.001f, u), u));
      float newthdot = __fadd_rn(
          theta_dot,
          __fmul_rn(__fadd_rn(__fmul_rn(kGravityTerm, sinf(theta)), __fmul_rn(kTorqueTerm, u)), kDt));
      newthdot = fminf(fmaxf(newthdot, -kMaxSpeed), kMaxSpeed);
      const float newth = __fadd_rn(theta, __fmul_rn(newthdot, kDt));
      const int ntime = s_time + 1;
      const bool done = ntime >= max_steps;

      u_out[tb] = u;
      greedy_out[tb] = greedy;
      value_out[tb] = 0.5f * (v0 + v1);
      rew_out[tb] = -cost;
      done_out[tb] = done ? 1.0f : 0.0f;
      s_theta = done ? s_rtheta : newth;
      s_thdot = done ? s_rthdot : newthdot;
      s_last_u = done ? 0.0f : u;
      s_time = done ? 0 : ntime;
      if (t == T - 1) {
        stf_out[b] = s_theta;
        stf_out[B + b] = s_thdot;
        stf_out[2 * B + b] = s_last_u;
        sti_out[b] = s_time;
        final_obs[b * 3] = cosf(s_theta);
        final_obs[b * 3 + 1] = sinf(s_theta);
        final_obs[b * 3 + 2] = s_thdot;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches one block of H threads per env on `stream`; returns the launch's
// cudaError_t (0 on success). `weights` is a host array of 30 device
// pointers: the actor's 10 tensors, then critic 0's and critic 1's. The
// wrapper checks shapes: H a multiple of 32 in [32, 1024], one hidden size,
// W2 16-byte aligned.
int pendulum_ac_rollout_f32(const void* const* weights, const float* stf0, const int* sti0,
                            float* obs_out, float* u_out, float* greedy_out, float* value_out,
                            float* rew_out, float* done_out, float* final_obs, float* stf_out,
                            int* sti_out, int T, int B, int H, unsigned long long seed,
                            float noise, int use_prng, int max_steps, int linspace_noise,
                            void* stream) {
  AcWeights wts;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  for (int n = 0; n < 3; ++n) {
    const float* const* p = w + 10 * n;
    wts.net[n] = Mlp{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9]};
  }
  const size_t smem = (size_t)(2 * H + 33) * sizeof(float);
  pendulum_ac_rollout_kernel<<<B, H, smem, (cudaStream_t)stream>>>(
      wts, stf0, sti0, obs_out, u_out, greedy_out, value_out, rew_out, done_out, final_obs,
      stf_out, sti_out, T, B, H, (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32), noise,
      use_prng, max_steps, linspace_noise);
  return (int)cudaGetLastError();
}

const char* pendulum_ac_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
