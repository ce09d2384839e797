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
// bandwidth roof.
//
// What bounded the old design, and by how much: one block of H threads per
// env ran the three MLPs back to back, each with a warp per output row of
// layer 2 walking its 32 rows one after the other (two float4 loads from
// L2 and a 5-shuffle reduction each: 32 dependent L2 round trips a layer)
// and about 12 block barriers for its LayerNorms and head. 1.93 ms a launch
// at (T 32, B 64, H 256), about 60 us a step, 150x the operation bound, on
// 64 of the 132 SMs.
//
// Design (the plan is ops/pendulum_rollout.py `pendulum_plan`): a
// thread-block cluster of C CTAs takes a group of G envs (1, 2, 4 or 8);
// the grid is ceil(B / G) clusters. CTA c owns the U = H / C output units
// [c U, (c + 1) U) of layer 2 of each of the three MLPs and holds those rows
// of the three W2s in shared memory for the whole rollout (H <= 512; above,
// it reads them from L2 every step). The plan takes C 16 and G 8 at the
// trainer's (B 64, H 256): on an H100 C 4, 8 and 16 ran 0.736, 0.567 and
// 0.459 ms (scripts/time_rollouts.py). Each step:
//   1. each warp g < G runs env g's per-env work (the Philox draw, the
//      observation, layer 1 and the two-pass LayerNorm of the actor, lane l
//      taking units l, l + 32, ..., in registers at H 256), with the same
//      bits on every CTA;
//   2. the CTA forms its U units of the actor's layer 2 for all G envs, a
//      (G x H) . (H x U) product: a thread a unit and a chunk of k, the G
//      envs' sums in registers, the chunks of a unit on adjacent lanes added
//      by a butterfly; and sends the G x U block to every CTA of the cluster
//      (a bulk copy each, counted on the slot's mbarrier there: one block to
//      all, which bulk copies send faster than 16-byte stores);
//   3. warp g gathers env g's H layer-2 values from the C blocks, runs LN2,
//      the head, tanh, the noise and the clip, then layer 1 of both critics
//      at (obs, u);
//   4. the CTA forms its units of both critics' layer 2 and sends them (a
//      second exchange);
//   5. warp g runs both critics' LN2 and heads, the value, the physics and
//      the reset; CTA 0 writes the outputs.
// Two exchanges a step and no block-wide reduction: every LayerNorm is a
// warp's. The physics is written with explicitly rounded operations (no
// fused multiply-add) in the TPU kernel's order, as the plain twin computes
// it.
//
// The slots: the actor's exchange goes to slot 0, the critics' to slot 1,
// each with its mbarrier. A CTA sends step t + 1's actor block only after
// it has every CTA's critic block of step t, which each CTA sends after it
// has read step t's actor blocks; it sends step t + 1's critic blocks only
// after it has every CTA's actor block of step t + 1, which each CTA sends
// after it has read step t's critic blocks. The same order keeps each
// staging block (the bulk copies' source) from being rewritten before every
// copy from it has landed.
//
// Randomness: Philox4x32-10 (philox.cuh) keyed by the wrapper's 64-bit
// seed, one call per step and env at counter (t, env, 0, 0): words 0 and 1
// feed Box-Muller, words 2 and 3 are the reset draws (the counterpart of
// prng_seed(seed + t) at pallas_rollout.py:2184). With use_prng = 0 the
// noise is 0 and a reset goes to the zero state (pallas_rollout.py:2204-2207).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "philox.cuh"

namespace {

using namespace dsmem;

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr float kMaxSpeed = 8.0f;
constexpr float kMaxTorque = 2.0f;
constexpr float kDt = 0.05f;
constexpr float kGravityTerm = 15.0f;  // 3 g / (2 l)
constexpr float kTorqueTerm = 3.0f;    // 3 / (m l^2)
constexpr float kUnit24 = 1.0f / 16777216.0f;
constexpr int kThreads = 256;
// a cluster takes up to 8 envs, a warp an env in the per-env phases
static_assert(kThreads / 32 == 8, "a warp for each of 8 envs");

// One MLP's weights in torch layout: W1 (H, n_in), b1, LN1 scale and bias,
// W2 (H, H), b2, LN2 scale and bias, head W (1, H), head b (1).
struct Mlp {
  const float *w1, *b1, *l1s, *l1b, *w2, *b2, *l2s, *l2b, *hw, *hb;
};

struct AcWeights {
  Mlp net[3];  // actor, critic 0, critic 1
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Threads a row of a layer-2 product takes (ops/pendulum_rollout.py _split):
// the largest power of two KS <= 32 with KS rows <= kThreads and a quad of k
// for each of them.
__host__ __device__ inline int split_of(int rows, int H) {
  int ks = 1;
  while (ks < 32 && 2 * ks * rows <= kThreads && 8 * ks <= H) ks *= 2;
  return ks;
}

// A row of the W2 slice in shared memory: H floats, padded so that the
// critics' pass (2 U rows) reads it without bank conflicts.
__host__ __device__ inline int row_stride(int H, int U) {
  const int ks = split_of(2 * U, H);
  return H + (ks >= 8 ? 0 : 4 * ks);
}

// Floats of dynamic shared memory a CTA takes (ops/pendulum_rollout.py
// pendulum_smem_bytes / 4): the two mbarriers (4), the W2 slices 3 x U x
// row_stride where resident, layer-1 activations 2 x G x H, the staging
// blocks of the two exchanges (G x U and 2 x G x U, padded to 4 floats), C
// received blocks of each, and where each unit's layer-2 value sits in a
// received block (H ints).
__host__ __device__ inline int smem_floats(int H, int C, int G, bool resident) {
  const int U = H / C;
  const int blk0 = round4(G * U), blk1 = round4(2 * G * U);
  return 4 + (resident ? 3 * U * row_stride(H, U) : 0) + 2 * G * H + (blk0 + blk1) * (1 + C) + H;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Layer 1 (N_IN -> H), the two-pass LayerNorm (eps 1e-6) of
// pallas_rollout.py `_layer_norm0` and relu, for one env on a warp: lane l
// takes units l, l + 32, ...; into y[0 .. H). NU > 0 (H = 32 NU): the
// lane's NU units in registers, each pass unrolled; NU = 0: any H, a pass
// over y a step of the LayerNorm.
template <int N_IN, int NU>
__device__ void layer1(const Mlp& w, const float (&x)[N_IN], float* y, int H, int lane) {
  if constexpr (NU > 0) {
    float a[NU];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const int u = lane + 32 * i;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < N_IN; ++k) acc += __ldg(w.w1 + u * N_IN + k) * x[k];
      a[i] = acc + __ldg(w.b1 + u);
      sum += a[i];
    }
    const float mu = warp_sum(sum) / (float)H;
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      a[i] -= mu;
      ss += a[i] * a[i];
    }
    const float inv = 1.0f / sqrtf(warp_sum(ss) / (float)H + 1e-6f);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const int u = lane + 32 * i;
      y[u] = fmaxf(a[i] * inv * __ldg(w.l1s + u) + __ldg(w.l1b + u), 0.0f);
    }
  } else {
    float sum = 0.0f;
    for (int u = lane; u < H; u += 32) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < N_IN; ++k) acc += __ldg(w.w1 + u * N_IN + k) * x[k];
      acc += __ldg(w.b1 + u);
      y[u] = acc;
      sum += acc;
    }
    const float mu = warp_sum(sum) / (float)H;
    float ss = 0.0f;
    for (int u = lane; u < H; u += 32) {
      const float d = y[u] - mu;
      ss += d * d;
    }
    const float inv = 1.0f / sqrtf(warp_sum(ss) / (float)H + 1e-6f);
    for (int u = lane; u < H; u += 32) {
      y[u] = fmaxf((y[u] - mu) * inv * __ldg(w.l1s + u) + __ldg(w.l1b + u), 0.0f);
    }
  }
}

// LN2 (two-pass), relu and the head of one env on a warp, whose layer-2
// unit u = r U + j (bias included) the cluster's CTA r sent to src[r blk +
// j], (r, j) = (at[u] >> 16, at[u] & 0xffff); y[0 .. H) is scratch where
// NU = 0 (as layer1). Every lane gets the MLP's output.
template <int NU>
__device__ float ln_head(const Mlp& w, const float* src, int blk, int H, const int* at, float* y, int lane) {
  float out = 0.0f;
  if constexpr (NU > 0) {
    float a[NU];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const int rj = at[lane + 32 * i];
      a[i] = src[(rj >> 16) * blk + (rj & 0xffff)];
      sum += a[i];
    }
    const float mu = warp_sum(sum) / (float)H;
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      a[i] -= mu;
      ss += a[i] * a[i];
    }
    const float inv = 1.0f / sqrtf(warp_sum(ss) / (float)H + 1e-6f);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const int u = lane + 32 * i;
      out += __ldg(w.hw + u) * fmaxf(a[i] * inv * __ldg(w.l2s + u) + __ldg(w.l2b + u), 0.0f);
    }
  } else {
    float sum = 0.0f;
    for (int u = lane; u < H; u += 32) {
      const int rj = at[u];
      const float v = src[(rj >> 16) * blk + (rj & 0xffff)];
      y[u] = v;
      sum += v;
    }
    const float mu = warp_sum(sum) / (float)H;
    float ss = 0.0f;
    for (int u = lane; u < H; u += 32) {
      const float d = y[u] - mu;
      ss += d * d;
    }
    const float inv = 1.0f / sqrtf(warp_sum(ss) / (float)H + 1e-6f);
    for (int u = lane; u < H; u += 32) {
      out += __ldg(w.hw + u) * fmaxf((y[u] - mu) * inv * __ldg(w.l2s + u) + __ldg(w.l2b + u), 0.0f);
    }
  }
  return warp_sum(out) + __ldg(w.hb);
}

// This CTA's U units of layer 2 of the n MLPs net[m0 ..] for the G envs,
// bias included: stage[(i G + g) U + j] = b2[u0 + j] + sum_k h1[i][g][k]
// W2[u0 + j][k] for MLP m0 + i. Thread (row = i U + j, chunk k of KS), the
// chunk the quads of k it walks k, k + KS, ...; the G sums in registers,
// added over the chunks by a butterfly.
template <bool RES, int KG>
__device__ void layer2_slice(const AcWeights& w, int m0, int n, const float* w2s, int Hs, const float* h1,
                             float* stage, int H, int U, int u0) {
  constexpr int G = KG;
  const int rows = n * U, ks = split_of(rows, H), tid = threadIdx.x;
  const int row = tid / ks, k = tid - (tid / ks) * ks;
  const bool valid = row < rows;
  const int i = valid ? row / U : 0, j = valid ? row - i * U : 0;
  const Mlp& net = i == 0 ? w.net[m0] : w.net[m0 + 1];
  const float bias = valid ? __ldg(net.b2 + u0 + j) : 0.0f;
  const float* wrow = RES ? w2s + ((m0 + i) * U + j) * Hs : net.w2 + (size_t)(u0 + j) * H;
  const float* x = h1 + i * G * H;
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;
  if (valid) {
    for (int q = k; q < H / 4; q += ks) {
      const float4 wv = RES ? *reinterpret_cast<const float4*>(wrow + 4 * q)
                            : __ldg(reinterpret_cast<const float4*>(wrow + 4 * q));
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 hv = *reinterpret_cast<const float4*>(x + g * H + 4 * q);
        acc[g] = fmaf(hv.w, wv.w, fmaf(hv.z, wv.z, fmaf(hv.y, wv.y, fmaf(hv.x, wv.x, acc[g]))));
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    for (int o = 1; o < ks; o <<= 1) acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], o);
    if (valid && k == 0) stage[(i * G + g) * U + j] = acc[g] + bias;
  }
  fence_proxy_async();
}

// RES: the W2 slices in shared memory (H <= 512); else read from L2. KG:
// the envs a cluster takes (ops/pendulum_rollout.py pendulum_plan's group).
// NU: a lane's units in the per-env work, 8 at the trainer's H 256 (held
// in registers), else 0 (any H).
template <bool RES, int KG, int NU>
__global__ void __launch_bounds__(kThreads) pendulum_ac_rollout_kernel(
    AcWeights wts, const float* __restrict__ stf0, const int* __restrict__ sti0,
    float* __restrict__ obs_out, float* __restrict__ u_out, float* __restrict__ greedy_out,
    float* __restrict__ value_out, float* __restrict__ rew_out, float* __restrict__ done_out,
    float* __restrict__ final_obs, float* __restrict__ stf_out, int* __restrict__ sti_out, int T,
    int B, int H, uint32_t key0, uint32_t key1, float noise, int use_prng, int max_steps,
    int linspace_noise) {
  constexpr int G = KG;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int U = H / C, u0 = rank * U, Hs = row_stride(H, U);
  const int blk0 = round4(G * U), blk1 = round4(2 * G * U);
  const int tid = threadIdx.x, lane = tid & 31, g = tid >> 5;
  // the CTA this thread sends the bulk copies to: lanes 0 and 1 of each warp
  // (a copy's operands are uniform, so the copies of one warp issue in turn)
  const int dst = lane * (kThreads / 32) + g;

  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(base);  // [2]
  float* w2s = base + 4;                          // RES: [3][U][Hs]
  float* h1 = w2s + (RES ? 3 * U * Hs : 0);      // [2][G][H]
  float* stage0 = h1 + 2 * G * H;                // [G][U], padded to blk0
  float* stage1 = stage0 + blk0;                 // [2][G][U], padded to blk1
  float* recv0 = stage1 + blk1;                  // [C][blk0]
  float* recv1 = recv0 + C * blk0;               // [C][blk1]
  int* at = reinterpret_cast<int*>(recv1 + C * blk1);  // [H]: (r, j) of unit u

  if (RES) {
    for (int i = tid; i < 3 * U * H; i += blockDim.x) {
      const int m = i / (U * H), rest = i - m * U * H;
      const int j = rest / H, k = rest - j * H;
      w2s[(m * U + j) * Hs + k] = wts.net[m].w2[(size_t)(u0 + j) * H + k];
    }
  }
  for (int u = tid; u < H; u += blockDim.x) at[u] = (u / U) << 16 | (u % U);
  if (tid == 0) {
    bar_init(smem_addr(&bars[0]));
    bar_init(smem_addr(&bars[1]));
    bar_expect(smem_addr(&bars[0]), 4u * C * blk0);
    bar_expect(smem_addr(&bars[1]), 4u * C * blk1);
  }
  cluster_start();

  // warp g < G: env b of the cluster; every CTA runs it on the same bits,
  // CTA 0 writes it out
  const int b = (int)(blockIdx.x / C) * G + g;
  const bool env_warp = g < G, real = env_warp && b < B, writer = real && rank == 0;
  float theta = 0.0f, thdot = 0.0f, last_u = 0.0f;
  int time = 0;
  if (real) {
    theta = stf0[b];
    thdot = stf0[B + b];
    last_u = stf0[2 * B + b];
    time = sti0[b];
  }
  // the env's std on the ladder: lane * (noise / max(B - 1, 1))
  const float std = linspace_noise ? (float)b * __fdiv_rn(noise, (float)max(B - 1, 1)) : noise;
  float* y0 = h1 + g * H;        // the warp's env in h1[0] and h1[1]
  float* y1 = h1 + (G + g) * H;
  unsigned parity = 0;  // bit i: the phase of mbarrier i to wait for

  for (int t = 0; t < T; ++t) {
    const long tb = (long)t * B + b;
    float z = 0.0f, rtheta = 0.0f, rthdot = 0.0f, obs[3] = {0.0f, 0.0f, 0.0f};
    if (env_warp) {
      if (use_prng) {
        const U4 r = philox4x32_10(U4{(uint32_t)t, (uint32_t)b, 0u, 0u}, key0, key1);
        const float u1 = (float)((r.x >> 8) + 1u) * kUnit24;  // (0, 1]
        const float u2 = (float)(r.y >> 8) * kUnit24;         // [0, 1)
        z = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
        rtheta = (unit24(r.z) * 2.0f - 1.0f) * kPi;
        rthdot = unit24(r.w) * 2.0f - 1.0f;
      }
      obs[0] = cosf(theta);
      obs[1] = sinf(theta);
      obs[2] = thdot;
      if (writer && lane < 3) obs_out[tb * 3 + lane] = obs[lane];
      layer1<3, NU>(wts.net[0], obs, y0, H, lane);
    }
    __syncthreads();
    // the actor's layer 2: this CTA's units to every CTA (a bulk copy each)
    layer2_slice<RES, G>(wts, 0, 1, w2s, Hs, h1, stage0, H, U, u0);
    __syncthreads();
    if (dst < C) copy_to(dst, recv0 + rank * blk0, stage0, 4u * blk0, &bars[0]);
    wait_slot(bars, 0, parity);
    if (tid == 0 && t + 1 < T) bar_expect(smem_addr(&bars[0]), 4u * C * blk0);

    float greedy = 0.0f, u = 0.0f;
    if (env_warp) {
      greedy = tanhf(ln_head<NU>(wts.net[0], recv0 + g * U, blk0, H, at, y0, lane)) * kMaxTorque;
      u = fminf(fmaxf(greedy + z * std * kMaxTorque, -kMaxTorque), kMaxTorque);
      const float cx[4] = {obs[0], obs[1], obs[2], u};
      layer1<4, NU>(wts.net[1], cx, y0, H, lane);
      layer1<4, NU>(wts.net[2], cx, y1, H, lane);
    }
    __syncthreads();
    // both critics' layer 2
    layer2_slice<RES, G>(wts, 1, 2, w2s, Hs, h1, stage1, H, U, u0);
    __syncthreads();
    if (dst < C) copy_to(dst, recv1 + rank * blk1, stage1, 4u * blk1, &bars[1]);
    wait_slot(bars, 1, parity);
    if (tid == 0 && t + 1 < T) bar_expect(smem_addr(&bars[1]), 4u * C * blk1);

    if (env_warp) {
      const float v0 = ln_head<NU>(wts.net[1], recv1 + g * U, blk1, H, at, y0, lane);
      const float v1 = ln_head<NU>(wts.net[2], recv1 + (G + g) * U, blk1, H, at, y1, lane);
      // physics (pendulum.py step_env) in pallas_rollout.py:2226-2241's order
      const float shifted = __fadd_rn(theta, kPi);
      const float angle = __fsub_rn(
          __fsub_rn(shifted, __fmul_rn(kTwoPi, floorf(__fdiv_rn(shifted, kTwoPi)))), kPi);
      const float cost = __fadd_rn(
          __fadd_rn(__fmul_rn(angle, angle), __fmul_rn(__fmul_rn(0.1f, thdot), thdot)),
          __fmul_rn(__fmul_rn(0.001f, u), u));
      float newthdot = __fadd_rn(
          thdot,
          __fmul_rn(__fadd_rn(__fmul_rn(kGravityTerm, sinf(theta)), __fmul_rn(kTorqueTerm, u)), kDt));
      newthdot = fminf(fmaxf(newthdot, -kMaxSpeed), kMaxSpeed);
      const float newth = __fadd_rn(theta, __fmul_rn(newthdot, kDt));
      const int ntime = time + 1;
      const bool done = ntime >= max_steps;

      if (writer && lane == 0) {
        u_out[tb] = u;
        greedy_out[tb] = greedy;
        value_out[tb] = 0.5f * (v0 + v1);
        rew_out[tb] = -cost;
        done_out[tb] = done ? 1.0f : 0.0f;
      }
      theta = done ? rtheta : newth;
      thdot = done ? rthdot : newthdot;
      last_u = done ? 0.0f : u;
      time = done ? 0 : ntime;
    }
  }
  if (writer && lane == 0) {
    stf_out[b] = theta;
    stf_out[B + b] = thdot;
    stf_out[2 * B + b] = last_u;
    sti_out[b] = time;
    final_obs[b * 3] = cosf(theta);
    final_obs[b * 3 + 1] = sinf(theta);
    final_obs[b * 3 + 2] = thdot;
  }
  // no CTA leaves while a bulk copy may still read its shared memory
  cluster.sync();
}

}  // namespace

extern "C" {

// Launches ceil(B / group) clusters of `cluster` CTAs of 256 threads,
// `smem_bytes` of dynamic shared memory each, the W2 slices resident in
// shared memory or not (the plan of ops/pendulum_rollout.py
// pendulum_plan), on `stream`; returns a cudaError_t (0 on success). A plan
// the card refuses returns its error; nothing retries. `weights` is a host
// array of 30 device pointers: the actor's 10 tensors, then critic 0's and
// critic 1's. The wrapper checks shapes: H a multiple of 32 in [32, 1024],
// one hidden size, W2 16-byte aligned.
int pendulum_ac_rollout_f32(const void* const* weights, const float* stf0, const int* sti0,
                            float* obs_out, float* u_out, float* greedy_out, float* value_out,
                            float* rew_out, float* done_out, float* final_obs, float* stf_out,
                            int* sti_out, int T, int B, int H, unsigned long long seed,
                            float noise, int use_prng, int max_steps, int linspace_noise,
                            int cluster, int group, int resident, int smem_bytes, void* stream) {
  const bool cluster_ok = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16;
  const bool group_ok = group == 1 || group == 2 || group == 4 || group == 8;
  if (!cluster_ok || !group_ok || H % 32 || H < 32 || H > 1024 || H % cluster || 2 * (H / cluster) > kThreads ||
      smem_bytes < 4 * smem_floats(H, cluster, group, resident != 0))
    return (int)cudaErrorInvalidValue;
  AcWeights wts;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  for (int n = 0; n < 3; ++n) {
    const float* const* p = w + 10 * n;
    wts.net[n] = Mlp{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9]};
  }
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull), k1 = (uint32_t)(seed >> 32);
  const int clusters = (B + group - 1) / group;
  auto kernel = resident && H == 256
                    ? (group == 8 ? pendulum_ac_rollout_kernel<true, 8, 8>
                       : group == 4 ? pendulum_ac_rollout_kernel<true, 4, 8>
                       : group == 2 ? pendulum_ac_rollout_kernel<true, 2, 8>
                                    : pendulum_ac_rollout_kernel<true, 1, 8>)
              : resident ? (group == 8 ? pendulum_ac_rollout_kernel<true, 8, 0>
                            : group == 4 ? pendulum_ac_rollout_kernel<true, 4, 0>
                            : group == 2 ? pendulum_ac_rollout_kernel<true, 2, 0>
                                         : pendulum_ac_rollout_kernel<true, 1, 0>)
                         : (group == 8 ? pendulum_ac_rollout_kernel<false, 8, 0>
                            : group == 4 ? pendulum_ac_rollout_kernel<false, 4, 0>
                            : group == 2 ? pendulum_ac_rollout_kernel<false, 2, 0>
                                         : pendulum_ac_rollout_kernel<false, 1, 0>);
  return launch_clusters(kernel, cluster, clusters, kThreads, smem_bytes, (cudaStream_t)stream, wts, stf0, sti0,
                         obs_out, u_out, greedy_out, value_out, rew_out, done_out, final_obs, stf_out, sti_out,
                         T, B, H, k0, k1, noise, use_prng, max_steps, linspace_noise);
}

const char* pendulum_ac_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
