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
// below the bandwidth roof. The kernel is bound by latency: T dependent
// steps, each a chain of reductions, an exchange and the physics.
//
// What bounded the first design (one block of H threads an env): each of 8
// warps walked its 32 rows of W2 (256 KiB at H 256, read from L2) one after
// the other, 32 dependent L2 round trips and 5-shuffle reductions a step;
// the two LayerNorms took four block-wide sums of two barriers each; and
// thread 0 alone ran the argmax, Philox and the physics while 255 threads
// waited. 1.36 ms a launch at (B 32, T 64, H 256), about 21 us a step, on
// 32 of the 132 SMs.
//
// Design (the plan is ops/cartpole_rollout.py `cartpole_plan`), the actor
// half of csrc/pendulum_ac_rollout.cu: a thread-block cluster of C CTAs
// takes a group of G envs (1, 2, 4 or 8); the grid is ceil(B / G)
// clusters. CTA c owns the U = H / C output units [c U, (c + 1) U) of layer
// 2 and holds those rows of W2 in shared memory for the whole rollout (H <=
// 512; above, it reads them from L2 every step). Each step:
//   1. each warp g < G runs env g's per-env work with the same bits on
//      every CTA: the observation, layer 1 (4 -> H) and the two-pass
//      LayerNorm and relu as a warp reduction, lane l taking units l, l +
//      32, ... (in registers at H 256);
//   2. the CTA forms its U units of layer 2 for all G envs, a (G x H) .
//      (H x U) product: a thread a unit and a chunk of k, the G sums in
//      registers, the chunks of a unit on adjacent lanes added by a
//      butterfly; and sends the G x U block to every CTA of the cluster (a
//      bulk copy each, counted on the step's mbarrier there): one exchange
//      a step;
//   3. warp g gathers env g's H layer-2 values from the C blocks, runs LN2,
//      relu, the head, the argmax (a NaN counted as the maximum, the first
//      NaN and the first of equal values winning, as jnp.argmax and
//      torch.argmax), the coin, the physics and the reset, every lane on
//      the same values; CTA 0 writes the outputs.
// No block-wide reduction and no thread that the block waits on: every
// LayerNorm is a warp's. The step's random words come from shared memory:
// every kChunk steps all threads draw the next kChunk steps' words for the
// group's envs (Philox off the step's chain). The head's weights sit in
// shared memory too. At most 128 registers a thread (two CTAs an SM), so
// that the card places every cluster of the plan at once: at 176 it placed
// 7 clusters of 16 and 15 of 8, not 8 and 16, so that the rest waited for
// a second wave. The physics is written with explicitly rounded operations
// (no fused multiply-add) so that it rounds as the plain PyTorch twin does,
// op for op.
//
// What bounds it (scripts/probe_rollout_phases.py --cartpole on an H100,
// cycles a step at (B 32, T 64, H 256), C 4, G 1): layer 1 1.3K, the
// layer-2 slice 1.9K (its shared-memory loads; 3.7K at B 128, G 4), the
// exchange 0.6K, LN2 and the head 1.9K, the physics 1.0K. Every phase but
// layer 2 is one warp's chain of shuffles and dependent loads. Holding the
// lanes' parameters in registers (176 registers, one CTA an SM) and four
// rows a thread in layer 2 (more shuffles) ran slower.
//
// The slots: step t's exchange goes to slot t & 1 (a received block and a
// staging block each, and an mbarrier). A CTA sends step t + 2's block into
// slot t & 1 of another only after it has every CTA's block of step t + 1,
// which each CTA sends after it has read step t's blocks (the barriers of
// step t + 1 follow step t's LN2); and every copy of step t from a staging
// block has landed before the block is rewritten at step t + 2, since each
// CTA's block of step t + 1 is sent only once its step t slot is full.
//
// Randomness: Philox4x32-10 (philox.cuh) keyed by the wrapper's 64-bit
// seed, counting over (step, env, draw group): the counterpart of
// prng_seed(seed + t) at pallas_rollout.py:491. Word 0 of group 0 is the
// coin, word 1 the random action, words 2-3 and words 0-1 of group 1 the
// reset state. With use_prng = 0 the coin is 1, the random action 0 and
// the reset state zero, as at pallas_rollout.py:525-528.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "philox.cuh"

namespace {

using namespace dsmem;

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
constexpr float kResetScale = (float)(0.1 / 16777216.0);
constexpr int kThreads = 256;
constexpr int kChunk = 64;  // the steps whose random words a CTA draws at once
// a cluster takes up to 8 envs, a warp an env in the per-env phases
static_assert(kThreads / 32 == 8, "a warp for each of 8 envs");

// The network in torch layout: W1 (H, 4), b1, LN1 scale and bias, W2 (H,
// H), b2, LN2 scale and bias, head W (A, H), head b (A).
struct Weights {
  const float *w1, *b1, *l1s, *l1b, *w2, *b2, *l2s, *l2b, *hw, *hb;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Threads a row of the layer-2 slice takes (ops/cartpole_rollout.py
// _split): the largest power of two KS <= 32 with U KS <= kThreads and a
// quad of k for each of them.
__host__ __device__ inline int split_of(int U, int H) {
  int ks = 1;
  while (ks < 32 && 2 * ks * U <= kThreads && 8 * ks <= H) ks *= 2;
  return ks;
}

// A row of the W2 slice in shared memory: H floats, padded so that fewer
// than 8 threads a row read it without bank conflicts.
__host__ __device__ inline int row_stride(int H, int U) {
  const int ks = split_of(U, H);
  return H + (ks >= 8 ? 0 : 4 * ks);
}

// The random words of a step for an env, as the step uses them.
struct Draws {
  float coin;
  int rand_act;
  float reset[4];
};

// Floats of dynamic shared memory a CTA takes (ops/cartpole_rollout.py
// cartpole_smem_bytes / 4): the two mbarriers (4), the W2 slice U x
// row_stride where resident, layer-1 activations G x H, two staging blocks
// of G x U (padded to 4 floats), two slots of C received blocks, where
// each unit's layer-2 value sits in a slot (H ints), the draws of kChunk
// steps for G envs (6 words each), and the head's weights and biases
// (room for kMaxActions).
__host__ __device__ inline int smem_floats(int H, int C, int G, bool resident) {
  return 4 + resident * (H / C) * row_stride(H, H / C) + G * H + 2 * round4(G * (H / C)) * (1 + C) + H +
         6 * kChunk * G + kMaxActions * (H + 1);
}

__device__ __forceinline__ float reset_draw(uint32_t w) {
  return __fsub_rn(__fmul_rn((float)(w >> 8), kResetScale), 0.05f);
}

// s[k] for a k < 4 known only at run time, without a local-memory copy of s
__device__ __forceinline__ float pick4(const float (&s)[4], int k) {
  return k == 0 ? s[0] : k == 1 ? s[1] : k == 2 ? s[2] : s[3];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Layer 1 (4 -> H), the two-pass LayerNorm (eps 1e-6) of pallas_rollout.py
// `_layer_norm0` and relu, for one env on a warp: lane l takes units l, l +
// 32, ...; into y[0 .. H). NU > 0 (H = 32 NU): the lane's NU units in
// registers, each pass unrolled; NU = 0: any H, a pass over y a step of the
// LayerNorm.
template <int NU>
__device__ void layer1(const Weights& w, const float (&s)[4], float* y, int H, int lane) {
  if constexpr (NU > 0) {
    float a[NU];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const int u = lane + 32 * i;
      const float4 wr = __ldg(reinterpret_cast<const float4*>(w.w1) + u);
      a[i] = wr.x * s[0] + wr.y * s[1] + wr.z * s[2] + wr.w * s[3] + __ldg(w.b1 + u);
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
      const float4 wr = __ldg(reinterpret_cast<const float4*>(w.w1) + u);
      const float v = wr.x * s[0] + wr.y * s[1] + wr.z * s[2] + wr.w * s[3] + __ldg(w.b1 + u);
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
      y[u] = fmaxf((y[u] - mu) * inv * __ldg(w.l1s + u) + __ldg(w.l1b + u), 0.0f);
    }
  }
}

// LN2 (two-pass), relu and the head (hw, hb in shared memory) of one env
// on a warp, whose layer-2 unit u (bias included) sits at src[at[u]]; y[0
// .. H) is scratch where NU = 0 (as layer1). Every lane gets the A
// Q-values in q[0 .. A).
template <int NU>
__device__ void ln_head(const Weights& w, const float* hw, const float* hb, const float* src, const int* at,
                        float* y, int H, int A, int lane, float (&q)[kMaxActions]) {
#pragma unroll
  for (int a = 0; a < kMaxActions; ++a) q[a] = 0.0f;
  if constexpr (NU > 0) {
    float v[NU];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      v[i] = src[at[lane + 32 * i]];
      sum += v[i];
    }
    const float mu = warp_sum(sum) / (float)H;
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      v[i] -= mu;
      ss += v[i] * v[i];
    }
    const float inv = 1.0f / sqrtf(warp_sum(ss) / (float)H + 1e-6f);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const int u = lane + 32 * i;
      const float h = fmaxf(v[i] * inv * __ldg(w.l2s + u) + __ldg(w.l2b + u), 0.0f);
#pragma unroll
      for (int a = 0; a < kMaxActions; ++a)
        if (a < A) q[a] += hw[a * H + u] * h;
    }
  } else {
    float sum = 0.0f;
    for (int u = lane; u < H; u += 32) {
      const float v = src[at[u]];
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
      const float h = fmaxf((y[u] - mu) * inv * __ldg(w.l2s + u) + __ldg(w.l2b + u), 0.0f);
#pragma unroll
      for (int a = 0; a < kMaxActions; ++a)
        if (a < A) q[a] += hw[a * H + u] * h;
    }
  }
#pragma unroll
  for (int a = 0; a < kMaxActions; ++a)
    if (a < A) q[a] = warp_sum(q[a]) + hb[a];
}

// This CTA's U units of layer 2 for the G envs, bias included: stage[g U +
// j] = b2[u0 + j] + sum_k h1[g][k] W2[u0 + j][k]. Thread (row j, chunk k of
// KS), the chunk the quads of k it walks k, k + KS, ...; the G sums in
// registers, added over the chunks by a butterfly.
template <bool RES, int G>
__device__ void layer2_slice(const Weights& w, const float* w2s, int Hs, const float* h1, float* stage, int H,
                             int U, int u0) {
  const int ks = split_of(U, H), tid = threadIdx.x;
  const int j = tid / ks, k = tid - j * ks;
  const bool valid = j < U;
  const float bias = valid ? __ldg(w.b2 + u0 + j) : 0.0f;
  const float* wrow = RES ? w2s + j * Hs : w.w2 + (size_t)(u0 + j) * H;
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;
  if (valid) {
    for (int q = k; q < H / 4; q += ks) {
      const float4 wv = RES ? *reinterpret_cast<const float4*>(wrow + 4 * q)
                            : __ldg(reinterpret_cast<const float4*>(wrow + 4 * q));
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 hv = *reinterpret_cast<const float4*>(h1 + g * H + 4 * q);
        acc[g] = fmaf(hv.w, wv.w, fmaf(hv.z, wv.z, fmaf(hv.y, wv.y, fmaf(hv.x, wv.x, acc[g]))));
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    for (int o = 1; o < ks; o <<= 1) acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], o);
    if (valid && k == 0) stage[g * U + j] = acc[g] + bias;
  }
  fence_proxy_async();
}

// RES: the W2 slice in shared memory (H <= 512); else read from L2. G: the
// envs a cluster takes (ops/cartpole_rollout.py cartpole_plan's group). NU:
// a lane's units in the per-env work, 8 at the trainer's H 256 (held in
// registers), else 0 (any H). At most 128 registers: two CTAs an SM.
template <bool RES, int G, int NU>
__global__ void __launch_bounds__(kThreads, 2) cartpole_rollout_kernel(
    Weights w, const float* __restrict__ stf0, const int* __restrict__ sti0, float* __restrict__ obs_out,
    int* __restrict__ act_out, float* __restrict__ rew_out, int* __restrict__ done_out,
    float* __restrict__ q_out, float* __restrict__ final_obs, float* __restrict__ stf_out,
    int* __restrict__ sti_out, int T, int B, int H, int A, uint32_t key0, uint32_t key1, float eps,
    int use_prng, int max_steps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int U = H / C, u0 = rank * U, Hs = row_stride(H, U), blk = round4(G * U);
  const int tid = threadIdx.x, lane = tid & 31, g = tid >> 5;
  // the CTA this thread sends the bulk copies to: lanes 0 and 1 of each warp
  // (a copy's operands are uniform, so the copies of one warp issue in turn)
  const int dst = lane * (kThreads / 32) + g;

  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(base);  // [2]
  float* w2s = base + 4;                             // RES: [U][Hs]
  float* h1 = w2s + (RES ? U * Hs : 0);             // [G][H]
  float* stage = h1 + G * H;                         // [2][blk]
  float* recv = stage + 2 * blk;                     // [2][C][blk]
  int* at = reinterpret_cast<int*>(recv + 2 * C * blk);  // [H]: unit u at recv[slot][at[u] + g U]
  Draws* draws = reinterpret_cast<Draws*>(at + H);  // [kChunk][G]
  float* hw = reinterpret_cast<float*>(draws + kChunk * G);  // [A][H]: the head
  float* hb = hw + A * H;                                    // [A]
  for (int i = tid; i < A * H; i += blockDim.x) hw[i] = w.hw[i];
  if (tid < A) hb[tid] = w.hb[tid];

  if (RES) {
    for (int i = tid; i < U * H / 4; i += blockDim.x) {
      const int j = i / (H / 4), k = i - j * (H / 4);
      *reinterpret_cast<float4*>(w2s + j * Hs + 4 * k) =
          __ldg(reinterpret_cast<const float4*>(w.w2 + (size_t)(u0 + j) * H) + k);
    }
  }
  for (int u = tid; u < H; u += blockDim.x) at[u] = (u / U) * blk + u % U;
  if (tid == 0) {
    bar_init(smem_addr(&bars[0]));
    bar_init(smem_addr(&bars[1]));
    bar_expect(smem_addr(&bars[0]), 4u * C * blk);
    bar_expect(smem_addr(&bars[1]), 4u * C * blk);
  }
  cluster_start();

  // warp g < G: env b of the cluster; every CTA runs it on the same bits,
  // CTA 0 writes it out
  const int b = (int)(blockIdx.x / C) * G + g;
  const bool env_warp = g < G, real = env_warp && b < B, writer = real && rank == 0;
  float st[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // x, x_dot, theta, theta_dot
  int time = 0;
  if (real) {
#pragma unroll
    for (int k = 0; k < 4; ++k) st[k] = stf0[k * B + b];
    time = sti0[b];
  }
  float* y = h1 + g * H;  // the warp's env in h1 (scratch for LN2 where NU = 0)
  unsigned parity = 0;    // bit i: the phase of mbarrier i to wait for

  for (int t = 0; t < T; ++t) {
    const int slot = t & 1;
    const long tb = (long)t * B + b;
    if (t % kChunk == 0) {
      // the words of steps t .. t + kChunk - 1 for the group's envs, a
      // Philox call a thread, once every thread has read the last chunk's
      __syncthreads();
      for (int i = tid; i < min(kChunk, T - t) * G * 2; i += blockDim.x) {
        const int call = i & 1, e = (i >> 1) % G, step = (i >> 1) / G;
        Draws& d = draws[step * G + e];
        U4 r{0u, 0u, 0u, 0u};
        if (use_prng) {
          const int env = (int)(blockIdx.x / C) * G + e;
          r = philox4x32_10(U4{(uint32_t)(t + step), (uint32_t)env, (uint32_t)call, 0u}, key0, key1);
        }
        if (call == 0) {
          d.coin = use_prng ? unit24(r.x) : 1.0f;
          d.rand_act = (int)((r.y >> 8) % (uint32_t)A);
          d.reset[0] = use_prng ? reset_draw(r.z) : 0.0f;
          d.reset[1] = use_prng ? reset_draw(r.w) : 0.0f;
        } else {
          d.reset[2] = use_prng ? reset_draw(r.x) : 0.0f;
          d.reset[3] = use_prng ? reset_draw(r.y) : 0.0f;
        }
      }
    }
    if (env_warp) {
      if (writer && lane < 4) obs_out[tb * 4 + lane] = pick4(st, lane);
      layer1<NU>(w, st, y, H, lane);
    }
    __syncthreads();
    // layer 2: this CTA's units to every CTA (a bulk copy each)
    float* stage_t = stage + slot * blk;
    float* recv_t = recv + slot * C * blk;
    layer2_slice<RES, G>(w, w2s, Hs, h1, stage_t, H, U, u0);
    __syncthreads();
    if (dst < C) copy_to(dst, recv_t + rank * blk, stage_t, 4u * blk, &bars[slot]);
    wait_slot(bars, slot, parity);
    if (tid == 0 && t + 2 < T) bar_expect(smem_addr(&bars[slot]), 4u * C * blk);

    if (env_warp) {
      const Draws& d = draws[(t % kChunk) * G + g];
      float q[kMaxActions];
      ln_head<NU>(w, hw, hb, recv_t + g * U, at, y, H, A, lane, q);
      // argmax: a NaN beats any number (the first NaN wins), a larger value
      // a smaller one, and among equal values the first index
      int greedy = 0;
      float best = q[0];
#pragma unroll
      for (int a = 1; a < kMaxActions; ++a) {
        if (a < A && best == best && (q[a] > best || q[a] != q[a])) {
          best = q[a];
          greedy = a;
        }
      }
      const int action = d.coin < eps ? d.rand_act : greedy;
      const float a_f = (float)action;

      // physics (cartpole.py step_env, Euler), rounded op by op
      const float x = st[0], x_dot = st[1], theta = st[2], theta_dot = st[3];
      const float force = __fsub_rn(__fmul_rn(kForce, a_f), __fmul_rn(kForce, __fsub_rn(1.0f, a_f)));
      const float costh = cosf(theta);
      const float sinth = sinf(theta);
      const float temp = __fdiv_rn(
          __fadd_rn(force, __fmul_rn(__fmul_rn(__fmul_rn(kPolemassLength, theta_dot), theta_dot), sinth)),
          kTotalMass);
      const float thacc = __fdiv_rn(
          __fsub_rn(__fmul_rn(kGravity, sinth), __fmul_rn(costh, temp)),
          __fmul_rn(kLength,
                    __fsub_rn(kFourThirds, __fdiv_rn(__fmul_rn(__fmul_rn(kMasspole, costh), costh), kTotalMass))));
      const float xacc =
          __fsub_rn(temp, __fdiv_rn(__fmul_rn(__fmul_rn(kPolemassLength, thacc), costh), kTotalMass));
      const float nx = __fadd_rn(x, __fmul_rn(kTau, x_dot));
      const float nx_dot = __fadd_rn(x_dot, __fmul_rn(kTau, xacc));
      const float nth = __fadd_rn(theta, __fmul_rn(kTau, theta_dot));
      const float nth_dot = __fadd_rn(theta_dot, __fmul_rn(kTau, thacc));
      const int ntime = time + 1;

      const bool done = fabsf(nx) > kXThreshold || fabsf(nth) > kThetaThreshold || ntime >= max_steps;
      // reward: 1 unless the INCOMING state was terminal
      const bool prev_done = fabsf(x) > kXThreshold || fabsf(theta) > kThetaThreshold || time >= max_steps;
      if (writer) {
        if (lane == 0) {
          act_out[tb] = action;
          rew_out[tb] = prev_done ? 0.0f : 1.0f;
          done_out[tb] = done ? 1 : 0;
        }
#pragma unroll
        for (int a = 0; a < kMaxActions; ++a)
          if (a < A && lane == a) q_out[tb * A + a] = q[a];
      }
      st[0] = done ? d.reset[0] : nx;
      st[1] = done ? d.reset[1] : nx_dot;
      st[2] = done ? d.reset[2] : nth;
      st[3] = done ? d.reset[3] : nth_dot;
      time = done ? 0 : ntime;
    }
  }
  if (writer && lane < 4) {
    stf_out[lane * B + b] = pick4(st, lane);
    final_obs[b * 4 + lane] = pick4(st, lane);
  }
  if (writer && lane == 0) sti_out[b] = time;
  // no CTA leaves while a bulk copy may still read its shared memory
  cluster.sync();
}

// The template instance a plan launches: the slice resident or not, the
// group, and a lane's units in registers at H 256.
using KernelFn = decltype(&cartpole_rollout_kernel<true, 8, 8>);
KernelFn kernel_for(int H, int group, bool resident) {
  if (resident && H == 256)
    return group == 8 ? cartpole_rollout_kernel<true, 8, 8>
           : group == 4 ? cartpole_rollout_kernel<true, 4, 8>
           : group == 2 ? cartpole_rollout_kernel<true, 2, 8>
                        : cartpole_rollout_kernel<true, 1, 8>;
  if (resident)
    return group == 8 ? cartpole_rollout_kernel<true, 8, 0>
           : group == 4 ? cartpole_rollout_kernel<true, 4, 0>
           : group == 2 ? cartpole_rollout_kernel<true, 2, 0>
                        : cartpole_rollout_kernel<true, 1, 0>;
  return group == 8 ? cartpole_rollout_kernel<false, 8, 0>
         : group == 4 ? cartpole_rollout_kernel<false, 4, 0>
         : group == 2 ? cartpole_rollout_kernel<false, 2, 0>
                      : cartpole_rollout_kernel<false, 1, 0>;
}

}  // namespace

extern "C" {

// Launches ceil(B / group) clusters of `cluster` CTAs of 256 threads,
// `smem_bytes` of dynamic shared memory each, the W2 slice resident in
// shared memory or not (the plan of ops/cartpole_rollout.py cartpole_plan),
// on `stream`; returns a cudaError_t (0 on success). A plan the card
// refuses returns its error; nothing retries. The wrapper checks shapes: H
// a multiple of 32 in [32, 1024], 1 <= A <= min(8, H / 32), W1 and W2
// 16-byte aligned.
int cartpole_rollout_f32(const float* w1, const float* b1, const float* ln1_scale, const float* ln1_bias,
                         const float* w2, const float* b2, const float* ln2_scale, const float* ln2_bias,
                         const float* head_w, const float* head_b, const float* stf0, const int* sti0,
                         float* obs_out, int* act_out, float* rew_out, int* done_out, float* q_out,
                         float* final_obs, float* stf_out, int* sti_out, int T, int B, int H, int A,
                         unsigned long long seed, float eps, int use_prng, int max_steps, int cluster, int group,
                         int resident, int smem_bytes, void* stream) {
  const bool cluster_ok = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16;
  const bool group_ok = group == 1 || group == 2 || group == 4 || group == 8;
  if (!cluster_ok || !group_ok || H % 32 || H < 32 || H > 1024 || H % cluster || H / cluster > kThreads ||
      A < 1 || A > kMaxActions || smem_bytes < 4 * smem_floats(H, cluster, group, resident != 0))
    return (int)cudaErrorInvalidValue;
  const Weights w{w1, b1, ln1_scale, ln1_bias, w2, b2, ln2_scale, ln2_bias, head_w, head_b};
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull), k1 = (uint32_t)(seed >> 32);
  const int clusters = (B + group - 1) / group;
  const auto kernel = kernel_for(H, group, resident != 0);
  return launch_clusters(kernel, cluster, clusters, kThreads, smem_bytes, (cudaStream_t)stream, w, stf0, sti0,
                         obs_out, act_out, rew_out, done_out, q_out, final_obs, stf_out, sti_out, T, B, H, A, k0,
                         k1, eps, use_prng, max_steps);
}

// How many clusters of the plan the card places at once
// (cudaOccupancyMaxActiveClusters), or minus the cudaError_t.
int cartpole_rollout_active_clusters(int H, int cluster, int group, int resident, int smem_bytes) {
  return active_clusters(kernel_for(H, group, resident != 0), cluster, kThreads, smem_bytes);
}

const char* cartpole_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
