// Fused Freeway-MinAtar rollout: T env steps of observation planes, the
// MinAtar CNN forward, epsilon-greedy, the Freeway rules and the reset in one
// launch.
//
// Replaces: purejaxql_tpu/ops/pallas_rollout.py `_make_freeway_kernel`
// (called by `freeway_rollout_pallas` through `_call_game_kernel`), which
// runs the rollout as a sequential grid over T with the env batch on the 128
// lanes: an (8, B) row per lane field, `_freeway_planes` as one (10, 10, B)
// mask per lane and channel, the shared `_cnn_forward`, and the TPU's
// hardware PRNG. None of that layout carries over.
//
// What bounded the old design, and by how much: one block of 256 threads
// per env ran the whole CNN, whose dense layer read the whole
// 512 KiB dense weight (H 128) from L2 at every step of every env: 64 MiB a
// step at the trainer's B 128, about 4.3 TB/s of L2 traffic at 0.50 ms a
// launch (T 32), 20x the operation bound (0.0246 ms: the conv's 63 taps and
// the dense layer's 2 x 1024 x H flops an env step).
//
// Design: the CNN of minatar_cluster.cuh. A thread-block cluster of C CTAs
// takes C envs, one env a CTA; each CTA holds 1 / C of the dense weight in
// shared memory for the whole launch, and the CTAs trade the conv outputs'
// slices and the dense layer's partial sums through distributed shared
// memory, so the weight is read from L2 once a launch and not once a step
// an env. The plan (ops/minatar_rollout.py `cluster_plan`) takes C 16
// (PLAN_CLUSTER there gives the times behind the choice). Each step a CTA with an env builds the 7
// planes (chicken, car, speed 1-5) in shared memory and writes them out (a
// thread a cell), threads 0-6 draw the step's 28 Philox words, the cluster
// runs the CNN, and warp 0 runs the argmax (first index wins ties), the
// epsilon coin and the Freeway rules in the order of freeway.py:73-125
// (lane k taking car lane k), then the reset on the time limit. The game
// is integer logic, so kernel and plain twin agree exactly on everything
// but the Q-values' last bits.
//
// Randomness: Philox4x32-10 (philox.cuh), counter (step, env, k, 0) for
// k = 0 .. 6, each word used through its top 24 bits: word 0 the coin, 1
// the random action, 2-9 the lane speeds a score draws (1 + w mod 5), 10-17
// their directions (+1 on an odd w, else -1), 18-25 the cars' columns after
// a reset (w mod 10). A reset takes the step's speed and direction draws, as
// pallas_rollout.py:1144-1157 does. With use_prng = 0: coin 1, random action
// 0, speeds 3, directions +1, reset columns 0 (pallas_rollout.py:1093-1097,
// 1151-1152).

#include <cuda_runtime.h>
#include <stdint.h>

#include "minatar_cluster.cuh"
#include "philox.cuh"

namespace {

using namespace minatar;
using namespace minatar_cluster;

constexpr int kChannels = 7;  // chicken, car, speed 1 .. speed 5
constexpr int kObs = kCells * kChannels;
constexpr int kLanes = 8;     // car lanes on rows 1-8
constexpr int kColumn = 4;    // the chicken's column
constexpr int kCalls = 7;     // Philox calls per step: 28 words, 26 used

// rows of the (32, B) state matrix
enum { kPos, kMoveTimer, kTime, kX = 3, kTimer = 11, kSpeed = 19, kUsedRows = 27, kStateRows = 32 };
// the ints the kernel keeps in the plan's block (Smem::game): none, its
// state and Philox words are static shared arrays (ops/freeway_rollout.py
// GAME_INTS; in the block they ran 1.4 % slower on an H100,
// scripts/time_rollouts.py)
constexpr int kGameInts = 0;

__device__ __forceinline__ int wrap(int x) { return x < 0 ? kSide - 1 : (x > kSide - 1 ? 0 : x); }

// The observation of a state as (row, col, channel) planes, into shared
// memory and out to `out` (freeway.py get_obs): a thread a cell.
__device__ void build_planes(float* planes, float* __restrict__ out, const int* s) {
  const int cell = threadIdx.x;
  if (cell >= kCells) return;
  const int r = cell / kSide, c = cell - r * kSide;
  const bool car_row = r >= 1 && r <= kLanes;
  const int x = car_row ? s[kX + r - 1] : -1, speed = car_row ? s[kSpeed + r - 1] : 0;
  // the cell behind the car, on the channel of its |speed|
  const bool trail = car_row && c == wrap(x + (speed > 0 ? -1 : 1));
#pragma unroll
  for (int ch = 0; ch < kChannels; ++ch) {
    const bool on = ch == 0 ? r == s[kPos] && c == kColumn : ch == 1 ? car_row && c == x : trail && ch == 1 + abs(speed);
    planes[cell * kChannels + ch] = on ? 1.0f : 0.0f;
    out[cell * kChannels + ch] = on ? 1.0f : 0.0f;
  }
}

// A car in the chicken's column on the chicken's row: lane k of the warp
// holds car lane k's column x.
__device__ __forceinline__ bool hit(bool car, int x, int k, int pos) {
  return __any_sync(0xffffffffu, car && x == kColumn && k + 1 == pos);
}

template <int KC>
__global__ void __launch_bounds__(kThreads) freeway_rollout_kernel(
    CnnWeights wts, const int* __restrict__ st0, float* __restrict__ obs_out,
    int* __restrict__ act_out, float* __restrict__ rew_out,
    int* __restrict__ done_out, float* __restrict__ q_out,
    float* __restrict__ final_obs, int* __restrict__ st_out, int T, int B,
    int H, int A, uint32_t key0, uint32_t key1, float eps, int use_prng,
    int max_steps, int player_speed) {
  extern __shared__ float4 smem4[];
  const Place p = place_of(B, H, A, T);
  const Smem m = smem_layout<kChannels>(reinterpret_cast<float*>(smem4), H, p.C);
  __shared__ int s[kUsedRows];
  __shared__ uint32_t words[4 * kCalls];

  const int b = p.b, tid = threadIdx.x;
  if (p.live && tid < kUsedRows) s[tid] = st0[tid * B + b];
  load_and_arm<kChannels>(m, wts, p);
  unsigned parity = 0;  // bit i: the phase of mbarrier i to wait for

  for (int t = 0; t < T; ++t) {
    const long tb = (long)t * B + b;
    if (p.live) {
      build_planes(m.planes, obs_out + tb * kObs, s);
      if (use_prng) step_words<kCalls>(words, t, b, key0, key1);
      __syncthreads();
    }
    cluster_q_values<kChannels, KC>(m, wts, p, t, parity);
    if (!p.live) continue;

    if (tid < 32) {
      // warp 0: the argmax (first index wins ties), the epsilon coin and the
      // Freeway rules, lane k < 8 taking car lane k
      const int k = tid;
      const bool car = k < kLanes;
      const int greedy = greedy_of(m, A);
      if (k < A) q_out[tb * A + k] = m.q[k];
      float u = 1.0f;
      int rand_act = 0, speed = 3, dir = 1, reset_x = 0;
      if (use_prng) {
        u = unit24(words[0]);
        rand_act = (int)((words[1] >> 8) % (uint32_t)A);
        if (car) {
          speed = (int)((words[2 + k] >> 8) % 5u) + 1;
          dir = ((words[10 + k] >> 8) & 1u) ? 1 : -1;
          reset_x = (int)((words[18 + k] >> 8) % 10u);
        }
      }
      const int action = u < eps ? rand_act : greedy;
      int x = car ? s[kX + k] : 0, timer = car ? s[kTimer + k] : 0, spd = car ? s[kSpeed + k] : 0;

      // the chicken moves when its cooldown is over (actions: noop, up, down)
      const int mt = s[kMoveTimer];
      const bool moved = mt == 0 && action != 0;
      int pos = min(max(s[kPos] + (moved ? (action == 1 ? -1 : 1) : 0), 0), kSide - 1);
      const int move_timer = moved ? player_speed : max(mt - 1, 0);

      // reaching the top scores and draws new lane speeds
      const bool scored = pos == 0;
      if (scored) {
        timer = speed;
        spd = speed * dir;
        pos = kSide - 1;
      }

      // the cars move on their lane timers; a car on the chicken before or
      // after the move sends it back
      const bool hit_before = hit(car, x, k, pos);
      if (timer <= 0) {
        x = wrap(x + (spd > 0 ? 1 : -1));
        timer = abs(spd);
      } else {
        timer -= 1;
      }
      if (hit(car, x, k, pos) || hit_before) pos = kSide - 1;

      const int time = s[kTime] + 1;
      const bool done = time >= max_steps;
      if (done) {  // reset: new columns, the step's speeds and directions
        pos = kSide - 1;
        x = reset_x;
        timer = speed;
        spd = speed * dir;
      }
      __syncwarp();
      if (car) {
        s[kX + k] = x;
        s[kTimer + k] = timer;
        s[kSpeed + k] = spd;
      }
      if (k == 0) {
        act_out[tb] = action;
        rew_out[tb] = scored ? 1.0f : 0.0f;
        done_out[tb] = done ? 1 : 0;
        s[kPos] = pos;
        s[kMoveTimer] = done ? 0 : move_timer;
        s[kTime] = done ? 0 : time;
      }
    }
    __syncthreads();
  }

  if (p.live) {
    build_planes(m.planes, final_obs + (long)b * kObs, s);
    if (tid < kStateRows) st_out[tid * B + b] = tid < kUsedRows ? s[tid] : 0;
  }
  finish_launch();
}

// the kernel's instance for a cluster of C (1, 2, 4, 8 or 16)
decltype(&freeway_rollout_kernel<1>) kernel_for(int C) {
  return C == 16 ? freeway_rollout_kernel<16>
       : C == 8  ? freeway_rollout_kernel<8>
       : C == 4  ? freeway_rollout_kernel<4>
       : C == 2  ? freeway_rollout_kernel<2>
                 : freeway_rollout_kernel<1>;
}

}  // namespace

extern "C" {

// Launches ceil(B / cluster) clusters of `cluster` CTAs of 256 threads,
// `smem_bytes` of dynamic shared memory each (the plan of
// ops/minatar_rollout.py cluster_plan), on `stream`; returns a cudaError_t
// (0 on success). A plan the card refuses returns its error; nothing
// retries. The wrapper checks shapes: H a multiple of 32 in [32, 256],
// 1 <= A <= 8.
int freeway_rollout_f32(const float* conv_w, const float* conv_b,
                        const float* ln1_scale, const float* ln1_bias,
                        const float* dense_w, const float* dense_b,
                        const float* ln2_scale, const float* ln2_bias,
                        const float* head_w, const float* head_b,
                        const int* st0, float* obs_out, int* act_out,
                        float* rew_out, int* done_out, float* q_out,
                        float* final_obs, int* st_out, int T, int B, int H,
                        int A, unsigned long long seed, float eps,
                        int use_prng, int max_steps, int player_speed,
                        int cluster, int smem_bytes, void* stream) {
  const bool cluster_ok = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16;
  if (!cluster_ok || H % 32 || H < 32 || H > kThreads || A < 1 || A > kMaxActions ||
      smem_bytes < 4 * smem_floats(kChannels, H, cluster, kGameInts))
    return (int)cudaErrorInvalidValue;
  const CnnWeights wts{conv_w, conv_b, ln1_scale, ln1_bias, dense_w,
                       dense_b, ln2_scale, ln2_bias, head_w, head_b};
  return launch_clusters(kernel_for(cluster), cluster, (B + cluster - 1) / cluster, kThreads, smem_bytes,
                         (cudaStream_t)stream, wts, st0, obs_out, act_out, rew_out, done_out, q_out,
                         final_obs, st_out, T, B, H, A, (uint32_t)(seed & 0xffffffffull),
                         (uint32_t)(seed >> 32), eps, use_prng, max_steps, player_speed);
}

// How many clusters of `cluster` CTAs with `smem_bytes` each the card
// places at once (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
int freeway_rollout_active_clusters(int cluster, int smem_bytes) {
  return active_clusters(kernel_for(cluster), cluster, kThreads, smem_bytes);
}

const char* freeway_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
