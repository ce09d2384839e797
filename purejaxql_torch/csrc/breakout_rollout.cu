// Fused Breakout-MinAtar rollout: T env steps of observation planes, the
// MinAtar CNN forward, epsilon-greedy, Breakout dynamics and auto-reset in
// one launch.
//
// Replaces: purejaxql_tpu/ops/pallas_rollout.py `_make_kernel` (called by
// `breakout_rollout_pallas`), which runs the rollout as a sequential grid
// over T with the env batch on the 128 lanes: boards (10, 10, B), the 3x3
// conv as 36 broadcast-FMA terms into a (16, 8, 8, B) map, one
// (128, 1024) x (1024, B) MXU matmul with host-reordered rows, a head padded
// to 8 sublanes with a -1e9 bias, and the TPU's hardware PRNG. None of that
// layout carries over.
//
// Bound on an H100: per env step the CNN forward is about 3.5e5 flops (the
// conv 7.4e4, the dense layer 2 * 1024 * H = 2.6e5 at H = 128, LayerNorms
// and head about 1e4). At the trainer's B = 128, T = 32 that is 1.4 GFLOP,
// about 0.02 ms at the float32 peak outside the tensor cores, while the
// ~7 MB it must move (the observation stream and 0.53 MB of weights) take
// about 0.002 ms: the bound is operations.
//
// What bounded the old design: one block of 256 threads per env ran the
// whole CNN, whose dense layer read the whole 512 KiB dense weight (H 128)
// from L2 at every step of every env, 64 MiB a step at the trainer's B 128:
// 0.40-0.47 ms a launch (T 32), about 20x the operation bound.
//
// Design: the CNN of minatar_cluster.cuh, as the Asterix kernel runs it. A
// thread-block cluster of C CTAs takes C envs, one env a CTA; each CTA holds
// 1 / C of the dense weight in shared memory for the whole launch, and the
// CTAs trade the conv outputs' slices and the dense layer's partial sums
// through distributed shared memory. The plan (ops/breakout_rollout.py
// `breakout_plan`) takes C 16 (ops/minatar_rollout.py PLAN_CLUSTER gives the
// times behind the choice). Each step a CTA with an env
//   - applies the last step's brick change (a struck brick cleared, or the
//     wall refilled) and builds the 4 planes (paddle, ball, trail, brick)
//     in shared memory and writes them out, a thread a cell; thread 0 draws
//     the step's Philox words;
//   - runs the cluster's CNN;
//   - on warp 0: the Q-values out a lane an action, and on lane 0 the
//     argmax (first index wins ties, as jnp.argmax), the epsilon coin, the
//     Breakout dynamics of the one ball in the rule order of
//     breakout.py:83-159 and the reset. The brick it strikes or the refill
//     is applied by the cells at the next step's planes.
// The game is integer logic, so kernel and plain twin agree exactly on
// everything but the Q-values' last bits.
//
// Randomness: one Philox4x32-10 call (philox.cuh) per step and env, keyed
// by the wrapper's 64-bit seed with counter (step, env, 0, 0): the coin
// from word 0, the random action from word 1 and the reset side from word
// 2, each from its top 24 bits as pallas_rollout.py:240-247 uses its words.
// With use_prng = 0 the coin is 1, the random action 0 and the reset side
// 0, as at pallas_rollout.py:248-251.

#include <cuda_runtime.h>
#include <stdint.h>

#include "minatar_cluster.cuh"
#include "philox.cuh"

namespace {

using namespace minatar;
using namespace minatar_cluster;

constexpr int kChannels = 4;                     // paddle, ball, trail, brick
constexpr int kObs = kCells * kChannels;         // floats per observation
constexpr int kWallBricks = 3 * kSide;           // rows 1-3
constexpr int kCalls = 1;                        // Philox calls per step: 4 words, 3 used

// rows of the (8, B) state matrix, then the kernel's own: the bricks left
// (read and written by lane 0 alone) and the change to the brick map that
// the next planes apply (the struck cell or -1; the wall refilled)
enum { kBallY, kBallX, kDir, kPos, kStrike, kLastY, kLastX, kTime, kStateRows,
       kBricksLeft = kStateRows, kHitCell, kRefill };
// the ints the kernel keeps in the env's CTA (Smem::game): the state rows and
// its own, the step's Philox words and the brick map
// (ops/breakout_rollout.py GAME_INTS)
constexpr int kWordsAt = 12;
constexpr int kBricksAt = 16;
constexpr int kGameInts = 116;
static_assert(kRefill < kWordsAt && kWordsAt + 4 * kCalls == kBricksAt, "the rows, then the words");
static_assert(kGameInts == kBricksAt + kCells, "the rows, the Philox words and the brick map");

// direction 0: up-left, 1: up-right, 2: down-right, 3: down-left
__device__ __forceinline__ int dir_dx(int d) { return (d == 1 || d == 2) ? 1 : -1; }
__device__ __forceinline__ int dir_dy(int d) { return d < 2 ? -1 : 1; }
// reflections: side wall [1,0,3,2], ceiling/brick/paddle [3,2,1,0],
// paddle corner [2,3,0,1]
__device__ __forceinline__ int bounce_x(int d) { return d ^ 1; }
__device__ __forceinline__ int bounce_y(int d) { return 3 - d; }
__device__ __forceinline__ int bounce_corner(int d) { return d ^ 2; }

// The last step's brick change on the brick map, then the observation as
// (row, col, channel) planes, into shared memory and out to `out`
// (breakout.py get_obs): a thread a cell, its 4 channels in one 16-byte
// store each.
__device__ void build_planes(float* planes, float* __restrict__ out, const int* s, int* bricks) {
  const int cell = threadIdx.x;
  if (cell >= kCells) return;
  int brick = bricks[cell];
  if (s[kRefill]) {
    brick = (cell >= kSide && cell < 4 * kSide) ? 1 : 0;
  } else if (cell == s[kHitCell]) {
    brick = 0;
  }
  bricks[cell] = brick;
  const int r = cell / kSide, c = cell - r * kSide;
  const bool paddle = r == kSide - 1 && c == s[kPos];
  const bool ball = r == s[kBallY] && c == s[kBallX];
  const bool trail = r == s[kLastY] && c == s[kLastX];
  const float4 v = make_float4(paddle ? 1.0f : 0.0f, ball ? 1.0f : 0.0f, trail ? 1.0f : 0.0f, (float)brick);
  reinterpret_cast<float4*>(planes)[cell] = v;
  reinterpret_cast<float4*>(out)[cell] = v;
}

template <int KC>
__global__ void __launch_bounds__(kThreads) breakout_rollout_kernel(
    CnnWeights wts, const int* __restrict__ st0, const int* __restrict__ brick0,
    float* __restrict__ obs_out, int* __restrict__ act_out,
    float* __restrict__ rew_out, int* __restrict__ done_out,
    float* __restrict__ q_out, float* __restrict__ final_obs,
    int* __restrict__ st_out, int* __restrict__ brick_out, int T, int B, int H,
    int A, uint32_t key0, uint32_t key1, float eps, int use_prng,
    int max_steps) {
  extern __shared__ float4 smem4[];
  const Place p = place_of(B, H, A, T);
  const Smem m = smem_layout<kChannels>(reinterpret_cast<float*>(smem4), H, p.C);
  int* s = m.game;
  uint32_t* words = reinterpret_cast<uint32_t*>(m.game + kWordsAt);
  int* bricks = m.game + kBricksAt;

  const int b = p.b, tid = threadIdx.x;
  if (p.live) {
    if (tid < kStateRows) s[tid] = st0[tid * B + b];
    if (tid < kCells) bricks[tid] = brick0[tid * B + b];
    if (tid == 0) {
      s[kHitCell] = -1;
      s[kRefill] = 0;
    }
  }
  load_and_arm<kChannels>(m, wts, p);
  unsigned parity = 0;  // bit i: the phase of mbarrier i to wait for
  if (p.live) {
    const int n = __syncthreads_count(tid < kCells && bricks[tid] != 0);
    if (tid == 0) s[kBricksLeft] = n;
  }

  for (int t = 0; t < T; ++t) {
    const long tb = (long)t * B + b;
    if (p.live) {
      build_planes(m.planes, obs_out + tb * kObs, s, bricks);
      if (use_prng) step_words<kCalls>(words, t, b, key0, key1);
      __syncthreads();
    }
    cluster_q_values<kChannels, KC>(m, wts, p, t, parity);
    if (!p.live) continue;

    if (tid < 32) {
      // warp 0: the Q-values out; lane 0 the argmax, the epsilon coin and
      // the dynamics (breakout.py step_env), in its rule order
      if (tid < A) q_out[tb * A + tid] = m.q[tid];
      if (tid == 0) {
        const int greedy = greedy_of(m, A);
        float u = 1.0f;
        int rand_act = 0, side = 0;
        if (use_prng) {
          u = unit24(words[0]);
          rand_act = (int)((words[1] >> 8) % (uint32_t)A);
          side = (int)((words[2] >> 8) & 1u);
        }
        const int action = u < eps ? rand_act : greedy;

        const int ball_x = s[kBallX], ball_y = s[kBallY], strike0 = s[kStrike];
        int n_bricks = s[kBricksLeft];
        const int move = action == 1 ? -1 : (action == 2 ? 1 : 0);
        int pos = min(max(s[kPos] + move, 0), kSide - 1);
        int last_y = ball_y, last_x = ball_x;
        int d = s[kDir];
        int nx = ball_x + dir_dx(d), ny = ball_y + dir_dy(d);
        if (nx < 0 || nx > kSide - 1) {  // side walls
          nx = min(max(nx, 0), kSide - 1);
          d = bounce_x(d);
        }
        if (ny < 0) {  // ceiling
          ny = 0;
          d = bounce_y(d);
        }
        // brick strike, latched: no reward while the strike is held; the row
        // is clamped as JAX clamps a gather index (a ball below the paddle
        // row is never reached in play)
        const int cell = min(ny, kSide - 1) * kSide + nx;
        const bool hit_brick = bricks[cell] == 1;
        const bool scored = hit_brick && strike0 == 0;
        int hit = -1, fill = 0;
        if (scored) {
          hit = cell;
          --n_bricks;
          d = bounce_y(d);
          ny = last_y;
        }
        // bottom row: respawn the wall when cleared, then paddle or miss
        const bool at_bottom = ny == kSide - 1 && !hit_brick;
        if (at_bottom && n_bricks == 0) {
          fill = 1;
          n_bricks = kWallBricks;
        }
        const bool caught_above = at_bottom && ball_x == pos;
        const bool caught_corner = at_bottom && !caught_above && nx == pos;
        const bool missed = at_bottom && !caught_above && !caught_corner;
        if (caught_above) d = bounce_y(d);
        if (caught_corner) d = bounce_corner(d);
        if (caught_above || caught_corner) ny = last_y;
        int strike = hit_brick ? (scored || strike0 != 0) : 0;
        int time = s[kTime] + 1;
        const bool done = missed || time >= max_steps;
        act_out[tb] = action;
        rew_out[tb] = scored ? 1.0f : 0.0f;
        done_out[tb] = done ? 1 : 0;
        if (done) {  // auto-reset: the ball starts on the drawn side
          nx = last_x = side * (kSide - 1);
          ny = last_y = 3;
          d = side + 2;
          pos = 4;
          strike = 0;
          time = 0;
          fill = 1;
          n_bricks = kWallBricks;
        }
        s[kBallY] = ny;
        s[kBallX] = nx;
        s[kDir] = d;
        s[kPos] = pos;
        s[kStrike] = strike;
        s[kLastY] = last_y;
        s[kLastX] = last_x;
        s[kTime] = time;
        s[kBricksLeft] = n_bricks;
        s[kHitCell] = hit;
        s[kRefill] = fill;
      }
    }
    __syncthreads();
  }

  if (p.live) {
    build_planes(m.planes, final_obs + (long)b * kObs, s, bricks);
    if (tid < kStateRows) st_out[tid * B + b] = s[tid];
    if (tid < kCells) brick_out[tid * B + b] = bricks[tid];
  }
  finish_launch();
}

// the kernel's instance for a cluster of C (1, 2, 4, 8 or 16)
decltype(&breakout_rollout_kernel<1>) kernel_for(int C) {
  return C == 16 ? breakout_rollout_kernel<16>
       : C == 8  ? breakout_rollout_kernel<8>
       : C == 4  ? breakout_rollout_kernel<4>
       : C == 2  ? breakout_rollout_kernel<2>
                 : breakout_rollout_kernel<1>;
}

}  // namespace

extern "C" {

// Launches ceil(B / cluster) clusters of `cluster` CTAs of 256 threads,
// `smem_bytes` of dynamic shared memory each (the plan of
// ops/breakout_rollout.py breakout_plan), on `stream`; returns a cudaError_t
// (0 on success). A plan the card refuses returns its error; nothing
// retries. The wrapper checks shapes: H a multiple of 32 in [32, 256],
// 1 <= A <= 8, the dense weight 16-byte aligned.
int breakout_rollout_f32(const float* conv_w, const float* conv_b,
                         const float* ln1_scale, const float* ln1_bias,
                         const float* dense_w, const float* dense_b,
                         const float* ln2_scale, const float* ln2_bias,
                         const float* head_w, const float* head_b,
                         const int* st0, const int* brick0, float* obs_out,
                         int* act_out, float* rew_out, int* done_out,
                         float* q_out, float* final_obs, int* st_out,
                         int* brick_out, int T, int B, int H, int A,
                         unsigned long long seed, float eps, int use_prng,
                         int max_steps, int cluster, int smem_bytes,
                         void* stream) {
  const bool cluster_ok = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16;
  if (!cluster_ok || H % 32 || H < 32 || H > kThreads || A < 1 || A > kMaxActions ||
      smem_bytes < 4 * smem_floats(kChannels, H, cluster, kGameInts))
    return (int)cudaErrorInvalidValue;
  const CnnWeights wts{conv_w, conv_b, ln1_scale, ln1_bias, dense_w,
                       dense_b, ln2_scale, ln2_bias, head_w, head_b};
  return launch_clusters(kernel_for(cluster), cluster, (B + cluster - 1) / cluster, kThreads, smem_bytes,
                         (cudaStream_t)stream, wts, st0, brick0, obs_out, act_out, rew_out, done_out, q_out,
                         final_obs, st_out, brick_out, T, B, H, A, (uint32_t)(seed & 0xffffffffull),
                         (uint32_t)(seed >> 32), eps, use_prng, max_steps);
}

// How many clusters of `cluster` CTAs with `smem_bytes` each the card
// places at once (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
int breakout_rollout_active_clusters(int cluster, int smem_bytes) {
  return active_clusters(kernel_for(cluster), cluster, kThreads, smem_bytes);
}

const char* breakout_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
