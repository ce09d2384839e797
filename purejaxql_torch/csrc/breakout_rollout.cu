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
// about 0.002 ms: the bound is operations. In practice the kernel is bound
// by latency: T dependent steps, each a chain of barriers, with the
// 512 KiB dense weight read from L2 at every step.
//
// Design (simple and right first): one block of 256 threads per env, so B
// blocks run side by side on the 132 SMs. Each step the block
//   - builds the 4 planes (row, col, channel) in shared memory and writes
//     them out as that step's observation;
//   - runs the MinAtar CNN of minatar_cnn.cuh (conv, LayerNorms, dense
//     layer with the weight read from L2, head);
//   - on thread 0: the argmax (first index wins ties, as jnp.argmax), the
//     epsilon coin, the Breakout dynamics in the rule order of
//     breakout.py:83-159 and the reset; the brick map is then updated by
//     100 threads. The game is integer logic, so kernel and plain twin
//     agree exactly on everything but the Q-values' last bits.
//
// Randomness: one Philox4x32-10 call (philox.cuh) per step and env, keyed
// by the wrapper's 64-bit seed with counter (step, env, 0, 0): the coin
// from word 0, the random action from word 1 and the reset side from word
// 2, each from its top 24 bits as pallas_rollout.py:240-247 uses its words.
// With use_prng = 0 the coin is 1, the random action 0 and the reset side
// 0, as at pallas_rollout.py:248-251.

#include <cuda_runtime.h>
#include <stdint.h>

#include "minatar_cnn.cuh"
#include "philox.cuh"

namespace {

using namespace minatar;

constexpr int kChannels = 4;                     // paddle, ball, trail, brick
constexpr int kObs = kCells * kChannels;         // floats per observation
constexpr int kWallBricks = 3 * kSide;           // rows 1-3

// rows of the (8, B) state matrix
enum { kBallY, kBallX, kDir, kPos, kStrike, kLastY, kLastX, kTime, kStateRows };

// direction 0: up-left, 1: up-right, 2: down-right, 3: down-left
__device__ __forceinline__ int dir_dx(int d) { return (d == 1 || d == 2) ? 1 : -1; }
__device__ __forceinline__ int dir_dy(int d) { return d < 2 ? -1 : 1; }
// reflections: side wall [1,0,3,2], ceiling/brick/paddle [3,2,1,0],
// paddle corner [2,3,0,1]
__device__ __forceinline__ int bounce_x(int d) { return d ^ 1; }
__device__ __forceinline__ int bounce_y(int d) { return 3 - d; }
__device__ __forceinline__ int bounce_corner(int d) { return d ^ 2; }

// The observation of a state as (row, col, channel) planes, into shared
// memory and out to `out` (breakout.py get_obs).
__device__ void build_planes(float* planes, float* __restrict__ out,
                             const int* s, const int* bricks) {
  for (int k = threadIdx.x; k < kObs; k += blockDim.x) {
    const int cell = k / kChannels, ch = k - cell * kChannels;
    const int r = cell / kSide, c = cell - r * kSide;
    float v;
    if (ch == 0) {
      v = (r == kSide - 1 && c == s[kPos]) ? 1.0f : 0.0f;
    } else if (ch == 1) {
      v = (r == s[kBallY] && c == s[kBallX]) ? 1.0f : 0.0f;
    } else if (ch == 2) {
      v = (r == s[kLastY] && c == s[kLastX]) ? 1.0f : 0.0f;
    } else {
      v = (float)bricks[cell];
    }
    planes[k] = v;
    out[k] = v;
  }
}

__global__ void __launch_bounds__(kThreads) breakout_rollout_kernel(
    CnnWeights wts, const int* __restrict__ st0, const int* __restrict__ brick0,
    float* __restrict__ obs_out, int* __restrict__ act_out,
    float* __restrict__ rew_out, int* __restrict__ done_out,
    float* __restrict__ q_out, float* __restrict__ final_obs,
    int* __restrict__ st_out, int* __restrict__ brick_out, int T, int B, int H,
    int A, uint32_t key0, uint32_t key1, float eps, int use_prng,
    int max_steps) {
  extern __shared__ __align__(16) float smem[];
  const CnnSmem m = cnn_smem<kChannels>(smem, H);
  __shared__ int s[kStateRows];
  __shared__ int bricks[kCells];
  __shared__ int n_bricks, hit_cell, refill;

  const int b = blockIdx.x, tid = threadIdx.x;
  load_conv<kChannels>(m, wts);
  for (int k = tid; k < kCells; k += blockDim.x) bricks[k] = brick0[k * B + b];
  if (tid < kStateRows) s[tid] = st0[tid * B + b];
  __syncthreads();
  if (tid == 0) {  // only thread 0 reads and writes the count
    int n = 0;
    for (int k = 0; k < kCells; ++k) n += bricks[k];
    n_bricks = n;
  }

  for (int t = 0; t < T; ++t) {
    const long tb = (long)t * B + b;
    build_planes(m.planes, obs_out + tb * kObs, s, bricks);
    __syncthreads();
    q_values<kChannels>(m, wts, H, A);

    if (tid == 0) {
      const int greedy = greedy_action(m.q, q_out + tb * A, A);
      float u = 1.0f;
      int rand_act = 0, side = 0;
      if (use_prng) {
        const U4 r = philox4x32_10(U4{(uint32_t)t, (uint32_t)b, 0u, 0u}, key0, key1);
        u = unit24(r.x);
        rand_act = (int)((r.y >> 8) % (uint32_t)A);
        side = (int)((r.z >> 8) & 1u);
      }
      const int action = u < eps ? rand_act : greedy;

      // dynamics (breakout.py step_env), in its rule order
      const int ball_x = s[kBallX], ball_y = s[kBallY], strike0 = s[kStrike];
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
      hit_cell = hit;
      refill = fill;
    }
    __syncthreads();
    if (tid < kCells) {
      if (refill) {
        bricks[tid] = (tid >= kSide && tid < 4 * kSide) ? 1 : 0;
      } else if (tid == hit_cell) {
        bricks[tid] = 0;
      }
    }
    __syncthreads();
  }

  build_planes(m.planes, final_obs + (long)b * kObs, s, bricks);
  if (tid < kStateRows) st_out[tid * B + b] = s[tid];
  for (int k = tid; k < kCells; k += blockDim.x) brick_out[k * B + b] = bricks[k];
}

}  // namespace

extern "C" {

// Launches one block of 256 threads per env on `stream`; returns the
// launch's cudaError_t (0 on success). The wrapper checks shapes: H a
// multiple of 32 in [32, 256], 1 <= A <= 8, the dense weight 16-byte
// aligned.
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
                         int max_steps, void* stream) {
  const CnnWeights wts{conv_w, conv_b, ln1_scale, ln1_bias, dense_w,
                       dense_b, ln2_scale, ln2_bias, head_w, head_b};
  const size_t smem = cnn_smem_floats(kChannels, H) * sizeof(float);
  breakout_rollout_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      wts, st0, brick0, obs_out, act_out, rew_out, done_out, q_out, final_obs,
      st_out, brick_out, T, B, H, A, (uint32_t)(seed & 0xffffffffull),
      (uint32_t)(seed >> 32), eps, use_prng, max_steps);
  return (int)cudaGetLastError();
}

const char* breakout_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
