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
// Bound on an H100: the CNN forward is most of the work (the conv has 63
// taps here, 7 channels; the dense layer 2 x 1024 x H flops per env step),
// so the bound is operations; in practice the kernel is bound by latency, T
// dependent steps of barriers with the 512 KiB dense weight read from L2 at
// every step (minatar_cnn.cuh).
//
// Design (simple and right first): one block of 256 threads per env. Each
// step the block builds the 7 planes (chicken, car, speed 1-5) in shared
// memory and writes them out, threads 0-6 draw the step's 28 Philox words,
// the block runs the MinAtar CNN of minatar_cnn.cuh, and thread 0 runs the
// argmax (first index wins ties), the epsilon coin and the Freeway rules on
// the 8 lanes in the order of freeway.py:73-125, then the reset on the time
// limit. The game is integer logic, so kernel and plain twin agree exactly
// on everything but the Q-values' last bits.
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

#include "minatar_cnn.cuh"
#include "philox.cuh"

namespace {

using namespace minatar;

constexpr int kChannels = 7;  // chicken, car, speed 1 .. speed 5
constexpr int kObs = kCells * kChannels;
constexpr int kLanes = 8;     // car lanes on rows 1-8
constexpr int kColumn = 4;    // the chicken's column
constexpr int kCalls = 7;     // Philox calls per step: 28 words, 26 used

// rows of the (32, B) state matrix
enum { kPos, kMoveTimer, kTime, kX = 3, kTimer = 11, kSpeed = 19, kUsedRows = 27, kStateRows = 32 };

__device__ __forceinline__ int wrap(int x) { return x < 0 ? kSide - 1 : (x > kSide - 1 ? 0 : x); }

// The observation of a state as (row, col, channel) planes, into shared
// memory and out to `out` (freeway.py get_obs).
__device__ void build_planes(float* planes, float* __restrict__ out, const int* s) {
  for (int k = threadIdx.x; k < kObs; k += blockDim.x) {
    const int cell = k / kChannels, ch = k - cell * kChannels;
    const int r = cell / kSide, c = cell - r * kSide;
    bool on = false;
    if (ch == 0) {
      on = r == s[kPos] && c == kColumn;
    } else if (r >= 1 && r <= kLanes) {
      const int lane = r - 1, x = s[kX + lane], speed = s[kSpeed + lane];
      if (ch == 1) {
        on = c == x;
      } else {  // the cell behind the car, on the channel of its |speed|
        on = ch == 1 + abs(speed) && c == wrap(x + (speed > 0 ? -1 : 1));
      }
    }
    planes[k] = on ? 1.0f : 0.0f;
    out[k] = on ? 1.0f : 0.0f;
  }
}

// A car in the chicken's column on the chicken's row.
__device__ __forceinline__ bool hit(const int* s, int pos) {
  for (int k = 0; k < kLanes; ++k) {
    if (s[kX + k] == kColumn && k + 1 == pos) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads) freeway_rollout_kernel(
    CnnWeights wts, const int* __restrict__ st0, float* __restrict__ obs_out,
    int* __restrict__ act_out, float* __restrict__ rew_out,
    int* __restrict__ done_out, float* __restrict__ q_out,
    float* __restrict__ final_obs, int* __restrict__ st_out, int T, int B,
    int H, int A, uint32_t key0, uint32_t key1, float eps, int use_prng,
    int max_steps, int player_speed) {
  extern __shared__ __align__(16) float smem[];
  const CnnSmem m = cnn_smem<kChannels>(smem, H);
  __shared__ int s[kUsedRows];
  __shared__ uint32_t words[4 * kCalls];

  const int b = blockIdx.x, tid = threadIdx.x;
  load_conv<kChannels>(m, wts);
  if (tid < kUsedRows) s[tid] = st0[tid * B + b];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const long tb = (long)t * B + b;
    build_planes(m.planes, obs_out + tb * kObs, s);
    if (use_prng) step_words<kCalls>(words, t, b, key0, key1);
    __syncthreads();
    q_values<kChannels>(m, wts, H, A);

    if (tid == 0) {
      const int greedy = greedy_action(m.q, q_out + tb * A, A);
      float u = 1.0f;
      int rand_act = 0, speed[kLanes], dir[kLanes], reset_x[kLanes];
      for (int k = 0; k < kLanes; ++k) {
        speed[k] = use_prng ? (int)((words[2 + k] >> 8) % 5u) + 1 : 3;
        dir[k] = use_prng ? (((words[10 + k] >> 8) & 1u) ? 1 : -1) : 1;
        reset_x[k] = use_prng ? (int)((words[18 + k] >> 8) % 10u) : 0;
      }
      if (use_prng) {
        u = unit24(words[0]);
        rand_act = (int)((words[1] >> 8) % (uint32_t)A);
      }
      const int action = u < eps ? rand_act : greedy;

      // the chicken moves when its cooldown is over (actions: noop, up, down)
      const bool moved = s[kMoveTimer] == 0 && action != 0;
      int pos = min(max(s[kPos] + (moved ? (action == 1 ? -1 : 1) : 0), 0), kSide - 1);
      const int move_timer = moved ? player_speed : max(s[kMoveTimer] - 1, 0);

      // reaching the top scores and draws new lane speeds
      const bool scored = pos == 0;
      if (scored) {
        for (int k = 0; k < kLanes; ++k) {
          s[kTimer + k] = speed[k];
          s[kSpeed + k] = speed[k] * dir[k];
        }
        pos = kSide - 1;
      }

      // the cars move on their lane timers; a car on the chicken before or
      // after the move sends it back
      const bool hit_before = hit(s, pos);
      for (int k = 0; k < kLanes; ++k) {
        if (s[kTimer + k] <= 0) {
          s[kX + k] = wrap(s[kX + k] + (s[kSpeed + k] > 0 ? 1 : -1));
          s[kTimer + k] = abs(s[kSpeed + k]);
        } else {
          s[kTimer + k] -= 1;
        }
      }
      if (hit_before || hit(s, pos)) pos = kSide - 1;

      const int time = s[kTime] + 1;
      const bool done = time >= max_steps;
      act_out[tb] = action;
      rew_out[tb] = scored ? 1.0f : 0.0f;
      done_out[tb] = done ? 1 : 0;
      if (done) {  // reset: new columns, the step's speeds and directions
        pos = kSide - 1;
        for (int k = 0; k < kLanes; ++k) {
          s[kX + k] = reset_x[k];
          s[kTimer + k] = speed[k];
          s[kSpeed + k] = speed[k] * dir[k];
        }
      }
      s[kPos] = pos;
      s[kMoveTimer] = done ? 0 : move_timer;
      s[kTime] = done ? 0 : time;
    }
    __syncthreads();
  }

  build_planes(m.planes, final_obs + (long)b * kObs, s);
  if (tid < kStateRows) st_out[tid * B + b] = tid < kUsedRows ? s[tid] : 0;
}

}  // namespace

extern "C" {

// Launches one block of 256 threads per env on `stream`; returns the
// launch's cudaError_t (0 on success). The wrapper checks shapes: H a
// multiple of 32 in [32, 256], 1 <= A <= 8, the dense weight 16-byte
// aligned.
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
                        void* stream) {
  const CnnWeights wts{conv_w, conv_b, ln1_scale, ln1_bias, dense_w,
                       dense_b, ln2_scale, ln2_bias, head_w, head_b};
  const size_t smem = cnn_smem_floats(kChannels, H) * sizeof(float);
  freeway_rollout_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      wts, st0, obs_out, act_out, rew_out, done_out, q_out, final_obs, st_out,
      T, B, H, A, (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32),
      eps, use_prng, max_steps, player_speed);
  return (int)cudaGetLastError();
}

const char* freeway_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
