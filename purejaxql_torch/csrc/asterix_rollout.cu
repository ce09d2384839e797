// Fused Asterix-MinAtar rollout: T env steps of observation planes, the
// MinAtar CNN forward, epsilon-greedy, the Asterix rules and the reset in one
// launch.
//
// Replaces: purejaxql_tpu/ops/pallas_rollout.py `_make_asterix_kernel`
// (called by `asterix_rollout_pallas` through `_call_game_kernel`), which
// runs the rollout as a sequential grid over T with the env batch on the 128
// lanes: an (8, B) row per slot field, one (10, 10, B) mask per slot for the
// planes, the shared `_cnn_forward`, and the TPU's hardware PRNG. None of
// that layout carries over.
//
// Bound on an H100: the CNN forward is most of the work, as in the Breakout
// kernel (about 3.5e5 flops per env step at H = 128; the game's rules are a
// few hundred integer operations), so the bound is operations; in practice
// the kernel is bound by latency, T dependent steps of barriers with the
// 512 KiB dense weight read from L2 at every step (minatar_cnn.cuh).
//
// Design (simple and right first): one block of 256 threads per env. Each
// step the block builds the 4 planes (player, enemy, trail, gold) in shared
// memory and writes them out, threads 0-2 draw the step's 12 Philox words,
// the block runs the MinAtar CNN of minatar_cnn.cuh, and thread 0 runs the
// argmax (first index wins ties), the epsilon coin and the Asterix rules on
// the 8 slots in the order of asterix.py:79-196 (spawn, player move,
// collide, entity move, collide, ramp), then the deterministic reset. The
// game is integer logic, so kernel and plain twin agree exactly on
// everything but the Q-values' last bits.
//
// Randomness: Philox4x32-10 (philox.cuh), counter (step, env, k, 0) for
// k = 0, 1, 2: word 0 the coin, 1 the random action, 2-9 the slot scores,
// 10 the spawn direction, 11 gold (below 1/3), each from its top 24 bits as
// pallas_rollout.py:764-782 uses its words. The spawn takes the free slot
// with the highest score, the first on ties (pallas_rollout.py:800-808).
// With use_prng = 0: coin 1, random action 0, each slot's score its index
// (the highest free slot wins), direction left, no gold
// (pallas_rollout.py:783-790).

#include <cuda_runtime.h>
#include <stdint.h>

#include "minatar_cnn.cuh"
#include "philox.cuh"

namespace {

using namespace minatar;

constexpr int kChannels = 4;  // player, enemy, trail, gold
constexpr int kObs = kCells * kChannels;
constexpr int kSlots = 8;     // one entity slot on each of rows 1-8
constexpr int kCalls = 3;     // Philox calls per step: 12 words
// The default params' cadences (asterix.py AsterixParams), built in as in the
// TPU kernel: the trainer refuses ENV_KWARGS for this game's fused rollout.
constexpr int kRampInterval = 100;
constexpr int kInitSpawn = 10;
constexpr int kInitMove = 5;

// rows of the (48, B) state matrix
enum {
  kPX, kPY, kSpawnSpeed, kSpawnTimer, kMoveSpeed, kMoveTimer, kRampTimer,
  kRampIndex, kTime, kTerm,
  kExists = 10, kX = 18, kLR = 26, kGold = 34, kUsedRows = 42, kStateRows = 48
};

// The observation of a state as (row, col, channel) planes, into shared
// memory and out to `out` (asterix.py get_obs).
__device__ void build_planes(float* planes, float* __restrict__ out, const int* s) {
  for (int k = threadIdx.x; k < kObs; k += blockDim.x) {
    const int cell = k / kChannels, ch = k - cell * kChannels;
    const int r = cell / kSide, c = cell - r * kSide;
    bool on = false;
    if (ch == 0) {
      on = r == s[kPY] && c == s[kPX];
    } else if (r >= 1 && r <= kSlots && s[kExists + r - 1]) {
      const int slot = r - 1, x = s[kX + slot];
      const bool gold = s[kGold + slot] != 0;
      if (ch == 1) {
        on = !gold && c == x;
      } else if (ch == 2) {  // the trail: the cell the entity came from
        on = c == min(max(x + (s[kLR + slot] ? -1 : 1), 0), kSide - 1);
      } else {
        on = gold && c == x;
      }
    }
    planes[k] = on ? 1.0f : 0.0f;
    out[k] = on ? 1.0f : 0.0f;
  }
}

// The player touches the entities on its cell: gold scores, an enemy ends
// the episode; either way the entity is gone (asterix.py:123-133).
__device__ __forceinline__ void collide(int* s, int px, int py, int& reward, int& terminal) {
  for (int k = 0; k < kSlots; ++k) {
    if (s[kExists + k] && s[kX + k] == px && k + 1 == py) {
      if (s[kGold + k]) {
        ++reward;
      } else {
        terminal = 1;
      }
      s[kExists + k] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads) asterix_rollout_kernel(
    CnnWeights wts, const int* __restrict__ st0, float* __restrict__ obs_out,
    int* __restrict__ act_out, float* __restrict__ rew_out,
    int* __restrict__ done_out, float* __restrict__ q_out,
    float* __restrict__ final_obs, int* __restrict__ st_out, int T, int B,
    int H, int A, uint32_t key0, uint32_t key1, float eps, int use_prng,
    int max_steps) {
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
      float u = 1.0f, score[kSlots];
      int rand_act = 0, lr = 0, gold = 0;
      for (int k = 0; k < kSlots; ++k) score[k] = (float)k;
      if (use_prng) {
        u = unit24(words[0]);
        rand_act = (int)((words[1] >> 8) % (uint32_t)A);
        for (int k = 0; k < kSlots; ++k) score[k] = unit24(words[2 + k]);
        lr = (int)((words[10] >> 8) & 1u);
        gold = unit24(words[11]) < (1.0f / 3.0f) ? 1 : 0;
      }
      const int action = u < eps ? rand_act : greedy;

      // spawn into the free slot with the highest score, the first on ties
      const int spawn_speed = s[kSpawnSpeed], move_speed = s[kMoveSpeed];
      const bool do_spawn = s[kSpawnTimer] == 0;
      int slot = -1;
      for (int k = 0; k < kSlots; ++k) {
        if (!s[kExists + k] && (slot < 0 || score[k] > score[slot])) slot = k;
      }
      if (do_spawn && slot >= 0) {
        s[kExists + slot] = 1;
        s[kX + slot] = lr ? 0 : kSide - 1;
        s[kLR + slot] = lr;
        s[kGold + slot] = gold;
      }
      const int spawn_timer = do_spawn ? spawn_speed : s[kSpawnTimer] - 1;

      // player move (actions: noop, left, up, right, down)
      const int px = min(max(s[kPX] + (action == 3) - (action == 1), 0), kSide - 1);
      const int py = min(max(s[kPY] + (action == 4) - (action == 2), 1), kSlots);
      int reward = 0, terminal = s[kTerm];
      collide(s, px, py, reward, terminal);

      // entity move: one column on the move timer; off the board, gone
      const bool do_move = s[kMoveTimer] == 0;
      for (int k = 0; k < kSlots; ++k) {
        if (do_move && s[kExists + k]) {
          const int nx = s[kX + k] + (s[kLR + k] ? 1 : -1);
          if (nx < 0 || nx > kSide - 1) s[kExists + k] = 0;
          s[kX + k] = min(max(nx, 0), kSide - 1);
        }
      }
      const int move_timer = do_move ? move_speed : s[kMoveTimer] - 1;
      collide(s, px, py, reward, terminal);

      // ramping, from the cadences the step started with
      const int ramp_timer0 = s[kRampTimer], ramp_index0 = s[kRampIndex];
      const bool can_ramp = spawn_speed > 1 || move_speed > 1;
      const bool do_ramp = can_ramp && ramp_timer0 <= 0;
      const bool ramp_move = do_ramp && ramp_index0 % 2 == 1 && move_speed > 1;
      const bool ramp_spawn = do_ramp && ramp_index0 % 2 == 0 && spawn_speed > 1;

      const int time = s[kTime] + 1;
      const bool done = terminal != 0 || time >= max_steps;
      act_out[tb] = action;
      rew_out[tb] = (float)reward;
      done_out[tb] = done ? 1 : 0;
      if (done) {  // the deterministic reset (asterix.py:60-77)
        s[kPX] = 5;
        s[kPY] = 5;
        s[kSpawnSpeed] = s[kSpawnTimer] = kInitSpawn;
        s[kMoveSpeed] = s[kMoveTimer] = kInitMove;
        s[kRampTimer] = kRampInterval;
        s[kRampIndex] = 0;
        s[kTerm] = 0;
        s[kTime] = 0;
        for (int k = kExists; k < kUsedRows; ++k) s[k] = 0;
      } else {
        s[kPX] = px;
        s[kPY] = py;
        s[kSpawnSpeed] = spawn_speed - (ramp_spawn ? 1 : 0);
        s[kSpawnTimer] = spawn_timer;
        s[kMoveSpeed] = move_speed - (ramp_move ? 1 : 0);
        s[kMoveTimer] = move_timer;
        s[kRampTimer] = do_ramp ? kRampInterval : ramp_timer0 - (can_ramp ? 1 : 0);
        s[kRampIndex] = ramp_index0 + (do_ramp ? 1 : 0);
        s[kTerm] = 0;  // a terminal step is done
        s[kTime] = time;
      }
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
int asterix_rollout_f32(const float* conv_w, const float* conv_b,
                        const float* ln1_scale, const float* ln1_bias,
                        const float* dense_w, const float* dense_b,
                        const float* ln2_scale, const float* ln2_bias,
                        const float* head_w, const float* head_b,
                        const int* st0, float* obs_out, int* act_out,
                        float* rew_out, int* done_out, float* q_out,
                        float* final_obs, int* st_out, int T, int B, int H,
                        int A, unsigned long long seed, float eps,
                        int use_prng, int max_steps, void* stream) {
  const CnnWeights wts{conv_w, conv_b, ln1_scale, ln1_bias, dense_w,
                       dense_b, ln2_scale, ln2_bias, head_w, head_b};
  const size_t smem = cnn_smem_floats(kChannels, H) * sizeof(float);
  asterix_rollout_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      wts, st0, obs_out, act_out, rew_out, done_out, q_out, final_obs, st_out,
      T, B, H, A, (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32),
      eps, use_prng, max_steps);
  return (int)cudaGetLastError();
}

const char* asterix_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
