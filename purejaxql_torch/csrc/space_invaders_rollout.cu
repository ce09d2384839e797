// Fused SpaceInvaders-MinAtar rollout: T env steps of observation planes, the
// MinAtar CNN forward, epsilon-greedy, the SpaceInvaders rules and the reset
// in one launch.
//
// Replaces: purejaxql_tpu/ops/pallas_rollout.py `_make_si_kernel` (called by
// `space_invaders_rollout_pallas` through `_call_game_kernel`), which runs
// the rollout as a sequential grid over T with the env batch on the 128
// lanes: three (10, 10, B) maps shifted by concatenation, column and row
// sums as reductions over the map, the shared `_cnn_forward`, and the TPU's
// hardware PRNG. None of that layout carries over.
//
// Bound on an H100: the CNN forward is most of the work (54 conv taps, the
// dense layer 2 x 1024 x H flops per env step), so the bound is operations;
// in practice the kernel is bound by latency, T dependent steps of barriers
// with the 512 KiB dense weight read from L2 at every step
// (minatar_cnn.cuh).
//
// Design (simple and right first): one block of 256 threads per env, the
// three maps in shared memory. Each step the block builds the 6 planes
// (cannon, alien, alien moving left, alien moving right, friendly bullet,
// enemy bullet) and writes them out, thread 0 draws the step's Philox words,
// the block runs the MinAtar CNN of minatar_cnn.cuh, then the rules of
// space_invaders.py:73-185 in their order, in phases split by barriers:
//   1. thread 0: argmax (first index wins ties), the epsilon coin, the
//      cannon's move, fire and cooldown;
//   2. one thread per cell: the bullets travel and the aliens march, each
//      cell computed from the maps the phase started with; the counts the
//      march decides on (aliens in columns 0 and 9 and on row 9) come from
//      __syncthreads_count over the cells;
//   3. thread 0: the ends of the episode (an enemy bullet or an alien on the
//      cannon, a drop with aliens on the bottom row), the march timer, and
//      the shot of the lowest alien in the column nearest the cannon (the
//      first such column on ties);
//   4. one thread per cell: kills, counted with __syncthreads_count, and a
//      cleared wave;
//   5. thread 0: the ramp, time, done and the reset; then every cell
//      respawns the wave or resets its maps.
// A drop fills the top row with zeros where the env rolls the bottom row
// round, as the TPU kernel does: they differ only when aliens sit on the
// bottom row, and then the drop ends the episode and the maps are reset.
// The rules are integer logic, so kernel and plain twin agree exactly on
// everything but the Q-values' last bits.
//
// Randomness: the env draws none. Philox4x32-10 (philox.cuh), counter
// (step, env, 0, 0): word 0 the coin, word 1 the random action, each from
// its top 24 bits. With use_prng = 0: coin 1, random action 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "minatar_cnn.cuh"
#include "philox.cuh"

namespace {

using namespace minatar;

constexpr int kChannels = 6;
constexpr int kObs = kCells * kChannels;
constexpr int kBottom = kSide - 1;       // the cannon's row
// The default params (space_invaders.py SpaceInvadersParams), built in as in
// the TPU kernel: the trainer refuses ENV_KWARGS for this game's fused rollout.
constexpr int kResetInterval = 12;       // the march interval after a reset
constexpr int kShotCoolDown = 5;         // the cannon's cooldown after a shot
constexpr int kShotInterval = 10;        // steps between the aliens' shots

// rows of the (16, B) state matrix
enum {
  kPos, kDir, kInterval, kMoveTimer, kAlienShotTimer, kRampIndex, kShotTimer,
  kTerm, kTime, kUsedRows, kStateRows = 16
};

__device__ __forceinline__ int wave(int cell) {
  const int r = cell / kSide, c = cell - r * kSide;
  return (r <= 3 && c >= 2 && c <= 7) ? 1 : 0;
}

// The observation of a state as (row, col, channel) planes, into shared
// memory and out to `out` (space_invaders.py get_obs).
__device__ void build_planes(float* planes, float* __restrict__ out, const int* s,
                             const int* alien, const int* fmap, const int* emap) {
  for (int k = threadIdx.x; k < kObs; k += blockDim.x) {
    const int cell = k / kChannels, ch = k - cell * kChannels;
    const int r = cell / kSide, c = cell - r * kSide;
    int v;
    switch (ch) {
      case 0: v = r == kBottom && c == s[kPos]; break;
      case 1: v = alien[cell]; break;
      case 2: v = s[kDir] < 0 ? alien[cell] : 0; break;
      case 3: v = s[kDir] > 0 ? alien[cell] : 0; break;
      case 4: v = fmap[cell]; break;
      default: v = emap[cell]; break;
    }
    planes[k] = (float)v;
    out[k] = (float)v;
  }
}

__global__ void __launch_bounds__(kThreads) space_invaders_rollout_kernel(
    CnnWeights wts, const int* __restrict__ st0, const int* __restrict__ alien0,
    const int* __restrict__ fmap0, const int* __restrict__ emap0,
    float* __restrict__ obs_out, int* __restrict__ act_out,
    float* __restrict__ rew_out, int* __restrict__ done_out,
    float* __restrict__ q_out, float* __restrict__ final_obs,
    int* __restrict__ st_out, int* __restrict__ alien_out,
    int* __restrict__ fmap_out, int* __restrict__ emap_out, int T, int B,
    int H, int A, uint32_t key0, uint32_t key1, float eps, int use_prng,
    int max_steps) {
  extern __shared__ __align__(16) float smem[];
  const CnnSmem m = cnn_smem<kChannels>(smem, H);
  __shared__ int s[kUsedRows];
  __shared__ int alien[kCells], fmap[kCells], emap[kCells];
  __shared__ int col_has[kSide];
  __shared__ uint32_t words[4];
  __shared__ int fire, done;

  const int b = blockIdx.x, tid = threadIdx.x;
  // thread k owns cell k in the cell phases
  const bool is_cell = tid < kCells;
  const int r = tid / kSide, c = tid - r * kSide;
  load_conv<kChannels>(m, wts);
  if (tid < kUsedRows) s[tid] = st0[tid * B + b];
  if (is_cell) {
    alien[tid] = alien0[tid * B + b];
    fmap[tid] = fmap0[tid * B + b];
    emap[tid] = emap0[tid * B + b];
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const long tb = (long)t * B + b;
    build_planes(m.planes, obs_out + tb * kObs, s, alien, fmap, emap);
    if (use_prng) step_words<1>(words, t, b, key0, key1);
    __syncthreads();
    q_values<kChannels>(m, wts, H, A);

    // 1. the action; the cannon moves, then fires from its new column
    if (tid == 0) {
      const int greedy = greedy_action(m.q, q_out + tb * A, A);
      float u = 1.0f;
      int rand_act = 0;
      if (use_prng) {
        u = unit24(words[0]);
        rand_act = (int)((words[1] >> 8) % (uint32_t)A);
      }
      const int action = u < eps ? rand_act : greedy;
      act_out[tb] = action;
      fire = action == 3 && s[kShotTimer] == 0;
      s[kShotTimer] = fire ? kShotCoolDown : max(s[kShotTimer] - 1, 0);
      s[kPos] = min(max(s[kPos] + (action == 2) - (action == 1), 0), kSide - 1);
    }
    __syncthreads();

    // 2. bullets travel (friendly up, enemy down) and the aliens march, a
    //    drop and a turn at the wall, else a step sideways
    const int pos = s[kPos], dir = s[kDir];
    const bool do_move = s[kMoveTimer] == 0;
    const int col0 = __syncthreads_count(is_cell && c == 0 && alien[tid]);
    const int col9 = __syncthreads_count(is_cell && c == kSide - 1 && alien[tid]);
    const int row9 = __syncthreads_count(is_cell && r == kBottom && alien[tid]);
    const bool at_edge = (col0 > 0 && dir < 0) || (col9 > 0 && dir > 0);
    const bool drop = do_move && at_edge, shift = do_move && !at_edge;
    int f_new = 0, e_new = 0, a_new = 0;
    if (is_cell) {
      if (r < kBottom) f_new = fmap[tid + kSide] | (fire && r + 1 == kBottom && c == pos);
      if (r > 0) e_new = emap[tid - kSide];
      if (drop) {
        a_new = r > 0 ? alien[tid - kSide] : 0;
      } else if (shift && dir < 0) {
        a_new = c < kSide - 1 ? alien[tid + 1] : 0;
      } else if (shift) {
        a_new = c > 0 ? alien[tid - 1] : 0;
      } else {
        a_new = alien[tid];
      }
    }
    __syncthreads();
    if (is_cell) {
      fmap[tid] = f_new;
      emap[tid] = e_new;
      alien[tid] = a_new;
    }
    const int n_alien = __syncthreads_count(is_cell && a_new);
    if (tid < kSide) {
      int has = 0;
      for (int rr = 0; rr < kSide; ++rr) has |= alien[rr * kSide + tid];
      col_has[tid] = has;
    }
    __syncthreads();

    // 3. the ends of the episode, the march timer, the aliens' shot
    if (tid == 0) {
      const int under = kBottom * kSide + pos;
      s[kTerm] = s[kTerm] || emap[under] || (drop && row9 > 0) || alien[under];
      s[kDir] = drop ? -dir : dir;
      s[kMoveTimer] = do_move ? min(n_alien, s[kInterval]) : s[kMoveTimer] - 1;
      const bool do_shoot = s[kAlienShotTimer] == 0;
      int shoot_col = -1;
      for (int cc = 0; cc < kSide; ++cc) {
        if (col_has[cc] && (shoot_col < 0 || abs(cc - pos) < abs(shoot_col - pos))) shoot_col = cc;
      }
      if (do_shoot && shoot_col >= 0) {
        int shoot_row = 0;
        for (int rr = 0; rr < kSide; ++rr) {
          if (alien[rr * kSide + shoot_col]) shoot_row = rr;
        }
        emap[shoot_row * kSide + shoot_col] = 1;
      }
      s[kAlienShotTimer] = do_shoot ? kShotInterval : s[kAlienShotTimer] - 1;
    }
    __syncthreads();

    // 4. kills; a cleared wave
    const bool kill = is_cell && alien[tid] && fmap[tid];
    const int reward = __syncthreads_count(kill);
    if (kill) alien[tid] = fmap[tid] = 0;
    const bool cleared = __syncthreads_count(is_cell && alien[tid]) == 0;

    // 5. ramp, time, done and the reset
    if (tid == 0) {
      if (cleared) {
        s[kRampIndex] += 1;
        if (s[kInterval] > 6) s[kInterval] -= 1;
      }
      const int time = s[kTime] + 1;
      done = s[kTerm] || time >= max_steps;
      rew_out[tb] = (float)reward;
      done_out[tb] = done;
      s[kTime] = time;
      if (done) {  // the deterministic reset (space_invaders.py:55-71)
        s[kPos] = 5;
        s[kDir] = -1;
        s[kInterval] = kResetInterval;
        s[kMoveTimer] = kResetInterval;
        s[kAlienShotTimer] = kShotInterval;
        s[kRampIndex] = 0;
        s[kShotTimer] = 0;
        s[kTerm] = 0;
        s[kTime] = 0;
      }
    }
    __syncthreads();
    if (is_cell) {
      if (done) {
        alien[tid] = wave(tid);
        fmap[tid] = 0;
        emap[tid] = 0;
      } else if (cleared) {
        alien[tid] = wave(tid);
      }
    }
    __syncthreads();
  }

  build_planes(m.planes, final_obs + (long)b * kObs, s, alien, fmap, emap);
  if (tid < kStateRows) st_out[tid * B + b] = tid < kUsedRows ? s[tid] : 0;
  if (is_cell) {
    alien_out[tid * B + b] = alien[tid];
    fmap_out[tid * B + b] = fmap[tid];
    emap_out[tid * B + b] = emap[tid];
  }
}

}  // namespace

extern "C" {

// Launches one block of 256 threads per env on `stream`; returns the
// launch's cudaError_t (0 on success). The wrapper checks shapes: H a
// multiple of 32 in [32, 256], 1 <= A <= 8, the dense weight 16-byte
// aligned.
int space_invaders_rollout_f32(const float* conv_w, const float* conv_b,
                               const float* ln1_scale, const float* ln1_bias,
                               const float* dense_w, const float* dense_b,
                               const float* ln2_scale, const float* ln2_bias,
                               const float* head_w, const float* head_b,
                               const int* st0, const int* alien0,
                               const int* fmap0, const int* emap0,
                               float* obs_out, int* act_out, float* rew_out,
                               int* done_out, float* q_out, float* final_obs,
                               int* st_out, int* alien_out, int* fmap_out,
                               int* emap_out, int T, int B, int H, int A,
                               unsigned long long seed, float eps,
                               int use_prng, int max_steps, void* stream) {
  const CnnWeights wts{conv_w, conv_b, ln1_scale, ln1_bias, dense_w,
                       dense_b, ln2_scale, ln2_bias, head_w, head_b};
  const size_t smem = cnn_smem_floats(kChannels, H) * sizeof(float);
  space_invaders_rollout_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      wts, st0, alien0, fmap0, emap0, obs_out, act_out, rew_out, done_out,
      q_out, final_obs, st_out, alien_out, fmap_out, emap_out, T, B, H, A,
      (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32), eps,
      use_prng, max_steps);
  return (int)cudaGetLastError();
}

const char* space_invaders_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
