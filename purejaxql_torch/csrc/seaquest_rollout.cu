// Fused Seaquest-MinAtar rollout: T env steps of observation planes, the
// MinAtar CNN forward, epsilon-greedy, the Seaquest rules and the reset in
// one launch.
//
// Replaces: purejaxql_tpu/ops/pallas_rollout.py `_make_seaquest_kernel`
// (called by `seaquest_rollout_pallas` through `_call_game_kernel`), which
// runs the rollout as a sequential grid over T with the env batch on the 128
// lanes: the (128, B) state slab, one (10, 10, B) mask per pool slot for the
// planes (`_pool_mask`, `_seaquest_planes`), the shared `_cnn_forward`, and
// the TPU's hardware PRNG. None of that layout carries over.
//
// Bound on an H100: the CNN forward is most of the work, as in the other
// MinAtar kernels (about 3.7e5 flops per env step at C = 10, H = 128; the
// game's rules a few hundred integer operations over the five pools), so the
// bound is operations; in practice the kernel is bound by latency, T
// dependent steps of barriers with the 512 KiB dense weight read from L2 at
// every step (minatar_cnn.cuh).
//
// Design (simple and right first): one block of 256 threads per env. Each
// step the block builds the 10 planes in shared memory, one cell and channel
// per thread (each pool's entities counted on the cell, then clamped to 1,
// as `_pool_mask` adds before the clamp), writes them out, threads 0-7 draw
// the step's 29 Philox words, the block runs the MinAtar CNN of
// minatar_cnn.cuh, and thread 0 runs the argmax (first index wins ties), the
// epsilon coin and the Seaquest rules on the pools (4-8 slots each: a
// barrier between rule phases would cost more than the rules) in the order
// of seaquest.py:153-353, then the deterministic reset. The game is integer
// logic but for the cash-in, so kernel and plain twin agree exactly on
// everything but the Q-values' last bits.
//
// Randomness: Philox4x32-10 (philox.cuh), counter (step, env, k, 0) for
// k = 0 .. 7: word 0 the coin, 1 the random action, 2-5 the friendly-bullet
// slot scores, 6-9 the enemy-bullet ones, 10-17 the fish, 18-21 the subs,
// 22-25 the divers, 26 the lane ((w >> 8) % 8 + 1), 27 the direction
// (bit 8), 28 is_sub (below 1/3), in the draw order of
// pallas_rollout.py:1734-1750. A spawn takes the slot of `_first_free`
// (pallas_rollout.py:1619): the free slot whose score is the highest of
// (free ? score : -1), the first on ties. With use_prng = 0 (the TPU
// kernel's deterministic mode, :1751-1762): coin 1, random action 0, each
// slot scored minus its index, lane 4, from the right edge, a fish.
//
// Care points: the oxygen gauge floors (oxygen * 10) / max_oxygen, which C's
// division truncates (they differ below 0); the sub's back cell is clamped,
// not wrapped; a sub's shot timer runs down only while the sub exists; the
// cash-in is oxygen * 0.1f, as XLA compiles the JAX env's oxygen / 10, with
// the product rounded before the add (__fmul_rn: no fused multiply-add).

#include <cuda_runtime.h>
#include <stdint.h>

#include "minatar_cnn.cuh"
#include "philox.cuh"

namespace {

using namespace minatar;

constexpr int kChannels = 10;
constexpr int kObs = kCells * kChannels;
constexpr int kCalls = 8;  // Philox calls per step: 32 words, 29 used
// The default params (seaquest.py SeaquestParams), built in as in the TPU
// kernel: the trainer refuses other ENV_KWARGS than max_steps_in_episode
// for this game's fused rollout.
constexpr int kMaxOxygen = 200;
constexpr int kSpawnSpeed = 20;
constexpr int kDiverSpawnSpeed = 30;
constexpr int kMoveInterval = 5;
constexpr int kShotCoolDown = 5;
constexpr int kEnemyShotInterval = 10;

// rows of the (128, B) state matrix (pallas_rollout.py:1609-1616)
enum {
  kSX, kSY, kSOr, kOxygen, kDivers, kShotTimer, kSpawnTimer, kDiverTimer,
  kMoveInt, kSurfaced, kTerm, kTime,
  kFish = 12,     // exists, x, y, dir, timer: 8 rows each
  kSubs = 52,     // exists, x, y, dir, timer, shot timer: 4 rows each
  kFBullet = 76,  // exists, x, y, dir: 4 rows each
  kEBullet = 92,  // exists, x, y, dir: 4 rows each
  kDiver = 108,   // exists, x, y, dir, timer: 4 rows each
  kStateRows = 128
};
constexpr int kNFish = 8, kNPool = 4;

// A pool of n slots: field f of slot k is row base + f * n + k.
struct Pool {
  int* s;
  int base, n;
  __device__ int& at(int field, int k) const { return s[base + field * n + k]; }
};
enum { kE, kX, kY, kDir, kTimer, kShot };

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// floor(a / b) for b > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Live entities of a pool on cell (r, c), at (x + dx, y) with x clamped
// after the shift (the trail channel) when `trail`.
__device__ __forceinline__ int count_on(const int* s, int base, int n, int r, int c, bool trail) {
  int count = 0;
  for (int k = 0; k < n; ++k) {
    if (!s[base + k]) continue;
    int x = s[base + n + k];
    if (trail) x = clampi(x - s[base + 3 * n + k], 0, kSide - 1);
    count += (s[base + 2 * n + k] == r && x == c) ? 1 : 0;
  }
  return count;
}

// The observation of a state as (row, col, channel) planes, into shared
// memory and out to `out` (seaquest.py get_obs).
__device__ void build_planes(float* planes, float* __restrict__ out, const int* s) {
  for (int k = threadIdx.x; k < kObs; k += blockDim.x) {
    const int cell = k / kChannels, ch = k - cell * kChannels;
    const int r = cell / kSide, c = cell - r * kSide;
    int on = 0;
    switch (ch) {
      case 0:  // the sub's front cell
        on = r == s[kSY] && c == s[kSX];
        break;
      case 1:  // its back cell, behind it, clamped to the board
        on = r == s[kSY] && c == clampi(s[kSX] + (s[kSOr] == 1 ? -1 : 1), 0, kSide - 1);
        break;
      case 2: on = count_on(s, kFBullet, kNPool, r, c, false); break;
      case 3: on = count_on(s, kFBullet, kNPool, r, c, true); break;
      case 4: on = count_on(s, kSubs, kNPool, r, c, false); break;
      case 5: on = count_on(s, kEBullet, kNPool, r, c, false); break;
      case 6: on = count_on(s, kFish, kNFish, r, c, false); break;
      case 7: on = count_on(s, kDiver, kNPool, r, c, false); break;
      case 8:  // the oxygen gauge on row 9
        on = r == kSide - 1 && c < clampi(floor_div(s[kOxygen] * 10, kMaxOxygen), 0, 9);
        break;
      default:  // the divers on board, row 9
        on = r == kSide - 1 && c < s[kDivers];
    }
    const float v = on > 0 ? 1.0f : 0.0f;
    planes[k] = v;
    out[k] = v;
  }
}

// `_first_free`: the free slot with the highest of (free ? score : -1), the
// first on ties, or -1 where that maximum is an occupied slot's; `any_free`
// says whether any slot is free.
__device__ __forceinline__ int first_free(const Pool& p, const float* score, bool& any_free) {
  float best = -2.0f;
  for (int k = 0; k < p.n; ++k) best = fmaxf(best, p.at(kE, k) ? -1.0f : score[k]);
  any_free = false;
  int slot = -1;
  for (int k = 0; k < p.n; ++k) {
    if (p.at(kE, k)) continue;
    any_free = true;
    if (slot < 0 && score[k] == best) slot = k;
  }
  return slot;
}

// Lane entities step on their cadence and leave off the board
// (seaquest.py:88-96); every slot's timer runs, live or not.
__device__ __forceinline__ void move_lane(const Pool& p, int interval) {
  for (int k = 0; k < p.n; ++k) {
    const bool do_move = p.at(kTimer, k) <= 0;
    const int nx = p.at(kX, k) + ((do_move && p.at(kE, k)) ? p.at(kDir, k) : 0);
    if (do_move && (nx < 0 || nx > kSide - 1)) p.at(kE, k) = 0;
    p.at(kX, k) = clampi(nx, 0, kSide - 1);
    p.at(kTimer, k) = do_move ? interval : p.at(kTimer, k) - 1;
  }
}

__device__ __forceinline__ void place(const Pool& p, int k, int x, int y, int dir) {
  p.at(kE, k) = 1;
  p.at(kX, k) = x;
  p.at(kY, k) = y;
  p.at(kDir, k) = dir;
}

__device__ __forceinline__ bool any_at(const Pool& p, int x, int y) {
  for (int k = 0; k < p.n; ++k) {
    if (p.at(kE, k) && p.at(kX, k) == x && p.at(kY, k) == y) return true;
  }
  return false;
}

// The deterministic reset (seaquest.py:114-150).
__device__ void reset_state(int* s) {
  for (int k = 0; k < kStateRows; ++k) s[k] = 0;
  s[kSX] = 5;
  s[kSOr] = 1;
  s[kOxygen] = kMaxOxygen;
  s[kSpawnTimer] = kSpawnSpeed;
  s[kDiverTimer] = kDiverSpawnSpeed;
  s[kMoveInt] = kMoveInterval;
  s[kSurfaced] = 1;
  for (int k = 0; k < kNFish; ++k) s[kFish + kDir * kNFish + k] = 1;
  for (int k = 0; k < kNPool; ++k) {
    s[kSubs + kDir * kNPool + k] = 1;
    s[kSubs + kShot * kNPool + k] = kEnemyShotInterval;
    s[kFBullet + kDir * kNPool + k] = 1;
    s[kEBullet + kDir * kNPool + k] = 1;
    s[kDiver + kDir * kNPool + k] = 1;
  }
}

// One step of the rules on the state `s` (seaquest.py:153-353) for `action`
// with the step's draws; returns the reward and sets `done`, then resets a
// finished env.
__device__ float step(int* s, int action, const float* sc_fb, const float* sc_eb,
                      const float* sc_fish, const float* sc_sub, const float* sc_diver,
                      int lane, int lr, int is_sub, int max_steps, bool& done) {
  const Pool fish{s, kFish, kNFish}, subs{s, kSubs, kNPool};
  const Pool fb{s, kFBullet, kNPool}, eb{s, kEBullet, kNPool}, dv{s, kDiver, kNPool};

  // player (actions: noop, left, up, right, down, fire)
  const int sub_x = clampi(s[kSX] + (action == 3) - (action == 1), 0, 9);
  const int sub_y = clampi(s[kSY] + (action == 4) - (action == 2), 0, 8);
  const int sub_or = action == 1 ? 0 : action == 3 ? 1 : s[kSOr];

  // fire: one friendly bullet from the sub's nose
  bool free_fb;
  const int fb_slot = first_free(fb, sc_fb, free_fb);
  const bool do_fire = action == 5 && s[kShotTimer] == 0 && free_fb;
  if (do_fire && fb_slot >= 0) place(fb, fb_slot, sub_x, sub_y, sub_or == 1 ? 1 : -1);
  const int shot_timer = do_fire ? kShotCoolDown : max(s[kShotTimer] - 1, 0);

  // bullets move every step; off the board, gone
  const Pool bullets[2] = {fb, eb};
  for (const Pool& p : bullets) {
    for (int k = 0; k < kNPool; ++k) {
      if (!p.at(kE, k)) continue;
      const int nx = p.at(kX, k) + p.at(kDir, k);
      if (nx < 0 || nx > kSide - 1) p.at(kE, k) = 0;
      p.at(kX, k) = clampi(nx, 0, kSide - 1);
    }
  }

  // lane entities on their cadence, the divers at half the pace
  const int mvi = s[kMoveInt];
  move_lane(fish, mvi);
  move_lane(subs, mvi);
  move_lane(dv, 2 * mvi);

  // the first sub whose shot timer ran out fires into a free bullet slot;
  // only the timers of subs that exist run down
  int shooter = -1;
  for (int k = 0; k < kNPool; ++k) {
    subs.at(kShot, k) -= subs.at(kE, k) ? 1 : 0;
    if (shooter < 0 && subs.at(kE, k) && subs.at(kShot, k) <= 0) shooter = k;
  }
  bool free_eb;
  const int eb_slot = first_free(eb, sc_eb, free_eb);
  if (shooter >= 0 && free_eb) {
    if (eb_slot >= 0) {
      place(eb, eb_slot, subs.at(kX, shooter), subs.at(kY, shooter), subs.at(kDir, shooter));
    }
    subs.at(kShot, shooter) = kEnemyShotInterval;
  }

  // friendly bullets hit fish and subs (every bullet on a cell hits every
  // enemy on it)
  int kills = 0;
  bool bullet_hit[kNPool] = {false, false, false, false};
  const Pool enemies[2] = {fish, subs};
  for (const Pool& p : enemies) {
    for (int j = 0; j < p.n; ++j) {
      if (!p.at(kE, j)) continue;
      bool hit = false;
      for (int i = 0; i < kNPool; ++i) {
        if (fb.at(kE, i) && fb.at(kX, i) == p.at(kX, j) && fb.at(kY, i) == p.at(kY, j)) {
          hit = true;
          bullet_hit[i] = true;
        }
      }
      if (hit) {
        p.at(kE, j) = 0;
        ++kills;
      }
    }
  }
  for (int i = 0; i < kNPool; ++i) {
    if (bullet_hit[i]) fb.at(kE, i) = 0;
  }

  // spawns: an enemy on the spawn cadence, a diver on its own
  const int edge_x = lr ? 0 : kSide - 1, edge_dir = lr ? 1 : -1;
  int spawn_timer = s[kSpawnTimer] - 1;
  const bool do_spawn = spawn_timer <= 0;
  bool free_f, free_s;
  const int f_slot = first_free(fish, sc_fish, free_f);
  const int s_slot = first_free(subs, sc_sub, free_s);
  if (do_spawn && !is_sub && free_f && f_slot >= 0) place(fish, f_slot, edge_x, lane, edge_dir);
  if (do_spawn && is_sub && free_s && s_slot >= 0) place(subs, s_slot, edge_x, lane, edge_dir);
  if (do_spawn) spawn_timer = kSpawnSpeed;
  int diver_timer = s[kDiverTimer] - 1;
  const bool do_dspawn = diver_timer <= 0;
  bool free_d;
  const int d_slot = first_free(dv, sc_diver, free_d);
  if (do_dspawn && free_d && d_slot >= 0) place(dv, d_slot, edge_x, lane, edge_dir);
  if (do_dspawn) diver_timer = kDiverSpawnSpeed;

  // the sub picks up divers and meets enemies and their bullets
  int divers = s[kDivers];
  for (int k = 0; k < kNPool; ++k) {
    if (dv.at(kE, k) && dv.at(kX, k) == sub_x && dv.at(kY, k) == sub_y) {
      ++divers;
      dv.at(kE, k) = 0;
    }
  }
  divers = min(divers, 6);
  const bool hit_enemy = any_at(fish, sub_x, sub_y) || any_at(subs, sub_x, sub_y) || any_at(eb, sub_x, sub_y);

  // oxygen and surfacing: with no diver fatal, with six a cash-in
  const bool underwater = sub_y > 0;
  int oxygen = underwater ? s[kOxygen] - 1 : s[kOxygen];
  const bool now_surfacing = !underwater && !s[kSurfaced];
  const bool fatal = now_surfacing && divers == 0;
  const bool cash_in = now_surfacing && divers == 6;
  float reward = (float)kills;
  if (cash_in) reward = reward + __fmul_rn((float)oxygen, 0.1f);
  if (now_surfacing && !fatal) {
    divers = cash_in ? 0 : divers - 1;
    oxygen = kMaxOxygen;
  }

  const bool terminal = s[kTerm] || hit_enemy || fatal || oxygen < 0;
  const int time = s[kTime] + 1;
  done = terminal || time >= max_steps;
  if (done) {
    reset_state(s);
  } else {
    s[kSX] = sub_x;
    s[kSY] = sub_y;
    s[kSOr] = sub_or;
    s[kOxygen] = oxygen;
    s[kDivers] = divers;
    s[kShotTimer] = shot_timer;
    s[kSpawnTimer] = spawn_timer;
    s[kDiverTimer] = diver_timer;
    s[kSurfaced] = underwater ? 0 : 1;
    s[kTerm] = 0;  // a terminal step is done
    s[kTime] = time;
  }
  return reward;
}

__global__ void __launch_bounds__(kThreads) seaquest_rollout_kernel(
    CnnWeights wts, const int* __restrict__ st0, float* __restrict__ obs_out,
    int* __restrict__ act_out, float* __restrict__ rew_out,
    int* __restrict__ done_out, float* __restrict__ q_out,
    float* __restrict__ final_obs, int* __restrict__ st_out, int T, int B,
    int H, int A, uint32_t key0, uint32_t key1, float eps, int use_prng,
    int max_steps) {
  extern __shared__ __align__(16) float smem[];
  const CnnSmem m = cnn_smem<kChannels>(smem, H);
  __shared__ int s[kStateRows];
  __shared__ uint32_t words[4 * kCalls];

  const int b = blockIdx.x, tid = threadIdx.x;
  load_conv<kChannels>(m, wts);
  if (tid < kStateRows) s[tid] = st0[tid * B + b];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const long tb = (long)t * B + b;
    build_planes(m.planes, obs_out + tb * kObs, s);
    if (use_prng) step_words<kCalls>(words, t, b, key0, key1);
    __syncthreads();
    q_values<kChannels>(m, wts, H, A);

    if (tid == 0) {
      const int greedy = greedy_action(m.q, q_out + tb * A, A);
      // the slot scores of the five pools, in the word order: friendly
      // bullets, enemy bullets, fish, subs, divers
      float score[24];
      float u = 1.0f;
      int rand_act = 0, lane = 4, lr = 0, is_sub = 0;
      if (use_prng) {
        u = unit24(words[0]);
        rand_act = (int)((words[1] >> 8) % (uint32_t)A);
        for (int k = 0; k < 24; ++k) score[k] = unit24(words[2 + k]);
        lane = (int)((words[26] >> 8) % 8u) + 1;
        lr = (int)((words[27] >> 8) & 1u);
        is_sub = unit24(words[28]) < (1.0f / 3.0f) ? 1 : 0;
      } else {
        const int n[5] = {kNPool, kNPool, kNFish, kNPool, kNPool};
        for (int p = 0, k = 0; p < 5; ++p) {
          for (int i = 0; i < n[p]; ++i) score[k++] = -(float)i;
        }
      }
      const int action = u < eps ? rand_act : greedy;
      bool done;
      const float reward = step(s, action, score, score + 4, score + 8, score + 16, score + 20,
                                lane, lr, is_sub, max_steps, done);
      act_out[tb] = action;
      rew_out[tb] = reward;
      done_out[tb] = done ? 1 : 0;
    }
    __syncthreads();
  }

  build_planes(m.planes, final_obs + (long)b * kObs, s);
  if (tid < kStateRows) st_out[tid * B + b] = s[tid];
}

}  // namespace

extern "C" {

// Launches one block of 256 threads per env on `stream`; returns the
// launch's cudaError_t (0 on success). The wrapper checks shapes: H a
// multiple of 32 in [32, 256], 1 <= A <= 8, the dense weight 16-byte
// aligned.
int seaquest_rollout_f32(const float* conv_w, const float* conv_b,
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
  seaquest_rollout_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      wts, st0, obs_out, act_out, rew_out, done_out, q_out, final_obs, st_out,
      T, B, H, A, (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32),
      eps, use_prng, max_steps);
  return (int)cudaGetLastError();
}

const char* seaquest_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
