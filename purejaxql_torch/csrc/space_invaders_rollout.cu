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
// dense layer 2 x 1024 x H flops per env step), so the bound is operations.
//
// What bounded the old design: one block of 256 threads per env ran the
// whole CNN, whose dense layer read the whole 512 KiB dense weight (H 128)
// from L2 at every step of every env, 64 MiB a step at the trainer's B 128:
// 0.47-0.48 ms a launch (T 32), about 20x the operation bound, with the
// rules in five phases between thread 0 and the cells, split by twelve barriers.
//
// Design: the CNN of minatar_cluster.cuh, as the Asterix kernel runs it. A
// thread-block cluster of C CTAs takes C envs, one env a CTA; each CTA holds
// 1 / C of the dense weight in shared memory for the whole launch, and the
// CTAs trade the conv outputs' slices and the dense layer's partial sums
// through distributed shared memory. The plan (ops/space_invaders_rollout.py
// `space_invaders_plan`) takes C 16 (ops/minatar_rollout.py PLAN_CLUSTER
// gives the times behind the choice). The three maps live in the env's CTA.
// Each step a CTA with an env
//   0. applies the last step's map changes (the kills, then a respawned
//      wave or the reset) and builds the 6 planes (cannon, alien, alien
//      moving left, alien moving right, friendly bullet, enemy bullet) in
//      shared memory and writes them out, a thread a cell; thread 0 draws
//      the step's Philox words; the cluster runs the CNN;
//   1. warp 0: the Q-values out a lane an action; the march's decision on
//      aliens in columns 0 and 9 and on row 9 (three ballots over lanes
//      0-9); on lane 0 the argmax (first index wins ties), the epsilon coin,
//      the cannon's move, fire and cooldown;
//   2. a thread a cell: the bullets travel and the aliens march, each cell
//      computed from the maps the phase started with, then written;
//   3. warp 0: the aliens, kills and aliens left counted over the cells
//      (__reduce_add_sync), the ends of the episode (an enemy bullet or an
//      alien on the cannon, a drop with aliens on the bottom row), the march
//      timer, the shot of the lowest alien in the column nearest the cannon
//      (a lane a column, the first such column on ties by __reduce_min_sync),
//      the ramp, time, done and the reset of the scalars. The kills, the
//      respawn and the maps' reset are left to the next step's phase 0, as
//      no rule reads them before.
// Phases 1-3 take four block barriers a step where the old design took
// twelve. A drop fills the top row with zeros where the env rolls the bottom
// row round, as the TPU kernel does (pallas_rollout.py:1381-1383): they
// differ only when aliens sit on the bottom row, and then the drop ends the
// episode and the maps are reset. The rules are integer logic, so kernel and
// plain twin agree exactly on everything but the Q-values' last bits.
//
// Randomness: the env draws none. Philox4x32-10 (philox.cuh), counter
// (step, env, 0, 0): word 0 the coin, word 1 the random action, each from
// its top 24 bits. With use_prng = 0: coin 1, random action 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "minatar_cluster.cuh"
#include "philox.cuh"

namespace {

using namespace minatar;
using namespace minatar_cluster;

constexpr unsigned kAll = 0xffffffffu;
constexpr int kChannels = 6;
constexpr int kObs = kCells * kChannels;
constexpr int kBottom = kSide - 1;       // the cannon's row
constexpr int kCalls = 1;                // Philox calls per step: 4 words, 2 used
// The default params (space_invaders.py SpaceInvadersParams), built in as in
// the TPU kernel: the trainer refuses ENV_KWARGS for this game's fused rollout.
constexpr int kResetInterval = 12;       // the march interval after a reset
constexpr int kShotCoolDown = 5;         // the cannon's cooldown after a shot
constexpr int kShotInterval = 10;        // steps between the aliens' shots

// rows of the (16, B) state matrix; the kernel keeps its own scalars in the
// unused rows: phase 1's decisions for phases 2 and 3, and the map changes
// the next planes apply (kPending: kKills | kReset | kRespawn)
enum {
  kPos, kDir, kInterval, kMoveTimer, kAlienShotTimer, kRampIndex, kShotTimer,
  kTerm, kTime, kUsedRows,
  kFire = kUsedRows, kDrop, kShift, kRow9, kPending, kStateRows = 16
};
enum { kKills = 1, kReset = 2, kRespawn = 4 };
// the ints the kernel keeps in the env's CTA (Smem::game): the state rows,
// the step's Philox words and the alien, friendly-bullet and enemy-bullet
// maps (ops/space_invaders_rollout.py GAME_INTS)
constexpr int kWordsAt = 16;
constexpr int kAlienAt = 20;
constexpr int kFmapAt = 120;
constexpr int kEmapAt = 220;
constexpr int kGameInts = 320;
static_assert(kPending < kStateRows && kWordsAt == kStateRows && kAlienAt == kWordsAt + 4 * kCalls,
              "the rows, then the words");
static_assert(kFmapAt == kAlienAt + kCells && kEmapAt == kFmapAt + kCells && kGameInts == kEmapAt + kCells,
              "the three maps");

__device__ __forceinline__ int wave(int cell) {
  const int r = cell / kSide, c = cell - r * kSide;
  return (r <= 3 && c >= 2 && c <= 7) ? 1 : 0;
}

// The last step's map changes (the kills, then the reset or a respawned
// wave), then the observation as (row, col, channel) planes, into shared
// memory and out to `out` (space_invaders.py get_obs): a thread a cell, its
// 6 channels in three 8-byte stores each.
__device__ void build_planes(float* planes, float* __restrict__ out, const int* s, int* alien, int* fmap,
                             int* emap) {
  const int cell = threadIdx.x;
  if (cell >= kCells) return;
  int a = alien[cell], f = fmap[cell], e = emap[cell];
  const int pending = s[kPending];
  if ((pending & kKills) && a && f) a = f = 0;
  if (pending & kReset) {
    a = wave(cell);
    f = e = 0;
  } else if (pending & kRespawn) {
    a = wave(cell);
  }
  alien[cell] = a;
  fmap[cell] = f;
  emap[cell] = e;
  const int r = cell / kSide, c = cell - r * kSide, dir = s[kDir];
  const float av = a ? 1.0f : 0.0f;
  const float2 v[3] = {
      make_float2(r == kBottom && c == s[kPos] ? 1.0f : 0.0f, av),
      make_float2(dir < 0 ? av : 0.0f, dir > 0 ? av : 0.0f),
      make_float2(f ? 1.0f : 0.0f, e ? 1.0f : 0.0f),
  };
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    reinterpret_cast<float2*>(planes)[3 * cell + k] = v[k];
    reinterpret_cast<float2*>(out)[3 * cell + k] = v[k];
  }
}

template <int KC>
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
  extern __shared__ float4 smem4[];
  const Place p = place_of(B, H, A, T);
  const Smem m = smem_layout<kChannels>(reinterpret_cast<float*>(smem4), H, p.C);
  int* s = m.game;
  uint32_t* words = reinterpret_cast<uint32_t*>(m.game + kWordsAt);
  int* alien = m.game + kAlienAt;
  int* fmap = m.game + kFmapAt;
  int* emap = m.game + kEmapAt;

  const int b = p.b, tid = threadIdx.x;
  // thread k owns cell k in the cell phases
  const bool is_cell = tid < kCells;
  const int r = tid / kSide, c = tid - r * kSide;
  if (p.live) {
    if (tid < kUsedRows) s[tid] = st0[tid * B + b];
    if (tid == 0) s[kPending] = 0;
    if (is_cell) {
      alien[tid] = alien0[tid * B + b];
      fmap[tid] = fmap0[tid * B + b];
      emap[tid] = emap0[tid * B + b];
    }
  }
  load_and_arm<kChannels>(m, wts, p);
  unsigned parity = 0;  // bit i: the phase of mbarrier i to wait for

  for (int t = 0; t < T; ++t) {
    const long tb = (long)t * B + b;
    if (p.live) {
      build_planes(m.planes, obs_out + tb * kObs, s, alien, fmap, emap);
      if (use_prng) step_words<kCalls>(words, t, b, key0, key1);
      __syncthreads();
    }
    cluster_q_values<kChannels, KC>(m, wts, p, t, parity);
    if (!p.live) continue;

    // 1. the action; the cannon moves, then fires from its new column; the
    //    march decides on the maps the step started with
    if (tid < 32) {
      const int lane = tid;
      if (lane < A) q_out[tb * A + lane] = m.q[lane];
      const bool row = lane < kSide;
      const bool col0 = __any_sync(kAll, row && alien[lane * kSide] != 0);
      const bool col9 = __any_sync(kAll, row && alien[lane * kSide + kSide - 1] != 0);
      const bool row9 = __any_sync(kAll, row && alien[kBottom * kSide + lane] != 0);
      if (lane == 0) {
        const int greedy = greedy_of(m, A);
        float u = 1.0f;
        int rand_act = 0;
        if (use_prng) {
          u = unit24(words[0]);
          rand_act = (int)((words[1] >> 8) % (uint32_t)A);
        }
        const int action = u < eps ? rand_act : greedy;
        act_out[tb] = action;
        const int shot_timer = s[kShotTimer], dir = s[kDir];
        const bool fire = action == 3 && shot_timer == 0;
        const bool do_move = s[kMoveTimer] == 0;
        const bool at_edge = (col0 && dir < 0) || (col9 && dir > 0);
        s[kShotTimer] = fire ? kShotCoolDown : max(shot_timer - 1, 0);
        s[kPos] = min(max(s[kPos] + (action == 2) - (action == 1), 0), kSide - 1);
        s[kFire] = fire;
        s[kDrop] = do_move && at_edge;
        s[kShift] = do_move && !at_edge;
        s[kRow9] = row9;
      }
    }
    __syncthreads();

    // 2. bullets travel (friendly up, enemy down) and the aliens march, a
    //    drop and a turn at the wall, else a step sideways
    const int pos = s[kPos], dir = s[kDir];
    const bool fire = s[kFire] != 0, drop = s[kDrop] != 0, shift = s[kShift] != 0;
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
    __syncthreads();

    // 3. the counts, the ends of the episode, the march timer, the aliens'
    //    shot, the ramp and the reset
    if (tid < 32) {
      const int lane = tid;
      int n_alien = 0, n_kill = 0;
      for (int k = lane; k < kCells; k += 32) {
        const bool a = alien[k] != 0;
        n_alien += a;
        n_kill += a && fmap[k] != 0;
      }
      n_alien = __reduce_add_sync(kAll, n_alien);
      n_kill = __reduce_add_sync(kAll, n_kill);
      // lane l < 10 holds column l: whether it has an alien and its lowest
      int has = 0, low = 0;
      if (lane < kSide) {
        for (int rr = 0; rr < kSide; ++rr) {
          if (alien[rr * kSide + lane]) {
            has = 1;
            low = rr;
          }
        }
      }
      const unsigned nearest = __reduce_min_sync(kAll, has ? (unsigned)abs(lane - pos) << 4 | lane : 0xffffu);
      const int under = kBottom * kSide + pos;
      const bool term = s[kTerm] || emap[under] || (drop && s[kRow9]) || alien[under];
      const bool do_shoot = s[kAlienShotTimer] == 0;
      __syncwarp();
      if (do_shoot && nearest != 0xffffu && lane == (int)(nearest & 15u)) emap[low * kSide + lane] = 1;
      if (lane == 0) {
        const bool cleared = n_alien == n_kill;  // no alien left after the kills
        const int interval = s[kInterval], time = s[kTime] + 1;
        const bool done = term || time >= max_steps;
        rew_out[tb] = (float)n_kill;
        done_out[tb] = done;
        s[kPending] = kKills | (done ? kReset : cleared ? kRespawn : 0);
        if (done) {  // the deterministic reset (space_invaders.py:55-71)
          s[kPos] = 5;
          s[kDir] = -1;
          s[kInterval] = kResetInterval;
          s[kMoveTimer] = kResetInterval;
          s[kAlienShotTimer] = kShotInterval;
          s[kRampIndex] = 0;
          s[kShotTimer] = 0;
          s[kTime] = 0;
        } else {
          s[kDir] = drop ? -dir : dir;
          s[kMoveTimer] = drop || shift ? min(n_alien, interval) : s[kMoveTimer] - 1;
          s[kAlienShotTimer] = do_shoot ? kShotInterval : s[kAlienShotTimer] - 1;
          if (cleared) {
            s[kRampIndex] += 1;
            if (interval > 6) s[kInterval] = interval - 1;
          }
          s[kTime] = time;
        }
        s[kTerm] = 0;  // a terminal step is done
      }
    }
    __syncthreads();
  }

  if (p.live) {
    build_planes(m.planes, final_obs + (long)b * kObs, s, alien, fmap, emap);
    if (tid < kStateRows) st_out[tid * B + b] = tid < kUsedRows ? s[tid] : 0;
    if (is_cell) {
      alien_out[tid * B + b] = alien[tid];
      fmap_out[tid * B + b] = fmap[tid];
      emap_out[tid * B + b] = emap[tid];
    }
  }
  finish_launch();
}

// the kernel's instance for a cluster of C (1, 2, 4, 8 or 16)
decltype(&space_invaders_rollout_kernel<1>) kernel_for(int C) {
  return C == 16 ? space_invaders_rollout_kernel<16>
       : C == 8  ? space_invaders_rollout_kernel<8>
       : C == 4  ? space_invaders_rollout_kernel<4>
       : C == 2  ? space_invaders_rollout_kernel<2>
                 : space_invaders_rollout_kernel<1>;
}

}  // namespace

extern "C" {

// Launches ceil(B / cluster) clusters of `cluster` CTAs of 256 threads,
// `smem_bytes` of dynamic shared memory each (the plan of
// ops/space_invaders_rollout.py space_invaders_plan), on `stream`; returns
// a cudaError_t (0 on success). A plan the card refuses returns its error;
// nothing retries. The wrapper checks shapes: H a multiple of 32 in
// [32, 256], 1 <= A <= 8, the dense weight 16-byte aligned.
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
                               int use_prng, int max_steps, int cluster,
                               int smem_bytes, void* stream) {
  const bool cluster_ok = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16;
  if (!cluster_ok || H % 32 || H < 32 || H > kThreads || A < 1 || A > kMaxActions ||
      smem_bytes < 4 * smem_floats(kChannels, H, cluster, kGameInts))
    return (int)cudaErrorInvalidValue;
  const CnnWeights wts{conv_w, conv_b, ln1_scale, ln1_bias, dense_w,
                       dense_b, ln2_scale, ln2_bias, head_w, head_b};
  return launch_clusters(kernel_for(cluster), cluster, (B + cluster - 1) / cluster, kThreads, smem_bytes,
                         (cudaStream_t)stream, wts, st0, alien0, fmap0, emap0, obs_out, act_out, rew_out,
                         done_out, q_out, final_obs, st_out, alien_out, fmap_out, emap_out, T, B, H, A,
                         (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32), eps, use_prng, max_steps);
}

// How many clusters of `cluster` CTAs with `smem_bytes` each the card
// places at once (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
int space_invaders_rollout_active_clusters(int cluster, int smem_bytes) {
  return active_clusters(kernel_for(cluster), cluster, kThreads, smem_bytes);
}

const char* space_invaders_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
