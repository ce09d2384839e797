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
// What bounded the old design: one block of 256 threads per env ran the whole
// CNN, whose dense layer read the whole 512 KiB dense weight
// (H 128) from L2 at every step of every env, 64 MiB a step at the
// trainer's B 128: 0.43-0.49 ms a launch (T 32), 20-23x the operation bound
// (the conv's taps and the dense layer's 2 x 1024 x H flops an env step),
// with the rules on one thread.
//
// Design: the CNN of minatar_cluster.cuh, as the Freeway kernel runs it. A
// thread-block cluster of C CTAs takes C envs, one env a CTA; each CTA holds
// 1 / C of the dense weight in shared memory for the whole launch, and the
// CTAs trade the conv outputs' slices and the dense layer's partial sums
// through distributed shared memory. The plan (ops/asterix_rollout.py
// `asterix_plan`) takes C 16 (ops/minatar_rollout.py PLAN_CLUSTER gives the
// times behind the choice). Each step a CTA with an env builds the 4
// planes (player, enemy, trail, gold) in shared memory and writes them out
// (a thread a cell), threads 0-2 draw the step's 12 Philox words, the
// cluster runs the CNN, and warp 0 runs the argmax (first index wins ties),
// the epsilon coin and the Asterix rules in the order of asterix.py:79-196
// (spawn, player move, collide, entity move, collide, ramp) with lane k
// taking slot k, then the deterministic reset. The game is integer logic,
// so kernel and plain twin agree exactly on everything but the Q-values'
// last bits.
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

#include "minatar_cluster.cuh"
#include "philox.cuh"

namespace {

using namespace minatar;
using namespace minatar_cluster;

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
// the ints the kernel keeps in the env's CTA (Smem::game): the used state
// rows, then the step's Philox words (ops/asterix_rollout.py GAME_INTS)
constexpr int kWords = round4(kUsedRows);
constexpr int kGameInts = 56;
static_assert(kGameInts == kWords + 4 * kCalls, "the state rows and the Philox words");

// The observation of a state as (row, col, channel) planes, into shared
// memory and out to `out` (asterix.py get_obs): a thread a cell, its 4
// channels in one 16-byte store each.
__device__ void build_planes(float* planes, float* __restrict__ out, const int* s) {
  const int cell = threadIdx.x;
  if (cell >= kCells) return;
  const int r = cell / kSide, c = cell - r * kSide;
  const bool player = r == s[kPY] && c == s[kPX];
  bool enemy = false, trail = false, gold = false;
  if (r >= 1 && r <= kSlots && s[kExists + r - 1]) {
    const int slot = r - 1, x = s[kX + slot];
    const bool g = s[kGold + slot] != 0;
    enemy = !g && c == x;
    gold = g && c == x;
    trail = c == min(max(x + (s[kLR + slot] ? -1 : 1), 0), kSide - 1);  // the cell it came from
  }
  const float4 v = make_float4(player ? 1.0f : 0.0f, enemy ? 1.0f : 0.0f, trail ? 1.0f : 0.0f, gold ? 1.0f : 0.0f);
  reinterpret_cast<float4*>(planes)[cell] = v;
  reinterpret_cast<float4*>(out)[cell] = v;
}

// The player touches the entity on its cell (lane k holds slot k, on row
// k + 1): gold scores, an enemy ends the episode; either way it is gone
// (asterix.py:123-133).
__device__ __forceinline__ void collide(bool slot, int k, int& exists, int x, int gold, int px, int py,
                                        int& reward, int& terminal) {
  const bool hit = slot && exists && x == px && k + 1 == py;
  reward += __popc(__ballot_sync(0xffffffffu, hit && gold));
  terminal |= __any_sync(0xffffffffu, hit && !gold) ? 1 : 0;
  if (hit) exists = 0;
}

template <int KC>
__global__ void __launch_bounds__(kThreads) asterix_rollout_kernel(
    CnnWeights wts, const int* __restrict__ st0, float* __restrict__ obs_out,
    int* __restrict__ act_out, float* __restrict__ rew_out,
    int* __restrict__ done_out, float* __restrict__ q_out,
    float* __restrict__ final_obs, int* __restrict__ st_out, int T, int B,
    int H, int A, uint32_t key0, uint32_t key1, float eps, int use_prng,
    int max_steps) {
  extern __shared__ float4 smem4[];
  const Place p = place_of(B, H, A, T);
  const Smem m = smem_layout<kChannels>(reinterpret_cast<float*>(smem4), H, p.C);
  int* s = m.game;
  uint32_t* words = reinterpret_cast<uint32_t*>(m.game + kWords);

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
      // warp 0: the argmax, the epsilon coin and the rules, lane k < 8
      // taking slot k
      const int k = tid;
      const bool slot = k < kSlots;
      const int greedy = greedy_of(m, A);
      if (k < A) q_out[tb * A + k] = m.q[k];
      float u = 1.0f, score = (float)k;
      int rand_act = 0, lr = 0, gold = 0;
      if (use_prng) {
        u = unit24(words[0]);
        rand_act = (int)((words[1] >> 8) % (uint32_t)A);
        if (slot) score = unit24(words[2 + k]);
        lr = (int)((words[10] >> 8) & 1u);
        gold = unit24(words[11]) < (1.0f / 3.0f) ? 1 : 0;
      }
      const int action = u < eps ? rand_act : greedy;
      int exists = slot ? s[kExists + k] : 0, x = slot ? s[kX + k] : 0;
      int e_lr = slot ? s[kLR + k] : 0, e_gold = slot ? s[kGold + k] : 0;
      const int spawn_speed = s[kSpawnSpeed], spawn_timer0 = s[kSpawnTimer], move_speed = s[kMoveSpeed];
      const int move_timer0 = s[kMoveTimer], ramp_timer0 = s[kRampTimer], ramp_index0 = s[kRampIndex];
      int terminal = s[kTerm];
      const int time = s[kTime] + 1;

      // spawn into the free slot with the highest score, the first on ties
      const bool free = slot && !exists;
      float best = free ? score : -1.0f;
#pragma unroll
      for (int o = 1; o < kSlots; o <<= 1) best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, o));
      const unsigned picks = __ballot_sync(0xffffffffu, free && score == best);
      const bool do_spawn = spawn_timer0 == 0;
      if (do_spawn && picks && k == __ffs(picks) - 1) {
        exists = 1;
        x = lr ? 0 : kSide - 1;
        e_lr = lr;
        e_gold = gold;
      }
      const int spawn_timer = do_spawn ? spawn_speed : spawn_timer0 - 1;

      // player move (actions: noop, left, up, right, down)
      const int px = min(max(s[kPX] + (action == 3) - (action == 1), 0), kSide - 1);
      const int py = min(max(s[kPY] + (action == 4) - (action == 2), 1), kSlots);
      int reward = 0;
      collide(slot, k, exists, x, e_gold, px, py, reward, terminal);

      // entity move: one column on the move timer; off the board, gone
      const bool do_move = move_timer0 == 0;
      if (slot && do_move && exists) {
        const int nx = x + (e_lr ? 1 : -1);
        if (nx < 0 || nx > kSide - 1) exists = 0;
        x = min(max(nx, 0), kSide - 1);
      }
      const int move_timer = do_move ? move_speed : move_timer0 - 1;
      collide(slot, k, exists, x, e_gold, px, py, reward, terminal);

      // ramping, from the cadences the step started with
      const bool can_ramp = spawn_speed > 1 || move_speed > 1;
      const bool do_ramp = can_ramp && ramp_timer0 <= 0;
      const bool ramp_move = do_ramp && ramp_index0 % 2 == 1 && move_speed > 1;
      const bool ramp_spawn = do_ramp && ramp_index0 % 2 == 0 && spawn_speed > 1;
      const bool done = terminal != 0 || time >= max_steps;
      __syncwarp();
      if (slot) {  // the deterministic reset (asterix.py:60-77) clears every slot
        s[kExists + k] = done ? 0 : exists;
        s[kX + k] = done ? 0 : x;
        s[kLR + k] = done ? 0 : e_lr;
        s[kGold + k] = done ? 0 : e_gold;
      }
      if (k == 0) {
        act_out[tb] = action;
        rew_out[tb] = (float)reward;
        done_out[tb] = done ? 1 : 0;
        s[kPX] = done ? 5 : px;
        s[kPY] = done ? 5 : py;
        s[kSpawnSpeed] = done ? kInitSpawn : spawn_speed - (ramp_spawn ? 1 : 0);
        s[kSpawnTimer] = done ? kInitSpawn : spawn_timer;
        s[kMoveSpeed] = done ? kInitMove : move_speed - (ramp_move ? 1 : 0);
        s[kMoveTimer] = done ? kInitMove : move_timer;
        s[kRampTimer] = done || do_ramp ? kRampInterval : ramp_timer0 - (can_ramp ? 1 : 0);
        s[kRampIndex] = done ? 0 : ramp_index0 + (do_ramp ? 1 : 0);
        s[kTerm] = 0;  // a terminal step is done
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
decltype(&asterix_rollout_kernel<1>) kernel_for(int C) {
  return C == 16 ? asterix_rollout_kernel<16>
       : C == 8  ? asterix_rollout_kernel<8>
       : C == 4  ? asterix_rollout_kernel<4>
       : C == 2  ? asterix_rollout_kernel<2>
                 : asterix_rollout_kernel<1>;
}

}  // namespace

extern "C" {

// Launches ceil(B / cluster) clusters of `cluster` CTAs of 256 threads,
// `smem_bytes` of dynamic shared memory each (the plan of
// ops/asterix_rollout.py asterix_plan), on `stream`; returns a cudaError_t
// (0 on success). A plan the card refuses returns its error; nothing
// retries. The wrapper checks shapes: H a multiple of 32 in [32, 256],
// 1 <= A <= 8, the dense weight 16-byte aligned.
int asterix_rollout_f32(const float* conv_w, const float* conv_b,
                        const float* ln1_scale, const float* ln1_bias,
                        const float* dense_w, const float* dense_b,
                        const float* ln2_scale, const float* ln2_bias,
                        const float* head_w, const float* head_b,
                        const int* st0, float* obs_out, int* act_out,
                        float* rew_out, int* done_out, float* q_out,
                        float* final_obs, int* st_out, int T, int B, int H,
                        int A, unsigned long long seed, float eps,
                        int use_prng, int max_steps, int cluster,
                        int smem_bytes, void* stream) {
  const bool cluster_ok = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16;
  if (!cluster_ok || H % 32 || H < 32 || H > kThreads || A < 1 || A > kMaxActions ||
      smem_bytes < 4 * smem_floats(kChannels, H, cluster, kGameInts))
    return (int)cudaErrorInvalidValue;
  const CnnWeights wts{conv_w, conv_b, ln1_scale, ln1_bias, dense_w,
                       dense_b, ln2_scale, ln2_bias, head_w, head_b};
  return launch_clusters(kernel_for(cluster), cluster, (B + cluster - 1) / cluster, kThreads, smem_bytes,
                         (cudaStream_t)stream, wts, st0, obs_out, act_out, rew_out, done_out, q_out,
                         final_obs, st_out, T, B, H, A, (uint32_t)(seed & 0xffffffffull),
                         (uint32_t)(seed >> 32), eps, use_prng, max_steps);
}

// How many clusters of `cluster` CTAs with `smem_bytes` each the card
// places at once (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
int asterix_rollout_active_clusters(int cluster, int smem_bytes) {
  return active_clusters(kernel_for(cluster), cluster, kThreads, smem_bytes);
}

const char* asterix_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
