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
// What bounded the old design: one block of 256 threads per env ran the whole
// CNN, whose dense layer read the whole 512 KiB dense weight
// (H 128) from L2 at every step of every env, 64 MiB a step at the
// trainer's B 128: about 0.55 ms a launch (T 32), 20x the operation bound
// (the conv's taps at 10 channels and the dense layer's 2 x 1024 x H flops
// an env step), with the rules over the five pools on one thread.
//
// Design: the CNN of minatar_cluster.cuh, as the Freeway kernel runs it. A
// thread-block cluster of C CTAs takes C envs, one env a CTA; each CTA holds
// 1 / C of the dense weight in shared memory for the whole launch, and the
// CTAs trade the conv outputs' slices and the dense layer's partial sums
// through distributed shared memory. The plan (ops/seaquest_rollout.py
// `seaquest_plan`) takes C 16, which keeps a CTA under the 113 KB at which
// two CTAs share an SM (ops/minatar_rollout.py PLAN_CLUSTER gives the times
// behind the choice). Each step a CTA with an env builds the 10
// planes in shared memory and writes them out, a thread a cell (each pool's
// entities counted on the cell, then clamped to 1, as `_pool_mask` adds
// before the clamp: a cell is on where any slot's cell code is it),
// threads 0-7 draw the step's 29 Philox words, the cluster runs the CNN, and
// warp 0 runs the argmax (first index wins ties), the epsilon coin and the
// Seaquest rules in the order of seaquest.py:153-353, then the
// deterministic reset. The warp
// holds a pool slot a lane (below); the per-slot moves run on every lane at
// once, and the phases where pools meet keep their order: the fire, the
// bullets' and the lane entities' moves, the enemy shot, the hits, the
// `_first_free` spawns, the pick-ups and collisions, oxygen and the
// cash-in. The game is integer logic but for the cash-in, so kernel and
// plain twin agree exactly on everything but the Q-values' last bits.
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

#include "minatar_cluster.cuh"
#include "philox.cuh"

namespace {

using namespace minatar;
using namespace minatar_cluster;

constexpr unsigned kAll = 0xffffffffu;
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
enum { kE, kX, kY, kDir, kTimer, kShot };  // a pool's fields: field f of slot k is row base + f * n + k

// The rules' warp holds a pool slot a lane: lanes 0-7 the fish, 8-11 the
// enemy subs, 12-15 the friendly bullets, 16-19 the enemy bullets, 20-23 the
// divers; 24-31 hold none. Each pool's lanes are aligned to its size, so a
// reduction over a pool stays in its lanes.
enum { kLFish = 0, kLSubs = 8, kLFb = 12, kLEb = 16, kLDiver = 20, kSlotLanes = 24 };
// The planes read each slot's cell (row * 10 + col, -1 where the slot is
// empty), a lane's each, then the friendly bullets' trail cells.
constexpr int kCodes = kSlotLanes + kNPool;
// the ints the kernel keeps in the env's CTA (Smem::game): the state rows,
// the step's Philox words and the cells (ops/seaquest_rollout.py GAME_INTS)
constexpr int kWordsAt = kStateRows, kCodesAt = kWordsAt + 4 * kCalls;
constexpr int kGameInts = 188;
static_assert(kGameInts == kCodesAt + kCodes, "the state rows, the Philox words and the cells");

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// floor(a / b) for b > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// the plane of cell code l: fish, subs, friendly bullets, enemy bullets,
// divers, then the friendly bullets' trails
__host__ __device__ constexpr int channel_of(int l) {
  return l < kLSubs ? 6 : l < kLFb ? 4 : l < kLEb ? 2 : l < kLDiver ? 5 : l < kSlotLanes ? 7 : 3;
}

// The observation of a state as (row, col, channel) planes, into shared
// memory and out to `out` (seaquest.py get_obs): a thread a cell.
__device__ void build_planes(float* planes, float* __restrict__ out, const int* s) {
  const int cell = threadIdx.x;
  if (cell >= kCells) return;
  const int r = cell / kSide, c = cell - r * kSide;
  bool on[kChannels];
  on[0] = r == s[kSY] && c == s[kSX];  // the sub's front cell
  // its back cell, behind it, clamped to the board
  on[1] = r == s[kSY] && c == clampi(s[kSX] + (s[kSOr] == 1 ? -1 : 1), 0, kSide - 1);
#pragma unroll
  for (int ch = 2; ch < 8; ++ch) on[ch] = false;
  const int4* code = reinterpret_cast<const int4*>(s + kCodesAt);
#pragma unroll
  for (int q = 0; q < kCodes / 4; ++q) {
    const int4 v = code[q];
    on[channel_of(4 * q)] |= v.x == cell;
    on[channel_of(4 * q + 1)] |= v.y == cell;
    on[channel_of(4 * q + 2)] |= v.z == cell;
    on[channel_of(4 * q + 3)] |= v.w == cell;
  }
  // the oxygen gauge and the divers on board, row 9
  on[8] = r == kSide - 1 && c < clampi(floor_div(s[kOxygen] * 10, kMaxOxygen), 0, 9);
  on[9] = r == kSide - 1 && c < s[kDivers];
  float2* p2 = reinterpret_cast<float2*>(planes + cell * kChannels);
  float2* o2 = reinterpret_cast<float2*>(out + cell * kChannels);
#pragma unroll
  for (int i = 0; i < kChannels / 2; ++i) {
    const float2 v = make_float2(on[2 * i] ? 1.0f : 0.0f, on[2 * i + 1] ? 1.0f : 0.0f);
    p2[i] = v;
    o2[i] = v;
  }
}

// A lane's pool slot: the pool's first state row (-1 for none), its slot
// count, the slot, and the Philox word of the slot's score.
struct Slot {
  int base, n, k, word;
};

__device__ __forceinline__ Slot slot_of(int lane) {
  if (lane < kLSubs) return {kFish, kNFish, lane - kLFish, 10 + lane - kLFish};
  if (lane < kLFb) return {kSubs, kNPool, lane - kLSubs, 18 + lane - kLSubs};
  if (lane < kLEb) return {kFBullet, kNPool, lane - kLFb, 2 + lane - kLFb};
  if (lane < kLDiver) return {kEBullet, kNPool, lane - kLEb, 6 + lane - kLEb};
  if (lane < kSlotLanes) return {kDiver, kNPool, lane - kLDiver, 22 + lane - kLDiver};
  return {-1, kNFish, 0, 0};
}

// A slot's fields (timer: fish, subs and divers; shot: subs).
struct Entity {
  int e, x, y, dir, timer, shot;
};

__device__ __forceinline__ bool timed(int lane) { return lane < kLFb || (lane >= kLDiver && lane < kSlotLanes); }
__device__ __forceinline__ bool is_sub_lane(int lane) { return lane >= kLSubs && lane < kLFb; }

__device__ __forceinline__ Entity load_entity(const int* s, const Slot& sl, int lane) {
  Entity en{0, 0, 0, 0, 0, 0};
  if (sl.base < 0) return en;
  const int* f = s + sl.base + sl.k;
  en.e = f[kE * sl.n];
  en.x = f[kX * sl.n];
  en.y = f[kY * sl.n];
  en.dir = f[kDir * sl.n];
  if (timed(lane)) en.timer = f[kTimer * sl.n];
  if (is_sub_lane(lane)) en.shot = f[kShot * sl.n];
  return en;
}

// The slot's fields into the state, and its cells into the planes' codes.
__device__ __forceinline__ void store_entity(int* s, const Slot& sl, int lane, const Entity& en) {
  if (sl.base < 0) return;
  int* f = s + sl.base + sl.k;
  f[kE * sl.n] = en.e;
  f[kX * sl.n] = en.x;
  f[kY * sl.n] = en.y;
  f[kDir * sl.n] = en.dir;
  if (timed(lane)) f[kTimer * sl.n] = en.timer;
  if (is_sub_lane(lane)) f[kShot * sl.n] = en.shot;
  int* code = s + kCodesAt;
  code[lane] = en.e ? en.y * kSide + en.x : -1;
  if (lane >= kLFb && lane < kLEb) code[kSlotLanes + sl.k] = en.e ? en.y * kSide + clampi(en.x - en.dir, 0, kSide - 1) : -1;
}

// `_first_free` in every pool at once: bit l of the result is set where
// lane l holds a free slot whose score is the highest of (free ? score : -1)
// over its pool (none where that maximum is an occupied slot's); the spawn
// takes the first of them (`takes`). `free_bits` gets the free slots.
__device__ __forceinline__ unsigned free_picks(bool free, float score, int n, unsigned& free_bits) {
  float best = free ? score : -1.0f;
#pragma unroll
  for (int o = 1; o < kNFish; o <<= 1) {
    const float other = __shfl_xor_sync(kAll, best, o);
    if (o < n) best = fmaxf(best, other);
  }
  free_bits = __ballot_sync(kAll, free);
  return __ballot_sync(kAll, free && score == best);
}

// whether lane's slot is the first of its pool's picks (`pool` the pool's lanes)
__device__ __forceinline__ bool takes(unsigned picks, unsigned pool, int lane) {
  const unsigned mine = picks & pool;
  return mine != 0 && __ffs(mine) - 1 == lane;
}

template <int KC>
__global__ void __launch_bounds__(kThreads) seaquest_rollout_kernel(
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
  uint32_t* words = reinterpret_cast<uint32_t*>(m.game + kWordsAt);

  const int b = p.b, tid = threadIdx.x;
  if (p.live && tid < kStateRows) s[tid] = st0[tid * B + b];
  load_and_arm<kChannels>(m, wts, p);
  unsigned parity = 0;  // bit i: the phase of mbarrier i to wait for
  if (p.live && tid < 32) store_entity(s, slot_of(tid), tid, load_entity(s, slot_of(tid), tid));  // the cells
  __syncthreads();

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
      // warp 0: the argmax, the epsilon coin and the rules, a slot a lane
      const int lane = tid;
      const Slot sl = slot_of(lane);
      const bool has = sl.base >= 0;
      const bool fish = lane < kLSubs, sub = is_sub_lane(lane), fb = lane >= kLFb && lane < kLEb;
      const bool eb = lane >= kLEb && lane < kLDiver, diver = lane >= kLDiver && lane < kSlotLanes;
      const unsigned pool = fish ? 0xffu << kLFish : (sub || fb || eb || diver) ? 0xfu << (lane & ~3) : 0u;
      const int greedy = greedy_of(m, A);
      if (lane < A) q_out[tb * A + lane] = m.q[lane];
      float u = 1.0f, score = -(float)sl.k;
      int rand_act = 0, row = 4, lr = 0, is_sub = 0;
      if (use_prng) {
        u = unit24(words[0]);
        rand_act = (int)((words[1] >> 8) % (uint32_t)A);
        if (has) score = unit24(words[sl.word]);
        row = (int)((words[26] >> 8) % 8u) + 1;
        lr = (int)((words[27] >> 8) & 1u);
        is_sub = unit24(words[28]) < (1.0f / 3.0f) ? 1 : 0;
      }
      const int action = u < eps ? rand_act : greedy;
      Entity en = load_entity(s, sl, lane);
      const int shot_timer0 = s[kShotTimer], mvi = s[kMoveInt], divers0 = s[kDivers];
      const int oxygen0 = s[kOxygen], surfaced = s[kSurfaced], term = s[kTerm];
      const int spawn_timer1 = s[kSpawnTimer] - 1, diver_timer1 = s[kDiverTimer] - 1, time = s[kTime] + 1;

      // player (actions: noop, left, up, right, down, fire)
      const int sub_x = clampi(s[kSX] + (action == 3) - (action == 1), 0, 9);
      const int sub_y = clampi(s[kSY] + (action == 4) - (action == 2), 0, 8);
      const int sub_or = action == 1 ? 0 : action == 3 ? 1 : s[kSOr];

      // fire: one friendly bullet from the sub's nose
      unsigned free_bits;
      unsigned picks = free_picks(has && !en.e, score, sl.n, free_bits);
      const bool do_fire = action == 5 && shot_timer0 == 0 && (free_bits & (0xfu << kLFb));
      if (do_fire && fb && takes(picks, pool, lane)) en = {1, sub_x, sub_y, sub_or == 1 ? 1 : -1, 0, 0};
      const int shot_timer = do_fire ? kShotCoolDown : max(shot_timer0 - 1, 0);

      // bullets move every step; off the board, gone
      if ((fb || eb) && en.e) {
        const int nx = en.x + en.dir;
        if (nx < 0 || nx > kSide - 1) en.e = 0;
        en.x = clampi(nx, 0, kSide - 1);
      }

      // lane entities step on their cadence and leave off the board
      // (seaquest.py:88-96), the divers at half the pace; every slot's timer
      // runs, live or not
      if (timed(lane)) {
        const bool do_move = en.timer <= 0;
        const int nx = en.x + ((do_move && en.e) ? en.dir : 0);
        if (do_move && (nx < 0 || nx > kSide - 1)) en.e = 0;
        en.x = clampi(nx, 0, kSide - 1);
        en.timer = do_move ? (diver ? 2 * mvi : mvi) : en.timer - 1;
      }

      // the first sub whose shot timer ran out fires into a free bullet slot;
      // only the timers of subs that exist run down
      if (sub) en.shot -= en.e ? 1 : 0;
      const unsigned wants = __ballot_sync(kAll, sub && en.e && en.shot <= 0);
      const int shooter = wants ? __ffs(wants) - 1 : 0;
      const int sh_x = __shfl_sync(kAll, en.x, shooter), sh_y = __shfl_sync(kAll, en.y, shooter);
      const int sh_dir = __shfl_sync(kAll, en.dir, shooter);
      picks = free_picks(has && !en.e, score, sl.n, free_bits);
      const bool enemy_shot = wants != 0 && (free_bits & (0xfu << kLEb)) != 0;
      if (enemy_shot && eb && takes(picks, pool, lane)) en = {1, sh_x, sh_y, sh_dir, 0, 0};
      if (enemy_shot && lane == shooter) en.shot = kEnemyShotInterval;

      // friendly bullets hit fish and subs (every bullet on a cell hits every
      // enemy on it): bit i of `hit`, bullet i on this enemy's cell
      const int cell = en.e ? en.y * kSide + en.x : -1;
      unsigned hit = 0;
#pragma unroll
      for (int i = 0; i < kNPool; ++i) {
        const int bullet = __shfl_sync(kAll, cell, kLFb + i);
        if ((fish || sub) && en.e && bullet == cell) hit |= 1u << i;
      }
      const unsigned bullets_hit = __reduce_or_sync(kAll, hit);
      const int kills = __popc(__ballot_sync(kAll, hit != 0));
      if (hit || (fb && ((bullets_hit >> sl.k) & 1u))) en.e = 0;

      // spawns: an enemy on the spawn cadence, a diver on its own
      const bool do_spawn = spawn_timer1 <= 0, do_dspawn = diver_timer1 <= 0;
      picks = free_picks(has && !en.e, score, sl.n, free_bits);
      const bool spawns = (fish && do_spawn && !is_sub) || (sub && do_spawn && is_sub) || (diver && do_dspawn);
      if (spawns && takes(picks, pool, lane)) {
        en.e = 1;
        en.x = lr ? 0 : kSide - 1;
        en.y = row;
        en.dir = lr ? 1 : -1;
      }

      // the sub picks up divers and meets enemies and their bullets
      const bool pick = diver && en.e && en.x == sub_x && en.y == sub_y;
      int divers = min(divers0 + __popc(__ballot_sync(kAll, pick)), 6);
      if (pick) en.e = 0;
      const bool hit_enemy = __any_sync(kAll, (fish || sub || eb) && en.e && en.x == sub_x && en.y == sub_y);

      // oxygen and surfacing: with no diver fatal, with six a cash-in
      const bool underwater = sub_y > 0;
      int oxygen = underwater ? oxygen0 - 1 : oxygen0;
      const bool now_surfacing = !underwater && !surfaced;
      const bool fatal = now_surfacing && divers == 0;
      const bool cash_in = now_surfacing && divers == 6;
      float reward = (float)kills;
      if (cash_in) reward = reward + __fmul_rn((float)oxygen, 0.1f);
      if (now_surfacing && !fatal) {
        divers = cash_in ? 0 : divers - 1;
        oxygen = kMaxOxygen;
      }
      const bool terminal = term || hit_enemy || fatal || oxygen < 0;
      const bool done = terminal || time >= max_steps;

      __syncwarp();
      // the deterministic reset (seaquest.py:114-150)
      if (done) en = {0, 0, 0, 1, 0, kEnemyShotInterval};
      store_entity(s, sl, lane, en);
      if (lane == 0) {
        act_out[tb] = action;
        rew_out[tb] = reward;
        done_out[tb] = done ? 1 : 0;
        s[kSX] = done ? 5 : sub_x;
        s[kSY] = done ? 0 : sub_y;
        s[kSOr] = done ? 1 : sub_or;
        s[kOxygen] = done ? kMaxOxygen : oxygen;
        s[kDivers] = done ? 0 : divers;
        s[kShotTimer] = done ? 0 : shot_timer;
        s[kSpawnTimer] = done ? kSpawnSpeed : do_spawn ? kSpawnSpeed : spawn_timer1;
        s[kDiverTimer] = done ? kDiverSpawnSpeed : do_dspawn ? kDiverSpawnSpeed : diver_timer1;
        s[kMoveInt] = done ? kMoveInterval : mvi;
        s[kSurfaced] = done || !underwater ? 1 : 0;
        s[kTerm] = 0;  // a terminal step is done
        s[kTime] = done ? 0 : time;
      }
    }
    __syncthreads();
  }

  if (p.live) {
    build_planes(m.planes, final_obs + (long)b * kObs, s);
    if (tid < kStateRows) st_out[tid * B + b] = s[tid];
  }
  finish_launch();
}

// the kernel's instance for a cluster of C (1, 2, 4, 8 or 16)
decltype(&seaquest_rollout_kernel<1>) kernel_for(int C) {
  return C == 16 ? seaquest_rollout_kernel<16>
       : C == 8  ? seaquest_rollout_kernel<8>
       : C == 4  ? seaquest_rollout_kernel<4>
       : C == 2  ? seaquest_rollout_kernel<2>
                 : seaquest_rollout_kernel<1>;
}

}  // namespace

extern "C" {

// Launches ceil(B / cluster) clusters of `cluster` CTAs of 256 threads,
// `smem_bytes` of dynamic shared memory each (the plan of
// ops/seaquest_rollout.py seaquest_plan), on `stream`; returns a cudaError_t
// (0 on success). A plan the card refuses returns its error; nothing
// retries. The wrapper checks shapes: H a multiple of 32 in [32, 256],
// 1 <= A <= 8, the dense weight 16-byte aligned.
int seaquest_rollout_f32(const float* conv_w, const float* conv_b,
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
int seaquest_rollout_active_clusters(int cluster, int smem_bytes) {
  return active_clusters(kernel_for(cluster), cluster, kThreads, smem_bytes);
}

const char* seaquest_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
