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
//   - runs the conv, one thread per output (i, j, f), its 36 taps in the
//     (di, dj, c) order with the 1/255 already folded into the weights;
//   - runs LayerNorm over the 16 channels of each pixel (one thread per
//     pixel, two-pass) and relu;
//   - runs the dense layer one warp per output row, lanes striding the row
//     with float4 loads, so each load instruction reads 512 contiguous
//     bytes. The weight (H x 1024 floats, 512 KiB at H = 128) does not fit
//     in the 227 KB of shared memory a block may have; it is read from
//     global memory, where it stays in L2 across blocks and steps. The
//     conv output sits in shared memory in flax's (i, j, f) flatten order,
//     so the weight's columns need no reorder;
//   - runs LayerNorm over the H units (two-pass block reduction) and relu,
//     then the head, one warp per action;
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

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 10;                        // the board is 10 x 10
constexpr int kCells = kSide * kSide;
constexpr int kChannels = 4;                     // paddle, ball, trail, brick
constexpr int kObs = kCells * kChannels;         // floats per observation
constexpr int kOut = kSide - 2;                  // VALID 3x3 conv: 8 x 8
constexpr int kFeatures = 16;                    // conv channels
constexpr int kFlat = kOut * kOut * kFeatures;   // 1024
constexpr int kTaps = 9 * kChannels;             // 36
constexpr int kMaxActions = 8;
constexpr int kWallBricks = 3 * kSide;           // rows 1-3
constexpr float kUnit24 = 1.0f / 16777216.0f;
constexpr float kLnEps = 1e-6f;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread gets the total. `red` holds 33 floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < nwarps ? red[lane] : 0.0f;
    s = warp_sum(s);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  return red[32];
}

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
    const float* __restrict__ conv_w, const float* __restrict__ conv_b,
    const float* __restrict__ ln1_scale, const float* __restrict__ ln1_bias,
    const float* __restrict__ dense_w, const float* __restrict__ dense_b,
    const float* __restrict__ ln2_scale, const float* __restrict__ ln2_bias,
    const float* __restrict__ head_w, const float* __restrict__ head_b,
    const int* __restrict__ st0, const int* __restrict__ brick0,
    float* __restrict__ obs_out, int* __restrict__ act_out,
    float* __restrict__ rew_out, int* __restrict__ done_out,
    float* __restrict__ q_out, float* __restrict__ final_obs,
    int* __restrict__ st_out, int* __restrict__ brick_out, int T, int B, int H,
    int A, uint32_t key0, uint32_t key1, float eps, int use_prng,
    int max_steps) {
  extern __shared__ __align__(16) float smem[];
  float* planes = smem;                    // kObs
  float* h1 = planes + kObs;               // kFlat, in (i, j, f) order
  float* h2 = h1 + kFlat;                  // H
  float* wconv = h2 + H;                   // kTaps x kFeatures
  float* red = wconv + kTaps * kFeatures;  // 33
  float* q = red + 33;                     // kMaxActions
  __shared__ int s[kStateRows];
  __shared__ int bricks[kCells];
  __shared__ int n_bricks, hit_cell, refill;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  for (int k = tid; k < kTaps * kFeatures; k += blockDim.x) wconv[k] = conv_w[k];
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
    build_planes(planes, obs_out + tb * kObs, s, bricks);
    __syncthreads();

    // conv 3x3 VALID, 4 -> 16 channels: output o = (i * 8 + j) * 16 + f
    for (int o = tid; o < kFlat; o += blockDim.x) {
      const int f = o % kFeatures, p = o / kFeatures;
      const int i = p / kOut, j = p - i * kOut;
      float acc = conv_b[f];
      for (int di = 0; di < 3; ++di) {
        for (int dj = 0; dj < 3; ++dj) {
          const float* x = planes + ((i + di) * kSide + (j + dj)) * kChannels;
          const float* w = wconv + (di * 3 + dj) * kChannels * kFeatures + f;
#pragma unroll
          for (int c = 0; c < kChannels; ++c) acc += x[c] * w[c * kFeatures];
        }
      }
      h1[o] = acc;
    }
    __syncthreads();

    // LayerNorm over the channels of each pixel (two-pass), relu
    if (tid < kOut * kOut) {
      float* hp = h1 + tid * kFeatures;
      float sum = 0.0f;
      for (int f = 0; f < kFeatures; ++f) sum += hp[f];
      const float mu = sum / (float)kFeatures;
      float ss = 0.0f;
      for (int f = 0; f < kFeatures; ++f) {
        const float d = hp[f] - mu;
        ss += d * d;
      }
      const float inv = 1.0f / sqrtf(ss / (float)kFeatures + kLnEps);
      for (int f = 0; f < kFeatures; ++f) {
        hp[f] = fmaxf((hp[f] - mu) * inv * ln1_scale[f] + ln1_bias[f], 0.0f);
      }
    }
    __syncthreads();

    // dense (1024 -> H): one warp per output row, float4 loads along it
    {
      const float4* x4 = reinterpret_cast<const float4*>(h1);
      for (int row = warp; row < H; row += nwarps) {
        const float4* w4 = reinterpret_cast<const float4*>(dense_w + (size_t)row * kFlat);
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < kFlat / 128; ++m) {
          const float4 w = __ldg(w4 + lane + 32 * m);
          const float4 x = x4[lane + 32 * m];
          acc += w.x * x.x + w.y * x.y + w.z * x.z + w.w * x.w;
        }
        acc = warp_sum(acc);
        if (lane == 0) h2[row] = acc + dense_b[row];
      }
    }
    __syncthreads();

    // LayerNorm over the H units (two-pass), relu: thread j owns unit j
    {
      const float v = tid < H ? h2[tid] : 0.0f;
      const float mu = block_sum(v, red) / (float)H;
      const float d = tid < H ? v - mu : 0.0f;
      const float var = block_sum(d * d, red) / (float)H;
      if (tid < H) {
        h2[tid] = fmaxf(d * (1.0f / sqrtf(var + kLnEps)) * ln2_scale[tid] + ln2_bias[tid], 0.0f);
      }
    }
    __syncthreads();

    // head (H -> A): warp a computes q[a]
    if (warp < A) {
      const float* wr = head_w + (size_t)warp * H;
      float acc = 0.0f;
      for (int k = lane; k < H; k += 32) acc += wr[k] * h2[k];
      acc = warp_sum(acc);
      if (lane == 0) q[warp] = acc + head_b[warp];
    }
    __syncthreads();

    if (tid == 0) {
      int greedy = 0;
      float best = q[0];
      q_out[tb * A] = q[0];
      for (int a = 1; a < A; ++a) {
        q_out[tb * A + a] = q[a];
        if (q[a] > best) {
          best = q[a];
          greedy = a;
        }
      }
      float u = 1.0f;
      int rand_act = 0, side = 0;
      if (use_prng) {
        const U4 r = philox4x32_10(U4{(uint32_t)t, (uint32_t)b, 0u, 0u}, key0, key1);
        u = (float)(r.x >> 8) * kUnit24;
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

  build_planes(planes, final_obs + (long)b * kObs, s, bricks);
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
  const size_t smem =
      (size_t)(kObs + kFlat + H + kTaps * kFeatures + 33 + kMaxActions) * sizeof(float);
  breakout_rollout_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      conv_w, conv_b, ln1_scale, ln1_bias, dense_w, dense_b, ln2_scale,
      ln2_bias, head_w, head_b, st0, brick0, obs_out, act_out, rew_out,
      done_out, q_out, final_obs, st_out, brick_out, T, B, H, A,
      (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32), eps, use_prng,
      max_steps);
  return (int)cudaGetLastError();
}

const char* breakout_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
