// The MinAtar CNN forward of every fused MinAtar rollout kernel, for one env
// per block of kThreads threads: a 3x3 VALID conv from C channels to 16,
// LayerNorm over the channels of each pixel and relu, a dense layer from the
// 1024 conv outputs to H units, LayerNorm and relu, and the head to A
// Q-values.
//
// Counterpart of purejaxql_tpu/ops/pallas_rollout.py `_cnn_forward` and
// `_pack_cnn_params`, which every MinAtar TPU kernel shares. The weights come
// as ops/minatar_rollout.py `minatar_weights` lays them out: the conv as a
// (9 C, 16) tap matrix with rows in the (di, dj, c) order and 1/255 folded
// in, the dense weight (H, 1024) with columns in flax's (i, j, f) flatten
// order, the head unpadded (A, H).
//
// Shared memory (floats, in this order): the observation planes (100 C, in
// (row, col, channel) order), the conv output h1 (1024, in (i, j, f)
// order), the hidden units h2 (H), the conv taps (9 C x 16), a reduction
// scratch (33) and the Q-values (8). 100 C is a multiple of 4, so h1 stays
// 16-byte aligned for the dense layer's float4 loads.
//
// Bound: the dense layer is 2 x 1024 x H flops per env step, most of the
// forward; its 512 KiB weight (H = 128) does not fit in a block's shared
// memory and is read from global memory at every step, where it stays in L2
// across blocks and steps. One warp per output row, lanes striding the row
// with float4 loads, so each load instruction reads 512 contiguous bytes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace minatar {

constexpr int kThreads = 256;
constexpr int kSide = 10;                       // the board is 10 x 10
constexpr int kCells = kSide * kSide;
constexpr int kOut = kSide - 2;                 // VALID 3x3 conv: 8 x 8
constexpr int kFeatures = 16;                   // conv channels
constexpr int kFlat = kOut * kOut * kFeatures;  // 1024
constexpr int kMaxActions = 8;
constexpr float kLnEps = 1e-6f;

struct CnnWeights {
  const float* conv_w;
  const float* conv_b;
  const float* ln1_scale;
  const float* ln1_bias;
  const float* dense_w;
  const float* dense_b;
  const float* ln2_scale;
  const float* ln2_bias;
  const float* head_w;
  const float* head_b;
};

// The CNN's part of a block's shared memory.
struct CnnSmem {
  float* planes;
  float* h1;
  float* h2;
  float* wconv;
  float* red;
  float* q;
};

// Floats of dynamic shared memory the CNN needs for C channels and H units.
inline size_t cnn_smem_floats(int C, int H) {
  return (size_t)(kCells * C + kFlat + H + 9 * C * kFeatures + 33 + kMaxActions);
}

template <int C>
__device__ __forceinline__ CnnSmem cnn_smem(float* smem, int H) {
  CnnSmem m;
  m.planes = smem;
  m.h1 = m.planes + kCells * C;
  m.h2 = m.h1 + kFlat;
  m.wconv = m.h2 + H;
  m.red = m.wconv + 9 * C * kFeatures;
  m.q = m.red + 33;
  return m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread gets the total. `red` holds 33 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
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

// Copy the conv taps into shared memory (once per block; the first
// __syncthreads after it publishes them).
template <int C>
__device__ __forceinline__ void load_conv(const CnnSmem& m, const CnnWeights& w) {
  for (int k = threadIdx.x; k < 9 * C * kFeatures; k += blockDim.x) m.wconv[k] = w.conv_w[k];
}

// Q-values of the planes in m.planes into m.q[0 .. A). The caller has
// built the planes and synchronized the block; this ends with a barrier, so
// m.q is then visible to every thread.
template <int C>
__device__ void q_values(const CnnSmem& m, const CnnWeights& w, int H, int A) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  // conv 3x3 VALID, C -> 16 channels: output o = (i * 8 + j) * 16 + f, its
  // 9 C taps in the (di, dj, c) order
  for (int o = tid; o < kFlat; o += blockDim.x) {
    const int f = o % kFeatures, p = o / kFeatures;
    const int i = p / kOut, j = p - i * kOut;
    float acc = w.conv_b[f];
    for (int di = 0; di < 3; ++di) {
      for (int dj = 0; dj < 3; ++dj) {
        const float* x = m.planes + ((i + di) * kSide + (j + dj)) * C;
        const float* wc = m.wconv + (di * 3 + dj) * C * kFeatures + f;
#pragma unroll
        for (int c = 0; c < C; ++c) acc += x[c] * wc[c * kFeatures];
      }
    }
    m.h1[o] = acc;
  }
  __syncthreads();

  // LayerNorm over the channels of each pixel (two-pass), relu
  if (tid < kOut * kOut) {
    float* hp = m.h1 + tid * kFeatures;
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
      hp[f] = fmaxf((hp[f] - mu) * inv * w.ln1_scale[f] + w.ln1_bias[f], 0.0f);
    }
  }
  __syncthreads();

  // dense (1024 -> H): one warp per output row, float4 loads along it
  {
    const float4* x4 = reinterpret_cast<const float4*>(m.h1);
    for (int row = warp; row < H; row += nwarps) {
      const float4* w4 = reinterpret_cast<const float4*>(w.dense_w + (size_t)row * kFlat);
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kFlat / 128; ++k) {
        const float4 wv = __ldg(w4 + lane + 32 * k);
        const float4 xv = x4[lane + 32 * k];
        acc += wv.x * xv.x + wv.y * xv.y + wv.z * xv.z + wv.w * xv.w;
      }
      acc = warp_sum(acc);
      if (lane == 0) m.h2[row] = acc + w.dense_b[row];
    }
  }
  __syncthreads();

  // LayerNorm over the H units (two-pass), relu: thread j owns unit j
  {
    const float v = tid < H ? m.h2[tid] : 0.0f;
    const float mu = block_sum(v, m.red) / (float)H;
    const float d = tid < H ? v - mu : 0.0f;
    const float var = block_sum(d * d, m.red) / (float)H;
    if (tid < H) {
      m.h2[tid] = fmaxf(d * (1.0f / sqrtf(var + kLnEps)) * w.ln2_scale[tid] + w.ln2_bias[tid], 0.0f);
    }
  }
  __syncthreads();

  // head (H -> A): warp a computes q[a]
  if (warp < A) {
    const float* wr = w.head_w + (size_t)warp * H;
    float acc = 0.0f;
    for (int k = lane; k < H; k += 32) acc += wr[k] * m.h2[k];
    acc = warp_sum(acc);
    if (lane == 0) m.q[warp] = acc + w.head_b[warp];
  }
  __syncthreads();
}

// Write q[0 .. A) to q_out and return the greedy action: the first maximum
// wins ties, as jnp.argmax.
__device__ __forceinline__ int greedy_action(const float* q, float* __restrict__ q_out, int A) {
  int greedy = 0;
  float best = q[0];
  q_out[0] = q[0];
  for (int a = 1; a < A; ++a) {
    q_out[a] = q[a];
    if (q[a] > best) {
      best = q[a];
      greedy = a;
    }
  }
  return greedy;
}

}  // namespace minatar
