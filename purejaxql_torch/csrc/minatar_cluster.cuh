// The MinAtar CNN forward of every fused MinAtar rollout, run by a
// thread-block cluster that keeps the dense weight on chip for the whole
// launch: a 3x3 VALID conv from kCh channels to 16, LayerNorm over the
// channels of each pixel and relu, a dense layer from the 1024 conv outputs
// to H units, LayerNorm and relu, the head to A Q-values.
//
// Counterpart of purejaxql_tpu/ops/pallas_rollout.py `_cnn_forward` and
// `_pack_cnn_params`, which every MinAtar TPU kernel shares. The weights
// come as ops/minatar_rollout.py `minatar_weights` lays them out: the conv
// as a (9 kCh, 16) tap matrix with rows in the (di, dj, c) order and 1/255
// folded in, the dense weight (H, 1024) with columns in flax's (i, j, f)
// flatten order, the head unpadded (A, H).
//
// What bounded the earlier design, one block of 256 threads an env: every
// step, every block read the whole dense weight (H x 1024
// floats, 512 KiB at H 128) from L2, 64 MiB a step at the trainers' B 128,
// so the MinAtar rollouts ran at about 4 TB/s of L2 traffic, 0.40-0.56 ms a
// launch (T 32), 19-24x their operation bounds.
//
// The design here (the plan is ops/minatar_rollout.py `cluster_plan`): a
// cluster of C CTAs takes C envs, one env a CTA (the last cluster may have
// CTAs without an env). CTA r holds the dense weight's columns [r F,
// (r + 1) F), F = 1024 / C, which read the conv pixels [r P, (r + 1) P),
// P = 64 / C: F x H floats in shared memory (transposed, a row a column),
// loaded once a launch. Each step:
//   1. each CTA with an env marks each cell's active channels of its 0/1
//      planes (a bit mask a cell) and runs the conv and LN1 (a thread a
//      pixel and 4 features); the conv sums the taps' weights at the
//      active cells of the pixel's 3x3 window only, in tap order, the bits
//      of the dense sum; each thread sends its 4 outputs to the CTA that
//      holds their pixel (st.async of 16 bytes);
//   2. each CTA, once the slices of all the cluster's envs are in, forms the
//      partial sums of its F columns for every env and unit from shared
//      memory: a thread a quad of units, half the envs and a chunk of the
//      columns, the quad's weights of a column in one 16-byte load and each
//      env's value of it in one broadcast load, the chunks then added in
//      order through shared memory; it sends env g's H sums to CTA g
//      (st.async of 16 bytes);
//   3. each CTA with an env adds the C partial sums of each unit in rank
//      order, then a warp a Q-value runs the bias, LN2, relu and head row a.
// The 64 MiB a step of L2 traffic becomes two exchanges of 4 KiB and C H
// floats a CTA and FP32 FMAs from shared memory (FFMA on the CUDA cores:
// TF32 would break the 1e-4 bound on Q against the twin, on which the
// greedy action rests). Loops over the cluster's envs have no branch (rows
// past the last env are computed and not sent), so their loads overlap.
//
// The slots of the exchanges. The conv outputs of step t go to slot t & 1
// of h1r, the partial sums to slot t & 1 of pr, each counted on its own
// mbarrier. A CTA writes step t + 2 into another CTA's h1r slot only after
// it has that step's partial sums for its env, which every CTA sends only
// after it has read step t + 1's slices, that is after it has read step t's
// from the same slot; a CTA writes the partial sums of step t + 2 only
// after it has the step t + 2 slices of their env's owner, which sends
// them only after it has read step t's partial sums.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace minatar

namespace minatar_cluster {

using namespace minatar;
using namespace dsmem;

// kThreads (256) a CTA: the conv takes a thread per pixel and feature quad
static_assert(kThreads == kOut * kOut * kFeatures / 4, "a thread per conv pixel and feature quad");

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// The partial sums take a thread a quad of units, a half of the cluster's
// envs (all of them where C is 1) and a chunk of the CTA's F columns:
// chunks_of(H, C) chunks (ops/minatar_rollout.py cluster_plan's `chunks`).
__host__ __device__ constexpr int halves_of(int C) { return C > 1 ? 2 : 1; }
__host__ __device__ constexpr int chunks_of(int H, int C) { return kThreads / (H / 4 * halves_of(C)); }

// Floats of dynamic shared memory a CTA takes at kCh channels, H units, a
// cluster of C and `game_ints` ints of the game's own (ops/minatar_rollout.py
// cluster_smem_bytes / 4), in blocks of multiples of 4 floats: 8 (the four
// mbarriers), the W slice transposed (F x H), two slots of the envs'
// conv-output slices (2 x 1024) and of the partial sums received (2 x C x
// H), the chunks' sums (chunks x C x H), the planes (100 kCh) and each
// cell's mask of active channels (100), the conv taps, the conv bias and
// LN1 scale and bias (48), the dense bias, LN2 scale and bias and the head
// (11 H + 8), q (8) and the game's ints (its state, its Philox words and
// what its planes read; Freeway keeps its own in static shared memory).
__host__ __device__ inline int smem_floats(int kCh, int H, int C, int game_ints) {
  return 8 + (kFlat / C) * H + 2 * kFlat + 2 * C * H + chunks_of(H, C) * C * H + round4(kCells * kCh) + kCells +
         9 * kCh * kFeatures + 48 + 11 * H + 8 + kMaxActions + round4(game_ints);
}

struct Smem {
  unsigned long long* bars;  // [4]: h1r slots 0, 1; pr slots 0, 1
  float* wt;                 // [F][H]: this CTA's columns of dense_w, transposed
  float* h1r;                // [2][C][F]: slot, source env
  float* pr;                 // [2][C][H]: slot, source CTA; this env's partial sums
  float* red;                // [chunks][C][H]: the chunks' partial sums
  float* planes;             // [100 kCh], (row, col, channel) order
  int* masks;                // [100]: each cell's active channels, bit c for channel c
  float* wconv;              // [9 kCh][16]
  float* vec;                // conv bias, LN1 scale, LN1 bias: [3][16]
  float* dense_b;            // [H]
  float* ln2_scale;          // [H]
  float* ln2_bias;           // [H]
  float* head_w;             // [8][H]
  float* head_b;             // [8]
  float* q;                  // [8]
  int* game;                 // [game ints]: the env's state, Philox words and the like
};

// Where the CTA runs: its cluster of C, its rank, the envs of the cluster
// (nb), its own env (b) and whether it has one (live).
struct Place {
  int C, H, A, T, rank, nb, b;
  bool live;
};

template <int kCh>
__device__ __forceinline__ Smem smem_layout(float* base, int H, int C) {
  Smem m;
  m.bars = reinterpret_cast<unsigned long long*>(base);
  m.wt = base + 8;
  m.h1r = m.wt + (kFlat / C) * H;
  m.pr = m.h1r + 2 * kFlat;
  m.red = m.pr + 2 * C * H;
  m.planes = m.red + chunks_of(H, C) * C * H;
  m.masks = reinterpret_cast<int*>(m.planes + round4(kCells * kCh));
  m.wconv = reinterpret_cast<float*>(m.masks + kCells);
  m.vec = m.wconv + 9 * kCh * kFeatures;
  m.dense_b = m.vec + 48;
  m.ln2_scale = m.dense_b + H;
  m.ln2_bias = m.ln2_scale + H;
  m.head_w = m.ln2_bias + H;
  m.head_b = m.head_w + 8 * H;
  m.q = m.head_b + 8;
  m.game = reinterpret_cast<int*>(m.q + kMaxActions);
  return m;
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ Place place_of(int B, int H, int A, int T) {
  Place p;
  cg::cluster_group cluster = cg::this_cluster();
  p.C = (int)cluster.num_blocks();
  p.rank = (int)cluster.block_rank();
  const int b0 = (int)(blockIdx.x / p.C) * p.C;
  p.nb = min(p.C, B - b0);
  p.b = b0 + p.rank;
  p.live = p.rank < p.nb;
  p.H = H, p.A = A, p.T = T;
  return p;
}

// Load this CTA's weights, arm the first two phases of each exchange and
// start the cluster. Ends with a cluster barrier, so the block is in step.
template <int kCh>
__device__ void load_and_arm(const Smem& m, const CnnWeights& w, const Place& p) {
  const int tid = threadIdx.x, H = p.H, F = kFlat / p.C;
  for (int i = tid; i < H * F; i += blockDim.x) {
    const int u = i / F, f = i - u * F;
    m.wt[f * H + u] = w.dense_w[(size_t)u * kFlat + p.rank * F + f];
  }
  for (int k = tid; k < 9 * kCh * kFeatures; k += blockDim.x) m.wconv[k] = w.conv_w[k];
  for (int u = tid; u < H; u += blockDim.x) {
    m.dense_b[u] = w.dense_b[u];
    m.ln2_scale[u] = w.ln2_scale[u];
    m.ln2_bias[u] = w.ln2_bias[u];
  }
  for (int i = tid; i < p.A * H; i += blockDim.x) m.head_w[i] = w.head_w[i];
  if (tid < p.A) m.head_b[tid] = w.head_b[tid];
  if (tid < kFeatures) {
    m.vec[tid] = w.conv_b[tid];
    m.vec[kFeatures + tid] = w.ln1_scale[tid];
    m.vec[2 * kFeatures + tid] = w.ln1_bias[tid];
  }
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) bar_init(smem_addr(&m.bars[i]));
    for (int s = 0; s < 2 && s < p.T; ++s) {
      bar_expect(smem_addr(&m.bars[s]), 4u * p.nb * F);
      if (p.live) bar_expect(smem_addr(&m.bars[2 + s]), 4u * p.C * H);
    }
  }
  cluster_start();
}

// Each cell's active channels of the planes (0/1, 100 kCh) as a bit mask
// into m.masks: a thread a cell. Ends with a block barrier.
template <int kCh>
__device__ __forceinline__ void cell_masks(const Smem& m) {
  const int tid = threadIdx.x;
  if (tid < kCells) {
    unsigned mask = 0;
#pragma unroll
    for (int c = 0; c < kCh; ++c) mask |= (m.planes[tid * kCh + c] != 0.0f ? 1u : 0u) << c;
    m.masks[tid] = (int)mask;
  }
  __syncthreads();
}

// Q-values of the planes in m.planes into m.q[0 .. A) at step t, on every
// CTA of the cluster (each step, every CTA calls it once; KC = C). The
// caller has built the planes of its env (if it has one) and synchronized
// the block. On a CTA with an env this ends with a block barrier after
// which m.q is visible; on one without, it returns once its partial sums
// are sent.
template <int kCh, int KC>
__device__ void cluster_q_values(const Smem& m, const CnnWeights& w, const Place& p, int t, unsigned& parity) {
  constexpr int F = kFlat / KC, P = kOut * kOut / KC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = p.H, slot = t & 1;
  float* h1r = m.h1r + slot * kFlat;

  if (p.live) {
    // conv 3x3 VALID: thread (pixel, feature quad), a sum a row of taps (the
    // bias in the first). The planes are 0/1, so the sum over the taps is the
    // sum of the taps' weights at the window's active cells, taken in the
    // same order (row, col, channel) as over all taps: the same bits as the
    // dense sum.
    cell_masks<kCh>(m);
    const int pix = tid >> 2, fq = tid & 3;
    const int i = pix / kOut, j = pix - (pix / kOut) * kOut;
    const float4* w4 = reinterpret_cast<const float4*>(m.wconv) + fq;
    float4 rows[3] = {reinterpret_cast<const float4*>(m.vec)[fq], make_float4(0.0f, 0.0f, 0.0f, 0.0f),
                      make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
#pragma unroll
    for (int di = 0; di < 3; ++di) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        for (unsigned mk = (unsigned)m.masks[(i + di) * kSide + j + dj]; mk != 0; mk &= mk - 1) {
          add4(rows[di], w4[((di * 3 + dj) * kCh + __ffs(mk) - 1) * (kFeatures / 4)]);
        }
      }
    }
    const float4 a = make_float4((rows[0].x + rows[1].x) + rows[2].x, (rows[0].y + rows[1].y) + rows[2].y,
                                 (rows[0].z + rows[1].z) + rows[2].z, (rows[0].w + rows[1].w) + rows[2].w);
    // LN1 over the pixel's 16 features (its 4 quads on adjacent lanes), relu
    float sum = (a.x + a.y) + (a.z + a.w);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float mu = sum / (float)kFeatures;
    const float4 d = make_float4(a.x - mu, a.y - mu, a.z - mu, a.w - mu);
    float ss = (d.x * d.x + d.y * d.y) + (d.z * d.z + d.w * d.w);
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    const float inv = 1.0f / sqrtf(ss / (float)kFeatures + kLnEps);
    const float4 sc = reinterpret_cast<const float4*>(m.vec + kFeatures)[fq];
    const float4 bi = reinterpret_cast<const float4*>(m.vec + 2 * kFeatures)[fq];
    const float4 y =
        make_float4(fmaxf(d.x * inv * sc.x + bi.x, 0.0f), fmaxf(d.y * inv * sc.y + bi.y, 0.0f),
                    fmaxf(d.z * inv * sc.z + bi.z, 0.0f), fmaxf(d.w * inv * sc.w + bi.w, 0.0f));
    // to the CTA that holds this pixel's columns, at [slot][this env]
    const int r = pix / P;
    const unsigned dst = smem_addr(h1r + p.rank * F + (pix - r * P) * kFeatures + 4 * fq);
    st_async4(cluster_addr(dst, r), y, cluster_addr(smem_addr(&m.bars[slot]), r));
  }
  wait_slot(m.bars, slot, parity);
  if (tid == 0 && t + 2 < p.T) bar_expect(smem_addr(&m.bars[slot]), 4u * p.nb * F);

  // partial dense sums of this CTA's F columns for every env slot: thread
  // (unit quad uq, env half eh, chunk ch), the chunk the columns ch, ch +
  // NCH, ...; the quad's 4 weights of a column in one load, each env's
  // value of it a broadcast load. Rows of h1r past the cluster's last env
  // hold stale values, whose sums are not sent (no branch, so the loads
  // overlap).
  constexpr int EH = halves_of(KC), KE = KC / EH;
  const int QH = H / 4, NCH = chunks_of(H, KC);
  float4* red = reinterpret_cast<float4*>(m.red);
  if (tid < NCH * EH * QH) {
    const int uq = tid % QH, eh = (tid / QH) % EH, ch = tid / (QH * EH);
    const float4* wt = reinterpret_cast<const float4*>(m.wt) + uq;
    const float* hx = h1r + eh * KE * F;
    float4 acc[KE];
#pragma unroll
    for (int g = 0; g < KE; ++g) acc[g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int f = ch; f < F; f += NCH) {
      const float4 wv = wt[f * QH];
#pragma unroll
      for (int g = 0; g < KE; ++g) {
        const float h = hx[g * F + f];
        acc[g].x = fmaf(h, wv.x, acc[g].x);
        acc[g].y = fmaf(h, wv.y, acc[g].y);
        acc[g].z = fmaf(h, wv.z, acc[g].z);
        acc[g].w = fmaf(h, wv.w, acc[g].w);
      }
    }
#pragma unroll
    for (int g = 0; g < KE; ++g) red[(ch * KC + eh * KE + g) * QH + uq] = acc[g];
  }
  __syncthreads();
  // env g's sums over the chunks, in chunk order, to its CTA (rank g), at
  // [slot][this rank]
  for (int o = tid; o < p.nb * QH; o += blockDim.x) {
    const int g = o / QH, uq = o - g * QH;
    float4 s = red[g * QH + uq];
    for (int ch = 1; ch < NCH; ++ch) add4(s, red[(ch * KC + g) * QH + uq]);
    const unsigned dst = smem_addr(m.pr + (slot * KC + p.rank) * H + 4 * uq);
    st_async4(cluster_addr(dst, g), s, cluster_addr(smem_addr(&m.bars[2 + slot]), g));
  }
  if (!p.live) return;

  wait_slot(m.bars, 2 + slot, parity);
  if (tid == 0 && t + 2 < p.T) bar_expect(smem_addr(&m.bars[2 + slot]), 4u * KC * H);
  // warp a < A: h2 (the C partial sums in rank order, then the bias), LN2
  // (two-pass) and relu over all H units, lane l taking units l, l + 32,
  // ...; then head row a. A lane's units past H read unit H - 1 and count
  // as 0 (no branch, so the loads overlap).
  if (warp < p.A) {
    const float* pr = m.pr + slot * KC * H;
    float y[kThreads / 32];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
      const int u = min(lane + 32 * i, H - 1);
      float v = 0.0f;
#pragma unroll
      for (int r = 0; r < KC; ++r) v += pr[r * H + u];
      y[i] = lane + 32 * i < H ? v + m.dense_b[u] : 0.0f;
      sum += y[i];
    }
    const float mu = warp_sum(sum) / (float)H;
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
      const float d = lane + 32 * i < H ? y[i] - mu : 0.0f;
      ss += d * d;
    }
    const float inv = 1.0f / sqrtf(warp_sum(ss) / (float)H + kLnEps);
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
      const int u = min(lane + 32 * i, H - 1);
      const float h = fmaxf((y[i] - mu) * inv * m.ln2_scale[u] + m.ln2_bias[u], 0.0f);
      q += lane + 32 * i < H ? m.head_w[warp * H + u] * h : 0.0f;
    }
    q = warp_sum(q);
    if (lane == 0) m.q[warp] = q + m.head_b[warp];
  }
  __syncthreads();
}

// The greedy action of the Q-values in m.q, on any thread of the env's CTA
// after cluster_q_values: the rule of jnp.argmax and torch.argmax, a NaN
// counted as the maximum (the first NaN wins) and the first index winning
// ties.
__device__ __forceinline__ int greedy_of(const Smem& m, int A) {
  int greedy = 0;
  float best = m.q[0];
  for (int a = 1; a < A; ++a) {
    if (best == best && (m.q[a] > best || m.q[a] != m.q[a])) {
      best = m.q[a];
      greedy = a;
    }
  }
  return greedy;
}

// After the last step: no CTA leaves while a remote store may still reach
// its shared memory.
__device__ __forceinline__ void finish_launch() { cg::this_cluster().sync(); }

}  // namespace minatar_cluster
