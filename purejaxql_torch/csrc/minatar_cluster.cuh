// The MinAtar CNN forward of a fused MinAtar rollout, run by a
// thread-block cluster that keeps the dense weight on chip for the whole
// launch. The same network as minatar_cnn.cuh (a 3x3 VALID conv from kCh
// channels to 16, LayerNorm over the channels of each pixel and relu, a
// dense layer from the 1024 conv outputs to H units, LayerNorm and relu,
// the head to A Q-values), with the weights in the layout of
// ops/minatar_rollout.py `minatar_weights`.
//
// Counterpart of purejaxql_tpu/ops/pallas_rollout.py `_cnn_forward`, which
// every MinAtar TPU kernel shares.
//
// What bounded the one-block-per-env design (minatar_cnn.cuh): every step,
// every block read the whole dense weight (H x 1024 floats, 512 KiB at H
// 128) from L2, 64 MiB a step at the trainers' B 128, so the MinAtar
// rollouts ran at about 4 TB/s of L2 traffic, 0.40-0.56 ms a launch
// (T 32), 19-24x their operation bounds.
//
// The design here (the plan is ops/minatar_rollout.py `cluster_plan`): a
// cluster of C CTAs takes C envs, one env a CTA (the last cluster may have
// CTAs without an env). CTA r holds the dense weight's columns [r F,
// (r + 1) F), F = 1024 / C, which read the conv pixels [r P, (r + 1) P),
// P = 64 / C: F x H floats in shared memory (transposed, a row a column),
// loaded once a launch. Each step:
//   1. each CTA with an env lists the active cells of its 0/1 planes and
//      runs the conv and LN1 (a thread a pixel and 4 features); the conv
//      sums the taps' weights at the active cells only, in tap order, the
//      bits of the dense sum; each thread sends its 4 outputs to the CTA
//      that holds their pixel (st.async of 16 bytes);
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

#include "cluster.cuh"
#include "minatar_cnn.cuh"

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
// H), the chunks' sums (chunks x C x H), the planes and their active cells
// (100 kCh each, and 4), the conv taps, the conv bias and LN1 scale and
// bias (48), the dense bias, LN2 scale and bias and the head (11 H + 8), a
// scan scratch (4), q (8) and the game's ints (its state, its Philox words
// and what its planes read; Freeway keeps its own in static shared memory).
__host__ __device__ inline int smem_floats(int kCh, int H, int C, int game_ints) {
  return 8 + (kFlat / C) * H + 2 * kFlat + 2 * C * H + chunks_of(H, C) * C * H + 2 * round4(kCells * kCh) + 4 +
         9 * kCh * kFeatures + 48 + 11 * H + 8 + 4 + kMaxActions + round4(game_ints);
}

struct Smem {
  unsigned long long* bars;  // [4]: h1r slots 0, 1; pr slots 0, 1
  float* wt;                 // [F][H]: this CTA's columns of dense_w, transposed
  float* h1r;                // [2][C][F]: slot, source env
  float* pr;                 // [2][C][H]: slot, source CTA; this env's partial sums
  float* red;                // [chunks][C][H]: the chunks' partial sums
  float* planes;             // [100 kCh], (row, col, channel) order
  int* cells;                // [100 kCh]: the planes' nonzero entries, (row << 16 | col << 8 | channel)
  int* ncells;               // [4]: how many, and a scan scratch [4]
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
  m.cells = reinterpret_cast<int*>(m.planes + round4(kCells * kCh));
  m.ncells = m.cells + round4(kCells * kCh);
  m.wconv = reinterpret_cast<float*>(m.ncells + 8);
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

// The nonzero entries of the planes (0/1 masks, 100 kCh), in (row, col,
// channel) order, into m.cells, and their count into m.ncells[0]: a thread
// a cell, a scan over the first 4 warps. Ends with a block barrier.
template <int kCh>
__device__ void active_cells(const Smem& m) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned mask = 0;
  if (tid < kCells) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) mask |= (m.planes[tid * kCh + c] != 0.0f ? 1u : 0u) << c;
  }
  const int cnt = __popc(mask);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (warp < 4 && lane == 31) m.ncells[4 + warp] = incl;
  __syncthreads();
  if (tid < kCells) {
    int at = incl - cnt;
    for (int w = 0; w < warp; ++w) at += m.ncells[4 + w];
    const int r = tid / kSide, col = tid - r * kSide;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      if ((mask >> c) & 1u) m.cells[at++] = r << 16 | col << 8 | c;
    }
  }
  if (tid == 0) m.ncells[0] = m.ncells[4] + m.ncells[5] + m.ncells[6] + m.ncells[7];
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
    // sum of the taps' weights at the active cells, taken in the same order
    // (row, col, channel) as over all taps: the same bits as the dense sum.
    active_cells<kCh>(m);
    const int pix = tid >> 2, fq = tid & 3;
    const int i = pix / kOut, j = pix - (pix / kOut) * kOut;
    const float4* w4 = reinterpret_cast<const float4*>(m.wconv) + fq;
    float4 r0 = reinterpret_cast<const float4*>(m.vec)[fq];
    float4 r1 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), r2 = r1;
    const int n = m.ncells[0];
for (int e = 0; e < n; ++e) {
      const int rc = m.cells[e];
      const int di = (rc >> 16) - i, dj = ((rc >> 8) & 0xff) - j;
      if ((unsigned)di < 3u && (unsigned)dj < 3u) {
        const float4 wv = w4[((di * 3 + dj) * kCh + (rc & 0xff)) * (kFeatures / 4)];
        if (di == 0) {
          add4(r0, wv);
        } else if (di == 1) {
          add4(r1, wv);
        } else {
          add4(r2, wv);
        }
      }
    }
    const float4 a = make_float4((r0.x + r1.x) + r2.x, (r0.y + r1.y) + r2.y, (r0.z + r1.z) + r2.z,
                                 (r0.w + r1.w) + r2.w);
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

// The greedy action of the Q-values in m.q (first index wins ties), on any
// thread of the env's CTA after cluster_q_values.
__device__ __forceinline__ int greedy_of(const Smem& m, int A) {
  int greedy = 0;
  float best = m.q[0];
  for (int a = 1; a < A; ++a) {
    if (m.q[a] > best) {
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
