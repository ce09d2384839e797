// GRU time scan, forward: the whole T-step recurrence of one GRU layer in
// one launch, from the hoisted input projections xi = x W_i + b_i.
//
// Replaces: purejaxql_tpu/ops/fast_rnn.py `_gru_fwd_kernel` (called through
// `_gru_core_fwd_call`), which keeps h, W_h and the residuals in VMEM and
// runs a fori_loop over T. Per step t, for each batch row b:
//   hbar = h * keep[t, b]                  (episode-boundary reset)
//   hh = hbar W_h                          (W_h is (H, 3H) row-major)
//   r = sigmoid(xi_r + hh_r), z = sigmoid(xi_z + hh_z), c = hh_n + b_hn,
//   n = tanh(xi_n + r c), h' = (1 - z) n + z hbar
// and it writes y = h', r, z, n and c at [t, b], the residuals that the
// backward kernel (gru_scan_bwd.cu) reads.
//
// Bound on an H100: the work is one (B, H) x (H, 3H) product and the gate
// math per step, and the bytes are xi, the five outputs and W_h once: at
// the trainers' shapes (T 132 or 68, B 2, H 256) a few microseconds of
// either roof. The scan is bound by latency instead: T dependent steps,
// each a product whose input is the step before's output, and an exchange
// between SMs.
//
// Design (the plan is ops/gru_scan.py:scan_plan): a thread-block cluster of
// C CTAs takes R <= 8 batch rows; the grid is ceil(B / R) clusters. CTA c
// owns U hidden units (the last CTA may own fewer) and keeps the 3U columns
// of W_h that feed them, [W_hr[:, U] | W_hz[:, U] | W_hn[:, U]], on chip for
// the whole scan: where H <= 256, each lane holds its 48 floats of them in
// registers (at H 256 a cluster of 16: 16 units a CTA, 256 threads); else
// the CTA holds them in shared memory, one zero-padded row per (unit, gate)
// (192 KiB at H 512, C 16). Every CTA holds the whole reset carry hbar of
// its rows in two slots. Each step, 16 lanes take a unit (2 units a warp):
// they split the H-long dot products of its three gates over k, 4 floats a
// lane at a time, for all R rows, and reduce them by a fixed butterfly of
// shuffles; lane b of the 16 then does the gate math of row b and sends
// h' * keep[t + 1] into the other slot of every CTA of the cluster through
// distributed shared memory (gru_cluster.cuh: st.async counted on that
// slot's mbarrier, so a CTA waits only for the data it reads). The five
// outputs are stored and the next step's xi and keep loaded while the
// exchange is in flight. Where the slice does not fit (H > 512), the CTA
// reads its columns of W_h from L2 every step instead.
//
// Seeds: with S seeds (NUM_SEEDS, what jax.vmap of the TPU kernel computes
// with the seed as a grid axis), W_h is (S, H, 3H), b_hn (S, H), and the
// rows are S seed-major blocks of B: xi (T, S B, 3H), keep (T, S B, 1), h0
// (S B, H). The grid is S ceil(B / R) clusters, seed by seed, so a
// cluster's rows never straddle two seeds and it loads only its own seed's
// slice of W_h. With S = 1 this is the single-seed kernel, bit for bit.
//
// fp32 FFMA on the CUDA cores, not wgmma: B is 2 at the trainers' shapes and
// wgmma wants 64-row tiles (N would pad from 2 to 8 even with W_h^T as A),
// and its float32 path is TF32, whose 10 mantissa bits would break the 1e-5
// tolerance against the twin. Every sum has a fixed order, so two launches
// give the same bits.

#include "gru_cluster.cuh"

namespace {

using namespace gru;

// a lane's k-quads of its unit's 3 rows of the slice in registers (REG):
// H <= 4 kLanes kRegQuads
constexpr int kRegQuads = 4;

// REG: the slice in registers (H <= 256); RES: else in shared memory; else
// read from L2 every step
template <int R, bool RES, bool REG>
__global__ void __launch_bounds__(RES || REG ? 512 : 1024, 1)
gru_scan_fwd_kernel(const float* __restrict__ xi, const float* __restrict__ keep,
                    const float* __restrict__ h0, const float* __restrict__ wh,
                    const float* __restrict__ bhn, float* __restrict__ y,
                    float* __restrict__ r_out, float* __restrict__ z_out,
                    float* __restrict__ n_out, float* __restrict__ c_out,
                    int T, int S, int B, int H, int Up) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int H3 = 3 * H;
  const int Hp = (H + 4 * kLanes - 1) / (4 * kLanes) * (4 * kLanes);  // a row of hbar, zero-padded
  const int Hs = Hp + 4;              // a row of the slice: 4 floats apart in banks
  // this cluster's seed and rows: B a seed, Bt = S B rows a step
  const int K = (B + R - 1) / R;
  const int cid = blockIdx.x / C, seed = cid / K;
  const int lb0 = (cid - seed * K) * R;
  const int b0 = seed * B + lb0;
  const int nb = min(R, B - lb0);
  const int Bt = S * B;
  wh += (size_t)seed * H * H3;
  bhn += (size_t)seed * H;
  const int u0 = rank * Up;
  const int U = min(Up, H - u0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane / kLanes, s = lane % kLanes;  // unit group of the warp, lane in it
  const int step = (blockDim.x >> 5) * kUnitsPerWarp;

  extern __shared__ float4 smem4[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem4);  // [2]: a slot's mbarrier
  float* ws = reinterpret_cast<float*>(smem4 + 1);  // [Up][3][Hs]: this CTA's columns of W_h
  float* hs = ws + (RES && !REG ? Up * 3 * Hs : 0);  // [2][R][Hp]: hbar, two slots

  if (RES && !REG) {
    // reads along a row of W_h (U units of a gate); the shared stores land
    // 12 banks apart, a 4-way conflict, once a launch
    for (int i = threadIdx.x; i < 3 * Up * Hp; i += blockDim.x) {
      const int k = i / (3 * Up), rest = i - k * 3 * Up;
      const int g = rest / Up, uu = rest - g * Up;
      ws[(uu * 3 + g) * Hs + k] = (k < H && uu < U) ? wh[(size_t)k * H3 + g * H + u0 + uu] : 0.0f;
    }
  }
  for (int i = threadIdx.x; i < 2 * R * Hp; i += blockDim.x) {
    const int slot = i / (R * Hp), rest = i - slot * R * Hp;
    const int b = rest / Hp, k = rest - b * Hp;
    hs[i] = (slot == 0 && b < nb && k < H) ? h0[(size_t)(b0 + b) * H + k] * keep[b0 + b] : 0.0f;
  }
  // step t sends h_{t+1} into slot (t + 1) & 1, for t + 1 < T: all H units
  // of nb rows from the cluster
  const unsigned bytes = 4u * nb * H;
  if (threadIdx.x == 0) {
    bar_init(smem_addr(&bars[0]));
    bar_init(smem_addr(&bars[1]));
    if (T > 1) bar_expect(smem_addr(&bars[1]), bytes);
    if (T > 2) bar_expect(smem_addr(&bars[0]), bytes);
  }
  cluster_start();

  // lane s's inputs for (row s, the group's first unit), loaded a step
  // ahead: xi[t] and keep[t + 1], which masks the h' that step t hands on
  const int u_first = u0 + warp * kUnitsPerWarp + q;
  const bool first = warp * kUnitsPerWarp + q < U && s < nb;
  float px_r = 0.0f, px_z = 0.0f, px_n = 0.0f, p_keep = 0.0f, b_first = 0.0f;
  if (T > 0 && first) {
    const float* x = xi + (size_t)(b0 + s) * H3;
    px_r = x[u_first];
    px_z = x[H + u_first];
    px_n = x[2 * H + u_first];
    if (T > 1) p_keep = keep[Bt + b0 + s];
    b_first = bhn[u_first];
  }
  // REG: the lane's quads k = 4 s + 4 kLanes i of its unit's 3 rows
  float4 wreg[REG ? kRegQuads : 1][3];
#pragma unroll
  for (int i = 0; i < (REG ? kRegQuads : 1); ++i) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * s + 4 * kLanes * i + e;
        w[e] = REG && u_first < u0 + U && k < H ? wh[(size_t)k * H3 + g * H + u_first] : 0.0f;
      }
      wreg[i][g] = make_float4(w[0], w[1], w[2], w[3]);
    }
  }
  size_t o_first = 0;
  float y_first = 0.0f, r_first = 0.0f, z_first = 0.0f, n_first = 0.0f, c_first = 0.0f;
  unsigned parity = 0;  // bit i: the phase of slot i's mbarrier to wait for

  for (int t = 0; t < T; ++t) {
    const float* cur = hs + (t & 1) * R * Hp;
    float* nxt = hs + ((t + 1) & 1) * R * Hp;
    const unsigned bar = smem_addr(&bars[(t + 1) & 1]);
    for (int ub = warp * kUnitsPerWarp; ub < U; ub += step) {
      const int uu = ub + q;
      const bool live = uu < U;
      const int u = u0 + uu;
      // two chains a sum (k = 0, 2 and k = 1, 3 of each float4), added at the end
      float acc[3][R][2];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int b = 0; b < R; ++b) acc[g][b][0] = acc[g][b][1] = 0.0f;
      // the unit's kLanes lanes split k, 4 floats a lane at a time
      if (REG && live) {
#pragma unroll
        for (int i = 0; i < kRegQuads; ++i) {
          const int k = 4 * s + 4 * kLanes * i;
          if (k < Hp) {
#pragma unroll
            for (int b = 0; b < R; ++b) {
              const float4 hv = *reinterpret_cast<const float4*>(cur + b * Hp + k);
#pragma unroll
              for (int g = 0; g < 3; ++g) {
                acc[g][b][0] = fmaf(hv.z, wreg[i][g].z, fmaf(hv.x, wreg[i][g].x, acc[g][b][0]));
                acc[g][b][1] = fmaf(hv.w, wreg[i][g].w, fmaf(hv.y, wreg[i][g].y, acc[g][b][1]));
              }
            }
          }
        }
      } else if (live) {
#pragma unroll 4
        for (int k = 4 * s; k < Hp; k += 4 * kLanes) {
          float4 w[3];
          if (RES) {
#pragma unroll
            for (int g = 0; g < 3; ++g) w[g] = *reinterpret_cast<const float4*>(ws + (uu * 3 + g) * Hs + k);
          } else {
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              const float* col = wh + g * H + u;
              w[g].x = k < H ? __ldg(col + (size_t)k * H3) : 0.0f;
              w[g].y = k + 1 < H ? __ldg(col + (size_t)(k + 1) * H3) : 0.0f;
              w[g].z = k + 2 < H ? __ldg(col + (size_t)(k + 2) * H3) : 0.0f;
              w[g].w = k + 3 < H ? __ldg(col + (size_t)(k + 3) * H3) : 0.0f;
            }
          }
#pragma unroll
          for (int b = 0; b < R; ++b) {
            const float4 hv = *reinterpret_cast<const float4*>(cur + b * Hp + k);
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              acc[g][b][0] = fmaf(hv.z, w[g].z, fmaf(hv.x, w[g].x, acc[g][b][0]));
              acc[g][b][1] = fmaf(hv.w, w[g].w, fmaf(hv.y, w[g].y, acc[g][b][1]));
            }
          }
        }
      }
      float a_r = 0.0f, a_z = 0.0f, a_n = 0.0f;
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const float s_r = group_sum(acc[0][b][0] + acc[0][b][1]);
        const float s_z = group_sum(acc[1][b][0] + acc[1][b][1]);
        const float s_n = group_sum(acc[2][b][0] + acc[2][b][1]);
        if (s == b) a_r = s_r, a_z = s_z, a_n = s_n;
      }
      if (live && s < nb) {
        const int b = s;
        const size_t row = (size_t)t * Bt + b0 + b;
        float x_r, x_z, x_n, k_next, b_n;
        if (ub == warp * kUnitsPerWarp) {
          x_r = px_r, x_z = px_z, x_n = px_n, k_next = p_keep, b_n = b_first;
        } else {
          const float* x = xi + row * H3;
          x_r = x[u], x_z = x[H + u], x_n = x[2 * H + u];
          k_next = t + 1 < T ? keep[row + Bt] : 0.0f;
          b_n = bhn[u];
        }
        const float r = sigmoidf(x_r + a_r);
        const float z = sigmoidf(x_z + a_z);
        const float c = a_n + b_n;
        const float n = tanhf(x_n + r * c);
        const float h_new = (1.0f - z) * n + z * cur[b * Hp + u];
        if (t + 1 < T) send_all(smem_addr(nxt + b * Hp + u), h_new * k_next, bar, C);
        const size_t o = row * H + u;
        if (ub == warp * kUnitsPerWarp) {
          o_first = o, y_first = h_new, r_first = r, z_first = z, n_first = n, c_first = c;
        } else {
          y[o] = h_new, r_out[o] = r, z_out[o] = z, n_out[o] = n, c_out[o] = c;
        }
      }
    }
    // while h_{t+1} is in flight: the first unit's outputs go out and the
    // next step's inputs come in
    if (first) {
      y[o_first] = y_first;
      r_out[o_first] = r_first;
      z_out[o_first] = z_first;
      n_out[o_first] = n_first;
      c_out[o_first] = c_first;
      if (t + 1 < T) {
        const float* x = xi + ((size_t)(t + 1) * Bt + b0 + s) * H3;
        px_r = x[u_first];
        px_z = x[H + u_first];
        px_n = x[2 * H + u_first];
        if (t + 2 < T) p_keep = keep[(size_t)(t + 2) * Bt + b0 + s];
      }
    }
    if (t + 1 < T) {
      const int slot = (t + 1) & 1;
      bar_wait(bar, (parity >> slot) & 1);
      parity ^= 1u << slot;
      __syncthreads();
      // re-arm the slot for step t + 2's send
      if (threadIdx.x == 0 && t + 3 < T) bar_expect(bar, bytes);
    }
  }
}

template <int R, bool RES, bool REG>
int launch(const float* xi, const float* keep, const float* h0, const float* wh,
           const float* bhn, float* y, float* r, float* z, float* n, float* c,
           int T, int S, int B, int H, int C, int Up, int threads, int smem, cudaStream_t s) {
  return launch_clusters(gru_scan_fwd_kernel<R, RES, REG>, C, S * ((B + R - 1) / R), threads, smem, s,
                         xi, keep, h0, wh, bhn, y, r, z, n, c, T, S, B, H, Up);
}

template <bool RES, bool REG>
int launch_rows(const float* xi, const float* keep, const float* h0, const float* wh,
                const float* bhn, float* y, float* r, float* z, float* n, float* c,
                int T, int S, int B, int H, int C, int Up, int R, int threads, int smem,
                cudaStream_t s) {
  switch (R) {
    case 1: return launch<1, RES, REG>(xi, keep, h0, wh, bhn, y, r, z, n, c, T, S, B, H, C, Up, threads, smem, s);
    case 2: return launch<2, RES, REG>(xi, keep, h0, wh, bhn, y, r, z, n, c, T, S, B, H, C, Up, threads, smem, s);
    case 4: return launch<4, RES, REG>(xi, keep, h0, wh, bhn, y, r, z, n, c, T, S, B, H, C, Up, threads, smem, s);
    case 8: return launch<8, RES, REG>(xi, keep, h0, wh, bhn, y, r, z, n, c, T, S, B, H, C, Up, threads, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// how many clusters of the <R, RES, REG> instance the card places at once
template <bool RES, bool REG>
int active_rows(int R, int C, int threads, int smem) {
  switch (R) {
    case 1: return active_clusters(gru_scan_fwd_kernel<1, RES, REG>, C, threads, smem);
    case 2: return active_clusters(gru_scan_fwd_kernel<2, RES, REG>, C, threads, smem);
    case 4: return active_clusters(gru_scan_fwd_kernel<4, RES, REG>, C, threads, smem);
    case 8: return active_clusters(gru_scan_fwd_kernel<8, RES, REG>, C, threads, smem);
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// xi (T, S B, 3H), keep (T, S B, 1), h0 (S B, H), wh (S, H, 3H), bhn (S, H)
// in; y, r, z, n, c (T, S B, H) out; all float32 and contiguous; S seeds
// of B rows each (S = 1: wh (H, 3H), bhn (H,)). The plan (cluster C,
// units per CTA, rows R, threads per CTA, resident, in registers, shared
// bytes per CTA)
// comes from ops/gru_scan.py:scan_plan. Launches on `stream`; returns a
// cudaError_t (0 on success).
int gru_scan_fwd_f32(const float* xi, const float* keep, const float* h0,
                     const float* wh, const float* bhn, float* y, float* r,
                     float* z, float* n, float* c, int T, int S, int B, int H,
                     int cluster, int units, int rows, int threads, int resident,
                     int registers, int smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (S < 1) return (int)cudaErrorInvalidValue;
  // the resident kernels take at most 512 threads; the registers hold
  // H <= 4 kLanes kRegQuads of one unit a lane group
  if ((resident || registers) && threads > 512) return (int)cudaErrorInvalidValue;
  if (registers && (H > 4 * kLanes * kRegQuads || threads * kUnitsPerWarp < 32 * units))
    return (int)cudaErrorInvalidValue;
  if (registers)
    return launch_rows<false, true>(xi, keep, h0, wh, bhn, y, r, z, n, c, T, S, B, H, cluster, units,
                                    rows, threads, smem_bytes, s);
  if (resident)
    return launch_rows<true, false>(xi, keep, h0, wh, bhn, y, r, z, n, c, T, S, B, H, cluster, units,
                                    rows, threads, smem_bytes, s);
  return launch_rows<false, false>(xi, keep, h0, wh, bhn, y, r, z, n, c, T, S, B, H, cluster, units,
                                   rows, threads, smem_bytes, s);
}

// How many clusters of the plan (ops/gru_scan.py:scan_plan) the card
// places at once (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
int gru_scan_fwd_active_clusters(int cluster, int rows, int threads, int resident, int registers,
                                   int smem_bytes) {
  if (registers) return active_rows<false, true>(rows, cluster, threads, smem_bytes);
  if (resident) return active_rows<true, false>(rows, cluster, threads, smem_bytes);
  return active_rows<false, false>(rows, cluster, threads, smem_bytes);
}

const char* gru_scan_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
