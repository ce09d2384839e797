// GRU time scan, backward: the reverse-time recurrence of one GRU layer's
// gradients and the weight gradients it accumulates, in one launch.
//
// Replaces: purejaxql_tpu/ops/fast_rnn.py `_gru_bwd_kernel` (called through
// `_gru_core_bwd`, the custom_vjp backward of `_gru_core`). From the forward
// residuals (hprev = h_{t-1}, r, z, n, c) and the cotangents g_y of every
// y_t and g_hT of h_T, for t = T-1 ... 0:
//   g = carry + g_y[t], hbar = hprev[t] * keep[t]
//   dn = g (1 - z), dz = g (hbar - n), da_n = dn (1 - n^2), dc = da_n r,
//   da_r = da_n c r (1 - r), da_z = dz z (1 - z)
//   dxi[t] = [da_r, da_z, da_n]; da_cat = [da_r, da_z, dc]
//   carry = (g z + da_cat W_h^T) * keep[t]
//   dW_h += hbar^T da_cat, db_hn += sum_b dc
// and dh0 = carry at the end.
//
// Bound on an H100: per step two (B, H) x (H, 3H)-sized products (the carry
// and the dW_h term) and the gate math; the bytes are the seven (T, B, H)
// inputs, dxi and W_h and dW_h once: a few microseconds of either roof at
// the trainers' shapes. Like the forward it is bound by latency: T dependent
// steps, each a product whose input is the step before's output, and an
// exchange between SMs.
//
// Design (the plan is ops/gru_scan.py:scan_plan, shared with the forward):
// a thread-block cluster of C CTAs takes R <= 8 batch rows. CTA c owns U
// hidden units and, as in the forward, the 3U columns of W_h that belong to
// them, J_c = [W_hr[:, U] | W_hz[:, U] | W_hn[:, U]]: read from W_h as it
// is, no transposed copy. Its gate threads (one per row and unit) compute
// da_cat for the CTA's own columns only, into shared memory. Then thread k
// (one per input unit k of the H) takes row k of the slice, W_h[k, J_c],
// and forms this CTA's part of the carry of unit k, sum over j in J_c of
// da_cat[b, j] W_h[k, j], for each row b, and adds hbar[b, k] da_cat[b, j]
// to its dW_h[k, J_c]. So da_cat never leaves the CTA; what the CTAs trade
// is the carry's parts: thread k sends its R parts to the CTA that owns
// unit k (gru_cluster.cuh: st.async counted on the receiver's mbarrier, so
// a CTA waits only for the parts it needs), and there the gate thread of
// (b, u) adds the C parts in rank order. Where 3U <= 48 and H <= 256 (the
// trainers' H 256 at C 16: 48 columns), a thread keeps W_h[k, J_c] and its
// dW_h[k, J_c] in registers for the whole scan: the TPU kernel's in-loop
// dW_h sum, in reverse t (the twin, gru_scan_bwd_plain, adds hbar.T @
// da_cat a step in the same order; its matmuls sum in another order, which
// the 1e-4 tolerance covers, as it covers the carry's sum by CTA). Else the
// slice sits in shared memory (H <= 512) or is read from L2 every step, and
// after the scan each thread sums its dW_h[k, J_c] over (t, b), again in
// reverse t, from the dxi of its own CTA (dc = da_n r, as the twin rounds
// it). The gate inputs of the next step and the hbar of the thread's unit
// are loaded while the parts are in flight.
//
// With one cluster (B <= R) this is the whole call. With several, each
// writes its dW_h and db_hn partial to scratch and `gru_partial_sum_kernel`
// adds them in cluster order.
//
// Seeds: with S seeds (NUM_SEEDS, what jax.vmap of the TPU kernel computes
// with the seed as a grid axis), W_h is (S, H, 3H) and the rows are S
// seed-major blocks of B, every (T, ., .) input (T, S B, .); dW_h comes out
// (S, H, 3H) and db_hn (S, H). The grid is S ceil(B / R) clusters, seed by
// seed: a cluster's rows never straddle two seeds, it reads only its own
// seed's W_h, and where a seed spans several clusters the partial-sum pass
// adds each seed's partials, in cluster order. With S = 1 this is the
// single-seed kernel, bit for bit. Every output has one owner and every sum a
// fixed order, without atomics, so two launches give the same bits. fp32
// FFMA on the CUDA cores, not wgmma, for the reasons in gru_scan_fwd.cu.

#include "gru_cluster.cuh"

namespace {

using namespace gru;

// columns of J_c a thread keeps in registers (ops/gru_scan.py REG_COLUMNS)
constexpr int kRegColumns = 48;
// dW_h columns a thread sums at a time after the scan
constexpr int kPost = 8;

// one (t, row, unit)'s inputs of the gate math
struct Step {
  float keep = 0.0f, hprev = 0.0f, r = 0.0f, z = 0.0f, n = 0.0f, c = 0.0f, gy = 0.0f;
};

__device__ __forceinline__ Step load_step(const float* __restrict__ keep, const float* __restrict__ hprev,
                                          const float* __restrict__ r, const float* __restrict__ z,
                                          const float* __restrict__ n, const float* __restrict__ c,
                                          const float* __restrict__ gy, int t, int Bt, int H, int b, int u) {
  const size_t row = (size_t)t * Bt + b;
  const size_t o = row * H + u;
  Step s;
  s.keep = keep[row];
  s.hprev = hprev[o];
  s.r = r[o];
  s.z = z[o];
  s.n = n[o];
  s.c = c[o];
  s.gy = gy[o];
  return s;
}

// REG: W_h[k, J_c] and dW_h[k, J_c] in registers, one input unit k a thread
// (H <= blockDim <= 256, 3 Up <= kRegColumns). RES: else the slice in shared
// memory.
template <int R, bool RES, bool REG>
__global__ void __launch_bounds__(REG ? 256 : 1024, 1)
gru_scan_bwd_kernel(const float* __restrict__ keep, const float* __restrict__ hprev,
                    const float* __restrict__ wh, const float* __restrict__ r_in,
                    const float* __restrict__ z_in, const float* __restrict__ n_in,
                    const float* __restrict__ c_in, const float* __restrict__ gy,
                    const float* __restrict__ ghT, float* __restrict__ dxi,
                    float* __restrict__ dh0, float* __restrict__ dw,
                    float* __restrict__ db, int T, int S, int B, int H, int Up) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int H3 = 3 * H;
  // this cluster's seed and rows: B a seed, Bt = S B rows a step
  const int K = (B + R - 1) / R;
  const int cid = blockIdx.x / C, seed = cid / K;
  const int lb0 = (cid - seed * K) * R;
  const int b0 = seed * B + lb0;
  const int nb = min(R, B - lb0);
  const int Bt = S * B;
  wh += (size_t)seed * H * H3;
  const int u0 = rank * Up;
  const int U = min(Up, H - u0);
  const int Wd = (3 * Up + 3) & ~3;  // a row of da_cat's own columns
  const int Ws = Wd + 4;             // a row of the slice: 4 floats apart in banks
  const int tid = threadIdx.x;
  // this cluster's dW_h and db_hn (with one cluster a seed the seed's
  // outputs, else its slot of the scratch, seed-major)
  dw += (size_t)cid * H * H3;
  db += (size_t)cid * H;

  extern __shared__ float4 smem4[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem4);  // [2]: a slot's mbarrier
  float* ws = reinterpret_cast<float*>(smem4 + 1);  // [H][Ws]: W_h[k, J_c], gate-major
  float* parts = ws + (RES && !REG ? H * Ws : 0);  // [2][C][R][Up]: the carry's parts, by sender
  float* da = parts + ((2 * C * R * Up + 3) & ~3);  // [R][Wd]: da_cat of the own columns

  if (RES && !REG) {
    for (int i = tid; i < H * Wd; i += blockDim.x) {
      const int k = i / Wd, jj = i - k * Wd, g = jj / Up, ui = jj - g * Up;
      ws[k * Ws + jj] = g < 3 && ui < U ? wh[(size_t)k * H3 + g * H + u0 + ui] : 0.0f;
    }
  }
  for (int i = tid; i < 2 * C * R * Up; i += blockDim.x) parts[i] = 0.0f;
  for (int i = tid; i < R * Wd; i += blockDim.x) da[i] = 0.0f;
  // step t: every CTA sends its parts of the carry of this CTA's U units,
  // nb rows, into slot t & 1
  const unsigned bytes = 4u * C * nb * U;
  if (tid == 0) {
    bar_init(smem_addr(&bars[0]));
    bar_init(smem_addr(&bars[1]));
    if (T > 0) bar_expect(smem_addr(&bars[(T - 1) & 1]), bytes);
    if (T > 1) bar_expect(smem_addr(&bars[T & 1]), bytes);
  }
  cluster_start();
  unsigned parity = 0;  // bit i: the phase of slot i's mbarrier to wait for

  // the gate thread of (row gb, unit gu): its inputs a step ahead, and
  // what the next step needs of this one (g z and keep[t])
  const bool gate = tid < nb * U;
  const int gb = gate ? tid / U : 0, gu = gate ? tid - gb * U : 0;
  Step pre;
  if (T > 0 && gate) pre = load_step(keep, hprev, r_in, z_in, n_in, c_in, gy, T - 1, Bt, H, b0 + gb, u0 + gu);
  float gz = 0.0f, keep_next = 0.0f, db_sum = 0.0f;

  // thread k's row of the slice and its dW_h (REG), and hbar[b, k] a step ahead
  float wreg[REG ? kRegColumns : 1], dwreg[REG ? kRegColumns : 1];
#pragma unroll
  for (int jj = 0; jj < (REG ? kRegColumns : 1); ++jj) {
    const int g = jj / Up, ui = jj - g * Up;
    wreg[jj] = REG && tid < H && g < 3 && ui < U ? wh[(size_t)tid * H3 + g * H + u0 + ui] : 0.0f;
    dwreg[jj] = 0.0f;
  }
  float hb[R];
#pragma unroll
  for (int b = 0; b < R; ++b) {
    const size_t row = (size_t)(T - 1) * Bt + b0 + b;
    hb[b] = REG && T > 0 && tid < H && b < nb ? hprev[row * H + tid] * keep[row] : 0.0f;
  }

  for (int t = T - 1; t >= 0; --t) {
    const int slot = t & 1;
    const unsigned bar = smem_addr(&bars[slot]);
    // gate math for (gb, gu): the carry from step t + 1's parts, in rank order
    if (gate) {
      float carry;
      if (t == T - 1) {
        carry = ghT[(size_t)(b0 + gb) * H + u0 + gu];
      } else {
        const float* p = parts + ((t + 1) & 1) * C * R * Up + gb * Up + gu;
        float sum = 0.0f;
        for (int src = 0; src < C; ++src) sum += p[src * R * Up];
        carry = (gz + sum) * keep_next;
      }
      const size_t row = (size_t)t * Bt + b0 + gb;
      const int u = u0 + gu;
      const float gg = carry + pre.gy;
      const float r = pre.r, z = pre.z, n = pre.n, c = pre.c;
      const float hbar = pre.hprev * pre.keep;
      const float dn = gg * (1.0f - z);
      const float dz = gg * (hbar - n);
      const float da_n = dn * (1.0f - n * n);
      const float dr = da_n * c;
      const float dc = da_n * r;
      const float da_r = dr * r * (1.0f - r);
      const float da_z = dz * z * (1.0f - z);
      float* d = da + gb * Wd + gu;
      d[0] = da_r;
      d[Up] = da_z;
      d[2 * Up] = dc;
      float* dx = dxi + row * H3;
      dx[u] = da_r;
      dx[H + u] = da_z;
      dx[2 * H + u] = da_n;
      gz = gg * z;
      keep_next = pre.keep;
      if (t > 0) pre = load_step(keep, hprev, r_in, z_in, n_in, c_in, gy, t - 1, Bt, H, b0 + gb, u);
    }
    __syncthreads();
    // db_hn[u] += the sum over rows b, in order
    if (tid < U) {
      float sum = 0.0f;
      for (int b = 0; b < nb; ++b) sum += da[b * Wd + 2 * Up + tid];
      db_sum += sum;
    }
    // thread k: this CTA's parts of unit k's carry, sent to k's owner, and
    // the dW_h term of row k
    for (int k = tid; k < H; k += blockDim.x) {
      float p[R];
#pragma unroll
      for (int b = 0; b < R; ++b) p[b] = 0.0f;
      if (REG) {
#pragma unroll
        for (int jq = 0; jq < kRegColumns / 4; ++jq) {
          if (4 * jq < 3 * Up) {
            float tmp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int b = 0; b < R; ++b) {
              const float4 dv = *reinterpret_cast<const float4*>(da + b * Wd + 4 * jq);
              const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                p[b] = fmaf(dd[e], wreg[4 * jq + e], p[b]);
                tmp[e] = fmaf(hb[b], dd[e], tmp[e]);
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) dwreg[4 * jq + e] += tmp[e];
          }
        }
      } else {
        const float* wrow = ws + k * Ws;
        for (int jj = 0; jj < 3 * Up; jj += 4) {
          float w[4];
          if (RES) {
            const float4 wv = *reinterpret_cast<const float4*>(wrow + jj);
            w[0] = wv.x, w[1] = wv.y, w[2] = wv.z, w[3] = wv.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int g = (jj + e) / Up, ui = jj + e - g * Up;
              w[e] = g < 3 && ui < U ? __ldg(wh + (size_t)k * H3 + g * H + u0 + ui) : 0.0f;
            }
          }
#pragma unroll
          for (int b = 0; b < R; ++b) {
            const float4 dv = *reinterpret_cast<const float4*>(da + b * Wd + jj);
            p[b] = fmaf(dv.w, w[3], fmaf(dv.z, w[2], fmaf(dv.y, w[1], fmaf(dv.x, w[0], p[b]))));
          }
        }
      }
      // to slot t of unit k's owner, at [this rank][b][k's place there]
      const int owner = k / Up;
      const unsigned dst = smem_addr(parts + slot * C * R * Up + rank * R * Up + (k - owner * Up));
      const unsigned rdst = cluster_addr(dst, owner), rbar = cluster_addr(bar, owner);
      for (int b = 0; b < nb; ++b) st_async(rdst + 4u * b * Up, p[b], rbar);
    }
    // while the parts are in flight: hbar of the next step for thread k
    if (REG && t > 0 && tid < H) {
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const size_t row = (size_t)(t - 1) * Bt + b0 + b;
        hb[b] = b < nb ? hprev[row * H + tid] * keep[row] : 0.0f;
      }
    }
    bar_wait(bar, (parity >> slot) & 1);
    parity ^= 1u << slot;
    __syncthreads();
    // re-arm the slot for step t - 2's parts
    if (tid == 0 && t >= 2) bar_expect(bar, bytes);
  }

  // dh0: the carry after step 0
  if (gate && T > 0) {
    const float* p = parts + gb * Up + gu;
    float sum = 0.0f;
    for (int src = 0; src < C; ++src) sum += p[src * R * Up];
    dh0[(size_t)(b0 + gb) * H + u0 + gu] = (gz + sum) * keep_next;
  } else if (gate) {
    dh0[(size_t)(b0 + gb) * H + u0 + gu] = ghT[(size_t)(b0 + gb) * H + u0 + gu];
  }
  if (tid < U) db[u0 + tid] = db_sum;
  if (REG) {
    if (tid < H) {
#pragma unroll
      for (int jj = 0; jj < kRegColumns; ++jj) {
        const int g = jj / Up, ui = jj - g * Up;
        if (g < 3 && ui < U) dw[(size_t)tid * H3 + g * H + u0 + ui] = dwreg[jj];
      }
    }
  } else {
    // dW_h[k, J_c] = sum over t (reverse) of sum over b of hbar[t, b, k]
    // da_cat[t, b, J_c], from this CTA's dxi (the block barrier of the last
    // step has made it visible); kPost columns at a time
    for (int k = tid; k < H; k += blockDim.x) {
      for (int j0 = 0; j0 < 3 * U; j0 += kPost) {
        float acc[kPost];
#pragma unroll
        for (int m = 0; m < kPost; ++m) acc[m] = 0.0f;
#pragma unroll 4
        for (int t = T - 1; t >= 0; --t) {
          float tmp[kPost];
#pragma unroll
          for (int m = 0; m < kPost; ++m) tmp[m] = 0.0f;
          for (int b = 0; b < nb; ++b) {
            const size_t row = (size_t)t * Bt + b0 + b;
            const float hbk = hprev[row * H + k] * keep[row];
#pragma unroll
            for (int m = 0; m < kPost; ++m) {
              if (j0 + m < 3 * U) {
                const int g = (j0 + m) / U, u = u0 + j0 + m - g * U;
                float d = dxi[row * H3 + g * H + u];
                if (g == 2) d *= r_in[row * H + u];
                tmp[m] = fmaf(hbk, d, tmp[m]);
              }
            }
          }
#pragma unroll
          for (int m = 0; m < kPost; ++m) acc[m] += tmp[m];
        }
#pragma unroll
        for (int m = 0; m < kPost; ++m) {
          if (j0 + m < 3 * U) {
            const int g = (j0 + m) / U, u = u0 + j0 + m - g * U;
            dw[(size_t)k * H3 + g * H + u] = acc[m];
          }
        }
      }
    }
  }
}

// out[s, i] = sum over a seed's clusters k, in order, of part[s, k, i]:
// part (S, clusters, n), out (S, n), total = S n
__global__ void gru_partial_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                       int n, int total, int clusters) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= total) return;
  const int seed = j / n, i = j - seed * n;
  const float* p = part + (size_t)seed * clusters * n;
  float s = p[i];
  for (int k = 1; k < clusters; ++k) s += p[(size_t)k * n + i];
  out[j] = s;
}

template <int R, bool RES, bool REG>
int launch(const float* keep, const float* hprev, const float* wh, const float* r,
           const float* z, const float* n, const float* c, const float* gy,
           const float* ghT, float* dxi, float* dh0, float* dw, float* db, int T,
           int S, int B, int H, int C, int Up, int threads, int smem, cudaStream_t s) {
  return launch_clusters(gru_scan_bwd_kernel<R, RES, REG>, C, S * ((B + R - 1) / R), threads, smem, s,
                         keep, hprev, wh, r, z, n, c, gy, ghT, dxi, dh0, dw, db, T, S, B, H, Up);
}

template <bool RES, bool REG>
int launch_rows(const float* keep, const float* hprev, const float* wh, const float* r,
                const float* z, const float* n, const float* c, const float* gy,
                const float* ghT, float* dxi, float* dh0, float* dw, float* db, int T,
                int S, int B, int H, int C, int Up, int R, int threads, int smem, cudaStream_t s) {
  switch (R) {
    case 1: return launch<1, RES, REG>(keep, hprev, wh, r, z, n, c, gy, ghT, dxi, dh0, dw, db, T, S, B, H, C, Up, threads, smem, s);
    case 2: return launch<2, RES, REG>(keep, hprev, wh, r, z, n, c, gy, ghT, dxi, dh0, dw, db, T, S, B, H, C, Up, threads, smem, s);
    case 4: return launch<4, RES, REG>(keep, hprev, wh, r, z, n, c, gy, ghT, dxi, dh0, dw, db, T, S, B, H, C, Up, threads, smem, s);
    case 8: return launch<8, RES, REG>(keep, hprev, wh, r, z, n, c, gy, ghT, dxi, dh0, dw, db, T, S, B, H, C, Up, threads, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// how many clusters of the <R, RES, REG> instance the card places at once
template <bool RES, bool REG>
int active_rows(int R, int C, int threads, int smem) {
  switch (R) {
    case 1: return active_clusters(gru_scan_bwd_kernel<1, RES, REG>, C, threads, smem);
    case 2: return active_clusters(gru_scan_bwd_kernel<2, RES, REG>, C, threads, smem);
    case 4: return active_clusters(gru_scan_bwd_kernel<4, RES, REG>, C, threads, smem);
    case 8: return active_clusters(gru_scan_bwd_kernel<8, RES, REG>, C, threads, smem);
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// keep (T, S B, 1), hprev, r, z, n, c, gy (T, S B, H), wh (S, H, 3H), ghT
// (S B, H) in; dxi (T, S B, 3H), dh0 (S B, H), dw (S, H, 3H) = dW_h and db
// (S, H) = db_hn out; all float32 and contiguous; S seeds of B rows each
// (S = 1: wh and dw (H, 3H), db (H,)). With more than one cluster a seed
// (ceil(B / rows) > 1) dw_part (S, clusters, H, 3H) and db_part (S,
// clusters, H) are the scratch for the clusters' partial sums, else unused. The plan (cluster C,
// units per CTA, rows R, threads per CTA, resident, dW_h in registers,
// shared bytes per CTA) comes from ops/gru_scan.py:scan_plan. Launches on
// `stream`; returns a cudaError_t (0 on success).
int gru_scan_bwd_f32(const float* keep, const float* hprev, const float* wh,
                     const float* r, const float* z, const float* n,
                     const float* c, const float* gy, const float* ghT,
                     float* dxi, float* dh0, float* dw, float* db, float* dw_part,
                     float* db_part, int T, int S, int B, int H, int cluster, int units,
                     int rows, int threads, int resident, int dw_in_loop,
                     int smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (S < 1) return (int)cudaErrorInvalidValue;
  const int clusters = (B + rows - 1) / rows;
  float* dw_out = clusters > 1 ? dw_part : dw;
  float* db_out = clusters > 1 ? db_part : db;
  // every gate thread and (with dW_h in registers) every input unit has its
  // thread: the registers' kernel takes H <= threads <= 256 and 3 units <=
  // kRegColumns
  if (threads < rows * units || (dw_in_loop && (threads < H || threads > 256 || 3 * units > kRegColumns)))
    return (int)cudaErrorInvalidValue;
  int err;
  if (dw_in_loop)
    err = launch_rows<false, true>(keep, hprev, wh, r, z, n, c, gy, ghT, dxi, dh0, dw_out, db_out,
                                   T, S, B, H, cluster, units, rows, threads, smem_bytes, s);
  else if (resident)
    err = launch_rows<true, false>(keep, hprev, wh, r, z, n, c, gy, ghT, dxi, dh0, dw_out, db_out,
                                   T, S, B, H, cluster, units, rows, threads, smem_bytes, s);
  else
    err = launch_rows<false, false>(keep, hprev, wh, r, z, n, c, gy, ghT, dxi, dh0, dw_out, db_out,
                                    T, S, B, H, cluster, units, rows, threads, smem_bytes, s);
  if (err != 0 || clusters == 1) return err;
  const int nw = H * 3 * H;
  gru_partial_sum_kernel<<<(S * nw + 255) / 256, 256, 0, s>>>(dw_part, dw, nw, S * nw, clusters);
  gru_partial_sum_kernel<<<(S * H + 255) / 256, 256, 0, s>>>(db_part, db, H, S * H, clusters);
  return (int)cudaGetLastError();
}

// How many clusters of the plan (ops/gru_scan.py:scan_plan) the card
// places at once (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
int gru_scan_bwd_active_clusters(int cluster, int rows, int threads, int resident, int dw_in_loop,
                                   int smem_bytes) {
  if (dw_in_loop) return active_rows<false, true>(rows, cluster, threads, smem_bytes);
  if (resident) return active_rows<true, false>(rows, cluster, threads, smem_bytes);
  return active_rows<false, false>(rows, cluster, threads, smem_bytes);
}

const char* gru_scan_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
