// GRU time scan, backward: the reverse-time recurrence of one GRU layer's
// gradients, and the weight gradients it accumulates, in two launches from
// one call.
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
// then dh0 = carry, dW_h = sum_t hbar^T da_cat and db_hn = sum_t,b dc.
//
// Bound on an H100: per step two (B, H) x (H, 3H)-sized products (the carry
// and the dW_h term) and the gate math; the bytes are the seven (T, B, H)
// inputs, dxi and W_h and dW_h once: a few microseconds of either roof at
// the trainers' shapes. Like the forward it is bound by latency: T dependent
// steps, each an L2 read of all of W_h and three barriers.
//
// Design: launch 1 (the scan) runs one block per group of R <= 8 batch rows
// with min(3H, 1024) threads. Phase A, one thread per (row, unit), does the
// gate math, writes dxi and dc (dc into scratch) and keeps g z and da_cat in
// shared memory. Phase B splits the 3H-long sum of da_cat W_h^T into S
// segments (3 at H 256, one thread per (segment, unit)) over a transposed
// copy of W_h, (3H, H), that the wrapper makes, so neighbouring threads read
// neighbouring addresses; phase C adds the segments in order and masks the
// carry. Launch 2 is a tiled reduction over the T*B rows: out[k, j] =
// sum_n A[n, k] D[n, j] with A = [hbar, 1] and D = [da_r, da_z, dc] read back
// from dxi and the dc scratch, so row H of the (H + 1, 3H) output holds the
// column sums, of which the last H are db_hn. Every output has one owner and
// sums in a fixed order, without atomics, so runs repeat bit for bit. The
// TPU kernel accumulates dW_h in its loop; here the scan stays short and the
// weight gradient is one pass with all of the card's blocks.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;

template <int R>
__global__ void __launch_bounds__(1024)
gru_scan_bwd_kernel(const float* __restrict__ keep, const float* __restrict__ hprev,
                    const float* __restrict__ wht, const float* __restrict__ r_in,
                    const float* __restrict__ z_in, const float* __restrict__ n_in,
                    const float* __restrict__ c_in, const float* __restrict__ gy,
                    const float* __restrict__ ghT, float* __restrict__ dxi,
                    float* __restrict__ dh0, float* __restrict__ dc_out, int T,
                    int B, int H, int S) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  float* g = smem;               // [R][H]: the carry, then g z
  float* da = g + R * H;         // [R][3H]: da_cat
  float* part = da + R * H3;     // [S][R][H]: segment sums of da_cat W_h^T
  const int b0 = blockIdx.x * R;
  const int nb = min(R, B - b0);
  const int L = (H3 + S - 1) / S;

  for (int i = threadIdx.x; i < R * H; i += blockDim.x) {
    const int b = i / H, u = i - b * H;
    g[i] = b < nb ? ghT[(size_t)(b0 + b) * H + u] : 0.0f;
  }
  for (int i = threadIdx.x; i < R * H3; i += blockDim.x) da[i] = 0.0f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
      const int b = i / H, u = i - b * H;
      const size_t row = (size_t)t * B + b0 + b;
      const size_t o = row * H + u;
      const float gg = g[i] + gy[o];
      const float r = r_in[o], z = z_in[o], n = n_in[o], c = c_in[o];
      const float hbar = hprev[o] * keep[row];
      const float dn = gg * (1.0f - z);
      const float dz = gg * (hbar - n);
      const float da_n = dn * (1.0f - n * n);
      const float dr = da_n * c;
      const float dc = da_n * r;
      const float da_r = dr * r * (1.0f - r);
      const float da_z = dz * z * (1.0f - z);
      float* d = da + b * H3;
      d[u] = da_r;
      d[H + u] = da_z;
      d[2 * H + u] = dc;
      float* dx = dxi + row * H3;
      dx[u] = da_r;
      dx[H + u] = da_z;
      dx[2 * H + u] = da_n;
      dc_out[o] = dc;
      g[i] = gg * z;
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < S * H; idx += blockDim.x) {
      const int seg = idx / H, k = idx - seg * H;
      const int jlo = seg * L, jhi = min(H3, jlo + L);
      float acc[R];
#pragma unroll
      for (int b = 0; b < R; ++b) acc[b] = 0.0f;
#pragma unroll 8
      for (int j = jlo; j < jhi; ++j) {
        const float w = __ldg(wht + (size_t)j * H + k);
#pragma unroll
        for (int b = 0; b < R; ++b) acc[b] = fmaf(da[b * H3 + j], w, acc[b]);
      }
#pragma unroll
      for (int b = 0; b < R; ++b) part[(seg * R + b) * H + k] = acc[b];
    }
    __syncthreads();

    for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
      const int b = i / H, u = i - b * H;
      float s = part[b * H + u];
      for (int seg = 1; seg < S; ++seg) s += part[(seg * R + b) * H + u];
      g[i] = (g[i] + s) * keep[(size_t)t * B + b0 + b];
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
    const int b = i / H, u = i - b * H;
    dh0[(size_t)(b0 + b) * H + u] = g[i];
  }
}

// out (H + 1, 3H): out[k, j] = sum over the N = T*B rows n, in order, of
// A[n, k] D[n, j], with A[n, k] = hprev[n, k] keep[n] (k < H) or 1 (k = H),
// and D[n, j] = dxi[n, j] (j < 2H, da_r and da_z) or dc[n, j - 2H].
__global__ void gru_weight_grad_kernel(const float* __restrict__ keep,
                                       const float* __restrict__ hprev,
                                       const float* __restrict__ dxi,
                                       const float* __restrict__ dc,
                                       float* __restrict__ out, int N, int H) {
  __shared__ float As[kTile][kTile + 1];
  __shared__ float Ds[kTile][kTile + 1];
  const int H3 = 3 * H;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile;
  float acc = 0.0f;
  for (int n0 = 0; n0 < N; n0 += kTile) {
    const int n = n0 + ty;
    float a = 0.0f, d = 0.0f;
    if (n < N) {
      const int k = k0 + tx;
      if (k < H) a = hprev[(size_t)n * H + k] * keep[n];
      else if (k == H) a = 1.0f;
      const int j = j0 + tx;
      if (j < 2 * H) d = dxi[(size_t)n * H3 + j];
      else if (j < H3) d = dc[(size_t)n * H + j - 2 * H];
    }
    As[ty][tx] = a;
    Ds[ty][tx] = d;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTile; ++i) acc = fmaf(As[i][ty], Ds[i][tx], acc);
    __syncthreads();
  }
  const int k = k0 + ty, j = j0 + tx;
  if (k <= H && j < H3) out[(size_t)k * H3 + j] = acc;
}

template <int R>
int launch_scan(const float* keep, const float* hprev, const float* wht,
                const float* r, const float* z, const float* n, const float* c,
                const float* gy, const float* ghT, float* dxi, float* dh0,
                float* dc, int T, int B, int H, cudaStream_t stream) {
  const int threads = 3 * H < 1024 ? (3 * H + 31) / 32 * 32 : 1024;
  // segments of the 3H-long sum: one thread per (segment, unit), at most 3
  const int S = threads / H >= 3 ? 3 : (threads / H >= 1 ? threads / H : 1);
  const size_t smem = (size_t)R * H * (4 + S) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gru_scan_bwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + R - 1) / R;
  gru_scan_bwd_kernel<R><<<blocks, threads, smem, stream>>>(
      keep, hprev, wht, r, z, n, c, gy, ghT, dxi, dh0, dc, T, B, H, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// keep (T, B, 1), hprev, r, z, n, c, gy (T, B, H), wht (3H, H) = W_h^T,
// ghT (B, H) in; dxi (T, B, 3H), dh0 (B, H), the scratch dc (T, B, H) and
// dwb (H + 1, 3H) out, dwb[:H] = dW_h and dwb[H, 2H:] = db_hn; all float32
// and contiguous. Launches both kernels on `stream`; returns a cudaError_t
// (0 on success).
int gru_scan_bwd_f32(const float* keep, const float* hprev, const float* wht,
                     const float* r, const float* z, const float* n,
                     const float* c, const float* gy, const float* ghT,
                     float* dxi, float* dh0, float* dc, float* dwb, int T,
                     int B, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (B <= 1) err = launch_scan<1>(keep, hprev, wht, r, z, n, c, gy, ghT, dxi, dh0, dc, T, B, H, s);
  else if (B <= 2) err = launch_scan<2>(keep, hprev, wht, r, z, n, c, gy, ghT, dxi, dh0, dc, T, B, H, s);
  else if (B <= 4) err = launch_scan<4>(keep, hprev, wht, r, z, n, c, gy, ghT, dxi, dh0, dc, T, B, H, s);
  else err = launch_scan<8>(keep, hprev, wht, r, z, n, c, gy, ghT, dxi, dh0, dc, T, B, H, s);
  if (err != 0) return err;
  const dim3 grid((3 * H + kTile - 1) / kTile, (H + 1 + kTile - 1) / kTile);
  gru_weight_grad_kernel<<<grid, dim3(kTile, kTile), 0, s>>>(keep, hprev, dxi, dc, dwb, T * B, H);
  return (int)cudaGetLastError();
}

const char* gru_scan_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
