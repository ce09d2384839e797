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
// either roof. The kernel is bound by latency instead: T dependent steps,
// each an L2 read of all of W_h (768 KiB at H 256, too large for shared
// memory) followed by two barriers.
//
// Design: one block per group of R <= 8 batch rows (B 2 at full width: one
// block of 2 rows), min(3H, 1024) threads. The reset carry hbar of the block's
// rows and the product hh live in shared memory. Thread j computes column j
// of hh for all R rows at once, so W_h is read once per step per block, not
// once per row, and neighbouring threads read neighbouring addresses of a
// row of W_h. After a barrier, one thread per (row, unit) does the gate math
// and writes h' * keep[t + 1] back as the next step's hbar; a second barrier
// ends the step. Later work: keep W_h in a cluster's shared memory, wgmma,
// several rows of the product per warp.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

template <int R>
__global__ void __launch_bounds__(1024)
gru_scan_fwd_kernel(const float* __restrict__ xi, const float* __restrict__ keep,
                    const float* __restrict__ h0, const float* __restrict__ wh,
                    const float* __restrict__ bhn, float* __restrict__ y,
                    float* __restrict__ r_out, float* __restrict__ z_out,
                    float* __restrict__ n_out, float* __restrict__ c_out,
                    int T, int B, int H) {
  extern __shared__ float smem[];
  float* hs = smem;           // [R][H]: the reset carry hbar of this step
  float* hh = smem + R * H;   // [R][3H]: hbar W_h
  const int H3 = 3 * H;
  const int b0 = blockIdx.x * R;
  const int nb = min(R, B - b0);

  for (int i = threadIdx.x; i < R * H; i += blockDim.x) {
    const int b = i / H, u = i - b * H;
    hs[i] = b < nb ? h0[(size_t)(b0 + b) * H + u] * keep[b0 + b] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int j = threadIdx.x; j < H3; j += blockDim.x) {
      float acc[R];
#pragma unroll
      for (int b = 0; b < R; ++b) acc[b] = 0.0f;
      const float* wcol = wh + j;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float w = __ldg(wcol + (size_t)k * H3);
#pragma unroll
        for (int b = 0; b < R; ++b) acc[b] = fmaf(hs[b * H + k], w, acc[b]);
      }
#pragma unroll
      for (int b = 0; b < R; ++b) hh[b * H3 + j] = acc[b];
    }
    __syncthreads();

    for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
      const int b = i / H, u = i - b * H;
      const size_t row = (size_t)t * B + b0 + b;
      const float* x = xi + row * H3;
      const float* a = hh + b * H3;
      const float r = sigmoidf(x[u] + a[u]);
      const float z = sigmoidf(x[H + u] + a[H + u]);
      const float c = a[2 * H + u] + bhn[u];
      const float n = tanhf(x[2 * H + u] + r * c);
      const float h_new = (1.0f - z) * n + z * hs[b * H + u];
      const size_t o = row * H + u;
      y[o] = h_new;
      r_out[o] = r;
      z_out[o] = z;
      n_out[o] = n;
      c_out[o] = c;
      if (t + 1 < T) hs[b * H + u] = h_new * keep[row + B];
    }
    __syncthreads();
  }
}

template <int R>
int launch(const float* xi, const float* keep, const float* h0, const float* wh,
           const float* bhn, float* y, float* r, float* z, float* n, float* c,
           int T, int B, int H, cudaStream_t stream) {
  const size_t smem = (size_t)4 * R * H * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gru_scan_fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 3 * H < 1024 ? (3 * H + 31) / 32 * 32 : 1024;
  const int blocks = (B + R - 1) / R;
  gru_scan_fwd_kernel<R><<<blocks, threads, smem, stream>>>(
      xi, keep, h0, wh, bhn, y, r, z, n, c, T, B, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xi (T, B, 3H), keep (T, B, 1), h0 (B, H), wh (H, 3H), bhn (H,) in; y, r,
// z, n, c (T, B, H) out; all float32 and contiguous. Launches on `stream`;
// returns a cudaError_t (0 on success).
int gru_scan_fwd_f32(const float* xi, const float* keep, const float* h0,
                     const float* wh, const float* bhn, float* y, float* r,
                     float* z, float* n, float* c, int T, int B, int H,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 1) return launch<1>(xi, keep, h0, wh, bhn, y, r, z, n, c, T, B, H, s);
  if (B <= 2) return launch<2>(xi, keep, h0, wh, bhn, y, r, z, n, c, T, B, H, s);
  if (B <= 4) return launch<4>(xi, keep, h0, wh, bhn, y, r, z, n, c, T, B, H, s);
  return launch<8>(xi, keep, h0, wh, bhn, y, r, z, n, c, T, B, H, s);
}

const char* gru_scan_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
