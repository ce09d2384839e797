// Q(lambda) returns: the reverse recurrence of purejaxql_tpu/algo/returns.py
// over (T, E), in its two forms. The gymnax form (returns.py:26-64) seeds the
// carry with next_q = last_q * (1 - d[T-1]) and lam_ret = r[T-1] + gamma *
// next_q; the closure form (returns.py:67-99, the recurrent trainer's
// targets) with lam_ret = r[T-1] + (gamma * (1 - d[T-1])) * last_q and
// next_q = max_qs[T-1]. Both then run the step of the TPU kernel
// (pallas_returns.py:36-44) for t = T-2 ... 0.
//
// Replaces: purejaxql_tpu/ops/pallas_returns.py `_lambda_kernel` (called by
// `lambda_returns_pallas`), which keeps the (T, E) operands in VMEM and
// pads E to 128 lanes; and, for the closure form, the XLA scan of
// returns.py:67. Here a ragged E is masked instead of padded.
//
// Bound on an H100: 3 reads and 1 write of T*E floats plus last_q (E
// floats), at 3.35 TB/s, and about ten flops an element: 0.010 us at the
// CartPole trainer's (T 64, E 32), 0.020 us at MinAtar's (32, 128). The
// kernel is bound by latency: the launch, the first load, and T - 1
// dependent steps of about five rounded float operations each.
//
// What held the earlier design back: one thread an env read rewards, dones
// and max_qs from device memory inside the loop over t (the compiler
// issuing at most eight steps' loads ahead) and stored each step's return
// behind a branch: ~120 cycles a step (scripts/time_device.py, its device
// times at T 64 and T 32). Staging the operands in shared memory alone did
// not help: a first staged version kept a branch, a reconvergence and a
// fresh read of the thread index around every store, and took ~140-160
// cycles a step (scripts/probe_returns.py). Here a step is ~35.
//
// Design: a block takes a tile of `tile` envs (a power of two, at most 32);
// warp 0 runs the chain, one lane an env, in chunks of 16 steps, latest
// first. It loads chunk 0 (and last_q) straight from device memory into
// registers at the kernel's entry, so that the round trip overlaps the
// setup. Later chunks stream through shared memory in a ring of `stages`
// slots: warps 1-4 are loaders, every loader thread issues its share of a
// chunk's copies with cp.async (16 bytes where E is a multiple of 4 and the
// rows are aligned, else 4) and the slot's mbarrier counts their completion
// (cp.async.mbarrier.arrive.noinc); up to four chunks are in flight, and a
// slot is refilled once the chain has released it. The chain reads a
// chunk's 48 values into registers in the same block as the scan that uses
// them, so the reads overlap its first steps; each step is the five
// dependent rounded operations of the recurrence and a predicated store of
// its return (no branch), a coalesced row of the tile that nothing waits
// for. A long T streams through the ring; a ragged E is masked (lanes past
// the last env compute on the last env's column and store nothing); a
// large E spreads over ceil(E / tile) blocks.
//
// Each operation is rounded on its own (no fused multiply-add), in the
// order of the plain twins in ops/lambda_returns.py, so the two agree to
// the last bit; there is no parallel scan over T, which would reassociate
// the sums. The launch plan is ops/lambda_returns.py `lambda_plan`; its
// shared bytes are `smem_bytes` below.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 160;        // the chain warp and four loader warps
constexpr int kLoaders = kThreads - 32;
constexpr int kMaxTile = 32;
constexpr int kChunk = 16;           // steps a slot holds (ops/lambda_returns.py CHUNK)

// Bytes of dynamic shared memory a block takes (ops/lambda_returns.py
// lambda_smem_bytes): a full and an empty mbarrier a slot (16), then each
// slot's chunk of rewards, dones and max_qs (3 x kChunk x tile floats).
__host__ __device__ inline int smem_bytes(int tile, int stages) {
  return 16 * stages + 12 * stages * kChunk * tile;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void copy4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void copy16(unsigned dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(dst), "l"(src) : "memory");
}

// one arrival on `bar` once every copy this thread has issued so far has landed
__device__ __forceinline__ void arrive_on_copies(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" :: "r"(bar) : "memory");
}

// v to *p where ok, as a predicated store: no branch, no reconvergence
__device__ __forceinline__ void store_if(float* p, float v, int ok) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p st.global.f32 [%0], %1;\n}\n"
               :: "l"(p), "f"(v), "r"(ok) : "memory");
}

// The chain through one chunk, latest step first: row i of r, d and q is
// step t = hi - 1 - i, whose return goes to dst - i E where the row is one
// of the chunk's `rows` (the rows past a short last chunk hold nothing of
// use and are scanned but never stored) and the lane's env is live. With
// kSeed, row 0 is step T - 1 and seeds the carry (lam_ret, next_q) in the
// form's way; every other row is one step of the TPU kernel's recurrence.
template <bool kClosure, bool kSeed>
__device__ __forceinline__ void scan_chunk(const float (&r)[kChunk], const float (&d)[kChunk],
                                           const float (&q)[kChunk], float& lam_ret, float& next_q, float lq,
                                           float gamma, float gamma_lam, float* dst, int E, int rows, int live) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (kSeed && i == 0) {
      if (kClosure) {
        lam_ret = __fadd_rn(r[0], __fmul_rn(__fmul_rn(gamma, __fsub_rn(1.0f, d[0])), lq));
        next_q = q[0];
      } else {
        next_q = __fmul_rn(lq, __fsub_rn(1.0f, d[0]));
        lam_ret = __fadd_rn(r[0], __fmul_rn(gamma, next_q));
      }
    } else {
      const float not_done = __fsub_rn(1.0f, d[i]);
      const float target_bootstrap = __fadd_rn(r[i], __fmul_rn(__fmul_rn(gamma, not_done), next_q));
      const float delta = __fsub_rn(lam_ret, next_q);
      lam_ret = __fadd_rn(target_bootstrap, __fmul_rn(gamma_lam, delta));
      lam_ret = __fadd_rn(__fmul_rn(not_done, lam_ret), __fmul_rn(d[i], r[i]));
      next_q = q[i];
    }
    store_if(dst, lam_ret, live & (i < rows));
    dst -= E;
  }
}

template <bool kClosure>
__global__ void __launch_bounds__(kThreads)
lambda_returns_kernel(const float* __restrict__ last_q, const float* __restrict__ rewards,
                      const float* __restrict__ dones, const float* __restrict__ max_qs,
                      float* __restrict__ out, int T, int E, float gamma, float gamma_lam, int tile,
                      int stages, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + stages;
  float* data = reinterpret_cast<float*>(smem + 16 * stages);
  const int plane = kChunk * tile;  // floats of one operand in a slot
  const int e0 = blockIdx.x * tile;
  const int valid = min(tile, E - e0);
  const int chunks = (T + kChunk - 1) / kChunk;
  const int lane = threadIdx.x;
  const int col = min(lane, valid - 1);  // the chain's column: lanes past the last env take its column

  // Chunk k holds steps T - 1 - 16 k down to T - 16 (k + 1) (not below 0):
  // row i is step T - 1 - 16 k - i. The chain warp loads chunk 0 itself,
  // straight into registers, before the mbarriers are even set up; chunk
  // k > 0 comes through slot (k - 1) % stages, for each operand a plane of
  // 16 rows of `tile` floats, its mbarriers in their phase (k - 1) / stages.
  float r0[kChunk], d0[kChunk], q0[kChunk], lq = 0.0f;
  if (threadIdx.x < 32) {
    lq = last_q[e0 + col];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const long at = (long)max(T - 1 - i, 0) * E + e0 + col;  // rows past step 0 repeat it
      r0[i] = rewards[at];
      d0[i] = dones[at];
      q0[i] = max_qs[at];
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(smem_addr(&full[s]), kLoaders);
      bar_init(smem_addr(&empty[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32) {
    // ---- loaders: every loader thread its share of chunk k's copies, once
    // the chain has released the slot's previous chunk
    const int lt = threadIdx.x - 32;
    const int row_shift = __ffs(tile) - 1 - (vec ? 2 : 0);  // copies a row: 1 << row_shift
    int s = 0;
    unsigned phase = 0;
    for (int k = 1; k < chunks; ++k) {
      if (k > stages) bar_wait(smem_addr(&empty[s]), phase ^ 1);
      const int hi = T - k * kChunk, rows = min(hi, kChunk);
      float* slot = data + 3 * s * plane;
#pragma unroll 1
      for (int i = lt; i < (3 * kChunk) << row_shift; i += kLoaders) {
        const int a = i >> (row_shift + 4), row = (i >> row_shift) & (kChunk - 1);
        const int c = (i & ((1 << row_shift) - 1)) << (vec ? 2 : 0);
        if (row < rows && c < valid) {
          const float* src = (a == 0 ? rewards : a == 1 ? dones : max_qs) + (long)(hi - 1 - row) * E + e0 + c;
          const unsigned dst = smem_addr(slot + a * plane + row * tile + c);
          if (vec) {
            copy16(dst, src);
          } else {
            copy4(dst, src);
          }
        }
      }
      arrive_on_copies(smem_addr(&full[s]));
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // ---- the chain warp: one lane an env, latest step first
  const int live = lane < valid;
  float lam_ret, next_q;
  float* dst = out + (long)(T - 1) * E + e0 + lane;  // step T - 1 - i at dst - i E
  scan_chunk<kClosure, true>(r0, d0, q0, lam_ret, next_q, lq, gamma, gamma_lam, dst, E, min(T, kChunk), live);
  int s = 0;
  unsigned phase = 0;
  for (int k = 1; k < chunks; ++k) {
    // the chunk from its slot into registers at once, the loads in one
    // block with the scan that uses them
    bar_wait(smem_addr(&full[s]), phase);
    const float* src = data + 3 * s * plane + col;
    float r[kChunk], d[kChunk], q[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      r[i] = src[i * tile];
      d[i] = src[plane + i * tile];
      q[i] = src[2 * plane + i * tile];
    }
    const int hi = T - k * kChunk;
    dst = out + (long)(hi - 1) * E + e0 + lane;
    scan_chunk<kClosure, false>(r, d, q, lam_ret, next_q, lq, gamma, gamma_lam, dst, E, min(hi, kChunk), live);
    // every value read from the slot has been used: the slot back to the loaders
    __syncwarp();
    if (lane == 0) bar_arrive(smem_addr(&empty[s]));
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
}

template <bool kClosure>
int launch(const float* last_q, const float* rewards, const float* dones, const float* max_qs, float* out,
           int T, int E, float gamma, float gamma_lam, int tile, int stages, int smem, cudaStream_t stream) {
  // an error an earlier call returned is not this call's (each library links
  // its own runtime, so nothing else clears it)
  (void)cudaGetLastError();
  // a ring of at least one slot where there is more than chunk 0
  if (T < 1 || E < 1 || tile < 1 || tile > kMaxTile || (tile & (tile - 1)) || stages < (T > kChunk ? 1 : 0) ||
      smem < smem_bytes(tile, stages))
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const float* p) { return ((unsigned long long)p & 15) == 0; };
  const int vec = E % 4 == 0 && tile % 4 == 0 && aligned(rewards) && aligned(dones) && aligned(max_qs);
  const int blocks = (E + tile - 1) / tile;
  lambda_returns_kernel<kClosure><<<blocks, kThreads, smem, stream>>>(last_q, rewards, dones, max_qs, out, T, E,
                                                                      gamma, gamma_lam, tile, stages, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` with the plan's tile, stages and
// shared bytes, and return the launch's cudaError_t (0 on success).
int lambda_returns_f32(const float* last_q, const float* rewards, const float* dones, const float* max_qs,
                       float* out, int T, int E, float gamma, float gamma_lam, int tile, int stages, int smem,
                       void* stream) {
  return launch<false>(last_q, rewards, dones, max_qs, out, T, E, gamma, gamma_lam, tile, stages, smem,
                       (cudaStream_t)stream);
}

int lambda_returns_closure_f32(const float* last_q, const float* rewards, const float* dones,
                               const float* max_qs, float* out, int T, int E, float gamma, float gamma_lam,
                               int tile, int stages, int smem, void* stream) {
  return launch<true>(last_q, rewards, dones, max_qs, out, T, E, gamma, gamma_lam, tile, stages, smem,
                      (cudaStream_t)stream);
}

const char* lambda_returns_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
