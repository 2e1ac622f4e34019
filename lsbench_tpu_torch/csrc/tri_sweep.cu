// One sparse triangular sweep in one launch, for NVIDIA Hopper (sm_90a),
// bound to Python with ctypes (lsbench_tpu_torch/ops/_cuda.py builds this
// file with nvcc; the wrapper and its plain PyTorch version are in
// lsbench_tpu_torch/ops/tri_sweep.py).
//
//   tri_sweep_f32 / tri_sweep_f64 compute one sweep of
//   lsbench_tpu/solvers/sparse_cholesky.py::_sweep (an XLA lax.scan over
//   dependency levels, no Pallas kernel):
//       x_i = (b_i - sum_j L_ij * x_j) * dinv_i
//   for every row i, j over the row's strictly-lower entries (forward) or
//   over the transposed rows (backward), dinv = 1 / diag(L). The IC(0)
//   preconditioner and sparse_cholesky's `level` schedule apply one
//   forward and one backward sweep.
//
// Layout (TriSweep, ops/tri_sweep.py), rows in dependency-level order:
//   perm   (n,) int32     row at position p (levels ascending, rows
//                         ascending inside a level)
//   offs   (n + 1,) int64 entries of position p at offs[p] .. offs[p+1]
//   cols   (nnz,) int32   row j each entry depends on (x index)
//   vals   (nnz,) T       L_ij
//   dinv   (n,) T         1 / L_ii, by position
//   b, x   (n,) T         by row; x is written once per row
//   ready  (n,) uint32    ready[i] == epoch once x_i is published
//   ctl    (2,) uint32    [claim counter, error word]
//
// What bounds it on an H100: not bytes (a sweep of poisson_2d(512)'s IC(0)
// factor reads ~7 MB, 2 us at 3.35 TB/s) but the dependency chain: one
// level after another, each a publish (store, fence, flag) and a read (an
// L2 round trip for the flag, another for x_j). The design runs the whole
// chain inside one launch instead of ~5 launches per level:
//   - a fixed set of warps (kWarpsPerSm on each SM) loops: each claims the
//     next position with atomicInc on ctl[0], in level order, until the
//     claims pass n. Every row a position depends on sits at an earlier
//     position, claimed by a warp that is running and holds no other
//     position, so the sweep cannot deadlock whatever order or number of
//     blocks the card runs at once. Each warp makes exactly one claim past
//     n, so the wrap value n + warps - 1 brings the counter back to 0 at
//     the end of every launch: it needs no reset. Few warps, not one per
//     row, keep the polling of waiting rows from crowding out the rows
//     that work;
//   - one warp serves one row: each lane takes every 32nd entry, loads the
//     flags of kBatch entries at once, waits (volatile polls, read from L2)
//     for those not yet ready, then loads their x_j past L1 (__ldcg) at
//     once, and the lanes reduce with shuffles; lane 0 stores x_i, fences
//     (__threadfence) and publishes ready[i] = epoch. `epoch` is a launch
//     argument the wrapper bumps on every launch, so the flags are never
//     cleared. A row's sum has one order, so x is bitwise repeatable;
//   - every wait is capped (kTimeoutNs on the global timer, kMaxSpins
//     polls): a row that waits past it sets the error word and publishes
//     NaN, and a waiting row that sees the error word stops waiting, so a
//     fault ends the sweep instead of hanging the card. The wrapper reads
//     the error word once per solve and raises.
//
// Every entry point returns cudaGetLastError() after its launch (0 = OK);
// the Python wrapper raises on anything else.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpsPerSm = 8;  // one block per SM
constexpr int kBatch = 4;       // entries a lane checks and reads at once
constexpr unsigned kPollsBeforeSleep = 64;
constexpr unsigned long long kTimeoutNs = 2000000000ull;  // 2 s per wait
constexpr unsigned kMaxSpins = 1u << 28;
constexpr unsigned kErrTimeout = 1;

// Flags and the error word are read with volatile loads: from L2, never
// from a stale L1 line, and never hoisted out of a polling loop.
__device__ __forceinline__ unsigned ld_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float nan_t(float) { return CUDART_NAN_F; }
__device__ __forceinline__ double nan_t(double) { return CUDART_NAN; }

// Wait until ready[j] == epoch; false if the wait ended on the cap or on
// another row's error.
__device__ bool wait_ready(const unsigned* ready, int j, unsigned epoch,
                           unsigned* err) {
  const unsigned long long t0 = global_ns();
  for (unsigned spins = 0;; ++spins) {
    if (spins >= kPollsBeforeSleep) __nanosleep(32);
    if (ld_volatile(ready + j) == epoch) return true;
    if (ld_volatile(err) != 0) return false;
    if (spins >= kMaxSpins || global_ns() - t0 > kTimeoutNs) {
      atomicExch(err, kErrTimeout);
      return false;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tri_sweep_kernel(const int* __restrict__ perm,
                 const int64_t* __restrict__ offs,
                 const int* __restrict__ cols, const T* __restrict__ vals,
                 const T* __restrict__ dinv, const T* __restrict__ b,
                 T* x, unsigned* ready, unsigned* ctl, int n,
                 unsigned n_claims, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    unsigned p = 0;
    if (lane == 0) p = atomicInc(ctl, n_claims - 1);
    p = __shfl_sync(0xffffffffu, p, 0);
    if (p >= static_cast<unsigned>(n)) return;  // the whole warp
    const int row = __ldg(perm + p);
    const int64_t end = __ldg(offs + p + 1);
    T acc = T(0);
    bool ok = true;
    for (int64_t e0 = __ldg(offs + p) + lane; e0 < end; e0 += 32 * kBatch) {
      int j[kBatch];
      T v[kBatch];
      unsigned f[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t e = e0 + 32 * u;
        j[u] = e < end ? __ldg(cols + e) : -1;
        v[u] = e < end ? __ldg(vals + e) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        f[u] = j[u] >= 0 ? ld_volatile(ready + j[u]) : epoch;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (f[u] != epoch && !wait_ready(ready, j[u], epoch, ctl + 1)) {
          ok = false;
        }
      }
      if (!ok) break;
      T xj[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        xj[u] = j[u] >= 0 ? __ldcg(x + j[u]) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j[u] >= 0) acc = fma_t(v[u], xj[u], acc);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    ok = __all_sync(0xffffffffu, ok);
    if (lane == 0) {
      x[row] = ok ? (__ldg(b + row) - acc) * __ldg(dinv + p) : nan_t(acc);
      __threadfence();
      *reinterpret_cast<volatile unsigned*>(ready + row) = epoch;
    }
  }
}

template <typename T>
int launch(const void* perm, const void* offs, const void* cols,
           const void* vals, const void* dinv, const void* b, void* x,
           void* ready, void* ctl, int n, int epoch, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks = sms * kWarpsPerSm / kWarps;
  if (static_cast<int64_t>(blocks) * kWarps > n) {
    blocks = (n + kWarps - 1) / kWarps;
  }
  // n successful claims, then one claim past n by each warp.
  const unsigned n_claims = static_cast<unsigned>(n) + blocks * kWarps;
  tri_sweep_kernel<T><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(perm), static_cast<const int64_t*>(offs),
      static_cast<const int*>(cols), static_cast<const T*>(vals),
      static_cast<const T*>(dinv), static_cast<const T*>(b),
      static_cast<T*>(x), static_cast<unsigned*>(ready),
      static_cast<unsigned*>(ctl), n, n_claims,
      static_cast<unsigned>(epoch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// perm (n,) int32, offs (n+1,) int64, cols (nnz,) int32, vals (nnz,) f32,
// dinv (n,) f32, b (n,) f32 -> x (n,) f32; ready (n,) and ctl (2,) uint32
// state kept between launches; epoch in [1, 2^31).
int lsb_tri_sweep_f32(const void* perm, const void* offs, const void* cols,
                      const void* vals, const void* dinv, const void* b,
                      void* x, void* ready, void* ctl, int n, int epoch,
                      void* stream) {
  return launch<float>(perm, offs, cols, vals, dinv, b, x, ready, ctl, n,
                       epoch, stream);
}

// The same with vals, dinv, b and x in f64.
int lsb_tri_sweep_f64(const void* perm, const void* offs, const void* cols,
                      const void* vals, const void* dinv, const void* b,
                      void* x, void* ready, void* ctl, int n, int epoch,
                      void* stream) {
  return launch<double>(perm, offs, cols, vals, dinv, b, x, ready, ctl, n,
                        epoch, stream);
}

}  // extern "C"
