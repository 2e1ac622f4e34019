// BSR SpMV and SpMM kernels for NVIDIA Hopper (sm_90a), bound to Python
// with ctypes (lsbench_tpu_torch/ops/_cuda.py builds this file with nvcc;
// the wrappers and their plain PyTorch twins are in
// lsbench_tpu_torch/ops/spmv_bsr.py).
//
// Layout (lsbench_tpu_torch/matrix/bsr.py, identical to the JAX package's):
//   blocks     (G, S*BR, 128) row-major: row group g, slot s, block row r,
//              lane c at ((g*S + s)*BR + r)*128 + c
//   block_cols (G, S) int32: column block of each slot (padding slots: 0,
//              with all-zero blocks)
//   x table    (n_cb, 128): x zero-padded to a multiple of 128; for k
//              right-hand sides (n_cb, k, 128), column j of column block cb
//              at (cb*k + j)*128
//   y          (G, BR): one value per row of each row group, BR = 8; for k
//              right-hand sides (G, BR, k)
//
// What bounds these kernels on an H100: device-memory bytes. Each stored
// block element is read once and used for one multiply-add, so K1/K5 move
// 4 B (K2: 8 B, the hi/lo pair) per 2 flops — far below the card's
// flop/byte balance. The design answers that with coalesced streaming only:
//   - one CUDA block of 128 threads per row group, thread c owns lane c, so
//     every block row (128 floats, 512 B) is read by one coalesced request;
//   - x[128*bcol + c] is read once per slot and reused for all BR rows;
//   - BR register partials per thread, ONE cross-lane reduction per row
//     group (warp shuffles, then shared memory across the 4 warps);
//   - 64-bit offsets: G*S*BR*128 is 1.7e8 at n=262k and passes int32 range
//     at modestly larger n.
// Overlapping loads with cp.async/TMA and several row groups per block are
// later work.
//
// Every entry point returns cudaGetLastError() after its launch (0 = OK);
// the Python wrapper raises on anything else.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;              // BC: block width, one thread each
constexpr int kWarps = kLanes / 32;
constexpr int BR = 8;                     // rows per row group (bsr.py's BR)
constexpr int kGroupsPerSupergroup = 16;  // GPS (BsrClassed's oidx unit)

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sum each of the BR per-lane partials over the 128 lanes of the block and
// write the BR row sums to out[0..BR).
template <typename T>
__device__ __forceinline__ void reduce_rows(T (&acc)[BR], T* part,
                                            T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    const T v = warp_sum(acc[r]);
    if (lane == 0) part[warp * BR + r] = v;
  }
  __syncthreads();
  if (threadIdx.x < BR) {
    T s = part[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w * BR + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// Lane c's partials of one row group: acc[r] += Σ_s blk[s, r, c] · x[cols[s], c].
__device__ __forceinline__ void group_f32(const float* __restrict__ blk,
                                          const int* __restrict__ cols,
                                          const float* __restrict__ x,
                                          int slots, float (&acc)[BR]) {
  const int c = threadIdx.x;
  for (int s = 0; s < slots; ++s) {
    const float xv = __ldg(x + static_cast<int64_t>(cols[s]) * kLanes + c);
    const float* b = blk + static_cast<int64_t>(s) * BR * kLanes + c;
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[r] = fmaf(__ldg(b + r * kLanes), xv, acc[r]);
  }
}

// K1. Replaces lsbench_tpu/ops/spmv_pallas.py::_kernel (via _spmv_bsr_call,
// public spmv_bsr): f32 y = A·x over uniform BSR. Grid: one block per row
// group (the TPU kernel's sequential grid of GPS-group steps becomes G
// independent blocks).
__global__ void __launch_bounds__(kLanes)
spmv_bsr_f32_kernel(const float* __restrict__ blocks,
                    const int* __restrict__ bcols,
                    const float* __restrict__ x, float* __restrict__ y,
                    int slots) {
  __shared__ float part[kWarps * BR];
  const int64_t g = blockIdx.x;
  float acc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.0f;
  group_f32(blocks + g * slots * BR * kLanes, bcols + g * slots, x, slots, acc);
  reduce_rows<float>(acc, part, y + g * BR);
}

// K5. Replaces lsbench_tpu/ops/spmv_pallas.py::_kernel_classed (via
// _spmv_bsr_classed_call, public spmv_bsr_classed): the K1 body over one
// slot class of class-padded BSR. Local row group i lands at global row
// group oidx[i / GPS]*GPS + i % GPS of y, which the wrapper zeroes once per
// call; one launch per class (the TPU version chained the classes through an
// aliased y; here each class writes its own disjoint rows).
__global__ void __launch_bounds__(kLanes)
spmv_bsr_classed_f32_kernel(const float* __restrict__ blocks,
                            const int* __restrict__ bcols,
                            const int* __restrict__ oidx,
                            const float* __restrict__ x,
                            float* __restrict__ y, int slots) {
  __shared__ float part[kWarps * BR];
  const int64_t i = blockIdx.x;
  const int64_t g =
      static_cast<int64_t>(oidx[i / kGroupsPerSupergroup]) *
          kGroupsPerSupergroup + i % kGroupsPerSupergroup;
  float acc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.0f;
  group_f32(blocks + i * slots * BR * kLanes, bcols + i * slots, x, slots, acc);
  reduce_rows<float>(acc, part, y + g * BR);
}

// K2. Replaces lsbench_tpu/ops/spmv_pallas.py::_kernel_df64 (via
// _spmv_bsr_df64_call, public spmv_bsr_df64 / spmv_bsr_df64_lo): y = A·x
// to f64 accuracy. The TPU built f64 from hi/lo f32 pairs with TwoProd/
// TwoSum because it has no FP64; Hopper has native FP64, so each element is
// a = (double)hi + (double)lo (exact: hi + lo is the f64 value to ~2^-48)
// and the products, sums and the cross-lane reduction run in FP64. The
// contract is the TPU kernel's accuracy, not its arithmetic. 8 B streamed
// per stored element (hi and lo).
__global__ void __launch_bounds__(kLanes)
spmv_bsr_f64acc_kernel(const float* __restrict__ hi,
                       const float* __restrict__ lo,
                       const int* __restrict__ bcols,
                       const double* __restrict__ x,
                       double* __restrict__ y, int slots) {
  __shared__ double part[kWarps * BR];
  const int64_t g = blockIdx.x;
  const int c = threadIdx.x;
  const int* cols = bcols + g * slots;
  double acc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.0;
  for (int s = 0; s < slots; ++s) {
    const double xv = __ldg(x + static_cast<int64_t>(cols[s]) * kLanes + c);
    const int64_t off = (g * slots + s) * BR * kLanes + c;
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const double a = static_cast<double>(__ldg(hi + off + r * kLanes)) +
                       static_cast<double>(__ldg(lo + off + r * kLanes));
      acc[r] = fma(a, xv, acc[r]);
    }
  }
  reduce_rows<double>(acc, part, y + g * BR);
}

// Butterfly reduction of N per-lane partials over the 32 lanes of a warp
// (N a power of two). Each step exchanges half of the live values with the
// lane OFF away and keeps the other half, so the steps cost N/2 + N/4 + ...
// shuffles instead of warp_sum's 5·N. Afterwards lane l holds the warp sums
// of values l·M .. l·M + M - 1 in v[0..M), M = N/32; for N < 32, v[0] holds
// the sum of value l·N/32 (the 32/N lanes that share it hold the same).
template <int M, int OFF, int N>
__device__ __forceinline__ void butterfly(float (&v)[N], int lane) {
  if constexpr (M > 1) {
    constexpr int H = M / 2;
    const bool upper = lane & OFF;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float keep = upper ? v[i + H] : v[i];
      const float send = upper ? v[i] : v[i + H];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    if constexpr (OFF > 1) butterfly<H, OFF / 2>(v, lane);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
    if constexpr (OFF > 1) butterfly<1, OFF / 2>(v, lane);
  }
}

// Sum each of the N per-lane partials over the 128 lanes of the block: the
// butterfly inside each warp, then the 4 warps' sums through shared memory.
// Thread t < N returns the sum of value t; the others return 0.
template <int N>
__device__ __forceinline__ float reduce_values(float (&v)[N], float* part) {
  constexpr int M = N >= 32 ? N / 32 : 1;
  constexpr int SHARE = N >= 32 ? 1 : 32 / N;  // lanes holding one sum
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  butterfly<N, 16>(v, lane);
  if (lane % SHARE == 0) {
#pragma unroll
    for (int i = 0; i < M; ++i) part[warp * N + (lane / SHARE) * M + i] = v[i];
  }
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < N) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w * N + threadIdx.x];
  }
  return s;
}

// K3. Replaces lsbench_tpu/ops/spmv_pallas.py::_kernel_mm (via
// _spmm_bsr_call, public spmm_bsr): f32 Y = A·X for k right-hand sides over
// uniform BSR, x table (n_cb, k, 128), Y (G, BR, k). The TPU kernel ran one
// MXU dot_general per slot; here K1's walk carries k columns: one block per
// row group, thread c owns lane c, loads its BR block elements of a slot once
// and uses each for KC FMAs against x[cb, j, c] (each x row one coalesced
// 512 B read). KC (1, 2, 4, 8) columns are accumulated at a time in
// acc[BR·KC] registers; k > 8 loops over chunks of 8 columns inside the
// block and re-reads the row group's blocks for each chunk (keeping them in
// shared memory is later work), and a chunk narrower than KC is masked.
// Bound: the block stream, as K1 — k extra columns add k·2 flops per 4 B
// block element, still far below the card's flop/byte balance at k ≤ 16.
// Plain f32 FMA, no TF32 or tensor cores (JAX's Precision.HIGHEST).
template <int KC>
__global__ void __launch_bounds__(kLanes)
spmm_bsr_f32_kernel(const float* __restrict__ blocks,
                    const int* __restrict__ bcols,
                    const float* __restrict__ x, float* __restrict__ y,
                    int slots, int k) {
  constexpr int N = BR * KC;
  __shared__ float part[kWarps * N];
  const int64_t g = blockIdx.x;
  const int c = threadIdx.x;
  const float* blk = blocks + g * slots * BR * kLanes + c;
  const int* cols = bcols + g * slots;
  for (int j0 = 0; j0 < k; j0 += KC) {
    const int kc = min(KC, k - j0);
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.0f;
    for (int s = 0; s < slots; ++s) {
      const float* xs =
          x + (static_cast<int64_t>(cols[s]) * k + j0) * kLanes + c;
      float xv[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) xv[j] = j < kc ? __ldg(xs + j * kLanes) : 0.0f;
      const float* b = blk + static_cast<int64_t>(s) * BR * kLanes;
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const float a = __ldg(b + r * kLanes);
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[r * KC + j] = fmaf(a, xv[j], acc[r * KC + j]);
      }
    }
    const float sum = reduce_values<N>(acc, part);
    if (c < N && c % KC < kc) {
      y[(g * BR + c / KC) * k + j0 + c % KC] = sum;
    }
    __syncthreads();  // part is reused by the next chunk
  }
}

template <int KC>
int launch_spmm(const void* blocks, const void* bcols, const void* x, void* y,
                int n_groups, int slots, int k, cudaStream_t stream) {
  spmm_bsr_f32_kernel<KC><<<n_groups, kLanes, 0, stream>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(bcols),
      static_cast<const float*>(x), static_cast<float*>(y), slots, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// blocks (n_groups, slots*8, 128) f32, bcols (n_groups, slots) i32,
// x (n_cb, 128) f32 -> y (n_groups, 8) f32.
int lsb_spmv_bsr_f32(const void* blocks, const void* bcols, const void* x,
                     void* y, int n_groups, int slots, void* stream) {
  spmv_bsr_f32_kernel<<<n_groups, kLanes, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(bcols),
      static_cast<const float*>(x), static_cast<float*>(y), slots);
  return static_cast<int>(cudaGetLastError());
}

// One slot class: blocks (n_local, slots*8, 128) f32, bcols
// (n_local*slots,) i32, oidx (n_local/16,) i32; writes its rows of
// y (n_groups_total, 8) f32.
int lsb_spmv_bsr_classed_f32(const void* blocks, const void* bcols,
                             const void* oidx, const void* x, void* y,
                             int n_local, int slots, void* stream) {
  spmv_bsr_classed_f32_kernel<<<n_local, kLanes, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(bcols),
      static_cast<const int*>(oidx), static_cast<const float*>(x),
      static_cast<float*>(y), slots);
  return static_cast<int>(cudaGetLastError());
}

// hi, lo (n_groups, slots*8, 128) f32, bcols (n_groups, slots) i32,
// x (n_cb, 128) f64 -> y (n_groups, 8) f64.
int lsb_spmv_bsr_f64acc(const void* hi, const void* lo, const void* bcols,
                        const void* x, void* y, int n_groups, int slots,
                        void* stream) {
  spmv_bsr_f64acc_kernel<<<n_groups, kLanes, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hi), static_cast<const float*>(lo),
      static_cast<const int*>(bcols), static_cast<const double*>(x),
      static_cast<double*>(y), slots);
  return static_cast<int>(cudaGetLastError());
}

// blocks (n_groups, slots*8, 128) f32, bcols (n_groups, slots) i32,
// x (n_cb, k, 128) f32 -> y (n_groups, 8, k) f32; k >= 1.
int lsb_spmm_bsr_f32(const void* blocks, const void* bcols, const void* x,
                     void* y, int n_groups, int slots, int k, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (k == 1) return launch_spmm<1>(blocks, bcols, x, y, n_groups, slots, k, s);
  if (k == 2) return launch_spmm<2>(blocks, bcols, x, y, n_groups, slots, k, s);
  if (k <= 4) return launch_spmm<4>(blocks, bcols, x, y, n_groups, slots, k, s);
  return launch_spmm<8>(blocks, bcols, x, y, n_groups, slots, k, s);
}

}  // extern "C"
