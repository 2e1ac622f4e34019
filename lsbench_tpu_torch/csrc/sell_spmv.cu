// Sliced-ELL SpMV (SELL-32) for NVIDIA Hopper (sm_90a), bound to Python
// with ctypes (lsbench_tpu_torch/ops/_cuda.py builds this file with nvcc;
// the wrappers and their plain PyTorch versions are in
// lsbench_tpu_torch/ops/spmv_sell.py).
//
// The redesigns of two TPU kernels for the solver paths:
//   spmv_sell_f32  replaces lsbench_tpu/ops/spmv_pallas.py::_kernel_classed
//                  (K5: f32 y = A·x on the class-padded 8x128 blocks);
//   spmv_sell_f64  replaces lsbench_tpu/ops/spmv_pallas.py::_kernel_df64
//                  (K2: y = A·x to f64 accuracy from hi/lo f32 blocks).
// The BSR ports of both stay in bsr_spmv.cu behind the ops API.
// spmv_sell_f32 also takes the place of K1 on the solver paths and, over a
// packed form of the uniform BSR layout (BsrMatrix.packed), of
// spmv_pallas.py::_kernel_selector (K7) and ::_kernel_onehot (K8) on the
// card: their one-hot products only kept scalar-indexed loads off the TPU.
//
// Layout (lsbench_tpu_torch/matrix/sell.py): rows in their order, cut into
// slices of 32 rows; slice s padded to its widest row w_s and stored
// column-major, entry j of row 32*s + l at slice_off[s] + 32*j + l:
//   vals       (n_stored,) f32 or f64 (0 in padding)
//   cols       (n_stored,) int32, inside [0, ncols) (padding too)
//   slice_off  (n_slices + 1,) int64
//   x          (ncols,), read in place: no zero-padded table
//   y          (nrows,); rows past nrows in the last slice are not written
//
// What bounds these kernels on an H100: device-memory bytes. Each stored
// entry is 8 B (f32 value + column) or 12 B (f64) for one multiply-add, so
// the card's flops and its tensor cores have nothing to do here. The 8x128
// blocks of the TPU kernels stored ~100x more elements than nonzeros on an
// RCM-ordered Poisson matrix; this layout stores each row's nonzeros plus
// the padding to its slice's widest row. Design:
//   - one thread per row, one warp per slice, 8 slices per 256-thread
//     block: the j-th loads of vals and cols of a warp are one coalesced
//     128 B (f32) or 256 B (f64) and 128 B request;
//   - x is gathered in place through the read-only cache; with RCM a
//     slice's columns fall in a narrow window, so they hit L1/L2;
//   - each thread sums its row in entry order with FMA and writes y once:
//     no shared memory, no cross-lane reduction, no atomics, so y is
//     bitwise repeatable;
//   - spmv_sell_f64 runs the same walk in native FP64: an exact f64
//     matvec, where the TPU approximated one with TwoProd/TwoSum on hi/lo
//     f32 pairs. K2's contract is f64 accuracy; this meets it with 12 B per
//     entry instead of 8 B per stored block element;
//   - 64-bit entry offsets; rows are int32.
//
// Every entry point returns cudaGetLastError() after its launch (0 = OK);
// the Python wrapper raises on anything else.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSlice = 32;     // rows per slice: one warp
constexpr int kThreads = 256;  // rows per CUDA block: 8 slices

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// Row `row`'s sum over its slice's entries, in entry order.
template <typename T>
__device__ __forceinline__ void sell_row(const T* __restrict__ vals,
                                         const int* __restrict__ cols,
                                         const int64_t* __restrict__ slice_off,
                                         const T* __restrict__ x,
                                         T* __restrict__ y, int nrows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= nrows) return;
  const int64_t s = row / kSlice;
  const int64_t end = __ldg(slice_off + s + 1);
  T acc = T(0);
#pragma unroll 4
  for (int64_t k = __ldg(slice_off + s) + row % kSlice; k < end; k += kSlice) {
    acc = fma_t(__ldg(vals + k), __ldg(x + __ldg(cols + k)), acc);
  }
  y[row] = acc;
}

// The redesigned K5: f32.
__global__ void __launch_bounds__(kThreads)
spmv_sell_f32_kernel(const float* __restrict__ vals,
                     const int* __restrict__ cols,
                     const int64_t* __restrict__ slice_off,
                     const float* __restrict__ x, float* __restrict__ y,
                     int nrows) {
  sell_row(vals, cols, slice_off, x, y, nrows);
}

// The redesigned K2: native FP64.
__global__ void __launch_bounds__(kThreads)
spmv_sell_f64_kernel(const double* __restrict__ vals,
                     const int* __restrict__ cols,
                     const int64_t* __restrict__ slice_off,
                     const double* __restrict__ x, double* __restrict__ y,
                     int nrows) {
  sell_row(vals, cols, slice_off, x, y, nrows);
}

template <typename T>
int launch(void (*kernel)(const T*, const int*, const int64_t*, const T*, T*,
                          int),
           const void* vals, const void* cols, const void* slice_off,
           const void* x, void* y, int nrows, void* stream) {
  const int blocks = (nrows + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(cols),
      static_cast<const int64_t*>(slice_off), static_cast<const T*>(x),
      static_cast<T*>(y), nrows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vals, cols (n_stored,), slice_off (ceil(nrows/32) + 1,), x (ncols,) f32
// -> y (nrows,) f32.
int lsb_spmv_sell_f32(const void* vals, const void* cols,
                      const void* slice_off, const void* x, void* y,
                      int nrows, void* stream) {
  return launch<float>(spmv_sell_f32_kernel, vals, cols, slice_off, x, y,
                       nrows, stream);
}

// The same with vals, x and y in f64.
int lsb_spmv_sell_f64(const void* vals, const void* cols,
                      const void* slice_off, const void* x, void* y,
                      int nrows, void* stream) {
  return launch<double>(spmv_sell_f64_kernel, vals, cols, slice_off, x, y,
                        nrows, stream);
}

}  // extern "C"
