// Sliced-ELL SpMM (SELL-32, k right-hand sides) for NVIDIA Hopper (sm_90a),
// bound to Python with ctypes (lsbench_tpu_torch/ops/_cuda.py builds this
// file with nvcc; the wrapper and its plain PyTorch version are in
// lsbench_tpu_torch/ops/spmv_sell.py).
//
// The redesign of one TPU kernel for the multi-RHS solver paths (block CG,
// batched BiCGSTAB):
//   spmm_sell_f32  replaces lsbench_tpu/ops/spmv_pallas.py::_kernel_mm
//                  (K3: f32 Y = A·X over the uniform 8x128 BSR blocks, X
//                  as an (n_cb, k, 128) table, one MXU product per slot).
// The BSR port of K3 stays in bsr_spmv.cu behind the ops API.
//
// Layout (lsbench_tpu_torch/matrix/sell.py, as in sell_spmv.cu): rows in
// their order, cut into slices of 32 rows; slice s padded to its widest row
// and stored column-major, entry j of row 32*s + l at slice_off[s] + 32*j + l:
//   vals       (n_stored,) f32 (0 in padding)
//   cols       (n_stored,) int32, inside [0, ncols) (padding too)
//   slice_off  (n_slices + 1,) int64
//   X          (ncols, k) f32 row-major, read in place: no x table
//   Y          (nrows, k) f32 row-major, written once
//
// What bounds it on an H100: device-memory bytes. Each stored entry is 8 B
// (value + column) for k multiply-adds, and X and Y are 4k B per row each;
// at k <= 16 that is far below the card's flop/byte balance. The 8x128
// blocks of the TPU kernel stored ~100x more elements than nonzeros on an
// RCM-ordered Poisson matrix (688.5 MB at n=262k against this layout's
// 12.6 MB). Design:
//   - one thread per row, one warp per slice, 8 slices per 256-thread block
//     (spmv_sell's walk): a warp's j-th loads of vals and cols are one
//     coalesced 128 B request each;
//   - each stored entry's value and column are loaded once per chunk of KC
//     columns and used for KC FMAs against the row X[col, j0:j0+KC], which
//     the thread gathers in place (with RCM a slice's columns fall in a
//     narrow window, so the gathers hit L1/L2). KC is a template parameter
//     in {1, 2, 4, 8, 16}: k = 1, 2, 3-4, 5-8 and multiples of 16 take one
//     chunk, any other k chunks of 8, the last one masked;
//   - the X row is gathered, and the Y row stored, with 16-byte vector
//     accesses where k % 4 == 0 and X and Y are 16-byte aligned (checked
//     here at the entry point), with scalar ones otherwise;
//   - each column is summed in entry order with fmaf, with no cross-lane
//     reduction, shared memory or atomics: Y[:, j] equals
//     spmv_sell_f32(S, X[:, j]) bit for bit, and Y is bitwise repeatable;
//   - 64-bit entry and X/Y offsets; rows are int32.
//
// The entry point returns cudaGetLastError() after its launch (0 = OK); the
// Python wrapper raises on anything else.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSlice = 32;     // rows per slice: one warp
constexpr int kThreads = 256;  // rows per CUDA block: 8 slices

template <int KC, bool VEC>
__global__ void __launch_bounds__(kThreads)
spmm_sell_f32_kernel(const float* __restrict__ vals,
                     const int* __restrict__ cols,
                     const int64_t* __restrict__ slice_off,
                     const float* __restrict__ x, float* __restrict__ y,
                     int nrows, int k) {
  static_assert(!VEC || KC % 4 == 0, "vector accesses take 4 columns");
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= nrows) return;
  const int64_t s = row / kSlice;
  const int64_t begin = __ldg(slice_off + s) + row % kSlice;
  const int64_t end = __ldg(slice_off + s + 1);
  float* yr = y + row * k;
  for (int j0 = 0; j0 < k; j0 += KC) {
    const int kc = min(KC, k - j0);
    float acc[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[j] = 0.0f;
    for (int64_t e = begin; e < end; e += kSlice) {
      const float v = __ldg(vals + e);
      const float* xr = x + static_cast<int64_t>(__ldg(cols + e)) * k + j0;
      if constexpr (VEC) {
#pragma unroll
        for (int j = 0; j < KC; j += 4) {
          if (j < kc) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(xr + j));
            acc[j] = fmaf(v, q.x, acc[j]);
            acc[j + 1] = fmaf(v, q.y, acc[j + 1]);
            acc[j + 2] = fmaf(v, q.z, acc[j + 2]);
            acc[j + 3] = fmaf(v, q.w, acc[j + 3]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          if (j < kc) acc[j] = fmaf(v, __ldg(xr + j), acc[j]);
        }
      }
    }
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < KC; j += 4) {
        if (j < kc) {
          *reinterpret_cast<float4*>(yr + j0 + j) =
              make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if (j < kc) yr[j0 + j] = acc[j];
      }
    }
  }
}

template <int KC, bool VEC>
int launch(const void* vals, const void* cols, const void* slice_off,
           const void* x, void* y, int nrows, int k, cudaStream_t stream) {
  const int blocks = (nrows + kThreads - 1) / kThreads;
  spmm_sell_f32_kernel<KC, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(vals), static_cast<const int*>(cols),
      static_cast<const int64_t*>(slice_off), static_cast<const float*>(x),
      static_cast<float*>(y), nrows, k);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// vals, cols (n_stored,), slice_off (ceil(nrows/32) + 1,), X (ncols, k) f32
// row-major -> Y (nrows, k) f32 row-major; k >= 1.
int lsb_spmm_sell_f32(const void* vals, const void* cols,
                      const void* slice_off, const void* x, void* y,
                      int nrows, int k, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (k % 4 == 0 && aligned16(x) && aligned16(y)) {
    if (k % 16 == 0) return launch<16, true>(vals, cols, slice_off, x, y, nrows, k, s);
    if (k == 4) return launch<4, true>(vals, cols, slice_off, x, y, nrows, k, s);
    return launch<8, true>(vals, cols, slice_off, x, y, nrows, k, s);
  }
  if (k == 1) return launch<1, false>(vals, cols, slice_off, x, y, nrows, k, s);
  if (k == 2) return launch<2, false>(vals, cols, slice_off, x, y, nrows, k, s);
  if (k <= 4) return launch<4, false>(vals, cols, slice_off, x, y, nrows, k, s);
  return launch<8, false>(vals, cols, slice_off, x, y, nrows, k, s);
}

}  // extern "C"
