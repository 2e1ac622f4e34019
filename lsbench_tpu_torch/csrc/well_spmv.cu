// Window-ELL SpMV (K4) for NVIDIA Hopper (sm_90a), bound to Python with
// ctypes (lsbench_tpu_torch/ops/_cuda.py builds this file with nvcc; the
// wrapper and its plain PyTorch version are in
// lsbench_tpu_torch/ops/interp_well.py).
//
// Replaces lsbench_tpu/ops/interp_pallas.py::_well_kernel (via
// _spmv_well_call, public spmv_well): the AMG transfer-operator product
//
//   y[r] = sum_{s < k_real} vals[s, r] * x[128 * w0[r / 128] + lcols[s, r]]
//
// Layout (interp_well.py, identical to the JAX package's):
//   vals   (k8, n_pad) f32, slot-major: slot s of row r at s * n_pad + r
//   lcols  (k8, n_pad) int32, column relative to the tile's window start
//   w0     (n_pad / 128,) int32, window start of each 128-row tile in blocks
//   x      (ncols,) f32, read in place. The TPU kernel read whole windows of
//          J blocks and so needed x zero-padded by J blocks; here a slot
//          reads only its own entry, whose index the layout's host check
//          (interp_well.py, at build) proved to lie in [0, ncols) for every
//          row < nrows and slot < k_real: a real slot reads its own column,
//          a padding slot (lcols 0) reads 128 * w0, at most the tile's
//          smallest column (0 in an empty tile).
//   y      (nrows,) f32, written once; padding rows are not computed.
//
// The TPU has no per-lane gather, so its kernel folded the gather into
// one-hot (128, 128) selector products on the MXU, J per tile. Hopper loads
// x directly; only what the kernel computes carries over.
//
// What bounds it on an H100: device-memory bytes (8 B per stored slot,
// value and column, for one multiply-add; x reads of a tile hit one window
// of at most J * 512 B, which stays in L1/L2). Design: one thread per row,
// looping over the k_real real slots; slot-major storage makes a warp's
// reads of vals and lcols one coalesced 128 B request each; x and w0 go
// through the read-only cache (__ldg); the slots are summed in slot order
// with fmaf. Offsets are 64-bit, since k8 * n_pad passes 2^31 at a few
// hundred million rows. A variant templated on k8 that issued every vals
// and lcols load before the first x gather was no faster on the large
// operators and slower on the small ones, whose launches are a few blocks
// long (its longer unrolled, predicated body), so the loop stays plain.
//
// The entry point returns cudaGetLastError() after its launch (0 = OK); the
// Python wrapper raises on anything else.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileRows = 128;  // TR: rows per window tile
constexpr int kThreads = 256;   // rows per CUDA block

__global__ void __launch_bounds__(kThreads)
spmv_well_f32_kernel(const float* __restrict__ vals,
                     const int* __restrict__ lcols,
                     const int* __restrict__ w0,
                     const float* __restrict__ x, float* __restrict__ y,
                     int nrows, int n_pad, int k_real) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= nrows) return;
  const float* xw =
      x + static_cast<int64_t>(__ldg(w0 + r / kTileRows)) * kTileRows;
  float acc = 0.0f;
  for (int s = 0; s < k_real; ++s) {
    const int64_t off = static_cast<int64_t>(s) * n_pad + r;
    acc = fmaf(__ldg(vals + off), __ldg(xw + __ldg(lcols + off)), acc);
  }
  y[r] = acc;
}

}  // namespace

extern "C" {

// vals, lcols (k8, n_pad), w0 (n_pad/128,), x (ncols,) f32 -> y (nrows,)
// f32; the slot loop runs k_real <= k8 times.
int lsb_spmv_well_f32(const void* vals, const void* lcols, const void* w0,
                      const void* x, void* y, int nrows, int n_pad,
                      int k_real, void* stream) {
  const int blocks = (nrows + kThreads - 1) / kThreads;
  spmv_well_f32_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(lcols),
      static_cast<const int*>(w0), static_cast<const float*>(x),
      static_cast<float*>(y), nrows, n_pad, k_real);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
