// The exact-block f32 BSR SpMV kernel (K6) for NVIDIA Hopper (sm_90a),
// bound to Python with ctypes (lsbench_tpu_torch/ops/_cuda.py builds this
// file with nvcc; the wrapper and its plain PyTorch twin are in
// lsbench_tpu_torch/ops/spmv_bsr.py). The other two alternate SpMVs, K7
// (selector) and K8 (in-kernel one-hot), run the SELL f32 kernel
// (sell_spmv.cu) over a packed form of their layout on the card.
//
// Layout (lsbench_tpu_torch/matrix/bsr.py, identical to the JAX package's,
// plus goff):
//   compact:  blocks (T, 8, 128), bcols (T,) int32, sorted by (row group,
//             column block); goff (n_groups + 1,) int32: row group g owns
//             blocks goff[g] .. goff[g+1]-1 (zero padding blocks in none)
//   x table   (C, 128): x zero-padded to C = n_col_blocks rows of 128
//   y         (n_groups, 8)
//
// K1's walk (bsr_spmv.cu): one CUDA block of 128 threads per row group,
// thread c owns lane c, BR register partials, one cross-lane reduction;
// plain f32 FMA, no TF32 (the JAX kernel's interpret-mode f32). The block
// walks its row group's contiguous block range, each block naming its own
// column block. The TPU kernel carried the whole y across a sequential grid
// and scatter-added each block's 8 row sums into y[gid]; on Hopper blocks
// run in parallel and in no order, so a direct port races on y[gid].
// Walking the sorted ranges instead (goff, built with the layout) writes
// every y row once, with no atomics: y is bitwise repeatable from run to
// run. What bounds it on an H100: device-memory bytes (2 flops per 4 B
// block element), as for K1.
//
// 64-bit offsets throughout. Every entry point returns cudaGetLastError()
// after its launch (0 = OK); the Python wrapper raises on anything else.

#include <cuda_runtime.h>

#include <cstdint>

#include "bsr_common.cuh"

namespace {

using lsb::BR;
using lsb::kLanes;
using lsb::kWarps;
using lsb::reduce_rows;

// acc[r] += blk[r, c] * xv for the 8 rows of one block (blk at lane c).
__device__ __forceinline__ void block_fma(const float* __restrict__ blk,
                                          float xv, float (&acc)[BR]) {
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    acc[r] = fmaf(__ldg(blk + r * kLanes), xv, acc[r]);
  }
}

// K6. Replaces lsbench_tpu/ops/spmv_pallas.py::_kernel_compact (via
// _spmv_bsr_compact_call, public spmv_bsr_compact).
__global__ void __launch_bounds__(kLanes)
spmv_bsr_compact_f32_kernel(const float* __restrict__ blocks,
                            const int* __restrict__ bcols,
                            const int* __restrict__ goff,
                            const float* __restrict__ x,
                            float* __restrict__ y) {
  __shared__ float part[kWarps * BR];
  const int64_t g = blockIdx.x;
  const int c = threadIdx.x;
  float acc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.0f;
  const int t1 = goff[g + 1];
  for (int64_t t = goff[g]; t < t1; ++t) {
    const float xv = __ldg(x + static_cast<int64_t>(bcols[t]) * kLanes + c);
    block_fma(blocks + t * BR * kLanes + c, xv, acc);
  }
  reduce_rows<float>(acc, part, y + g * BR);
}

}  // namespace

extern "C" {

// blocks (T, 8, 128) f32, bcols (T,) i32, goff (n_groups+1,) i32,
// x (C, 128) f32 -> y (n_groups, 8) f32.
int lsb_spmv_bsr_compact_f32(const void* blocks, const void* bcols,
                             const void* goff, const void* x, void* y,
                             int n_groups, void* stream) {
  if (n_groups < 1) return static_cast<int>(cudaErrorInvalidValue);
  spmv_bsr_compact_f32_kernel<<<n_groups, kLanes, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(bcols),
      static_cast<const int*>(goff), static_cast<const float*>(x),
      static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
