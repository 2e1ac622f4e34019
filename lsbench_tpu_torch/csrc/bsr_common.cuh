// Shared by the BSR kernels (bsr_spmv.cu, bsr_variants.cu): the layout's
// constants and the cross-lane reduction of one row group's partials.
//
// One CUDA block of kLanes = 128 threads walks one row group; thread c owns
// lane c of every 8x128 block and keeps BR register partials, which one
// reduction per row group sums over the 128 lanes.

#pragma once

#include <cuda_runtime.h>

namespace lsb {

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

}  // namespace lsb
