// The alternate f32 BSR SpMV kernels for NVIDIA Hopper (sm_90a), bound to
// Python with ctypes (lsbench_tpu_torch/ops/_cuda.py builds this file with
// nvcc; the wrappers and their plain PyTorch twins are in
// lsbench_tpu_torch/ops/spmv_bsr.py):
//
//   K6 spmv_bsr_compact_f32   exact-block layout (BsrCompact)
//   K7 spmv_bsr_selector_f32  uniform layout, x gathered through the
//                             host-built one-hot selector `sel`
//   K8 spmv_bsr_onehot_f32    uniform layout, x gathered through a one-hot
//                             built in the kernel from block_cols
//
// Layouts (lsbench_tpu_torch/matrix/bsr.py, identical to the JAX package's):
//   uniform:  blocks (G, S*8, 128), block_cols (G, S) int32, sel (G*S, C) f32
//             with row g*S + s one-hot at block_cols[g, s]
//   compact:  blocks (T, 8, 128), bcols (T,) int32, sorted by (row group,
//             column block); goff (n_groups + 1,) int32: row group g owns
//             blocks goff[g] .. goff[g+1]-1 (zero padding blocks in none)
//   x table   (C, 128): x zero-padded to C = n_col_blocks rows of 128
//   y         (G, 8) (compact: (n_groups, 8))
//
// All three are K1's walk (bsr_spmv.cu): one CUDA block of 128 threads per
// row group, thread c owns lane c, BR register partials, one cross-lane
// reduction; plain f32 FMA, no TF32 (the JAX kernels' Precision.HIGHEST or
// interpret-mode f32). They differ in how a block finds its x row:
//   K6 walks its row group's contiguous block range, each block naming its
//      own column block. The TPU kernel carried the whole y across a
//      sequential grid and scatter-added each block's 8 row sums into
//      y[gid]; on Hopper blocks run in parallel and in no order, so a direct
//      port races on y[gid]. Walking the sorted ranges instead (goff, built
//      with the layout) writes every y row once, with no atomics: y is
//      bitwise repeatable from run to run.
//   K7 reads the selector rows of a chunk of slots (coalesced, 128 threads
//      striding over C columns), records each row's nonzero column and value
//      in shared memory, and scales that x row by the value. The rows are
//      exactly one-hot (checked when a layout is built or carried over), so
//      this equals the TPU kernel's product g = sel @ x_table exactly (a row
//      with no nonzero gives 0, as the product does). The selector is most
//      of the bytes: (G*S)*C*4 against G*S*4 KB of blocks.
//   K8 builds the one-hot of a chunk of slots in the kernel: each thread
//      compares the slot's column id with its share of the column iota
//      0..C-1 and a match records the column in shared memory. A column id
//      outside [0, C) matches nothing and gathers 0, as the TPU kernel's
//      one-hot product does. Nothing stages the x table in shared memory, so
//      every C is taken.
// What bounds them on an H100: device-memory bytes (2 flops per 4 B block
// element; K7 adds C*4 B of selector per slot), as for K1.
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

constexpr int kSlotChunk = 32;  // slots whose x rows one pass selects

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

// K7. Replaces lsbench_tpu/ops/spmv_pallas.py::_kernel_selector (via
// _spmv_bsr_selector_call, public spmv_bsr(variant="selector")). Reads sel,
// the x table and the blocks; never block_cols.
__global__ void __launch_bounds__(kLanes)
spmv_bsr_selector_f32_kernel(const float* __restrict__ sel,
                             const float* __restrict__ x,
                             const float* __restrict__ blocks,
                             float* __restrict__ y, int slots, int C) {
  __shared__ float part[kWarps * BR];
  __shared__ int sh_col[kSlotChunk];
  __shared__ float sh_val[kSlotChunk];
  const int64_t g = blockIdx.x;
  const int c = threadIdx.x;
  float acc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.0f;
  for (int s0 = 0; s0 < slots; s0 += kSlotChunk) {
    const int n = min(kSlotChunk, slots - s0);
    if (c < n) {
      sh_col[c] = 0;
      sh_val[c] = 0.0f;
    }
    __syncthreads();
    // The chunk's n selector rows are contiguous: n*C floats.
    const int64_t row0 = g * slots + s0;
    const float* rows = sel + row0 * C;
    const int64_t len = static_cast<int64_t>(n) * C;
#pragma unroll 4
    for (int64_t e = c; e < len; e += kLanes) {
      const float v = __ldg(rows + e);
      if (v != 0.0f) {
        const int i = static_cast<int>(e / C);
        sh_col[i] = static_cast<int>(e - static_cast<int64_t>(i) * C);
        sh_val[i] = v;
      }
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float xv =
          sh_val[i] * __ldg(x + static_cast<int64_t>(sh_col[i]) * kLanes + c);
      block_fma(blocks + (row0 + i) * BR * kLanes + c, xv, acc);
    }
    __syncthreads();  // sh_col/sh_val are reset for the next chunk
  }
  reduce_rows<float>(acc, part, y + g * BR);
}

// K8. Replaces lsbench_tpu/ops/spmv_pallas.py::_kernel_onehot (via
// _spmv_bsr_onehot_call, public spmv_bsr(variant="onehot")). Reads
// block_cols, the x table and the blocks.
__global__ void __launch_bounds__(kLanes)
spmv_bsr_onehot_f32_kernel(const int* __restrict__ bcols,
                           const float* __restrict__ x,
                           const float* __restrict__ blocks,
                           float* __restrict__ y, int slots, int C) {
  __shared__ float part[kWarps * BR];
  __shared__ int sh_col[kSlotChunk];
  __shared__ float sh_hit[kSlotChunk];
  const int64_t g = blockIdx.x;
  const int c = threadIdx.x;
  float acc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.0f;
  for (int s0 = 0; s0 < slots; s0 += kSlotChunk) {
    const int n = min(kSlotChunk, slots - s0);
    if (c < n) {
      sh_col[c] = 0;
      sh_hit[c] = 0.0f;
    }
    __syncthreads();
    const int64_t row0 = g * slots + s0;
    for (int i = 0; i < n; ++i) {
      const int cb = __ldg(bcols + row0 + i);
      // onehot[i, j] = (cb == j) over this thread's columns j = c + 128 m.
      for (int j = c; j < C; j += kLanes) {
        if (cb == j) {
          sh_col[i] = j;
          sh_hit[i] = 1.0f;
        }
      }
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float xv =
          sh_hit[i] * __ldg(x + static_cast<int64_t>(sh_col[i]) * kLanes + c);
      block_fma(blocks + (row0 + i) * BR * kLanes + c, xv, acc);
    }
    __syncthreads();  // sh_col/sh_hit are reset for the next chunk
  }
  reduce_rows<float>(acc, part, y + g * BR);
}

int bad_shape(int n_groups, int slots, int C) {
  return (n_groups < 1 || slots < 1 || C < 1)
             ? static_cast<int>(cudaErrorInvalidValue)
             : 0;
}

}  // namespace

extern "C" {

// blocks (T, 8, 128) f32, bcols (T,) i32, goff (n_groups+1,) i32,
// x (C, 128) f32 -> y (n_groups, 8) f32.
int lsb_spmv_bsr_compact_f32(const void* blocks, const void* bcols,
                             const void* goff, const void* x, void* y,
                             int n_groups, void* stream) {
  if (int rc = bad_shape(n_groups, 1, 1)) return rc;
  spmv_bsr_compact_f32_kernel<<<n_groups, kLanes, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(bcols),
      static_cast<const int*>(goff), static_cast<const float*>(x),
      static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}

// sel (n_groups*slots, C) f32, x (C, 128) f32, blocks (n_groups, slots*8,
// 128) f32 -> y (n_groups, 8) f32.
int lsb_spmv_bsr_selector_f32(const void* sel, const void* x,
                              const void* blocks, void* y, int n_groups,
                              int slots, int C, void* stream) {
  if (int rc = bad_shape(n_groups, slots, C)) return rc;
  spmv_bsr_selector_f32_kernel<<<n_groups, kLanes, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sel), static_cast<const float*>(x),
      static_cast<const float*>(blocks), static_cast<float*>(y), slots, C);
  return static_cast<int>(cudaGetLastError());
}

// bcols (n_groups, slots) i32, x (C, 128) f32, blocks (n_groups, slots*8,
// 128) f32 -> y (n_groups, 8) f32.
int lsb_spmv_bsr_onehot_f32(const void* bcols, const void* x,
                            const void* blocks, void* y, int n_groups,
                            int slots, int C, void* stream) {
  if (int rc = bad_shape(n_groups, slots, C)) return rc;
  spmv_bsr_onehot_f32_kernel<<<n_groups, kLanes, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bcols), static_cast<const float*>(x),
      static_cast<const float*>(blocks), static_cast<float*>(y), slots, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
