// CUDA-graph conditional (if) nodes around work that PyTorch captures,
// guarded by a counted loop's test on the device, bound to Python with
// ctypes (lsbench_tpu_torch/ops/_cuda.py builds this file with nvcc; the
// wrapper and the guard's plain version are lsbench_tpu_torch/ops/graph_if.py).
// The CG loop's block graph (lsbench_tpu_torch/solvers/cg.py::CgGraphs)
// puts each of its iterations in one.
//
// While a stream captures a graph, lsb_graph_if_<T> adds to that graph one
// kernel, the guard, and after it an if-node; the capturing stream's later
// work follows the node. At replay the guard reads a 0-d int64 count `it`,
// its limit, and two 0-d values of type T: where it < limit and
// value > bound, it adds one to `it` and sets the node's condition, so
// the node's body runs; else the body is skipped and nothing changes. A
// second stream, which captures nothing, then captures the body graph
// until lsb_graph_if_end. The body runs on a stream of the caller's
// choosing, so its work keeps that stream's library handles (cuBLAS keeps
// a workspace per stream) and allocations. One kernel a guard, where the
// test written in PyTorch (two compares, an and, the increment) takes
// four and the condition's setter a fifth: each costs the card a launch
// inside the graph.
//
// Conditional nodes need CUDA 12.4; an older runtime answers with an error
// code, and the caller replays its work otherwise.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void guard_kernel(cudaGraphConditionalHandle handle,
                             long long* it, const long long* limit,
                             const T* value, const T* bound) {
  const bool go = *it < *limit && *value > *bound;
  if (go) *it += 1;
  cudaGraphSetConditional(handle, go ? 1u : 0u);
}

template <typename T>
int begin(void* it, const void* limit, const void* value, const void* bound,
          void* body, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  guard_kernel<T><<<1, 1, 0, s>>>(
      handle, static_cast<long long*>(it),
      static_cast<const long long*>(limit), static_cast<const T*>(value),
      static_cast<const T*>(bound));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // The dependencies now end at the guard just captured.
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

}  // namespace

extern "C" {

// Loads the kernels into the current context, outside any capture.
int lsb_graph_if_load(void* stream) {
  (void)stream;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, guard_kernel<float>);
  if (err != cudaSuccess) return err;
  return cudaFuncGetAttributes(&attr, guard_kernel<double>);
}

// it, limit: 0-d int64 on the device; value, bound: 0-d f32 (f64); body: a
// stream that captures nothing; stream: the stream capturing the graph.
int lsb_graph_if_f32(void* it, const void* limit, const void* value,
                     const void* bound, void* body, void* stream) {
  return begin<float>(it, limit, value, bound, body, stream);
}

int lsb_graph_if_f64(void* it, const void* limit, const void* value,
                     const void* bound, void* body, void* stream) {
  return begin<double>(it, limit, value, bound, body, stream);
}

// Ends the body's capture on `stream` (lsb_graph_if_<T>'s body). The
// body graph belongs to its node.
int lsb_graph_if_end(void* stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &body);
}

}  // extern "C"
