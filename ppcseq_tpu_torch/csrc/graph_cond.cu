// Conditional (IF) nodes in a CUDA graph that PyTorch is capturing from a
// stream: the device-side branch of infer/graphs.when, the counterpart of
// the predicates of XLA's while_loop and cond (ppcseq_tpu/infer/nuts.py's
// lax.while_loop over a NUTS transition's doublings and leaves).
//
// graph_if_begin, called while `parent` is capturing, appends to the
// parent's graph a one-thread kernel that copies a device bool into a new
// conditional handle, then an IF node on that handle after it, makes the
// IF node the parent's capture dependency, and starts capturing `body`
// into the IF node's body graph. What is then queued on `body` runs at a
// replay only where the bool is true at that point of the replay.
// graph_if_end ends the body's capture. Both return a cudaError_t (0: ok).
// Needs CUDA 12.4 (conditional nodes, capture to a graph).

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

}  // namespace

extern "C" int graph_if_begin(cudaStream_t parent, cudaStream_t body, const bool* flag) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_conditional<<<1, 1, 0, parent>>>(handle, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(parent, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0], nullptr, nullptr,
                                       0, cudaStreamCaptureModeRelaxed);
}

extern "C" int graph_if_end(cudaStream_t body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(body, &graph);
}

extern "C" const char* graph_cond_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
