// Device marks and the kernel-node count of a graph under capture: the
// port's tracing on the card (CUDA C++ for sm_90a).
//
// Replaces no TPU kernel.  Python side: casualhdrsplat_torch/utils/
// profiling.py (`mark`, `kernel_nodes`).
//
// Marks.  A captured CUDA graph replays without Python, so a host range
// (torch.profiler's record_function) inside its body runs at capture and
// never at a replay.  A kernel does run at every replay, and the
// profiler's device trace reports it by name on the device clock, beside
// the work it brackets.  So each layer boundary of the training step and of
// a render is an empty kernel named after it (`chs_mark_bin`: binning and
// the stream gather have ended), launched on the current stream: one
// block of one thread that does nothing, a graph node of about a
// microsecond.  The names are extern "C", so the trace shows them
// unmangled.  `which` indexes kMarks in profiling.py's order.
//
// Kernel nodes.  `chs_capture_kernel_nodes` counts the kernel nodes of the
// graph a stream is capturing into (cudaStreamGetCaptureInfo), before the
// capture ends: the launches every replay of that graph makes.

#include <cuda_runtime.h>
#include <stdlib.h>

#define CHS_MARK(name) \
  extern "C" __global__ void chs_mark_##name() {}

CHS_MARK(step_begin)
CHS_MARK(project)
CHS_MARK(bin)
CHS_MARK(composite)
CHS_MARK(loss)
CHS_MARK(backward)
CHS_MARK(step_end)
CHS_MARK(render_begin)
CHS_MARK(render_end)

#undef CHS_MARK

extern "C" int chs_trace_mark(int which, void* cu_stream) {
  cudaStream_t st = static_cast<cudaStream_t>(cu_stream);
  switch (which) {
    case 0: chs_mark_step_begin<<<1, 1, 0, st>>>(); break;
    case 1: chs_mark_project<<<1, 1, 0, st>>>(); break;
    case 2: chs_mark_bin<<<1, 1, 0, st>>>(); break;
    case 3: chs_mark_composite<<<1, 1, 0, st>>>(); break;
    case 4: chs_mark_loss<<<1, 1, 0, st>>>(); break;
    case 5: chs_mark_backward<<<1, 1, 0, st>>>(); break;
    case 6: chs_mark_step_end<<<1, 1, 0, st>>>(); break;
    case 7: chs_mark_render_begin<<<1, 1, 0, st>>>(); break;
    case 8: chs_mark_render_end<<<1, 1, 0, st>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int chs_capture_kernel_nodes(void* cu_stream, long long* out) {
  cudaStream_t st = static_cast<cudaStream_t>(cu_stream);
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, &id, &graph);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr)
    return (int)cudaErrorStreamCaptureUnmatched;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNode_t* nodes = static_cast<cudaGraphNode_t*>(malloc((n ? n : 1) * sizeof(*nodes)));
  if (nodes == nullptr) return (int)cudaErrorMemoryAllocation;
  err = cudaGraphGetNodes(graph, nodes, &n);
  long long kernels = 0;
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    kernels += err == cudaSuccess && type == cudaGraphNodeTypeKernel;
  }
  free(nodes);
  *out = kernels;
  return (int)err;
}
