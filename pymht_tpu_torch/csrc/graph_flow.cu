// Device-side loops and branches for a CUDA graph captured from PyTorch:
// the WHILE and IF conditional nodes of CUDA 12.4+, entered from a stream
// that PyTorch is capturing, with the body captured on a side stream and
// its allocations routed into the capturing graph's private memory pool.
//
// Counterpart of JAX's compiled control flow: `jax.jit` turns a scan
// step with `lax.while_loop` and `lax.cond` into one device program
// (pymht_tpu/core/tracker.py:333-335); here `torch.cuda.graph` captures
// the step once, and every data-dependent loop exit and branch predicate
// is tested on the device by `condition_kernel`, with no host read.  It
// replaces no Pallas kernel.
//
// The condition kernel is one thread: it reads a 1-byte predicate and,
// for a loop, bumps a 4-byte trip counter, and hands the result to
// `cudaGraphSetConditional`; it also counts its runs, in all (`g_runs`)
// and per node (`g_node_runs`, by the slot its node was given).  What
// bounds it is the launch of a graph node, not bytes or operations (5
// bytes read, 20 written).
//
// The stamp kernel, one thread too, writes the device's `%globaltimer`
// (ns) into a ring of rows in device memory, one row per run of the
// step: stamp 0 advances the row counter that lies in device memory
// beside the ring, so a replayed graph writes each run into a row of its
// own with no argument of the host's (`kernels/graph_flow.stamp`).
//
// Entering a node (`graph_flow_begin`), in stream-capture terms:
//   1. read the capturing graph and its current dependencies from the
//      outer stream (`cudaStreamGetCaptureInfo`);
//   2. create the node's handle in that graph and capture a condition
//      kernel that sets it for the first test (counter reset to 0);
//   3. add the conditional node behind that kernel (`cudaGraphAddNode`)
//      and make it the outer stream's only dependency
//      (`cudaStreamUpdateCaptureDependencies`), so that what the outer
//      stream captures next runs after the node;
//   4. begin capturing the side stream into the node's body graph
//      (`cudaStreamBeginCaptureToGraph`).
// A WHILE body ends with `graph_flow_next`: the condition kernel, on the
// body stream, bumps the counter and sets the handle for the next test.
// `graph_flow_end` ends the body's capture.  Nodes nest: the outer stream
// of a nested node is the body stream of the node around it.
//
// Memory.  PyTorch's caching allocator routes a stream's allocations to
// a graph's private pool only when a filter registered for that pool
// accepts the stream; the filter PyTorch registers at capture_begin
// accepts the outer capture alone.  At the outermost node this file
// swaps it (endAllocateToPool / beginAllocateToPool on the same pool,
// and releasePool to undo the second reference the swap takes) for one
// that accepts every capture in `ids`: the outer capture and each body
// being captured.  PyTorch's capture_end removes it as it would its own.
#include <cuda_runtime.h>
#include <c10/cuda/CUDACachingAllocator.h>

#include <algorithm>
#include <mutex>
#include <utility>
#include <vector>

#if CUDART_VERSION < 12040
#error "graph_flow.cu needs CUDA 12.4 or later (conditional nodes with body capture)"
#endif

namespace {

constexpr int kSlots = 256;                  // named nodes counted apart

__device__ unsigned long long g_runs = 0;   // condition-kernel executions
__device__ unsigned long long g_node_runs[kSlots];   // the same, per slot

__global__ void condition_kernel(cudaGraphConditionalHandle handle,
                                 const bool* pred, int negate, int* counter,
                                 int cap, int first, int slot) {
  unsigned int go = 1u;
  if (pred != nullptr) go = (*pred != (negate != 0)) ? 1u : 0u;
  if (counter != nullptr) {
    int i = first ? 0 : *counter + 1;
    *counter = i;
    if (i >= cap) go = 0u;
  }
  cudaGraphSetConditional(handle, go);
  g_runs += 1ULL;
  g_node_runs[slot] += 1ULL;
}

// `ring` holds `rows` rows of `width` stamps; `*row_count` the rows begun.
// Stamp `k` of the current row; stamp 0 begins a row.  Without a
// `row_count` the stamp goes to `ring[k]` (the host's calibration).
__global__ void stamp_kernel(long long* ring, long long* row_count, int rows,
                             int width, int k) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long row = 0;
  if (row_count != nullptr) {
    if (k == 0) *row_count += 1;
    row = (*row_count - 1) % rows;
  }
  ring[row * width + k] = static_cast<long long>(now);
}

cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status,
                         unsigned long long* id, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, id, graph, deps, nullptr, n);
#else
  return cudaStreamGetCaptureInfo(s, status, id, graph, deps, n);
#endif
}

struct Routing {
  std::mutex mu;
  std::vector<unsigned long long> ids;   // captures routed to `pool`
  int depth = 0;                         // nodes being captured
};

Routing& routing() {
  static Routing r;
  return r;
}

bool routed(cudaStream_t s) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (capture_info(s, &status, &id, nullptr, nullptr, nullptr) !=
          cudaSuccess ||
      status != cudaStreamCaptureStatusActive)
    return false;
  Routing& r = routing();
  std::lock_guard<std::mutex> lock(r.mu);
  return std::find(r.ids.begin(), r.ids.end(), id) != r.ids.end();
}

}  // namespace

// Begin capturing the body of a conditional node (kind 0: IF, 1: WHILE)
// entered from `outer`, on `body`.  The first test reads `pred` (a device
// bool; null: true), negated if `negate`; for a loop `counter` (a device
// int) is reset to 0 and the body runs while the test holds and the
// counter is below `cap`.  `slot` (below `kSlots`) counts the node's
// condition-kernel runs.  `pool_a`, `pool_b`: the capturing graph's
// mempool id.  Writes the node's handle; returns a CUDA error code, -1 if
// `outer` is not capturing, or -2 for a slot out of range.
extern "C" int graph_flow_begin(int kind, cudaStream_t outer,
                                cudaStream_t body, const void* pred,
                                int negate, void* counter, int cap, int slot,
                                int device, unsigned long long pool_a,
                                unsigned long long pool_b,
                                unsigned long long* handle_out) {
  if (slot < 0 || slot >= kSlots) return -2;
  cudaStreamCaptureStatus status;
  unsigned long long outer_id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  cudaError_t err = capture_info(outer, &status, &outer_id, &graph, &deps, &n);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return -1;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  condition_kernel<<<1, 1, 0, outer>>>(handle,
                                       static_cast<const bool*>(pred), negate,
                                       static_cast<int*>(counter), cap, 1,
                                       slot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(outer, &status, &outer_id, &graph, &deps, &n);
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
#endif
  if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(outer, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(outer, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0],
                                      nullptr, nullptr, 0,
                                      cudaStreamCaptureModeRelaxed);
  if (err != cudaSuccess) return err;
  unsigned long long body_id = 0;
  err = capture_info(body, &status, &body_id, nullptr, nullptr, nullptr);
  if (err != cudaSuccess) return err;

  Routing& r = routing();
  bool install = false;
  {
    std::lock_guard<std::mutex> lock(r.mu);
    if (r.depth == 0) {
      r.ids.assign(1, outer_id);
      install = true;
    }
    r.ids.push_back(body_id);
    r.depth += 1;
  }
  if (install) {
    namespace alloc = c10::cuda::CUDACachingAllocator;
    // MempoolId_t: a pair of capture ids, in every PyTorch version
    const std::pair<unsigned long long, unsigned long long> pool{pool_a,
                                                                 pool_b};
    const auto dev = static_cast<c10::DeviceIndex>(device);
    alloc::endAllocateToPool(dev, pool);
    alloc::beginAllocateToPool(dev, pool, routed);
    alloc::releasePool(dev, pool);
  }
  *handle_out = handle;
  return 0;
}

// The end of a WHILE body: bump the counter, test `pred` (null: true)
// and the cap, and set the handle for the next iteration.
extern "C" int graph_flow_next(cudaStream_t body, unsigned long long handle,
                               const void* pred, void* counter, int cap,
                               int slot) {
  if (slot < 0 || slot >= kSlots) return -2;
  condition_kernel<<<1, 1, 0, body>>>(handle, static_cast<const bool*>(pred),
                                      0, static_cast<int*>(counter), cap, 0,
                                      slot);
  return cudaGetLastError();
}

// End the capture of the body begun on `body`.
extern "C" int graph_flow_end(cudaStream_t body) {
  cudaStreamCaptureStatus status;
  unsigned long long body_id = 0;
  cudaError_t info = capture_info(body, &status, &body_id, nullptr, nullptr,
                                  nullptr);
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamEndCapture(body, &graph);
  Routing& r = routing();
  {
    std::lock_guard<std::mutex> lock(r.mu);
    if (info == cudaSuccess) {
      auto it = std::find(r.ids.begin(), r.ids.end(), body_id);
      if (it != r.ids.end()) r.ids.erase(it);
    }
    if (r.depth > 0) r.depth -= 1;
  }
  return err;
}

// Condition-kernel executions since the last reset, in all and per slot
// (the first `n` slots; synchronous reads).
extern "C" int graph_flow_runs(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, g_runs, sizeof(*out));
}

extern "C" int graph_flow_node_runs(unsigned long long* out, int n) {
  if (n < 0 || n > kSlots) return -2;
  return cudaMemcpyFromSymbol(out, g_node_runs, n * sizeof(*out));
}

extern "C" int graph_flow_reset_runs() {
  const unsigned long long zero = 0;
  static const unsigned long long zeros[kSlots] = {};
  cudaError_t err = cudaMemcpyToSymbol(g_runs, &zero, sizeof(zero));
  if (err != cudaSuccess) return err;
  return cudaMemcpyToSymbol(g_node_runs, zeros, sizeof(zeros));
}

// Stamp `k` on `stream` (module comment); a launch, or under capture a
// kernel node of the graph.
extern "C" int graph_flow_stamp(cudaStream_t stream, void* ring,
                                void* row_count, int rows, int width, int k) {
  stamp_kernel<<<1, 1, 0, stream>>>(static_cast<long long*>(ring),
                                    static_cast<long long*>(row_count), rows,
                                    width, k);
  return cudaGetLastError();
}
