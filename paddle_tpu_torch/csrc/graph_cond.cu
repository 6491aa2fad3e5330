// Conditional nodes for CUDA-graph capture: the `if` and the `while` of
// a captured step (jit/to_static.py, static/nn.py).
//
// A CUDA graph cannot branch on a device value from the host. CUDA 12.4
// adds conditional nodes: a node whose body graph runs when (kIf) or as
// long as (kWhile) a handle's value is non-zero, the value being set on
// the device by cudaGraphSetConditional. graph_cond_begin, called while
// `parent` is capturing, (1) creates the handle, (2) captures a one-thread
// kernel that sets it from the bool at `flag`, (3) adds the conditional
// node after the parent's current capture dependencies, (4) makes the
// node the parent's only dependency, and (5) starts capturing `body`
// into the node's body graph. graph_cond_end captures, for a while node,
// the kernel that sets the handle again from `flag` (the condition as
// the body left it), then ends the body's capture. The parent's capture
// then goes on after the node.
//
// The caller routes the body's allocations to the parent graph's memory
// pool and keeps the body stream current while the body is captured.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* flag) {
    cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n) {
#if CUDART_VERSION >= 13000
    return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps,
                                    nullptr, n);
#else
    return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, n);
#endif
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph,
                     const cudaGraphNode_t* deps, size_t n,
                     cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
    return cudaGraphAddNode(node, graph, deps, nullptr, n, params);
#else
    return cudaGraphAddNode(node, graph, deps, n, params);
#endif
}

cudaError_t set_dependency(cudaStream_t s, cudaGraphNode_t* node) {
#if CUDART_VERSION >= 13000
    return cudaStreamUpdateCaptureDependencies(
        s, node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
    return cudaStreamUpdateCaptureDependencies(
        s, node, 1, cudaStreamSetCaptureDependencies);
#endif
}

}  // namespace

// A failed call returns step * 10000 + its cudaError_t, so the caller
// can name the step.
#define CHECK_AT(step, call)                                        \
    do {                                                            \
        cudaError_t err_ = (call);                                  \
        if (err_ != cudaSuccess) return (step) * 10000 + (int)err_; \
    } while (0)
#define CHECK(call) CHECK_AT(0, call)

// kind: 0 = if, 1 = while. Returns 0 or a cudaError_t (-1: `parent` is
// not capturing).
extern "C" int graph_cond_begin(void* parent, void* body, const bool* flag,
                                int kind, unsigned long long* handle_out) {
    cudaStream_t ps = static_cast<cudaStream_t>(parent);
    cudaStream_t bs = static_cast<cudaStream_t>(body);
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t n = 0;
    CHECK_AT(1, capture_info(ps, &status, &graph, &deps, &n));
    if (status != cudaStreamCaptureStatusActive) return -1;
    cudaGraphConditionalHandle handle;
    CHECK_AT(2, cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                                 cudaGraphCondAssignDefault));
    set_condition_kernel<<<1, 1, 0, ps>>>(handle, flag);
    CHECK_AT(3, cudaGetLastError());
    CHECK_AT(4, capture_info(ps, &status, &graph, &deps, &n));
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type =
        kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    CHECK_AT(5, add_node(&node, graph, deps, n, &params));
    CHECK_AT(6, set_dependency(ps, &node));
    CHECK_AT(7, cudaStreamBeginCaptureToGraph(
        bs, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
        cudaStreamCaptureModeThreadLocal));
    *handle_out = static_cast<unsigned long long>(handle);
    return 0;
}

extern "C" int graph_cond_end(void* body, const bool* flag, int kind,
                              unsigned long long handle) {
    cudaStream_t bs = static_cast<cudaStream_t>(body);
    if (kind == 1) {
        set_condition_kernel<<<1, 1, 0, bs>>>(
            static_cast<cudaGraphConditionalHandle>(handle), flag);
        CHECK_AT(8, cudaGetLastError());
    }
    cudaGraph_t graph;
    CHECK_AT(9, cudaStreamEndCapture(bs, &graph));
    return 0;
}

// A stream of its own (non-blocking, as torch's are) for a body's
// capture: torch.cuda.Stream() hands out streams from a pool of 32 that
// wraps around, so two of its streams can be one CUDA stream, and a
// body captured on the stream the step captures on fails.
extern "C" int graph_cond_stream_create(void** out) {
    cudaStream_t s;
    CHECK(cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking));
    *out = s;
    return 0;
}

// Whether `stream` is capturing (cudaStreamCaptureStatus: 0 none, 1
// active, 2 invalidated), for the caller's error messages.
extern "C" int graph_cond_stream_status(void* stream, int* status) {
    cudaStreamCaptureStatus st;
    CHECK(cudaStreamIsCapturing(static_cast<cudaStream_t>(stream), &st));
    *status = static_cast<int>(st);
    return 0;
}

// The runtime's version, for the caller's check (conditional nodes need
// 12.4).
extern "C" int graph_cond_versions(int* runtime, int* driver) {
    CHECK(cudaRuntimeGetVersion(runtime));
    CHECK(cudaDriverGetVersion(driver));
    return 0;
}
