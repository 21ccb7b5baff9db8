// The in-graph length-bucket switch: one CUDA graph that runs, at every
// launch, the body captured for the live length bucket.
//
// Replaces no pallas_call. It is the counterpart of the jax.lax.switch that
// ggmlsharp_tpu/models/common.py:175-183 (cached_attention, prefix_bound
// None) compiles into one executable: the branch index is computed on the
// device from the cache's lengths, idx = sum(lim > b for b in
// buckets[:-1]) with lim = max(length) + add, and no host reads it.
//
// The parent graph holds a one-thread selector kernel and, behind it, a
// conditional node whose bodies are the bodies' graphs (each a child-graph
// node): with CUDA 12.8 one cudaGraphCondTypeSwitch node over every body,
// before it a chain of cudaGraphCondTypeIf nodes, one a body, the selector
// opening exactly one. The design is chosen at build time, from the
// toolkit unless GS_SWITCH is given (graph_switch_design); CUDA refusing
// it is an error the
// caller raises, with no fallback. Two axes (a speculative round's target
// and draft buckets) combine as idx0 * nb1 + idx1.
//
// Bound: the selector reads B + B' ints and writes one conditional value;
// it is launch latency (a few microseconds), nothing on the card's rates.
#include <cuda_runtime.h>

#include <climits>

#define GS_MAX_BUCKETS 16
#define GS_MAX_BODIES 64

// 1: the switch node; 0: the chain of if nodes (-DGS_SWITCH=0 builds it
// on any toolkit, graph_switch.set_design("if_chain"))
#ifndef GS_SWITCH
#if CUDART_VERSION >= 12080
#define GS_SWITCH 1
#else
#define GS_SWITCH 0
#endif
#endif

struct GsAxis {
  const int* len;  // int32 [n] on the device: each slot's cache length
  int n;
  int add;         // lim = max(len) + add
  int nb;          // buckets, ascending; the last holds every lim
  int b[GS_MAX_BUCKETS];
};

struct GsSel {
  GsAxis ax[2];
  int naxes;
};

struct GsHandles {
  cudaGraphConditionalHandle h[GS_MAX_BODIES];
  int n;
};

struct GsGraph {
  cudaGraph_t graph;
  cudaGraphExec_t exec;
};

__device__ __forceinline__ int gs_index(const GsSel& s) {
  int idx = 0;
  for (int a = 0; a < s.naxes; ++a) {
    const GsAxis& x = s.ax[a];
    int m = INT_MIN;
    for (int i = 0; i < x.n; ++i) m = max(m, x.len[i]);
    const int lim = m + x.add;
    int j = 0;
    for (int i = 0; i + 1 < x.nb; ++i) j += lim > x.b[i];
    idx = idx * x.nb + j;
  }
  return idx;
}

__global__ void gs_select_kernel(GsSel s, GsHandles hs) {
  const int idx = gs_index(s);
#if GS_SWITCH
  cudaGraphSetConditional(hs.h[0], (unsigned)idx);
#else
  for (int i = 0; i < hs.n; ++i)
    cudaGraphSetConditional(hs.h[i], idx == i ? 1u : 0u);
#endif
}

__global__ void gs_probe_kernel(GsSel s, int* out) { *out = gs_index(s); }

static cudaError_t fill_axis(GsAxis* x, const int* len, int n, int add,
                             const int* buckets, int nb) {
  if (n < 1 || nb < 1 || nb > GS_MAX_BUCKETS || len == nullptr)
    return cudaErrorInvalidValue;
  x->len = len;
  x->n = n;
  x->add = add;
  x->nb = nb;
  for (int i = 0; i < nb; ++i) x->b[i] = buckets[i];
  return cudaSuccess;
}

// one axis when nb1 is 0
static cudaError_t fill_sel(GsSel* s, const int* len0, int n0, int add0,
                            const int* buckets0, int nb0, const int* len1,
                            int n1, int add1, const int* buckets1, int nb1) {
  cudaError_t e = fill_axis(&s->ax[0], len0, n0, add0, buckets0, nb0);
  if (e != cudaSuccess) return e;
  s->naxes = 1;
  if (nb1 > 0) {
    e = fill_axis(&s->ax[1], len1, n1, add1, buckets1, nb1);
    s->naxes = 2;
  }
  return e;
}

static cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t g,
                            const cudaGraphNode_t* deps, size_t ndeps,
                            cudaGraphNodeParams* p) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, g, deps, nullptr, ndeps, p);
#else
  return cudaGraphAddNode(node, g, deps, ndeps, p);
#endif
}

static cudaError_t build(GsGraph* out, const void* const* bodies,
                         int n_bodies, const GsSel& sel) {
  cudaGraph_t g = out->graph;
  GsHandles hs = {};
  hs.n = GS_SWITCH ? 1 : n_bodies;
  cudaError_t e;
  for (int i = 0; i < hs.n; ++i) {
    e = cudaGraphConditionalHandleCreate(&hs.h[i], g, 0, 0);
    if (e != cudaSuccess) return e;
  }
  GsSel s = sel;
  void* args[] = {&s, &hs};
  cudaKernelNodeParams kp = {};
  kp.func = (void*)gs_select_kernel;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  cudaGraphNode_t prev;
  e = cudaGraphAddKernelNode(&prev, g, nullptr, 0, &kp);
  if (e != cudaSuccess) return e;
  for (int c = 0; c < hs.n; ++c) {
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = hs.h[c];
#if GS_SWITCH
    cp.conditional.type = cudaGraphCondTypeSwitch;
    cp.conditional.size = (unsigned)n_bodies;
#else
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
#endif
    cudaGraphNode_t cond;
    e = add_node(&cond, g, &prev, 1, &cp);
    if (e != cudaSuccess) return e;
    for (unsigned i = 0; i < cp.conditional.size; ++i) {
      cudaGraphNode_t child;
      const int which = GS_SWITCH ? (int)i : c;
      e = cudaGraphAddChildGraphNode(
          &child, cp.conditional.phGraph_out[i], nullptr, 0,
          (cudaGraph_t)const_cast<void*>(bodies[which]));
      if (e != cudaSuccess) return e;
    }
    prev = cond;
  }
  return cudaGraphInstantiate(&out->exec, g, 0);
}

// The parent graph over n_bodies body graphs (cudaGraph_t, in the order of
// the combined index), instantiated; *out receives its handle.
extern "C" int graph_switch_build(const void* const* bodies, int n_bodies,
                                  const int* len0, int n0, int add0,
                                  const int* buckets0, int nb0,
                                  const int* len1, int n1, int add1,
                                  const int* buckets1, int nb1, void** out) {
  GsSel sel;
  cudaError_t e = fill_sel(&sel, len0, n0, add0, buckets0, nb0, len1, n1,
                           add1, buckets1, nb1);
  if (e != cudaSuccess) return e;
  if (n_bodies != nb0 * (nb1 > 0 ? nb1 : 1) || n_bodies > GS_MAX_BODIES)
    return cudaErrorInvalidValue;
  GsGraph* gg = new GsGraph{nullptr, nullptr};
  e = cudaGraphCreate(&gg->graph, 0);
  if (e == cudaSuccess) e = build(gg, bodies, n_bodies, sel);
  if (e != cudaSuccess) {
    if (gg->exec) cudaGraphExecDestroy(gg->exec);
    if (gg->graph) cudaGraphDestroy(gg->graph);
    delete gg;
    cudaGetLastError();
    return e;
  }
  *out = gg;
  return cudaSuccess;
}

// One launch of the parent graph on ``stream``.
extern "C" int graph_switch_launch(void* handle, cudaStream_t stream) {
  cudaError_t e = cudaGraphLaunch(static_cast<GsGraph*>(handle)->exec,
                                  stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

extern "C" int graph_switch_destroy(void* handle) {
  GsGraph* gg = static_cast<GsGraph*>(handle);
  cudaError_t e = cudaGraphExecDestroy(gg->exec);
  cudaError_t e2 = cudaGraphDestroy(gg->graph);
  delete gg;
  return e != cudaSuccess ? e : e2;
}

// The selector's index written to out (int32 on the device): the same
// device function the parent graph's selector runs, for checking it.
extern "C" int graph_switch_select(const int* len0, int n0, int add0,
                                   const int* buckets0, int nb0,
                                   const int* len1, int n1, int add1,
                                   const int* buckets1, int nb1, int* out,
                                   cudaStream_t stream) {
  GsSel sel;
  cudaError_t e = fill_sel(&sel, len0, n0, add0, buckets0, nb0, len1, n1,
                           add1, buckets1, nb1);
  if (e != cudaSuccess) return e;
  gs_probe_kernel<<<1, 1, 0, stream>>>(sel, out);
  return cudaGetLastError();
}

// 1: one switch node (CUDA 12.8); 2: a chain of if nodes.
extern "C" int graph_switch_design(int* out) {
  *out = GS_SWITCH ? 1 : 2;
  return cudaSuccess;
}

// The name and text of CUDA error ``code`` into buf (n bytes).
extern "C" int graph_switch_error(int code, char* buf, int n) {
  const char* name = cudaGetErrorName((cudaError_t)code);
  const char* text = cudaGetErrorString((cudaError_t)code);
  int i = 0;
  for (const char* p = name; *p && i + 1 < n; ++p) buf[i++] = *p;
  for (const char* p = ": "; *p && i + 1 < n; ++p) buf[i++] = *p;
  for (const char* p = text; *p && i + 1 < n; ++p) buf[i++] = *p;
  if (n > 0) buf[i] = 0;
  return cudaSuccess;
}
