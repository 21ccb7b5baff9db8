// A whole pre-LN GPT-2 block for one token for Hopper (sm_90a), one launch:
//   xn = ln1(x); qkv = xn Wa^T + ba; a = causal attention of q over the cache
//   rows < npast plus the fresh k/v; x2 = x + a Wp^T + bp; h = gelu(ln2(x2)
//   Wf^T + bf); y = x2 + h Wc^T + bc.   Returns y, k_new, v_new.
//
// Replaces ggmlsharp_tpu/kernels/gpt2_layer.py::_call_gpt2_layer (entry
// gpt2_layer_step), called once a block on every b = 1 decode step of GPT-2.
// All arithmetic is f32; no activation is quantized; the four weights are
// Q8_0 in the port's layout (qs int8 [N, K] element order, d f16 [N, K/32]).
// The cache [T, E] (bf16 or f32) is read only: the caller writes k_new/v_new
// to row npast afterwards, so the stale row npast is never attended and the
// fresh row is attended unrounded.
//
// What bounds it: the HBM bytes of the weights, 12*E*E*34/32 a call (7.5 MB
// at E 768, 20.9 MB at E 1280), plus the live cache rows. Five dependent
// matrix-vector phases at one row cannot hide their latencies behind one
// another, so the kernel sits far from that bound.
//
// Design: a cooperative launch of a persistent grid (every block resident),
// phases separated by grid-wide barriers, small intermediates in an
// L2-resident scratch:
//   1. every block computes ln1(x) into its own shared memory (the row's
//      mean and variance are recomputed by each block: cheaper than two more
//      barriers), then the grid's warps share the 3E qkv rows;       barrier
//   2. attention: one block an item (head, chunk of the live rows); its 8
//      warps take rows in turn with an online softmax, lane l owning D/32
//      features; the fresh f32 row seeds chunk 0. Each item leaves an
//      unnormalised (max, sum, out[D]) partial;                       barrier
//   3. every block merges the partials of all heads into shared memory,
//      then the warps share the E rows of proj (+ bias + x);          barrier
//   4. every block computes ln2(x2) in shared memory, then fc + GELU; barrier
//   5. every block loads h into shared memory, then cproj (+ bias + x2).
// Matrix-vector rows are dealt to warps round-robin, two rows a pass, through
// q8_dot.cuh's inner loop with the activation vector in shared memory; cproj,
// whose E rows are 4E long, instead gives a block two rows a pass and splits
// their K over its warps (a warp a row left most of the grid idle behind 12
// to 20 dependent steps). At entry every thread sends
// L2 prefetches over the weights of phases 3-5, so HBM streams them while
// phases 1-2 run. npast is read on the device; rows >= T are never read.
//
// Tunables (-D overrides them; scripts/probe_q8_kernels.py times the
// alternatives): LAYER_RW weight rows a warp pass; LAYER_CHUNKS attention
// items a head; LAYER_MAX_BLOCKS_SM resident blocks an SM (more only cost
// barrier time); LAYER_L2_PREFETCH 0 sends no prefetch; LAYER_CPROJ_KSPLIT 0
// runs cproj as the other products, a warp a row; LAYER_NO_MATVEC 1 skips
// every product and leaves barriers, layer norms, attention and the merge.
#ifndef LAYER_RW
#define LAYER_RW 2
#endif
#ifndef LAYER_CHUNKS
#define LAYER_CHUNKS 8
#endif
#ifndef LAYER_MAX_BLOCKS_SM
#define LAYER_MAX_BLOCKS_SM 2
#endif
#ifndef LAYER_L2_PREFETCH
#define LAYER_L2_PREFETCH 1
#endif
#ifndef LAYER_CPROJ_KSPLIT
#define LAYER_CPROJ_KSPLIT 1
#endif
#ifndef LAYER_NO_MATVEC
#define LAYER_NO_MATVEC 0
#endif
#include <cooperative_groups.h>

#include "q8_dot.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RW = LAYER_RW;
constexpr int CHUNKS = LAYER_CHUNKS;
static_assert(CHUNKS <= 8, "the wrapper sizes the partials' scratch for 8 chunks a head");
constexpr int MAX_D = 128;  // head width: a multiple of 32 up to this
constexpr int MAX_BLOCKS_SM = LAYER_MAX_BLOCKS_SM;
constexpr float NEG = -1e30f;

struct LayerArgs {
  const float* x;
  const void* kc;
  const void* vc;
  const int* npast;
  const int8_t *qa, *qp, *qf, *qc;
  const __half *da, *dp, *df, *dc;
  const void *ba, *bp, *bf, *bc, *g1, *b1, *g2, *b2;
  float *y, *qkv, *part, *x2, *h;
  int E, H, F, T;
  float eps;
  int kv_bf16, vec_bf16;
};

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = q8::warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) t += red[i];
  __syncthreads();
  return t;
}

template <bool COHERENT>
__device__ __forceinline__ float load_f(const float* p) {
  return COHERENT ? __ldcg(p) : __ldg(p);
}

// vec[i] = (src[i] - mean) * rsqrt(var + eps) * g[i] + b[i], two passes as
// ops.basic.norm takes them. The row is staged in vec once, so the passes
// read shared memory and not L2 three times over.
template <bool COHERENT>
__device__ void layer_norm(const float* src, const void* g, const void* b, int vec_bf16,
                           int E, float eps, float* vec, float* red) {
  float s = 0.f;
  for (int i = threadIdx.x; i < E; i += THREADS) {
    const float v = load_f<COHERENT>(src + i);
    vec[i] = v;  // read back below by this thread only
    s += v;
  }
  const float mean = block_sum(s, red) / (float)E;
  float q = 0.f;
  for (int i = threadIdx.x; i < E; i += THREADS) {
    const float c = vec[i] - mean;
    q = fmaf(c, c, q);
  }
  const float rs = rsqrtf(block_sum(q, red) / (float)E + eps);
  for (int i = threadIdx.x; i < E; i += THREADS)
    vec[i] = (vec[i] - mean) * rs * q8::load_vec(g, i, vec_bf16) +
             q8::load_vec(b, i, vec_bf16);
  __syncthreads();
}

// out[n] = act(vec . W[n] + bias[n]) (+ res[n]) for the rows dealt to this
// warp: n = gwarp + j * nwarps. RES: 0 none, 1 read-only input, 2 scratch
// written earlier in this launch.
template <bool GELU, int RES>
__device__ __forceinline__ void matvec(const float* vec, int K, const int8_t* qs,
                                       const __half* d, const void* bias, int vec_bf16,
                                       const float* res, int N, float* out, int gwarp,
                                       int nwarps, int lane) {
  const int rows = LAYER_NO_MATVEC ? 0 : N;
  for (int n0 = gwarp; n0 < rows; n0 += RW * nwarps) {
    const int8_t* q[RW];
    const __half* dd[RW];
    q8::row_ptrs(qs, d, K, N, n0, nwarps, q, dd);
    float acc[1][RW];
    q8::warp_dot<1, RW, q8::X_PLAIN>(vec, 0, 1, q, dd, K, lane, acc);
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      float v = q8::warp_sum(acc[0][w]);  // every lane holds the sum
      const int n = n0 + w * nwarps;
      if (lane == w && n < N) {
        v += q8::load_vec(bias, n, vec_bf16);
        if (GELU) v = q8::gelu(v);
        if (RES == 1) v += __ldg(res + n);
        if (RES == 2) v += __ldcg(res + n);
        out[n] = v;
      }
    }
  }
}

// The same for a weight of few, long rows (cproj: E rows of K = F): a block
// takes RW consecutive rows a pass and its warps split K, every WARPS-th
// 256-element step each; their sums meet in shared memory in a fixed order.
template <int RES>
__device__ __forceinline__ void matvec_ksplit(const float* vec, int K, const int8_t* qs,
                                              const __half* d, const void* bias,
                                              int vec_bf16, const float* res, int N,
                                              float* out, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = LAYER_NO_MATVEC ? 0 : N;
  for (int n0 = blockIdx.x * RW; n0 < rows; n0 += gridDim.x * RW) {
    const int8_t* q[RW];
    const __half* dd[RW];
    q8::row_ptrs(qs, d, K, N, n0, 1, q, dd);
    float acc[1][RW];
    q8::warp_dot<1, RW, q8::X_PLAIN>(vec, 0, 1, q, dd, K, lane, acc, warp, WARPS);
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      const float v = q8::warp_sum(acc[0][w]);
      if (lane == w) red[warp * RW + w] = v;
    }
    __syncthreads();
    if (threadIdx.x < RW && n0 + threadIdx.x < N) {
      const int n = n0 + threadIdx.x;
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) v += red[i * RW + threadIdx.x];
      v += q8::load_vec(bias, n, vec_bf16);
      if (RES == 1) v += __ldg(res + n);
      if (RES == 2) v += __ldcg(res + n);
      out[n] = v;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float load_kv(const void* p, size_t i, int is_bf16) {
  if (is_bf16) {
    const uint16_t bits = __ldg(reinterpret_cast<const uint16_t*>(p) + i);
    return __uint_as_float((uint32_t)bits << 16);
  }
  return __ldg(reinterpret_cast<const float*>(p) + i);
}

// One (head, chunk) item: partial[0] = running max, [1] = sum of exp,
// [2 .. 2 + D) = unnormalised output.
__device__ void attention_item(const LayerArgs& a, int head, int chunk, int live, int D,
                               float* sm_ml, float* sm_o) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dpl = D >> 5;  // features a lane: lane, lane + 32, ...
  const int per = (live + CHUNKS - 1) / CHUNKS;
  const int r0 = chunk * per;
  const int r1 = min(live, r0 + per);
  const float scale = rsqrtf((float)D);
  const int E = a.E;
  float q[MAX_D / 32], o[MAX_D / 32];
#pragma unroll
  for (int j = 0; j < MAX_D / 32; ++j) {
    q[j] = j < dpl ? __ldcg(a.qkv + head * D + lane + 32 * j) * scale : 0.f;
    o[j] = 0.f;
  }
  float m = NEG, l = 0.f;
  if (chunk == 0 && warp == 0) {  // the fresh row, f32, seeds the softmax
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j)
      if (j < dpl) s = fmaf(q[j], __ldcg(a.qkv + E + head * D + lane + 32 * j), s);
    m = q8::warp_sum(s);
    l = 1.f;
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j)
      if (j < dpl) o[j] = __ldcg(a.qkv + 2 * E + head * D + lane + 32 * j);
  }
  for (int t = r0 + warp; t < r1; t += WARPS) {
    const size_t base = (size_t)t * E + head * D + lane;
    float k[MAX_D / 32], v[MAX_D / 32];
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j) {
      k[j] = j < dpl ? load_kv(a.kc, base + 32 * j, a.kv_bf16) : 0.f;
      v[j] = j < dpl ? load_kv(a.vc, base + 32 * j, a.kv_bf16) : 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j) s = fmaf(q[j], k[j], s);
    s = q8::warp_sum(s);
    const float mn = fmaxf(m, s);
    const float corr = expf(m - mn), p = expf(s - mn);
    l = fmaf(l, corr, p);
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j) o[j] = fmaf(o[j], corr, p * v[j]);
    m = mn;
  }
  if (lane == 0) {
    sm_ml[2 * warp] = m;
    sm_ml[2 * warp + 1] = l;
  }
#pragma unroll
  for (int j = 0; j < MAX_D / 32; ++j)
    if (j < dpl) sm_o[warp * MAX_D + lane + 32 * j] = o[j];
  __syncthreads();
  float* part = a.part + (size_t)(head * CHUNKS + chunk) * (D + 2);
  if (threadIdx.x < D) {
    float M = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_ml[2 * w]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(sm_ml[2 * w] - M);
      L = fmaf(sm_ml[2 * w + 1], f, L);
      O = fmaf(sm_o[w * MAX_D + threadIdx.x], f, O);
    }
    part[2 + threadIdx.x] = O;
    if (threadIdx.x == 0) {
      part[0] = M;
      part[1] = L;
    }
  }
  __syncthreads();
}

// vec[e] = the attention output: the CHUNKS partials of e's head merged.
__device__ void merge_attention(const LayerArgs& a, int D, float* vec) {
  for (int e = threadIdx.x; e < a.E; e += THREADS) {
    const int head = e / D, f = e % D;
    const float* part = a.part + (size_t)head * CHUNKS * (D + 2);
    float M = NEG;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) M = fmaxf(M, __ldcg(part + c * (D + 2)));
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const float w = expf(__ldcg(part + c * (D + 2)) - M);
      L = fmaf(__ldcg(part + c * (D + 2) + 1), w, L);
      O = fmaf(__ldcg(part + c * (D + 2) + 2 + f), w, O);
    }
    vec[e] = O / L;
  }
  __syncthreads();
}

__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes, size_t gtid,
                                            size_t gthreads) {
  const char* c = reinterpret_cast<const char*>(p);
  for (size_t off = gtid * 128; LAYER_L2_PREFETCH && off < bytes; off += gthreads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + off));
}

__global__ void __launch_bounds__(THREADS) gpt2_layer_kernel(LayerArgs a) {
  extern __shared__ __align__(16) float vec[];  // max(E, F) floats
  __shared__ float red[WARPS];
  __shared__ float sm_ml[2 * WARPS];
  __shared__ float sm_o[WARPS * MAX_D];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * WARPS;
  const int E = a.E, F = a.F, D = a.E / a.H;

  {
    const size_t gtid = (size_t)blockIdx.x * THREADS + threadIdx.x;
    const size_t gthreads = (size_t)gridDim.x * THREADS;
    prefetch_l2(a.qp, (size_t)E * E, gtid, gthreads);
    prefetch_l2(a.dp, (size_t)E * E / 16, gtid, gthreads);
    prefetch_l2(a.qf, (size_t)F * E, gtid, gthreads);
    prefetch_l2(a.df, (size_t)F * E / 16, gtid, gthreads);
    prefetch_l2(a.qc, (size_t)E * F, gtid, gthreads);
    prefetch_l2(a.dc, (size_t)E * F / 16, gtid, gthreads);
  }

  layer_norm<false>(a.x, a.g1, a.b1, a.vec_bf16, E, a.eps, vec, red);
  matvec<false, 0>(vec, E, a.qa, a.da, a.ba, a.vec_bf16, nullptr, 3 * E, a.qkv, gwarp,
                   nwarps, lane);
  grid.sync();

  const int live = max(0, min(__ldg(a.npast), a.T));
  for (int item = blockIdx.x; item < a.H * CHUNKS; item += gridDim.x)
    attention_item(a, item / CHUNKS, item % CHUNKS, live, D, sm_ml, sm_o);
  grid.sync();

  merge_attention(a, D, vec);
  matvec<false, 1>(vec, E, a.qp, a.dp, a.bp, a.vec_bf16, a.x, E, a.x2, gwarp, nwarps, lane);
  grid.sync();

  layer_norm<true>(a.x2, a.g2, a.b2, a.vec_bf16, E, a.eps, vec, red);
  matvec<true, 0>(vec, E, a.qf, a.df, a.bf, a.vec_bf16, nullptr, F, a.h, gwarp, nwarps, lane);
  grid.sync();

  for (int i = threadIdx.x; i < F; i += THREADS) vec[i] = __ldcg(a.h + i);
  __syncthreads();
  if (LAYER_CPROJ_KSPLIT)
    matvec_ksplit<2>(vec, F, a.qc, a.dc, a.bc, a.vec_bf16, a.x2, E, a.y, sm_o);
  else
    matvec<false, 2>(vec, F, a.qc, a.dc, a.bc, a.vec_bf16, a.x2, E, a.y, gwarp, nwarps, lane);
}

}  // namespace

// x f32 [E]; kc, vc [T, E] contiguous, bf16 (kv_bf16) or f32; npast int32 on
// the device; four Q8_0 weights (qs int8, d f16): a [3E, E], p [E, E],
// f [F, E], c [E, F]; biases ba [3E], bp [E], bf [F], bc [E] and layer-norm
// pairs g1, b1, g2, b2 [E], all f32 or all bf16 (vec_bf16). Outputs y f32 [E]
// and qkv f32 [3E] (k_new = qkv[E:2E], v_new = qkv[2E:3E]). Scratch, f32:
// part [H * 8 * (E/H + 2)], x2 [E], h [F]. E % 32 == 0, F % 32 == 0,
// E/H a multiple of 32 up to 128. Returns the CUDA error of the cooperative
// launch (0: launched).
extern "C" int gpt2_layer(const float* x, const void* kc, const void* vc, const int* npast,
                          const int8_t* qa, const __half* da, const void* ba,
                          const int8_t* qp, const __half* dp, const void* bp,
                          const int8_t* qf, const __half* df, const void* bf,
                          const int8_t* qc, const __half* dc, const void* bc,
                          const void* g1, const void* b1, const void* g2, const void* b2,
                          float* y, float* qkv, float* part, float* x2, float* h,
                          int E, int H, int F, int T, float eps, int kv_bf16,
                          int vec_bf16, cudaStream_t stream) {
  if (E <= 0 || H <= 0 || F <= 0 || T <= 0 || E % 32 || F % 32 || E % H)
    return (int)cudaErrorInvalidValue;
  const int D = E / H;
  if (D % 32 || D > MAX_D) return (int)cudaErrorInvalidValue;
  LayerArgs a{x,  kc, vc, npast, qa, qp, qf,   qc, da, dp, df, dc, ba, bp,
              bf, bc, g1, b1,    g2, b2, y,    qkv, part, x2, h,  E,  H,  F,
              T,  eps, kv_bf16, vec_bf16};
  const size_t smem = (size_t)(E > F ? E : F) * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(gpt2_layer_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gpt2_layer_kernel, THREADS,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > MAX_BLOCKS_SM) per_sm = MAX_BLOCKS_SM;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gpt2_layer_kernel),
                                    dim3(per_sm * sms), dim3(THREADS), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
