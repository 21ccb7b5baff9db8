// A whole llama block for one token for Hopper (sm_90a), one launch:
//   xn = rms(x) g1; qkv = xn Wqkv^T; q, k = rope(q), rope(k); a = causal
//   attention of q over the cache rows < npast plus the fresh k/v (GQA);
//   x2 = x + a Wo^T; h = silu(rms(x2) g2 Wg^T) * (rms(x2) g2 Wu^T);
//   y = x2 + h Wd^T.   Returns y, the roped k_new, v_new.
//
// Replaces ggmlsharp_tpu/kernels/llama_layer.py::_call_llama_layer (entry
// llama_layer_step), called once a block on every b = 1 decode step of the
// whole-block llama route. All arithmetic is f32; no activation is quantized;
// the four weights are Q4_0 in the port's layout (qs uint8 [N, K/2] in ggml's
// nibble order, d f16 [N, K/32]). Everything is in element order, with one
// exception the function itself carries: the block route's wo is a second
// Q4_0 matrix, quantized from wo with its columns regrouped, so attention
// output element e is the activation of wo column slot[e] (the wrapper's
// module says where the grouping comes from). The cache [T, E_kv] (bf16 or
// f32) is read only: the caller writes k_new/v_new to row npast afterwards,
// so the stale row npast is never attended and the fresh row is attended
// unrounded. cos/sin [D/2] come from the caller, made once a step from npast
// on the device, so the kernel and ops.rope rotate by the same f32 values.
//
// What bounds it: the HBM bytes of the weights, (2*E*E + 2*E*E_kv + 3*E*F) *
// 18/32 a call (113.8 MB at Llama-7B: 34.0 us at 3.35 TB/s), plus the live
// cache rows. Five dependent matrix-vector phases at one row and the grid
// barriers between them keep it above that bound.
//
// Design: gpt2_layer.cu's plan with llama's differences. A cooperative
// launch of a persistent grid (every block resident), phases separated by
// grid-wide barriers, small intermediates in an L2-resident scratch:
//   1. every block computes rms(x) g1 into its own shared memory (the mean
//      is recomputed by each block: cheaper than a barrier), then the grid's
//      warps share the E + 2 E_kv qkv rows;                           barrier
//   2. attention: one block an item (query head, chunk of the live rows). It
//      ropes its head's q (scaled) and, in chunk 0, the KV head's fresh k
//      into shared memory; its 8 warps take rows in turn with an online
//      softmax, lane l owning features l, l + 32, ...; the fresh f32 row
//      seeds chunk 0. Each item leaves an unnormalised (max, sum, out[D])
//      partial; the first query head of a KV head writes the roped k_new;
//                                                                      barrier
//   3. every block merges the partials of all heads into shared memory at
//      wo's column slots, then the warps share the E rows of wo (+ x); barrier
//   4. every block computes rms(x2) g2 in shared memory, then a warp takes
//      gate row n and up row F + n together and writes silu(g) * u;    barrier
//   5. every block loads that product (F floats, 43 KB at F 11008: dynamic
//      shared memory, opted in above 48 KB) and down's E rows of K = F go to
//      blocks, LAYER_RW rows a pass, a block's warps splitting K (+ x2).
// Matrix-vector rows are dealt to warps round-robin through q4_dot.cuh's
// inner loop with the activation vector in shared memory. F/32 need not be a
// multiple of 16 (masked). npast is read on the device; rows >= T are never
// read.
//
// Tunables (-D overrides them; scripts/probe_q8_kernels.py times the
// alternatives): LAYER_RW weight rows a warp pass; LAYER_CHUNKS attention
// items a head; LAYER_MAX_BLOCKS_SM resident blocks an SM (the products want
// loads in flight more than the barriers want few blocks: 4 ran 9% faster
// than 2, 1 ran 56% slower); LAYER_NO_MATVEC 1 skips every product and leaves
// barriers, norms, rope, attention and the merge. L2 prefetches of wo during
// attention, as gpt2_layer.cu sends them, changed nothing here (a block's
// weights are twice the L2) and are not sent.
#ifndef LAYER_RW
#define LAYER_RW 2
#endif
#ifndef LAYER_CHUNKS
#define LAYER_CHUNKS 8
#endif
#ifndef LAYER_MAX_BLOCKS_SM
#define LAYER_MAX_BLOCKS_SM 4
#endif
#ifndef LAYER_NO_MATVEC
#define LAYER_NO_MATVEC 0
#endif
#include <cooperative_groups.h>

#include "q4_dot.cuh"

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
  const float *cosv, *sinv;
  const uint8_t *qa, *qo, *qg, *qd;
  const __half *da, *dO, *dg, *dd;
  const float *g1, *g2;
  const int* slot;
  float *y, *qkv, *kn, *part, *x2, *act;
  int E, H, Hkv, F, T;
  float eps;
  int kv_bf16, rope_mode;
};

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = q4::warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) t += red[i];
  __syncthreads();
  return t;
}

// vec[i] = src[i] * rsqrt(mean(src^2) + eps) * g[i]. COHERENT: src was
// written earlier in this launch by other blocks.
template <bool COHERENT>
__device__ void rms_norm(const float* src, const float* g, int E, float eps, float* vec,
                         float* red) {
  float q = 0.f;
  for (int i = threadIdx.x; i < E; i += THREADS) {
    const float v = COHERENT ? __ldcg(src + i) : __ldg(src + i);
    vec[i] = v;  // read back below by this thread only
    q = fmaf(v, v, q);
  }
  const float rs = rsqrtf(block_sum(q, red) / (float)E + eps);
  for (int i = threadIdx.x; i < E; i += THREADS) vec[i] = vec[i] * rs * __ldg(g + i);
  __syncthreads();
}

// out[n] = vec . W[n] (+ res[n]) for the rows dealt to this warp:
// n = gwarp + j * nwarps. RES: 0 none, 1 read-only input.
template <int RES>
__device__ __forceinline__ void matvec(const float* vec, int K, const uint8_t* qs,
                                       const __half* d, const float* res, int N, float* out,
                                       int gwarp, int nwarps, int lane) {
  const int rows = LAYER_NO_MATVEC ? 0 : N;
  for (int n0 = gwarp; n0 < rows; n0 += RW * nwarps) {
    const uint8_t* q[RW];
    const __half* dd[RW];
    q4::row_ptrs(qs, d, K, N, n0, nwarps, q, dd);
    float acc[1][RW];
    q4::warp_dot<1, RW, q4::X_PLAIN>(vec, 0, 1, q, dd, K, lane, acc);
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      float v = q4::warp_sum(acc[0][w]);  // every lane holds the sum
      const int n = n0 + w * nwarps;
      if (lane == w && n < N) {
        if (RES == 1) v += __ldg(res + n);
        out[n] = v;
      }
    }
  }
}

// act[n] = silu(vec . Wg[n]) * (vec . Wu[n]); gate row n and up row F + n of
// qs [2F, K/2] meet in one warp.
__device__ __forceinline__ void gate_up(const float* vec, int K, const uint8_t* qs,
                                        const __half* d, int F, float* act, int gwarp,
                                        int nwarps, int lane) {
  const int rows = LAYER_NO_MATVEC ? 0 : F;
  for (int n = gwarp; n < rows; n += nwarps) {
    const uint8_t* q[2];
    const __half* dd[2];
    q4::row_ptrs(qs, d, K, 2 * F, n, F, q, dd);
    float acc[1][2];
    q4::warp_dot<1, 2, q4::X_PLAIN>(vec, 0, 1, q, dd, K, lane, acc);
    const float g = q4::warp_sum(acc[0][0]);
    const float u = q4::warp_sum(acc[0][1]);
    if (lane == 0) act[n] = q4::swiglu(g, u);
  }
}

// out[n] = vec . W[n] + res[n] for a weight of few, long rows (down: E rows
// of K = F): a block takes RW consecutive rows a pass and its warps split K,
// every WARPS-th 512-element step each; their sums meet in shared memory in
// a fixed order. res was written earlier in this launch.
__device__ __forceinline__ void matvec_ksplit(const float* vec, int K, const uint8_t* qs,
                                              const __half* d, const float* res, int N,
                                              float* out, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = LAYER_NO_MATVEC ? 0 : N;
  for (int n0 = blockIdx.x * RW; n0 < rows; n0 += gridDim.x * RW) {
    const uint8_t* q[RW];
    const __half* dd[RW];
    q4::row_ptrs(qs, d, K, N, n0, 1, q, dd);
    float acc[1][RW];
    q4::warp_dot<1, RW, q4::X_PLAIN>(vec, 0, 1, q, dd, K, lane, acc, warp, WARPS);
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      const float v = q4::warp_sum(acc[0][w]);
      if (lane == w) red[warp * RW + w] = v;
    }
    __syncthreads();
    if (threadIdx.x < RW && n0 + threadIdx.x < N) {
      const int n = n0 + threadIdx.x;
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) v += red[i * RW + threadIdx.x];
      out[n] = v + __ldcg(res + n);
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

// dst[i] = rope(src)[i] * mul for one head of D features: pair t is
// (2t, 2t + 1) in mode 0 (ggml interleaved) and (t, t + D/2) in mode 2
// (NeoX halves), rotated by (cos[t], sin[t]). src was written earlier in
// this launch. copy: a second destination for the unscaled result, or null.
__device__ __forceinline__ void rope_head(const LayerArgs& a, const float* src, int D,
                                          float mul, float* dst, float* copy) {
  if (threadIdx.x < (D >> 1)) {
    const int t = threadIdx.x;
    const int i0 = (a.rope_mode & 2) ? t : 2 * t;
    const int i1 = (a.rope_mode & 2) ? t + (D >> 1) : 2 * t + 1;
    const float c = __ldg(a.cosv + t), s = __ldg(a.sinv + t);
    const float u = __ldcg(src + i0), v = __ldcg(src + i1);
    const float r0 = u * c - v * s, r1 = u * s + v * c;
    dst[i0] = r0 * mul;
    dst[i1] = r1 * mul;
    if (copy != nullptr) {
      copy[i0] = r0;
      copy[i1] = r1;
    }
  }
}

// One (query head, chunk) item: partial[0] = running max, [1] = sum of exp,
// [2 .. 2 + D) = unnormalised output.
__device__ void attention_item(const LayerArgs& a, int head, int chunk, int live, int D,
                               float* sm_ml, float* sm_o, float* sm_q, float* sm_k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_rep = a.H / a.Hkv;
  const int hkv = head / n_rep;
  const int Ekv = a.Hkv * D;
  const int dpl = D >> 5;  // features a lane: lane, lane + 32, ...
  const int per = (live + CHUNKS - 1) / CHUNKS;
  const int r0 = chunk * per;
  const int r1 = min(live, r0 + per);
  rope_head(a, a.qkv + head * D, D, rsqrtf((float)D), sm_q, nullptr);
  if (chunk == 0)
    rope_head(a, a.qkv + a.E + hkv * D, D, 1.0f, sm_k,
              head % n_rep == 0 ? a.kn + hkv * D : nullptr);
  __syncthreads();
  float q[MAX_D / 32], o[MAX_D / 32];
#pragma unroll
  for (int j = 0; j < MAX_D / 32; ++j) {
    q[j] = j < dpl ? sm_q[lane + 32 * j] : 0.f;
    o[j] = 0.f;
  }
  float m = NEG, l = 0.f;
  if (chunk == 0 && warp == 0) {  // the fresh row, f32, seeds the softmax
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j)
      if (j < dpl) s = fmaf(q[j], sm_k[lane + 32 * j], s);
    m = q4::warp_sum(s);
    l = 1.f;
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j)
      if (j < dpl) o[j] = __ldcg(a.qkv + a.E + Ekv + hkv * D + lane + 32 * j);
  }
  for (int t = r0 + warp; t < r1; t += WARPS) {
    const size_t base = (size_t)t * Ekv + hkv * D + lane;
    float k[MAX_D / 32], v[MAX_D / 32];
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j) {
      k[j] = j < dpl ? load_kv(a.kc, base + 32 * j, a.kv_bf16) : 0.f;
      v[j] = j < dpl ? load_kv(a.vc, base + 32 * j, a.kv_bf16) : 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j) s = fmaf(q[j], k[j], s);
    s = q4::warp_sum(s);
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

// vec[slot[e]] = the attention output element e: the CHUNKS partials of e's
// head merged.
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
    vec[__ldg(a.slot + e)] = O / L;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) llama_layer_kernel(LayerArgs a) {
  extern __shared__ __align__(16) float vec[];  // max(E, F) floats
  __shared__ float red[WARPS * RW];
  __shared__ float sm_ml[2 * WARPS];
  __shared__ float sm_o[WARPS * MAX_D];
  __shared__ float sm_q[MAX_D];
  __shared__ float sm_k[MAX_D];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * WARPS;
  const int E = a.E, F = a.F, D = a.E / a.H;
  const int Ekv = a.Hkv * D;

  rms_norm<false>(a.x, a.g1, E, a.eps, vec, red);
  matvec<0>(vec, E, a.qa, a.da, nullptr, E + 2 * Ekv, a.qkv, gwarp, nwarps, lane);
  grid.sync();

  const int live = max(0, min(__ldg(a.npast), a.T));
  for (int item = blockIdx.x; item < a.H * CHUNKS; item += gridDim.x)
    attention_item(a, item / CHUNKS, item % CHUNKS, live, D, sm_ml, sm_o, sm_q, sm_k);
  grid.sync();

  merge_attention(a, D, vec);
  matvec<1>(vec, E, a.qo, a.dO, a.x, E, a.x2, gwarp, nwarps, lane);
  grid.sync();

  rms_norm<true>(a.x2, a.g2, E, a.eps, vec, red);
  gate_up(vec, E, a.qg, a.dg, F, a.act, gwarp, nwarps, lane);
  grid.sync();

  for (int i = threadIdx.x; i < F; i += THREADS) vec[i] = __ldcg(a.act + i);
  __syncthreads();
  matvec_ksplit(vec, F, a.qd, a.dd, a.x2, E, a.y, red);
}

}  // namespace

// x f32 [E]; kc, vc [T, E_kv] contiguous, bf16 (kv_bf16) or f32; npast int32
// on the device; cosv, sinv f32 [D/2]; four Q4_0 weights (qs uint8, d f16):
// a = wqkv [E + 2 E_kv, E], o = the block route's wo [E, E], g = [gate; up]
// [2F, E], d = down [E, F]; gains g1, g2 f32 [E]; slot int32 [E], a
// permutation of 0..E-1. Outputs y f32 [E], qkv f32 [E + 2 E_kv] (v_new is
// its last E_kv; q and k in it are unrotated) and kn f32 [E_kv], the roped
// k_new. Scratch, f32: part [H * 8 * (D + 2)], x2 [E], act [F]. E % 32 == 0,
// F % 32 == 0, H % Hkv == 0, D = E/H a multiple of 32 up to 128. Returns the
// CUDA error of the cooperative launch (0: launched).
extern "C" int llama_layer(const float* x, const void* kc, const void* vc, const int* npast,
                           const float* cosv, const float* sinv, const uint8_t* qa,
                           const __half* da, const uint8_t* qo, const __half* dO,
                           const uint8_t* qg, const __half* dg, const uint8_t* qd,
                           const __half* dd, const float* g1, const float* g2,
                           const int* slot, float* y, float* qkv, float* kn, float* part,
                           float* x2, float* act, int E, int H, int Hkv, int F, int T,
                           float eps, int kv_bf16, int rope_mode, cudaStream_t stream) {
  if (E <= 0 || H <= 0 || Hkv <= 0 || F <= 0 || T <= 0 || E % 32 || F % 32 || E % H || H % Hkv)
    return (int)cudaErrorInvalidValue;
  const int D = E / H;
  if (D % 32 || D > MAX_D) return (int)cudaErrorInvalidValue;
  LayerArgs a{x,  kc, vc, npast, cosv, sinv, qa, qo,   qg,  qd, da,  dO, dg, dd,  g1,
              g2, slot, y, qkv,  kn,   part, x2, act,  E,   H,  Hkv, F,  T,  eps, kv_bf16,
              rope_mode};
  const size_t smem = (size_t)(E > F ? E : F) * sizeof(float);
  // static + dynamic shared memory above 48 KB needs the opt-in; the static
  // part is under 6 KB
  static size_t smem_set = 40 * 1024;
  cudaError_t err = cudaSuccess;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(llama_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, llama_layer_kernel, THREADS,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > MAX_BLOCKS_SM) per_sm = MAX_BLOCKS_SM;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(llama_layer_kernel),
                                    dim3(per_sm * sms), dim3(THREADS), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
