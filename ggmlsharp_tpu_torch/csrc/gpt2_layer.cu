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
// at E 768: 2.2 us at 3.35 TB/s; 20.9 MB at E 1280), plus the live cache
// rows. The weights depend on no activation, only the products do; what
// keeps a one-token block from that bound is the chain of dependent steps
// between its four products (norms, attention, and three points where every
// CTA needs every other CTA's rows), each of which must not also wait for
// HBM.
//
// Design: a persistent grid of one CTA an SM (a cooperative launch: every
// CTA resident) that has its whole share of the weights in flight early and
// no grid barrier.
//  * CTA c of G owns rows [N c / G, N (c + 1) / G) of each of the four
//    weights. Its qs rows are one contiguous range and so are its scales.
//  * The wrapper (kernels/gpt2_layer.py::smem_plan) cuts the CTA's shares
//    into pieces and places them in shared memory (shares.cuh, shared with
//    mlp_fused_q8.cu's one-row instance); each piece has its own `full`
//    mbarrier. At 124M, 355M and 774M every share fits at once (57,
//    101, 158 KB): one piece a weight. A producer warp issues qkv's TMA bulk
//    copies (cp.async.bulk) at entry and each other weight's a phase or two
//    before it is needed (proj's once ln1's inputs are in, c_fc's once
//    attention's output is, mlp c_proj's once x2 is), so that the few loads
//    each step waits for do not queue behind the whole stream. A width whose shares do not fit (E 1536, F 6144: ~232 KB)
//    gets pieces of at most 32 KB of qs in a ring: a piece that lands on
//    earlier pieces' bytes is issued once the consumers have released them
//    (their `empty` mbarrier; every mbarrier is used once a launch, so every
//    wait is on parity 0).
//  * CW = 16 consumer warps take a piece when its barrier completes, in
//    units of RW (1 or 2) rows and every P-th 256-element step of their K,
//    RW and P chosen by the plan for the fewest rounds of the longest units
//    (q8_dot.cuh's smem_rows_dot: the weights and the activation vector
//    both in shared memory, the next step's loads issued before this
//    step's arithmetic; one warp reduction a row and unit, the partials
//    added in a fixed order).
//  * The CTAs exchange qkv, the attention output, x2 and h through a buffer
//    of 64-bit words, each a value and the tag of the launch that wrote it
//    (one more than the last launch's, kept in `sync`): a reader waits for
//    exactly the elements it reads, with no fence and no barrier (grid
//    barriers and per-head counters were 1-3 us slower a call, PERF.md §6:
//    a gpu-scope fence also waits for the SM's bulk copies in flight).
//  * Every CTA computes ln1(x) itself, then its qkv rows. Attention: one
//    CTA an item (head, chunk of the live rows), chunks enough for every
//    warp to have AR rows, at most min(LAYER_CHUNKS, G / H); the item reads
//    its head's q, k_new and v_new from the exchange once its warps' first
//    cache rows are loaded; its warps take rows in turn with an online
//    softmax, lane l owning features l, l + 32; the fresh f32 row seeds
//    chunk 0. A head of one chunk (npast < 64) writes its output to the
//    exchange; else each item leaves an unnormalised (max, sum, out[D])
//    partial and the head's last chunk to finish (a counter a head) merges
//    them. Every CTA then gathers the output (proj), x2 (ln2, every CTA
//    computing it itself) and h (cproj).
// npast is read on the device; rows >= T are never read.
//
// Tunables (-D overrides them; scripts/probe_q8_kernels.py times the
// alternatives): LAYER_CHUNKS the most attention items a head (8; 4 was
// within 2 us at npast 32); LAYER_NO_MATVEC 1 streams no weight and skips
// every product, leaving the norms, the exchanges and attention
// (chip_smoke.py times it); LAYER_TRACE 1, a diagnostic build, writes each
// CTA's clock at the phase boundaries over the partials' scratch
// (scripts/probe_q8_kernels.py trace reads them).
#ifndef LAYER_CHUNKS
#define LAYER_CHUNKS 8
#endif
#ifndef LAYER_NO_MATVEC
#define LAYER_NO_MATVEC 0
#endif
#ifndef LAYER_TRACE
#define LAYER_TRACE 0
#endif
#include "persist.cuh"
#include "q8_dot.cuh"
#include "shares.cuh"

namespace {

constexpr int CW = 16;       // consumer warps (kernels/gpt2_layer.py _CONSUMER_WARPS)
constexpr int NC = CW * 32;  // consumer threads (the producer warp is the last)
constexpr int THREADS = NC + 32;
constexpr int CHUNKS = LAYER_CHUNKS;
static_assert(CHUNKS >= 1 && CHUNKS <= 8,
              "the wrapper sizes the partials' scratch for 8 chunks a head");
constexpr int MAX_D = 128;  // head width: a multiple of 32 up to this
constexpr int LNP = 5;      // elements of an E vector a consumer thread takes: E <= LNP * NC
constexpr float NEG = -1e30f;

using shares::H_ATT;
using shares::H_BAR;
using shares::H_FIRST;
using shares::H_G;
using shares::H_LEN;
using shares::H_N;
using shares::H_RED;
using shares::H_RING;
using shares::H_SMEM;
using shares::MAX_PIECES;
using shares::Mat;
using shares::PIECE_INTS;
using shares::Plan;

struct LayerArgs {
  const float* x;
  const void* kc;
  const void* vc;
  const int* npast;
  const int8_t* qs[4];   // c_attn, attn c_proj, c_fc, mlp c_proj
  const __half* d[4];
  const void* bias[4];
  const void *g1, *b1, *g2, *b2;
  float *y, *qkv, *part;
  // the vectors the CTAs exchange, each element with this launch's tag:
  // qkv [3E], the attention output [E], x2 [E], h [F]
  unsigned long long* xch;
  unsigned* sync;  // [1] the launch generation, [2 + h] head h's finished chunks
  int E, H, F, T;
  float eps;
  Plan plan;
};

using persist::await;
using persist::mbar_arrive;
using persist::mbar_wait;
using persist::peek;
using persist::put;

__device__ __forceinline__ void csync() { persist::csync<NC>(); }

// ---- the weights -----------------------------------------------------------

__device__ __forceinline__ Mat mat_of(const LayerArgs& a, int w) {
  return shares::share(a.qs[w], a.d[w], w == 0 ? 3 * a.E : w == 2 ? a.F : a.E,
                       w == 3 ? a.F : a.E);
}

// The pieces of the producer warp's lane 0, in plan order.
__device__ __forceinline__ void issue(const LayerArgs& a, int p0, int p1, unsigned char* ring,
                                      uint64_t* full, uint64_t* empty) {
  shares::issue(a.plan, [&](int w) { return mat_of(a, w); }, p0, p1, ring, full, empty);
}

// The consumers' go-ahead to the producer for weight w's pieces (named
// barrier 1 + w): ln1's inputs are in (proj), attention's output is in
// (c_fc), x2 is in (mlp c_proj).
__device__ __forceinline__ void release_weight(int w) {
  if (w == 1) asm volatile("bar.arrive 2, %0;" ::"n"(NC + 32) : "memory");
  if (w == 2) asm volatile("bar.arrive 3, %0;" ::"n"(NC + 32) : "memory");
  if (w == 3) asm volatile("bar.arrive 4, %0;" ::"n"(NC + 32) : "memory");
}

// The producer warp: qkv's pieces at once, each other weight's once the
// consumers let it go (release_weight), a phase or two before it is
// needed: the stream is spread over the launch, so that the few loads each
// step waits for (ln1's inputs, the cache rows, the exchange) do not queue
// behind all of it.
__device__ void produce(const LayerArgs& a, unsigned char* ring, uint64_t* full,
                        uint64_t* empty) {
  const bool lead = !LAYER_NO_MATVEC && (threadIdx.x & 31) == 0;
  if (lead) issue(a, 0, a.plan.hdr[H_FIRST + 1], ring, full, empty);
  asm volatile("bar.sync 2, %0;" ::"n"(NC + 32) : "memory");
  if (lead) issue(a, a.plan.hdr[H_FIRST + 1], a.plan.hdr[H_FIRST + 2], ring, full, empty);
  asm volatile("bar.sync 3, %0;" ::"n"(NC + 32) : "memory");
  if (lead) issue(a, a.plan.hdr[H_FIRST + 2], a.plan.hdr[H_FIRST + 3], ring, full, empty);
  asm volatile("bar.sync 4, %0;" ::"n"(NC + 32) : "memory");
  if (lead) issue(a, a.plan.hdr[H_FIRST + 3], a.plan.hdr[H_N], ring, full, empty);
}

// The consumers' pass over weight w's pieces (shares.cuh).
__device__ __forceinline__ void consume(const LayerArgs& a, int w, const Mat& m, const float* vec,
                                        const unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, float* red, long long* tr = nullptr) {
  if (LAYER_NO_MATVEC) return;
  shares::consume<CW>(a.plan, w, m, vec, ring, full, empty, red, LAYER_TRACE ? tr : nullptr);
}

// Row i of the CTA's share of weight w: its partials added in split order.
__device__ __forceinline__ float row_total(const LayerArgs& a, int w, int i, const float* red) {
  if (LAYER_NO_MATVEC) return 0.f;
  return shares::row_total<CW>(a.plan, w, i, red);
}

// ---- the block's other steps (consumer threads) ------------------------

// The sum of v over the consumer threads, the same in every thread: each
// warp adds the CW warp sums itself (a butterfly: every lane the same
// value). buf must not be read again before the next csync.
__device__ __forceinline__ float block_sum(float v, float* buf) {
  v = q8::warp_sum(v);
  const int lane = threadIdx.x & 31;
  if (lane == 0) buf[threadIdx.x >> 5] = v;
  csync();
  return q8::warp_sum(lane < CW ? buf[lane] : 0.f);
}

// A gain or bias element: the j-th a thread loaded at entry into registers,
// or element i of a copy in shared memory.
__device__ __forceinline__ float gain_at(const float (&g)[LNP], int j, int) { return g[j]; }
__device__ __forceinline__ float gain_at(float* const& g, int, int i) { return g[i]; }

// vec[i] = (src[i] - mean) * rsqrt(var + eps) * g[i] + b[i], two passes as
// ops.basic.norm takes them; thread t takes i = t + j NC. SMEM: src is
// shared memory (vec itself: each thread reads and writes its own elements).
template <bool SMEM, typename Gain>
__device__ void layer_norm(const float* src, const Gain& g, const Gain& b, int E, float eps,
                           float* vec, float* bred, float* bred2) {
  float v[LNP];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < LNP; ++j) {
    const int i = threadIdx.x + j * NC;
    v[j] = i < E ? (SMEM ? src[i] : __ldg(src + i)) : 0.f;
    s += v[j];
  }
  const float mean = block_sum(s, bred) / (float)E;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < LNP; ++j) {
    const float c = threadIdx.x + j * NC < E ? v[j] - mean : 0.f;
    q = fmaf(c, c, q);
  }
  const float rs = rsqrtf(block_sum(q, bred2) / (float)E + eps);
#pragma unroll
  for (int j = 0; j < LNP; ++j) {
    const int i = threadIdx.x + j * NC;
    if (i < E) vec[i] = (v[j] - mean) * rs * gain_at(g, j, i) + gain_at(b, j, i);
  }
  csync();
}

// Element i of a read-only bf16 (B16) or f32 vector. The storage type is a
// template argument, so that a run of these loads is one straight block
// whose loads are all in flight before the first is used.
template <bool B16>
__device__ __forceinline__ float ld_vec(const void* p, size_t i) {
  if constexpr (B16) {
    const uint16_t bits = __ldg(reinterpret_cast<const uint16_t*>(p) + i);
    return __uint_as_float((uint32_t)bits << 16);
  } else {
    return __ldg(reinterpret_cast<const float*>(p) + i);
  }
}

// One (head, chunk) item: partial[0] = running max, [1] = sum of exp,
// [2 .. 2 + D) = unnormalised output. A warp takes rows r0 + warp, + CW, ...
// and keeps AR of them in flight; its first AR are loaded before the head's
// q, k and v rows are awaited.
constexpr int AR = 4;
template <bool KVB>
__device__ void attention_item(const LayerArgs& a, int head, int chunk, int chunks, int live,
                               int D, unsigned tag, float* sm_ml, float* sm_o, float* sm_qkv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dpl = D >> 5;  // features a lane: lane, lane + 32, ...
  const int per = (live + chunks - 1) / chunks;
  const int r0 = chunk * per;
  const int r1 = min(live, r0 + per);
  const int E = a.E;
  float kb[AR][MAX_D / 32], vb[AR][MAX_D / 32];
  auto load_rows = [&](int t0) {
#pragma unroll
    for (int r = 0; r < AR; ++r) {
      const int t = t0 + r * CW;
#pragma unroll
      for (int j = 0; j < MAX_D / 32; ++j) {
        const size_t at = (size_t)t * E + head * D + lane + 32 * j;
        kb[r][j] = t < r1 && j < dpl ? ld_vec<KVB>(a.kc, at) : 0.f;
        vb[r][j] = t < r1 && j < dpl ? ld_vec<KVB>(a.vc, at) : 0.f;
      }
    }
  };
  int t0 = r0 + warp;
  load_rows(t0);
  if (threadIdx.x < 3 * D) {  // the head's q, k_new, v_new, as they come in
    const int part = threadIdx.x / D, f = threadIdx.x % D;
    const unsigned long long* p = a.xch + part * E + head * D + f;
    sm_qkv[threadIdx.x] = await(p, peek(p), tag);
  }
  csync();
  const float scale = rsqrtf((float)D);
  float q[MAX_D / 32], o[MAX_D / 32];
#pragma unroll
  for (int j = 0; j < MAX_D / 32; ++j) {
    q[j] = j < dpl ? sm_qkv[lane + 32 * j] * scale : 0.f;
    o[j] = 0.f;
  }
  float m = NEG, l = 0.f;
  if (chunk == 0 && warp == 0) {  // the fresh row, f32, seeds the softmax
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j)
      if (j < dpl) s = fmaf(q[j], sm_qkv[D + lane + 32 * j], s);
    m = q8::warp_sum(s);
    l = 1.f;
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j)
      if (j < dpl) o[j] = sm_qkv[2 * D + lane + 32 * j];
  }
  while (t0 < r1) {
#pragma unroll
    for (int r = 0; r < AR; ++r) {
      if (t0 + r * CW < r1) {  // the same for the whole warp
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < MAX_D / 32; ++j) s = fmaf(q[j], kb[r][j], s);
        s = q8::warp_sum(s);
        const float mn = fmaxf(m, s);
        const float corr = expf(m - mn), p = expf(s - mn);
        l = fmaf(l, corr, p);
#pragma unroll
        for (int j = 0; j < MAX_D / 32; ++j) o[j] = fmaf(o[j], corr, p * vb[r][j]);
        m = mn;
      }
    }
    t0 += AR * CW;
    if (t0 < r1) load_rows(t0);
  }
  if (lane == 0) {
    sm_ml[2 * warp] = m;
    sm_ml[2 * warp + 1] = l;
  }
#pragma unroll
  for (int j = 0; j < MAX_D / 32; ++j)
    if (j < dpl) sm_o[warp * D + lane + 32 * j] = o[j];
  csync();
  // the head's output: written here when the head has one chunk; else this
  // chunk's partial, and the head's last chunk to finish (a counter a head)
  // merges the partials
  float* part = a.part + (size_t)(head * chunks + chunk) * (D + 2);
  unsigned long long* out = a.xch + 3 * E + head * D;
  if (threadIdx.x < D) {
    float M = NEG;
#pragma unroll
    for (int w = 0; w < CW; ++w) M = fmaxf(M, sm_ml[2 * w]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < CW; ++w) {
      const float f = expf(sm_ml[2 * w] - M);
      L = fmaf(sm_ml[2 * w + 1], f, L);
      O = fmaf(sm_o[w * D + threadIdx.x], f, O);
    }
    if (chunks == 1) {
      put(out + threadIdx.x, O / L, tag);
    } else {
      part[2 + threadIdx.x] = O;
      if (threadIdx.x == 0) {
        part[0] = M;
        part[1] = L;
      }
    }
  }
  if (chunks > 1) {
    csync();
    unsigned* done = a.sync + 2 + head;
    if (threadIdx.x == 0) {
      __threadfence();  // the partial before the arrival
      sm_ml[0] = atomicAdd(done, 1u) == (unsigned)(chunks - 1) ? 1.f : 0.f;
      __threadfence();
    }
    csync();
    if (sm_ml[0] != 0.f) {  // every chunk of the head is in
      if (threadIdx.x < D) {
        const float* hp = a.part + (size_t)head * chunks * (D + 2);
        float pm[CHUNKS], pl[CHUNKS], po[CHUNKS];
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
          const bool in = c < chunks;
          pm[c] = in ? __ldcg(hp + c * (D + 2)) : NEG;
          pl[c] = in ? __ldcg(hp + c * (D + 2) + 1) : 0.f;
          po[c] = in ? __ldcg(hp + c * (D + 2) + 2 + threadIdx.x) : 0.f;
        }
        float M = NEG;
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) M = fmaxf(M, pm[c]);
        float L = 0.f, O = 0.f;
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
          if (c < chunks) {
            const float w = expf(pm[c] - M);
            L = fmaf(pl[c], w, L);
            O = fmaf(po[c], w, O);
          }
        }
        put(out + threadIdx.x, O / L, tag);
      }
      if (threadIdx.x == 0) *done = 0u;  // the last arrival: nobody reads it again this launch
    }
  }
  csync();
}

#define STAMP(i)                                       \
  do {                                                 \
    if (LAYER_TRACE && threadIdx.x == 0) ts[i] = clock64(); \
  } while (0)

// KVB: the cache is bf16 (else f32); VB: the biases and gains are bf16.
template <bool KVB, bool VB>
__global__ void __launch_bounds__(THREADS, 1) gpt2_layer_kernel(const __grid_constant__ LayerArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int E = a.E, F = a.F, H = a.H, D = a.E / a.H;
  const int np = a.plan.hdr[H_N];
  float* vec = reinterpret_cast<float*>(dyn);
  float* red = reinterpret_cast<float*>(dyn + a.plan.hdr[H_RED]);
  float* sm_ml = reinterpret_cast<float*>(dyn + a.plan.hdr[H_ATT]);  // [2 CW]
  float* bred = sm_ml + 2 * CW;                                      // [CW]
  float* sm_o = bred + CW;                                           // [CW D]
  float* sm_qkv = sm_o + CW * D;                                     // [3 D]
  float* g2s = sm_qkv + 3 * D;                                       // [E] ln2's gain
  float* b2s = g2s + E;                                              // [E] and bias
  uint64_t* full = reinterpret_cast<uint64_t*>(dyn + a.plan.hdr[H_BAR]);
  uint64_t* empty = full + np;
  unsigned char* ring = dyn + a.plan.hdr[H_RING];
  shares::init_barriers<CW>(a.plan, full, empty);
  __syncthreads();
  if (threadIdx.x >= NC) {  // the producer warp
    produce(a, ring, full, empty);
    return;
  }
  long long ts[18];
  if (LAYER_TRACE) ts[16] = ts[17] = 0;
  unsigned long long gt0 = 0;
  if (LAYER_TRACE && threadIdx.x == 0) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt0));
  STAMP(0);

  // this launch's tag: one more than the last launch's (CTA 0 stores it
  // once it has seen every CTA's h, each written after its CTA read this)
  const unsigned tag = persist::launch_tag(a.sync);
  // ln1's gain and bias (thread t takes elements t + j NC)
  const int t = threadIdx.x;
  float g1[LNP], b1[LNP];
#pragma unroll
  for (int j = 0; j < LNP; ++j) {
    const int i = t + j * NC;
    const bool in = i < E;
    g1[j] = in ? ld_vec<VB>(a.g1, i) : 0.f;
    b1[j] = in ? ld_vec<VB>(a.b1, i) : 0.f;
  }
  const Mat m0 = mat_of(a, 0), m1 = mat_of(a, 1), m2 = mat_of(a, 2), m3 = mat_of(a, 3);
  const bool r0 = t < m0.hi - m0.lo, r1 = t < m1.hi - m1.lo, r2 = t < m2.hi - m2.lo,
             r3 = t < m3.hi - m3.lo;
  unsigned long long* xq = a.xch;           // qkv [3E]
  unsigned long long* xa = a.xch + 3 * E;   // the attention output [E]
  unsigned long long* xx = a.xch + 4 * E;   // x2 [E]
  unsigned long long* xh = a.xch + 5 * E;   // h [F]

  // 1. qkv = ln1(x) Wa^T + ba
  layer_norm<false>(a.x, g1, b1, E, a.eps, vec, bred, sm_ml);
  release_weight(1);
  // this CTA's rows of the four biases and x's rows of the proj residual
  // (thread t writes row t of each weight's share), landing during the
  // products
  const float bias0 = r0 ? ld_vec<VB>(a.bias[0], m0.lo + t) : 0.f;
  const float bias1 = r1 ? ld_vec<VB>(a.bias[1], m1.lo + t) : 0.f;
  const float bias2 = r2 ? ld_vec<VB>(a.bias[2], m2.lo + t) : 0.f;
  const float bias3 = r3 ? ld_vec<VB>(a.bias[3], m3.lo + t) : 0.f;
  const float xres = r1 ? __ldg(a.x + m1.lo + t) : 0.f;
  STAMP(1);
  consume(a, 0, m0, vec, ring, full, empty, red, ts + 16);
  csync();
  STAMP(2);
  if (r0) {
    const float v = row_total(a, 0, t, red) + bias0;
    a.qkv[m0.lo + t] = v;
    put(xq + m0.lo + t, v, tag);
  }
  STAMP(3);

  // 2. attention, each item once its head's q, k and v are in: enough
  // chunks a head for every warp of an item to have AR rows, at most
  // min(CHUNKS, G/H)
  const int live = max(0, min(__ldg(a.npast), a.T));
  const int chunks =
      max(1, min(min(CHUNKS, (int)gridDim.x / H), (live + AR * CW - 1) / (AR * CW)));
  for (int item = blockIdx.x; item < H * chunks; item += gridDim.x)
    attention_item<KVB>(a, item / chunks, item % chunks, chunks, live, D, tag, sm_ml, sm_o,
                        sm_qkv);
  STAMP(4);
  // ln2's gain and bias into shared memory, while the heads' outputs come in
#pragma unroll
  for (int j = 0; j < LNP; ++j) {
    const int i = t + j * NC;
    if (i < E) {
      g2s[i] = ld_vec<VB>(a.g2, i);
      b2s[i] = ld_vec<VB>(a.b2, i);
    }
  }

  // 3. x2 = x + attention Wp^T + bp
  persist::gather<NC>(xa, E, tag, vec);
  release_weight(2);
  STAMP(5);
  consume(a, 1, m1, vec, ring, full, empty, red);
  csync();
  STAMP(6);
  const float x2 = r1 ? row_total(a, 1, t, red) + bias1 + xres : 0.f;
  if (r1) put(xx + m1.lo + t, x2, tag);
  STAMP(7);

  // 4. h = gelu(ln2(x2) Wf^T + bf)
  persist::gather<NC>(xx, E, tag, vec);
  release_weight(3);
  STAMP(8);
  layer_norm<true>(vec, g2s, b2s, E, a.eps, vec, bred, sm_ml);
  STAMP(9);
  consume(a, 2, m2, vec, ring, full, empty, red);
  csync();
  STAMP(10);
  if (r2) put(xh + m2.lo + t, q8::gelu(row_total(a, 2, t, red) + bias2), tag);
  STAMP(11);

  // 5. y = x2 + h Wc^T + bc (cproj's rows are proj's: this thread's x2)
  persist::gather<NC>(xh, F, tag, vec);
  if (blockIdx.x == 0 && t == 0)  // every CTA has read the generation
    persist::store_tag(a.sync, tag);
  STAMP(12);
  consume(a, 3, m3, vec, ring, full, empty, red);
  csync();
  STAMP(13);
  if (r3) a.y[m3.lo + t] = row_total(a, 3, t, red) + bias3 + x2;
  STAMP(14);
  STAMP(15);  // (the same point: the clock the trace scales by)
  if (LAYER_TRACE && t == 0) {  // over the partials' scratch: a diagnostic build only
    unsigned long long gt1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt1));
    unsigned* out = reinterpret_cast<unsigned*>(a.part) + blockIdx.x * 20;
    for (int i = 0; i < 18; ++i) out[i] = ts[i] ? (unsigned)(ts[i] - ts[0]) : 0u;
    out[18] = (unsigned)gt0;
    out[19] = (unsigned)(gt1 - gt0);
  }
}

}  // namespace

// x f32 [E]; kc, vc [T, E] contiguous, bf16 (kv_bf16) or f32; npast int32 on
// the device; four Q8_0 weights (qs int8, d f16; both 16-byte aligned): a
// [3E, E], p [E, E], f [F, E], c [E, F]; biases ba [3E], bp [E], bf [F], bc
// [E] and layer-norm pairs g1, b1, g2, b2 [E], all f32 or all bf16
// (vec_bf16). Outputs y f32 [E] and qkv f32 [3E] (k_new = qkv[E:2E], v_new =
// qkv[2E:3E]). Scratch: part f32 [H * 8 * (E/H + 2)] (attention partials);
// xch uint64 [5E + F], all 0 before the first launch (each word a value and
// the tag of the launch that wrote it); sync uint32 [2 + H], its word 1 the
// last launch's tag (0 before the first) and words 2.. 0, left so (word 1
// one more) by every launch (one launch at a time a pair of buffers).
// plan: host int32, the shared-memory plan of kernels/gpt2_layer.py
// smem_plan for these widths and this card (its header, then 5 ints a
// piece). E % 128 == 0, F % 128 == 0, E/H a multiple of 32 up to 128, E
// <= 2560, and no CTA more than 512 rows of a weight.
// Returns the CUDA error of the cooperative launch (0: launched),
// cudaErrorInvalidValue for shapes or a plan it does not take.
extern "C" int gpt2_layer(const float* x, const void* kc, const void* vc, const int* npast,
                          const int8_t* qa, const __half* da, const void* ba,
                          const int8_t* qp, const __half* dp, const void* bp,
                          const int8_t* qf, const __half* df, const void* bf,
                          const int8_t* qc, const __half* dc, const void* bc,
                          const void* g1, const void* b1, const void* g2, const void* b2,
                          float* y, float* qkv, float* part, unsigned long long* xch,
                          unsigned* sync, const int* plan, int E, int H, int F, int T,
                          float eps, int kv_bf16, int vec_bf16, cudaStream_t stream) {
  if (E <= 0 || H <= 0 || F <= 0 || T <= 0 || E % 128 || F % 128 || E % H || sync == nullptr ||
      xch == nullptr || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  const int D = E / H;
  if (D % 32 || D > MAX_D) return (int)cudaErrorInvalidValue;
  LayerArgs a{};
  a.x = x;
  a.kc = kc;
  a.vc = vc;
  a.npast = npast;
  const int8_t* qs[4] = {qa, qp, qf, qc};
  const __half* ds[4] = {da, dp, df, dc};
  const void* bs[4] = {ba, bp, bf, bc};
  for (int w = 0; w < 4; ++w) {
    a.qs[w] = qs[w];
    a.d[w] = ds[w];
    a.bias[w] = bs[w];
  }
  a.g1 = g1;
  a.b1 = b1;
  a.g2 = g2;
  a.b2 = b2;
  a.y = y;
  a.qkv = qkv;
  a.part = part;
  a.xch = xch;
  a.sync = sync;
  a.E = E;
  a.H = H;
  a.F = F;
  a.T = T;
  a.eps = eps;
  for (int i = 0; i < H_LEN; ++i) a.plan.hdr[i] = plan[i];
  const int np = a.plan.hdr[H_N];
  if (np < 4 || np > MAX_PIECES || a.plan.hdr[H_FIRST] != 0 || a.plan.hdr[H_FIRST + 4] != np)
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < np; ++p)
    for (int k = 0; k < PIECE_INTS; ++k) a.plan.piece[p][k] = plan[H_LEN + p * PIECE_INTS + k];
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int G = a.plan.hdr[H_G];
  if (G < 1 || G > sms || G > F || E > LNP * NC || (3 * E + G - 1) / G > NC ||
      (F + G - 1) / G > NC ||
      (long long)(3 * E > F ? 3 * E : F) * G >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)a.plan.hdr[H_SMEM];
  const void* fn = kv_bf16 ? (vec_bf16 ? (const void*)gpt2_layer_kernel<true, true>
                                       : (const void*)gpt2_layer_kernel<true, false>)
                           : (vec_bf16 ? (const void*)gpt2_layer_kernel<false, true>
                                       : (const void*)gpt2_layer_kernel<false, false>);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(G), dim3(THREADS), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
