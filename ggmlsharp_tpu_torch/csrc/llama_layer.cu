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
// cache rows. The weights depend on no activation; only the products do.
//
// Design: a persistent grid of one CTA an SM (a cooperative launch: every
// CTA resident) that streams its weights through shared memory without a
// pause at the phase boundaries.
//  * Each CTA owns a fixed, equal share of the rows of each of the five
//    matrices (qkv, wo, gate with up, down): rows [N c / G, N (c + 1) / G)
//    of CTA c of G, a gate row with its up row.
//  * A producer warp walks the CTA's rows of all five in phase order, R
//    whole rows a tile (R <= 8, the most whose qs fit TILE = 32 KB; a
//    gate/up tile holds R gate and R up rows), and copies each tile into a
//    ring of stages in shared memory: its qs rows are one contiguous
//    range, and so are its scales, each one bulk copy (TMA,
//    cp.async.bulk) completing on the stage's `full` mbarrier (scales that
//    are not 16-byte aligned and sized go as 4-byte cp.asyncs arriving on
//    it); each stage's release is awaited on its `empty` mbarrier. It
//    never waits for an activation, so while the consumers sit at a
//    barrier or in attention the ring fills with the next matrix's first
//    tiles.
//  * CW = 16 consumer warps take each tile as it lands: warp w takes
//    row w % R of it and every (CW / R)-th 512-element step of its K
//    (q4_dot.cuh's inner loop, f32 FMAs, the weights and the activation
//    vector both in shared memory), leaves its partial sum in shared
//    memory and releases the stage. After a matrix's last tile they add
//    each row's partials in a fixed order and write the row's result.
//    These FMAs, with the serial steps between the products, set the
//    time: without them the ring streams near the card's copy ceiling
//    (PERF.md §6).
//  * Between the phases: qkv rows -> per-KV-head arrival counters (a
//    head's attention waits only for its own q, k and v rows:
//    red.release / ld.acquire at gpu scope), then a grid barrier before
//    wo (every CTA merges every head), before rms2 and before down; the
//    grid barrier is the CTAs' own (persist.cuh, shared with gpt2_layer.cu):
//    one word whose top bit the 132nd arrival flips.
//  * Every CTA recomputes rms(x) g1, the attention merge into wo's column
//    slots, rms(x2) g2 and loads the gated product itself (cheaper than a
//    barrier each). Attention: one CTA an item (query head, chunk of the
//    live rows), its consumer warps taking rows in turn with an online
//    softmax, lane l owning features l, l + 32, ...; the fresh f32 row
//    seeds chunk 0; each item leaves an unnormalised (max, sum, out[D])
//    partial; the first query head of a KV head writes the roped k_new.
// F/32 need not be a multiple of 16 (masked). npast is read on the device;
// rows >= T are never read. The scratch `sync` (the barrier word, an unused
// word, then a counter a KV head) is left as the launch found it: the
// barrier's low 31 bits 0, the head counters 0 (reset after the last wait).
//
// The consumer warps (16) and the tile (32 KB of qs) are fixed at the best
// of the alternatives measured on an H100 at 7B widths (PERF.md §6, kernel
// 10: 102.7 us at npast 32, 196.9 at 2047): 8 warps took 115.2 us at npast
// 32; 24 warps 109.6 there and 175.1 at 2047 (attention gets the extra
// warps; decode runs at short npast); 16 KB tiles +7 us.
//
// Tunables (-D overrides them): LAYER_CHUNKS attention items a head;
// LAYER_NO_MATVEC 1 streams no weight and skips every product, leaving the
// barriers, norms, rope, attention and the merge (chip_smoke.py times it).
#ifndef LAYER_CHUNKS
#define LAYER_CHUNKS 8
#endif
#ifndef LAYER_NO_MATVEC
#define LAYER_NO_MATVEC 0
#endif
#include "mma_bf16.cuh"
#include "persist.cuh"
#include "q4_dot.cuh"

namespace {

constexpr int CW = 16;             // consumer warps
constexpr int NC = CW * 32;        // consumer threads (the producer warp is the last)
constexpr int THREADS = NC + 32;
constexpr int CHUNKS = LAYER_CHUNKS;
static_assert(CHUNKS <= 8, "the wrapper sizes the partials' scratch for 8 chunks a head");
static_assert(CW % 8 == 0, "a tile's rows (up to 8) divide the consumer warps");
constexpr int TILE = 32768;  // the most qs bytes of a tile
constexpr int MAX_D = 128;  // head width: a multiple of 32 up to this
constexpr int MAX_STAGES = 12;
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
  unsigned* sync;  // [0] the grid barrier, [2 + g] KV head g's qkv rows
  int E, H, Hkv, F, T;
  float eps;
  int kv_bf16, rope_mode;
  int stage_bytes, stages, red_floats;
};

// ---- synchronisation (persist.cuh) --------------------------------------

using persist::bulk_copy;
using persist::cp_async4;
using persist::ld_acquire;
using persist::mbar_arrive;
using persist::mbar_arrive_cp;
using persist::mbar_arrive_tx;
using persist::mbar_init;
using persist::mbar_wait;
using persist::red_release_add;

// the consumer warps only (the producer warp never joins)
__device__ __forceinline__ void csync() { persist::csync<NC>(); }
// every consumer thread of every CTA: the CTAs' own grid barrier
__device__ __forceinline__ void grid_sync(unsigned* bar) { persist::grid_sync<NC>(bar); }

// ---- the weight stream -----------------------------------------------------

// One matrix of the stream as this CTA sees it: rows [lo, hi) of N (a gate
// row n with its up row F + n: pair 2), K columns, R rows a tile and P
// consumer warps a row.
struct Mat {
  const uint8_t* qs;
  const __half* d;
  int N, K, pair, R, P, lo, hi, second;  // second: the row offset of a pair's second row
};

// the most rows a tile (8, 4, 2 or 1) whose qs fit TILE
__host__ __device__ inline int tile_rows(int K, int pair) {
  int R = 8;
  while (R > 1 && R * pair * (K / 2) > TILE) R >>= 1;
  return R;
}
// words a stage keeps for one row group's scales: R rows of K/32 f16 from
// a word boundary, rounded up to 16 bytes (a bulk copy's destination)
__host__ __device__ inline int d_words(int R, int K) { return (R * K / 64 + 2 + 3) & ~3; }
__host__ __device__ inline int stage_need(int K, int pair) {
  const int R = tile_rows(K, pair);
  return (pair * R * (K / 2) + pair * d_words(R, K) * 4 + 15) & ~15;
}

__device__ Mat mat_of(const LayerArgs& a, int ph) {
  const int D = a.E / a.H, Ekv = a.Hkv * D;
  const uint8_t* qs[4] = {a.qa, a.qo, a.qg, a.qd};
  const __half* d[4] = {a.da, a.dO, a.dg, a.dd};
  Mat m;
  m.qs = qs[ph];
  m.d = d[ph];
  m.pair = ph == 2 ? 2 : 1;
  m.second = ph == 2 ? a.F : 0;
  m.N = ph == 0 ? a.E + 2 * Ekv : ph == 2 ? a.F : a.E;
  m.K = ph == 3 ? a.F : a.E;
  m.R = tile_rows(m.K, m.pair);
  m.P = CW / m.R;
  m.lo = (int)((long long)m.N * blockIdx.x / gridDim.x);
  m.hi = LAYER_NO_MATVEC ? m.lo : (int)((long long)m.N * (blockIdx.x + 1) / gridDim.x);
  return m;
}

__device__ __forceinline__ int tiles_of(const Mat& m) { return (m.hi - m.lo + m.R - 1) / m.R; }

// The producer warp: every tile of the four phases into the ring, in order.
// A tile's qs rows are one contiguous range, and so are its scales: lane 0
// sends each as one bulk copy (TMA) and arrives expecting their bytes; a
// scale range that is not 16-byte aligned and sized (K not a multiple of
// 256) goes as 4-byte cp.asyncs over lanes 1..31 instead. Every lane
// arrives once a tile (`full` counts 32): lane 0 with the bytes, the
// others once their cp.asyncs land.
__device__ void produce(const LayerArgs& a, unsigned char* ring, uint64_t* full,
                        uint64_t* empty) {
  const int lane = threadIdx.x & 31;
  int k = 0;  // tiles issued
  for (int ph = 0; ph < 4; ++ph) {
    const Mat m = mat_of(a, ph);
    const int nt = tiles_of(m);
    const size_t rowb = m.K / 2, drow = m.K / 16;  // qs and d bytes a row
    const unsigned char* dsrc = reinterpret_cast<const unsigned char*>(m.d);
    const bool d_bulk = drow % 16 == 0 && (reinterpret_cast<uintptr_t>(dsrc) & 15) == 0;
    for (int t = 0; t < nt; ++t, ++k) {
      const int s = k % a.stages;
      if (k >= a.stages) mbar_wait(&empty[s], ((k / a.stages) - 1) & 1);
      unsigned char* st = ring + (size_t)s * a.stage_bytes;
      const int n0 = m.lo + t * m.R, nr = min(m.R, m.hi - n0);
      if (lane == 0)  // every byte the bulk copies will bring
        mbar_arrive_tx(&full[s], (unsigned)(m.pair * nr * (rowb + (d_bulk ? drow : 0))));
      for (int j = 0; j < m.pair; ++j) {
        const size_t row0 = (size_t)n0 + j * m.second;
        const size_t start = row0 * drow, end = start + nr * drow;
        unsigned char* ddst = st + (size_t)m.pair * m.R * rowb + (size_t)j * d_words(m.R, m.K) * 4;
        if (lane == 0) {
          bulk_copy(st + (size_t)j * m.R * rowb, m.qs + row0 * rowb, (unsigned)(nr * rowb),
                    &full[s]);
          if (d_bulk) bulk_copy(ddst, dsrc + start, (unsigned)(nr * drow), &full[s]);
        } else if (!d_bulk) {
          const size_t w0 = start & ~(size_t)3;
          const int nw = (int)((end - w0 + 3) / 4);
          for (int i = lane - 1; i < nw; i += 31) {
            const size_t at = w0 + 4 * (size_t)i;
            cp_async4(ddst + 4 * i, dsrc + at, (int)min((size_t)4, end - at));
          }
        }
      }
      if (lane > 0) mbar_arrive_cp(&full[s]);
    }
  }
  cp_async_wait0();  // leave nothing in flight behind this warp
}

// The consumers' pass over one matrix's tiles (k: tiles consumed so far):
// warp w takes row w % R of each tile and every P-th 512-element step of
// its K (q4_dot.cuh's inner loop, the weights and the activation vector
// both in shared memory); each row's partial sums go to red[(i * P + p) *
// pair + j], i the row's index in the CTA's range.
__device__ void consume(const LayerArgs& a, const Mat& m, const float* vec, unsigned char* ring,
                        uint64_t* full, uint64_t* empty, float* red, int& k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp % m.R, p = warp / m.R;
  const int nt = tiles_of(m);
  const size_t rowb = m.K / 2, drow = m.K / 16;
  for (int t = 0; t < nt; ++t, ++k) {
    const int s = k % a.stages;
    mbar_wait(&full[s], (k / a.stages) & 1);
    const unsigned char* st = ring + (size_t)s * a.stage_bytes;
    const int n0 = m.lo + t * m.R, nr = min(m.R, m.hi - n0);
    if (r < nr) {
      const uint8_t* q[2];
      const __half* dd[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int jj = j < m.pair ? j : 0;
        const size_t start = ((size_t)n0 + jj * m.second) * drow;
        q[j] = st + ((size_t)jj * m.R + r) * rowb;
        dd[j] = reinterpret_cast<const __half*>(st + (size_t)m.pair * m.R * rowb +
                                                (size_t)jj * d_words(m.R, m.K) * 4 +
                                                (start & 3) + r * drow);
      }
      float* out = red + ((size_t)(t * m.R + r) * m.P + p) * m.pair;
      if (m.pair == 2) {
        float acc[1][2];
        q4::warp_dot<1, 2, q4::X_PLAIN, true>(vec, 0, 1, q, dd, m.K, lane, acc, p, m.P);
        const float g = q4::warp_sum(acc[0][0]), u = q4::warp_sum(acc[0][1]);
        if (lane == 0) {
          out[0] = g;
          out[1] = u;
        }
      } else {
        const uint8_t* q1[1] = {q[0]};
        const __half* d1[1] = {dd[0]};
        float acc[1][1];
        q4::warp_dot<1, 1, q4::X_PLAIN, true>(vec, 0, 1, q1, d1, m.K, lane, acc, p, m.P);
        const float v = q4::warp_sum(acc[0][0]);
        if (lane == 0) out[0] = v;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// The sum of row i's partials (pair member j), in warp order.
__device__ __forceinline__ float row_sum(const float* red, const Mat& m, int i, int j) {
  float v = 0.f;
  for (int p = 0; p < m.P; ++p) v += red[((size_t)i * m.P + p) * m.pair + j];
  return v;
}

// ---- the block's other steps (consumer threads) ------------------------

__device__ __forceinline__ float block_sum(float v, float* bred) {
  v = q4::warp_sum(v);
  if ((threadIdx.x & 31) == 0) bred[threadIdx.x >> 5] = v;
  csync();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < CW; ++i) t += bred[i];
  csync();
  return t;
}

// vec[i] = src[i] * rsqrt(mean(src^2) + eps) * g[i]. COHERENT: src was
// written earlier in this launch by other CTAs.
template <bool COHERENT>
__device__ void rms_norm(const float* src, const float* g, int E, float eps, float* vec,
                         float* bred) {
  float q = 0.f;
  for (int i = threadIdx.x; i < E; i += NC) {
    const float v = COHERENT ? __ldcg(src + i) : __ldg(src + i);
    vec[i] = v;  // read back below by this thread only
    q = fmaf(v, v, q);
  }
  const float rs = rsqrtf(block_sum(q, bred) / (float)E + eps);
  for (int i = threadIdx.x; i < E; i += NC) vec[i] = vec[i] * rs * __ldg(g + i);
  csync();
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
  csync();
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
  for (int t = r0 + warp; t < r1; t += CW) {
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
  csync();
  float* part = a.part + (size_t)(head * CHUNKS + chunk) * (D + 2);
  if (threadIdx.x < D) {
    float M = NEG;
#pragma unroll
    for (int w = 0; w < CW; ++w) M = fmaxf(M, sm_ml[2 * w]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < CW; ++w) {
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
  csync();
}

// vec[slot[e]] = the attention output element e: the CHUNKS partials of e's
// head merged.
__device__ void merge_attention(const LayerArgs& a, int D, float* vec) {
  for (int e = threadIdx.x; e < a.E; e += NC) {
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
  csync();
}

// rows of qkv [lo, hi) that belong to KV head g: its query heads' q rows,
// its k and its v rows
__device__ __forceinline__ int head_rows(int lo, int hi, int g, int E, int Ekv, int D,
                                         int n_rep) {
  auto ov = [&](int a0, int a1) { return max(0, min(hi, a1) - max(lo, a0)); };
  return ov(g * n_rep * D, (g + 1) * n_rep * D) + ov(E + g * D, E + (g + 1) * D) +
         ov(E + Ekv + g * D, E + Ekv + (g + 1) * D);
}

// Bytes of the front of the dynamic shared memory: the activation vector
// (max(E, F) f32), then the partial sums (red_floats f32), then the
// stages' full and empty mbarriers; the ring follows.
__host__ __device__ inline int front_bytes(int E, int F, int red_floats) {
  return (((E > F ? E : F) + red_floats) * 4 + 15) / 16 * 16 + 2 * MAX_STAGES * 8;
}

__global__ void __launch_bounds__(THREADS, 1) llama_layer_kernel(LayerArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float bred[CW];
  __shared__ float sm_ml[2 * CW];
  __shared__ float sm_o[CW * MAX_D];
  __shared__ float sm_q[MAX_D];
  __shared__ float sm_k[MAX_D];
  const int E = a.E, F = a.F, D = a.E / a.H;
  const int Ekv = a.Hkv * D, n_rep = a.H / a.Hkv;
  float* vec = reinterpret_cast<float*>(dyn);
  float* red = vec + (E > F ? E : F);
  uint64_t* full = reinterpret_cast<uint64_t*>(dyn + front_bytes(E, F, a.red_floats) -
                                               2 * MAX_STAGES * 8);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* ring = reinterpret_cast<unsigned char*>(empty + MAX_STAGES);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 32);  // each producer lane's arrival
      mbar_init(&empty[s], CW);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= NC) {  // the producer warp
    produce(a, ring, full, empty);
    return;
  }

  int k = 0;  // tiles consumed
  // 1. qkv
  rms_norm<false>(a.x, a.g1, E, a.eps, vec, bred);
  Mat m = mat_of(a, 0);
  consume(a, m, vec, ring, full, empty, red, k);
  csync();
  for (int i = threadIdx.x; i < m.hi - m.lo; i += NC) a.qkv[m.lo + i] = row_sum(red, m, i, 0);
  csync();
  if (threadIdx.x == 0) {  // this CTA's qkv rows, to the heads they feed
    __threadfence();
    for (int g = 0; g < a.Hkv; ++g) {
      const int n = head_rows((int)((long long)m.N * blockIdx.x / gridDim.x),
                              (int)((long long)m.N * (blockIdx.x + 1) / gridDim.x), g, E, Ekv,
                              D, n_rep);
      if (n > 0) red_release_add(a.sync + 2 + g, (unsigned)n);
    }
  }

  // 2. attention, each item once its KV head's rows are in
  const int live = max(0, min(__ldg(a.npast), a.T));
  const unsigned want = (unsigned)((n_rep + 2) * D);
  for (int item = blockIdx.x; item < a.H * CHUNKS; item += gridDim.x) {
    const int head = item / CHUNKS;
    if (threadIdx.x == 0) {
      while (ld_acquire(a.sync + 2 + head / n_rep) < want) __nanosleep(32);
      __threadfence();
    }
    csync();
    attention_item(a, head, item % CHUNKS, live, D, sm_ml, sm_o, sm_q, sm_k);
  }
  grid_sync(a.sync);
  if (blockIdx.x == 0 && threadIdx.x == 0)  // every wait is over
    for (int g = 0; g < a.Hkv; ++g) a.sync[2 + g] = 0;

  // 3. x2 = x + attention wo^T
  merge_attention(a, D, vec);
  m = mat_of(a, 1);
  consume(a, m, vec, ring, full, empty, red, k);
  csync();
  for (int i = threadIdx.x; i < m.hi - m.lo; i += NC)
    a.x2[m.lo + i] = row_sum(red, m, i, 0) + __ldg(a.x + m.lo + i);
  grid_sync(a.sync);

  // 4. act = silu(gate) * up over rms(x2) g2
  rms_norm<true>(a.x2, a.g2, E, a.eps, vec, bred);
  m = mat_of(a, 2);
  consume(a, m, vec, ring, full, empty, red, k);
  csync();
  for (int i = threadIdx.x; i < m.hi - m.lo; i += NC)
    a.act[m.lo + i] = q4::swiglu(row_sum(red, m, i, 0), row_sum(red, m, i, 1));
  grid_sync(a.sync);

  // 5. y = x2 + act down^T
  for (int i = threadIdx.x; i < F; i += NC) vec[i] = __ldcg(a.act + i);
  csync();
  m = mat_of(a, 3);
  consume(a, m, vec, ring, full, empty, red, k);
  csync();
  for (int i = threadIdx.x; i < m.hi - m.lo; i += NC)
    a.y[m.lo + i] = row_sum(red, m, i, 0) + __ldcg(a.x2 + m.lo + i);
}

}  // namespace

// x f32 [E]; kc, vc [T, E_kv] contiguous, bf16 (kv_bf16) or f32; npast int32
// on the device; cosv, sinv f32 [D/2]; four Q4_0 weights (qs uint8, 16-byte
// aligned; d f16, 4-byte aligned): a = wqkv [E + 2 E_kv, E], o = the block
// route's wo [E, E], g = [gate; up] [2F, E], d = down [E, F]; gains g1, g2
// f32 [E]; slot int32 [E], a permutation of 0..E-1. Outputs y f32 [E], qkv
// f32 [E + 2 E_kv] (v_new is its last E_kv; q and k in it are unrotated)
// and kn f32 [E_kv], the roped k_new. Scratch, f32: part [H * 8 * (D + 2)],
// x2 [E], act [F]; sync: uint32 [2 + Hkv], the barrier word's low 31 bits
// and the head counters 0 before the first launch, and left so by every
// launch (one launch at a time a buffer). E % 32 == 0, F % 32 == 0, H % Hkv == 0,
// D = E/H a multiple of 32 up to 128. Returns the CUDA error of the
// cooperative launch (0: launched), cudaErrorInvalidValue for shapes it
// does not take and cudaErrorCooperativeLaunchTooLarge when the shared
// memory cannot hold two stages.
extern "C" int llama_layer(const float* x, const void* kc, const void* vc, const int* npast,
                           const float* cosv, const float* sinv, const uint8_t* qa,
                           const __half* da, const uint8_t* qo, const __half* dO,
                           const uint8_t* qg, const __half* dg, const uint8_t* qd,
                           const __half* dd, const float* g1, const float* g2,
                           const int* slot, float* y, float* qkv, float* kn, float* part,
                           float* x2, float* act, unsigned* sync, int E, int H, int Hkv, int F,
                           int T, float eps, int kv_bf16, int rope_mode, cudaStream_t stream) {
  if (E <= 0 || H <= 0 || Hkv <= 0 || F <= 0 || T <= 0 || E % 32 || F % 32 || E % H || H % Hkv ||
      sync == nullptr)
    return (int)cudaErrorInvalidValue;
  const int D = E / H;
  if (D % 32 || D > MAX_D) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, smem_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // the partial sums a CTA keeps for one matrix (its rows times the warps
  // a row), and the largest stage any matrix's tile takes
  const int Ekv = Hkv * D;
  const int NS[4] = {E + 2 * Ekv, E, F, E}, KS[4] = {E, E, E, F}, PR[4] = {1, 1, 2, 1};
  int red_floats = 0, stage = 0;
  for (int i = 0; i < 4; ++i) {
    red_floats = max(red_floats,
                     (NS[i] + sms - 1) / sms * (CW / tile_rows(KS[i], PR[i])) * PR[i]);
    stage = max(stage, stage_need(KS[i], PR[i]));
  }
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, llama_layer_kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t fixed = front_bytes(E, F, red_floats);
  const long long room = (long long)smem_optin - (long long)fa.sharedSizeBytes - (long long)fixed;
  const int stages = (int)min((long long)MAX_STAGES, room / stage);
  if (stages < 2) return (int)cudaErrorCooperativeLaunchTooLarge;
  const size_t smem = fixed + (size_t)stages * stage;
  err = cudaFuncSetAttribute(llama_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, llama_layer_kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  LayerArgs a{x,  kc,  vc,   npast, cosv,      sinv, qa,    qo,         qg,  qd,  da,  dO,
              dg, dd,  g1,   g2,    slot,      y,    qkv,   kn,         part, x2, act, sync,
              E,  H,   Hkv,  F,     T,         eps,  kv_bf16, rope_mode, stage, stages,
              red_floats};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(llama_layer_kernel), dim3(sms),
                                    dim3(THREADS), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
