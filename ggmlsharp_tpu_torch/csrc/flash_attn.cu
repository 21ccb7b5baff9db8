// Flash attention for Hopper (sm_90a) on the tensor cores, f32 online softmax.
//
// Replaces ggmlsharp_tpu/kernels/flash.py::_flash_bhsd, both of its entries:
//   * flash_attention_cached (cached causal GQA, per-row npast): prompt
//     prefill of the llama and GPT-2 paths, and the attention of training;
//   * flash_attention (uncached: causal or not, a static n_past, Sq != Sk):
//     the graph layer's flash_attn op.
//
//   q [B, Hq, S, D], k/v [B, Hkv, T, D]  ->  out [B, Hq, S, D] f32.
//   Query s of batch b sits at position npast[b] + s (or n_past when npast
//   is null) and, when causal, sees keys kidx <= npast + s; otherwise every
//   key. Query head h reads KV head h / (Hq / Hkv) (GQA without a repeated
//   copy). With softcap > 0 a score s becomes tanh(s / softcap) * softcap
//   before the mask. A row that sees no key gives 0. q and k/v come in their
//   own types: (q, kv) is (f32, f32), (f32, bf16), (f32, f16), (bf16, bf16)
//   or (f16, f16).
//
// The cache may be a prefix view of a longer buffer: rows of one head are
// contiguous (stride D) and heads are kv_head_stride elements apart, batch
// entries Hkv * kv_head_stride. Pointers are 16-byte aligned (the wrapper
// sees to it).
//
// What bounds it: at the paths' shapes (S 16-128, D 64-128) the bytes of q,
// out and the K/V rows causality keeps, and the launch; the products are
// 4·D operations a kept (query, key) pair, far below the tensor-core rate.
//
// Design. A block takes one (batch entry, KV head) and a tile of BM rows:
// cw = 1..4 row warps of 16 rows (64 rows; 16 when n_rep * S is 16, as in
// path a's prefill). Its rows are all n_rep query heads of that KV head,
// position-major (row = s * n_rep + r), so every K/V tile is loaded once for
// all of them and the block's causal limit is that of its last position.
// K/V tiles of BN rows (64 at D <= 128, 32 at D 256; half that for f32
// K/V) come in with cp.async: bf16 tiles straight into shared memory,
// double buffered, f32/f16 ones into a landing area that the thread that
// copied each 16 bytes then splits into bf16 planes; only the live rows of
// a tile (rounded up to 16) are copied, and tiles past the block's causal
// limit are not. With bf16 K/V and more
// than one tile, two key groups of warps take every other tile each and
// merge their softmax states at the end (the causal diagonal block's two
// tiles run side by side); every block has at least 4 warps to stage. A
// warp skips the keys its rows cannot see. S = Q·Kᵀ and O += P·V run on
// mma.sync.m16n8k16 (bf16 operands, f32 accumulation) with fragments from
// ldmatrix (rows D + 8 elements apart: conflict-free); each warp keeps its
// 16 rows' softmax state (m, l) and O in registers, in the mma accumulator
// layout, and P goes from the S accumulator straight into the A operand of
// the next product. The softmax runs in log2 units (exp2) and masks only
// the tiles that cross some row's limit.
//
// The f32 bar. The products run on bf16 operands and keep the f32
// function: an operand is kept as bf16 planes, x = x0 + x1 + ..., each the
// bf16 rounding of what the earlier ones leave: one plane for bf16 (exact),
// two for f16 (exact), three for f32 (24 bits) and for P, the f32 softmax
// weights in [0, 1]. A product takes every plane pair (i, j) of order
// i + j <= 2; the terms left out are below 2^-24 of it, the f32 rounding
// itself. bf16 K/V stay one plane and are copied with cp.async; f32 and f16
// ones are split on their way into shared memory. The scores, the softmax
// and the sums stay f32, so the kernel meets the dense f32 reference's bar
// (rtol 2e-4 / atol 2e-5) with room: with two planes for f32 (2^-18) it
// did too, but a path that rounds to INT8 downstream (GPT-2 behind the
// engine) then parted from its plain run at a near tie.
//
// mma issue a (16 rows x 8 keys x 16 features) step, S then P·V:
//   (bf16, bf16): 1 + 3     (f32, bf16): 3 + 3     (f16, f16): 4 + 5
//   (f32, f16): 5 + 5       (f32, f32): 6 + 6
// against 1 + 1 for plain bf16 operands. Path g's call (B 8, H 12, S = T
// 128, D 64, bf16) keeps 3 (64-row, 64-key) tile pairs a head: 512 mma a
// pair, 147,456 in all, 0.60 GFLOP, 0.61 us at the H100's dense bf16 rate; path
// a's prefill (B 1, Hq 32, S 16 from npast 0, D 128, f32 q, bf16 K/V) keeps
// one 16-key tile a head: 12,288 mma, 0.05 us. The products are a small
// share of the time; loads, the softmax and the launch are the rest.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_WARPS = 4;

// bf16 planes an operand is kept in: bf16 1 (exact), f16 2 (exact), f32 3
// (hi, mid, lo: 24 bits); P, the softmax weights, 3.
template <typename T> struct Planes { static constexpr int n = 3; };
template <> struct Planes<__half> { static constexpr int n = 2; };
template <> struct Planes<__nv_bfloat16> { static constexpr int n = 1; };
constexpr int NP = 3;

template <int D, typename KT> struct Tile {
  // keys a K/V tile: fewer for f32 K/V, whose three planes and landing area
  // must fit in shared memory
  static constexpr int BN = Planes<KT>::n == 3 ? (D > 128 ? 16 : 32) : (D > 128 ? 32 : 64);
  static constexpr int LD = D + 8;  // row stride in bf16: conflict-free fragment loads
  static constexpr int MAXW = D > 128 ? 2 : MAX_WARPS;  // row warps a block
};

// rows a K/V tile buffer holds: BN, or fewer when the cache is shorter
__host__ __device__ inline int tile_rows_max(int bn, int T) {
  return bn < ((T + 15) & ~15) ? bn : ((T + 15) & ~15);
}

// Shared memory of a block of cw row warps whose K/V tiles hold rb rows,
// kw key groups: q planes [NQ][16 cw][LD]; K/V planes [NBUF][k, v][NK][rb]
// [LD] (NBUF = 2 kw for bf16 K/V, which cp.async fills directly, double
// buffered; 1 for split K/V, kw = 1); raw f32/f16 landing areas for the
// operands that are split, q [16 cw][D] and K/V [k, v][rb][D]. Once the
// tiles are read, the K/V planes' bytes hold key group 1's states for the
// merge (merge_bytes).
template <int D, typename QT, typename KT>
struct Smem {
  static constexpr int NQ = Planes<QT>::n, NK = Planes<KT>::n;
  static constexpr int LD = Tile<D, KT>::LD;
  __host__ __device__ static int q_planes(int cw) { return NQ * 16 * cw * LD * 2; }
  __host__ __device__ static int kv_planes(int rb, int kw) {
    return (NK == 1 ? 2 * kw : 1) * 2 * NK * rb * LD * 2;
  }
  __host__ __device__ static int raw_q(int cw) {
    return NQ > 1 ? 16 * cw * D * (int)sizeof(QT) : 0;
  }
  __host__ __device__ static int raw_kv(int rb) {
    return NK > 1 ? 2 * rb * D * (int)sizeof(KT) : 0;
  }
  // a key group's state for the merge: (D / 2 + 4) floats a lane of cw warps
  __host__ __device__ static int merge_bytes(int cw) { return cw * 32 * (D / 2 + 4) * 4; }
  __host__ __device__ static int bytes(int cw, int rb, int kw) {
    const int kv = kv_planes(rb, kw);
    return q_planes(cw) + (kv > merge_bytes(cw) ? kv : merge_bytes(cw)) + raw_q(cw) +
           raw_kv(rb);
  }
};

// 16 bytes of f32 (4) or f16 (8) elements from shared memory -> floats
__device__ __forceinline__ void lds_chunk(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void lds_chunk(const __half* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// The raw 16-byte chunk at raw, split into the NPL bf16 planes at dst
// (plane_stride elements apart).
template <int NPL, typename T>
__device__ __forceinline__ void split_chunk(const T* raw, __nv_bfloat16* dst,
                                            int plane_stride) {
  constexpr int E = 16 / sizeof(T);
  float x[8];
  lds_chunk(raw, x);
  uint32_t w[NPL][E / 2];
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    uint32_t pw[NPL];
    split_pair<NPL>(x[2 * i], x[2 * i + 1], pw);
#pragma unroll
    for (int p = 0; p < NPL; ++p) w[p][i] = pw[p];
  }
#pragma unroll
  for (int p = 0; p < NPL; ++p) {
    if constexpr (E == 8)
      *reinterpret_cast<uint4*>(dst + p * plane_stride) =
          make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
    else
      *reinterpret_cast<uint2*>(dst + p * plane_stride) = make_uint2(w[p][0], w[p][1]);
  }
}

template <int D, typename QT, typename KT>
__global__ void __launch_bounds__(2 * MAX_WARPS * 32)
flash_attn_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                  const KT* __restrict__ v, const int* __restrict__ npast,
                  int n_past, float* __restrict__ out, int Hq, int Hkv, int S,
                  int T, long long kv_head_stride, float scale, float softcap,
                  int causal, int cw, int kw) {
  using SM = Smem<D, QT, KT>;
  constexpr int NQ = SM::NQ, NK = SM::NK, BN = Tile<D, KT>::BN, LD = SM::LD;
  constexpr int QCH = D * (int)sizeof(QT) / 16;  // 16-byte chunks a q row
  constexpr int KCH = D * (int)sizeof(KT) / 16;  // ... a K/V row
  constexpr int QE = 16 / (int)sizeof(QT), KE = 16 / (int)sizeof(KT);
  constexpr int NT = D / 8;  // n-tiles of the output
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  // Warp w owns rows 16 (w % cw) .. + 15 of the block's tile and takes the
  // key tiles kw * step + w / cw (its key group); every warp stages tiles.
  const int nthr = blockDim.x, BM = cw * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slab = warp % cw, kg = warp / cw;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: matrix and row of a lane
  const int RB = tile_rows_max(BN, T);  // rows a tile buffer holds
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* at = smem_raw + SM::q_planes(cw);
  const int kv_bytes = max(SM::kv_planes(RB, kw), SM::merge_bytes(cw));
  __nv_bfloat16* kvs = reinterpret_cast<__nv_bfloat16*>(at);
  QT* rq = reinterpret_cast<QT*>(at + kv_bytes);
  KT* rkv = reinterpret_cast<KT*>(at + kv_bytes + SM::raw_q(cw));
  auto tile = [&](int buf, int which) { return kvs + (buf * 2 + which) * NK * RB * LD; };

  const int n_rep = Hq / Hkv;
  const int b = blockIdx.x / Hkv, hkv = blockIdx.x % Hkv;
  const int rows = n_rep * S;
  const int rho0 = blockIdx.y * BM;
  const int np = npast ? npast[b] : n_past;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  // scores in log2 units: exp(s - m) = exp2(s log2(e) - m log2(e))
  const float s_mul = softcap > 0.f ? scale : scale * LOG2E;
  const float cap_mul = softcap * LOG2E;

  // q rows of this tile: straight into the plane (bf16) or into the raw
  // area to be split (zeros past the last row)
  for (int idx = threadIdx.x; idx < BM * QCH; idx += nthr) {
    const int rr = idx / QCH, ch = idx % QCH, rho = rho0 + rr;
    const bool ok = rho < rows;
    const QT* src = q;
    if (ok) {
      const int s = rho / n_rep, h = hkv * n_rep + rho % n_rep;
      src = q + ((size_t)(b * Hq + h) * S + s) * D + ch * QE;
    }
    if constexpr (NQ == 1) cp_async16(qs + rr * LD + ch * QE, src, ok);
    else cp_async16(rq + rr * D + ch * QE, src, ok);
  }
  cp_async_commit();

  const size_t head = ((size_t)b * Hkv + hkv) * (size_t)kv_head_stride;
  const KT* kh = k + head;
  const KT* vh = v + head;
  const int s_last = (min(rho0 + BM, rows) - 1) / n_rep;
  const int kend = max(0, causal ? min(T, s_last + np + 1) : T);  // rows past it: never seen
  const int ntiles = (kend + BN - 1) / BN;
  const int nsteps = (ntiles + kw - 1) / kw;

  // K/V rows [t0, t0 + n) of a tile, n = its live rows rounded up to 16
  // (the rows the products read; zeros from kend on): into planes buffer
  // buf (bf16) or into the raw area
  auto tile_rows = [&](int t0) { return min(RB, (kend - t0 + 15) & ~15); };
  auto stage = [&](int t0, int buf) {
    const int n = tile_rows(t0);
    for (int idx = threadIdx.x; idx < n * KCH; idx += nthr) {
      const int jr = idx / KCH, ch = idx % KCH, row = t0 + jr;
      const bool ok = row < kend;
      const size_t off = (size_t)(ok ? row : 0) * D + ch * KE;
      if constexpr (NK == 1) {
        cp_async16(tile(buf, 0) + jr * LD + ch * KE, kh + off, ok);
        cp_async16(tile(buf, 1) + jr * LD + ch * KE, vh + off, ok);
      } else {
        cp_async16(rkv + jr * D + ch * KE, kh + off, ok);
        cp_async16(rkv + (RB + jr) * D + ch * KE, vh + off, ok);
      }
    }
  };
  // the kw tiles of a step: tile kw * step + i into buffer kw * (step & 1) + i
  auto stage_step = [&](int step) {
    for (int i = 0; i < kw && kw * step + i < ntiles; ++i)
      stage((kw * step + i) * BN, NK == 1 ? kw * (step & 1) + i : 0);
  };
  // split the raw chunks this thread copied (its own cp.async are complete)
  auto split_kv = [&](int t0) {
    if constexpr (NK > 1) {
      const int n = tile_rows(t0);
      for (int idx = threadIdx.x; idx < n * KCH; idx += nthr) {
        const int jr = idx / KCH, ch = idx % KCH;
        split_chunk<NK>(rkv + jr * D + ch * KE, tile(0, 0) + jr * LD + ch * KE, RB * LD);
        split_chunk<NK>(rkv + (RB + jr) * D + ch * KE, tile(0, 1) + jr * LD + ch * KE,
                        RB * LD);
      }
    }
  };

  if (ntiles > 0) stage_step(0);
  cp_async_commit();
  if constexpr (NQ > 1) {
    cp_async_wait1();  // q has landed (tile 0 may still fly)
    for (int idx = threadIdx.x; idx < BM * QCH; idx += nthr) {
      const int rr = idx / QCH, ch = idx % QCH;
      split_chunk<NQ>(rq + rr * D + ch * QE, qs + rr * LD + ch * QE, BM * LD);
    }
  }
  if constexpr (NK > 1) {
    cp_async_wait0();
    if (ntiles > 0) split_kv(0);
  }

  // this thread's two rows (g and g + 8 of its slab): the key limit of each
  int lim[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rho = rho0 + slab * 16 + g + 8 * half;
    lim[half] = kg < kw && rho < rows ? (causal ? min(T, rho / n_rep + np + 1) : T) : 0;
  }
  int wlim = max(lim[0], lim[1]), wmin = min(lim[0], lim[1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wlim = max(wlim, __shfl_xor_sync(0xffffffffu, wlim, off));
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, off));
  }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  const __nv_bfloat16* qw = qs + slab * 16 * LD;

  for (int step = 0; step < nsteps; ++step) {
    if constexpr (NK == 1) {
      if (step + 1 < nsteps) stage_step(step + 1);
      cp_async_commit();
      cp_async_wait1();  // this step's tiles have landed
    } else {
      if (step + 1 < nsteps) stage_step(step + 1);  // into the raw area
      cp_async_commit();
    }
    __syncthreads();
    const int tix = kw * step + kg;  // this warp's tile
    const int k0 = tix * BN;
    const int buf = NK == 1 ? kw * (step & 1) + kg : 0;
    const __nv_bfloat16* ks = tile(buf, 0);
    const __nv_bfloat16* vs = tile(buf, 1);
    const int wlive = tix < ntiles ? min(kend, wlim) - k0 : 0;  // keys it may see
    if (wlive > 0) {
      // S = Q·Kᵀ for this warp's 16 rows and the tile's keys, 8 at a time
      float sc[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // A: rows (lm & 1) * 8 + lr, features kk * 16 + (lm >> 1) * 8
        uint32_t a[NQ][4];
#pragma unroll
        for (int p = 0; p < NQ; ++p)
          ldsm4(a[p], qw + p * BM * LD + ((lm & 1) * 8 + lr) * LD + kk * 16 + (lm >> 1) * 8);
        // B of key tiles j, j + 1: keys (j + (lm >> 1)) * 8 + lr, features
        // kk * 16 + (lm & 1) * 8. The plane pairs' products go in separate
        // passes over the key tiles, so that back-to-back mma never wait on
        // one accumulator.
        uint32_t bk[BN / 8][NK][2];
#pragma unroll
        for (int j = 0; j < BN / 8; j += 2) {
          if (8 * j >= wlive) break;
#pragma unroll
          for (int p = 0; p < NK; ++p) {
            uint32_t r[4];
            ldsm4(r, ks + p * RB * LD + ((j + (lm >> 1)) * 8 + lr) * LD + kk * 16 +
                         (lm & 1) * 8);
            bk[j][p][0] = r[0];
            bk[j][p][1] = r[1];
            bk[j + 1][p][0] = r[2];
            bk[j + 1][p][1] = r[3];
          }
          mma(sc[j], a[0], bk[j][0][0], bk[j][0][1]);
          mma(sc[j + 1], a[0], bk[j + 1][0][0], bk[j + 1][0][1]);
        }
        // the other plane pairs (i, jj) of order i + jj <= 2: the terms
        // left out are below 2^-24 of the product
#pragma unroll
        for (int i = 0; i < NQ; ++i)
#pragma unroll
          for (int jj = 0; jj < NK; ++jj) {
            if (i + jj == 0 || i + jj > 2) continue;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              if (8 * (j & ~1) >= wlive) break;
              mma(sc[j], a[i], bk[j][jj][0], bk[j][jj][1]);
            }
          }
      }

      // online softmax in log2 units: sc[j][e] is row g, key k0 + 8j + c2 +
      // e; sc[j][2 + e] row g + 8. Keys past a row's limit only on a tile
      // some row of the warp does not see whole.
      const bool masked = k0 + BN > wmin;
      float alpha[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = sc[j][2 * half + e] * s_mul;
            if (softcap > 0.f) x = tanhf(x * inv_cap) * cap_mul;
            if (masked && k0 + 8 * j + c2 + e >= lim[half]) x = NEG_INF;
            sc[j][2 * half + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[half], mx);
        // a row that has seen no key yet keeps p = 0 (exp2 of -1e30)
        const float m_use = m_new == NEG_INF ? 0.f : m_new;
        alpha[half] = exp2f(m[half] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(sc[j][2 * half + e] - m_use);
            sc[j][2 * half + e] = p;
            sum += p;
          }
        l[half] = l[half] * alpha[half] + sum;
        m[half] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][0] *= alpha[0];
        o[nt][1] *= alpha[0];
        o[nt][2] *= alpha[1];
        o[nt][3] *= alpha[1];
      }

      // O += P·V, 16 keys a step; P's accumulator layout is the A operand's
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        if (16 * kk >= wlive) break;
        uint32_t pp[NP][4];  // P's planes, A fragments
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int jt = 2 * kk + (r >> 1), e0 = 2 * (r & 1);
          uint32_t w[NP];
          split_pair<NP>(sc[jt][e0], sc[jt][e0 + 1], w);
#pragma unroll
          for (int i = 0; i < NP; ++i) pp[i][r] = w[i];
        }
        // one pass over the output tiles a (P plane, V plane) pair (B of
        // output tiles nt, nt + 1: keys kk * 16 + (lm & 1) * 8 + lr,
        // features (nt + (lm >> 1)) * 8, transposed)
        auto pv_pass = [&](const uint32_t* pa, int p) {
#pragma unroll
          for (int nt = 0; nt < NT; nt += 2) {
            uint32_t r[4];
            ldsm4_t(r, vs + p * RB * LD + (kk * 16 + (lm & 1) * 8 + lr) * LD +
                           (nt + (lm >> 1)) * 8);
            mma(o[nt], pa, r[0], r[1]);
            mma(o[nt + 1], pa, r[2], r[3]);
          }
        };
#pragma unroll
        for (int i = 0; i < NP; ++i)
#pragma unroll
          for (int jj = 0; jj < NK; ++jj)
            if (i + jj <= 2) pv_pass(pp[i], jj);
      }
    }
    __syncthreads();  // the tiles are read before they are refilled
    if constexpr (NK > 1) {
      if (step + 1 < nsteps) {
        cp_async_wait0();
        split_kv((step + 1) * BN);
      }
    }
  }
  cp_async_wait0();  // nothing in flight past here (a block with no tile)

  // key group 1 hands its rows' states to key group 0 (kw is 1 or 2)
  if (kw == 2) {
    float* mb = reinterpret_cast<float*>(at) + (slab * 32 + lane) * (D / 2 + 4);
    if (kg == 1) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) mb[4 * nt + i] = o[nt][i];
      mb[D / 2] = m[0];
      mb[D / 2 + 1] = m[1];
      mb[D / 2 + 2] = l[0];
      mb[D / 2 + 3] = l[1];
    }
    __syncthreads();
    if (kg == 1) return;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float mo = mb[D / 2 + half];
      const float mm = fmaxf(m[half], mo);
      const float m_use = mm == NEG_INF ? 0.f : mm;
      const float a0 = exp2f(m[half] - m_use), a1 = exp2f(mo - m_use);
      l[half] = l[half] * a0 + mb[D / 2 + 2 + half] * a1;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[nt][2 * half + e] = o[nt][2 * half + e] * a0 + mb[4 * nt + 2 * half + e] * a1;
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sum = l[half];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int rho = rho0 + slab * 16 + g + 8 * half;
    if (kg != 0 || rho >= rows) continue;
    const float inv = 1.f / (sum > 0.f ? sum : 1.f);
    const int s = rho / n_rep, h = hkv * n_rep + rho % n_rep;
    float* orow = out + ((size_t)(b * Hq + h) * S + s) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<float2*>(orow + nt * 8 + c2) =
          make_float2(o[nt][2 * half] * inv, o[nt][2 * half + 1] * inv);
  }
}

template <int D, typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const int* npast,
           int n_past, float* out, int B, int Hq, int Hkv, int S, int T,
           long long kv_head_stride, int causal, float scale, float softcap,
           cudaStream_t stream) {
  using SM = Smem<D, QT, KT>;
  constexpr int MAXW = Tile<D, KT>::MAXW;
  auto kern = flash_attn_kernel<D, QT, KT>;
  static bool attr_set = false;  // once an instance, at its largest block
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SM::bytes(MAXW, Tile<D, KT>::BN, 2));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int rows = (Hq / Hkv) * S;
  const int cw = min(MAXW, (rows + 15) / 16);  // warps that own rows
  const int rb = tile_rows_max(Tile<D, KT>::BN, T);
  // two key groups (each a tile of every pair) where there are two tiles to
  // share and their buffers fit: bf16 K/V, D <= 128
  const int kw = Planes<KT>::n == 1 && D <= 128 && T > Tile<D, KT>::BN ? 2 : 1;
  dim3 grid(B * Hkv, (rows + 16 * cw - 1) / (16 * cw));
  kern<<<grid, (kw == 2 ? max(2 * cw, MAXW) : MAXW) * 32, SM::bytes(cw, rb, kw), stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), npast, n_past, out, Hq, Hkv, S, T,
      kv_head_stride, scale, softcap, causal, cw, kw);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int* npast, int n_past, float* out, int B, int Hq,
               int Hkv, int S, int T, long long kv_head_stride, int causal,
               float scale, float softcap, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32, QT, KT>(q, k, v, npast, n_past, out, B, Hq, Hkv, S, T, kv_head_stride, causal, scale, softcap, stream);
    case 64: return launch<64, QT, KT>(q, k, v, npast, n_past, out, B, Hq, Hkv, S, T, kv_head_stride, causal, scale, softcap, stream);
    case 128: return launch<128, QT, KT>(q, k, v, npast, n_past, out, B, Hq, Hkv, S, T, kv_head_stride, causal, scale, softcap, stream);
    case 256: return launch<256, QT, KT>(q, k, v, npast, n_past, out, B, Hq, Hkv, S, T, kv_head_stride, causal, scale, softcap, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Element types: 0 f32, 1 bf16, 2 f16. (q_type, kv_type) is one of (0, 0),
// (0, 1), (0, 2), (1, 1), (2, 2). D is 32, 64, 128 or 256 and Hq a multiple
// of Hkv. npast: int32 [B] on the device, or null for the static n_past.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          const int* npast, int n_past, float* out, int B,
                          int Hq, int Hkv, int S, int T, int D,
                          long long kv_head_stride, int q_type, int kv_type,
                          int causal, float scale, float softcap,
                          cudaStream_t stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
#define FLASH_ARGS D, q, k, v, npast, n_past, out, B, Hq, Hkv, S, T, kv_head_stride, causal, scale, softcap, stream
  if (q_type == 0 && kv_type == 0) return dispatch_d<float, float>(FLASH_ARGS);
  if (q_type == 0 && kv_type == 1) return dispatch_d<float, __nv_bfloat16>(FLASH_ARGS);
  if (q_type == 0 && kv_type == 2) return dispatch_d<float, __half>(FLASH_ARGS);
  if (q_type == 1 && kv_type == 1) return dispatch_d<__nv_bfloat16, __nv_bfloat16>(FLASH_ARGS);
  if (q_type == 2 && kv_type == 2) return dispatch_d<__half, __half>(FLASH_ARGS);
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}
