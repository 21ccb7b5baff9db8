// Batched single-token decode attention over a flat KV cache, for Hopper
// (sm_90a), f32 online softmax, split over the cache rows.
//
// Replaces ggmlsharp_tpu/kernels/attn_decode.py::_call_flash_decode, both
// lane maps: entry flash_decode_flat (layout "heads"), the attention of every
// batched decode step of the serving path, and entry flash_decode_flat_attn
// (layout "attn"), batched decode over a cache kept in the whole-block llama
// kernel's TPU row order.
//
//   q [B, Hq, D] f32 (unscaled: the kernel multiplies it by `scale`, as the
//   JAX kernel's caller pre-scales it); kn/vn [B, E] f32: the fresh
//   token's K/V rows, unquantized; kc/vc [B, T, E] (a prefix view: batch
//   entries kv_batch_stride elements apart, rows E apart; lane j of a row
//   belongs to KV head j / D), int8 or bf16; for int8, ks/vs [B, T, Hkv]
//   f32 scales a (token, head), batch entries sc_batch_stride apart;
//   npast int32 [B]  ->  out [B, Hq, D] f32.
//   Slot b's query sees the cache rows t < min(npast[b], T) (row npast[b] is
//   stale: the fresh row stands in for it) plus the fresh row, which seeds
//   the online softmax with weight exp(0). Query head h reads KV head
//   h / n_rep (GQA without a repeated copy).
//   With attn_layout set, the lanes of a row are mapped otherwise: KV head h
//   owns lanes [h D/2, (h+1) D/2) and the same run at + E/2, and q and out
//   are [B, n_rep, E] (sub-query r of every KV head in one E-wide row in
//   that same map). Only where a head's features lie changes: the loop is
//   the same.
//
// What bounds it: bytes. Each live K/V element is read once and used for
// 2 * n_rep FMAs; at B = 8, T = 2048, E = 4096 int8 that is 134 MB a call
// (40 us at 3.35 TB/s) against 1.1 GFLOP of f32 work. So the kernel needs
// enough loads in flight to cover the memory's latency, on every SM, at
// every batch size; tensor cores buy nothing at n_rep = 1.
//
// Design: split-K over the cache. The grid is (Hkv, B, splits); `splits`
// comes from the host (kernels/attn_decode.py::decode_splits: as many as
// keep the grid within one wave of four blocks an SM, at least 64 rows a
// split), and split z takes the rows [z * chunk, (z + 1) * chunk), chunk =
// ceil(T / splits), that are live. A block is 4 warps. It copies its rows
// tile by tile (8 KB of K and 8 KB of V: 64 int8 rows at D 128, 32 bf16)
// with cp.async, in the storage type, double buffered, with the rows'
// scales: the loads in flight cost no registers, which a load into
// registers would (8 a row: the register-load version of this kernel kept
// too few bytes in flight, 17.3 us at B 1, T 2048 on an H100 80GB HBM3,
// against 13.3).
// A row of one head is D * sizeof(KT) bytes: G lanes hold it, 16 bytes
// each (G = 8 for int8 at D 128, 16 for bf16), so a warp takes R = 32 / G
// rows at once and a row group takes 4 rows of a tile. D is 32, 64, 128 or
// 256 (an instance each): from G = 2 (int8 at D 32: R = 16 rows a warp,
// TR = 256 rows a tile, a run of 16 lanes a head in the "attn" map is one
// 16-byte chunk) to G = 32 (bf16 at D 256: a warp a row, TR = 16); the
// 16-byte chunks of a row are never split, and a group always takes
// TR / NG = 4 rows of a tile. E_kv need only be a multiple of D (192 at D
// 32 or 64: every offset is a row times E plus a chunk, 16-byte aligned). A lane dequantizes
// its 16 bytes in registers (an int8 score or weight is scaled once, by the
// row's scale; an int8 value becomes a float by a byte permute and one
// subtraction, not the conversion unit) and holds, for up to QR query heads
// at once (n_rep in passes of QR <= 4), its q slice and an online-softmax
// state (m, l, acc[16 bytes' worth of features]); the score of a row is a
// sum over its G lanes (xor shuffles). Shared memory holds the two stages
// and, once they are read, the merge state: about 37 KB a block.
//
// The merge, in the same launch: the states of a warp's R row groups merge
// by xor shuffles, the block's 4 warps in shared memory. With one split the
// block writes out = acc / l. Otherwise it writes its (m, l, acc[D]) to the
// f32 scratch `part` [B, Hkv, splits, n_rep, D + 2], and the last block of a
// (slot, KV head) to arrive (a per-(b, hkv) counter, atomicAdd after a
// __threadfence) merges the splits in split order, a thread a (query row,
// feature), writes out, and sets the counter back to 0 for the next launch. The fresh row seeds split 0's
// first row group only. Against the dense reference only the order of the
// f32 sums changes: rtol 2e-4 / atol 2e-5.
//
// mm_dot (kernels/config.py): RND = 0 ("f32") is the function above. RND =
// 1 ("bf16", JAX's fast mode) rounds what the JAX kernel feeds its matrix
// unit: the scaled query to bf16 for the cache rows' scores, and each cache
// row's softmax weight (times its V scale, INT8) to bf16 before it meets
// the row's values; the fresh row stays f32. A weight rounded relative to
// a running maximum would round differently in every split and tile order,
// so RND runs the softmax in base 2 against an integer maximum: u = s *
// log2(e), m = ceil(max u), p = 2^(u - m), and every rescale between
// states (2^(m - m'), m and m' integers) is an exact power of two, which
// moves no bf16 rounding. The result is then the plain version's up to the
// order of the f32 sums and the last bit of exp2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// 2^e for an integer-valued e <= 0, exactly, built from its exponent bits
// (0 below the smallest normal f32: such a weight is below every bar)
__device__ __forceinline__ float pow2i(float e) {
  return e < -126.f ? 0.f : __int_as_float(((int)e + 127) << 23);
}
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// the rescale factor between softmax states of maxima m <= mm: e^(m - mm),
// or (RND, integer maxima in base 2) 2^(m - mm)
template <int RND>
__device__ __forceinline__ float rescale(float m, float mm) {
  return RND ? pow2i(m - mm) : expf(m - mm);
}
constexpr int WARPS = 4;
constexpr int MAX_SPLITS = 512;

// Where feature i of KV head h lies in a row of E lanes.
__device__ __forceinline__ int lane_of(int h, int i, int D, int E, int attn_layout) {
  if (!attn_layout) return h * D + i;
  const int half = D >> 1;
  return i < half ? h * half + i : (E >> 1) + h * half + i - half;
}

// 16 bytes of a row -> 16 / sizeof(KT) floats (int8 values unscaled). An
// int8 b becomes a float without the conversion unit (a quarter of the FMA
// rate on Hopper, and the kernel's bottleneck when it converted each
// element): the byte b + 128 goes into the mantissa of 2^23, and
// 2^23 + 128 is subtracted, exactly.
__device__ __forceinline__ void unpack16(const int4& u, const int8_t*, float* out) {
  const unsigned w[4] = {(unsigned)u.x, (unsigned)u.y, (unsigned)u.z, (unsigned)u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned biased = w[j] ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[4 * j + i] =
          __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | i)) - 8388736.f;
  }
}
__device__ __forceinline__ void unpack16(const int4& u, const __nv_bfloat16*, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? bytes : 0;  // 0: fill with zeros
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

constexpr int TILE_BYTES = 8192;  // one K (or V) tile of a stage

template <int D, typename KT, int QR, int RND>
__global__ void __launch_bounds__(WARPS * 32)
attn_decode_kernel(const float* __restrict__ q, const float* __restrict__ kn,
                   const float* __restrict__ vn, const KT* __restrict__ kc,
                   const KT* __restrict__ vc, const float* __restrict__ ks,
                   const float* __restrict__ vs, const int* __restrict__ npast,
                   float* __restrict__ out, float* __restrict__ part,
                   int* __restrict__ counter, int Hkv, int n_rep, int T,
                   int chunk, long long kv_batch_stride,
                   long long sc_batch_stride, float scale, int attn_layout) {
  constexpr int VEC = 16 / sizeof(KT);  // features a 16-byte chunk
  constexpr int G = D / VEC;            // lanes a row
  constexpr int R = 32 / G;             // rows a warp reads at once
  constexpr int NG = WARPS * R;         // row groups of the block
  constexpr int RB = D * (int)sizeof(KT);  // bytes of a head's row
  constexpr int TR = TILE_BYTES / RB;   // rows a tile: 64 int8 / 32 bf16 at D 128
  constexpr int UT = TR / NG;           // rows a group takes from a tile (4)
  constexpr int DP = D + 2;             // a partial state: acc[D], m, l
  constexpr unsigned FULL = 0xffffffffu;
  // two stages of K and V tiles, then the rows' scales; the merge state
  // reuses the tiles' bytes once they are read
  __shared__ __align__(16) unsigned char tiles[2 * 2 * TILE_BYTES];
  __shared__ float scl[2][2][TR];
  __shared__ float wm[WARPS][QR], wl[WARPS][QR];
  __shared__ int is_last;
  static_assert(WARPS * QR * D * 4 <= (int)sizeof(tiles), "merge state fits");
  float* wacc = reinterpret_cast<float*>(tiles);  // [WARPS][QR][D]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane / G, f0 = (lane % G) * VEC;
  const int hkv = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int splits = gridDim.z;
  const int E = Hkv * D;
  const int live = min(npast[b], T);  // cache rows this slot attends
  const int t_begin = z * chunk, t_end = min(t_begin + chunk, live);
  const int ntiles = t_end > t_begin ? (t_end - t_begin + TR - 1) / TR : 0;
  const int at = lane_of(hkv, f0, D, E, attn_layout);  // where its features lie in a row
  const KT* kb = kc + (size_t)b * kv_batch_stride;
  const KT* vb = vc + (size_t)b * kv_batch_stride;
  const float* ksb = ks ? ks + (size_t)b * sc_batch_stride + hkv : nullptr;
  const float* vsb = vs ? vs + (size_t)b * sc_batch_stride + hkv : nullptr;
  const size_t head = (size_t)b * Hkv + hkv;
  float* pz = part ? part + ((head * splits + z) * n_rep) * DP : nullptr;

  // feature f of query row r (and of its output row)
  auto q_at = [&](int r, int f) -> size_t {
    return attn_layout ? ((size_t)b * n_rep + r) * E + lane_of(hkv, f, D, E, 1)
                       : (head * n_rep + r) * D + f;
  };
  // rows [t0, t0 + TR) of K, V (and their scales) into stage st; zeros past t_end
  auto stage = [&](int t0, int st) {
    unsigned char* kd = tiles + st * 2 * TILE_BYTES;
    for (int idx = threadIdx.x; idx < TR * G; idx += WARPS * 32) {
      const int jr = idx / G, c = idx % G, t = t0 + jr;
      const bool ok = t < t_end;
      const size_t off = (size_t)(ok ? t : 0) * E + lane_of(hkv, c * VEC, D, E, attn_layout);
      cp_async(kd + jr * RB + c * 16, kb + off, 16, ok);
      cp_async(kd + TILE_BYTES + jr * RB + c * 16, vb + off, 16, ok);
    }
    if (ksb)
      for (int jr = threadIdx.x; jr < TR; jr += WARPS * 32) {
        const int t = t0 + jr;
        const bool ok = t < t_end;
        cp_async(&scl[st][0][jr], ksb + (size_t)(ok ? t : 0) * Hkv, 4, ok);
        cp_async(&scl[st][1][jr], vsb + (size_t)(ok ? t : 0) * Hkv, 4, ok);
      }
  };

  for (int r0 = 0; r0 < n_rep; r0 += QR) {
    // the first tile is in flight before q is read
    if (ntiles > 0) stage(t_begin, 0);
    cp_async_commit();

    float qv[QR][VEC], m[QR], l[QR], acc[QR][VEC];
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      const bool ok = r0 + r < n_rep;
      const float4* qa = reinterpret_cast<const float4*>(q + (ok ? q_at(r0 + r, f0) : 0));
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i) {
        const float4 x = ok ? qa[i] : make_float4(0.f, 0.f, 0.f, 0.f);
        qv[r][4 * i] = x.x * scale;
        qv[r][4 * i + 1] = x.y * scale;
        qv[r][4 * i + 2] = x.z * scale;
        qv[r][4 * i + 3] = x.w * scale;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
      m[r] = NEG_INF;
      l[r] = 0.f;
    }

    // The fresh row seeds split 0's first row group: m = its score, l = 1,
    // acc = its V slice.
    if (z == 0 && warp == 0) {
      float kf[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = kn[(size_t)b * E + at + i];
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) d = fmaf(qv[r][i], kf[i], d);
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) d += __shfl_xor_sync(FULL, d, off);
        if (gi == 0) {
          // RND: m the integer ceiling of the base-2 score, l = 2^(u - m)
          const float u = d * LOG2E;
          m[r] = RND ? ceilf(u) : d;
          l[r] = RND ? exp2f(u - m[r]) : 1.f;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[r][i] = l[r] * vn[(size_t)b * E + at + i];
        }
      }
    }
    if (RND) {  // the cache rows' scores take the query rounded to bf16
#pragma unroll
      for (int r = 0; r < QR; ++r)
#pragma unroll
        for (int i = 0; i < VEC; ++i) qv[r][i] = bf16_round(qv[r][i]);
    }

    // the split's rows, a tile of TR at a time, the next tile loading; a
    // group takes rows gi + NG * u of a tile (whole rows across G lanes)
    const int my = warp * R + gi;
    for (int it = 0; it < ntiles; ++it) {
      const int t0 = t_begin + it * TR;
      if (it + 1 < ntiles) stage(t0 + TR, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait1();  // tile it has landed
      __syncthreads();
      const unsigned char* kt = tiles + (it & 1) * 2 * TILE_BYTES;
      const unsigned char* vt = kt + TILE_BYTES;
      float p[QR][UT];
#pragma unroll
      for (int u = 0; u < UT; ++u) {
        const int jr = my + u * NG;
        float kf[VEC];
        unpack16(*reinterpret_cast<const int4*>(kt + jr * RB + (lane % G) * 16), kc, kf);
        const float sk = ksb ? scl[it & 1][0][jr] : 1.f;
        const bool ok = t0 + jr < t_end;
#pragma unroll
        for (int r = 0; r < QR; ++r) {
          float d4[4] = {0.f, 0.f, 0.f, 0.f};  // four short FMA chains
#pragma unroll
          for (int i = 0; i < VEC; ++i) d4[i % 4] = fmaf(qv[r][i], kf[i], d4[i % 4]);
          float d = (d4[0] + d4[1]) + (d4[2] + d4[3]);
#pragma unroll
          for (int off = G / 2; off > 0; off >>= 1) d += __shfl_xor_sync(FULL, d, off);
          p[r][u] = ok ? (RND ? d * sk * LOG2E : d * sk) : NEG_INF;
        }
      }
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < UT; ++u) mx = fmaxf(mx, p[r][u]);
        if (RND) mx = ceilf(mx);
        const float alpha = rescale<RND>(m[r], mx);
        l[r] *= alpha;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] *= alpha;
#pragma unroll
        for (int u = 0; u < UT; ++u) {
          p[r][u] = t0 + my + u * NG < t_end
                        ? (RND ? exp2f(p[r][u] - mx) : expf(p[r][u] - mx)) : 0.f;
          l[r] += p[r][u];
        }
        m[r] = mx;
      }
#pragma unroll
      for (int u = 0; u < UT; ++u) {
        const int jr = my + u * NG;
        float vf[VEC];
        unpack16(*reinterpret_cast<const int4*>(vt + jr * RB + (lane % G) * 16), vc, vf);
        const float sv = vsb ? scl[it & 1][1][jr] : 1.f;
#pragma unroll
        for (int r = 0; r < QR; ++r) {
          const float w = RND ? bf16_round(p[r][u] * sv) : p[r][u] * sv;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[r][i] = fmaf(w, vf[i], acc[r][i]);
        }
      }
      __syncthreads();  // the stage is read before it is refilled
    }

    // merge the warp's R row groups (lanes G, 2G, ... apart hold the same
    // features), then the block's warps in shared memory
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        const float mo = __shfl_xor_sync(FULL, m[r], off);
        const float lo = __shfl_xor_sync(FULL, l[r], off);
        const float mm = fmaxf(m[r], mo);
        const float a = rescale<RND>(m[r], mm), c = rescale<RND>(mo, mm);
        l[r] = l[r] * a + lo * c;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[r][i] = acc[r][i] * a + __shfl_xor_sync(FULL, acc[r][i], off) * c;
        m[r] = mm;
      }
    }
    cp_async_wait0();
    __syncthreads();  // the tiles' bytes now hold the merge state
    if (gi == 0) {
#pragma unroll
      for (int r = 0; r < QR; ++r) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) wacc[(warp * QR + r) * D + f0 + i] = acc[r][i];
        if (lane == 0) {
          wm[warp][r] = m[r];
          wl[warp][r] = l[r];
        }
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < QR * D; idx += WARPS * 32) {
      const int r = idx / D, f = idx % D;
      if (r0 + r >= n_rep) continue;
      float mm = NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, wm[w][r]);
      float ll = 0.f, aa = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float e = rescale<RND>(wm[w][r], mm);
        ll = fmaf(wl[w][r], e, ll);
        aa = fmaf(wacc[(w * QR + r) * D + f], e, aa);
      }
      if (splits == 1) {
        out[q_at(r0 + r, f)] = aa / ll;
      } else {
        float* pr = pz + (size_t)(r0 + r) * DP;
        pr[f] = aa;
        if (f == 0) {
          pr[D] = mm;
          pr[D + 1] = ll;
        }
      }
    }
    __syncthreads();  // wacc's bytes are tiles again in the next pass
  }
  if (splits == 1) return;

  // the last block of this (slot, KV head) to finish merges the splits
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter + head, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // every (query row, feature) of the slot's KV head at once: a thread
  // reads the splits' (m, l) and its feature's acc, in split order
  const float* ph = part + head * splits * n_rep * DP;  // [splits][n_rep][DP]
  for (int idx = threadIdx.x; idx < n_rep * D; idx += WARPS * 32) {
    const int r = idx / D, f = idx % D;
    const float* pr = ph + (size_t)r * DP;
    const size_t zs = (size_t)n_rep * DP;  // split stride
    float mm = NEG_INF;
#pragma unroll 8
    for (int zz = 0; zz < splits; ++zz) mm = fmaxf(mm, __ldcg(pr + zz * zs + D));
    float ll = 0.f, aa = 0.f;
#pragma unroll 8
    for (int zz = 0; zz < splits; ++zz) {
      const float e = rescale<RND>(__ldcg(pr + zz * zs + D), mm);
      ll = fmaf(__ldcg(pr + zz * zs + D + 1), e, ll);
      aa = fmaf(__ldcg(pr + zz * zs + f), e, aa);
    }
    out[q_at(r, f)] = aa / ll;
  }
  if (threadIdx.x == 0) counter[head] = 0;
}

template <int D, typename KT, int QR>
int launch(const float* q, const float* kn, const float* vn, const void* kc,
           const void* vc, const float* ks, const float* vs, const int* npast,
           float* out, float* part, int* counter, int B, int Hkv, int n_rep,
           int T, long long kv_batch_stride, long long sc_batch_stride,
           float scale, int attn_layout, int splits, int rnd, cudaStream_t stream) {
  dim3 grid(Hkv, B, splits);
  auto kern = rnd ? attn_decode_kernel<D, KT, QR, 1> : attn_decode_kernel<D, KT, QR, 0>;
  kern<<<grid, WARPS * 32, 0, stream>>>(
      q, kn, vn, static_cast<const KT*>(kc), static_cast<const KT*>(vc), ks,
      vs, npast, out, part, counter, Hkv, n_rep, T, (T + splits - 1) / splits,
      kv_batch_stride, sc_batch_stride, scale, attn_layout);
  return (int)cudaGetLastError();
}

template <int D, typename KT>
int launch_qr(const float* q, const float* kn, const float* vn, const void* kc,
              const void* vc, const float* ks, const float* vs, const int* npast,
              float* out, float* part, int* counter, int B, int Hkv, int n_rep,
              int T, long long kvs, long long scs, float scale, int attn_layout,
              int splits, int rnd, cudaStream_t stream) {
#define DECODE_ARGS q, kn, vn, kc, vc, ks, vs, npast, out, part, counter, B, Hkv, n_rep, T, kvs, scs, scale, attn_layout, splits, rnd, stream
  if (n_rep == 1) return launch<D, KT, 1>(DECODE_ARGS);
  if (n_rep == 2) return launch<D, KT, 2>(DECODE_ARGS);
  return launch<D, KT, 4>(DECODE_ARGS);
#undef DECODE_ARGS
}

template <typename KT>
int launch_d(int D, const float* q, const float* kn, const float* vn,
             const void* kc, const void* vc, const float* ks, const float* vs,
             const int* npast, float* out, float* part, int* counter, int B,
             int Hkv, int n_rep, int T, long long kvs, long long scs,
             float scale, int attn_layout, int splits, int rnd, cudaStream_t stream) {
  if (D == 128)
    return launch_qr<128, KT>(q, kn, vn, kc, vc, ks, vs, npast, out, part, counter, B, Hkv,
                              n_rep, T, kvs, scs, scale, attn_layout, splits, rnd, stream);
  if (D == 64)
    return launch_qr<64, KT>(q, kn, vn, kc, vc, ks, vs, npast, out, part, counter, B, Hkv,
                             n_rep, T, kvs, scs, scale, attn_layout, splits, rnd, stream);
  if (D == 32)
    return launch_qr<32, KT>(q, kn, vn, kc, vc, ks, vs, npast, out, part, counter, B, Hkv,
                             n_rep, T, kvs, scs, scale, attn_layout, splits, rnd, stream);
  if (D == 256)
    return launch_qr<256, KT>(q, kn, vn, kc, vc, ks, vs, npast, out, part, counter, B, Hkv,
                              n_rep, T, kvs, scs, scale, attn_layout, splits, rnd, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// kv_kind: 0 bf16, 1 int8 (then ks/vs are required). attn_layout: 0 the
// "heads" lane map, 1 the "attn" one (float caches only). D must be 32, 64,
// 128 or 256, n_rep any count from 1 (query rows in passes of QR <= 4).
// Pointers 16-byte aligned and batch strides
// multiples of 16 bytes (the wrapper checks). splits in 1..min(T, 512);
// above 1, part is an f32 scratch of B * Hkv * splits * n_rep * (D + 2)
// floats and counter an int32 [B * Hkv], all 0 (the kernel leaves it so).
// One launch at a time may use a counter buffer (the wrapper keeps one a
// stream). rnd: the mm_dot "bf16" function (RND above), else "f32".
// Returns the first CUDA error of the launch, or 0.
extern "C" int attn_decode(const float* q, const float* kn, const float* vn,
                           const void* kc, const void* vc, const float* ks,
                           const float* vs, const int* npast, float* out,
                           float* part, int* counter, int B, int Hkv,
                           int n_rep, int T, int D, long long kv_batch_stride,
                           long long sc_batch_stride, int kv_kind,
                           float scale, int attn_layout, int splits, int rnd,
                           cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || T <= 0 || n_rep <= 0)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > MAX_SPLITS || splits > T) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part == nullptr || counter == nullptr)) return (int)cudaErrorInvalidValue;
  if (attn_layout && kv_kind != 0) return (int)cudaErrorInvalidValue;
  if (kv_kind == 1 && (ks == nullptr || vs == nullptr)) return (int)cudaErrorInvalidValue;
  if (kv_kind == 1)
    return launch_d<int8_t>(D, q, kn, vn, kc, vc, ks, vs, npast, out, part, counter, B, Hkv,
                            n_rep, T, kv_batch_stride, sc_batch_stride, scale, 0, splits,
                            rnd, stream);
  if (kv_kind == 0)
    return launch_d<__nv_bfloat16>(D, q, kn, vn, kc, vc, nullptr, nullptr, npast, out, part,
                                   counter, B, Hkv, n_rep, T, kv_batch_stride, 0, scale,
                                   attn_layout, splits, rnd, stream);
  return (int)cudaErrorInvalidValue;
}
