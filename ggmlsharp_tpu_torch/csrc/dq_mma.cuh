// The multi-row instance of the dequant-matmuls on the tensor cores, shared
// by matmul_q4_0.cu (Q4_0) and matmul_q.cu (Q4_1 ... Q6_K):
//   y[b, n] = sum_k x[b, k] * w[n, k],  x, y f32; w packed, one decoder a format.
// The wrappers (kernels/matmul_q.py) launch it for every b >= MMA_MIN_ROWS;
// one activation row keeps the sources' b = 1 instance.
//
// What bounds it: at a few rows the HBM bytes of the packed weight, as at
// b = 1; the products (2·b·N·K, one or three bf16 products a term below)
// pass the bytes, at the dense bf16 rate and 4.5 bits a weight, near
// b = 28 with three planes and b = 83 with one.
//
// Design, simple first:
//  * Weights on the M side: mma.sync.m16n8k16 (bf16 operands, f32
//    accumulators) takes 16 weight rows (A) against 8 activation rows (B).
//    A CTA of WARPS warps owns ROWS weight rows (MT 16-row tiles a warp) and
//    8·NT activation rows (NT = 1 n-tile for b <= 8, else 2, or 4 past 16
//    rows with one activation plane); ragged b and N are masked (rows past
//    them read the last valid one; their results are never stored).
//  * Weight values are exact in bf16. Each format's decoder turns the packed
//    integers into bf16 pairs of q - offset (or q, with the min folded): a
//    byte permute puts 0x43 above each byte, the bf16 of 128 + q, and one
//    bf16x2 subtraction of 128 + offset leaves the value exactly. A lane
//    holds elements 4t..4t+3 of each 16-deep k-step (t = lane % 4) at the
//    fragment's slots 2t, 2t + 1, 2t + 8, 2t + 9; the activations are read
//    in the same order, so the product is the same sum.
//  * x is kept exactly: a first kernel writes it once into the caller's
//    scratch as bf16 planes, with the f32 sum of every 16 columns. f32 x
//    (split_x) takes three planes (hi + mid + lo: f32's 24 bits;
//    split_pair), and a product takes all three. Q8 activations, int8
//    values times a block scale (split_q8), take one plane, the int8
//    values, which bf16 holds exactly; the block's fold then also
//    multiplies by the activation scale.
//  * The loads are asynchronous: K goes in chunks of KC columns, and each
//    chunk's weight bytes (every plane's slice of each of the CTA's rows)
//    and x tile (planes and sums) land in shared memory by cp.async, STAGES
//    chunks in flight, one barrier a chunk. The planes are only 4-byte
//    aligned: the packed quants (rows a multiple of 16 bytes) copy in
//    16-byte pieces where the plane's base allows it, else in 4-byte words
//    like the small planes (scales, mins: src-size clamps a slice's end,
//    and a 2-byte field rides in the word that holds it); x, the kernel's
//    own scratch, in 16 bytes. A warp reads its fragments from
//    shared memory (weight rows rw() words apart: conflict-free) and keeps
//    the B fragments in registers for its MT weight tiles.
//  * Scales as the b = 1 kernels apply them: a block's k-steps (two for a
//    32-element block, one for 16) run into a zeroed fragment, which is
//    folded once: acc = fma(d, c_blk, acc), then + m · sum_blk x where the
//    format has a min. Each x plane runs its own chain of mma (c_blk =
//    hi + (mid + lo)), so the block's products are not one long dependence.
//  * SMs are filled by splitting K: split s of S takes chunks
//    [s·C/S, (s+1)·C/S) of the C = ceil(K / KC) and writes its partial
//    sums; a third kernel adds them in split order (no atomics). S comes
//    from (N, K, SM count) alone (kernels/matmul_q.py mma_splits), never
//    from b, and a row's sums run in the same order in every n-tile, so a
//    row's bits do not depend on how many rows share the launch.
//  * No launch geometry: the (warps, rows a warp) pair of the b = 1
//    instance means nothing here.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {
namespace dqm {

constexpr int WARPS = 4;                // warps a CTA
constexpr int MT = 2;                   // 16-row weight tiles a warp
constexpr int ROWS = WARPS * MT * 16;   // weight rows a CTA (matmul_q.py MMA_ROWS)
constexpr int KC = 256;                 // columns a chunk: the split unit (matmul_q.py MMA_KC)
constexpr int XLD = KC + 16;            // bf16 stride of a staged x row: 8-byte reads conflict-free
constexpr int SUMS = KC / 16;           // 16-column sums of a chunk
constexpr int STAGES = 2;               // chunks a CTA has in flight (fewer if they do not fit)
constexpr int SMEM_MAX = 232448;        // shared memory a CTA may take

struct Planes {
  const void* p[4];
};

// Where a plane keeps a weight row's bytes for chunk c: from byte
// row * stride + c * cbytes of base, min(cbytes, stride - c * cbytes) of
// them (a legacy K's last chunk is short).
struct Lin {
  const uint8_t* base;
  int stride, cbytes;
};

// 16-column sums (and 32-column activation scales) a row of the split
// kernels' scratch holds, rounded up to 4 so each row starts 16-byte
// aligned
__host__ __device__ inline int sum_ld(int K) { return ((K / 16) + 3) & ~3; }
__host__ __device__ inline int scale_ld(int K) { return ((K / 32) + 3) & ~3; }

// cp.async of the 4-byte word at src, its first n bytes (0..4) read, the
// rest zero-filled
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// f16(a * b) as f32: the JAX package's fused k-quant scale
__device__ __forceinline__ float f16_round(float v) { return __half2float(__float2half_rn(v)); }

// The f16 at byte offset `byte` of a staged slice
__device__ __forceinline__ float lds_h(const uint32_t* slice, int byte) {
  return __half2float(
      *reinterpret_cast<const __half*>(reinterpret_cast<const unsigned char*>(slice) + byte));
}

// Bytes 0..3 of v (each < 128) minus off, exactly, as the bf16 pairs
// (v0, v1) -> out[0] and (v2, v3) -> out[1].
template <int OFF>
__device__ __forceinline__ void bytes_bf16(uint32_t v, uint32_t out[2]) {
  constexpr uint32_t bias = (0x4300u + OFF) * 0x10001u;  // bf16 of 128 + OFF, twice
  const uint32_t p[2] = {__byte_perm(v, 0x43u, 0x4140), __byte_perm(v, 0x43u, 0x4342)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p[i]),
                                     *reinterpret_cast<const __nv_bfloat162*>(&bias));
    out[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
}

// Bits 0..3 of h -> bit 4 of bytes 0..3.
__device__ __forceinline__ uint32_t spread4(uint32_t h) {
  return ((h & 1u) << 4) | ((h & 2u) << 11) | ((h & 4u) << 18) | ((h & 8u) << 25);
}

// Words a row's staged slices take, padded to 4 mod 8: eight rows' reads
// of four neighbouring words then fall in 32 distinct banks.
__host__ __device__ constexpr int row_words(int words) { return words + (12 - words % 8) % 8; }

// The decoders. Each names the slices a weight row needs a chunk (NSLICE;
// slice s: ws(s) words at word off(s) of the row's rw() words, from the
// plane lin(s); bulk(s): rows a multiple of 16 bytes long)
// and gives, from the staged row wr, for 32-element group gi of chunk c and
// lane t: w[ks][0] = elements 16ks + 4t, +1 and w[ks][1] = 16ks + 4t + 2,
// +3 of the group as bf16 pairs of their integer values, and d[ks], m[ks],
// the scale and min term of the block that holds k-step ks. A slice's
// first byte sits at byte (start % 4) of its first word (bulk: 0).

// ggml's legacy blocks (quant/formats.py): qs u8 [N, K/2] (byte j of a block
// of BS: elements j and j + BS/2), [qh i32 [N, K/32] (bit l: element l's
// fifth bit)], d [, m] f16 [N, K/BS]; planes in that order.
template <int BS_, int OFF, bool M_, bool Q5>
struct DecLegacy {
  static constexpr int BS = BS_, KALIGN = 32;
  static constexpr bool M = M_;
  static constexpr int SC = 2 * KC / BS;  // bytes of a chunk's d (and m) slice
  // slices: qs, [qh], d, [m]
  static constexpr int NSLICE = 2 + Q5 + M;
  __host__ __device__ static constexpr int ws(int s) {
    return s == 0 ? KC / 8 : (Q5 && s == 1) ? KC / 32 : SC / 4 + 1;
  }
  __host__ __device__ static constexpr int off(int s) { return s == 0 ? 0 : off(s - 1) + ws(s - 1); }
  __host__ __device__ static constexpr int rw() { return row_words(off(NSLICE - 1) + ws(NSLICE - 1)); }
  // qs, and Q5's qh, in 16-byte pieces where the plane allows it
  __host__ __device__ static constexpr bool bulk(int s) { return s == 0; }
  __device__ static Lin lin(int s, const Planes& p, int K) {
    const uint8_t* base = static_cast<const uint8_t*>(p.p[s]);
    if (s == 0) return {base, K / 2, KC / 2};
    if (Q5 && s == 1) return {base, K / 8, KC / 8};
    return {base, 2 * (K / BS), SC};
  }
  __device__ static void group(const uint32_t* wr, size_t row, int c, int gi, int K, int t,
                               uint32_t w[2][2], float d[2], float m[2]) {
    constexpr int sd = 1 + Q5;  // the d slice
    const int mis = (int)((row * 2 * (K / BS) + (size_t)c * SC) & 3);  // of d and m alike
    if constexpr (BS == 32) {
      const uint32_t u = wr[4 * gi + t];
      uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
      if constexpr (Q5) {
        const uint32_t h = wr[off(1) + gi];
        lo |= spread4((h >> (4 * t)) & 0xFu);
        hi |= spread4((h >> (16 + 4 * t)) & 0xFu);
      }
      bytes_bf16<OFF>(lo, w[0]);
      bytes_bf16<OFF>(hi, w[1]);
      d[0] = d[1] = lds_h(wr + off(sd), mis + 2 * gi);
      m[0] = m[1] = M ? lds_h(wr + off(sd + 1), mis + 2 * gi) : 0.f;
    } else {  // 16-element blocks: k-step ks is block 2 gi + ks of the chunk, 8 bytes
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int blk = 2 * gi + ks;
        // elements 4t..4t+3: bytes 4 (t % 2).. of the block, low nibbles for
        // t < 2 (elements 0..7), high for t >= 2 (elements 8..15)
        const uint32_t u = wr[2 * blk + (t & 1)];
        bytes_bf16<OFF>((u >> (4 * (t >> 1))) & 0x0F0F0F0Fu, w[ks]);
        d[ks] = lds_h(wr + off(sd), mis + 2 * blk);
        m[ks] = M ? lds_h(wr + off(sd + 1), mis + 2 * blk) : 0.f;
      }
    }
  }
};

// x f32 [B, K] -> xp bf16 [3][B][K] (the three planes of each value) and
// xsum f32 [B][sum_ld(K)] (the sum of each 16 columns). Thread i takes
// float4 i; four neighbouring lanes hold 16 columns of one row (K % 32 == 0).
__global__ void split_x(const float* __restrict__ x, __nv_bfloat16* __restrict__ xp,
                        float* __restrict__ xsum, int B, int K) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n4 = (size_t)B * K / 4;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n4) v = __ldg(reinterpret_cast<const float4*>(x) + i);
  uint32_t lo[3], hi[3];
  split_pair<3>(v.x, v.y, lo);
  split_pair<3>(v.z, v.w, hi);
  float sm = (v.x + v.y) + (v.z + v.w);  // every lane takes part in the shuffles
  sm += __shfl_xor_sync(0xffffffffu, sm, 1);
  sm += __shfl_xor_sync(0xffffffffu, sm, 2);
  if (i >= n4) return;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    reinterpret_cast<uint2*>(xp + (size_t)p * B * K)[i] = make_uint2(lo[p], hi[p]);
  const size_t b = 4 * i / K;
  const int col = (int)(4 * i - b * K);
  if ((i & 3) == 0) xsum[b * sum_ld(K) + col / 16] = sm;
}

// Q8 activations, x = d * xq[b, k] with d the scale of k's block of KB
// columns (32 or 256; f16 or f32: Q8_0, Q8_1 or Q8_K) in xd [B][K / KB]
// -> xp bf16 [1][B][K] (the int8 values, exact), xsum f32 [B][sum_ld(K)]
// (d times the integer sum of each 16 columns) and xs f32
// [B][scale_ld(K)] (d of each 32 columns).
template <typename DT, int KB>
__global__ void split_q8(const int8_t* __restrict__ xq, const DT* __restrict__ xd,
                         __nv_bfloat16* __restrict__ xp, float* __restrict__ xsum,
                         float* __restrict__ xs, int B, int K) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n4 = (size_t)B * K / 4;
  char4 q = make_char4(0, 0, 0, 0);
  if (i < n4) q = __ldg(reinterpret_cast<const char4*>(xq) + i);
  int sq = ((int)q.x + q.y) + ((int)q.z + q.w);
  sq += __shfl_xor_sync(0xffffffffu, sq, 1);
  sq += __shfl_xor_sync(0xffffffffu, sq, 2);
  if (i >= n4) return;
  const __nv_bfloat162 lo = __floats2bfloat162_rn((float)q.x, (float)q.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn((float)q.z, (float)q.w);
  reinterpret_cast<uint2*>(xp)[i] =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  const size_t b = 4 * i / K;
  const int col = (int)(4 * i - b * K);
  const float d = to_f32(xd[b * (K / KB) + col / KB]);
  if ((i & 3) == 0) xsum[b * sum_ld(K) + col / 16] = d * (float)sq;
  if ((i & 7) == 0) xs[b * scale_ld(K) + col / 32] = d;
}

// P bf16 planes of the activations: 3 for f32 x (exact), 1 for Q8
// activations, whose int8 values bf16 holds exactly; then the block's fold
// also multiplies by the activation scale.
template <class Dec, int NT, int P>
struct Cfg {
  static constexpr int BR = 8 * NT;  // activation rows a CTA
  static constexpr int WBYTES = ROWS * Dec::rw() * 4;
  static constexpr int XBYTES = P * BR * XLD * 2;
  static constexpr int SBYTES = Dec::M ? BR * SUMS * 4 : 0;
  static constexpr int DBYTES = P == 1 ? BR * (KC / 32) * 4 : 0;
  static constexpr int STAGE = WBYTES + XBYTES + SBYTES + DBYTES;  // each a multiple of 16
  static constexpr int NSTAGE = STAGES * STAGE <= SMEM_MAX ? STAGES : SMEM_MAX / STAGE;
  static_assert(NSTAGE >= 2, "two stages must fit in shared memory");
  static constexpr int SMEM = NSTAGE * STAGE;
};

// xp, xsum (, xs): the split kernel's output; out: y [B][N], or the
// partial sums [splits][B][N] when splits > 1.
template <class Dec, int NT, int P>
__global__ void __launch_bounds__(WARPS * 32)
dq_mma_kernel(const __nv_bfloat16* __restrict__ xp, const float* __restrict__ xsum,
              const float* __restrict__ xs, Planes pl, float* __restrict__ out, int B, int N,
              int K, int splits) {
  using C = Cfg<Dec, NT, P>;
  constexpr int BR = C::BR;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * BR;
  const int n_cta = blockIdx.y * ROWS;
  const size_t plane = (size_t)B * K;
  const int sld = sum_ld(K), dld = scale_ld(K);

  const int chunks = (K + KC - 1) / KC;
  const int s = blockIdx.z;
  const int c0 = (int)((long long)s * chunks / splits);
  const int nch = (int)((long long)(s + 1) * chunks / splits) - c0;

  // issue the copies of chunk c into stage buffer `buf`
  auto stage = [&](int c, int buf) {
    unsigned char* base = smem + buf * C::STAGE;
    uint32_t* W = reinterpret_cast<uint32_t*>(base);
#pragma unroll
    for (int sl = 0; sl < Dec::NSLICE; ++sl) {
      const Lin ln = Dec::lin(sl, pl, K);
      const int nw = Dec::ws(sl);
      const size_t coff = (size_t)c * ln.cbytes;
      const int valid = min(ln.cbytes, ln.stride - c * ln.cbytes);
      uint32_t* dst = W + Dec::off(sl);
      if (Dec::bulk(sl) && (reinterpret_cast<uintptr_t>(ln.base) & 15) == 0) {
        for (int i = tid; i < ROWS * (nw / 4); i += WARPS * 32) {
          const int r = i / (nw / 4), q = i - r * (nw / 4);
          const size_t row = (size_t)min(n_cta + r, N - 1);
          const bool ok = 16 * q < valid;
          cp_async16(dst + r * Dec::rw() + 4 * q,
                     ln.base + row * ln.stride + coff + (ok ? 16 * q : 0), ok);
        }
      } else {  // 4-byte words over the slice's bytes
        for (int i = tid; i < ROWS * nw; i += WARPS * 32) {
          const int r = i / nw, wd = i - r * nw;
          const size_t start = (size_t)min(n_cta + r, N - 1) * ln.stride + coff;
          const size_t a = (start & ~(size_t)3) + 4 * wd;  // the word's first byte
          const int n = (int)max(0ll, min(4ll, (long long)(start + valid) - (long long)a));
          cp_async4(dst + r * Dec::rw() + wd, n > 0 ? ln.base + a : ln.base, n);
        }
      }
    }
    __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(base + C::WBYTES);
    for (int i = tid; i < P * BR * (KC / 8); i += WARPS * 32) {
      const int q = i % (KC / 8), r = (i / (KC / 8)) % BR, p = i / (BR * (KC / 8));
      const int col = c * KC + 8 * q;
      const size_t brow = (size_t)min(b0 + r, B - 1);
      const bool ok = col < K;  // K % 32 == 0: all 8 columns or none
      cp_async16(X + (p * BR + r) * XLD + 8 * q, xp + p * plane + brow * K + (ok ? col : 0), ok);
    }
    if constexpr (Dec::M) {
      float* S = reinterpret_cast<float*>(base + C::WBYTES + C::XBYTES);
      for (int i = tid; i < BR * (SUMS / 4); i += WARPS * 32) {
        const int r = i / (SUMS / 4), q = i % (SUMS / 4);
        const int col = c * SUMS + 4 * q;
        const bool ok = col < sld;
        cp_async16(S + r * SUMS + 4 * q, xsum + (size_t)min(b0 + r, B - 1) * sld + (ok ? col : 0),
                   ok);
      }
    }
    if constexpr (P == 1) {
      float* D = reinterpret_cast<float*>(base + C::WBYTES + C::XBYTES + C::SBYTES);
      for (int i = tid; i < BR * (KC / 128); i += WARPS * 32) {
        const int r = i / (KC / 128), q = i % (KC / 128);
        const int col = c * (KC / 32) + 4 * q;
        const bool ok = col < dld;
        cp_async16(D + r * (KC / 32) + 4 * q, xs + (size_t)min(b0 + r, B - 1) * dld + (ok ? col : 0),
                   ok);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // one group of a staged chunk: decode, B fragments, P mma a k-step, fold
  auto group = [&](const unsigned char* base, int c, int gi) {
    const uint32_t* W = reinterpret_cast<const uint32_t*>(base);
    const __nv_bfloat16* X = reinterpret_cast<const __nv_bfloat16*>(base + C::WBYTES);
    const float* S = reinterpret_cast<const float*>(base + C::WBYTES + C::XBYTES);
    const float* D = reinterpret_cast<const float*>(base + C::WBYTES + C::XBYTES + C::SBYTES);
    uint32_t a[MT][2][4];
    float dv[MT][2][2], mv[MT][2][2];  // [mt][ks][row g, g + 8]
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * MT * 16 + mt * 16 + g + 8 * h;
        uint32_t w[2][2];
        float d2[2], m2[2];
        Dec::group(W + r * Dec::rw(), (size_t)min(n_cta + r, N - 1), c, gi, K, t, w, d2, m2);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          a[mt][ks][h] = w[ks][0];
          a[mt][ks][2 + h] = w[ks][1];
          dv[mt][ks][h] = d2[ks];
          mv[mt][ks][h] = m2[ks];
        }
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bx[2][P][2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              X + (p * BR + nt * 8 + g) * XLD + gi * 32 + ks * 16 + 4 * t);
          bx[ks][p][0] = v.x;
          bx[ks][p][1] = v.y;
        }
      // this lane's two activation rows (columns 2t, 2t + 1): the scale
      // (Q8) and the block sums of the group
      float dx[2] = {1.f, 1.f};
      if constexpr (P == 1) {
#pragma unroll
        for (int j = 0; j < 2; ++j) dx[j] = D[(nt * 8 + 2 * t + j) * (KC / 32) + gi];
      }
      float xb[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [block of the group][column]
      if constexpr (Dec::M) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* sr = S + (nt * 8 + 2 * t + j) * SUMS + 2 * gi;
          if constexpr (Dec::BS == 32) {
            xb[0][j] = sr[0] + sr[1];
          } else {
            xb[0][j] = sr[0];
            xb[1][j] = sr[1];
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        constexpr int FOLDS = Dec::BS == 32 ? 1 : 2;  // blocks a group
#pragma unroll
        for (int f = 0; f < FOLDS; ++f) {
          // one chain a plane (shorter dependences), added lo + mid, + hi
          float cp[P][4] = {};
#pragma unroll
          for (int ks = f; ks < (FOLDS == 1 ? 2 : f + 1); ++ks)
#pragma unroll
            for (int p = 0; p < P; ++p) mma(cp[p], a[mt][ks], bx[ks][p][0], bx[ks][p][1]);
          float cf[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cf[i] = P == 1 ? cp[0][i] : cp[0][i] + (cp[1][i] + cp[2][i]);
          float* ac = acc[mt][nt];
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // (row g, g + 8) x (column 2t, 2t + 1)
            const float dw = dv[mt][f][i >> 1];
            ac[i] = fmaf(P == 1 ? dw * dx[i & 1] : dw, cf[i], ac[i]);
            if constexpr (Dec::M) ac[i] = fmaf(mv[mt][f][i >> 1], xb[f][i & 1], ac[i]);
          }
        }
      }
    }
  };

#pragma unroll
  for (int i = 0; i < C::NSTAGE - 1; ++i) {
    if (i < nch) stage(c0 + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < nch; ++i) {
    cp_async_wait<C::NSTAGE - 2>();  // chunk i has landed (this thread's copies)
    __syncthreads();                 // everyone's; and chunk i - 1's buffer is free
    if (i + C::NSTAGE - 1 < nch) stage(c0 + i + C::NSTAGE - 1, (i + C::NSTAGE - 1) % C::NSTAGE);
    cp_async_commit();
    const int c = c0 + i;
    const unsigned char* base = smem + (i % C::NSTAGE) * C::STAGE;
    if constexpr (Dec::KALIGN < KC) {
      if ((c + 1) * KC > K) {  // the last chunk of a legacy K % 256
        for (int gi = 0; c * KC + gi * 32 < K; ++gi) group(base, c, gi);
        continue;
      }
    }
#pragma unroll
    for (int gi = 0; gi < KC / 32; ++gi) group(base, c, gi);
  }

  // accumulator (row g / g + 8, column 2t / 2t + 1) -> out[s][b][n]
  float* dst = out + (size_t)s * B * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n_cta + warp * MT * 16 + mt * 16 + g + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int b = b0 + nt * 8 + 2 * t + j;
          if (b < B) dst[(size_t)b * N + n] = acc[mt][nt][2 * h + j];
        }
    }
}

// y[i] = part[0][i] + part[1][i] + ..., in split order
__global__ void merge_splits(const float* __restrict__ part, float* __restrict__ y,
                             size_t total, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float v = part[i];
  for (int s = 1; s < splits; ++s) v += part[(size_t)s * total + i];
  y[i] = v;
}

// The caller's scratch, each part a multiple of 16 bytes: the planes (P * B
// * K bf16), the 16-column sums (B * sum_ld(K) f32), for Q8 activations
// their scales (B * scale_ld(K) f32) and, when splits > 1, the partial
// sums (splits * B * N f32): scratch_bytes(...) bytes (matmul_q.py
// _mma_scratch_bytes).
inline size_t planes_bytes(int P, int B, int K) {
  return ((size_t)P * B * K * 2 + 15) & ~(size_t)15;
}
inline size_t sums_bytes(int B, int K) { return (size_t)B * sum_ld(K) * 4; }
inline size_t scales_bytes(int P, int B, int K) {
  return P == 1 ? (size_t)B * scale_ld(K) * 4 : 0;
}

// Q8 activation scales: f16 per 32 columns (Q8_0), f32 per 32 (Q8_1), f32
// per 256 (Q8_K)
enum ScaleKind : int { Q8_F16_32 = 0, Q8_F32_32 = 1, Q8_F32_256 = 2 };

template <class Dec, int NT, int P>
int launch_nt(const float* x, const int8_t* xq, const void* xd, int kind, const Planes& pl,
              float* y, unsigned char* scratch, int B, int N, int K, int splits,
              cudaStream_t stream) {
  using C = Cfg<Dec, NT, P>;
  __nv_bfloat16* xp = reinterpret_cast<__nv_bfloat16*>(scratch);
  float* xsum = reinterpret_cast<float*>(scratch + planes_bytes(P, B, K));
  float* xs = xsum + sums_bytes(B, K) / 4;
  float* part = xs + scales_bytes(P, B, K) / 4;
  const size_t n4 = (size_t)B * K / 4;
  const unsigned blocks = (unsigned)((n4 + 255) / 256);
  if constexpr (P == 3)
    split_x<<<blocks, 256, 0, stream>>>(x, xp, xsum, B, K);
  else if (kind == Q8_F16_32)
    split_q8<__half, 32><<<blocks, 256, 0, stream>>>(xq, static_cast<const __half*>(xd), xp,
                                                     xsum, xs, B, K);
  else if (kind == Q8_F32_32)
    split_q8<float, 32><<<blocks, 256, 0, stream>>>(xq, static_cast<const float*>(xd), xp,
                                                    xsum, xs, B, K);
  else
    split_q8<float, 256><<<blocks, 256, 0, stream>>>(xq, static_cast<const float*>(xd), xp,
                                                     xsum, xs, B, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dq_mma_kernel<Dec, NT, P>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + C::BR - 1) / C::BR, (N + ROWS - 1) / ROWS, splits);
  dq_mma_kernel<Dec, NT, P><<<grid, WARPS * 32, C::SMEM, stream>>>(
      xp, xsum, xs, pl, splits > 1 ? part : y, B, N, K, splits);
  if (splits > 1) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const size_t total = (size_t)B * N;
    merge_splits<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, y, total, splits);
  }
  return (int)cudaGetLastError();
}

template <class Dec, int P>
int launch_p(const float* x, const int8_t* xq, const void* xd, int kind, const Planes& pl,
             float* y, unsigned char* scratch, int B, int N, int K, int splits,
             cudaStream_t stream) {
  if (B <= 8) return launch_nt<Dec, 1, P>(x, xq, xd, kind, pl, y, scratch, B, N, K, splits, stream);
  // 32 rows a CTA with one plane; three planes of 32 rows leave one CTA an
  // SM in shared memory, and tiles of 16 ran 15-20% faster at 128 rows
  if constexpr (P == 1) {
    if (B > 16)
      return launch_nt<Dec, 4, P>(x, xq, xd, kind, pl, y, scratch, B, N, K, splits, stream);
  }
  return launch_nt<Dec, 2, P>(x, xq, xd, kind, pl, y, scratch, B, N, K, splits, stream);
}

// Activations either x f32 [B, K] (16-byte aligned), or Q8: xq int8 [B, K]
// (4-byte aligned; x null) and its block scales xd of ScaleKind `kind`;
// planes as the decoder reads them (4-byte aligned); y f32 [B, N];
// scratch: scratch_bytes bytes, 16-byte aligned.
template <class Dec>
int launch(const float* x, const int8_t* xq, const void* xd, int kind, const Planes& pl,
           float* y, unsigned char* scratch, int B, int N, int K, int splits,
           cudaStream_t stream) {
  const int chunks = (K + KC - 1) / KC;
  if (B <= 0 || N <= 0 || K <= 0 || K % Dec::KALIGN || splits < 1 || splits > chunks ||
      scratch == nullptr || (x == nullptr) == (xq == nullptr) ||
      (xq != nullptr && (xd == nullptr || kind < 0 || kind > 2 || (kind == 2 && K % 256))))
    return (int)cudaErrorInvalidValue;
  if (x != nullptr)
    return launch_p<Dec, 3>(x, xq, xd, kind, pl, y, scratch, B, N, K, splits, stream);
  return launch_p<Dec, 1>(x, xq, xd, kind, pl, y, scratch, B, N, K, splits, stream);
}

}  // namespace dqm
}  // namespace
