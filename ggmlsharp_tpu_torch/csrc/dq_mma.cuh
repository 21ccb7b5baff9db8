// The multi-row instance of the dequant-matmuls on the tensor cores, shared
// by matmul_q4_0.cu (Q4_0), matmul_q8_0.cu (Q8_0), matmul_q.cu (Q4_1 ...
// Q6_K) and the fused SwiGLU MLP (mlp_fused_silu_q4.cu):
//   y[b, n] = sum_k x[b, k] * w[n, k],  x, y f32; w packed, one decoder a format.
// The wrappers (kernels/matmul_q.py, kernels/mlp_fused.py) launch it for
// every b >= MMA_MIN_ROWS; one activation row keeps the sources' b = 1
// instance.
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
//  * Q8_0 weights: bytes_bf16's trick holds bytes below 128 only; with f32
//    x DecQ8 puts 0x43 above each byte's low 7 bits and subtracts 128 or
//    256 by its sign bit (sbytes_bf16), exact for every int8. Against Q8_0
//    activations (q8_i8_kernel) no decoder and no split kernel run:
//    mma.sync.m16n8k32.s8 multiplies the staged weight bytes by the
//    caller's int8 activations, one 32-element block a k-step, into int32
//    sums that are exact (|S| <= 32 * 127 * 127), folded once a block:
//    acc = fma(d_w * d_x, float(S), acc). GPT-2's narrow shapes are
//    latency-bound: there Q8_0 takes one launch on both routes (f32 x: the
//    XF route of Cfg) at ROWS_Q8 = 64 weight rows a CTA, the K splits
//    (matmul_q.py q8_mma_splits) reduced in a thread-block cluster. f32 x
//    at weights whose 128-row tiles fill the card (the LM head) keeps the
//    design above.
//  * The SwiGLU MLP chains the passes: split x, the gate/up product, a
//    merge that adds its splits, pairs gate row n with up row F + n and
//    writes silu(g) * u as the down product's three planes and sums
//    (merge_gate), the down product, its merge.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "q8_dot.cuh"

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

// Signed bytes 0..3 of v, exactly, as the bf16 pairs (v0, v1) -> out[0]
// and (v2, v3) -> out[1]: bytes_bf16's 0x43 above each byte's low 7 bits
// makes bf16(128 + (q & 127)), and the bias is 128 for q >= 0, 256 for
// q < 0 (bf16 0x4300 or 0x4380: the byte's sign bit is the bias's bit 7).
__device__ __forceinline__ void sbytes_bf16(uint32_t v, uint32_t out[2]) {
  const uint32_t p[2] = {__byte_perm(v, 0x43u, 0x4140), __byte_perm(v, 0x43u, 0x4342)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t val = p[i] & 0xFF7FFF7Fu;
    const uint32_t bias = (p[i] & 0x00800080u) ^ 0x43004300u;
    const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&val),
                                     *reinterpret_cast<const __nv_bfloat162*>(&bias));
    out[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
}

// Q8_0 (quant/formats.py): qs int8 [N, K] in element order, d f16 [N, K/32];
// planes in that order.
struct DecQ8 {
  static constexpr int BS = 32, KALIGN = 32;
  static constexpr bool M = false;
  static constexpr int SC = 2 * KC / 32;  // bytes of a chunk's d slice
  static constexpr int NSLICE = 2;        // slices: qs, d
  __host__ __device__ static constexpr int ws(int s) { return s == 0 ? KC / 4 : SC / 4 + 1; }
  __host__ __device__ static constexpr int off(int s) { return s == 0 ? 0 : ws(0); }
  __host__ __device__ static constexpr int rw() { return row_words(ws(0) + ws(1)); }
  __host__ __device__ static constexpr bool bulk(int s) { return s == 0; }
  __device__ static Lin lin(int s, const Planes& p, int K) {
    const uint8_t* base = static_cast<const uint8_t*>(p.p[s]);
    if (s == 0) return {base, K, KC};
    return {base, 2 * (K / 32), SC};
  }
  __device__ static void group(const uint32_t* wr, size_t row, int c, int gi, int K, int t,
                               uint32_t w[2][2], float d[2], float m[2]) {
    const int mis = (int)((row * 2 * (K / 32) + (size_t)c * SC) & 3);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) sbytes_bf16(wr[8 * gi + 4 * ks + t], w[ks]);  // 16ks + 4t..
    d[0] = d[1] = lds_h(wr + off(1), mis + 2 * gi);
    m[0] = m[1] = 0.f;
  }
};

// v, float4 i of an f32 [B, K] array, as its P bf16 planes into xp bf16
// [P][B][K] (P = 3: exact; P = 1: v rounded to bf16, mm_dot "bf16"), and
// the sum of each 16 columns of what the planes hold into xsum f32
// [B][sum_ld(K)]. Every lane of the warp calls it (the shuffles); lanes
// past n4 store nothing.
template <int P = 3>
__device__ __forceinline__ void store_planes(float4 v, size_t i, size_t n4,
                                             __nv_bfloat16* __restrict__ xp,
                                             float* __restrict__ xsum, int B, int K) {
  uint32_t lo[P], hi[P];
  split_pair<P>(v.x, v.y, lo);
  split_pair<P>(v.z, v.w, hi);
  if constexpr (P == 1) v = bf16_round4(v);
  float sm = (v.x + v.y) + (v.z + v.w);  // every lane takes part in the shuffles
  sm += __shfl_xor_sync(0xffffffffu, sm, 1);
  sm += __shfl_xor_sync(0xffffffffu, sm, 2);
  if (i >= n4) return;
#pragma unroll
  for (int p = 0; p < P; ++p)
    reinterpret_cast<uint2*>(xp + (size_t)p * B * K)[i] = make_uint2(lo[p], hi[p]);
  const size_t b = 4 * i / K;
  const int col = (int)(4 * i - b * K);
  if ((i & 3) == 0) xsum[b * sum_ld(K) + col / 16] = sm;
}

// x f32 [B, K] -> xp bf16 [P][B][K] (the three planes of each value, or
// with P = 1 its bf16 rounding) and xsum f32 [B][sum_ld(K)] (the sum of
// each 16 columns). Thread i takes float4 i; four neighbouring lanes hold
// 16 columns of one row (K % 32 == 0).
template <int P>
__global__ void split_x(const float* __restrict__ x, __nv_bfloat16* __restrict__ xp,
                        float* __restrict__ xsum, int B, int K) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n4 = (size_t)B * K / 4;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n4) v = __ldg(reinterpret_cast<const float4*>(x) + i);
  store_planes<P>(v, i, n4, xp, xsum, B, K);
}

// SwiGLU between the two products of the fused MLP: g = sum_s part[s][b][n],
// u = sum_s part[s][b][F + n] (the gate/up product's splits, added in split
// order), a[b, n] = silu(g) * u in f32 (as the b = 1 kernel,
// q4_dot.cuh swiglu), written as the down product's activations, split_x's
// form of a [B, F]: xp bf16 [3][B][F] and xsum f32 [B][sum_ld(F)].
__global__ void merge_gate(const float* __restrict__ part, __nv_bfloat16* __restrict__ xp,
                           float* __restrict__ xsum, int B, int F, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n4 = (size_t)B * F / 4;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n4) {
    const size_t b = 4 * i / F;
    const size_t gcol = b * 2 * F + (4 * i - b * F);  // gate column in a [B][2F] split
    const size_t total = (size_t)B * 2 * F;
    float4 g = __ldg(reinterpret_cast<const float4*>(part + gcol));
    float4 u = __ldg(reinterpret_cast<const float4*>(part + gcol + F));
    for (int s = 1; s < splits; ++s) {
      const float4 gs = __ldg(reinterpret_cast<const float4*>(part + s * total + gcol));
      const float4 us = __ldg(reinterpret_cast<const float4*>(part + s * total + gcol + F));
      g.x += gs.x; g.y += gs.y; g.z += gs.z; g.w += gs.w;
      u.x += us.x; u.y += us.y; u.z += us.z; u.w += us.w;
    }
    auto swiglu = [](float gv, float uv) { return gv / (1.0f + expf(-gv)) * uv; };
    v = make_float4(swiglu(g.x, u.x), swiglu(g.y, u.y), swiglu(g.z, u.z), swiglu(g.w, u.w));
  }
  store_planes(v, i, n4, xp, xsum, B, F);
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

// CL: the K splits of one output tile run as one thread-block cluster
// (grid z = splits, cluster (1, 1, splits): rank = split). Each rank > 0
// leaves its sums in its shared memory (red: na sums of nthr threads), and
// rank 0 adds them to its own in split order, the merge kernel's order,
// with no second launch and no partial sums in device memory. Every thread
// of the cluster calls it (its barriers); `active` threads hold sums.
// Returns whether this thread holds a finished sum (rank 0, active).
template <int A0, int A1>
__device__ __forceinline__ bool cluster_reduce(float (&acc)[A0][A1][4], float* red, int me,
                                               int nthr, bool active) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  cp_async_wait<0>();
  __syncthreads();  // this CTA's products are done: its stages are free
  if (rank > 0 && active) {
#pragma unroll
    for (int a = 0; a < A0; ++a)
#pragma unroll
      for (int b = 0; b < A1; ++b)
#pragma unroll
        for (int i = 0; i < 4; ++i) red[((a * A1 + b) * 4 + i) * nthr + me] = acc[a][b][i];
  }
  cl.sync();  // every rank's sums are in its shared memory
  if (rank == 0 && active) {
    for (unsigned r = 1; r < cl.num_blocks(); ++r) {
      const float* rr = cl.map_shared_rank(red, r);
#pragma unroll
      for (int a = 0; a < A0; ++a)
#pragma unroll
        for (int b = 0; b < A1; ++b)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[a][b][i] += rr[((a * A1 + b) * 4 + i) * nthr + me];
    }
  }
  cl.sync();  // rank 0 has read them: the other ranks may leave
  return rank == 0 && active;
}

// Launch kern on `grid` in clusters of (1, 1, cz) CTAs.
template <typename... P, typename... A>
int launch_cluster(void (*kern)(P...), dim3 grid, int threads, int smem, int cz,
                   cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = cz;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, args...);
}

// A complete sum as it is stored: v (EPI 0), v + bias[n] (1), or
// gelu(v + bias[n]) (2, q8_dot.cuh's tanh form), bias f32 or bf16.
template <int EPI>
__device__ __forceinline__ float epilogue(float v, const void* bias, int n, int bias_bf16) {
  if constexpr (EPI == 0) return v;
  v += q8::load_vec(bias, n, bias_bf16);
  return EPI == 2 ? q8::gelu(v) : v;
}

constexpr int XLD8 = KC + 16;  // bytes of a staged int8 x row: 4-byte reads conflict-free
constexpr int DW8 = KC / 64 + 1;  // words of a row's staged f16 scales (+1: a 2-byte start)

// Chunk c's f16 scales of one row (of d or xd: row stride 2 * (K / 32)
// bytes), its valid bytes, as 4-byte words from the one that holds the first
// into dst; the row's first scale then sits at byte (row * stride) & 3.
__device__ __forceinline__ void stage_scales(uint32_t* dst, const __half* base, size_t row, int c,
                                             int K, int wd) {
  const int stride = 2 * (K / 32);
  const int valid = min(KC / 16, stride - c * (KC / 16));
  const size_t start = row * stride + (size_t)c * (KC / 16);
  const size_t a = (start & ~(size_t)3) + 4 * wd;
  const int n = (int)max(0ll, min(4ll, (long long)(start + valid) - (long long)a));
  const unsigned char* b = reinterpret_cast<const unsigned char*>(base);
  cp_async4(dst, n > 0 ? b + a : b, n);
}

// P bf16 planes of the activations: 3 for f32 x (exact), 1 for Q8
// activations, whose int8 values bf16 holds exactly; then the block's fold
// also multiplies by the activation scale. XF: the route of x at narrow
// weights (Q8_0 at GPT-2's shapes), where one launch a product pays:
//  * the kernel reads x itself (no split kernel): a stage holds the
//    chunk's f32 tile (P = 3) or, P = 1, its Q8_0 int8 values and f16
//    scales (matmul_q8_0.cu's Q8_ACTS = 1 build, a probe's alternative to
//    q8_i8_kernel), which the CTA writes once into its planes (and, P = 1,
//    f32 scales; PBYTES, after the stages) before the products; formats
//    without a min only;
//  * MT_ = 1: ROWS_Q8 = 64 weight rows a CTA (ROWS otherwise);
//  * KW = 4 warp groups share each chunk (group gi goes to warp group
//    gi % KW) and add their sums in group order at the end;
//  * CL: the K splits are reduced in a cluster (cluster_reduce).
//
// R1: f32 x rounded to one bf16 plane (mm_dot "bf16"; P = 1, no activation
// scales). EPI, the XF route only: the stored sums get + bias (1), or
// gelu(sum + bias) (2).
template <class Dec, int NT, int P, bool XF = false, bool R1 = false, int EPI = 0>
struct Cfg {
  static_assert(!XF || !Dec::M, "x read in the kernel: no min");
  static_assert(!R1 || P == 1, "a rounded x is one plane");
  static_assert(EPI == 0 || XF, "an epilogue needs complete sums");
  static constexpr bool SC = P == 1 && !R1;  // Q8 activations: a scale a block
  static constexpr bool XT = XF && (P == 3 || R1);  // a stage holds an f32 x tile
  static constexpr int MT_ = XF ? 1 : MT, KW = XF ? 4 : 1;
  static constexpr bool CL = XF;
  static constexpr int THREADS = WARPS * KW * 32;
  static constexpr int R = WARPS * MT_ * 16;
  static constexpr int BR = 8 * NT;   // activation rows a CTA
  static constexpr int XLDF = KC + 4;  // floats of a staged f32 x row (XF)
  static constexpr int WBYTES = R * Dec::rw() * 4;
  // a stage's x: the planes or, XF, f32 x (P = 3) or the int8 values and f16 scales
  static constexpr int XBYTES = !XF ? P * BR * XLD * 2
                                : XT ? BR * XLDF * 4 : BR * XLD8 + ((BR * DW8 * 4 + 15) & ~15);
  static constexpr int SBYTES = Dec::M ? BR * SUMS * 4 : 0;
  static constexpr int DBYTES = SC ? BR * (KC / 32) * 4 : 0;  // f32 scales of the x rows
  static constexpr int STAGE = WBYTES + XBYTES + SBYTES + (XF ? 0 : DBYTES);  // each a multiple of 16
  static constexpr int PBYTES = XF ? P * BR * XLD * 2 + DBYTES : 0;
  static constexpr int NSTAGE =
      STAGES * STAGE + PBYTES <= SMEM_MAX ? STAGES : (SMEM_MAX - PBYTES) / STAGE;
  static_assert(NSTAGE >= 2, "two stages must fit in shared memory");
  static constexpr int SMEM = NSTAGE * STAGE + PBYTES;
  // the sums warp groups (KW) and cluster ranks (CL) leave in shared memory
  static constexpr int RBYTES = (KW - 1 + CL) * WARPS * 32 * MT_ * NT * 16;
  static_assert(RBYTES <= SMEM, "the sums fit");
};

// xp, xsum (, xs): the split kernel's output, or (XF) xf: x f32 [B, K]
// (P = 3, or R1) or Q8_0 int8 [B, K] with its f16 scales xfd [B, K/32]
// (P = 1); out: y [B][N], or the partial sums [splits][B][N] when splits >
// 1 (XF: always y); bias [N] f32 or bf16 (bias_bf16) for EPI.
template <class Dec, int NT, int P, bool XF, bool R1 = false, int EPI = 0>
__global__ void __launch_bounds__(Cfg<Dec, NT, P, XF, R1, EPI>::THREADS)
dq_mma_kernel(const __nv_bfloat16* __restrict__ xp, const float* __restrict__ xsum,
              const float* __restrict__ xs, const void* __restrict__ xf,
              const __half* __restrict__ xfd, Planes pl, float* __restrict__ out, int B, int N,
              int K, int splits, const void* __restrict__ bias, int bias_bf16) {
  using C = Cfg<Dec, NT, P, XF, R1, EPI>;
  constexpr int BR = C::BR, MT_ = C::MT_, KW = C::KW;
  constexpr bool CL = C::CL;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  // row tile, K group (a constant 0 for one group: the groups' indices
  // stay compile-time constants)
  const int warp = KW == 1 ? tid >> 5 : (tid >> 5) % WARPS;
  const int wk = KW == 1 ? 0 : (tid >> 5) / WARPS;
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * BR;
  const int n_cta = blockIdx.y * C::R;
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
        for (int i = tid; i < C::R * (nw / 4); i += C::THREADS) {
          const int r = i / (nw / 4), q = i - r * (nw / 4);
          const size_t row = (size_t)min(n_cta + r, N - 1);
          const bool ok = 16 * q < valid;
          cp_async16(dst + r * Dec::rw() + 4 * q,
                     ln.base + row * ln.stride + coff + (ok ? 16 * q : 0), ok);
        }
      } else {  // 4-byte words over the slice's bytes
        for (int i = tid; i < C::R * nw; i += C::THREADS) {
          const int r = i / nw, wd = i - r * nw;
          const size_t start = (size_t)min(n_cta + r, N - 1) * ln.stride + coff;
          const size_t a = (start & ~(size_t)3) + 4 * wd;  // the word's first byte
          const int n = (int)max(0ll, min(4ll, (long long)(start + valid) - (long long)a));
          cp_async4(dst + r * Dec::rw() + wd, n > 0 ? ln.base + a : ln.base, n);
        }
      }
    }
    if constexpr (C::XT) {
      float* XS = reinterpret_cast<float*>(base + C::WBYTES);
      const float* xv = static_cast<const float*>(xf);
      for (int i = tid; i < BR * (KC / 4); i += C::THREADS) {
        const int r = i / (KC / 4), q = i % (KC / 4);
        const int col = c * KC + 4 * q;
        const size_t brow = (size_t)min(b0 + r, B - 1);
        const bool ok = col < K;
        cp_async16(XS + r * C::XLDF + 4 * q, xv + brow * K + (ok ? col : 0), ok);
      }
    } else if constexpr (XF) {  // Q8_0 x: the int8 values, then the f16 scales
      unsigned char* X8 = base + C::WBYTES;
      const int8_t* xv = static_cast<const int8_t*>(xf);
      const int valid = min(KC, K - c * KC);  // bytes of a row in this chunk
      for (int i = tid; i < BR * (KC / 16); i += C::THREADS) {
        const int r = i / (KC / 16), q = i % (KC / 16);
        const size_t brow = (size_t)min(b0 + r, B - 1);
        const bool ok = 16 * q < valid;
        cp_async16(X8 + r * XLD8 + 16 * q, xv + brow * K + (size_t)c * KC + (ok ? 16 * q : 0), ok);
      }
      uint32_t* XD = reinterpret_cast<uint32_t*>(X8 + BR * XLD8);
      for (int i = tid; i < BR * DW8; i += C::THREADS) {
        const int r = i / DW8, wd = i % DW8;
        stage_scales(XD + r * DW8 + wd, xfd, (size_t)min(b0 + r, B - 1), c, K, wd);
      }
    } else {
      __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(base + C::WBYTES);
      for (int i = tid; i < P * BR * (KC / 8); i += C::THREADS) {
        const int q = i % (KC / 8), r = (i / (KC / 8)) % BR, p = i / (BR * (KC / 8));
        const int col = c * KC + 8 * q;
        const size_t brow = (size_t)min(b0 + r, B - 1);
        const bool ok = col < K;  // K % 32 == 0: all 8 columns or none
        cp_async16(X + (p * BR + r) * XLD + 8 * q, xp + p * plane + brow * K + (ok ? col : 0), ok);
      }
    }
    if constexpr (Dec::M) {
      float* S = reinterpret_cast<float*>(base + C::WBYTES + C::XBYTES);
      for (int i = tid; i < BR * (SUMS / 4); i += C::THREADS) {
        const int r = i / (SUMS / 4), q = i % (SUMS / 4);
        const int col = c * SUMS + 4 * q;
        const bool ok = col < sld;
        cp_async16(S + r * SUMS + 4 * q, xsum + (size_t)min(b0 + r, B - 1) * sld + (ok ? col : 0),
                   ok);
      }
    }
    if constexpr (C::SC && !XF) {
      float* D = reinterpret_cast<float*>(base + C::WBYTES + C::XBYTES + C::SBYTES);
      for (int i = tid; i < BR * (KC / 128); i += C::THREADS) {
        const int r = i / (KC / 128), q = i % (KC / 128);
        const int col = c * (KC / 32) + 4 * q;
        const bool ok = col < dld;
        cp_async16(D + r * (KC / 32) + 4 * q, xs + (size_t)min(b0 + r, B - 1) * dld + (ok ? col : 0),
                   ok);
      }
    }
  };

  float acc[MT_][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT_; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // one group of a staged chunk: decode, B fragments, P mma a k-step, fold
  auto group = [&](const unsigned char* base, const __nv_bfloat16* X, int c, int gi) {
    const uint32_t* W = reinterpret_cast<const uint32_t*>(base);
    const float* S = reinterpret_cast<const float*>(base + C::WBYTES + C::XBYTES);
    const float* D = reinterpret_cast<const float*>(
        XF ? smem + C::NSTAGE * C::STAGE + P * BR * XLD * 2
           : base + C::WBYTES + C::XBYTES + C::SBYTES);
    uint32_t a[MT_][2][4];
    float dv[MT_][2][2], mv[MT_][2][2];  // [mt][ks][row g, g + 8]
#pragma unroll
    for (int mt = 0; mt < MT_; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * MT_ * 16 + mt * 16 + g + 8 * h;
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
      if constexpr (C::SC) {
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
      for (int mt = 0; mt < MT_; ++mt) {
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
            ac[i] = fmaf(C::SC ? dw * dx[i & 1] : dw, cf[i], ac[i]);
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
    const __nv_bfloat16* X = reinterpret_cast<const __nv_bfloat16*>(base + C::WBYTES);
    if constexpr (XF) {
      // chunk c's x tile into the planes (chunk c - 1's products are
      // done: the barrier above)
      __nv_bfloat16* XP = reinterpret_cast<__nv_bfloat16*>(smem + C::NSTAGE * C::STAGE);
      if constexpr (C::XT) {  // three planes, or (R1) x rounded to one
        const float* XS = reinterpret_cast<const float*>(base + C::WBYTES);
        for (int j = tid; j < BR * (KC / 4); j += C::THREADS) {
          const int r = j / (KC / 4), q = j % (KC / 4);
          const float4 v = *reinterpret_cast<const float4*>(XS + r * C::XLDF + 4 * q);
          uint32_t lo[P], hi[P];
          split_pair<P>(v.x, v.y, lo);
          split_pair<P>(v.z, v.w, hi);
#pragma unroll
          for (int p = 0; p < P; ++p)
            *reinterpret_cast<uint2*>(XP + (p * BR + r) * XLD + 4 * q) = make_uint2(lo[p], hi[p]);
        }
      } else {  // the int8 values (exact in bf16) and the scales as f32
        const unsigned char* X8 = base + C::WBYTES;
        const uint32_t* XD = reinterpret_cast<const uint32_t*>(X8 + BR * XLD8);
        float* D = reinterpret_cast<float*>(XP + BR * XLD);
        for (int j = tid; j < BR * (KC / 4); j += C::THREADS) {
          const int r = j / (KC / 4), q = j % (KC / 4);
          const char4 v = *reinterpret_cast<const char4*>(X8 + r * XLD8 + 4 * q);
          const __nv_bfloat162 lo = __floats2bfloat162_rn((float)v.x, (float)v.y);
          const __nv_bfloat162 hi = __floats2bfloat162_rn((float)v.z, (float)v.w);
          *reinterpret_cast<uint2*>(XP + r * XLD + 4 * q) =
              make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                         *reinterpret_cast<const uint32_t*>(&hi));
        }
        for (int j = tid; j < BR * (KC / 32); j += C::THREADS) {
          const int r = j / (KC / 32), gi = j % (KC / 32);
          const int mis = (int)(((size_t)min(b0 + r, B - 1) * 2 * (K / 32)) & 3);
          D[j] = lds_h(XD + r * DW8, mis + 2 * gi);
        }
      }
      __syncthreads();
      X = XP;
    }
    if constexpr (Dec::KALIGN < KC) {
      if ((c + 1) * KC > K) {  // the last chunk of a legacy K % 256
        for (int gi = wk; c * KC + gi * 32 < K; gi += KW) group(base, X, c, gi);
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < KC / 32 / KW; ++j) group(base, X, c, j * KW + wk);
  }

  constexpr int WT = WARPS * 32;  // threads a warp group
  bool keep = wk == 0;  // this thread holds sums to store
  if constexpr (KW > 1) {  // warp group 0 adds the others' sums, in order
    float* red = reinterpret_cast<float*>(smem);
    const int me = tid % WT;
    cp_async_wait<0>();
    __syncthreads();  // every chunk's products are done: the stages are free
    if (wk > 0) {
#pragma unroll
      for (int mt = 0; mt < MT_; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            red[((mt * NT + nt) * 4 + i) * (KW - 1) * WT + (wk - 1) * WT + me] = acc[mt][nt][i];
    }
    __syncthreads();
    if (keep) {
#pragma unroll
      for (int w = 0; w < KW - 1; ++w)
#pragma unroll
        for (int mt = 0; mt < MT_; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[mt][nt][i] += red[((mt * NT + nt) * 4 + i) * (KW - 1) * WT + w * WT + me];
    }
  }
  if constexpr (CL)  // after the warp groups' sums in shared memory
    keep = cluster_reduce(acc, reinterpret_cast<float*>(smem) + (KW - 1) * WT * MT_ * NT * 4,
                          tid % WT, WT, keep);
  if (!keep) return;

  // accumulator (row g / g + 8, column 2t / 2t + 1) -> out[s][b][n]
  float* dst = out + (CL ? 0 : (size_t)s * B * N);  // CL: rank 0, split 0, stores y
#pragma unroll
  for (int mt = 0; mt < MT_; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n_cta + warp * MT_ * 16 + mt * 16 + g + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int b = b0 + nt * 8 + 2 * t + j;
          if (b < B) dst[(size_t)b * N + n] = epilogue<EPI>(acc[mt][nt][2 * h + j], bias, n, bias_bf16);
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

// The parts of a scratch for P planes of B x K activations (from `base`):
// planes, sums, scales (Q8) and, after them, the partial sums.
struct Scratch {
  __nv_bfloat16* xp;
  float *xsum, *xs, *part;
};
inline Scratch carve(unsigned char* base, int P, int B, int K) {
  Scratch s;
  s.xp = reinterpret_cast<__nv_bfloat16*>(base);
  s.xsum = reinterpret_cast<float*>(base + planes_bytes(P, B, K));
  s.xs = s.xsum + sums_bytes(B, K) / 4;
  s.part = s.xs + scales_bytes(P, B, K) / 4;
  return s;
}

// The first pass: the activations into the planes of s (split_x: three
// planes, or with R1 f32 x rounded to one; or split_q8 for Q8 activations
// of ScaleKind `kind`).
template <int P, bool R1 = false>
int split_acts(const float* x, const int8_t* xq, const void* xd, int kind, const Scratch& s, int B,
               int K, cudaStream_t stream) {
  const size_t n4 = (size_t)B * K / 4;
  const unsigned blocks = (unsigned)((n4 + 255) / 256);
  if constexpr (P == 3 || R1)
    split_x<P><<<blocks, 256, 0, stream>>>(x, s.xp, s.xsum, B, K);
  else if (kind == Q8_F16_32)
    split_q8<__half, 32><<<blocks, 256, 0, stream>>>(xq, static_cast<const __half*>(xd), s.xp,
                                                     s.xsum, s.xs, B, K);
  else if (kind == Q8_F32_32)
    split_q8<float, 32><<<blocks, 256, 0, stream>>>(xq, static_cast<const float*>(xd), s.xp,
                                                    s.xsum, s.xs, B, K);
  else
    split_q8<float, 256><<<blocks, 256, 0, stream>>>(xq, static_cast<const float*>(xd), s.xp,
                                                     s.xsum, s.xs, B, K);
  return (int)cudaGetLastError();
}

// The mma pass over split activations s: out is y [B][N], or the partial
// sums [splits][B][N] when splits > 1.
template <class Dec, int NT, int P, bool XF, bool R1, int EPI>
int mma_pass_nt(const Scratch& s, const void* xf, const __half* xfd, const Planes& pl, float* out,
                int B, int N, int K, int splits, cudaStream_t stream, const void* bias,
                int bias_bf16) {
  using C = Cfg<Dec, NT, P, XF, R1, EPI>;
  auto kern = dq_mma_kernel<Dec, NT, P, XF, R1, EPI>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + C::BR - 1) / C::BR, (N + C::R - 1) / C::R, splits);
  if constexpr (C::CL)
    return launch_cluster(kern, grid, C::THREADS, C::SMEM, splits, stream, s.xp, s.xsum, s.xs,
                          xf, xfd, pl, out, B, N, K, splits, bias, bias_bf16);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(s.xp, s.xsum, s.xs, xf, xfd, pl, out, B, N, K,
                                               splits, bias, bias_bf16);
  return (int)cudaGetLastError();
}

// The mma pass over split activations s (or, XF, over x itself: xf, xfd as
// dq_mma_kernel takes them; the splits reduced in clusters: out is y, with
// the epilogue EPI of bias).
template <class Dec, int P, bool XF = false, bool R1 = false, int EPI = 0>
int mma_pass(const Scratch& s, const Planes& pl, float* out, int B, int N, int K, int splits,
             cudaStream_t stream, const void* xf = nullptr, const __half* xfd = nullptr,
             const void* bias = nullptr, int bias_bf16 = 0) {
#define DQ_PASS(NT) \
  mma_pass_nt<Dec, NT, P, XF, R1, EPI>(s, xf, xfd, pl, out, B, N, K, splits, stream, bias, bias_bf16)
  if (B <= 8) return DQ_PASS(1);
  // 32 rows a CTA with one plane; three planes of 32 rows leave one CTA an
  // SM in shared memory, and tiles of 16 ran 15-20% faster at 128 rows
  if constexpr (P == 1) {
    if (B > 16) return DQ_PASS(4);
  }
  return DQ_PASS(2);
#undef DQ_PASS
}

inline int merge(const float* part, float* y, int B, int N, int splits, cudaStream_t stream) {
  const size_t total = (size_t)B * N;
  merge_splits<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, y, total, splits);
  return (int)cudaGetLastError();
}

template <class Dec, int P, bool R1 = false>
int launch_p(const float* x, const int8_t* xq, const void* xd, int kind, const Planes& pl,
             float* y, unsigned char* scratch, int B, int N, int K, int splits,
             cudaStream_t stream) {
  const Scratch s = carve(scratch, P, B, K);
  int e = split_acts<P, R1>(x, xq, xd, kind, s, B, K, stream);
  if (e == 0)
    e = mma_pass<Dec, P, false, R1>(s, pl, splits > 1 ? s.part : y, B, N, K, splits, stream);
  if (e == 0 && splits > 1) e = merge(s.part, y, B, N, splits, stream);
  return e;
}

// Activations either x f32 [B, K] (16-byte aligned; rx: rounded to one bf16
// plane, mm_dot "bf16", else three exact ones), or Q8: xq int8 [B, K]
// (4-byte aligned; x null) and its block scales xd of ScaleKind `kind`;
// planes as the decoder reads them (4-byte aligned); y f32 [B, N];
// scratch: scratch_bytes bytes, 16-byte aligned.
template <class Dec>
int launch(const float* x, const int8_t* xq, const void* xd, int kind, const Planes& pl,
           float* y, unsigned char* scratch, int B, int N, int K, int splits,
           cudaStream_t stream, int rx = 0) {
  const int chunks = (K + KC - 1) / KC;
  if (B <= 0 || N <= 0 || K <= 0 || K % Dec::KALIGN || splits < 1 || splits > chunks ||
      scratch == nullptr || (x == nullptr) == (xq == nullptr) ||
      (xq != nullptr && (xd == nullptr || kind < 0 || kind > 2 || (kind == 2 && K % 256))))
    return (int)cudaErrorInvalidValue;
  if (x != nullptr && rx)
    return launch_p<Dec, 1, true>(x, xq, xd, kind, pl, y, scratch, B, N, K, splits, stream);
  if (x != nullptr)
    return launch_p<Dec, 3>(x, xq, xd, kind, pl, y, scratch, B, N, K, splits, stream);
  return launch_p<Dec, 1>(x, xq, xd, kind, pl, y, scratch, B, N, K, splits, stream);
}

// The XF route (Cfg): f32 x [B, K] (rx: rounded to one bf16 plane, else
// three exact ones) or, x null, Q8_0 activations (xq int8 [B, K], xd f16
// [B, K/32]), 16-byte aligned, read by the mma kernel itself, ROWS_Q8
// weight rows a CTA, the K splits reduced in clusters: one launch, no
// scratch. Decoders without a min; splits <= 8 (a portable cluster). EPI
// (f32 x only) with bias: the stored sums' epilogue.
template <class Dec, int EPI = 0>
int launch_xf(const float* x, const int8_t* xq, const __half* xd, const Planes& pl, float* y,
              int B, int N, int K, int splits, cudaStream_t stream, int rx = 0,
              const void* bias = nullptr, int bias_bf16 = 0) {
  const int chunks = (K + KC - 1) / KC;
  if (B <= 0 || N <= 0 || K <= 0 || K % Dec::KALIGN || splits < 1 || splits > chunks ||
      splits > 8 || (x == nullptr) == (xq == nullptr) || (xq != nullptr && xd == nullptr) ||
      (EPI != 0 && (x == nullptr || bias == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Scratch s{nullptr, nullptr, nullptr, nullptr};
  if (x != nullptr && rx)
    return mma_pass<Dec, 1, true, true, EPI>(s, pl, y, B, N, K, splits, stream, x, nullptr, bias,
                                             bias_bf16);
  if (x != nullptr)
    return mma_pass<Dec, 3, true, false, EPI>(s, pl, y, B, N, K, splits, stream, x, nullptr,
                                              bias, bias_bf16);
  if constexpr (EPI == 0) return mma_pass<Dec, 1, true>(s, pl, y, B, N, K, splits, stream, xq, xd);
  return (int)cudaErrorInvalidValue;
}

// --- Q8_0 weights x Q8_0 activations on the int8 tensor cores ------------

// c += a (16x32, row) * b (32x8, col): int8 operands, int32 accumulators.
// Lane (g, t): a[0] row g, columns 4t..4t+3 (byte i: column 4t + i), a[1]
// row g + 8, a[2], a[3] the same rows at columns 16 + 4t..; b0 rows 4t..4t+3
// of column g, b1 rows 16 + 4t..; c as the bf16 mma's.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int STAGES_I8 = 4;   // chunks a CTA has in flight (fewer if they do not fit)

constexpr int ROWS_Q8 = 64;  // weight rows a CTA of Q8_0 (matmul_q.py MMA_ROWS_Q8)
static_assert(ROWS_Q8 == WARPS * 16 && Cfg<DecQ8, 1, 3, true>::R == ROWS_Q8,
              "Q8_0's tile: one 16-row tile a warp, on both routes");

// WARPS warps of one 16-row weight tile (ROWS_Q8 weight rows a CTA), NT
// 8-row activation tiles (BR rows)
template <int NT>
struct CfgI8 {
  static constexpr int ROWS = ROWS_Q8, BR = 8 * NT, MT_ = 1;
  static constexpr int RW = row_words(KC / 4 + DW8);  // qs, then d
  static constexpr int WBYTES = ROWS * RW * 4;
  static constexpr int XBYTES = BR * XLD8;
  static constexpr int DBYTES = (BR * DW8 * 4 + 15) & ~15;
  static constexpr int STAGE = WBYTES + XBYTES + DBYTES;  // each a multiple of 16
  static constexpr int NSTAGE = STAGES_I8 * STAGE <= SMEM_MAX ? STAGES_I8 : SMEM_MAX / STAGE;
  static_assert(NSTAGE >= 2, "two stages must fit in shared memory");
  static constexpr int SMEM = NSTAGE * STAGE;
};

// xq int8 [B, K], xd f16 [B, K/32] (Q8_0 activations); qs int8 [N, K], d f16
// [N, K/32] -> y [B][N], the K splits reduced in clusters (cluster_reduce).
template <int NT, int EPI = 0>
__global__ void __launch_bounds__(WARPS * 32)
q8_i8_kernel(const int8_t* __restrict__ xq, const __half* __restrict__ xd,
             const int8_t* __restrict__ qs, const __half* __restrict__ d, float* __restrict__ out,
             int B, int N, int K, int splits, const void* __restrict__ bias, int bias_bf16) {
  using C = CfgI8<NT>;
  static_assert(C::ROWS * C::BR * 4 <= C::SMEM, "a rank's sums fit");
  constexpr int ROWS_ = C::ROWS, BR = C::BR, MT_ = C::MT_, THREADS = WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bb = blockIdx.x * BR;
  const int n_cta = blockIdx.y * ROWS_;
  const size_t dstride = 2 * (size_t)(K / 32);

  const int chunks = (K + KC - 1) / KC;
  const int s = blockIdx.z;
  const int c0 = (int)((long long)s * chunks / splits);
  const int nch = (int)((long long)(s + 1) * chunks / splits) - c0;

  auto stage = [&](int c, int buf) {
    unsigned char* base = smem + buf * C::STAGE;
    uint32_t* W = reinterpret_cast<uint32_t*>(base);
    const int valid = min(KC, K - c * KC);  // bytes of a row in this chunk
    for (int i = tid; i < ROWS_ * (KC / 16); i += THREADS) {
      const int r = i / (KC / 16), q = i % (KC / 16);
      const size_t row = (size_t)min(n_cta + r, N - 1);
      const bool ok = 16 * q < valid;
      cp_async16(W + r * C::RW + 4 * q, qs + row * K + (size_t)c * KC + (ok ? 16 * q : 0), ok);
    }
    for (int i = tid; i < ROWS_ * DW8; i += THREADS) {
      const int r = i / DW8, wd = i % DW8;
      stage_scales(W + r * C::RW + KC / 4 + wd, d, (size_t)min(n_cta + r, N - 1), c, K, wd);
    }
    unsigned char* X = base + C::WBYTES;
    for (int i = tid; i < BR * (KC / 16); i += THREADS) {
      const int r = i / (KC / 16), q = i % (KC / 16);
      const size_t brow = (size_t)min(bb + r, B - 1);
      const bool ok = 16 * q < valid;
      cp_async16(X + r * XLD8 + 16 * q, xq + brow * K + (size_t)c * KC + (ok ? 16 * q : 0), ok);
    }
    uint32_t* XD = reinterpret_cast<uint32_t*>(base + C::WBYTES + C::XBYTES);
    for (int i = tid; i < BR * DW8; i += THREADS) {
      const int r = i / DW8, wd = i % DW8;
      stage_scales(XD + r * DW8 + wd, xd, (size_t)min(bb + r, B - 1), c, K, wd);
    }
  };

  // where each of this lane's rows keeps its first staged scale (the same
  // byte in every chunk: a chunk's scales are 16 bytes)
  int misw[MT_][2], misx[NT][2];
#pragma unroll
  for (int mt = 0; mt < MT_; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      misw[mt][h] = (int)(((size_t)min(n_cta + warp * MT_ * 16 + mt * 16 + g + 8 * h, N - 1) *
                           dstride) & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      misx[nt][j] = (int)(((size_t)min(bb + nt * 8 + 2 * t + j, B - 1) * dstride) & 3);

  float acc[MT_][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT_; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // block gi (32 columns) of a staged chunk: one int8 mma a tile pair, and
  // its fold
  auto block = [&](const unsigned char* base, int gi) {
    const uint32_t* W = reinterpret_cast<const uint32_t*>(base);
    const unsigned char* X = base + C::WBYTES;
    const uint32_t* XD = reinterpret_cast<const uint32_t*>(base + C::WBYTES + C::XBYTES);
    uint32_t a[MT_][4];
    float dw[MT_][2];
#pragma unroll
    for (int mt = 0; mt < MT_; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t* wr = W + (warp * MT_ * 16 + mt * 16 + g + 8 * h) * C::RW;
        a[mt][h] = wr[8 * gi + t];
        a[mt][2 + h] = wr[8 * gi + 4 + t];
        dw[mt][h] = lds_h(wr + KC / 4, misw[mt][h] + 2 * gi);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t* xr = reinterpret_cast<const uint32_t*>(X + (nt * 8 + g) * XLD8);
      const uint32_t b0 = xr[8 * gi + t], b1 = xr[8 * gi + 4 + t];
      float dx[2];  // this lane's activation rows (columns 2t, 2t + 1)
#pragma unroll
      for (int j = 0; j < 2; ++j) dx[j] = lds_h(XD + (nt * 8 + 2 * t + j) * DW8, misx[nt][j] + 2 * gi);
#pragma unroll
      for (int mt = 0; mt < MT_; ++mt) {
        int c4[4] = {0, 0, 0, 0};
        mma_s8(c4, a[mt], b0, b1);
        float* ac = acc[mt][nt];
#pragma unroll
        for (int i = 0; i < 4; ++i)  // (row g, g + 8) x (column 2t, 2t + 1)
          ac[i] = fmaf(dw[mt][i >> 1] * dx[i & 1], (float)c4[i], ac[i]);
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
    if ((c + 1) * KC > K) {  // a short last chunk
      for (int gi = 0; c * KC + gi * 32 < K; ++gi) block(base, gi);
      continue;
    }
#pragma unroll
    for (int gi = 0; gi < KC / 32; ++gi) block(base, gi);
  }

  if (!cluster_reduce(acc, reinterpret_cast<float*>(smem), tid, THREADS, true)) return;
  // rank 0 (split 0) stores y
#pragma unroll
  for (int mt = 0; mt < MT_; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n_cta + warp * MT_ * 16 + mt * 16 + g + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int b = bb + nt * 8 + 2 * t + j;
          if (b < B) out[(size_t)b * N + n] = epilogue<EPI>(acc[mt][nt][2 * h + j], bias, n, bias_bf16);
        }
    }
}

template <int NT, int EPI>
int launch_i8_nt(const int8_t* xq, const __half* xd, const int8_t* qs, const __half* d, float* y,
                 int B, int N, int K, int splits, cudaStream_t stream, const void* bias,
                 int bias_bf16) {
  using C = CfgI8<NT>;
  auto kern = q8_i8_kernel<NT, EPI>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + C::BR - 1) / C::BR, (N + C::ROWS - 1) / C::ROWS, splits);
  return launch_cluster(kern, grid, WARPS * 32, C::SMEM, splits, stream, xq, xd, qs, d, y, B, N,
                        K, splits, bias, bias_bf16);
}

// Q8_0 weights (qs, d) against Q8_0 activations (xq 16-byte aligned, xd)
// -> y f32 [B, N]; ROWS_Q8 weight rows a CTA, K split `splits` ways (at
// most 8: a portable cluster), reduced in clusters: one launch, no scratch.
// EPI with bias: the stored sums' epilogue.
template <int EPI = 0>
int launch_i8(const int8_t* xq, const __half* xd, const int8_t* qs, const __half* d, float* y,
              int B, int N, int K, int splits, cudaStream_t stream, const void* bias = nullptr,
              int bias_bf16 = 0) {
  const int chunks = (K + KC - 1) / KC;
  if (B <= 0 || N <= 0 || K <= 0 || K % 32 || splits < 1 || splits > chunks || splits > 8 ||
      xq == nullptr || xd == nullptr || (EPI != 0 && bias == nullptr))
    return (int)cudaErrorInvalidValue;
#define DQ_I8(NT) launch_i8_nt<NT, EPI>(xq, xd, qs, d, y, B, N, K, splits, stream, bias, bias_bf16)
  if (B <= 8) return DQ_I8(1);
  if (B <= 16) return DQ_I8(2);
  return DQ_I8(4);
#undef DQ_I8
}

}  // namespace dqm
}  // namespace
