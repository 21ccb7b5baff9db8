// The b = 1 instance of the dequant-matmuls, shared by matmul_q4_0.cu (Q4_0)
// and matmul_q.cu (Q4_1, Q4_2, Q4_3, Q5_0, Q5_1, Q4_K, Q6_K): one streaming
// matrix-vector product with one decoder a format,
//   y[n] = sum_k x[k] * w[n, k],  x, y f32,
// w the weight as dequantize(..., fused_scales=True) gives it (the k-quants'
// kd = f16(d * sc), km = f16(dmin * m)). Two or more activation rows take
// the multi-row instance on the tensor cores (dq_mma.cuh).
//
// What bounds it: the HBM bytes of the packed weights, 4.5 to 6.5 bits a
// weight. What held the first design (a block over four lanes, 4-byte
// loads, x re-read from global memory every step, every lane decoding the
// k-quants' 12 scale bytes, one CTA a handful of rows) at 0.24-0.43 of that
// bound was the instructions and round trips per byte, not the bytes. An
// exact f32 product still costs three instructions a weight (a byte
// permute into the mantissa of 2^23, the subtraction of 2^23 + offset, the
// FMA), so the design spends as little as it can on anything else.
//
// Design (matmul_int_dot.cu's, for f32 activations):
//  * Units: 32 weights of a row whose packed quants are 16 contiguous bytes
//    (a Q4/Q5 block, two Q4_2/Q4_3 blocks, half a Q4_K group, a quarter of a
//    Q6_K half). Lane l of a warp step takes unit c0 + l of each row: one
//    16-byte load a row (Q6_K: two, ql and qh) and the unit's scale, min and
//    fifth-bit words, each a load coalesced across the warp.
//  * A unit's 32 weights pair with 8 pieces of 4 consecutive activations
//    (piece (w, h): word w's low or high nibbles; D::xoff). A CTA copies x
//    into shared memory once, piece by piece in the order a lane reads
//    them, 36 floats a unit: the 8 pieces and, in the last 16 bytes, the
//    activation sums the min terms fold through (D::slot). 144 bytes a
//    unit put the eight lanes that share a 16-byte shared-memory wavefront
//    on eight different bank groups (a 128-byte stride would put them all
//    on one: an 8-way conflict), with no address arithmetic in the loop.
//  * A K whose copy of x passes CHUNK units (K above 51,456: 144 bytes a
//    unit, 227 KB a CTA) runs as near-equal chunks of whole 256-weight
//    groups, one launch a chunk, each adding its rows' sums to y in order.
//  * A nibble becomes f32 by a byte permute into the mantissa of 2^23 and
//    one subtraction of 2^23 + offset (exact); then one FMA. The pure 4-bit
//    formats leave a high nibble where it is (16 q; D::HI16) and meet x / 16,
//    staged so (a power of two: exact), which saves the shift. A unit's sums
//    keep one chain a nibble half, folded once a unit with its scales:
//    acc += d * s (+ m * sum x). The k-quants' scales are decoded once a
//    (row, sub-block): a Q4_K lane decodes its own sub-block's (kd, km) as
//    one f16 pair (__hmul2: f16(d * sc) exactly) and swaps it with its
//    neighbour, whose sub-block the unit's other nibble half belongs to.
//  * A persistent grid (as many CTAs as the card holds at once, at most
//    WARPS_SM warps an SM: each CTA copies x once) walks groups of RW rows
//    in a grid stride. A step's loads are issued before the previous
//    step's products, and a group's first loads before the previous
//    group's reduction; one warp reduction a row at the end. The next
//    step's registers are either copied into place after the step (the
//    legacy decoders) or swapped between two buffers by phase (D::SWAP: the
//    k-quants), whichever measured faster for the decoder on an H100
//    (PERF.md §6 lists what else was tried).
//  * Row offsets are 32-bit (the entries refuse planes past 2^31 bytes).
//  * A row's sum depends on neither WARPS, RW nor the grid: lane l always
//    takes units l, l + 32, ... of a chunk in order, the reduction tree is
//    fixed and the chunks depend on K alone, so every geometry gives the
//    same bits.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mma_bf16.cuh"

namespace {
namespace dqv {

constexpr int STEP = 32;          // units a warp step: one a lane
constexpr int XU = 36;            // floats a unit takes in shared memory
constexpr int SMEM_MAX = 232448;  // shared memory a CTA may take
constexpr int CHUNK = SMEM_MAX / (XU * 4) / 8 * 8;  // most units a launch
constexpr int WARPS_SM = 32;      // warps an SM the grid fills at most

struct Planes {
  const void* p[4];
};

// The four bytes of m (each < 256) minus off, as floats: the byte permute
// into the mantissa of 2^23, then one subtraction (exact).
__device__ __forceinline__ void bytes_f32(uint32_t m, float off, float out[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    out[t] = __int_as_float(__byte_perm(m, 0x4B000000u, 0x7440 + t)) - (8388608.0f + off);
}

__device__ __forceinline__ float dot4(const float4& x, const float w[4], float s) {
  s = fmaf(x.x, w[0], s);
  s = fmaf(x.y, w[1], s);
  s = fmaf(x.z, w[2], s);
  return fmaf(x.w, w[3], s);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

__device__ __forceinline__ float lo_f(__half2 h) { return __low2float(h); }
__device__ __forceinline__ float hi_f(__half2 h) { return __high2float(h); }

__device__ __forceinline__ __half2 as_h2(uint32_t v) { return *reinterpret_cast<__half2*>(&v); }

// (a, b), both integers in [0, 1024), as an exact f16 pair: 1024 + v in
// each half, then 1024 subtracted
__device__ __forceinline__ __half2 int_pair(uint32_t a, uint32_t b) {
  return __hsub2(as_h2(0x64006400u | a | (b << 16)), as_h2(0x64006400u));
}

// Bits 0..3 of h -> bit 4 of bytes 0..3: h * 0x00204081 puts bit i at bit
// 8i (the four copies do not overlap, so nothing carries).
__device__ __forceinline__ uint32_t spread4(uint32_t h) {
  return ((h * 0x00204081u) & 0x01010101u) << 4;
}

// (a & mask) | magic in one instruction
__device__ __forceinline__ uint32_t lop3_and_or(uint32_t a, uint32_t mask, uint32_t magic) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(r) : "r"(a), "r"(mask), "r"(magic));
  return r;
}

// Unpack steps of the legacy decoder (matmul_q4_0.cu's Q4_UNPACK):
// UNPACK_PRMT the byte permute above; UNPACK_I2F the masked nibble through
// an integer-to-float conversion (the same values, so the same bits);
// UNPACK_HALF2 16-bit operands: each nibble pair one __half2 of q - 8 (a
// lop3 against the exponent of 1024 and a subtraction of 1032), x rounded to
// f16, a word's 8 products summed in packed f16 (4 a half) and widened once.
constexpr int UNPACK_PRMT = 0, UNPACK_I2F = 1, UNPACK_HALF2 = 2;

// ---- Q4_0, Q4_1, Q4_2, Q4_3, Q5_0, Q5_1: BS-element blocks ----
// A unit is one 32-element block (two for BS 16): byte j of a BS block
// holds element j (low nibble) and j + BS/2 (high). Word w of the unit's 16
// bytes: BS 32, elements 4w.. (low) and 16 + 4w.. (high); BS 16, block w/2,
// elements 4(w % 2).. and 8 + 4(w % 2)... Planes: qs, [qh,] d, [m].
template <int BS, int OFF, bool HAS_M, bool Q5, int UNPACK = UNPACK_PRMT>
struct DecLeg {
  static constexpr int KALIGN = 32;
  static constexpr bool M = HAS_M;
  static constexpr int NP = BS == 16 ? 4 : 2;  // partial sums: (block of the unit, half)
  // high nibbles left in place (16 q), their x pieces staged / 16
  static constexpr bool HI16 = !Q5 && UNPACK == UNPACK_PRMT;
  static constexpr bool SWAP = false;  // the loop's buffers: see vec_kernel
  static_assert(UNPACK == UNPACK_PRMT || (BS == 32 && !HAS_M && !Q5),
                "the probe's unpack steps exist for Q4_0 only");
  struct W {
    uint4 q;
    uint32_t h;     // Q5: the block's fifth bits
    uint32_t d, m;  // f16 bits (BS 16: the two blocks' pair)
  };
  __device__ static int xoff(int u, int w, int h) {
    return BS == 16 ? 32 * u + 16 * (w >> 1) + 8 * h + 4 * (w & 1) : 32 * u + 4 * w + 16 * h;
  }
  __device__ static int slot(int w, int h) { return BS == 16 ? w >> 1 : 0; }
  __device__ static void load(W& k, const Planes& p, int row, int u, int K) {
    const int nb = K / BS;
    const void* dp = p.p[Q5 ? 2 : 1];
    const void* mp = p.p[Q5 ? 3 : 2];
    k.q = __ldg(reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(p.p[0]) +
                                               (uint32_t)(row * (K / 2) + 16 * u)));
    if constexpr (Q5)
      k.h = (uint32_t)__ldg(static_cast<const int32_t*>(p.p[1]) + (uint32_t)(row * nb + u));
    if constexpr (BS == 16) {  // the unit's two blocks: one 32-bit word
      k.d = __ldg(static_cast<const uint32_t*>(dp) + (uint32_t)(row * (nb / 2) + u));
      if constexpr (HAS_M)
        k.m = __ldg(static_cast<const uint32_t*>(mp) + (uint32_t)(row * (nb / 2) + u));
    } else {
      k.d = __ldg(static_cast<const unsigned short*>(dp) + (uint32_t)(row * nb + u));
      if constexpr (HAS_M)
        k.m = __ldg(static_cast<const unsigned short*>(mp) + (uint32_t)(row * nb + u));
    }
  }
  __device__ static void prep(W&, int) {}
  __device__ static void dot2(const W& k, int w, const float4& xa, const float4& xb, float s[NP]) {
    const uint32_t u = word(k.q, w);
    if constexpr (UNPACK == UNPACK_HALF2) {
      const uint32_t magic = 0x64006400u;  // 1024 in both halves
      const __half2 bias = as_h2(0x64086408u);  // 1032
      const uint32_t b01 = __byte_perm(u, 0u, 0x4140), b23 = __byte_perm(u, 0u, 0x4342);
      const __half2 w0 = __hsub2(as_h2(lop3_and_or(b01, 0x000F000Fu, magic)), bias);
      const __half2 w1 = __hsub2(as_h2(lop3_and_or(b23, 0x000F000Fu, magic)), bias);
      const __half2 w2 = __hsub2(as_h2(lop3_and_or(b01 >> 4, 0x000F000Fu, magic)), bias);
      const __half2 w3 = __hsub2(as_h2(lop3_and_or(b23 >> 4, 0x000F000Fu, magic)), bias);
      __half2 h = __hmul2(__floats2half2_rn(xa.x, xa.y), w0);
      h = __hfma2(__floats2half2_rn(xa.z, xa.w), w1, h);
      h = __hfma2(__floats2half2_rn(xb.x, xb.y), w2, h);
      h = __hfma2(__floats2half2_rn(xb.z, xb.w), w3, h);
      s[0] += __low2float(h) + __high2float(h);
    } else {
      uint32_t lo = u & 0x0F0F0F0Fu, hi = HI16 ? u & 0xF0F0F0F0u : (u >> 4) & 0x0F0F0F0Fu;
      if constexpr (Q5) {  // BS 32: element 4w + t's fifth bit is bit 4w + t
        lo |= spread4((k.h >> (4 * w)) & 0xFu);
        hi |= spread4((k.h >> (4 * w + 16)) & 0xFu);
      }
      float a[4], b[4];
      if constexpr (UNPACK == UNPACK_I2F) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          a[t] = (float)((lo >> (8 * t)) & 0xFFu) - (float)OFF;
          b[t] = (float)((hi >> (8 * t)) & 0xFFu) - (float)OFF;
        }
      } else {
        bytes_f32(lo, (float)OFF, a);
        bytes_f32(hi, (float)(HI16 ? 16 * OFF : OFF), b);
      }
      const int p = BS == 16 ? 2 * (w >> 1) : 0;
      s[p] = dot4(xa, a, s[p]);
      s[p + 1] = dot4(xb, b, s[p + 1]);
    }
  }
  __device__ static float fold(const W& k, const float s[NP], float2 S, float acc) {
    if constexpr (BS == 16) {
      const __half2 d = as_h2(k.d);
      acc = fmaf(lo_f(d), s[0] + s[1], acc);
      acc = fmaf(hi_f(d), s[2] + s[3], acc);
      if constexpr (HAS_M) {
        const __half2 m = as_h2(k.m);
        acc = fmaf(lo_f(m), S.x, acc);
        acc = fmaf(hi_f(m), S.y, acc);
      }
    } else {
      acc = fmaf(__half2float(__ushort_as_half((unsigned short)k.d)), s[0] + s[1], acc);
      if constexpr (HAS_M)
        acc = fmaf(__half2float(__ushort_as_half((unsigned short)k.m)), S.x, acc);
    }
    return acc;
  }
};

// ---- Q4_K: 256-element superblocks of eight 32-element sub-blocks ----
// qs byte l of 64-element group g holds elements 64g + l (low nibble,
// sub-block 2g) and 64g + 32 + l (high, 2g + 1). Unit v = u % 8 of a
// superblock is bytes 16v..16v+15: group v / 2, bytes 16(v % 2)..; word w
// holds elements 64g + 16(v % 2) + 4w.. (low) and 32 more (high). Lane v
// decodes sub-block v's (kd, km) from ggml's 6-bit packing
// (get_scale_min_k4) and swaps it with lane v ^ 1 (units 2g and 2g + 1 need
// sub-blocks 2g and 2g + 1 both). Planes: qs, scales, d, dmin.
struct DecQ4K {
  static constexpr int KALIGN = 256;
  static constexpr bool M = true;
  static constexpr int NP = 2;
  static constexpr bool HI16 = true, SWAP = true;
  struct W {
    uint4 q;
    uint32_t s0, s1, s2;  // the superblock's 12 scale bytes
    uint32_t dd;          // f16 d | dmin << 16
    __half2 lo, hi;       // (kd, km) of the unit's low and high nibbles
  };
  __device__ static int xoff(int u, int w, int h) { return 32 * u - 16 * (u & 1) + 4 * w + 32 * h; }
  __device__ static int slot(int w, int h) { return h; }
  __device__ static void load(W& k, const Planes& p, int row, int u, int K) {
    const int nsb = K >> 8, sb = u >> 3;
    k.q = __ldg(reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(p.p[0]) +
                                               (uint32_t)(row * (K / 2) + 16 * u)));
    const uint32_t* sc = reinterpret_cast<const uint32_t*>(
        static_cast<const uint8_t*>(p.p[1]) + (uint32_t)((row * nsb + sb) * 12));
    k.s0 = __ldg(sc);
    k.s1 = __ldg(sc + 1);
    k.s2 = __ldg(sc + 2);
    const uint32_t i = (uint32_t)(row * nsb + sb);
    k.dd = (uint32_t)__ldg(static_cast<const unsigned short*>(p.p[2]) + i) |
           ((uint32_t)__ldg(static_cast<const unsigned short*>(p.p[3]) + i) << 16);
  }
  __device__ static void prep(W& k, int lane) {
    // ggml's get_scale_min_k4(j) with shifts and masks fixed a lane: j < 4
    // takes 6 bits of bytes j and j + 4; j >= 4 takes 4 bits of byte j + 4
    // and the top 2 of bytes j - 4 and j
    const int j = lane & 7;  // this lane's unit (= sub-block) in its superblock
    const bool low = j < 4;
    const int sh = 8 * (j & 3);
    const uint32_t fm = low ? 63u : 15u, tm = low ? 0u : 0x30u;
    const uint32_t a = low ? k.s0 : k.s2, b = low ? k.s1 : k.s2 >> 4;
    const uint32_t sc = ((a >> sh) & fm) | ((k.s0 >> (sh + 2)) & tm);
    const uint32_t mn = ((b >> sh) & fm) | ((k.s1 >> (sh + 2)) & tm);
    const __half2 mine = __hmul2(as_h2(k.dd), int_pair(sc, mn));  // (kd, km), rounded once
    const __half2 other = as_h2(__shfl_xor_sync(0xffffffffu, *reinterpret_cast<const uint32_t*>(&mine), 1));
    k.lo = (j & 1) ? other : mine;
    k.hi = (j & 1) ? mine : other;
  }
  __device__ static void dot2(const W& k, int w, const float4& xa, const float4& xb, float s[NP]) {
    const uint32_t u = word(k.q, w);
    float a[4], b[4];
    bytes_f32(u & 0x0F0F0F0Fu, 0.f, a);
    bytes_f32(u & 0xF0F0F0F0u, 0.f, b);
    s[0] = dot4(xa, a, s[0]);
    s[1] = dot4(xb, b, s[1]);
  }
  __device__ static float fold(const W& k, const float s[NP], float2 S, float acc) {
    acc = fmaf(lo_f(k.lo), s[0], acc);
    acc = fmaf(lo_f(k.hi), s[1], acc);
    acc = fmaf(-hi_f(k.lo), S.x, acc);
    return fmaf(-hi_f(k.hi), S.y, acc);
  }
};

// ---- Q6_K: 256-element superblocks, ggml's block_q6_K ----
// ql byte 64h + 32p + l (h half, p part, l < 32) holds element 128h + 32p
// + l (low nibble) and + 64 (high); qh byte 32h + l their two high bits at
// bits 2p and 2p + 4; sc[8h + l/16 + 2p] and [+ 4] their i8 scales. Unit v =
// u % 8 is ql bytes 16v..: h = v / 4, p = (v / 2) % 2, l = 16(v % 2) + ...;
// its qh bytes 32h + 16(v % 2).. are one 16-byte load. Planes: ql, qh, sc, d.
struct DecQ6K {
  static constexpr int KALIGN = 256;
  static constexpr bool M = false;
  static constexpr int NP = 2;
  static constexpr bool HI16 = false, SWAP = true;
  struct W {
    uint4 ql, qh;
    uint32_t sc;  // the two i8 scales, bytes 0 (low nibbles) and 2 (high)
    uint32_t d;   // f16 bits
    __half2 kd;   // (kd of the low nibbles, of the high)
  };
  __device__ static int xoff(int u, int w, int h) {
    const int v = u & 7;
    return 256 * (u >> 3) + 128 * (v >> 2) + 32 * ((v >> 1) & 1) + 16 * (v & 1) + 4 * w + 64 * h;
  }
  __device__ static int slot(int w, int h) { return h; }
  __device__ static void load(W& k, const Planes& p, int row, int u, int K) {
    const int v = u & 7, sb = u >> 3;
    k.ql = __ldg(reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(p.p[0]) +
                                                (uint32_t)(row * (K / 2) + 16 * u)));
    k.qh = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const uint8_t*>(p.p[1]) +
        (uint32_t)(row * (K / 4) + 64 * sb + 32 * (v >> 2) + 16 * (v & 1))));
    const uint8_t* sc = static_cast<const uint8_t*>(p.p[2]) +
                        (uint32_t)(row * (K / 16) + 16 * sb + 8 * (v >> 2) + 2 * ((v >> 1) & 1) +
                                   (v & 1));
    k.sc = (uint32_t)__ldg(sc) | ((uint32_t)__ldg(sc + 4) << 16);
    k.d = __ldg(static_cast<const unsigned short*>(p.p[3]) + (uint32_t)(row * (K >> 8) + sb));
  }
  __device__ static void prep(W& k, int) {
    // i8 s -> 1024 + (s + 128) in f16, minus 1152: s exactly
    const __half2 sc = __hsub2(as_h2((k.sc ^ 0x00800080u) | 0x64006400u), as_h2(0x64806480u));
    k.kd = __hmul2(as_h2(k.d * 0x10001u), sc);  // f16(d * sc), rounded once
  }
  __device__ static void dot2(const W& k, int w, const float4& xa, const float4& xb, float s[NP]) {
    const int pt = (threadIdx.x >> 1) & 1;  // the unit's part: (u / 2) % 2 = (lane / 2) % 2
    const uint32_t u = word(k.ql, w), v = word(k.qh, w) >> (2 * pt);
    float a[4], b[4];
    bytes_f32((u & 0x0F0F0F0Fu) | ((v & 0x03030303u) << 4), 32.f, a);
    bytes_f32(((u >> 4) & 0x0F0F0F0Fu) | (((v >> 4) & 0x03030303u) << 4), 32.f, b);
    s[0] = dot4(xa, a, s[0]);
    s[1] = dot4(xb, b, s[1]);
  }
  __device__ static float fold(const W& k, const float s[NP], float2, float acc) {
    acc = fmaf(lo_f(k.kd), s[0], acc);
    return fmaf(hi_f(k.kd), s[1], acc);
  }
};

// x into shared memory in the order the lanes read it (see the header), a
// thread a unit: its 8 pieces loaded at once, rounded to bf16 where RX
// (mm_dot "bf16"), their sums by D::slot, the high pieces / 16 where
// D::HI16. (cp.async pieces, the rounding and sums in a second pass, made
// the k-quants 6-10% slower on an H100.)
template <class D, bool RX>
__device__ __forceinline__ void stage_x(const float* __restrict__ x, float* xs, int units) {
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    float4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = __ldg(reinterpret_cast<const float4*>(x + D::xoff(u, j & 3, j >> 2)));
      if constexpr (RX) v[j] = bf16_round4(v[j]);
    }
    float sm[2] = {0.f, 0.f};
    float* dst = xs + XU * u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (D::M) sm[D::slot(j & 3, j >> 2)] += (v[j].x + v[j].y) + (v[j].z + v[j].w);
      if (D::HI16 && j >= 4)  // exact: a power of two
        v[j] = make_float4(v[j].x * 0.0625f, v[j].y * 0.0625f, v[j].z * 0.0625f, v[j].w * 0.0625f);
      *reinterpret_cast<float4*>(dst + 4 * j) = v[j];
    }
    if constexpr (D::M) *reinterpret_cast<float2*>(dst + 32) = make_float2(sm[0], sm[1]);
  }
  __syncthreads();
}

// The streaming walk over row groups, shared by vec_kernel and the fused
// SwiGLU MLP (mlp_fused_silu_q4.cu): this warp takes groups g, g + gstride,
// ... below `groups`, RW weight rows each (row r of group lg: row(lg, r),
// a row of the planes), units 0 .. units - 1 of each (unit u0 + u of the
// row). The warp's steps run in order, (group, first unit), the loads one
// step ahead of the products; the first step's loads are issued before
// stage() (which fills xs, x in the lanes' order from unit u0 on). Unit
// lc + lane: a lane past the last unit loads nothing and adds 0.
// ready(c0) runs before a step reads xs's units c0 .. c0 + 31; out(lg, v)
// gets the group's RW sums once the warp has reduced them (every lane holds
// them).
template <class D, int RW, class Row, class Stage, class Ready, class Out>
__device__ __forceinline__ void walk(const Planes& pl, const float* xs, int K, int u0, int units,
                                     int groups, int g, int gstride, Row row, Stage stage,
                                     Ready ready, Out out) {
  using W = typename D::W;
  const int lane = threadIdx.x & 31;
  int lg = g, lc = 0;
  auto load = [&](W (&k)[RW]) {
    if (lg < groups && lc + lane < units) {
#pragma unroll
      for (int r = 0; r < RW; ++r) D::load(k[r], pl, row(lg, r), u0 + lc + lane, K);
    }
    lc += STEP;
    if (lc >= units) {
      lc = 0;
      lg += gstride;
    }
  };
  W b0[RW], b1[RW];
  load(b0);  // weight bytes in flight before the copy
  stage();

  // One step: the next step's loads into `fill`, then cur's products
  auto step = [&](W (&cur)[RW], W (&fill)[RW], int c0, float (&acc)[RW]) {
    load(fill);
#pragma unroll
    for (int r = 0; r < RW; ++r) D::prep(cur[r], lane);
    ready(c0);
    const int u = c0 + lane;
    if (u < units) {
      const float* xu = xs + XU * u;
      float s[RW][D::NP];
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int i = 0; i < D::NP; ++i) s[r][i] = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float4 xa = *reinterpret_cast<const float4*>(xu + 4 * w);
        const float4 xb = *reinterpret_cast<const float4*>(xu + 16 + 4 * w);
#pragma unroll
        for (int r = 0; r < RW; ++r) D::dot2(cur[r], w, xa, xb, s[r]);
      }
      float2 S = make_float2(0.f, 0.f);
      if constexpr (D::M) S = *reinterpret_cast<const float2*>(xu + 32);
#pragma unroll
      for (int r = 0; r < RW; ++r) acc[r] = D::fold(cur[r], s[r], S, acc[r]);
    }
  };
  int ph = 0;  // D::SWAP: which buffer holds the next step (no register copies)
  while (g < groups) {
    float acc[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) acc[r] = 0.f;
    for (int c0 = 0; c0 < units; c0 += STEP) {
      if constexpr (!D::SWAP) {
        step(b0, b1, c0, acc);
#pragma unroll
        for (int r = 0; r < RW; ++r) b0[r] = b1[r];
      } else {
        if (ph == 0)
          step(b0, b1, c0, acc);
        else
          step(b1, b0, c0, acc);
        ph ^= 1;
      }
    }
    // the group's reduction, the next group's first loads in flight
#pragma unroll
    for (int r = 0; r < RW; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    out(g, acc);
    g += gstride;
  }
}

// One chunk of K: units u0 .. u0 + units - 1 of every row (u0 a multiple
// of 8, x already advanced to unit u0); add: y += the chunk's sums. Rows
// past N read row N - 1 and write nothing.
template <class D, int WARPS, int RW, bool RX>
__global__ void __launch_bounds__(WARPS * 32)
vec_kernel(const float* __restrict__ x, const Planes pl, float* __restrict__ y, int N, int K,
           int u0, int units, int add) {
  extern __shared__ __align__(16) float xs[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  walk<D, RW>(
      pl, xs, K, u0, units, (N + RW - 1) / RW, blockIdx.x * WARPS + warp, gridDim.x * WARPS,
      [&](int lg, int r) { return min(lg * RW + r, N - 1); },
      [&] { stage_x<D, RX>(x, xs, units); }, [](int) {},
      [&](int g, const float (&v)[RW]) {
#pragma unroll
        for (int r = 0; r < RW; ++r)
          if (lane == 0 && g * RW + r < N) y[g * RW + r] = add ? y[g * RW + r] + v[r] : v[r];
      });
}

// One launch at (WARPS, RW) a chunk of K (CHUNK units at most; where K
// needs more than one, near-equal chunks of whole 256-weight groups): the grid is every row
// group's warp, at most what the card holds at once (and WARPS_SM warps an
// SM), found once for each (device, shared memory bytes) and kept in a few
// slots, each one (device, bytes, CTAs) word. Returns the first failure of
// cudaGetLastError() after a launch.
template <class D, int WARPS, int RW, bool RX>
int launch_geom(const float* x, const Planes& pl, float* y, int N, int K, cudaStream_t stream) {
  static std::atomic<unsigned long long> fits[8];
  const int units = K / 32, chunks = (units + CHUNK - 1) / CHUNK;
  const int cu = chunks == 1 ? units : ((units + chunks - 1) / chunks + 7) / 8 * 8;
  const int smem = cu * XU * (int)sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long key = ((unsigned long long)dev << 24 | (unsigned)smem) << 32;
  int fit = 0;
  for (auto& f : fits) {
    const unsigned long long v = f.load(std::memory_order_relaxed);
    if ((v >> 32 << 32) == key) {
      fit = (int)(uint32_t)v;
      break;
    }
  }
  if (fit == 0) {
    // the attribute at its largest: a miss at a smaller size must not
    // lower it below a size kept earlier
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(vec_kernel<D, WARPS, RW, RX>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vec_kernel<D, WARPS, RW, RX>,
                                                          WARPS * 32, smem);
    if (err != cudaSuccess) return (int)err;
    fit = max(1, min(per_sm, max(1, WARPS_SM / WARPS)) * sms);
    bool kept = false;
    for (auto& f : fits) {
      unsigned long long empty = 0;
      if (f.compare_exchange_strong(empty, key | (uint32_t)fit)) {
        kept = true;
        break;
      }
    }
    if (!kept) fits[(unsigned)smem / 16 % 8].store(key | (uint32_t)fit, std::memory_order_relaxed);
  }
  const int groups = (N + RW - 1) / RW;
  const int grid = min((groups + WARPS - 1) / WARPS, fit);
  for (int u0 = 0; u0 < units; u0 += cu) {
    vec_kernel<D, WARPS, RW, RX><<<grid, WARPS * 32, smem, stream>>>(
        x + 32 * u0, pl, y, N, K, u0, min(cu, units - u0), u0 > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The checks every entry makes before a launch: one activation row, K a
// multiple of D::KALIGN, x and the 16-byte quant planes aligned, every
// plane's row offsets within 2^31 bytes.
template <class D>
bool launchable(const float* x, const Planes& pl, int B, int N, int K, int nwide) {
  if (B != 1 || N <= 0 || K <= 0 || K % D::KALIGN) return false;
  if (reinterpret_cast<uintptr_t>(x) % 16) return false;
  for (int i = 0; i < nwide; ++i)
    if (reinterpret_cast<uintptr_t>(pl.p[i]) % 16) return false;
  return (long long)N * (K / 2) < (1ll << 31);
}

template <class D, int WARPS, int RW>
int launch(const float* x, const Planes& pl, float* y, int N, int K, int rx, cudaStream_t stream) {
  return rx ? launch_geom<D, WARPS, RW, true>(x, pl, y, N, K, stream)
            : launch_geom<D, WARPS, RW, false>(x, pl, y, N, K, stream);
}

}  // namespace dqv
}  // namespace
