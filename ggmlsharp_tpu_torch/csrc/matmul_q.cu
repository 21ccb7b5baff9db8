// Dequant-matmul for the weight formats Q4_1, Q4_2, Q4_3, Q5_0, Q5_1, Q4_K
// and Q6_K on Hopper (sm_90a):
//   y[b, n] = sum_k x[b, k] * w[n, k],  x, y f32; w packed, one decode a format.
//
// Replaces, for those formats, ggmlsharp_tpu/kernels/matmul_q.py's three TPU
// layouts of one function: _call_kernel_swar (:377, Q4_1/4_K/5_0/5_1/6_K),
// _call_kernel_planes (:199, Q4_1/4_K) and _call_kernel (:737, every format;
// the only one that reaches Q4_2 and Q4_3). Q4_0 and Q8_0 have their own
// sources (matmul_q4_0.cu, matmul_q8_0.cu).
//
// Weights come in the port's layout (quant/formats.py): each of ggml's block
// fields in one plane, row-major, in wire order within a row:
//   Q4_1/Q4_3  qs u8 [N, K/2] (byte j of a block of B: elements j, j + B/2),
//              d, m f16 [N, K/B]; Q4_2 as Q4_1 without m; B = 32 / 16 / 16.
//   Q5_0/Q5_1  qs as Q4_1 (low 4 bits), qh i32 [N, K/32] (bit l = element
//              l's fifth bit), d (m) f16 [N, K/32].
//   Q4_K       qs u8 [N, K/2] (byte l of 64-element group g: elements
//              64g + l, 64g + 32 + l), scales u8 [N, K/256*12] (ggml's
//              6-bit packing), d, dmin f16 [N, K/256].
//   Q6_K       ql u8 [N, K/2], qh u8 [N, K/4], sc i8 [N, K/16], d f16
//              [N, K/256] (ggml's block_q6_K fields).
// w is ggml's dequantized weight, with the k-quants' sub-block scale formed
// as the JAX package's kernels read it: kd = f16(d * sc), km = f16(dmin * m)
// (the f32 product is exact; one round to f16), w = q * kd - km (Q4_K),
// (q - 32) * kd (Q6_K). Those are read from the packed scales in registers,
// so a Q4_K weight costs 4.5 bits of traffic, as on the wire.
//
// What bounds it: at decode (b = 1) a matrix-vector product, bound by the
// HBM bytes of the packed weights (5 to 6.5 bits a weight); the f32 FMAs
// (2*b*N*K) overtake the bytes only at larger b.
//
// Design, simple first (matmul_q4_0.cu's, a decode function a format):
//  * A warp owns ROWS_PER_WARP weight rows and streams each once; a lane
//    loads 4 bytes of packed nibbles a row a step (128 contiguous bytes a
//    warp: coalesced), and the activations it needs as two float4 loads
//    through the read-only cache, which serve every row of the warp.
//  * Quants become floats without an int-to-float conversion: a byte
//    permute puts each in the mantissa of 2^23, one subtraction leaves
//    q - offset exactly. Q5 ORs bit l of the block's qh into element l's
//    bit 4 first, Q6_K the two high bits from qh.
//  * The min terms are folded, as kernel 1 folds them: sum_k x_k (q_k d +
//    m) = d sum_k x_k q_k + m sum_k x_k, the activation sum taken once a
//    lane a step for all the warp's rows.
//  * The activation row keeps its own f32 accumulators (RB rows a pass, a
//    template parameter launched at 1: decode); a warp-shuffle reduction
//    ends each row.
//  * Launch geometry: WARPS warps a block, ROWS_PER_WARP rows a warp, both
//    template parameters, one instance for each pair of kernels/tune.py's
//    GEOMETRIES and each format (the C entry takes the pair). Each row keeps
//    its own accumulator chain and lane map whatever the pair, so every
//    pair gives the same bits.
//  * Ragged edges are masked: N not a multiple of the rows a block, K/32 not
//    a multiple of 8 groups (K = 11008 is 344 blocks of 32 and 43
//    superblocks of 256: the k-quants take one superblock a warp step).
// No tensor cores and no TMA in this instance, which runs one activation
// row. Two or more rows take the multi-row instance on the tensor cores
// (dq_mma.cuh, q_matmul_mma below; kernels/matmul_q.py MMA_MIN_ROWS), with
// the Q4_K and Q6_K decoders defined here.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dq_mma.cuh"

namespace {

constexpr int GROUPS_PER_STEP = 8;  // 32-element groups a warp covers a step

// format ids: GType's numbering (dtypes.py)
enum Fmt : int { Q4_1 = 3, Q4_2 = 4, Q4_3 = 5, Q5_0 = 6, Q5_1 = 7, Q4_K = 14, Q6_K = 15 };

template <int F> struct Traits;
// BS: block elements; OFF: value offset; M: a min term; Q5: a qh bit plane
template <> struct Traits<Q4_1> { static constexpr int BS = 32, OFF = 0; static constexpr bool M = true, Q5 = false; };
template <> struct Traits<Q4_2> { static constexpr int BS = 16, OFF = 8; static constexpr bool M = false, Q5 = false; };
template <> struct Traits<Q4_3> { static constexpr int BS = 16, OFF = 0; static constexpr bool M = true, Q5 = false; };
template <> struct Traits<Q5_0> { static constexpr int BS = 32, OFF = 16; static constexpr bool M = false, Q5 = true; };
template <> struct Traits<Q5_1> { static constexpr int BS = 32, OFF = 0; static constexpr bool M = true, Q5 = true; };

// The four bytes of m (each < 2^8) -> byte - off as floats.
__device__ __forceinline__ void bytes_to_float(uint32_t m, float off, float out[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    out[t] = __int_as_float(__byte_perm(m, 0x4B000000u, 0x7440 + t)) - (8388608.0f + off);
}

// Bits 0..3 of h -> bit 4 of bytes 0..3.
__device__ __forceinline__ uint32_t spread4(uint32_t h) {
  return ((h & 1u) << 4) | ((h & 2u) << 11) | ((h & 4u) << 18) | ((h & 8u) << 25);
}

__device__ __forceinline__ float dot4(const float4& x, const float w[4]) {
  float s = x.x * w[0];
  s = fmaf(x.y, w[1], s);
  s = fmaf(x.z, w[2], s);
  return fmaf(x.w, w[3], s);
}

__device__ __forceinline__ float sum4(const float4& x) { return x.x + x.y + x.z + x.w; }

// f16(a * b) as f32: the JAX package's fused k-quant scale
__device__ __forceinline__ float f16_product(__half a, int b) {
  return __half2float(__float2half_rn(__half2float(a) * (float)b));
}

// four activations, rounded to bf16 where RX (mm_dot "bf16")
template <bool RX>
__device__ __forceinline__ float4 ldx(const float* p) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return RX ? bf16_round4(v) : v;
}

__device__ __forceinline__ uint32_t ldw(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

// ---- legacy formats: a lane takes 4 bytes of a 32-element group a step ----
template <int F, int RB, int ROWS_PER_WARP, bool RX>
__device__ __forceinline__ void legacy_rows(const float* __restrict__ x, const void* p0,
                                            const void* p1, const void* p2, const void* p3,
                                            int B, int N, int K, int n0, int b0, int lane,
                                            float acc[RB][ROWS_PER_WARP]) {
  using T = Traits<F>;
  const uint8_t* qs = static_cast<const uint8_t*>(p0);
  const int32_t* qh = T::Q5 ? static_cast<const int32_t*>(p1) : nullptr;
  const __half* d = static_cast<const __half*>(T::Q5 ? p2 : p1);
  const __half* m = static_cast<const __half*>(T::Q5 ? p3 : p2);
  const int ng = K >> 5;          // 32-element groups a row
  const int nb = K / T::BS;       // blocks a row
  const int j = (lane & 3) * 4;   // first of the lane's 4 bytes in its group
  // element offsets (in the group) of the lane's low and high nibbles, and
  // the block of the group they belong to
  const int sub = T::BS == 16 ? (j >> 3) : 0;
  const int e_lo = T::BS == 16 ? sub * 16 + (j & 7) : j;
  const int e_hi = e_lo + T::BS / 2;

  for (int c = lane >> 2; c < ng; c += GROUPS_PER_STEP) {
    float wl[ROWS_PER_WARP][4], wh[ROWS_PER_WARP][4], dw[ROWS_PER_WARP], mw[ROWS_PER_WARP];
    const int blk = T::BS == 16 ? 2 * c + sub : c;
#pragma unroll
    for (int w = 0; w < ROWS_PER_WARP; ++w) {
      uint32_t lo = 0, hi = 0;
      dw[w] = 0.f;
      mw[w] = 0.f;
      if (n0 + w < N) {
        const size_t row = (size_t)(n0 + w);
        const uint32_t u = ldw(qs + row * (K / 2) + c * 16 + j);
        lo = u & 0x0F0F0F0Fu;
        hi = (u >> 4) & 0x0F0F0F0Fu;
        if constexpr (T::Q5) {
          const uint32_t h = (uint32_t)__ldg(qh + row * ng + c);
          lo |= spread4((h >> j) & 0xFu);
          hi |= spread4((h >> (j + 16)) & 0xFu);
        }
        dw[w] = __half2float(d[row * nb + blk]);
        if constexpr (T::M) mw[w] = __half2float(m[row * nb + blk]);
      }
      bytes_to_float(lo, (float)T::OFF, wl[w]);
      bytes_to_float(hi, (float)T::OFF, wh[w]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (b0 + r < B) {
        const float* xr = x + (size_t)(b0 + r) * K + c * 32;
        const float4 xl = ldx<RX>(xr + e_lo);
        const float4 xh = ldx<RX>(xr + e_hi);
        const float xs = T::M ? sum4(xl) + sum4(xh) : 0.f;
#pragma unroll
        for (int w = 0; w < ROWS_PER_WARP; ++w) {
          float s = dot4(xl, wl[w]);
          s = fmaf(xh.x, wh[w][0], s);
          s = fmaf(xh.y, wh[w][1], s);
          s = fmaf(xh.z, wh[w][2], s);
          s = fmaf(xh.w, wh[w][3], s);
          acc[r][w] = fmaf(dw[w], s, acc[r][w]);
          if constexpr (T::M) acc[r][w] = fmaf(mw[w], xs, acc[r][w]);
        }
      }
    }
  }
}

// ---- Q4_K: a warp takes one superblock (128 bytes of qs) a row a step ----
// Lane L holds bytes 4L..4L+3: group g = L/8, elements 64g + 4(L%8) + t (low
// nibbles, sub-block 2g) and 32 more (high nibbles, sub-block 2g + 1).
template <int RB, int ROWS_PER_WARP, bool RX>
__device__ __forceinline__ void q4_k_rows(const float* __restrict__ x, const void* p0,
                                          const void* p1, const void* p2, const void* p3,
                                          int B, int N, int K, int n0, int b0, int lane,
                                          float acc[RB][ROWS_PER_WARP]) {
  const uint8_t* qs = static_cast<const uint8_t*>(p0);
  const uint8_t* scales = static_cast<const uint8_t*>(p1);
  const __half* d = static_cast<const __half*>(p2);
  const __half* dmin = static_cast<const __half*>(p3);
  const int nsb = K >> 8;
  const int g = lane >> 3;
  const int e_lo = 64 * g + 4 * (lane & 7);
  // ggml's get_scale_min_k4 for the lane's sub-blocks 2g and 2g + 1, read
  // from the three 32-bit words of the packed scales (bytes 0-3, 4-7, 8-11)
  // with shifts fixed a lane: sub-blocks 0..3 keep 6-bit fields in bytes
  // 0..7; 4..7 take 4 bits from bytes 8..11 and their top 2 from the top
  // bits of bytes 0..7. No byte array (it would live in local memory).
  const bool low = g < 2;
  const int sh = 16 * (g & 1);
  const uint32_t fmask = low ? 63u : 15u, top = low ? 0u : 1u;

  for (int s = 0; s < nsb; ++s) {
    float wl[ROWS_PER_WARP][4], wh[ROWS_PER_WARP][4];
    float kl[ROWS_PER_WARP], kh[ROWS_PER_WARP], ml[ROWS_PER_WARP], mh[ROWS_PER_WARP];
#pragma unroll
    for (int w = 0; w < ROWS_PER_WARP; ++w) {
      uint32_t u = 0;
      kl[w] = kh[w] = ml[w] = mh[w] = 0.f;
      if (n0 + w < N) {
        const size_t row = (size_t)(n0 + w);
        u = ldw(qs + row * (K / 2) + s * 128 + 4 * lane);
        const uint8_t* sp = scales + (row * nsb + s) * 12;
        const uint32_t w0 = ldw(sp), w1 = ldw(sp + 4), w2 = ldw(sp + 8);
        const uint32_t a = low ? w0 : w2, c = low ? w1 : w2 >> 4;
        const int sc_lo = ((a >> sh) & fmask) | (((w0 >> (sh + 6)) & 3u) << 4) * top;
        const int sc_hi = ((a >> (sh + 8)) & fmask) | (((w0 >> (sh + 14)) & 3u) << 4) * top;
        const int mn_lo = ((c >> sh) & fmask) | (((w1 >> (sh + 6)) & 3u) << 4) * top;
        const int mn_hi = ((c >> (sh + 8)) & fmask) | (((w1 >> (sh + 14)) & 3u) << 4) * top;
        const __half dd = d[row * nsb + s], dm = dmin[row * nsb + s];
        kl[w] = f16_product(dd, sc_lo);
        kh[w] = f16_product(dd, sc_hi);
        ml[w] = -f16_product(dm, mn_lo);
        mh[w] = -f16_product(dm, mn_hi);
      }
      bytes_to_float(u & 0x0F0F0F0Fu, 0.f, wl[w]);
      bytes_to_float((u >> 4) & 0x0F0F0F0Fu, 0.f, wh[w]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (b0 + r < B) {
        const float* xr = x + (size_t)(b0 + r) * K + s * 256;
        const float4 xl = ldx<RX>(xr + e_lo);
        const float4 xh = ldx<RX>(xr + e_lo + 32);
        const float xsl = sum4(xl), xsh = sum4(xh);
#pragma unroll
        for (int w = 0; w < ROWS_PER_WARP; ++w) {
          float a = fmaf(kl[w], dot4(xl, wl[w]), acc[r][w]);
          a = fmaf(kh[w], dot4(xh, wh[w]), a);
          a = fmaf(ml[w], xsl, a);
          acc[r][w] = fmaf(mh[w], xsh, a);
        }
      }
    }
  }
}

// ---- Q6_K: a warp takes one superblock a row a step ----
// Lane L: half h = L/16, part = (L/8) % 2, l = 4(L%8): ql bytes 4L..4L+3
// (h*64 + part*32 + l) hold elements e = 128h + 32part + l + t (low nibbles)
// and e + 64 (high); qh bytes h*32 + l + t hold their two high bits at bit
// pairs part (e) and part + 2 (e + 64).
template <int RB, int ROWS_PER_WARP, bool RX>
__device__ __forceinline__ void q6_k_rows(const float* __restrict__ x, const void* p0,
                                          const void* p1, const void* p2, const void* p3,
                                          int B, int N, int K, int n0, int b0, int lane,
                                          float acc[RB][ROWS_PER_WARP]) {
  const uint8_t* ql = static_cast<const uint8_t*>(p0);
  const uint8_t* qh = static_cast<const uint8_t*>(p1);
  const int8_t* sc = static_cast<const int8_t*>(p2);
  const __half* d = static_cast<const __half*>(p3);
  const int nsb = K >> 8;
  const int h = lane >> 4, part = (lane >> 3) & 1, l = 4 * (lane & 7);
  const int e_lo = 128 * h + 32 * part + l;

  for (int s = 0; s < nsb; ++s) {
    float wl[ROWS_PER_WARP][4], wh[ROWS_PER_WARP][4], kl[ROWS_PER_WARP], kh[ROWS_PER_WARP];
#pragma unroll
    for (int w = 0; w < ROWS_PER_WARP; ++w) {
      uint32_t lo = 0x20202020u, hi = 0x20202020u;  // q = 32: value 0
      kl[w] = kh[w] = 0.f;
      if (n0 + w < N) {
        const size_t row = (size_t)(n0 + w);
        const uint32_t u = ldw(ql + row * (K / 2) + s * 128 + 4 * lane);
        const uint32_t v = ldw(qh + row * (K / 4) + s * 64 + 32 * h + l);
        lo = (u & 0x0F0F0F0Fu) | (((v >> (2 * part)) & 0x03030303u) << 4);
        hi = ((u >> 4) & 0x0F0F0F0Fu) | (((v >> (2 * part + 4)) & 0x03030303u) << 4);
        const int8_t* scr = sc + row * (K / 16) + s * 16;
        const __half dd = d[row * nsb + s];
        kl[w] = f16_product(dd, scr[e_lo >> 4]);
        kh[w] = f16_product(dd, scr[(e_lo >> 4) + 4]);
      }
      bytes_to_float(lo, 32.f, wl[w]);
      bytes_to_float(hi, 32.f, wh[w]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (b0 + r < B) {
        const float* xr = x + (size_t)(b0 + r) * K + s * 256;
        const float4 xl = ldx<RX>(xr + e_lo);
        const float4 xh = ldx<RX>(xr + e_lo + 64);
#pragma unroll
        for (int w = 0; w < ROWS_PER_WARP; ++w) {
          const float a = fmaf(kl[w], dot4(xl, wl[w]), acc[r][w]);
          acc[r][w] = fmaf(kh[w], dot4(xh, wh[w]), a);
        }
      }
    }
  }
}

template <int F, int WARPS, int ROWS_PER_WARP, int RB, bool RX>
__global__ void __launch_bounds__(WARPS * 32)
q_matmul_kernel(const float* __restrict__ x, const void* p0, const void* p1, const void* p2,
                const void* p3, float* __restrict__ y, int B, int N, int K) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + warp) * ROWS_PER_WARP;
  if (n0 >= N) return;  // the whole warp leaves together
  const int b0 = blockIdx.y * RB;

  float acc[RB][ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int w = 0; w < ROWS_PER_WARP; ++w) acc[r][w] = 0.f;

  if constexpr (F == Q4_K)
    q4_k_rows<RB, ROWS_PER_WARP, RX>(x, p0, p1, p2, p3, B, N, K, n0, b0, lane, acc);
  else if constexpr (F == Q6_K)
    q6_k_rows<RB, ROWS_PER_WARP, RX>(x, p0, p1, p2, p3, B, N, K, n0, b0, lane, acc);
  else
    legacy_rows<F, RB, ROWS_PER_WARP, RX>(x, p0, p1, p2, p3, B, N, K, n0, b0, lane, acc);

#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int w = 0; w < ROWS_PER_WARP; ++w) {
      float v = acc[r][w];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && b0 + r < B && n0 + w < N) y[(size_t)(b0 + r) * N + n0 + w] = v;
    }
  }
}

template <int F, int WARPS, int RPW>
void launch_geom(const float* x, const void* p0, const void* p1, const void* p2,
                 const void* p3, float* y, int B, int N, int K, int rx, cudaStream_t stream) {
  constexpr int rows = WARPS * RPW;  // weight rows a block
  dim3 grid((N + rows - 1) / rows, 1);  // decode: one activation row
  if (rx)  // mm_dot "bf16": x rounded where it is loaded
    q_matmul_kernel<F, WARPS, RPW, 1, true><<<grid, WARPS * 32, 0, stream>>>(x, p0, p1, p2, p3,
                                                                          y, B, N, K);
  else
    q_matmul_kernel<F, WARPS, RPW, 1, false><<<grid, WARPS * 32, 0, stream>>>(x, p0, p1, p2, p3,
                                                                           y, B, N, K);
}

template <int F>
int launch(const float* x, const void* p0, const void* p1, const void* p2, const void* p3,
           float* y, int B, int N, int K, int warps, int rpw, int rx, cudaStream_t stream) {
  const bool kq = F == Q4_K || F == Q6_K;
  if (K % (kq ? 256 : 32)) return (int)cudaErrorInvalidValue;
  switch (warps * 16 + rpw) {
    case 4 * 16 + 1: launch_geom<F, 4, 1>(x, p0, p1, p2, p3, y, B, N, K, rx, stream); break;
    case 4 * 16 + 2: launch_geom<F, 4, 2>(x, p0, p1, p2, p3, y, B, N, K, rx, stream); break;
    case 4 * 16 + 4: launch_geom<F, 4, 4>(x, p0, p1, p2, p3, y, B, N, K, rx, stream); break;
    case 8 * 16 + 1: launch_geom<F, 8, 1>(x, p0, p1, p2, p3, y, B, N, K, rx, stream); break;
    case 8 * 16 + 2: launch_geom<F, 8, 2>(x, p0, p1, p2, p3, y, B, N, K, rx, stream); break;
    case 8 * 16 + 4: launch_geom<F, 8, 4>(x, p0, p1, p2, p3, y, B, N, K, rx, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ---- the multi-row instance's k-quant decoders (dq_mma.cuh) ----

// Q4_K: a chunk is one superblock; group gi is sub-block gi (64-element
// group gi / 2, low nibbles for even gi, high for odd): k-step ks of the
// lane reads bytes 32 (gi / 2) + 16 ks + 4t..+3. Scale and min from ggml's
// 6-bit packing (get_scale_min_k4), fused to f16 as the b = 1 instance.
// Slices: qs (32 words), scales (3), d (1), dmin (1).
struct DecQ4K {
  static constexpr int BS = 32, KALIGN = 256;
  static constexpr bool M = true;
  static constexpr int NSLICE = 4;
  __host__ __device__ static constexpr int ws(int s) { return s == 0 ? 32 : s == 1 ? 3 : 1; }
  __host__ __device__ static constexpr int off(int s) { return s == 0 ? 0 : off(s - 1) + ws(s - 1); }
  __host__ __device__ static constexpr int rw() { return dqm::row_words(off(NSLICE - 1) + ws(NSLICE - 1)); }
  __host__ __device__ static constexpr bool bulk(int s) { return s == 0; }
  __device__ static dqm::Lin lin(int s, const dqm::Planes& p, int K) {
    const uint8_t* base = static_cast<const uint8_t*>(p.p[s]);
    const int nsb = K >> 8;
    if (s == 0) return {base, K / 2, 128};
    if (s == 1) return {base, nsb * 12, 12};
    return {base, nsb * 2, 2};
  }
  __device__ static void group(const uint32_t* wr, size_t row, int c, int gi, int K, int t,
                               uint32_t w[2][2], float d[2], float m[2]) {
    const int mis = (int)(((row * (K >> 8) + c) * 2) & 3);
    const float dd = dqm::lds_h(wr + off(2), mis), dm = dqm::lds_h(wr + off(3), mis);
    // get_scale_min_k4(gi): bytes gi % 4, + 4 and + 8 of the 12
    auto byte = [&](int i) { return (int)((wr[off(1) + (i >> 2)] >> (8 * (i & 3))) & 0xFF); };
    const int a = byte(gi & 3), b = byte((gi & 3) + 4), e = byte((gi & 3) + 8);
    const int sc = gi < 4 ? a & 63 : (e & 0xF) | ((a >> 6) << 4);
    const int mn = gi < 4 ? b & 63 : (e >> 4) | ((b >> 6) << 4);
    const float kd = dqm::f16_round(dd * (float)sc), km = dqm::f16_round(dm * (float)mn);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint32_t u = wr[8 * (gi >> 1) + 4 * ks + t];
      dqm::bytes_bf16<0>((u >> (4 * (gi & 1))) & 0x0F0F0F0Fu, w[ks]);
      d[ks] = kd;
      m[ks] = -km;
    }
  }
};

// Q6_K: a chunk is one superblock; group gi holds elements 32 gi..: half
// h = gi / 4, quarter qd = gi % 4 (ggml's order: ql bytes 64h + 32 (qd % 2)
// + l, low nibbles for qd < 2, high for qd >= 2; qh bytes 32h + l, bits
// 2 qd), l = 16 ks + 4t + i. Sub-block 2 gi + ks of 16 takes scale
// f16(d * sc). Slices: ql (32 words), qh (16), sc (4), d (1).
struct DecQ6K {
  static constexpr int BS = 16, KALIGN = 256;
  static constexpr bool M = false;
  static constexpr int NSLICE = 4;
  __host__ __device__ static constexpr int ws(int s) { return s == 0 ? 32 : s == 1 ? 16 : s == 2 ? 4 : 1; }
  __host__ __device__ static constexpr int off(int s) { return s == 0 ? 0 : off(s - 1) + ws(s - 1); }
  __host__ __device__ static constexpr int rw() { return dqm::row_words(off(NSLICE - 1) + ws(NSLICE - 1)); }
  __host__ __device__ static constexpr bool bulk(int s) { return s < 2; }
  __device__ static dqm::Lin lin(int s, const dqm::Planes& p, int K) {
    const uint8_t* base = static_cast<const uint8_t*>(p.p[s]);
    if (s == 0) return {base, K / 2, 128};
    if (s == 1) return {base, K / 4, 64};
    if (s == 2) return {base, K / 16, 16};
    return {base, (K >> 8) * 2, 2};
  }
  __device__ static void group(const uint32_t* wr, size_t row, int c, int gi, int K, int t,
                               uint32_t w[2][2], float d[2], float m[2]) {
    const int h = gi >> 2, qd = gi & 3;
    const float dd = dqm::lds_h(wr + off(3), (int)(((row * (K >> 8) + c) * 2) & 3));
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint32_t u = wr[16 * h + 8 * (qd & 1) + 4 * ks + t];
      const uint32_t v = wr[off(1) + 8 * h + 4 * ks + t];
      dqm::bytes_bf16<32>(((u >> (4 * (qd >> 1))) & 0x0F0F0F0Fu) |
                              (((v >> (2 * qd)) & 0x03030303u) << 4),
                          w[ks]);
      const int sb = 2 * gi + ks;
      const int sc = (int)(int8_t)((wr[off(2) + (sb >> 2)] >> (8 * (sb & 3))) & 0xFF);
      d[ks] = dqm::f16_round(dd * (float)sc);
      m[ks] = 0.f;
    }
  }
};

template <int F>
using DecOf = dqm::DecLegacy<Traits<F>::BS, Traits<F>::OFF, Traits<F>::M, Traits<F>::Q5>;

// fmt: the weight's GType id; p0..p3 its planes in kernels/matmul_q.py's
// _PLANES order (unused ones null). x f32 [1, K], y f32 [1, N]: the b = 1
// instance (any other B returns cudaErrorInvalidValue); `warps` warps
// a block and `rpw` weight rows a warp: one of kernels/tune.py's GEOMETRIES
// (any other pair returns cudaErrorInvalidValue). K must be a multiple of 32
// (256 for the k-quants); x 16-byte and the planes 4-byte aligned (the
// wrapper checks). rx: x rounded to bf16 where it is loaded (mm_dot
// "bf16"). Returns cudaGetLastError() after the launch.
extern "C" int q_matmul(int fmt, const float* x, const void* p0, const void* p1,
                        const void* p2, const void* p3, float* y, int B, int N, int K,
                        int warps, int rpw, int rx, cudaStream_t stream) {
  if (B != 1 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  switch (fmt) {
    case Q4_1: return launch<Q4_1>(x, p0, p1, p2, p3, y, B, N, K, warps, rpw, rx, stream);
    case Q4_2: return launch<Q4_2>(x, p0, p1, p2, p3, y, B, N, K, warps, rpw, rx, stream);
    case Q4_3: return launch<Q4_3>(x, p0, p1, p2, p3, y, B, N, K, warps, rpw, rx, stream);
    case Q5_0: return launch<Q5_0>(x, p0, p1, p2, p3, y, B, N, K, warps, rpw, rx, stream);
    case Q5_1: return launch<Q5_1>(x, p0, p1, p2, p3, y, B, N, K, warps, rpw, rx, stream);
    case Q4_K: return launch<Q4_K>(x, p0, p1, p2, p3, y, B, N, K, warps, rpw, rx, stream);
    case Q6_K: return launch<Q6_K>(x, p0, p1, p2, p3, y, B, N, K, warps, rpw, rx, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The multi-row instance (dq_mma.cuh): fmt and planes as q_matmul;
// activations x f32 [B, K], or Q8 (xq int8 [B, K], its block scales xd of
// dqm::ScaleKind `kind`; x null); y f32 [B, N] for any B (the wrappers send B >= 2 here); K a
// multiple of 32 (256 for the k-quants), split `splits` ways
// (kernels/matmul_q.py mma_splits); scratch as for q4_0_matmul_mma; rx as
// for q4_0_matmul_mma. Returns cudaGetLastError() after the launches.
extern "C" int q_matmul_mma(int fmt, const float* x, const int8_t* xq, const void* xd, int kind,
                            const void* p0, const void* p1, const void* p2, const void* p3,
                            float* y, unsigned char* scratch, int B, int N, int K, int splits,
                            int rx, cudaStream_t stream) {
  const dqm::Planes pl{{p0, p1, p2, p3}};
#define DQ_LAUNCH(D) dqm::launch<D>(x, xq, xd, kind, pl, y, scratch, B, N, K, splits, stream, rx)
  switch (fmt) {
    case Q4_1: return DQ_LAUNCH(DecOf<Q4_1>);
    case Q4_2: return DQ_LAUNCH(DecOf<Q4_2>);
    case Q4_3: return DQ_LAUNCH(DecOf<Q4_3>);
    case Q5_0: return DQ_LAUNCH(DecOf<Q5_0>);
    case Q5_1: return DQ_LAUNCH(DecOf<Q5_1>);
    case Q4_K: return DQ_LAUNCH(DecQ4K);
    case Q6_K: return DQ_LAUNCH(DecQ6K);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DQ_LAUNCH
}
