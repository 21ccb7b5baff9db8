// Warp-level Q4_0 row dot products, shared by mlp_fused_silu_q4.cu and
// llama_layer.cu (the inner loop of matmul_q4_0.cu as a header).
//
// A Q4_0 weight row is K/2 bytes in ggml's in-block nibble order (byte j of a
// 16-byte block: element j in the low nibble, element j + 16 in the high one)
// beside K/32 f16 scales, one a 32-element block (quant/formats.py). A warp
// streams RW such rows once and dots each with RB f32 activation rows:
//   acc[r][w] = sum_k x[r][k] * d[w][k/32] * (q[w][k] - 8).
// Per step the warp covers 16 blocks (512 elements) of every row as two
// 128-byte halves: lane L takes bytes 4*(L%4)..+3 of block c0 + L/4 and of
// block c0 + 8 + L/4, so each half is one coalesced 32-bit load a lane, two
// loads a row in flight. Its four bytes hold elements j..j+3 (low nibbles)
// and j+16..j+19 (high nibbles), j = 4*(L%4): two float4 activation loads a
// block. Lanes of an odd block take the high half first, so the eight lanes
// that share a 128-bit shared-memory transaction hit 32 distinct banks when x
// lives there. The activation loads serve all RW rows. A nibble becomes f32
// without an int-to-float conversion: a byte permute puts it in the mantissa
// of 2^23 and one subtraction of 2^23 + 8 leaves q - 8 exactly. The scale is
// applied once a block. Rows past N are passed as nullptr and contribute 0;
// K/32 need not be a multiple of 16 (the tail blocks are masked: K = 11008
// has 344 blocks).
#pragma once
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace q4 {

// Where the activations live: global memory that no block writes during the
// launch (__ldg, the read-only path), or anywhere a plain load is right:
// shared memory, or global memory that other blocks wrote earlier in the
// launch, before a grid-wide barrier (the barrier orders those writes before
// plain loads; the read-only path gives no such promise).
enum XLoad { X_READONLY = 0, X_PLAIN = 1 };

template <int XL>
__device__ __forceinline__ float4 load_x4(const float* p) {
  if constexpr (XL == X_READONLY) return __ldg(reinterpret_cast<const float4*>(p));
  else return *reinterpret_cast<const float4*>(p);
}

// Four nibbles held in bytes 0..3 of m (masked to 0x0F0F0F0F) -> q - 8 as floats.
__device__ __forceinline__ void nibbles_minus_8(uint32_t m, float out[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    out[t] = __int_as_float(__byte_perm(m, 0x4B000000u, 0x7440 + t)) - 8388616.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Weight rows n0, n0 + stride, ... of qs [N, K/2] / d [N, K/32]; nullptr past N.
template <int RW>
__device__ __forceinline__ void row_ptrs(const uint8_t* qs, const __half* d, int K, int N,
                                         int n0, int stride, const uint8_t* (&q)[RW],
                                         const __half* (&dd)[RW]) {
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    const int n = n0 + w * stride;
    q[w] = n < N ? qs + (size_t)n * (K >> 1) : nullptr;
    dd[w] = n < N ? d + (size_t)n * (K >> 5) : nullptr;
  }
}

// x: the first of RB activation rows, xs floats apart; rows r >= rows_valid
// are skipped. qs[w] / d[w]: weight row w (nullptr: masked). On return
// acc[r][w] is this lane's partial sum; warp_sum() completes it. Several
// warps can split one row's K: warp i of n passes step_first = i, step_stride
// = n and takes every n-th 512-element step; the caller adds their sums.
// WS: the weight rows lie in shared memory (plain loads; else the
// read-only path).
template <int RB, int RW, int XL, bool WS = false>
__device__ __forceinline__ void warp_dot(const float* x, size_t xs, int rows_valid,
                                         const uint8_t* const (&qs)[RW],
                                         const __half* const (&d)[RW], int K, int lane,
                                         float (&acc)[RB][RW], int step_first = 0,
                                         int step_stride = 1) {
  const int nb = K >> 5;
  const int j = (lane & 3) * 4;         // first of the lane's 4 bytes in its block
  const int odd = (lane >> 2) & 1;      // odd blocks take the high half first
  const int sh_a = odd ? 4 : 0, sh_b = 4 - sh_a;
  const int off_a = j + (odd ? 16 : 0), off_b = j + (odd ? 0 : 16);
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int w = 0; w < RW; ++w) acc[r][w] = 0.f;

#pragma unroll 2
  for (int c0 = 16 * step_first; c0 < nb; c0 += 16 * step_stride) {
    const int blk0 = c0 + (lane >> 2), blk1 = blk0 + 8;
    const bool in0 = blk0 < nb, in1 = blk1 < nb;
    // [half of the step][a: first activation load, b: second]
    float wa0[RW][4], wb0[RW][4], wa1[RW][4], wb1[RW][4], s0[RW], s1[RW];
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      uint32_t u0 = 0x88888888u, u1 = 0x88888888u;  // q = 8: 0 where masked
      s0[w] = 0.f;
      s1[w] = 0.f;
      if (qs[w] != nullptr) {
        if (in0) {
          const uint32_t* p = reinterpret_cast<const uint32_t*>(qs[w] + blk0 * 16 + j);
          u0 = WS ? *p : __ldg(p);
          s0[w] = __half2float(WS ? d[w][blk0] : __ldg(d[w] + blk0));
        }
        if (in1) {
          const uint32_t* p = reinterpret_cast<const uint32_t*>(qs[w] + blk1 * 16 + j);
          u1 = WS ? *p : __ldg(p);
          s1[w] = __half2float(WS ? d[w][blk1] : __ldg(d[w] + blk1));
        }
      }
      nibbles_minus_8((u0 >> sh_a) & 0x0F0F0F0Fu, wa0[w]);
      nibbles_minus_8((u0 >> sh_b) & 0x0F0F0F0Fu, wb0[w]);
      nibbles_minus_8((u1 >> sh_a) & 0x0F0F0F0Fu, wa1[w]);
      nibbles_minus_8((u1 >> sh_b) & 0x0F0F0F0Fu, wb1[w]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < rows_valid) {
        const float* xr = x + (size_t)r * xs;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 a0 = in0 ? load_x4<XL>(xr + blk0 * 32 + off_a) : z;
        const float4 b0 = in0 ? load_x4<XL>(xr + blk0 * 32 + off_b) : z;
        const float4 a1 = in1 ? load_x4<XL>(xr + blk1 * 32 + off_a) : z;
        const float4 b1 = in1 ? load_x4<XL>(xr + blk1 * 32 + off_b) : z;
#pragma unroll
        for (int w = 0; w < RW; ++w) {
          float t0 = a0.x * wa0[w][0];
          t0 = fmaf(a0.y, wa0[w][1], t0);
          t0 = fmaf(a0.z, wa0[w][2], t0);
          t0 = fmaf(a0.w, wa0[w][3], t0);
          t0 = fmaf(b0.x, wb0[w][0], t0);
          t0 = fmaf(b0.y, wb0[w][1], t0);
          t0 = fmaf(b0.z, wb0[w][2], t0);
          t0 = fmaf(b0.w, wb0[w][3], t0);
          float t1 = a1.x * wa1[w][0];
          t1 = fmaf(a1.y, wa1[w][1], t1);
          t1 = fmaf(a1.z, wa1[w][2], t1);
          t1 = fmaf(a1.w, wa1[w][3], t1);
          t1 = fmaf(b1.x, wb1[w][0], t1);
          t1 = fmaf(b1.y, wb1[w][1], t1);
          t1 = fmaf(b1.z, wb1[w][2], t1);
          t1 = fmaf(b1.w, wb1[w][3], t1);
          acc[r][w] = fmaf(s0[w], t0, acc[r][w]);
          acc[r][w] = fmaf(s1[w], t1, acc[r][w]);
        }
      }
    }
  }
}

// silu(g) * u = g / (1 + exp(-g)) * u in f32.
__device__ __forceinline__ float swiglu(float g, float u) {
  return g / (1.0f + expf(-g)) * u;
}

}  // namespace q4
