// Warp-level Q8_0 row dot products, shared by matmul_q8_0.cu (warp_dot) and
// the kernels whose rows lie in shared memory, gpt2_layer.cu and
// mlp_fused_q8.cu's one-row instance (smem_rows_dot, through shares.cuh).
//
// A Q8_0 weight row is K int8 values in element order beside K/32 f16
// scales, one a 32-element block (quant/formats.py). A warp streams RW such
// rows once and dots each with RB f32 activation rows:
//   acc[r][w] = sum_k x[r][k] * d[w][k/32] * q[w][k].
// Per step the warp covers 8 blocks (256 elements) of every row as two
// 128-byte halves: lane L takes elements 4*(L%8)..+3 of block c0 + L/8 and
// of block c0 + 4 + L/8, so each half is one coalesced 32-bit load a lane,
// two loads a row in flight, and the matching activations are two float4
// loads at consecutive addresses across the warp (no shared-memory bank
// conflict when x lives there). The activation loads serve all RW rows.
// int8 becomes f32 without an int-to-float conversion: flipping the sign bit
// gives q + 128 as an unsigned byte, a byte permute puts it in the mantissa
// of 2^23, and one subtraction of 2^23 + 128 leaves q exactly. The scale is
// applied once a block. Rows past N are passed as nullptr and contribute 0;
// K/32 need not be a multiple of 8 (the tail blocks are masked).
#pragma once
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace q8 {

// The activations are global memory that no block writes during the launch,
// read by the read-only path (__ldg); X_READONLY_BF16: each value rounded to
// bf16 as it is loaded (mm_dot "bf16").
enum XLoad { X_READONLY = 0, X_READONLY_BF16 = 2 };

template <int XL>
__device__ __forceinline__ float4 load_x4(const float* p) {
  if constexpr (XL == X_READONLY_BF16)
    return bf16_round4(__ldg(reinterpret_cast<const float4*>(p)));
  else return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void int8x4_to_float(uint32_t u, float out[4]) {
  u ^= 0x80808080u;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    out[t] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + t)) - 8388736.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Weight rows n0, n0 + stride, ... of qs [N, K] / d [N, K/32]; nullptr past N.
template <int RW>
__device__ __forceinline__ void row_ptrs(const int8_t* qs, const __half* d, int K, int N,
                                         int n0, int stride, const int8_t* (&q)[RW],
                                         const __half* (&dd)[RW]) {
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    const int n = n0 + w * stride;
    q[w] = n < N ? qs + (size_t)n * K : nullptr;
    dd[w] = n < N ? d + (size_t)n * (K >> 5) : nullptr;
  }
}

// x: the first of RB activation rows, xs floats apart; rows r >= rows_valid
// are skipped. qs[w] / d[w]: weight row w (nullptr: masked). On return
// acc[r][w] is this lane's partial sum; warp_sum() completes it.
template <int RB, int RW, int XL>
__device__ __forceinline__ void warp_dot(const float* x, size_t xs, int rows_valid,
                                         const int8_t* const (&qs)[RW],
                                         const __half* const (&d)[RW], int K, int lane,
                                         float (&acc)[RB][RW]) {
  const int nb = K >> 5;
  const int e = (lane & 7) * 4;
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int w = 0; w < RW; ++w) acc[r][w] = 0.f;

#pragma unroll 2
  for (int c0 = 0; c0 < nb; c0 += 8) {
    const int blk0 = c0 + (lane >> 3), blk1 = blk0 + 4;
    const bool in0 = blk0 < nb, in1 = blk1 < nb;
    float w0[RW][4], w1[RW][4], s0[RW], s1[RW];
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      uint32_t u0 = 0u, u1 = 0u;  // q = 0 where masked
      s0[w] = 0.f;
      s1[w] = 0.f;
      if (qs[w] != nullptr) {
        if (in0) {
          u0 = __ldg(reinterpret_cast<const uint32_t*>(qs[w] + blk0 * 32 + e));
          s0[w] = __half2float(__ldg(d[w] + blk0));
        }
        if (in1) {
          u1 = __ldg(reinterpret_cast<const uint32_t*>(qs[w] + blk1 * 32 + e));
          s1[w] = __half2float(__ldg(d[w] + blk1));
        }
      }
      int8x4_to_float(u0, w0[w]);
      int8x4_to_float(u1, w1[w]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < rows_valid) {
        const float* xr = x + (size_t)r * xs;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 a0 = in0 ? load_x4<XL>(xr + blk0 * 32 + e) : z;
        const float4 a1 = in1 ? load_x4<XL>(xr + blk1 * 32 + e) : z;
#pragma unroll
        for (int w = 0; w < RW; ++w) {
          float t0 = a0.x * w0[w][0];
          t0 = fmaf(a0.y, w0[w][1], t0);
          t0 = fmaf(a0.z, w0[w][2], t0);
          t0 = fmaf(a0.w, w0[w][3], t0);
          float t1 = a1.x * w1[w][0];
          t1 = fmaf(a1.y, w1[w][1], t1);
          t1 = fmaf(a1.z, w1[w][2], t1);
          t1 = fmaf(a1.w, w1[w][3], t1);
          acc[r][w] = fmaf(s0[w], t0, acc[r][w]);
          acc[r][w] = fmaf(s1[w], t1, acc[r][w]);
        }
      }
    }
  }
}

// The same product for RW weight rows that lie in shared memory (row
// stride K bytes, scales K/32 halves apart) against an activation vector x
// also in shared memory, with no branch: a row past `rows` or a block past
// K/32 reads row 0 or block 0 and has its scale replaced by 0. The loads of
// the next step are issued before this step's arithmetic (two register
// sets), so a warp never waits for shared memory with work at hand. On
// return acc[w] is this lane's partial sum of row w over the 256-element
// steps s0, s0 + P, ...; warp_sum() completes it.
template <int RW>
struct SmemStep {
  float4 a0, a1;
  uint32_t u0[RW], u1[RW];
  float h0[RW], h1[RW];
  bool in0, in1;
};

template <int RW>
__device__ __forceinline__ void smem_step_load(SmemStep<RW>& st, const float* x, const int8_t* q,
                                               const __half* d, int K, int rows, int c0,
                                               int lane) {
  const int nb = K >> 5, e = (lane & 7) * 4;
  const int b0 = c0 + (lane >> 3), b1 = b0 + 4;
  st.in0 = b0 < nb;
  st.in1 = b1 < nb;
  const int k0 = st.in0 ? b0 : 0, k1 = st.in1 ? b1 : 0;
  st.a0 = *reinterpret_cast<const float4*>(x + k0 * 32 + e);
  st.a1 = *reinterpret_cast<const float4*>(x + k1 * 32 + e);
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    const int r = w < rows ? w : 0;
    const int8_t* qr = q + (size_t)r * K;
    const __half* dr = d + (size_t)r * (K >> 5);
    st.u0[w] = *reinterpret_cast<const uint32_t*>(qr + k0 * 32 + e);
    st.u1[w] = *reinterpret_cast<const uint32_t*>(qr + k1 * 32 + e);
    st.h0[w] = __half2float(dr[k0]);
    st.h1[w] = __half2float(dr[k1]);
  }
}

template <int RW>
__device__ __forceinline__ void smem_step_fma(const SmemStep<RW>& st, int rows,
                                              float (&acc)[RW]) {
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    float w0[4], w1[4];
    int8x4_to_float(st.u0[w], w0);
    int8x4_to_float(st.u1[w], w1);
    float t0 = st.a0.x * w0[0];
    t0 = fmaf(st.a0.y, w0[1], t0);
    t0 = fmaf(st.a0.z, w0[2], t0);
    t0 = fmaf(st.a0.w, w0[3], t0);
    float t1 = st.a1.x * w1[0];
    t1 = fmaf(st.a1.y, w1[1], t1);
    t1 = fmaf(st.a1.z, w1[2], t1);
    t1 = fmaf(st.a1.w, w1[3], t1);
    const bool live = w < rows;
    acc[w] = fmaf(live && st.in0 ? st.h0[w] : 0.f, t0, acc[w]);
    acc[w] = fmaf(live && st.in1 ? st.h1[w] : 0.f, t1, acc[w]);
  }
}

template <int RW>
__device__ __forceinline__ void smem_rows_dot(const float* x, const int8_t* q, const __half* d,
                                              int K, int rows, int s0, int P, int lane,
                                              float (&acc)[RW]) {
  const int nb = K >> 5;
#pragma unroll
  for (int w = 0; w < RW; ++w) acc[w] = 0.f;
  int c0 = 8 * s0;
  if (c0 >= nb) return;
  SmemStep<RW> A, B;
  smem_step_load(A, x, q, d, K, rows, c0, lane);
  while (true) {
    c0 += 8 * P;
    if (c0 < nb) smem_step_load(B, x, q, d, K, rows, c0, lane);
    smem_step_fma(A, rows, acc);
    if (c0 >= nb) break;
    c0 += 8 * P;
    if (c0 < nb) smem_step_load(A, x, q, d, K, rows, c0, lane);
    smem_step_fma(B, rows, acc);
    if (c0 >= nb) break;
  }
}

// ggml's tanh-form GELU (the constants of ops/basic.py).
__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// A bias / gain vector stored as f32 or bf16.
__device__ __forceinline__ float load_vec(const void* p, int i, int is_bf16) {
  if (is_bf16) {
    const uint16_t bits = __ldg(reinterpret_cast<const uint16_t*>(p) + i);
    return __uint_as_float((uint32_t)bits << 16);
  }
  return __ldg(reinterpret_cast<const float*>(p) + i);
}

}  // namespace q8
