// Q4_0 dequant-matmul for Hopper (sm_90a):
//   y[b, n] = sum_k x[b, k] * d[n, k/32] * (q[n, k] - 8),  x, y f32; q, d packed.
//
// Replaces ggmlsharp_tpu/kernels/matmul_q.py::_call_kernel_swar (Q4_0 only),
// the fused dequant-matmul behind every weight matmul of the llama main path
// (wqkv, wo, w_gate_up, w_down and the LM head).
//
// Weights come in the port's layout (quant/formats.py): qs uint8 [N, K/2] in
// ggml's in-block nibble order (byte j of a block: element j low, element
// j+16 high) and d f16 [N, K/32].
//
// What bounds it: at decode (b = 1) this is a matrix-vector product, bound by
// the HBM bytes of the packed weights, N*K*18/32 a call. The f32 FMAs
// (2*b*N*K) overtake the bytes only at larger b, at prefill.
//
// Design, simple first:
//  * A warp owns RPW weight rows and streams each once. Per step a lane takes
//    4 bytes of one quant block (elements j..j+3 and j+16..j+19, j =
//    4*(lane%4), block lane/4), so the warp reads 8 blocks = 128 contiguous
//    qs bytes of each row: coalesced, one 32-bit load a lane.
//  * The 8 activations a lane needs are two float4 loads through the
//    read-only cache; they serve every weight row of the warp, which divides
//    the on-chip x traffic by RPW.
//  * Nibbles become floats without an int-to-float conversion (Q4_UNPACK,
//    below): a byte permute puts the nibble in the mantissa of 2^23, one
//    subtraction of 2^23 + 8 leaves q - 8 exactly.
//  * Each activation row keeps its own f32 accumulator (RB rows a pass, a
//    template parameter: 1 for decode, so b = 1 carries no dead registers,
//    and 8 for every larger b); the scale is applied once a block and a
//    warp-shuffle reduction ends each row.
//  * Launch geometry: WARPS warps a block, RPW rows a warp, both template
//    parameters, one instance for each pair of kernels/tune.py's GEOMETRIES
//    (the C entry takes the pair; kernels/tune_h100.json holds the measured
//    choice a shape). A row's lane partial sums and shuffle tree depend on
//    neither number, so every pair gives the same bits.
//  * Ragged edges are masked: N not a multiple of the rows a block, K/32 not a
//    multiple of 8 blocks (K = 11008 has 344 blocks), b not a multiple of RB.
// No tensor cores and no TMA: wgmma and TMA designs are left to a later change.
//
// Q4_UNPACK (-D, default 0), the nibble-to-number step, a probe's variants
// (probes/dq_variants.py; counterpart of scripts/probe_dq_variants.py's
// three TPU inner loops):
//   0 prmt  (TPU variant b): the byte permute into 2^23's mantissa above;
//   1 i2f   (TPU variant c): the masked nibble through an integer-to-float
//           conversion, then - 8. Both give q - 8 exactly, so the result is
//           prmt's bit for bit;
//   2 half2 (TPU variant a): 16-bit operands, f32 accumulation. Two nibbles
//           become one __half2 with one lop3 against the exponent of 1024
//           and one __hsub2 of 1032; the activations are rounded to f16; a
//           lane's 8 products of a block are summed in packed f16 (4 a half,
//           __hfma2) and widened to f32 once a block, before the scale. Its
//           error is bounded by (4 + 1) * 2^-11 * sum_k |x_k w_k|. No route
//           of the port uses it.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef Q4_UNPACK
#define Q4_UNPACK 0
#endif
#define Q4_UNPACK_PRMT 0
#define Q4_UNPACK_I2F 1
#define Q4_UNPACK_HALF2 2

namespace {

constexpr int BLOCKS_PER_STEP = 8;  // quant blocks a warp covers per step

// Four nibbles held in bytes 0..3 of m (masked to 0x0F0F0F0F) -> q - 8 as floats.
__device__ __forceinline__ void nibbles_minus_8(uint32_t m, float out[4]) {
#if Q4_UNPACK == Q4_UNPACK_I2F
#pragma unroll
  for (int t = 0; t < 4; ++t) out[t] = (float)((m >> (8 * t)) & 0xFu) - 8.0f;
#else
#pragma unroll
  for (int t = 0; t < 4; ++t)
    out[t] = __int_as_float(__byte_perm(m, 0x4B000000u, 0x7440 + t)) - 8388616.0f;
#endif
}

// (a & mask) | magic in one instruction
__device__ __forceinline__ uint32_t lop3_and_or(uint32_t a, uint32_t mask, uint32_t magic) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(r) : "r"(a), "r"(mask), "r"(magic));
  return r;
}

// The lane's 8 quants of a block (u: bytes j..j+3, low nibbles elements
// j..j+3, high nibbles j+16..j+19) as four __half2 of q - 8: (j, j+1),
// (j+2, j+3), (j+16, j+17), (j+18, j+19).
__device__ __forceinline__ void nibbles_half2(uint32_t u, __half2 out[4]) {
  const uint32_t magic = 0x64006400u;   // 1024 in both halves
  const __half2 bias = __halves2half2(__ushort_as_half(0x6408), __ushort_as_half(0x6408));  // 1032
  const uint32_t b01 = __byte_perm(u, 0u, 0x4140);  // byte 0 -> half 0, byte 1 -> half 1
  const uint32_t b23 = __byte_perm(u, 0u, 0x4342);
  const uint32_t w[4] = {lop3_and_or(b01, 0x000F000Fu, magic), lop3_and_or(b23, 0x000F000Fu, magic),
                         lop3_and_or(b01 >> 4, 0x000F000Fu, magic),
                         lop3_and_or(b23 >> 4, 0x000F000Fu, magic)};
#pragma unroll
  for (int t = 0; t < 4; ++t) out[t] = __hsub2(*reinterpret_cast<const __half2*>(&w[t]), bias);
}

template <int WARPS, int RPW, int RB>
__global__ void __launch_bounds__(WARPS * 32)
q4_0_matmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
                   const __half* __restrict__ d, float* __restrict__ y,
                   int B, int N, int K) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + warp) * RPW;
  if (n0 >= N) return;  // the whole warp leaves together
  const int b0 = blockIdx.y * RB;
  const int nb = K >> 5;        // quant blocks a row
  const int j = (lane & 3) * 4;  // first of the lane's 4 bytes in its block

  float acc[RB][RPW];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int w = 0; w < RPW; ++w) acc[r][w] = 0.f;

  for (int c = lane >> 2; c < nb; c += BLOCKS_PER_STEP) {
#if Q4_UNPACK == Q4_UNPACK_HALF2
    __half2 wq[RPW][4];
    float dw[RPW];
#pragma unroll
    for (int w = 0; w < RPW; ++w) {
      uint32_t u = 0x88888888u;  // q = 8: contributes 0 past the last row
      dw[w] = 0.f;
      if (n0 + w < N) {
        const size_t row = (size_t)(n0 + w);
        u = __ldg(reinterpret_cast<const uint32_t*>(qs + row * (K / 2) + c * 16 + j));
        dw[w] = __half2float(d[row * nb + c]);
      }
      nibbles_half2(u, wq[w]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (b0 + r < B) {
        const float* xr = x + (size_t)(b0 + r) * K + c * 32 + j;
        const float4 xl = __ldg(reinterpret_cast<const float4*>(xr));
        const float4 xh = __ldg(reinterpret_cast<const float4*>(xr + 16));
        const __half2 xa = __floats2half2_rn(xl.x, xl.y), xb = __floats2half2_rn(xl.z, xl.w);
        const __half2 xc = __floats2half2_rn(xh.x, xh.y), xd = __floats2half2_rn(xh.z, xh.w);
#pragma unroll
        for (int w = 0; w < RPW; ++w) {
          __half2 h = __hmul2(xa, wq[w][0]);
          h = __hfma2(xb, wq[w][1], h);
          h = __hfma2(xc, wq[w][2], h);
          h = __hfma2(xd, wq[w][3], h);
          acc[r][w] = fmaf(dw[w], __low2float(h) + __high2float(h), acc[r][w]);
        }
      }
    }
#else
    float wl[RPW][4], wh[RPW][4], dw[RPW];
#pragma unroll
    for (int w = 0; w < RPW; ++w) {
      uint32_t u = 0x88888888u;  // q = 8: contributes 0 past the last row
      dw[w] = 0.f;
      if (n0 + w < N) {
        const size_t row = (size_t)(n0 + w);
        u = __ldg(reinterpret_cast<const uint32_t*>(qs + row * (K / 2) + c * 16 + j));
        dw[w] = __half2float(d[row * nb + c]);
      }
      nibbles_minus_8(u & 0x0F0F0F0Fu, wl[w]);
      nibbles_minus_8((u >> 4) & 0x0F0F0F0Fu, wh[w]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (b0 + r < B) {
        const float* xr = x + (size_t)(b0 + r) * K + c * 32 + j;
        const float4 xl = __ldg(reinterpret_cast<const float4*>(xr));
        const float4 xh = __ldg(reinterpret_cast<const float4*>(xr + 16));
#pragma unroll
        for (int w = 0; w < RPW; ++w) {
          float s = xl.x * wl[w][0];
          s = fmaf(xl.y, wl[w][1], s);
          s = fmaf(xl.z, wl[w][2], s);
          s = fmaf(xl.w, wl[w][3], s);
          s = fmaf(xh.x, wh[w][0], s);
          s = fmaf(xh.y, wh[w][1], s);
          s = fmaf(xh.z, wh[w][2], s);
          s = fmaf(xh.w, wh[w][3], s);
          acc[r][w] = fmaf(dw[w], s, acc[r][w]);
        }
      }
    }
#endif
  }

#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int w = 0; w < RPW; ++w) {
      float v = acc[r][w];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && b0 + r < B && n0 + w < N) y[(size_t)(b0 + r) * N + n0 + w] = v;
    }
  }
}

template <int WARPS, int RPW>
void launch(const float* x, const uint8_t* qs, const __half* d, float* y,
            int B, int N, int K, cudaStream_t stream) {
  constexpr int rows = WARPS * RPW;  // weight rows a block
  if (B == 1) {  // decode
    dim3 grid((N + rows - 1) / rows, 1);
    q4_0_matmul_kernel<WARPS, RPW, 1><<<grid, WARPS * 32, 0, stream>>>(x, qs, d, y, B, N, K);
  } else {  // prefill; ragged B masked
    dim3 grid((N + rows - 1) / rows, (B + 7) / 8);
    q4_0_matmul_kernel<WARPS, RPW, 8><<<grid, WARPS * 32, 0, stream>>>(x, qs, d, y, B, N, K);
  }
}

}  // namespace

// x f32 [B, K], qs uint8 [N, K/2], d f16 [N, K/32] -> y f32 [B, N], launched
// with `warps` warps a block and `rpw` weight rows a warp: one of
// kernels/tune.py's GEOMETRIES (any other pair returns cudaErrorInvalidValue).
// K must be a multiple of 32; x and qs 16-byte aligned (the wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int q4_0_matmul(const float* x, const uint8_t* qs, const __half* d,
                           float* y, int B, int N, int K, int warps, int rpw,
                           cudaStream_t stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K % 32) return (int)cudaErrorInvalidValue;
  switch (warps * 16 + rpw) {
    case 4 * 16 + 1: launch<4, 1>(x, qs, d, y, B, N, K, stream); break;
    case 4 * 16 + 2: launch<4, 2>(x, qs, d, y, B, N, K, stream); break;
    case 4 * 16 + 4: launch<4, 4>(x, qs, d, y, B, N, K, stream); break;
    case 8 * 16 + 1: launch<8, 1>(x, qs, d, y, B, N, K, stream); break;
    case 8 * 16 + 2: launch<8, 2>(x, qs, d, y, B, N, K, stream); break;
    case 8 * 16 + 4: launch<8, 4>(x, qs, d, y, B, N, K, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
