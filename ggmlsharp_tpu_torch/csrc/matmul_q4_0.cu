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
//  * A warp owns ROWS_PER_WARP weight rows and streams each once. Per step a
//    lane takes 4 bytes of one quant block (elements j..j+3 and j+16..j+19,
//    j = 4*(lane%4), block lane/4), so the warp reads 8 blocks = 128
//    contiguous qs bytes of each row: coalesced, one 32-bit load a lane.
//  * The 8 activations a lane needs are two float4 loads through the
//    read-only cache; they serve every weight row of the warp, which divides
//    the on-chip x traffic by ROWS_PER_WARP.
//  * Nibbles become floats without an int-to-float conversion: a byte permute
//    puts the nibble in the mantissa of 2^23, one subtraction of 2^23 + 8
//    leaves q - 8 exactly.
//  * Each activation row keeps its own f32 accumulator (RB rows a pass, a
//    template parameter: 1 for decode, so b = 1 carries no dead registers,
//    and 8 for every larger b); the scale is
//    applied once a block and a warp-shuffle reduction ends each row.
//  * Ragged edges are masked: N not a multiple of the rows a block, K/32 not a
//    multiple of 8 blocks (K = 11008 has 344 blocks), b not a multiple of RB.
// No tensor cores and no TMA: wgmma and TMA designs are left to a later change.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = 2;
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;
constexpr int BLOCKS_PER_STEP = 8;  // quant blocks a warp covers per step

// Four nibbles held in bytes 0..3 of m (masked to 0x0F0F0F0F) -> q - 8 as floats.
__device__ __forceinline__ void nibbles_minus_8(uint32_t m, float out[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    out[t] = __int_as_float(__byte_perm(m, 0x4B000000u, 0x7440 + t)) - 8388616.0f;
}

template <int RB>
__global__ void __launch_bounds__(WARPS * 32)
q4_0_matmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
                   const __half* __restrict__ d, float* __restrict__ y,
                   int B, int N, int K) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + warp) * ROWS_PER_WARP;
  if (n0 >= N) return;  // the whole warp leaves together
  const int b0 = blockIdx.y * RB;
  const int nb = K >> 5;        // quant blocks a row
  const int j = (lane & 3) * 4;  // first of the lane's 4 bytes in its block

  float acc[RB][ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int w = 0; w < ROWS_PER_WARP; ++w) acc[r][w] = 0.f;

  for (int c = lane >> 2; c < nb; c += BLOCKS_PER_STEP) {
    float wl[ROWS_PER_WARP][4], wh[ROWS_PER_WARP][4], dw[ROWS_PER_WARP];
#pragma unroll
    for (int w = 0; w < ROWS_PER_WARP; ++w) {
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
        for (int w = 0; w < ROWS_PER_WARP; ++w) {
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
  }

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

template <int RB>
void launch(const float* x, const uint8_t* qs, const __half* d, float* y,
            int B, int N, int K, cudaStream_t stream) {
  dim3 grid((N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, (B + RB - 1) / RB);
  q4_0_matmul_kernel<RB><<<grid, WARPS * 32, 0, stream>>>(x, qs, d, y, B, N, K);
}

}  // namespace

// x f32 [B, K], qs uint8 [N, K/2], d f16 [N, K/32] -> y f32 [B, N].
// K must be a multiple of 32; x and qs 16-byte aligned (the wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int q4_0_matmul(const float* x, const uint8_t* qs, const __half* d,
                           float* y, int B, int N, int K, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K % 32) return (int)cudaErrorInvalidValue;
  if (B == 1) launch<1>(x, qs, d, y, B, N, K, stream);  // decode
  else launch<8>(x, qs, d, y, B, N, K, stream);         // prefill; ragged B masked
  return (int)cudaGetLastError();
}
