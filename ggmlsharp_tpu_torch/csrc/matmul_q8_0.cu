// Q8_0 dequant-matmul for Hopper (sm_90a):
//   y[b, n] = sum_k x[b, k] * d[n, k/32] * q[n, k],  x, y f32; q int8, d f16.
//
// Replaces ggmlsharp_tpu/kernels/matmul_q.py::_call_kernel_swar_q8 (entry
// mul_mat_swar), the fused dequant-matmul behind GPT-2's per-matmul linears
// (c_attn, c_proj at prefill) and its LM head over wte.
//
// Weights come in the port's layout (quant/formats.py): qs int8 [N, K] in
// element order and d f16 [N, K/32], ggml's own block bytes split in two.
//
// What bounds it: at b = 1 a matrix-vector product, bound by the HBM bytes
// of the weights, N*K*34/32 a call. The f32 FMAs (2*b*N*K) overtake the
// bytes at larger b.
//
// Design, simple first (q8_dot.cuh has the inner loop):
//  * A warp owns ROWS_PER_WARP weight rows and streams each once, 256 bytes
//    of a row a step as two coalesced 32-bit loads a lane; the activation
//    loads (two float4 a lane through the read-only cache) serve every row
//    of the warp.
//  * int8 -> f32 by a byte permute into the mantissa of 2^23 and one
//    subtraction, not by an int-to-float conversion.
//  * Each activation row keeps its own f32 accumulator (RB rows a pass: 1 at
//    decode, 8 for any larger b, so a row's sum does not depend on b); a
//    warp-shuffle reduction ends each row.
//  * Launch geometry: WARPS warps a block, ROWS_PER_WARP rows a warp, both
//    template parameters, one instance for each pair of kernels/tune.py's
//    GEOMETRIES (the C entry takes the pair). warp_dot keeps one accumulator
//    chain a row whatever the number of rows, so every pair gives the same
//    bits.
//  * Ragged edges are masked by row and by block: N = 50257 (the LM head)
//    is a multiple of nothing, and neighbouring rows are not padded.
// No tensor cores and no TMA: those designs are left to a later change.
#include "q8_dot.cuh"

namespace {

template <int WARPS, int ROWS_PER_WARP, int RB>
__global__ void __launch_bounds__(WARPS * 32)
q8_0_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ qs,
                   const __half* __restrict__ d, float* __restrict__ y,
                   int B, int N, int K) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + warp) * ROWS_PER_WARP;
  if (n0 >= N) return;  // the whole warp leaves together
  const int b0 = blockIdx.y * RB;

  const int8_t* q[ROWS_PER_WARP];
  const __half* dd[ROWS_PER_WARP];
  q8::row_ptrs(qs, d, K, N, n0, 1, q, dd);
  float acc[RB][ROWS_PER_WARP];
  q8::warp_dot<RB, ROWS_PER_WARP, q8::X_READONLY>(x + (size_t)b0 * K, (size_t)K, B - b0,
                                                  q, dd, K, lane, acc);
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int w = 0; w < ROWS_PER_WARP; ++w) {
      const float v = q8::warp_sum(acc[r][w]);
      if (lane == 0 && b0 + r < B && n0 + w < N) y[(size_t)(b0 + r) * N + n0 + w] = v;
    }
  }
}

template <int WARPS, int RPW>
void launch(const float* x, const int8_t* qs, const __half* d, float* y,
            int B, int N, int K, cudaStream_t stream) {
  constexpr int rows = WARPS * RPW;  // weight rows a block
  if (B == 1) {  // decode
    dim3 grid((N + rows - 1) / rows, 1);
    q8_0_matmul_kernel<WARPS, RPW, 1><<<grid, WARPS * 32, 0, stream>>>(x, qs, d, y, B, N, K);
  } else {  // prefill; ragged B masked
    dim3 grid((N + rows - 1) / rows, (B + 7) / 8);
    q8_0_matmul_kernel<WARPS, RPW, 8><<<grid, WARPS * 32, 0, stream>>>(x, qs, d, y, B, N, K);
  }
}

}  // namespace

// x f32 [B, K], qs int8 [N, K], d f16 [N, K/32] -> y f32 [B, N], launched
// with `warps` warps a block and `rpw` weight rows a warp: one of
// kernels/tune.py's GEOMETRIES (any other pair returns cudaErrorInvalidValue).
// K must be a multiple of 32; x and qs 16-byte aligned (the wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int q8_0_matmul(const float* x, const int8_t* qs, const __half* d,
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
