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
// of the weights, N*K*34/32 a call. The multi-row instance's products
// (2*b*N*K on the int8 tensor cores for Q8_0 activations, three bf16
// products a term for f32 x) pass the bytes near b = 310 and b = 52.
//
// Design, simple first (q8_dot.cuh has the inner loop):
//  * A warp owns ROWS_PER_WARP weight rows and streams each once, 256 bytes
//    of a row a step as two coalesced 32-bit loads a lane; the activation
//    loads (two float4 a lane through the read-only cache) serve every row
//    of the warp.
//  * int8 -> f32 by a byte permute into the mantissa of 2^23 and one
//    subtraction, not by an int-to-float conversion.
//  * The activation row keeps its own f32 accumulator (RB rows a pass, a
//    template parameter launched at 1: decode); a warp-shuffle reduction
//    ends each row.
//  * Launch geometry: WARPS warps a block, ROWS_PER_WARP rows a warp, both
//    template parameters, one instance for each pair of kernels/tune.py's
//    GEOMETRIES (the C entry takes the pair). warp_dot keeps one accumulator
//    chain a row whatever the number of rows, so every pair gives the same
//    bits.
//  * Ragged edges are masked by row and by block: N = 50257 (the LM head)
//    is a multiple of nothing, and neighbouring rows are not padded.
// No tensor cores and no TMA in this instance, which runs one activation
// row. Two or more rows take the multi-row instance on the tensor cores
// (dq_mma.cuh, q8_0_matmul_mma below; kernels/matmul_q.py MMA_MIN_ROWS):
// f32 x in three bf16 planes against DecQ8's exact bf16 weights, or Q8_0
// activations against the weight bytes on the int8 tensor cores
// (q8_i8_kernel). GPT-2's narrow shapes are latency-bound: there both
// routes take one launch (no split kernel: f32 x is split in the mma
// kernel's shared memory; the K splits reduced in a thread-block cluster,
// no merge kernel) and tiles of 64 weight rows (kernels/matmul_q.py
// q8_mma_splits).
//
// Q8_ACTS, a probe's variant (probes/q8_acts.py): 0 (the default) sends
// Q8_0 activations to q8_i8_kernel; 1 to the shared kernel's one-plane
// route read in the kernel (the XF route with P = 1: the int8 values as
// one bf16 plane against DecQ8), the same launch shape, to time the two.
#ifndef Q8_ACTS
#define Q8_ACTS 0
#endif
#include "dq_mma.cuh"
#include "q8_dot.cuh"

namespace {

template <int WARPS, int ROWS_PER_WARP, int RB, int XL>
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
  q8::warp_dot<RB, ROWS_PER_WARP, XL>(x + (size_t)b0 * K, (size_t)K, B - b0, q, dd, K, lane,
                                      acc);
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
            int B, int N, int K, int rx, cudaStream_t stream) {
  constexpr int rows = WARPS * RPW;  // weight rows a block
  dim3 grid((N + rows - 1) / rows, 1);  // decode: one activation row
  if (rx)  // mm_dot "bf16": x rounded where it is loaded
    q8_0_matmul_kernel<WARPS, RPW, 1, q8::X_READONLY_BF16><<<grid, WARPS * 32, 0, stream>>>(
        x, qs, d, y, B, N, K);
  else
    q8_0_matmul_kernel<WARPS, RPW, 1, q8::X_READONLY><<<grid, WARPS * 32, 0, stream>>>(
        x, qs, d, y, B, N, K);
}

}  // namespace

// x f32 [1, K], qs int8 [N, K], d f16 [N, K/32] -> y f32 [1, N]: the b = 1
// instance (any other B returns cudaErrorInvalidValue), launched
// with `warps` warps a block and `rpw` weight rows a warp: one of
// kernels/tune.py's GEOMETRIES (any other pair returns cudaErrorInvalidValue).
// K must be a multiple of 32; x and qs 16-byte aligned (the wrapper checks).
// rx: x rounded to bf16 where it is loaded (mm_dot "bf16"). Returns
// cudaGetLastError() after the launch.
extern "C" int q8_0_matmul(const float* x, const int8_t* qs, const __half* d,
                           float* y, int B, int N, int K, int warps, int rpw, int rx,
                           cudaStream_t stream) {
  if (B != 1 || N <= 0 || K <= 0 || K % 32) return (int)cudaErrorInvalidValue;
  switch (warps * 16 + rpw) {
    case 4 * 16 + 1: launch<4, 1>(x, qs, d, y, B, N, K, rx, stream); break;
    case 4 * 16 + 2: launch<4, 2>(x, qs, d, y, B, N, K, rx, stream); break;
    case 4 * 16 + 4: launch<4, 4>(x, qs, d, y, B, N, K, rx, stream); break;
    case 8 * 16 + 1: launch<8, 1>(x, qs, d, y, B, N, K, rx, stream); break;
    case 8 * 16 + 2: launch<8, 2>(x, qs, d, y, B, N, K, rx, stream); break;
    case 8 * 16 + 4: launch<8, 4>(x, qs, d, y, B, N, K, rx, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The multi-row instance (dq_mma.cuh), for any B (the wrappers send B >= 2
// here); qs int8 [N, K], d f16 [N, K/32] -> y f32 [B, N], K split `splits`
// ways; `rows` and the splits from kernels/matmul_q.py (_mma_plan):
//  * Q8_0 activations (xq int8 [B, K], 16-byte aligned, xd f16 [B, K/32],
//    `kind` dqm::Q8_F16_32; x null): the int8 tensor cores, rows =
//    dqm::ROWS_Q8, splits <= 8 reduced in clusters; one launch;
//  * x f32 [B, K] (16-byte aligned), rows = dqm::ROWS_Q8: split into three
//    bf16 planes in the mma kernel's shared memory, four warp groups a
//    chunk, splits <= 8 reduced in clusters; one launch;
//  * x f32, rows = dqm::ROWS (weights whose 128-row tiles alone fill the
//    card: the LM head): the shared split, mma and merge kernels; scratch
//    dqm::scratch_bytes of three planes (matmul_q.py _mma_scratch_bytes).
// rx: f32 x rounded to one bf16 plane (mm_dot "bf16") in place of the
// three (the LM head's scratch then holds one plane). Returns
// cudaGetLastError() after the launches.
extern "C" int q8_0_matmul_mma(const float* x, const int8_t* xq, const void* xd, int kind,
                               const int8_t* qs, const __half* d, float* y,
                               unsigned char* scratch, int B, int N, int K, int rows,
                               int splits, int rx, cudaStream_t stream) {
  const dqm::Planes pl{{qs, d, nullptr, nullptr}};
  if ((x == nullptr) == (xq == nullptr)) return (int)cudaErrorInvalidValue;
  if (x != nullptr && rows == dqm::ROWS)
    return dqm::launch<dqm::DecQ8>(x, nullptr, nullptr, 0, pl, y, scratch, B, N, K, splits,
                                   stream, rx);
  if (rows != dqm::ROWS_Q8) return (int)cudaErrorInvalidValue;
  if (x != nullptr)
    return dqm::launch_xf<dqm::DecQ8>(x, nullptr, nullptr, pl, y, B, N, K, splits, stream, rx);
  if (kind != dqm::Q8_F16_32) return (int)cudaErrorInvalidValue;
#if Q8_ACTS == 1
  return dqm::launch_xf<dqm::DecQ8>(nullptr, xq, static_cast<const __half*>(xd), pl, y, B, N, K,
                                    splits, stream);
#else
  return dqm::launch_i8(xq, static_cast<const __half*>(xd), qs, d, y, B, N, K, splits, stream);
#endif
}
