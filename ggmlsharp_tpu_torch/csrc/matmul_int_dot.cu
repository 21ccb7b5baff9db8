// ggml's exact quantized dot at one activation row, for Hopper (sm_90a):
//   y[n] = sum_c f32(dw[n, c]) * da[c] * (S[n, c] - off * sum_l xq[32c + l])
//          (+ sum_c f32(m[n, c]) * s[c] for Q4_1 / Q5_1),
//   S[n, c] = sum_l q[n, 32c + l] * xq[32c + l]  (int8 x int8 -> int32).
//
// Replaces ggmlsharp_tpu/kernels/matmul_q.py::_call_int_dot_kernel (:803),
// the route of GGML_TPU_INT_DOT=1: weights Q8_0, Q4_0, Q4_1, Q5_0, Q5_1;
// activations quantized once a call, in PyTorch before the launch, to Q8_0
// (xq int8 [K], da = its f16 scale as f32 [K/32]) or, for the formats with a
// min, Q8_1 (f32 da and s = da * sum xq, [K/32]). off is 8 (Q4_0), 16
// (Q5_0), 0 otherwise: the value offsets fold into the activation block
// sums, as ggml's Q8_1 trick does. S is exact in int32; the sum over blocks
// is f32, so the result differs from ggml's C dot only in f32 summation
// order.
//
// Weights come in the port's layout (quant/formats.py): qs u8 [N, K/2]
// (byte j of a block: elements j, j + 16) or, for Q8_0, int8 [N, K]; qh i32
// [N, K/32] (bit l = element l's fifth bit); d (m) f16 [N, K/32].
//
// What bounds it: a matrix-vector product, bound by the HBM bytes of the
// packed weights (N*K*(18 to 34)/32); dp4a does 4 multiply-adds an
// instruction, so the integer work is far below the bytes.
//
// Design, simple first (the dequant kernels' row layout):
//  * A warp owns ROWS_PER_WARP weight rows; a step covers 8 blocks of 32, a
//    lane 8 elements of one block (j..j+3, j+16..j+19): one 32-bit load of
//    nibbles a row (two for Q8_0) against two 32-bit loads of int8
//    activations, which serve every row of the warp.
//  * Nibbles widen to int8 by a mask (Q5 ORs bit l of qh into bit 4), then
//    two __dp4a give the lane's part of S; a shuffle across the block's 4
//    lanes completes S in int32 before any float is formed.
//  * The activation block sum (for the offset) is one more dp4a against
//    0x01010101, taken once a step for all rows.
//  * Ragged edges are masked: N not a multiple of the rows a block, K/32 not
//    a multiple of 8 (the warp stays in the loop together for the shuffles).
// No tensor cores: at one row there is nothing for them to reuse.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = 2;
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;
constexpr int BLOCKS_PER_STEP = 8;

// format ids: GType's numbering (dtypes.py)
enum Fmt : int { Q4_0 = 2, Q4_1 = 3, Q5_0 = 6, Q5_1 = 7, Q8_0 = 8 };

template <int F> struct Traits;
// OFF: value offset; M: a min term (Q8_1 activations); Q5: a qh bit plane
template <> struct Traits<Q8_0> { static constexpr int OFF = 0; static constexpr bool M = false, Q5 = false; };
template <> struct Traits<Q4_0> { static constexpr int OFF = 8; static constexpr bool M = false, Q5 = false; };
template <> struct Traits<Q4_1> { static constexpr int OFF = 0; static constexpr bool M = true, Q5 = false; };
template <> struct Traits<Q5_0> { static constexpr int OFF = 16; static constexpr bool M = false, Q5 = true; };
template <> struct Traits<Q5_1> { static constexpr int OFF = 0; static constexpr bool M = true, Q5 = true; };

// Bits 0..3 of h -> bit 4 of bytes 0..3.
__device__ __forceinline__ uint32_t spread4(uint32_t h) {
  return ((h & 1u) << 4) | ((h & 2u) << 11) | ((h & 4u) << 18) | ((h & 8u) << 25);
}

__device__ __forceinline__ int ld32(const void* p) {
  return __ldg(reinterpret_cast<const int*>(p));
}

template <int F>
__global__ void __launch_bounds__(WARPS * 32)
int_dot_kernel(const int8_t* __restrict__ xq, const float* __restrict__ da,
               const float* __restrict__ xs, const void* qs_, const int32_t* __restrict__ qh,
               const __half* __restrict__ d, const __half* __restrict__ m,
               float* __restrict__ y, int N, int K) {
  using T = Traits<F>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + warp) * ROWS_PER_WARP;
  if (n0 >= N) return;  // the whole warp leaves together
  const int nb = K >> 5;
  const int j = (lane & 3) * 4;
  const uint8_t* qs = static_cast<const uint8_t*>(qs_);

  float acc[ROWS_PER_WARP], accm[ROWS_PER_WARP];
#pragma unroll
  for (int w = 0; w < ROWS_PER_WARP; ++w) acc[w] = accm[w] = 0.f;

  for (int c0 = 0; c0 < nb; c0 += BLOCKS_PER_STEP) {
    const int c = c0 + (lane >> 2);
    const bool valid = c < nb;
    int xlo = 0, xhi = 0;
    float dac = 0.f, sc = 0.f;
    if (valid) {
      xlo = ld32(xq + c * 32 + j);
      xhi = ld32(xq + c * 32 + j + 16);
      dac = __ldg(da + c);
      if constexpr (T::M) sc = __ldg(xs + c);
    }
    int sumq = 0;
    if constexpr (T::OFF != 0) {
      sumq = __dp4a(xlo, 0x01010101, __dp4a(xhi, 0x01010101, 0));
      sumq += __shfl_xor_sync(0xffffffffu, sumq, 1);
      sumq += __shfl_xor_sync(0xffffffffu, sumq, 2);
    }
#pragma unroll
    for (int w = 0; w < ROWS_PER_WARP; ++w) {
      const bool live = valid && n0 + w < N;
      const size_t row = (size_t)(n0 + w);
      int wlo = 0, whi = 0;
      if (live) {
        if constexpr (F == Q8_0) {
          wlo = ld32(qs + row * K + c * 32 + j);
          whi = ld32(qs + row * K + c * 32 + j + 16);
        } else {
          const uint32_t u = (uint32_t)ld32(qs + row * (K / 2) + c * 16 + j);
          uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
          if constexpr (T::Q5) {
            const uint32_t h = (uint32_t)__ldg(qh + row * nb + c);
            lo |= spread4((h >> j) & 0xFu);
            hi |= spread4((h >> (j + 16)) & 0xFu);
          }
          wlo = (int)lo;
          whi = (int)hi;
        }
      }
      int S = __dp4a(wlo, xlo, __dp4a(whi, xhi, 0));
      S += __shfl_xor_sync(0xffffffffu, S, 1);
      S += __shfl_xor_sync(0xffffffffu, S, 2);
      if (live && (lane & 3) == 0) {
        const float eff = __half2float(d[row * nb + c]) * dac;
        acc[w] = fmaf(eff, (float)(S - T::OFF * sumq), acc[w]);
        if constexpr (T::M) accm[w] = fmaf(__half2float(m[row * nb + c]), sc, accm[w]);
      }
    }
  }

#pragma unroll
  for (int w = 0; w < ROWS_PER_WARP; ++w) {
    float v = acc[w], vm = accm[w];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
      vm += __shfl_xor_sync(0xffffffffu, vm, off);
    }
    if (lane == 0 && n0 + w < N) y[n0 + w] = v + vm;
  }
}

template <int F>
int launch(const int8_t* xq, const float* da, const float* xs, const void* qs,
           const void* qh, const void* d, const void* m, float* y, int N, int K,
           cudaStream_t stream) {
  const int grid = (N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  int_dot_kernel<F><<<grid, WARPS * 32, 0, stream>>>(
      xq, da, xs, qs, static_cast<const int32_t*>(qh), static_cast<const __half*>(d),
      static_cast<const __half*>(m), y, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: the weight's GType id. xq int8 [K], da f32 [K/32], xs f32 [K/32]
// (Q4_1/Q5_1, else null); qs, qh (Q5, else null), d, m (Q4_1/Q5_1, else
// null) the weight's planes; y f32 [N]. K must be a multiple of 32; every
// pointer 4-byte aligned (the wrapper checks). Returns cudaGetLastError()
// after the launch.
extern "C" int int_dot_matmul(int fmt, const int8_t* xq, const float* da, const float* xs,
                              const void* qs, const void* qh, const void* d, const void* m,
                              float* y, int N, int K, cudaStream_t stream) {
  if (N <= 0 || K <= 0 || K % 32) return (int)cudaErrorInvalidValue;
  switch (fmt) {
    case Q8_0: return launch<Q8_0>(xq, da, xs, qs, qh, d, m, y, N, K, stream);
    case Q4_0: return launch<Q4_0>(xq, da, xs, qs, qh, d, m, y, N, K, stream);
    case Q4_1: return launch<Q4_1>(xq, da, xs, qs, qh, d, m, y, N, K, stream);
    case Q5_0: return launch<Q5_0>(xq, da, xs, qs, qh, d, m, y, N, K, stream);
    case Q5_1: return launch<Q5_1>(xq, da, xs, qs, qh, d, m, y, N, K, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
