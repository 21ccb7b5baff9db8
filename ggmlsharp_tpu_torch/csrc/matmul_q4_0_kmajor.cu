// Q4_0 matrix-vector product over a K-major weight layout for Hopper (sm_90a):
//   y[b, n] = sum_k x[b, k] * d[k/32, n] * (q[k, n] - 8),  x, y f32.
//
// Replaces scripts/probe_swar.py::swar_mm (the TPU probe of a K-major
// "fewer, wider ops" Q4_0 layout). A probe: no route of the port uses it;
// probes/swar.py times it against matmul_q4_0.cu's row layout on the same
// weights.
//
// Layout (probes/swar.py::kmajor_repack): P u32 [K/8, N], word (r, n) holds
// nibbles k = 8r..8r+7 of weight row n in order (nibble t at bits 4t..4t+3);
// d f16 [K/32, N]. N must be a multiple of 4.
//
// What bounds it: at b = 1 the HBM bytes of the packed weights, N*K*18/32 a
// call, as the row kernel.
//
// Design, simple first:
//  * A thread owns 4 neighbouring weight rows; neighbouring threads take
//    neighbouring rows, so each K step is one coalesced 16-byte load a thread
//    (P[r, n..n+3]) and the scales one 8-byte load a 32-element block.
//  * x is staged in shared memory for the block's K range and broadcast (all
//    threads read the same address); no warp reduction is needed.
//  * At N = 4096 one thread per 4 rows is 8 blocks of 128 threads on 132
//    SMs, so K is split over blocks (gridDim.y): each writes its partial sums
//    to a workspace [splits, B, N], and a second pass adds the splits in a
//    fixed order (no atomics: the result is the same bits on every run).
//  * Nibbles become floats by the byte permute into 2^23's mantissa
//    (matmul_q4_0.cu's prmt step); a row's 8 products of a word are chained
//    by FMA, the scale applied once a block.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS_PER_THREAD = 4;

__device__ __forceinline__ void nibbles_minus_8(uint32_t m, float out[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    out[t] = __int_as_float(__byte_perm(m, 0x4B000000u, 0x7440 + t)) - 8388616.0f;
}

template <int RB>
__global__ void __launch_bounds__(THREADS)
kmajor_partial(const float* __restrict__ x, const uint32_t* __restrict__ P,
               const __half* __restrict__ d, float* __restrict__ part, int B, int N, int K,
               int cps) {
  extern __shared__ float xs[];  // [RB][cps * 32]
  const int nbk = K >> 5;
  const int split = blockIdx.y;
  const int b0 = blockIdx.z * RB;
  const int c0 = split * cps;
  const int c1 = min(c0 + cps, nbk);
  const int len = (c1 - c0) * 32;
  const int ld = cps * 32;
  for (int i = threadIdx.x; i < RB * len; i += THREADS) {
    const int r = i / len, e = i - r * len;
    xs[r * ld + e] = b0 + r < B ? x[(size_t)(b0 + r) * K + c0 * 32 + e] : 0.f;
  }
  __syncthreads();
  const int n = (blockIdx.x * THREADS + threadIdx.x) * ROWS_PER_THREAD;
  if (n >= N) return;

  float acc[RB][ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[r][i] = 0.f;

  for (int c = c0; c < c1; ++c) {
    const uint2 dd = __ldg(reinterpret_cast<const uint2*>(d + (size_t)c * N + n));
    float dw[ROWS_PER_THREAD];
    dw[0] = __half2float(__ushort_as_half((unsigned short)(dd.x & 0xFFFFu)));
    dw[1] = __half2float(__ushort_as_half((unsigned short)(dd.x >> 16)));
    dw[2] = __half2float(__ushort_as_half((unsigned short)(dd.y & 0xFFFFu)));
    dw[3] = __half2float(__ushort_as_half((unsigned short)(dd.y >> 16)));
    float s[RB][ROWS_PER_THREAD];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) s[r][i] = 0.f;
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {  // the block's 4 words a row
      const uint4 w4 = __ldg(reinterpret_cast<const uint4*>(P + (size_t)(c * 4 + rr) * N + n));
      const uint32_t wv[ROWS_PER_THREAD] = {w4.x, w4.y, w4.z, w4.w};
      float ev[ROWS_PER_THREAD][4], od[ROWS_PER_THREAD][4];  // nibbles 0,2,4,6 / 1,3,5,7
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) {
        nibbles_minus_8(wv[i] & 0x0F0F0F0Fu, ev[i]);
        nibbles_minus_8((wv[i] >> 4) & 0x0F0F0F0Fu, od[i]);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (b0 + r < B) {
          const float* xr = xs + r * ld + (c - c0) * 32 + rr * 8;
          const float4 xa = *reinterpret_cast<const float4*>(xr);
          const float4 xb = *reinterpret_cast<const float4*>(xr + 4);
#pragma unroll
          for (int i = 0; i < ROWS_PER_THREAD; ++i) {
            float t = fmaf(xa.x, ev[i][0], s[r][i]);
            t = fmaf(xa.y, od[i][0], t);
            t = fmaf(xa.z, ev[i][1], t);
            t = fmaf(xa.w, od[i][1], t);
            t = fmaf(xb.x, ev[i][2], t);
            t = fmaf(xb.y, od[i][2], t);
            t = fmaf(xb.z, ev[i][3], t);
            s[r][i] = fmaf(xb.w, od[i][3], t);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[r][i] = fmaf(dw[i], s[r][i], acc[r][i]);
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (b0 + r < B) {
      float* o = part + ((size_t)split * B + b0 + r) * N + n;
      *reinterpret_cast<float4*>(o) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

// y[i] = sum over splits of part[split, i], in split order
__global__ void kmajor_sum(const float* __restrict__ part, float* __restrict__ y, int splits,
                           long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = part[i];
  for (int s = 1; s < splits; ++s) v += part[(size_t)s * n + i];
  y[i] = v;
}

}  // namespace

// x f32 [B, K], P u32 [K/8, N], d f16 [K/32, N] -> y f32 [B, N]; part f32
// [splits, B, N] the workspace, splits = ceil(K/32 / cps), cps the 32-element
// blocks a split (1..32); with one split part may be y. N a multiple of 4, K
// of 32; x 4-byte, P and part 16-byte, d 8-byte aligned (the wrapper
// checks). Returns cudaGetLastError() after the launches.
extern "C" int q4_0_kmajor_matmul(const float* x, const uint32_t* P, const __half* d,
                                  float* part, float* y, int B, int N, int K, int cps,
                                  cudaStream_t stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K % 32 || N % 4 || cps < 1 || cps > 32)
    return (int)cudaErrorInvalidValue;
  const int nbk = K >> 5;
  const int splits = (nbk + cps - 1) / cps;
  const int rb = B == 1 ? 1 : 8;
  dim3 grid((N + THREADS * ROWS_PER_THREAD - 1) / (THREADS * ROWS_PER_THREAD), splits,
            (B + rb - 1) / rb);
  const size_t smem = (size_t)rb * cps * 32 * sizeof(float);
  if (B == 1)
    kmajor_partial<1><<<grid, THREADS, smem, stream>>>(x, P, d, part, B, N, K, cps);
  else
    kmajor_partial<8><<<grid, THREADS, smem, stream>>>(x, P, d, part, B, N, K, cps);
  if (splits > 1) {
    const long long n = (long long)B * N;
    kmajor_sum<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, y, splits, n);
  }
  return (int)cudaGetLastError();
}
