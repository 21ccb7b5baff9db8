// Probe kernels of the tuning path for Hopper (sm_90a), each beside its plain
// version in ggmlsharp_tpu_torch/probes/:
//
//  * probe_copy: a grid-stride copy with 16-byte loads and stores. Replaces
//    scripts/probe_dq_variants.py::dma_copy (a pure copy of a weight plane,
//    the TPU's bandwidth ceiling); bound by bytes (read + write), so its
//    rate on a plane no cache holds is the card's measured HBM ceiling.
//  * probe_byte_order: which source byte lands in which output position
//    under the loads and byte permutes the port's Q4 kernels use (a u32
//    __ldg at byte offset c*16 + j, then __byte_perm selector 0x7440 + t).
//    Replaces scripts/probe_swar.py::probe_bitcast_order (the TPU's
//    u32 -> int8 bitcast order). Little-endian: output 4r + b holds byte b
//    of word r.
//  * probe_f16_decode: every f16 pattern through the scale load of the
//    port's kernels (__half2float of an __ldg of the d plane). Replaces the
//    decode kernel of scripts/diag_chunked10.py (:42, the TPU's in-kernel
//    f16-pair decode over all 65,536 patterns).
//  * probe_block_map: for each element k of a row, the scale the kernels'
//    lane maps assign it (matmul_q4_0.cu, q8_dot.cuh, matmul_q.cu's legacy,
//    Q4_K and Q6_K loops; their index expressions, repeated here). Replaces
//    the repeat kernel of scripts/diag_chunked10.py (:68, pltpu.repeat's
//    tile semantics); the port's map is a block repeat (np.repeat).
// The last three are bound by nothing worth measuring; they check layouts.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(512)
copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    dst[i] = __ldg(src + i);
}

__global__ void byte_order_kernel(const uint8_t* __restrict__ src, int nwords,
                                  int* __restrict__ map, float* __restrict__ val) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nwords) return;
  // a Q4 kernel's word: block c = r / 4, first byte j = 4 * (r % 4)
  const int c = r >> 2, j = (r & 3) * 4;
  const uint32_t u = __ldg(reinterpret_cast<const uint32_t*>(src + c * 16 + j));
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint32_t f = __byte_perm(u, 0x4B000000u, 0x7440 + t);
    map[4 * r + t] = (int)(f & 0xFFu);
    val[4 * r + t] = __int_as_float(f) - 8388608.0f;  // the byte's value as a float
  }
}

__global__ void f16_decode_kernel(const __half* __restrict__ d, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __half2float(__ldg(d + i));
}

// GType ids (dtypes.py)
enum Fmt : int { Q4_0 = 2, Q4_1 = 3, Q4_2 = 4, Q4_3 = 5, Q5_0 = 6, Q5_1 = 7, Q8_0 = 8,
                 Q4_K = 14, Q6_K = 15 };

// One warp walks a row of K elements as the format's kernel does and writes,
// for each element, the scale its lane map picks from d (one a block).
__global__ void block_map_kernel(int fmt, const float* __restrict__ d, float* __restrict__ out,
                                 int K) {
  const int lane = threadIdx.x & 31;
  const int nb = K >> 5;
  if (fmt == Q8_0) {  // q8_dot.cuh::warp_dot
    const int e = (lane & 7) * 4;
    for (int c0 = 0; c0 < nb; c0 += 8) {
      const int blk0 = c0 + (lane >> 3), blk1 = blk0 + 4;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (blk0 < nb) out[blk0 * 32 + e + t] = d[blk0];
        if (blk1 < nb) out[blk1 * 32 + e + t] = d[blk1];
      }
    }
  } else if (fmt == Q4_K) {  // matmul_q.cu::q4_k_rows: sub-blocks of 32
    const int g = lane >> 3, e_lo = 64 * g + 4 * (lane & 7);
    for (int s = 0; s < (K >> 8); ++s)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        out[s * 256 + e_lo + t] = d[s * 8 + 2 * g];
        out[s * 256 + e_lo + 32 + t] = d[s * 8 + 2 * g + 1];
      }
  } else if (fmt == Q6_K) {  // matmul_q.cu::q6_k_rows: sub-blocks of 16
    const int h = lane >> 4, part = (lane >> 3) & 1, l = 4 * (lane & 7);
    const int e_lo = 128 * h + 32 * part + l;
    for (int s = 0; s < (K >> 8); ++s)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        out[s * 256 + e_lo + t] = d[s * 16 + (e_lo >> 4)];
        out[s * 256 + e_lo + 64 + t] = d[s * 16 + (e_lo >> 4) + 4];
      }
  } else {  // matmul_q4_0.cu (Q4_0) and matmul_q.cu::legacy_rows
    const int bs = (fmt == Q4_2 || fmt == Q4_3) ? 16 : 32;
    const int j = (lane & 3) * 4;
    const int sub = bs == 16 ? (j >> 3) : 0;
    const int e_lo = bs == 16 ? sub * 16 + (j & 7) : j;
    const int e_hi = e_lo + bs / 2;
    for (int c = lane >> 2; c < nb; c += 8) {
      const int blk = bs == 16 ? 2 * c + sub : c;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        out[c * 32 + e_lo + t] = d[blk];
        out[c * 32 + e_hi + t] = d[blk];
      }
    }
  }
}

}  // namespace

// src, dst: 16-byte aligned, n16 16-byte words each. Returns cudaGetLastError().
extern "C" int probe_copy(const void* src, void* dst, long long n16, cudaStream_t stream) {
  if (n16 <= 0) return (int)cudaErrorInvalidValue;
  const long long want = (n16 + 511) / 512;
  const int blocks = (int)(want < 132 * 4 ? want : 132 * 4);  // 4 blocks of 512 an SM
  copy_kernel<<<blocks, 512, 0, stream>>>(static_cast<const uint4*>(src),
                                          static_cast<uint4*>(dst), n16);
  return (int)cudaGetLastError();
}

// src: 4 * nwords bytes, 4-byte aligned; map int [4 * nwords] (the source
// byte's value), val f32 [4 * nwords] (the same through 2^23's mantissa).
extern "C" int probe_byte_order(const uint8_t* src, int nwords, int* map, float* val,
                                cudaStream_t stream) {
  if (nwords <= 0) return (int)cudaErrorInvalidValue;
  byte_order_kernel<<<(nwords + 127) / 128, 128, 0, stream>>>(src, nwords, map, val);
  return (int)cudaGetLastError();
}

// d: n f16 patterns -> out f32 [n].
extern "C" int probe_f16_decode(const __half* d, float* out, int n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  f16_decode_kernel<<<(n + 255) / 256, 256, 0, stream>>>(d, out, n);
  return (int)cudaGetLastError();
}

// fmt: a GType id; d f32 [K / block] (one value a block, 32 elements; 16 for
// Q4_2, Q4_3 and Q6_K's sub-blocks); out f32 [K]. K a multiple of 256 for
// the k-quants, of 32 otherwise.
extern "C" int probe_block_map(int fmt, const float* d, float* out, int K,
                               cudaStream_t stream) {
  const bool kq = fmt == Q4_K || fmt == Q6_K;
  const bool known = kq || fmt == Q4_0 || fmt == Q4_1 || fmt == Q4_2 || fmt == Q4_3 ||
                     fmt == Q5_0 || fmt == Q5_1 || fmt == Q8_0;
  if (!known || K <= 0 || K % (kq ? 256 : 32)) return (int)cudaErrorInvalidValue;
  block_map_kernel<<<1, 32, 0, stream>>>(fmt, d, out, K);
  return (int)cudaGetLastError();
}
