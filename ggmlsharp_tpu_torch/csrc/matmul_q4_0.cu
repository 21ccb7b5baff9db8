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
// Two instances. One activation row (decode) takes the streaming
// matrix-vector product of dq_vec.cuh, with the legacy decoder at BS 32,
// offset 8. What bounds it is the HBM bytes of the packed weights, N*K*18/32
// a call; the first design here (a block over four lanes, a 4-byte load a
// lane a step, the f16 scale loaded by four lanes, 32 bytes of f32 x re-read
// from global memory for every 4 weight bytes, a CTA of a few rows) stayed
// at 0.41 of that bound, bound by instructions and round trips. Now a lane
// takes a whole block by one 16-byte load and its scale by a load coalesced
// across the warp, x sits in shared memory (copied once a CTA in the lanes'
// order, 144 bytes a block: no bank conflict), and a persistent grid walks
// groups of rows with the next step's loads in flight (dq_vec.cuh's header
// has the whole design). Its launch geometry: WARPS warps a CTA, RPW rows
// a group, both template parameters, one instance for each pair of
// kernels/tune.py's VEC_GEOMETRIES (GEOMETRIES and 16 warps; the C entry
// takes the pair;
// kernels/tune_h100.json holds the measured choice a shape). A row's lane
// sums and reduction tree depend on neither number, so every pair gives the
// same bits. Two or more rows take the multi-row instance on the tensor
// cores (dq_mma.cuh, q4_0_matmul_mma below; kernels/matmul_q.py
// MMA_MIN_ROWS).
//
// Q4_UNPACK (-D, default 0; the multi-row instance ignores it), the
// nibble-to-number step of the b = 1 instance, a probe's variants
// (probes/dq_variants.py; counterpart of scripts/probe_dq_variants.py's
// three TPU inner loops):
//   0 prmt  (TPU variant b): a byte permute puts the nibble in the mantissa
//           of 2^23, one subtraction of 2^23 + 8 leaves q - 8 exactly (a
//           high nibble stays in place: 16 (q - 8) against x / 16);
//   1 i2f   (TPU variant c): the masked nibble through an integer-to-float
//           conversion, then - 8. Both give products of the same value, so
//           the result is prmt's bit for bit;
//   2 half2 (TPU variant a): 16-bit operands, f32 accumulation. Two nibbles
//           become one __half2 with one lop3 against the exponent of 1024
//           and one __hsub2 of 1032; the activations are rounded to f16; a
//           word's 8 products are summed in packed f16 (4 a half, __hfma2)
//           and widened to f32 once, before the scale. Its error is bounded
//           by (4 + 1) * 2^-11 * sum_k |x_k w_k|. No route of the port uses
//           it.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dq_mma.cuh"
#include "dq_vec.cuh"

#ifndef Q4_UNPACK
#define Q4_UNPACK 0
#endif

namespace {

using DecQ4_0 = dqv::DecLeg<32, 8, false, false, Q4_UNPACK>;

}  // namespace

// x f32 [1, K], qs uint8 [N, K/2], d f16 [N, K/32] -> y f32 [1, N]: the b = 1
// instance (any other B returns cudaErrorInvalidValue), launched
// with `warps` warps a CTA and `rpw` weight rows a warp group: one of
// kernels/tune.py's VEC_GEOMETRIES (any other pair returns
// cudaErrorInvalidValue).
// K must be a multiple of 32, x and qs 16-byte aligned, N * K / 2 below
// 2^31 (else cudaErrorInvalidValue; the wrapper checks). Any such K runs: past a
// CTA's shared memory, x is taken in chunks (dq_vec.cuh). rx: x rounded to
// bf16 where it is loaded (mm_dot "bf16"). Returns cudaGetLastError() after
// the launches.
extern "C" int q4_0_matmul(const float* x, const uint8_t* qs, const __half* d,
                           float* y, int B, int N, int K, int warps, int rpw, int rx,
                           cudaStream_t stream) {
  const dqv::Planes pl{{qs, d, nullptr, nullptr}};
  if (!dqv::launchable<DecQ4_0>(x, pl, B, N, K, 1)) return (int)cudaErrorInvalidValue;
  switch (warps * 16 + rpw) {
    case 4 * 16 + 1: return dqv::launch<DecQ4_0, 4, 1>(x, pl, y, N, K, rx, stream);
    case 4 * 16 + 2: return dqv::launch<DecQ4_0, 4, 2>(x, pl, y, N, K, rx, stream);
    case 4 * 16 + 4: return dqv::launch<DecQ4_0, 4, 4>(x, pl, y, N, K, rx, stream);
    case 8 * 16 + 1: return dqv::launch<DecQ4_0, 8, 1>(x, pl, y, N, K, rx, stream);
    case 8 * 16 + 2: return dqv::launch<DecQ4_0, 8, 2>(x, pl, y, N, K, rx, stream);
    case 8 * 16 + 4: return dqv::launch<DecQ4_0, 8, 4>(x, pl, y, N, K, rx, stream);
    case 16 * 16 + 1: return dqv::launch<DecQ4_0, 16, 1>(x, pl, y, N, K, rx, stream);
    case 16 * 16 + 2: return dqv::launch<DecQ4_0, 16, 2>(x, pl, y, N, K, rx, stream);
    case 16 * 16 + 4: return dqv::launch<DecQ4_0, 16, 4>(x, pl, y, N, K, rx, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The multi-row instance (dq_mma.cuh): activations x f32 [B, K], or Q8
// (xq int8 [B, K], its block scales xd of dqm::ScaleKind `kind`; x null),
// qs uint8 [N, K/2], d f16
// [N, K/32] -> y f32 [B, N], for any B (the wrappers send B >= 2 here), K
// split `splits` ways (kernels/matmul_q.py mma_splits); scratch: 16-byte
// aligned, dqm::scratch_bytes (matmul_q.py _mma_scratch_bytes). rx: f32 x
// rounded to one bf16 plane (mm_dot "bf16"), else split into three exact
// ones. Returns cudaGetLastError() after the launches.
extern "C" int q4_0_matmul_mma(const float* x, const int8_t* xq, const void* xd, int kind,
                               const uint8_t* qs, const __half* d, float* y,
                               unsigned char* scratch, int B, int N, int K, int splits, int rx,
                               cudaStream_t stream) {
  const dqm::Planes pl{{qs, d, nullptr, nullptr}};
  return dqm::launch<dqm::DecLegacy<32, 8, false, false>>(x, xq, xd, kind, pl, y, scratch, B, N,
                                                          K, splits, stream, rx);
}
