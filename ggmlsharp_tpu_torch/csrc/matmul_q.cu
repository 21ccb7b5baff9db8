// Dequant-matmul for the weight formats Q4_1, Q4_2, Q4_3, Q5_0, Q5_1, Q4_K
// and Q6_K on Hopper (sm_90a):
//   y[b, n] = sum_k x[b, k] * w[n, k],  x, y f32; w packed, one decode a format.
//
// Replaces, for those formats, ggmlsharp_tpu/kernels/matmul_q.py's three TPU
// layouts of one function: _call_kernel_swar (:377, Q4_1/4_K/5_0/5_1/6_K),
// _call_kernel_planes (:199, Q4_1/4_K) and _call_kernel (:737, every format;
// the only one that reaches Q4_2 and Q4_3). Q4_0 and Q8_0 have their own
// sources (matmul_q4_0.cu, matmul_q8_0.cu).
//
// Weights come in the port's layout (quant/formats.py): each of ggml's block
// fields in one plane, row-major, in wire order within a row:
//   Q4_1/Q4_3  qs u8 [N, K/2] (byte j of a block of B: elements j, j + B/2),
//              d, m f16 [N, K/B]; Q4_2 as Q4_1 without m; B = 32 / 16 / 16.
//   Q5_0/Q5_1  qs as Q4_1 (low 4 bits), qh i32 [N, K/32] (bit l = element
//              l's fifth bit), d (m) f16 [N, K/32].
//   Q4_K       qs u8 [N, K/2] (byte l of 64-element group g: elements
//              64g + l, 64g + 32 + l), scales u8 [N, K/256*12] (ggml's
//              6-bit packing), d, dmin f16 [N, K/256].
//   Q6_K       ql u8 [N, K/2], qh u8 [N, K/4], sc i8 [N, K/16], d f16
//              [N, K/256] (ggml's block_q6_K fields).
// w is ggml's dequantized weight, with the k-quants' sub-block scale formed
// as the JAX package's kernels read it: kd = f16(d * sc), km = f16(dmin * m)
// (one rounding of the exact product), w = q * kd - km (Q4_K), (q - 32) * kd
// (Q6_K). Those are formed from the packed scales in registers, so a Q4_K
// weight costs 4.5 bits of traffic, as on the wire.
//
// Two instances. One activation row (decode) takes the streaming
// matrix-vector product of dq_vec.cuh, one decoder a format (DecLeg for
// the legacy formats, DecQ4K, DecQ6K). What bounds it is the HBM bytes of
// the packed weights, 4.5 to 6.5 bits a weight. The first design here
// (matmul_q4_0.cu's: a 4-byte load a lane a row a step, x re-read from
// global memory, and for the k-quants every lane loading the superblock's 12
// scale bytes and d/dmin and forming four f16 products a row a step, the
// activation sum recomputed a lane a step) held Q4_K at 0.24 of that bound
// and Q6_K at 0.43, no faster than a bf16 GEMV that reads 3.6x the bytes.
// Now a lane takes 32 weights of a row by one 16-byte load (Q6_K: ql and
// qh), x and its per-block sums for the min fold sit in shared memory,
// copied once a CTA, and a Q4_K lane decodes one sub-block's (kd, km) pair,
// swapped with its neighbour by one shuffle; a persistent grid walks groups
// of rows with the next step's loads in flight. Launch geometry: WARPS warps
// a CTA, ROWS_PER_WARP rows a group, both template parameters, one instance
// for each pair of kernels/tune.py's VEC_GEOMETRIES (GEOMETRIES and 16
// warps) and each format (the C entry takes the pair; kernels/tune_h100.json
// holds the measured choice a format and shape). A row's lane sums and reduction tree depend on neither,
// so every pair gives the same bits. Two or more rows take the multi-row
// instance on the tensor cores (dq_mma.cuh, q_matmul_mma below;
// kernels/matmul_q.py MMA_MIN_ROWS), with the Q4_K and Q6_K decoders
// defined here.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dq_mma.cuh"
#include "dq_vec.cuh"

namespace {

// format ids: GType's numbering (dtypes.py)
enum Fmt : int { Q4_1 = 3, Q4_2 = 4, Q4_3 = 5, Q5_0 = 6, Q5_1 = 7, Q4_K = 14, Q6_K = 15 };

template <int F> struct Traits;
// BS: block elements; OFF: value offset; M: a min term; Q5: a qh bit plane
template <> struct Traits<Q4_1> { static constexpr int BS = 32, OFF = 0; static constexpr bool M = true, Q5 = false; };
template <> struct Traits<Q4_2> { static constexpr int BS = 16, OFF = 8; static constexpr bool M = false, Q5 = false; };
template <> struct Traits<Q4_3> { static constexpr int BS = 16, OFF = 0; static constexpr bool M = true, Q5 = false; };
template <> struct Traits<Q5_0> { static constexpr int BS = 32, OFF = 16; static constexpr bool M = false, Q5 = true; };
template <> struct Traits<Q5_1> { static constexpr int BS = 32, OFF = 0; static constexpr bool M = true, Q5 = true; };

// The b = 1 instance's decoder of format F (dq_vec.cuh); Q6_K's quant planes
// are ql and qh (16-byte loads both), the others' qs alone
template <int F> struct VecOf {
  using T = Traits<F>;
  using D = dqv::DecLeg<T::BS, T::OFF, T::M, T::Q5>;
  static constexpr int WIDE = 1;
};
template <> struct VecOf<Q4_K> { using D = dqv::DecQ4K; static constexpr int WIDE = 1; };
template <> struct VecOf<Q6_K> { using D = dqv::DecQ6K; static constexpr int WIDE = 2; };

template <int F>
int launch(const float* x, const dqv::Planes& pl, float* y, int B, int N, int K, int warps,
           int rpw, int rx, cudaStream_t stream) {
  using D = typename VecOf<F>::D;
  if (!dqv::launchable<D>(x, pl, B, N, K, VecOf<F>::WIDE)) return (int)cudaErrorInvalidValue;
  switch (warps * 16 + rpw) {
    case 4 * 16 + 1: return dqv::launch<D, 4, 1>(x, pl, y, N, K, rx, stream);
    case 4 * 16 + 2: return dqv::launch<D, 4, 2>(x, pl, y, N, K, rx, stream);
    case 4 * 16 + 4: return dqv::launch<D, 4, 4>(x, pl, y, N, K, rx, stream);
    case 8 * 16 + 1: return dqv::launch<D, 8, 1>(x, pl, y, N, K, rx, stream);
    case 8 * 16 + 2: return dqv::launch<D, 8, 2>(x, pl, y, N, K, rx, stream);
    case 8 * 16 + 4: return dqv::launch<D, 8, 4>(x, pl, y, N, K, rx, stream);
    case 16 * 16 + 1: return dqv::launch<D, 16, 1>(x, pl, y, N, K, rx, stream);
    case 16 * 16 + 2: return dqv::launch<D, 16, 2>(x, pl, y, N, K, rx, stream);
    case 16 * 16 + 4: return dqv::launch<D, 16, 4>(x, pl, y, N, K, rx, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ---- the multi-row instance's k-quant decoders (dq_mma.cuh) ----

// Q4_K: a chunk is one superblock; group gi is sub-block gi (64-element
// group gi / 2, low nibbles for even gi, high for odd): k-step ks of the
// lane reads bytes 32 (gi / 2) + 16 ks + 4t..+3. Scale and min from ggml's
// 6-bit packing (get_scale_min_k4), fused to f16 as the b = 1 instance.
// Slices: qs (32 words), scales (3), d (1), dmin (1).
struct DecQ4K {
  static constexpr int BS = 32, KALIGN = 256;
  static constexpr bool M = true;
  static constexpr int NSLICE = 4;
  __host__ __device__ static constexpr int ws(int s) { return s == 0 ? 32 : s == 1 ? 3 : 1; }
  __host__ __device__ static constexpr int off(int s) { return s == 0 ? 0 : off(s - 1) + ws(s - 1); }
  __host__ __device__ static constexpr int rw() { return dqm::row_words(off(NSLICE - 1) + ws(NSLICE - 1)); }
  __host__ __device__ static constexpr bool bulk(int s) { return s == 0; }
  __device__ static dqm::Lin lin(int s, const dqm::Planes& p, int K) {
    const uint8_t* base = static_cast<const uint8_t*>(p.p[s]);
    const int nsb = K >> 8;
    if (s == 0) return {base, K / 2, 128};
    if (s == 1) return {base, nsb * 12, 12};
    return {base, nsb * 2, 2};
  }
  __device__ static void group(const uint32_t* wr, size_t row, int c, int gi, int K, int t,
                               uint32_t w[2][2], float d[2], float m[2]) {
    const int mis = (int)(((row * (K >> 8) + c) * 2) & 3);
    const float dd = dqm::lds_h(wr + off(2), mis), dm = dqm::lds_h(wr + off(3), mis);
    // get_scale_min_k4(gi): bytes gi % 4, + 4 and + 8 of the 12
    auto byte = [&](int i) { return (int)((wr[off(1) + (i >> 2)] >> (8 * (i & 3))) & 0xFF); };
    const int a = byte(gi & 3), b = byte((gi & 3) + 4), e = byte((gi & 3) + 8);
    const int sc = gi < 4 ? a & 63 : (e & 0xF) | ((a >> 6) << 4);
    const int mn = gi < 4 ? b & 63 : (e >> 4) | ((b >> 6) << 4);
    const float kd = dqm::f16_round(dd * (float)sc), km = dqm::f16_round(dm * (float)mn);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint32_t u = wr[8 * (gi >> 1) + 4 * ks + t];
      dqm::bytes_bf16<0>((u >> (4 * (gi & 1))) & 0x0F0F0F0Fu, w[ks]);
      d[ks] = kd;
      m[ks] = -km;
    }
  }
};

// Q6_K: a chunk is one superblock; group gi holds elements 32 gi..: half
// h = gi / 4, quarter qd = gi % 4 (ggml's order: ql bytes 64h + 32 (qd % 2)
// + l, low nibbles for qd < 2, high for qd >= 2; qh bytes 32h + l, bits
// 2 qd), l = 16 ks + 4t + i. Sub-block 2 gi + ks of 16 takes scale
// f16(d * sc). Slices: ql (32 words), qh (16), sc (4), d (1).
struct DecQ6K {
  static constexpr int BS = 16, KALIGN = 256;
  static constexpr bool M = false;
  static constexpr int NSLICE = 4;
  __host__ __device__ static constexpr int ws(int s) { return s == 0 ? 32 : s == 1 ? 16 : s == 2 ? 4 : 1; }
  __host__ __device__ static constexpr int off(int s) { return s == 0 ? 0 : off(s - 1) + ws(s - 1); }
  __host__ __device__ static constexpr int rw() { return dqm::row_words(off(NSLICE - 1) + ws(NSLICE - 1)); }
  __host__ __device__ static constexpr bool bulk(int s) { return s < 2; }
  __device__ static dqm::Lin lin(int s, const dqm::Planes& p, int K) {
    const uint8_t* base = static_cast<const uint8_t*>(p.p[s]);
    if (s == 0) return {base, K / 2, 128};
    if (s == 1) return {base, K / 4, 64};
    if (s == 2) return {base, K / 16, 16};
    return {base, (K >> 8) * 2, 2};
  }
  __device__ static void group(const uint32_t* wr, size_t row, int c, int gi, int K, int t,
                               uint32_t w[2][2], float d[2], float m[2]) {
    const int h = gi >> 2, qd = gi & 3;
    const float dd = dqm::lds_h(wr + off(3), (int)(((row * (K >> 8) + c) * 2) & 3));
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint32_t u = wr[16 * h + 8 * (qd & 1) + 4 * ks + t];
      const uint32_t v = wr[off(1) + 8 * h + 4 * ks + t];
      dqm::bytes_bf16<32>(((u >> (4 * (qd >> 1))) & 0x0F0F0F0Fu) |
                              (((v >> (2 * qd)) & 0x03030303u) << 4),
                          w[ks]);
      const int sb = 2 * gi + ks;
      const int sc = (int)(int8_t)((wr[off(2) + (sb >> 2)] >> (8 * (sb & 3))) & 0xFF);
      d[ks] = dqm::f16_round(dd * (float)sc);
      m[ks] = 0.f;
    }
  }
};

template <int F>
using DecOf = dqm::DecLegacy<Traits<F>::BS, Traits<F>::OFF, Traits<F>::M, Traits<F>::Q5>;

// fmt: the weight's GType id; p0..p3 its planes in kernels/matmul_q.py's
// _PLANES order (unused ones null). x f32 [1, K], y f32 [1, N]: the b = 1
// instance (any other B returns cudaErrorInvalidValue); `warps` warps
// a CTA and `rpw` weight rows a warp group: one of kernels/tune.py's
// VEC_GEOMETRIES (any other pair returns cudaErrorInvalidValue). K must be
// a multiple of 32 (256 for the k-quants); x and the quant planes (qs; Q6_K's
// ql and qh) 16-byte aligned, the others 4-byte; N * K / 2 below 2^31 (else
// cudaErrorInvalidValue; the wrapper checks). Any such K runs: past a
// CTA's shared memory, x is taken in chunks (dq_vec.cuh). rx: x rounded to bf16 where it
// is loaded (mm_dot "bf16"). Returns cudaGetLastError() after the launches.
extern "C" int q_matmul(int fmt, const float* x, const void* p0, const void* p1,
                        const void* p2, const void* p3, float* y, int B, int N, int K,
                        int warps, int rpw, int rx, cudaStream_t stream) {
  const dqv::Planes pl{{p0, p1, p2, p3}};
#define VEC_LAUNCH(F) launch<F>(x, pl, y, B, N, K, warps, rpw, rx, stream)
  switch (fmt) {
    case Q4_1: return VEC_LAUNCH(Q4_1);
    case Q4_2: return VEC_LAUNCH(Q4_2);
    case Q4_3: return VEC_LAUNCH(Q4_3);
    case Q5_0: return VEC_LAUNCH(Q5_0);
    case Q5_1: return VEC_LAUNCH(Q5_1);
    case Q4_K: return VEC_LAUNCH(Q4_K);
    case Q6_K: return VEC_LAUNCH(Q6_K);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VEC_LAUNCH
}

// The multi-row instance (dq_mma.cuh): fmt and planes as q_matmul;
// activations x f32 [B, K], or Q8 (xq int8 [B, K], its block scales xd of
// dqm::ScaleKind `kind`; x null); y f32 [B, N] for any B (the wrappers send B >= 2 here); K a
// multiple of 32 (256 for the k-quants), split `splits` ways
// (kernels/matmul_q.py mma_splits); scratch as for q4_0_matmul_mma; rx as
// for q4_0_matmul_mma. Returns cudaGetLastError() after the launches.
extern "C" int q_matmul_mma(int fmt, const float* x, const int8_t* xq, const void* xd, int kind,
                            const void* p0, const void* p1, const void* p2, const void* p3,
                            float* y, unsigned char* scratch, int B, int N, int K, int splits,
                            int rx, cudaStream_t stream) {
  const dqm::Planes pl{{p0, p1, p2, p3}};
#define DQ_LAUNCH(D) dqm::launch<D>(x, xq, xd, kind, pl, y, scratch, B, N, K, splits, stream, rx)
  switch (fmt) {
    case Q4_1: return DQ_LAUNCH(DecOf<Q4_1>);
    case Q4_2: return DQ_LAUNCH(DecOf<Q4_2>);
    case Q4_3: return DQ_LAUNCH(DecOf<Q4_3>);
    case Q5_0: return DQ_LAUNCH(DecOf<Q5_0>);
    case Q5_1: return DQ_LAUNCH(DecOf<Q5_1>);
    case Q4_K: return DQ_LAUNCH(DecQ4K);
    case Q6_K: return DQ_LAUNCH(DecQ6K);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DQ_LAUNCH
}
