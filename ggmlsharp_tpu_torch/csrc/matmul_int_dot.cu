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
// instruction, so the integer work is far below the bytes. What kept the
// first design (32-bit loads, a block over 4 lanes, two shuffles a row a
// step, x re-read from global memory every step) at 0.29-0.43 of the bound
// was the instructions and round trips per byte, not the bytes.
//
// Design: wide loads, whole blocks a lane, activations in shared memory.
//  * A CTA first copies xq, da (and s) into shared memory, with each
//    block's off * sum xq (dp4a against 0x01010101), once.
//  * A warp takes groups of RW = 2 consecutive rows in a grid stride (the
//    grid: as many CTAs as the card holds at once, so each copies the
//    activations once); lane l takes block c0 + l of every row, a step
//    covering 32 blocks: one 16-byte load of a row's nibbles (two for
//    Q8_0), and its scale, min and fifth-bit word, each a load coalesced
//    across the warp.
//    The block's 32 activation bytes come from shared memory once for all
//    RW rows (two 16-byte loads, the odd lane quads taking the halves in
//    the other order so that no two lanes of a quarter warp share a bank).
//  * S is complete in one lane: 8 dp4a over the nibbles widened by
//    & 0x0F0F0F0F and >> 4 (Q5: the fifth bits spread in by one multiply);
//    no shuffle in the K loop, one warp reduction a row at the end.
//  * A group's first loads are issued before the previous group's
//    reduction. A warp keeps one step of its rows in flight (1 KB of 4-bit
//    rows, 2 KB of Q8_0), and the few registers that takes let enough CTAs
//    of 8 warps share an SM to keep well over the ~25 KB an SM needs at the
//    copy ceiling in flight. Measured on an H100 at the four 7B shapes
//    (PERF.md §6): two steps in flight a warp was up to 8% slower
//    (Q8_0 w_gate_up 36.1 against 33.8 us), three 3-16% slower; 4 rows a
//    group 1.1-1.9x slower for the 4- and 5-bit formats and up to 40% for
//    Q8_0, 1 row a group within 3% but for Q8_0 (1-9% faster at two steps).
//  * Ragged edges are masked: rows past N (a group's last rows read row N -
//    1 and write nothing), K/32 not a multiple of 32 (a lane past the last
//    block loads nothing and adds 0).
// No tensor cores: at one row there is nothing for them to reuse.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int RW = 2;     // rows a warp group
constexpr int NSTEP = 1;  // steps loaded before any is used
constexpr int STEP = 32;  // blocks a warp step: one a lane

// format ids: GType's numbering (dtypes.py)
enum Fmt : int { Q4_0 = 2, Q4_1 = 3, Q5_0 = 6, Q5_1 = 7, Q8_0 = 8 };

template <int F> struct Traits;
// OFF: value offset; M: a min term (Q8_1 activations); Q5: a qh bit plane
template <> struct Traits<Q8_0> { static constexpr int OFF = 0; static constexpr bool M = false, Q5 = false; };
template <> struct Traits<Q4_0> { static constexpr int OFF = 8; static constexpr bool M = false, Q5 = false; };
template <> struct Traits<Q4_1> { static constexpr int OFF = 0; static constexpr bool M = true, Q5 = false; };
template <> struct Traits<Q5_0> { static constexpr int OFF = 16; static constexpr bool M = false, Q5 = true; };
template <> struct Traits<Q5_1> { static constexpr int OFF = 0; static constexpr bool M = true, Q5 = true; };

// Bits 0..3 of h -> bit 4 of bytes 0..3: h * 0x00204081 puts bit i at bit
// 8i (the four copies do not overlap, so nothing carries).
__device__ __forceinline__ uint32_t spread4(uint32_t h) {
  return ((h * 0x00204081u) & 0x01010101u) << 4;
}

// One row's block as loaded: 16 bytes of nibbles, or Q8_0's 32 bytes.
template <int F>
struct Blk {
  int4 a, b;  // b: Q8_0's second half only
  float d, m;
  uint32_t h;
};

template <int F>
__device__ __forceinline__ void load_blk(Blk<F>& k, const void* qs, const int32_t* qh,
                                         const __half* d, const __half* m, size_t row, int nb,
                                         int K, int c, bool in) {
  using T = Traits<F>;
  k.a = make_int4(0, 0, 0, 0);
  k.b = k.a;
  k.d = k.m = 0.f;
  k.h = 0u;
  if (!in) return;
  if constexpr (F == Q8_0) {
    const int4* p = reinterpret_cast<const int4*>(static_cast<const int8_t*>(qs) + row * K +
                                                  (size_t)c * 32);
    k.a = __ldg(p);
    k.b = __ldg(p + 1);
  } else {
    k.a = __ldg(reinterpret_cast<const int4*>(static_cast<const uint8_t*>(qs) + row * (K / 2) +
                                              (size_t)c * 16));
  }
  k.d = __half2float(__ldg(d + row * nb + c));
  if constexpr (T::M) k.m = __half2float(__ldg(m + row * nb + c));
  if constexpr (T::Q5) k.h = (uint32_t)__ldg(qh + row * nb + c);
}

// S of one row's block against the block's activation words xl (elements
// 0..15) and xh (16..31).
template <int F>
__device__ __forceinline__ int block_s(const Blk<F>& k, const int4& xl, const int4& xh) {
  if constexpr (F == Q8_0) {
    int S = __dp4a(k.a.x, xl.x, 0);
    S = __dp4a(k.a.y, xl.y, S);
    S = __dp4a(k.a.z, xl.z, S);
    S = __dp4a(k.a.w, xl.w, S);
    S = __dp4a(k.b.x, xh.x, S);
    S = __dp4a(k.b.y, xh.y, S);
    S = __dp4a(k.b.z, xh.z, S);
    return __dp4a(k.b.w, xh.w, S);
  } else {
    const uint32_t u[4] = {(uint32_t)k.a.x, (uint32_t)k.a.y, (uint32_t)k.a.z, (uint32_t)k.a.w};
    const int xs_lo[4] = {xl.x, xl.y, xl.z, xl.w}, xs_hi[4] = {xh.x, xh.y, xh.z, xh.w};
    int S = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // word i: elements 4i..4i+3 and 16+4i..
      uint32_t lo = u[i] & 0x0F0F0F0Fu, hi = (u[i] >> 4) & 0x0F0F0F0Fu;
      if constexpr (Traits<F>::Q5) {
        lo |= spread4((k.h >> (4 * i)) & 0xFu);
        hi |= spread4((k.h >> (16 + 4 * i)) & 0xFu);
      }
      S = __dp4a((int)lo, xs_lo[i], S);
      S = __dp4a((int)hi, xs_hi[i], S);
    }
    return S;
  }
}

template <int F>
__global__ void __launch_bounds__(WARPS * 32)
int_dot_kernel(const int8_t* __restrict__ xq, const float* __restrict__ da,
               const float* __restrict__ xs, const void* qs, const int32_t* __restrict__ qh,
               const __half* __restrict__ d, const __half* __restrict__ m,
               float* __restrict__ y, int N, int K) {
  using T = Traits<F>;
  extern __shared__ __align__(16) unsigned char sm[];
  const int nb = K >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (N + RW - 1) / RW, gstride = gridDim.x * WARPS;
  int g = blockIdx.x * WARPS + warp;  // this warp's row group: rows g RW ..
  size_t row[RW];
  Blk<F> k[NSTEP][RW];
  bool in[NSTEP];
  auto load_steps = [&](int c0) {  // blocks c0 + lane and c0 + STEP + lane of every row
#pragma unroll
    for (int t = 0; t < NSTEP; ++t) {
      const int c = c0 + t * STEP + lane;
      in[t] = c < nb;
#pragma unroll
      for (int w = 0; w < RW; ++w) load_blk<F>(k[t][w], qs, qh, d, m, row[w], nb, K, c, in[t]);
    }
  };
  auto start_group = [&]() {  // rows past N read row N - 1 and write nothing
#pragma unroll
    for (int w = 0; w < RW; ++w) row[w] = (size_t)min(g * RW + w, N - 1);
    load_steps(0);
  };
  if (g < groups) start_group();  // weight bytes in flight before the copy below

  // xq [K] int8, then per block: da, off * sum xq (as f32: exact, |.| < 2^24), s
  int8_t* s_xq = reinterpret_cast<int8_t*>(sm);
  float* s_da = reinterpret_cast<float*>(sm + K);
  float* s_off = s_da + nb;
  float* s_s = s_off + nb;
  for (int c = threadIdx.x; c < nb; c += WARPS * 32) {
    const int4* src = reinterpret_cast<const int4*>(xq + (size_t)c * 32);
    const int4 lo = __ldg(src), hi = __ldg(src + 1);
    int4* dst = reinterpret_cast<int4*>(s_xq + (size_t)c * 32);
    dst[0] = lo;
    dst[1] = hi;
    s_da[c] = __ldg(da + c);
    if constexpr (T::OFF != 0) {
      int sq = __dp4a(lo.x, 0x01010101, 0);
      sq = __dp4a(lo.y, 0x01010101, sq);
      sq = __dp4a(lo.z, 0x01010101, sq);
      sq = __dp4a(lo.w, 0x01010101, sq);
      sq = __dp4a(hi.x, 0x01010101, sq);
      sq = __dp4a(hi.y, 0x01010101, sq);
      sq = __dp4a(hi.z, 0x01010101, sq);
      sq = __dp4a(hi.w, 0x01010101, sq);
      s_off[c] = (float)(T::OFF * sq);
    }
    if constexpr (T::M) s_s[c] = __ldg(xs + c);
  }
  __syncthreads();

  // odd lane quads load the activation halves in the other order
  const int swap = (lane >> 2) & 1;
  while (g < groups) {
    float acc[RW];
#pragma unroll
    for (int w = 0; w < RW; ++w) acc[w] = 0.f;
    for (int c0 = 0;;) {
#pragma unroll
      for (int t = 0; t < NSTEP; ++t) {
        if (!in[t]) continue;
        const int c = c0 + t * STEP + lane;
        const int4* xp = reinterpret_cast<const int4*>(s_xq + (size_t)c * 32);
        const int4 x0 = xp[swap], x1 = xp[1 - swap];
        const int4 xl = swap ? x1 : x0, xh = swap ? x0 : x1;
        const float dac = s_da[c];
        const float offc = T::OFF != 0 ? s_off[c] : 0.f;
        const float sc = T::M ? s_s[c] : 0.f;
#pragma unroll
        for (int w = 0; w < RW; ++w) {
          const int S = block_s<F>(k[t][w], xl, xh);
          acc[w] = fmaf(k[t][w].d * dac, (float)S - offc, acc[w]);
          if constexpr (T::M) acc[w] = fmaf(k[t][w].m, sc, acc[w]);
        }
      }
      c0 += NSTEP * STEP;
      if (c0 >= nb) break;
      load_steps(c0);
    }
    const int n0 = g * RW;
    g += gstride;
    if (g < groups) start_group();  // the next group's bytes before this one's sums
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      float v = acc[w];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && n0 + w < N) y[n0 + w] = v;
    }
  }
}

// CTAs a launch: enough for every row group, at most what fits on the card
// at once (the kernel walks the groups in a grid stride, the activations
// copied once a CTA).
template <int F>
int launch(const int8_t* xq, const float* da, const float* xs, const void* qs,
           const void* qh, const void* d, const void* m, float* y, int N, int K,
           cudaStream_t stream) {
  static int cached_smem = -1, fit = 0;  // CTAs the card holds at cached_smem
  const int smem = K + (K / 32) * 3 * (int)sizeof(float);
  cudaError_t err = cudaSuccess;
  if (smem != cached_smem) {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(int_dot_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int_dot_kernel<F>, WARPS * 32,
                                                          smem);
    if (err != cudaSuccess) return (int)err;
    fit = per_sm * sms;
    cached_smem = smem;
  }
  const int groups = (N + RW - 1) / RW;
  const int grid = min((groups + WARPS - 1) / WARPS, fit > 0 ? fit : 1);
  int_dot_kernel<F><<<grid, WARPS * 32, smem, stream>>>(
      xq, da, xs, qs, static_cast<const int32_t*>(qh), static_cast<const __half*>(d),
      static_cast<const __half*>(m), y, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: the weight's GType id. xq int8 [K], da f32 [K/32], xs f32 [K/32]
// (Q4_1/Q5_1, else null); qs, qh (Q5, else null), d, m (Q4_1/Q5_1, else
// null) the weight's planes; y f32 [N]. K must be a multiple of 32; xq and
// qs 16-byte aligned, every other pointer 4-byte aligned (the wrapper
// checks). Returns cudaGetLastError() after the launch.
extern "C" int int_dot_matmul(int fmt, const int8_t* xq, const float* da, const float* xs,
                              const void* qs, const void* qh, const void* d, const void* m,
                              float* y, int N, int K, cudaStream_t stream) {
  if (N <= 0 || K <= 0 || K % 32 || reinterpret_cast<uintptr_t>(xq) % 16 ||
      reinterpret_cast<uintptr_t>(qs) % 16)
    return (int)cudaErrorInvalidValue;
  switch (fmt) {
    case Q8_0: return launch<Q8_0>(xq, da, xs, qs, qh, d, m, y, N, K, stream);
    case Q4_0: return launch<Q4_0>(xq, da, xs, qs, qh, d, m, y, N, K, stream);
    case Q4_1: return launch<Q4_1>(xq, da, xs, qs, qh, d, m, y, N, K, stream);
    case Q5_0: return launch<Q5_0>(xq, da, xs, qs, qh, d, m, y, N, K, stream);
    case Q5_1: return launch<Q5_1>(xq, da, xs, qs, qh, d, m, y, N, K, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
