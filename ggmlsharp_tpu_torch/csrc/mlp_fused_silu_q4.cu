// Fused SwiGLU MLP over two Q4_0 weights for Hopper (sm_90a), one launch:
//   y = (silu(x Wg^T) * (x Wu^T)) Wd^T,
//   x f32 [B, E], W1 = [Wg; Wu] [2F, E], W2 = Wd [E, F].
//
// Replaces ggmlsharp_tpu/kernels/mlp_fused.py::_call_mlp_fused_silu_q4
// (entry flash_ff_silu_q4), llama's MLP at decode- and prefill-sized row
// counts (B <= 64). The function kept from it: all three products and the
// gate in one launch; the gate and up rows and the gated product stay f32
// and are never re-quantized (the gated product is no tensor of the model).
//
// What bounds it: the HBM bytes of the two weights, 3*E*F*18/32 (76.1 MB at
// E 4096, F 11008: 22.7 us at 3.35 TB/s); the multi-row instance's products
// (one bf16 product a term for Q8_0 activations, three for the f32 gated
// product: 2*B*E*F*(1 + 3) at the dense bf16 rate) pass them near B = 44.
//
// Two instances. One activation row (decode) keeps the one-launch kernel
// below; two or more (mlp_fused_silu_q4_mma, kernels/mlp_fused.py) run on
// the tensor cores through dq_mma.cuh as a chain of launches: x into bf16
// planes (three for f32 x; one, the int8 values, for Q8_0 activations),
// the gate/up product (both halves of [Wg; Wu], K = E split
// mma_splits(2F, E) ways), merge_gate (adds the splits, pairs gate row n
// with up row F + n, silu(g) * u in f32, written as the down product's
// three exact bf16 planes), the down product (K = F split mma_splits(E, F)
// ways) and its merge. Nothing else runs between them; the gated product
// is never re-quantized.
//
// Design of the b = 1 instance. The TPU kernel walks a sequential grid and
// keeps the gate/up rows in on-chip scratch; here blocks run in parallel
// and none can hold them for the others. So the kernel is a cooperative
// launch of a persistent grid that fits the card at once:
//  * phase 1: every warp of the grid takes (gate row n and up row F + n)
//    items in turn, so both halves of an element meet in one warp, and
//    writes a[n] = silu(g) * u to a scratch a [F] f32 (it stays in L2). The
//    raw gate/up rows never leave registers;
//  * one grid-wide barrier;
//  * phase 2: W2 has few rows (E) and long ones (K = F), so a block takes an
//    item (MLP_RW rows) and its 8 warps split K, every
//    8th 512-element step each; their sums meet in shared memory in a fixed
//    order. a is read with plain loads (L1 and L2). F/32 need not be a
//    multiple of 16: the tail blocks are masked.
// The inner loop is q4_dot.cuh's. Both weights are read in the block's one
// Q4_0 copy. The grid is sized inside the C entry from the occupancy of the
// kernel times the SM count; a launch the card refuses comes back as its
// CUDA error.
//
// Tunables (-D overrides them): MLP_RW weight rows a phase-2 item;
// MLP_MAX_BLOCKS_SM resident blocks an SM (more only cost barrier time);
// MLP_NO_WORK 1 leaves the launch and the barrier.
#ifndef MLP_RW
#define MLP_RW 2
#endif
#ifndef MLP_MAX_BLOCKS_SM
#define MLP_MAX_BLOCKS_SM 4
#endif
#ifndef MLP_NO_WORK
#define MLP_NO_WORK 0
#endif
#include <cooperative_groups.h>

#include "dq_mma.cuh"
#include "q4_dot.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RW = MLP_RW;
constexpr int MAX_BLOCKS_SM = MLP_MAX_BLOCKS_SM;

struct MlpArgs {
  const float* x;
  const uint8_t* qs1;
  const __half* d1;
  const uint8_t* qs2;
  const __half* d2;
  float* a;
  float* y;
  int B, E, F;
};

// a[b, n] = silu(x[b] . Wg[n]) * (x[b] . Wu[n]) over all (n, 8-row chunk)
// items, one a warp at a time across the whole grid.
template <int RB>
__device__ __forceinline__ void phase_gate_up(const MlpArgs& m, int gwarp, int nwarps,
                                              int lane) {
  const int nbc = (m.B + RB - 1) / RB;
  const int items = MLP_NO_WORK ? 0 : m.F * nbc;
  for (int item = gwarp; item < items; item += nwarps) {
    const int n = item / nbc;
    const int b0 = (item % nbc) * RB;
    const uint8_t* q[2];
    const __half* dd[2];
    q4::row_ptrs(m.qs1, m.d1, m.E, 2 * m.F, n, m.F, q, dd);  // rows n, F + n
    float acc[RB][2];
    q4::warp_dot<RB, 2, q4::X_READONLY>(m.x + (size_t)b0 * m.E, (size_t)m.E, m.B - b0, q, dd,
                                        m.E, lane, acc);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float g = q4::warp_sum(acc[r][0]);  // every lane holds the sums
      const float u = q4::warp_sum(acc[r][1]);
      if (lane == r && b0 + r < m.B) m.a[(size_t)(b0 + r) * m.F + n] = q4::swiglu(g, u);
    }
  }
}

// y[b, n] = sum_k a[b, k] W2[n, k] over (RW rows, 8-row chunk) items, one a
// block at a time, the block's warps splitting K.
template <int RB>
__device__ __forceinline__ void phase_down(const MlpArgs& m, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nbc = (m.B + RB - 1) / RB;
  const int items = MLP_NO_WORK ? 0 : ((m.E + RW - 1) / RW) * nbc;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int n0 = (item / nbc) * RW;
    const int b0 = (item % nbc) * RB;
    const uint8_t* q[RW];
    const __half* dd[RW];
    q4::row_ptrs(m.qs2, m.d2, m.F, m.E, n0, 1, q, dd);
    float acc[RB][RW];
    q4::warp_dot<RB, RW, q4::X_PLAIN>(m.a + (size_t)b0 * m.F, (size_t)m.F, m.B - b0, q, dd,
                                      m.F, lane, acc, warp, WARPS);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int w = 0; w < RW; ++w) {
        const float v = q4::warp_sum(acc[r][w]);
        if (lane == r * RW + w) red[warp * (RB * RW) + lane] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < RB * RW) {
      const int r = threadIdx.x / RW, w = threadIdx.x % RW;
      if (b0 + r < m.B && n0 + w < m.E) {
        float v = 0.f;
#pragma unroll
        for (int i = 0; i < WARPS; ++i) v += red[i * (RB * RW) + threadIdx.x];
        m.y[(size_t)(b0 + r) * m.E + n0 + w] = v;
      }
    }
    __syncthreads();
  }
}

template <int RB>
__global__ void __launch_bounds__(THREADS) mlp_fused_silu_q4_kernel(MlpArgs m) {
  static_assert(RB * RW <= 32, "a lane a (row, weight row) sum");
  __shared__ float red[WARPS * RB * RW];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * WARPS;
  phase_gate_up<RB>(m, gwarp, nwarps, lane);
  grid.sync();
  phase_down<RB>(m, red);
}

template <int RB>
int launch(MlpArgs& m, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_fused_silu_q4_kernel<RB>,
                                                        THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > MAX_BLOCKS_SM) per_sm = MAX_BLOCKS_SM;
  void* params[] = {&m};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(mlp_fused_silu_q4_kernel<RB>),
                                    dim3(per_sm * sms), dim3(THREADS), params, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x f32 [1, E]; qs1 uint8 [2F, E/2], d1 f16 [2F, E/32] (gate rows, then up
// rows); qs2 uint8 [E, F/2], d2 f16 [E, F/32]; a f32 [1, F] scratch; y f32
// [1, E]: the b = 1 instance (any other B returns cudaErrorInvalidValue).
// E and F multiples of 32; x, a, qs1 and qs2 16-byte aligned (the wrapper
// checks). Returns the CUDA error of the cooperative launch (0: launched).
extern "C" int mlp_fused_silu_q4(const float* x, const uint8_t* qs1, const __half* d1,
                                 const uint8_t* qs2, const __half* d2, float* a, float* y,
                                 int B, int E, int F, cudaStream_t stream) {
  if (B != 1 || E <= 0 || F <= 0 || E % 32 || F % 32) return (int)cudaErrorInvalidValue;
  MlpArgs m{x, qs1, d1, qs2, d2, a, y, B, E, F};
  return launch<1>(m, stream);
}

// The multi-row instance (dq_mma.cuh), for any B (the wrappers send 2..64
// rows here): activations x f32 [B, E] (16-byte aligned), or Q8_0 (xq int8
// [B, E], 4-byte aligned, xd f16 [B, E/32]; x null); weights as for the
// b = 1 entry (4-byte aligned); y f32 [B, E]. The gate/up product's K
// splits `splits1` ways, the down product's `splits2`
// (kernels/matmul_q.py mma_splits). scratch, 16-byte aligned
// (kernels/mlp_fused.py _mlp_scratch_bytes): the gate/up pass's planes,
// sums and scales of x (as dqm::carve), its splits1 * B * 2F f32 sums, then
// the down pass's three planes and sums of the gated product and its
// splits2 * B * E f32 partial sums (splits2 > 1). Returns
// cudaGetLastError() after the launches.
extern "C" int mlp_fused_silu_q4_mma(const float* x, const int8_t* xq, const __half* xd,
                                     const uint8_t* qs1, const __half* d1, const uint8_t* qs2,
                                     const __half* d2, float* y, unsigned char* scratch, int B,
                                     int E, int F, int splits1, int splits2,
                                     cudaStream_t stream) {
  using Dec = dqm::DecLegacy<32, 8, false, false>;  // Q4_0
  const int c1 = (E + dqm::KC - 1) / dqm::KC, c2 = (F + dqm::KC - 1) / dqm::KC;
  if (B <= 0 || E <= 0 || F <= 0 || E % 32 || F % 32 || splits1 < 1 || splits1 > c1 ||
      splits2 < 1 || splits2 > c2 || scratch == nullptr || (x == nullptr) == (xq == nullptr) ||
      (xq != nullptr && xd == nullptr))
    return (int)cudaErrorInvalidValue;
  const int P1 = x != nullptr ? 3 : 1;
  const dqm::Scratch s1 = dqm::carve(scratch, P1, B, E);
  unsigned char* base2 = reinterpret_cast<unsigned char*>(s1.part + (size_t)splits1 * B * 2 * F);
  const dqm::Scratch s2 = dqm::carve(base2, 3, B, F);
  const dqm::Planes pl1{{qs1, d1, nullptr, nullptr}}, pl2{{qs2, d2, nullptr, nullptr}};
  int e = P1 == 3 ? dqm::split_acts<3>(x, xq, xd, dqm::Q8_F16_32, s1, B, E, stream)
                  : dqm::split_acts<1>(x, xq, xd, dqm::Q8_F16_32, s1, B, E, stream);
  if (e == 0)
    e = P1 == 3 ? dqm::mma_pass<Dec, 3>(s1, pl1, s1.part, B, 2 * F, E, splits1, stream)
                : dqm::mma_pass<Dec, 1>(s1, pl1, s1.part, B, 2 * F, E, splits1, stream);
  if (e == 0) {
    const size_t n4 = (size_t)B * F / 4;
    dqm::merge_gate<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(s1.part, s2.xp, s2.xsum,
                                                                       B, F, splits1);
    e = (int)cudaGetLastError();
  }
  if (e == 0)
    e = dqm::mma_pass<Dec, 3>(s2, pl2, splits2 > 1 ? s2.part : y, B, E, F, splits2, stream);
  if (e == 0 && splits2 > 1) e = dqm::merge(s2.part, y, B, E, splits2, stream);
  return e;
}
