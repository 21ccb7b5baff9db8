// Fused GELU MLP over two Q8_0 weights for Hopper (sm_90a), one launch:
//   y = gelu(x W1^T + b1) W2^T + b2,   x f32 [B, K1], W1 [N1, K1], W2 [N2, N1].
//
// Replaces ggmlsharp_tpu/kernels/mlp_fused.py::_call_mlp_fused_q8 (entry
// flash_ff_q8), GPT-2's MLP at prefill-sized row counts (B <= 64). The
// function kept from it: both products and the GELU in one launch, and
// h = gelu(...) stays f32 (it is never re-quantized and is no tensor of the
// model).
//
// What bounds it: the HBM bytes of the two weights (N1*K1 + N2*N1)*34/32 up
// to about 8 rows; beyond that the f32 FMAs, 2*B*N1*(K1 + N2).
//
// Design. The TPU kernel walks a sequential grid and keeps h in on-chip
// scratch; here blocks run in parallel and none can hold W1 or h for the
// others. So the kernel is a cooperative launch of a persistent grid that
// fits the card at once:
//  * phase 1: every warp of the grid takes (a pair of W1 rows, 8 activation
//    rows) items in turn and writes gelu(dot + b1) to a scratch h [B, N1]
//    f32 (at most 64 x 5120 x 4 B = 1.3 MB: it stays in L2);
//  * one grid-wide barrier;
//  * phase 2: W2 has few rows (N2 = E) and long ones (K = N1 = 4E), so a
//    warp a row pair would leave most of the grid idle behind 12 to 20
//    dependent steps. Here a block takes an item and its 8 warps split K,
//    every 8th 256-element step each; their sums meet in shared memory in a
//    fixed order. h is read with plain loads (L1 and L2).
// The inner loop is q8_dot.cuh's. The grid is sized inside the C entry from
// the occupancy of the kernel times the SM count; a launch the card refuses
// comes back as its CUDA error.
//
// Tunables (-D overrides them; scripts/probe_q8_kernels.py times the
// alternatives): MLP_RW weight rows a warp item; MLP_MAX_BLOCKS_SM resident
// blocks an SM (more only cost barrier time); MLP_PHASE2_KSPLIT 0 runs phase 2
// as phase 1, a warp an item; MLP_NO_WORK 1 leaves the launch and the barrier.
#ifndef MLP_RW
#define MLP_RW 2
#endif
#ifndef MLP_MAX_BLOCKS_SM
#define MLP_MAX_BLOCKS_SM 4
#endif
#ifndef MLP_PHASE2_KSPLIT
#define MLP_PHASE2_KSPLIT 1
#endif
#ifndef MLP_NO_WORK
#define MLP_NO_WORK 0
#endif
#include <cooperative_groups.h>

#include "q8_dot.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RW = MLP_RW;
constexpr int MAX_BLOCKS_SM = MLP_MAX_BLOCKS_SM;

struct MlpArgs {
  const float* x;
  const int8_t* qs1;
  const __half* d1;
  const void* b1;
  const int8_t* qs2;
  const __half* d2;
  const void* b2;
  float* h;
  float* y;
  int B, K1, N1, N2, bias_bf16;
};

// out[b, n] = act(sum_k x[b, k] W[n, k] + bias[n]) over all (row pair, 8-row
// chunk) items, one a warp at a time across the whole grid.
template <int RB, int XL, bool GELU>
__device__ __forceinline__ void phase(const float* x, int B, int K, const int8_t* qs,
                                      const __half* d, const void* bias, int bias_bf16,
                                      int N, float* out, int gwarp, int nwarps, int lane) {
  const int nbc = (B + RB - 1) / RB;
  const int items = MLP_NO_WORK ? 0 : ((N + RW - 1) / RW) * nbc;
  for (int item = gwarp; item < items; item += nwarps) {
    const int n0 = (item / nbc) * RW;
    const int b0 = (item % nbc) * RB;
    const int8_t* q[RW];
    const __half* dd[RW];
    q8::row_ptrs(qs, d, K, N, n0, 1, q, dd);
    float acc[RB][RW];
    q8::warp_dot<RB, RW, XL>(x + (size_t)b0 * K, (size_t)K, B - b0, q, dd, K, lane, acc);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int w = 0; w < RW; ++w) {
        float v = q8::warp_sum(acc[r][w]);  // every lane holds the sum
        if (lane == r * RW + w && b0 + r < B && n0 + w < N) {
          v += q8::load_vec(bias, n0 + w, bias_bf16);
          out[(size_t)(b0 + r) * N + n0 + w] = GELU ? q8::gelu(v) : v;
        }
      }
    }
  }
}

// The same items, one a block at a time, the block's warps splitting K.
template <int RB>
__device__ __forceinline__ void phase_ksplit(const float* x, int B, int K, const int8_t* qs,
                                             const __half* d, const void* bias,
                                             int bias_bf16, int N, float* out, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nbc = (B + RB - 1) / RB;
  const int items = MLP_NO_WORK ? 0 : ((N + RW - 1) / RW) * nbc;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int n0 = (item / nbc) * RW;
    const int b0 = (item % nbc) * RB;
    const int8_t* q[RW];
    const __half* dd[RW];
    q8::row_ptrs(qs, d, K, N, n0, 1, q, dd);
    float acc[RB][RW];
    q8::warp_dot<RB, RW, q8::X_PLAIN>(x + (size_t)b0 * K, (size_t)K, B - b0, q, dd, K, lane,
                                      acc, warp, WARPS);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int w = 0; w < RW; ++w) {
        const float v = q8::warp_sum(acc[r][w]);
        if (lane == r * RW + w) red[warp * (RB * RW) + lane] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < RB * RW) {
      const int r = threadIdx.x / RW, w = threadIdx.x % RW;
      if (b0 + r < B && n0 + w < N) {
        float v = 0.f;
#pragma unroll
        for (int i = 0; i < WARPS; ++i) v += red[i * (RB * RW) + threadIdx.x];
        out[(size_t)(b0 + r) * N + n0 + w] = v + q8::load_vec(bias, n0 + w, bias_bf16);
      }
    }
    __syncthreads();
  }
}

template <int RB>
__global__ void __launch_bounds__(THREADS) mlp_fused_q8_kernel(MlpArgs a) {
  __shared__ float red[WARPS * RB * RW];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * WARPS;
  phase<RB, q8::X_READONLY, true>(a.x, a.B, a.K1, a.qs1, a.d1, a.b1, a.bias_bf16, a.N1,
                                  a.h, gwarp, nwarps, lane);
  grid.sync();
  if (MLP_PHASE2_KSPLIT)
    phase_ksplit<RB>(a.h, a.B, a.N1, a.qs2, a.d2, a.b2, a.bias_bf16, a.N2, a.y, red);
  else
    phase<RB, q8::X_PLAIN, false>(a.h, a.B, a.N1, a.qs2, a.d2, a.b2, a.bias_bf16, a.N2, a.y,
                                  gwarp, nwarps, lane);
}

template <int RB>
int launch(MlpArgs& a, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_fused_q8_kernel<RB>,
                                                        THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > MAX_BLOCKS_SM) per_sm = MAX_BLOCKS_SM;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(mlp_fused_q8_kernel<RB>),
                                    dim3(per_sm * sms), dim3(THREADS), params, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x f32 [B, K1]; qs1 int8 [N1, K1], d1 f16 [N1, K1/32], b1 [N1]; qs2 int8
// [N2, N1], d2 f16 [N2, N1/32], b2 [N2]; biases f32 or bf16 (bias_bf16);
// h f32 [B, N1] scratch; y f32 [B, N2]. Returns the CUDA error of the
// cooperative launch (0: launched).
extern "C" int mlp_fused_q8(const float* x, const int8_t* qs1, const __half* d1,
                            const void* b1, const int8_t* qs2, const __half* d2,
                            const void* b2, float* h, float* y, int B, int K1, int N1,
                            int N2, int bias_bf16, cudaStream_t stream) {
  if (B <= 0 || K1 <= 0 || N1 <= 0 || N2 <= 0 || K1 % 32 || N1 % 32)
    return (int)cudaErrorInvalidValue;
  MlpArgs a{x, qs1, d1, b1, qs2, d2, b2, h, y, B, K1, N1, N2, bias_bf16};
  return B == 1 ? launch<1>(a, stream) : launch<8>(a, stream);
}
