// Fused GELU MLP over two Q8_0 weights for Hopper (sm_90a), one launch:
//   y = gelu(x W1^T + b1) W2^T + b2,   x f32 [B, K1], W1 [N1, K1], W2 [N2, N1].
//
// Replaces ggmlsharp_tpu/kernels/mlp_fused.py::_call_mlp_fused_q8 (entry
// flash_ff_q8), GPT-2's MLP at prefill-sized row counts (B <= 64). The
// function kept from it: both products and the GELU in one launch, and
// h = gelu(...) stays f32 (it is never re-quantized and is no tensor of the
// model).
//
// What bounds it: the HBM bytes of the two weights (N1*K1 + N2*N1)*34/32
// at every row count it takes (<= 64); on the tensor cores the products
// (2*B*N1*(K1 + N2), three bf16 products a term for an f32 operand) stay
// below the bytes' time.
//
// Two instances. One activation row (entry mlp_fused_q8) runs the SIMT
// design below; from kernels/matmul_q.py MMA_MIN_ROWS (2) rows on the
// wrapper launches the multi-row instance (entry mlp_fused_q8_mma) on the tensor
// cores, two launches of matmul_q8_0.cu's single-launch routes
// (dq_mma.cuh), each with its K splits reduced in a thread-block cluster
// so that the complete sums meet in one CTA, where an epilogue finishes
// them:
//  * W1: Q8_0 activations go to the int8 tensor cores (q8_i8_kernel:
//    m16n8k32.s8, exact int32 block sums folded by d_w * d_x); f32 x is
//    split in shared memory into three exact bf16 planes, or rounded to one
//    for mm_dot "bf16" (the XF route). The epilogue writes
//    h = gelu(sum + b1), f32, to a scratch [B, N1];
//  * W2 over h: the XF route, h split into its three exact planes (h is
//    never rounded), epilogue y = sum + b2.
// A row's sums run in the same order at every B that takes the instance
// (the splits depend on the weight's shape alone).
//
// The b = 1 design. The TPU kernel walks a sequential grid and keeps h in
// on-chip scratch; here blocks run in parallel and none can hold W1 or h
// for the others. So the kernel is a cooperative launch of a persistent
// grid that fits the card at once:
//  * phase 1: every warp of the grid takes a pair of W1 rows in turn and
//    writes gelu(dot + b1) to a scratch h [1, N1] f32 (it stays in L2);
//  * one grid-wide barrier;
//  * phase 2: W2 has few rows (N2 = E) and long ones (K = N1 = 4E), so a
//    warp a row pair would leave most of the grid idle behind 12 to 20
//    dependent steps. Here a block takes a row pair and its 8 warps split K,
//    every 8th 256-element step each; their sums meet in shared memory in a
//    fixed order. h is read with plain loads (L1 and L2).
// The inner loop is q8_dot.cuh's (mm_dot "bf16": x rounded where phase 1
// loads it). The grid is sized inside the C entry from
// the occupancy of the kernel times the SM count; a launch the card refuses
// comes back as its CUDA error.
//
// Tunables of the b = 1 instance (-D overrides them; scripts/
// probe_q8_kernels.py calls the wrapper at 16 rows, which the multi-row
// instance takes, so its MLP variants no longer time them): MLP_RW weight
// rows a warp item; MLP_MAX_BLOCKS_SM resident
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

#include "dq_mma.cuh"
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
  int K1, N1, N2, bias_bf16, rx;
};

// out[n] = act(sum_k x[k] W[n, k] + bias[n]) over all row-pair items, one a
// warp at a time across the whole grid.
template <int XL, bool GELU>
__device__ __forceinline__ void phase(const float* x, int K, const int8_t* qs,
                                      const __half* d, const void* bias, int bias_bf16,
                                      int N, float* out, int gwarp, int nwarps, int lane) {
  const int items = MLP_NO_WORK ? 0 : (N + RW - 1) / RW;
  for (int item = gwarp; item < items; item += nwarps) {
    const int n0 = item * RW;
    const int8_t* q[RW];
    const __half* dd[RW];
    q8::row_ptrs(qs, d, K, N, n0, 1, q, dd);
    float acc[1][RW];
    q8::warp_dot<1, RW, XL>(x, (size_t)K, 1, q, dd, K, lane, acc);
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      float v = q8::warp_sum(acc[0][w]);  // every lane holds the sum
      if (lane == w && n0 + w < N) {
        v += q8::load_vec(bias, n0 + w, bias_bf16);
        out[n0 + w] = GELU ? q8::gelu(v) : v;
      }
    }
  }
}

// The same items, one a block at a time, the block's warps splitting K.
__device__ __forceinline__ void phase_ksplit(const float* x, int K, const int8_t* qs,
                                             const __half* d, const void* bias,
                                             int bias_bf16, int N, float* out, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int items = MLP_NO_WORK ? 0 : (N + RW - 1) / RW;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int n0 = item * RW;
    const int8_t* q[RW];
    const __half* dd[RW];
    q8::row_ptrs(qs, d, K, N, n0, 1, q, dd);
    float acc[1][RW];
    q8::warp_dot<1, RW, q8::X_PLAIN>(x, (size_t)K, 1, q, dd, K, lane, acc, warp, WARPS);
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      const float v = q8::warp_sum(acc[0][w]);
      if (lane == w) red[warp * RW + lane] = v;
    }
    __syncthreads();
    if (threadIdx.x < RW && n0 + threadIdx.x < N) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) v += red[i * RW + threadIdx.x];
      out[n0 + threadIdx.x] = v + q8::load_vec(bias, n0 + threadIdx.x, bias_bf16);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS) mlp_fused_q8_kernel(MlpArgs a) {
  __shared__ float red[WARPS * RW];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * WARPS;
  if (a.rx)  // mm_dot "bf16": x rounded where it is loaded
    phase<q8::X_READONLY_BF16, true>(a.x, a.K1, a.qs1, a.d1, a.b1, a.bias_bf16, a.N1, a.h,
                                     gwarp, nwarps, lane);
  else
    phase<q8::X_READONLY, true>(a.x, a.K1, a.qs1, a.d1, a.b1, a.bias_bf16, a.N1, a.h, gwarp,
                                nwarps, lane);
  grid.sync();
  if (MLP_PHASE2_KSPLIT)
    phase_ksplit(a.h, a.N1, a.qs2, a.d2, a.b2, a.bias_bf16, a.N2, a.y, red);
  else
    phase<q8::X_PLAIN, false>(a.h, a.N1, a.qs2, a.d2, a.b2, a.bias_bf16, a.N2, a.y, gwarp,
                              nwarps, lane);
}

int launch(MlpArgs& a, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_fused_q8_kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > MAX_BLOCKS_SM) per_sm = MAX_BLOCKS_SM;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(mlp_fused_q8_kernel),
                                    dim3(per_sm * sms), dim3(THREADS), params, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x f32 [1, K1]; qs1 int8 [N1, K1], d1 f16 [N1, K1/32], b1 [N1]; qs2 int8
// [N2, N1], d2 f16 [N2, N1/32], b2 [N2]; biases f32 or bf16 (bias_bf16);
// h f32 [1, N1] scratch; y f32 [1, N2]; rx: x rounded to bf16 where it is
// loaded (mm_dot "bf16"): the b = 1 instance (any other B returns
// cudaErrorInvalidValue). Returns the CUDA error of the cooperative launch
// (0: launched).
extern "C" int mlp_fused_q8(const float* x, const int8_t* qs1, const __half* d1,
                            const void* b1, const int8_t* qs2, const __half* d2,
                            const void* b2, float* h, float* y, int B, int K1, int N1,
                            int N2, int bias_bf16, int rx, cudaStream_t stream) {
  if (B != 1 || K1 <= 0 || N1 <= 0 || N2 <= 0 || K1 % 32 || N1 % 32)
    return (int)cudaErrorInvalidValue;
  MlpArgs a{x, qs1, d1, b1, qs2, d2, b2, h, y, K1, N1, N2, bias_bf16, rx};
  return launch(a, stream);
}

// The multi-row instance (dq_mma.cuh), for any B (the wrappers send 2..64
// rows here): activations x f32 [B, K1] (rx: rounded to one bf16 plane,
// mm_dot "bf16", else three exact ones), or Q8_0 (xq int8 [B, K1], xd f16
// [B, K1/32]; x null), 16-byte aligned; weights and biases as for the
// b = 1 entry; h f32 [B, N1] scratch and y f32 [B, N2], 16-byte aligned.
// W1's K splits `splits1` ways, W2's `splits2` (kernels/matmul_q.py
// q8_mma_splits, at most 8). Returns cudaGetLastError() after the two
// launches.
extern "C" int mlp_fused_q8_mma(const float* x, const int8_t* xq, const __half* xd,
                                const int8_t* qs1, const __half* d1, const void* b1,
                                const int8_t* qs2, const __half* d2, const void* b2, float* h,
                                float* y, int B, int K1, int N1, int N2, int bias_bf16,
                                int splits1, int splits2, int rx, cudaStream_t stream) {
  if (B <= 0 || K1 <= 0 || N1 <= 0 || N2 <= 0 || K1 % 32 || N1 % 32 ||
      (x == nullptr) == (xq == nullptr) || (xq != nullptr && xd == nullptr))
    return (int)cudaErrorInvalidValue;
  const dqm::Planes pl1{{qs1, d1, nullptr, nullptr}}, pl2{{qs2, d2, nullptr, nullptr}};
  int e = xq != nullptr
              ? dqm::launch_i8<2>(xq, xd, qs1, d1, h, B, N1, K1, splits1, stream, b1, bias_bf16)
              : dqm::launch_xf<dqm::DecQ8, 2>(x, nullptr, nullptr, pl1, h, B, N1, K1, splits1,
                                              stream, rx, b1, bias_bf16);
  if (e == 0)
    e = dqm::launch_xf<dqm::DecQ8, 1>(h, nullptr, nullptr, pl2, y, B, N2, N1, splits2, stream,
                                      0, b2, bias_bf16);
  return e;
}
