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
// Two instances. One activation row (entry mlp_fused_q8) runs the
// persistent design below; from kernels/matmul_q.py MMA_MIN_ROWS (2) rows on the
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
// The b = 1 design (gpt2_layer.cu's, cut down to its MLP). What keeps one
// activation row from the bytes' bound (5.0 MB at 124M: 1.5 us) is the
// chain of dependent steps: the launch, the first weight bytes, W1's
// products, the point where every CTA needs every other CTA's h, W2's
// products. So the kernel is a persistent grid of one CTA an SM (a
// cooperative launch: every CTA resident) with no grid barrier:
//  * CTA c of G owns rows [N c / G, N (c + 1) / G) of each weight; its
//    producer warp copies its W1 share into shared memory by TMA bulk
//    copies at entry and its W2 share once W1's has landed (W2's bytes
//    land during W1's products and the exchange instead of slowing W1's:
//    -1.2 us at 774M); the pieces and their offsets come from
//    kernels/mlp_fused.py::mlp_smem_plan (shares.cuh; one piece a share
//    where both fit, 19 + 19 KB at 124M and 53 + 53 KB at 774M, else a
//    ring of pieces);
//  * the CW consumer warps copy x into shared memory (requested before the
//    weights; rounded to bf16 under mm_dot "bf16") and the plan beside it (read there, not through
//    the constant cache, whose misses wait behind the weights' copies),
//    take W1's rows (q8_dot.cuh's smem_rows_dot) and write their rows of
//    h = gelu(x W1^T + b1) to an exchange buffer as (value, launch tag)
//    words (persist.cuh: a reader waits for exactly the words it reads, no
//    fence, no barrier);
//  * every CTA gathers all of h into shared memory as its words come in,
//    then takes W2's rows and writes y = h W2^T + b2.
// The products, not the bytes, set the time once W1 has landed: CW is 12
// or 20, which the wrapper picks for the shares' rows (mlp_smem_plan).
// The launch tag is one more than word 1 of the sync buffer (kernels/
// _sync.py), which CTA 0 stores once it has gathered h (every CTA wrote h
// after reading the tag): it comes from the device, so a CUDA graph's
// replays each take a new one, and the launches of this kernel and
// gpt2_layer.cu on one stream take turns on the same word. A launch the
// card refuses comes back as its CUDA error.
//
// Tunables of the b = 1 instance (-D overrides them; scripts/
// probe_q8_kernels.py times them at one row): MLP_RW rows a consumer unit
// (0: the plan's, 1 or 2 a piece; 1, 2 or 4 forces it); MLP_W2_LATE 0
// issues W2's copies at entry with W1's; MLP_NO_WORK 1 copies no weight
// and skips the products, leaving the launch, x and the exchange.
#ifndef MLP_RW
#define MLP_RW 0
#endif
#ifndef MLP_W2_LATE
#define MLP_W2_LATE 1
#endif
#ifndef MLP_NO_WORK
#define MLP_NO_WORK 0
#endif

#include "dq_mma.cuh"
#include "persist.cuh"
#include "q8_dot.cuh"
#include "shares.cuh"

namespace {

static_assert(MLP_RW == 0 || MLP_RW == 1 || MLP_RW == 2 || MLP_RW == 4, "rows a unit");
// The consumer warps an instance takes (kernels/mlp_fused.py _CONSUMER_WARPS)
constexpr int CW_FEW = 12, CW_MANY = 20;

struct OneRow {
  const float* x;
  const int8_t* qs[2];  // W1 [N1, K1], W2 [N2, N1]
  const __half* d[2];
  const void* bias[2];
  float* y;
  unsigned long long* xh;  // h [N1], each element with this launch's tag
  unsigned* sync;          // [1] the last launch's tag
  int K1, N1, N2, rx;
  shares::Plan plan;
};

template <bool VB>
__device__ __forceinline__ float bias_at(const void* p, int i) {
  return VB ? __uint_as_float((uint32_t)__ldg(reinterpret_cast<const uint16_t*>(p) + i) << 16)
            : __ldg(reinterpret_cast<const float*>(p) + i);
}

// CW consumer warps and a producer warp; VB: the biases are bf16 (else f32).
template <int CW, bool VB>
__global__ void __launch_bounds__(CW * 32 + 32, 1)
    mlp_one_row(const __grid_constant__ OneRow a) {
  constexpr int NC = CW * 32;  // consumer threads (the producer warp is the last)
  extern __shared__ __align__(16) unsigned char dyn[];
  using namespace shares;
  const int np = a.plan.hdr[H_N];
  float* vec = reinterpret_cast<float*>(dyn);
  float* red = reinterpret_cast<float*>(dyn + a.plan.hdr[H_RED]);
  Plan* sp = reinterpret_cast<Plan*>(dyn + a.plan.hdr[H_ATT]);  // the plan's copy
  uint64_t* full = reinterpret_cast<uint64_t*>(dyn + a.plan.hdr[H_BAR]);
  uint64_t* empty = full + np;
  unsigned char* ring = dyn + a.plan.hdr[H_RING];
  const Mat m1 = share(a.qs[0], a.d[0], a.N1, a.K1), m2 = share(a.qs[1], a.d[1], a.N2, a.N1);
  // x's first NC float4s requested before the producer's copies, which
  // they would otherwise queue behind (-0.2 us at 124M)
  float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x < NC && 4 * threadIdx.x < a.K1)
    x0 = __ldg(reinterpret_cast<const float4*>(a.x + 4 * threadIdx.x));
  init_barriers<CW>(a.plan, full, empty);
  __syncthreads();
  if (threadIdx.x >= NC) {  // the producer warp: W1's share, then W2's
    if (!MLP_NO_WORK && (threadIdx.x & 31) == 0) {
      const auto mat_of = [&](int w) { return w == 0 ? m1 : m2; };
      const int p1 = a.plan.hdr[H_FIRST + 1];
      issue(a.plan, mat_of, 0, p1, ring, full, empty);
      if (MLP_W2_LATE) persist::mbar_wait(&full[p1 - 1], 0);  // W1's last piece is in
      issue(a.plan, mat_of, p1, np, ring, full, empty);
    }
    return;
  }
  const unsigned tag = persist::launch_tag(a.sync);
  const int t = threadIdx.x;
  for (int i = t; i < H_LEN + np * PIECE_INTS; i += NC)
    reinterpret_cast<int*>(sp)[i] = reinterpret_cast<const int*>(&a.plan)[i];
  const bool r1 = t < m1.hi - m1.lo, r2 = t < m2.hi - m2.lo;
  // this CTA's rows of the biases, landing during the products
  const float bias1 = r1 ? bias_at<VB>(a.bias[0], m1.lo + t) : 0.f;
  const float bias2 = r2 ? bias_at<VB>(a.bias[1], m2.lo + t) : 0.f;
  for (int i = 4 * t; i < a.K1; i += 4 * NC) {
    float4 v = i == 4 * t ? x0 : __ldg(reinterpret_cast<const float4*>(a.x + i));
    if (a.rx) v = bf16_round4(v);  // mm_dot "bf16": x rounded where it is loaded
    *reinterpret_cast<float4*>(vec + i) = v;
  }
  persist::csync<NC>();

  // h = gelu(x W1^T + b1): this CTA's rows, to the exchange
  if (!MLP_NO_WORK) consume<CW, MLP_RW>(*sp, 0, m1, vec, ring, full, empty, red);
  persist::csync<NC>();
  if (r1)
    persist::put(a.xh + m1.lo + t,
                 q8::gelu((MLP_NO_WORK ? 0.f : row_total<CW>(*sp, 0, t, red)) + bias1), tag);

  // y = h W2^T + b2, once every CTA's h is in
  persist::gather<NC>(a.xh, a.N1, tag, vec);
  if (blockIdx.x == 0 && t == 0) persist::store_tag(a.sync, tag);  // every CTA has read it
  if (!MLP_NO_WORK) consume<CW, MLP_RW>(*sp, 1, m2, vec, ring, full, empty, red);
  persist::csync<NC>();
  if (r2) a.y[m2.lo + t] = (MLP_NO_WORK ? 0.f : row_total<CW>(*sp, 1, t, red)) + bias2;
}

}  // namespace

// x f32 [1, K1], 16-byte aligned; qs1 int8 [N1, K1], d1 f16 [N1, K1/32],
// b1 [N1]; qs2 int8 [N2, N1], d2 f16 [N2, N1/32], b2 [N2]; the four weight
// planes 16-byte aligned, N1 K1 and N2 N1 multiples of 256; biases f32 or
// bf16 (bias_bf16); y f32 [1, N2]; rx: x rounded to bf16 where it is loaded
// (mm_dot "bf16"): the b = 1 instance (any other B returns
// cudaErrorInvalidValue). xh uint64 [N1], all 0 before the first launch
// (each word a value and the tag of the launch that wrote it); sync uint32
// (kernels/_sync.py sync_buffer), its word 1 the last launch's tag, one more
// after this one (one launch at a time a pair of buffers). plan: host
// int32, kernels/mlp_fused.py::mlp_smem_plan for these widths, this card
// and `cw` consumer warps (CW_FEW or CW_MANY; gpt2_layer.cu's layout: its
// header, then 7 ints a piece; two weights). Returns the CUDA error of the
// cooperative launch (0: launched), cudaErrorInvalidValue for shapes or a
// plan it does not take.
extern "C" int mlp_fused_q8(const float* x, const int8_t* qs1, const __half* d1,
                            const void* b1, const int8_t* qs2, const __half* d2,
                            const void* b2, unsigned long long* xh, float* y, int B, int K1,
                            int N1, int N2, int bias_bf16, int rx, unsigned* sync,
                            const int* plan, int cw, cudaStream_t stream) {
  using namespace shares;
  if (B != 1 || K1 <= 0 || N1 <= 0 || N2 <= 0 || K1 % 32 || N1 % 32 || xh == nullptr ||
      sync == nullptr || plan == nullptr || (cw != CW_FEW && cw != CW_MANY))
    return (int)cudaErrorInvalidValue;
  OneRow a{};
  a.x = x;
  a.qs[0] = qs1;
  a.qs[1] = qs2;
  a.d[0] = d1;
  a.d[1] = d2;
  a.bias[0] = b1;
  a.bias[1] = b2;
  a.y = y;
  a.xh = xh;
  a.sync = sync;
  a.K1 = K1;
  a.N1 = N1;
  a.N2 = N2;
  a.rx = rx;
  for (int i = 0; i < H_LEN; ++i) a.plan.hdr[i] = plan[i];
  const int np = a.plan.hdr[H_N];
  if (np < 2 || np > MAX_PIECES || a.plan.hdr[H_FIRST] != 0 || a.plan.hdr[H_FIRST + 2] != np ||
      a.plan.hdr[H_BAR] - a.plan.hdr[H_ATT] < (int)sizeof(Plan))
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < np; ++p)
    for (int k = 0; k < PIECE_INTS; ++k) a.plan.piece[p][k] = plan[H_LEN + p * PIECE_INTS + k];
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int G = a.plan.hdr[H_G];
  if (G < 1 || G > sms || G > N1 || (N1 + G - 1) / G > 32 * cw || (N2 + G - 1) / G > 32 * cw ||
      (long long)(N1 > N2 ? N1 : N2) * G >= (1ll << 31) || (long long)N1 * K1 % 256 ||
      (long long)N2 * N1 % 256)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)a.plan.hdr[H_SMEM];
  const void* fn = cw == CW_FEW
                       ? (bias_bf16 ? (const void*)mlp_one_row<CW_FEW, true>
                                    : (const void*)mlp_one_row<CW_FEW, false>)
                       : (bias_bf16 ? (const void*)mlp_one_row<CW_MANY, true>
                                    : (const void*)mlp_one_row<CW_MANY, false>);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(G), dim3(cw * 32 + 32), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
