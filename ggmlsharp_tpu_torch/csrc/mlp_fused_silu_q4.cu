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
// and none can hold them for the others. What bounds one row is the bytes
// of the weights, so both passes are dq_vec.cuh's streaming matvec (the
// Q4_0 matvec's decoder, staging and walk: a lane a 16-byte Q4_0 block,
// the activation vector copied into shared memory once a CTA at 144 bytes
// a block, a persistent grid whose warps have each step's loads issued
// before the previous step's products), in one cooperative launch (every
// CTA resident; grid from the occupancy query with its shared memory, and
// no larger than the groups of either phase fill), and the hand-off
// between the passes leaves HBM no idle stretch:
//  * phase 1: a warp group takes MLP_RW gate rows n.. and the up rows
//    F + n.. beside them (one pair: 2.7 us faster than two on an H100), so
//    silu(g) * u forms in registers. The gated product a goes to global
//    memory (L2) in the layout dq_vec.cuh's staging gives an activation
//    vector in shared memory, so that a chunk of it (1024 elements) reaches
//    a CTA as one bulk copy (TMA);
//  * no grid barrier: each chunk of a has an arrival counter in the sync
//    buffer. A warp counts its elements on a count of its CTA's in shared
//    memory (a CTA-scope release: cheap while its next loads are in
//    flight; a gpu-scope release there waits for them, 2.5 us a launch); a
//    publishing warp a CTA adds the CTA's count of a chunk to the chunk's
//    counter once it is whole, after a gpu-scope fence; a staging warp a
//    CTA requests a chunk's bulk copy once its counter is full and the
//    copy completes the chunk's mbarrier; the last CTA to see a counter
//    full sets it back to 0;
//  * phase 2: w_down's rows, MLP_RW2 a warp group, K = F, each step once
//    its chunk's mbarrier completes. Its groups go to the warps in reverse
//    order, so that the warps with fewer phase-1 groups take them and
//    start while phase 1 still streams; only the CTAs that hold them copy
//    a.
// A row's sums run in dq_vec.cuh's fixed order, so a launch's bits depend
// on no timing. A shape whose shared memory does not fit a CTA is refused
// (cudaErrorInvalidValue; the wrapper refuses it first); a launch the card
// refuses comes back as its CUDA error. (A grid barrier in place of the
// counters, with w_down's first rows prefetched into L2 before it, was 3-5
// us slower: PERF.md §6.)
//
// Tunables (-D overrides them): MLP_WARPS phase warps a CTA (registers
// allow 20 on an SM); MLP_RW (gate, up) row pairs a phase-1 group; MLP_RW2
// w_down rows a phase-2 group; MLP_NO_WORK 1 loads and multiplies no
// weight, leaving the launch, the copy of x, a's hand-off (zeros) and its
// copies.
#ifndef MLP_WARPS
#define MLP_WARPS 20
#endif
#ifndef MLP_RW
#define MLP_RW 1
#endif
#ifndef MLP_RW2
#define MLP_RW2 2
#endif
#ifndef MLP_NO_WORK
#define MLP_NO_WORK 0
#endif

#include "dq_mma.cuh"
#include "dq_vec.cuh"
#include "persist.cuh"
#include "q4_dot.cuh"

namespace {

constexpr int WARPS = MLP_WARPS;
constexpr int PAIRS = MLP_RW;
constexpr int RW2 = MLP_RW2;
constexpr int THREADS = WARPS * 32 + 64;  // and a publishing and a staging warp
constexpr int CHUNK = 32 * dqv::STEP;     // elements of a chunk of a: a phase-2 step's
constexpr int UNIT_BYTES = dqv::XU * 4;   // a 32-element block as staged
constexpr int MAX_COUNTERS = 1024;        // the sync buffer's counter words (kernels/_sync.py)
static_assert(WARPS % 4 == 0 && WARPS <= 30, "phase warps a CTA");
static_assert(CHUNK % PAIRS == 0, "a phase-1 group's elements in one chunk");
using Dec = dqv::DecLeg<32, 8, false, false>;  // Q4_0, as matmul_q4_0.cu's default
static_assert(Dec::HI16 && !Dec::M, "a is written as this decoder's staging leaves x");

struct OneRow {
  const float* x;
  dqv::Planes w1, w2;
  float* a;        // the gated product, as staged: F / 32 blocks of XU floats
  unsigned* sync;  // from [2]: a's chunk counters, then their readers' counts
  float* y;
  int E, F;
};

__host__ __device__ constexpr int chunks_of(int F) { return (F + CHUNK - 1) / CHUNK; }

// Shared-memory bytes of a launch: x's blocks, a's blocks, then for each
// of a's chunks its mbarrier and this CTA's count of its elements.
__host__ __device__ constexpr int smem_bytes(int E, int F) {
  return (E / 32 + F / 32) * UNIT_BYTES + chunks_of(F) * 16;
}

__device__ __forceinline__ void red_release_cta(unsigned* p, unsigned v) {
  asm volatile("red.release.cta.shared::cta.add.u32 [%0], %1;" ::"r"(persist::smem_addr(p)),
               "r"(v)
               : "memory");
}
__device__ __forceinline__ unsigned ld_acquire_cta(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];"
               : "=r"(v)
               : "r"(persist::smem_addr(p))
               : "memory");
  return v;
}

// Element n of the gated product where dq_vec.cuh's staging of the Q4_0
// decoder would leave it: block n / 32's 32 elements in order, XU floats a
// block, the high 16 (the high nibbles' activations) / 16 (exact).
__device__ __forceinline__ void put_staged(float* a, int n, float v) {
  const int e = n & 31;
  a[dqv::XU * (n >> 5) + e] = e < 16 ? v : v * 0.0625f;
}

// The publishing warp's lane 0: each chunk of a that this CTA's warps
// write some of, once their count in shared memory holds all of them,
// added to the chunk's counter after a gpu-scope fence (which orders the
// warps' writes, seen through that count, before it).
__device__ void publish(const OneRow& m, const unsigned* mine, int groups1, int nwarps) {
  unsigned* done = m.sync + 2;
  for (int c = 0; c < chunks_of(m.F); ++c) {
    unsigned want = 0;  // this CTA's elements of chunk c, its groups round by round
    for (int g0 = blockIdx.x * WARPS; g0 < groups1; g0 += nwarps) {
      const int lo = max(g0 * PAIRS, c * CHUNK);
      const int hi = min(min(g0 + WARPS, groups1) * PAIRS, min(m.F, (c + 1) * CHUNK));
      if (hi > lo) want += (unsigned)(hi - lo);
    }
    if (want == 0) continue;
    while (ld_acquire_cta(mine + c) != want) __nanosleep(20);
    __threadfence();
    atomicAdd(done + c, want);
  }
}

// The staging warp's lane 0, in each of the `readers` CTAs that take
// phase-2 rows: each chunk of a once its counter is full, then its bulk
// copy into shared memory, completing on full[c] (a fence first: the
// copy's reads, in the async proxy, after the writes seen through the
// counter). The last of them to see a counter full sets it and its
// readers' count back to 0, as the launch found them.
__device__ void stage(const OneRow& m, float* as, uint64_t* full, unsigned readers) {
  const int chunks = chunks_of(m.F);
  unsigned* done = m.sync + 2;
  unsigned* seen = m.sync + 2 + chunks;
  for (int c = 0; c < chunks; ++c) {
    while (persist::ld_acquire(done + c) != (unsigned)min(CHUNK, m.F - CHUNK * c))
      __nanosleep(20);
    const int u0 = 32 * c, bytes = min(32, m.F / 32 - u0) * UNIT_BYTES;
    asm volatile("fence.proxy.async.global;" ::: "memory");
    persist::mbar_arrive_tx(&full[c], (unsigned)bytes);
    persist::bulk_copy(as + dqv::XU * u0, m.a + dqv::XU * u0, (unsigned)bytes, &full[c]);
    if (atomicAdd(seen + c, 1u) == readers - 1) {  // nobody reads either again
      done[c] = 0u;
      seen[c] = 0u;
    }
  }
}

__global__ void __launch_bounds__(THREADS) silu_one_row(const __grid_constant__ OneRow m) {
  extern __shared__ __align__(16) float dyn[];
  const int ue = m.E / 32, uf = m.F / 32, chunks = chunks_of(m.F);
  float* xs = dyn;
  float* as = dyn + dqv::XU * ue;
  uint64_t* full = reinterpret_cast<uint64_t*>(dyn + dqv::XU * (ue + uf));
  unsigned* mine = reinterpret_cast<unsigned*>(full + chunks);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * WARPS, gw = blockIdx.x * WARPS + warp;
  const int groups1 = (m.F + PAIRS - 1) / PAIRS, groups2 = (m.E + RW2 - 1) / RW2;
  // phase 2's groups go to the warps in reverse order: the last `readers`
  // CTAs take them and need a
  const int readers = min((int)gridDim.x, (groups2 + WARPS - 1) / WARPS);
  if (threadIdx.x == 0) {
    for (int c = 0; c < chunks; ++c) {
      persist::mbar_init(&full[c], 1);
      mine[c] = 0u;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (warp >= WARPS) {  // x with the others, then a's chunks: published, staged
    dqv::stage_x<Dec, false>(m.x, xs, ue);
    if (warp == WARPS && lane == 0) publish(m, mine, groups1, nwarps);
    if (warp == WARPS + 1 && lane == 0 && (int)(gridDim.x - 1 - blockIdx.x) < readers)
      stage(m, as, full, (unsigned)readers);
    return;
  }

  // phase 1: a[n] = silu(x . Wg[n]) * (x . Wu[n]), PAIRS rows n a group
  // (rows past F read row F - 1 and write nothing), each group's elements
  // counted on its chunk once written
  dqv::walk<Dec, 2 * PAIRS>(
      m.w1, xs, m.E, 0, ue, MLP_NO_WORK ? 0 : groups1, gw, nwarps,
      [&](int g, int r) {
        const int n = min(g * PAIRS + r % PAIRS, m.F - 1);
        return r < PAIRS ? n : m.F + n;
      },
      [&] { dqv::stage_x<Dec, false>(m.x, xs, ue); }, [](int) {},
      [&](int g, const float (&v)[2 * PAIRS]) {
#pragma unroll
        for (int p = 0; p < PAIRS; ++p) {
          const int n = g * PAIRS + p;
          if (lane == p && n < m.F) put_staged(m.a, n, q4::swiglu(v[p], v[PAIRS + p]));
        }
        __syncwarp();
        if (lane == 0)
          red_release_cta(mine + g * PAIRS / CHUNK, (unsigned)min(PAIRS, m.F - g * PAIRS));
      });
  if (MLP_NO_WORK) {  // the groups' elements, zero, counted as phase 1 counts them
    for (int g = gw; g < groups1; g += nwarps) {
      if (lane < PAIRS && g * PAIRS + lane < m.F) put_staged(m.a, g * PAIRS + lane, 0.f);
      __syncwarp();
      if (lane == 0)
        red_release_cta(mine + g * PAIRS / CHUNK, (unsigned)min(PAIRS, m.F - g * PAIRS));
    }
  }

  // phase 2: y[n] = a . Wd[n], groups in reverse warp order, each step once
  // its chunk of a is in shared memory
  dqv::walk<Dec, RW2>(
      m.w2, as, m.F, 0, uf, MLP_NO_WORK ? 0 : groups2, nwarps - 1 - gw, nwarps,
      [&](int g, int r) { return min(g * RW2 + r, m.E - 1); }, [] {},
      [&](int c0) { persist::mbar_wait(&full[c0 / dqv::STEP], 0); },
      [&](int g, const float (&v)[RW2]) {
#pragma unroll
        for (int r = 0; r < RW2; ++r)
          if (lane == r && g * RW2 + r < m.E) m.y[g * RW2 + r] = v[r];
      });
  if (threadIdx.x == 0 && (int)(gridDim.x - 1 - blockIdx.x) < readers)
    for (int c = 0; c < chunks; ++c)  // no copy into this CTA in flight at its exit
      persist::mbar_wait(&full[c], 0);
}

int launch_one_row(OneRow& m, cudaStream_t stream) {
  const int smem = smem_bytes(m.E, m.F);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(silu_one_row, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, silu_one_row, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // no CTA without a group of either phase (a narrow shape's launch)
  const int groups = max((m.F + PAIRS - 1) / PAIRS, (m.E + RW2 - 1) / RW2);
  void* params[] = {&m};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(silu_one_row),
                                    dim3(min(per_sm * sms, (groups + WARPS - 1) / WARPS)),
                                    dim3(THREADS), params, (size_t)smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x f32 [1, E]; qs1 uint8 [2F, E/2], d1 f16 [2F, E/32] (gate rows, then up
// rows); qs2 uint8 [E, F/2], d2 f16 [E, F/32]; a f32 [F / 32 * 36] scratch
// (the gated product as staged), 16-byte aligned; y f32 [1, E]: the b = 1
// instance (any other B returns cudaErrorInvalidValue). sync uint32
// (kernels/_sync.py sync_buffer: words from 2 on counters, 0 before a
// launch and left so by it; one launch at a time a buffer). E and F
// multiples of 32, 2F E / 2 below 2^31, x, qs1 and qs2 16-byte aligned, and
// smem_bytes(E, F) within a CTA's shared memory (the wrapper checks).
// Returns the CUDA error of the cooperative launch (0: launched).
extern "C" int mlp_fused_silu_q4(const float* x, const uint8_t* qs1, const __half* d1,
                                 const uint8_t* qs2, const __half* d2, float* a, float* y,
                                 int B, int E, int F, unsigned* sync, cudaStream_t stream) {
  if (B != 1 || E <= 0 || F <= 0 || E % 32 || F % 32 || a == nullptr || sync == nullptr ||
      (long long)2 * F * (E / 2) >= (1ll << 31) || smem_bytes(E, F) > dqv::SMEM_MAX ||
      2 * chunks_of(F) > MAX_COUNTERS)
    return (int)cudaErrorInvalidValue;
  OneRow m{x, {{qs1, d1, nullptr, nullptr}}, {{qs2, d2, nullptr, nullptr}}, a, sync, y, E, F};
  return launch_one_row(m, stream);
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
