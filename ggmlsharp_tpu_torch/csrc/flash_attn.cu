// Flash attention for Hopper (sm_90a), f32 online softmax.
//
// Replaces ggmlsharp_tpu/kernels/flash.py::_flash_bhsd, both of its entries:
//   * flash_attention_cached (cached causal GQA, per-row npast): prompt
//     prefill of the llama and GPT-2 paths, and the attention of training;
//   * flash_attention (uncached: causal or not, a static n_past, Sq != Sk):
//     the graph layer's flash_attn op.
//
//   q [B, Hq, S, D], k/v [B, Hkv, T, D]  ->  out [B, Hq, S, D] f32.
//   Query s of batch b sits at position npast[b] + s (or n_past when npast
//   is null) and, when causal, sees keys kidx <= npast + s; otherwise every
//   key. Query head h reads KV head h / (Hq / Hkv) (GQA without a repeated
//   copy). With softcap > 0 a score s becomes tanh(s / softcap) * softcap
//   before the mask. q and k/v are read in their own types (f32, bf16, f16;
//   q is f32 or the k/v type) and widened to f32 in registers.
//
// The cache may be a prefix view of a longer buffer: rows of one head are
// contiguous (stride D) and heads are kv_head_stride elements apart, batch
// entries Hkv * kv_head_stride.
//
// What bounds it: at the paths' shapes (S 16-128, D 64-128) the work is
// small; the bytes of q, out and the K/V rows causality keeps bound it, and
// in practice the launch does. The design keeps scores out of device memory
// and skips every K tile above the diagonal, as the TPU kernel does.
//
// Design: one block per (b*Hq + h, tile of BQ = 8 queries), one warp per
// query. The block loops over K tiles of BK = 32 rows staged in shared memory
// as f32 (K rows padded to D + 1 floats so that lane j reading row j hits
// distinct banks; dynamic shared memory, 74 KB at D = 256). Lane j scores key
// j of the tile against the warp's query; the tile max and sum are warp
// shuffles; the P.V update has each lane own D/32 output features,
// broadcasting p_j with a shuffle. Fully masked rows end with l = 0 and are
// divided by 1, as the TPU kernel does. Instances: D in {32, 64, 128, 256}.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 8;   // queries (warps) a block
constexpr int BK = 32;  // keys a tile: one a lane
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <int D>
constexpr int smem_bytes() { return (BK * (D + 1) + BK * D + BQ * D) * 4; }

template <int D, typename QT, typename KT>
__global__ void __launch_bounds__(BQ * 32)
flash_attn_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                  const KT* __restrict__ v, const int* __restrict__ npast,
                  int n_past, float* __restrict__ out, int Hq, int Hkv, int S,
                  int T, long long kv_head_stride, float scale, float softcap,
                  int causal) {
  constexpr int DL = D / 32;  // output features a lane owns
  extern __shared__ float smem[];
  float* ks = smem;                // [BK][D + 1]
  float* vs = ks + BK * (D + 1);   // [BK][D]
  float* qsh = vs + BK * D;        // [BQ][D]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int hkv = (bh % Hq) / (Hq / Hkv);
  const int q_first = blockIdx.y * BQ;
  const int s = q_first + warp;  // this warp's query
  const int np = npast ? npast[b] : n_past;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  for (int i = lane; i < D; i += 32)
    qsh[warp * D + i] = s < S ? to_f32(q[((size_t)bh * S + s) * D + i]) : 0.f;

  const size_t head = ((size_t)b * Hkv + hkv) * (size_t)kv_head_stride;
  const KT* kh = k + head;
  const KT* vh = v + head;
  const int q_last = min(q_first + BQ, S) - 1;
  // tiles past kmax are above the diagonal
  const int kmax = causal ? min(T, q_last + np + 1) : T;

  float m = NEG_INF, l = 0.f, acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < kmax; k0 += BK) {
    __syncthreads();  // previous tile fully read (and qsh written, first time)
    for (int idx = threadIdx.x; idx < BK * D; idx += BQ * 32) {
      const int jr = idx / D, dd = idx % D;
      const int row = k0 + jr;
      float kv = 0.f, vv = 0.f;
      if (row < T) {
        kv = to_f32(kh[(size_t)row * D + dd]);
        vv = to_f32(vh[(size_t)row * D + dd]);
      }
      ks[jr * (D + 1) + dd] = kv;
      vs[jr * D + dd] = vv;
    }
    __syncthreads();

    const int kidx = k0 + lane;
    const float* qrow = qsh + warp * D;
    const float* krow = ks + lane * (D + 1);
    float sc = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) sc = fmaf(qrow[dd], krow[dd], sc);
    sc *= scale;
    if (softcap > 0.f) sc = tanhf(sc * inv_cap) * softcap;
    const bool valid = s < S && kidx < T && (!causal || kidx <= s + np);
    sc = valid ? sc : NEG_INF;

    float mcur = sc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, off));
    const float m_new = fmaxf(m, mcur);
    const float alpha = expf(m - m_new);
    const float p = valid ? expf(sc - m_new) : 0.f;
    float psum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = alpha * l + psum;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] *= alpha;
#pragma unroll 8
    for (int jr = 0; jr < BK; ++jr) {
      const float pj = __shfl_sync(0xffffffffu, p, jr);
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] = fmaf(pj, vs[jr * D + lane + 32 * i], acc[i]);
    }
    m = m_new;
  }

  if (s < S) {
    const float safe_l = l > 0.f ? l : 1.f;
    float* o = out + ((size_t)bh * S + s) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) o[lane + 32 * i] = acc[i] / safe_l;
  }
}

template <int D, typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const int* npast,
           int n_past, float* out, int B, int Hq, int Hkv, int S, int T,
           long long kv_head_stride, int causal, float scale, float softcap,
           cudaStream_t stream) {
  auto kern = flash_attn_kernel<D, QT, KT>;
  constexpr int bytes = smem_bytes<D>();
  static bool attr_set = false;  // once an instance, before any capture
  if (bytes > 48 * 1024 && !attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  kern<<<grid, BQ * 32, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), npast, n_past, out, Hq, Hkv, S, T,
      kv_head_stride, scale, softcap, causal);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int* npast, int n_past, float* out, int B, int Hq,
               int Hkv, int S, int T, long long kv_head_stride, int causal,
               float scale, float softcap, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32, QT, KT>(q, k, v, npast, n_past, out, B, Hq, Hkv, S, T, kv_head_stride, causal, scale, softcap, stream);
    case 64: return launch<64, QT, KT>(q, k, v, npast, n_past, out, B, Hq, Hkv, S, T, kv_head_stride, causal, scale, softcap, stream);
    case 128: return launch<128, QT, KT>(q, k, v, npast, n_past, out, B, Hq, Hkv, S, T, kv_head_stride, causal, scale, softcap, stream);
    case 256: return launch<256, QT, KT>(q, k, v, npast, n_past, out, B, Hq, Hkv, S, T, kv_head_stride, causal, scale, softcap, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Element types: 0 f32, 1 bf16, 2 f16. (q_type, kv_type) is one of (0, 0),
// (0, 1), (0, 2), (1, 1), (2, 2). D is 32, 64, 128 or 256 and Hq a multiple
// of Hkv. npast: int32 [B] on the device, or null for the static n_past.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          const int* npast, int n_past, float* out, int B,
                          int Hq, int Hkv, int S, int T, int D,
                          long long kv_head_stride, int q_type, int kv_type,
                          int causal, float scale, float softcap,
                          cudaStream_t stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
#define FLASH_ARGS D, q, k, v, npast, n_past, out, B, Hq, Hkv, S, T, kv_head_stride, causal, scale, softcap, stream
  if (q_type == 0 && kv_type == 0) return dispatch_d<float, float>(FLASH_ARGS);
  if (q_type == 0 && kv_type == 1) return dispatch_d<float, __nv_bfloat16>(FLASH_ARGS);
  if (q_type == 0 && kv_type == 2) return dispatch_d<float, __half>(FLASH_ARGS);
  if (q_type == 1 && kv_type == 1) return dispatch_d<__nv_bfloat16, __nv_bfloat16>(FLASH_ARGS);
  if (q_type == 2 && kv_type == 2) return dispatch_d<__half, __half>(FLASH_ARGS);
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}
