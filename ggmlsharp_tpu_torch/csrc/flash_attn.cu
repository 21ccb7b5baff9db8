// Cached causal flash attention for Hopper (sm_90a), f32 online softmax.
//
// Replaces ggmlsharp_tpu/kernels/flash.py::_flash_bhsd (entry
// flash_attention_cached): prompt-prefill attention of the llama main path.
//
//   q [B, Hq, S, D] f32 (new tokens), k/v [B, Hkv, T, D] f32 or bf16 (the
//   cache prefix; read as f32), npast int32 [B]  ->  out [B, Hq, S, D] f32.
//   Query s of batch b sits at absolute position npast[b] + s and sees keys
//   kidx <= npast[b] + s. Query head h reads KV head h / (Hq / Hkv) (GQA
//   without a repeated copy).
//
// The cache may be a prefix view of a longer buffer: rows of one head are
// contiguous (stride D) and heads are kv_head_stride elements apart, batch
// entries Hkv * kv_head_stride.
//
// What bounds it: at the main path's prefill (S = 16, D = 128, npast = 0)
// the work is tiny; the bytes of q, out and the K/V rows causality keeps
// (npast + S of them) bound it, and in practice the launch does. The
// design keeps scores out of device memory and skips every K tile above
// the diagonal, as the TPU kernel does.
//
// Design: one block per (b*Hq + h, tile of BQ = 8 queries), one warp per
// query. The block loops over K tiles of BK = 32 rows staged in shared memory
// as f32 (K rows padded to D + 1 floats so that lane j reading row j hits
// distinct banks). Lane j scores key j of the tile against the warp's query;
// the tile max and sum are warp shuffles; the P.V update has each lane own
// D/32 output features, broadcasting p_j with a shuffle. Fully masked rows
// end with l = 0 and are divided by 1, as the TPU kernel does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 8;   // queries (warps) a block
constexpr int BK = 32;  // keys a tile: one a lane
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int D, typename KT>
__global__ void __launch_bounds__(BQ * 32)
flash_attn_kernel(const float* __restrict__ q, const KT* __restrict__ k,
                  const KT* __restrict__ v, const int* __restrict__ npast,
                  float* __restrict__ out, int Hq, int Hkv, int S, int T,
                  long long kv_head_stride, float scale) {
  constexpr int DL = D / 32;  // output features a lane owns
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];
  __shared__ float qsh[BQ][D];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int hkv = (bh % Hq) / (Hq / Hkv);
  const int q_first = blockIdx.y * BQ;
  const int s = q_first + warp;  // this warp's query
  const int np = npast[b];

  for (int i = lane; i < D; i += 32)
    qsh[warp][i] = s < S ? q[((size_t)bh * S + s) * D + i] : 0.f;

  const size_t head = ((size_t)b * Hkv + hkv) * (size_t)kv_head_stride;
  const KT* kh = k + head;
  const KT* vh = v + head;
  const int q_last = min(q_first + BQ, S) - 1;
  const int kmax = min(T, q_last + np + 1);  // tiles past it are above the diagonal

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
      ks[jr][dd] = kv;
      vs[jr][dd] = vv;
    }
    __syncthreads();

    const int kidx = k0 + lane;
    float sc = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) sc = fmaf(qsh[warp][dd], ks[lane][dd], sc);
    sc *= scale;
    const bool valid = s < S && kidx < T && kidx <= s + np;
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
      for (int i = 0; i < DL; ++i) acc[i] = fmaf(pj, vs[jr][lane + 32 * i], acc[i]);
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

template <int D, typename KT>
void launch(const float* q, const void* k, const void* v, const int* npast,
            float* out, int B, int Hq, int Hkv, int S, int T,
            long long kv_head_stride, float scale, cudaStream_t stream) {
  dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  flash_attn_kernel<D, KT><<<grid, BQ * 32, 0, stream>>>(
      q, static_cast<const KT*>(k), static_cast<const KT*>(v), npast, out,
      Hq, Hkv, S, T, kv_head_stride, scale);
}

}  // namespace

// kv_bf16: 1 when k/v hold bf16, 0 for f32. D must be 64 or 128 and Hq a
// multiple of Hkv. Returns cudaGetLastError() after the launch.
extern "C" int flash_attn_cached(const float* q, const void* k, const void* v,
                                 const int* npast, float* out, int B, int Hq,
                                 int Hkv, int S, int T, int D,
                                 long long kv_head_stride, int kv_bf16,
                                 float scale, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  if (D == 128 && kv_bf16)
    launch<128, __nv_bfloat16>(q, k, v, npast, out, B, Hq, Hkv, S, T, kv_head_stride, scale, stream);
  else if (D == 128)
    launch<128, float>(q, k, v, npast, out, B, Hq, Hkv, S, T, kv_head_stride, scale, stream);
  else if (D == 64 && kv_bf16)
    launch<64, __nv_bfloat16>(q, k, v, npast, out, B, Hq, Hkv, S, T, kv_head_stride, scale, stream);
  else if (D == 64)
    launch<64, float>(q, k, v, npast, out, B, Hq, Hkv, S, T, kv_head_stride, scale, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
