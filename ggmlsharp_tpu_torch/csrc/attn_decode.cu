// Batched single-token decode attention over a flat KV cache, for Hopper
// (sm_90a), f32 online softmax.
//
// Replaces ggmlsharp_tpu/kernels/attn_decode.py::_call_flash_decode, both
// lane maps: entry flash_decode_flat (layout "heads"), the attention of every
// batched decode step of the serving path, and entry flash_decode_flat_attn
// (layout "attn"), batched decode over a cache kept in the whole-block llama
// kernel's TPU row order.
//
//   q [B, Hq, D] f32 (unscaled: the kernel multiplies it by `scale`, as the
//   JAX kernel's caller pre-scales it); kn/vn [B, E] f32: the fresh
//   token's K/V rows, unquantized; kc/vc [B, T, E] (a prefix view: batch
//   entries kv_batch_stride elements apart, rows E apart; lane j of a row
//   belongs to KV head j / D), int8 or bf16; for int8, ks/vs [B, T, Hkv]
//   f32 scales a (token, head), batch entries sc_batch_stride apart;
//   npast int32 [B]  ->  out [B, Hq, D] f32.
//   Slot b's query sees the cache rows t < min(npast[b], T) (row npast[b] is stale:
//   the fresh row stands in for it) plus the fresh row, which seeds the
//   online softmax with weight exp(0). Query head h reads KV head h / n_rep
//   (GQA without a repeated copy).
//   With attn_layout set, the lanes of a row are mapped otherwise: KV head h
//   owns lanes [h D/2, (h+1) D/2) and the same run at + E/2, and q and out
//   are [B, n_rep, E] (sub-query r of every KV head in one E-wide row in
//   that same map). Only where a head's features lie changes: the loop is
//   the same.
//
// What bounds it: bytes. Each live K/V element is read once and used for
// 2 * n_rep FMAs; at B = 8, T = 2048, E = 4096 int8 that is 134 MB a call
// (40 us at 3.35 TB/s) against 1.1 GFLOP of f32 work.
//
// Design, simple first: one block a (KV head, slot). Its warps are n_rep
// query rows times NS splits of the key range (NS = 4 / n_rep, at least 1,
// so a block has at least 4 warps to keep loads in flight). A step stages
// NS * 32 rows of K and V in shared memory as f32, dequantized on the way
// for int8 (16-byte loads; rows padded to D + 1 floats so that lane j
// reading row j, and the staging stores, hit distinct banks); the warp of
// (row r, split s) then scores keys s*32 .. s*32+31 of the tile, one key a
// lane, takes the tile max and sum with warp shuffles and updates its D/32
// output features a lane, broadcasting p_j with a shuffle. At the end the
// NS partial softmax states of a row merge in shared memory. Split-K over T
// across blocks (long prefixes at small B) and tensor cores are left to a
// later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// Where feature i of KV head h lies in a row of E lanes.
__device__ __forceinline__ int lane_of(int h, int i, int D, int E, int attn_layout) {
  if (!attn_layout) return h * D + i;
  const int half = D >> 1;
  return i < half ? h * half + i : (E >> 1) + h * half + i - half;
}

// 16 bytes of a row -> VEC floats.
__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  const int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = (float)(int8_t)(w[i / 4] >> (8 * (i % 4)));
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int D, typename KT>
__global__ void attn_decode_kernel(const float* __restrict__ q,
                                   const float* __restrict__ kn,
                                   const float* __restrict__ vn,
                                   const KT* __restrict__ kc,
                                   const KT* __restrict__ vc,
                                   const float* __restrict__ ks,
                                   const float* __restrict__ vs,
                                   const int* __restrict__ npast,
                                   float* __restrict__ out, int Hkv, int n_rep,
                                   int T, long long kv_batch_stride,
                                   long long sc_batch_stride, float scale,
                                   int attn_layout) {
  constexpr int DL = D / 32;              // output features a lane owns
  constexpr int VEC = 16 / sizeof(KT);    // elements a 16-byte load
  constexpr int CH = D / VEC;             // 16-byte chunks a head row
  const int nwarps = blockDim.x >> 5;
  const int ns = nwarps / n_rep;          // splits of the key range
  const int kt = ns * 32;                 // rows a staged tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp % n_rep, split = warp / n_rep;
  const int hkv = blockIdx.x, b = blockIdx.y;
  const int hq = hkv * n_rep + r;
  const int E = Hkv * D;
  const int live = min(npast[b], T);      // cache rows this slot attends

  extern __shared__ float smem[];
  float* ksh = smem;                      // [kt][D + 1]
  float* vsh = ksh + kt * (D + 1);        // [kt][D + 1]
  float* qsh = vsh + kt * (D + 1);        // [n_rep][D]
  float* msh = qsh + n_rep * D;           // [nwarps] merge: m, l
  float* lsh = msh + nwarps;
  float* ash = lsh + nwarps;              // [nwarps][D] merge: acc

  // feature i of this query row (and of its output row)
  auto q_at = [&](int i) -> size_t {
    return attn_layout ? ((size_t)b * n_rep + r) * E + lane_of(hkv, i, D, E, 1)
                       : ((size_t)b * Hkv * n_rep + hq) * D + i;
  };
  for (int i = lane; i < D; i += 32) qsh[r * D + i] = q[q_at(i)] * scale;
  __syncwarp();

  // The fresh row seeds split 0's state: m = its score, l = 1, acc = v.
  float m = NEG_INF, l = 0.f, acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;
  if (split == 0) {
    const float* knr = kn + (size_t)b * E;
    const float* vnr = vn + (size_t)b * E;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      s = fmaf(qsh[r * D + lane + 32 * i],
               knr[lane_of(hkv, lane + 32 * i, D, E, attn_layout)], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    m = s;
    l = 1.f;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      acc[i] = vnr[lane_of(hkv, lane + 32 * i, D, E, attn_layout)];
  }

  const KT* kb = kc + (size_t)b * kv_batch_stride;
  const KT* vb = vc + (size_t)b * kv_batch_stride;
  const float* ksb = ks ? ks + (size_t)b * sc_batch_stride + hkv : nullptr;
  const float* vsb = vs ? vs + (size_t)b * sc_batch_stride + hkv : nullptr;

  for (int t0 = 0; t0 < live; t0 += kt) {
    __syncthreads();  // the previous tile is fully read
    // consecutive threads take consecutive rows: with rows padded to D + 1
    // floats the shared-memory stores of a warp hit distinct banks
    for (int idx = threadIdx.x; idx < kt * CH; idx += blockDim.x) {
      const int jr = idx % kt, c = (idx / kt) * VEC;
      const int row = t0 + jr;
      float kv[VEC], vv[VEC];
      if (row < live) {
        // a 16-byte chunk never straddles the two halves (VEC divides D/2)
        const size_t at = (size_t)row * E + lane_of(hkv, c, D, E, attn_layout);
        load16(kb + at, kv);
        load16(vb + at, vv);
        if (ksb) {
          const float sk = ksb[(size_t)row * Hkv], sv = vsb[(size_t)row * Hkv];
#pragma unroll
          for (int i = 0; i < VEC; ++i) { kv[i] *= sk; vv[i] *= sv; }
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) { kv[i] = 0.f; vv[i] = 0.f; }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        ksh[jr * (D + 1) + c + i] = kv[i];
        vsh[jr * (D + 1) + c + i] = vv[i];
      }
    }
    __syncthreads();

    const int j0 = split * 32;  // this warp's keys in the tile
    const int kidx = t0 + j0 + lane;
    const bool valid = kidx < live;
    float sc = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) sc = fmaf(qsh[r * D + dd], ksh[(j0 + lane) * (D + 1) + dd], sc);
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
    for (int jr = 0; jr < 32; ++jr) {
      const float pj = __shfl_sync(0xffffffffu, p, jr);
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] = fmaf(pj, vsh[(j0 + jr) * (D + 1) + lane + 32 * i], acc[i]);
    }
    m = m_new;
  }

  // Merge the splits of each query row; split 0 writes the row.
  if (lane == 0) { msh[warp] = m; lsh[warp] = l; }
#pragma unroll
  for (int i = 0; i < DL; ++i) ash[warp * D + lane + 32 * i] = acc[i];
  __syncthreads();
  if (split == 0) {
    float mm = NEG_INF;
    for (int s = 0; s < ns; ++s) mm = fmaxf(mm, msh[s * n_rep + r]);
    float ll = 0.f, o[DL];
#pragma unroll
    for (int i = 0; i < DL; ++i) o[i] = 0.f;
    for (int s = 0; s < ns; ++s) {
      const int w = s * n_rep + r;
      const float f = expf(msh[w] - mm);
      ll = fmaf(lsh[w], f, ll);
#pragma unroll
      for (int i = 0; i < DL; ++i) o[i] = fmaf(ash[w * D + lane + 32 * i], f, o[i]);
    }
#pragma unroll
    for (int i = 0; i < DL; ++i) out[q_at(lane + 32 * i)] = o[i] / ll;
  }
}

template <int D, typename KT>
int launch(const float* q, const float* kn, const float* vn, const void* kc,
           const void* vc, const float* ks, const float* vs, const int* npast,
           float* out, int B, int Hkv, int n_rep, int T,
           long long kv_batch_stride, long long sc_batch_stride, float scale,
           int attn_layout, cudaStream_t stream) {
  const int ns = n_rep >= 4 ? 1 : 4 / n_rep;
  const int nwarps = n_rep * ns, kt = ns * 32;
  const size_t smem = sizeof(float) *
      (2 * (size_t)kt * (D + 1) + (size_t)n_rep * D +
       2 * (size_t)nwarps + (size_t)nwarps * D);
  auto kern = attn_decode_kernel<D, KT>;
  static size_t smem_set = 48 * 1024;  // opt in once per instantiation
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid(Hkv, B);
  kern<<<grid, nwarps * 32, smem, stream>>>(
      q, kn, vn, static_cast<const KT*>(kc), static_cast<const KT*>(vc), ks,
      vs, npast, out, Hkv, n_rep, T, kv_batch_stride, sc_batch_stride, scale, attn_layout);
  return (int)cudaGetLastError();
}

template <typename KT>
int launch_d(int D, const float* q, const float* kn, const float* vn,
             const void* kc, const void* vc, const float* ks, const float* vs,
             const int* npast, float* out, int B, int Hkv, int n_rep, int T,
             long long kvs, long long scs, float scale, int attn_layout,
             cudaStream_t stream) {
  if (D == 128)
    return launch<128, KT>(q, kn, vn, kc, vc, ks, vs, npast, out, B, Hkv, n_rep, T, kvs, scs,
                           scale, attn_layout, stream);
  if (D == 64)
    return launch<64, KT>(q, kn, vn, kc, vc, ks, vs, npast, out, B, Hkv, n_rep, T, kvs, scs,
                          scale, attn_layout, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// kv_kind: 0 bf16, 1 int8 (then ks/vs are required). attn_layout: 0 the
// "heads" lane map, 1 the "attn" one (float caches only). D must be 64 or
// 128 and n_rep in 1..32. Pointers 16-byte aligned and batch strides
// multiples of 16 bytes (the wrapper checks). Returns the first CUDA error
// of the launch, or 0.
extern "C" int attn_decode(const float* q, const float* kn, const float* vn,
                           const void* kc, const void* vc, const float* ks,
                           const float* vs, const int* npast, float* out,
                           int B, int Hkv, int n_rep, int T, int D,
                           long long kv_batch_stride,
                           long long sc_batch_stride, int kv_kind,
                           float scale, int attn_layout, cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || T <= 0 || n_rep <= 0 || n_rep > 32)
    return (int)cudaErrorInvalidValue;
  if (attn_layout && kv_kind != 0) return (int)cudaErrorInvalidValue;
  if (kv_kind == 1 && (ks == nullptr || vs == nullptr)) return (int)cudaErrorInvalidValue;
  if (kv_kind == 1)
    return launch_d<int8_t>(D, q, kn, vn, kc, vc, ks, vs, npast, out, B, Hkv, n_rep, T,
                            kv_batch_stride, sc_batch_stride, scale, 0, stream);
  if (kv_kind == 0)
    return launch_d<__nv_bfloat16>(D, q, kn, vn, kc, vc, nullptr, nullptr, npast, out, B,
                                   Hkv, n_rep, T, kv_batch_stride, 0, scale, attn_layout,
                                   stream);
  return (int)cudaErrorInvalidValue;
}
