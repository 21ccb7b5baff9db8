// Helpers of the persistent kernels (llama_layer.cu, gpt2_layer.cu and the
// one-row instances of mlp_fused_q8.cu and mlp_fused_silu_q4.cu): a
// cooperative launch (every CTA resident), a producer warp that copies
// weights into shared memory by TMA bulk copies completing on mbarriers,
// consumer warps that wait on them, the CTAs' own grid barrier in a small
// int32 buffer kept for each (device, stream) (kernels/_sync.py): its word
// 0 is the barrier, word 1 the last launch's tag, its words from 2 on
// per-head arrival counters; and the tagged exchange of vectors between
// CTAs.
//
// NC is the number of consumer threads: they synchronise on named barrier 1
// (the producer warp never joins), and one of them a CTA arrives at the grid
// barrier.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace persist {

// the consumer warps only
template <int NC>
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NC) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Every consumer thread of every CTA: the CTAs' own grid barrier on the
// word bar[0], whose low 31 bits are 0 between barriers. CTA 0 adds 2^31 -
// (G - 1), every other CTA 1, so the word's top bit flips with the last
// arrival and with no other: each CTA waits until the top bit differs from
// the one its own add saw (one atomic and the polls; nobody writes the word
// a second time, and it needs no reset).
template <int NC>
__device__ void grid_sync(unsigned* bar) {
  csync<NC>();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();  // this CTA's writes before its arrival
    const unsigned old = atomicAdd(bar, add);
    while (((ld_acquire(bar) ^ old) & 0x80000000u) == 0) __nanosleep(20);
    __threadfence();
  }
  csync<NC>();
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(smem_addr(b))
      : "memory");
}
// the arrival of this thread's earlier cp.asyncs, once they land
__device__ __forceinline__ void mbar_arrive_cp(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(b))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(b)),
      "r"(parity)
      : "memory");
}

// this thread's arrival on b, expecting `bytes` more of asynchronous copies
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* b, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(
          smem_addr(b)),
      "r"(bytes)
      : "memory");
}
// one bulk copy (TMA) of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global src to shared dst, completing on b
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(b))
      : "memory");
}

// cp.async of the 4-byte word at src, its first n bytes (0..4) read, the
// rest zero-filled
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n)
               : "memory");
}

// ---- the tagged exchange ---------------------------------------------------
// Element v of a vector the CTAs exchange, stored with the launch's tag in
// one 64-bit word (kernels/_sync.py exchange_buffer): a reader that sees the
// tag sees the value. No fence, no barrier: a CTA waits for exactly the
// elements it reads. The tag is one more than word 1 of the sync buffer,
// which one CTA of the launch stores once every CTA has read it; launches
// of every kernel that tags take turns on a stream, so a tag is never
// reused.
__device__ __forceinline__ unsigned launch_tag(const unsigned* sync) {
  unsigned tag;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(tag) : "l"(sync + 1) : "memory");
  return tag + 1;
}
__device__ __forceinline__ void store_tag(unsigned* sync, unsigned tag) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(sync + 1), "r"(tag) : "memory");
}
__device__ __forceinline__ void put(unsigned long long* p, float v, unsigned tag) {
  const unsigned long long w = ((unsigned long long)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ unsigned long long peek(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}
__device__ __forceinline__ float await(const unsigned long long* p, unsigned long long w,
                                       unsigned tag) {
  while ((unsigned)(w >> 32) != tag) {
    __nanosleep(20);
    w = peek(p);
  }
  return __uint_as_float((unsigned)w);
}

// vec[i] = src[i] for i < n, each once it carries this launch's tag, by the
// NC consumer threads: a thread's elements i = t + j NC, GB at a time, all
// read in one pass and the ones not yet written read again together in the
// next.
constexpr int GB = 8;
template <int NC>
__device__ void gather(const unsigned long long* src, int n, unsigned tag, float* vec) {
  for (int i0 = threadIdx.x; i0 < n; i0 += GB * NC) {
    unsigned long long w[GB];
#pragma unroll
    for (int j = 0; j < GB; ++j) w[j] = i0 + j * NC < n ? peek(src + i0 + j * NC) : 0ull;
    while (true) {
      bool all = true;
#pragma unroll
      for (int j = 0; j < GB; ++j)
        all = all && (i0 + j * NC >= n || (unsigned)(w[j] >> 32) == tag);
      if (all) break;
      __nanosleep(20);
#pragma unroll
      for (int j = 0; j < GB; ++j)
        if (i0 + j * NC < n && (unsigned)(w[j] >> 32) != tag) w[j] = peek(src + i0 + j * NC);
    }
#pragma unroll
    for (int j = 0; j < GB; ++j)
      if (i0 + j * NC < n) vec[i0 + j * NC] = __uint_as_float((unsigned)w[j]);
  }
  csync<NC>();
}

}  // namespace persist
