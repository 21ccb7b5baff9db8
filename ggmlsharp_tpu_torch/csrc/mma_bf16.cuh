// bf16 tensor-core helpers shared by the kernels that run mma.sync
// (flash_attn.cu, and the multi-row instance of the dequant-matmuls through
// dq_mma.cuh): the bf16 plane split of an f32 pair, 16-byte cp.async,
// ldmatrix, and mma.sync.m16n8k16 with f32 accumulators.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// (a, b) -> N bf16 pairs: w[0] = bf16(a, b), w[i] the bf16 rounding of
// what w[0..i-1] leave (each residual is exact in f32)
template <int N>
__device__ __forceinline__ void split_pair(float a, float b, uint32_t* w) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
    if (i + 1 < N) {
      const float2 f = __bfloat1622float2(h);
      a -= f.x;
      b -= f.y;
    }
  }
}

// v with each element rounded to bf16 (to nearest even), back in f32: the
// activation operand of mm_dot "bf16" (kernels/config.py)
__device__ __forceinline__ float4 bf16_round4(float4 v) {
  const float2 a = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
  const float2 b = __bfloat1622float2(__floats2bfloat162_rn(v.z, v.w));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 matrices from shared memory into mma fragments: lane t
// gives the address of row t % 8 of matrix t / 8 and receives, of matrix i,
// register i: row t / 4, columns 2 (t % 4) and + 1 (with trans: column t / 4,
// rows 2 (t % 4) and + 1).
__device__ __forceinline__ void ldsm4(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// c += a (16x16, row) * b (16x8, col): bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
