// Shared device helpers for the xkv_tpu_torch kernels (sm_90a).
//
// Tensor-core products use the warp-level mma.sync instructions:
//   m16n8k16 bf16 x bf16 -> fp32   (attention scores, P@V, K rebuild)
//   m16n8k32 s8 x s8 -> s32        (int8 K rebuild)
// Fragment layouts follow the PTX ISA: with g = lane / 4 and q = lane % 4,
//   A (16 x k): reg0 row g, reg1 row g+8, reg2 row g (upper k half),
//               reg3 row g+8 (upper k half);
//   B (k x 8):  reg0 column g (lower k half), reg1 column g (upper half);
//   C (16 x 8): c0,c1 row g cols 2q,2q+1; c2,c3 row g+8 cols 2q,2q+1.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xkv {

// Finite mask value shared with the JAX kernels: -0.7 * FLT_MAX.
constexpr float kNegInf = -0.7f * 3.402823466e+38f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

}  // namespace xkv
