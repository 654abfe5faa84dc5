// Hopper (sm_90a) helpers shared by the warp-specialised kernels: K1
// (flash_attention.cu), K3/K5 (lowrank_attention.cu) and K2/K4/K6/K7/K8
// (rankspace_attention.cu).
//   - mbarriers (init, expect_tx, arrive, parity wait);
//   - TMA: a 3-D tensor-map box into shared memory, counted on a barrier;
//     the 128-byte swizzle TMA writes; the cuTensorMapEncodeTiled entry
//     point (fetched through the runtime, so nothing links the driver) and
//     a byte-typed tensor map of rows;
//   - wgmma: the shared-memory descriptor of a 128-byte-swizzled operand,
//     fence / commit / wait, and the register pins that keep the compiler
//     from moving accumulator reads or writes across the asynchronous
//     products.
#pragma once

#include <cuda.h>  // CUtensorMap; the encoder is fetched from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace xkv {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 3-D tensor map into shared memory, counted on the
// barrier at `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// Byte offset of (row, byte) in rows of 128 bytes stored in TMA's 128-byte
// swizzle (the 16-byte unit index XOR the row's low three bits).
__device__ __forceinline__ int swz(int row, int byte) {
  return row * 128 + ((((byte >> 4) & 7) ^ (row & 7)) << 4) + (byte & 15);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout B128.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator (or operand) register reads or
// writes across the asynchronous wgmma instructions.
template <typename A, int N>
__device__ __forceinline__ void fence_regs(A (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<A, float>::value)
      asm volatile("" : "+f"(d[i])::"memory");
    else
      asm volatile("" : "+r"(d[i])::"memory");
  }
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// cuTensorMapEncodeTiled, fetched through the runtime so that the library
// needs no link against the driver.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (row_bytes, rows, batch) byte tensor map, row and batch strides in
// bytes (multiples of 16), box `box_bytes` x `box_rows` x 1, in the
// 128-byte swizzle (box_bytes 128) or unswizzled; reads past the rows or
// the row's bytes give zeros.
inline bool byte_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, long long row_bytes,
                     long long rows, long long batch, long long row_stride,
                     long long batch_stride, int box_bytes = 128, int box_rows = 64,
                     bool swizzle = true) {
  const cuuint64_t dims[3] = {(cuuint64_t)row_bytes, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride, (cuuint64_t)batch_stride};
  const cuuint32_t box[3] = {(cuuint32_t)box_bytes, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace xkv
