// K11: tensor-core rate probe, for sm_90a.
//
// Replaces scripts/probe_int4.py `build` (Pallas body `_kernel`): `reps`
// dependent products y_i = x_i @ w, with x_{i+1} = y_i & 7 for the integer
// types (int32 accumulator) and bf16(y_i * 1e-3) for bf16 (fp32
// accumulator); the output is sum_i y_i as fp32. x is (M, K) and w (K, K):
// at M = K (the probe's 512) this is the TPU kernel's function; a larger M
// only adds independent rows, so a caller can fill every SM.
//
// Bound on the H100: operations, 2 * M * K * K * reps, over 989 TFLOP/s
// (bf16) or 1,979 TOP/s (int8); the data sheet gives no int4 rate.
//
// Design: the rows of x are independent, so each CTA owns 32 rows of x and
// keeps them, and its next x, in shared memory (two buffers), and its y and
// running sum in registers. w does not fit in shared memory (K = 512: 256 KB
// as int8, 512 KB as bf16, against a block's 227 KB), so every product
// streams it from L2 in 64-byte slices of its depth; the wrapper hands w
// transposed (and int4 packed two to a byte), so a slice is staged with
// plain 16-byte copies. Products are warp-level mma.sync: bf16 m16n8k16,
// s8 m16n8k32, s4 m16n8k64. All three read 32 bytes of depth per step with
// the same fragment addressing, so one body serves the three types. This is
// the simple form: every CTA re-reads all of w per product, so at M = 512
// (16 CTAs) and past it the probe measures mma.sync fed from L2, not the
// tensor cores' peak (wgmma with TMA and a cluster sharing w would be the
// fast form).
#include <type_traits>

#include "common.cuh"

using namespace xkv;

namespace {

constexpr int kRowsP = 32;      // rows of x per CTA
constexpr int kThreadsP = 256;  // 8 warps: 2 row tiles x 4 column groups
constexpr int kSliceB = 64;     // bytes of depth per staged slice of w
constexpr int kPad = 16;        // bytes of padding per shared row

__device__ __forceinline__ void mma_s4_16864(int c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// KIND 0: bf16, 1: int8, 2: int4 (two values per byte, lower k in the low
// nibble). NT: 8-column tiles per warp, K = 32 * NT.
template <int KIND, int NT>
__global__ void __launch_bounds__(kThreadsP) probe_kernel(const unsigned char* __restrict__ x,
                                                         const unsigned char* __restrict__ wt,
                                                         float* __restrict__ out, int M,
                                                         int reps) {
  typedef typename std::conditional<KIND == 0, float, int>::type Acc;
  constexpr int K = 32 * NT;
  constexpr int KB = KIND == 0 ? 2 * K : (KIND == 1 ? K : K / 2);  // bytes per row
  constexpr int XS = KB + kPad;
  constexpr int WS = kSliceB + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem;                 // [2][kRowsP][XS]
  unsigned char* ws = smem + 2 * kRowsP * XS;  // [K][WS]: w^T slice

  const int row0 = blockIdx.x * kRowsP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rt = warp & 1, n0 = (warp >> 1) * (K / 4);

  for (int c = threadIdx.x; c < kRowsP * (KB / 16); c += kThreadsP) {
    const int r = c / (KB / 16), off = (c % (KB / 16)) * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < M) v = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * KB + off);
    *reinterpret_cast<uint4*>(xs + r * XS + off) = v;
  }
  Acc total[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) total[nt][0] = total[nt][1] = total[nt][2] = total[nt][3] = 0;

  int cur = 0;
  for (int rep = 0; rep < reps; ++rep) {
    Acc acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
    const unsigned char* arow = xs + cur * kRowsP * XS + (rt * 16 + g) * XS;
    for (int cb = 0; cb < KB; cb += kSliceB) {
      __syncthreads();  // the previous slice is consumed; x's buffer is written
      for (int c = threadIdx.x; c < K * (kSliceB / 16); c += kThreadsP) {
        const int n = c / (kSliceB / 16), off = (c % (kSliceB / 16)) * 16;
        *reinterpret_cast<uint4*>(ws + n * WS + off) =
            *reinterpret_cast<const uint4*>(wt + (size_t)n * KB + cb + off);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kSliceB / 32; ++ks) {
        const int kb = ks * 32 + tq * 4;
        const uint32_t a[4] = {
            *reinterpret_cast<const uint32_t*>(arow + cb + kb),
            *reinterpret_cast<const uint32_t*>(arow + 8 * XS + cb + kb),
            *reinterpret_cast<const uint32_t*>(arow + cb + kb + 16),
            *reinterpret_cast<const uint32_t*>(arow + 8 * XS + cb + kb + 16)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned char* brow = ws + (n0 + nt * 8 + g) * WS + kb;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(brow);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(brow + 16);
          if constexpr (KIND == 0) {
            mma_bf16_16816(reinterpret_cast<float*>(acc[nt]), a, b0, b1);
          } else if constexpr (KIND == 1) {
            mma_s8_16832(reinterpret_cast<int*>(acc[nt]), a, b0, b1);
          } else {
            mma_s4_16864(reinterpret_cast<int*>(acc[nt]), a, b0, b1);
          }
        }
      }
    }
    // Sum, and the next x from y (the other buffer, read after the next
    // product's first barrier).
    unsigned char* xn = xs + (cur ^ 1) * kRowsP * XS;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g, g + 8
        const int r = rt * 16 + g + h * 8;
        const int col = n0 + nt * 8 + tq * 2;
        const Acc y0 = acc[nt][2 * h], y1 = acc[nt][2 * h + 1];
        total[nt][2 * h] += y0;
        total[nt][2 * h + 1] += y1;
        if constexpr (KIND == 0) {
          *reinterpret_cast<uint32_t*>(xn + r * XS + col * 2) =
              pack_bf16(__fmul_rn(y0, 1e-3f), __fmul_rn(y1, 1e-3f));
        } else if constexpr (KIND == 1) {
          xn[r * XS + col] = (unsigned char)(y0 & 7);
          xn[r * XS + col + 1] = (unsigned char)(y1 & 7);
        } else {
          xn[r * XS + col / 2] = (unsigned char)((y0 & 7) | ((y1 & 7) << 4));
        }
      }
    }
    cur ^= 1;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + rt * 16 + g + (e >> 1) * 8;
      const int col = n0 + nt * 8 + tq * 2 + (e & 1);
      if (r < M) out[(size_t)r * K + col] = (float)total[nt][e];
    }
  }
}

template <int KIND, int NT>
int launch(const void* x, const void* wt, void* out, int M, int reps, cudaStream_t st) {
  constexpr int K = 32 * NT;
  constexpr int KB = KIND == 0 ? 2 * K : (KIND == 1 ? K : K / 2);
  const size_t smem = 2 * (size_t)kRowsP * (KB + kPad) + (size_t)K * (kSliceB + kPad);
  auto kern = probe_kernel<KIND, NT>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(M + kRowsP - 1) / kRowsP, kThreadsP, smem, st>>>(
      (const unsigned char*)x, (const unsigned char*)wt, (float*)out, M, reps);
  return (int)cudaGetLastError();
}

template <int KIND>
int dispatch_k(int K, const void* x, const void* wt, void* out, int M, int reps,
               cudaStream_t st) {
  switch (K) {
    case 128: return launch<KIND, 4>(x, wt, out, M, reps, st);
    case 256: return launch<KIND, 8>(x, wt, out, M, reps, st);
    case 512: return launch<KIND, 16>(x, wt, out, M, reps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) and wt = w^T (K, K), row-major: bf16 (kind 0), int8 (kind 1), or
// int4 packed two to a byte along K (kind 2). K is 128, 256 or 512. Writes
// out (M, K) fp32 = sum over `reps` chained products.
extern "C" int xkv_probe_gemm_chain(const void* x, const void* wt, void* out, int M, int K,
                                    int reps, int kind, void* stream) {
  if (M < 1 || reps < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return dispatch_k<0>(K, x, wt, out, M, reps, st);
    case 1: return dispatch_k<1>(K, x, wt, out, M, reps, st);
    case 2: return dispatch_k<2>(K, x, wt, out, M, reps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
