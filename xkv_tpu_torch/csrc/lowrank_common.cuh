// Pieces of K3's first design (one CTA per 32 rows and key split, all kv
// heads in turn, k_vt re-streamed per block), kept for the kernel-study
// kernel built from it: K9 (kernel_variants.cu). K3/K5 themselves
// (lowrank_attention.cu) and K10 (kernel_ablation.cu, on K3's shipped
// machinery) no longer use them.
//
// - The on-chip key rebuild of one kv head, K = k_us @ k_vt, on mma.sync
//   tensor cores (bf16 -> fp32 or int8 -> int32), k_vt streamed through
//   shared memory in (rank chunk x hd) tiles stored transposed.
// - K3's merge kernel: the splits merged by log-sum-exp, then t @ v_vt for
//   each row's own head.
#pragma once

#include "decode_common.cuh"

namespace xkv {

constexpr int kHD = 128;                 // head_dim served by these kernels
constexpr int kChunkB = 64;              // bytes of rank per staged k_vt tile row
constexpr int kVtStride = kChunkB + 16;  // padded bytes per transposed row

template <typename T>
struct RebuildAcc;
template <>
struct RebuildAcc<bf16> { typedef float type; };
template <>
struct RebuildAcc<int8_t> { typedef int type; };

// Rebuild kv head hk of 16 * KT staged keys: us_s holds the keys' k_us rows
// (raw bytes, row stride us_stride), vt_s is (kHD x kVtStride) bytes of
// scratch. The 8 warps tile the (16 KT x kHD) block as KT key tiles of 16
// rows by 8 / KT column parts; warp w owns key tile w % KT and the 16 KT
// columns from (w / KT) * 16 KT. kacc[nt] is the mma.sync C fragment of its
// n-tile nt: keys mt*16 + g (+8), columns nbase + nt*8 + 2 tq (+1). Starts
// and ends with __syncthreads() inside its rank loop; the caller syncs
// after staging us_s.
template <typename T, int KT>
__device__ __forceinline__ void rebuild_head(typename RebuildAcc<T>::type (&kacc)[2 * KT][4],
                                             const unsigned char* us_s, int us_stride,
                                             unsigned char* vt_s, const T* __restrict__ kvt_b,
                                             long long ld_kvt, int hk, int rk) {
  constexpr int KC = kChunkB / (int)sizeof(T);  // ranks per staged tile
  constexpr int kPerLoad = 16 / (int)sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int mt = warp % KT;
  const int nbase = (warp / KT) * (16 * KT);
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) kacc[nt][0] = kacc[nt][1] = kacc[nt][2] = kacc[nt][3] = 0;
  for (int kc = 0; kc < rk; kc += KC) {
    __syncthreads();  // previous tile consumed
    for (int c = threadIdx.x; c < KC * kHD / kPerLoad; c += kThreads) {
      const int kr = c / (kHD / kPerLoad), col = (c % (kHD / kPerLoad)) * kPerLoad;
      const uint4 x = *reinterpret_cast<const uint4*>(
          kvt_b + (size_t)(kc + kr) * ld_kvt + hk * kHD + col);
      const T* xe = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int i = 0; i < kPerLoad; ++i)
        reinterpret_cast<T*>(vt_s + (col + i) * kVtStride)[kr] = xe[i];
    }
    __syncthreads();
    const unsigned char* arow = us_s + (mt * 16 + g) * us_stride + kc * (int)sizeof(T);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int kb = ks * 32 + tq * 4;
      const uint32_t a[4] = {
          *reinterpret_cast<const uint32_t*>(arow + kb),
          *reinterpret_cast<const uint32_t*>(arow + 8 * us_stride + kb),
          *reinterpret_cast<const uint32_t*>(arow + kb + 16),
          *reinterpret_cast<const uint32_t*>(arow + 8 * us_stride + kb + 16)};
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        const unsigned char* brow = vt_s + (nbase + nt * 8 + g) * kVtStride + kb;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(brow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(brow + 16);
        if constexpr (sizeof(T) == 2) {
          mma_bf16_16816(reinterpret_cast<float*>(kacc[nt]), a, b0, b1);
        } else {
          mma_s8_16832(reinterpret_cast<int*>(kacc[nt]), a, b0, b1);
        }
      }
    }
  }
}

// Stage `nkeys` (<= rows) k_us rows of rk elements of T, starting at src,
// into us_s (row stride us_stride bytes); rows past nkeys are zero.
template <typename T>
__device__ __forceinline__ void stage_us_rows(unsigned char* us_s, int us_stride,
                                              const T* __restrict__ src, int rk, int rows,
                                              int nkeys) {
  const int row_bytes = rk * (int)sizeof(T);
  const int per_row = row_bytes / 16;
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  for (int c = threadIdx.x; c < rows * per_row; c += kThreads) {
    const int row = c / per_row, off = (c % per_row) * 16;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row < nkeys) x = *reinterpret_cast<const uint4*>(s + (size_t)row * row_bytes + off);
    *reinterpret_cast<uint4*>(us_s + row * us_stride + off) = x;
  }
}

// K3's merge: one CTA per (row r, sequence bi) combines the splits' (t, m,
// l), scales t by the int8 per-rank V scale (or 1), rounds it to bf16 and
// writes out = t @ v_vt over the row's own head's hd columns, and lse.
// Static: one copy in each source that includes this.
static __global__ void __launch_bounds__(kThreads) lowrank_merge_kernel(
    const float* __restrict__ part_t, const float* __restrict__ part_m,
    const float* __restrict__ part_l, const bf16* __restrict__ v_vt,
    long long sb_vvt, long long ld_vvt, const float* __restrict__ v_scale,
    bf16* __restrict__ out, float* __restrict__ lse_out, int R, int hq, int hkv, int rv,
    int nsplit) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  float* half_sums = red + 8;                  // [kThreads]
  float* trow = half_sums + kThreads;          // [rv]
  float* w = trow + rv;                        // [nsplit]
  const int r = blockIdx.x, bi = blockIdx.y;
  const float lse = merge_row(part_t, part_m, part_l, bi, r, R, rv, nsplit, w, red, trow);
  for (int j = threadIdx.x; j < rv; j += kThreads) {
    const float sc = v_scale ? v_scale[(size_t)bi * rv + j] : 1.f;
    trow[j] = round_bf16(trow[j] * sc);
  }
  __syncthreads();
  const int head = (r % hq) / (hq / hkv);
  const int d = threadIdx.x % kHD, part = threadIdx.x / kHD;
  constexpr int kParts = kThreads / kHD;
  const bf16* vt = v_vt + (size_t)bi * sb_vvt + head * kHD + d;
  float s = 0.f;
  for (int j = part; j < rv; j += kParts) s += trow[j] * __bfloat162float(vt[(size_t)j * ld_vvt]);
  half_sums[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < kHD) {
    float o = 0.f;
#pragma unroll
    for (int p = 0; p < kParts; ++p) o += half_sums[p * kHD + threadIdx.x];
    out[((size_t)bi * R + r) * kHD + threadIdx.x] = __float2bfloat16_rn(o);
    if (threadIdx.x == 0) lse_out[(size_t)bi * R + r] = lse;
  }
}

// Launch K3's merge over (R rows, b sequences).
static int launch_lowrank_merge(const void* part_t, const void* part_m, const void* part_l,
                                const void* v_vt, long long sb_vvt, long long ld_vvt,
                                const void* v_scale, void* out, void* lse, int b, int R,
                                int hq, int hkv, int rv, int nsplit, cudaStream_t st) {
  const size_t msmem = (8 + kThreads + (size_t)rv + nsplit) * sizeof(float);
  lowrank_merge_kernel<<<dim3(R, b), kThreads, msmem, st>>>(
      (const float*)part_t, (const float*)part_m, (const float*)part_l, (const bf16*)v_vt,
      sb_vvt, ld_vvt, (const float*)v_scale, (bf16*)out, (float*)lse, R, hq, hkv, rv, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace xkv
