// Split-sequence (flash-decoding) machinery shared by the decode kernels:
// K9; the block walk also K2, K4, K6, K7, K8 (rankspace_attention.cu), and
// the block walk and the merge of a row K3, K5 (lowrank_attention.cu); the
// block and row-tile sizes and the warp reductions K10
// (kernel_ablation.cu).
//
// A decode step has b = 1 on the main path, so one CTA per sequence would
// use one SM of 132. The key blocks of each sequence (kBS keys each) are
// dealt out in contiguous runs to `nsplit` CTAs: for the dense kernels the
// blocks covering the live range [win_lo, valid_len), for the sparse ones
// (K4, K5) the blocks of the selected chunks, which each CTA looks up in
// the chunk ids itself. Each CTA keeps, for up to kRows query rows, an
// fp32 online softmax (m, l) and the rank-space value accumulator
// t = sum_blocks P @ v_us in registers, and writes the unnormalised
// partial (t, m, l). A second pass merges the splits by log-sum-exp.
#pragma once

#include "common.cuh"

namespace xkv {

constexpr int kBS = 64;        // keys per block
constexpr int kRows = 32;      // query rows per CTA
constexpr int kThreads = 256;  // 8 warps

// The key blocks of one CTA: entries [begin, end) of its sequence's block
// list, and the live column range [lo, hi). Dense: entry v is the block at
// key v * kBS. Sparse: the list holds the selected chunks' blocks in turn,
// per = ceil(chunk / kBS) of them a chunk, entry v being block v % per of
// chunk ids[v / per] (an id < 0 selects nothing). Block j of chunk id starts
// at key id * chunk + j * kBS and its live keys end at the chunk's end, so
// a chunk of any width is walked; columns past it are masked like any
// other dead column.
struct BlockWalk {
  int lo, hi, begin, end, chunk, per;
  const int* ids;  // this sequence's chunk ids, or null (dense)

  // First key of entry v, or -1 when its block holds no live key (a chunk
  // not selected, a block past the segment or outside [lo, hi)). Uniform
  // over the CTA.
  __device__ __forceinline__ int key0(int v) const {
    if (ids == nullptr) return v * kBS;
    const int id = ids[v / per];
    if (id < 0) return -1;
    const int k0 = id * chunk + (v % per) * kBS;
    return (k0 >= hi || min(k0 + kBS, (id + 1) * chunk) <= lo) ? -1 : k0;
  }

  // End of entry v's live keys: hi, or its chunk's end if that is sooner.
  __device__ __forceinline__ int key_hi(int v) const {
    return ids == nullptr ? hi : min(hi, (ids[v / per] + 1) * chunk);
  }
};

// The walk of split `split` of `nsplit` over the live range [lo, hi), the
// blocks of the chunks `ids` (n_sel of them, this sequence's) or, with ids
// null, the blocks covering [lo, hi).
__device__ __forceinline__ BlockWalk make_walk(int lo, int hi, const int* ids, int n_sel,
                                               int chunk, int split, int nsplit) {
  BlockWalk w;
  w.lo = lo;
  w.hi = hi;
  w.chunk = chunk;
  w.ids = ids;
  int first, last;
  if (ids != nullptr) {
    w.per = (chunk + kBS - 1) / kBS;
    first = 0;
    last = n_sel * w.per;
  } else {
    w.per = 1;
    first = lo / kBS;
    last = hi > lo ? (hi + kBS - 1) / kBS : first;
  }
  const int per = (last - first + nsplit - 1) / nsplit;
  w.begin = min(first + split * per, last);
  w.end = min(w.begin + per, last);
  return w;
}

__device__ __forceinline__ BlockWalk block_walk(const int* lens, const int* los,
                                                const int* ids, int n_sel, int chunk,
                                                int bi, int s_p, int split, int nsplit) {
  return make_walk(max(los[bi], 0), min(lens[bi], s_p),
                   ids != nullptr ? ids + (size_t)bi * n_sel : nullptr, n_sel, chunk, split,
                   nsplit);
}

// Shared state of the online softmax for kRows rows.
struct SoftmaxSmem {
  float sc[kRows][kBS];   // scores of the current block (already scaled)
  float pT[kBS][kRows];   // probabilities rounded to bf16, transposed
  float m[kRows], l[kRows], alpha[kRows];
};

__device__ __forceinline__ void softmax_init(SoftmaxSmem& sm) {
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
}

// One block's online-softmax update. Masked columns (outside [lo, hi))
// take NEG_INF and probability exactly 0; the probabilities are kept for
// the value product rounded to bf16. Ends with __syncthreads().
__device__ __forceinline__ void softmax_block(SoftmaxSmem& sm, int rows, int key0,
                                              int lo, int hi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int c0 = key0 + lane, c1 = key0 + lane + 32;
    const bool live0 = r < rows && c0 >= lo && c0 < hi;
    const bool live1 = r < rows && c1 >= lo && c1 < hi;
    const float x0 = live0 ? sm.sc[r][lane] : kNegInf;
    const float x1 = live1 ? sm.sc[r][lane + 32] : kNegInf;
    const float m_old = sm.m[r];
    const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
    const float p0 = live0 ? __expf(x0 - m_new) : 0.f;
    const float p1 = live1 ? __expf(x1 - m_new) : 0.f;
    const float psum = warp_sum(p0 + p1);
    const float alpha = __expf(m_old - m_new);
    sm.pT[lane][r] = round_bf16(p0);
    sm.pT[lane + 32][r] = round_bf16(p1);
    if (lane == 0) {
      sm.m[r] = m_new;
      sm.l[r] = alpha * sm.l[r] + psum;
      sm.alpha[r] = alpha;
    }
  }
  __syncthreads();
}

// t[r][c] = alpha[r] * t[r][c] + sum_k pT[k][r] * v[k][j_c], j_c =
// threadIdx.x + c * kThreads, over rv-wide rows of T; v points at the
// block's first row.
template <typename T, int NC>
__device__ __forceinline__ void pv_block(float (&acc)[kRows][NC], const SoftmaxSmem& sm,
                                         const T* __restrict__ v, int rv, int nkeys) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float a = sm.alpha[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] *= a;
  }
  for (int kk = 0; kk < nkeys; ++kk) {
    float vv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = threadIdx.x + c * kThreads;
      vv[c] = j < rv ? to_float(v[(size_t)kk * rv + j]) : 0.f;
    }
    const float4* pr = reinterpret_cast<const float4*>(sm.pT[kk]);
#pragma unroll
    for (int r4 = 0; r4 < kRows / 4; ++r4) {
      const float4 p = pr[r4];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[4 * r4 + 0][c] += p.x * vv[c];
        acc[4 * r4 + 1][c] += p.y * vv[c];
        acc[4 * r4 + 2][c] += p.z * vv[c];
        acc[4 * r4 + 3][c] += p.w * vv[c];
      }
    }
  }
}

// Write this CTA's partial (t, m, l) for rows [row0, row0 + rows).
template <int NC>
__device__ __forceinline__ void write_partial(const float (&acc)[kRows][NC],
                                              const SoftmaxSmem& sm, float* part_t,
                                              float* part_m, float* part_l, int bi,
                                              int split, int nsplit, int R, int row0,
                                              int rows, int rv) {
  const size_t base = ((size_t)bi * nsplit + split) * R + row0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = threadIdx.x + c * kThreads;
        if (j < rv) part_t[(base + r) * rv + j] = acc[r][c];
      }
    }
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    part_m[base + r] = sm.m[r];
    part_l[base + r] = sm.l[r];
  }
}

__device__ __forceinline__ float block_reduce(float x, bool is_max, float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  x = is_max ? warp_max(x) : warp_sum(x);
  __syncthreads();
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float y = lane < kThreads / 32 ? scratch[lane] : (is_max ? kNegInf : 0.f);
  return is_max ? warp_max(y) : warp_sum(y);
}

// Merge the splits of row r of sequence bi into trow[rv] (normalised by
// 1/L, 0 where L == 0) and return lse = M + log(max(L, 1e-30)).
// `w` holds nsplit floats of shared scratch; `red` 8 floats.
__device__ __forceinline__ float merge_row(const float* part_t, const float* part_m,
                                           const float* part_l, int bi, int r, int R,
                                           int rv, int nsplit, float* w, float* red,
                                           float* trow) {
  float mx = kNegInf;
  for (int i = threadIdx.x; i < nsplit; i += kThreads)
    mx = fmaxf(mx, part_m[((size_t)bi * nsplit + i) * R + r]);
  const float M = block_reduce(mx, true, red);
  float ls = 0.f;
  for (int i = threadIdx.x; i < nsplit; i += kThreads) {
    const size_t idx = ((size_t)bi * nsplit + i) * R + r;
    const float wi = __expf(part_m[idx] - M);
    w[i] = wi;
    ls += wi * part_l[idx];
  }
  const float L = block_reduce(ls, false, red);  // also orders the w writes
  const float inv = L > 0.f ? 1.f / L : 0.f;
  for (int j = threadIdx.x; j < rv; j += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < nsplit; ++i)
      acc += w[i] * part_t[(((size_t)bi * nsplit + i) * R + r) * rv + j];
    trow[j] = acc * inv;
  }
  __syncthreads();
  return M + logf(fmaxf(L, 1e-30f));
}

}  // namespace xkv
