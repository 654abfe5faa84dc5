// Split-sequence (flash-decoding) machinery shared by the decode kernels:
// the block walk by K2, K4, K6, K7, K8 (rankspace_attention.cu) and K3, K5,
// K9 (lowrank_attention.cu, lowrank_tma.cuh, kernel_variants.cu); the block
// reduction by the rank-space merge; the block and row-tile sizes and the
// warp reductions also K10 (kernel_ablation.cu).
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

__device__ __forceinline__ float block_reduce(float x, bool is_max, float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  x = is_max ? warp_max(x) : warp_sum(x);
  __syncthreads();
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float y = lane < kThreads / 32 ? scratch[lane] : (is_max ? kNegInf : 0.f);
  return is_max ? warp_max(y) : warp_sum(y);
}

}  // namespace xkv
