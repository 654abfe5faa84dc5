// K2: rank-space decode attention over POST-RoPE factors, for sm_90a.
//
// Replaces: xkv_tpu/ops/pallas/rankspace_attention.py,
// rankspace_decode_attention (Pallas body _rankspace_kernel /
// _rankspace_block_body). As there, the q -> rank-space projection
// (_project_q) and the final t @ v_vt projection (_project_out) stay plain
// tensor code outside the kernel.
//
// Bound on the H100: bytes. Per layer and step the kernel streams the
// factor rows k_us (s_p x rk) and v_us (s_p x rv) once: ~21 MB at
// s_p = 8192, rk 512, rv 768 in bf16 (half in int8), against
// ~2 * R * s_p * (rk + rv) operations with R = 32 query rows, about 32
// FLOP/byte, far below the ~295 FLOP/byte ridge.
//
// Design: flash-decoding. The live columns [win_lo, valid_len) are cut
// into 64-key blocks dealt out to `nsplit` CTAs per (32-row chunk,
// sequence), so a b = 1 step fills the card. Per block a CTA stages the
// key rows in shared memory (int8 upcast to bf16, as the TPU kernel does),
// computes the (32 x 64) scores q_emb . k_us^T on mma.sync bf16 tensor
// cores, runs the fp32 online softmax, and accumulates t += P @ v_us with
// each thread owning rank columns of t in registers, so every v_us byte is
// read from device memory once. A second kernel merges the splits by
// log-sum-exp and writes the normalised t and lse. Masked scores are the
// finite NEG_INF, masked probabilities are exactly 0, and a row with no
// live key gets t = 0.
#include "decode_common.cuh"

using namespace xkv;

namespace {

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) rankspace_split_kernel(
    const bf16* __restrict__ q_emb, const T* __restrict__ k_us,
    const T* __restrict__ v_us, const int* __restrict__ lens,
    const int* __restrict__ los, float* __restrict__ part_t,
    float* __restrict__ part_m, float* __restrict__ part_l, int R, int s_p, int rk,
    int rv, int nsplit) {
  extern __shared__ __align__(16) unsigned char smem[];
  SoftmaxSmem& sm = *reinterpret_cast<SoftmaxSmem*>(smem);
  const int ld = rk + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem + sizeof(SoftmaxSmem));
  bf16* ks = qs + kRows * ld;

  const int split = blockIdx.x, bi = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, R - row0);
  const SplitRange range = split_range(lens, los, bi, s_p, split, nsplit);

  stage_as_bf16<bf16>(qs, ld, q_emb + ((size_t)bi * R + row0) * rk, rk, kRows, rk, rows);
  softmax_init(sm);
  float acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int mt = warp & 1, nt0 = (warp >> 1) * 2;

  for (int blk = range.blk_begin; blk < range.blk_end; ++blk) {
    const int key0 = blk * kBS;
    const int nkeys = min(kBS, s_p - key0);
    __syncthreads();
    stage_as_bf16<T>(ks, ld, k_us + ((size_t)bi * s_p + key0) * rk, rk, kBS, rk, nkeys);
    __syncthreads();

    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const bf16* qa = qs + (mt * 16 + g) * ld + tq * 2;
    for (int kk = 0; kk < rk / 16; ++kk) {
      const bf16* qk = qa + kk * 16;
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(qk),
                             *reinterpret_cast<const uint32_t*>(qk + 8 * ld),
                             *reinterpret_cast<const uint32_t*>(qk + 8),
                             *reinterpret_cast<const uint32_t*>(qk + 8 * ld + 8)};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bf16* kr = ks + ((nt0 + j) * 8 + g) * ld + kk * 16 + tq * 2;
        mma_bf16_16816(c[j], a, *reinterpret_cast<const uint32_t*>(kr),
                       *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = (nt0 + j) * 8 + tq * 2;
      sm.sc[mt * 16 + g][col] = c[j][0];
      sm.sc[mt * 16 + g][col + 1] = c[j][1];
      sm.sc[mt * 16 + g + 8][col] = c[j][2];
      sm.sc[mt * 16 + g + 8][col + 1] = c[j][3];
    }
    __syncthreads();
    softmax_block(sm, rows, key0, range.lo, range.hi);
    pv_block<T, NC>(acc, sm, v_us + ((size_t)bi * s_p + key0) * rv, rv, nkeys);
  }
  __syncthreads();
  write_partial<NC>(acc, sm, part_t, part_m, part_l, bi, split, nsplit, R, row0, rows, rv);
}

__global__ void __launch_bounds__(kThreads) rankspace_merge_kernel(
    const float* __restrict__ part_t, const float* __restrict__ part_m,
    const float* __restrict__ part_l, float* __restrict__ t_out,
    float* __restrict__ lse_out, int R, int rv, int nsplit) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  float* w = red + 8;
  const int r = blockIdx.x, bi = blockIdx.y;
  const float lse = merge_row(part_t, part_m, part_l, bi, r, R, rv, nsplit, w, red,
                              t_out + ((size_t)bi * R + r) * rv);
  if (threadIdx.x == 0) lse_out[(size_t)bi * R + r] = lse;
}

template <typename T, int NC>
int launch_split(dim3 grid, size_t smem, cudaStream_t st, const void* q_emb,
                 const void* k_us, const void* v_us, const int* lens, const int* los,
                 void* part_t, void* part_m, void* part_l, int R, int s_p, int rk, int rv,
                 int nsplit) {
  auto kern = rankspace_split_kernel<T, NC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, st>>>((const bf16*)q_emb, (const T*)k_us, (const T*)v_us,
                                     lens, los, (float*)part_t, (float*)part_m,
                                     (float*)part_l, R, s_p, rk, rv, nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_nc(int nc, dim3 grid, size_t smem, cudaStream_t st, const void* q_emb,
                const void* k_us, const void* v_us, const int* lens, const int* los,
                void* part_t, void* part_m, void* part_l, int R, int s_p, int rk, int rv,
                int nsplit) {
  switch (nc) {
    case 1: return launch_split<T, 1>(grid, smem, st, q_emb, k_us, v_us, lens, los, part_t, part_m, part_l, R, s_p, rk, rv, nsplit);
    case 2: return launch_split<T, 2>(grid, smem, st, q_emb, k_us, v_us, lens, los, part_t, part_m, part_l, R, s_p, rk, rv, nsplit);
    case 3: return launch_split<T, 3>(grid, smem, st, q_emb, k_us, v_us, lens, los, part_t, part_m, part_l, R, s_p, rk, rv, nsplit);
    case 4: return launch_split<T, 4>(grid, smem, st, q_emb, k_us, v_us, lens, los, part_t, part_m, part_l, R, s_p, rk, rv, nsplit);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q_emb (b, R, rk) bf16; k_us (b, s_p, rk), v_us (b, s_p, rv) bf16 or int8,
// contiguous; lens/los (b,) int32 live range [los, lens). Scratch part_t
// (b, nsplit, R, rv), part_m/part_l (b, nsplit, R) fp32. Writes t_out
// (b, R, rv) and lse_out (b, R) fp32. Returns cudaGetLastError().
extern "C" int xkv_rankspace_decode(const void* q_emb, const void* k_us, const void* v_us,
                                    const int* lens, const int* los, void* part_t,
                                    void* part_m, void* part_l, void* t_out, void* lse_out,
                                    int b, int R, int s_p, int rk, int rv, int nsplit,
                                    int is_int8, void* stream) {
  if (rk % 16 != 0 || rv > 4 * kThreads || nsplit < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nc = (rv + kThreads - 1) / kThreads;
  const size_t smem = sizeof(SoftmaxSmem) + (size_t)(kRows + kBS) * (rk + 8) * sizeof(bf16);
  dim3 grid(nsplit, (R + kRows - 1) / kRows, b);
  int err = is_int8
      ? dispatch_nc<int8_t>(nc, grid, smem, st, q_emb, k_us, v_us, lens, los, part_t, part_m, part_l, R, s_p, rk, rv, nsplit)
      : dispatch_nc<bf16>(nc, grid, smem, st, q_emb, k_us, v_us, lens, los, part_t, part_m, part_l, R, s_p, rk, rv, nsplit);
  if (err != 0) return err;
  const size_t msmem = (8 + (size_t)nsplit) * sizeof(float);
  rankspace_merge_kernel<<<dim3(R, b), kThreads, msmem, st>>>(
      (const float*)part_t, (const float*)part_m, (const float*)part_l, (float*)t_out,
      (float*)lse_out, R, rv, nsplit);
  return (int)cudaGetLastError();
}
