// K3 and K5: fused low-rank decode attention over PRE-RoPE factors, for
// sm_90a.
//
// Replaces, in xkv_tpu/ops/pallas/lowrank_attention.py:
//   K3  lowrank_decode_attention (Pallas body _lowrank_kernel /
//       _lowrank_block_body);
//   K5  sparse_lowrank_decode_attention (body _lowrank_sparse_kernel), K3
//       over the Quest-selected chunks only.
// The query embeds (_query_embeds) stay plain tensor code outside the
// kernel, as there.
//
// Bound on the H100: operations. Per layer and step K3 rebuilds every key
// block K = k_us @ k_vt on chip (2 * s_p * rk * m operations, ~8.6 GFLOP at
// s_p = 8192, rk 512, m = hkv*hd = 1024) while the bytes it must read are
// ~21 MB of factors, ~400 FLOP/byte, above the ridge. K5 rebuilds only the
// n_sel * chunk selected rows (2.1 GFLOP at top-4 of 512-row chunks) and
// reads those rows plus this layer's k_vt and v_vt (~7.9 MB in bf16), so
// its operations and bytes take about the same time.
//
// Design: flash-decoding, like K2 (decode_common.cuh): the 64-key blocks
// of the live columns [win_lo, valid_len) (K3), or of the selected chunks
// (K5, each CTA reading the chunk ids itself, the position-table rows read
// at the rows' absolute positions), are dealt out to `nsplit` CTAs per
// (32-row chunk, sequence). Per block a CTA keeps the k_us rows in
// shared memory and, for each kv head, rebuilds that head's (64 x hd) key
// block on mma.sync tensor cores: bf16 x bf16 -> fp32, or int8 x int8 ->
// int32, then rounds it to bf16 as the TPU kernel does. k_vt (rk x m,
// 1 MB in bf16) does not fit in shared memory, so it is streamed through in
// (rank chunk x hd) tiles, stored transposed for the tensor-core operand.
// RoPE is applied in relative-angle form: the rebuilt block is multiplied
// by the key-position cos and sin (bf16 half tables) and contracted with
// the two query embeds [qa | qb], which carry the query-position trig, the
// softmax scale and the int8 K column scale. Only the rows of the head's
// own query group are contracted (the TPU kernel multiplies zeros for the
// other heads). Values stay in rank space: t += P @ v_us. The merge kernel
// combines the splits and also applies t @ v_vt (times the int8 per-rank V
// scale) for each row's own head block, which the TPU kernel did at its
// last grid step. Masked scores are the finite NEG_INF, masked
// probabilities are exactly 0, a row with no live key outputs 0, and
// lse = m + log(max(l, 1e-30)).
#include "lowrank_common.cuh"

using namespace xkv;

namespace {

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) lowrank_split_kernel(
    const bf16* __restrict__ qab, const T* __restrict__ k_us, const T* __restrict__ k_vt,
    const T* __restrict__ v_us, const bf16* __restrict__ cos_h,
    const bf16* __restrict__ sin_h, const int* __restrict__ lens,
    const int* __restrict__ los, const int* __restrict__ ids, int n_sel, int chunk,
    float* __restrict__ part_t, float* __restrict__ part_m,
    float* __restrict__ part_l, int R, int hq, int hkv, int s_p, int rk, int rv,
    long long sb_kvt, long long ld_kvt, int nsplit) {
  constexpr int KC = kChunkB / (int)sizeof(T);  // ranks per staged tile
  constexpr int LDK = kHD + 2;                   // bf16 row stride of kcos/ksin
  extern __shared__ __align__(16) unsigned char smem[];
  SoftmaxSmem& sm = *reinterpret_cast<SoftmaxSmem*>(smem);
  float* qf = reinterpret_cast<float*>(smem + sizeof(SoftmaxSmem));  // [kRows][2*kHD]
  bf16* kcos = reinterpret_cast<bf16*>(qf + kRows * 2 * kHD);        // [kBS][LDK]
  bf16* ksin = kcos + kBS * LDK;
  unsigned char* us_s = reinterpret_cast<unsigned char*>(ksin + kBS * LDK);
  const int us_stride = rk * (int)sizeof(T) + 16;  // bytes
  unsigned char* vt_s = us_s + kBS * us_stride;    // [kHD][kVtStride] bytes

  const int split = blockIdx.x, bi = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, R - row0);
  const int gsz = hq / hkv;
  const BlockWalk walk = block_walk(lens, los, ids, n_sel, chunk, bi, s_p, split, nsplit);

  for (int i = threadIdx.x; i < kRows * 2 * kHD; i += kThreads) {
    const int r = i / (2 * kHD);
    qf[i] = r < rows ? __bfloat162float(qab[((size_t)bi * R + row0) * 2 * kHD + i]) : 0.f;
  }
  softmax_init(sm);
  float acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int mt = warp & 3;                  // 16-key row tile of the block
  const int nbase = (warp >> 2) * (kHD / 2);  // 64-column half of the head
  const T* kvt_b = k_vt + (size_t)bi * sb_kvt;
  const int us_row_bytes = rk * (int)sizeof(T);

  for (int v = walk.begin; v < walk.end; ++v) {
    const int key0 = walk.key0(v);
    if (key0 < 0) continue;  // uniform over the CTA
    const int nkeys = min(kBS, s_p - key0);
    __syncthreads();
    {  // stage the block's k_us rows (raw bytes, zero past s_p)
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          k_us + ((size_t)bi * s_p + key0) * rk);
      const int per_row = us_row_bytes / 16;
      for (int c = threadIdx.x; c < kBS * per_row; c += kThreads) {
        const int row = c / per_row, off = (c % per_row) * 16;
        uint4 x = make_uint4(0, 0, 0, 0);
        if (row < nkeys)
          x = *reinterpret_cast<const uint4*>(src + (size_t)row * us_row_bytes + off);
        *reinterpret_cast<uint4*>(us_s + row * us_stride + off) = x;
      }
    }
    for (int hk = 0; hk < hkv; ++hk) {
      typename RebuildAcc<T>::type kacc[kHD / 16][4];
#pragma unroll
      for (int nt = 0; nt < kHD / 16; ++nt) kacc[nt][0] = kacc[nt][1] = kacc[nt][2] = kacc[nt][3] = 0;

      for (int kc = 0; kc < rk; kc += KC) {
        __syncthreads();  // previous tile consumed (and k_us staged)
        // k_vt tile: ranks [kc, kc+KC) x columns [hk*hd, hk*hd + hd),
        // stored transposed: vt_s[col][rank].
        constexpr int kPerLoad = 16 / (int)sizeof(T);
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
          // bf16: k16 steps at 2 bytes/elem; int8: k32 steps at 1 byte/elem.
          const int kb = ks * 32 + tq * 4;  // byte offset of this lane's pair/quad
          const uint32_t a[4] = {
              *reinterpret_cast<const uint32_t*>(arow + kb),
              *reinterpret_cast<const uint32_t*>(arow + 8 * us_stride + kb),
              *reinterpret_cast<const uint32_t*>(arow + kb + 16),
              *reinterpret_cast<const uint32_t*>(arow + 8 * us_stride + kb + 16)};
#pragma unroll
          for (int nt = 0; nt < kHD / 16; ++nt) {
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
      // Round the rebuilt keys to bf16 and form the two trig fields.
#pragma unroll
      for (int nt = 0; nt < kHD / 16; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = mt * 16 + g + (e >> 1) * 8;
          const int col = nbase + nt * 8 + tq * 2 + (e & 1);
          const bf16 kb16 = __float2bfloat16_rn((float)kacc[nt][e]);
          bf16 cv = __float2bfloat16_rn(0.f), sv = cv;
          if (key0 + key < s_p) {
            cv = cos_h[(size_t)(key0 + key) * (kHD / 2) + (col % (kHD / 2))];
            sv = sin_h[(size_t)(key0 + key) * (kHD / 2) + (col % (kHD / 2))];
          }
          kcos[key * LDK + col] = __hmul(kb16, cv);
          ksin[key * LDK + col] = __hmul(kb16, sv);
        }
      }
      __syncthreads();
      // Scores of the rows whose query head reads kv head hk.
      const int kk = threadIdx.x & (kBS - 1);
      for (int r = threadIdx.x / kBS; r < rows; r += kThreads / kBS) {
        if (((row0 + r) % hq) / gsz != hk) continue;
        const float* qa = qf + r * 2 * kHD;
        const float* qb = qa + kHD;
        const __nv_bfloat162* kc2 = reinterpret_cast<const __nv_bfloat162*>(kcos + kk * LDK);
        const __nv_bfloat162* ks2 = reinterpret_cast<const __nv_bfloat162*>(ksin + kk * LDK);
        float s = 0.f;
#pragma unroll 8
        for (int d2 = 0; d2 < kHD / 2; ++d2) {
          const float2 c = __bfloat1622float2(kc2[d2]);
          const float2 sn = __bfloat1622float2(ks2[d2]);
          s += qa[2 * d2] * c.x + qa[2 * d2 + 1] * c.y + qb[2 * d2] * sn.x +
               qb[2 * d2 + 1] * sn.y;
        }
        sm.sc[r][kk] = s;
      }
    }
    __syncthreads();
    softmax_block(sm, rows, key0, walk.lo, walk.hi);
    pv_block<T, NC>(acc, sm, v_us + ((size_t)bi * s_p + key0) * rv, rv, nkeys);
  }
  __syncthreads();
  write_partial<NC>(acc, sm, part_t, part_m, part_l, bi, split, nsplit, R, row0, rows, rv);
}

template <typename T, int NC>
int launch_split(dim3 grid, size_t smem, cudaStream_t st, const void* qab, const void* k_us,
                 const void* k_vt, const void* v_us, const void* cos_h, const void* sin_h,
                 const int* lens, const int* los, const int* ids, int n_sel, int chunk,
                 void* part_t, void* part_m,
                 void* part_l, int R, int hq, int hkv, int s_p, int rk, int rv,
                 long long sb_kvt, long long ld_kvt, int nsplit) {
  auto kern = lowrank_split_kernel<T, NC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, st>>>(
      (const bf16*)qab, (const T*)k_us, (const T*)k_vt, (const T*)v_us,
      (const bf16*)cos_h, (const bf16*)sin_h, lens, los, ids, n_sel, chunk, (float*)part_t,
      (float*)part_m,
      (float*)part_l, R, hq, hkv, s_p, rk, rv, sb_kvt, ld_kvt, nsplit);
  return (int)cudaGetLastError();
}

#define XKV_LOWRANK_ARGS                                                              \
  grid, smem, st, qab, k_us, k_vt, v_us, cos_h, sin_h, lens, los, ids, n_sel, chunk, part_t, \
      part_m, part_l, R, hq, hkv, s_p, rk, rv, sb_kvt, ld_kvt, nsplit

template <typename T>
int dispatch_nc(int nc, dim3 grid, size_t smem, cudaStream_t st, const void* qab,
                const void* k_us, const void* k_vt, const void* v_us, const void* cos_h,
                const void* sin_h, const int* lens, const int* los, const int* ids,
                int n_sel, int chunk, void* part_t,
                void* part_m, void* part_l, int R, int hq, int hkv, int s_p, int rk,
                int rv, long long sb_kvt, long long ld_kvt, int nsplit) {
  switch (nc) {
    case 1: return launch_split<T, 1>(XKV_LOWRANK_ARGS);
    case 2: return launch_split<T, 2>(XKV_LOWRANK_ARGS);
    case 3: return launch_split<T, 3>(XKV_LOWRANK_ARGS);
    case 4: return launch_split<T, 4>(XKV_LOWRANK_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Split kernel for the launch's value width, then the merge (K3 with
// ids == null, K5 otherwise).
int run(const void* qab, const void* k_us, const void* k_vt, long long sb_kvt,
        long long ld_kvt, const void* v_us, const void* v_vt, long long sb_vvt,
        long long ld_vvt, const void* cos_h, const void* sin_h, const void* v_scale,
        const int* ids, int n_sel, int chunk, const int* lens, const int* los, void* part_t,
        void* part_m, void* part_l, void* out, void* lse, int b, int R, int hq, int hkv,
        int hd, int s_p, int rk, int rv, int nsplit, int is_int8, void* stream) {
  if (hd != kHD || rk % kChunkB != 0 || rv > 4 * kThreads || nsplit < 1 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (ids != nullptr && (chunk <= 0 || chunk % kBS != 0 || n_sel < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nc = (rv + kThreads - 1) / kThreads;
  const size_t tsz = is_int8 ? 1 : 2;
  const size_t smem = sizeof(SoftmaxSmem) + (size_t)kRows * 2 * kHD * sizeof(float) +
                      2 * (size_t)kBS * (kHD + 2) * sizeof(bf16) +
                      (size_t)kBS * (rk * tsz + 16) + (size_t)kHD * kVtStride;
  dim3 grid(nsplit, (R + kRows - 1) / kRows, b);
  int err = is_int8
      ? dispatch_nc<int8_t>(nc, grid, smem, st, qab, k_us, k_vt, v_us, cos_h, sin_h, lens, los, ids, n_sel, chunk, part_t, part_m, part_l, R, hq, hkv, s_p, rk, rv, sb_kvt, ld_kvt, nsplit)
      : dispatch_nc<bf16>(nc, grid, smem, st, qab, k_us, k_vt, v_us, cos_h, sin_h, lens, los, ids, n_sel, chunk, part_t, part_m, part_l, R, hq, hkv, s_p, rk, rv, sb_kvt, ld_kvt, nsplit);
  if (err != 0) return err;
  return launch_lowrank_merge(part_t, part_m, part_l, v_vt, sb_vvt, ld_vvt, v_scale, out, lse,
                              b, R, hq, hkv, rv, nsplit, st);
}

}  // namespace

// K3. qab (b, R, 2*hd) bf16 compact query embeds ([qa | qb] of each row's own
// head); k_us (b, s_p, rk), v_us (b, s_p, rv) bf16 or int8 contiguous;
// k_vt (b, rk, .) with batch stride sb_kvt and row stride ld_kvt, this
// layer's columns starting at the pointer; v_vt (b, rv, .) bf16 likewise;
// cos_h/sin_h (s_p, hd/2) bf16; v_scale (b, 1, rv) fp32 or null;
// lens/los (b,) int32. Scratch part_t (b, nsplit, R, rv), part_m/part_l
// (b, nsplit, R) fp32. Writes out (b, R, hd) bf16 and lse (b, R) fp32.
extern "C" int xkv_lowrank_decode(
    const void* qab, const void* k_us, const void* k_vt, long long sb_kvt,
    long long ld_kvt, const void* v_us, const void* v_vt, long long sb_vvt,
    long long ld_vvt, const void* cos_h, const void* sin_h, const void* v_scale,
    const int* lens, const int* los, void* part_t, void* part_m, void* part_l, void* out,
    void* lse, int b, int R, int hq, int hkv, int hd, int s_p, int rk, int rv, int nsplit,
    int is_int8, void* stream) {
  return run(qab, k_us, k_vt, sb_kvt, ld_kvt, v_us, v_vt, sb_vvt, ld_vvt, cos_h, sin_h,
             v_scale, nullptr, 0, 0, lens, los, part_t, part_m, part_l, out, lse, b, R, hq,
             hkv, hd, s_p, rk, rv, nsplit, is_int8, stream);
}

// K5. As K3, over the rows of the selected chunks: ids (b, n_sel) int32,
// chunk id i covering rows [i * chunk, (i + 1) * chunk) (chunk a multiple
// of 64); an id < 0 selects nothing.
extern "C" int xkv_sparse_lowrank_decode(
    const void* qab, const void* k_us, const void* k_vt, long long sb_kvt,
    long long ld_kvt, const void* v_us, const void* v_vt, long long sb_vvt,
    long long ld_vvt, const void* cos_h, const void* sin_h, const void* v_scale,
    const int* ids, const int* lens, const int* los, void* part_t, void* part_m,
    void* part_l, void* out, void* lse, int b, int R, int hq, int hkv, int hd, int s_p,
    int rk, int rv, int n_sel, int chunk, int nsplit, int is_int8, void* stream) {
  return run(qab, k_us, k_vt, sb_kvt, ld_kvt, v_us, v_vt, sb_vvt, ld_vvt, cos_h, sin_h,
             v_scale, ids, n_sel, chunk, lens, los, part_t, part_m, part_l, out, lse, b, R,
             hq, hkv, hd, s_p, rk, rv, nsplit, is_int8, stream);
}
