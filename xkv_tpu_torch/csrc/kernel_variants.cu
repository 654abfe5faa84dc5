// K9: design variants of K3's score stage, for sm_90a.
//
// Replaces scripts/kernel_variants.py `variant_attention` (Pallas body
// `_variant_kernel`): K3's function (lowrank_decode_attention: keys rebuilt
// from pre-RoPE factors per block, relative-angle RoPE, online softmax,
// values in rank space, t @ v_vt per head at the end) computed by other
// designs of the score stage, as candidates for K3's redesign:
//   two_gemm    per kv head, the rebuilt block times the key-position cos
//               and sin goes to two (64 x hd) shared buffers, and two score
//               products of depth hd (qa against K*cos, qb against K*sin)
//               accumulate in registers over all heads: depth m = hkv * hd
//               each, as on the TPU;
//   scratch_ab  both trig products of the whole key block, all kv heads,
//               staged in one (N x 2m) shared buffer [K*cos | K*sin], then
//               one score product of depth 2m. At 2m = 2048 bf16 a 64-key
//               buffer is 256 KB, over a block's 227 KB, so it stages N = 32
//               (or 16: `b16`) keys at a time and rebuilds, re-streaming
//               k_vt, once per N keys.
// Both contract the TPU form's full-width query embeds [qa | qb] (b, R, 2m)
// with zeros off each row's head, read from device memory (L2) as mma.sync
// fragments, so every row multiplies every head's keys (K3 contracts each
// row with its own head only). Rebuild (rebuild_head), softmax, value
// product and merge (lowrank_common.cuh, decode_common.cuh) are K3's.
//
// Bound on the H100: K3's, operations (the rebuild 2 * s_p * rk * m plus
// the score and value products of the live rows).
#include "lowrank_common.cuh"

using namespace xkv;

namespace {

constexpr int LDB = kHD + 8;  // bf16 row stride of the per-head buffers

__device__ __forceinline__ uint32_t ld_pair(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// c[j] += A . B_j^T over `depth` columns: A the 16 query rows whose
// fragment rows start at q0 (row g) and q8 (row g + 8), already offset by
// the lane's column tq * 2, each loaded only where ok0 / ok8; B_j the 8
// keys (nt0 + j) * 8 + g of kbuf (row stride ldb), column tq * 2 of each
// 16-wide step.
template <int NJ>
__device__ __forceinline__ void score_mma(float (&c)[NJ][4], const bf16* q0, const bf16* q8,
                                          bool ok0, bool ok8, const bf16* kbuf, int ldb,
                                          int nt0, int g, int tq, int depth) {
  for (int kk = 0; kk < depth / 16; ++kk) {
    const uint32_t af[4] = {ld_pair(q0 + kk * 16, ok0), ld_pair(q8 + kk * 16, ok8),
                            ld_pair(q0 + kk * 16 + 8, ok0), ld_pair(q8 + kk * 16 + 8, ok8)};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bf16* kr = kbuf + ((nt0 + j) * 8 + g) * ldb + kk * 16 + tq * 2;
      mma_bf16_16816(c[j], af, *reinterpret_cast<const uint32_t*>(kr),
                     *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }
}

// The rebuilt keys of head hk (C fragments of rebuild_head<T, KT>) rounded
// to bf16 and times the key-position cos and sin, into kc / ks at column
// offset col0 (row stride ld); keys past s_p take 0.
template <typename Acc, int KT>
__device__ __forceinline__ void trig_fields(const Acc (&kacc)[2 * KT][4], bf16* kc, bf16* ks,
                                            int ld, int col0, int key0, int s_p,
                                            const bf16* __restrict__ cos_h,
                                            const bf16* __restrict__ sin_h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int mt = warp % KT, nbase = (warp / KT) * (16 * KT);
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
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
      kc[key * ld + col0 + col] = __hmul(kb16, cv);
      ks[key * ld + col0 + col] = __hmul(kb16, sv);
    }
  }
}

struct Args {
  const bf16* qab;  // (b, R, 2m) full-width [qa | qb], zero off each row's head
  const void *k_us, *k_vt, *v_us;
  const bf16 *cos_h, *sin_h;
  const int *lens, *los;
  float *part_t, *part_m, *part_l;
  int R, hq, hkv, s_p, rk, rv;
  long long sb_kvt, ld_kvt;
  int nsplit;
};

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) two_gemm_kernel(const Args a) {
  typedef typename RebuildAcc<T>::type Acc;
  const int m = a.hkv * kHD;
  const int us_stride = a.rk * (int)sizeof(T) + 16;
  extern __shared__ __align__(16) unsigned char smem[];
  SoftmaxSmem& sm = *reinterpret_cast<SoftmaxSmem*>(smem);
  bf16* kcos = reinterpret_cast<bf16*>(smem + sizeof(SoftmaxSmem));  // [kBS][LDB]
  bf16* ksin = kcos + kBS * LDB;
  unsigned char* us_s = reinterpret_cast<unsigned char*>(ksin + kBS * LDB);
  unsigned char* vt_s = us_s + kBS * us_stride;

  const int split = blockIdx.x, bi = blockIdx.z, row0 = blockIdx.y * kRows;
  const int rows = min(kRows, a.R - row0);
  const BlockWalk walk = block_walk(a.lens, a.los, nullptr, 0, 0, bi, a.s_p, split, a.nsplit);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rt = warp & 1, kg = warp >> 1;  // score tile: 16 rows x 16 keys
  const int r0 = rt * 16 + g;
  const bf16* q0 = a.qab + ((size_t)bi * a.R + row0 + r0) * 2 * m + tq * 2;
  const bf16* q8 = q0 + (size_t)8 * 2 * m;
  const T* kvt_b = reinterpret_cast<const T*>(a.k_vt) + (size_t)bi * a.sb_kvt;

  softmax_init(sm);
  float acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int v = walk.begin; v < walk.end; ++v) {
    const int key0 = walk.key0(v);
    const int nkeys = min(kBS, a.s_p - key0);
    __syncthreads();
    stage_us_rows<T>(us_s, us_stride,
                     reinterpret_cast<const T*>(a.k_us) + ((size_t)bi * a.s_p + key0) * a.rk,
                     a.rk, kBS, nkeys);
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int hk = 0; hk < a.hkv; ++hk) {
      Acc kacc[8][4];
      rebuild_head<T, 4>(kacc, us_s, us_stride, vt_s, kvt_b, a.ld_kvt, hk, a.rk);
      trig_fields<Acc, 4>(kacc, kcos, ksin, LDB, 0, key0, a.s_p, a.cos_h, a.sin_h);
      __syncthreads();
      const int qc = hk * kHD;
      score_mma<2>(c, q0 + qc, q8 + qc, r0 < rows, r0 + 8 < rows, kcos, LDB, kg * 2, g, tq, kHD);
      score_mma<2>(c, q0 + m + qc, q8 + m + qc, r0 < rows, r0 + 8 < rows, ksin, LDB, kg * 2, g,
                   tq, kHD);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sm.sc[r0 + (e >> 1) * 8][(kg * 2 + j) * 8 + tq * 2 + (e & 1)] = c[j][e];
    __syncthreads();
    softmax_block(sm, rows, key0, walk.lo, walk.hi);
    pv_block<T, NC>(acc, sm, reinterpret_cast<const T*>(a.v_us) + ((size_t)bi * a.s_p + key0) * a.rv,
                    a.rv, nkeys);
  }
  __syncthreads();
  write_partial<NC>(acc, sm, a.part_t, a.part_m, a.part_l, bi, split, a.nsplit, a.R, row0, rows,
                    a.rv);
}

template <typename T, int NC, int KT>
__global__ void __launch_bounds__(kThreads) scratch_ab_kernel(const Args a) {
  typedef typename RebuildAcc<T>::type Acc;
  constexpr int N = 16 * KT;  // keys staged at a time
  const int m = a.hkv * kHD, lda = 2 * m + 8;
  const int us_stride = a.rk * (int)sizeof(T) + 16;
  extern __shared__ __align__(16) unsigned char smem[];
  SoftmaxSmem& sm = *reinterpret_cast<SoftmaxSmem*>(smem);
  bf16* ab = reinterpret_cast<bf16*>(smem + sizeof(SoftmaxSmem));  // [N][lda]
  unsigned char* us_s = reinterpret_cast<unsigned char*>(ab + N * lda);
  unsigned char* vt_s = us_s + N * us_stride;

  const int split = blockIdx.x, bi = blockIdx.z, row0 = blockIdx.y * kRows;
  const int rows = min(kRows, a.R - row0);
  const BlockWalk walk = block_walk(a.lens, a.los, nullptr, 0, 0, bi, a.s_p, split, a.nsplit);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  // Score tasks: (16-row tile rt, 8-key tile nt), 2 * N / 8 of them.
  const int rt = warp & 1, nt = warp >> 1;
  const bool has_task = nt < N / 8;
  const int r0 = rt * 16 + g;
  const bf16* q0 = a.qab + ((size_t)bi * a.R + row0 + r0) * 2 * m + tq * 2;
  const bf16* q8 = q0 + (size_t)8 * 2 * m;
  const T* kvt_b = reinterpret_cast<const T*>(a.k_vt) + (size_t)bi * a.sb_kvt;

  softmax_init(sm);
  float acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int v = walk.begin; v < walk.end; ++v) {
    const int key0 = walk.key0(v);
    const int nkeys = min(kBS, a.s_p - key0);
    for (int sub = 0; sub < kBS / N; ++sub) {
      const int k0 = key0 + sub * N;
      __syncthreads();  // the previous keys' buffer and scores are consumed
      stage_us_rows<T>(us_s, us_stride,
                       reinterpret_cast<const T*>(a.k_us) + ((size_t)bi * a.s_p + k0) * a.rk,
                       a.rk, N, nkeys - sub * N);
      for (int hk = 0; hk < a.hkv; ++hk) {
        Acc kacc[2 * KT][4];
        rebuild_head<T, KT>(kacc, us_s, us_stride, vt_s, kvt_b, a.ld_kvt, hk, a.rk);
        trig_fields<Acc, KT>(kacc, ab, ab + m, lda, hk * kHD, k0, a.s_p, a.cos_h, a.sin_h);
      }
      __syncthreads();
      if (has_task) {
        float c[1][4] = {{0.f, 0.f, 0.f, 0.f}};
        score_mma<1>(c, q0, q8, r0 < rows, r0 + 8 < rows, ab, lda, nt, g, tq, 2 * m);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sm.sc[r0 + (e >> 1) * 8][sub * N + nt * 8 + tq * 2 + (e & 1)] = c[0][e];
      }
    }
    __syncthreads();
    softmax_block(sm, rows, key0, walk.lo, walk.hi);
    pv_block<T, NC>(acc, sm, reinterpret_cast<const T*>(a.v_us) + ((size_t)bi * a.s_p + key0) * a.rv,
                    a.rv, nkeys);
  }
  __syncthreads();
  write_partial<NC>(acc, sm, a.part_t, a.part_m, a.part_l, bi, split, a.nsplit, a.R, row0, rows,
                    a.rv);
}

template <typename K>
int launch(K kern, dim3 grid, size_t smem, cudaStream_t st, const Args& a) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int dispatch_variant(int variant, int block, dim3 grid, cudaStream_t st, const Args& a) {
  const int m = a.hkv * kHD;
  const size_t us_row = (size_t)a.rk * sizeof(T) + 16;
  const size_t vt = (size_t)kHD * kVtStride;
  if (variant == 0 && block == kBS)
    return launch(two_gemm_kernel<T, NC>, grid,
                  sizeof(SoftmaxSmem) + 2 * (size_t)kBS * LDB * sizeof(bf16) + kBS * us_row + vt,
                  st, a);
  if (variant == 1 && (block == 16 || block == 32)) {
    const size_t smem = sizeof(SoftmaxSmem) + (size_t)block * (2 * m + 8) * sizeof(bf16) +
                        block * us_row + vt;
    return block == 16 ? launch(scratch_ab_kernel<T, NC, 1>, grid, smem, st, a)
                       : launch(scratch_ab_kernel<T, NC, 2>, grid, smem, st, a);
  }
  return (int)cudaErrorInvalidValue;
}

// One value width is built: rv in (2 * kThreads, 3 * kThreads], the tools'
// rank_v of 768 (each instantiation costs build time).
template <typename T>
int dispatch_nc(int variant, int block, dim3 grid, cudaStream_t st, const Args& a) {
  return dispatch_variant<T, 3>(variant, block, grid, st, a);
}

}  // namespace

// K9. As xkv_lowrank_decode (K3) with 512 < rv <= 768, but qab is the full-width (b, R, 2*hkv*hd)
// bf16 [qa | qb] with zeros off each row's head; variant 0 (two_gemm, block
// 64) or 1 (scratch_ab, block 16 or 32 keys staged at a time).
extern "C" int xkv_variant_decode(
    const void* qab, const void* k_us, const void* k_vt, long long sb_kvt, long long ld_kvt,
    const void* v_us, const void* v_vt, long long sb_vvt, long long ld_vvt, const void* cos_h,
    const void* sin_h, const void* v_scale, const int* lens, const int* los, void* part_t,
    void* part_m, void* part_l, void* out, void* lse, int b, int R, int hq, int hkv, int hd,
    int s_p, int rk, int rv, int nsplit, int is_int8, int variant, int block, void* stream) {
  if (hd != kHD || rk % kChunkB != 0 || rv <= 2 * kThreads || rv > 3 * kThreads ||
      nsplit < 1 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Args a{(const bf16*)qab, k_us, k_vt, v_us, (const bf16*)cos_h, (const bf16*)sin_h,
               lens, los, (float*)part_t, (float*)part_m, (float*)part_l,
               R, hq, hkv, s_p, rk, rv, sb_kvt, ld_kvt, nsplit};
  dim3 grid(nsplit, (R + kRows - 1) / kRows, b);
  const int err = is_int8 ? dispatch_nc<int8_t>(variant, block, grid, st, a)
                          : dispatch_nc<bf16>(variant, block, grid, st, a);
  if (err != 0) return err;
  return launch_lowrank_merge(part_t, part_m, part_l, v_vt, sb_vvt, ld_vvt, v_scale, out, lse,
                              b, R, hq, hkv, rv, nsplit, st);
}
