// K2, K4, K6, K7 and K8: rank-space decode attention over POST-RoPE
// factors and over the factored MLA latent, for sm_90a.
//
// Replaces, in xkv_tpu/ops/pallas/rankspace_attention.py:
//   K2  rankspace_decode_attention (Pallas body _rankspace_kernel /
//       _rankspace_block_body), bf16 or int8 factors;
//   K6  the same with mixed int8 + packed int4 factors (k_us4/v_us4, body
//       _rankspace_mixed_kernel);
//   K4  sparse_rankspace_decode_attention (body _rankspace_sparse_kernel),
//       K2 over the Quest-selected chunks only;
//   K7  mla_rankspace_decode_attention (body _mla_rankspace_kernel), the
//       absorbed DeepSeek-V2 MLA decode over the factored latent;
//   K8  the same with int8 + packed int4 latent factors (k_us4, body
//       _mla_rankspace_mixed_kernel).
// As there, the q -> rank-space projection (_project_q) and the final
// t @ v_vt projection (_project_out) stay plain tensor code outside.
//
// Bound on the H100: bytes. Per layer and step K2 streams the factor rows
// k_us (s_p x rk) and v_us (s_p x rv) once: ~21 MB at s_p = 8192, rk 512,
// rv 768 in bf16 (half in int8), against ~2 * R * s_p * (rk + rv)
// operations with R = 32 query rows, about 32 FLOP/byte, far below the
// ~295 FLOP/byte ridge. K6 streams 256 + 128 + 256 + 256 bytes per row at
// the 8B split (7.3 MB); K4 reads only the n_sel * chunk selected rows
// (5.2 MB in bf16 at top-4 of 512-row chunks). K7 at DeepSeek-V2-Lite
// (s_p 8192, rank 512, RoPE key 64, R = 16) reads us 8.39 MB, k_pe 1.05 MB
// and r 0.03 MB in bf16 (5.3 MB with int8 us); K8 at 256 int8 + 256 int4
// ranks 4.2 MB: 2.8, 1.6 and 1.3 us at 3.35 TB/s.
//
// Design: flash-decoding (decode_common.cuh). The key blocks of 64 are
// dealt out to `nsplit` CTAs per (32-row chunk, sequence), so a b = 1 step
// fills the card: for K2 and K6 the blocks covering [win_lo, valid_len),
// for K4 the blocks of the selected chunks, each CTA reading the chunk ids
// itself and masking by absolute column (id * chunk + j); a block past the
// segment or outside the live range is never read, and the ragged last
// chunk is masked in the kernel with no padding copy. Per block a CTA
// stages the key rows in shared memory as bf16 (int8 upcast, int4 nibbles
// unpacked to [hi | evens | odds] with the shifts of the Pallas
// _unpack_nibbles; int8 and int4 values are exact in bf16), computes the
// (32 x 64) scores q_emb . k_us^T on mma.sync bf16 tensor cores, runs the
// fp32 online softmax, and accumulates t += P @ v_us with each thread
// owning rank columns of t in registers, reading every v_us byte from
// device memory once (int4 pairs unpacked in the same loop). A second
// kernel merges the splits by log-sum-exp and writes the normalised t and
// lse. Masked scores are the finite NEG_INF, masked probabilities are
// exactly 0, and a row with no live key gets t = 0.
//
// K7 and K8 keep that structure with three changes. V is the latent's own
// us rows: each 64-key block of us is staged to shared memory once (int8
// upcast, int4 unpacked to [hi | evens | odds]) and read there by both the
// score product and P @ us, so us crosses device memory once. A second,
// rope-wide score product runs against the block's k_pe rows. The block's
// r (per-row inverse RMS of the latent) multiplies the nope scores, and P
// before the value product: s = (q_emb . us^T) * r + q_pe . k_pe^T,
// t += round_bf16(P * r) @ us, as the Pallas kernels compute it.
#include "decode_common.cuh"

using namespace xkv;

namespace {

// Operands of one launch. Ranks: rk/rv are the totals (the widths of q_emb
// and t); for mixed factors r8k/r8v int8 ranks and h4k/h4v packed bytes
// per row, so rk = r8k + 2 * h4k and rv = r8v + 2 * h4v.
struct RankspaceArgs {
  const bf16* q_emb;
  const bf16* q_pe;  // K7, K8: (b, R, rope) rotated RoPE queries
  const bf16* k_pe;  // K7, K8: (b, s_p, rope) rotated RoPE keys
  const float* r;    // K7, K8: (b, s_p) latent inverse RMS
  int rope;
  const void* k_us;
  const int8_t* k_us4;
  const void* v_us;
  const int8_t* v_us4;
  const int* lens;
  const int* los;
  const int* ids;  // (b, n_sel) chunk ids, or null
  int n_sel, chunk;
  float* part_t;
  float* part_m;
  float* part_l;
  int R, s_p, rk, rv, r8k, h4k, r8v, h4v, nsplit;
};

// Stage `valid` key rows of mixed factors (r8 int8 ranks, h4 packed int4
// bytes) as bf16 rows [hi | evens | odds]; rows at or past `valid` are 0.
__device__ __forceinline__ void stage_mixed(bf16* dst, int ld, const int8_t* k8,
                                            const int8_t* k4, int r8, int h4, int valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = warp; row < kBS; row += kThreads / 32) {
    const bool ok = row < valid;
    bf16* d = dst + row * ld;
    for (int c = lane; c < r8; c += 32)
      d[c] = __float2bfloat16_rn(ok ? (float)k8[(size_t)row * r8 + c] : 0.f);
    for (int c = lane; c < h4; c += 32) {
      const int x = ok ? (int)k4[(size_t)row * h4 + c] : 0;
      d[r8 + c] = __float2bfloat16_rn((float)(x >> 4));
      d[r8 + h4 + c] = __float2bfloat16_rn((float)(((x & 0xF) ^ 8) - 8));
    }
  }
}

template <typename T, int NC, bool kMixed>
__global__ void __launch_bounds__(kThreads) rankspace_split_kernel(const RankspaceArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  SoftmaxSmem& sm = *reinterpret_cast<SoftmaxSmem*>(smem);
  const int rk = a.rk, rv = a.rv, s_p = a.s_p;
  const int ld = rk + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem + sizeof(SoftmaxSmem));
  bf16* ks = qs + kRows * ld;

  const int split = blockIdx.x, bi = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, a.R - row0);
  const BlockWalk walk =
      block_walk(a.lens, a.los, a.ids, a.n_sel, a.chunk, bi, s_p, split, a.nsplit);
  const T* k_us = reinterpret_cast<const T*>(a.k_us);
  const T* v_us = reinterpret_cast<const T*>(a.v_us);

  stage_as_bf16<bf16>(qs, ld, a.q_emb + ((size_t)bi * a.R + row0) * rk, rk, kRows, rk, rows);
  softmax_init(sm);
  float acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int mt = warp & 1, nt0 = (warp >> 1) * 2;

  for (int v = walk.begin; v < walk.end; ++v) {
    const int key0 = walk.key0(v);
    if (key0 < 0) continue;  // uniform over the CTA
    const int nkeys = min(kBS, s_p - key0);
    const size_t row_base = (size_t)bi * s_p + key0;
    __syncthreads();
    if constexpr (kMixed) {
      stage_mixed(ks, ld, reinterpret_cast<const int8_t*>(a.k_us) + row_base * a.r8k,
                  a.k_us4 + row_base * a.h4k, a.r8k, a.h4k, nkeys);
    } else {
      stage_as_bf16<T>(ks, ld, k_us + row_base * rk, rk, kBS, rk, nkeys);
    }
    __syncthreads();

    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    mma_rows_x_keys(c, qs + (mt * 16 + g) * ld + tq * 2, ld, ks, nt0, g, tq, rk);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = (nt0 + j) * 8 + tq * 2;
      sm.sc[mt * 16 + g][col] = c[j][0];
      sm.sc[mt * 16 + g][col + 1] = c[j][1];
      sm.sc[mt * 16 + g + 8][col] = c[j][2];
      sm.sc[mt * 16 + g + 8][col + 1] = c[j][3];
    }
    __syncthreads();
    softmax_block(sm, rows, key0, walk.lo, walk.hi);
    if constexpr (kMixed) {
      const int r8 = a.r8v, h4 = a.h4v;
      const int8_t* v8 = reinterpret_cast<const int8_t*>(a.v_us) + row_base * r8;
      const int8_t* v4 = a.v_us4 + row_base * h4;
      pv_block_with<NC>(acc, sm, rv, nkeys, [=](int kk, int j) -> float {
        if (j < r8) return (float)v8[(size_t)kk * r8 + j];
        j -= r8;
        const int x = (int)v4[(size_t)kk * h4 + (j < h4 ? j : j - h4)];
        return (float)(j < h4 ? (x >> 4) : (((x & 0xF) ^ 8) - 8));
      });
    } else {
      pv_block<T, NC>(acc, sm, v_us + row_base * rv, rv, nkeys);
    }
  }
  __syncthreads();
  write_partial<NC>(acc, sm, a.part_t, a.part_m, a.part_l, bi, split, a.nsplit, a.R, row0,
                    rows, rv);
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

// K7 and K8: split kernel. rk is the total rank (the width of q_emb, us
// and t); for K8 r8k int8 ranks and h4k packed bytes per row.
template <typename T, int NC, bool kMixed>
__global__ void __launch_bounds__(kThreads) mla_split_kernel(const RankspaceArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  SoftmaxSmem& sm = *reinterpret_cast<SoftmaxSmem*>(smem);
  const int rk = a.rk, rope = a.rope, s_p = a.s_p;
  const int ld = rk + 8, ldp = rope + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem + sizeof(SoftmaxSmem));
  bf16* us = qs + kRows * ld;     // kBS x ld: the block's us rows, K and V
  bf16* qps = us + kBS * ld;      // kRows x ldp
  bf16* kps = qps + kRows * ldp;  // kBS x ldp
  float* rs = reinterpret_cast<float*>(kps + kBS * ldp);  // kBS

  const int split = blockIdx.x, bi = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, a.R - row0);
  const BlockWalk walk =
      block_walk(a.lens, a.los, nullptr, 0, 0, bi, s_p, split, a.nsplit);

  const size_t qrow = (size_t)bi * a.R + row0;
  stage_as_bf16<bf16>(qs, ld, a.q_emb + qrow * rk, rk, kRows, rk, rows);
  stage_as_bf16<bf16>(qps, ldp, a.q_pe + qrow * rope, rope, kRows, rope, rows);
  softmax_init(sm);
  float acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int mt = warp & 1, nt0 = (warp >> 1) * 2;

  for (int v = walk.begin; v < walk.end; ++v) {
    const int key0 = walk.key0(v);
    const int nkeys = min(kBS, s_p - key0);
    const size_t row_base = (size_t)bi * s_p + key0;
    __syncthreads();
    if constexpr (kMixed) {
      stage_mixed(us, ld, reinterpret_cast<const int8_t*>(a.k_us) + row_base * a.r8k,
                  a.k_us4 + row_base * a.h4k, a.r8k, a.h4k, nkeys);
    } else {
      stage_as_bf16<T>(us, ld, reinterpret_cast<const T*>(a.k_us) + row_base * rk, rk, kBS,
                       rk, nkeys);
    }
    stage_as_bf16<bf16>(kps, ldp, a.k_pe + row_base * rope, rope, kBS, rope, nkeys);
    for (int c = threadIdx.x; c < kBS; c += kThreads)
      rs[c] = c < nkeys ? a.r[row_base + c] : 0.f;
    __syncthreads();

    // (32 x 64) nope scores against us and pe scores against k_pe.
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float cp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    mma_rows_x_keys(c, qs + (mt * 16 + g) * ld + tq * 2, ld, us, nt0, g, tq, rk);
    mma_rows_x_keys(cp, qps + (mt * 16 + g) * ldp + tq * 2, ldp, kps, nt0, g, tq, rope);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = (nt0 + j) * 8 + tq * 2;
      const float r0 = rs[col], r1 = rs[col + 1];
      sm.sc[mt * 16 + g][col] = c[j][0] * r0 + cp[j][0];
      sm.sc[mt * 16 + g][col + 1] = c[j][1] * r1 + cp[j][1];
      sm.sc[mt * 16 + g + 8][col] = c[j][2] * r0 + cp[j][2];
      sm.sc[mt * 16 + g + 8][col + 1] = c[j][3] * r1 + cp[j][3];
    }
    __syncthreads();
    softmax_block(sm, rows, key0, walk.lo, walk.hi, rs);
    const bf16* ub = us;
    pv_block_with<NC>(acc, sm, rk, nkeys, [=](int kk, int j) -> float {
      return __bfloat162float(ub[kk * ld + j]);
    });
  }
  __syncthreads();
  write_partial<NC>(acc, sm, a.part_t, a.part_m, a.part_l, bi, split, a.nsplit, a.R, row0,
                    rows, rk);
}

template <typename Kern>
int launch(Kern kern, dim3 grid, size_t smem, cudaStream_t st, const RankspaceArgs& a) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int NC, bool kMixed>
int launch_split(dim3 grid, size_t smem, cudaStream_t st, const RankspaceArgs& a) {
  return launch(rankspace_split_kernel<T, NC, kMixed>, grid, smem, st, a);
}

template <typename T, int NC, bool kMixed>
int launch_mla(dim3 grid, size_t smem, cudaStream_t st, const RankspaceArgs& a) {
  return launch(mla_split_kernel<T, NC, kMixed>, grid, smem, st, a);
}

// Merge the splits of every row into t_out (b, R, rv) and lse_out (b, R).
int merge(const RankspaceArgs& a, int b, int rv, void* t_out, void* lse_out, cudaStream_t st) {
  const size_t msmem = (8 + (size_t)a.nsplit) * sizeof(float);
  rankspace_merge_kernel<<<dim3(a.R, b), kThreads, msmem, st>>>(
      a.part_t, a.part_m, a.part_l, (float*)t_out, (float*)lse_out, a.R, rv, a.nsplit);
  return (int)cudaGetLastError();
}

// Split kernel for the launch's value width, then the merge.
template <typename T, bool kMixed>
int run(const RankspaceArgs& a, int b, void* t_out, void* lse_out, void* stream) {
  if (a.rk % 16 != 0 || a.rv > 4 * kThreads || a.nsplit < 1) return (int)cudaErrorInvalidValue;
  if (a.ids != nullptr && (a.chunk % kBS != 0 || a.chunk <= 0 || a.n_sel < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(SoftmaxSmem) + (size_t)(kRows + kBS) * (a.rk + 8) * sizeof(bf16);
  const dim3 grid(a.nsplit, (a.R + kRows - 1) / kRows, b);
  int err;
  switch ((a.rv + kThreads - 1) / kThreads) {
    case 1: err = launch_split<T, 1, kMixed>(grid, smem, st, a); break;
    case 2: err = launch_split<T, 2, kMixed>(grid, smem, st, a); break;
    case 3: err = launch_split<T, 3, kMixed>(grid, smem, st, a); break;
    case 4: err = launch_split<T, 4, kMixed>(grid, smem, st, a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return merge(a, b, a.rv, t_out, lse_out, st);
}

// K7 / K8 split kernel for the launch's rank, then the merge.
template <typename T, bool kMixed>
int run_mla(const RankspaceArgs& a, int b, void* t_out, void* lse_out, void* stream) {
  if (a.rk % 16 != 0 || a.rope % 16 != 0 || a.rk > 4 * kThreads || a.nsplit < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(SoftmaxSmem) + (size_t)(kRows + kBS) * (a.rk + 8) * sizeof(bf16) +
                      (size_t)(kRows + kBS) * (a.rope + 8) * sizeof(bf16) + kBS * sizeof(float);
  const dim3 grid(a.nsplit, (a.R + kRows - 1) / kRows, b);
  int err;
  switch ((a.rk + kThreads - 1) / kThreads) {
    case 1: err = launch_mla<T, 1, kMixed>(grid, smem, st, a); break;
    case 2: err = launch_mla<T, 2, kMixed>(grid, smem, st, a); break;
    case 3: err = launch_mla<T, 3, kMixed>(grid, smem, st, a); break;
    case 4: err = launch_mla<T, 4, kMixed>(grid, smem, st, a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return merge(a, b, a.rk, t_out, lse_out, st);
}

RankspaceArgs base_args(const void* q_emb, const void* k_us, const void* v_us,
                        const int* lens, const int* los, void* part_t, void* part_m,
                        void* part_l, int R, int s_p, int rk, int rv, int nsplit) {
  RankspaceArgs a{};
  a.q_emb = (const bf16*)q_emb;
  a.k_us = k_us;
  a.v_us = v_us;
  a.lens = lens;
  a.los = los;
  a.part_t = (float*)part_t;
  a.part_m = (float*)part_m;
  a.part_l = (float*)part_l;
  a.R = R;
  a.s_p = s_p;
  a.rk = a.r8k = rk;
  a.rv = a.r8v = rv;
  a.nsplit = nsplit;
  return a;
}

}  // namespace

// K2. q_emb (b, R, rk) bf16; k_us (b, s_p, rk), v_us (b, s_p, rv) bf16 or
// int8, contiguous; lens/los (b,) int32 live range [los, lens). Scratch
// part_t (b, nsplit, R, rv), part_m/part_l (b, nsplit, R) fp32. Writes
// t_out (b, R, rv) and lse_out (b, R) fp32. Returns cudaGetLastError().
extern "C" int xkv_rankspace_decode(const void* q_emb, const void* k_us, const void* v_us,
                                    const int* lens, const int* los, void* part_t,
                                    void* part_m, void* part_l, void* t_out, void* lse_out,
                                    int b, int R, int s_p, int rk, int rv, int nsplit,
                                    int is_int8, void* stream) {
  const RankspaceArgs a =
      base_args(q_emb, k_us, v_us, lens, los, part_t, part_m, part_l, R, s_p, rk, rv, nsplit);
  return is_int8 ? run<int8_t, false>(a, b, t_out, lse_out, stream)
                 : run<bf16, false>(a, b, t_out, lse_out, stream);
}

// K4. As K2, over the rows of the selected chunks: ids (b, n_sel) int32,
// chunk id i covering rows [i * chunk, (i + 1) * chunk) (chunk a multiple
// of 64); an id < 0 selects nothing.
extern "C" int xkv_sparse_rankspace_decode(const void* q_emb, const void* k_us,
                                           const void* v_us, const int* ids, const int* lens,
                                           const int* los, void* part_t, void* part_m,
                                           void* part_l, void* t_out, void* lse_out, int b,
                                           int R, int s_p, int rk, int rv, int n_sel,
                                           int chunk, int nsplit, int is_int8,
                                           void* stream) {
  RankspaceArgs a =
      base_args(q_emb, k_us, v_us, lens, los, part_t, part_m, part_l, R, s_p, rk, rv, nsplit);
  a.ids = ids;
  a.n_sel = n_sel;
  a.chunk = chunk;
  return is_int8 ? run<int8_t, false>(a, b, t_out, lse_out, stream)
                 : run<bf16, false>(a, b, t_out, lse_out, stream);
}

// K6. q_emb (b, R, r8k + 2 * h4k) bf16 in [hi | lo-eo] column order;
// k_us8 (b, s_p, r8k), k_us4 (b, s_p, h4k), v_us8 (b, s_p, r8v), v_us4
// (b, s_p, h4v) int8 contiguous, the *4 streams packed int4 pairs. Writes
// t_out (b, R, r8v + 2 * h4v) in [hi | lo-eo] order and lse_out (b, R).
extern "C" int xkv_mixed_rankspace_decode(const void* q_emb, const void* k_us8,
                                          const void* k_us4, const void* v_us8,
                                          const void* v_us4, const int* lens, const int* los,
                                          void* part_t, void* part_m, void* part_l,
                                          void* t_out, void* lse_out, int b, int R, int s_p,
                                          int r8k, int h4k, int r8v, int h4v, int nsplit,
                                          void* stream) {
  RankspaceArgs a = base_args(q_emb, k_us8, v_us8, lens, los, part_t, part_m, part_l, R, s_p,
                              r8k + 2 * h4k, r8v + 2 * h4v, nsplit);
  a.k_us4 = (const int8_t*)k_us4;
  a.v_us4 = (const int8_t*)v_us4;
  a.r8k = r8k;
  a.h4k = h4k;
  a.r8v = r8v;
  a.h4v = h4v;
  return run<int8_t, true>(a, b, t_out, lse_out, stream);
}

// K7 (k_us4 null): q_emb (b, R, r8) bf16; k_us (b, s_p, r8) bf16 or int8
// (is_int8). K8 (k_us4 set): q_emb (b, R, r8 + 2 * h4) in [hi | lo-eo]
// column order, k_us (b, s_p, r8) int8 and k_us4 (b, s_p, h4) packed int4
// pairs. Both: q_pe (b, R, rope) and k_pe (b, s_p, rope) bf16, r (b, s_p)
// fp32, all contiguous; lens/los (b,) int32 live range [los, lens);
// scratch as K2's. Writes t_out (b, R, rk) in q_emb's rank order and
// lse_out (b, R) fp32. Returns cudaGetLastError().
extern "C" int xkv_mla_rankspace_decode(const void* q_emb, const void* q_pe, const void* k_us,
                                        const void* k_us4, const void* k_pe, const void* r,
                                        const int* lens, const int* los, void* part_t,
                                        void* part_m, void* part_l, void* t_out,
                                        void* lse_out, int b, int R, int s_p, int r8, int h4,
                                        int rope, int nsplit, int is_int8, void* stream) {
  RankspaceArgs a = base_args(q_emb, k_us, nullptr, lens, los, part_t, part_m, part_l, R, s_p,
                              r8 + 2 * h4, 0, nsplit);
  a.q_pe = (const bf16*)q_pe;
  a.k_pe = (const bf16*)k_pe;
  a.r = (const float*)r;
  a.rope = rope;
  a.r8k = r8;
  a.h4k = h4;
  a.k_us4 = (const int8_t*)k_us4;
  if (k_us4 != nullptr) {
    if (!is_int8) return (int)cudaErrorInvalidValue;
    return run_mla<int8_t, true>(a, b, t_out, lse_out, stream);
  }
  return is_int8 ? run_mla<int8_t, false>(a, b, t_out, lse_out, stream)
                 : run_mla<bf16, false>(a, b, t_out, lse_out, stream);
}
