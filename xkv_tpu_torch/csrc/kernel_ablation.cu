// K10: stage ablation of K3, for sm_90a. A timing tool: with a stage off
// the numbers are wrong on purpose.
//
// Replaces scripts/kernel_ablation.py `build_step` (Pallas body `_kernel`):
// a K3-shaped pass over int8 factors whose stages can be switched off.
//   recon     rebuild K = k_us @ k_vt (int8 x int8 -> int32); off: the k_us
//             row tiled to width, K[k][c] = k_us[k][c % rk]
//   scalemul  times the per-column K scale (fp32)
//   rope      absolute RoPE of the rebuilt keys (fp32, half tables) -> bf16;
//             `roll` is the same rotation from full-width tables with
//             rotate_half's sign folded into sin (equal in fp32, no
//             contraction); `ropeq` the relative-angle form: bf16 K times
//             the bf16 relative cos and sin fields, both contracted with q
//   scores    q @ K^T * scale over all hkv * hd columns for every query
//             row (off: the score of key k is K[k][0] * scale for all rows)
//   softmax   the online softmax (off: P = S, running max never written)
//   vpath     t = alpha t + bf16(P) @ v_us (off: alpha t + rowsum(P) + the
//             block's first v_us row)
// Output: o = t[:, :hd] (not normalised, no v_vt product) in bf16 and the
// running max m (-inf with softmax off).
//
// Bound on the H100 (the `full` stage set): operations, the int8 rebuild
// 2 * s * rk * m over 1,979 TOP/s plus the bf16 products 2 * hq * s * (m +
// rv) over 989 TFLOP/s.
//
// Design: K3's split kernel (lowrank_attention.cu) with its rebuild
// (rebuild_head, lowrank_common.cuh) and the stages as compile-time
// switches, so each stage set's time attributes K3's own time on this card.
// The TPU kernel walks the 64-key blocks in order; here they are dealt out
// to `nsplit` CTAs and merged as t = sum_j t_j exp(m_j - m), m = max_j m_j
// (softmax off: the parts add). The block structure is part of the
// function: `-vpath` adds each 64-key block's first v_us row, weighted by
// exp(running max then - m). Unlike K3, the keys are staged in fp32 before
// the rotation, since absolute RoPE pairs column d with d + hd/2, which
// another warp rebuilt; and all query rows are staged in shared memory and
// contracted with every head on mma.sync.
#include "lowrank_common.cuh"

using namespace xkv;

namespace {

enum : int {
  kRecon = 1, kScaleMul = 2, kRope = 4, kScores = 8, kSoftmax = 16, kVPath = 32,
  kRoll = 64, kRopeQ = 128,
};
constexpr int kAll = kRecon | kScaleMul | kRope | kScores | kSoftmax | kVPath;
constexpr int LDP = kHD + 4;  // fp32 row stride of the staged keys
constexpr int LDB = kHD + 8;  // bf16 row stride of the rotated keys

// c[j] += q_rows . kbuf_j^T over one head's kHD columns: A is the warp's 16
// query rows (qa at row rt*16 + g, column tq*2 of the head), B_j the 8 keys
// (nt0 + j) * 8 + g of kbuf.
__device__ __forceinline__ void score_mma(float (&c)[2][4], const bf16* qa, int ldq,
                                          const bf16* kbuf, int nt0, int g, int tq) {
#pragma unroll 4
  for (int kk = 0; kk < kHD / 16; ++kk) {
    const bf16* qk = qa + kk * 16;
    const uint32_t af[4] = {*reinterpret_cast<const uint32_t*>(qk),
                            *reinterpret_cast<const uint32_t*>(qk + 8 * ldq),
                            *reinterpret_cast<const uint32_t*>(qk + 8),
                            *reinterpret_cast<const uint32_t*>(qk + 8 * ldq + 8)};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bf16* kr = kbuf + ((nt0 + j) * 8 + g) * LDB + kk * 16 + tq * 2;
      mma_bf16_16816(c[j], af, *reinterpret_cast<const uint32_t*>(kr),
                     *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }
}

template <int ST, int NC>
__global__ void __launch_bounds__(kThreads) ablation_split_kernel(
    const bf16* __restrict__ q, const int8_t* __restrict__ k_us,
    const int8_t* __restrict__ k_vt, const int8_t* __restrict__ v_us,
    const float* __restrict__ k_scale, const bf16* __restrict__ cos_tab,
    const bf16* __restrict__ sin_tab, const float* __restrict__ trig,
    float* __restrict__ part_t, float* __restrict__ part_m, int hq, int hkv, int s, int rk,
    int rv, int tw, float scale, int nsplit) {
  constexpr bool kRotate = (ST & (kRope | kRoll)) != 0;
  constexpr bool kRelative = (ST & kRopeQ) != 0;
  const int m = hkv * kHD, ldq = m + 8, us_stride = rk + 16;
  extern __shared__ __align__(16) unsigned char smem[];
  SoftmaxSmem& sm = *reinterpret_cast<SoftmaxSmem*>(smem);
  float* rsum = reinterpret_cast<float*>(smem + sizeof(SoftmaxSmem));  // [kRows]
  float* col0 = rsum + kRows;                                           // [kBS]
  float* kp = col0 + kBS;                                               // [kBS][LDP]
  bf16* ka = reinterpret_cast<bf16*>(kp + kBS * LDP);                   // [kBS][LDB]
  bf16* kb = ka + kBS * LDB;                                            // [kBS][LDB]
  bf16* qs = kb + kBS * LDB;                                            // [kRows][ldq]
  unsigned char* us_s = reinterpret_cast<unsigned char*>(qs + kRows * ldq);
  unsigned char* vt_s = us_s + kBS * us_stride;  // [kHD][kVtStride]

  const int split = blockIdx.x, bi = blockIdx.z;
  const int rows = hq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rt = warp & 1, kg = warp >> 1;  // score tile: 16 rows x 16 keys

  for (int i = threadIdx.x; i < kRows * (m / 8); i += kThreads) {
    const int r = i / (m / 8), c = (i % (m / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < rows) x = *reinterpret_cast<const uint4*>(q + ((size_t)bi * hq + r) * m + c);
    *reinterpret_cast<uint4*>(qs + r * ldq + c) = x;
  }
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    sm.m[r] = -INFINITY;
    sm.alpha[r] = 1.f;
  }
  float acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  const int nblk = s / kBS;
  const int per = (nblk + nsplit - 1) / nsplit;
  const int begin = min(split * per, nblk), end = min(begin + per, nblk);
  const int8_t* kvt_b = k_vt + (size_t)bi * rk * m;
  const float* ksc = k_scale + (size_t)bi * m;

  for (int v = begin; v < end; ++v) {
    const int key0 = v * kBS;
    __syncthreads();
    stage_us_rows<int8_t>(us_s, us_stride, k_us + ((size_t)bi * s + key0) * rk, rk, kBS, kBS);
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int hk = 0; hk < hkv; ++hk) {
      // K of head hk into kp (fp32), scaled per column where that stage is on.
      if constexpr ((ST & kRecon) != 0) {
        int kacc[8][4];
        rebuild_head<int8_t, 4>(kacc, us_s, us_stride, vt_s, kvt_b, m, hk, rk);
        const int mt = warp % 4, nbase = (warp / 4) * 64;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = mt * 16 + g + (e >> 1) * 8;
            const int col = nbase + nt * 8 + tq * 2 + (e & 1);
            float x = (float)kacc[nt][e];
            if constexpr ((ST & kScaleMul) != 0 && !kRelative) x = __fmul_rn(x, ksc[hk * kHD + col]);
            kp[key * LDP + col] = x;
          }
        }
      } else {
        __syncthreads();  // k_us staged
        for (int i = threadIdx.x; i < kBS * kHD; i += kThreads) {
          const int key = i / kHD, col = i % kHD;
          float x = (float)reinterpret_cast<const int8_t*>(us_s)[key * us_stride +
                                                                 (hk * kHD + col) % rk];
          if constexpr ((ST & kScaleMul) != 0 && !kRelative) x = __fmul_rn(x, ksc[hk * kHD + col]);
          kp[key * LDP + col] = x;
        }
      }
      __syncthreads();
      // Rotate (or round) into ka, and kb for the relative form.
      for (int i = threadIdx.x; i < kBS * kHD; i += kThreads) {
        const int key = i / kHD, d = i % kHD;
        const float x = kp[key * LDP + d];
        const size_t trow = (size_t)(key0 + key) * tw;
        bf16 out_a;
        if constexpr (kRotate) {
          const float y = kp[key * LDP + (d ^ (kHD / 2))];
          float cs, sn;
          if constexpr ((ST & kRoll) != 0) {
            cs = __bfloat162float(cos_tab[trow + d]);
            sn = __bfloat162float(sin_tab[trow + d]);
          } else {
            cs = __bfloat162float(cos_tab[trow + (d % (kHD / 2))]);
            sn = __bfloat162float(sin_tab[trow + (d % (kHD / 2))]);
            if (d < kHD / 2) sn = -sn;
          }
          out_a = __float2bfloat16_rn(__fadd_rn(__fmul_rn(x, cs), __fmul_rn(y, sn)));
        } else if constexpr (kRelative) {
          const float cb = __bfloat162float(cos_tab[trow + d]);
          const float sb = __bfloat162float(sin_tab[trow + d]);
          const float ct = trig[d], st = trig[kHD + d];
          const float crel = __fadd_rn(__fmul_rn(cb, ct), __fmul_rn(sb, st));
          const float srel = __fsub_rn(__fmul_rn(sb, ct), __fmul_rn(cb, st));
          const bf16 kx = __float2bfloat16_rn(x);
          out_a = __hmul(kx, __float2bfloat16_rn(crel));
          kb[key * LDB + d] = __hmul(kx, __float2bfloat16_rn(srel));
        } else {
          out_a = __float2bfloat16_rn(x);
        }
        ka[key * LDB + d] = out_a;
        if constexpr ((ST & kScores) == 0) {
          if (hk == 0 && d == 0) col0[key] = __bfloat162float(out_a);
        }
      }
      __syncthreads();
      if constexpr ((ST & kScores) != 0) {
        const bf16* qa = qs + (rt * 16 + g) * ldq + hk * kHD + tq * 2;
        score_mma(c, qa, ldq, ka, kg * 2, g, tq);
        if constexpr (kRelative) score_mma(c, qa, ldq, kb, kg * 2, g, tq);
      }
    }
    if constexpr ((ST & kScores) != 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rt * 16 + g + (e >> 1) * 8;
          const int key = (kg * 2 + j) * 8 + tq * 2 + (e & 1);
          sm.sc[r][key] = kRelative ? c[j][e] : __fmul_rn(c[j][e], scale);
        }
    } else {
      for (int i = threadIdx.x; i < kRows * kBS; i += kThreads)
        sm.sc[i / kBS][i % kBS] = __fmul_rn(col0[i % kBS], scale);
    }
    __syncthreads();
    for (int r = warp; r < kRows; r += kThreads / 32) {
      const float x0 = sm.sc[r][lane], x1 = sm.sc[r][lane + 32];
      float p0 = x0, p1 = x1, alpha = 1.f, m_new = 0.f;
      if constexpr ((ST & kSoftmax) != 0) {
        const float m_old = sm.m[r];
        m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
        p0 = __expf(x0 - m_new);
        p1 = __expf(x1 - m_new);
        alpha = __expf(m_old - m_new);
      }
      if (r >= rows) p0 = p1 = 0.f;
      sm.pT[lane][r] = round_bf16(p0);
      sm.pT[lane + 32][r] = round_bf16(p1);
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        if constexpr ((ST & kSoftmax) != 0) sm.m[r] = m_new;
        sm.alpha[r] = alpha;
        rsum[r] = psum;
      }
    }
    __syncthreads();
    const int8_t* vb = v_us + ((size_t)bi * s + key0) * rv;
    if constexpr ((ST & kVPath) != 0) {
      pv_block<int8_t, NC>(acc, sm, vb, rv, kBS);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float a = sm.alpha[r], rs = rsum[r];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int j = threadIdx.x + cc * kThreads;
          const float v0 = j < rv ? (float)vb[j] : 0.f;
          acc[r][cc] = __fadd_rn(__fadd_rn(__fmul_rn(acc[r][cc], a), rs), v0);
        }
      }
    }
  }
  __syncthreads();
  const size_t base = ((size_t)bi * nsplit + split) * hq;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int j = threadIdx.x + cc * kThreads;
        if (j < rv) part_t[(base + r) * rv + j] = acc[r][cc];
      }
    }
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) part_m[base + r] = sm.m[r];
}

// One CTA per (row, sequence): o = sum_j w_j t_j[:kHD], w_j = exp(m_j - M)
// (1 when M = -inf: softmax off), and M.
__global__ void __launch_bounds__(kHD) ablation_merge_kernel(
    const float* __restrict__ part_t, const float* __restrict__ part_m, bf16* __restrict__ out,
    float* __restrict__ m_out, int hq, int rv, int nsplit) {
  const int r = blockIdx.x, bi = blockIdx.y, j = threadIdx.x;
  float M = -INFINITY;
  for (int i = 0; i < nsplit; ++i) M = fmaxf(M, part_m[((size_t)bi * nsplit + i) * hq + r]);
  float o = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const size_t idx = ((size_t)bi * nsplit + i) * hq + r;
    const float w = M == -INFINITY ? 1.f : __expf(part_m[idx] - M);
    o += w * part_t[idx * rv + j];
  }
  out[((size_t)bi * hq + r) * kHD + j] = __float2bfloat16_rn(o);
  if (j == 0) m_out[(size_t)bi * hq + r] = M;
}

struct Args {
  const void *q, *k_us, *k_vt, *v_us, *k_scale, *cos_tab, *sin_tab, *trig;
  void *part_t, *part_m;
  int b, hq, hkv, s, rk, rv, tw;
  float scale;
  int nsplit;
};

template <int ST, int NC>
int launch_split(const Args& a, size_t smem, cudaStream_t st) {
  auto kern = ablation_split_kernel<ST, NC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(a.nsplit, 1, a.b), kThreads, smem, st>>>(
      (const bf16*)a.q, (const int8_t*)a.k_us, (const int8_t*)a.k_vt, (const int8_t*)a.v_us,
      (const float*)a.k_scale, (const bf16*)a.cos_tab, (const bf16*)a.sin_tab,
      (const float*)a.trig, (float*)a.part_t, (float*)a.part_m, a.hq, a.hkv, a.s, a.rk, a.rv,
      a.tw, a.scale, a.nsplit);
  return (int)cudaGetLastError();
}

// One value width is built: rv in (2 * kThreads, 3 * kThreads], the tools'
// rank_v of 768 (each instantiation costs build time).
template <int ST>
int dispatch_nc(const Args& a, size_t smem, cudaStream_t st) {
  return launch_split<ST, 3>(a, smem, st);
}

}  // namespace

// q (b, hq, hkv*hd) bf16; k_us (b, s, rk), k_vt (b, rk, hkv*hd), v_us
// (b, s, rv) int8, 512 < rv <= 768; k_scale (b, hkv*hd) fp32; cos_tab/sin_tab (s, tw) bf16
// (tw = hd/2 half tables for `rope`, hd for `roll` and `ropeq`); trig (2,
// hd) fp32 [cos_t; sin_t]; all contiguous. `stages` is a bitmask of the
// stage enum above, one of the tool's ten stage sets. Scratch part_t (b,
// nsplit, hq, rv), part_m (b, nsplit, hq) fp32. Writes out (b, hq, hd)
// bf16 and m_out (b, hq) fp32.
extern "C" int xkv_ablation_step(const void* q, const void* k_us, const void* k_vt,
                                 const void* v_us, const void* k_scale, const void* cos_tab,
                                 const void* sin_tab, const void* trig, void* part_t,
                                 void* part_m, void* out, void* m_out, int b, int hq, int hkv,
                                 int hd, int s, int rk, int rv, int tw, float scale, int stages,
                                 int nsplit, void* stream) {
  const int m = hkv * kHD;
  if (hd != kHD || hq < 1 || hq > kRows || m > 1024 || s % kBS != 0 || rk % kChunkB != 0 ||
      rv <= 2 * kThreads || rv > 3 * kThreads || nsplit < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Args a{q, k_us, k_vt, v_us, k_scale, cos_tab, sin_tab, trig, part_t, part_m,
               b, hq, hkv, s, rk, rv, tw, scale, nsplit};
  const size_t smem = sizeof(SoftmaxSmem) + (size_t)(kRows + kBS) * sizeof(float) +
                      (size_t)kBS * LDP * sizeof(float) + 2 * (size_t)kBS * LDB * sizeof(bf16) +
                      (size_t)kRows * (m + 8) * sizeof(bf16) + (size_t)kBS * (rk + 16) +
                      (size_t)kHD * kVtStride;
  int err;
  switch (stages) {
    case kAll: err = dispatch_nc<kAll>(a, smem, st); break;
    case kAll & ~kRecon: err = dispatch_nc<kAll & ~kRecon>(a, smem, st); break;
    case kAll & ~kScaleMul: err = dispatch_nc<kAll & ~kScaleMul>(a, smem, st); break;
    case kAll & ~kRope: err = dispatch_nc<kAll & ~kRope>(a, smem, st); break;
    case kAll & ~kScores: err = dispatch_nc<kAll & ~kScores>(a, smem, st); break;
    case kAll & ~kSoftmax: err = dispatch_nc<kAll & ~kSoftmax>(a, smem, st); break;
    case kAll & ~kVPath: err = dispatch_nc<kAll & ~kVPath>(a, smem, st); break;
    case (kAll & ~kRope) | kRoll: err = dispatch_nc<(kAll & ~kRope) | kRoll>(a, smem, st); break;
    case (kAll & ~kRope) | kRopeQ: err = dispatch_nc<(kAll & ~kRope) | kRopeQ>(a, smem, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  ablation_merge_kernel<<<dim3(hq, b), kHD, 0, st>>>((const float*)part_t, (const float*)part_m,
                                                     (bf16*)out, (float*)m_out, hq, rv, nsplit);
  return (int)cudaGetLastError();
}
