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
// Design (head-split flash-decoding):
// - One CTA per (kv head, 16-row tile of that head's ql*gsz query rows,
//   key split, value slice, sequence); one value slice holds every rank up
//   to 1024 (t's share of a thread stays in registers), past that slices
//   of at most 1024, each of which rebuilds the keys again (value_slice).
//   The 64-key blocks of the live columns
//   [win_lo, valid_len) (K3), or of the selected chunks (K5, each CTA
//   reading the chunk ids itself: BlockWalk, decode_common.cuh), are dealt
//   out to `nsplit` splits, chosen so that the grid fills the SMs.
// - The head's k_vt slice (rk x hd) is loaded into shared memory once per
//   CTA and stays there for all its blocks: bf16 in its own [rank][col]
//   layout; int8 transposed once to [col][rank] (the int8 products take
//   K-major operands only). At hd 128 both in the 128-byte swizzle that
//   wgmma reads.
// - A producer warp keeps a 4-stage ring full by TMA: per block the
//   chunks (64 rows x 256 bytes, two 128-byte-swizzled panels) of k_us
//   rows, of the key positions' [cos | sin] rows and of v_us rows, with an
//   mbarrier full/empty pair per stage; the 8 consumer warps never wait
//   for the loads' issue. (A cluster of the split's kv heads sharing each
//   chunk by multicast was slower: the loads were not the limit.)
// - Where the slice does not fit beside that ring (bf16 hd 128 above rk
//   512, int8 hd 128 above rk 1024, bf16 hd 64 above rk 1024, int8 hd 64
//   above rk 2304), k_vt streams in rank chunks beside the k_us chunks
//   through a cp.async ring instead (lowrank_stream_split_kernel).
// - Rebuild at hd 128 on wgmma: per k_us chunk each warpgroup issues
//   m64n64 products (bf16 k16 with k_vt MN-major, or int8 k32 with k_vt
//   K-major) for its half of the head's columns, both operands in shared
//   memory. At hd 64, and in the streamed kernel, on mma.sync.
// - mma.sync rebuilds are fed by ldmatrix: bf16 m16n8k16 -> fp32, int8
//   m16n8k32 -> int32; 8 warps as 4 key tiles x 2 column halves. The keys
//   are rounded to bf16 and multiplied by the bf16 trig in registers; those
//   fragments are the B operand of the score product [qa | qb] .
//   [K*cos | K*sin] (as FlashAttention-2 reuses S as P's A operand), whose
//   A operand, the head's query rows padded to 16, stays in registers.
// - fp32 online softmax; P rounded to bf16; t += P @ v_us on mma.sync.
// - Merge: one CTA per (head, row tile, 64-rank chunk, sequence) combines
//   the splits by log-sum-exp, rounds the normalised, V-scaled t to bf16
//   and forms the chunk's share of t @ v_vt over the head's columns,
//   reading v_vt rows coalesced; the last of a head's chunk CTAs sums the
//   shares in chunk order.
// Masked scores are the finite NEG_INF, masked probabilities are exactly
// 0, a row with no live key outputs 0, and lse = m + log(max(l, 1e-30)).
// The resident split kernel and the merge live in lowrank_tma.cuh, shared
// with K9 (kernel_variants.cu), which instantiates them with other score
// stages; this file holds the streamed kernel and the entry points.
#include "lowrank_tma.cuh"

// One unnamed namespace a source, the header's (inside xkv): nvcc's stubs
// name every unnamed namespace of a source alike.
namespace xkv {
namespace {

constexpr int kMaxVC = 16;  // 64-rank value chunks of a slice: <= 1024 ranks

// cp.async `rows` rows of `bytes` (a multiple of 16) from src (row stride
// src_ld bytes) into dst (row stride dst_ld); rows at or past `valid` are
// zero-filled.
__device__ __forceinline__ void stage_rows(unsigned char* dst, int dst_ld,
                                           const unsigned char* src, size_t src_ld, int rows,
                                           int bytes, int valid) {
  const int per = bytes >> 4;
  for (int i = threadIdx.x; i < rows * per; i += kT) {
    const int r = i / per, c = (i - r * per) << 4;
    const bool ok = r < valid;
    cp_async16(dst + r * dst_ld + c, ok ? src + (size_t)r * src_ld + c : src, ok);
  }
}

// Four int8 values at rows k0..k0+3 (stride ld bytes) of one column, as
// one mma.sync B register (lowest row in the lowest byte).
__device__ __forceinline__ uint32_t gather4(const unsigned char* p, int ld) {
  return (uint32_t)p[0] | ((uint32_t)p[ld] << 8) | ((uint32_t)p[2 * ld] << 16) |
         ((uint32_t)p[3 * ld] << 24);
}

// The split kernel of the streamed path (k_vt slices too large to stay
// resident): one CTA per (kv head, row tile, key split, sequence), every
// chunk loaded by cp.async into a 4-stage ring of (64 rows x 128 bytes)
// chunks, the k_us chunks beside the k_vt rank chunk they multiply.
// kSliced: value slices of `vslice` ranks on the grid (rv > 1024); without,
// one slice of every rank, the code of the main path's shapes.
template <typename T, int HD, bool kSliced>
__global__ void __launch_bounds__(kT, 1) lowrank_stream_split_kernel(
    const bf16* __restrict__ qab, const T* __restrict__ k_us, const T* __restrict__ k_vt,
    const T* __restrict__ v_us, const bf16* __restrict__ cos_h,
    const bf16* __restrict__ sin_h, const int* __restrict__ lens,
    const int* __restrict__ los, const int* __restrict__ ids, int n_sel, int chunk,
    float* __restrict__ part_t, float* __restrict__ part_m, float* __restrict__ part_l,
    int* __restrict__ done, int R, int hq, int hkv, int s_p, int rk, int rv, long long sb_kvt,
    long long ld_kvt, int nsplit, int ntiles, int vslice) {
  using L = Layout<T, HD>;
  using Acc = typename std::conditional<sizeof(T) == 2, float, int>::type;
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int kNT = HD / 16;  // rebuild n-tiles of a warp's column half
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  constexpr int stage_b = L::kStage;
  bf16* q_s = reinterpret_cast<bf16*>(ring + kStages * stage_b);
  float* sc = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(q_s) + L::kQBytes);
  bf16* p_s = reinterpret_cast<bf16*>(sc + 2 * kHR * kBS);
  float* m_s = reinterpret_cast<float*>(p_s + kHR * L::kPLd);
  float* l_s = m_s + kHR;
  float* a_s = l_s + kHR;

  // Value slice vs holds ranks [v0, v0 + rvs).
  const int nvs = kSliced ? (rv + vslice - 1) / vslice : 1;
  const int split = kSliced ? blockIdx.x / nvs : blockIdx.x, bi = blockIdx.z;
  const int vs = kSliced ? blockIdx.x % nvs : 0;
  const int v0 = vs * vslice, rvs = kSliced ? min(vslice, rv - v0) : rv;
  const int hk = blockIdx.y / ntiles, rt = blockIdx.y % ntiles;
  const int gsz = hq / hkv;
  const int head_rows = (R / hq) * gsz;
  const int nrows = min(kHR, head_rows - rt * kHR);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int mt = warp & 3, half = warp >> 2;  // key tile, column half
  const BlockWalk walk = block_walk(lens, los, ids, n_sel, chunk, bi, s_p, split, nsplit);
  if (blockIdx.x == 0 && threadIdx.x == 0) done[((size_t)bi * hkv + hk) * ntiles + rt] = 0;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the merge may start
  auto grow = [&](int i) {  // the tile's row i -> row of (ql, hq)
    const int hr = rt * kHR + i;
    return (hr / gsz) * hq + hk * gsz + hr % gsz;
  };

  const int us_bytes = rk * (int)sizeof(T);
  const int nk = (us_bytes + kChunk - 1) / kChunk;
  const int nv = (rvs + 63) / 64;
  const int nch = nk + 2 + nv;
  const T* kvt_b = k_vt + (size_t)bi * sb_kvt + hk * HD;
  const unsigned char* kus_b = reinterpret_cast<const unsigned char*>(k_us + (size_t)bi * s_p * rk);
  const unsigned char* vus_b = reinterpret_cast<const unsigned char*>(v_us + (size_t)bi * s_p * rv);

  auto next_live = [&](int v) {
    while (v < walk.end && walk.key0(v) < 0) ++v;
    return v;
  };
  // Producer: chunk `psub` of block entry `pv`, into the next ring stage.
  int pv = next_live(walk.begin), psub = 0, issued = 0;
  auto issue_next = [&]() {
    if (pv < walk.end) {
      unsigned char* st = ring + (issued % kStages) * stage_b;
      const int key0 = walk.key0(pv);
      const int valid = s_p - key0;
      if (psub < nk) {
        const int off = psub * kChunk;
        const int cb = min(kChunk, us_bytes - off);
        stage_rows(st, kRowB, kus_b + (size_t)key0 * us_bytes + off, us_bytes, kBS, cb, valid);
        const int r0 = off / (int)sizeof(T), nr = cb / (int)sizeof(T);
        stage_rows(st + kStageUs, L::kNatLd,
                   reinterpret_cast<const unsigned char*>(kvt_b + (size_t)r0 * ld_kvt),
                   (size_t)ld_kvt * sizeof(T), nr, HD * (int)sizeof(T), nr);
      } else if (psub < nk + 2) {
        const bf16* tab = psub == nk ? cos_h : sin_h;
        stage_rows(st, kRowB, reinterpret_cast<const unsigned char*>(tab + (size_t)key0 * (HD / 2)),
                   HD, kBS, HD, valid);
      } else {
        const int r0 = v0 + (psub - nk - 2) * 64;
        const int nr = min(64, rv - r0);
        stage_rows(st, kRowB, vus_b + ((size_t)key0 * rv + r0) * sizeof(T), (size_t)rv * sizeof(T),
                   kBS, nr * (int)sizeof(T), valid);
      }
      if (++psub == nch) {
        psub = 0;
        pv = next_live(pv + 1);
      }
    }
    cp_async_commit();
    ++issued;
  };
  // Consumer: wait for the next chunk; once every thread is past the
  // barrier, the stage read last step is free and the chunk kStages - 1
  // ahead goes into it before this one is computed.
  int consumed = 0;
  auto ring_wait = [&]() -> const unsigned char* {
    cp_async_wait_ring();
    __syncthreads();
    const unsigned char* st = ring + (consumed++ % kStages) * stage_b;
    issue_next();
    return st;
  };

  for (int s = 0; s < kStages - 1; ++s) issue_next();
  // The tile's query rows (zero past nrows), then their A fragments.
  for (int i = tid; i < kHR * (HD / 4); i += kT) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < nrows) x = *reinterpret_cast<const uint4*>(qab + ((size_t)bi * R + grow(r)) * 2 * HD + c);
    *reinterpret_cast<uint4*>(q_s + r * L::kQLd + c) = x;
  }
  if (tid < kHR) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  uint32_t qa_f[HD / 32][4], qb_f[HD / 32][4];
#pragma unroll
  for (int s = 0; s < HD / 32; ++s) {
    const bf16* qrow = q_s + (lane & 15) * L::kQLd + half * (HD / 2) + s * 16 + (lane >> 4) * 8;
    ldsm_x4(qa_f[s], qrow);
    ldsm_x4(qb_f[s], qrow + HD);
  }

  float acc_v[kMaxVC][4];
#pragma unroll
  for (int c = 0; c < kMaxVC; ++c) acc_v[c][0] = acc_v[c][1] = acc_v[c][2] = acc_v[c][3] = 0.f;

  for (int v = next_live(walk.begin); v < walk.end; v = next_live(v + 1)) {
    const int key0 = walk.key0(v);
    // Rebuild this warp's 16 keys x hd/2 columns of K = k_us @ k_vt.
    Acc kacc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) kacc[nt][0] = kacc[nt][1] = kacc[nt][2] = kacc[nt][3] = 0;
    for (int kc = 0; kc < nk; ++kc) {
      const unsigned char* st = ring_wait();
      const int ksteps = min(kChunk, us_bytes - kc * kChunk) / 32;
#pragma unroll
      for (int ks = 0; ks < kChunk / 32; ++ks) {
        if (ks < ksteps) {
          uint32_t a[4];
          ldsm_x4(a, st + (mt * 16 + (lane & 15)) * kRowB + ks * 32 + (lane >> 4) * 16);
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            const int n0 = half * (HD / 2) + np * 16;  // first column of the n-tile pair
            uint32_t b[4];
            if constexpr (!kInt8) {
              ldsm_x4_t(b, st + kStageUs + (ks * 16 + (lane & 15)) * L::kNatLd +
                               (n0 + (lane >> 4) * 8) * 2);
            } else {
              const unsigned char* p = st + kStageUs + (ks * 32 + tq * 4) * L::kNatLd + n0 + g;
              b[0] = gather4(p, L::kNatLd);
              b[1] = gather4(p + 16 * L::kNatLd, L::kNatLd);
              b[2] = gather4(p + 8, L::kNatLd);
              b[3] = gather4(p + 8 + 16 * L::kNatLd, L::kNatLd);
            }
            if constexpr (!kInt8) {
              mma_bf16_16816(kacc[2 * np], a, b[0], b[1]);
              mma_bf16_16816(kacc[2 * np + 1], a, b[2], b[3]);
            } else {
              mma_s8_16832(kacc[2 * np], a, b[0], b[1]);
              mma_s8_16832(kacc[2 * np + 1], a, b[2], b[3]);
            }
          }
        }
      }
    }
    // Keys rounded to bf16, as (key g, key g + 8) column pairs.
    __nv_bfloat162 kpk[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      kpk[nt][0] = __floats2bfloat162_rn((float)kacc[nt][0], (float)kacc[nt][1]);
      kpk[nt][1] = __floats2bfloat162_rn((float)kacc[nt][2], (float)kacc[nt][3]);
    }
    // Scores: qa . (K*cos) then qb . (K*sin), trig products in bf16. The
    // key fragments are the B operand (keys as n, columns as k).
    float s_acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int tab = 0; tab < 2; ++tab) {
      const unsigned char* st = ring_wait();
#pragma unroll
      for (int s = 0; s < HD / 32; ++s) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const unsigned char* trow = st + (mt * 16 + g + 8 * j) * kRowB + tq * 4;
          const __nv_bfloat162 t0 = *reinterpret_cast<const __nv_bfloat162*>(trow + (2 * s) * 16);
          const __nv_bfloat162 t1 =
              *reinterpret_cast<const __nv_bfloat162*>(trow + (2 * s + 1) * 16);
          const __nv_bfloat162 k0 = __hmul2(kpk[2 * s][j], t0);
          const __nv_bfloat162 k1 = __hmul2(kpk[2 * s + 1][j], t1);
          mma_bf16_16816(s_acc[j], tab == 0 ? qa_f[s] : qb_f[s],
                         *reinterpret_cast<const uint32_t*>(&k0),
                         *reinterpret_cast<const uint32_t*>(&k1));
        }
      }
    }
    {
      float* sch = sc + half * kHR * kBS;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = mt * 16 + j * 8 + 2 * tq;
        *reinterpret_cast<float2*>(sch + g * kBS + key) = make_float2(s_acc[j][0], s_acc[j][1]);
        *reinterpret_cast<float2*>(sch + (g + 8) * kBS + key) =
            make_float2(s_acc[j][2], s_acc[j][3]);
      }
    }
    __syncthreads();
    // Online softmax, rows warp and warp + 8; lanes over the 64 keys, live
    // below the block's chunk end (key_hi: read here, where it is used).
    const int key_hi = walk.key_hi(v);
    for (int r = warp; r < kHR; r += kWarps) {
      const int c0 = key0 + lane, c1 = c0 + 32;
      const bool live0 = r < nrows && c0 >= walk.lo && c0 < key_hi;
      const bool live1 = r < nrows && c1 >= walk.lo && c1 < key_hi;
      const float x0 = live0 ? sc[r * kBS + lane] + sc[(kHR + r) * kBS + lane] : kNegInf;
      const float x1 = live1 ? sc[r * kBS + lane + 32] + sc[(kHR + r) * kBS + lane + 32] : kNegInf;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = live0 ? __expf(x0 - m_new) : 0.f;
      const float p1 = live1 ? __expf(x1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      p_s[r * L::kPLd + lane] = __float2bfloat16_rn(p0);
      p_s[r * L::kPLd + lane + 32] = __float2bfloat16_rn(p1);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + psum;
        a_s[r] = alpha;
      }
    }
    // t = alpha * t + P @ v_us; warp w owns ranks [64 c + 8 w, +8) of chunk c.
    uint32_t pf[4][4];
#pragma unroll
    for (int c = 0; c < kMaxVC; ++c) {
      if (c < nv) {
        const unsigned char* st = ring_wait();
        if (c == 0) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            ldsm_x4(pf[ks], p_s + (lane & 15) * L::kPLd + ks * 16 + (lane >> 4) * 8);
          const float a0 = a_s[g], a1 = a_s[g + 8];
#pragma unroll
          for (int cc = 0; cc < kMaxVC; ++cc) {
            acc_v[cc][0] *= a0;
            acc_v[cc][1] *= a0;
            acc_v[cc][2] *= a1;
            acc_v[cc][3] *= a1;
          }
        }
        if (c * 64 + warp * 8 < rvs) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            uint32_t b[4];
            if constexpr (!kInt8) {
              ldsm_x4_t(b, st + (kk * 32 + lane) * kRowB + warp * 16);
            } else {
              const unsigned char* p = st + (kk * 32 + 2 * tq) * kRowB + warp * 8 + g;
#pragma unroll
              for (int q = 0; q < 4; ++q) {  // keys 2tq (+1), + 8 q
                const unsigned char* pq = p + 8 * q * kRowB;
                b[q] = pack_bf16((float)(int8_t)pq[0], (float)(int8_t)pq[kRowB]);
              }
            }
            mma_bf16_16816(acc_v[c], pf[2 * kk], b[0], b[1]);
            mma_bf16_16816(acc_v[c], pf[2 * kk + 1], b[2], b[3]);
          }
        }
        }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const size_t base = ((size_t)bi * nsplit + split) * R;
#pragma unroll
  for (int c = 0; c < kMaxVC; ++c) {
    const int col = v0 + c * 64 + warp * 8 + 2 * tq;
    if (c < nv && c * 64 + warp * 8 < rvs) {
      if (g < nrows)
        *reinterpret_cast<float2*>(part_t + (base + grow(g)) * rv + col) =
            make_float2(acc_v[c][0], acc_v[c][1]);
      if (g + 8 < nrows)
        *reinterpret_cast<float2*>(part_t + (base + grow(g + 8)) * rv + col) =
            make_float2(acc_v[c][2], acc_v[c][3]);
    }
  }
  if (vs == 0 && tid < nrows) {
    part_m[base + grow(tid)] = m_s[tid];
    part_l[base + grow(tid)] = l_s[tid];
  }
}
template <typename T, int HD, bool kSliced>
int launch_stream(cudaStream_t st, const void* qab, const void* k_us, const void* k_vt,
                  const void* v_us, const void* cos_h, const void* sin_h, const int* lens,
                  const int* los, const int* ids, int n_sel, int chunk, void* part_t,
                  void* part_m, void* part_l, int* done, int b, int R, int hq, int hkv, int s_p,
                  int rk, int rv, long long sb_kvt, long long ld_kvt, int nsplit, int ntiles,
                  int vslice) {
  constexpr int smem = Layout<T, HD>::kStreamSmem;
  static_assert(smem <= kMaxSmem, "streamed ring too large");
  auto kern = lowrank_stream_split_kernel<T, HD, kSliced>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int nvs = (rv + vslice - 1) / vslice;
  kern<<<dim3(nsplit * nvs, hkv * ntiles, b), kT, smem, st>>>(
      (const bf16*)qab, (const T*)k_us, (const T*)k_vt, (const T*)v_us, (const bf16*)cos_h,
      (const bf16*)sin_h, lens, los, ids, n_sel, chunk, (float*)part_t, (float*)part_m,
      (float*)part_l, done, R, hq, hkv, s_p, rk, rv, sb_kvt, ld_kvt, nsplit, ntiles, vslice);
  return (int)cudaGetLastError();
}

// Whether the head's k_vt slice must stream (it does not fit beside the
// TMA kernel's ring).
template <typename T, int HD>
bool streams(int rk) {
  return TmaLayout<T, HD>::smem(rk) > kMaxSmem;
}

#define XKV_SPLIT_ARGS                                                                    \
  st, qab, k_us, k_vt, v_us, cos_h, sin_h, lens, los, ids, n_sel, chunk, part_t, part_m,  \
      part_l, done, b, R, hq, hkv, s_p, rk, rv, sb_kvt, ld_kvt, nsplit, ntiles, vslice

template <typename T, int HD>
int dispatch_split(cudaStream_t st, const void* qab, const void* k_us, const void* k_vt,
                   const void* v_us, const void* cos_h, const void* sin_h, const int* lens,
                   const int* los, const int* ids, int n_sel, int chunk, void* part_t,
                   void* part_m, void* part_l, int* done, int b, int R, int hq, int hkv, int s_p,
                   int rk, int rv, long long sb_kvt, long long ld_kvt, int nsplit, int ntiles,
                   int vslice) {
  if (vslice < rv)
    return streams<T, HD>(rk) ? launch_stream<T, HD, true>(XKV_SPLIT_ARGS)
                              : launch_tma<T, HD, true>(XKV_SPLIT_ARGS);
  return streams<T, HD>(rk) ? launch_stream<T, HD, false>(XKV_SPLIT_ARGS)
                            : launch_tma<T, HD, false>(XKV_SPLIT_ARGS);
}

// Ranks of a value slice: every rank up to 64 * kMaxVC = 1024; past that
// the fewest slices of at most 1024, in whole 128-rank chunks. Each slice's
// CTAs rebuild the keys again.
int value_slice(int rv) {
  if (rv <= 64 * kMaxVC) return rv;
  const int nvs = (rv + 64 * kMaxVC - 1) / (64 * kMaxVC);
  return ((rv + nvs - 1) / nvs + 127) / 128 * 128;
}

// Split kernel for the launch's (factor type, head size), then the merge
// (K3 with ids == null, K5 otherwise).
int run(const void* qab, const void* k_us, const void* k_vt, long long sb_kvt,
        long long ld_kvt, const void* v_us, const void* v_vt, long long sb_vvt,
        long long ld_vvt, const void* cos_h, const void* sin_h, const void* v_scale,
        const int* ids, int n_sel, int chunk, const int* lens, const int* los, void* part_t,
        void* part_m, void* part_l, void* part_o, int* done, void* out, void* lse, int b, int R,
        int hq, int hkv, int hd, int s_p, int rk, int rv, int nsplit, int is_int8,
        void* stream) {
  if ((hd != 64 && hd != 128) || rk < 64 || rk % 64 != 0 || rv < 16 || rv % 16 != 0 ||
      nsplit < 1 || hkv < 1 || hq % hkv != 0 || R % hq != 0)
    return (int)cudaErrorInvalidValue;
  if (ids != nullptr && (chunk <= 0 || n_sel < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int ntiles = ((R / hq) * (hq / hkv) + kHR - 1) / kHR;
  const int vslice = value_slice(rv);
  int err;
  if (hd == 128)
    err = is_int8 ? dispatch_split<int8_t, 128>(XKV_SPLIT_ARGS)
                  : dispatch_split<bf16, 128>(XKV_SPLIT_ARGS);
  else
    err = is_int8 ? dispatch_split<int8_t, 64>(XKV_SPLIT_ARGS)
                  : dispatch_split<bf16, 64>(XKV_SPLIT_ARGS);
  if (err != 0) return err;
  return hd == 128 ? launch_merge<128>(st, part_t, part_m, part_l, v_vt, sb_vvt, ld_vvt,
                                       v_scale, part_o, done, out, lse, b, R, hq, hkv, rv,
                                       nsplit,
                                       ntiles)
                   : launch_merge<64>(st, part_t, part_m, part_l, v_vt, sb_vvt, ld_vvt,
                                      v_scale, part_o, done, out, lse, b, R, hq, hkv, rv,
                                      nsplit,
                                      ntiles);
}

}  // namespace
}  // namespace xkv

using namespace xkv;

// K3. qab (b, R, 2*hd) bf16 compact query embeds ([qa | qb] of each row's own
// head), hd 64 or 128; k_us (b, s_p, rk), v_us (b, s_p, rv) bf16 or int8
// contiguous; k_vt (b, rk, .) with batch stride sb_kvt and row stride
// ld_kvt, this layer's columns starting at the pointer; v_vt (b, rv, .) bf16
// likewise; cos_h/sin_h (s_p, hd/2) bf16; v_scale (b, 1, rv) fp32 or null;
// lens/los (b,) int32. Scratch part_t (b, nsplit, R, rv), part_m/part_l
// (b, nsplit, R), part_o (b, ceil(rv / 64), R, hd) fp32, done
// (b * hkv * ceil(ql * hq / hkv / 16)) int32. Writes out (b, R, hd) bf16 and
// lse (b, R) fp32.
extern "C" int xkv_lowrank_decode(
    const void* qab, const void* k_us, const void* k_vt, long long sb_kvt,
    long long ld_kvt, const void* v_us, const void* v_vt, long long sb_vvt,
    long long ld_vvt, const void* cos_h, const void* sin_h, const void* v_scale,
    const int* lens, const int* los, void* part_t, void* part_m, void* part_l, void* part_o,
    int* done, void* out, void* lse, int b, int R, int hq, int hkv, int hd, int s_p, int rk,
    int rv, int nsplit, int is_int8, void* stream) {
  return run(qab, k_us, k_vt, sb_kvt, ld_kvt, v_us, v_vt, sb_vvt, ld_vvt, cos_h, sin_h,
             v_scale, nullptr, 0, 0, lens, los, part_t, part_m, part_l, part_o, done, out, lse, b,
             R, hq, hkv, hd, s_p, rk, rv, nsplit, is_int8, stream);
}

// K5. As K3, over the rows of the selected chunks: ids (b, n_sel) int32,
// chunk id i covering rows [i * chunk, (i + 1) * chunk) (any chunk > 0); an
// id < 0 selects nothing.
extern "C" int xkv_sparse_lowrank_decode(
    const void* qab, const void* k_us, const void* k_vt, long long sb_kvt,
    long long ld_kvt, const void* v_us, const void* v_vt, long long sb_vvt,
    long long ld_vvt, const void* cos_h, const void* sin_h, const void* v_scale,
    const int* ids, const int* lens, const int* los, void* part_t, void* part_m,
    void* part_l, void* part_o, int* done, void* out, void* lse, int b, int R, int hq, int hkv,
    int hd, int s_p, int rk, int rv, int n_sel, int chunk, int nsplit, int is_int8,
    void* stream) {
  return run(qab, k_us, k_vt, sb_kvt, ld_kvt, v_us, v_vt, sb_vvt, ld_vvt, cos_h, sin_h,
             v_scale, ids, n_sel, chunk, lens, los, part_t, part_m, part_l, part_o, done, out, lse,
             b, R, hq, hkv, hd, s_p, rk, rv, nsplit, is_int8, stream);
}

// Whether K3/K5 stream the k_vt slice through the ring (1) or keep it
// resident in shared memory (0) at this head size, rank and factor type.
extern "C" int xkv_lowrank_streams_kvt(int hd, int rk, int is_int8) {
  if (hd == 128) return is_int8 ? streams<int8_t, 128>(rk) : streams<bf16, 128>(rk);
  return is_int8 ? streams<int8_t, 64>(rk) : streams<bf16, 64>(rk);
}
