// K1: GQA causal prefill attention (flash attention forward) for sm_90a.
//
// Replaces: xkv_tpu/ops/pallas/flash_attention.py, flash_attention_fwd
// (Pallas body _flash_kernel).
//
// Bound on the H100: operations. Causal prefill at s = 8192, 32 query
// heads, head_dim 128 is ~0.55 TFLOP per layer against ~0.13 GB of q/k/v/o,
// far above the ~295 FLOP/byte ridge, so the tensor cores set the floor.
//
// Design: one CTA per (query tile, kv head, batch). The CTA holds all
// q_per_kv query heads of its kv head (128 query rows = q_per_kv heads x
// 128/q_per_kv positions), so each K/V tile staged in shared memory serves
// every query head of the group and kv heads are never repeated. Each of
// the 8 warps owns 16 query rows of one head, keeps its Q fragments and its
// fp32 output accumulator in registers, and runs QK^T and P@V on mma.sync
// bf16 tensor cores with an fp32 online softmax. K/V tiles wholly above the
// diagonal or wholly outside the sliding window are never loaded; the
// ragged edge (positions >= s) is masked in the kernel, with no padded
// copies. Masked scores take the finite NEG_INF and their probabilities are
// zeroed explicitly; a row with no live key outputs 0. This first version
// stages tiles with plain loads and one buffer (no TMA, no wgmma, no
// pipelining): later work makes it fast.
#include "common.cuh"

using namespace xkv;

namespace {

constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 8 warps x 16 query rows = 128 rows

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int hq, int hkv, int s,
    float scale, int window) {
  constexpr int LDS = HD + 8;  // padded smem row: conflict-free fragment loads
  __shared__ __align__(16) bf16 ks[kBK * LDS];
  __shared__ __align__(16) bf16 vs[kBK * LDS];

  const int qpk = hq / hkv;
  const int bq = 128 / qpk;  // query positions per CTA
  const int q_start = blockIdx.x * bq;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  const int r0 = warp * 16;                 // first CTA row of this warp
  const int h = hk * qpk + r0 / bq;         // its query head
  const int pos0 = q_start + (r0 % bq);     // position of its row 0
  const bf16* qh = q + ((size_t)(bi * hq + h) * s) * HD;
  const bf16* kh = k + ((size_t)(bi * hkv + hk) * s) * HD;
  const bf16* vh = v + ((size_t)(bi * hkv + hk) * s) * HD;

  // Q fragments for 16 rows x HD, straight from global memory.
  uint32_t qf[HD / 16][4];
  const int pa = pos0 + g, pb = pos0 + g + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int col = kk * 16 + tq * 2;
    qf[kk][0] = pa < s ? *reinterpret_cast<const uint32_t*>(qh + (size_t)pa * HD + col) : 0u;
    qf[kk][1] = pb < s ? *reinterpret_cast<const uint32_t*>(qh + (size_t)pb * HD + col) : 0u;
    qf[kk][2] = pa < s ? *reinterpret_cast<const uint32_t*>(qh + (size_t)pa * HD + col + 8) : 0u;
    qf[kk][3] = pb < s ? *reinterpret_cast<const uint32_t*>(qh + (size_t)pb * HD + col + 8) : 0u;
  }

  float o[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};

  const int k_end = min(s, q_start + bq);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_start - window + 1) / kBK * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    for (int c = threadIdx.x; c < kBK * HD / 8; c += kThreads) {
      const int row = c / (HD / 8), col = (c % (HD / 8)) * 8;
      const int key = k0 + row;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < s) {
        kv = *reinterpret_cast<const uint4*>(kh + (size_t)key * HD + col);
        vv = *reinterpret_cast<const uint4*>(vh + (size_t)key * HD + col);
      }
      *reinterpret_cast<uint4*>(ks + row * LDS + col) = kv;
      *reinterpret_cast<uint4*>(vs + row * LDS + col) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x kBK keys.
    float sc[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const bf16* kr = ks + (nt * 8 + g) * LDS + kk * 16 + tq * 2;
        mma_bf16_16816(sc[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                       *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // Mask, online softmax (fp32).
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = (e < 2) ? pa : pb;
        const int col = k0 + nt * 8 + tq * 2 + (e & 1);
        bool live = col <= pos && pos < s;
        if (window > 0) live = live && col > pos - window;
        const float x = live ? sc[nt][e] * scale : kNegInf;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m_r[i], mx[i]);
      alpha[i] = __expf(m_r[i] - m_new[i]);
      m_r[i] = m_new[i];
    }
    uint32_t pf[kBK / 8][2];  // P rounded to bf16, packed by column pairs
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[nt][e];
        p[e] = (x == kNegInf) ? 0.f : __expf(x - m_new[e >> 1]);
        rs[e >> 1] += p[e];
      }
      pf[nt][0] = pack_bf16(p[0], p[1]);
      pf[nt][1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_r[i] = alpha[i] * l_r[i] + rs[i];
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // O += P V; the S accumulator layout of two key octets is exactly the
    // A fragment of one 16-key slab.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                             pf[2 * kk + 1][1]};
      const bf16* v0 = vs + (kk * 16 + tq * 2) * LDS + g;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const bf16* vp = v0 + nt * 8;
        const uint32_t b0 = pack_bf16_raw(vp[0], vp[LDS]);
        const uint32_t b1 = pack_bf16_raw(vp[8 * LDS], vp[9 * LDS]);
        mma_bf16_16816(o[nt], a, b0, b1);
      }
    }
  }

  // out is (b, s, hq, HD).
  const float inv[2] = {l_r[0] > 0.f ? 1.f / l_r[0] : 0.f,
                        l_r[1] > 0.f ? 1.f / l_r[1] : 0.f};
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    const int col = nt * 8 + tq * 2;
    if (pa < s)
      *reinterpret_cast<uint32_t*>(out + (((size_t)bi * s + pa) * hq + h) * HD + col) =
          pack_bf16(o[nt][0] * inv[0], o[nt][1] * inv[0]);
    if (pb < s)
      *reinterpret_cast<uint32_t*>(out + (((size_t)bi * s + pb) * hq + h) * HD + col) =
          pack_bf16(o[nt][2] * inv[1], o[nt][3] * inv[1]);
  }
}

}  // namespace

// q (b, hq, s, hd), k/v (b, hkv, s, hd) bf16 contiguous; out (b, s, hq, hd).
// window <= 0 means no sliding window. Returns cudaGetLastError().
extern "C" int xkv_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       void* out, int b, int hq, int hkv, int s, int hd,
                                       float scale, int window, void* stream) {
  const int qpk = hq / hkv;
  if (hq % hkv != 0 || 128 % (16 * qpk) != 0) return (int)cudaErrorInvalidValue;
  const int bq = 128 / qpk;
  dim3 grid((s + bq - 1) / bq, hkv, b);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (hd != 128) return (int)cudaErrorInvalidValue;
  flash_fwd_kernel<128><<<grid, kThreads, 0, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, hq, hkv, s, scale, window);
  return (int)cudaGetLastError();
}
