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
// Design: the machinery K3 ships (lowrank_attention.cu; hopper.cuh), so
// that "full minus -stage" attributes time to the stages of that design.
// - One CTA per key split (and sequence); the 64-key blocks are dealt out
//   in contiguous runs of ceil(blocks / nsplit), as the TPU kernel's grid
//   walks them in order, and the parts merge as t = sum_j t_j exp(m_j - m),
//   m = max_j m_j (softmax off: the parts add). The block structure is
//   part of the function: `-vpath` adds each block's first v_us row.
// - A producer warp loads by TMA: once, the query rows of every head
//   (32 rows x 64 columns a panel, the K-major B operand of the scores);
//   per block, the k_us rows and the position tables the stage set reads
//   (a buffer of their own, held while the block's heads are rebuilt),
//   then through a 4-stage ring with a full/empty mbarrier pair per stage
//   the k_vt panels (128 columns x 128 ranks) of each head and the v_us
//   rows (64 keys x 256 ranks a stage).
// - k_vt is transposed to K-major (column-major) once per call by a small
//   kernel, as K3's int8 path transposes its slice once per CTA: the s8
//   wgmma takes K-major operands only. Every block needs all of the
//   layer's hkv slices (512 KB at the tool's shapes), which cannot stay
//   resident beside the ring, so they stream from L2.
// - Two consumer warpgroups take the kv heads in turn (warpgroup g the
//   heads g, g + 2, ...). Per head: K_h = k_us . k_vt_h on wgmma
//   m64n128k32 s8, keys on M and the head's 128 columns on N, into int32
//   registers. In that accumulator a thread holds columns c and c + 64 of
//   the same keys (n-tiles nt and nt + 8), so the scale and the rotation,
//   which pairs column d with d + hd/2, run in registers with no staging.
//   The rotated keys, rounded to bf16, are packed as the register A
//   operand of S^T += K_h . q_h^T (wgmma m64n32k16: keys x the 32 query
//   rows), as FlashAttention-3 feeds P; S accumulates over the heads, the
//   depth-m product of the TPU kernel, and the two warpgroups' partial sums
//   meet in shared memory.
// - The fp32 online softmax over the summed scores; P rounded to bf16 into
//   a swizzled panel, the K-major B operand of t^T (64 ranks x 32 rows) +=
//   v_us^T . P^T on wgmma, v_us^T gathered from the int8 stage into
//   registers as bf16 A fragments (as K3 widens its int8 values).
// - Only o = t[:, :hd] leaves the kernel, so the partials hold hd ranks;
//   every rank of t is still computed, as in K3.
#include "decode_common.cuh"
#include "hopper.cuh"

using namespace xkv;

namespace {

enum : int {
  kRecon = 1, kScaleMul = 2, kRope = 4, kScores = 8, kSoftmax = 16, kVPath = 32,
  kRoll = 64, kRopeQ = 128,
};
constexpr int kAll = kRecon | kScaleMul | kRope | kScores | kSoftmax | kVPath;

constexpr int kHD = 128;          // head size of the tool
constexpr int kMaxHeads = 8;      // hkv * hd <= 1024
constexpr int kMaxRk = 512;       // k_us rows held for the block
constexpr int kMaxVJ = 6;         // 64-rank value panels a warpgroup holds: rv <= 768
constexpr int kCW = 8;            // consumer warps: 2 warpgroups
constexpr int kCT = kCW * 32;
constexpr int kTP = kCT + 32;     // and the producer warp
constexpr int kStages = 4;
constexpr int kStageB = 16384;    // a k_vt panel (128 x 128 B) or two v_us boxes
constexpr int kBoxB = kBS * 128;  // 64 rows x 128 bytes, swizzled
constexpr int kQPanelB = kRows * 128;
constexpr int kScLd = kBS + 4;

// Shared memory, from a 1024-aligned base.
constexpr int kQOff = kStages * kStageB;                    // 2 * hkv q panels
constexpr int kKusOff = kQOff + 2 * kMaxHeads * kQPanelB;   // rk / 128 k_us boxes
constexpr int kTabOff = kKusOff + kMaxRk / 128 * kBoxB;     // cos, sin: 2 boxes each
constexpr int kPOff = kTabOff + 4 * kBoxB;                  // P panel (32 rows x 64 keys)
constexpr int kScOff = kPOff + kQPanelB;                    // sc[2][kRows][kScLd]
constexpr int kKscOff = kScOff + 2 * kRows * kScLd * 4;     // k_scale [hkv * hd]
constexpr int kTrigOff = kKscOff + kMaxHeads * kHD * 4;     // trig [2][hd]
constexpr int kStatOff = kTrigOff + 2 * kHD * 4;            // m, alpha, rowsum, col0
constexpr int kBarOff = kStatOff + (3 * kRows + kBS) * 4;
constexpr int kNBars = 2 * kStages + 3;                     // full, empty, q, kus full/empty
constexpr int kSmem = 1024 + kBarOff + kNBars * 8;

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCT) : "memory");
}

// D (64 keys x 128 columns, s32) += A (64 x 32 ranks) B (32 x 128), both
// K-major in shared memory.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db));
}

// D (64 x 32, fp32) += A (64 x 16, bf16 registers) B (16 x 32), B K-major
// in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Two bf16 values of a 64-row x 128-byte swizzled box: row `row`, the
// pair starting at byte `byte` (a multiple of 4), as floats.
__device__ __forceinline__ float2 box_pair(const unsigned char* box, int row, int byte) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(box + swz(row, byte)));
}

struct Params {
  const int8_t* v_us;
  const float* k_scale;
  const float* trig;
  float* part_t;
  float* part_m;
  int hq, hkv, s, rk, rv;
  float scale;
  int nsplit;
};

template <int ST>
__global__ void __launch_bounds__(kTP, 1) ablation_split_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_kus,
    const __grid_constant__ CUtensorMap tm_kvt, const __grid_constant__ CUtensorMap tm_vus,
    const __grid_constant__ CUtensorMap tm_cos, const __grid_constant__ CUtensorMap tm_sin,
    const Params a) {
  constexpr bool kRecon_ = (ST & kRecon) != 0, kVPath_ = (ST & kVPath) != 0;
  constexpr bool kRelative = (ST & kRopeQ) != 0;
  constexpr bool kFullTab = (ST & (kRoll | kRopeQ)) != 0;
  constexpr bool kTables = (ST & (kRope | kRoll | kRopeQ)) != 0;
  constexpr bool kScale = (ST & kScaleMul) != 0 && !kRelative;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = smem;
  float* sc = reinterpret_cast<float*>(smem + kScOff);
  float* ksc = reinterpret_cast<float*>(smem + kKscOff);
  float* trig = reinterpret_cast<float*>(smem + kTrigOff);
  float* m_s = reinterpret_cast<float*>(smem + kStatOff);
  float* a_s = m_s + kRows;
  float* rs_s = a_s + kRows;
  float* col0 = rs_s + kRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOff);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);
  const uint32_t q_bar = smem_u32(bars + 2 * kStages);
  const uint32_t kus_full = q_bar + 8, kus_empty = q_bar + 16;

  const int hkv = a.hkv, rk = a.rk, rv = a.rv;
  const int split = blockIdx.x, bi = blockIdx.z;
  const int nblk = a.s / kBS;
  const int per = (nblk + a.nsplit - 1) / a.nsplit;
  const int begin = min(split * per, nblk), end = min(begin + per, nblk);
  const int npk = (rk + 127) / 128;       // k_us boxes and k_vt panels of a head
  const int nvs = (rv + 255) / 256;       // v_us stages of a block
  const int nvp = (rv + 63) / 64;         // 64-rank value panels
  const int nkv = kRecon_ ? hkv * npk : 0;
  const int per_block = nkv + (kVPath_ ? nvs : 0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == kCT) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kCW);
    }
    mbar_init(q_bar, 1);
    mbar_init(kus_full, 1);
    mbar_init(kus_empty, kCW);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kCW) {
    // Producer. The query panels, then per block the k_us boxes and tables
    // (once the consumers are done with the last block's), then the ring:
    // k_vt panels pair by pair of heads (head 2j then 2j + 1, panel by
    // panel, so both warpgroups rebuild at once), then the v_us stages.
    if (lane == 0 && begin < end) {
      mbar_expect_tx(q_bar, 2 * hkv * kQPanelB);
      for (int p = 0; p < 2 * hkv; ++p)
        tma_box(smem_u32(smem + kQOff + p * kQPanelB), &tm_q, q_bar, p * 128, 0, bi);
      const int ntb = kFullTab ? 2 : 1;  // boxes of a table row
      int n = 0;
      for (int v = begin; v < end; ++v) {
        const int key0 = v * kBS, nb = v - begin;
        if (nb > 0) mbar_wait(kus_empty, (nb - 1) & 1);
        mbar_expect_tx(kus_full, (npk + (kTables ? 2 * ntb : 0)) * kBoxB);
        for (int p = 0; p < npk; ++p)
          tma_box(smem_u32(smem + kKusOff + p * kBoxB), &tm_kus, kus_full, p * 128, key0, bi);
        if constexpr (kTables) {
          for (int t = 0; t < ntb; ++t) {
            tma_box(smem_u32(smem + kTabOff + t * kBoxB), &tm_cos, kus_full, t * 128, key0, 0);
            tma_box(smem_u32(smem + kTabOff + (2 + t) * kBoxB), &tm_sin, kus_full, t * 128,
                    key0, 0);
          }
        }
        // Ring entry n into stage n % kStages once its last entry is read.
        auto put = [&](int bytes) -> int {
          const int s = n % kStages;
          if (n >= kStages) mbar_wait(empty0 + 8 * s, (n / kStages - 1) & 1);
          mbar_expect_tx(full0 + 8 * s, bytes);
          ++n;
          return s;
        };
        if constexpr (kRecon_) {
          for (int j = 0; 2 * j < hkv; ++j)
            for (int p = 0; p < npk; ++p)
              for (int h = 2 * j; h < min(2 * j + 2, hkv); ++h) {
                const int s = put(kStageB);
                tma_box(smem_u32(ring + s * kStageB), &tm_kvt, full0 + 8 * s, p * 128, h * kHD,
                        bi);
              }
        }
        if constexpr (kVPath_) {
          for (int i = 0; i < nvs; ++i) {
            const int boxes = min(2, (rv - 256 * i + 127) / 128);
            const int s = put(boxes * kBoxB);
            for (int x = 0; x < boxes; ++x)
              tma_box(smem_u32(ring + s * kStageB + x * kBoxB), &tm_vus, full0 + 8 * s,
                      256 * i + 128 * x, key0, bi);
          }
        }
      }
    }
    return;
  }

  // Consumers.
  const int grp = warp >> 2, wq = warp & 3, g = lane >> 2, tq = lane & 3;
  for (int i = tid; i < hkv * kHD; i += kCT) ksc[i] = a.k_scale[(size_t)bi * hkv * kHD + i];
  for (int i = tid; i < 2 * kHD; i += kCT) trig[i] = a.trig[i];
  if (tid < kRows) {
    m_s[tid] = -INFINITY;
    a_s[tid] = 1.f;
  }
  consumers_sync();
  if (begin < end) mbar_wait(q_bar, 0);

  // t^T of the warpgroup's value panels 2 j + grp: ranks 16 wq + g (+ 8) x
  // rows 8 i + 2 tq (+ 1) in acc[j][4 i + e].
  float acc[kMaxVJ][16];
#pragma unroll
  for (int j = 0; j < kMaxVJ; ++j)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[j][e] = 0.f;

  const uint32_t kus_a = smem_u32(smem + kKusOff), q_a = smem_u32(smem + kQOff);
  const uint32_t p_a = smem_u32(smem + kPOff);
  const unsigned char* kus_s = smem + kKusOff;
  const unsigned char* cos_s = smem + kTabOff;
  const unsigned char* sin_s = smem + kTabOff + 2 * kBoxB;
  int n0 = 0;  // the block's first ring entry
  for (int v = begin; v < end; ++v, n0 += per_block) {
    const int key0 = v * kBS, nb = v - begin;
    mbar_wait(kus_full, nb & 1);
    float sacc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) sacc[e] = 0.f;
    for (int h = grp; h < hkv; h += 2) {
      // K_h of the block: 64 keys x 128 columns.
      int kacc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) kacc[i] = 0;
      if constexpr (kRecon_) {
        const int pair = min(2, hkv - (h & ~1));  // heads of this head's pair
        for (int p = 0; p < npk; ++p) {
          const int n = n0 + (h & ~1) * npk + p * pair + (h & 1);
          const int s = n % kStages;
          mbar_wait(full0 + 8 * s, (n / kStages) & 1);
          const uint32_t st = smem_u32(ring + s * kStageB);
          fence_regs(kacc);
          wgmma_fence();
          // All four k-steps: TMA fills the ranks past rk with zeros in both
          // operands (a k-step under a condition serialises the wgmmas).
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_s8_n128(kacc, desc_b128(kus_a + p * kBoxB + kk * 32, 16, 1024),
                          desc_b128(st + kk * 32, 16, 1024));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(kacc);
          __syncwarp();
          if (lane == 0) {  // the stage's one reader warpgroup counts twice
            mbar_arrive(empty0 + 8 * s);
            mbar_arrive(empty0 + 8 * s);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = 16 * wq + g + 8 * ((i >> 1) & 1);
          const int byte = (h * kHD + 8 * (i >> 2) + 2 * tq + (i & 1)) % rk;
          kacc[i] = (int8_t)kus_s[(byte >> 7) * kBoxB + swz(key, byte & 127)];
        }
      }
      // Scale, rotate and round to bf16, packed as the score product's A
      // fragments: elements i, i + 1 (i even) go to af[i / 8][(i / 2) % 4].
      // Columns c, c + 1 (i < 32) pair with c + 64, c + 65 (i + 32).
      uint32_t af[8][4], bf[8][4];  // bf: the relative form's K * sin_rel
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int key = 16 * wq + g + 8 * ((i >> 1) & 1);
        const int c = 8 * (i >> 2) + 2 * tq;
        float lo[2], hi[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          lo[e] = (float)kacc[i + e];
          hi[e] = (float)kacc[i + 32 + e];
          if constexpr (kScale) {
            lo[e] = __fmul_rn(lo[e], ksc[h * kHD + c + e]);
            hi[e] = __fmul_rn(hi[e], ksc[h * kHD + 64 + c + e]);
          }
        }
        bf16 ra[2][2], rb[2][2];  // [lo | hi][e]
        if constexpr ((ST & kRope) != 0) {
          const float2 cp = box_pair(cos_s, key, 2 * c), sp = box_pair(sin_s, key, 2 * c);
          const float cs[2] = {cp.x, cp.y}, sn[2] = {sp.x, sp.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            ra[0][e] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(lo[e], cs[e]),
                                                     __fmul_rn(hi[e], -sn[e])));
            ra[1][e] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(hi[e], cs[e]),
                                                     __fmul_rn(lo[e], sn[e])));
          }
        } else if constexpr ((ST & kRoll) != 0) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 cp = box_pair(cos_s + half * kBoxB, key, 2 * c);
            const float2 sp = box_pair(sin_s + half * kBoxB, key, 2 * c);
            const float cs[2] = {cp.x, cp.y}, sn[2] = {sp.x, sp.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = half ? hi[e] : lo[e], y = half ? lo[e] : hi[e];
              ra[half][e] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(x, cs[e]),
                                                          __fmul_rn(y, sn[e])));
            }
          }
        } else if constexpr (kRelative) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 cp = box_pair(cos_s + half * kBoxB, key, 2 * c);
            const float2 sp = box_pair(sin_s + half * kBoxB, key, 2 * c);
            const float cb[2] = {cp.x, cp.y}, sb[2] = {sp.x, sp.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = c + e + 64 * half;
              const float ct = trig[d], st = trig[kHD + d];
              const bf16 crel = __float2bfloat16_rn(__fadd_rn(__fmul_rn(cb[e], ct),
                                                              __fmul_rn(sb[e], st)));
              const bf16 srel = __float2bfloat16_rn(__fsub_rn(__fmul_rn(sb[e], ct),
                                                              __fmul_rn(cb[e], st)));
              const bf16 kx = __float2bfloat16_rn(half ? hi[e] : lo[e]);
              ra[half][e] = __hmul(kx, crel);
              rb[half][e] = __hmul(kx, srel);
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            ra[0][e] = __float2bfloat16_rn(lo[e]);
            ra[1][e] = __float2bfloat16_rn(hi[e]);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          af[(i >> 3) + 4 * half][(i >> 1) & 3] = pack_bf16_raw(ra[half][0], ra[half][1]);
          if constexpr (kRelative)
            bf[(i >> 3) + 4 * half][(i >> 1) & 3] = pack_bf16_raw(rb[half][0], rb[half][1]);
        }
        if constexpr ((ST & kScores) == 0) {
          if (h == 0 && tq == 0 && i < 4) col0[key] = __bfloat162float(ra[0][0]);
        }
      }
      if constexpr ((ST & kScores) != 0) {
        fence_regs(af);
        fence_regs(sacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_rs_n32(sacc, af[kk],
                       desc_b128(q_a + (2 * h + (kk >> 2)) * kQPanelB + (kk & 3) * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
        if constexpr (kRelative) {
          fence_regs(bf);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            wgmma_rs_n32(sacc, bf[kk],
                         desc_b128(q_a + (2 * h + (kk >> 2)) * kQPanelB + (kk & 3) * 32, 16,
                                   1024));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sacc);
        }
      } else {
        fence_regs(af);  // the rebuilt, rotated keys stay computed
      }
    }
    // The block's k_us and tables are no longer read.
    __syncwarp();
    if (lane == 0) mbar_arrive(kus_empty);
    if constexpr ((ST & kScores) != 0) {
      float* scp = sc + grp * kRows * kScLd;
      const int key = 16 * wq + g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 8 * i + 2 * tq;
        scp[r * kScLd + key] = sacc[4 * i];
        scp[(r + 1) * kScLd + key] = sacc[4 * i + 1];
        scp[r * kScLd + key + 8] = sacc[4 * i + 2];
        scp[(r + 1) * kScLd + key + 8] = sacc[4 * i + 3];
      }
    }
    consumers_sync();
    // Online softmax (or P = S), rows warp, warp + 8, ...; lanes over the
    // 64 keys. P goes to its swizzled panel as bf16.
    for (int r = warp; r < kRows; r += kCW) {
      float x0, x1;
      if constexpr ((ST & kScores) != 0) {
        x0 = sc[r * kScLd + lane] + sc[(kRows + r) * kScLd + lane];
        x1 = sc[r * kScLd + lane + 32] + sc[(kRows + r) * kScLd + lane + 32];
        if constexpr (!kRelative) {
          x0 = __fmul_rn(x0, a.scale);
          x1 = __fmul_rn(x1, a.scale);
        }
      } else {
        x0 = __fmul_rn(col0[lane], a.scale);
        x1 = __fmul_rn(col0[lane + 32], a.scale);
      }
      float p0 = x0, p1 = x1, alpha = 1.f, m_new = 0.f;
      if constexpr ((ST & kSoftmax) != 0) {
        const float m_old = m_s[r];
        m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
        p0 = __expf(x0 - m_new);
        p1 = __expf(x1 - m_new);
        alpha = __expf(m_old - m_new);
      }
      if (r >= a.hq) p0 = p1 = 0.f;
      unsigned char* prow = smem + kPOff;
      *reinterpret_cast<bf16*>(prow + swz(r, lane * 2)) = __float2bfloat16_rn(p0);
      *reinterpret_cast<bf16*>(prow + swz(r, lane * 2 + 64)) = __float2bfloat16_rn(p1);
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        if constexpr ((ST & kSoftmax) != 0) m_s[r] = m_new;
        a_s[r] = alpha;
        rs_s[r] = psum;
      }
    }
    fence_async_smem();
    consumers_sync();
    if constexpr (kVPath_) {
      // t^T += v_us^T . P^T: stage i holds ranks [256 i, 256 i + 256), of
      // which this warpgroup takes the panels 4 i + grp and 4 i + 2 + grp.
#pragma unroll
      for (int i = 0; i < (kMaxVJ + 1) / 2; ++i) {
        if (i < nvs) {
          const int n = n0 + nkv + i, s = n % kStages;
          mbar_wait(full0 + 8 * s, (n / kStages) & 1);
          const unsigned char* st = ring + s * kStageB;
#pragma unroll
          for (int q2 = 0; q2 < 2; ++q2) {
            const int j = 2 * i + q2, vp = 2 * j + grp;
            if (j < kMaxVJ && vp < nvp) {
#pragma unroll
              for (int ii = 0; ii < 4; ++ii) {
                const float a0 = a_s[8 * ii + 2 * tq], a1 = a_s[8 * ii + 2 * tq + 1];
                acc[j][4 * ii] *= a0;
                acc[j][4 * ii + 1] *= a1;
                acc[j][4 * ii + 2] *= a0;
                acc[j][4 * ii + 3] *= a1;
              }
              // A fragments: ranks r0 = 16 wq + g (+ 8) of the panel, keys
              // 16 kk + 2 tq (+ 1) and + 8, int8 -> bf16 (exact).
              const unsigned char* box = st + q2 * kBoxB;
              const int b0 = grp * 64 + 16 * wq + g;
              uint32_t vf[4][4];
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const int k = 16 * kk + 2 * tq + 8 * (q >> 1), byte = b0 + 8 * (q & 1);
                  vf[kk][q] = pack_bf16((float)(int8_t)box[swz(k, byte)],
                                        (float)(int8_t)box[swz(k + 1, byte)]);
                }
              fence_regs(vf);
              fence_regs(acc[j]);
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_rs_n32(acc[j], vf[kk], desc_b128(p_a + kk * 32, 16, 1024));
              wgmma_commit();
              wgmma_wait<0>();
              fence_regs(acc[j]);
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * s);  // both warpgroups read the stage
        }
      }
    } else {
      const int8_t* v0 = a.v_us + ((size_t)bi * a.s + key0) * rv;
#pragma unroll
      for (int j = 0; j < kMaxVJ; ++j)
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int r = 8 * (e >> 2) + 2 * tq + (e & 1);
          const int rank = (2 * j + grp) * 64 + 16 * wq + g + 8 * ((e >> 1) & 1);
          const float vv = rank < rv ? (float)v0[rank] : 0.f;
          acc[j][e] = __fadd_rn(__fadd_rn(__fmul_rn(acc[j][e], a_s[r]), rs_s[r]), vv);
        }
    }
  }
  // This CTA's partial: t's first kHD ranks (value panels 0 and 1, j = 0)
  // and m.
  const size_t base = ((size_t)bi * a.nsplit + split) * a.hq;
  if (grp * 64 < kHD) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int r = 8 * (e >> 2) + 2 * tq + (e & 1);
      const int rank = grp * 64 + 16 * wq + g + 8 * ((e >> 1) & 1);
      if (r < a.hq) a.part_t[(base + r) * kHD + rank] = acc[0][e];
    }
  }
  if (tid < a.hq) a.part_m[base + tid] = m_s[tid];
}

// k_vt (b, rk, m) -> (b, m, rk), int8, in 64 x 64 tiles: the K-major B
// operand of the s8 rebuild.
__global__ void __launch_bounds__(256) transpose_kvt_kernel(const int8_t* __restrict__ in,
                                                            int8_t* __restrict__ out, int rk,
                                                            int m) {
  __shared__ uint32_t tile[64][17];  // [rank][column / 4]
  const int c0 = blockIdx.x * 64, r0 = blockIdx.y * 64, bi = blockIdx.z;
  const int8_t* src = in + (size_t)bi * rk * m;
  int8_t* dst = out + (size_t)bi * m * rk;
  for (int i = threadIdx.x; i < 64 * 16; i += 256) {
    const int r = i / 16, c = i % 16;
    tile[r][c] = *reinterpret_cast<const uint32_t*>(src + (size_t)(r0 + r) * m + c0 + 4 * c);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * 16; i += 256) {
    const int c = i / 16, r = 4 * (i % 16);  // column, first of 4 ranks
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) w |= ((tile[r + j][c / 4] >> (8 * (c % 4))) & 0xFFu) << (8 * j);
    *reinterpret_cast<uint32_t*>(dst + (size_t)(c0 + c) * rk + r0 + r) = w;
  }
}

// One CTA per (row, 32 columns, sequence): M = max_j m_j and the weights
// w_j = exp(m_j - M) (1 when M = -inf: softmax off) taken once into shared
// memory; then each of the four warps sums a quarter of the splits for the
// 32 columns, with their loads in flight together, and the quarters add.
constexpr int kMergeCols = 32;
__global__ void __launch_bounds__(128) ablation_merge_kernel(
    const float* __restrict__ part_t, const float* __restrict__ part_m, bf16* __restrict__ out,
    float* __restrict__ m_out, int hq, int nsplit) {
  extern __shared__ float w_s[];  // [nsplit]
  __shared__ float red[4][kMergeCols];
  const int r = blockIdx.x, c0 = blockIdx.y * kMergeCols, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, quarter = tid >> 5;
  const float* pm = part_m + (size_t)bi * nsplit * hq + r;
  float mx = -INFINITY;
  for (int i = tid; i < nsplit; i += 128) mx = fmaxf(mx, pm[(size_t)i * hq]);
  red[quarter][lane] = warp_max(mx);
  __syncthreads();
  const float M = fmaxf(fmaxf(red[0][0], red[1][0]), fmaxf(red[2][0], red[3][0]));
  for (int i = tid; i < nsplit; i += 128)
    w_s[i] = M == -INFINITY ? 1.f : __expf(pm[(size_t)i * hq] - M);
  __syncthreads();
  const float* pt = part_t + ((size_t)bi * nsplit * hq + r) * kHD + c0 + lane;
  float o = 0.f;
#pragma unroll 8
  for (int i = quarter; i < nsplit; i += 4) o += w_s[i] * pt[(size_t)i * hq * kHD];
  red[quarter][lane] = o;  // every warp has read red[.][0] before the second sync
  __syncthreads();
  if (quarter == 0) {
    o = (red[0][lane] + red[1][lane]) + (red[2][lane] + red[3][lane]);
    out[((size_t)bi * hq + r) * kHD + c0 + lane] = __float2bfloat16_rn(o);
    if (lane == 0 && blockIdx.y == 0) m_out[(size_t)bi * hq + r] = M;
  }
}

struct Maps {
  CUtensorMap q, kus, kvt, vus, cos, sin;
};

template <int ST>
int launch_split(const Maps& mp, const Params& p, int b, cudaStream_t st) {
  auto kern = ablation_split_kernel<ST>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(p.nsplit, 1, b), kTP, kSmem, st>>>(mp.q, mp.kus, mp.kvt, mp.vus, mp.cos, mp.sin,
                                                 p);
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, hq, hkv*hd) bf16, hd 128, hq <= 32, hkv*hd <= 1024; k_us (b, s, rk),
// k_vt (b, rk, hkv*hd), v_us (b, s, rv) int8, s a multiple of 64, rk a
// multiple of 64 up to 512, rv a multiple of 16 in [128, 768]; k_scale (b,
// hkv*hd) fp32; cos_tab/sin_tab (s, tw) bf16 (tw = hd/2 half tables for
// `rope`, hd for `roll` and `ropeq`); trig (2, hd) fp32 [cos_t; sin_t]; all
// contiguous. `stages` is a bitmask of the stage enum above, one of the
// tool's ten stage sets. Scratch kvt_t (b, hkv*hd, rk) int8, part_t (b,
// nsplit, hq, hd), part_m (b, nsplit, hq) fp32. Writes out (b, hq, hd)
// bf16 and m_out (b, hq) fp32.
extern "C" int xkv_ablation_step(const void* q, const void* k_us, const void* k_vt,
                                 const void* v_us, const void* k_scale, const void* cos_tab,
                                 const void* sin_tab, const void* trig, void* kvt_t,
                                 void* part_t, void* part_m, void* out, void* m_out, int b,
                                 int hq, int hkv, int hd, int s, int rk, int rv, int tw,
                                 float scale, int stages, int nsplit, void* stream) {
  const int m = hkv * kHD;
  if (hd != kHD || hq < 1 || hq > kRows || hkv < 1 || hkv > kMaxHeads || s < kBS ||
      s % kBS != 0 || rk < 64 || rk % 64 != 0 || rk > kMaxRk || rv < kHD || rv > 64 * 2 * kMaxVJ ||
      rv % 16 != 0 || (tw != kHD && tw != kHD / 2) || nsplit < 1 || nsplit > 8192 || b < 1)
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  Maps mp;
  if (!byte_map(enc, &mp.q, q, 2LL * m, hq, b, 2LL * m, 2LL * m * hq, 128, kRows) ||
      !byte_map(enc, &mp.kus, k_us, rk, s, b, rk, (long long)s * rk) ||
      !byte_map(enc, &mp.kvt, kvt_t, rk, m, b, rk, (long long)m * rk, 128, 128) ||
      !byte_map(enc, &mp.vus, v_us, rv, s, b, rv, (long long)s * rv) ||
      !byte_map(enc, &mp.cos, cos_tab, 2LL * tw, s, 1, 2LL * tw, 2LL * tw * s) ||
      !byte_map(enc, &mp.sin, sin_tab, 2LL * tw, s, 1, 2LL * tw, 2LL * tw * s))
    return (int)cudaErrorInvalidValue;
  const Params p{(const int8_t*)v_us, (const float*)k_scale, (const float*)trig,
                 (float*)part_t, (float*)part_m, hq, hkv, s, rk, rv, scale, nsplit};
  if (stages & kRecon) {
    transpose_kvt_kernel<<<dim3(m / 64, rk / 64, b), 256, 0, st>>>(
        (const int8_t*)k_vt, (int8_t*)kvt_t, rk, m);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  int err;
  switch (stages) {
    case kAll: err = launch_split<kAll>(mp, p, b, st); break;
    case kAll & ~kRecon: err = launch_split<kAll & ~kRecon>(mp, p, b, st); break;
    case kAll & ~kScaleMul: err = launch_split<kAll & ~kScaleMul>(mp, p, b, st); break;
    case kAll & ~kRope: err = launch_split<kAll & ~kRope>(mp, p, b, st); break;
    case kAll & ~kScores: err = launch_split<kAll & ~kScores>(mp, p, b, st); break;
    case kAll & ~kSoftmax: err = launch_split<kAll & ~kSoftmax>(mp, p, b, st); break;
    case kAll & ~kVPath: err = launch_split<kAll & ~kVPath>(mp, p, b, st); break;
    case (kAll & ~kRope) | kRoll: err = launch_split<(kAll & ~kRope) | kRoll>(mp, p, b, st); break;
    case (kAll & ~kRope) | kRopeQ:
      err = launch_split<(kAll & ~kRope) | kRopeQ>(mp, p, b, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  ablation_merge_kernel<<<dim3(hq, kHD / kMergeCols, b), 128, nsplit * sizeof(float), st>>>(
      (const float*)part_t, (const float*)part_m, (bf16*)out, (float*)m_out, hq, nsplit);
  return (int)cudaGetLastError();
}
