// K3's resident split kernel and its merge (lowrank_attention.cu has the
// design), shared with K9 (kernel_variants.cu): the kernel takes the score
// stage as a template argument. K3 and K5 instantiate their own stage
// (kScoreK3: the trig products as mma.sync B fragments against query
// fragments held in registers); K9 instantiates the two other designs it
// studies (kScoreTwoGemm, kScoreScratchAB). Everything else (producer
// warp, TMA ring, resident k_vt, wgmma rebuild, online softmax, P @ v_us,
// merge) is the same code. Also the shared-memory layout and the copy and
// ldmatrix helpers of K3's streamed kernel.
#pragma once

#include <type_traits>

#include "decode_common.cuh"
#include "hopper.cuh"

namespace xkv {
namespace {

constexpr int kHR = 16;             // query rows per CTA (one head's row tile)
constexpr int kWarps = 8;
constexpr int kT = kWarps * 32;     // threads per CTA
constexpr int kStages = 4;          // cp.async ring depth
constexpr int kChunk = 128;         // bytes of a staged chunk row
constexpr int kRowB = kChunk + 16;  // padded chunk row stride (bytes)
constexpr int kStageUs = kBS * kRowB;
constexpr int kMaxSmem = 232448;    // opt-in shared memory of one CTA

// Shared-memory sizes of the split kernels: the fixed part (q rows,
// scores, P, m, l, alpha), the resident k_vt slice, and the streamed
// path's ring stage (a k_us, cos, sin or v_us chunk beside a k_vt chunk).
template <typename T, int HD>
struct Layout {
  static constexpr int kQLd = 2 * HD + 8;  // bf16 elements per query row
  static constexpr int kQBytes = kHR * kQLd * 2;
  static constexpr int kScBytes = 2 * kHR * kBS * 4;  // two column halves
  static constexpr int kPLd = kBS + 8;
  static constexpr int kPBytes = kHR * kPLd * 2;
  static constexpr int kFixed = kQBytes + kScBytes + kPBytes + 3 * kHR * 4;
  static constexpr int kRanks = kChunk / (int)sizeof(T);  // ranks of a k chunk
  static constexpr int kNatLd = HD * (int)sizeof(T) + 16;  // bytes per k_vt rank row
  static constexpr int kVtChunk = kRanks * kNatLd;          // streamed k_vt chunk
  __host__ __device__ static int resident_bytes(int rk) {
    return sizeof(T) == 2 ? rk * kNatLd : HD * (rk + 16);
  }
  static constexpr int kStage = kStageUs + kVtChunk;
  static constexpr int kStreamSmem = kStages * kStage + kFixed;
};

// 16 bytes global -> shared, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// ---- The resident path: k_vt resident, a TMA ring fed by a producer warp.
constexpr int kCStages = 4;             // ring depth
constexpr int kPanel = 64 * 128;        // one 128-byte panel of a 64-row chunk
constexpr int kCStage = 2 * kPanel;     // a chunk: 64 rows x 256 bytes, two panels
constexpr int kMaxVC2 = 8;              // 128-rank value chunks of a slice: <= 1024 ranks
constexpr int kTP = kT + 32;            // 8 consumer warps and the producer warp

// Score stages of the resident split kernel: K3's own (the trig products
// as mma.sync B fragments against query fragments in registers), and the
// two designs K9 studies (two_gemm: the products as wgmma register A
// operands; scratch_ab: the products staged in shared memory for one
// wgmma of depth 2 hd).
enum : int { kScoreK3 = 0, kScoreTwoGemm = 1, kScoreScratchAB = 2 };

template <typename T, int HD, int kScore = kScoreK3>
struct TmaLayout {
  using L = Layout<T, HD>;
  // scratch_ab's staged panel does not fit beside four stages and the
  // resident bf16 slice at rank 512: it takes one stage less.
  static constexpr int kStages = kScore == kScoreScratchAB ? kCStages - 1 : kCStages;
  static constexpr int kRing = kStages * kCStage;
  static constexpr int kBars = 2 * kStages * 8;
  // scratch_ab: [K*cos | K*sin] of a block, 64 keys x 2 hd bf16 as four
  // swizzled 64-column panels.
  static constexpr int kAB = kScore == kScoreScratchAB ? 2 * HD * kBS * 2 : 0;
  // K3: the query rows (padded), read once into registers; K9: [qa | qb]
  // as four swizzled (16 rows x 64 columns) wgmma B panels.
  static constexpr int kQ = kScore == kScoreK3 ? L::kQBytes : 2 * HD * kHR * 2;
  // Scores: a column half each warpgroup (scratch_ab: one product).
  static constexpr int kSc = kScore == kScoreScratchAB ? L::kScBytes / 2 : L::kScBytes;
  static constexpr int kFixed = kQ + kSc + L::kPBytes + 3 * kHR * 4;
  // hd 128 keeps k_vt as wgmma operands in the 128-byte swizzle: bf16 as
  // two [rank][64 columns] panels, int8 transposed as [column][128 ranks]
  // panels; hd 64 as the mma.sync path's padded rows (Layout).
  __host__ __device__ static int resident_bytes(int rk) {
    if (HD == 64) return L::resident_bytes(rk);
    return sizeof(T) == 2 ? rk * 2 * HD : (rk + 127) / 128 * 128 * HD;
  }
  // Base aligned to 1024 by hand (the swizzle atom), hence the slack.
  __host__ __device__ static int smem(int rk) {
    return 1024 + kRing + resident_bytes(rk) + kAB + kFixed + kBars;
  }
};

// K9's b<N>: the dense walk `w` cut into runs of `run` blocks from the live
// range's first, split i taking run i, so a split walks N = 64 run keys as
// the TPU tool's grid step walks block_s; run 0 keeps w, K3's even deal.
__device__ __forceinline__ BlockWalk in_runs(BlockWalk w, int split, int run) {
  if (run > 0) {
    const int first = w.lo / kBS;
    const int last = w.hi > w.lo ? (w.hi + kBS - 1) / kBS : first;
    w.begin = min(first + split * run, last);
    w.end = min(w.begin + run, last);
  }
  return w;
}

// (row, byte) of a 64-row x 256-byte chunk stored as two swizzled panels.
__device__ __forceinline__ int chunk_off(int row, int byte) {
  return (byte >> 7) * kPanel + swz(row, byte & 127);
}

// The 8 consumer warps' barrier (the producer warp does not take part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kT) : "memory");
}

// D (64 keys x 64 columns) += A (64 x 16 ranks, K-major) B (16 x 64, MN-major).
__device__ __forceinline__ void wgmma_rebuild(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// D (64 keys x 64 columns, s32) += A (64 x 32 ranks) B (32 x 64), both K-major.
__device__ __forceinline__ void wgmma_rebuild(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db));
}

// K9's score products, S^T (64 keys x 16 query rows, fp32): D += A B with
// B the K-major [qa | qb] panel of 16 columns and A the keys' trig
// products, from registers (two_gemm) or a K-major shared panel
// (scratch_ab).
__device__ __forceinline__ void wgmma_score(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_score(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, 1, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db));
}

// The split kernel of the resident path: one CTA per (kv head hk, row tile,
// key split, sequence). Warp 8 is the producer: its lane 0 loads every
// chunk of the CTA's blocks (k_us, [cos | sin], v_us; 64 rows x 256 bytes)
// by TMA into a 4-stage ring, each stage with a full barrier (the bytes
// landed) and an empty one (all 8 consumer warps read it). Warps 0-7
// consume: per block the k_us chunks (rebuild against the resident k_vt:
// wgmma at hd 128, one m64n64 product per warpgroup and column half;
// mma.sync at hd 64), [cos | sin] (scores), softmax, the v_us chunks
// (t += P @ v_us). kSliced as the streamed kernel's. kSparse: K5, over the
// chunks `ids`; without, K3, whose code then holds no chunk walk. kScore:
// the score stage (K3's, or one of K9's at hd 128, whose instances also
// take `run` > 0: split i walks the live blocks [i run, (i + 1) run)).
template <typename T, int HD, bool kSliced, bool kSparse, int kScore = kScoreK3>
__global__ void __launch_bounds__(kTP, 1) lowrank_tma_split_kernel(
    const __grid_constant__ CUtensorMap tm_kus, const __grid_constant__ CUtensorMap tm_vus,
    const __grid_constant__ CUtensorMap tm_cos, const __grid_constant__ CUtensorMap tm_sin,
    const bf16* __restrict__ qab, const T* __restrict__ k_vt, const int* __restrict__ lens,
    const int* __restrict__ los, const int* __restrict__ ids, int n_sel, int chunk,
    float* __restrict__ part_t, float* __restrict__ part_m, float* __restrict__ part_l,
    int* __restrict__ done, int R, int hq, int hkv, int s_p, int rk, int rv, long long sb_kvt,
    long long ld_kvt, int nsplit, int ntiles, int vslice, int run) {
  using L = Layout<T, HD>;
  using TL = TmaLayout<T, HD, kScore>;
  using Acc = typename std::conditional<sizeof(T) == 2, float, int>::type;
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr bool kWgmma = HD == 128;
  constexpr bool kK3 = kScore == kScoreK3;
  static_assert(kK3 || (kWgmma && !kSliced && !kSparse), "K9's stages: hd 128, one slice, dense");
  constexpr int kNT = HD / 16;  // rebuild n-tiles of a warp's column half
  constexpr int kNS = TL::kStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = smem;
  unsigned char* kvt_s = ring + TL::kRing;
  unsigned char* ab_s = kvt_s + TL::resident_bytes(rk);  // scratch_ab's staged panel
  bf16* q_s = reinterpret_cast<bf16*>(ab_s + TL::kAB);
  float* sc = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(q_s) + TL::kQ);
  bf16* p_s = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(sc) + TL::kSc);
  float* m_s = reinterpret_cast<float*>(p_s + kHR * L::kPLd);
  float* l_s = m_s + kHR;
  float* a_s = l_s + kHR;
  uint64_t* bars = reinterpret_cast<uint64_t*>(a_s + kHR);  // full[kNS], empty[kNS]
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kNS);

  const int hk = blockIdx.y / ntiles, rt = blockIdx.y % ntiles;
  // Value slice vs holds ranks [v0, v0 + rvs).
  const int nvs = kSliced ? (rv + vslice - 1) / vslice : 1;
  const int split = kSliced ? blockIdx.x / nvs : blockIdx.x, bi = blockIdx.z;
  const int vs = kSliced ? blockIdx.x % nvs : 0;
  const int v0 = vs * vslice, rvs = kSliced ? min(vslice, rv - v0) : rv;
  const int gsz = hq / hkv;
  const int head_rows = (R / hq) * gsz;
  const int nrows = min(kHR, head_rows - rt * kHR);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int mt = warp & 3, half = (warp >> 2) & 1;  // key tile, column half
  const BlockWalk dealt =
      block_walk(lens, los, kSparse ? ids : nullptr, n_sel, chunk, bi, s_p, split, nsplit);
  const BlockWalk walk = kK3 ? dealt : in_runs(dealt, split, run);
  if (blockIdx.x == 0 && tid == 0) done[((size_t)bi * hkv + hk) * ntiles + rt] = 0;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the merge may start
  auto grow = [&](int i) {  // the tile's row i -> row of (ql, hq)
    const int hr = rt * kHR + i;
    return (hr / gsz) * hq + hk * gsz + hr % gsz;
  };
  auto next_live = [&](int v) {
    while (v < walk.end && walk.key0(v) < 0) ++v;
    return v;
  };

  const int us_bytes = rk * (int)sizeof(T);
  const int nk = (us_bytes + 255) / 256;
  const int nv = (rvs + 127) / 128;
  const int nch = nk + 1 + nv;

  if (tid == kT) {
    for (int s = 0; s < kNS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kWarps) {
    // Producer: chunk n into stage n % kNS once the consumers have read
    // that stage's previous chunk. It starts while they load k_vt.
    if (lane == 0) {
      int n = 0;
      for (int v = next_live(walk.begin); v < walk.end; v = next_live(v + 1)) {
        const int key0 = walk.key0(v);
        for (int sub = 0; sub < nch; ++sub, ++n) {
          const int s = n % kNS;
          if (n >= kNS) mbar_wait(empty0 + 8 * s, (n / kNS - 1) & 1);
          const uint32_t full = full0 + 8 * s;
          const uint32_t dst = smem_u32(ring + s * kCStage);
          if (sub < nk) {
            mbar_expect_tx(full, kCStage);
            tma_box(dst, &tm_kus, full, sub * 256, key0, bi);
            tma_box(dst + kPanel, &tm_kus, full, sub * 256 + 128, key0, bi);
          } else if (sub == nk) {
            mbar_expect_tx(full, kCStage);
            tma_box(dst, &tm_cos, full, 0, key0, 0);
            tma_box(dst + kPanel, &tm_sin, full, 0, key0, 0);
          } else {
            const int x = (v0 + (sub - nk - 1) * 128) * (int)sizeof(T);
            mbar_expect_tx(full, kInt8 ? kPanel : kCStage);
            tma_box(dst, &tm_vus, full, x, key0, bi);
            if (!kInt8) tma_box(dst + kPanel, &tm_vus, full, x + 128, key0, bi);
          }
        }
      }
    }
    return;
  }
  // The head's k_vt slice, resident (cp.async; int8 transposed once).
  const T* kvt_b = k_vt + (size_t)bi * sb_kvt + hk * HD;
  if constexpr (!kInt8) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(kvt_b);
    for (int i = tid; i < rk * (HD / 8); i += kT) {
      const int r = i / (HD / 8), c = i % (HD / 8);  // rank, 16-byte unit of the row
      unsigned char* dst = kWgmma ? kvt_s + (c >> 3) * (rk * 128) + swz(r, (c & 7) * 16)
                                  : kvt_s + r * L::kNatLd + c * 16;
      cp_async16(dst, src + (size_t)r * ld_kvt * 2 + c * 16, true);
    }
    cp_async_commit();
  } else {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(kvt_b);
    for (int i = tid; i < (HD / 4) * (rk / 4); i += kT) {
      const int cg = i % (HD / 4), rg = i / (HD / 4);
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = *reinterpret_cast<const uint32_t*>(src + (size_t)(4 * rg + j) * ld_kvt + 4 * cg);
      const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
      const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * cg + j, r = 4 * rg;  // column, first rank
        unsigned char* d = kWgmma ? kvt_s + (r >> 7) * (128 * HD) + swz(n, r & 127)
                                  : kvt_s + (size_t)n * (rk + 16) + r;
        *reinterpret_cast<uint32_t*>(d) = col[j];
      }
    }
  }
  for (int i = tid; i < kHR * (HD / 4); i += kT) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < nrows) x = *reinterpret_cast<const uint4*>(qab + ((size_t)bi * R + grow(r)) * 2 * HD + c);
    if constexpr (kK3) {
      *reinterpret_cast<uint4*>(q_s + r * L::kQLd + c) = x;
    } else {  // 16-byte unit c / 8 of [qa | qb]: panel c / 64, (16 rows x 128 bytes)
      *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(q_s) + (c >> 6) * (kHR * 128) +
                                swz(r, (c & 63) * 2)) = x;
    }
  }
  if (tid < kHR) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // k_vt (K9: q) for wgmma
  consumers_sync();

  uint32_t qa_f[HD / 32][4], qb_f[HD / 32][4];
  if constexpr (kK3) {
#pragma unroll
    for (int s = 0; s < HD / 32; ++s) {
      const bf16* qrow = q_s + (lane & 15) * L::kQLd + half * (HD / 2) + s * 16 + (lane >> 4) * 8;
      ldsm_x4(qa_f[s], qrow);
      ldsm_x4(qb_f[s], qrow + HD);
    }
  }
  const uint32_t q_a = smem_u32(q_s), ab_a = smem_u32(ab_s);  // K9's wgmma operands

  // Consumer: wait for chunk q; after reading it each warp releases the stage.
  int q = 0;
  auto acquire = [&]() -> const unsigned char* {
    const int s = q % kNS;
    mbar_wait(full0 + 8 * s, (q / kNS) & 1);
    return ring + s * kCStage;
  };
  auto release = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (q % kNS));
    ++q;
  };

  float acc_v[kMaxVC2][2][4];
#pragma unroll
  for (int c = 0; c < kMaxVC2; ++c)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) acc_v[c][nt][0] = acc_v[c][nt][1] = acc_v[c][nt][2] = acc_v[c][nt][3] = 0.f;

  for (int v = next_live(walk.begin); v < walk.end; v = next_live(v + 1)) {
    const int key0 = walk.key0(v);
    // Rebuild this warp's 16 keys x hd/2 columns of K = k_us @ k_vt
    // (kacc[4 nt + e]: the mma C fragment of n-tile nt; wgmma's accumulator
    // of a warpgroup's 64 x 64 product has the same layout).
    Acc kacc[kNT * 4];
#pragma unroll
    for (int i = 0; i < kNT * 4; ++i) kacc[i] = 0;
    for (int kc = 0; kc < nk; ++kc) {
      const unsigned char* st = acquire();
      const int ksteps = min(256, us_bytes - kc * 256) / 32;
      if constexpr (kWgmma) {
        const uint32_t a0 = smem_u32(st), b0 = smem_u32(kvt_s);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          if (ks < ksteps) {
            const uint64_t da = desc_b128(a0 + (ks >> 2) * kPanel + (ks & 3) * 32, 16, 1024);
            uint64_t db;
            if constexpr (!kInt8) {  // [rank][64 columns] panel of this half, 16 ranks
              db = desc_b128(b0 + half * (rk * 128) + (kc * 128 + ks * 16) * 128, rk * 128, 1024);
            } else {  // [column][128 ranks] panel, this half's 64 columns, 32 ranks
              const int r0 = kc * 256 + ks * 32;
              db = desc_b128(b0 + (r0 >> 7) * (128 * HD) + half * 64 * 128 + (r0 & 127), 16, 1024);
            }
            wgmma_rebuild(kacc, da, db);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(kacc);
      } else {
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          if (ks < ksteps) {
            uint32_t a[4];
            ldsm_x4(a, st + chunk_off(mt * 16 + (lane & 15), ks * 32 + (lane >> 4) * 16));
#pragma unroll
            for (int np = 0; np < kNT / 2; ++np) {
              const int n0 = half * (HD / 2) + np * 16;  // first column of the n-tile pair
              uint32_t b[4];
              if constexpr (!kInt8) {
                const int rank = kc * 128 + ks * 16 + (lane & 15);
                ldsm_x4_t(b, kvt_s + rank * L::kNatLd + (n0 + (lane >> 4) * 8) * 2);
                mma_bf16_16816(&kacc[8 * np], a, b[0], b[1]);
                mma_bf16_16816(&kacc[8 * np + 4], a, b[2], b[3]);
              } else {
                ldsm_x4(b, kvt_s + (size_t)(n0 + (lane & 7) + (lane >> 4) * 8) * (rk + 16) +
                               kc * 256 + ks * 32 + ((lane >> 3) & 1) * 16);
                mma_s8_16832(&kacc[8 * np], a, b[0], b[1]);
                mma_s8_16832(&kacc[8 * np + 4], a, b[2], b[3]);
              }
            }
          }
        }
      }
      release();
    }
    // Scores: qa . (K*cos) + qb . (K*sin), keys rounded to bf16 and the trig
    // products in bf16; the key fragments are the B operand (keys as n).
    if constexpr (kK3) {
      const unsigned char* st = acquire();
      float s_acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int s = 0; s < HD / 32; ++s) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = mt * 16 + g + 8 * j;
          const __nv_bfloat162 k0 = __floats2bfloat162_rn((float)kacc[8 * s + 2 * j],
                                                          (float)kacc[8 * s + 2 * j + 1]);
          const __nv_bfloat162 k1 = __floats2bfloat162_rn((float)kacc[8 * s + 4 + 2 * j],
                                                          (float)kacc[8 * s + 4 + 2 * j + 1]);
#pragma unroll
          for (int tab = 0; tab < 2; ++tab) {
            const __nv_bfloat162 t0 = *reinterpret_cast<const __nv_bfloat162*>(
                st + chunk_off(row, tab * 128 + 32 * s + 4 * tq));
            const __nv_bfloat162 t1 = *reinterpret_cast<const __nv_bfloat162*>(
                st + chunk_off(row, tab * 128 + 32 * s + 16 + 4 * tq));
            const __nv_bfloat162 kt0 = __hmul2(k0, t0), kt1 = __hmul2(k1, t1);
            mma_bf16_16816(s_acc[j], tab == 0 ? qa_f[s] : qb_f[s],
                           *reinterpret_cast<const uint32_t*>(&kt0),
                           *reinterpret_cast<const uint32_t*>(&kt1));
          }
        }
      }
      release();
      float* sch = sc + half * kHR * kBS;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = mt * 16 + j * 8 + 2 * tq;
        *reinterpret_cast<float2*>(sch + g * kBS + key) = make_float2(s_acc[j][0], s_acc[j][1]);
        *reinterpret_cast<float2*>(sch + (g + 8) * kBS + key) =
            make_float2(s_acc[j][2], s_acc[j][3]);
      }
    } else {
      // K9: the same trig products, then the design's product of
      // S^T (64 keys x 16 rows) on wgmma against the [qa | qb] panels.
      const unsigned char* st = acquire();
      uint32_t ktc[HD / 32][4], kts[HD / 32][4];  // two_gemm's A fragments, k-step s
#pragma unroll
      for (int s = 0; s < HD / 32; ++s) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = mt * 16 + g + 8 * j;
          const __nv_bfloat162 k0 = __floats2bfloat162_rn((float)kacc[8 * s + 2 * j],
                                                          (float)kacc[8 * s + 2 * j + 1]);
          const __nv_bfloat162 k1 = __floats2bfloat162_rn((float)kacc[8 * s + 4 + 2 * j],
                                                          (float)kacc[8 * s + 4 + 2 * j + 1]);
#pragma unroll
          for (int tab = 0; tab < 2; ++tab) {
            const __nv_bfloat162 t0 = *reinterpret_cast<const __nv_bfloat162*>(
                st + chunk_off(row, tab * 128 + 32 * s + 4 * tq));
            const __nv_bfloat162 t1 = *reinterpret_cast<const __nv_bfloat162*>(
                st + chunk_off(row, tab * 128 + 32 * s + 16 + 4 * tq));
            const __nv_bfloat162 kt0 = __hmul2(k0, t0), kt1 = __hmul2(k1, t1);
            if constexpr (kScore == kScoreTwoGemm) {
              const uint32_t a0 = *reinterpret_cast<const uint32_t*>(&kt0);
              const uint32_t a1 = *reinterpret_cast<const uint32_t*>(&kt1);
              if (tab == 0) {
                ktc[s][j] = a0;
                ktc[s][2 + j] = a1;
              } else {
                kts[s][j] = a0;
                kts[s][2 + j] = a1;
              }
            } else {  // panel (table, column half) of the staged [K*cos | K*sin]
              unsigned char* pa = ab_s + (2 * tab + half) * kPanel;
              *reinterpret_cast<__nv_bfloat162*>(pa + swz(row, 32 * s + 4 * tq)) = kt0;
              *reinterpret_cast<__nv_bfloat162*>(pa + swz(row, 32 * s + 16 + 4 * tq)) = kt1;
            }
          }
        }
      }
      release();
      float sacc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) sacc[e] = 0.f;
      if constexpr (kScore == kScoreTwoGemm) {
        // Each warpgroup its column half: S^T += (K*cos) qa^T, then
        // (K*sin) qb^T, the products as register A operands.
        fence_regs(ktc);
        fence_regs(kts);
        fence_regs(sacc);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < HD / 32; ++s)
          wgmma_score(sacc, ktc[s], desc_b128(q_a + half * (kHR * 128) + s * 32, 16, 1024));
#pragma unroll
        for (int s = 0; s < HD / 32; ++s)
          wgmma_score(sacc, kts[s], desc_b128(q_a + (2 + half) * (kHR * 128) + s * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
      } else {
        // The staged panel is read by wgmma (the async proxy). Warpgroup 0
        // takes the whole depth 2 hd in one product; warpgroup 1 waits at
        // the barrier before the softmax.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumers_sync();
        if (half == 0) {
          fence_regs(sacc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 2 * HD / 16; ++kk)
            wgmma_score(sacc, desc_b128(ab_a + (kk >> 2) * kPanel + (kk & 3) * 32, 16, 1024),
                        desc_b128(q_a + (kk >> 2) * (kHR * 128) + (kk & 3) * 32, 16, 1024));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sacc);
        }
      }
      if (kScore == kScoreTwoGemm || half == 0) {
        // sacc[4 i + e]: key mt * 16 + g (+ 8 for e >= 2), row 8 i + 2 tq (+ 1 for odd e).
        float* sch = sc + half * kHR * kBS;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sch[(8 * (e >> 2) + 2 * tq + (e & 1)) * kBS + mt * 16 + g + 8 * ((e >> 1) & 1)] = sacc[e];
      }
    }
    consumers_sync();
    // Online softmax, rows warp and warp + 8; lanes over the 64 keys, live
    // below the block's chunk end (key_hi: read here, where it is used).
    const int key_hi = walk.key_hi(v);
    for (int r = warp; r < kHR; r += kWarps) {
      const int c0 = key0 + lane, c1 = c0 + 32;
      const bool live0 = r < nrows && c0 >= walk.lo && c0 < key_hi;
      const bool live1 = r < nrows && c1 >= walk.lo && c1 < key_hi;
      float x0, x1;
      if constexpr (kScore == kScoreScratchAB) {  // one product: one half of sc
        x0 = live0 ? sc[r * kBS + lane] : kNegInf;
        x1 = live1 ? sc[r * kBS + lane + 32] : kNegInf;
      } else {
        x0 = live0 ? sc[r * kBS + lane] + sc[(kHR + r) * kBS + lane] : kNegInf;
        x1 = live1 ? sc[r * kBS + lane + 32] + sc[(kHR + r) * kBS + lane + 32] : kNegInf;
      }
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
    consumers_sync();
    uint32_t pf[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldsm_x4(pf[ks], p_s + (lane & 15) * L::kPLd + ks * 16 + (lane >> 4) * 8);
    {
      const float a0 = a_s[g], a1 = a_s[g + 8];
#pragma unroll
      for (int c = 0; c < kMaxVC2; ++c)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          acc_v[c][nt][0] *= a0;
          acc_v[c][nt][1] *= a0;
          acc_v[c][nt][2] *= a1;
          acc_v[c][nt][3] *= a1;
        }
    }
    // t += P @ v_us; warp w owns ranks [128 c + 16 w, +16) of chunk c.
#pragma unroll
    for (int c = 0; c < kMaxVC2; ++c) {
      if (c < nv) {
        const unsigned char* st = acquire();
        if (c * 128 + warp * 16 < rvs) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            uint32_t b[4];
            if constexpr (!kInt8) {
              ldsm_x4_t(b, st + chunk_off(ks * 16 + (lane & 15), warp * 32 + (lane >> 4) * 16));
            } else {
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                const int col = warp * 16 + nt * 8 + g;
#pragma unroll
                for (int h = 0; h < 2; ++h) {  // keys 2 tq (+1), + 8 h
                  const int k = ks * 16 + 2 * tq + 8 * h;
                  b[2 * nt + h] = pack_bf16((float)(int8_t)st[chunk_off(k, col)],
                                            (float)(int8_t)st[chunk_off(k + 1, col)]);
                }
              }
            }
            mma_bf16_16816(acc_v[c][0], pf[ks], b[0], b[1]);
            mma_bf16_16816(acc_v[c][1], pf[ks], b[2], b[3]);
          }
        }
        release();
      }
    }
  }
  const size_t base = ((size_t)bi * nsplit + split) * R;
#pragma unroll
  for (int c = 0; c < kMaxVC2; ++c) {
    if (c < nv && c * 128 + warp * 16 < rvs) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = v0 + c * 128 + warp * 16 + nt * 8 + 2 * tq;
        if (g < nrows)
          *reinterpret_cast<float2*>(part_t + (base + grow(g)) * rv + col) =
              make_float2(acc_v[c][nt][0], acc_v[c][nt][1]);
        if (g + 8 < nrows)
          *reinterpret_cast<float2*>(part_t + (base + grow(g + 8)) * rv + col) =
              make_float2(acc_v[c][nt][2], acc_v[c][nt][3]);
      }
    }
  }
  if (vs == 0 && tid < nrows) {
    part_m[base + grow(tid)] = m_s[tid];
    part_l[base + grow(tid)] = l_s[tid];
  }
}

// The resident split kernel with the score stage kScore (K9's: dense, one
// value slice; `run` as the kernel's).
template <typename T, int HD, bool kSliced, int kScore = kScoreK3>
int launch_tma(cudaStream_t st, const void* qab, const void* k_us, const void* k_vt,
               const void* v_us, const void* cos_h, const void* sin_h, const int* lens,
               const int* los, const int* ids, int n_sel, int chunk, void* part_t,
               void* part_m, void* part_l, int* done, int b, int R, int hq, int hkv, int s_p,
               int rk, int rv, long long sb_kvt, long long ld_kvt, int nsplit, int ntiles,
               int vslice, int run = 0) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const long long sz = sizeof(T);
  CUtensorMap tm_kus, tm_vus, tm_cos, tm_sin;
  if (!byte_map(enc, &tm_kus, k_us, rk * sz, s_p, b, rk * sz, (long long)s_p * rk * sz) ||
      !byte_map(enc, &tm_vus, v_us, rv * sz, s_p, b, rv * sz, (long long)s_p * rv * sz) ||
      !byte_map(enc, &tm_cos, cos_h, HD, s_p, 1, HD, (long long)s_p * HD) ||
      !byte_map(enc, &tm_sin, sin_h, HD, s_p, 1, HD, (long long)s_p * HD))
    return (int)cudaErrorInvalidValue;
  const int smem = TmaLayout<T, HD, kScore>::smem(rk);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = lowrank_tma_split_kernel<T, HD, kSliced, false, kScore>;
  if constexpr (kScore == kScoreK3) {
    if (ids != nullptr) kern = lowrank_tma_split_kernel<T, HD, kSliced, true>;
  }
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int nvs = (rv + vslice - 1) / vslice;
  kern<<<dim3(nsplit * nvs, hkv * ntiles, b), kTP, smem, st>>>(
      tm_kus, tm_vus, tm_cos, tm_sin, (const bf16*)qab, (const T*)k_vt, lens, los, ids, n_sel,
      chunk, (float*)part_t, (float*)part_m, (float*)part_l, done, R, hq, hkv, s_p, rk, rv,
      sb_kvt, ld_kvt, nsplit, ntiles, vslice, run);
  return (int)cudaGetLastError();
}

// The merge: one CTA per (head hk, row tile, 64-rank chunk c, sequence)
// combines the splits' (t, m, l) of its ranks by log-sum-exp, scales t by
// 1/L and the int8 per-rank V scale (or 1), rounds it to bf16 and writes
// the chunk's share of t @ v_vt over the head's hd columns, part_o
// (b, nchunks, R, hd) fp32, reading v_vt rows coalesced; chunk 0 writes
// lse. `done` counts the finished chunks of each (head, tile, sequence);
// the split kernel zeroes it. Launched as a programmatic dependent of the
// split kernel: it loads its v_vt values before waiting for the partials.
template <int HD>
__global__ void __launch_bounds__(kT) lowrank_merge_chunk_kernel(
    const float* __restrict__ part_t, const float* __restrict__ part_m,
    const float* __restrict__ part_l, const bf16* __restrict__ v_vt, long long sb_vvt,
    long long ld_vvt, const float* __restrict__ v_scale, float* __restrict__ part_o,
    int* __restrict__ done, bf16* __restrict__ out, float* __restrict__ lse_out, int R, int hq,
    int hkv, int rv, int nsplit, int ntiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* t_s = reinterpret_cast<float*>(smem);  // [kHR][64]
  float* inv_s = t_s + kHR * 64;                // [kHR]
  float* w_s = inv_s + kHR;                     // [kHR][nsplit]
  const int hk = blockIdx.x / ntiles, rt = blockIdx.x % ntiles;
  const int c = blockIdx.y, bi = blockIdx.z, nchunks = gridDim.y;
  const int gsz = hq / hkv;
  const int nrows = min(kHR, (R / hq) * gsz - rt * kHR);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto grow = [&](int i) {
    const int hr = rt * kHR + i;
    return (hr / gsz) * hq + hk * gsz + hr % gsz;
  };
  // The product is dealt out as (row, 64 columns) pairs, one per warp at a
  // time, each lane owning two columns; the chunk's v_vt values of the
  // warp's first pair are loaded first, to arrive while the splits combine.
  constexpr int kHalves = HD / 64;
  const int npair = nrows * kHalves;
  const int nj = min(64, rv - c * 64);
  const bf16* vt = v_vt + (size_t)bi * sb_vvt + (size_t)(c * 64) * ld_vvt + hk * HD + 2 * lane;
  __nv_bfloat162 vv[64];
  auto load_v = [&](int pair) {
    const bf16* col = vt + (pair % kHalves) * 64;
#pragma unroll
    for (int jj = 0; jj < 64; ++jj)
      vv[jj] = jj < nj ? *reinterpret_cast<const __nv_bfloat162*>(col + (size_t)jj * ld_vvt)
                       : __floats2bfloat162_rn(0.f, 0.f);
  };
  if (warp < npair) load_v(warp);
  // Launched early (programmatic dependent launch): wait for the split
  // kernel's partials only now.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int i = warp; i < nrows; i += kWarps) {
    const int r = grow(i);
    float mx = kNegInf;
    for (int s = lane; s < nsplit; s += 32) mx = fmaxf(mx, part_m[((size_t)bi * nsplit + s) * R + r]);
    const float M = warp_max(mx);
    float ls = 0.f;
    for (int s = lane; s < nsplit; s += 32) {
      const size_t idx = ((size_t)bi * nsplit + s) * R + r;
      const float w = __expf(part_m[idx] - M);
      w_s[i * nsplit + s] = w;
      ls += w * part_l[idx];
    }
    const float Lsum = warp_sum(ls);
    if (lane == 0) {
      inv_s[i] = Lsum > 0.f ? 1.f / Lsum : 0.f;
      if (c == 0) lse_out[(size_t)bi * R + r] = M + logf(fmaxf(Lsum, 1e-30f));
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kHR * 64; idx += kT) {
    const int i = idx >> 6, j = c * 64 + (idx & 63);
    float tt = 0.f;
    if (i < nrows && j < rv) {
      const float* pt = part_t + ((size_t)bi * nsplit * R + grow(i)) * rv + j;
      const size_t ss = (size_t)R * rv;  // split stride
      float acc = 0.f;
#pragma unroll 16
      for (int s = 0; s < nsplit; ++s) acc += w_s[i * nsplit + s] * pt[s * ss];
      tt = acc * inv_s[i];
      if (v_scale) tt *= v_scale[(size_t)bi * rv + j];
    }
    t_s[idx] = round_bf16(tt);
  }
  __syncthreads();
  for (int pair = warp; pair < npair; pair += kWarps) {
    if (pair != warp) load_v(pair);
    const int i = pair / kHalves;
    float2 o = make_float2(0.f, 0.f);
#pragma unroll
    for (int jj = 0; jj < 64; ++jj) {  // t_s is 0 past the chunk's ranks
      const float t = t_s[i * 64 + jj];
      const float2 v = __bfloat1622float2(vv[jj]);
      o.x += t * v.x;
      o.y += t * v.y;
    }
    *reinterpret_cast<float2*>(
        part_o + (((size_t)bi * nchunks + c) * R + grow(i)) * HD + (pair % kHalves) * 64 + 2 * lane) = o;
  }
  // The last chunk CTA of this (head, tile, sequence) to finish sums the
  // shares in chunk order.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(done + blockIdx.z * gridDim.x + blockIdx.x, 1) == nchunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int idx = tid; idx < nrows * HD; idx += kT) {
    const int i = idx / HD, dd = idx % HD;
    const size_t row = (size_t)grow(i) * HD + dd;
    float o = 0.f;
#pragma unroll 16
    for (int cc = 0; cc < nchunks; ++cc) o += __ldcg(part_o + ((size_t)bi * nchunks + cc) * R * HD + row);
    out[(size_t)bi * R * HD + row] = __float2bfloat16_rn(o);
  }
}

// Launch the merge over (hkv * ntiles, 64-rank chunks, b) as a programmatic
// dependent of the split kernel.
template <int HD>
int launch_merge(cudaStream_t st, const void* part_t, const void* part_m, const void* part_l,
                 const void* v_vt, long long sb_vvt, long long ld_vvt, const void* v_scale,
                 void* part_o, int* done, void* out, void* lse, int b, int R, int hq, int hkv,
                 int rv, int nsplit, int ntiles) {
  const int smem = (kHR * 64 + kHR + kHR * nsplit) * 4;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = lowrank_merge_chunk_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(hkv * ntiles, (rv + 63) / 64, b);
  cfg.blockDim = dim3(kT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, (const float*)part_t, (const float*)part_m,
                         (const float*)part_l, (const bf16*)v_vt, sb_vvt, ld_vvt,
                         (const float*)v_scale, (float*)part_o, done, (bf16*)out, (float*)lse, R,
                         hq, hkv, rv, nsplit, ntiles);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace xkv
