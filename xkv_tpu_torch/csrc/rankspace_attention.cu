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
// Design of K2, K4 and K6 (flash-decoding over a TMA ring, wgmma):
// - One CTA per (key split, value slice, 32-row tile, sequence). A single
//   row tile (R <= 32, one decode token) splits the value ranks into
//   256-rank slices so that a b = 1 step fills the SMs; several tiles keep
//   every value rank in each CTA up to 1024, so each tile reads the
//   factors once, and take 1024-rank slices past that.
//   The key blocks of 64 covering [win_lo, valid_len) (K2, K6), or the
//   blocks of the selected chunks (K4: each CTA reads the chunk ids itself
//   and masks by absolute column id * chunk + j), are dealt out in
//   contiguous runs to `nsplit` splits, as many as fill the SMs once, so a
//   CTA streams several blocks and the partials stay a small part of the
//   factor bytes. A block past the segment, outside the live range or of
//   an unselected chunk is never read; ragged rows and ranks arrive as
//   TMA's zero fill.
// - A producer warp loads the row tile's q_emb by TMA, then keeps a ring
//   of 64-key x 64-rank panels in flight (as deep as shared memory allows,
//   up to 32): per block the key panels of k_us, then the CTA's value
//   panels of v_us, with a full/empty mbarrier pair per stage. Where
//   q_emb's panels would leave the ring under two stages (rk past ~3000
//   in bf16), they come through a ring of their own instead, each beside
//   its key panel: the same 32 rows for every block, so L2 serves them.
//   bf16 panels
//   land in the 128-byte swizzle and are read in place; int8 panels (and
//   K6's packed int4 bytes) land as 64-byte boxes and the warpgroup that
//   reads them widens them to bf16 with 16-byte vector reads into one of
//   its two swizzled panels (int4: the high nibbles give the evens, the
//   low ones the odds, in the [hi | evens | odds] order of the Pallas
//   _unpack_nibbles; int8 and int4 values are exact in bf16), so no
//   product loop unpacks anything. K6 splits that are not whole 64-byte
//   boxes gather their panels byte by byte instead.
// - Two consumer warpgroups never issue a load. Keys go on wgmma's 64-row
//   M: s^T (64 keys x 32 rows) = k_us . q_emb^T, both K-major, the key
//   panel straight from the ring; each warpgroup sums half the key panels
//   and the halves meet in shared memory for the fp32 online softmax. P,
//   rounded to bf16, goes back to shared memory as the K-major B operand
//   of t^T (64 ranks x 32 rows) += v_us^T . P^T, the value panel read
//   MN-major (tnspA); fp32 accumulators.
// - The k_us panels of a block are read by each value slice's CTA; those
//   CTAs are adjacent in the grid, and loading the key panels in one
//   slice only was no faster, so the other reads are L2 hits.
// - Merge: a second kernel, one CTA per (64-rank chunk, row, sequence), a
//   thread per (rank, quarter of the splits), each thread's partials
//   loaded before the softmax statistics. (A programmatic dependent launch
//   measured no faster, and a last-CTA reduction would read every split's
//   partial from one SM.)
// Masked scores are the finite NEG_INF, masked probabilities are exactly
// 0, and a row with no live key gets t = 0.
//
// K7 and K8 (mla_tma_split_kernel) run on the same machinery: a producer
// warp, a TMA ring of 64-key panels, two consumer warpgroups on wgmma, the
// same merge. They differ from K2's arithmetic in three ways. V is the
// latent's own us rows: with one value slice the block's us panels stay in
// shared memory from the score product to the value product (bf16: their
// ring stages; int8 / int4: widened to bf16 once), so us crosses to shared
// memory once and is read there twice. A second, RoPE-wide score product
// runs against the block's k_pe panels. The block's r (per-row inverse RMS
// of the latent) scales the latent scores row by row in registers, and P
// before the value product: s = (q_emb . us^T) * r + q_pe . k_pe^T,
// t += round_bf16(P * r) @ us, as the Pallas kernels compute it. Value
// slices (past 1024 ranks, or where the caller's split rule asks for them)
// take every us panel for the scores and their own panels again for the
// value product.
#include "decode_common.cuh"
#include "hopper.cuh"

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
  int vslices;  // K7, K8: value slices of the latent's ranks
  int us_w, us_ld;  // K7, K8: k_us's columns and row stride, in elements
};

// ---- K2, K4, K6: one CTA per (key split, value slice, 32-row tile,
// sequence); a producer warp fills a TMA ring of 64-key x 64-rank panels;
// 2 consumer warpgroups compute on wgmma from shared memory.
constexpr int kCW = 8;                  // consumer warps: 2 warpgroups
constexpr int kCT = kCW * 32;           // consumer threads
constexpr int kTP = kCT + 32;           // and the producer warp
constexpr int kGroups = 2;
constexpr int kMaxStages = 32;          // panels in flight, at most
constexpr int kPanelB = kBS * 128;      // a bf16 panel: 64 keys x 64 ranks, swizzled rows
constexpr int kRawB = kBS * 64;         // an int8 box: 64 keys x 64 bytes
constexpr int kQPanelB = kRows * 128;   // a q (or P) panel: 32 rows x 64 ranks (keys)
constexpr int kMaxVPanels = 16;         // value panels of a CTA: 1024-rank slices
constexpr int kSliceVP = 4;             // value panels of a 256-rank slice
constexpr int kQStages = 8;             // q panels in flight when q_emb streams
constexpr int kScLd = kBS + 4;          // fp32 score row stride
constexpr int kMaxSmemB = 232448;

// How a panel is staged. kBf16: the TMA box is the panel (128-byte swizzle).
// kInt8: a 64-byte TMA box of int8 ranks, widened to bf16 by the
// warpgroup that reads it. kMixedTma: K6 with 64-aligned int8/int4 splits,
// each panel an int8 box or the hi (evens) or lo (odds) nibbles of a packed
// int4 box. kMixedGather: other K6 splits, each panel gathered from device
// memory byte by byte by its warpgroup.
enum Mode { kBf16 = 0, kInt8 = 1, kMixedTma = 2, kMixedGather = 3 };
enum Src { kSrcBf16, kSrcInt8, kSrcHi, kSrcLo };

// Shared memory, in bytes from a 1024-aligned base: each warpgroup's two
// widened panels (not for bf16), q_emb's panels, P (one panel), the ring,
// the warpgroups' partial scores, the softmax statistics and the barriers.
// Every wgmma operand starts on a 1024-byte swizzle atom. The ring takes
// what the opt-in limit leaves, up to kMaxStages panels, so large ranks
// still fit (at least 2 stages). Where q_emb's panels leave no room for 2
// stages (rk past ~3000 in bf16, ~2600 in int8), they stream instead
// (qring): a ring of kQStages q panels beside the panel ring, one q panel
// loaded with each key panel, with its own full/empty barriers.
struct RsLayout {
  int stage, stages, cv, q, p, ring, sc, stats, bars, nbars, total;
  __host__ __device__ RsLayout(int rk, int mode, bool qring) {
    const int npk = (rk + 63) / 64;
    stage = mode == kBf16 ? kPanelB : kRawB;
    cv = 0;
    q = cv + (mode == kBf16 ? 0 : kGroups * 2 * kPanelB);
    p = q + (qring ? kQStages : npk) * kQPanelB;
    ring = p + kQPanelB;
    nbars = 2 * kMaxStages + 1 + (qring ? 2 * kQStages : 0);
    const int rest = kGroups * kRows * kScLd * 4 + 3 * kRows * 4 + nbars * 8;
    stages = min(kMaxStages, (kMaxSmemB - 1024 - ring - rest) / stage);
    sc = ring + stages * stage;
    stats = sc + kGroups * kRows * kScLd * 4;
    bars = stats + 3 * kRows * 4;
    total = bars + nbars * 8 + 1024;  // slack: the base is aligned to 1024
  }
};

// Whether q_emb's panels stream through their own ring at this rank: only
// where keeping them resident would leave the panel ring under 2 stages.
__host__ __device__ inline bool q_streams(int rk, int mode) {
  return RsLayout(rk, mode, false).stages < 2;
}

// Where panel p of a factor comes from: the tensor map (0: the int8 or bf16
// stream, 1: the packed int4 stream), the box's first byte and how to
// widen it. r8/h4: the factor's int8 ranks and packed int4 bytes.
template <int kMode>
__device__ __forceinline__ Src panel_src(int p, int r8, int h4, int& map, int& x) {
  map = 0;
  if (kMode == kBf16) {
    x = p * 128;
    return kSrcBf16;
  }
  if (kMode == kInt8 || p < r8 / 64) {
    x = p * 64;
    return kSrcInt8;
  }
  map = 1;
  const int q = p - r8 / 64;
  x = (q < h4 / 64 ? q : q - h4 / 64) * 64;
  return q < h4 / 64 ? kSrcHi : kSrcLo;
}

// Live range and key blocks of one CTA (block_walk, with a null lens or
// los read as s_p or 0).
__device__ __forceinline__ BlockWalk rs_walk(const RankspaceArgs& a, int bi, int split) {
  return make_walk(a.los ? max(a.los[bi], 0) : 0, a.lens ? min(a.lens[bi], a.s_p) : a.s_p,
                   a.ids != nullptr ? a.ids + (size_t)bi * a.n_sel : nullptr, a.n_sel, a.chunk,
                   split, a.nsplit);
}

// Named barriers: 1 for the 8 consumer warps, 2 + c for warpgroup c.
__device__ __forceinline__ void rs_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCT) : "memory");
}
__device__ __forceinline__ void group_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
}
// Order this thread's shared-memory stores before wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (64 x 32, fp32) += A (64 x 16) B (16 x 32), both from shared memory,
// B K-major; A K-major (kTA 0) or MN-major (kTA 1).
template <int kTA>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, 1, 1, 1, %18, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "n"(kTA));
}

// 16 bf16 values into two 16-byte units of a swizzled panel row.
__device__ __forceinline__ void put16(unsigned char* panel, int row, int byte,
                                      const float (&f)[16]) {
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(panel + swz(row, byte)) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(panel + swz(row, byte + 16)) = make_uint4(o[4], o[5], o[6], o[7]);
}

// Widen half `half` (32 bytes) of row `row` of a 64-row x 64-byte box into
// a bf16 panel with 16-byte reads: int8 values, or the high or low nibble
// of each packed int4 byte with the shifts of the Pallas _unpack_nibbles.
// All exact in bf16.
__device__ __forceinline__ void widen_half(unsigned char* panel, const unsigned char* box,
                                           Src src, int row, int half) {
#pragma unroll
  for (int c = 2 * half; c < 2 * half + 2; ++c) {
    const int4 x = *reinterpret_cast<const int4*>(box + row * 64 + c * 16);
    const int8_t* b = reinterpret_cast<const int8_t*>(&x);
    float f[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int v = b[i];
      f[i] = (float)(src == kSrcInt8 ? v : src == kSrcHi ? (v >> 4) : (((v & 0xF) ^ 8) - 8));
    }
    put16(panel, row, c * 32, f);
  }
}

// Half `half` of row `row` of panel p of mixed factors gathered from device
// memory: logical ranks [hi | evens | odds] of the block's rows (zero past
// nkeys or the width).
__device__ __forceinline__ void gather_half(unsigned char* panel, const int8_t* f8,
                                            const int8_t* f4, int r8, int h4, size_t row0,
                                            int nkeys, int p, int row, int half) {
  const size_t r = row0 + row;
#pragma unroll
  for (int cc = 2 * half; cc < 2 * half + 2; ++cc) {
    float f[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = p * 64 + cc * 16 + i;
      int v = 0;
      if (row < nkeys && c < r8) {
        v = f8[r * r8 + c];
      } else if (row < nkeys && c < r8 + 2 * h4) {
        const int j = c - r8;
        const int x = f4[r * h4 + (j < h4 ? j : j - h4)];
        v = j < h4 ? (x >> 4) : (((x & 0xF) ^ 8) - 8);
      }
      f[i] = (float)v;
    }
    put16(panel, row, cc * 32, f);
  }
}

// Warpgroup c reads the key panels c, c + 2, ... of each block and the
// value panels c and c + 2 of the slice, so each ring stage has the 4
// warps of one warpgroup as readers. Scores are taken transposed, keys on
// wgmma's 64-row M: s^T (64 keys x 32 rows) = k_us (K-major, the ring
// panel as it landed) . q_emb^T (K-major q panels); the two warpgroups'
// partial sums meet in shared memory for the softmax. The value product is
// t^T (64 ranks x 32 rows) += v_us^T (the ring panel read MN-major) . P^T
// (K-major, P in one swizzled panel). With kQRing the q_emb panel of each
// key panel arrives through the q ring instead of staying resident.
template <int kMode, int kVPanels, bool kQRing>
__global__ void __launch_bounds__(kTP, 1) rankspace_tma_split_kernel(
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_k4,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_v4,
    const __grid_constant__ CUtensorMap tm_q, const RankspaceArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int rk = a.rk, rv = a.rv, s_p = a.s_p;
  const RsLayout lay(rk, kMode, kQRing);
  unsigned char* ring = smem + lay.ring;
  const int S = lay.stages;
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  float* m_s = reinterpret_cast<float*>(smem + lay.stats);
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kMaxStages);
  const uint32_t q_bar = smem_u32(bars + 2 * kMaxStages);
  // kQRing: the q ring's full and empty barriers.
  const uint32_t qfull0 = smem_u32(bars + 2 * kMaxStages + 1);
  const uint32_t qempty0 = qfull0 + 8 * kQStages;

  const int nvs = (rv + 64 * kVPanels - 1) / (64 * kVPanels);
  const int split = blockIdx.x / nvs, vs = blockIdx.x % nvs;
  const int bi = blockIdx.z, row0 = blockIdx.y * kRows;
  const int rows = min(kRows, a.R - row0);
  const int npk = (rk + 63) / 64;
  const int nvp = min(kVPanels, (rv + 63) / 64 - vs * kVPanels);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const BlockWalk walk = rs_walk(a, bi, split);
  auto next_live = [&](int v) {
    while (v < walk.end && walk.key0(v) < 0) ++v;
    return v;
  };

  if (tid == kCT) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);
    }
    mbar_init(q_bar, 1);
    if constexpr (kQRing) {
      for (int s = 0; s < kQStages; ++s) {
        mbar_init(qfull0 + 8 * s, 1);
        mbar_init(qempty0 + 8 * s, 4);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kCW) {
    // Producer: panel n into stage n % S once its warpgroup has
    // released that stage's previous panel; per block the npk key panels,
    // then this CTA's value panels. First the row tile's q_emb, as npk
    // swizzled panels of 32 rows (zero past the rows and the ranks); with
    // kQRing instead each key panel's q panel just before it.
    if (!kQRing && lane == 0) {
      mbar_expect_tx(q_bar, npk * kQPanelB);
      for (int p = 0; p < npk; ++p)
        tma_box(smem_u32(smem + lay.q + p * kQPanelB), &tm_q, q_bar, p * 128, row0, bi);
    }
    if ((kQRing || kMode != kMixedGather) && lane == 0) {
      int n = 0, nq = 0;
      for (int v = next_live(walk.begin); v < walk.end; v = next_live(v + 1)) {
        const int key0 = walk.key0(v);
        for (int i = 0; i < npk + nvp; ++i, ++n) {
          const bool is_k = i < npk;
          if (kQRing && is_k) {
            // The key panel's q panel, into q stage nq % kQStages (K6's
            // gathered panels too).
            const int sq = nq % kQStages;
            if (nq >= kQStages) mbar_wait(qempty0 + 8 * sq, (nq / kQStages - 1) & 1);
            mbar_expect_tx(qfull0 + 8 * sq, kQPanelB);
            tma_box(smem_u32(smem + lay.q + sq * kQPanelB), &tm_q, qfull0 + 8 * sq, i * 128,
                    row0, bi);
            ++nq;
          }
          if (kMode == kMixedGather) continue;
          const int s = n % S;
          if (n >= S) mbar_wait(empty0 + 8 * s, (n / S - 1) & 1);
          int map, x;
          panel_src<kMode>(is_k ? i : vs * kVPanels + i - npk, is_k ? a.r8k : a.r8v,
                           is_k ? a.h4k : a.h4v, map, x);
          const CUtensorMap* tm = is_k ? (map ? &tm_k4 : &tm_k) : (map ? &tm_v4 : &tm_v);
          mbar_expect_tx(full0 + 8 * s, lay.stage);
          tma_box(smem_u32(ring + s * lay.stage), tm, full0 + 8 * s, x, key0, bi);
        }
      }
    }
    return;
  }

  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  rs_consumers_sync();
  if (!kQRing) mbar_wait(q_bar, 0);

  const int grp = warp >> 2, wg_tid = tid & 127, wq = warp & 3;  // warpgroup, its warp
  const int g = lane >> 2, tq = lane & 3;
  unsigned char* cv = smem + lay.cv + grp * 2 * kPanelB;
  int ncv = 0;
  // Panel n of the CTA's sequence (panel p of the K or V factor) as a bf16
  // wgmma operand in shared memory. A widened stage is released at once, a
  // bf16 one by release() once the warpgroup's products have read it.
  auto acquire = [&](int n, bool is_k, int p, int key0, int nkeys) -> uint32_t {
    if constexpr (kMode == kMixedGather) {
      unsigned char* dst = cv + (ncv++ & 1) * kPanelB;
      const size_t rb = (size_t)bi * s_p + key0;
      if (is_k)
        gather_half(dst, reinterpret_cast<const int8_t*>(a.k_us), a.k_us4, a.r8k, a.h4k, rb,
                    nkeys, p, wg_tid >> 1, wg_tid & 1);
      else
        gather_half(dst, reinterpret_cast<const int8_t*>(a.v_us), a.v_us4, a.r8v, a.h4v, rb,
                    nkeys, p, wg_tid >> 1, wg_tid & 1);
      fence_async_smem();
      group_sync(grp);
      return smem_u32(dst);
    } else {
      const int s = n % S;
      mbar_wait(full0 + 8 * s, (n / S) & 1);
      const unsigned char* st = ring + s * lay.stage;
      if constexpr (kMode == kBf16) return smem_u32(st);
      int map, x;
      const Src src = panel_src<kMode>(p, is_k ? a.r8k : a.r8v, is_k ? a.h4k : a.h4v, map, x);
      unsigned char* dst = cv + (ncv++ & 1) * kPanelB;
      widen_half(dst, st, src, wg_tid >> 1, wg_tid & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      fence_async_smem();
      group_sync(grp);
      return smem_u32(dst);
    }
  };
  auto release = [&](int n) {
    if constexpr (kMode == kBf16) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * (n % S));
    }
  };

  // t^T of the warpgroup's value panels c and c + 2: ranks 16 wq + g (+ 8)
  // x rows 8 i + 2 tq (+ 1) in acc[j][4 i + e].
  constexpr int kVJ = kVPanels / kGroups;
  float acc[kVJ][16];
#pragma unroll
  for (int j = 0; j < kVJ; ++j)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[j][e] = 0.f;

  const uint32_t q_a = smem_u32(smem + lay.q), p_a = smem_u32(smem + lay.p);
  bf16* p_s = reinterpret_cast<bf16*>(smem + lay.p);
  const int nsum = min(kGroups, npk);  // warpgroups holding partial scores
  int n0 = 0;                          // the block's first panel in the CTA's sequence
  int nq0 = 0;                         // kQRing: the block's first q panel
  for (int v = next_live(walk.begin); v < walk.end;
       v = next_live(v + 1), n0 += npk + nvp, nq0 += npk) {
    const int key0 = walk.key0(v), key_hi = walk.key_hi(v);
    const int nkeys = min(kBS, s_p - key0);
    // Partial s^T over the warpgroup's key panels.
    float s[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = 0.f;
    for (int p = grp; p < npk; p += kGroups) {
      uint32_t qp = q_a + p * kQPanelB;
      if constexpr (kQRing) {
        const int nq = nq0 + p, sq = nq % kQStages;
        mbar_wait(qfull0 + 8 * sq, (nq / kQStages) & 1);
        qp = q_a + sq * kQPanelB;
      }
      const uint32_t kp = acquire(n0 + p, true, p, key0, nkeys);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_n32<0>(s, desc_b128(kp + ks * 32, 16, 1024), desc_b128(qp + ks * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      release(n0 + p);
      if constexpr (kQRing) {
        __syncwarp();
        if (lane == 0) mbar_arrive(qempty0 + 8 * ((nq0 + p) % kQStages));
      }
    }
    if (grp < nsum) {
      float* scp = sc + grp * kRows * kScLd;
      const int key = 16 * wq + g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 8 * i + 2 * tq;
        scp[r * kScLd + key] = s[4 * i];
        scp[(r + 1) * kScLd + key] = s[4 * i + 1];
        scp[r * kScLd + key + 8] = s[4 * i + 2];
        scp[(r + 1) * kScLd + key + 8] = s[4 * i + 3];
      }
    }
    rs_consumers_sync();
    // Online softmax over the summed partials: rows warp, warp + 8, ...;
    // lanes over the 64 keys. P goes to its swizzled panel as bf16.
    for (int r = warp; r < kRows; r += kCW) {
      const int c0 = key0 + lane, c1 = c0 + 32;
      const bool live0 = r < rows && c0 >= walk.lo && c0 < key_hi;
      const bool live1 = r < rows && c1 >= walk.lo && c1 < key_hi;
      float s0 = 0.f, s1 = 0.f;
      for (int q = 0; q < nsum; ++q) {
        s0 += sc[(q * kRows + r) * kScLd + lane];
        s1 += sc[(q * kRows + r) * kScLd + lane + 32];
      }
      const float x0 = live0 ? s0 : kNegInf;
      const float x1 = live1 ? s1 : kNegInf;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = live0 ? __expf(x0 - m_new) : 0.f;
      const float p1 = live1 ? __expf(x1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      unsigned char* prow = reinterpret_cast<unsigned char*>(p_s);
      *reinterpret_cast<bf16*>(prow + swz(r, lane * 2)) = __float2bfloat16_rn(p0);
      *reinterpret_cast<bf16*>(prow + swz(r, lane * 2 + 64)) = __float2bfloat16_rn(p1);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + psum;
        a_s[r] = alpha;
      }
    }
    fence_async_smem();
    rs_consumers_sync();
    // t^T += v_us^T . P^T over the warpgroup's value panels.
#pragma unroll
    for (int j = 0; j < kVJ; ++j) {
      const int vp = grp + kGroups * j;
      if (vp < nvp) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a0 = a_s[8 * i + 2 * tq], a1 = a_s[8 * i + 2 * tq + 1];
          acc[j][4 * i] *= a0;
          acc[j][4 * i + 1] *= a1;
          acc[j][4 * i + 2] *= a0;
          acc[j][4 * i + 3] *= a1;
        }
        const uint32_t vpn = acquire(n0 + npk + vp, false, vs * kVPanels + vp, key0, nkeys);
        fence_regs(acc[j]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_n32<1>(acc[j], desc_b128(vpn + ks * 16 * 128, kPanelB, 1024),
                       desc_b128(p_a + ks * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc[j]);
        release(n0 + npk + vp);
      }
    }
  }
  // This CTA's partial (t, m, l); m and l from the first value slice.
  const size_t base = ((size_t)bi * a.nsplit + split) * a.R + row0;
#pragma unroll
  for (int j = 0; j < kVJ; ++j) {
    const int vp = grp + kGroups * j;
    if (vp < nvp) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int r = 8 * (e >> 2) + 2 * tq + (e & 1);
        const int col = (vs * kVPanels + vp) * 64 + 16 * wq + g + 8 * ((e >> 1) & 1);
        if (r < rows && col < rv) a.part_t[(base + r) * rv + col] = acc[j][e];
      }
    }
  }
  if (vs == 0 && tid < rows) {
    a.part_m[base + tid] = m_s[tid];
    a.part_l[base + tid] = l_s[tid];
  }
}

// The merge: one CTA per (64-rank chunk, row, sequence) combines the
// splits' (t, m, l) by log-sum-exp into the normalised t and, from the
// first chunk, lse = M + log(max(L, 1e-30)). A thread per (rank, quarter
// of the splits), the quarters summed in shared memory, so each thread
// waits on a few loads; the splits' weights exp(m - M) and L are taken
// once per CTA, a thread per split.
constexpr int kMergeCols = 64;
__global__ void __launch_bounds__(kCT) rankspace_merge_cols_kernel(
    const float* __restrict__ part_t, const float* __restrict__ part_m,
    const float* __restrict__ part_l, float* __restrict__ t_out,
    float* __restrict__ lse_out, int R, int rv, int nsplit) {
  // nsplit weights (m until M is known), nsplit l, the quarters, 8 floats
  // of reduction scratch.
  extern __shared__ __align__(16) float w_sm[];
  float* l_sm = w_sm + nsplit;
  float* q_sm = l_sm + nsplit;  // [3][kMergeCols]
  float* red = q_sm + kCT - kMergeCols;
  const int c0 = blockIdx.x * kMergeCols, r = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, col = tid % kMergeCols, quarter = tid / kMergeCols;
  constexpr int kQuarters = kCT / kMergeCols;
  const int j = c0 + col;
  const float* pt = part_t + ((size_t)bi * nsplit * R + r) * rv + j;
  const size_t ss = (size_t)R * rv;  // split stride
  // The thread's partials (splits quarter, quarter + 4, ...) are loaded
  // before the statistics arrive, so the merge waits on one round trip.
  constexpr int kPer = 16;
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int s = quarter + kQuarters * k;
    v[k] = s < nsplit && j < rv ? pt[s * ss] : 0.f;
  }
  float mx = kNegInf;
  for (int s = tid; s < nsplit; s += kCT) {
    const size_t idx = ((size_t)bi * nsplit + s) * R + r;
    w_sm[s] = part_m[idx];
    l_sm[s] = part_l[idx];
    mx = fmaxf(mx, w_sm[s]);
  }
  const float M = block_reduce(mx, true, red);
  float ls = 0.f;
  for (int s = tid; s < nsplit; s += kCT) {
    const float w = __expf(w_sm[s] - M);
    w_sm[s] = w;
    ls += w * l_sm[s];
  }
  const float L = block_reduce(ls, false, red);  // also orders the weights' writes
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int s = quarter + kQuarters * k;
    if (s < nsplit) acc += w_sm[s] * v[k];
  }
  if (j < rv)
    for (int s = quarter + kQuarters * kPer; s < nsplit; s += kQuarters)
      acc += w_sm[s] * pt[s * ss];
  if (quarter > 0) q_sm[(quarter - 1) * kMergeCols + col] = acc;
  __syncthreads();
  if (quarter == 0) {
    for (int q = 0; q < kQuarters - 1; ++q) acc += q_sm[q * kMergeCols + col];
    if (j < rv) t_out[((size_t)bi * R + r) * rv + j] = acc * (L > 0.f ? 1.f / L : 0.f);
    if (blockIdx.x == 0 && tid == 0) lse_out[(size_t)bi * R + r] = M + logf(fmaxf(L, 1e-30f));
  }
}

// Launch the merge of the splits of a K2-K8 launch: t_out (b, R, rv),
// lse_out (b, R).
int merge_cols(const RankspaceArgs& a, int b, int rv, void* t_out, void* lse_out,
               cudaStream_t st) {
  const size_t msmem = (2 * a.nsplit + kCT - kMergeCols + 8) * sizeof(float);
  rankspace_merge_cols_kernel<<<dim3((rv + kMergeCols - 1) / kMergeCols, a.R, b), kCT, msmem,
                                st>>>((const float*)a.part_t, (const float*)a.part_m,
                                      (const float*)a.part_l, (float*)t_out, (float*)lse_out,
                                      a.R, rv, a.nsplit);
  return (int)cudaGetLastError();
}

// ---- K7, K8: one CTA per (key split, value slice, 32-row tile,
// sequence), on K2's producer warp, ring and warpgroups. The ring's stages
// are 8 KB: a bf16 panel (64 keys x 64 ranks, or 64 keys x 64 RoPE
// columns of k_pe) or, in the first half, a 64-byte int8 / int4 box.
//
// Shared memory, in bytes from a 1024-aligned base: the held widened us
// panels (kHold, int8 / int4: every us panel of the block, widened once
// and read by both products), each warpgroup's two widened panels (reload,
// int8 / int4), q_emb's panels (or the q ring), q_pe's panels, P, the
// ring, the partial scores, the statistics and the barriers.
struct MlaLayout {
  int held, cv, q, qpe, p, ring, stages, sc, stats, bars, total;
  __host__ __device__ MlaLayout(int npk, int nrp, int mode, bool hold, bool qring) {
    const bool widen = mode != kBf16;
    held = 0;
    cv = held + (hold && widen ? npk * kPanelB : 0);
    q = cv + (!hold && widen ? kGroups * 2 * kPanelB : 0);
    qpe = q + (qring ? kQStages : npk) * kQPanelB;
    p = qpe + nrp * kQPanelB;
    ring = p + kQPanelB;
    const int nbars = 2 * kMaxStages + 1 + (qring ? 2 * kQStages : 0);
    const int rest = kGroups * kRows * kScLd * 4 + 3 * kRows * 4 + nbars * 8;
    stages = min(kMaxStages, (kMaxSmemB - 1024 - ring - rest) / kPanelB);
    sc = ring + max(stages, 0) * kPanelB;
    stats = sc + kGroups * kRows * kScLd * 4;
    bars = stats + 3 * kRows * 4;
    total = bars + nbars * 8 + 1024;  // slack: the base is aligned to 1024
  }
  // Stages the kernel needs: holding, every ring panel of a block at once
  // (a held panel, or a k_pe panel released after all the scores, never
  // stalls a load of its own block); else 2.
  __host__ __device__ static int min_stages(int npk, int nrp, bool hold) {
    return hold ? npk + nrp : 2;
  }
};

// Value panels of a CTA that holds its us panels: 512 ranks.
constexpr int kHoldPanels = 8;

// Per 64-key block the ring carries the block's k_pe panels, its us
// panels, and (reload) the CTA's value panels of us again; gathered int4
// splits (kMixedGather) carry k_pe only. Scores are taken transposed, keys
// on wgmma's 64-row M, as K2's: warpgroup c takes the us panels c, c + 2,
// ... against q_emb's panels into s and the k_pe panels j with (npk + j)
// % 2 == c against q_pe's into sp, then s = s * r + sp, each accumulator
// row scaled by its key's r; the warpgroups' partials meet in shared
// memory for the fp32 online softmax, which writes round_bf16(P * r) as
// the K-major B operand of t^T (64 ranks x 32 rows) += us^T . (P r)^T,
// the us panel read MN-major (tnspA).
// kHold (one value slice of at most 512 ranks, where it fits): the us
// panels of a block stay in shared memory from the score product to the
// value product (bf16: their ring stages are released after it; int8 /
// int4: widened once into the held panels), each read twice by the
// warpgroup that took it; so us crosses to shared memory once, and each
// phase's products are issued together and waited for once. Else (value
// slices, wider ranks) the slice's panels come through the ring again
// after the softmax, from L2. kQRing: q_emb's panels through a ring of
// their own, as K2's.
template <int kMode, bool kHold, bool kQRing>
__global__ void __launch_bounds__(kTP, 1) mla_tma_split_kernel(
    const __grid_constant__ CUtensorMap tm_u, const __grid_constant__ CUtensorMap tm_u4,
    const __grid_constant__ CUtensorMap tm_pe, const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_qpe, const RankspaceArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int rk = a.rk, s_p = a.s_p;
  const int npk = (rk + 63) / 64, nrp = (a.rope + 63) / 64;
  const MlaLayout lay(npk, nrp, kMode, kHold, kQRing);
  unsigned char* ring = smem + lay.ring;
  const int S = lay.stages;
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  float* m_s = reinterpret_cast<float*>(smem + lay.stats);
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kMaxStages);
  const uint32_t q_bar = smem_u32(bars + 2 * kMaxStages);
  const uint32_t qfull0 = smem_u32(bars + 2 * kMaxStages + 1);
  const uint32_t qempty0 = qfull0 + 8 * kQStages;

  const int nvs = a.vslices, vpp = (npk + nvs - 1) / nvs;
  const int split = blockIdx.x / nvs, vs = blockIdx.x % nvs;
  const int v0 = vs * vpp, nvp = min(vpp, npk - v0);  // the slice's first panel, its panels
  const int bi = blockIdx.z, row0 = blockIdx.y * kRows;
  const int rows = min(kRows, a.R - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr bool kRingUs = kMode != kMixedGather;
  const int per_block = nrp + (kRingUs ? npk + (kHold ? 0 : nvp) : 0);  // ring panels
  const BlockWalk walk = rs_walk(a, bi, split);

  if (tid == kCT) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);
    }
    mbar_init(q_bar, 1);
    if constexpr (kQRing) {
      for (int s = 0; s < kQStages; ++s) {
        mbar_init(qfull0 + 8 * s, 1);
        mbar_init(qempty0 + 8 * s, 4);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kCW) {
    // Producer: ring panel n into stage n % S once its reader has released
    // that stage's previous panel. First the row tile's q_pe (and q_emb,
    // unless it streams) as swizzled panels of 32 rows.
    if (lane == 0) {
      mbar_expect_tx(q_bar, ((kQRing ? 0 : npk) + nrp) * kQPanelB);
      if (!kQRing)
        for (int p = 0; p < npk; ++p)
          tma_box(smem_u32(smem + lay.q + p * kQPanelB), &tm_q, q_bar, p * 128, row0, bi);
      for (int j = 0; j < nrp; ++j)
        tma_box(smem_u32(smem + lay.qpe + j * kQPanelB), &tm_qpe, q_bar, j * 128, row0, bi);
      int n = 0, nq = 0;
      auto put = [&](const CUtensorMap* tm, int x, int key0, int bytes) {
        const int s = n % S;
        if (n >= S) mbar_wait(empty0 + 8 * s, (n / S - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, bytes);
        tma_box(smem_u32(ring + s * kPanelB), tm, full0 + 8 * s, x, key0, bi);
        ++n;
      };
      auto put_us = [&](int p, int key0) {
        int map, x;
        panel_src<kMode>(p, a.r8k, a.h4k, map, x);
        put(map ? &tm_u4 : &tm_u, x, key0, kMode == kBf16 ? kPanelB : kRawB);
      };
      for (int v = walk.begin; v < walk.end; ++v) {
        const int key0 = walk.key0(v);
        for (int j = 0; j < nrp; ++j) put(&tm_pe, j * 128, key0, kPanelB);
        for (int p = 0; p < npk; ++p) {
          if constexpr (kQRing) {
            const int sq = nq % kQStages;
            if (nq >= kQStages) mbar_wait(qempty0 + 8 * sq, (nq / kQStages - 1) & 1);
            mbar_expect_tx(qfull0 + 8 * sq, kQPanelB);
            tma_box(smem_u32(smem + lay.q + sq * kQPanelB), &tm_q, qfull0 + 8 * sq, p * 128,
                    row0, bi);
            ++nq;
          }
          if constexpr (kRingUs) put_us(p, key0);
        }
        if constexpr (kRingUs && !kHold)
          for (int i = 0; i < nvp; ++i) put_us(v0 + i, key0);
      }
    }
    return;
  }

  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  rs_consumers_sync();
  mbar_wait(q_bar, 0);

  const int grp = warp >> 2, wg_tid = tid & 127, wq = warp & 3;  // warpgroup, its warp
  const int g = lane >> 2, tq = lane & 3;
  unsigned char* held = smem + lay.held;
  unsigned char* cv = smem + lay.cv + grp * 2 * kPanelB;
  int ncv = 0;
  // us panel p (ring panel n) of the block at key0 as a bf16 wgmma operand
  // in shared memory: bf16, the ring stage, released by release() once
  // read; else widened (or gathered) into dst, the raw stage released at
  // once.
  auto acquire = [&](int n, int p, int key0, unsigned char* dst) -> uint32_t {
    if constexpr (kMode == kMixedGather) {
      gather_half(dst, reinterpret_cast<const int8_t*>(a.k_us), a.k_us4, a.r8k, a.h4k,
                  (size_t)bi * s_p + key0, min(kBS, s_p - key0), p, wg_tid >> 1, wg_tid & 1);
      fence_async_smem();
      group_sync(grp);
      return smem_u32(dst);
    } else {
      const int s = n % S;
      mbar_wait(full0 + 8 * s, (n / S) & 1);
      const unsigned char* st = ring + s * kPanelB;
      if constexpr (kMode == kBf16) return smem_u32(st);
      int map, x;
      const Src src = panel_src<kMode>(p, a.r8k, a.h4k, map, x);
      widen_half(dst, st, src, wg_tid >> 1, wg_tid & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      fence_async_smem();
      group_sync(grp);
      return smem_u32(dst);
    }
  };
  auto release = [&](int n) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (n % S));
  };

  // t^T of the warpgroup's value panels c and c + 2, ...: ranks 16 wq + g
  // (+ 8) x rows 8 i + 2 tq (+ 1) in acc[j][4 i + e].
  constexpr int kVJ = (kHold ? kHoldPanels : kMaxVPanels) / kGroups;
  float acc[kVJ][16];
#pragma unroll
  for (int j = 0; j < kVJ; ++j)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[j][e] = 0.f;

  const uint32_t q_a = smem_u32(smem + lay.q), qpe_a = smem_u32(smem + lay.qpe);
  const uint32_t p_a = smem_u32(smem + lay.p);
  unsigned char* p_s = smem + lay.p;
  // r of the thread's keys in a block: its score rows 16 wq + g (+ 8) and
  // its softmax lanes (lane, lane + 32); the next block's are loaded while
  // this one's products run.
  const float* r_row = a.r + (size_t)bi * s_p;
  auto load_r = [&](int key0, float (&rr)[4]) {
    const int k[4] = {key0 + 16 * wq + g, key0 + 16 * wq + g + 8, key0 + lane, key0 + lane + 32};
#pragma unroll
    for (int i = 0; i < 4; ++i) rr[i] = k[i] < s_p ? __ldg(r_row + k[i]) : 0.f;
  };
  float r_next[4] = {0.f, 0.f, 0.f, 0.f};
  if (walk.begin < walk.end) load_r(walk.key0(walk.begin), r_next);
  int n0 = 0;   // the block's first ring panel
  int nq0 = 0;  // kQRing: the block's first q panel
  for (int v = walk.begin; v < walk.end; ++v, n0 += per_block, nq0 += npk) {
    const int key0 = walk.key0(v);
    float r_cur[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) r_cur[i] = r_next[i];
    if (v + 1 < walk.end) load_r(walk.key0(v + 1), r_next);
    float s[16], sp[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = sp[e] = 0.f;
    // RoPE scores over the warpgroup's k_pe panels (first in the ring),
    // then latent scores over its us panels. kHold: all in flight at once,
    // one wait; else each waited for, and its stage released, in turn.
    fence_regs(s);
    fence_regs(sp);
    for (int j = (npk + grp) & 1; j < nrp; j += kGroups) {
      const int n = n0 + j, st = n % S;
      mbar_wait(full0 + 8 * st, (n / S) & 1);
      const uint32_t kp = smem_u32(ring + st * kPanelB), qp = qpe_a + j * kQPanelB;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_n32<0>(sp, desc_b128(kp + ks * 32, 16, 1024), desc_b128(qp + ks * 32, 16, 1024));
      if constexpr (!kHold) {
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sp);
        release(n);
      }
    }
    for (int p = grp; p < npk; p += kGroups) {
      uint32_t qp = q_a + p * kQPanelB;
      if constexpr (kQRing) {
        const int nq = nq0 + p, sq = nq % kQStages;
        mbar_wait(qfull0 + 8 * sq, (nq / kQStages) & 1);
        qp = q_a + sq * kQPanelB;
      }
      const uint32_t kp = acquire(n0 + nrp + p, p, key0,
                                  kHold ? held + p * kPanelB : cv + (ncv++ & 1) * kPanelB);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_n32<0>(s, desc_b128(kp + ks * 32, 16, 1024), desc_b128(qp + ks * 32, 16, 1024));
      if constexpr (!kHold) {
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        if (kMode == kBf16) release(n0 + nrp + p);
        if constexpr (kQRing) {
          __syncwarp();
          if (lane == 0) mbar_arrive(qempty0 + 8 * ((nq0 + p) % kQStages));
        }
      }
    }
    if constexpr (kHold) {
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(sp);
      for (int j = (npk + grp) & 1; j < nrp; j += kGroups) release(n0 + j);
    }
    // s = s * r + sp, rows (keys) 16 wq + g (+ 8); every warpgroup has a
    // panel (npk, nrp >= 1), so both partials meet in shared memory.
    {
      float* scp = sc + grp * kRows * kScLd;
      const int key = 16 * wq + g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 8 * i + 2 * tq;
        scp[r * kScLd + key] = s[4 * i] * r_cur[0] + sp[4 * i];
        scp[(r + 1) * kScLd + key] = s[4 * i + 1] * r_cur[0] + sp[4 * i + 1];
        scp[r * kScLd + key + 8] = s[4 * i + 2] * r_cur[1] + sp[4 * i + 2];
        scp[(r + 1) * kScLd + key + 8] = s[4 * i + 3] * r_cur[1] + sp[4 * i + 3];
      }
    }
    rs_consumers_sync();
    // Online softmax over the summed partials: rows warp, warp + 8, ...,
    // the warp's rows side by side so their shuffle reductions overlap;
    // lanes over the 64 keys. P * r goes to its swizzled panel as bf16;
    // l sums P.
    {
      constexpr int kRW = kRows / kCW;  // rows of a warp
      const int c0 = key0 + lane, c1 = c0 + 32;
      float x0[kRW], x1[kRW], mx[kRW], ps[kRW];
      bool live0[kRW], live1[kRW];
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        const int r = warp + kCW * i;
        live0[i] = r < rows && c0 >= walk.lo && c0 < walk.hi;
        live1[i] = r < rows && c1 >= walk.lo && c1 < walk.hi;
        x0[i] = live0[i] ? sc[r * kScLd + lane] + sc[(kRows + r) * kScLd + lane] : kNegInf;
        x1[i] = live1[i] ? sc[r * kScLd + lane + 32] + sc[(kRows + r) * kScLd + lane + 32]
                         : kNegInf;
        mx[i] = fmaxf(x0[i], x1[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < kRW; ++i)
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        const int r = warp + kCW * i;
        const float m_new = fmaxf(m_s[r], mx[i]);
        mx[i] = m_new;
        x0[i] = live0[i] ? __expf(x0[i] - m_new) : 0.f;  // masked: exactly 0
        x1[i] = live1[i] ? __expf(x1[i] - m_new) : 0.f;
        ps[i] = x0[i] + x1[i];
        *reinterpret_cast<bf16*>(p_s + swz(r, lane * 2)) = __float2bfloat16_rn(x0[i] * r_cur[2]);
        *reinterpret_cast<bf16*>(p_s + swz(r, lane * 2 + 64)) =
            __float2bfloat16_rn(x1[i] * r_cur[3]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < kRW; ++i) ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], o);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kRW; ++i) {
          const int r = warp + kCW * i;
          const float alpha = __expf(m_s[r] - mx[i]);
          m_s[r] = mx[i];
          l_s[r] = alpha * l_s[r] + ps[i];
          a_s[r] = alpha;
        }
      }
    }
    fence_async_smem();
    rs_consumers_sync();
    // t^T += us^T . (P r)^T over the warpgroup's value panels.
#pragma unroll
    for (int j = 0; j < kVJ; ++j) {
      if (grp + kGroups * j < nvp) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a0 = a_s[8 * i + 2 * tq], a1 = a_s[8 * i + 2 * tq + 1];
          acc[j][4 * i] *= a0;
          acc[j][4 * i + 1] *= a1;
          acc[j][4 * i + 2] *= a0;
          acc[j][4 * i + 3] *= a1;
        }
      }
    }
    // kHold: the panels this warpgroup read for the scores, all in flight
    // at once; else the slice's panels again, each waited for in turn.
    if constexpr (kHold) {
#pragma unroll
      for (int j = 0; j < kVJ; ++j) fence_regs(acc[j]);
      wgmma_fence();
    }
#pragma unroll
    for (int j = 0; j < kVJ; ++j) {
      const int vp = grp + kGroups * j;
      if (vp < nvp) {
        const int n = n0 + nrp + (kHold ? vp : npk + vp);
        uint32_t up;
        if constexpr (kHold) {
          up = smem_u32(kMode == kBf16 ? ring + (n % S) * kPanelB : held + vp * kPanelB);
        } else {
          up = acquire(n, v0 + vp, key0, cv + (ncv++ & 1) * kPanelB);
          fence_regs(acc[j]);
          wgmma_fence();
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_n32<1>(acc[j], desc_b128(up + ks * 16 * 128, kPanelB, 1024),
                       desc_b128(p_a + ks * 32, 16, 1024));
        if constexpr (!kHold) {
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc[j]);
          if (kMode == kBf16) release(n);
        }
      }
    }
    if constexpr (kHold) {
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < kVJ; ++j) fence_regs(acc[j]);
      if (kMode == kBf16)
        for (int vp = grp; vp < nvp; vp += kGroups) release(n0 + nrp + vp);
    }
  }
  // This CTA's partial (t, m, l); m and l from the first value slice.
  const size_t base = ((size_t)bi * a.nsplit + split) * a.R + row0;
#pragma unroll
  for (int j = 0; j < kVJ; ++j) {
    const int vp = grp + kGroups * j;
    if (vp < nvp) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int r = 8 * (e >> 2) + 2 * tq + (e & 1);
        const int col = (v0 + vp) * 64 + 16 * wq + g + 8 * ((e >> 1) & 1);
        if (r < rows && col < rk) a.part_t[(base + r) * rk + col] = acc[j][e];
      }
    }
  }
  if (vs == 0 && tid < rows) {
    a.part_m[base + tid] = m_s[tid];
    a.part_l[base + tid] = l_s[tid];
  }
}

// K2, K4, K6: encode the launch's tensor maps, then the split kernel and
// the merge.
template <int kMode, int kVPanels, bool kQRing>
int run_split(const RankspaceArgs& a, int b, void* t_out, void* lse_out, cudaStream_t st) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const long long sp = a.s_p;
  CUtensorMap tm[5] = {};  // k, k4, v, v4, q_emb
  if constexpr (kMode == kBf16) {
    const long long kb = 2LL * a.rk, vb = 2LL * a.rv;
    if (!byte_map(enc, &tm[0], a.k_us, kb, sp, b, kb, sp * kb) ||
        !byte_map(enc, &tm[2], a.v_us, vb, sp, b, vb, sp * vb))
      return (int)cudaErrorInvalidValue;
  } else if constexpr (kMode != kMixedGather) {
    // Unswizzled 64-byte boxes of int8 (and packed int4) bytes.
    const void* ptr[4] = {a.k_us, a.k_us4, a.v_us, a.v_us4};
    const long long w[4] = {a.r8k, a.h4k, a.r8v, a.h4v};
    for (int i = 0; i < 4; ++i) {
      if (w[i] == 0 || (kMode == kInt8 && (i & 1))) continue;
      if (!byte_map(enc, &tm[i], ptr[i], w[i], sp, b, w[i], sp * w[i], 64, kBS, false))
        return (int)cudaErrorInvalidValue;
    }
  }
  const long long qb = 2LL * a.rk;
  if (!byte_map(enc, &tm[4], a.q_emb, qb, a.R, b, qb, (long long)a.R * qb, 128, kRows, true))
    return (int)cudaErrorInvalidValue;
  const RsLayout lay(a.rk, kMode, kQRing);
  if (lay.stages < 2 || lay.total > kMaxSmemB) return (int)cudaErrorInvalidValue;
  auto kern = rankspace_tma_split_kernel<kMode, kVPanels, kQRing>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (e != cudaSuccess) return (int)e;
  const int nvs = (a.rv + 64 * kVPanels - 1) / (64 * kVPanels);
  const int ntiles = (a.R + kRows - 1) / kRows;
  kern<<<dim3(a.nsplit * nvs, ntiles, b), kTP, lay.total, st>>>(tm[0], tm[1], tm[2], tm[3],
                                                                 tm[4], a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return merge_cols(a, b, a.rv, t_out, lse_out, st);
}

// One 32-row tile: 256-rank value slices, so a b = 1 step fills the SMs.
// Several tiles: every value rank in each CTA up to 1024, so each tile
// reads the factors once (at R 128 the slices would read k_us twelve
// times); past 1024 value ranks, slices of 1024. q_emb streams only where
// its panels do not fit (q_streams).
template <int kMode, bool kQRing>
int run_ring(const RankspaceArgs& a, int b, void* t_out, void* lse_out, cudaStream_t st) {
  return a.R <= kRows ? run_split<kMode, kSliceVP, kQRing>(a, b, t_out, lse_out, st)
                      : run_split<kMode, kMaxVPanels, kQRing>(a, b, t_out, lse_out, st);
}

template <int kMode>
int run_mode(const RankspaceArgs& a, int b, void* t_out, void* lse_out, cudaStream_t st) {
  return q_streams(a.rk, kMode) ? run_ring<kMode, true>(a, b, t_out, lse_out, st)
                                : run_ring<kMode, false>(a, b, t_out, lse_out, st);
}

// The shape rules of K2, K4 and K6, then the launch in the factors' mode.
int run(const RankspaceArgs& a, int b, int mode, void* t_out, void* lse_out, void* stream) {
  if (b < 1 || a.R < 1 || a.s_p < 1 || a.rk < 16 || a.rk % 16 != 0 || a.rv < 16 ||
      a.rv % 16 != 0 || a.nsplit < 1)
    return (int)cudaErrorInvalidValue;
  if (a.ids != nullptr && (a.chunk <= 0 || a.n_sel < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (mode) {
    case kBf16: return run_mode<kBf16>(a, b, t_out, lse_out, st);
    case kInt8: return run_mode<kInt8>(a, b, t_out, lse_out, st);
    case kMixedTma: return run_mode<kMixedTma>(a, b, t_out, lse_out, st);
    case kMixedGather: return run_mode<kMixedGather>(a, b, t_out, lse_out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6's staging: TMA boxes where every int8 and int4 part is a whole number
// of 64-byte boxes (the configs' splits), else gathered.
int mixed_mode(int r8k, int h4k, int r8v, int h4v) {
  return (r8k % 64 | h4k % 64 | r8v % 64 | h4v % 64) == 0 ? kMixedTma : kMixedGather;
}

// K7 / K8: encode the launch's tensor maps, then the split kernel and the
// merge.
template <int kMode, bool kHold, bool kQRing>
int run_mla_split(const RankspaceArgs& a, int b, void* t_out, void* lse_out, cudaStream_t st) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const long long sp = a.s_p;
  CUtensorMap tm[5] = {};  // us (bf16 or int8), us4, k_pe, q_emb, q_pe
  // us: its us_w columns at row stride us_ld (a draft's top ranks read in
  // place); the box columns past us_w, up to rk, are zero-filled.
  if constexpr (kMode == kBf16) {
    const long long ub = 2LL * a.us_w, ld = 2LL * a.us_ld;
    if (!byte_map(enc, &tm[0], a.k_us, ub, sp, b, ld, sp * ld))
      return (int)cudaErrorInvalidValue;
  } else if constexpr (kMode != kMixedGather) {
    // Unswizzled 64-byte boxes of int8 (and packed int4) bytes.
    const void* ptr[2] = {a.k_us, a.k_us4};
    const long long w[2] = {a.us_w, a.h4k}, ld[2] = {a.us_ld, a.h4k};
    for (int i = 0; i < 2; ++i) {
      if (w[i] == 0) continue;
      if (!byte_map(enc, &tm[i], ptr[i], w[i], sp, b, ld[i], sp * ld[i], 64, kBS, false))
        return (int)cudaErrorInvalidValue;
    }
  }
  const long long pb = 2LL * a.rope, qb = 2LL * a.rk;
  if (!byte_map(enc, &tm[2], a.k_pe, pb, sp, b, pb, sp * pb) ||
      !byte_map(enc, &tm[3], a.q_emb, qb, a.R, b, qb, (long long)a.R * qb, 128, kRows, true) ||
      !byte_map(enc, &tm[4], a.q_pe, pb, a.R, b, pb, (long long)a.R * pb, 128, kRows, true))
    return (int)cudaErrorInvalidValue;
  const int npk = (a.rk + 63) / 64, nrp = (a.rope + 63) / 64;
  const MlaLayout lay(npk, nrp, kMode, kHold, kQRing);
  if (lay.stages < MlaLayout::min_stages(npk, nrp, kHold) || lay.total > kMaxSmemB)
    return (int)cudaErrorInvalidValue;
  auto kern = mla_tma_split_kernel<kMode, kHold, kQRing>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = (a.R + kRows - 1) / kRows;
  kern<<<dim3(a.nsplit * a.vslices, ntiles, b), kTP, lay.total, st>>>(tm[0], tm[1], tm[2],
                                                                      tm[3], tm[4], a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return merge_cols(a, b, a.rk, t_out, lse_out, st);
}

// The us panels held from the score product to the value product where
// there is one value slice of at most 512 ranks and they fit; else the
// slice's panels come again, with q_emb resident where the ring keeps 2
// stages beside it.
template <int kMode>
int run_mla_mode(const RankspaceArgs& a, int b, void* t_out, void* lse_out, cudaStream_t st) {
  const int npk = (a.rk + 63) / 64, nrp = (a.rope + 63) / 64;
  if constexpr (kMode != kMixedGather) {
    if (a.vslices == 1 && npk <= kHoldPanels &&
        MlaLayout(npk, nrp, kMode, true, false).stages >= MlaLayout::min_stages(npk, nrp, true))
      return run_mla_split<kMode, true, false>(a, b, t_out, lse_out, st);
  }
  if (MlaLayout(npk, nrp, kMode, false, false).stages >= 2)
    return run_mla_split<kMode, false, false>(a, b, t_out, lse_out, st);
  return run_mla_split<kMode, false, true>(a, b, t_out, lse_out, st);
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
// int8, contiguous; lens/los (b,) int32 live range [los, lens), or null
// for s_p / 0. Scratch
// part_t (b, nsplit, R, rv), part_m/part_l (b, nsplit, R) fp32. Writes
// t_out (b, R, rv) and lse_out (b, R) fp32. Returns cudaGetLastError().
extern "C" int xkv_rankspace_decode(const void* q_emb, const void* k_us, const void* v_us,
                                    const int* lens, const int* los, void* part_t,
                                    void* part_m, void* part_l, void* t_out, void* lse_out,
                                    int b, int R, int s_p, int rk, int rv, int nsplit,
                                    int is_int8, void* stream) {
  const RankspaceArgs a =
      base_args(q_emb, k_us, v_us, lens, los, part_t, part_m, part_l, R, s_p, rk, rv, nsplit);
  return run(a, b, is_int8 ? kInt8 : kBf16, t_out, lse_out, stream);
}

// K4. As K2, over the rows of the selected chunks: ids (b, n_sel) int32,
// chunk id i covering rows [i * chunk, (i + 1) * chunk) (any chunk > 0),
// each walked as ceil(chunk / 64) blocks; an id < 0 selects nothing.
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
  return run(a, b, is_int8 ? kInt8 : kBf16, t_out, lse_out, stream);
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
  return run(a, b, mixed_mode(r8k, h4k, r8v, h4v), t_out, lse_out, stream);
}

// K7 (k_us4 null): q_emb (b, R, r8) bf16; k_us (b, s_p, us_w) bf16 or
// int8 (is_int8), us_w <= r8 < us_w + 16, rows us_ld elements apart (a
// multiple of 16 bytes; a draft reads the top ranks of wider factors in
// place), its missing ranks read as zero. K8 (k_us4 set): q_emb (b, R, r8
// + 2 * h4) in [hi | lo-eo] column order, k_us (b, s_p, r8) int8 (us_w =
// us_ld = r8) and k_us4 (b, s_p, h4) packed int4 pairs. Both: q_pe (b, R,
// rope) and k_pe (b, s_p, rope) bf16, r (b, s_p) fp32, contiguous; lens/los
// (b,) int32 live range [los, lens), or null for s_p / 0;
// scratch as K2's with rv = rk. nsplit key splits, each of `vslices`
// value slices of ceil(npk / vslices) 64-rank panels (at most 16, none
// empty; npk = ceil(rk / 64)). Writes t_out (b, R, rk) in q_emb's rank
// order and lse_out (b, R) fp32. Returns cudaGetLastError().
extern "C" int xkv_mla_rankspace_decode(const void* q_emb, const void* q_pe, const void* k_us,
                                        const void* k_us4, const void* k_pe, const void* r,
                                        const int* lens, const int* los, void* part_t,
                                        void* part_m, void* part_l, void* t_out,
                                        void* lse_out, int b, int R, int s_p, int r8, int h4,
                                        int us_w, int us_ld, int rope, int nsplit,
                                        int vslices, int is_int8, void* stream) {
  RankspaceArgs a = base_args(q_emb, k_us, nullptr, lens, los, part_t, part_m, part_l, R, s_p,
                              r8 + 2 * h4, 0, nsplit);
  a.q_pe = (const bf16*)q_pe;
  a.k_pe = (const bf16*)k_pe;
  a.r = (const float*)r;
  a.rope = rope;
  a.r8k = r8;
  a.h4k = h4;
  a.k_us4 = (const int8_t*)k_us4;
  a.vslices = vslices;
  a.us_w = us_w;
  a.us_ld = us_ld;
  const int npk = (a.rk + 63) / 64, vpp = vslices > 0 ? (npk + vslices - 1) / vslices : 0;
  if (b < 1 || R < 1 || s_p < 1 || a.rk < 16 || a.rk % 16 != 0 || rope < 16 || rope % 16 != 0 ||
      nsplit < 1 || vslices < 1 || vpp > kMaxVPanels || (vslices - 1) * vpp >= npk ||
      (k_us4 != nullptr && !is_int8) || us_w < 1 || us_w > r8 || us_w + 16 <= r8 ||
      us_ld < us_w || (k_us4 != nullptr && (us_w != r8 || us_ld != r8)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (k_us4 != nullptr)
    return mixed_mode(r8, h4, 0, 0) == kMixedTma
               ? run_mla_mode<kMixedTma>(a, b, t_out, lse_out, st)
               : run_mla_mode<kMixedGather>(a, b, t_out, lse_out, st);
  return is_int8 ? run_mla_mode<kInt8>(a, b, t_out, lse_out, st)
                 : run_mla_mode<kBf16>(a, b, t_out, lse_out, st);
}
