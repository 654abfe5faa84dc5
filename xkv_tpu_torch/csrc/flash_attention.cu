// K1: GQA causal prefill attention (flash attention forward) for sm_90a.
//
// Replaces: xkv_tpu/ops/pallas/flash_attention.py, flash_attention_fwd
// (Pallas body _flash_kernel).
//
// Bound on the H100: operations. Causal prefill at s = 8192, 32 query
// heads, head_dim 128 is ~0.55 TFLOP per layer against ~0.13 GB of q/k/v/o,
// far above the ~295 FLOP/byte ridge, so the tensor cores set the floor,
// and only wgmma reaches their full rate on Hopper.
//
// Design: a persistent kernel, one CTA per SM. A work item is a tile of 128
// query positions of one head of one sequence, so the group size hq / hkv
// only picks which kv head an item reads (the qpk heads of a kv head run
// side by side and share its K/V through L2). Items run longest first, in
// rounds of one item per CTA walked in alternate directions, so every CTA
// gets an even share of the causal triangle. The CTA is warp specialised
// into three warpgroups:
//  * a producer (registers lowered with setmaxnreg) whose one thread loads
//    an item's Q tile and then its 128-key K and V tiles with TMA into a
//    ring of two stages. K and V each have full and empty mbarriers per
//    stage: a K stage frees as soon as its score products are done, so K
//    runs a tile ahead of V and no consumer waits out a load; the next
//    item's Q and first tiles load while the consumers finish this one;
//  * two consumers of 64 query rows each (registers raised), which compute
//    S = Q K^T with wgmma.m64n128k16 from shared memory (both K-major), the
//    fp32 online softmax in registers in the exp2 domain (log2(e) folded
//    into the scale), and O += P V with wgmma, P as the register A operand
//    and V read MN-major (tnspB) from shared memory. The score product of
//    tile t is issued together with the value product of tile t - 1, and
//    the softmax of tile t runs while that value product finishes. At head
//    size 128 the two consumers also take turns on the tensor cores (named
//    barriers), so one's softmax runs under the other's products.
// Every tile is stored as 64-column panels of 128-byte rows with TMA's
// 128-byte swizzle, which the wgmma descriptors name (layout B128). The
// tensor maps are 3-D (hd, s, heads), so rows past s arrive zero-filled
// and no padded copy exists. Tiles wholly above the diagonal or wholly
// outside the sliding window are never loaded; the mask is applied only on
// tiles that cross the diagonal or the window's edge. Masked scores take
// the finite NEG_INF; a row whose running max is still NEG_INF
// exponentiates against 0, so masked probabilities are exactly 0 and a row
// with no live key outputs 0.
#include "common.cuh"
#include "hopper.cuh"

using namespace xkv;

namespace {

constexpr int kBM = 128;     // query positions per CTA
constexpr int kBN = 128;     // keys per tile
constexpr int kStages = 2;   // K/V ring depth
constexpr int kPanel = 64;   // columns per 128-byte swizzled panel
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-aligned base: Q, then the K and V
// rings (each tile a run of HD / 64 panels of rows x 128 bytes), then the
// barriers.
template <int HD>
struct Smem {
  static constexpr int kQ = kBM * HD * 2;
  static constexpr int kTile = kBN * HD * 2;
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  // bar_q, q_empty, full_k[kStages], full_v[kStages], empty_k[kStages],
  // empty_v[kStages]
  static constexpr int kBytes = kBar + 8 * (2 + 4 * kStages);
};

// Load rows [row0, row0 + rows) x HD of one head as HD / 64 panels.
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int rows, int row0, int head) {
#pragma unroll
  for (int p = 0; p < HD / kPanel; ++p)
    tma_box(dst + p * rows * 128, map, bar, p * kPanel, row0, head);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barriers 1 and 2 order the two consumer warpgroups' tensor-core
// work (0 is __syncthreads): warpgroup c waits on barrier 1 + c before it
// issues its products, and releases the other one once they are issued.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// D (64 x 128, fp32) = A (64 x 16) B (16 x 128), A and B in shared memory,
// both K-major; scale_d 0 overwrites D, 1 accumulates.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) += A (64 x 16, registers) B (16 x 128), B in shared
// memory MN-major (tnspB = 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, registers) B (16 x 64), B in shared
// memory MN-major (tnspB = 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}

// Issue S = Q K^T for one warpgroup's 64 rows and one 128-key tile: hd / 16
// steps of 32 bytes, four per 128-byte panel row.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n128(sc, desc_b128(q_rows + (kk / 4) * kBM * 128 + off, 16, 1024),
                  desc_b128(k_tile + (kk / 4) * kBN * 128 + off, 16, 1024), kk > 0);
  }
}

// Issue O += P V for one 128-key tile: 16 keys per step, V MN-major; the
// leading byte offset steps across the 64-column panels of hd.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&pf)[kBN / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_pv<HD>(o, pf[kk], desc_b128(v_tile + kk * 16 * 128, kBN * 128, 1024));
}

// The two query rows a consumer thread holds (pos and pos + 8) and the
// column pair tq of each key octet.
struct Rows {
  int pos, tq, window;
  float scale_log2;
};

// Online softmax of one 128-key score tile in the wgmma accumulator layout
// (element i: row pos + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + 2 tq +
// (i & 1)), in place: the scores become the probabilities. Masked scores
// take the finite NEG_INF; the running max m is kept unscaled, and a row
// whose max is still NEG_INF exponentiates against 0, so every masked
// probability is exactly 0. Returns the rescale factor alpha of each row
// and accumulates this thread's share of the row sums l (reduced across
// the quad at the end).
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Rows& rows, int k0,
                                             bool need_mask) {
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int pos = rows.pos + ((i & 2) ? 8 : 0);
      const int col = k0 + (i >> 2) * 8 + rows.tq * 2 + (i & 1);
      const bool live = col <= pos && (rows.window <= 0 || col > pos - rows.window);
      sc[i] = live ? sc[i] : kNegInf;
    }
  }
  float mx[2] = {m[0], m[1]}, shift[2];
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2_approx((m[r] - mx[r]) * rows.scale_log2);
    m[r] = mx[r];
    shift[r] = mx[r] == kNegInf ? 0.f : mx[r] * rows.scale_log2;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = exp2_approx(fmaf(sc[i], rows.scale_log2, -shift[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
}

// P rounded to bf16 as the register A fragments of the value product: two
// key octets of the score accumulator are exactly one 16-key step.
__device__ __forceinline__ void pack_p(const float (&p)[64], uint32_t (&pf)[kBN / 16][4]) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) pf[i >> 3][(i >> 1) & 3] = pack_bf16(p[i], p[i + 1]);
}

// A work item: a tile of kBM query positions of one head of one sequence.
// Items run longest tile first, and the heads and sequences of one tile are
// adjacent, so the qpk heads of a kv head run side by side and share its
// K/V in L2.
struct Work {
  int q0, h, bi;
};

__device__ __forceinline__ Work work_item(int w, int n_qt, int hq, int b) {
  const int bh = w % (hq * b);
  return Work{(n_qt - 1 - w / (hq * b)) * kBM, bh % hq, bh / hq};
}

// The item a persistent CTA takes in round r: rounds of gridDim.x items,
// walked in alternate directions, so that every CTA's share of the
// (longest first) items comes out even.
__device__ __forceinline__ int round_item(int r) {
  return r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out, int b, int hq, int hkv,
    int s, float scale_log2, int window) {
  using L = Smem<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = base + L::kBar, q_empty = bar_q + 8;
  const uint32_t full_k = q_empty + 8, full_v = full_k + 8 * kStages,
                 empty_k = full_v + 8 * kStages, empty_v = empty_k + 8 * kStages;
  const int n_qt = (s + kBM - 1) / kBM;
  const int n_items = n_qt * hq * b;
  // Key tiles of the query tile at q0: [k_begin, min(s, q0 + kBM)), the
  // window's lower edge floored to a tile; tiles above the diagonal or
  // wholly outside the window are never loaded.
  auto key_tiles = [&](int q0, int& k_begin) {
    k_begin = window > 0 ? max(0, q0 - window + 1) / kBN * kBN : 0;
    return (min(s, q0 + kBM) - k_begin + kBN - 1) / kBN;
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(q_empty, 256);  // every consumer thread releases
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full_k + 8 * i, 1);
      mbar_init(full_v + 8 * i, 1);
      mbar_init(empty_k + 8 * i, 256);
      mbar_init(empty_v + 8 * i, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The CTA is persistent: it walks the items round_item(0), round_item(1),
  // ... below n_items.
  // Stage and phase of the K/V ring follow tc, the tiles loaded or consumed
  // so far over every item, so the producer fills the ring for the next
  // item while the consumers finish this one.
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int tc = 0, it = 0;
      for (int w; (w = round_item(it)) < n_items; ++it) {
        const Work wk = work_item(w, n_qt, hq, b);
        int k_begin;
        const int n_tiles = key_tiles(wk.q0, k_begin);
        const int kv = wk.bi * hkv + wk.h / (hq / hkv);
        if (it > 0) mbar_wait(q_empty, (it - 1) & 1);  // the last item's Q is read
        mbar_expect_tx(bar_q, L::kQ);
        tma_tile<HD>(base, &tm_q, bar_q, kBM, wk.q0, wk.bi * hq + wk.h);
        for (int t = 0; t < n_tiles; ++t, ++tc) {
          // A K stage frees once both consumers' score products on it are
          // done, a V stage once their value products are: K runs a tile
          // ahead of V.
          const int st = tc % kStages, par = (tc / kStages - 1) & 1;
          const int k0 = k_begin + t * kBN;
          if (tc >= kStages) mbar_wait(empty_k + 8 * st, par);
          mbar_expect_tx(full_k + 8 * st, L::kTile);
          tma_tile<HD>(base + L::kK + st * L::kTile, &tm_k, full_k + 8 * st, kBN, k0, kv);
          if (tc >= kStages) mbar_wait(empty_v + 8 * st, par);
          mbar_expect_tx(full_v + 8 * st, L::kTile);
          tma_tile<HD>(base + L::kV + st * L::kTile, &tm_v, full_v + 8 * st, kBN, k0, kv);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns query rows [q0 + 64 c, q0 + 64 c + 64).
    // The score product of tile t runs on the tensor cores while the value
    // product of tile t - 1 is issued behind it, and the softmax of tile t
    // runs while that value product finishes.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const uint32_t q_base = base + c * 64 * 128;  // this warpgroup's rows in panel 0
    // Ping-pong (head size 128): while one warpgroup runs its softmax, the
    // other's products hold the tensor cores; warpgroup 0 goes first. At
    // head size 64 the softmax outweighs the products and it does not pay.
    constexpr bool kPingPong = HD == 128;
    const int my_turn = 1 + c, their_turn = 2 - c;
    if (kPingPong && c == 1) bar_arrive(their_turn);
    int tc = 0, it = 0;
    for (int w; (w = round_item(it)) < n_items; ++it) {
      const Work wk = work_item(w, n_qt, hq, b);
      int k_begin;
      const int n_tiles = key_tiles(wk.q0, k_begin);
      const int qc0 = wk.q0 + 64 * c;  // first row of this warpgroup
      const Rows rows{qc0 + warp * 16 + (lane >> 2), lane & 3, window, scale_log2};
      auto need_mask = [&](int k0) {
        return k0 + kBN - 1 > qc0 || (window > 0 && k0 <= qc0 + 63 - window);
      };

      float o[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
      float sc[64];
      uint32_t pf[kBN / 16][4];

      mbar_wait(bar_q, it & 1);
      const int st0 = tc % kStages;
      mbar_wait(full_k + 8 * st0, (tc / kStages) & 1);
      fence_regs(sc);
      if (kPingPong) bar_sync(my_turn);
      wgmma_fence();
      issue_qk<HD>(sc, q_base, base + L::kK + st0 * L::kTile);
      wgmma_commit();
      if (kPingPong) bar_arrive(their_turn);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(empty_k + 8 * st0);
      if (n_tiles == 1) mbar_arrive(q_empty);
      softmax_tile(sc, m, l, alpha, rows, k_begin, need_mask(k_begin));
      pack_p(sc, pf);
      for (int t = 1; t < n_tiles; ++t) {
        const int cur = tc + t, st = cur % kStages, prev = (cur - 1) % kStages;
        mbar_wait(full_k + 8 * st, (cur / kStages) & 1);
        mbar_wait(full_v + 8 * prev, ((cur - 1) / kStages) & 1);
        // Both waits come before the fence, and every register the two
        // products read is pinned before it: no instruction may define one
        // while they are in flight, or the compiler serialises them.
        fence_regs(sc);
        fence_regs(o);
        fence_regs(pf);
        if (kPingPong) bar_sync(my_turn);
        wgmma_fence();
        issue_qk<HD>(sc, q_base, base + L::kK + st * L::kTile);
        wgmma_commit();
        issue_pv<HD>(o, pf, base + L::kV + prev * L::kTile);
        wgmma_commit();
        if (kPingPong) bar_arrive(their_turn);
        wgmma_wait<1>();
        fence_regs(sc);
        mbar_arrive(empty_k + 8 * st);
        if (t == n_tiles - 1) mbar_arrive(q_empty);  // this item's last read of Q
        const int k0 = k_begin + t * kBN;
        softmax_tile(sc, m, l, alpha, rows, k0, need_mask(k0));
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pf);
        mbar_arrive(empty_v + 8 * prev);
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        pack_p(sc, pf);  // only now: pf fed the value product just finished
      }
      const int lastc = tc + n_tiles - 1, last = lastc % kStages;
      mbar_wait(full_v + 8 * last, (lastc / kStages) & 1);
      fence_regs(o);
      fence_regs(pf);
      if (kPingPong) bar_sync(my_turn);
      wgmma_fence();
      issue_pv<HD>(o, pf, base + L::kV + last * L::kTile);
      wgmma_commit();
      if (kPingPong) bar_arrive(their_turn);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty_v + 8 * last);
      tc += n_tiles;

      // out is (b, s, hq, HD): divide by l, round to bf16, store row pairs.
      const int pa = rows.pos, pb = pa + 8, tq = rows.tq;
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l_r = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
        l_r += __shfl_xor_sync(0xffffffffu, l_r, 2);
        inv[r] = l_r > 0.f ? 1.f / l_r : 0.f;
      }
      bf16* out_a = out + (((size_t)wk.bi * s + pa) * hq + wk.h) * HD;
      bf16* out_b = out + (((size_t)wk.bi * s + pb) * hq + wk.h) * HD;
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        const int col = n8 * 8 + tq * 2;
        if (pa < s)
          *reinterpret_cast<uint32_t*>(out_a + col) =
              pack_bf16(o[n8 * 4] * inv[0], o[n8 * 4 + 1] * inv[0]);
        if (pb < s)
          *reinterpret_cast<uint32_t*>(out_b + col) =
              pack_bf16(o[n8 * 4 + 2] * inv[1], o[n8 * 4 + 3] * inv[1]);
      }
    }
  }
}

// A (hd, s, heads) bf16 tensor map whose box is 64 columns x rows x 1 head,
// 128-byte swizzled; rows past s read as zeros.
bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int hd, int s, int heads,
                int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)s, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)s * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kPanel, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b, int hq, int hkv,
           int s, float scale, int window, cudaStream_t st) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map(enc, &tm_q, q, HD, s, b * hq, kBM) ||
      !tensor_map(enc, &tm_k, k, HD, s, b * hkv, kBN) ||
      !tensor_map(enc, &tm_v, v, HD, s, b * hkv, kBN))
    return (int)cudaErrorInvalidValue;
  const int smem = Smem<HD>::kBytes + 1024;  // room to align the base to 1024
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev, n_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int n_items = (s + kBM - 1) / kBM * hq * b;  // one CTA per SM at most
  flash_fwd_kernel<HD><<<min(n_items, n_sm), kThreads, smem, st>>>(
      tm_q, tm_k, tm_v, (bf16*)out, b, hq, hkv, s, scale * kLog2e, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, hq, s, hd), k/v (b, hkv, s, hd) bf16 contiguous and 16-byte
// aligned; out (b, s, hq, hd). Any hq % hkv == 0; hd 64 or 128. window <= 0
// means no sliding window. Returns cudaGetLastError().
extern "C" int xkv_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       void* out, int b, int hq, int hkv, int s, int hd,
                                       float scale, int window, void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64>(q, k, v, out, b, hq, hkv, s, scale, window, st);
  if (hd == 128) return launch<128>(q, k, v, out, b, hq, hkv, s, scale, window, st);
  return (int)cudaErrorInvalidValue;
}
