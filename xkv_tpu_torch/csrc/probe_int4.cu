// K11: tensor-core rate probe, for sm_90a.
//
// Replaces scripts/probe_int4.py `build` (Pallas body `_kernel`): `reps`
// dependent products y_i = x_i @ w, with x_{i+1} = y_i & 7 for the integer
// types (int32 accumulator) and bf16(y_i * 1e-3) for bf16 (fp32
// accumulator); the output is sum_i y_i as fp32. x is (M, K) and w (K, K):
// at M = K (the probe's 512) this is the TPU kernel's function; a larger M
// only adds independent rows, so a caller can fill every SM.
//
// Bound on the H100: operations, 2 * M * K * K * reps, over 989 TFLOP/s
// (bf16) or 1,979 TOP/s (int8); the data sheet gives no int4 rate.
//
// Design (w resident, x exchanged in a cluster):
// - The rows of x are independent, but w does not fit in one CTA's shared
//   memory (K = 512: 512 KB as bf16). So the output columns are split
//   instead: a cluster of CS CTAs owns a tile of 64 rows of x, and CTA c
//   of the cluster owns the columns [c N, (c + 1) N), N = K / CS. It loads
//   its slice of w^T (N rows of K; 64 KB in bf16 at K = 512, CS = 8) once
//   and keeps it in shared memory for every product.
// - Every CTA holds the tile's whole x_i (64 x K) in one of two buffers.
//   After product i it writes its columns of x_{i+1} into its own other
//   buffer and copies them in 16-byte units into every peer's other buffer
//   with st.async, each store counting its bytes on the peer's mbarrier of
//   that buffer; product i + 1 starts once this CTA's barrier has counted
//   every peer's columns. No cluster barrier per product: a peer can write
//   x_{i+1} only after its product i, which needed this CTA's columns of
//   x_i, sent after this CTA's product i - 1 had read the buffer. y_i and
//   the running sum stay in registers. (A cluster barrier per product, with
//   st.shared::cluster stores, was slower; one bulk copy per peer of a
//   contiguous slice was no faster than st.async: the SM-to-SM transfer,
//   56 KB per CTA and product in bf16 at K = 512, sets the pace, not the
//   products.)
// - bf16 and int8: one warpgroup issues wgmma m64nNk16 (bf16) or m64nNk32
//   (s8) with x and the w slice both K-major in the 128-byte swizzle, one
//   instruction per 32 bytes of depth. int4: Hopper has no s4 wgmma, and
//   the probe measures the s4 product: four warps issue mma.sync m16n8k64
//   s4 from padded rows, in the same resident-w, exchanged-x structure.
// - The slices and the first x arrive by cp.async (zero past M: a ragged
//   last tile's extra rows stay 0 and are not written out).
// - 8 CTAs a cluster (int4 at K = 128: 4, so that a CTA's columns of a row
//   stay a whole 16-byte unit): at M = 512 that is 64 CTAs. 16 CTAs, all
//   128 SMs busy, were slower in bf16 and int8: each CTA receives as many
//   bytes a product and does half the products.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

using namespace xkv;

namespace {

constexpr int kTileRows = 64;   // rows of x per cluster: wgmma's M
constexpr int kThreadsP = 128;  // one warpgroup
constexpr int kMaxSmemP = 232448;

__device__ __forceinline__ void mma_s4_16864(int c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D (64 x N) += A (64 x 16, K-major) B (16 x N, K-major), bf16 -> fp32;
// and the s8 -> s32 form over 32 of depth.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db);
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, 1, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, 1, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, 1;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, 1;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The shared::cluster address of CTA `rank`'s copy of a local shared address.
__device__ __forceinline__ uint32_t peer(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}
// 16 bytes into a peer's shared memory, counted on the peer's mbarrier.
__device__ __forceinline__ void st_async16(uint32_t remote, uint4 v, uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(remote), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Shapes and shared memory of one (kind, K, cluster size). KIND 0: bf16,
// 1: int8, 2: int4 (two values per byte, lower k in the low nibble).
template <int KIND, int K, int CS>
struct Probe {
  static constexpr int N = K / CS;  // output columns of a CTA
  static constexpr int KB = KIND == 0 ? 2 * K : (KIND == 1 ? K : K / 2);  // bytes of a row
  static constexpr int kSliceB = KB / CS;  // bytes of a CTA's columns in a row
  static constexpr bool kWgmma = KIND != 2;
  // bf16, int8: rows in panels of 128 bytes of depth, 128-byte swizzle;
  // int4: padded rows.
  static constexpr int kLd = KB + 16;
  static constexpr int kXBuf = kWgmma ? kTileRows * KB : kTileRows * kLd;
  static constexpr int kW = kWgmma ? N * KB : N * kLd;
  static constexpr int kSmem = 1024 + kW + 2 * kXBuf;  // slack: the base is aligned to 1024
  static_assert(kSliceB % 16 == 0 && N % 8 == 0, "a CTA's columns are whole 16-byte units");
  static_assert(kSmem <= kMaxSmemP, "w slice and x buffers exceed shared memory");

  // Byte offset of 16-byte unit u of row `row` of an operand of `rows` rows.
  __device__ static int unit(int rows, int row, int u) {
    if constexpr (kWgmma) return (u >> 3) * rows * 128 + row * 128 + (((u & 7) ^ (row & 7)) << 4);
    return row * kLd + u * 16;
  }
  __device__ static int byte(int rows, int row, int b) { return unit(rows, row, b >> 4) + (b & 15); }
};

template <int KIND, int K, int CS>
__global__ void __launch_bounds__(kThreadsP, 1)
    probe_cluster_kernel(const unsigned char* __restrict__ x, const unsigned char* __restrict__ wt,
                         float* __restrict__ out, int M, int reps) {
  using P = Probe<KIND, K, CS>;
  using Acc = typename std::conditional<KIND == 0, float, int>::type;
  constexpr int N = P::N, KB = P::KB, NT = N / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ws = smem;         // the w^T slice: N rows of K
  unsigned char* xs = smem + P::kW;  // [2][64 rows of K]
  // full[b]: the peers' columns of the next x bound for buffer b.
  __shared__ __align__(8) uint64_t full[2];
  constexpr uint32_t kPeerBytes = (CS - 1) * kTileRows * P::kSliceB;
  const int c = (int)cluster_rank();
  const int row0 = (int)(blockIdx.x / CS) * kTileRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;

  for (int i = tid; i < N * (KB / 16); i += kThreadsP) {
    const int n = i / (KB / 16), u = i % (KB / 16);
    cp_async16(ws + P::unit(N, n, u), wt + (size_t)(c * N + n) * KB + u * 16, true);
  }
  for (int i = tid; i < kTileRows * (KB / 16); i += kThreadsP) {
    const int r = i / (KB / 16), u = i % (KB / 16);
    const bool ok = row0 + r < M;
    cp_async16(xs + P::unit(kTileRows, r, u), ok ? x + (size_t)(row0 + r) * KB + u * 16 : x, ok);
  }
  if (tid == 0) {
    // Buffer 1 receives x_1, x_3, ...; buffer 0 (x_0 loaded here) x_2, ...
    for (int b = 0; b < 2; ++b) mbar_init(smem_u32(&full[b]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int b = 0; b < 2; ++b) mbar_expect_tx(smem_u32(&full[b]), kPeerBytes);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
  if constexpr (P::kWgmma) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  // Every CTA of the cluster runs, its barriers set, before any writes
  // into a peer.
  cluster_sync();

  Acc acc[NT * 4], total[NT * 4];
#pragma unroll
  for (int i = 0; i < NT * 4; ++i) total[i] = 0;
  const uint32_t w_a = smem_u32(ws);
  int cur = 0;
  for (int rep = 0; rep < reps; ++rep) {
    if (rep > 0) {
      // x_rep is whole in this CTA's buffer (use (rep - 1) / 2 of it);
      // the barrier is set again for x_{rep + 2}.
      mbar_wait(smem_u32(&full[cur]), ((rep - 1) >> 1) & 1);
      if (tid == 0 && rep + 2 < reps) mbar_expect_tx(smem_u32(&full[cur]), kPeerBytes);
      if constexpr (P::kWgmma) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    unsigned char* xc = xs + cur * P::kXBuf;
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) acc[i] = 0;
    if constexpr (P::kWgmma) {
      const uint32_t x_a = smem_u32(xc);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KB / 32; ++ks) {
        const uint64_t da = desc_b128(x_a + (ks >> 2) * (kTileRows * 128) + (ks & 3) * 32, 16, 1024);
        const uint64_t db = desc_b128(w_a + (ks >> 2) * (N * 128) + (ks & 3) * 32, 16, 1024);
        if constexpr (KIND == 0)
          wgmma_bf16<N>(acc, da, db);
        else
          wgmma_s8<N>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    } else {
      // Warp w's 16 rows x N columns, 64 int4 values of depth a step.
      const unsigned char* arow = xc + (warp * 16 + g) * P::kLd;
#pragma unroll 2
      for (int kb0 = 0; kb0 < KB; kb0 += 32) {
        const int kb = kb0 + tq * 4;
        const uint32_t a[4] = {ld32(arow + kb), ld32(arow + 8 * P::kLd + kb), ld32(arow + kb + 16),
                               ld32(arow + 8 * P::kLd + kb + 16)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned char* brow = ws + (nt * 8 + g) * P::kLd + kb;
          mma_s4_16864(&acc[4 * nt], a, ld32(brow), ld32(brow + 16));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) total[i] += acc[i];
    if (rep + 1 == reps) break;
    // x_{rep+1}'s columns [c N, (c + 1) N) into this CTA's other buffer
    // (acc[4 nt + 2 h + e]: row 16 warp + g + 8 h, column 8 nt + 2 tq + e) ...
    unsigned char* xn = xs + (cur ^ 1) * P::kXBuf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h, col = c * N + nt * 8 + 2 * tq;
        const Acc y0 = acc[4 * nt + 2 * h], y1 = acc[4 * nt + 2 * h + 1];
        if constexpr (KIND == 0) {
          *reinterpret_cast<uint32_t*>(xn + P::byte(kTileRows, r, col * 2)) =
              pack_bf16(__fmul_rn(y0, 1e-3f), __fmul_rn(y1, 1e-3f));
        } else if constexpr (KIND == 1) {
          *reinterpret_cast<uint16_t*>(xn + P::byte(kTileRows, r, col)) =
              (uint16_t)((y0 & 7) | ((y1 & 7) << 8));
        } else {
          xn[P::byte(kTileRows, r, col / 2)] = (unsigned char)((y0 & 7) | ((y1 & 7) << 4));
        }
      }
    }
    __syncthreads();
    // ... and into every peer's, 16 bytes at a time, each CTA starting at
    // its next peer.
    constexpr int U = P::kSliceB / 16;
    const uint32_t bar = smem_u32(&full[cur ^ 1]);
    for (int i = tid; i < kTileRows * U; i += kThreadsP) {
      const int off = P::unit(kTileRows, i / U, c * U + i % U);
      const uint4 v = *reinterpret_cast<const uint4*>(xn + off);
      const uint32_t la = smem_u32(xn + off);
#pragma unroll
      for (int p = 1; p < CS; ++p) {
        const uint32_t r = (uint32_t)((c + p) % CS);
        st_async16(peer(la, r), v, peer(bar, r));
      }
    }
    cur ^= 1;
  }
  // No CTA leaves while its stores into a peer may be in flight.
  cluster_sync();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + warp * 16 + g + (e >> 1) * 8;
      const int col = c * N + nt * 8 + tq * 2 + (e & 1);
      if (r < M) out[(size_t)r * K + col] = (float)total[4 * nt + e];
    }
  }
}

template <int KIND, int K, int CS>
int launch(const void* x, const void* wt, void* out, int M, int reps, cudaStream_t st) {
  using P = Probe<KIND, K, CS>;
  auto kern = probe_cluster_kernel<KIND, K, CS>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + kTileRows - 1) / kTileRows * CS);
  cfg.blockDim = dim3(kThreadsP);
  cfg.dynamicSmemBytes = P::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, (const unsigned char*)x, (const unsigned char*)wt,
                         (float*)out, M, reps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int KIND>
int dispatch_k(int K, const void* x, const void* wt, void* out, int M, int reps,
               cudaStream_t st) {
  switch (K) {
    case 128:
      if constexpr (KIND == 2) return launch<KIND, 128, 4>(x, wt, out, M, reps, st);
      else return launch<KIND, 128, 8>(x, wt, out, M, reps, st);
    case 256: return launch<KIND, 256, 8>(x, wt, out, M, reps, st);
    case 512: return launch<KIND, 512, 8>(x, wt, out, M, reps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) and wt = w^T (K, K), row-major: bf16 (kind 0), int8 (kind 1), or
// int4 packed two to a byte along K (kind 2). K is 128, 256 or 512. Writes
// out (M, K) fp32 = sum over `reps` chained products.
extern "C" int xkv_probe_gemm_chain(const void* x, const void* wt, void* out, int M, int K,
                                    int reps, int kind, void* stream) {
  if (M < 1 || reps < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return dispatch_k<0>(K, x, wt, out, M, reps, st);
    case 1: return dispatch_k<1>(K, x, wt, out, M, reps, st);
    case 2: return dispatch_k<2>(K, x, wt, out, M, reps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
