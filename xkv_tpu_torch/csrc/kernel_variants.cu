// K9: design variants of K3's score stage, for sm_90a.
//
// Replaces scripts/kernel_variants.py `variant_attention` (Pallas body
// `_variant_kernel`): K3's function (lowrank_decode_attention with lengths
// and no window: keys rebuilt from pre-RoPE factors per block, relative-
// angle RoPE, online softmax, values in rank space, t @ v_vt per head at the
// end) computed by other designs of the score stage
//   s = qa . (K*cos)^T + qb . (K*sin)^T,
// as candidates for K3's second pass. Every variant runs K3's resident
// split kernel (lowrank_tma.cuh) with another score stage; the rest is K3's
// code: one CTA per (kv head, 16-row tile, key split), a producer warp
// keeping a 4-stage TMA ring of k_us, [cos | sin] and v_us chunks full, the
// head's k_vt slice resident in the 128-byte swizzle, the rebuild on wgmma
// m64n64 (one product per warpgroup and column half), the fp32 online
// softmax, t += P @ v_us, and K3's merge. Only the compact embeds of each
// row's own head are read ([qa | qb], (b, R, 2 hd)), stored once per CTA as
// four K-major wgmma B panels (16 rows x 64 columns).
//   two_gemm    each warpgroup forms K*cos and K*sin of its column half in
//               registers and feeds them, rounded to bf16, as the register
//               A operand (keys on M) of two wgmma m64n16k16 chains,
//               S^T += (K*cos) qa^T and S^T += (K*sin) qb^T; the two halves
//               meet in shared memory, as in K3.
//   scratch_ab  both warpgroups store K*cos | K*sin (bf16) into one
//               swizzled panel of 64 keys x 2 hd (32 KB), then warpgroup 0
//               issues one wgmma chain of depth 2 hd, both operands read
//               from shared memory, while warpgroup 1 waits at the barrier
//               before the softmax. The panel takes one ring stage's room:
//               its ring has 3 stages.
//   b<N>        scratch_ab with N keys a split (the TPU tool's block_s):
//               split i walks the blocks [i N / 64, (i + 1) N / 64).
// The numerics of the stage are K3's in every variant: keys rounded to
// bf16 from the fp32 (int32) rebuild, the trig products in bf16, fp32
// accumulation.
//
// Bound on the H100: K3's, operations (the rebuild 2 * s_p * rk * hkv * hd
// plus the score and value products of the live rows).
#include "lowrank_tma.cuh"

// One unnamed namespace a source, the header's (inside xkv): nvcc's stubs
// name every unnamed namespace of a source alike.
namespace xkv {
namespace {

constexpr int kHD = 128;  // the head size of K3's wgmma instance

template <typename T, int kScore>
int run_variant(cudaStream_t st, const void* qab, const void* k_us, const void* k_vt,
                long long sb_kvt, long long ld_kvt, const void* v_us, const void* v_vt,
                long long sb_vvt, long long ld_vvt, const void* cos_h, const void* sin_h,
                const void* v_scale, const int* lens, const int* los, void* part_t,
                void* part_m, void* part_l, void* part_o, int* done, void* out, void* lse,
                int b, int R, int hq, int hkv, int s_p, int rk, int rv, int nsplit, int run) {
  const int ntiles = ((R / hq) * (hq / hkv) + kHR - 1) / kHR;
  const int err = launch_tma<T, kHD, false, kScore>(
      st, qab, k_us, k_vt, v_us, cos_h, sin_h, lens, los, nullptr, 0, 0, part_t, part_m, part_l,
      done, b, R, hq, hkv, s_p, rk, rv, sb_kvt, ld_kvt, nsplit, ntiles, rv, run);
  if (err != 0) return err;
  return launch_merge<kHD>(st, part_t, part_m, part_l, v_vt, sb_vvt, ld_vvt, v_scale, part_o,
                           done, out, lse, b, R, hq, hkv, rv, nsplit, ntiles);
}

}  // namespace
}  // namespace xkv

using namespace xkv;

// K9. The operands, scratch and outputs of xkv_lowrank_decode (K3) with
// head size 128, a k_vt slice that stays resident, rv <= 1024 and no
// window; variant 1 (two_gemm) or 2 (scratch_ab); run: blocks a split
// (b<N>: N / 64), or 0 for K3's even deal of the blocks over nsplit.
extern "C" int xkv_variant_decode(
    const void* qab, const void* k_us, const void* k_vt, long long sb_kvt, long long ld_kvt,
    const void* v_us, const void* v_vt, long long sb_vvt, long long ld_vvt, const void* cos_h,
    const void* sin_h, const void* v_scale, const int* lens, const int* los, void* part_t,
    void* part_m, void* part_l, void* part_o, int* done, void* out, void* lse, int b, int R,
    int hq, int hkv, int hd, int s_p, int rk, int rv, int nsplit, int run, int is_int8,
    int variant, void* stream) {
  if (hd != kHD || rk < 64 || rk % 64 != 0 || rv < 16 || rv % 16 != 0 || rv > 128 * kMaxVC2 ||
      nsplit < 1 || run < 0 || hkv < 1 || hq % hkv != 0 || R % hq != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define XKV_VARIANT_ARGS                                                                       \
  st, qab, k_us, k_vt, sb_kvt, ld_kvt, v_us, v_vt, sb_vvt, ld_vvt, cos_h, sin_h, v_scale, lens, \
      los, part_t, part_m, part_l, part_o, done, out, lse, b, R, hq, hkv, s_p, rk, rv, nsplit,  \
      run
  if (variant == 1)
    return is_int8 ? run_variant<int8_t, kScoreTwoGemm>(XKV_VARIANT_ARGS)
                   : run_variant<bf16, kScoreTwoGemm>(XKV_VARIANT_ARGS);
  if (variant == 2)
    return is_int8 ? run_variant<int8_t, kScoreScratchAB>(XKV_VARIANT_ARGS)
                   : run_variant<bf16, kScoreScratchAB>(XKV_VARIANT_ARGS);
#undef XKV_VARIANT_ARGS
  return (int)cudaErrorInvalidValue;
}
