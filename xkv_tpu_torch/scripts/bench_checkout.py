"""Time the decode kernels K2-K8, the score-stage variants K9, the stage
ablation K10 and the probe K11 of one checkout on the card, at the main
path's shapes.

    python xkv_tpu_torch/scripts/bench_checkout.py [--root DIR] [--label NAME]

``--root`` names the checkout whose ``xkv_tpu_torch`` is timed (default:
the one holding this file), so two versions of the kernels can be timed in
turns on one card, each process building its own library:

    python xkv_tpu_torch/scripts/bench_checkout.py --root build/parent --label parent
    python xkv_tpu_torch/scripts/bench_checkout.py --label change

Run it as a file, not with ``-m``: with ``-m`` the package of the working
directory is imported first. (Its earlier form, ``bench_rankspace.py``,
timed K2, K4 and K6 only.) Shapes, b 1, s_p 8192:
  * K2 at the Llama-3.1-8B xKV-4 layer (rank_k 512, rank_v 768), R 32 (one
    token, 32 heads) and 128 (ql 4), over bf16 and int8 factors; K6 over
    the 8B split (256 int8 + 256 int4 K ranks, 256 + 512 V ranks); K4 over
    the top-4 of 512-row chunks;
  * K3 and K5 (top-4) at the 8B layer (32/8 heads, head size 128) and the
    Llama-3.2-1B one (32/8 heads, head size 64, rank_k 256, rank_v 384),
    bf16 and int8, the vt slices layer 1 of a group's wider basis;
  * K7 at DeepSeek-V2-Lite (16 heads, rank 512, RoPE key 64), bf16 and
    int8, at ql 1 and 2; K8 over 256 int8 + 256 int4 ranks; the same at
    rank 2048 (1024 int8 + 1024 int4), ql 1; where the checkout has
    ``mla_split_count``, K7 and K8 at ql 1 also under each split rule of
    ``SPLIT_ALTERNATIVES``;
  * last, K9 in the variants two_gemm, scratch_ab, b512 and b2048 at K3's
    8B shapes above, bf16 and int8, beside K3 (``K9 prod``) on the same
    inputs; a checkout
    whose ``variant_kernel`` takes the full-width embeds gets them
    (``full_query_embeds``), and a variant the checkout refuses records
    null;
  * K4 and K5 (8B, bf16) over 2048 selected rows at chunk widths 16 (128
    chunks) and 512 (4 chunks); a checkout whose kernels refuse width 16
    records null;
  * K10 in each of its ten stage sets at the tool's geometry (32/8 heads,
    head size 128, rank_k 512, rank_v 768, int8, s 8192), beside K3 int8 at
    the same shapes above;
  * K11, 256 chained products, bf16, int8 and int4, at M = K = 512 and at
    M = 2 * 32 * (the card's SMs); beside it the library's 256
    ``torch.matmul`` (bf16) and ``torch._int_mm`` (int8) calls.
The inputs come from one seed, so every checkout sees the same. Times are
``cuda_time_ms``'s cold-L2 mean of 10 calls of the wrapper (its merge
included; K11 5 calls). Prints one JSON line, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys


# K7/K8 split rules timed beside the shipped one at V2-Lite's rank 512 (b
# 1, s_p 8192: 128 blocks of 64 keys), as (key splits, value slices): a
# split per block, two, three and four blocks a split, and 256- and
# 128-rank value slices that fill the SMs with fewer splits.
SPLIT_ALTERNATIVES = ((128, 1), (64, 1), (43, 1), (32, 1), (66, 2), (33, 4))
# K9's variants timed beside K3 (the JAX tool's defaults and b512).
K9_VARIANTS = ("two_gemm", "scratch_ab", "b512", "b2048")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout whose kernels are timed")
    ap.add_argument("--label", default="", help="name of this run in the output")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from xkv_tpu_torch.compress.quant import pack_int4_pairs
    from xkv_tpu_torch.ops.kernels import kernel_ablation as k10
    from xkv_tpu_torch.ops.kernels import kernel_variants as k9
    from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
    from xkv_tpu_torch.ops.kernels import probe_int4 as k11
    from xkv_tpu_torch.ops.kernels import rankspace_attention as k2
    from xkv_tpu_torch.scripts.timing import card_line, cuda_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("bench_checkout: no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s_p, rk, rv = 8192, 512, 768
    bf = torch.bfloat16

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev).to(torch.int8)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    times = {}
    k9_inputs = {}  # K3's 8B operands by dtype, for K9 (timed last)
    # K2, K4, K6.
    fac = dict(k=randn(1, s_p, rk).to(bf), v=randn(1, s_p, rv).to(bf))
    i8 = dict(k=ints((1, s_p, rk), -127, 128), v=ints((1, s_p, rv), -127, 128))
    mixed = (ints((1, s_p, 256), -127, 128), pack_int4_pairs(ints((1, s_p, 256), -7, 8)),
             ints((1, s_p, 256), -127, 128), pack_int4_pairs(ints((1, s_p, 512), -7, 8)))
    ids = torch.tensor([[0, 5, 11, 15]], dtype=torch.int32, device=dev)
    for R in (32, 128):
        q = (randn(1, R, rk) * 0.02).to(bf)
        q8 = (q.float() / 73).to(bf)
        times[f"K2 bf16 R{R}"] = cuda_time_ms(lambda: k2.rankspace_kernel(q, fac["k"], fac["v"]))
        times[f"K2 int8 R{R}"] = cuda_time_ms(lambda: k2.rankspace_kernel(q8, i8["k"], i8["v"]))
        times[f"K6 R{R}"] = cuda_time_ms(lambda: k2.mixed_rankspace_kernel(q8, *mixed))
        if R == 32:
            times["K4 bf16 top-4"] = cuda_time_ms(
                lambda: k2.sparse_rankspace_kernel(q, fac["k"], fac["v"], ids, 512))
            times["K4 int8 top-4"] = cuda_time_ms(
                lambda: k2.sparse_rankspace_kernel(q8, i8["k"], i8["v"], ids, 512))
    # K3, K5: (hq, hkv, hd, rank_k, rank_v) of the 8B and 1B layers.
    for shape, (hq, hkv, hd, rk3, rv3) in {"8B": (32, 8, 128, 512, 768),
                                           "1B": (32, 8, 64, 256, 384)}.items():
        m = hkv * hd
        theta = torch.arange(s_p, device=dev)[:, None] * 1e-3 * torch.arange(
            1, hd // 2 + 1, device=dev)[None]
        cos_h, sin_h = theta.cos().to(bf), theta.sin().to(bf)
        for dtype in ("bf16", "int8"):
            if dtype == "bf16":
                k_us, v_us = randn(1, s_p, rk3).to(bf), randn(1, s_p, rv3).to(bf)
                k_vt, scale, v_scale = (randn(1, rk3, 4 * m) * 0.05).to(bf), 1.0, None
            else:
                k_us, v_us = ints((1, s_p, rk3), -127, 128), ints((1, s_p, rv3), -127, 128)
                k_vt, scale = ints((1, rk3, 4 * m), -127, 128), 2e-4
                v_scale = torch.full((1, 1, rv3), 1e-2, device=dev)
            v_vt = (randn(1, rv3, 4 * m) * 0.05).to(bf)
            vt_k, vt_v = k_vt[:, :, m:2 * m], v_vt[:, :, m:2 * m]
            qab = (randn(1, hq, 2 * hd) * 0.05 * scale).to(bf)
            kw = dict(num_q_heads=hq, num_kv_heads=hkv)
            a = (qab, k_us, vt_k, v_us, vt_v, cos_h, sin_h, v_scale)
            times[f"K3 {shape} {dtype}"] = cuda_time_ms(lambda: k3.lowrank_kernel(*a, None, None,
                                                                                  **kw))
            times[f"K5 {shape} {dtype} top-4"] = cuda_time_ms(
                lambda: k3.sparse_lowrank_kernel(*a, ids, 512, None, None, **kw))
            if shape == "8B":
                k9_inputs[dtype] = (a, kw)
            if shape == "8B" and dtype == "bf16":
                # 2048 selected rows at chunk widths 16 and 512 (K4 too).
                q4 = (randn(1, 32, rk3) * 0.02).to(bf)
                for width in (16, 512):
                    pick = torch.randperm(s_p // width, generator=torch.Generator().manual_seed(0))
                    w_ids = pick[:2048 // width].to(device=dev, dtype=torch.int32)[None]
                    try:
                        times[f"K4 bf16 width {width}"] = cuda_time_ms(
                            lambda: k2.sparse_rankspace_kernel(q4, k_us, v_us, w_ids, width))
                        times[f"K5 8B bf16 width {width}"] = cuda_time_ms(
                            lambda: k3.sparse_lowrank_kernel(*a, w_ids, width, None, None, **kw))
                    except ValueError:  # a checkout whose kernels refuse the width
                        times[f"K4 bf16 width {width}"] = None
                        times[f"K5 8B bf16 width {width}"] = None
    # K7, K8 at DeepSeek-V2-Lite: ql 1 and 2 at rank 512, ql 1 at rank 2048.
    nh, rope = 16, 64
    k_pe, r = randn(1, s_p, rope).to(bf), torch.rand((1, s_p), generator=gen, device=dev) + 0.5
    for rk7 in (512, 2048):
        us = {"bf16": randn(1, s_p, rk7).to(bf), "int8": ints((1, s_p, rk7), -127, 128)}
        us8 = ints((1, s_p, rk7 // 2), -127, 128)
        us4 = pack_int4_pairs(ints((1, s_p, rk7 // 2), -7, 8))
        for ql in ((1, 2) if rk7 == 512 else (1,)):
            tag = ("" if ql == 1 else f" ql{ql}") + ("" if rk7 == 512 else f" rank {rk7}")
            qe = (randn(1, ql * nh, rk7) * 0.02 * (512 / rk7) ** 0.5).to(bf)
            qp = (randn(1, ql * nh, rope) * 0.1).to(bf)
            for dtype, u in us.items():
                times[f"K7 {dtype}{tag}"] = cuda_time_ms(
                    lambda: k2.mla_rankspace_kernel(qe, qp, u, k_pe, r))
            times[f"K8{tag}"] = cuda_time_ms(
                lambda: k2.mla_mixed_rankspace_kernel(qe, qp, us8, us4, k_pe, r))
            if rk7 == 512 and ql == 1 and hasattr(k2, "mla_split_count"):
                # The split rule's alternatives, (key splits, value slices).
                rule = k2.mla_split_count
                for ns, nv in SPLIT_ALTERNATIVES:
                    k2.mla_split_count = lambda *_: (ns, nv)
                    for dtype, u in us.items():
                        times[f"K7 {dtype} split {ns}x{nv}"] = cuda_time_ms(
                            lambda: k2.mla_rankspace_kernel(qe, qp, u, k_pe, r))
                    times[f"K8 split {ns}x{nv}"] = cuda_time_ms(
                        lambda: k2.mla_mixed_rankspace_kernel(qe, qp, us8, us4, k_pe, r))
                k2.mla_split_count = rule
        del us, us8, us4
    # K10 in every stage set (the tool's geometry, int8).
    abl = k10.inputs(1, s_p, 32, 8, 128, 512, 768, dev, seed=0)
    for name, stages in k10.configs():
        a10 = (*abl, *k10.tables(s_p, 128, stages, dev), stages)
        times[f"K10 {name}"] = cuda_time_ms(lambda: k10.ablation_step(*a10, num_kv_heads=8))
    del abl
    # K11 and the library's calls.
    reps, k = 256, 512
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for M in (512, 2 * 32 * n_sm):
        for kind in ("bf16", "int8", "int4"):
            if kind == "bf16":
                x, w = randn(M, k).to(bf), randn(k, k).to(bf)
            else:
                x, w = ints((M, k), -8, 8), ints((k, k), -8, 8)
            times[f"K11 {kind} M{M}"] = cuda_time_ms(lambda: k11.gemm_chain(x, w, reps, kind),
                                                     iters=5, warmup=1)
            if kind == "bf16":
                times[f"library bf16 M{M}"] = cuda_time_ms(
                    lambda: [torch.matmul(x, w) for _ in range(reps)], iters=5, warmup=1)
            elif kind == "int8":
                wc = w.t().contiguous().t()  # column-major, cuBLASLt's int8 layout
                times[f"library int8 M{M}"] = cuda_time_ms(
                    lambda: [torch._int_mm(x, wc) for _ in range(reps)], iters=5, warmup=1)
    # K9 beside K3 on K3's 8B operands, last, so that the kernels above see
    # the same allocations in every checkout.
    full = next(iter(inspect.signature(k9.variant_kernel).parameters)) == "qab_full"
    for dtype, (a, kw) in k9_inputs.items():
        times[f"K9 prod {dtype}"] = cuda_time_ms(lambda: k3.lowrank_kernel(*a, None, None, **kw))
        q9 = k9.full_query_embeds(a[0], kw["num_q_heads"], kw["num_kv_heads"]) if full else a[0]
        for v in K9_VARIANTS:
            try:
                times[f"K9 {v} {dtype}"] = cuda_time_ms(lambda: k9.variant_kernel(
                    q9, *a[1:], None, variant=v, **kw))
            except ValueError:  # a checkout whose K9 refuses the variant
                times[f"K9 {v} {dtype}"] = None
    print(json.dumps({"label": args.label, "root": args.root, "card": card_line(dev),
                      "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
