"""Microbenchmark: per-call decode-attention time on the card.

    python -m xkv_tpu_torch.scripts.bench_kernel [--ctx 32768] [--batch 1]
        [--n 32] [--impls dense,bf16,int8] [--device cuda]

Port of ``scripts/bench_kernel.py`` (the JAX package's TPU tool). Times one
layer's decode attention, the hot op of the factored cache, against the
dense baseline at the Llama-3.1-8B geometry: ``dense`` is the plain dense
decode attention (``dense_decode_attention_ref``) over bf16 K/V, ``bf16``
and ``int8`` are K3 over bf16 or int8 factors. Prints
``<name> <ms> ms/call``.

``--block-s`` is accepted and ignored: K3 walks fixed 64-key blocks and
picks its split count itself. ``--n`` is the number of timed calls (the JAX
tool's chain length).
"""

from __future__ import annotations

import argparse

import torch

from xkv_tpu_torch.compress.quant import quantize_k_factors, quantize_v_factors
from xkv_tpu_torch.ops.attention import dense_decode_attention_ref
from xkv_tpu_torch.ops.kernels.lowrank_attention import lowrank_decode_attention
from xkv_tpu_torch.ops.rope import rope_cos_sin
from xkv_tpu_torch.scripts.timing import card_line, device_arg, time_ms

HKV, HQ, HD = 8, 32, 128
RK, RV = 512, 768


def main(argv=None) -> dict:
    hkv, hq, hd, rk, rv = HKV, HQ, HD, RK, RV
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctx", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--n", type=int, default=32, help="timed calls")
    ap.add_argument("--impls", default="dense,bf16,int8")
    ap.add_argument("--block-s", default="1024")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_arg(args.device)
    print(card_line(device), flush=True)
    print(f"# --block-s {args.block_s} ignored: K3 walks 64-key blocks", flush=True)

    b, s = args.batch, args.ctx
    gen = torch.Generator(device=device).manual_seed(0)
    scale = hd ** -0.5
    bf = torch.bfloat16
    q0 = torch.randn((b, hq, 1, hd), generator=gen, device=device).to(bf)
    cos_p, sin_p = rope_cos_sin(torch.arange(s, device=device), hd, 500000.0)
    cos_t, sin_t = (x.expand(b, hd) for x in rope_cos_sin(
        torch.tensor([s], device=device), hd, 500000.0))
    impls = args.impls.split(",")
    results = {}

    if "dense" in impls:
        k_dense = torch.randn((b, hkv, s, hd), generator=gen, device=device).to(bf)
        v_dense = torch.randn((b, hkv, s, hd), generator=gen, device=device).to(bf)
        results["dense_plain"] = time_ms(
            lambda: dense_decode_attention_ref(q0, k_dense, v_dense, scale).out, device,
            iters=args.n)
        del k_dense, v_dense

    k_us_f = torch.randn((b, s, rk), generator=gen, device=device)
    k_vt_f = torch.randn((b, rk, hkv * hd), generator=gen, device=device) * 0.03
    v_us_f = torch.randn((b, s, rv), generator=gen, device=device)
    v_vt_f = torch.randn((b, rv, hkv * hd), generator=gen, device=device) * 0.03
    tables = (cos_p, sin_p, cos_t, sin_t)
    if "bf16" in impls:
        f = (k_us_f.to(bf), k_vt_f.to(bf), v_us_f.to(bf), v_vt_f.to(bf))
        results["lowrank_bf16"] = time_ms(
            lambda: lowrank_decode_attention(q0, *f, *tables, scale=scale, num_kv_heads=hkv),
            device, iters=args.n)
    if "int8" in impls:
        kq = quantize_k_factors(k_us_f, k_vt_f)
        vq = quantize_v_factors(v_us_f, v_vt_f)
        results["lowrank_int8"] = time_ms(
            lambda: lowrank_decode_attention(
                q0, kq.us_q, kq.vt_q, vq.us_q, vq.vt, *tables, k_scale_slice=kq.out_scale,
                v_rank_scale=vq.rank_scale, scale=scale, num_kv_heads=hkv),
            device, iters=args.n)

    print(f"# ctx={s} batch={b} geometry: hkv={hkv} hq={hq} hd={hd} rk={rk} rv={rv}")
    for name, t in results.items():
        print(f"{name:24s} {t:8.3f} ms/call", flush=True)
    return results


if __name__ == "__main__":
    main()
