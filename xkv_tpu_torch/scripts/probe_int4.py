"""Probe: do the card's tensor cores run int4 x int4 -> int32 products, and
at what rate against int8 and bf16?

    python -m xkv_tpu_torch.scripts.probe_int4 [--reps 256] [--device cuda]

Port of ``scripts/probe_int4.py`` (the JAX package's TPU tool): times K11,
``reps`` back-to-back dependent (M, K) @ (K, M) products per call, M = K =
512, and prints per type ``<name> <us> us/GEMM <rate> TMAC/s`` and its share
of the card's published peak.
"""

from __future__ import annotations

import argparse

import torch

from xkv_tpu_torch.ops.kernels import probe_int4 as k11
from xkv_tpu_torch.scripts.timing import card_line, device_arg, time_ms

M, K = 512, 512
# Published dense peaks of one H100 SXM, in multiply-accumulates per second
# (half the operation rates: 989 TFLOP/s bf16, 1,979 TOP/s int8); the data
# sheet gives no int4 rate.
PEAK_MACS = {"bf16": 989e12 / 2, "int8": 1979e12 / 2, "int4": None}


def inputs(kind: str, device: torch.device, m: int, k: int):
    """The JAX probe's operands, from seeds 0 and 1: integers in [-7, 7)
    for int8 and int4, normal values for bf16."""
    gx = torch.Generator(device=device).manual_seed(0)
    gw = torch.Generator(device=device).manual_seed(1)
    if kind == "bf16":
        x = torch.randn((m, k), generator=gx, device=device).to(torch.bfloat16)
        w = torch.randn((k, k), generator=gw, device=device).to(torch.bfloat16)
    else:
        x = torch.randint(-7, 7, (m, k), generator=gx, device=device, dtype=torch.int8)
        w = torch.randint(-7, 7, (k, k), generator=gw, device=device, dtype=torch.int8)
    return x, w


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_arg(args.device)
    print(card_line(device), flush=True)
    macs = M * M * K
    results = {}
    for name in ("bf16", "int8", "int4"):
        x, w = inputs(name, device, M, K)
        t = time_ms(lambda: k11.gemm_chain(x, w, args.reps, name), device, iters=5,
                    warmup=1) * 1e-3 / args.reps
        peak = PEAK_MACS[name]
        share = f"  ({macs / t / peak:6.1%} of peak)" if peak else "  (no published peak)"
        print(f"{name:5s} {t * 1e6:9.3f} us/GEMM  {macs / t / 1e12:7.1f} TMAC/s{share}",
              flush=True)
        results[name] = t
    return results


if __name__ == "__main__":
    main()
