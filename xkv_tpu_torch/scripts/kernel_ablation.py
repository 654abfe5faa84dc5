"""Ablation study of the low-rank decode kernel (K3): which stage costs what.

    python -m xkv_tpu_torch.scripts.kernel_ablation [--ctx 32768] [--n 64]
        [--configs full,-recon,...] [--device cuda]

Port of ``scripts/kernel_ablation.py`` (the JAX package's TPU tool). Times
K10, the tool's K3-shaped pass built on the machinery K3 ships (a producer
warp's TMA ring, the key rebuild on ``wgmma``, RoPE in registers) with
stages switched off at compile time (numerics wrong on purpose: a timing
tool), for each stage set, at the Llama-3.1-8B geometry over int8 factors,
and prints ``<name> <ms> ms/call`` with what each set saves against
``full``: that stage's cost in K3's design.

Stages: recon (the k_us @ k_vt rebuild), scalemul (the int8 per-column
scale), rope (rotation of the rebuilt keys), scores (q @ K^T), softmax (the
online softmax), vpath (P @ v_us). ``roll-rope``, ``ropeq`` and ``ropeq2d``
swap the rotation for another form (``ropeq2d`` differs from ``ropeq`` only
in the TPU's lane layout, and runs the same kernel here).

``--block-s`` is accepted and ignored: K3 walks fixed 64-key blocks and
picks its split count itself. ``--n`` is the number of timed calls (the
JAX tool's chain length).
"""

from __future__ import annotations

import argparse

import torch

from xkv_tpu_torch.ops.kernels import kernel_ablation as k10
from xkv_tpu_torch.scripts.timing import card_line, device_arg, time_ms

HKV, HQ, HD = 8, 32, 128
RK, RV = 512, 768


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctx", type=int, default=32768)
    ap.add_argument("--block-s", type=int, default=1024)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--configs", default=None,
                    help="comma list: full,-recon,-scores,... (default all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_arg(args.device)
    print(card_line(device), flush=True)
    print(f"# --block-s {args.block_s} ignored: K3 walks 64-key blocks", flush=True)
    configs = k10.configs()
    if args.configs:
        want = args.configs.split(",")
        configs = [c for c in configs if c[0] in want]
    q, k_us, k_vt, v_us, k_scale = k10.inputs(1, args.ctx, HQ, HKV, HD, RK, RV, device)
    results = {}
    base = None
    for name, stages in configs:
        cos_t, sin_t, trig = k10.tables(args.ctx, HD, stages, device)

        def step(stages=stages, cos_t=cos_t, sin_t=sin_t, trig=trig):
            return k10.ablation_step(q, k_us, k_vt, v_us, k_scale, cos_t, sin_t, trig, stages,
                                     num_kv_heads=HKV)

        t = time_ms(step, device, iters=args.n)
        if name == "full":
            base = t
        delta = f"  (saves {base - t:6.3f} ms)" if base and name != "full" else ""
        print(f"{name:12s} {t:8.3f} ms/call{delta}", flush=True)
        results[name] = t
    return results


if __name__ == "__main__":
    main()
