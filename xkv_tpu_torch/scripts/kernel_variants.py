"""Timing experiments for candidate rewrites of the low-rank decode kernel
(K3).

    python -m xkv_tpu_torch.scripts.kernel_variants [--ctx 65536] [--batch 8]
        [--n 16] [--variants prod,scratch_ab,two_gemm,b2048] [--check]
        [--device cuda]

Port of ``scripts/kernel_variants.py`` (the JAX package's TPU tool). Each
variant is a full, numerically right kernel (K9) computing K3's function;
``--check`` holds each against K3 first. Prints ``<name> <ms> ms/call``.

Variants (K3's resident kernel with another score stage, K9):
  prod        K3, the production kernel (baseline)
  scratch_ab  [K*cos | K*sin] staged in one shared buffer, one score
              product of depth 2 hd
  two_gemm    two score products of depth hd (qa against K*cos, qb against
              K*sin) from registers, accumulated
  b<N>        scratch_ab with N keys a split (N a positive multiple of 64),
              as the TPU tool's block_s; b2048 and b512 as there
``--n`` is the number of timed calls (the JAX tool's chain length).
"""

from __future__ import annotations

import argparse

import torch

from xkv_tpu_torch.compress.quant import quantize_k_factors, quantize_v_factors
from xkv_tpu_torch.ops.kernels import kernel_variants as k9
from xkv_tpu_torch.ops.kernels.lowrank_attention import lowrank_decode_attention
from xkv_tpu_torch.ops.rope import rope_cos_sin
from xkv_tpu_torch.scripts.timing import card_line, device_arg, time_ms

HKV, HQ, HD = 8, 32, 128
RK, RV = 512, 768
# Parity with K3: both round P to bf16 against another maximum and round
# their bf16 output once: two units in bf16's last place of a row's
# largest value. lse: fp32 on both sides.
TOL_OUT, TOL_LSE = 2.0 ** -6, 1e-5


def row_rel_err(out, ref) -> float:
    """Largest over rows (the last axis) of max |out - ref| / max |ref|."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return (diff / scale).max().item()


def lse_err(lse, ref) -> float:
    """Largest |lse - ref| / max(1, |ref|)."""
    return ((lse - ref).abs() / ref.abs().clamp_min(1.0)).max().item()


def inputs(b: int, s: int, device: torch.device):
    """The JAX tool's operands, from a torch generator: bf16 queries, int8
    factors of normal fp32 factors (k_vt, v_vt scaled 0.03), tables at
    theta 500000, query position s."""
    gen = torch.Generator(device=device).manual_seed(0)
    q0 = torch.randn((b, HQ, 1, HD), generator=gen, device=device).to(torch.bfloat16)
    cos_p, sin_p = rope_cos_sin(torch.arange(s, device=device), HD, 500000.0)
    cos_t, sin_t = (x.expand(b, HD) for x in rope_cos_sin(
        torch.tensor([s], device=device), HD, 500000.0))
    kq = quantize_k_factors(torch.randn((b, s, RK), generator=gen, device=device),
                            torch.randn((b, RK, HKV * HD), generator=gen, device=device) * 0.03)
    vq = quantize_v_factors(torch.randn((b, s, RV), generator=gen, device=device),
                            torch.randn((b, RV, HKV * HD), generator=gen, device=device) * 0.03)
    fargs = (kq.us_q, kq.vt_q, vq.us_q, vq.vt, cos_p, sin_p, cos_t, sin_t)
    fkw = dict(k_scale_slice=kq.out_scale, v_rank_scale=vq.rank_scale)
    return q0, fargs, fkw


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctx", type=int, default=65536)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--variants", default="prod,scratch_ab,two_gemm,b2048")
    ap.add_argument("--check", action="store_true",
                    help="numerics parity check vs production first")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_arg(args.device)
    print(card_line(device), flush=True)
    q0, fargs, fkw = inputs(args.batch, args.ctx, device)
    common = dict(scale=HD ** -0.5, num_kv_heads=HKV, **fkw)

    if args.check:
        o0, l0 = lowrank_decode_attention(q0, *fargs, **common)
        for v in ("scratch_ab", "two_gemm"):
            o1, l1 = k9.variant_attention(q0, *fargs, variant=v, **common)
            err, lerr = row_rel_err(o1, o0), lse_err(l1, l0)
            if not (err <= TOL_OUT and lerr <= TOL_LSE):
                raise AssertionError(f"{v}: row error {err:.3e} (limit {TOL_OUT:.3e}), "
                                     f"lse {lerr:.3e} (limit {TOL_LSE:.0e}) against prod")
            print(f"parity ok: {v}", flush=True)

    results = {}
    for v in args.variants.split(","):
        if v == "prod":
            def step():
                return lowrank_decode_attention(q0, *fargs, **common)
        else:
            def step(v=v):
                return k9.variant_attention(q0, *fargs, variant=v, **common)

        results[v] = time_ms(step, device, iters=args.n)
        print(f"{v:12s} {results[v]:8.3f} ms/call", flush=True)
    return results


if __name__ == "__main__":
    main()
