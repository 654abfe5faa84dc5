"""Int8 quantisation of low-rank factors (the int8 half of
``xkv_tpu/compress/quant.py``).

Scale folding, so the decode kernels need one post-product scale:
    us ~= us_q * su            su: per-rank scale
    vt' = su[:, None] * vt     fold su into the basis
    vt' ~= vt_q * sv           sv: per-output-column scale
    us @ vt = (us_q @ vt_q) * sv                (int8 x int8 -> int32)
For V the kernels contract P @ us first, so us_q keeps its per-rank scale:
    P @ us = (P @ us_q) * su
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedKFactors(NamedTuple):
    """K side: reconstruction = (us_q @ vt_q) * out_scale."""

    us_q: torch.Tensor  # (b, s, r) int8
    vt_q: torch.Tensor  # (b, r, m) int8
    out_scale: torch.Tensor  # (b, 1, m) fp32


class QuantizedVFactors(NamedTuple):
    """V side: per-rank scale on us (applied to t = P @ us_q), bf16 vt."""

    us_q: torch.Tensor  # (b, s, r) int8
    rank_scale: torch.Tensor  # (b, 1, r) fp32
    vt: torch.Tensor  # (b, r, m) bf16


def _per_col_scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True)
    return torch.clamp(amax, min=1e-8) / 127.0


def _q8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does.
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_k_factors(us: torch.Tensor, vt: torch.Tensor) -> QuantizedKFactors:
    """us (b, s, r), vt (b, r, m) -> int8 K factors with folded scales."""
    us = us.to(torch.float32)
    vt = vt.to(torch.float32)
    su = _per_col_scale(us, dim=1)  # (b, 1, r)
    us_q = _q8(us, su)
    vt_folded = su.transpose(1, 2) * vt
    sv = _per_col_scale(vt_folded, dim=1)  # (b, 1, m)
    return QuantizedKFactors(us_q=us_q, vt_q=_q8(vt_folded, sv), out_scale=sv)


def dequantize_k(qf: QuantizedKFactors) -> torch.Tensor:
    """(b, s, m) fp32 reconstruction. The integer product is summed in
    fp64, which is exact here as the int32 accumulation is."""
    prod = torch.bmm(qf.us_q.to(torch.float64), qf.vt_q.to(torch.float64))
    return prod.to(torch.float32) * qf.out_scale


def quantize_v_factors(us: torch.Tensor, vt: torch.Tensor) -> QuantizedVFactors:
    """us (b, s, r), vt (b, r, m) -> int8 us + bf16 vt."""
    us = us.to(torch.float32)
    su = _per_col_scale(us, dim=1)
    return QuantizedVFactors(us_q=_q8(us, su), rank_scale=su, vt=vt.to(torch.bfloat16))


def dequantize_v(qf: QuantizedVFactors) -> torch.Tensor:
    us = qf.us_q.to(torch.float32) * qf.rank_scale
    return torch.bmm(us, qf.vt.to(torch.float32))
