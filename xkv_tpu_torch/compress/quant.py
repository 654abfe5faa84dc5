"""Int8 and mixed int8+int4 quantisation of low-rank factors (port of
``xkv_tpu/compress/quant.py``).

Scale folding, so the decode kernels need one post-product scale:
    us ~= us_q * su            su: per-rank scale
    vt' = su[:, None] * vt     fold su into the basis
    vt' ~= vt_q * sv           sv: per-output-column scale
    us @ vt = (us_q @ vt_q) * sv                (int8 x int8 -> int32)
For V the kernels contract P @ us first, so us_q keeps its per-rank scale:
    P @ us = (P @ us_q) * su

Mixed int8+int4 (``factor_dtype="int4"``): the top ``r_hi`` ranks keep
int8, the tail ranks drop to int4 packed two per byte. Byte j of a packed
row holds rank 2j in the high nibble and rank 2j+1 in the low nibble, so
unpacking yields the tail in [evens | odds] order; every rank-indexed
companion (``vt4`` rows, the V rank scale and ``v_vt`` rows) is stored
already permuted to that order and nothing is permuted at run time.
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


# ------------------------------------------------------------ mixed int8+int4
def _q4(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int4 values in [-7, 7], held as int8."""
    return torch.clamp(torch.round(x / scale), -7, 7).to(torch.int8)


def _per_col_scale4(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True)
    return torch.clamp(amax, min=1e-8) / 7.0


def eo_perm(r_lo: int, device=None) -> torch.Tensor:
    """[0, 2, 4, ..., 1, 3, 5, ...]: the unpack order of packed pairs."""
    idx = torch.arange(r_lo, device=device)
    return torch.cat([idx[::2], idx[1::2]])


def pack_int4_pairs(vals: torch.Tensor) -> torch.Tensor:
    """vals (..., r_lo) integers in [-7, 7] -> (..., r_lo/2) int8 packed."""
    vals = vals.to(torch.int32)
    even, odd = vals[..., ::2], vals[..., 1::2]
    return ((even << 4) | (odd & 0xF)).to(torch.int8)


def unpack_int4_pairs(packed: torch.Tensor):
    """(..., r_lo/2) int8 -> (evens, odds) int32, each (..., r_lo/2)."""
    x = packed.to(torch.int32)
    hi = x >> 4  # arithmetic shift: sign-extends the high nibble
    lo = ((x & 0xF) ^ 8) - 8  # sign-extends the low nibble
    return hi, lo


def unpack_int4_rows(packed: torch.Tensor) -> torch.Tensor:
    """(..., r_lo/2) packed -> (..., r_lo) int8 in [evens | odds] order."""
    ev, od = unpack_int4_pairs(packed)
    return torch.cat([ev, od], dim=-1).to(torch.int8)


class QuantizedKFactorsMixed4(NamedTuple):
    """K side, mixed: reconstruction =
    (us8 @ vt8) * out_scale + (unpack(us4p) @ vt4) * scale4, with the vt4
    rows stored in [evens | odds] order."""

    us8: torch.Tensor  # (b, s, r_hi) int8
    us4p: torch.Tensor  # (b, s, r_lo/2) int8, packed nibble pairs
    vt8: torch.Tensor  # (b, r_hi, m) int8
    vt4: torch.Tensor  # (b, r_lo, m) int8, rows in [evens | odds] order
    out_scale: torch.Tensor  # (b, 1, m) fp32, the int8 part's column scale
    scale4: torch.Tensor  # (b, 1, m) fp32, the int4 part's column scale


class QuantizedVFactorsMixed4(NamedTuple):
    """V side, mixed: int8 top ranks + packed int4 tail; rank_scale and the
    bf16 vt rows in the [hi | lo-evens | lo-odds] order of the unpacked
    t = P @ [us8 | unpack(us4p)]."""

    us8: torch.Tensor  # (b, s, r_hi) int8
    us4p: torch.Tensor  # (b, s, r_lo/2) int8
    rank_scale: torch.Tensor  # (b, 1, r) fp32, [hi | lo-eo] order
    vt: torch.Tensor  # (b, r, m) bf16, rows in [hi | lo-eo] order


def _int4_codes(us_lo: torch.Tensor) -> tuple:
    """Tail coordinates (b, s, r_lo) -> (packed int8 pairs, per-rank scale)."""
    if us_lo.shape[-1] % 2:
        raise ValueError("int4 tail rank count must be even")
    su = _per_col_scale4(us_lo, dim=1)  # (b, 1, r_lo)
    q4 = torch.clamp(torch.round(us_lo / su), -7, 7).to(torch.int32)
    return pack_int4_pairs(q4), su


def quantize_k_factors_mixed4(
    us: torch.Tensor, vt: torch.Tensor, r_hi: int
) -> QuantizedKFactorsMixed4:
    """us (b, s, r), vt (b, r, m), ranks in descending singular value order
    -> int8 top-``r_hi`` + packed int4 tail with folded scales."""
    us = us.to(torch.float32)
    vt = vt.to(torch.float32)
    hi = quantize_k_factors(us[:, :, :r_hi], vt[:, :r_hi, :])
    us4p, su = _int4_codes(us[:, :, r_hi:])
    vt_folded = su.transpose(1, 2) * vt[:, r_hi:, :]
    sv4 = _per_col_scale4(vt_folded, dim=1)  # (b, 1, m)
    perm = eo_perm(vt_folded.shape[1], us.device)
    return QuantizedKFactorsMixed4(
        us8=hi.us_q, us4p=us4p, vt8=hi.vt_q, vt4=_q4(vt_folded, sv4)[:, perm],
        out_scale=hi.out_scale, scale4=sv4)


def dequantize_k_mixed4(qf: QuantizedKFactorsMixed4) -> torch.Tensor:
    """(b, s, m) fp32 reconstruction (integer products summed exactly in
    fp64, as the int32 accumulation is)."""
    hi = torch.bmm(qf.us8.to(torch.float64), qf.vt8.to(torch.float64)).to(torch.float32)
    us_lo = unpack_int4_rows(qf.us4p)
    lo = torch.bmm(us_lo.to(torch.float64), qf.vt4.to(torch.float64)).to(torch.float32)
    return hi * qf.out_scale + lo * qf.scale4


def quantize_v_factors_mixed4(
    us: torch.Tensor, vt: torch.Tensor, r_hi: int
) -> QuantizedVFactorsMixed4:
    us = us.to(torch.float32)
    su8 = _per_col_scale(us[:, :, :r_hi], dim=1)
    us8 = _q8(us[:, :, :r_hi], su8)
    us4p, su4 = _int4_codes(us[:, :, r_hi:])
    perm = eo_perm(su4.shape[2], us.device)
    rank_scale = torch.cat([su8, su4[:, :, perm]], dim=2)
    vt_perm = torch.cat([vt[:, :r_hi], vt[:, r_hi:][:, perm]], dim=1)
    return QuantizedVFactorsMixed4(us8=us8, us4p=us4p, rank_scale=rank_scale,
                                   vt=vt_perm.to(torch.bfloat16))


def dequantize_v_mixed4(qf: QuantizedVFactorsMixed4) -> torch.Tensor:
    us = torch.cat([qf.us8, unpack_int4_rows(qf.us4p)], dim=-1)
    us = us.to(torch.float32) * qf.rank_scale
    return torch.bmm(us, qf.vt.to(torch.float32))
