"""Rotary position embeddings (HF Llama "rotate_half" convention).

Port of ``xkv_tpu/ops/rope.py``. The xKV contract: merged groups store
pre-RoPE keys ("pre" mode), and RoPE is applied after reconstruction at read
time, either in the plain reference ops or folded into the decode kernel's
query embeds.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def default_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def llama3_scaled_inv_freq(
    inv_freq: torch.Tensor,
    factor: float = 8.0,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_position: int = 8192,
) -> torch.Tensor:
    """Llama-3.1 rope scaling (HF `_compute_llama3_parameters` parity)."""
    low_freq_wavelen = original_max_position / low_freq_factor
    high_freq_wavelen = original_max_position / high_freq_factor
    wavelen = 2 * math.pi / inv_freq
    inv_freq_llama = torch.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
    smooth = (original_max_position / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    smoothed = (1 - smooth) * inv_freq_llama / factor + smooth * inv_freq_llama
    is_medium = (wavelen >= high_freq_wavelen) & (wavelen <= low_freq_wavelen)
    return torch.where(is_medium, smoothed, inv_freq_llama)


def rope_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    theta: float = 10000.0,
    rope_scaling: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables for ``positions`` (..., ) -> (..., head_dim)
    each, with the half-frequencies duplicated (``cat([freqs, freqs], -1)``).
    The tables land on the device of ``positions``."""
    inv_freq = default_inv_freq(head_dim, theta, device=positions.device)
    if rope_scaling:
        rope_type = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
        if rope_type == "llama3":
            inv_freq = llama3_scaled_inv_freq(
                inv_freq,
                factor=rope_scaling.get("factor", 8.0),
                low_freq_factor=rope_scaling.get("low_freq_factor", 1.0),
                high_freq_factor=rope_scaling.get("high_freq_factor", 4.0),
                original_max_position=rope_scaling.get(
                    "original_max_position_embeddings", 8192
                ),
            )
        elif rope_type == "linear":
            inv_freq = inv_freq / rope_scaling.get("factor", 1.0)
        elif rope_type != "default":
            raise NotImplementedError(f"rope_type {rope_type!r} not supported")
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply RoPE in fp32 and cast back. x: (..., s, hd) or (b, nh, s, hd);
    cos/sin: (..., s, hd) broadcastable against x (a head axis is inserted
    when x has one more leading dim than cos)."""
    if x.dim() == cos.dim() + 1:
        cos = cos.unsqueeze(-3)
        sin = sin.unsqueeze(-3)
    xf = x.to(torch.float32)
    out = xf * cos.to(torch.float32) + rotate_half(xf) * sin.to(torch.float32)
    return out.to(x.dtype)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V2 interleaved RoPE: the (x0, x1), (x2, x3), ... pairs are
    de-interleaved to [evens | odds], then rotated as ``apply_rope`` does,
    in fp32. The result stays de-interleaved (the MLA cache stores the
    rotated ``k_pe`` in that layout)."""
    if x.dim() == cos.dim() + 1:
        cos = cos.unsqueeze(-3)
        sin = sin.unsqueeze(-3)
    xf = x.to(torch.float32)
    x_deint = torch.cat([xf[..., 0::2], xf[..., 1::2]], dim=-1)
    out = x_deint * cos.to(torch.float32) + rotate_half(x_deint) * sin.to(torch.float32)
    return out.to(x.dtype)
