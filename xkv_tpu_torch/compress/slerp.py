"""MiniCache-style SLERP merging of two layers' K/V (port of
``xkv_tpu/compress/slerp.py``), plain torch in fp32.

Row-wise spherical interpolation on the unit sphere with
  * a linear-interpolation fallback for near-parallel rows (angle < 1e-7),
  * a divergence threshold ``d_min + (d_max - d_min) * gamma`` over all
    rows: only *divergent* rows take the merged vector (rescaled by each
    layer's row norm); the others keep their per-layer values.

``compact_pair`` / ``compact_reconstruct`` store a merged pair as one
shared direction per row, two norms, and the exact rows of both layers at
the ``keep`` rows of largest angle (``cache.SlerpCompact``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from xkv_tpu_torch.cache import SlerpCompact

_EPS = 1e-12


def slerp_merge_rows(
    x1: torch.Tensor, x2: torch.Tensor, t: float = 0.5, gamma: float = 0.05,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise SLERP of (L, d) matrices. Returns (merged, diverge_mask (L,),
    norm1 (L, 1), norm2 (L, 1)).

    ``valid`` ((L,) bool) keeps the rows it marks False (right-padded zero
    rows of a bucketed admission) out of the threshold's d_min / d_max; an
    all-zero row has no direction."""
    x1 = x1.to(torch.float32)
    x2 = x2.to(torch.float32)
    norm1 = torch.linalg.vector_norm(x1, dim=1, keepdim=True)
    norm2 = torch.linalg.vector_norm(x2, dim=1, keepdim=True)
    # Zero rows: 0 / eps = 0 keeps omega finite (a NaN would poison min / max).
    u1 = x1 / norm1.clamp_min(_EPS)
    u2 = x2 / norm2.clamp_min(_EPS)
    dot = (u1 * u2).sum(dim=1, keepdim=True).clamp(-1.0, 1.0)
    omega = torch.arccos(dot)  # (L, 1)
    sin_omega = torch.sin(omega)

    if valid is None:
        d_min, d_max = omega.min(), omega.max()
    else:
        v = valid.reshape(-1, 1)
        d_min = torch.where(v, omega, torch.inf).min()
        d_max = torch.where(v, omega, -torch.inf).max()
    threshold = d_min + (d_max - d_min) * gamma
    diverge = (omega > threshold).squeeze(-1)

    parallel = omega < 1e-7
    # Near-parallel rows take the linear branch: guard the division.
    safe_sin = torch.where(parallel, 1.0, sin_omega)
    alpha = torch.sin((1.0 - t) * omega) / safe_sin
    beta = torch.sin(t * omega) / safe_sin
    e_slerp = alpha * u1 + beta * u2
    e_linear = (1.0 - t) * x1 + t * x2
    return torch.where(parallel, e_linear, e_slerp), diverge, norm1, norm2


def minicache_merge(
    x1: torch.Tensor, x2: torch.Tensor, t: float = 0.5, gamma: float = 0.05,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MiniCache merge of two (L, d) matrices: divergent rows take the
    merged unit vector rescaled by each layer's norm, the others keep
    their rows. Outputs in the inputs' dtype."""
    dtype = x1.dtype
    merged, diverge, n1, n2 = slerp_merge_rows(x1, x2, t=t, gamma=gamma, valid=valid)
    mask = diverge[:, None]
    e1 = torch.where(mask, merged * n1, x1.to(torch.float32))
    e2 = torch.where(mask, merged * n2, x2.to(torch.float32))
    return e1.to(dtype), e2.to(dtype)


def minicache_merge_heads(
    k1: torch.Tensor, k2: torch.Tensor, t: float = 0.5, gamma: float = 0.05,
    valid_len=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MiniCache merge of (b, nh, s, hd) tensors over rows of head_dim, the
    divergence threshold global over (b, nh, s). ``valid_len`` (an int, a
    0-d or a (b,) tensor) keeps rows at and past it out of the threshold."""
    shape = k1.shape
    b, nh, s, hd = shape
    valid = None
    if valid_len is not None:
        vl = torch.as_tensor(valid_len, device=k1.device).reshape(-1, 1)  # (b or 1, 1)
        v = torch.arange(s, device=k1.device)[None, :] < vl
        valid = v[:, None, :].expand(b, nh, s).reshape(-1)
    e1, e2 = minicache_merge(k1.reshape(-1, hd), k2.reshape(-1, hd), t=t, gamma=gamma,
                             valid=valid)
    return e1.reshape(shape), e2.reshape(shape)


def compact_pair(x1: torch.Tensor, x2: torch.Tensor, keep: int) -> SlerpCompact:
    """Two merged layers' (b, nh, s, hd) rows as a shared direction, two
    norms per row and the exact rows of both layers at the ``keep`` rows of
    largest angle between them (merged rows are parallel, angle 0, so the
    budget goes to the rows the merge kept per layer). Among equal angles
    the lower row comes first (a stable sort: ``jax.lax.top_k``'s order).
    ``base`` and ``keep_rows`` in the inputs' dtype, ``norms`` fp32."""
    dtype = x1.dtype
    x1f = x1.to(torch.float32)
    x2f = x2.to(torch.float32)
    n1 = torch.linalg.vector_norm(x1f, dim=-1)  # (b, nh, s)
    n2 = torch.linalg.vector_norm(x2f, dim=-1)
    u1 = x1f / n1.clamp_min(_EPS)[..., None]
    u2 = x2f / n2.clamp_min(_EPS)[..., None]
    dot = (u1 * u2).sum(dim=-1).clamp(-1.0, 1.0)
    # Zero rows (padding, empty) are parallel by convention.
    both = (n1 > _EPS) & (n2 > _EPS)
    omega = torch.where(both, torch.arccos(dot), 0.0)

    mid = u1 + u2
    midn = torch.linalg.vector_norm(mid, dim=-1, keepdim=True)
    base = torch.where(midn > 1e-6, mid / midn.clamp_min(_EPS), u1)

    keep_idx = torch.sort(omega, dim=-1, descending=True, stable=True).indices[..., :keep]
    rows = torch.stack([x1f, x2f], dim=3)  # (b, nh, s, 2, hd)
    keep_rows = torch.gather(rows, 2, keep_idx[..., None, None].expand(
        -1, -1, -1, 2, rows.shape[-1]))
    return SlerpCompact(base=base.to(dtype), norms=torch.stack([n1, n2], dim=-1),
                        keep_idx=keep_idx.to(torch.int32), keep_rows=keep_rows.to(dtype))


def compact_reconstruct(sc: SlerpCompact, layer_pos: int,
                        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One layer's (b, nh, s, hd) rows from compact storage: the shared
    direction scaled by the layer's norm, the exact rows written back at
    the kept positions (a repeated index carries equal rows, so the
    result does not depend on which write lands)."""
    out = sc.base.to(torch.float32) * sc.norms[..., layer_pos, None]
    rows = sc.keep_rows[:, :, :, layer_pos].to(torch.float32)
    b, nh, _ = sc.keep_idx.shape
    bi = torch.arange(b, device=out.device)[:, None, None]
    hi = torch.arange(nh, device=out.device)[None, :, None]
    out.index_put_((bi, hi, sc.keep_idx.long()), rows)
    return out.to(dtype if dtype is not None else sc.base.dtype)
