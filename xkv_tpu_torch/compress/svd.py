"""Low-rank SVD factorisation of stacked KV matrices.

Port of ``xkv_tpu/compress/svd.py``. All compute is fp32.

  * ``truncated_svd``  exact ``torch.linalg.svd`` + truncation.
  * ``randomized_svd`` Halko-Martinsson-Tropp range finder with subspace
                       iteration; only an O((r+p)^2) SVD runs on the small
                       projected matrix.
  * ``factorize``      returns ``LowRankFactors`` with ``us = U diag(S)``
                       (b, s, r) and ``vt`` (b, r, m).
  * ``reconstruct``    ``us @ vt``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class LowRankFactors(NamedTuple):
    """Rank-r factorisation ``A ~= us @ vt``; us (..., s, r), vt (..., r, m)."""

    us: torch.Tensor
    vt: torch.Tensor

    @property
    def rank(self) -> int:
        return self.us.shape[-1]


def truncated_svd(mat: torch.Tensor, rank: int) -> LowRankFactors:
    """Exact truncated SVD over the last two dims, fp32."""
    mat = mat.to(torch.float32)
    u, s, vt = torch.linalg.svd(mat, full_matrices=False)
    us = u[..., :, :rank] * s[..., None, :rank]
    return LowRankFactors(us=us, vt=vt[..., :rank, :])


def randomized_svd(
    mat: torch.Tensor,
    rank: int,
    *,
    oversample: int = 16,
    n_iter: int = 2,
    seed: int = 0,
    omega: Optional[torch.Tensor] = None,
) -> LowRankFactors:
    """Randomized truncated SVD over the last two dims (HMT 2011, Alg. 4.4).

    The sketch Omega (m, r+p) is drawn once from a CPU ``torch.Generator``
    seeded with ``seed`` and shared by every batch row, as the JAX version
    shares one key. ``omega`` replaces the draw (tests pass the exact
    matrix the JAX package draws).
    """
    mat = mat.to(torch.float32)
    s, m = mat.shape[-2:]
    sketch = min(rank + oversample, min(s, m))
    if omega is None:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(seed)
        omega = torch.randn((m, sketch), generator=gen, dtype=torch.float32)
    omega = omega.to(device=mat.device, dtype=torch.float32)
    mat_t = mat.transpose(-1, -2)
    q, _ = torch.linalg.qr(mat @ omega)
    for _ in range(n_iter):
        z, _ = torch.linalg.qr(mat_t @ q)
        q, _ = torch.linalg.qr(mat @ z)
    b = q.transpose(-1, -2) @ mat  # (..., sketch, m)
    u_b, sv, vt = torch.linalg.svd(b, full_matrices=False)
    us = (q @ u_b[..., :, :rank]) * sv[..., None, :rank]
    return LowRankFactors(us=us, vt=vt[..., :rank, :])


def factorize(
    mat: torch.Tensor,
    rank: int,
    *,
    method: str = "randomized",
    oversample: int = 16,
    n_iter: int = 2,
    seed: int = 0,
) -> LowRankFactors:
    """Factorise (..., s, m) into rank-r ``LowRankFactors`` (fp32)."""
    if method == "exact":
        fac = truncated_svd(mat, rank)
    elif method == "randomized":
        fac = randomized_svd(mat, rank, oversample=oversample, n_iter=n_iter, seed=seed)
    else:
        raise ValueError(f"Unknown SVD method {method!r}")
    # LAPACK/cuSOLVER may return column-major factors; the cache stores
    # row-major ones (the kernels read rows).
    return LowRankFactors(fac.us.contiguous(), fac.vt.contiguous())


def reconstruct(factors: LowRankFactors, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dense reconstruction ``us @ vt`` in fp32, optionally cast."""
    out = factors.us.to(torch.float32) @ factors.vt.to(torch.float32)
    return out.to(dtype) if dtype is not None else out


def heads_to_matrix(x: torch.Tensor) -> torch.Tensor:
    """(b, nh, s, hd) -> (b, s, nh*hd)."""
    b, nh, s, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, nh * hd)


def matrix_to_heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    """(b, s, nh*hd) -> (b, nh, s, hd), inverse of ``heads_to_matrix``."""
    b, s, m = x.shape
    return x.reshape(b, s, nh, m // nh).permute(0, 2, 1, 3)
