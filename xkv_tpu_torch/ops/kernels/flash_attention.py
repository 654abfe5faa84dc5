"""K1: GQA causal prefill attention (``csrc/flash_attention.cu``).

Port of ``xkv_tpu/ops/pallas/flash_attention.py:flash_attention_fwd``.
``flash_attention`` launches the CUDA kernel for CUDA tensors and runs
``flash_attention_plain`` for CPU tensors; there is no other path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from xkv_tpu_torch.ops.attention import blockwise_causal_attention
from xkv_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernel since the last reset (plain runs not counted).
launches = 0

# Head sizes the kernel is built for (those of the Llama-family configs);
# any other even head size up to 128 is zero-padded to the next of them.
HEAD_DIMS = (64, 128)


def padded_head_dim(hd: int) -> int:
    """The built head size that runs head size ``hd``: ``hd`` itself, or
    the next of ``HEAD_DIMS``, the operands zero-padded to it. Takes every
    even ``hd`` up to 128 (the decode kernels K3 and K5 pad each RoPE half,
    so they need it even; K1 keeps their rule)."""
    _build.require(0 < hd <= HEAD_DIMS[-1] and hd % 2 == 0,
                   f"head_dim {hd} not supported: the kernels take head sizes that are even, "
                   f"at most {HEAD_DIMS[-1]}")
    return next(d for d in HEAD_DIMS if d >= hd)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's function in plain tensor code: fp32 scores and online
    softmax, probabilities cast to v's dtype before the value product.
    q (b, hq, s, hd), k/v (b, hkv, s, hd) -> (b, s, hq, hd) in q's dtype."""
    out = blockwise_causal_attention(q, k, v, scale, window=window)
    return out.permute(0, 2, 1, 3).contiguous()


def kernel_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[int, ...]:
    """Check the operands' shapes against what the kernel takes and return
    (b, hq, hkv, s, hd): q (b, hq, s, hd), k and v (b, hkv, s, hd), any
    group size hq / hkv, every even hd up to 128 (``padded_head_dim``).
    Reads shapes only, so it runs on any device (``meta`` included)."""
    _build.require(q.dim() == 4 and k.dim() == 4,
                   f"q and k must have 4 dims, got {tuple(q.shape)}, {tuple(k.shape)}")
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    _build.require(k.shape == (b, hkv, s, hd) and v.shape == k.shape,
                   "k and v must be (b, hkv, s, hd) with q's b, s and hd")
    _build.require(hkv > 0 and hq % hkv == 0, f"q heads {hq} not a multiple of kv heads {hkv}")
    padded_head_dim(hd)
    return b, hq, hkv, s, hd


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal GQA attention with an optional sliding window (``col > row -
    window``). q (b, hq, s, hd), k/v (b, hkv, s, hd) -> (b, s, hq, hd),
    seq-major and ready for the (b, s, d) reshape that feeds wo."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, window=window)
    global launches
    b, hq, hkv, s, hd = kernel_shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require_cuda_tensor(t, name, (torch.bfloat16,), 4)
        _build.require(t.is_contiguous(), f"{name} must be contiguous")
    hp = padded_head_dim(hd)
    if hp != hd:  # zero columns add nothing to q . k; the scale stays the caller's
        q, k, v = (torch.nn.functional.pad(t, (0, hp - hd)) for t in (q, k, v))
    out = torch.empty((b, s, hq, hp), dtype=q.dtype, device=q.device)
    status = _build.load().xkv_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, s, hp, float(scale), int(window or 0),
        _build.stream_ptr(q.device),
    )
    _build.check(status, "flash_attention")
    launches += 1
    return out if hp == hd else out[..., :hd].contiguous()
