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

# Head sizes the kernel is built for (those of the Llama-family configs).
HEAD_DIMS = (64, 128)


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
    group size hq / hkv, hd in ``HEAD_DIMS``. Reads shapes only, so it
    runs on any device (``meta`` included)."""
    _build.require(q.dim() == 4 and k.dim() == 4,
                   f"q and k must have 4 dims, got {tuple(q.shape)}, {tuple(k.shape)}")
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    _build.require(k.shape == (b, hkv, s, hd) and v.shape == k.shape,
                   "k and v must be (b, hkv, s, hd) with q's b, s and hd")
    _build.require(hkv > 0 and hq % hkv == 0, f"q heads {hq} not a multiple of kv heads {hkv}")
    _build.require(hd in HEAD_DIMS, f"head_dim {hd} not supported: the kernel takes {HEAD_DIMS}")
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
    out = torch.empty((b, s, hq, hd), dtype=q.dtype, device=q.device)
    status = _build.load().xkv_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, s, hd, float(scale), int(window or 0),
        _build.stream_ptr(q.device),
    )
    _build.check(status, "flash_attention")
    launches += 1
    return out
