"""DuoAttention pattern support: per-head full-vs-streaming attention masks.

Port of ``xkv_tpu/utils/duo_attention.py`` (the reference's
`xKV/utils/duo_attn_utils.py:6-37`, support code for its sparse-attention
roadmap item). Loads DuoAttention-format per-head gate scores (tsv +
config.json with sink / recent sizes) and thresholds them into binary head
patterns. The arithmetic is numpy's, as in the JAX package; the patterns
and masks come out as torch tensors, the form the port's attention ops
read (``ops.attention.attention_partial`` takes a boolean mask, True =
attend).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch


def sparsify_attention_heads(
    full_attention_heads,
    threshold: Optional[float] = None,
    sparsity: Optional[float] = None,
    seed: int = 0,
) -> Tuple[torch.Tensor, float]:
    """Binarize per-head gate scores (an array or tensor) at a threshold or
    a target sparsity (reference `duo_attn_utils.py:6-25`; the tie-break
    noise is numpy's, seeded). Returns (float64 head pattern, 1 = full
    attention; the share of streaming heads)."""
    scores = np.asarray(torch.as_tensor(full_attention_heads).cpu().numpy(), float)
    rng = np.random.default_rng(seed)
    scores = scores + rng.uniform(0, 1e-6, scores.shape)
    if sparsity is not None:
        threshold = np.quantile(scores, sparsity)
        if sparsity >= 1:
            threshold = 2.0
        if sparsity <= 0:
            threshold = -1.0
    elif threshold is None:
        raise ValueError("Either threshold or sparsity must be provided")
    heads = (scores >= threshold).astype(float)
    return torch.from_numpy(heads), float(1 - np.mean(heads))


def load_attn_pattern(attn_load_dir: str) -> Tuple[torch.Tensor, int, int]:
    """Load DuoAttention-format head patterns (reference
    `duo_attn_utils.py:28-37`): (float64 gate scores clipped to [0, 1],
    sink_size, recent_size)."""
    heads = np.loadtxt(
        os.path.join(attn_load_dir, "full_attention_heads.tsv"),
        dtype=float,
        delimiter="\t",
    )
    heads = np.clip(heads, 0, 1)
    with open(os.path.join(attn_load_dir, "config.json")) as f:
        config = json.load(f)
    return torch.from_numpy(heads), config["sink_size"], config["recent_size"]


def streaming_head_mask(
    q_len: int, kv_len: int, sink_size: int, recent_size: int, q_offset: int = 0,
    device: str | torch.device = "cpu",
) -> torch.Tensor:
    """(q_len, kv_len) bool mask on ``device`` for a *streaming* head: attend
    to the first ``sink_size`` tokens plus the most recent ``recent_size``
    (causal)."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    causal = kv_pos <= q_pos
    sink = kv_pos < sink_size
    recent = kv_pos > q_pos - recent_size
    return causal & (sink | recent)
