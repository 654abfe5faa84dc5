"""KV-cache collection for compressor training.

The port's counterpart of ``xkv_tpu/train/collector.py``. The reference
registers forward hooks on every layer's k_proj / v_proj
(`src/kv_cache_collector.py:9-132`); the functional model returns each
layer's K/V from ``prefill``, so collection is a function: a frozen forward
through the default prefill (K1 on the card, its plain version on the CPU)
under ``torch.no_grad``.
"""

from __future__ import annotations

import torch

from xkv_tpu_torch.compress.svd import heads_to_matrix
from xkv_tpu_torch.models import llama
from xkv_tpu_torch.models.config import ModelConfig


@torch.no_grad()
def collect_kv(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Frozen forward over tokens (b, s); returns the stacked K‖V tensor
    (b, num_layers, s, 2 * hkv * hd) in the weights' dtype - the
    compressor's input layout (reference `compressor.py:47-89`). Only the
    first position's logits are computed: the K/V do not depend on them."""
    _, kvs = llama.prefill(params, cfg, tokens, logits_position=0)
    per_layer = [torch.cat([heads_to_matrix(k), heads_to_matrix(v)], dim=-1) for k, v in kvs]
    return torch.stack(per_layer, dim=1)
