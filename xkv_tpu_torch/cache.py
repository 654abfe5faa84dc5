"""Compressed KV cache structures (port of ``xkv_tpu/cache.py``).

Per layer group the cache holds the low-rank factors of the stacked K (and
V) matrices:

    group matrix  M_K = [K_l0 | K_l1 | ...]   (b, s_p, g*hkv*hd)
    factors       k_us (b, s_p, rk), k_vt (b, rk, g*hkv*hd)

plus dense segments for what the factors do not cover (ungrouped layers,
an unmerged side, the "fake" and "none" modes) and a preallocated decode
tail holding the tokens appended after prefill.

The cache is a plain dataclass of tensors. The decode tail is updated IN
PLACE (``append_tail`` writes into ``tail_k``/``tail_v``); everything else
is replaced, never mutated. The tail's fill ``tail_len`` is a 0-d int32
tensor on the cache's device, as in the JAX package, so a decode step reads
no value on the host; ``tail_count`` is the same count kept on the host
(every step's length is known there), which the overflow refusals read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from xkv_tpu_torch.configs import XKVConfig
from xkv_tpu_torch.models.config import ModelConfig


@dataclass
class GroupFactors:
    """Low-rank factors for one layer group; a field is None when its side
    or storage format is not in use.

    Int8 (compress/quant.py): k_us/k_vt are int8 with the post-product
    column scale in ``k_scale``; v_us is int8 with its per-rank scale in
    ``v_scale`` (v_vt stays bf16). The fields after ``v_scale`` belong to
    formats later parts of the port fill (mixed int8+int4, MLA, sparse
    bounds, compact MiniCache); they are declared so those parts add code,
    not fields.
    """

    k_us: Optional[torch.Tensor] = None  # (b, s_p, rk)
    k_vt: Optional[torch.Tensor] = None  # (b, rk, g*hkv*hd)
    v_us: Optional[torch.Tensor] = None  # (b, s_p, rv)
    v_vt: Optional[torch.Tensor] = None  # (b, rv, g*hkv*hd)
    k_scale: Optional[torch.Tensor] = None  # (b, 1, g*hkv*hd) fp32, int8 only
    v_scale: Optional[torch.Tensor] = None  # (b, 1, rv) fp32, int8 only
    k_us4: Optional[torch.Tensor] = None  # (b, s_p, r_lo_k/2) packed int4
    k_vt4: Optional[torch.Tensor] = None  # (b, r_lo_k, g*hkv*hd)
    k_scale4: Optional[torch.Tensor] = None  # (b, 1, g*hkv*hd)
    v_us4: Optional[torch.Tensor] = None  # (b, s_p, r_lo_v/2) packed int4
    k_rnorm: Optional[torch.Tensor] = None  # (b, g, s_p) MLA latent inv-rms
    k_cmin: Optional[torch.Tensor] = None  # (b, n_chunks, g*hkv*hd)
    k_cmax: Optional[torch.Tensor] = None
    slerp_k: Optional[Any] = None  # compact MiniCache storage
    slerp_v: Optional[Any] = None


def iter_tensors(obj) -> Iterator[torch.Tensor]:
    """Every tensor held by a dataclass, walking its fields (and nested
    dataclasses) generically, so a new field needs no new code here."""
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if isinstance(val, torch.Tensor):
            yield val
        elif dataclasses.is_dataclass(val):
            yield from iter_tensors(val)


@dataclass
class XKVCache:
    """Hybrid factored + dense KV cache for one sequence batch.

    groups:  GroupFactors per ``XKVConfig.layer_groups`` entry.
    dense_k: {layer: (b, hkv, s_p, hd)} post-RoPE prefill keys of layers
             whose K is not factored; dense_v likewise for V.
    tail_k/tail_v: (L, b, hkv, t_max, hd) decode-time K (post-RoPE) and V;
             MLA: the latent and the rotated RoPE key (``init_tail``).
    tail_len: () int32 tensor on the tail's device, the number of valid
             tail rows; tail_count: the same number on the host.
    """

    groups: Tuple[GroupFactors, ...]
    dense_k: Dict[int, torch.Tensor]
    dense_v: Dict[int, torch.Tensor]
    tail_k: torch.Tensor
    tail_v: torch.Tensor
    tail_len: torch.Tensor
    tail_count: int = 0

    @property
    def prefill_len(self) -> int:
        if self.dense_k:
            return next(iter(self.dense_k.values())).shape[2]
        for g in self.groups:
            for f in (g.k_us, g.v_us):
                if f is not None:
                    return f.shape[1]
        raise ValueError("empty cache")

    @property
    def tail_max(self) -> int:
        return self.tail_k.shape[3]

    def append_tail(self, layer_idx: int, k: torch.Tensor, v: torch.Tensor) -> "XKVCache":
        """Write one decode step's K/V (b, hkv, ql, hd) IN PLACE at tail
        rows ``tail_len + arange(ql)`` of ``layer_idx`` (an indexed copy on
        the device); ``advance`` moves the position once per step."""
        ql = k.shape[2]
        if self.tail_count + ql > self.tail_max:
            raise ValueError(f"tail overflow: {self.tail_count} + {ql} > {self.tail_max}")
        rows = self.tail_len.long() + torch.arange(ql, device=self.tail_len.device)
        self.tail_k[layer_idx].index_copy_(2, rows, k.to(self.tail_k.dtype))
        self.tail_v[layer_idx].index_copy_(2, rows, v.to(self.tail_v.dtype))
        return self

    def advance(self, n: int = 1) -> "XKVCache":
        """The cache ``n`` rows on: a new ``tail_len`` tensor (added on the
        device) and host count; the tail buffers are shared."""
        return dataclasses.replace(self, tail_len=self.tail_len + n,
                                   tail_count=self.tail_count + n)

    # ------------------------------------------------------------- memory
    def num_cache_bytes(self) -> int:
        """Bytes held for prefill KV (factors incl. scales + dense),
        excluding the tail (which exists in both compressed and baseline)."""
        total = 0
        for g in self.groups:
            total += sum(t.numel() * t.element_size() for t in iter_tensors(g))
        for d in (self.dense_k, self.dense_v):
            total += sum(a.numel() * a.element_size() for a in d.values())
        return total

    def compression_ratio(self, cfg: ModelConfig) -> float:
        """Dense-cache bytes (at the tail's dtype) / stored bytes. The MLA
        dense cache is one latent and one RoPE key per layer and row."""
        b = self.tail_k.shape[1]
        s_p = self.prefill_len
        if cfg.model_type == "deepseek_v2":
            dense = cfg.num_layers * b * s_p * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        else:
            dense = 2 * cfg.num_layers * b * cfg.num_kv_heads * s_p * cfg.head_dim
        return dense * self.tail_k.element_size() / max(self.num_cache_bytes(), 1)


def init_tail(
    cfg: ModelConfig,
    batch: int,
    t_max: int,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed decode tails (L, b, heads, t_max, width) for K and V. MLA: the
    K slot holds the latent (one "head" of kv_lora_rank), the V slot the
    rotated RoPE key (qk_rope_head_dim)."""
    if cfg.model_type == "deepseek_v2":
        k_shape = (cfg.num_layers, batch, 1, t_max, cfg.kv_lora_rank)
        v_shape = (cfg.num_layers, batch, 1, t_max, cfg.qk_rope_head_dim)
    else:
        k_shape = v_shape = (cfg.num_layers, batch, cfg.num_kv_heads, t_max, cfg.head_dim)
    return (torch.zeros(k_shape, dtype=dtype, device=device),
            torch.zeros(v_shape, dtype=dtype, device=device))


def empty_tail_len(device: str | torch.device) -> torch.Tensor:
    """``tail_len`` of an empty tail: a 0-d int32 zero on ``device``."""
    return torch.zeros((), dtype=torch.int32, device=device)


def layer_group_index(xkv: XKVConfig) -> Dict[int, Tuple[int, int]]:
    """{layer_idx: (group_ordinal, position_within_group)} for grouped layers."""
    out: Dict[int, Tuple[int, int]] = {}
    for gi, grp in enumerate(xkv.layer_groups):
        for pos, lyr in enumerate(grp.layers):
            out[lyr] = (gi, pos)
    return out


def vt_layer_slice(vt: torch.Tensor, pos: int, num_kv_heads: int, head_dim: int) -> torch.Tensor:
    """Column slice of a group's shared V^T for the layer at position
    ``pos`` in the group: columns [pos*hkv*hd, (pos+1)*hkv*hd). A view, not
    contiguous; the kernel wrappers take it as it is (row stride)."""
    width = num_kv_heads * head_dim
    return vt[:, :, pos * width:(pos + 1) * width]
