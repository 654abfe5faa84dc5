"""Single-sequence/batch inference engine: prefill + compress + greedy decode.

Port of the single-device path of ``xkv_tpu/engine/engine.py:InferenceEngine``
for the Llama family (``models/llama.py``) and DeepSeek-V2 MLA + MoE
(``models/deepseek.py``, ``model_type="deepseek_v2"``: the latent is the
merged K slot, the RoPE key the unmerged V slot).

Modes:
  * "factored": the cache holds factors (+ dense tail);
  * "fake":     the dense lossy reconstruction is stored (reference parity);
  * "none":     uncompressed baseline.

There is no attention-implementation switch: on a CUDA device the kernels
run, for CPU tensors their plain versions do. ``generate`` and ``score``
run their decode steps through ``graphs.DecodeGraph``, the counterpart of
the JAX engine's scanned steps: on a CUDA device a captured CUDA graph of
one step, replayed once per token; on the CPU the same step, eagerly.
``decode_step`` is that step, eager; the decode state (the tail's fill and
the position) lives on the device. A full tail is folded back into the
factors between segments (``refactorize``).

Sparse top-k decode (``sparse_topk``): each decode step attends to the
``sparse_topk`` highest-bounded ``sparse_block``-row chunks of every
factored segment (Quest selection; the sink and recency chunks always
kept, the dense tail exact), in the layers of ``sparse_layers`` (all when
None). ``sparse_topk_max``: a second, larger budget for steps with many
near-maximal chunks (``sparse_adaptive_band``), in post mode.
``factor_dtype="int4"``: mixed int8 + packed int4 factors, post mode only
(MLA: any mode, its latent carries no RoPE). MLA takes no sparse decode.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch

from xkv_tpu_torch.cache import XKVCache
from xkv_tpu_torch.configs import XKVConfig
from xkv_tpu_torch.engine.compression import (
    build_cache,
    build_uncompressed_cache,
    refactorize_cache,
)
from xkv_tpu_torch.engine.graphs import DecodeGraph, SegmentTiming
from xkv_tpu_torch.models import deepseek, llama
from xkv_tpu_torch.models.config import ModelConfig
from xkv_tpu_torch.ops.rope import rope_cos_sin


class InferenceEngine:
    def __init__(
        self,
        params,
        cfg: ModelConfig,
        xkv: Optional[XKVConfig] = None,
        mode: str = "factored",
        tail_max: int = 128,
        cache_dtype: torch.dtype = torch.bfloat16,
        factor_dtype=torch.bfloat16,
        prefill_logits: str = "all",
        device: str | torch.device = "cuda",
        sparse_topk: Optional[int] = None,
        sparse_block: int = 512,
        sparse_layers=None,
        sparse_topk_max: Optional[int] = None,
        sparse_adaptive_band: float = 0.5,
    ):
        if mode not in ("factored", "fake", "none"):
            raise ValueError(f"unknown mode {mode!r}")
        if prefill_logits not in ("all", "last"):
            raise ValueError(f"unknown prefill_logits {prefill_logits!r}")
        mla = cfg.model_type == "deepseek_v2"
        if sparse_topk is not None and mode != "factored":
            raise ValueError("sparse_topk requires mode='factored'")
        if sparse_topk is not None and mla:
            raise ValueError("sparse_topk is llama-family only (MLA's absorbed decode "
                             "is already rank-space)")
        if factor_dtype == "int4" and xkv is not None and mode == "factored" \
                and xkv.rope_mode != "post" and not mla:
            raise ValueError("factor_dtype='int4' requires rope_mode='post' "
                             "(the rank-space decode path)")
        if sparse_topk_max is not None:
            if sparse_topk is None:
                raise ValueError("sparse_topk_max requires sparse_topk")
            if sparse_topk_max <= sparse_topk:
                raise ValueError("sparse_topk_max must exceed sparse_topk")
        if mode != "none" and xkv is None:
            raise ValueError("xkv config required unless mode='none'")
        if mla and xkv is not None and xkv.merge_value:
            raise ValueError(
                "DeepSeek MLA does not support merge_value (the V slot "
                "holds the uncompressed RoPE key); pass merge_value=False")
        if not mla and cfg.model_type not in ("llama", "mistral", "qwen2"):
            raise NotImplementedError(f"model_type {cfg.model_type!r}")
        self._mla = mla
        self.device = torch.device(device)
        self.params = params
        self.cfg = cfg
        self.xkv = xkv
        self.mode = mode
        self.tail_max = tail_max
        self.cache_dtype = cache_dtype
        self.factor_dtype = factor_dtype
        self.prefill_logits = prefill_logits
        # Chunk width of the key bounds the cache stores (none unless sparse).
        self._bound_block = None if sparse_topk is None else sparse_block
        self._sparse_kw = {} if sparse_topk is None else dict(
            sparse_select=sparse_topk, sparse_block=sparse_block,
            sparse_layers=None if sparse_layers is None else frozenset(sparse_layers),
            sparse_select_max=sparse_topk_max, sparse_adaptive_band=sparse_adaptive_band)
        self._cos_sin: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        # The segments of the last generate or score call.
        self.last_timings: List[SegmentTiming] = []

    def _prefill_cos_sin(self, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(s, hd) RoPE tables of the prefill positions, computed once per
        length and kept on the device."""
        if s not in self._cos_sin:
            self._cos_sin[s] = rope_cos_sin(
                torch.arange(s, device=self.device), self.cfg.head_dim,
                self.cfg.rope_theta, self.cfg.rope_scaling)
        return self._cos_sin[s]

    # ------------------------------------------------------------ public API
    @torch.no_grad()
    def prefill(self, tokens) -> Tuple[torch.Tensor, XKVCache]:
        """tokens (b, s) -> (logits (b, s, V) fp32, or (b, 1, V) with
        prefill_logits="last"; cache)."""
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        s = tokens.shape[1]
        model = deepseek if self._mla else llama
        logits, kvs = model.prefill(
            self.params, self.cfg, tokens,
            logits_position=s - 1 if self.prefill_logits == "last" else None)
        # The MLA latent is stored without RoPE: no tables (its RoPE key,
        # already rotated, is qk_rope_head_dim wide, not head_dim).
        cos_p, sin_p = (None, None) if self._mla else self._prefill_cos_sin(s)
        if self.mode == "none":
            cache = build_uncompressed_cache(
                kvs, self.cfg, cos_p, sin_p, self.tail_max, cache_dtype=self.cache_dtype)
        else:
            cache = build_cache(
                kvs, self.xkv, self.cfg, cos_p, sin_p, self.tail_max,
                fake=self.mode == "fake", factor_dtype=self.factor_dtype,
                cache_dtype=self.cache_dtype, sparse_block=self._bound_block)
        return logits, cache

    @torch.no_grad()
    def decode_step(self, cache: XKVCache, tokens,
                    pos: Union[int, torch.Tensor]) -> Tuple[torch.Tensor, XKVCache]:
        """One eager decode step at position ``pos`` (an int or a 0-d
        tensor on the device); the cache's tail is updated in place."""
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        # The uncompressed cache has no groups, whatever merge plan is set.
        xkv = None if self.mode == "none" else self.xkv
        if self._mla:
            return deepseek.decode_step(self.params, self.cfg, xkv, cache, tokens, pos)
        return llama.decode_step(
            self.params, self.cfg, xkv, cache, tokens, pos,
            self._prefill_cos_sin(cache.prefill_len), **self._sparse_kw)

    @torch.no_grad()
    def refactorize(self, cache: XKVCache) -> XKVCache:
        """Fold a full decode tail into the factors (tail_len must equal
        tail_max); returns a cache with an empty tail and prefill_len
        extended by tail_max."""
        if self.mode != "factored" or self.xkv is None:
            raise ValueError("refactorize requires mode='factored'")
        if cache.tail_count != cache.tail_max:
            raise ValueError(f"tail holds {cache.tail_count} of {cache.tail_max} rows")
        return refactorize_cache(
            cache, self.xkv, self.cfg, factor_dtype=self.factor_dtype,
            sparse_block=self._bound_block)

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens: int,
                 eos_token_id: Optional[int] = None) -> Union[torch.Tensor, List[torch.Tensor]]:
        """Greedy generation. Returns (b, max_new_tokens) token ids, prefill's
        token first; with ``eos_token_id``, a list of per-row token tensors
        on the host, each cut after its first EOS (the truncation runs on the
        host after the loop, as in the JAX engine)."""
        can_refactor = self.mode == "factored" and self.xkv is not None
        if max_new_tokens > self.tail_max and not can_refactor:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} exceeds tail_max={self.tail_max}")
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        logits, cache = self.prefill(tokens)
        tok = logits[:, -1, :].argmax(dim=-1)[:, None]
        pieces: List[torch.Tensor] = [tok]
        pos = tokens.shape[1]
        remaining = max_new_tokens - 1
        self.last_timings = []
        while remaining > 0:
            # Segments of tail capacity; a full tail is folded back into the
            # factors (periodic refactorisation), and the next segment's
            # graph is captured over the new factors.
            n = min(remaining, self.tail_max)
            seg = DecodeGraph(self, cache, pos, n, first_token=tok)
            rest, cache = seg.run()
            self.last_timings.append(seg.timing)
            pieces.append(rest)
            tok = rest[:, -1:]
            pos += n
            remaining -= n
            if remaining > 0:
                cache = self.refactorize(cache)
        out = torch.cat(pieces, dim=1)
        if eos_token_id is None:
            return out
        rows = []
        for row in out.cpu():
            hits = (row == eos_token_id).nonzero()
            rows.append(row[:int(hits[0]) + 1] if len(hits) else row)
        return rows

    @torch.no_grad()
    def score(self, cache: XKVCache, tokens,
              start_pos: Union[int, torch.Tensor]) -> Tuple[torch.Tensor, XKVCache]:
        """Teacher-forced scoring (the JAX engine's ``score``): feeds
        tokens[:, i] (b, steps) at position start_pos + i and returns
        (log-probs (b, steps, V) fp32, row i the log-softmax of the step
        that read tokens[:, i]; the cache with the steps appended to its
        tail). Steps past the tail's room are refused before any write."""
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        seg = DecodeGraph(self, cache, start_pos, tokens.shape[1], teacher=tokens)
        out = seg.run()
        self.last_timings = [seg.timing]
        return out
