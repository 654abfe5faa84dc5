"""Single-sequence/batch inference engine: prefill + compress + greedy decode.

Port of the single-device path of ``xkv_tpu/engine/engine.py:InferenceEngine``
for the Llama family (``models/llama.py``) and DeepSeek-V2 MLA + MoE
(``models/deepseek.py``, ``model_type="deepseek_v2"``: the latent is the
merged K slot, the RoPE key the unmerged V slot).

Modes:
  * "factored": the cache holds factors (+ dense tail); with the slerp
                scheme (MiniCache) the merged layers, dense or compact
                (``slerp_compact``);
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

``generate_speculative``: greedy decoding by draft and exact verify
(``graphs.SpecRounds``), the drafts from the sparse top-k step (Llama,
``sparse_topk``) or from the top ``draft_rank`` ranks of the MLA latent
factors (``draft_rank``); every emitted token comes from an exact pass.
``staged_prefill``: the prefill forward one SVD group at a time, each
group's K/V compressed as soon as its layers finish (peak memory holds one
group's dense K/V, not every layer's).

Sparse top-k decode (``sparse_topk``): each decode step attends to the
``sparse_topk`` highest-bounded ``sparse_block``-row chunks of every
factored segment (Quest selection; the sink and recency chunks always
kept, the dense tail exact), in the layers of ``sparse_layers`` (all when
None). ``sparse_topk_max``: a second, larger budget for steps with many
near-maximal chunks (``sparse_adaptive_band``), in post mode.
``factor_dtype="int4"``: mixed int8 + packed int4 factors, post mode only
(MLA: any mode, its latent carries no RoPE). MLA takes no sparse decode.

``mesh`` (``parallel.mesh.make_mesh(data=d, model=m)``, one process a
rank of the ``torch.distributed`` group): the JAX engine's ``mesh``. On
the model axis, tensor parallelism over kv heads for the Llama family
(modes factored, fake and none; rope modes pre and post; bf16, int8 and
mixed int8+int4 factors; sparse top-k) and over q heads for DeepSeek-V2
MLA, with expert parallelism for its MoE layers. The engine shards the
weights it is given (``parallel.sharding.shard_params``); each rank runs
K1 on its heads in prefill and K2-K8 on its heads' cache shard in decode
(sparse top-k selecting chunks per shard, sparse x int4 over every head,
as the JAX pallas path does), and the row-split products and the logits
are joined over the model axis (``models/llama.py``,
``models/deepseek.py``); the model group's first rank computes each
group's factors at a build and a refold and broadcasts them
(``engine/compression.py``). On the data axis each data row of ranks
serves its block of the batch rows (the batch must divide the axis, as
the JAX engine's token sharding needs): ``prefill`` and ``decode_step``
take and return every row, ``generate`` returns every row on every rank,
and the cache a rank holds is its shard (its rows; ``engine.shard_cfg``
is its share of the heads). With ``sequence_parallel`` (Llama family;
the JAX engine's) the data axis splits the prompt's rows instead: each
data rank runs its rows through every layer at their global positions,
attention by ring attention over the data axis (``ops/ring_attention.py``,
plain block products, as the JAX ring's), and the K/V rows and logits
are joined over it; the mesh's first rank factorises (each data group
then broadcasts its factors), so every rank holds the whole cache on its
heads, and decode runs every batch row on every data rank (b = 1
included; ``self.mesh`` is the mesh with ``replicas`` set). Decode under
a mesh runs eagerly: the collectives of the gloo backend cannot be
captured in a CUDA graph, so ``generate`` runs its steps one by one and
``DecodeGraph`` / ``SpecRounds`` (``score``, speculation) refuse a mesh.
Refused under a mesh: ``staged_prefill`` and ``sparse_topk_max`` (the JAX
engine refuses them too), and, not ported yet (ROADMAP item 17), the
slerp scheme. ``BatchedEngine(mesh=...)`` serves continuous batching
under a mesh (``engine/batching.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch

from xkv_tpu_torch.cache import XKVCache
from xkv_tpu_torch.configs import XKVConfig
from xkv_tpu_torch.engine.compression import (
    build_cache,
    build_cache_by_span,
    build_uncompressed_cache,
    refactorize_cache,
)
from xkv_tpu_torch.engine.graphs import DecodeGraph, RoundTiming, SegmentTiming, SpecRounds
from xkv_tpu_torch.models import deepseek, llama
from xkv_tpu_torch.models.config import ModelConfig
from xkv_tpu_torch.ops.rope import rope_cos_sin
from xkv_tpu_torch.parallel.sharding import shard_params

TP_ITEM = "not ported under a mesh yet (ROADMAP item 17)"


def check_tp(cfg: ModelConfig, xkv: Optional[XKVConfig], mode: str, mesh, sparse_topk_max,
             staged_prefill: bool, sequence_parallel: bool) -> None:
    """Refuse what the engine does not serve under a mesh: the JAX engine's
    own refusals with its reasons, the rest naming ROADMAP item 17."""
    if sequence_parallel:
        if mesh is None:
            raise ValueError("sequence_parallel requires a mesh with a 'data' axis")
        if cfg.model_type == "deepseek_v2":
            raise ValueError("sequence_parallel prefill is llama-family only (MLA "
                             "prefill shards batch over data instead)")
    if mesh is None or mesh.model * mesh.data == 1:
        return
    if staged_prefill:
        raise ValueError("staged_prefill is single-device (the sharded prefill paths stream "
                         "through GSPMD instead)")
    if sparse_topk_max is not None:
        raise ValueError("sparse_topk_max is single-device (TP sparse selection is per-shard "
                         "with a static budget)")
    if xkv is not None and mode != "none" and xkv.layer_merge_impl == "slerp":
        raise ValueError(f"the slerp scheme (MiniCache) is {TP_ITEM}")
    mla = cfg.model_type == "deepseek_v2"
    if cfg.num_q_heads % mesh.model or (not mla and cfg.num_kv_heads % mesh.model):
        heads = (f"{cfg.num_q_heads} q heads" if mla
                 else f"{cfg.num_q_heads} q / {cfg.num_kv_heads} kv heads")
        raise ValueError(f"{heads} do not split over a model axis of {mesh.model}")


def check_mla_slerp(xkv: Optional[XKVConfig]) -> None:
    """Refuse compact SLERP storage under MLA: the JAX MLA decode reads a
    group's dense latent wherever it has no factors, and compact storage
    leaves none (ROADMAP queue 3), so there is no reference to hold it to.
    Dense SLERP storage is served."""
    if xkv is not None and xkv.layer_merge_impl == "slerp" and xkv.slerp_compact:
        raise ValueError(
            "DeepSeek MLA with slerp_compact: the JAX MLA decode has no compact "
            "SLERP branch (it reads dense_k of every group without factors and raises "
            "KeyError at the first decode step); store SLERP groups dense "
            "(slerp_compact off)")


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
        draft_rank: Optional[int] = None,
        staged_prefill: bool = False,
        mesh=None,
        sequence_parallel: bool = False,
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
        # Rank-truncated drafts for speculative decoding, draft steps only.
        if draft_rank is not None:
            if not mla:
                raise ValueError("draft_rank drafts are MLA-only "
                                 "(llama-family speculation drafts with "
                                 "sparse_topk)")
            if mode != "factored":
                raise ValueError("draft_rank requires mode='factored'")
        if mode != "none" and xkv is None:
            raise ValueError("xkv config required unless mode='none'")
        if mla and xkv is not None and xkv.merge_value:
            raise ValueError(
                "DeepSeek MLA does not support merge_value (the V slot "
                "holds the uncompressed RoPE key); pass merge_value=False")
        if mla and mode == "factored":
            check_mla_slerp(xkv)
        if staged_prefill:
            if mode != "factored" or xkv is None:
                raise ValueError("staged_prefill requires mode='factored'")
            if xkv.layer_merge_impl != "svd":
                raise ValueError("staged_prefill supports the svd scheme only")
            if mla:
                raise ValueError("staged_prefill is llama-family only")
            if prefill_logits != "last":
                raise ValueError("staged_prefill computes last-position "
                                 "logits only (prefill_logits='last')")
            for grp in xkv.layer_groups:
                lo = grp.layers[0]
                if list(grp.layers) != list(range(lo, lo + len(grp.layers))):
                    raise ValueError(
                        "staged_prefill needs contiguous layer groups, got "
                        f"{grp.layers}")
        if not mla and cfg.model_type not in ("llama", "mistral", "qwen2"):
            raise NotImplementedError(f"model_type {cfg.model_type!r}")
        check_tp(cfg, xkv, mode, mesh, sparse_topk_max, staged_prefill, sequence_parallel)
        self._mla = mla
        self.device = torch.device(device)
        # Under a mesh: this rank's weights, its share of the heads. Under
        # sequence parallelism the data axis splits the prompt's rows at
        # prefill (``_ring_mesh``) and carries replicas after it: every data
        # row holds the whole cache on its heads and decodes every row.
        self.sequence_parallel = sequence_parallel
        self._ring_mesh = mesh if sequence_parallel else None
        if sequence_parallel:
            mesh = dataclasses.replace(mesh, replicas=True)
        self.mesh = mesh if mesh is not None and mesh.model * mesh.data > 1 else None
        self.params = params if self.mesh is None else shard_params(params, self.mesh)
        self.shard_cfg = cfg if self.mesh is None else dataclasses.replace(
            cfg, num_q_heads=cfg.num_q_heads // mesh.model,
            num_kv_heads=cfg.num_kv_heads // mesh.model,
            intermediate_size=cfg.intermediate_size // mesh.model)
        self._mesh_kw = {} if self.mesh is None else {"mesh": self.mesh}
        self.cfg = cfg
        self.xkv = xkv
        self.mode = mode
        self.tail_max = tail_max
        self.cache_dtype = cache_dtype
        self.factor_dtype = factor_dtype
        self.prefill_logits = prefill_logits
        self.staged_prefill = staged_prefill
        # Chunk width of the key bounds the cache stores (none unless sparse).
        self._bound_block = None if sparse_topk is None else sparse_block
        # Decode options of the plain step (its sparse top-k) and of a
        # speculative draft step; the verify step takes none (exact).
        self.step_kw = {} if sparse_topk is None else dict(
            sparse_select=sparse_topk, sparse_block=sparse_block,
            sparse_layers=None if sparse_layers is None else frozenset(sparse_layers),
            sparse_select_max=sparse_topk_max, sparse_adaptive_band=sparse_adaptive_band)
        self.draft_kw = self.step_kw if sparse_topk is not None else (
            {} if draft_rank is None else {"draft_rank": draft_rank})
        self._cos_sin: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        # The segments of the last generate, score or generate_speculative
        # call (``RoundTiming`` for a segment's speculative rounds).
        self.last_timings: List[Union[SegmentTiming, RoundTiming]] = []

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
        prefill_logits="last"; cache). Under a data axis the cache holds
        this rank's rows, the logits every row; under sequence parallelism
        every rank's cache and logits hold every row."""
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        if self.staged_prefill:
            return self._prefill_staged(tokens)
        if self.mesh is not None:
            tokens = self.mesh.rows(tokens)
        s = tokens.shape[1]
        model = deepseek if self._mla else llama
        prefill_kw = (dict(mesh=self._ring_mesh, sequence_parallel=True)
                      if self.sequence_parallel else self._mesh_kw)
        logits, kvs = model.prefill(
            self.params, self.shard_cfg, tokens,
            logits_position=s - 1 if self.prefill_logits == "last" else None, **prefill_kw)
        # The MLA latent is stored without RoPE: no tables (its RoPE key,
        # already rotated, is qk_rope_head_dim wide, not head_dim).
        cos_p, sin_p = (None, None) if self._mla else self._prefill_cos_sin(s)
        if self.mode == "none":
            cache = build_uncompressed_cache(
                kvs, self.shard_cfg, cos_p, sin_p, self.tail_max, cache_dtype=self.cache_dtype)
        else:
            cache = build_cache(
                kvs, self.xkv, self.shard_cfg, cos_p, sin_p, self.tail_max,
                fake=self.mode == "fake", factor_dtype=self.factor_dtype,
                cache_dtype=self.cache_dtype, sparse_block=self._bound_block, **self._mesh_kw)
        if self.mesh is not None:
            logits = self.mesh.gather_rows(logits)
        return logits, cache

    def _prefill_staged(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, XKVCache]:
        """The prefill one SVD group at a time (JAX ``_prefill_staged``):
        ``build_cache_by_span`` asks for each group's K/V (then each
        ungrouped layer's) in layer order, and gets them from a span of
        the layers (``llama.prefill_layer_span``) run there; it compresses
        them and drops them before the next span runs. The same layer body
        and group compression as the monolithic path; logits of the last
        position."""
        cfg = self.cfg
        s = tokens.shape[1]
        cos, sin = rope_cos_sin(torch.arange(s, device=self.device)[None, :], cfg.head_dim,
                                cfg.rope_theta, cfg.rope_scaling)
        cos_p, sin_p = self._prefill_cos_sin(s)
        layers = self.params["layers"]
        # Groups are contiguous (checked at construction), so each span
        # starts where the activations h stand.
        state = {"h": self.params["embed"][tokens]}

        def span_kvs(span):
            state["h"], kvs = llama.prefill_layer_span([layers[l] for l in span], cfg,
                                                       state["h"], cos, sin)
            return kvs

        cache = build_cache_by_span(
            span_kvs, cfg.num_layers, self.xkv, cfg, cos_p, sin_p, self.tail_max,
            factor_dtype=self.factor_dtype, cache_dtype=self.cache_dtype,
            sparse_block=self._bound_block)
        return llama.unembed(self.params, cfg, state["h"][:, -1:]), cache

    def step(self, cache: XKVCache, tokens: torch.Tensor, pos: Union[int, torch.Tensor],
             step_kw: dict) -> Tuple[torch.Tensor, XKVCache]:
        """One eager decode step with the decode options ``step_kw``
        (``step_kw`` the plain step's, ``draft_kw`` a draft's, {} exact)."""
        # The uncompressed cache has no groups, whatever merge plan is set.
        xkv = None if self.mode == "none" else self.xkv
        if self._mla:
            return deepseek.decode_step(self.params, self.shard_cfg, xkv, cache, tokens, pos,
                                        **step_kw, **self._mesh_kw)
        return llama.decode_step(
            self.params, self.shard_cfg, xkv, cache, tokens, pos,
            self._prefill_cos_sin(cache.prefill_len), **step_kw, **self._mesh_kw)

    @torch.no_grad()
    def decode_step(self, cache: XKVCache, tokens,
                    pos: Union[int, torch.Tensor]) -> Tuple[torch.Tensor, XKVCache]:
        """One eager decode step at position ``pos`` (an int or a 0-d
        tensor on the device); the cache's tail is updated in place. Under
        a data axis ``tokens`` and the logits hold every row, the cache
        this rank's."""
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        if self.mesh is None:
            return self.step(cache, tokens, pos, self.step_kw)
        logits, cache = self.step(cache, self.mesh.rows(tokens), pos, self.step_kw)
        return self.mesh.gather_rows(logits), cache

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
            cache, self.xkv, self.shard_cfg, factor_dtype=self.factor_dtype,
            sparse_block=self._bound_block, **self._mesh_kw)

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
            if self.mesh is None:
                seg = DecodeGraph(self, cache, pos, n, first_token=tok)
                rest, cache = seg.run()
                self.last_timings.append(seg.timing)
            else:
                rest, cache = self._eager_segment(cache, tok, pos, n)
                self.last_timings.append(SegmentTiming(n))
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

    def _eager_segment(self, cache: XKVCache, tok: torch.Tensor, pos: int,
                       n: int) -> Tuple[torch.Tensor, XKVCache]:
        """``n`` greedy steps from ``tok`` (b, 1) at ``pos``, one eager step
        after another (decode under a mesh, each data rank over its rows).
        Returns (tokens (b, n), every row, cache)."""
        tok = self.mesh.rows(tok)
        out = []
        for i in range(n):
            logits, cache = self.step(cache, tok, pos + i, self.step_kw)
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            out.append(tok)
        return self.mesh.gather_rows(torch.cat(out, dim=1)), cache

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

    @torch.no_grad()
    def generate_speculative(self, tokens, max_new_tokens: int, draft_k: int = 7,
                             eos_token_id: Optional[int] = None, return_stats: bool = False):
        """Greedy generation by draft and exact verify (the JAX engine's
        ``generate_speculative``): rounds of ``draft_k`` draft steps and one
        exact pass over them (``graphs.SpecRounds``, captured once per
        factor segment on CUDA), each emitting the drafts' matching prefix
        and the verify's next token. Every emitted token comes from an exact
        pass, so the tokens are exact greedy decoding's. When fewer than
        ``draft_k + 1`` tail rows are left, exact steps top the tail up to
        full (emitting tokens too), and it is folded into the factors.
        Batch 1. Returns (1, n) int64 token ids on the host, n <=
        ``max_new_tokens`` (cut after the first ``eos_token_id``); with
        ``return_stats`` also {rounds, round_tokens, plain_steps,
        tokens_per_round}."""
        if not self.draft_kw:
            raise ValueError("generate_speculative requires sparse_topk "
                             "(llama) or draft_rank (MLA) — the draft path")
        if self.cfg.sliding_window is not None:
            raise ValueError(
                "speculative decoding does not compose with sliding_window "
                "(the multi-token verify pass has no per-row window bound)")
        if torch.as_tensor(tokens).shape[0] != 1:
            raise ValueError("speculative decoding is batch-1 "
                             "(per-sequence acceptance lengths)")
        if draft_k + 1 > self.tail_max:
            raise ValueError(f"draft_k={draft_k} needs tail_max > draft_k")
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        logits, cache = self.prefill(tokens)
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        out = [int(tok)]
        pos = tokens.shape[1]
        stats = {"rounds": 0, "round_tokens": 0, "plain_steps": 0}
        self.last_timings = []
        rounds: Optional[SpecRounds] = None
        while len(out) < max_new_tokens:
            if eos_token_id is not None and out[-1] == eos_token_id:
                break
            capacity = self.tail_max - cache.tail_count
            if capacity < draft_k + 1:
                if rounds is not None:
                    tok, cache = rounds.close()
                    rounds = None
                if capacity > 0:
                    # Exact steps (the verify's options) up to a full tail.
                    seg = DecodeGraph(self, cache, pos, capacity, first_token=tok, step_kw={})
                    toks, cache = seg.run()
                    self.last_timings.append(seg.timing)
                    out.extend(toks[0].tolist())
                    tok = toks[:, -1:]
                    pos += capacity
                    stats["plain_steps"] += capacity
                if len(out) >= max_new_tokens:
                    break
                cache = self.refactorize(cache)
                continue
            if rounds is None:
                rounds = SpecRounds(self, cache, tok, pos, draft_k)
                self.last_timings.append(rounds.timing)
            emitted = rounds.round()
            out.extend(emitted)
            pos += len(emitted)
            cache = rounds.cache
            stats["rounds"] += 1
            stats["round_tokens"] += len(emitted)
        out = out[:max_new_tokens]
        if eos_token_id is not None and eos_token_id in out:
            out = out[:out.index(eos_token_id) + 1]
        result = torch.tensor(out, dtype=torch.long)[None, :]
        if return_stats:
            stats["tokens_per_round"] = (
                stats["round_tokens"] / stats["rounds"] if stats["rounds"] else 0.0)
            return result, stats
        return result
