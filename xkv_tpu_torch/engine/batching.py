"""Continuous batching: a slot-based scheduler over the factored cache.

Port of ``xkv_tpu/engine/batching.py`` (``BatchedEngine``):

  * B fixed decode slots over one slot cache of ``s_max`` rows per slot;
    all shapes static.
  * Admission: a request is prefilled alone at its length bucket (right
    padded; K1 for Llama), compressed (``build_cache``) and written into
    its slot in place; per-slot valid lengths mask the padding. With
    ``prefill_chunk`` the prompt is prefilled one chunk per scheduler
    step (``prefill_chunk``), interleaved with decode steps.
  * One decode step advances every slot (``graphs.BatchedStep``: on CUDA
    a graph captured once per engine and replayed every step); finished
    slots (EOS, ``max_new_tokens``) free at once and the next queued
    request is admitted, with no batch-wide barrier.
  * A slot whose tail fills folds it back into its own factors in place
    (``refactorize_slot_cache``) while its rows last, and finishes
    otherwise. MiniCache (slerp) groups are stored dense, or compact
    (``slerp_compact``) at a fixed exception budget per slot; compact
    slots fold like factors, dense ones never do (the JAX engine's rule).
  * With ``speculative_k``, a step is a speculative round of every slot
    (``graphs.BatchedSpecRound``: k draft steps with the draft options,
    sparse top-k for Llama or ``draft_rank`` for MLA, one exact verify
    pass, per-slot acceptance; both steps captured once per engine), or,
    when a slot lacks the tail rows of a round, a plain exact step.

Greedy decoding. The slot cache is written only in place (admission,
refolds), never reallocated: the captured step reads it by address.

Under a ``mesh`` (``parallel.mesh.make_mesh(data=d, model=m)``, one
process a rank; JAX ``BatchedEngine(mesh=...)``): the slots split over the
data axis (data rank i holds slots [i * B / d, (i + 1) * B / d), their rows
of every cache leaf, ``parallel.sharding.shard_cache``'s layout), the
weights and each slot's kv heads over the model axis, as
``InferenceEngine(mesh=...)`` splits them. Every rank runs the same host
scheduler over every request; a step's (or a round's) tokens of all slots
are joined over the data axis before any host decision (a finish, a full
tail, a refold, an acceptance), so the ranks decide alike and their
collectives stay paired. An admission (monolithic or chunked: its prefill,
build and insertion) and a slot's refold run on the data row that holds
the slot, over that row's model group; the first tokens are joined after.
Steps run eagerly there: gloo's collectives cannot be captured in a CUDA
graph, so ``BatchedStep`` and ``BatchedSpecRound`` refuse a mesh. Every
configuration of one device is served (pre / post, bf16 / int8 / int4
factors, sparse drafts with speculation, MLA + MoE with ``draft_rank``),
but the slerp scheme, refused under a mesh as ``InferenceEngine`` refuses
it (ROADMAP item 17).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from xkv_tpu_torch.cache import GroupFactors, SlerpCompact, XKVCache, empty_tail_len, init_tail
from xkv_tpu_torch.configs import XKVConfig
from xkv_tpu_torch.engine.compression import (
    build_cache,
    build_uncompressed_cache,
    int4_rank_hi,
    put_slot,
    refactorize_slot_cache,
)
from xkv_tpu_torch.engine.engine import check_mla_slerp, check_tp
from xkv_tpu_torch.engine.graphs import BatchedSpecRound, BatchedStep
from xkv_tpu_torch.models import deepseek, llama
from xkv_tpu_torch.models.config import ModelConfig
from xkv_tpu_torch.ops.rope import rope_cos_sin
from xkv_tpu_torch.parallel.mesh import Mesh
from xkv_tpu_torch.parallel.sharding import shard_params


@dataclass
class Request:
    request_id: int
    tokens: np.ndarray  # (s,) prompt
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    done: bool = False


class BatchedEngine:
    """Slot-based continuous batching over the hybrid factored cache (the
    JAX constructor's surface without ``attention_impl``, plus ``device``;
    ``mesh`` a ``parallel.mesh.Mesh``, module docstring). ``xkv=None``
    serves an uncompressed cache."""

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        xkv: Optional[XKVConfig],
        num_slots: int = 4,
        s_max: int = 2048,
        tail_max: int = 128,
        prefill_buckets: Optional[List[int]] = None,
        eos_token_id: Optional[int] = None,
        cache_dtype: torch.dtype = torch.bfloat16,
        factor_dtype=torch.bfloat16,
        prefill_chunk: Optional[int] = None,
        sparse_topk: Optional[int] = None,
        sparse_block: int = 512,
        sparse_layers=None,
        speculative_k: Optional[int] = None,
        draft_rank: Optional[int] = None,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"BatchedEngine(mesh=...) takes a parallel.mesh.Mesh, not "
                            f"{type(mesh).__name__}")
        mla = cfg.model_type == "deepseek_v2"
        if not mla and cfg.model_type not in ("llama", "mistral", "qwen2"):
            raise NotImplementedError(f"model_type {cfg.model_type!r}")
        if mla and xkv is not None and xkv.merge_value:
            raise ValueError("DeepSeek MLA: pass merge_value=False")
        if mla:
            check_mla_slerp(xkv)
        if factor_dtype == "int4":
            if mla:
                raise ValueError("factor_dtype='int4' is llama-family rope_mode='post' "
                                 "only; MLA uses int8 factors")
            if xkv is None or xkv.rope_mode != "post":
                raise ValueError("factor_dtype='int4' requires rope_mode='post' "
                                 "(rank-space decode; docs/ROPE_MODES.md)")
            if not (xkv.merge_key and xkv.merge_value):
                raise ValueError(
                    "BatchedEngine factor_dtype='int4' requires merge_key=True and "
                    "merge_value=True (one-sided int4 is supported by the single-stream "
                    "InferenceEngine)")
            if speculative_k is not None:
                raise ValueError(
                    "factor_dtype='int4' does not compose with batched speculation yet (the "
                    "multi-token verify pass needs the mixed packed layout in its exact "
                    "path); sparse_topk composes (rank-space gathered rows)")
            max_rank = max(max(g.rank_k or 0, g.rank_v or 0) for g in xkv.layer_groups)
            min_bucket = min(prefill_buckets or [s_max])
            if min_bucket < max_rank:
                # A shorter bucket clamps the SVD rank, and the packed int4
                # tail would no longer line up with the slot's layout.
                raise ValueError(
                    f"factor_dtype='int4' needs every prefill bucket >= the max factor "
                    f"rank ({max_rank}); got bucket {min_bucket}")
        buckets = sorted(prefill_buckets or [s_max])
        if buckets[-1] > s_max:
            raise ValueError(f"prefill bucket {buckets[-1]} exceeds s_max={s_max}")
        if prefill_chunk is not None:
            bad = [b for b in buckets if b % prefill_chunk]
            if bad:
                raise ValueError(f"prefill buckets {bad} not multiples of "
                                 f"prefill_chunk={prefill_chunk}")
        if sparse_topk is not None and mla:
            raise ValueError("sparse_topk is llama-family only")
        if draft_rank is not None and not mla:
            raise ValueError("draft_rank drafts are MLA-only (llama-family speculation "
                             "drafts with sparse_topk)")
        if speculative_k is not None:
            if sparse_topk is None and draft_rank is None:
                raise ValueError("speculative_k requires sparse_topk (llama) or draft_rank "
                                 "(MLA) — the draft path")
            if cfg.sliding_window is not None:
                raise ValueError("speculative_k does not compose with sliding_window "
                                 "(multi-token verify has no per-row window bound)")
            if speculative_k + 1 > tail_max:
                raise ValueError(f"speculative_k={speculative_k} needs tail_max > "
                                 f"speculative_k")
        if mesh is not None and mesh.model * mesh.data == 1:
            mesh = None
        if mesh is not None:
            if num_slots % mesh.data:
                raise ValueError(f"num_slots={num_slots} must be a multiple of the mesh data "
                                 f"axis ({mesh.data})")
            check_tp(cfg, xkv, "factored", mesh, None, False, False)
        self._model = deepseek if mla else llama
        self._mla = mla
        self._quantized = factor_dtype in ("int8", torch.int8)
        self._mixed4 = factor_dtype == "int4"
        self.device = torch.device(device)
        # Under a mesh: this rank's weights and share of the heads, and its
        # data row's slots [_lo, _lo + local_slots).
        self.mesh = mesh
        self.params = params if mesh is None else shard_params(params, mesh)
        self.shard_cfg = cfg if mesh is None else dataclasses.replace(
            cfg, num_q_heads=cfg.num_q_heads // mesh.model,
            num_kv_heads=cfg.num_kv_heads // mesh.model,
            intermediate_size=cfg.intermediate_size // mesh.model)
        self._mesh_kw = {} if mesh is None else {"mesh": mesh}
        self.local_slots = num_slots if mesh is None else num_slots // mesh.data
        self._lo = 0 if mesh is None else mesh.data_rank * self.local_slots
        self.cfg = cfg
        self.xkv = xkv
        self.num_slots = num_slots
        self.s_max = s_max
        self.tail_max = tail_max
        self.eos_token_id = eos_token_id
        self.cache_dtype = cache_dtype
        self.factor_dtype = factor_dtype
        self.prefill_buckets = buckets
        # Chunked admission: at most one in flight, one chunk per step.
        self.prefill_chunk = prefill_chunk
        self._admitting: Optional[dict] = None
        self.sparse_topk = sparse_topk
        self.sparse_block = sparse_block
        self.sparse_layers = None if sparse_layers is None else frozenset(sparse_layers)
        self._sparse_kw = {} if sparse_topk is None else dict(
            sparse_select=sparse_topk, sparse_block=sparse_block,
            sparse_layers=self.sparse_layers)
        # Speculation: the draft step's options; the plain step of a
        # speculating engine (a top-up) is exact, where the JAX engine's
        # runs its sparse options (ROADMAP queue 3).
        self.speculative_k = speculative_k
        self.draft_kw = self._sparse_kw if sparse_topk is not None else (
            {} if draft_rank is None else {"draft_rank": draft_rank})
        self._step_kw = {} if speculative_k is not None else self._sparse_kw
        # Rounds run, tokens emitted by rounds, plain (top-up) steps.
        self.spec_stats = {"rounds": 0, "round_tokens": 0, "plain_steps": 0}
        # Per-slot refolds: SVD groups fold their tails into their factors,
        # compact SLERP groups compact again in place; dense storage never
        # folds (a full tail finishes the request).
        self._can_refactor = (
            xkv is not None and (xkv.merge_key or xkv.merge_value)
            and (xkv.layer_merge_impl == "svd" or xkv.slerp_compact))

        rope_dim = cfg.qk_rope_head_dim if mla else cfg.head_dim
        self._cos_sin = rope_cos_sin(torch.arange(s_max, device=self.device), rope_dim,
                                     cfg.rope_theta, cfg.rope_scaling)
        self.batch_cache = self._empty_batch_cache()
        self.prefill_len = np.zeros(num_slots, np.int32)
        self.tail_len = np.zeros(num_slots, np.int32)
        self.pos = np.zeros(num_slots, np.int32)
        self.token = np.zeros(num_slots, np.int32)
        self.slot_request: Dict[int, Request] = {}
        self.queue: List[Request] = []
        self._next_id = 0
        self._finished: List[Request] = []
        self._tail_capacity_finished: List[Request] = []
        # Under a mesh the steps run eagerly (``_mesh_step``, ``_mesh_round``).
        self.step_graph = None if mesh is not None else BatchedStep(self)
        self.spec_graph = (None if speculative_k is None or mesh is not None
                           else BatchedSpecRound(self))

    # ------------------------------------------------------------ structure
    def _empty_batch_cache(self) -> XKVCache:
        """Zeroed slot cache: the layout of a batch-1 admitted cache with
        ``num_slots`` rows and ``s_max`` sequence rows (JAX
        ``_empty_batch_cache``). A compact SLERP side holds a fixed
        exception budget per slot, D = max(1, int(slerp_keep_frac * s_max))
        + tail_max: an admission's kept rows and one fold's. A dense SLERP
        group gets dense slots. Under a mesh: this rank's slots and heads."""
        cfg, xkv, dev = self.shard_cfg, self.xkv, self.device
        B, S = self.local_slots, self.s_max

        def zeros(*shape, dtype=self.cache_dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # MLA: the K slot is the latent (one "head" of kv_lora_rank), the V
        # slot the rotated RoPE key, never merged.
        hkv, hd = (1, cfg.kv_lora_rank) if self._mla else (cfg.num_kv_heads, cfg.head_dim)
        v_width = cfg.qk_rope_head_dim if self._mla else hd
        quantlike = self._quantized or self._mixed4
        f_dtype = torch.int8 if quantlike else self.factor_dtype
        groups = []
        dense_k: Dict[int, torch.Tensor] = {}
        dense_v: Dict[int, torch.Tensor] = {}
        covered = set()
        svd = xkv is not None and xkv.layer_merge_impl == "svd"
        compact = xkv is not None and xkv.layer_merge_impl == "slerp" and xkv.slerp_compact
        D = max(1, int(xkv.slerp_keep_frac * S)) + self.tail_max if compact else 0

        def compact_side():
            return SlerpCompact(base=zeros(B, hkv, S, hd),
                                norms=zeros(B, hkv, S, 2, dtype=torch.float32),
                                keep_idx=zeros(B, hkv, D, dtype=torch.int32),
                                keep_rows=zeros(B, hkv, D, 2, hd))

        for grp in (xkv.layer_groups if xkv is not None else []):
            covered.update(grp.layers)
            m = len(grp.layers) * hkv * hd
            kw = {}
            if compact and xkv.merge_key:
                kw["slerp_k"] = compact_side()
            elif svd and xkv.merge_key:
                r8 = int4_rank_hi(grp.rank_k, xkv.int4_rank_frac) if self._mixed4 else grp.rank_k
                kw["k_us"], kw["k_vt"] = zeros(B, S, r8, dtype=f_dtype), zeros(B, r8, m,
                                                                               dtype=f_dtype)
                if quantlike:
                    kw["k_scale"] = zeros(B, 1, m, dtype=torch.float32)
                if self._mixed4:
                    lo = grp.rank_k - r8
                    kw["k_us4"] = zeros(B, S, lo // 2, dtype=torch.int8)
                    kw["k_vt4"] = zeros(B, lo, m, dtype=torch.int8)
                    kw["k_scale4"] = zeros(B, 1, m, dtype=torch.float32)
                if self.sparse_topk is not None:
                    nc = -(-S // self.sparse_block)
                    kw["k_cmin"], kw["k_cmax"] = zeros(B, nc, m), zeros(B, nc, m)
                if self._mla:
                    kw["k_rnorm"] = zeros(B, len(grp.layers), S, dtype=torch.float32)
            else:
                for l in grp.layers:
                    dense_k[l] = zeros(B, hkv, S, hd)
            if compact and xkv.merge_value:
                kw["slerp_v"] = compact_side()
            elif svd and xkv.merge_value:
                r8 = int4_rank_hi(grp.rank_v, xkv.int4_rank_frac) if self._mixed4 else grp.rank_v
                kw["v_us"] = zeros(B, S, r8, dtype=f_dtype)
                # v_vt keeps every rank (bf16, [hi | lo-eo] order if mixed).
                kw["v_vt"] = zeros(B, grp.rank_v, m,
                                   dtype=torch.bfloat16 if quantlike else f_dtype)
                if quantlike:
                    kw["v_scale"] = zeros(B, 1, grp.rank_v, dtype=torch.float32)
                if self._mixed4:
                    kw["v_us4"] = zeros(B, S, (grp.rank_v - r8) // 2, dtype=torch.int8)
            else:
                for l in grp.layers:
                    dense_v[l] = zeros(B, hkv, S, v_width)
            groups.append(GroupFactors(**kw))
        for l in range(cfg.num_layers):
            if l not in covered:
                dense_k[l] = zeros(B, hkv, S, hd)
                dense_v[l] = zeros(B, hkv, S, v_width)
        tail_k, tail_v = init_tail(cfg, B, self.tail_max, self.cache_dtype, dev)
        return XKVCache(groups=tuple(groups), dense_k=dense_k, dense_v=dense_v,
                        tail_k=tail_k, tail_v=tail_v, tail_len=empty_tail_len(dev))

    # ------------------------------------------------------------ admission
    def _compress_kvs(self, kvs, bucket: int, true_len: int) -> XKVCache:
        """Zero the padded rows and compress into a batch-1 cache. The
        valid rows attend only among themselves (causal), so their K/V
        and logits are exact; zero rows cost the SVD no rank and decode
        masks them by the slot's prefill_len."""
        mask = (torch.arange(bucket, device=self.device) < true_len)[None, None, :, None]
        kvs = [(k * mask, v * mask) for k, v in kvs]
        cos_p, sin_p = (None, None) if self._mla else (x[:bucket] for x in self._cos_sin)
        if self.xkv is None:
            return build_uncompressed_cache(kvs, self.shard_cfg, cos_p, sin_p, 1,
                                            cache_dtype=self.cache_dtype)
        return build_cache(
            kvs, self.xkv, self.shard_cfg, cos_p, sin_p, 1, factor_dtype=self.factor_dtype,
            cache_dtype=self.cache_dtype,
            sparse_block=self.sparse_block if self.sparse_topk is not None else None,
            valid_len=true_len, **self._mesh_kw)

    def _pick_bucket(self, s: int) -> int:
        bucket = next((b for b in self.prefill_buckets if b >= s), None)
        if bucket is None:
            raise ValueError(f"prompt length {s} exceeds s_max={self.s_max}")
        return bucket

    def _prefill_one(self, tokens: np.ndarray):
        """Monolithic prefill + compression at the prompt's bucket; the
        logits of the last valid position only."""
        s = tokens.shape[-1]
        bucket = self._pick_bucket(s)
        padded = torch.zeros((1, bucket), dtype=torch.long, device=self.device)
        padded[0, :s] = torch.as_tensor(tokens, device=self.device)
        logits, kvs = self._model.prefill(self.params, self.shard_cfg, padded,
                                          logits_position=s - 1, **self._mesh_kw)
        cache1 = self._compress_kvs(kvs, bucket, s)
        return cache1, int(logits[0, 0].argmax()), s

    def _start_admission(self, req: Request, slot: int) -> None:
        s = int(req.tokens.shape[-1])
        bucket = self._pick_bucket(s)
        self._admitting = dict(req=req, slot=slot, bucket=bucket, s=s, ci=0)
        if not self._owns(slot):
            return
        cfg = self.shard_cfg
        L, dt = cfg.num_layers, self.params["embed"].dtype
        if self._mla:
            # K scratch: the RoPE-free latent; V scratch: the rotated k_pe.
            k_shape = (L, 1, 1, bucket, cfg.kv_lora_rank)
            v_shape = (L, 1, 1, bucket, cfg.qk_rope_head_dim)
        else:
            k_shape = v_shape = (L, 1, cfg.num_kv_heads, bucket, cfg.head_dim)
        self._admitting.update(
            scratch_k=torch.zeros(k_shape, dtype=dt, device=self.device),
            scratch_v=torch.zeros(v_shape, dtype=dt, device=self.device))

    def _advance_admission(self) -> None:
        """Run ONE prefill chunk (on the data row that holds the slot);
        after the last, compress and insert."""
        a = self._admitting
        C = self.prefill_chunk
        pos0 = a["ci"] * C
        s, bucket = a["s"], a["bucket"]
        final = pos0 + C >= s
        a["ci"] += 1
        if not self._owns(a["slot"]):
            if final:
                self._admitting = None
                self._admit_all([(a["slot"], a["req"], None)])
            return
        valid = min(C, s - pos0)
        chunk = torch.zeros((1, C), dtype=torch.long, device=self.device)
        chunk[0, :valid] = torch.as_tensor(a["req"].tokens[pos0:pos0 + valid],
                                           device=self.device)
        cos_s, sin_s = (x[:bucket] for x in self._cos_sin)
        logits, _, _ = self._model.prefill_chunk(
            self.params, self.shard_cfg, chunk, a["scratch_k"], a["scratch_v"], pos0, cos_s,
            sin_s, valid - 1 if final else C - 1, **self._mesh_kw)
        if final:
            self._finish_admission(logits)

    def _finish_admission(self, logits: torch.Tensor) -> None:
        a, self._admitting = self._admitting, None

        def admit():
            kvs = [(a["scratch_k"][l], a["scratch_v"][l]) for l in range(self.cfg.num_layers)]
            return self._compress_kvs(kvs, a["bucket"], a["s"]), int(logits[0, 0].argmax())

        self._admit_all([(a["slot"], a["req"], admit)])

    # ---------------------------------------------------------- mesh layout
    def _owns(self, slot: int) -> bool:
        """Whether this rank's data row holds ``slot`` (always on one
        device)."""
        return self._lo <= slot < self._lo + self.local_slots

    def _local(self, slot: int) -> int:
        """``slot``'s index in this rank's slot cache."""
        return slot - self._lo

    def _rows(self, arr: np.ndarray) -> torch.Tensor:
        """This rank's slots of a host (num_slots,) array, on the device."""
        return torch.as_tensor(arr[self._lo:self._lo + self.local_slots], dtype=torch.long,
                               device=self.device)

    def _admit_all(self, plan) -> None:
        """Admit each (slot, request, admit) of ``plan`` in order; ``admit()``
        -> (the request's batch-1 cache, its first token). Under a mesh the
        data row that holds a slot admits it, and the first tokens are
        joined over the data axis before the host records any (every rank
        calls this with the same plan)."""
        if self.mesh is None:
            for slot, req, admit in plan:
                cache1, first_token = admit()
                self._place(slot, req, cache1, first_token, int(req.tokens.shape[-1]))
            return
        first = torch.zeros(self.local_slots, dtype=torch.long, device=self.device)
        for slot, req, admit in plan:
            if self._owns(slot):
                cache1, first[self._local(slot)] = admit()
                self._insert(cache1, self._local(slot))
        first = self.mesh.gather_rows(first).tolist()
        for slot, req, _ in plan:
            self._record(slot, req, first[slot], int(req.tokens.shape[-1]))

    def _insert(self, cache1: XKVCache, slot: int) -> None:
        """Write one admitted sequence's cache into its slot IN PLACE
        (JAX ``_insert_impl``): every field of the slot zeroed, then
        filled from the bucket-sized cache; the slot's tail zeroed. A
        compact SLERP side's rows are zero past the bucket; its budget is
        filled up by repeating entry 0 of ``keep_idx`` and ``keep_rows``
        (zeros would pair row 0 with a zero row, and the rebuild's scatter
        would blank it; a repeated index writes equal rows)."""
        bc = self.batch_cache
        for gd, gs in zip(bc.groups, cache1.groups):
            for name, dst in vars(gd).items():
                if isinstance(dst, SlerpCompact):
                    src = getattr(gs, name)
                    pad = dst.keep_idx.shape[2] - src.keep_idx.shape[2]
                    put_slot(dst.base, slot, src.base)
                    put_slot(dst.norms, slot, src.norms)
                    for d, x in ((dst.keep_idx, src.keep_idx), (dst.keep_rows, src.keep_rows)):
                        d[slot].copy_(torch.cat([x[0], x[0, :, :1].expand(
                            -1, pad, *x.shape[3:])], dim=1))
                elif dst is not None:
                    put_slot(dst, slot, getattr(gs, name))
        for dense, src in ((bc.dense_k, cache1.dense_k), (bc.dense_v, cache1.dense_v)):
            for l, dst in dense.items():
                put_slot(dst, slot, src[l])
        bc.tail_k[:, slot].zero_()
        bc.tail_v[:, slot].zero_()

    def _place(self, slot: int, req: Request, cache1: XKVCache, first_token: int,
               s: int) -> None:
        self._insert(cache1, slot)
        self._record(slot, req, first_token, s)

    def _record(self, slot: int, req: Request, first_token: int, s: int) -> None:
        """The host's record of an admitted request."""
        req.generated.append(first_token)
        self.slot_request[slot] = req
        self.prefill_len[slot] = s
        self.tail_len[slot] = 0
        self.pos[slot] = s
        self.token[slot] = first_token
        self._maybe_finish(slot)

    # ------------------------------------------------------------ stepping
    def step_logits(self, token, pos, prefill_len, tail_len,
                    step_kw: Optional[dict] = None) -> torch.Tensor:
        """One decode step of every slot on (B,) device tensors (the body
        ``BatchedStep`` runs and captures), with the decode options
        ``step_kw`` (default the plain step's; ``draft_kw`` a draft's, {}
        exact); ``token`` (B, ql) runs a multi-token pass. Each slot's tail
        is written in place. Returns logits (B, V), or (B, ql, V), fp32."""
        logits, _ = self._model.decode_step_batched(
            self.params, self.shard_cfg, self.xkv, self.batch_cache, token, pos, prefill_len,
            tail_len, self._cos_sin, **(self._step_kw if step_kw is None else step_kw),
            **self._mesh_kw)
        return logits

    def _refactor(self, slot: int, plen: int) -> None:
        """Fold ``slot``'s full tail into its factors (under a mesh, on the
        data row that holds it)."""
        if not self._owns(slot):
            return
        refactorize_slot_cache(
            self.batch_cache, self.xkv, self.shard_cfg, self._local(slot), plen,
            sparse_block=self.sparse_block if self.sparse_topk is not None else None,
            **self._mesh_kw)

    def _mesh_step(self) -> np.ndarray:
        """One eager decode step of this rank's slots; every slot's tokens
        (num_slots,), joined over the data axis, on the host."""
        logits = self.step_logits(self._rows(self.token), self._rows(self.pos),
                                  self._rows(self.prefill_len), self._rows(self.tail_len))
        return self.mesh.gather_rows(logits.argmax(dim=-1)).cpu().numpy()

    def _mesh_round(self):
        """One eager speculative round of this rank's slots
        (``BatchedSpecRound``'s draft and verify steps); every slot's (n_out
        (num_slots,), the verify's tokens (num_slots, k + 1)), joined over
        the data axis, on the host."""
        token, pos, plen, tail = (self._rows(a) for a in (self.token, self.pos,
                                                          self.prefill_len, self.tail_len))
        tok, p, t, drafts = token, pos, tail, []
        for _ in range(self.speculative_k):
            tok = self.step_logits(tok, p, plen, t, self.draft_kw).argmax(dim=-1)
            drafts.append(tok)
            p, t = p + 1, t + 1
        drafts = torch.stack(drafts, dim=1)
        inputs = torch.cat([token[:, None], drafts], dim=1)
        exact = self.step_logits(inputs, pos, plen, tail, {}).argmax(dim=-1)
        n_acc = (drafts == exact[:, :-1]).long().cumprod(dim=1).sum(dim=1)
        res = self.mesh.gather_rows(torch.cat([(n_acc + 1)[:, None], exact], dim=1))
        res = res.cpu().numpy()
        return res[:, 0], res[:, 1:]

    # ------------------------------------------------------------ public API
    def submit(self, tokens, max_new_tokens: int) -> int:
        req = Request(self._next_id, np.asarray(tokens, np.int32).reshape(-1), max_new_tokens)
        self._next_id += 1
        self.queue.append(req)
        return req.request_id

    def _free_slots(self) -> List[int]:
        return [i for i in range(self.num_slots) if i not in self.slot_request]

    def _admit(self) -> None:
        if self.prefill_chunk is not None:
            if self._admitting is None and self.queue and self._free_slots():
                self._start_admission(self.queue.pop(0), self._free_slots()[0])
            if self._admitting is not None:
                self._advance_admission()
            return
        plan = []
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.pop(0)
            plan.append((slot, req, lambda req=req: self._prefill_one(req.tokens)[:2]))
        self._admit_all(plan)

    def _maybe_finish(self, slot: int) -> None:
        req = self.slot_request.get(slot)
        if req is None:
            return
        if (len(req.generated) >= req.max_new_tokens
                or (self.eos_token_id is not None and req.generated[-1] == self.eos_token_id)):
            req.done = True
            del self.slot_request[slot]
            self._finished.append(req)

    def _handle_full_tail(self, slot: int) -> None:
        """A slot whose tail filled folds it into its factors in place
        (generation goes on until the slot's s_max rows are used) or, when
        that is impossible, finishes early."""
        if slot not in self.slot_request or self.tail_len[slot] < self.tail_max:
            return
        plen = int(self.prefill_len[slot])
        if self._can_refactor and plen + self.tail_max <= self.s_max:
            self._refactor(slot, plen)
            self.prefill_len[slot] = plen + self.tail_max
            self.tail_len[slot] = 0
        else:
            req = self.slot_request.pop(slot)
            req.done = True
            self._tail_capacity_finished.append(req)

    def _spec_blocked(self) -> bool:
        """True when an active slot lacks the tail rows of a round (k
        drafts and 1); the step is then a plain one, until that tail fills
        and folds."""
        need = self.speculative_k + 1
        return any(self.tail_len[slot] + need > self.tail_max for slot in self.slot_request)

    def _spec_round(self) -> None:
        """One batched speculative round: every active slot advances by its
        own acceptance, 1 to k + 1 tokens, cut at EOS or
        ``max_new_tokens``."""
        g = self.spec_graph
        if g is None:
            n_out, exact = self._mesh_round()
        else:
            g.load(self.token, self.pos, self.prefill_len, self.tail_len)
            n_out, exact = g.run()
        self.spec_stats["rounds"] += 1
        emitted = 0
        for slot, req in list(self.slot_request.items()):
            n = int(n_out[slot])
            self.spec_stats["round_tokens"] += n
            # The tail rows [t0, t0 + n) are the slot's history now, also
            # where EOS cuts the emitted tokens below (the slot then frees).
            self.tail_len[slot] += n
            self.pos[slot] += n
            for tok in exact[slot, :n]:
                req.generated.append(int(tok))
                self.token[slot] = int(tok)
                emitted += 1
                self._maybe_finish(slot)
                if req.done:
                    break
            if not req.done:
                self._handle_full_tail(slot)
        if g is not None:
            g.timing.emitted.append(emitted)

    @torch.no_grad()
    def step(self) -> List[Request]:
        """Admit queued requests (or one admission chunk), run one decode
        step of every slot, or one speculative round, return the requests
        that finished. Emitted tokens are exact greedy decoding's either
        way. A request that finishes at admission (its first token is EOS,
        or ``max_new_tokens`` is 1) is returned too; the JAX engine drops it
        (ROADMAP queue 3)."""
        self._finished = []
        self._tail_capacity_finished = []
        self._admit()
        if self.slot_request and self.speculative_k is not None and not self._spec_blocked():
            self._spec_round()
        elif self.slot_request:
            if self.speculative_k is not None:
                self.spec_stats["plain_steps"] += 1
            if self.step_graph is None:
                next_tok = self._mesh_step()
            else:
                self.step_graph.load(self.token, self.pos, self.prefill_len, self.tail_len)
                next_tok = self.step_graph.run()
            for slot, req in list(self.slot_request.items()):
                self.tail_len[slot] += 1
                self.pos[slot] += 1
                tok = int(next_tok[slot])
                req.generated.append(tok)
                self.token[slot] = tok
                self._maybe_finish(slot)
                if not req.done:
                    self._handle_full_tail(slot)
        return self._finished + self._tail_capacity_finished

    @torch.no_grad()
    def run(self) -> List[Request]:
        """Drain the queue; returns every finished request."""
        done: List[Request] = []
        while self.queue or self.slot_request or self._admitting is not None:
            done.extend(self.step())
        return done
