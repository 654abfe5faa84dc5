"""Pipeline parallelism: stage-sharded layers, microbatched (GPipe).

Port of ``xkv_tpu/parallel/pipeline.py``: the stages are the ranks of a
pipe mesh (``make_pipe_mesh``, one process a stage over the default
``torch.distributed`` group), stage p holding the p-th of P contiguous
blocks of the decoder layers (``stage_params``) and, for decode, its
groups' factors and its layers' tail rows (``stage_cache``):

  * the batch is split into M microbatches; at tick t stage p works on
    microbatch t - p; stage 0 injects microbatch t, each stage's output
    goes to the next stage (``PipeMesh.shift``, the JAX ``ppermute``), and
    after P + M - 1 ticks the last stage has produced every microbatch,
    which reaches every rank (a broadcast; JAX: a ``psum`` after zeroing);
  * a bubble tick (t - p outside [0, M)) computes nothing, sends nothing
    and writes no tail row (the JAX scan computes garbage there and keeps
    none of it);
  * the embedding and the unembedding run on every rank.

``pipelined_forward``: the causal prefill forward, each layer the port's
``llama._prefill_layer`` (K1 on the card, its plain version on the CPU).
``pipelined_decode_step``: one decode step of the rope_mode="post"
factored cache, each layer's factored segment by K2 (bf16 and int8
factors, as ``llama.decode_step`` runs it) and its tail by the plain dense
decode attention, merged by log-sum-exp; the layouts the JAX function
refuses it refuses, with its messages (``_check_uniform_groups``: this is
a direct-call API, not routed by the engine).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from xkv_tpu_torch.cache import GroupFactors, XKVCache
from xkv_tpu_torch.models import llama
from xkv_tpu_torch.models.config import ModelConfig
from xkv_tpu_torch.ops.attention import dense_decode_attention_ref, merge_partials
from xkv_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from xkv_tpu_torch.parallel.mesh import _world, exchange

PIPE_AXIS = "pipe"


@dataclass(frozen=True)
class PipeMesh:
    """The stages of a pipeline: global ranks 0 .. stages - 1 of the
    default group, stage p at rank p."""

    stages: int
    rank: int

    @property
    def shape(self) -> Dict[str, int]:
        return {PIPE_AXIS: self.stages}

    @property
    def stage(self) -> int:
        return self.rank

    def shift(self, tensors: Sequence[torch.Tensor], send: bool, receive: bool
              ) -> List[torch.Tensor]:
        """The JAX ``ppermute`` with perm ``(j, j + 1)`` along the pipe, on
        the ticks that carry a microbatch: with ``send`` each tensor goes to
        the next stage (not past the last), with ``receive`` the previous
        stage's arrive in their place (not before the first); else the
        tensors are returned. The two sides of a link must agree."""
        sends = ([(t, self.rank + 1) for t in tensors]
                 if send and self.stage < self.stages - 1 else [])
        recvs = ([(t, self.rank - 1) for t in tensors]
                 if receive and self.stage > 0 else [])
        if not sends and not recvs:
            return list(tensors)
        got = exchange(sends, recvs)
        return got if recvs else list(tensors)

    def from_last(self, x: torch.Tensor) -> torch.Tensor:
        """The last stage's ``x`` on every stage, in place."""
        if self.stages > 1:
            dist.broadcast(x, src=self.stages - 1)
        return x


def make_pipe_mesh(stages: Optional[int] = None) -> PipeMesh:
    """The pipe mesh over the default process group, a stage a rank
    (``stages`` defaults to the world size, and must equal it)."""
    n, rank = _world()
    stages = n if stages is None else stages
    if stages != n:
        raise ValueError(f"{stages} pipeline stages over {n} ranks: one stage a rank")
    return PipeMesh(stages=stages, rank=rank)


def stack_layer_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """[per-layer dict] -> dict of stacked (L, ...) tensors."""

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack(xs, dim=0)

    return stack(*params["layers"])


def _stage_span(cfg: ModelConfig, mesh: PipeMesh) -> range:
    lp = cfg.num_layers // mesh.stages
    return range(mesh.stage * lp, (mesh.stage + 1) * lp)


def stage_params(params: Dict[str, Any], cfg: ModelConfig, mesh: PipeMesh) -> Dict[str, Any]:
    """This stage's weights: its layers, and the embedding, final norm and
    head that every stage runs."""
    if cfg.num_layers % mesh.stages:
        raise ValueError(f"{cfg.num_layers} layers must divide {mesh.stages} stages")
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = _stage_layers(params, cfg, mesh)
    return out


def _stage_layers(params, cfg: ModelConfig, mesh: PipeMesh) -> list:
    """The stage's layers of ``params``: all L layers given (then sliced),
    or the stage's L / P."""
    layers, span = params["layers"], _stage_span(cfg, mesh)
    if len(layers) == cfg.num_layers:
        return [layers[l] for l in span]
    if len(layers) == len(span):
        return list(layers)
    raise ValueError(f"{len(layers)} layers: give all {cfg.num_layers} or the stage's "
                     f"{len(span)}")


def _schedule(mesh: PipeMesh, M: int, work, recv_like: torch.Tensor):
    """The GPipe ticks: at tick t this stage runs ``work(j, h)`` on
    microbatch j = t - p (h: its input from the previous stage, None on
    stage 0) and sends the result on; returns the last stage's results by
    microbatch (a list of M, None elsewhere)."""
    P, p = mesh.stages, mesh.stage
    outputs: List[Optional[torch.Tensor]] = [None] * M
    incoming = worked = None
    for t in range(P + M - 1):
        j = t - p
        valid = 0 <= j < M
        if valid:
            worked = work(j, incoming)
            if p == P - 1:
                outputs[j] = worked
        # The previous stage sends at this tick what this one works on next.
        receive = 0 <= t + 1 - p < M
        got = mesh.shift([worked if valid else recv_like], send=valid, receive=receive)
        if receive and p > 0:
            incoming = got[0]
    return outputs


def _join_last(mesh: PipeMesh, outputs, like: torch.Tensor) -> torch.Tensor:
    """The last stage's (M, ...) results on every stage."""
    out = (torch.stack(outputs) if mesh.stage == mesh.stages - 1
           else torch.empty((len(outputs), *like.shape), dtype=like.dtype, device=like.device))
    return mesh.from_last(out.contiguous())


def pipelined_forward(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (b, s)
    mesh: PipeMesh,
    axis_name: str = PIPE_AXIS,
    num_microbatches: int = 2,
    logits_position: Optional[int] = None,
) -> torch.Tensor:
    """Pipelined decoder forward -> logits (b, s, vocab) fp32 on every
    stage, or (b, 1, vocab) at ``logits_position`` (as ``llama.prefill``).
    ``params``: every layer or the stage's (``stage_params``). Requires
    num_layers % P == 0 and b % num_microbatches == 0."""
    n_stages = mesh.shape[axis_name]
    b, s = tokens.shape
    M = num_microbatches
    if cfg.num_layers % n_stages:
        raise ValueError(f"{cfg.num_layers} layers must divide {n_stages} stages")
    if b % M:
        raise ValueError(f"batch {b} must divide microbatches {M}")
    mb = b // M
    scale = 1.0 / math.sqrt(cfg.head_dim)
    layers = _stage_layers(params, cfg, mesh)
    positions = torch.arange(s, device=tokens.device)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)

    def work(j, h):
        if h is None:  # stage 0 injects microbatch j
            h = params["embed"][tokens[j * mb:(j + 1) * mb]]
        for layer in layers:
            h, _, _ = llama._prefill_layer(layer, cfg, h, cos, sin, scale)
        return h

    like = torch.empty((mb, s, cfg.hidden_size), dtype=params["embed"].dtype,
                       device=tokens.device)
    h = _join_last(mesh, _schedule(mesh, M, work, like), like).reshape(b, s, cfg.hidden_size)
    if logits_position is not None:
        h = h[:, logits_position:logits_position + 1]
    return llama.unembed(params, cfg, h)


# ------------------------------------------------------------- decode PP
def _check_uniform_groups(xkv, cfg: ModelConfig, n_stages: int, cache=None):
    """Decode PP requires the flagship layout: consecutive equal SVD groups
    with both sides merged, rope_mode='post' (rank-space decode — no trig
    in the stage body), and group boundaries aligned to stage boundaries.
    A cache carrying mixed-int4 panels, Quest bounds, or compact-slerp
    storage — or a sliding-window model config — would decode with wrong
    logits if allowed through (the JAX function's checks and messages)."""
    if xkv is None or xkv.rope_mode != "post":
        raise ValueError("pipelined_decode_step requires rope_mode='post'")
    if cfg.sliding_window is not None:
        raise ValueError(
            "pipelined_decode_step does not apply the sliding-window mask; "
            "sliding_window configs are unsupported")
    for gi, gf in enumerate(getattr(cache, "groups", ()) or ()):
        for f in ("k_us4", "v_us4", "k_cmin", "slerp_k", "slerp_v"):
            if getattr(gf, f, None) is not None:
                raise ValueError(
                    f"pipelined_decode_step: cache group {gi} has {f} set — "
                    "mixed int8+int4 factors, Quest sparse bounds, and "
                    "compact-slerp storage are unsupported in decode PP")
        if gf.k_us is None or gf.v_us is None:
            raise ValueError(f"pipelined_decode_step: cache group {gi} is not factored on "
                             "both sides (decode PP needs merge_key and merge_value)")
    groups = xkv.layer_groups
    if not groups:
        raise ValueError("no layer groups")
    g = len(groups[0].layers)
    expect = 0
    for grp in groups:
        if list(grp.layers) != list(range(expect, expect + g)):
            raise ValueError(
                "decode PP needs consecutive equal-size groups covering "
                f"all layers (group {grp.layers} at layer {expect})")
        if (grp.rank_k, grp.rank_v) != (groups[0].rank_k, groups[0].rank_v):
            raise ValueError("decode PP needs uniform group ranks")
        expect += g
    if expect != cfg.num_layers:
        raise ValueError("groups must cover every layer")
    if cfg.num_layers % n_stages:
        raise ValueError(f"{cfg.num_layers} layers / {n_stages} stages")
    layers_per_stage = cfg.num_layers // n_stages
    if layers_per_stage % g:
        raise ValueError(
            f"stage size {layers_per_stage} must be a whole number of "
            f"groups (group size {g})")
    return g


def stage_cache(cache: XKVCache, cfg: ModelConfig, xkv, mesh: PipeMesh) -> XKVCache:
    """This stage's part of a whole factored cache: its groups' factors and
    its layers' tail rows (copies, so the whole can be freed); a stage's
    cache as it is."""
    g = _check_uniform_groups(xkv, cfg, mesh.stages, cache)
    span = _stage_span(cfg, mesh)
    if cache.tail_k.shape[0] == len(span):
        return cache
    groups = cache.groups[span.start // g:span.stop // g]
    return dataclasses.replace(
        cache, groups=tuple(groups), dense_k={}, dense_v={},
        tail_k=cache.tail_k[span.start:span.stop].clone(),
        tail_v=cache.tail_v[span.start:span.stop].clone(),
        tail_len=cache.tail_len.clone())


def join_stage_tails(cache: XKVCache, cfg: ModelConfig, mesh: PipeMesh):
    """Every stage's tail rows joined in layer order, (L, b, hkv, t, hd)
    each of K and V, on every stage (an ``all_reduce`` over zero-filled
    wholes): the tail one device's ``decode_step`` writes."""
    span = _stage_span(cfg, mesh)
    out = []
    for x in (cache.tail_k, cache.tail_v):
        full = torch.zeros((cfg.num_layers, *x.shape[1:]), dtype=x.dtype, device=x.device)
        full[span.start:span.stop] = x
        if mesh.stages > 1:
            dist.all_reduce(full)
        out.append(full)
    return tuple(out)


def pipelined_decode_step(
    params: Dict[str, Any],
    cfg: ModelConfig,
    xkv,
    cache: XKVCache,
    tokens: torch.Tensor,  # (b, 1)
    pos,
    mesh: PipeMesh,
    axis_name: str = PIPE_AXIS,
    num_microbatches: Optional[int] = None,
):
    """One decode step through the factored cache, layer-stage-sharded.

    Each stage holds its layers' weights (``params``: every layer or the
    stage's), its groups' factor panels and its layers' tail rows
    (``cache``: the whole cache, of which the stage's part is taken with
    ``stage_cache``, or a stage's cache from an earlier step); only (mb, 1,
    hidden) activations cross stages. The batch is split into M
    microbatches (default min(b, P)) so the stages overlap. ``pos``: the
    position of ``tokens``, an int or a 0-d tensor. Post-RoPE factors,
    bf16 or int8; the layouts ``_check_uniform_groups`` refuses raise
    ValueError.

    Returns (logits (b, 1, V) fp32 on every stage, this stage's cache with
    the tail advanced; ``join_stage_tails`` joins the stages' tails, and
    the stage's cache chains into the next step).
    """
    n_stages = mesh.shape[axis_name]
    g = _check_uniform_groups(xkv, cfg, n_stages, cache=cache)
    b, ql = tokens.shape
    if ql != 1:
        raise ValueError("pipelined_decode_step is single-token")
    M = num_microbatches or min(b, n_stages)
    if b % M:
        raise ValueError(f"batch {b} must divide microbatches {M}")
    mb = b // M
    cache = stage_cache(cache, cfg, xkv, mesh)
    layers = _stage_layers(params, cfg, mesh)
    lo = _stage_span(cfg, mesh).start
    scale = 1.0 / math.sqrt(cfg.head_dim)
    dev = tokens.device
    pos = llama.position_tensor(pos, dev)
    cos, sin = rope_cos_sin(pos.reshape(1, 1), cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    tail_len = cache.tail_len
    valid = (tail_len + 1).to(torch.int32).reshape(1, 1).expand(mb, 1)

    def work(j, h):
        rows = slice(j * mb, (j + 1) * mb)
        if h is None:  # stage 0 injects microbatch j
            h = params["embed"][tokens[rows]]
        for ll, layer in enumerate(layers):
            gf = cache.groups[ll // g]
            gf = GroupFactors(**{k: None if v is None else v[rows] for k, v in vars(gf).items()})
            resid = h
            x = llama.rms_norm(h, layer["input_norm"], cfg.rms_norm_eps)
            q_pre, k_pre, v_new = llama.qkv_proj(layer["attn"], cfg, x)
            q = apply_rope(q_pre, cos, sin)
            # The microbatch's new row, at tail_len of the stage's layer.
            tk, tv = cache.tail_k[ll, rows], cache.tail_v[ll, rows]
            tk.index_copy_(2, tail_len.long().reshape(1), apply_rope(k_pre, cos, sin).to(tk.dtype))
            tv.index_copy_(2, tail_len.long().reshape(1), v_new.to(tv.dtype))
            prefill_part = llama._factored_part(q_pre, q, cos, sin, gf, ll % g, lo + ll, cfg,
                                                True, None, None, scale, None, None)
            tail_part = dense_decode_attention_ref(q, tk, tv, scale, valid_len=valid)
            attn = merge_partials(prefill_part, tail_part).to(h.dtype)
            h = resid + attn.permute(0, 2, 1, 3).reshape(mb, 1, -1) @ layer["attn"]["wo"]
            h = h + llama.mlp(layer["mlp"],
                              llama.rms_norm(h, layer["post_norm"], cfg.rms_norm_eps))
        return h

    like = torch.empty((mb, 1, cfg.hidden_size), dtype=params["embed"].dtype, device=dev)
    h = _join_last(mesh, _schedule(mesh, M, work, like), like)
    logits = llama.unembed(params, cfg, h.reshape(b, 1, cfg.hidden_size))
    return logits, cache.advance(1)
