"""Llama-family decoder (Llama 2/3, Mistral, Qwen2) on the factored cache.

Port of the single-device path of ``xkv_tpu/models/llama.py``.
Parameters are the JAX package's tree as plain dicts of tensors, in its
(in, out) layout: every projection is ``x @ W``.

The xKV contract:
  * prefill attention uses the fresh, locally RoPE'd K, so compression never
    changes prefill outputs;
  * merged groups store pre-RoPE keys ("pre") or keys rotated before the
    SVD ("post"); dense layers store post-RoPE keys;
  * decode attention reads the factored segment (kernel K3 for "pre", K2
    for "post", K6 for mixed int8+int4 factors) and the dense segments and
    tail (plain ops), merged by log-sum-exp;
  * sparse top-k decode (``sparse_select``) reads only the Quest-selected
    chunks of the factored segment (K5 for "pre", K4 for "post").

Prefill attention runs kernel K1 unless the caller passes another
``attention`` (training passes the plain, differentiable one: K1 has no
backward). Each kernel wrapper launches its CUDA kernel for CUDA tensors
and its plain version for CPU tensors.

Tensor parallelism over kv heads (``mesh``, a ``parallel.mesh.Mesh`` with
a model axis; the engine's ``mesh``): the functions run on a rank's
weights (``parallel.sharding.shard_params``) and cache, with ``cfg`` the
rank's share of the heads (``parallel.sharding`` docstring); the kernels
run on the rank's heads as they are given them, the ``wo`` and ``w_down``
products are summed over the model axis (``row_product``), and the logits
of the ``lm_head`` column shards are joined. The decode dispatch follows
the JAX package's pallas path case by case: K2 / K3 / K6 on the rank's kv
heads; sparse top-k post (K4) and pre (K5) select chunks per shard, over
the rank's own heads' bounds (the JAX ``*_tp`` wrappers); sparse x int4
selects over every head (the JAX path's global selection: the per-chunk
bound maxima are joined by a max over the model axis), then each rank
attends over the selected chunks as one device does. Under a data axis
each rank runs its own batch rows; nothing here crosses it.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from xkv_tpu_torch.cache import XKVCache, layer_group_index, vt_layer_slice
from xkv_tpu_torch.compress.quant import (
    QuantizedKFactorsMixed4,
    QuantizedVFactorsMixed4,
    dequantize_k_mixed4,
    dequantize_v_mixed4,
)
from xkv_tpu_torch.compress.slerp import compact_reconstruct
from xkv_tpu_torch.configs import XKVConfig
from xkv_tpu_torch.models.config import ModelConfig
from xkv_tpu_torch.ops.attention import (
    PartialAttention,
    adaptive_hot_chunks,
    blockwise_causal_attention,
    chunk_bound_scores,
    dense_decode_attention_ref,
    merge_partials,
    reconstruct_group_heads,
    select_topk_chunks,
    sparse_rankspace_decode_attention_ref,
    topk_ids,
)
from xkv_tpu_torch.ops.kernels.flash_attention import flash_attention
from xkv_tpu_torch.ops.kernels.lowrank_attention import (
    lowrank_decode_attention,
    sparse_lowrank_decode_attention,
)
from xkv_tpu_torch.ops.kernels.rankspace_attention import (
    rankspace_decode_attention,
    sparse_rankspace_decode_attention,
)
from xkv_tpu_torch.ops.rope import apply_rope, rope_cos_sin

Params = Dict[str, Any]


# ----------------------------------------------------------------- init
def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> Params:
    """Random parameters: normal(0, 0.02) projections and embeddings, unit
    norms. Draws come from ``generator``, which must live on ``device``."""

    def dense(*shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * 0.02).to(dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    d, f = cfg.hidden_size, cfg.intermediate_size
    hq, hkv, hd = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    layers = []
    for _ in range(cfg.num_layers):
        layer = {
            "attn": {"wq": dense(d, hq * hd), "wk": dense(d, hkv * hd),
                     "wv": dense(d, hkv * hd), "wo": dense(hq * hd, d)},
            "mlp": {"w_gate": dense(d, f), "w_up": dense(d, f), "w_down": dense(f, d)},
            "input_norm": ones(d),
            "post_norm": ones(d),
        }
        if cfg.attention_bias:
            for name, n in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
                layer["attn"][name] = torch.zeros((n,), dtype=dtype, device=device)
        layers.append(layer)
    params: Params = {"embed": dense(cfg.vocab_size, d), "layers": layers,
                      "final_norm": ones(d)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(d, cfg.vocab_size)
    return params


# ----------------------------------------------------------------- blocks
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (normed * weight.to(torch.float32)).to(x.dtype)


def row_product(mesh, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, rounded to ``x``'s dtype once. Under a ``mesh`` ``w`` is
    this rank's row block and ``x`` its columns: each rank's partial
    product is taken in fp32 (bf16 products are exact in fp32), the
    partials are summed over the model axis in fp32, and the sum is
    rounded once, as one device's product with fp32 accumulation is."""
    if mesh is None:
        return x @ w
    return mesh.all_reduce(x.float() @ w.float()).to(x.dtype)


def mlp(p: Params, x: torch.Tensor, mesh=None) -> torch.Tensor:
    return row_product(mesh, F.silu(x @ p["w_gate"]) * (x @ p["w_up"]), p["w_down"])


def qkv_proj(
    p: Params, cfg: ModelConfig, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (b, s, d) -> q (b, hq, s, hd), k/v (b, hkv, s, hd) (views)."""
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.num_q_heads, cfg.head_dim).permute(0, 2, 1, 3)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim).permute(0, 2, 1, 3)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim).permute(0, 2, 1, 3)
    return q, k, v


def unembed(params: Params, cfg: ModelConfig, h: torch.Tensor, mesh=None) -> torch.Tensor:
    """fp32 logits; under a ``mesh`` the ``lm_head`` column shards' logits
    joined across the model axis (tied embeddings are replicated)."""
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    w = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    logits = (h @ w).to(torch.float32)
    if mesh is None or cfg.tie_word_embeddings:
        return logits
    return mesh.gather(logits)


# ----------------------------------------------------------------- prefill
def _prefill_layer(
    layer: Params,
    cfg: ModelConfig,
    h: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    scale: float,
    attention: Optional[Callable] = None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decoder layer of the causal prefill. Returns (h', k_pre_rope, v).
    ``attention(q, k, v, scale=, window=)`` -> (b, s, hq, hd): K1 (this
    module's ``flash_attention``, looked up at the call) when None,
    ``ops.attention.plain_prefill_attention`` to differentiate."""
    if attention is None:
        attention = flash_attention
    b, s = h.shape[0], h.shape[1]
    resid = h
    x = rms_norm(h, layer["input_norm"], cfg.rms_norm_eps)
    q, k_pre, v = qkv_proj(layer["attn"], cfg, x)
    q = apply_rope(q, cos, sin).contiguous()
    k = apply_rope(k_pre, cos, sin).contiguous()
    attn = attention(q, k, v.contiguous(), scale=scale, window=cfg.sliding_window)
    h = resid + row_product(mesh, attn.reshape(b, s, -1), layer["attn"]["wo"])
    h = h + mlp(layer["mlp"], rms_norm(h, layer["post_norm"], cfg.rms_norm_eps), mesh)
    return h, k_pre, v


def prefill_layer_span(
    layers: List[Params],
    cfg: ModelConfig,
    h: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    attention: Optional[Callable] = None,
    mesh=None,
) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """A contiguous span of the prefill's decoder layers, entered with the
    activations h (b, s, d): the staged prefill (engine
    ``staged_prefill``) runs one SVD group's span at a time and compresses
    its K/V before the next. Returns (h', [(k_pre_rope, v)] per layer)."""
    scale = 1.0 / math.sqrt(cfg.head_dim)
    kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for layer in layers:
        h, k_pre, v = _prefill_layer(layer, cfg, h, cos, sin, scale, attention, mesh)
        kvs.append((k_pre, v))
    return h, kvs


def prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    logits_position: Optional[int] = None,
    attention: Optional[Callable] = None,
    mesh=None,
    sequence_parallel: bool = False,
) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Causal forward over a prompt. tokens (b, s) -> (logits (b, s, V)
    fp32, or (b, 1, V) at ``logits_position``; [(k_pre_rope, v)] per layer,
    each (b, hkv, s, hd)). ``attention``: as ``_prefill_layer``'s (under a
    ``mesh``, on the rank's heads).

    ``sequence_parallel`` (JAX ``prefill(sequence_parallel=True)``): the
    prompt's rows split over the ``mesh``'s data axis, data rank i running
    rows [i * s / d, (i + 1) * s / d) through every layer at their global
    RoPE positions, attention by ``ops.ring_attention`` over the data axis
    on the rank's heads. The K/V rows and the final activations are joined
    over the data axis in rank order, so every rank returns the whole
    prompt's logits and K/V, as one device does."""
    b, s = tokens.shape
    lo = 0
    if sequence_parallel:
        from xkv_tpu_torch.ops.ring_attention import ring_attention

        if mesh is None:
            raise ValueError("sequence_parallel prefill needs a mesh with a 'data' axis")
        if s % mesh.data:
            raise ValueError(f"data axis size {mesh.data} must divide seq {s}")
        s_local = s // mesh.data
        lo = mesh.data_rank * s_local
        tokens = tokens[:, lo:lo + s_local]

        def attention(q, k, v, scale, window):
            out = ring_attention(q, k, v, mesh=mesh, axis_name="data", scale=scale,
                                 causal=True, window=window)
            return out.transpose(1, 2)

    positions = torch.arange(lo, lo + tokens.shape[1], device=tokens.device)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    h, kvs = prefill_layer_span(params["layers"], cfg, params["embed"][tokens], cos, sin,
                                attention, mesh)
    if sequence_parallel:
        h = mesh.join_rows(h, dim=1)
        kvs = [(mesh.join_rows(k, dim=2), mesh.join_rows(v, dim=2)) for k, v in kvs]
    if logits_position is not None:
        h = h[:, logits_position:logits_position + 1]
    return unembed(params, cfg, h, mesh), kvs


def prefill_chunk(
    params: Params,
    cfg: ModelConfig,
    chunk_tokens: torch.Tensor,
    scratch_k: torch.Tensor,
    scratch_v: torch.Tensor,
    pos0: Union[int, torch.Tensor],
    cos_s: torch.Tensor,
    sin_s: torch.Tensor,
    last_idx: Union[int, torch.Tensor],
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk of a chunked (incremental) prefill (JAX ``prefill_chunk``).

    chunk_tokens (b, C) at absolute positions [pos0, pos0 + C); scratch_k /
    scratch_v (L, b, hkv, S, hd): the pre-RoPE K and V of the rows before
    it, written IN PLACE at pos0 for the chunk; cos_s / sin_s (S, hd): the
    RoPE tables of the scratch rows. Attention is causal over the valid
    rows [0, pos0 + C) (plain ``blockwise_causal_attention``, fresh keys
    rotated locally, as the monolithic prefill), so the chunk's logits and
    K/V equal the monolithic prefill's. ``pos0`` and ``last_idx`` are ints
    (the scratch is then read only up to pos0 + C) or 0-d tensors on the
    device (every row read, those past pos0 + C masked). Under a ``mesh``,
    on the rank's heads (the scratch holds its kv heads). Returns (logits
    (b, 1, V) fp32 at chunk row ``last_idx``, scratch_k, scratch_v)."""
    b, C = chunk_tokens.shape
    hd = cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    rows = torch.arange(C, device=chunk_tokens.device) + pos0
    kv_valid = pos0 + C
    # Rows the attention reads: up to the chunk's end when that is known.
    n_read = kv_valid if isinstance(kv_valid, int) else scratch_k.shape[3]
    cos_c, sin_c = cos_s[rows][None], sin_s[rows][None]
    h = params["embed"][chunk_tokens]
    for li, layer in enumerate(params["layers"]):
        resid = h
        x = rms_norm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k_pre, v = qkv_proj(layer["attn"], cfg, x)
        q = apply_rope(q, cos_c, sin_c)
        scratch_k[li].index_copy_(2, rows, k_pre.to(scratch_k.dtype))
        scratch_v[li].index_copy_(2, rows, v.to(scratch_v.dtype))
        k_all = apply_rope(scratch_k[li, :, :, :n_read].to(k_pre.dtype), cos_s[None, :n_read],
                           sin_s[None, :n_read])
        attn = blockwise_causal_attention(
            q, k_all, scratch_v[li, :, :, :n_read].to(v.dtype), scale,
            window=cfg.sliding_window, q_offset=pos0, kv_valid=kv_valid)
        h = resid + row_product(mesh, attn.permute(0, 2, 1, 3).reshape(b, C, -1),
                                layer["attn"]["wo"])
        h = h + mlp(layer["mlp"], rms_norm(h, layer["post_norm"], cfg.rms_norm_eps), mesh)
    idx = torch.as_tensor(last_idx, device=h.device).reshape(1)
    return unembed(params, cfg, h.index_select(1, idx), mesh), scratch_k, scratch_v


# ----------------------------------------------------------------- decode
def position_tensor(pos: Union[int, torch.Tensor], device: torch.device) -> torch.Tensor:
    """A decode position as a 0-d int64 tensor on ``device``: a tensor as
    it is, an int through a fill (no copy from the host, which would wait
    for the device)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.long)
    return torch.full((), pos, dtype=torch.long, device=device)


def _chunk_count(gf, block: int) -> int:
    """Chunks of the group's stored bounds; they must be ``block`` rows."""
    nc = gf.k_cmin.shape[1]
    if nc != -(-gf.k_us.shape[1] // block):
        raise ValueError("k_cmin chunk count does not match sparse_block")
    return nc


def _post_rope_factored_part(
    q: torch.Tensor,  # (b, hq, ql, hd) POST-RoPE queries
    gf,
    gpos: int,
    cfg: ModelConfig,
    scale: float,
    k_scale_slice: Optional[torch.Tensor],
    win_lo: Optional[torch.Tensor] = None,
    sparse_ok: bool = False,
    sparse_select: Optional[int] = None,
    sparse_block: int = 512,
    sparse_select_max: Optional[int] = None,
    sparse_adaptive_band: float = 0.5,
    lengths: Optional[torch.Tensor] = None,
    mesh=None,
) -> PartialAttention:
    """Attention over a POST-RoPE factored group in rank space: no
    reconstruction and no trig. K2 reads the whole segment, K6 mixed
    int8+int4 factors, K4 the Quest-selected chunks when ``sparse_ok``;
    ``lengths`` (b,) bounds each sequence's valid rows (None: all). Under
    a ``mesh`` sparse x int4 selects over the model's every head."""
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    vt_k = vt_layer_slice(gf.k_vt, gpos, hkv, hd)
    vt_v = vt_layer_slice(gf.v_vt, gpos, hkv, hd)
    if sparse_ok:
        nc = _chunk_count(gf, sparse_block)
        cmin_sl = vt_layer_slice(gf.k_cmin, gpos, hkv, hd)
        cmax_sl = vt_layer_slice(gf.k_cmax, gpos, hkv, hd)
        n_sel = min(sparse_select, nc)
    if gf.k_us4 is not None:
        kw4 = dict(k_us4=gf.k_us4, k_vt4_slice=vt_layer_slice(gf.k_vt4, gpos, hkv, hd),
                   k_scale4_slice=vt_layer_slice(gf.k_scale4, gpos, hkv, hd),
                   v_us4=gf.v_us4)
        if sparse_ok:
            # Sparse x int4: Quest selection, then rank-space attention over
            # the gathered int8 + packed-int4 rows. The JAX package runs this
            # composition as plain XLA on the TPU too (it has no kernel for
            # it), so this is the reference's own path, not a fallback.
            ids = select_topk_chunks(q, cmin_sl, cmax_sl, n_select=n_sel, num_kv_heads=hkv,
                                     valid_len=lengths, block=sparse_block, win_lo=win_lo,
                                     head_max=None if mesh is None else mesh.all_max)
            return sparse_rankspace_decode_attention_ref(
                q, gf.k_us, vt_k, gf.v_us, vt_v, ids, scale, hkv, block=sparse_block,
                k_scale_slice=k_scale_slice, v_rank_scale=gf.v_scale, valid_len=lengths,
                valid_lo=win_lo, **kw4)
        out, lse = rankspace_decode_attention(
            q, gf.k_us, vt_k, gf.v_us, vt_v, lengths, k_scale_slice=k_scale_slice,
            v_rank_scale=gf.v_scale, win_lo=win_lo, scale=scale, num_kv_heads=hkv, **kw4)
        return PartialAttention(out=out, lse=lse)
    if sparse_ok:
        sc, live, sc_raw = chunk_bound_scores(q, cmin_sl, cmax_sl, hkv, valid_len=lengths,
                                              block=sparse_block, win_lo=win_lo)
        n_hi = min(sparse_select_max, nc) if sparse_select_max else n_sel
        ids = topk_ids(sc, max(n_hi, n_sel))
        if n_hi > n_sel:
            # Adaptive budget: the high budget when any sequence's step has
            # more hot chunks than the low one. Decided on the device: the
            # low budget's step passes the same ids with those past n_sel
            # set to -1, which the kernel skips; the first n_sel ids of the
            # stable descending order are the low budget's selection.
            use_hi = (adaptive_hot_chunks(sc_raw, live, band=sparse_adaptive_band)
                      > n_sel).any()
            ids[:, n_sel:] = torch.where(use_hi, ids[:, n_sel:], -1)
        out, lse = sparse_rankspace_decode_attention(
            q, gf.k_us, vt_k, gf.v_us, vt_v, ids, lengths, k_scale_slice=k_scale_slice,
            v_rank_scale=gf.v_scale, win_lo=win_lo, scale=scale, num_kv_heads=hkv,
            block=sparse_block)
        return PartialAttention(out=out, lse=lse)
    out, lse = rankspace_decode_attention(
        q, gf.k_us, vt_k, gf.v_us, vt_v, lengths,
        k_scale_slice=k_scale_slice, v_rank_scale=gf.v_scale, win_lo=win_lo,
        scale=scale, num_kv_heads=hkv,
    )
    return PartialAttention(out=out, lse=lse)


def _dense_prefill_segment(q, gf, gpos, li, cache, cfg, cos_p, sin_p, rope_post):
    """K and V of a layer's prefill segment when the group factors at most
    one side: the factored side is reconstructed, a compact SLERP side
    rebuilt (``compact_reconstruct``; keys stored post-RoPE), the other
    read dense."""
    hkv, hd = cfg.num_kv_heads, cfg.head_dim

    def heads(mat):  # (b, s, hkv*hd) -> (b, hkv, s, hd)
        return mat.reshape(mat.shape[0], mat.shape[1], hkv, hd).permute(0, 2, 1, 3)

    if gf is not None and gf.k_us is not None:
        k_scale = None if gf.k_scale is None else vt_layer_slice(gf.k_scale, gpos, hkv, hd)
        if gf.k_us4 is not None:  # mixed int8 + packed int4: the tail ranks too
            k_rec = heads(dequantize_k_mixed4(QuantizedKFactorsMixed4(
                us8=gf.k_us, us4p=gf.k_us4, vt8=vt_layer_slice(gf.k_vt, gpos, hkv, hd),
                vt4=vt_layer_slice(gf.k_vt4, gpos, hkv, hd), out_scale=k_scale,
                scale4=vt_layer_slice(gf.k_scale4, gpos, hkv, hd))))
        else:
            k_rec = reconstruct_group_heads(
                gf.k_us, vt_layer_slice(gf.k_vt, gpos, hkv, hd), hkv, out_scale=k_scale)
        if not rope_post:
            k_rec = apply_rope(k_rec, cos_p[None], sin_p[None])
        k_prefill = k_rec.to(q.dtype)
    elif gf is not None and gf.slerp_k is not None:
        k_prefill = compact_reconstruct(gf.slerp_k, gpos, q.dtype)
    else:
        k_prefill = cache.dense_k[li]
    if gf is not None and gf.v_us4 is not None:
        v_prefill = heads(dequantize_v_mixed4(QuantizedVFactorsMixed4(
            us8=gf.v_us, us4p=gf.v_us4, rank_scale=gf.v_scale,
            vt=vt_layer_slice(gf.v_vt, gpos, hkv, hd)))).to(q.dtype)
    elif gf is not None and gf.v_us is not None:
        v_prefill = reconstruct_group_heads(
            gf.v_us, vt_layer_slice(gf.v_vt, gpos, hkv, hd), hkv,
            rank_scale=gf.v_scale).to(q.dtype)
    elif gf is not None and gf.slerp_v is not None:
        v_prefill = compact_reconstruct(gf.slerp_v, gpos, q.dtype)
    else:
        v_prefill = cache.dense_v[li]
    return k_prefill, v_prefill


def _factored_part(q_pre, q, cos, sin, gf, gpos, li, cfg, rope_post, cos_p, sin_p, scale,
                   lengths, win_lo, sparse_select=None, sparse_block=512, sparse_layers=None,
                   sparse_select_max=None, sparse_adaptive_band=0.5,
                   mesh=None) -> PartialAttention:
    """Attention over a group's factored prefill segment (both sides
    factored) for one layer: K2/K4/K6 in post mode, K3/K5 in pre mode.
    ``lengths`` (b,): each sequence's valid prefill rows (a slot cache's
    rows past them are padding), None for all; ``win_lo`` (b,): the
    sliding window's lower bound."""
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    ql = q.shape[2]
    k_scale = None if gf.k_scale is None else vt_layer_slice(gf.k_scale, gpos, hkv, hd)
    sparse_ok = (sparse_select is not None and gf.k_cmin is not None and ql == 1
                 and (sparse_layers is None or li in sparse_layers))
    if rope_post:
        return _post_rope_factored_part(
            q, gf, gpos, cfg, scale, k_scale, win_lo, sparse_ok, sparse_select,
            sparse_block, sparse_select_max, sparse_adaptive_band, lengths=lengths, mesh=mesh)
    fargs = (q_pre, gf.k_us, vt_layer_slice(gf.k_vt, gpos, hkv, hd),
             gf.v_us, vt_layer_slice(gf.v_vt, gpos, hkv, hd), cos_p, sin_p, cos, sin)
    kw = dict(lengths=lengths, k_scale_slice=k_scale, v_rank_scale=gf.v_scale, win_lo=win_lo,
              scale=scale, num_kv_heads=hkv)
    if sparse_ok:
        nc = _chunk_count(gf, sparse_block)
        ids = select_topk_chunks(
            q, vt_layer_slice(gf.k_cmin, gpos, hkv, hd), vt_layer_slice(gf.k_cmax, gpos, hkv, hd),
            n_select=min(sparse_select, nc), num_kv_heads=hkv, valid_len=lengths,
            block=sparse_block, win_lo=win_lo)
        return PartialAttention(*sparse_lowrank_decode_attention(
            *fargs, ids, block=sparse_block, **kw))
    return PartialAttention(*lowrank_decode_attention(*fargs, **kw))


def _decode_layers(params, cfg, xkv, cache, tokens, cos, sin, cos_p, sin_p, write_tail,
                   tail_valid, lengths=None, win_lo=None, tail_lo=None, mesh=None,
                   **sparse_kw) -> torch.Tensor:
    """The decoder layers of a decode step, shared by ``decode_step`` and
    ``decode_step_batched``: tokens (b, ql) at the positions of the
    tables cos/sin (1|b, ql, hd); ``write_tail(li, k, v)`` writes the new
    K (post-RoPE) and V into the tail; query i sees tail rows <
    ``tail_valid[:, i]``; ``lengths``/``win_lo``/``tail_lo`` (b,) bound the
    prefill segment and the tail per sequence. Returns logits (b, ql, V)."""
    b, ql = tokens.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    grp_index = layer_group_index(xkv) if xkv is not None else {}
    rope_post = xkv is not None and xkv.rope_mode == "post"
    h = params["embed"][tokens]
    for li, layer in enumerate(params["layers"]):
        resid = h
        x = rms_norm(h, layer["input_norm"], cfg.rms_norm_eps)
        q_pre, k_new_pre, v_new = qkv_proj(layer["attn"], cfg, x)
        q = apply_rope(q_pre, cos, sin)
        write_tail(li, apply_rope(k_new_pre, cos, sin), v_new)

        gf = gpos = None
        if li in grp_index:
            gi, gpos = grp_index[li]
            gf = cache.groups[gi]
        if gf is not None and gf.k_us is not None and gf.v_us is not None:
            prefill_part = _factored_part(q_pre, q, cos, sin, gf, gpos, li, cfg, rope_post,
                                          cos_p, sin_p, scale, lengths, win_lo, mesh=mesh,
                                          **sparse_kw)
        else:
            k_prefill, v_prefill = _dense_prefill_segment(
                q, gf, gpos, li, cache, cfg, cos_p, sin_p, rope_post)
            prefill_part = dense_decode_attention_ref(
                q, k_prefill, v_prefill, scale, valid_len=lengths, valid_lo=win_lo)
        # Decode tail, this step's token(s) included; causal within the
        # new rows: query i sees tail rows < tail_len + i + 1.
        tail_part = dense_decode_attention_ref(
            q, cache.tail_k[li], cache.tail_v[li], scale, valid_len=tail_valid,
            valid_lo=tail_lo)

        attn = merge_partials(prefill_part, tail_part).to(h.dtype)
        attn = attn.permute(0, 2, 1, 3).reshape(b, ql, -1)
        h = resid + row_product(mesh, attn, layer["attn"]["wo"])
        h = h + mlp(layer["mlp"], rms_norm(h, layer["post_norm"], cfg.rms_norm_eps), mesh)
    return unembed(params, cfg, h, mesh)


def decode_step(
    params: Params,
    cfg: ModelConfig,
    xkv: Optional[XKVConfig],
    cache: XKVCache,
    tokens: torch.Tensor,
    pos: Union[int, torch.Tensor],
    prefill_cos_sin: Tuple[torch.Tensor, torch.Tensor],
    sparse_select: Optional[int] = None,
    sparse_block: int = 512,
    sparse_layers: Optional[frozenset] = None,
    sparse_select_max: Optional[int] = None,
    sparse_adaptive_band: float = 0.5,
    mesh=None,
) -> Tuple[torch.Tensor, XKVCache]:
    """One decode step over the hybrid factored cache (a rank's shard of it
    under a ``mesh``).

    tokens: (b, ql) next token(s); pos: absolute position of tokens[:, 0],
    an int or a 0-d tensor on the device (the step then reads no value on
    the host, and a CUDA graph can capture it); prefill_cos_sin: (s_p, hd)
    RoPE tables of the prefill positions. The tail is written in place.
    Returns (logits (b, ql, V) fp32, cache).

    ``sparse_select``: attend to that many ``sparse_block``-row chunks of
    each factored segment (Quest selection over the stored chunk bounds),
    in the layers of ``sparse_layers`` (all when None; the others read the
    factored cache exactly). ``sparse_select_max``: in post mode, the
    budget of steps whose hot-chunk count (``adaptive_hot_chunks`` with
    ``sparse_adaptive_band``) exceeds ``sparse_select``.
    """
    b, ql = tokens.shape
    dev = tokens.device
    hd = cfg.head_dim
    pos = position_tensor(pos, dev)
    positions = (pos + torch.arange(ql, device=dev))[None, :]
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta, cfg.rope_scaling)

    # Sliding window: keys at positions > pos - window are live; tail row j
    # sits at absolute position prefill_len + j.
    win_lo = tail_lo = None
    if cfg.sliding_window is not None:
        if ql > 1:
            raise ValueError("multi-token decode with sliding_window is not supported")
        lo = (pos - (cfg.sliding_window - 1)).clamp_min(0)
        win_lo = lo.to(torch.int32).repeat(b)
        tail_lo = (lo - cache.prefill_len).clamp_min(0).to(torch.int32).repeat(b)
    tail_valid = (cache.tail_len + 1 + torch.arange(ql, dtype=torch.int32, device=dev))
    tail_valid = tail_valid[None, :].expand(b, ql)
    logits = _decode_layers(
        params, cfg, xkv, cache, tokens, cos, sin, *prefill_cos_sin, cache.append_tail,
        tail_valid, win_lo=win_lo, tail_lo=tail_lo, sparse_select=sparse_select,
        sparse_block=sparse_block, sparse_layers=sparse_layers,
        sparse_select_max=sparse_select_max, sparse_adaptive_band=sparse_adaptive_band,
        mesh=mesh)
    return logits, cache.advance(ql)


def decode_step_batched(
    params: Params,
    cfg: ModelConfig,
    xkv: Optional[XKVConfig],
    cache: XKVCache,
    tokens: torch.Tensor,
    pos: torch.Tensor,
    prefill_len: torch.Tensor,
    tail_len: torch.Tensor,
    prefill_cos_sin: Tuple[torch.Tensor, torch.Tensor],
    sparse_select: Optional[int] = None,
    sparse_block: int = 512,
    sparse_layers: Optional[frozenset] = None,
    mesh=None,
) -> Tuple[torch.Tensor, XKVCache]:
    """One decode step across B independent slots (continuous batching;
    JAX ``decode_step_batched``); under a ``mesh``, a rank's heads of its
    slots, as ``decode_step``.

    tokens: (B,) one token per slot, or (B, ql) a multi-token pass (the
    batched speculative verify: ``ql`` exact K/V rows appended at each
    slot's ``tail_len``, causal among themselves; sparse selection is
    single-token, so such a pass reads the factors exactly). pos,
    prefill_len, tail_len: (B,) tensors on the device, each slot's
    position of tokens[:, 0], valid prefill rows of the s_max-row slot
    cache and tail fill; the step reads no value on the host, so a CUDA
    graph can capture it. prefill_cos_sin: (s_max, hd) RoPE tables of the
    slot rows. The per-layer dispatch is ``decode_step``'s, with
    ``lengths=prefill_len``; a slot with prefill_len 0 (never admitted)
    has no live prefill key, and its logits are ignored by the caller.
    Each slot's tail is written in place. Returns (logits (B, V), or
    (B, ql, V) for 2-D tokens, fp32; cache)."""
    multi = tokens.dim() == 2
    tokens2 = tokens if multi else tokens[:, None]
    ql = tokens2.shape[1]
    dev = tokens2.device
    positions = pos.long()[:, None] + torch.arange(ql, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    win_lo = tail_lo = None
    if cfg.sliding_window is not None:
        if ql > 1:
            raise ValueError("multi-token decode with sliding_window is not supported")
        win_lo = (pos.long() - (cfg.sliding_window - 1)).clamp_min(0).to(torch.int32)
        tail_lo = (win_lo - prefill_len).clamp_min(0).to(torch.int32)
    tail_valid = tail_len.long()[:, None] + 1 + torch.arange(ql, device=dev)[None, :]
    logits = _decode_layers(
        params, cfg, xkv, cache, tokens2, cos, sin, *prefill_cos_sin,
        lambda li, k, v: cache.append_slot_tails(li, k, v, tail_len), tail_valid,
        lengths=prefill_len, win_lo=win_lo, tail_lo=tail_lo, sparse_select=sparse_select,
        sparse_block=sparse_block, sparse_layers=sparse_layers, mesh=mesh)
    return (logits if multi else logits[:, 0]), cache
