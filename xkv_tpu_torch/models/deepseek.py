"""DeepSeek-V2 MLA + MoE decoder on the factored latent cache.

Port of the single-device path of ``xkv_tpu/models/deepseek.py``.
Parameters are the JAX package's tree as plain dicts of tensors, in its
(in, out) layout: every projection is ``x @ W``.

  * MLA: optional q-LoRA; ``kv_a_proj`` splits the per-token latent
    (``kv_lora_rank``) from the small RoPE key (``qk_rope_head_dim``). The
    latent goes through the cache's K slot and is group-SVD'd, the RoPE key
    through the V slot uncompressed (``merge_value`` is refused by the
    engine).
  * DeepSeek's interleaved RoPE on q_pe / k_pe (``apply_rope_interleaved``).
  * MoE FFN: softmax top-k routing with ``routed_scaling_factor`` and
    shared experts; dense FFN for the first ``first_k_dense_replace`` layers.

Prefill attention is plain (``blockwise_causal_attention``, q/k 192 wide and
v 128 at DeepSeek-V2-Lite), as in the JAX package, which runs no Pallas
kernel there. Decode uses the absorbed formulation: W_uk folds into the
query, W_uv applies after the probability-weighted latent sum. Over a
factored group with ``k_rnorm`` the latent is never rebuilt: kernel K7 (K8
for mixed int8+int4 factors) computes the rank-space scores and values
over the prefill segment, and the dense tail's latent-space partial is
merged by log-sum-exp. Dense latents (mode none, fake layers, ungrouped
layers, and factored latents saved without ``k_rnorm``, rebuilt first)
take the joint softmax over prefill and tail in plain torch.

Under a ``mesh`` (the engine's; ``cfg`` the rank's share of the q heads)
each rank holds its q heads' columns of ``q_proj`` / ``q_b_proj`` /
``kv_b_proj`` and rows of ``o_proj`` (summed over the model axis in fp32,
``llama.row_product``); the latent, its factors and ``k_pe`` are whole on
every rank, and K7 / K8 run on the rank's q heads. The MoE layers run
expert parallelism where the routed experts divide the model axis (JAX
``moe_expert_parallel``): every rank routes every token, computes its own
experts' share with the others' combine weights zero, and the fp32
partials are summed over the model axis; otherwise every rank runs every
expert (JAX ``_mlp``). The shared experts and the dense layers' FFN take
the Megatron split.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from xkv_tpu_torch.cache import XKVCache, layer_group_index
from xkv_tpu_torch.compress.quant import QuantizedKFactors, dequantize_k
from xkv_tpu_torch.configs import XKVConfig
from xkv_tpu_torch.models.config import ModelConfig
from xkv_tpu_torch.models.llama import mlp as _ffn
from xkv_tpu_torch.models.llama import position_tensor, rms_norm, row_product, unembed
from xkv_tpu_torch.ops.attention import (
    NEG_INF,
    PartialAttention,
    blockwise_causal_attention,
    merge_partials,
    topk_ids,
)
from xkv_tpu_torch.ops.kernels.rankspace_attention import mla_rankspace_decode_attention
from xkv_tpu_torch.ops.rope import apply_rope_interleaved, rope_cos_sin

Params = Dict[str, Any]


# ----------------------------------------------------------------- init
def _param_tree(cfg: ModelConfig, dense: Callable, ones: Callable) -> Params:
    """The JAX package's parameter tree, leaves from ``dense(*shape)`` and
    ``ones(n)``."""
    if cfg.model_type != "deepseek_v2":
        raise ValueError("deepseek parameters need model_type='deepseek_v2'")
    d, nh = cfg.hidden_size, cfg.num_q_heads
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim

    def ffn(inter):
        return {"w_gate": dense(d, inter), "w_up": dense(d, inter), "w_down": dense(inter, d)}

    layers = []
    for li in range(cfg.num_layers):
        attn = {
            "kv_a_proj": dense(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
            "kv_a_norm": ones(cfg.kv_lora_rank),
            "kv_b_proj": dense(cfg.kv_lora_rank,
                               nh * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
            "o_proj": dense(nh * cfg.v_head_dim, d),
        }
        if cfg.q_lora_rank:
            attn["q_a_proj"] = dense(d, cfg.q_lora_rank)
            attn["q_a_norm"] = ones(cfg.q_lora_rank)
            attn["q_b_proj"] = dense(cfg.q_lora_rank, nh * qk_dim)
        else:
            attn["q_proj"] = dense(d, nh * qk_dim)
        if cfg.n_routed_experts is not None and li >= cfg.first_k_dense_replace:
            inter = cfg.moe_intermediate_size or cfg.intermediate_size
            e = cfg.n_routed_experts
            mlp = {"router": dense(d, e),
                   "experts": {"w_gate": dense(e, d, inter), "w_up": dense(e, d, inter),
                               "w_down": dense(e, inter, d)}}
            if cfg.n_shared_experts:
                mlp["shared"] = ffn(inter * cfg.n_shared_experts)
        else:
            mlp = ffn(cfg.intermediate_size)
        layers.append({"attn": attn, "mlp": mlp, "input_norm": ones(d), "post_norm": ones(d)})
    return {"embed": dense(cfg.vocab_size, d), "layers": layers, "final_norm": ones(d),
            "lm_head": dense(d, cfg.vocab_size)}


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
    scale: float = 0.02,
) -> Params:
    """Random parameters: normal(0, ``scale``) projections, embeddings and
    experts, unit norms. Draws come from ``generator``, which must live on
    ``device``."""

    def dense(*shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * scale).to(dtype)

    return _param_tree(cfg, dense, lambda n: torch.ones((n,), dtype=dtype, device=device))


def numpy_params(cfg: ModelConfig, seed: int, scale: float = 0.02) -> Params:
    """The same tree in fp32 numpy from ``numpy.random.default_rng(seed)``:
    weights the JAX package and the port can both be given
    (``models/ckpt.py:params_from_numpy``)."""
    rng = np.random.default_rng(seed)
    return _param_tree(cfg, lambda *shape: rng.standard_normal(shape, dtype=np.float32) * scale,
                       lambda n: np.ones((n,), np.float32))


# ----------------------------------------------------------------- blocks
def _moe(p: Params, cfg: ModelConfig, x: torch.Tensor, decode: bool = False,
         mesh=None) -> torch.Tensor:
    """Softmax top-k MoE (DeepSeek-V2 routing): the function of the JAX
    package's dense one-hot dispatch, with each token sent to its own
    ``num_experts_per_tok`` experts only where that reads fewer weights.

    Routing in fp32, ties to the lower expert as ``jax.lax.top_k``; then
    ``norm_topk_prob`` and ``routed_scaling_factor``; the combine weights
    are cast to the activation dtype; the shared experts are added last.
    The routed sum is ``_routed_experts``'s; under a ``mesh`` whose ranks
    each hold a block of the experts (expert parallelism) it runs over the
    rank's experts only and the fp32 partials are summed over the model
    axis.
    """
    b, s, d = x.shape
    n, k = b * s, cfg.num_experts_per_tok
    xf = x.reshape(n, d)
    probs = torch.softmax((xf @ p["router"]).to(torch.float32), dim=-1)
    ids = topk_ids(probs, k).long()  # (n, k)
    topv = probs.gather(-1, ids)
    if cfg.norm_topk_prob:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    topv = (topv * cfg.routed_scaling_factor).to(x.dtype)
    ex = p["experts"]
    n_here = ex["w_gate"].shape[0]
    if n_here == cfg.n_routed_experts:
        out = _routed_experts(ex, xf, ids, topv, decode).to(x.dtype)
    else:
        # Expert parallelism: this rank's experts are [e0, e0 + n_here);
        # the other ranks' pairs are marked -1.
        e0 = mesh.model_rank * n_here
        mine = (ids >= e0) & (ids < e0 + n_here)
        routed = _routed_experts(ex, xf, torch.where(mine, ids - e0, -1), topv, decode,
                                 pairs=mine.reshape(-1).nonzero()[:, 0])
        out = mesh.all_reduce(routed).to(x.dtype)
    out = out.reshape(b, s, d)
    if "shared" in p:
        out = out + _ffn(p["shared"], x, mesh)
    return out


def _routed_experts(ex: Params, xf: torch.Tensor, ids: torch.Tensor, topv: torch.Tensor,
                    decode: bool, pairs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The routed experts' combined output (n, d) fp32 of tokens xf (n, d)
    sent to experts ``ids`` (n, k) of ``ex`` with weights ``topv``.
    ``pairs``: the flat (token, slot) indices of the pairs these experts
    take (the others' ids are -1, their outputs zero); None for all.

    With few pairs, at most as many as experts (a decode step), the
    selected experts' weights are gathered by index and applied as batched
    products: no host sync, and at most the layer's own expert weights are
    copied. Otherwise the pairs are sorted by expert and each expert runs
    one product over its rows; that needs the per-expert row counts on the
    host, one sync per layer (prefill). A ``decode`` step with more pairs
    than experts takes the JAX package's dense form instead: every expert
    over every token, weighted by the one-hot combine. It makes no host
    sync, so a CUDA graph can capture the step, and by then the sorted path
    would read nearly every expert's weights anyway. With ``pairs`` the
    count is read on the host (expert parallelism runs eagerly)."""
    n, k = ids.shape
    d = xf.shape[1]
    n_exp = ex["w_gate"].shape[0]
    flat = ids.reshape(-1)
    n_pairs = n * k if pairs is None else pairs.numel()
    if decode and n_pairs > n_exp:
        combine = torch.zeros((n, n_exp), dtype=xf.dtype, device=xf.device)
        combine.scatter_add_(1, ids.clamp_min(0), torch.where(ids >= 0, topv, 0))
        hid = F.silu(xf @ ex["w_gate"]) * (xf @ ex["w_up"])  # (E, n, inter)
        return torch.einsum("end,ne->nd", (hid @ ex["w_down"]).to(torch.float32),
                            combine.to(torch.float32))
    if pairs is None:
        pairs = torch.arange(n * k, device=xf.device)
    if n_pairs <= n_exp:
        sel = flat[pairs]
        xr = xf[pairs // k][:, None, :]  # (pairs, 1, d)
        hid = F.silu(torch.bmm(xr, ex["w_gate"][sel])) * torch.bmm(xr, ex["w_up"][sel])
        ys, order = torch.bmm(hid, ex["w_down"][sel])[:, 0], pairs
    else:
        # Another rank's pairs sort last, past every expert here.
        order = torch.argsort(torch.where(flat >= 0, flat, n_exp), stable=True)[:n_pairs]
        xs = xf[order // k]
        ys = torch.empty_like(xs)
        start = 0
        for e, c in enumerate(torch.bincount(flat[order], minlength=n_exp).tolist()):
            if c:
                ys[start:start + c] = _ffn({name: w[e] for name, w in ex.items()},
                                           xs[start:start + c])
                start += c
    y = torch.zeros((n * k, d), dtype=xf.dtype, device=xf.device).index_copy_(0, order, ys)
    return (y.reshape(n, k, d).to(torch.float32)
            * topv.to(torch.float32)[..., None]).sum(dim=1)


def _mlp(p: Params, cfg: ModelConfig, x: torch.Tensor, decode: bool = False,
         mesh=None) -> torch.Tensor:
    """FFN or MoE, by the layer's parameters."""
    return _moe(p, cfg, x, decode, mesh) if "router" in p else _ffn(p, x, mesh)


def _q_heads(p: Params, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) -> q_nope (b, nh, s, nope), q_pe (b, nh, s, rope)."""
    b, s, _ = x.shape
    if "q_b_proj" in p:
        q = rms_norm(x @ p["q_a_proj"], p["q_a_norm"], 1e-6) @ p["q_b_proj"]
    else:
        q = x @ p["q_proj"]
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    q = q.reshape(b, s, cfg.num_q_heads, qk_dim).permute(0, 2, 1, 3)
    return q[..., :cfg.qk_nope_head_dim], q[..., cfg.qk_nope_head_dim:]


def _latent_and_kpe(p: Params, cfg: ModelConfig, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) -> latent (b, 1, s, lora), k_pe before RoPE (b, 1, s, rope)."""
    ckv = x @ p["kv_a_proj"]
    return ckv[:, None, :, :cfg.kv_lora_rank], ckv[:, None, :, cfg.kv_lora_rank:]


def _up_project(p: Params, cfg: ModelConfig, latent: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """latent (b, s, lora) -> k_nope (b, nh, s, nope), v (b, nh, s, v_dim)."""
    b, s, _ = latent.shape
    kv = rms_norm(latent, p["kv_a_norm"], 1e-6) @ p["kv_b_proj"]
    kv = kv.reshape(b, s, cfg.num_q_heads, cfg.qk_nope_head_dim + cfg.v_head_dim)
    kv = kv.permute(0, 2, 1, 3)
    return kv[..., :cfg.qk_nope_head_dim], kv[..., cfg.qk_nope_head_dim:]


def _kv_b_split(p: Params, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """kv_b_proj (lora, nh*(nope+v)) -> W_uk (nh, lora, nope), W_uv (nh, lora, v)."""
    w = p["kv_b_proj"].reshape(cfg.kv_lora_rank, cfg.num_q_heads,
                               cfg.qk_nope_head_dim + cfg.v_head_dim).permute(1, 0, 2)
    return w[..., :cfg.qk_nope_head_dim], w[..., cfg.qk_nope_head_dim:]


def softmax_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


# ----------------------------------------------------------------- prefill
def prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    logits_position: Optional[int] = None,
    mesh=None,
) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Causal forward over a prompt. tokens (b, s) -> (logits (b, s, V)
    fp32, or (b, 1, V) at ``logits_position``; per layer the MLA cache
    slots (latent (b, 1, s, lora), rotated k_pe (b, 1, s, rope))). Under a
    ``mesh``, attention over the rank's q heads (module docstring)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_scaling)
    scale = softmax_scale(cfg)
    h = params["embed"][tokens]
    kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for layer in params["layers"]:
        resid = h
        x = rms_norm(h, layer["input_norm"], cfg.rms_norm_eps)
        ap = layer["attn"]
        q_nope, q_pe = _q_heads(ap, cfg, x)
        latent, k_pe_pre = _latent_and_kpe(ap, cfg, x)
        q_pe = apply_rope_interleaved(q_pe, cos, sin)
        k_pe = apply_rope_interleaved(k_pe_pre, cos, sin)
        kvs.append((latent, k_pe))
        # Per-head Q/K (nope | pe, k_pe shared by every head).
        k_nope, v = _up_project(ap, cfg, latent[:, 0])
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        k_full = torch.cat([k_nope, k_pe.expand(-1, k_nope.shape[1], -1, -1)], dim=-1)
        attn = blockwise_causal_attention(q_full, k_full, v, scale).to(h.dtype)
        h = resid + row_product(mesh, attn.permute(0, 2, 1, 3).reshape(b, s, -1), ap["o_proj"])
        h = h + _mlp(layer["mlp"], cfg, rms_norm(h, layer["post_norm"], cfg.rms_norm_eps),
                     mesh=mesh)
    if logits_position is not None:
        h = h[:, logits_position:logits_position + 1]
    return unembed(params, cfg, h, mesh), kvs


def prefill_chunk(
    params: Params,
    cfg: ModelConfig,
    chunk_tokens: torch.Tensor,
    scratch_latent: torch.Tensor,
    scratch_kpe: torch.Tensor,
    pos0: Union[int, torch.Tensor],
    cos_s: torch.Tensor,
    sin_s: torch.Tensor,
    last_idx: Union[int, torch.Tensor],
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk of a chunked MLA prefill (JAX ``prefill_chunk``), with
    ``llama.prefill_chunk``'s contract: the chunk's RoPE-free latent and
    rotated k_pe are written IN PLACE into the scratch (L, b, 1, S, lora)
    and (L, b, 1, S, rope) at pos0, every read row's latent is
    up-projected again, and attention is causal over [0, pos0 + C)
    (plain ``blockwise_causal_attention``). cos_s / sin_s: the
    interleaved-RoPE tables (S, rope). Returns (logits (b, 1, V) fp32 at
    chunk row ``last_idx``, scratch_latent, scratch_kpe). Under a ``mesh``,
    over the rank's q heads and experts (the latent is whole)."""
    b, C = chunk_tokens.shape
    scale = softmax_scale(cfg)
    rows = torch.arange(C, device=chunk_tokens.device) + pos0
    kv_valid = pos0 + C
    n_read = kv_valid if isinstance(kv_valid, int) else scratch_latent.shape[3]
    cos_c, sin_c = cos_s[rows][None], sin_s[rows][None]
    h = params["embed"][chunk_tokens]
    for li, layer in enumerate(params["layers"]):
        resid = h
        x = rms_norm(h, layer["input_norm"], cfg.rms_norm_eps)
        ap = layer["attn"]
        q_nope, q_pe = _q_heads(ap, cfg, x)
        latent, k_pe_pre = _latent_and_kpe(ap, cfg, x)
        q_pe = apply_rope_interleaved(q_pe, cos_c, sin_c)
        k_pe = apply_rope_interleaved(k_pe_pre, cos_c, sin_c)
        scratch_latent[li].index_copy_(2, rows, latent.to(scratch_latent.dtype))
        scratch_kpe[li].index_copy_(2, rows, k_pe.to(scratch_kpe.dtype))
        k_nope, v = _up_project(ap, cfg, scratch_latent[li, :, 0, :n_read].to(latent.dtype))
        k_pe_all = scratch_kpe[li, :, :, :n_read].to(k_pe.dtype)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        k_full = torch.cat([k_nope, k_pe_all.expand(-1, k_nope.shape[1], -1, -1)], dim=-1)
        attn = blockwise_causal_attention(q_full, k_full, v, scale, q_offset=pos0,
                                          kv_valid=kv_valid).to(h.dtype)
        h = resid + row_product(mesh, attn.permute(0, 2, 1, 3).reshape(b, C, -1), ap["o_proj"])
        h = h + _mlp(layer["mlp"], cfg, rms_norm(h, layer["post_norm"], cfg.rms_norm_eps),
                     mesh=mesh)
    idx = torch.as_tensor(last_idx, device=h.device).reshape(1)
    return unembed(params, cfg, h.index_select(1, idx), mesh), scratch_latent, scratch_kpe


# ----------------------------------------------------------------- decode
def _scores(q_abs, q_pe, latent, k_pe, scale) -> torch.Tensor:
    """Absorbed scores (b, nh, ql, s) of q_abs (b, nh, ql, lora) and q_pe
    against latent (b, s, lora) and k_pe (b, s, rope), all fp32."""
    return (q_abs @ latent[:, None].transpose(-1, -2)
            + q_pe @ k_pe[:, None].transpose(-1, -2)) * scale


def _rankspace_part(q_abs, q_pe, gf, gpos, k_pe_p, w, cfg, scale,
                    draft_rank: Optional[int] = None,
                    lengths: Optional[torch.Tensor] = None) -> PartialAttention:
    """Latent-space attention over a factored group's prefill segment, in
    rank space (K7, or K8 for mixed int8+int4 factors): the latent norm's
    row scalar is ``k_rnorm``, its column weight ``w`` (and the int8 column
    scales) fold into the absorbed query and into the output projection.
    ``lengths`` (b,): each sequence's valid prefill rows (a slot cache),
    None for all. ``draft_rank``: K7 attends over only the top
    ``draft_rank`` ranks (of the int8 ones for mixed factors), read in
    place from the factors' own
    rows; the norms stay those of the full-rank latent. The projections in
    and out of rank space keep the full-rank shapes (the query's other
    ranks dropped, t's zero), which the exact step's products have: at 16
    rows x 128 ranks cuBLAS ran the fp32 product at 1.41 ms a V2-Lite step
    (NVIDIA H100 80GB HBM3, 700.00 W), in no kernel above 0.49 ms at 512."""
    cols = slice(gpos * cfg.kv_lora_rank, (gpos + 1) * cfg.kv_lora_rank)
    mixed = gf.k_us4 is not None and draft_rank is None
    w4 = w.to(torch.float32)
    # (rank-space basis of this layer, its column fold) per rank block.
    blocks = [(gf.k_vt[:, :, cols].to(torch.float32),
               w4 if gf.k_scale is None else w4 * gf.k_scale[:, None, :, cols])]
    if mixed:
        blocks.append((gf.k_vt4[:, :, cols].to(torch.float32),
                       w4 * gf.k_scale4[:, None, :, cols]))
    q_emb = torch.cat([torch.einsum("bhql,brl->bhqr", q_abs * fold, vt)
                       for vt, fold in blocks], dim=-1)
    ranks = slice(None, draft_rank)
    t, lse = mla_rankspace_decode_attention(
        q_emb[..., ranks] * scale, q_pe * scale, gf.k_us[..., ranks], k_pe_p,
        gf.k_rnorm[:, gpos], lengths, k_us4=gf.k_us4 if mixed else None)
    if draft_rank is not None:
        t = F.pad(t, (0, q_emb.shape[-1] - t.shape[-1]))
    out, col = 0, 0
    for vt, fold in blocks:
        out = out + torch.einsum("bhqr,brl->bhql", t[..., col:col + vt.shape[1]], vt) * fold
        col += vt.shape[1]
    return PartialAttention(out=out, lse=lse)


def _rebuilt_latent(gf, gpos, cfg, draft_rank: Optional[int] = None) -> torch.Tensor:
    """The legacy reconstruct path (JAX ``decode_step`` for caches
    persisted without ``k_rnorm``): a factored group's latent of the layer
    at ``gpos``, (b, s_p, lora) fp32, ``k_us @ vt`` or the int8
    dequantisation, over the top ``draft_rank`` ranks when given. As in the
    JAX package, mixed int8+int4 factors are rebuilt from their int8 ranks
    alone. Plain torch: the JAX package runs no kernel here."""
    cols = slice(gpos * cfg.kv_lora_rank, (gpos + 1) * cfg.kv_lora_rank)
    k_us, vt = gf.k_us[..., :draft_rank], gf.k_vt[:, :draft_rank, cols]
    if gf.k_scale is not None:
        return dequantize_k(QuantizedKFactors(k_us, vt, gf.k_scale[:, :, cols]))
    return k_us.to(torch.float32) @ vt.to(torch.float32)


def _decode_layers(params, cfg, xkv, cache, tokens, cos, sin, write_tail, t_mask,
                   lengths=None, draft_rank=None, mesh=None) -> torch.Tensor:
    """The decoder layers of an absorbed MLA decode step, shared by
    ``decode_step`` and ``decode_step_batched``: tokens (b, ql) at the
    positions of the interleaved-RoPE tables cos/sin (1|b, ql, rope);
    ``write_tail(li, latent, k_pe)`` writes the new rows into the tail;
    ``t_mask`` (broadcastable to (b, nh, ql, t_max)) marks each query's
    live tail rows; ``lengths`` (b,) each sequence's valid prefill rows
    (None: all). Returns logits (b, ql, V)."""
    b, ql = tokens.shape
    scale = softmax_scale(cfg)
    grp_index = layer_group_index(xkv) if xkv is not None else {}
    h = params["embed"][tokens]
    for li, layer in enumerate(params["layers"]):
        resid = h
        x = rms_norm(h, layer["input_norm"], cfg.rms_norm_eps)
        ap = layer["attn"]
        q_nope, q_pe = _q_heads(ap, cfg, x)
        latent_new, k_pe_pre = _latent_and_kpe(ap, cfg, x)
        q_pe = apply_rope_interleaved(q_pe, cos, sin).to(torch.float32)
        write_tail(li, latent_new, apply_rope_interleaved(k_pe_pre, cos, sin))

        w_uk, w_uv = _kv_b_split(ap, cfg)
        q_abs = torch.einsum("bhqd,hld->bhql", q_nope.to(torch.float32), w_uk.to(torch.float32))
        w = ap["kv_a_norm"]

        def norm_latent(z):
            return rms_norm(z, w, 1e-6).to(torch.float32)

        latent_t = norm_latent(cache.tail_k[li][:, 0])  # (b, t_max, lora)
        k_pe_t = cache.tail_v[li][:, 0].to(torch.float32)
        scores_t = torch.where(t_mask, _scores(q_abs, q_pe, latent_t, k_pe_t, scale), NEG_INF)
        k_pe_p = cache.dense_v[li][:, 0]

        gf = gpos = None
        if li in grp_index:
            gi, gpos = grp_index[li]
            gf = cache.groups[gi]
        if gf is not None and gf.k_us is not None and gf.k_rnorm is not None:
            # The tail as a partial in latent space, merged by log-sum-exp.
            m_t = torch.clamp(scores_t.amax(dim=-1, keepdim=True), min=-1e29)
            e_t = torch.where(t_mask, torch.exp(scores_t - m_t), 0.0)
            l_t = e_t.sum(dim=-1, keepdim=True)
            tail = PartialAttention(
                out=(e_t / torch.clamp(l_t, min=1e-30)) @ latent_t[:, None],
                lse=m_t[..., 0] + torch.log(torch.clamp(l_t[..., 0], min=1e-30)))
            lat_sum = merge_partials(
                _rankspace_part(q_abs, q_pe, gf, gpos, k_pe_p, w, cfg, scale, draft_rank,
                                lengths), tail)
        else:
            # Dense latent: one softmax over prefill and tail. A factored
            # latent saved without k_rnorm is rebuilt first.
            latent_p = norm_latent(cache.dense_k[li][:, 0] if gf is None or gf.k_us is None
                                   else _rebuilt_latent(gf, gpos, cfg, draft_rank))
            scores_p = _scores(q_abs, q_pe, latent_p, k_pe_p.to(torch.float32), scale)
            s_p = latent_p.shape[1]
            if lengths is not None:
                live = torch.arange(s_p, device=lengths.device)[None, :] < lengths[:, None]
                scores_p = torch.where(live[:, None, None, :], scores_p, NEG_INF)
            probs = torch.softmax(torch.cat([scores_p, scores_t], dim=-1), dim=-1)
            lat_sum = probs[..., :s_p] @ latent_p[:, None] + probs[..., s_p:] @ latent_t[:, None]
        attn = torch.einsum("bhql,hlv->bhqv", lat_sum, w_uv.to(torch.float32))
        attn = attn.to(h.dtype).permute(0, 2, 1, 3).reshape(b, ql, -1)
        h = resid + row_product(mesh, attn, ap["o_proj"])
        h = h + _mlp(layer["mlp"], cfg, rms_norm(h, layer["post_norm"], cfg.rms_norm_eps),
                     decode=True, mesh=mesh)
    return unembed(params, cfg, h, mesh)


def decode_step(
    params: Params,
    cfg: ModelConfig,
    xkv: Optional[XKVConfig],
    cache: XKVCache,
    tokens: torch.Tensor,
    pos: Union[int, torch.Tensor],
    draft_rank: Optional[int] = None,
    mesh=None,
) -> Tuple[torch.Tensor, XKVCache]:
    """Absorbed MLA decode over the hybrid latent cache (under a ``mesh``,
    over the rank's q heads).

    tokens: (b, ql) next token(s); pos: absolute position of tokens[:, 0],
    an int or a 0-d tensor on the device (``llama.decode_step``).
    ``ql > 1`` appends ql rows to the tail, causal among themselves (the
    speculative verify pass). The tail is written in place. Returns
    (logits (b, ql, V) fp32, cache). Per layer the nope scores contract
    the query (through W_uk) against the latent, in rank space when the
    group is factored; the pe scores use the dense k_pe slot; the output
    recombines through W_uv, then o_proj.

    ``draft_rank``: the speculative draft's step, over the top
    ``draft_rank`` singular directions of each factored latent (the best
    rank-r approximation, the factors being SVD-ordered; mixed int8+int4
    factors draft on their int8 ranks); the tail and the pe scores stay
    exact.
    """
    b, ql = tokens.shape
    dev = tokens.device
    positions = (position_tensor(pos, dev) + torch.arange(ql, device=dev))[None, :]
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_scaling)
    # Query i sees tail rows < tail_len + i + 1.
    t_mask = (torch.arange(cache.tail_max, device=dev)[None, :]
              < cache.tail_len + 1 + torch.arange(ql, device=dev)[:, None])
    logits = _decode_layers(params, cfg, xkv, cache, tokens, cos, sin, cache.append_tail,
                            t_mask, draft_rank=draft_rank, mesh=mesh)
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
    prefill_cos_sin=None,
    draft_rank: Optional[int] = None,
    mesh=None,
) -> Tuple[torch.Tensor, XKVCache]:
    """Absorbed MLA decode across B independent slots (continuous
    batching; JAX ``decode_step_batched``): per-slot positions, valid
    prefill rows of the s_max-row slot cache (``lengths`` of K7/K8 and of
    the dense latents' mask) and tail fills, each a (B,) tensor on the
    device; no host read, so a CUDA graph can capture the step. 2-D
    ``tokens`` (B, ql) run a multi-token pass per slot (logits (B, ql,
    V); the batched speculative verify). ``draft_rank``: the batched
    speculative draft, over each slot's top ``draft_rank`` ranks of the
    factored latents (``decode_step``). ``prefill_cos_sin`` is unused (the
    latent carries no RoPE); it keeps ``llama``'s signature. Under a
    ``mesh``, a rank's q heads and experts over its slots (``decode_step``).
    Returns (logits (B, V) fp32, cache)."""
    multi = tokens.dim() == 2
    tokens2 = tokens if multi else tokens[:, None]
    ql = tokens2.shape[1]
    dev = tokens2.device
    positions = pos.long()[:, None] + torch.arange(ql, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_scaling)
    t_mask = (torch.arange(cache.tail_max, device=dev)[None, None, :]
              < (tail_len.long()[:, None] + 1 + torch.arange(ql, device=dev)[None, :])[..., None]
              )[:, None]  # (B, 1, ql, t_max)
    logits = _decode_layers(
        params, cfg, xkv, cache, tokens2, cos, sin,
        lambda li, k, v: cache.append_slot_tails(li, k, v, tail_len), t_mask,
        lengths=prefill_len, draft_rank=draft_rank, mesh=mesh)
    return (logits if multi else logits[:, 0]), cache
