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
layers) take the joint softmax over prefill and tail in plain torch.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from xkv_tpu_torch.cache import XKVCache, layer_group_index
from xkv_tpu_torch.configs import XKVConfig
from xkv_tpu_torch.models.config import ModelConfig
from xkv_tpu_torch.models.llama import mlp as _ffn
from xkv_tpu_torch.models.llama import position_tensor, rms_norm, unembed
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
def _moe(p: Params, cfg: ModelConfig, x: torch.Tensor, decode: bool = False) -> torch.Tensor:
    """Softmax top-k MoE (DeepSeek-V2 routing): the function of the JAX
    package's dense one-hot dispatch, with each token sent to its own
    ``num_experts_per_tok`` experts only where that reads fewer weights.

    Routing in fp32, ties to the lower expert as ``jax.lax.top_k``; then
    ``norm_topk_prob`` and ``routed_scaling_factor``; the combine weights
    are cast to the activation dtype; the shared experts are added last.
    With few (token, expert) pairs, at most one per expert (a decode step),
    the selected experts' weights are gathered by index and applied as
    batched products: no host sync, and at most the layer's own expert
    weights are copied. Otherwise the pairs are sorted by expert and each
    expert runs one product over its rows; that needs the per-expert row
    counts on the host, one sync per layer (prefill). A ``decode`` step
    with more pairs than experts takes the JAX package's dense form
    instead: every expert over every token, weighted by the one-hot
    combine. It makes no host sync, so a CUDA graph can capture the step,
    and by then the sorted path would read nearly every expert's weights
    anyway.
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
    flat = ids.reshape(-1)
    if decode and n * k > cfg.n_routed_experts:
        combine = torch.zeros((n, cfg.n_routed_experts), dtype=x.dtype, device=x.device)
        combine.scatter_(1, ids, topv)
        hid = F.silu(xf @ ex["w_gate"]) * (xf @ ex["w_up"])  # (E, n, inter)
        routed = torch.einsum("end,ne->nd", (hid @ ex["w_down"]).to(torch.float32),
                              combine.to(torch.float32))
    else:
        if n * k <= cfg.n_routed_experts:
            xr = xf.repeat_interleave(k, dim=0)[:, None, :]  # (n*k, 1, d)
            hid = F.silu(torch.bmm(xr, ex["w_gate"][flat])) * torch.bmm(xr, ex["w_up"][flat])
            y = torch.bmm(hid, ex["w_down"][flat])[:, 0]  # (n*k, d), (token, slot) order
        else:
            order = torch.argsort(flat, stable=True)
            xs = xf[order // k]
            ys = torch.empty_like(xs)
            start = 0
            for e, c in enumerate(torch.bincount(flat, minlength=cfg.n_routed_experts).tolist()):
                if c:
                    ys[start:start + c] = _ffn({name: w[e] for name, w in ex.items()},
                                               xs[start:start + c])
                    start += c
            y = torch.empty_like(ys).index_copy_(0, order, ys)
        routed = (y.reshape(n, k, d).to(torch.float32)
                  * topv.to(torch.float32)[..., None]).sum(dim=1)
    out = routed.to(x.dtype).reshape(b, s, d)
    if "shared" in p:
        out = out + _ffn(p["shared"], x)
    return out


def _mlp(p: Params, cfg: ModelConfig, x: torch.Tensor, decode: bool = False) -> torch.Tensor:
    """FFN or MoE, by the layer's parameters."""
    return _moe(p, cfg, x, decode) if "router" in p else _ffn(p, x)


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
) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Causal forward over a prompt. tokens (b, s) -> (logits (b, s, V)
    fp32, or (b, 1, V) at ``logits_position``; per layer the MLA cache
    slots (latent (b, 1, s, lora), rotated k_pe (b, 1, s, rope)))."""
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
        h = resid + attn.permute(0, 2, 1, 3).reshape(b, s, -1) @ ap["o_proj"]
        h = h + _mlp(layer["mlp"], cfg, rms_norm(h, layer["post_norm"], cfg.rms_norm_eps))
    if logits_position is not None:
        h = h[:, logits_position:logits_position + 1]
    return unembed(params, cfg, h), kvs


# ----------------------------------------------------------------- decode
def _scores(q_abs, q_pe, latent, k_pe, scale) -> torch.Tensor:
    """Absorbed scores (b, nh, ql, s) of q_abs (b, nh, ql, lora) and q_pe
    against latent (b, s, lora) and k_pe (b, s, rope), all fp32."""
    return (q_abs @ latent[:, None].transpose(-1, -2)
            + q_pe @ k_pe[:, None].transpose(-1, -2)) * scale


def _rankspace_part(q_abs, q_pe, gf, gpos, k_pe_p, w, cfg, scale) -> PartialAttention:
    """Latent-space attention over a factored group's prefill segment, in
    rank space (K7, or K8 for mixed int8+int4 factors): the latent norm's
    row scalar is ``k_rnorm``, its column weight ``w`` (and the int8 column
    scales) fold into the absorbed query and into the output projection."""
    cols = slice(gpos * cfg.kv_lora_rank, (gpos + 1) * cfg.kv_lora_rank)
    w4 = w.to(torch.float32)
    # (rank-space basis of this layer, its column fold) per rank block.
    blocks = [(gf.k_vt[:, :, cols].to(torch.float32),
               w4 if gf.k_scale is None else w4 * gf.k_scale[:, None, :, cols])]
    if gf.k_us4 is not None:
        blocks.append((gf.k_vt4[:, :, cols].to(torch.float32),
                       w4 * gf.k_scale4[:, None, :, cols]))
    q_emb = torch.cat([torch.einsum("bhql,brl->bhqr", q_abs * fold, vt)
                       for vt, fold in blocks], dim=-1)
    t, lse = mla_rankspace_decode_attention(
        q_emb * scale, q_pe * scale, gf.k_us, k_pe_p, gf.k_rnorm[:, gpos], k_us4=gf.k_us4)
    out, col = 0, 0
    for vt, fold in blocks:
        out = out + torch.einsum("bhqr,brl->bhql", t[..., col:col + vt.shape[1]], vt) * fold
        col += vt.shape[1]
    return PartialAttention(out=out, lse=lse)


def decode_step(
    params: Params,
    cfg: ModelConfig,
    xkv: Optional[XKVConfig],
    cache: XKVCache,
    tokens: torch.Tensor,
    pos: Union[int, torch.Tensor],
) -> Tuple[torch.Tensor, XKVCache]:
    """Absorbed MLA decode over the hybrid latent cache.

    tokens: (b, ql) next token(s); pos: absolute position of tokens[:, 0],
    an int or a 0-d tensor on the device (``llama.decode_step``).
    ``ql > 1`` appends ql rows to the tail, causal among themselves. The
    tail is written in place. Returns (logits (b, ql, V) fp32, cache).
    Per layer the nope scores contract the query (through W_uk) against
    the latent, in rank space when the group is factored; the pe scores
    use the dense k_pe slot; the output recombines through W_uv, then
    o_proj.
    """
    b, ql = tokens.shape
    dev = tokens.device
    scale = softmax_scale(cfg)
    positions = (position_tensor(pos, dev) + torch.arange(ql, device=dev))[None, :]
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_scaling)
    grp_index = layer_group_index(xkv) if xkv is not None else {}
    # Query i sees tail rows < tail_len + i + 1.
    t_mask = (torch.arange(cache.tail_max, device=dev)[None, :]
              < cache.tail_len + 1 + torch.arange(ql, device=dev)[:, None])

    h = params["embed"][tokens]
    for li, layer in enumerate(params["layers"]):
        resid = h
        x = rms_norm(h, layer["input_norm"], cfg.rms_norm_eps)
        ap = layer["attn"]
        q_nope, q_pe = _q_heads(ap, cfg, x)
        latent_new, k_pe_pre = _latent_and_kpe(ap, cfg, x)
        q_pe = apply_rope_interleaved(q_pe, cos, sin).to(torch.float32)
        cache.append_tail(li, latent_new, apply_rope_interleaved(k_pe_pre, cos, sin))

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
        if gf is not None and gf.k_us is not None:
            if gf.k_rnorm is None:
                raise ValueError(
                    "factored MLA latent without k_rnorm: the reconstruct path for "
                    "such caches waits for prompt-cache persistence (ROADMAP item 16)")
            # The tail as a partial in latent space, merged by log-sum-exp.
            m_t = torch.clamp(scores_t.amax(dim=-1, keepdim=True), min=-1e29)
            e_t = torch.where(t_mask, torch.exp(scores_t - m_t), 0.0)
            l_t = e_t.sum(dim=-1, keepdim=True)
            tail = PartialAttention(
                out=(e_t / torch.clamp(l_t, min=1e-30)) @ latent_t[:, None],
                lse=m_t[..., 0] + torch.log(torch.clamp(l_t[..., 0], min=1e-30)))
            lat_sum = merge_partials(
                _rankspace_part(q_abs, q_pe, gf, gpos, k_pe_p, w, cfg, scale), tail)
        else:
            # Dense latent: one softmax over prefill and tail.
            latent_p = norm_latent(cache.dense_k[li][:, 0])
            scores_p = _scores(q_abs, q_pe, latent_p, k_pe_p.to(torch.float32), scale)
            s_p = latent_p.shape[1]
            probs = torch.softmax(torch.cat([scores_p, scores_t], dim=-1), dim=-1)
            lat_sum = probs[..., :s_p] @ latent_p[:, None] + probs[..., s_p:] @ latent_t[:, None]
        attn = torch.einsum("bhql,hlv->bhqv", lat_sum, w_uv.to(torch.float32))
        attn = attn.to(h.dtype).permute(0, 2, 1, 3).reshape(b, ql, -1)
        h = resid + attn @ ap["o_proj"]
        h = h + _mlp(layer["mlp"], cfg, rms_norm(h, layer["post_norm"], cfg.rms_norm_eps),
                     decode=True)
    return unembed(params, cfg, h), cache.advance(ql)
