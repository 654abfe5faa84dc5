"""Build the compressed XKVCache from prefill K/V (port of the SVD scheme of
``xkv_tpu/engine/compression.py``).

  * svd with layer groups >= 2: grouped xKV (cross-layer SVD);
  * svd with groups of 1: per-layer SVD;
  * ``fake=True``: factors are multiplied straight back and stored dense
    (the reference's semantics, used for parity).

Factors are bf16, fp32 or int8 (``factor_dtype="int8"`` or ``torch.int8``),
with keys factored pre-RoPE (``rope_mode="pre"``) or post-RoPE ("post").
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from xkv_tpu_torch.cache import GroupFactors, XKVCache, init_tail
from xkv_tpu_torch.compress.quant import (
    QuantizedKFactors,
    QuantizedVFactors,
    dequantize_k,
    dequantize_v,
    quantize_k_factors,
    quantize_v_factors,
)
from xkv_tpu_torch.compress.svd import (
    LowRankFactors,
    factorize,
    heads_to_matrix,
    matrix_to_heads,
    reconstruct,
)
from xkv_tpu_torch.configs import XKVConfig
from xkv_tpu_torch.models.config import ModelConfig
from xkv_tpu_torch.ops.rope import apply_rope, rope_cos_sin


def _stack_group_matrix(kvs: List[torch.Tensor]) -> torch.Tensor:
    """[(b, hkv, s, hd)] per layer -> (b, s, g*hkv*hd); columns ordered
    (layer, head, dim)."""
    return heads_to_matrix(torch.cat(kvs, dim=1))


def _split_group_matrix(mat: torch.Tensor, g: int, hkv: int) -> List[torch.Tensor]:
    """(b, s, g*hkv*hd) -> g tensors (b, hkv, s, hd)."""
    stacked = matrix_to_heads(mat, g * hkv)
    return [stacked[:, i * hkv:(i + 1) * hkv] for i in range(g)]


def _is_int8(factor_dtype) -> bool:
    if factor_dtype == "int4":
        raise NotImplementedError(
            "mixed int8+int4 factors: ROADMAP queue 1 item 11")
    return factor_dtype in ("int8", torch.int8)


def _svd_kw(xkv: XKVConfig) -> dict:
    return dict(method=xkv.svd_method, oversample=xkv.svd_oversample,
                n_iter=xkv.svd_iters, seed=xkv.svd_seed)


def _check_scheme(xkv: XKVConfig, cfg: ModelConfig) -> None:
    if xkv.layer_merge_impl != "svd":
        raise NotImplementedError("MiniCache slerp: ROADMAP queue 1 item 15")
    if cfg.model_type == "deepseek_v2":
        raise NotImplementedError("DeepSeek MLA: ROADMAP queue 1 item 14")


def _store_k(fac: LowRankFactors, factor_dtype) -> dict:
    if _is_int8(factor_dtype):
        qk = quantize_k_factors(fac.us, fac.vt)
        return dict(k_us=qk.us_q, k_vt=qk.vt_q, k_scale=qk.out_scale)
    return dict(k_us=fac.us.to(factor_dtype), k_vt=fac.vt.to(factor_dtype))


def _store_v(fac: LowRankFactors, factor_dtype) -> dict:
    if _is_int8(factor_dtype):
        qv = quantize_v_factors(fac.us, fac.vt)
        return dict(v_us=qv.us_q, v_vt=qv.vt, v_scale=qv.rank_scale)
    return dict(v_us=fac.us.to(factor_dtype), v_vt=fac.vt.to(factor_dtype))


def compress_svd_group(
    ks: List[torch.Tensor],
    vs: List[torch.Tensor],
    grp,
    xkv: XKVConfig,
    cfg: ModelConfig,
    cos_p: torch.Tensor,
    sin_p: torch.Tensor,
    fake: bool = False,
    factor_dtype=torch.bfloat16,
    cache_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[GroupFactors, Dict[int, torch.Tensor], Dict[int, torch.Tensor]]:
    """Compress ONE svd layer group's K/V.

    ks/vs: per layer of the group, each (b, hkv, s, hd), keys PRE-RoPE.
    Returns (GroupFactors, dense_k, dense_v); the dense dicts, keyed by
    ``grp.layers``, carry the unmerged side(s) and the fake reconstructions.
    """
    svd_kw = _svd_kw(xkv)
    hkv = cfg.num_kv_heads
    layers = grp.layers
    dense_k: Dict[int, torch.Tensor] = {}
    dense_v: Dict[int, torch.Tensor] = {}
    rope_post = xkv.rope_mode == "post"

    def rope_dense_k(k_pre):
        return apply_rope(k_pre, cos_p[None], sin_p[None]).to(cache_dtype)

    gf_kwargs = {}
    if xkv.merge_key:
        if rope_post:
            ks = [apply_rope(k, cos_p[None], sin_p[None]) for k in ks]
        k_mat = _stack_group_matrix(ks)
        fac_k = factorize(k_mat, grp.rank_k, **svd_kw)
        if fake:
            k_rec = _split_group_matrix(
                reconstruct(fac_k).to(k_mat.dtype), len(layers), hkv)
            for l, kr in zip(layers, k_rec):
                # Post mode: the reconstruction is already rotated.
                dense_k[l] = kr.to(cache_dtype) if rope_post else rope_dense_k(kr)
        else:
            gf_kwargs.update(_store_k(fac_k, factor_dtype))
    else:
        for l, k in zip(layers, ks):
            dense_k[l] = rope_dense_k(k)
    if xkv.merge_value:
        v_mat = _stack_group_matrix(vs)
        fac_v = factorize(v_mat, grp.rank_v, **svd_kw)
        if fake:
            v_rec = _split_group_matrix(
                reconstruct(fac_v).to(v_mat.dtype), len(layers), hkv)
            for l, vr in zip(layers, v_rec):
                dense_v[l] = vr.to(cache_dtype)
        else:
            gf_kwargs.update(_store_v(fac_v, factor_dtype))
    else:
        for l, v in zip(layers, vs):
            dense_v[l] = v.to(cache_dtype)
    return GroupFactors(**gf_kwargs), dense_k, dense_v


def build_cache(
    kvs: List[Tuple[torch.Tensor, torch.Tensor]],
    xkv: XKVConfig,
    cfg: ModelConfig,
    cos_p: torch.Tensor,
    sin_p: torch.Tensor,
    tail_max: int,
    fake: bool = False,
    factor_dtype=torch.bfloat16,
    cache_dtype: torch.dtype = torch.bfloat16,
) -> XKVCache:
    """Compress prefill K/V into the hybrid cache.

    kvs: per layer (k_pre_rope, v), each (b, hkv, s, hd). cos_p/sin_p:
    (s, hd) RoPE tables of the prefill positions, applied to the keys of
    dense-stored layers. ``fake``: store dense reconstructions instead of
    factors.
    """
    _check_scheme(xkv, cfg)
    groups: List[GroupFactors] = []
    dense_k: Dict[int, torch.Tensor] = {}
    dense_v: Dict[int, torch.Tensor] = {}
    covered = set()
    for grp in xkv.layer_groups:
        covered.update(grp.layers)
        gf, dk, dv = compress_svd_group(
            [kvs[l][0] for l in grp.layers], [kvs[l][1] for l in grp.layers],
            grp, xkv, cfg, cos_p, sin_p, fake=fake,
            factor_dtype=factor_dtype, cache_dtype=cache_dtype,
        )
        dense_k.update(dk)
        dense_v.update(dv)
        groups.append(gf)
    # Ungrouped layers: plain dense cache, post-RoPE K.
    for l in range(len(kvs)):
        if l not in covered:
            dense_k[l] = apply_rope(kvs[l][0], cos_p[None], sin_p[None]).to(cache_dtype)
            dense_v[l] = kvs[l][1].to(cache_dtype)
    k0 = kvs[0][0]
    tail_k, tail_v = init_tail(cfg, k0.shape[0], tail_max, cache_dtype, k0.device)
    return XKVCache(groups=tuple(groups), dense_k=dense_k, dense_v=dense_v,
                    tail_k=tail_k, tail_v=tail_v, tail_len=0)


def build_uncompressed_cache(
    kvs: List[Tuple[torch.Tensor, torch.Tensor]],
    cfg: ModelConfig,
    cos_p: torch.Tensor,
    sin_p: torch.Tensor,
    tail_max: int,
    cache_dtype: torch.dtype = torch.bfloat16,
) -> XKVCache:
    """Baseline: dense post-RoPE cache for every layer."""
    dense_k = {l: apply_rope(k, cos_p[None], sin_p[None]).to(cache_dtype)
               for l, (k, _) in enumerate(kvs)}
    dense_v = {l: v.to(cache_dtype) for l, (_, v) in enumerate(kvs)}
    k0 = kvs[0][0]
    tail_k, tail_v = init_tail(cfg, k0.shape[0], tail_max, cache_dtype, k0.device)
    return XKVCache(groups=(), dense_k=dense_k, dense_v=dense_v,
                    tail_k=tail_k, tail_v=tail_v, tail_len=0)


def refactorize_cache(
    cache: XKVCache,
    xkv: XKVConfig,
    cfg: ModelConfig,
    factor_dtype=torch.bfloat16,
) -> XKVCache:
    """Fold a FULL decode tail back into the compressed cache: re-run the
    merge over [reconstructed prefill ; tail] per group.

    Caller contract: ``tail_len == tail_max``. The tail stores post-RoPE
    keys; in "pre" mode they are un-rotated (RoPE by -theta is exact) before
    joining the pre-RoPE factors.
    """
    _check_scheme(xkv, cfg)
    s_p = cache.prefill_len
    t = cache.tail_max
    device = cache.tail_k.device
    rope_post = xkv.rope_mode == "post"
    cos_t, sin_t = rope_cos_sin(
        s_p + torch.arange(t, device=device), cfg.head_dim, cfg.rope_theta,
        cfg.rope_scaling)
    svd_kw = _svd_kw(xkv)
    quantized = any(g.k_scale is not None or g.v_scale is not None for g in cache.groups)
    store_dtype = "int8" if quantized else factor_dtype

    def unrope(k):
        return k if rope_post else apply_rope(k, cos_t[None], -sin_t[None])

    new_groups = []
    for grp, gf in zip(xkv.layer_groups, cache.groups):
        layers = grp.layers
        kw = {}
        if gf.k_us is not None:
            if gf.k_scale is not None:
                k_mat = dequantize_k(QuantizedKFactors(gf.k_us, gf.k_vt, gf.k_scale))
            else:
                k_mat = reconstruct(LowRankFactors(gf.k_us, gf.k_vt))
            tail_pre = _stack_group_matrix(
                [unrope(cache.tail_k[l].to(torch.float32)) for l in layers])
            k_ext = torch.cat([k_mat, tail_pre], dim=1)
            kw.update(_store_k(factorize(k_ext, grp.rank_k, **svd_kw), store_dtype))
        if gf.v_us is not None:
            if gf.v_scale is not None:
                v_mat = dequantize_v(QuantizedVFactors(gf.v_us, gf.v_scale, gf.v_vt))
            else:
                v_mat = reconstruct(LowRankFactors(gf.v_us, gf.v_vt))
            tail_v = _stack_group_matrix(
                [cache.tail_v[l].to(torch.float32) for l in layers])
            v_ext = torch.cat([v_mat, tail_v], dim=1)
            kw.update(_store_v(factorize(v_ext, grp.rank_v, **svd_kw), store_dtype))
        new_groups.append(GroupFactors(**kw))

    # Dense segments: concat the (already post-RoPE) tail.
    new_dense_k = {l: torch.cat([d, cache.tail_k[l].to(d.dtype)], dim=2)
                   for l, d in cache.dense_k.items()}
    new_dense_v = {l: torch.cat([d, cache.tail_v[l].to(d.dtype)], dim=2)
                   for l, d in cache.dense_v.items()}
    tail_k, tail_v = init_tail(cfg, cache.tail_k.shape[1], t, cache.tail_k.dtype, device)
    return XKVCache(groups=tuple(new_groups), dense_k=new_dense_k, dense_v=new_dense_v,
                    tail_k=tail_k, tail_v=tail_v, tail_len=0)
