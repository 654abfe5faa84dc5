"""Build the compressed XKVCache from prefill K/V (port of the SVD scheme of
``xkv_tpu/engine/compression.py``).

  * svd with layer groups >= 2: grouped xKV (cross-layer SVD);
  * svd with groups of 1: per-layer SVD;
  * ``fake=True``: factors are multiplied straight back and stored dense
    (the reference's semantics, used for parity).

Factors are bf16, fp32, int8 (``factor_dtype="int8"`` or ``torch.int8``)
or mixed int8+int4 (``factor_dtype="int4"``, post-RoPE only), with keys
factored pre-RoPE (``rope_mode="pre"``) or post-RoPE ("post"). With
``sparse_block`` set, each factored K side also stores the Quest-style
per-chunk (min, max) bounds of its post-RoPE keys for sparse top-k decode.

DeepSeek-V2 MLA (``cfg.model_type == "deepseek_v2"``): the K slot holds the RoPE-free
latent and is stored as it is (no RoPE, no post mode; mixed int8+int4
allowed), the V slot the rotated RoPE key, never merged. Factored latents
also store ``k_rnorm``, the per-row inverse RMS of the latent that decode
contracts against (``latent_rnorm``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from xkv_tpu_torch.cache import GroupFactors, XKVCache, empty_tail_len, init_tail
from xkv_tpu_torch.compress.quant import (
    QuantizedKFactors,
    QuantizedKFactorsMixed4,
    QuantizedVFactors,
    QuantizedVFactorsMixed4,
    dequantize_k,
    dequantize_k_mixed4,
    dequantize_v,
    dequantize_v_mixed4,
    quantize_k_factors,
    quantize_k_factors_mixed4,
    quantize_v_factors,
    quantize_v_factors_mixed4,
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


def latent_rnorm(k_rec_mat: torch.Tensor, g: int) -> torch.Tensor:
    """Per-layer inverse RMS of an MLA group's latent matrix (b, s, g*lora):
    (b, g, s) fp32, rsqrt(mean(z^2) + 1e-6) per row, the row scalar of the
    decode's rms_norm(latent, w, 1e-6). Storing it keeps the absorbed decode
    in rank space (the column weight w folds into the query)."""
    b, s, gm = k_rec_mat.shape
    z = k_rec_mat.to(torch.float32).reshape(b, s, g, gm // g)
    return torch.rsqrt(z.pow(2).mean(dim=-1) + 1e-6).permute(0, 2, 1)


def _k_matrix(gf: GroupFactors) -> torch.Tensor:
    """The fp32 group key (MLA: latent) matrix (b, s, g*hkv*hd) the stored
    K factors hold: rebuilt from the stored factors, dequantised."""
    if gf.k_us4 is not None:
        return dequantize_k_mixed4(QuantizedKFactorsMixed4(
            gf.k_us, gf.k_us4, gf.k_vt, gf.k_vt4, gf.k_scale, gf.k_scale4))
    if gf.k_scale is not None:
        return dequantize_k(QuantizedKFactors(gf.k_us, gf.k_vt, gf.k_scale))
    return reconstruct(LowRankFactors(gf.k_us, gf.k_vt))


def _is_int8(factor_dtype) -> bool:
    return factor_dtype in ("int8", torch.int8)


def int4_rank_hi(rank: int, frac: float) -> int:
    """Rank split of mixed int8+int4 factors: the top ``r_hi`` ranks stay
    int8, the tail drops to packed int4. At rank >= 512 the tail rounds
    down to a multiple of 256 (toward more int8), and a requested tail
    below 256 ranks there is refused rather than moving ranks the caller
    asked to keep in int8; smaller ranks just keep an even tail."""
    hi = max(2, int(rank * frac))
    lo = rank - hi
    if rank >= 512:
        lo = (lo // 256) * 256
        if lo == 0:
            raise ValueError(
                f"int4_rank_frac={frac} leaves an int4 tail of "
                f"{rank - hi} ranks at rank {rank}, below the 256-rank "
                "lane-alignment tile; use factor_dtype='int8' or "
                f"int4_rank_frac <= {(rank - 256) / rank:.3f}"
            )
    else:
        lo -= lo % 2
    return rank - lo


def chunk_bounds(
    k_mat: torch.Tensor,  # (b, s, n_heads*hd) group/layer key matrix
    cos: Optional[torch.Tensor],  # (s, hd) RoPE tables, None: keys are rotated
    sin: Optional[torch.Tensor],
    block: int,
    n_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quest-style per-chunk elementwise (min, max) of the POST-RoPE keys,
    each (b, nc, n_heads*hd) fp32, nc = ceil(s / block).

    ``U_c = qpos . kmax + qneg . kmin`` then bounds every q . k in chunk c
    from above (Quest, arXiv:2406.10774). The keys are rotated and reduced
    one chunk at a time, so no rotated fp32 copy of the whole matrix
    exists; rows past ``s`` belong to no chunk.
    """
    b, s, m = k_mat.shape
    hd = m // n_heads
    nc = -(-s // block)
    kmin = torch.empty((b, nc, m), dtype=torch.float32, device=k_mat.device)
    kmax = torch.empty_like(kmin)
    for c in range(nc):
        x = k_mat[:, c * block:(c + 1) * block].to(torch.float32)
        if cos is not None:
            rows = x.shape[1]
            heads = x.reshape(b, rows, n_heads, hd).permute(0, 2, 1, 3)
            heads = apply_rope(heads, cos[None, c * block:c * block + rows],
                               sin[None, c * block:c * block + rows])
            x = heads.permute(0, 2, 1, 3).reshape(b, rows, m)
        kmin[:, c] = x.amin(dim=1)
        kmax[:, c] = x.amax(dim=1)
    return kmin, kmax


def _svd_kw(xkv: XKVConfig) -> dict:
    return dict(method=xkv.svd_method, oversample=xkv.svd_oversample,
                n_iter=xkv.svd_iters, seed=xkv.svd_seed)


def _check_scheme(xkv: XKVConfig) -> None:
    if xkv.layer_merge_impl != "svd":
        raise NotImplementedError("MiniCache slerp: ROADMAP queue 1 item 15")


def _store_k(fac: LowRankFactors, factor_dtype, r_hi: Optional[int] = None) -> dict:
    """Stored K factors; ``r_hi`` is the int8 rank count of mixed factors."""
    if factor_dtype == "int4":
        q4 = quantize_k_factors_mixed4(fac.us, fac.vt, r_hi)
        return dict(k_us=q4.us8, k_us4=q4.us4p, k_vt=q4.vt8, k_vt4=q4.vt4,
                    k_scale=q4.out_scale, k_scale4=q4.scale4)
    if _is_int8(factor_dtype):
        qk = quantize_k_factors(fac.us, fac.vt)
        return dict(k_us=qk.us_q, k_vt=qk.vt_q, k_scale=qk.out_scale)
    return dict(k_us=fac.us.to(factor_dtype), k_vt=fac.vt.to(factor_dtype))


def _store_v(fac: LowRankFactors, factor_dtype, r_hi: Optional[int] = None) -> dict:
    if factor_dtype == "int4":
        q4 = quantize_v_factors_mixed4(fac.us, fac.vt, r_hi)
        return dict(v_us=q4.us8, v_us4=q4.us4p, v_scale=q4.rank_scale, v_vt=q4.vt)
    if _is_int8(factor_dtype):
        qv = quantize_v_factors(fac.us, fac.vt)
        return dict(v_us=qv.us_q, v_vt=qv.vt, v_scale=qv.rank_scale)
    return dict(v_us=fac.us.to(factor_dtype), v_vt=fac.vt.to(factor_dtype))


def compress_svd_group(
    ks: List[torch.Tensor],
    vs: List[torch.Tensor],
    grp,
    xkv: XKVConfig,
    cos_p: Optional[torch.Tensor],
    sin_p: Optional[torch.Tensor],
    fake: bool = False,
    factor_dtype=torch.bfloat16,
    cache_dtype: torch.dtype = torch.bfloat16,
    rope_dense_keys: bool = True,
    sparse_block: Optional[int] = None,
) -> Tuple[GroupFactors, Dict[int, torch.Tensor], Dict[int, torch.Tensor]]:
    """Compress ONE svd layer group's K/V.

    ks/vs: per layer of the group, each (b, heads, s, width): keys PRE-RoPE
    (``rope_dense_keys``), or the MLA latent (b, 1, s, kv_lora_rank) and
    RoPE key with ``rope_dense_keys=False``, when cos_p/sin_p are unused.
    Returns (GroupFactors, dense_k, dense_v); the dense dicts, keyed by
    ``grp.layers``, carry the unmerged side(s) and the fake reconstructions,
    split into each slot's own heads (one latent head for MLA).
    ``sparse_block``: also store the chunk bounds (``chunk_bounds``) of
    the exact prefill keys, in ``cache_dtype``.
    """
    svd_kw = _svd_kw(xkv)
    layers = grp.layers
    dense_k: Dict[int, torch.Tensor] = {}
    dense_v: Dict[int, torch.Tensor] = {}
    rope_post = xkv.rope_mode == "post" and rope_dense_keys
    if factor_dtype == "int4" and not rope_post and rope_dense_keys:
        raise ValueError(
            "factor_dtype='int4' (mixed int8+int4) requires rope_mode='post' "
            "(the rank-space decode path)")

    def r_hi(rank):
        return int4_rank_hi(rank, xkv.int4_rank_frac) if factor_dtype == "int4" else None

    def rope_dense_k(k_pre):
        if not rope_dense_keys:
            return k_pre.to(cache_dtype)
        return apply_rope(k_pre, cos_p[None], sin_p[None]).to(cache_dtype)

    gf_kwargs = {}
    if xkv.merge_key:
        hk = ks[0].shape[1]
        if rope_post:
            ks = [apply_rope(k, cos_p[None], sin_p[None]) for k in ks]
        k_mat = _stack_group_matrix(ks)
        fac_k = factorize(k_mat, grp.rank_k, **svd_kw)
        if fake:
            k_rec = _split_group_matrix(
                reconstruct(fac_k).to(k_mat.dtype), len(layers), hk)
            for l, kr in zip(layers, k_rec):
                # Post mode: the reconstruction is already rotated.
                dense_k[l] = kr.to(cache_dtype) if rope_post else rope_dense_k(kr)
        else:
            gf_kwargs.update(_store_k(fac_k, factor_dtype, r_hi(grp.rank_k)))
            if not rope_dense_keys:
                # MLA: the inverse RMS of the latent decode contracts
                # against, rebuilt from the stored (rounded or quantised)
                # factors.
                gf_kwargs["k_rnorm"] = latent_rnorm(
                    _k_matrix(GroupFactors(**gf_kwargs)), len(layers))
        if sparse_block is not None and not fake:
            # Bounds from the exact prefill keys (post mode: already rotated).
            cmin, cmax = chunk_bounds(
                k_mat, None if rope_post else cos_p, sin_p, sparse_block,
                len(layers) * hk)
            gf_kwargs["k_cmin"] = cmin.to(cache_dtype)
            gf_kwargs["k_cmax"] = cmax.to(cache_dtype)
    else:
        for l, k in zip(layers, ks):
            dense_k[l] = rope_dense_k(k)
    if xkv.merge_value:
        v_mat = _stack_group_matrix(vs)
        fac_v = factorize(v_mat, grp.rank_v, **svd_kw)
        if fake:
            v_rec = _split_group_matrix(
                reconstruct(fac_v).to(v_mat.dtype), len(layers), vs[0].shape[1])
            for l, vr in zip(layers, v_rec):
                dense_v[l] = vr.to(cache_dtype)
        else:
            gf_kwargs.update(_store_v(fac_v, factor_dtype, r_hi(grp.rank_v)))
    else:
        for l, v in zip(layers, vs):
            dense_v[l] = v.to(cache_dtype)
    return GroupFactors(**gf_kwargs), dense_k, dense_v


def _rope_keys(cfg: ModelConfig) -> bool:
    """Whether the K slot holds RoPE'd keys: not for the MLA latent."""
    return cfg.model_type != "deepseek_v2"


def _dense_key(k, cos_p, sin_p, cache_dtype, rope_dense_keys: bool) -> torch.Tensor:
    """A dense-stored key slot: post-RoPE keys, or (MLA) the latent as it is."""
    if not rope_dense_keys:
        return k.to(cache_dtype)
    return apply_rope(k, cos_p[None], sin_p[None]).to(cache_dtype)


def build_cache(
    kvs: List[Tuple[torch.Tensor, torch.Tensor]],
    xkv: XKVConfig,
    cfg: ModelConfig,
    cos_p: Optional[torch.Tensor],
    sin_p: Optional[torch.Tensor],
    tail_max: int,
    fake: bool = False,
    factor_dtype=torch.bfloat16,
    cache_dtype: torch.dtype = torch.bfloat16,
    sparse_block: Optional[int] = None,
) -> XKVCache:
    """Compress prefill K/V into the hybrid cache.

    kvs: per layer (k_pre_rope, v), each (b, hkv, s, hd). cos_p/sin_p:
    (s, hd) RoPE tables of the prefill positions, applied to the keys of
    dense-stored layers. MLA: kvs hold (latent, rotated RoPE key) per
    layer, the latent stored without RoPE; cos_p/sin_p unused.
    ``fake``: store dense reconstructions instead of factors.
    ``sparse_block``: also store per-chunk key bounds for sparse top-k decode.
    """
    _check_scheme(xkv)
    rope_dense_keys = _rope_keys(cfg)
    groups: List[GroupFactors] = []
    dense_k: Dict[int, torch.Tensor] = {}
    dense_v: Dict[int, torch.Tensor] = {}
    covered = set()
    for grp in xkv.layer_groups:
        covered.update(grp.layers)
        gf, dk, dv = compress_svd_group(
            [kvs[l][0] for l in grp.layers], [kvs[l][1] for l in grp.layers],
            grp, xkv, cos_p, sin_p, fake=fake,
            factor_dtype=factor_dtype, cache_dtype=cache_dtype,
            rope_dense_keys=rope_dense_keys, sparse_block=sparse_block,
        )
        dense_k.update(dk)
        dense_v.update(dv)
        groups.append(gf)
    # Ungrouped layers: plain dense cache, post-RoPE K (MLA: the latent).
    for l in range(len(kvs)):
        if l not in covered:
            dense_k[l] = _dense_key(kvs[l][0], cos_p, sin_p, cache_dtype, rope_dense_keys)
            dense_v[l] = kvs[l][1].to(cache_dtype)
    k0 = kvs[0][0]
    tail_k, tail_v = init_tail(cfg, k0.shape[0], tail_max, cache_dtype, k0.device)
    return XKVCache(groups=tuple(groups), dense_k=dense_k, dense_v=dense_v,
                    tail_k=tail_k, tail_v=tail_v,
                    tail_len=empty_tail_len(tail_k.device))


def build_uncompressed_cache(
    kvs: List[Tuple[torch.Tensor, torch.Tensor]],
    cfg: ModelConfig,
    cos_p: Optional[torch.Tensor],
    sin_p: Optional[torch.Tensor],
    tail_max: int,
    cache_dtype: torch.dtype = torch.bfloat16,
) -> XKVCache:
    """Baseline: dense post-RoPE cache for every layer (MLA: the latent as
    it is)."""
    dense_k = {l: _dense_key(k, cos_p, sin_p, cache_dtype, _rope_keys(cfg))
               for l, (k, _) in enumerate(kvs)}
    dense_v = {l: v.to(cache_dtype) for l, (_, v) in enumerate(kvs)}
    k0 = kvs[0][0]
    tail_k, tail_v = init_tail(cfg, k0.shape[0], tail_max, cache_dtype, k0.device)
    return XKVCache(groups=(), dense_k=dense_k, dense_v=dense_v,
                    tail_k=tail_k, tail_v=tail_v,
                    tail_len=empty_tail_len(tail_k.device))


def refactorize_cache(
    cache: XKVCache,
    xkv: XKVConfig,
    cfg: ModelConfig,
    factor_dtype=torch.bfloat16,
    sparse_block: Optional[int] = None,
) -> XKVCache:
    """Fold a FULL decode tail back into the compressed cache: re-run the
    merge over [reconstructed prefill ; tail] per group.

    Caller contract: the tail is full (``tail_count == tail_max``). The tail stores post-RoPE
    keys; in "pre" mode they are un-rotated (RoPE by -theta is exact) before
    joining the pre-RoPE factors. The MLA K slot holds the RoPE-free latent,
    which joins as it is; its ``k_rnorm`` is recomputed from the new
    factors. Groups that hold chunk bounds get them recomputed over the
    extended keys in ``sparse_block``-row chunks.
    """
    _check_scheme(xkv)
    s_p = cache.prefill_len
    t = cache.tail_max
    device = cache.tail_k.device
    rope_keys = _rope_keys(cfg)
    rope_post = xkv.rope_mode == "post" and rope_keys
    svd_kw = _svd_kw(xkv)
    quantized = any(g.k_scale is not None or g.v_scale is not None for g in cache.groups)
    store_dtype = "int8" if quantized else factor_dtype
    # Chunk bounds are recomputed over [prefill ; tail]; pre mode rotates
    # the reconstructed keys at every position.
    cos_f = sin_f = None
    bounded = any(g.k_cmin is not None for g in cache.groups)
    if bounded and sparse_block is None:
        raise ValueError("the cache holds chunk bounds: pass sparse_block")
    if bounded and not rope_post:
        cos_f, sin_f = rope_cos_sin(torch.arange(s_p + t, device=device), cfg.head_dim,
                                    cfg.rope_theta, cfg.rope_scaling)

    cos_t = sin_t = None
    if rope_keys and not rope_post:
        cos_t, sin_t = rope_cos_sin(s_p + torch.arange(t, device=device), cfg.head_dim,
                                    cfg.rope_theta, cfg.rope_scaling)

    def unrope(k):
        return k if cos_t is None else apply_rope(k, cos_t[None], -sin_t[None])

    new_groups = []
    for grp, gf in zip(xkv.layer_groups, cache.groups):
        layers = grp.layers
        kw = {}
        if gf.k_us is not None:
            tail_pre = _stack_group_matrix(
                [unrope(cache.tail_k[l].to(torch.float32)) for l in layers])
            k_ext = torch.cat([_k_matrix(gf), tail_pre], dim=1)
            # Mixed factors keep their rank split.
            mixed = gf.k_us4 is not None
            kw.update(_store_k(factorize(k_ext, grp.rank_k, **svd_kw),
                               "int4" if mixed else store_dtype, gf.k_us.shape[2]))
            if gf.k_rnorm is not None:
                kw["k_rnorm"] = latent_rnorm(_k_matrix(GroupFactors(**kw)), len(layers))
            if gf.k_cmin is not None:
                # The JAX package derives the chunk width from the stored
                # chunk count, ceil(s_p / nc), which differs from
                # sparse_block once s_p is not a multiple of it.
                cmin, cmax = chunk_bounds(k_ext, cos_f, sin_f, sparse_block,
                                          len(layers) * cfg.num_kv_heads)
                kw["k_cmin"] = cmin.to(gf.k_cmin.dtype)
                kw["k_cmax"] = cmax.to(gf.k_cmax.dtype)
        if gf.v_us is not None:
            if gf.v_us4 is not None:
                v_mat = dequantize_v_mixed4(QuantizedVFactorsMixed4(
                    gf.v_us, gf.v_us4, gf.v_scale, gf.v_vt))
            elif gf.v_scale is not None:
                v_mat = dequantize_v(QuantizedVFactors(gf.v_us, gf.v_scale, gf.v_vt))
            else:
                v_mat = reconstruct(LowRankFactors(gf.v_us, gf.v_vt))
            tail_v = _stack_group_matrix(
                [cache.tail_v[l].to(torch.float32) for l in layers])
            v_ext = torch.cat([v_mat, tail_v], dim=1)
            mixed = gf.v_us4 is not None
            kw.update(_store_v(factorize(v_ext, grp.rank_v, **svd_kw),
                               "int4" if mixed else store_dtype, gf.v_us.shape[2]))
        new_groups.append(GroupFactors(**kw))

    # Dense segments: concat the (already post-RoPE) tail.
    new_dense_k = {l: torch.cat([d, cache.tail_k[l].to(d.dtype)], dim=2)
                   for l, d in cache.dense_k.items()}
    new_dense_v = {l: torch.cat([d, cache.tail_v[l].to(d.dtype)], dim=2)
                   for l, d in cache.dense_v.items()}
    tail_k, tail_v = init_tail(cfg, cache.tail_k.shape[1], t, cache.tail_k.dtype, device)
    return XKVCache(groups=tuple(new_groups), dense_k=new_dense_k, dense_v=new_dense_v,
                    tail_k=tail_k, tail_v=tail_v,
                    tail_len=empty_tail_len(tail_k.device))
