"""Build the compressed XKVCache from prefill K/V (port of
``xkv_tpu/engine/compression.py``).

  * svd with layer groups >= 2: grouped xKV (cross-layer SVD);
  * svd with groups of 1: per-layer SVD;
  * slerp (groups of 2): the MiniCache merge, stored dense, or with
    ``slerp_compact`` as a shared direction, norms and the exact rows of
    the ``slerp_keep_frac`` largest angles (``compress/slerp.py``);
  * ``fake=True``: factors are multiplied straight back and stored dense
    (the reference's semantics, used for parity); SLERP stores dense.

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

Under a ``mesh`` (the svd scheme; any factor dtype, chunk bounds
included) every rank holds its data rows (every row, after a
sequence-parallel prefill, whose K/V ``llama.prefill`` joins over the data
axis) and, for the Llama family, its kv heads' K/V, and ``cfg`` is its
share of the heads. A group's SVD mixes
every head of the group, so the group's whole matrix is joined from the
model group's columns (``Mesh.gather``), the model group's first rank
computes the factors (at a build and at each refold) and broadcasts them,
and each rank keeps its shard (``parallel/sharding.py``): the same ``us``
on every rank by construction. The MLA latent has no heads: every rank of
a model group holds the same latent, and the first rank's factors are
broadcast and kept whole.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from xkv_tpu_torch.cache import (
    GroupFactors,
    SlerpCompact,
    XKVCache,
    empty_tail_len,
    init_tail,
)
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
from xkv_tpu_torch.compress.slerp import compact_pair, compact_reconstruct, minicache_merge_heads
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
from xkv_tpu_torch.parallel.sharding import shard_group_factors, shard_heads


def _stack_group_matrix(kvs: List[torch.Tensor]) -> torch.Tensor:
    """[(b, hkv, s, hd)] per layer -> (b, s, g*hkv*hd); columns ordered
    (layer, head, dim)."""
    return heads_to_matrix(torch.cat(kvs, dim=1))


def _split_group_matrix(mat: torch.Tensor, g: int, hkv: int) -> List[torch.Tensor]:
    """(b, s, g*hkv*hd) -> g tensors (b, hkv, s, hd)."""
    stacked = matrix_to_heads(mat, g * hkv)
    return [stacked[:, i * hkv:(i + 1) * hkv] for i in range(g)]


def _whole_group(xs: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """A group's per-layer K or V of every rank's kv heads: [(b, hkv /
    model, s, hd)] per layer -> [(b, hkv, s, hd)] per layer."""
    g, hl = len(xs), xs[0].shape[1]
    return _split_group_matrix(mesh.gather(_stack_group_matrix(xs), blocks=g), g,
                               hl * mesh.model)


def _on_first_rank(mesh, compute: Callable[[], Dict[str, torch.Tensor]],
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """``compute()``'s tensors, run on the model group's first rank and
    broadcast to the group. When the data rows are replicas (sequence
    parallelism), on the mesh's first rank alone: the first data row's
    model group gets them so, and each data group then broadcasts its
    first rank's, so every rank holds the same factors bitwise."""
    if mesh.replicas and mesh.data_rank != 0:
        return mesh.broadcast_tensors(None, device, axis="data")
    out = mesh.broadcast_tensors(compute() if mesh.model_rank == 0 else None, device)
    if mesh.replicas:
        mesh.broadcast_tensors(out, device, axis="data")
    return out


def _compress_group_tp(ks, vs, layers, mesh, compress, heads: bool):
    """A group under a mesh: the whole K/V joined from the model group's
    heads (``heads``; the MLA latent is whole on every rank), ``compress(ks,
    vs)`` -> (GroupFactors, dense_k, dense_v) on the group's first rank,
    broadcast, and this rank's shard of it."""
    if heads:
        ks, vs = _whole_group(ks, mesh), _whole_group(vs, mesh)

    def compute():
        gf, dk, dv = compress(ks, vs)
        flat = {f"gf.{k}": v for k, v in vars(gf).items() if v is not None}
        flat.update({f"dk.{l}": x for l, x in dk.items()})
        flat.update({f"dv.{l}": x for l, x in dv.items()})
        return flat

    flat = _on_first_rank(mesh, compute, ks[0].device)
    gf = GroupFactors(**{k[3:]: v for k, v in flat.items() if k.startswith("gf.")})
    dense = {side: {int(k[3:]): shard_heads(v, mesh) if heads else v for k, v in flat.items()
                    if k.startswith(side)} for side in ("dk", "dv")}
    if heads:
        gf = shard_group_factors(gf, len(layers), mesh)
    return gf, dense["dk"], dense["dv"]


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


def _v_matrix(gf: GroupFactors) -> torch.Tensor:
    """The fp32 group value matrix the stored V factors hold."""
    if gf.v_us4 is not None:
        return dequantize_v_mixed4(QuantizedVFactorsMixed4(gf.v_us, gf.v_us4, gf.v_scale, gf.v_vt))
    if gf.v_scale is not None:
        return dequantize_v(QuantizedVFactors(gf.v_us, gf.v_scale, gf.v_vt))
    return reconstruct(LowRankFactors(gf.v_us, gf.v_vt))


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


def compress_slerp_group(
    ks: List[torch.Tensor],
    vs: List[torch.Tensor],
    grp,
    xkv: XKVConfig,
    cos_p: Optional[torch.Tensor],
    sin_p: Optional[torch.Tensor],
    fake: bool = False,
    cache_dtype: torch.dtype = torch.bfloat16,
    rope_dense_keys: bool = True,
    valid_len=None,
) -> Tuple[GroupFactors, Dict[int, torch.Tensor], Dict[int, torch.Tensor]]:
    """Merge ONE slerp group's two layers (MiniCache, at the group's
    ``slerp_t`` / ``slerp_gamma``; K pre-RoPE) and store each merged side
    dense (K post-RoPE, MLA: the latent) or, with ``slerp_compact`` outside
    ``fake``, as ``SlerpCompact`` over the stored rows with
    ``max(1, int(slerp_keep_frac * s))`` exact rows. A side the config does
    not merge is stored dense as it is. ``valid_len``: the true row count
    (an int or a (b,) tensor) when the rows carry right padding, kept out
    of the divergence threshold. Returns (GroupFactors, dense_k, dense_v)
    as ``compress_svd_group``."""
    layers = grp.layers
    compact = xkv.slerp_compact and not fake
    keep = max(1, int(xkv.slerp_keep_frac * ks[0].shape[2]))
    gf_kwargs = {}
    dense_k: Dict[int, torch.Tensor] = {}
    dense_v: Dict[int, torch.Tensor] = {}

    def key(k):
        return _dense_key(k, cos_p, sin_p, cache_dtype, rope_dense_keys)

    def value(v):
        return v.to(cache_dtype)

    for side, xs, store, dense, merged in (("slerp_k", ks, key, dense_k, xkv.merge_key),
                                           ("slerp_v", vs, value, dense_v, xkv.merge_value)):
        if merged:
            xs = minicache_merge_heads(xs[0], xs[1], t=grp.slerp_t, gamma=grp.slerp_gamma,
                                       valid_len=valid_len)
        rows = [store(x) for x in xs]
        if merged and compact:
            gf_kwargs[side] = compact_pair(rows[0], rows[1], keep)
        else:
            dense.update(zip(layers, rows))
    return GroupFactors(**gf_kwargs), dense_k, dense_v


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
    valid_len=None,
    mesh=None,
) -> XKVCache:
    """Compress prefill K/V into the hybrid cache (a rank's shard of it
    under a ``mesh``).

    kvs: per layer (k_pre_rope, v), each (b, hkv, s, hd). cos_p/sin_p:
    (s, hd) RoPE tables of the prefill positions, applied to the keys of
    dense-stored layers. MLA: kvs hold (latent, rotated RoPE key) per
    layer, the latent stored without RoPE; cos_p/sin_p unused.
    ``fake``: store dense reconstructions instead of factors.
    ``sparse_block``: also store per-chunk key bounds for sparse top-k
    decode (svd groups). ``valid_len``: the true row count when kvs carry
    right-padded zero rows (bucketed admission), which keeps the SLERP
    divergence threshold on real rows; the SVD needs none (zero rows of U).
    """
    return build_cache_by_span(
        lambda layers: [kvs[l] for l in layers], len(kvs), xkv, cfg, cos_p, sin_p, tail_max,
        fake=fake, factor_dtype=factor_dtype, cache_dtype=cache_dtype,
        sparse_block=sparse_block, valid_len=valid_len, mesh=mesh)


def build_cache_by_span(
    span_kvs: Callable[[List[int]], List[Tuple[torch.Tensor, torch.Tensor]]],
    num_layers: int,
    xkv: XKVConfig,
    cfg: ModelConfig,
    cos_p: Optional[torch.Tensor],
    sin_p: Optional[torch.Tensor],
    tail_max: int,
    fake: bool = False,
    factor_dtype=torch.bfloat16,
    cache_dtype: torch.dtype = torch.bfloat16,
    sparse_block: Optional[int] = None,
    valid_len=None,
    mesh=None,
) -> XKVCache:
    """``build_cache`` with the K/V given span by span: ``span_kvs(layers)``
    returns the (k, v) of ``layers``, a group's or one ungrouped layer's,
    and is called once for each, in the order of their first layers. What
    it returns is dropped once stored, so the staged prefill, which runs
    each span's layers inside ``span_kvs``, holds one group's dense K/V at
    a time."""
    rope_dense_keys = _rope_keys(cfg)
    group_at = {min(grp.layers): gi for gi, grp in enumerate(xkv.layer_groups)}
    covered = {l for grp in xkv.layer_groups for l in grp.layers}
    groups: List[Optional[GroupFactors]] = [None] * len(xkv.layer_groups)
    dense_k: Dict[int, torch.Tensor] = {}
    dense_v: Dict[int, torch.Tensor] = {}
    for l in range(num_layers):
        if l in group_at:
            grp = xkv.layer_groups[group_at[l]]
            kvs = span_kvs(list(grp.layers))
            ks, vs = [k for k, _ in kvs], [v for _, v in kvs]
            if xkv.layer_merge_impl == "slerp":
                groups[group_at[l]], dk, dv = compress_slerp_group(
                    ks, vs, grp, xkv, cos_p, sin_p, fake=fake, cache_dtype=cache_dtype,
                    rope_dense_keys=rope_dense_keys, valid_len=valid_len)
            else:
                def compress(ks, vs, grp=grp):
                    return compress_svd_group(
                        ks, vs, grp, xkv, cos_p, sin_p, fake=fake,
                        factor_dtype=factor_dtype, cache_dtype=cache_dtype,
                        rope_dense_keys=rope_dense_keys, sparse_block=sparse_block)

                groups[group_at[l]], dk, dv = (
                    compress(ks, vs) if mesh is None
                    else _compress_group_tp(ks, vs, grp.layers, mesh, compress, rope_dense_keys))
            del ks, vs
            dense_k.update(dk)
            dense_v.update(dv)
        elif l not in covered:
            # Ungrouped layers: plain dense cache, post-RoPE K (MLA: the latent).
            kvs = span_kvs([l])
            dense_k[l] = _dense_key(kvs[0][0], cos_p, sin_p, cache_dtype, rope_dense_keys)
            dense_v[l] = kvs[0][1].to(cache_dtype)
        else:
            continue
        b, dev = kvs[0][0].shape[0], kvs[0][0].device
        del kvs
    tail_k, tail_v = init_tail(cfg, b, tail_max, cache_dtype, dev)
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


def _refolded_fields(gf: GroupFactors, grp, hkv: int, k_ext: Optional[torch.Tensor],
                     v_ext: Optional[torch.Tensor], store_k, store_v, svd_kw: dict,
                     sparse_block: Optional[int], cos_f, sin_f) -> dict:
    """The stored fields of a group refactorised over its K and V matrices
    with the tail folded in, ``k_ext`` / ``v_ext`` (b, rows, m) fp32 (None
    for a side the group does not factor): stored as ``store_k`` /
    ``store_v``, mixed factors keeping their int8 / int4 rank split; the
    MLA ``k_rnorm`` from the new stored factors; chunk bounds over
    ``k_ext`` (``hkv`` kv heads a layer) in ``sparse_block``-row chunks (the JAX package derives the
    width from the stored chunk count, ceil(rows / nc), which differs from
    sparse_block once rows are not a multiple of it)."""
    kw = {}
    if k_ext is not None:
        kw.update(_store_k(factorize(k_ext, grp.rank_k, **svd_kw),
                           "int4" if gf.k_us4 is not None else store_k, gf.k_us.shape[2]))
        if gf.k_rnorm is not None:
            kw["k_rnorm"] = latent_rnorm(_k_matrix(GroupFactors(**kw)), len(grp.layers))
        if gf.k_cmin is not None:
            cmin, cmax = chunk_bounds(k_ext, cos_f, sin_f, sparse_block, len(grp.layers) * hkv)
            kw["k_cmin"], kw["k_cmax"] = cmin.to(gf.k_cmin.dtype), cmax.to(gf.k_cmax.dtype)
    if v_ext is not None:
        kw.update(_store_v(factorize(v_ext, grp.rank_v, **svd_kw),
                           "int4" if gf.v_us4 is not None else store_v, gf.v_us.shape[2]))
    return kw


def _refold_group(gf: GroupFactors, grp, cfg: ModelConfig, k_ext, v_ext, store_k, store_v,
                  svd_kw: dict, sparse_block, cos_f, sin_f, mesh, heads: bool,
                  device: torch.device) -> dict:
    """``_refolded_fields`` on one device, or under a ``mesh``: the model
    group joins its columns of the extended matrices (``heads``; the MLA
    latent is whole on every rank), its first rank refactorises and
    broadcasts, and each rank keeps its shard of the fields."""
    if mesh is None:
        return _refolded_fields(gf, grp, cfg.num_kv_heads, k_ext, v_ext, store_k, store_v,
                                svd_kw, sparse_block, cos_f, sin_f)
    g = len(grp.layers)
    if heads:
        k_ext = None if k_ext is None else mesh.gather(k_ext, blocks=g)
        v_ext = None if v_ext is None else mesh.gather(v_ext, blocks=g)
    kw = _on_first_rank(mesh, lambda: _refolded_fields(
        gf, grp, cfg.num_kv_heads * mesh.model, k_ext, v_ext, store_k, store_v, svd_kw,
        sparse_block, cos_f, sin_f), device)
    if heads:
        kw = {k: v for k, v in vars(shard_group_factors(GroupFactors(**kw), g, mesh)).items()
              if v is not None}
    return kw


def refactorize_cache(
    cache: XKVCache,
    xkv: XKVConfig,
    cfg: ModelConfig,
    factor_dtype=torch.bfloat16,
    sparse_block: Optional[int] = None,
    mesh=None,
) -> XKVCache:
    """Fold a FULL decode tail back into the compressed cache: re-run the
    merge over [reconstructed prefill ; tail] per group. Under a ``mesh``
    the model group joins its columns of the extended matrices (MLA: they
    are whole on every rank), its first rank factorises and broadcasts,
    each rank keeps its shard.

    Caller contract: the tail is full (``tail_count == tail_max``). The tail stores post-RoPE
    keys; in "pre" mode they are un-rotated (RoPE by -theta is exact) before
    joining the pre-RoPE factors. The MLA K slot holds the RoPE-free latent,
    which joins as it is; its ``k_rnorm`` is recomputed from the new
    factors. Groups that hold chunk bounds get them recomputed over the
    extended keys in ``sparse_block``-row chunks. Compact SLERP sides are
    rebuilt, joined by their tail rows and compacted again at a budget
    grown by ``tail_max`` (``_refold_compact``), so every row kept before
    and every tail row stays exact; dense SLERP layers take the tail as
    every dense segment does.
    """
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
        k_ext = v_ext = None
        if gf.k_us is not None:
            tail_pre = _stack_group_matrix(
                [unrope(cache.tail_k[l].to(torch.float32)) for l in layers])
            k_ext = torch.cat([_k_matrix(gf), tail_pre], dim=1)
        if gf.v_us is not None:
            tail_v = _stack_group_matrix(
                [cache.tail_v[l].to(torch.float32) for l in layers])
            v_ext = torch.cat([_v_matrix(gf), tail_v], dim=1)
        kw = _refold_group(gf, grp, cfg, k_ext, v_ext, store_dtype, store_dtype, svd_kw,
                           sparse_block, cos_f, sin_f, mesh, rope_keys, device)
        for side, tail in (("slerp_k", cache.tail_k), ("slerp_v", cache.tail_v)):
            sc = getattr(gf, side)
            if sc is not None:
                kw[side] = _refold_compact(sc, [tail[l] for l in layers],
                                           sc.keep_idx.shape[2] + t)
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


def _refold_compact(sc: SlerpCompact, tails: List[torch.Tensor], keep: int,
                    plen: Optional[int] = None) -> SlerpCompact:
    """A compact SLERP side with the group's two tails (b, hkv, t, hd; keys
    post-RoPE, as stored) folded in: both layers rebuilt in fp32, the tail
    rows appended (``plen`` None) or written at rows [plen, plen + t) of a
    slot's fixed row space, compacted again with ``keep`` exact rows;
    ``base`` and ``keep_rows`` in their stored dtype."""
    xs = []
    for pos, tail in enumerate(tails):
        x = compact_reconstruct(sc, pos, torch.float32)
        if plen is None:
            x = torch.cat([x, tail.to(torch.float32)], dim=2)
        else:
            x[:, :, plen:plen + tail.shape[2]] = tail
        xs.append(x)
    new = compact_pair(xs[0], xs[1], keep)
    return dataclasses.replace(new, base=new.base.to(sc.base.dtype),
                               keep_rows=new.keep_rows.to(sc.keep_rows.dtype))


# ------------------------------------------------------ continuous batching
def _slot_view(x, slot: int):
    if x is None:
        return None
    if isinstance(x, SlerpCompact):
        return SlerpCompact(**{f.name: _slot_view(getattr(x, f.name), slot)
                               for f in dataclasses.fields(SlerpCompact)})
    return x[slot:slot + 1]


def slot_fields(gf: GroupFactors, slot: int) -> GroupFactors:
    """The group's factors of one slot of a batched (slot) cache: views
    [slot:slot+1] of every field (compact SLERP storage field by field),
    so a write into one lands in the slot."""
    return GroupFactors(**{f.name: _slot_view(getattr(gf, f.name), slot)
                           for f in dataclasses.fields(GroupFactors)})


def put_slot(dst: torch.Tensor, slot: int, src: torch.Tensor) -> None:
    """Write ``src`` (1, ...) into row ``slot`` of ``dst`` (B, ...) IN
    PLACE: the slot is zeroed, then ``src`` fills its leading corner. A
    bucket-sized admission so leaves the slot's rows past the bucket (and
    rank columns past a bucket-clamped rank) zero, as the JAX package's
    zero padding to ``s_max`` does, whatever an earlier request left
    there: the refold's SVD reads the slot's whole row space."""
    view = dst[slot]
    view.zero_()
    view[tuple(slice(0, n) for n in src.shape[1:])].copy_(src[0])


def refactorize_slot_cache(
    cache: XKVCache,
    xkv: XKVConfig,
    cfg: ModelConfig,
    slot: int,
    plen: int,
    sparse_block: Optional[int] = None,
    mesh=None,
) -> XKVCache:
    """Fold ONE slot's full decode tail back into its factors, IN PLACE
    within the slot's static row capacity (continuous batching; JAX
    ``refactorize_slot_cache``).

    The tail rows take rows [plen, plen + tail_max) of the slot's
    s_max-row factor space; rows past the slot's length are zero (zero
    rows of U), so they are free to occupy. Every write is a copy into the
    existing slot tensors, which a captured batched step reads by address:
    nothing is reallocated. Caller contract: the slot's tail is full and
    ``plen + tail_max <= s_max``. Groups holding chunk bounds get them
    recomputed over the slot's keys in ``sparse_block``-row chunks, the
    width decode gathers (the JAX package re-derives the width as
    ceil(s_max / n_chunks), another width once s_max is not a multiple of
    the block: ROADMAP queue 3). Factor shapes, dtypes and the int8 /
    int4 rank split stay the slot's. A compact SLERP side is rebuilt, takes
    the tail at rows [plen, plen + tail_max) and is compacted again at the
    slot's FIXED budget D (``BatchedEngine`` sizes it for the admission's
    rows and one fold): past it the rows of least angle are
    re-approximated. Under a ``mesh`` the ranks of the data row that holds
    the slot (``slot`` its index there) fold it: the model group joins its
    columns of the slot's matrices, its first rank factorises and
    broadcasts, each rank keeps its shard (``refactorize_cache``)."""
    t = cache.tail_max
    s_max = cache.prefill_len
    if plen + t > s_max:
        raise ValueError(f"slot refold past s_max: {plen} + {t} > {s_max}")
    device = cache.tail_k.device
    rope_keys = _rope_keys(cfg)
    rope_post = xkv.rope_mode == "post" and rope_keys
    svd_kw = _svd_kw(xkv)
    bounded = any(g.k_cmin is not None for g in cache.groups)
    if bounded and sparse_block is None:
        raise ValueError("the cache holds chunk bounds: pass sparse_block")
    cos_f = sin_f = None
    if bounded and not rope_post:
        cos_f, sin_f = rope_cos_sin(torch.arange(s_max, device=device), cfg.head_dim,
                                    cfg.rope_theta, cfg.rope_scaling)
    cos_t = sin_t = None
    if rope_keys and not rope_post:
        cos_t, sin_t = rope_cos_sin(plen + torch.arange(t, device=device), cfg.head_dim,
                                    cfg.rope_theta, cfg.rope_scaling)

    def unrope(k):
        return k if cos_t is None else apply_rope(k, cos_t[None], -sin_t[None])

    for grp, gf in zip(xkv.layer_groups, cache.groups):
        layers = grp.layers
        one = slot_fields(gf, slot)
        k_ext = v_ext = None
        if gf.k_us is not None:
            k_ext = _k_matrix(one)
            k_ext[:, plen:plen + t] = _stack_group_matrix(
                [unrope(cache.tail_k[l][slot:slot + 1].to(torch.float32)) for l in layers])
        if gf.v_us is not None:
            v_ext = _v_matrix(one)
            v_ext[:, plen:plen + t] = _stack_group_matrix(
                [cache.tail_v[l][slot:slot + 1].to(torch.float32) for l in layers])
        # The slot's own storage dtypes (int8 scales mark quantised sides).
        store_k = "int8" if gf.k_scale is not None else getattr(gf.k_us, "dtype", None)
        store_v = "int8" if gf.v_scale is not None else getattr(gf.v_us, "dtype", None)
        kw = _refold_group(gf, grp, cfg, k_ext, v_ext, store_k, store_v, svd_kw, sparse_block,
                           cos_f, sin_f, mesh, rope_keys, device)
        for name, src in kw.items():
            put_slot(getattr(gf, name), slot, src)
        for side, tail in (("slerp_k", cache.tail_k), ("slerp_v", cache.tail_v)):
            sc = getattr(one, side)
            if sc is not None:
                new = _refold_compact(sc, [tail[l][slot:slot + 1] for l in layers],
                                      sc.keep_idx.shape[2], plen)
                # Same shapes (D is fixed): a copy into the slot's views.
                for f in dataclasses.fields(SlerpCompact):
                    getattr(sc, f.name).copy_(getattr(new, f.name))

    # Dense segments hold the tail's storage form already (post-RoPE keys,
    # MLA: the latent and rotated k_pe): its rows are copied in.
    for dense, tail in ((cache.dense_k, cache.tail_k), (cache.dense_v, cache.tail_v)):
        for l, dst in dense.items():
            dst[slot, :, plen:plen + t].copy_(tail[l][slot])
    # An empty slot tail keeps rows past the slot's tail_len zero.
    cache.tail_k[:, slot].zero_()
    cache.tail_v[:, slot].zero_()
    return cache
