"""Tensor parallelism over kv heads and q heads, and data parallelism over
batch rows: which slice of each weight and of the compressed cache a rank
of the (data, model) mesh holds.

Port of ``xkv_tpu/parallel/sharding.py``'s parameter rules
(``param_pspecs``, ``shard_params``): Megatron-style splits on the model
axis, in the JAX table's terms, each weight's split dimension (``None``
replicated):
  * ``wq`` / ``wk`` / ``wv`` by columns (heads; their biases with them),
    ``wo`` by rows: each rank's attention is complete for its heads, and
    the ``wo`` products are partial sums (an ``all_reduce``);
  * ``w_gate`` / ``w_up`` by columns, ``w_down`` by rows (an ``all_reduce``);
  * ``lm_head`` by columns (the logits' vocabulary, joined across ranks);
  * the norms and ``embed`` replicated;
  * DeepSeek MLA: ``q_proj`` / ``q_b_proj`` / ``kv_b_proj`` by columns (q
    heads), ``o_proj`` by rows, the latent's projections and norms
    replicated; the routed experts split by expert (expert parallelism),
    or replicated where they do not divide the model axis (the JAX
    ``_mlp`` then runs every expert); the shared experts and the dense
    layers' FFN as ``w_gate`` / ``w_up`` / ``w_down``.
Weights are replicated on the data axis.

The cache layout follows the kernels' ``*_tp`` in_specs (JAX
``rankspace_attention.py:952-957``, ``lowrank_attention.py:792-797``),
not ``cache_pspecs`` (the JAX XLA path's rank split,
``xkv_tpu/parallel/sharding.py:92-117``): the kernels run unchanged on a
rank's heads only if a rank holds whole kv heads. So a rank holds
  * ``k_us`` / ``v_us`` / ``k_us4`` / ``v_us4`` (and ``v_scale``, per rank
    of the SVD) replicated on the model axis: every rank holds the same
    factors by construction (the model group's first rank computes them
    and broadcasts them);
  * of every column field (``COLUMN_FIELDS``: ``k_vt``, ``v_vt``,
    ``k_scale``, ``k_vt4``, ``k_scale4``, the Quest bounds ``k_cmin`` /
    ``k_cmax``, laid out (layer, kv head, dim) over the group's layers)
    its kv heads' block of each layer slice, joined in layer order: the
    group's columns as if it had ``hkv / model`` kv heads, so
    ``cache.vt_layer_slice`` with the local head count reads a rank's
    slice of a layer;
  * the dense segments and the decode tail by kv head;
  * MLA: everything replicated on the model axis (the latent, its factors
    and ``k_pe`` have no kv heads);
and on the data axis, in every leaf, the data rank's batch rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from xkv_tpu_torch.cache import GroupFactors, XKVCache
from xkv_tpu_torch.parallel.mesh import Mesh

# The split dimension of each attention weight (JAX ``_ATTN``).
_ATTN = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0, "bv": 0,
    "kv_a_proj": None, "kv_a_norm": None, "kv_b_proj": 1, "o_proj": 0,
    "q_proj": 1, "q_a_proj": None, "q_a_norm": None, "q_b_proj": 1,
}
_FFN = {"w_gate": 1, "w_up": 1, "w_down": 0}

# GroupFactors fields laid out over the group's (layer, kv head, dim)
# columns; the others are replicated.
COLUMN_FIELDS = ("k_vt", "v_vt", "k_scale", "k_vt4", "k_scale4", "k_cmin", "k_cmax")


def param_pspecs(params: Dict[str, Any], model: Optional[int] = None) -> Dict[str, Any]:
    """The split dimension (on the model axis) of every weight of a
    ``llama.init_params`` / ``deepseek.init_params`` tree, ``None`` where
    it is replicated; the tree's structure. With ``model`` (the axis's
    size) routed experts that do not divide it are replicated."""

    def mlp_spec(mlp):
        if "router" not in mlp:
            return dict(_FFN)
        # MoE: experts split over the model axis (expert parallelism).
        n_exp = mlp["router"].shape[-1]
        ep = None if model is not None and n_exp % model else 0
        spec = {"router": None, "experts": {k: ep for k in _FFN}}
        if "shared" in mlp:
            spec["shared"] = dict(_FFN)
        return spec

    def layer_spec(layer):
        return {"attn": {k: _ATTN[k] for k in layer["attn"]}, "mlp": mlp_spec(layer["mlp"]),
                "input_norm": None, "post_norm": None}

    specs: Dict[str, Any] = {"embed": None, "layers": [layer_spec(l) for l in params["layers"]],
                             "final_norm": None}
    if "lm_head" in params:
        specs["lm_head"] = 1
    return specs


def shard_tensor(x: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (a copy, so the whole can be
    freed), or ``x`` itself when replicated."""
    if dim is None or mesh.model == 1:
        return x
    n = x.shape[dim]
    if n % mesh.model:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split {mesh.model} ways")
    w = n // mesh.model
    return x.narrow(dim, mesh.model_rank * w, w).clone()


def shard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's slices of ``params`` (``param_pspecs``)."""

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, s) for v, s in zip(tree, spec)]
        return shard_tensor(tree, spec, mesh)

    return walk(params, param_pspecs(params, mesh.model))


def local_columns(x: torch.Tensor, blocks: int, mesh: Mesh) -> torch.Tensor:
    """This rank's columns of (..., blocks * model * w), laid out (block,
    rank, w): (..., blocks * w), a copy; ``Mesh.gather`` inverts it."""
    if mesh.model == 1:
        return x
    w = x.shape[-1] // (blocks * mesh.model)
    x = x.reshape(*x.shape[:-1], blocks, mesh.model, w)[..., :, mesh.model_rank, :]
    return x.reshape(*x.shape[:-2], blocks * w).contiguous()


def shard_group_factors(gf: GroupFactors, layers: int, mesh: Mesh) -> GroupFactors:
    """A group's factors as a rank holds them: every column field
    (``COLUMN_FIELDS``) reduced to the rank's kv heads' block of each of
    the ``layers`` layer slices, the rest replicated."""
    return GroupFactors(**{
        name: (local_columns(val, layers, mesh) if name in COLUMN_FIELDS and val is not None
               else val)
        for name, val in vars(gf).items()})


def shard_heads(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """This rank's kv heads of a (b, hkv, s, hd) dense segment."""
    return shard_tensor(x, dim, mesh)


def _map_cache(cache: XKVCache, group_layers, heads: bool, cols, by_head, rows) -> XKVCache:
    """``cache`` with every leaf mapped: a group's column fields by
    ``cols(x, layers)`` (kv-head layouts only), the dense segments and the
    tail by ``by_head(x, dim)`` (the kv-head dim; kv-head layouts only),
    then every leaf by ``rows(x, dim)`` (the batch dim)."""

    def group(gf, g):
        out = {}
        for name, val in vars(gf).items():
            if val is not None and heads and name in COLUMN_FIELDS:
                val = cols(val, g)
            out[name] = None if val is None else rows(val, 0)
        return GroupFactors(**out)

    def dense(x):
        return rows(by_head(x, 1) if heads else x, 0)

    return dataclasses.replace(
        cache, groups=tuple(group(gf, g) for gf, g in zip(cache.groups, group_layers)),
        dense_k={l: dense(x) for l, x in cache.dense_k.items()},
        dense_v={l: dense(x) for l, x in cache.dense_v.items()},
        tail_k=rows(by_head(cache.tail_k, 2) if heads else cache.tail_k, 1),
        tail_v=rows(by_head(cache.tail_v, 2) if heads else cache.tail_v, 1))


def shard_cache(cache: XKVCache, group_layers, mesh: Mesh, heads: bool = True) -> XKVCache:
    """This rank's shard of a whole cache (``group_layers``: the layer
    count of each group, in order; ``heads=False`` for MLA, whose leaves
    have no kv heads): its data rows of every leaf, and with ``heads`` its
    kv heads' columns and heads."""
    return _map_cache(cache, group_layers, heads,
                      lambda x, g: local_columns(x, g, mesh),
                      lambda x, dim: shard_tensor(x, dim, mesh),
                      lambda x, dim: mesh.rows(x, dim).clone())


def gather_cache(cache: XKVCache, group_layers, mesh: Mesh, heads: bool = True) -> XKVCache:
    """The whole cache joined from every rank's shard (every rank gets it):
    ``shard_cache`` inverted, over the model axis (with ``heads``) and the
    data axis. For checks of the sharded engine against one device's."""
    return _map_cache(cache, group_layers, heads,
                      lambda x, g: mesh.gather(x, blocks=g),
                      lambda x, dim: mesh.gather(x, dim=dim),
                      lambda x, dim: mesh.gather_rows(x, dim))
