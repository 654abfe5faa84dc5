"""Tensor parallelism over kv heads: which slice of each weight and of the
compressed cache a rank of the model axis holds.

Port of ``xkv_tpu/parallel/sharding.py``'s parameter rules
(``param_pspecs``, ``shard_params``): Megatron-style splits, in the JAX
table's terms, each weight's split dimension (``None`` replicated):
  * ``wq`` / ``wk`` / ``wv`` by columns (heads; their biases with them),
    ``wo`` by rows: each rank's attention is complete for its heads, and
    the ``wo`` products are partial sums (an ``all_reduce``);
  * ``w_gate`` / ``w_up`` by columns, ``w_down`` by rows (an ``all_reduce``);
  * ``lm_head`` by columns (the logits' vocabulary, joined across ranks);
  * the norms and ``embed`` replicated;
  * the DeepSeek MLA / MoE entries as the JAX table has them (the engine
    refuses MLA under a mesh: ROADMAP item 17).

The cache layout follows the kernels' ``*_tp`` in_specs, not
``cache_pspecs`` (the JAX XLA path's rank split,
``xkv_tpu/parallel/sharding.py:93-122``): the kernels run unchanged on a
rank's heads only if a rank holds whole kv heads (JAX
``lowrank_attention.py:636-639``: "each shard holds its kv heads' V^T
columns (a contiguous column block of the layer slice), the full ``us``
coordinates (replicated ...)"). So a rank holds
  * ``k_us`` / ``v_us`` (and ``v_scale``, per rank of the SVD) replicated:
    every rank holds the same factors by construction (rank 0 computes
    them and broadcasts them);
  * of every column field (``k_vt``, ``v_vt``, ``k_scale``, laid out
    (layer, kv head, dim) over the group's layers) its kv heads' block of
    each layer slice, joined in layer order: the group's columns as if it
    had ``hkv / model`` kv heads, so ``cache.vt_layer_slice`` with the
    local head count reads a rank's slice of a layer;
  * the dense segments and the decode tail by kv head.
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


def param_pspecs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The split dimension (on the model axis) of every weight of a
    ``llama.init_params`` / ``deepseek.init_params`` tree, ``None`` where
    it is replicated; the tree's structure."""

    def mlp_spec(mlp):
        if "router" not in mlp:
            return dict(_FFN)
        # MoE: experts split over the model axis (expert parallelism).
        spec = {"router": None, "experts": {k: 0 for k in _FFN}}
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

    return walk(params, param_pspecs(params))


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


def gather_cache(cache: XKVCache, group_layers, mesh: Mesh) -> XKVCache:
    """The whole cache joined from every rank's shard (every rank gets it):
    the inverse of the layout above. ``group_layers``: the layer count of
    each group, in order. For checks of the sharded engine against one
    device's."""
    groups = tuple(
        GroupFactors(**{name: (mesh.gather(val, blocks=g)
                               if name in COLUMN_FIELDS and val is not None else val)
                        for name, val in vars(gf).items()})
        for gf, g in zip(cache.groups, group_layers))
    return dataclasses.replace(
        cache, groups=groups,
        dense_k={l: mesh.gather(x, dim=1) for l, x in cache.dense_k.items()},
        dense_v={l: mesh.gather(x, dim=1) for l, x in cache.dense_v.items()},
        tail_k=mesh.gather(cache.tail_k, dim=2), tail_v=mesh.gather(cache.tail_v, dim=2))
