"""Prompt-cache persistence: save a compressed cache to disk and load it.

Port of ``xkv_tpu/engine/cache_io.py`` in its file format, so a file
passes between the two packages in either direction: one ``.npz`` of the
cache's leaves ``leaf_{i}`` in the JAX
pytree's leaf order, and a JSON sidecar ``path + '.json'`` with
``format_version`` (1), ``treedef`` (a string; each package writes its
own and neither reads it), ``num_leaves``, ``dtypes`` and ``metadata``.

Leaf order (``cache_leaves``): each group's fields that are not None, in
``GroupFactors`` declaration order (the JAX package's), a compact SLERP
side (``SlerpCompact``) as its four leaves ``base``, ``norms``,
``keep_idx``, ``keep_rows`` at its field's place (flax's flattening of
the nested dataclass); then ``dense_k`` and ``dense_v`` by ascending
layer; then ``tail_k``, ``tail_v`` and ``tail_len``. A bf16 leaf is
stored as numpy stores the JAX package's bfloat16 arrays: raw 2-byte
void (``|V2``), its dtype named in the sidecar only, and read back by
its bits. (The JAX ``load_cache`` cannot
cast such a leaf, so it cannot read a bf16 cache, its own included:
ROADMAP queue 3.)

The port writes the ``.npz`` stored (``np.savez``), where the JAX package
deflates it (``np.savez_compressed``); ``np.load`` reads both. The
factors' bf16 and int8 values leave zlib little to take (0.79 of the
bytes of a bf16 cache, 0.86 of an int8 one), at 7-9 MB/s a core: 25-28 s
to save an 8B cache of 8192 tokens and 96-110 s a MiniCache one on the
host of an NVIDIA H100 80GB HBM3 (700.00 W; ``chip_smoke.py``'s
persistence lines).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from xkv_tpu_torch.cache import GroupFactors, SlerpCompact, XKVCache

_FORMAT_VERSION = 1
_COMPACT_FIELDS = [f.name for f in dataclasses.fields(SlerpCompact)]


def _group_fields(g: GroupFactors) -> List[str]:
    return [f.name for f in dataclasses.fields(GroupFactors) if getattr(g, f.name) is not None]


def _field_leaves(x) -> List[torch.Tensor]:
    if isinstance(x, SlerpCompact):
        return [getattr(x, name) for name in _COMPACT_FIELDS]
    return [x]


def cache_leaves(cache: XKVCache) -> List[torch.Tensor]:
    """The cache's tensors in the JAX pytree's leaf order."""
    leaves = [leaf for g in cache.groups for name in _group_fields(g)
              for leaf in _field_leaves(getattr(g, name))]
    leaves += [cache.dense_k[l] for l in sorted(cache.dense_k)]
    leaves += [cache.dense_v[l] for l in sorted(cache.dense_v)]
    return leaves + [cache.tail_k, cache.tail_v, cache.tail_len]


def _treedef(cache: XKVCache) -> str:
    groups = ", ".join("(" + ", ".join(_group_fields(g)) + ")" for g in cache.groups)
    return (f"XKVCache(groups=[{groups}], dense_k={sorted(cache.dense_k)}, "
            f"dense_v={sorted(cache.dense_v)}, tail_k, tail_v, tail_len)")


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, stored: str, like: torch.Tensor) -> torch.Tensor:
    """A stored leaf as a tensor of ``like``'s dtype on its device (the
    JAX ``load_cache`` casts to the reference leaf's dtype too)."""
    if stored == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, dtype=np.dtype(stored)))
    return t.to(device=like.device, dtype=like.dtype)


def save_cache(cache: XKVCache, path: str, metadata: Optional[dict] = None) -> None:
    """Write ``cache`` to ``path`` (.npz; numpy adds the suffix when it is
    missing) and the sidecar ``path + '.json'``."""
    pairs = [_to_numpy(t) for t in cache_leaves(cache)]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{f"leaf_{i}": a for i, (a, _) in enumerate(pairs)})
    sidecar = {
        "format_version": _FORMAT_VERSION,
        "treedef": _treedef(cache),
        "num_leaves": len(pairs),
        "dtypes": [d for _, d in pairs],
        "metadata": metadata or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=2)


def load_cache(path: str, like: XKVCache) -> Tuple[XKVCache, dict]:
    """Load a cache saved by ``save_cache`` (this package's or the JAX
    package's). ``like`` gives the structure, dtypes and device: a cache of
    the same engine and configuration (a fresh prefill's, or the cache
    being restored). Leaf counts and shapes are held against it. Returns
    (the cache, the sidecar's metadata); ``tail_count`` is read from the
    stored ``tail_len``."""
    with open(path + ".json") as f:
        sidecar = json.load(f)
    if sidecar["format_version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported cache format {sidecar['format_version']}")
    refs = cache_leaves(like)
    if len(refs) != sidecar["num_leaves"]:
        raise ValueError(
            f"cache structure mismatch: {len(refs)} leaves vs stored "
            f"{sidecar['num_leaves']} (different xkv config / model?)")
    loaded = []
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for i, ref in enumerate(refs):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i} shape mismatch: stored {arr.shape} vs expected "
                                 f"{tuple(ref.shape)}")
            loaded.append(_from_numpy(arr, sidecar["dtypes"][i], ref))
    it = iter(loaded)

    def field(x):
        if isinstance(x, SlerpCompact):
            return SlerpCompact(**{name: next(it) for name in _COMPACT_FIELDS})
        return next(it)

    groups = tuple(dataclasses.replace(g, **{name: field(getattr(g, name))
                                             for name in _group_fields(g)})
                   for g in like.groups)
    dense_k = {l: next(it) for l in sorted(like.dense_k)}
    dense_v = {l: next(it) for l in sorted(like.dense_v)}
    tail_k, tail_v, tail_len = next(it), next(it), next(it)
    return XKVCache(groups=groups, dense_k=dense_k, dense_v=dense_v, tail_k=tail_k,
                    tail_v=tail_v, tail_len=tail_len, tail_count=int(tail_len)), \
        sidecar["metadata"]
