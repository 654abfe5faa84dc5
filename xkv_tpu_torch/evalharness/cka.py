"""Centered linear CKA between layers' K/V projections + grouping tool.

The port's counterpart of ``xkv_tpu/evalharness/cka.py`` (the reference's
CKA notebook and offline grouping script):
  * per-layer pre-RoPE K (or V) on a calibration prompt, from a frozen
    prefill (K1 on the card; reference `scripts/cka_similarity_analysis
    .ipynb` cells 4-8 hook the HF modules);
  * centered linear CKA (Kornblith et al.) between every layer pair
    (notebook cell 13);
  * average-linkage (UPGMA) clustering of the dissimilarity, with optional
    index-distance weighting and forced contiguity, emitting an xKV config
    (reference `group_layers.py:9-80`). The JAX package clusters with
    ``sklearn``'s ``AgglomerativeClustering``; the card's machine has no
    ``sklearn``, so the clustering is written here (``average_linkage``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from xkv_tpu_torch.configs import LayerGroup, XKVConfig


def linear_cka_centered(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Centered linear CKA between (n, d1) and (n, d2) feature matrices."""
    x = x - x.mean(dim=0, keepdim=True)
    y = y - y.mean(dim=0, keepdim=True)
    xty = x.T @ y
    hsic = torch.sum(xty * xty)
    norm_x = torch.linalg.norm(x.T @ x)
    norm_y = torch.linalg.norm(y.T @ y)
    return hsic / (norm_x * norm_y + 1e-12)


@torch.no_grad()
def collect_kv_features(params, cfg, tokens: torch.Tensor, which: str = "k") -> List[torch.Tensor]:
    """Per-layer pre-RoPE K (or V) features on a calibration prompt
    (tokens (1, s)), flattened to (seq, hkv*hd) fp32."""
    from xkv_tpu_torch.compress.svd import heads_to_matrix
    from xkv_tpu_torch.models import llama

    _, kvs = llama.prefill(params, cfg, tokens, logits_position=0)
    idx = 0 if which == "k" else 1
    return [heads_to_matrix(kv[idx])[0].to(torch.float32) for kv in kvs]


def cka_matrix(features: List[torch.Tensor]) -> np.ndarray:
    """Pairwise CKA similarity matrix over layers (float64, host)."""
    n = len(features)
    sim = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for j in range(i, n):
            v = float(linear_cka_centered(features[i], features[j]))
            sim[i, j] = sim[j, i] = v
    return sim


def average_linkage(dissim: np.ndarray, n_clusters: int) -> np.ndarray:
    """Average-linkage (UPGMA) agglomerative clustering of a precomputed
    dissimilarity (its upper triangle), stopped at ``n_clusters``: the
    clusters ``sklearn``'s ``AgglomerativeClustering(metric="precomputed",
    linkage="average")`` cuts its tree into (the linkage is monotone, so
    undoing its last n_clusters - 1 merges is stopping before them). Ties
    merge the first pair in row order. Returns one label per item,
    numbered by each cluster's first item."""
    n = dissim.shape[0]
    if not 1 <= n_clusters <= n:
        raise ValueError(f"cannot cut {n} items into {n_clusters} clusters")
    d = np.array(dissim, dtype=np.float64)  # read and updated at [min, max] only

    def dist(a: int, b: int) -> float:
        return d[min(a, b), max(a, b)]

    members = {i: [i] for i in range(n)}
    for _ in range(n - n_clusters):
        alive = sorted(members)
        _, a, b = min((dist(a, b), a, b) for i, a in enumerate(alive) for b in alive[i + 1:])
        na, nb = len(members[a]), len(members[b])
        for c in alive:
            if c not in (a, b):
                d[min(a, c), max(a, c)] = (na * dist(a, c) + nb * dist(b, c)) / (na + nb)
        members[a] += members.pop(b)
    labels = np.empty(n, dtype=np.int64)
    for k, a in enumerate(sorted(members)):
        labels[members[a]] = k
    return labels


def group_layers_from_cka(
    sim: np.ndarray,
    n_groups: int,
    index_distance_scale: Optional[float] = None,
) -> List[List[int]]:
    """Agglomerative clustering + forced contiguity
    (reference `group_layers.py:13-55`)."""
    n = sim.shape[0]
    weighted = sim.copy()
    if index_distance_scale is not None:
        idx = np.arange(n)
        weight = np.exp(-np.abs(idx[:, None] - idx[None, :]) / index_distance_scale)
        weighted = weighted * weight
    dissim = 1.0 - weighted
    np.fill_diagonal(dissim, 0.0)
    labels = average_linkage(dissim, n_groups)

    # Force contiguity: only adjacent layers with the same label share a group.
    groups: List[List[int]] = [[0]]
    for i in range(1, n):
        if labels[i] == labels[i - 1]:
            groups[-1].append(i)
        else:
            groups.append([i])
    return groups


def make_grouped_config(
    groups: List[List[int]],
    num_layers: int,
    rank_k: int,
    rank_v: int,
    merge_key: bool = True,
    merge_value: bool = True,
) -> XKVConfig:
    """Emit an xKV config from CKA-derived groups (singleton groups are kept
    as grouped layers with per-layer SVD, matching the reference's emitted
    YAML structure, `group_layers.py:58-80`)."""
    return XKVConfig(
        num_layers=num_layers,
        layer_merge_impl="svd",
        rank_k=rank_k,
        rank_v=rank_v,
        merge_key=merge_key,
        merge_value=merge_value,
        layer_groups=[LayerGroup(layers=list(g)) for g in groups],
    )
