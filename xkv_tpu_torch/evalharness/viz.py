"""Result visualization: NIAH heatmap + KV-cache statistics plots.

Port of ``xkv_tpu/evalharness/viz.py`` (the reference's
`evaluate/data/niah/viz.py:55+`, a needle-in-a-haystack score heatmap
over depth x context length, and `src/utils/kv_visualizer.py`, per-layer
KV statistics). The arrays are numpy's, as in the JAX package; KV inputs
may be torch tensors (any device, any float dtype: read as fp32 on the
host) or numpy arrays. Matplotlib is imported lazily, inside each plot, so
importing this module does not load it (the card's machine has none).
"""

from __future__ import annotations

import json
from typing import List

import numpy as np


def _host_fp32(x) -> np.ndarray:
    """A tensor or array as a host fp32 numpy array."""
    if hasattr(x, "detach"):  # a torch tensor
        import torch

        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_needle_viz(
    records: List[dict],
    out_path: str,
    title: str = "Needle-in-a-Haystack",
    depth_buckets: int = 10,
    length_buckets: int = 8,
):
    """Heatmap of NIAH scores over (depth %, context length).

    records: [{"score": float, "depth_pct": float, "ctx_len": int}].
    """
    plt = _pyplot()
    depths = np.array([r.get("depth_pct", 0.0) for r in records], float)
    lens = np.array([r.get("ctx_len", r.get("prompt_len", 0)) for r in records], float)
    scores = np.array([r["score"] for r in records], float)

    d_edges = np.linspace(0, 100, depth_buckets + 1)
    l_edges = np.linspace(lens.min(), lens.max() + 1, length_buckets + 1)
    grid = np.full((depth_buckets, length_buckets), np.nan)
    for i in range(depth_buckets):
        for j in range(length_buckets):
            m = (
                (depths >= d_edges[i]) & (depths < d_edges[i + 1])
                & (lens >= l_edges[j]) & (lens < l_edges[j + 1])
            )
            if m.any():
                grid[i, j] = scores[m].mean()

    fig, ax = plt.subplots(figsize=(10, 6))
    im = ax.imshow(grid, aspect="auto", origin="lower", cmap="RdYlGn", vmin=0, vmax=1)
    ax.set_xlabel("context length")
    ax.set_ylabel("needle depth (%)")
    ax.set_xticks(range(length_buckets))
    ax.set_xticklabels([f"{int(l)}" for l in l_edges[:-1]], rotation=45)
    ax.set_yticks(range(depth_buckets))
    ax.set_yticklabels([f"{int(d)}" for d in d_edges[:-1]])
    ax.set_title(title)
    fig.colorbar(im, label="score")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_needle_viz_from_jsonl(jsonl_path: str, out_path: str, **kw):
    with open(jsonl_path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    return plot_needle_viz(records, out_path, **kw)


def plot_kv_stats(
    kv,
    out_path: str,
    title: str = "KV cache statistics",
):
    """Per-layer mean/std/absmax of a collected KV tensor (b, layers, seq,
    features) + a layer x seq magnitude heatmap (reference
    `src/utils/kv_visualizer.py`)."""
    plt = _pyplot()
    kv = _host_fp32(kv)
    L = kv.shape[1]
    mean = kv.mean(axis=(0, 2, 3))
    std = kv.std(axis=(0, 2, 3))
    amax = np.abs(kv).max(axis=(0, 2, 3))
    mag = np.abs(kv).mean(axis=(0, 3))  # (layers, seq): mean over batch and features

    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    x = np.arange(L)
    axes[0].plot(x, mean, label="mean")
    axes[0].plot(x, std, label="std")
    axes[0].plot(x, amax, label="absmax")
    axes[0].set_xlabel("layer")
    axes[0].legend()
    axes[0].set_title("per-layer stats")

    im = axes[1].imshow(mag, aspect="auto", cmap="viridis")
    axes[1].set_xlabel("sequence position")
    axes[1].set_ylabel("layer")
    axes[1].set_title("|KV| heatmap")
    fig.colorbar(im, ax=axes[1])
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_singular_value_spectrum(
    kvs, out_path: str, max_layers: int = 8, title: str = "KV singular values"
):
    """Spectra of per-layer K matrices (each (b, h, s, d), a tensor or an
    array): the empirical case for cross-layer low-rank compression."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 5))
    for li, (k, _v) in enumerate(kvs[:max_layers]):
        mat = _host_fp32(k)
        b, h, s, d = mat.shape
        mat = mat.transpose(0, 2, 1, 3).reshape(b * s, h * d)
        sv = np.linalg.svd(mat, compute_uv=False)
        ax.semilogy(sv / sv[0], label=f"layer {li}")
    ax.set_xlabel("singular value index")
    ax.set_ylabel("normalized magnitude")
    ax.legend(fontsize=7)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
