"""Calibration data samplers (reference `xKV/utils/data_utils.py:9-43`).

The port's counterpart of ``xkv_tpu/utils/data_utils.py``: the same
sources, chunks and cache file. The synthetic text comes from the port's
own RULER word lists; ``wikitext2`` and ``c4`` import ``datasets`` where
they need it, and a missing package raises ``ImportError`` naming it.
Always returns numpy token chunks, cached to ``.npz``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _load_dataset(*args, **kwargs):
    try:
        from datasets import load_dataset
    except ImportError as e:
        raise ImportError("the wikitext2 and c4 calibration sets need the 'datasets' "
                          "package; use name='synthetic' or name='file'") from e
    return load_dataset(*args, **kwargs)


def get_calib_data(
    name: str,
    tokenizer,
    nsamples: int = 16,
    seqlen: int = 2048,
    seed: int = 3,
    cache_dir: str = "cache",
    text_file: Optional[str] = None,
) -> np.ndarray:
    """Returns (nsamples, seqlen) int32 token chunks for calibration.

    name: "wikitext2" | "c4" (HF hub) | "synthetic" | "file" (with text_file).
    """
    os.makedirs(cache_dir, exist_ok=True)
    cache_path = os.path.join(
        cache_dir, f"calib_{name}_{nsamples}_{seqlen}_{seed}.npz"
    )
    if os.path.exists(cache_path):
        return np.load(cache_path)["tokens"]

    rng = np.random.default_rng(seed)
    if name == "synthetic":
        import random

        from xkv_tpu_torch.evalharness.ruler.wordlists import essay_words

        text = " ".join(
            essay_words(random.Random(seed), approx_words=nsamples * seqlen * 2)
        )
    elif name == "file":
        if not text_file:
            raise ValueError("name='file' requires text_file")
        with open(text_file) as f:
            text = f.read()
    elif name == "wikitext2":
        ds = _load_dataset("wikitext", "wikitext-2-raw-v1", split="train")
        text = "\n\n".join(r["text"] for r in ds)
    elif name == "c4":
        ds = _load_dataset("allenai/c4", "en", split="train", streaming=True)
        pieces = []
        for i, row in enumerate(ds):
            pieces.append(row["text"])
            if i >= nsamples * 4:
                break
        text = "\n\n".join(pieces)
    else:
        raise ValueError(f"unknown calib set {name!r}")

    ids = np.asarray(tokenizer.encode(text), np.int32)
    if len(ids) < nsamples * seqlen:
        reps = int(np.ceil(nsamples * seqlen / len(ids)))
        ids = np.tile(ids, reps)
    starts = rng.integers(0, len(ids) - seqlen, size=nsamples)
    chunks = np.stack([ids[s : s + seqlen] for s in starts])
    np.savez_compressed(cache_path, tokens=chunks)
    return chunks
