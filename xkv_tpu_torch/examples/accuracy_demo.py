"""Accuracy-vs-compression demo, fully offline.

Port of ``examples/accuracy_demo.py``. Trains a tiny induction model
(sequences ``[bos, x, x]``: continuing the second copy requires attending
back through the KV cache, the mechanism RULER's needle tasks measure),
then sweeps the xKV rank and reports recall accuracy through the factored
engine.

Training runs in fp32 (``train_lm``, plain attention). The JAX example
serves fp32 weights, cache and factors; the card's decode kernels take
bf16 (or int8) factors, so on ``cuda`` the trained weights, the cache and
the factors are bf16, and on the CPU they stay fp32. On the card prefill
runs K1 and factored decode K3 (head size 24 zero-padded to 64, small
ranks padded to the kernels' layout).

Run:  python -m xkv_tpu_torch.examples.accuracy_demo [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np
import torch

from xkv_tpu_torch.configs import generate_consecutive_xkv_config
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.models.config import tiny_llama_config
from xkv_tpu_torch.models.llama import init_params
from xkv_tpu_torch.train.lm import train_lm, tree_map

M = 24
CFG = tiny_llama_config(
    vocab_size=64, hidden_size=96, intermediate_size=192,
    num_layers=3, num_q_heads=4, num_kv_heads=2, head_dim=24,
)
FULL_RANK = 2 * CFG.num_kv_heads * CFG.head_dim
RANKS = (FULL_RANK, FULL_RANK // 2, FULL_RANK // 4, 8, 4, 2)


def make_batch(rng, batch):
    x = rng.integers(2, CFG.vocab_size, size=(batch, M)).astype(np.int32)
    tokens = np.concatenate([np.ones((batch, 1), np.int32), x, x], axis=1)
    mask = np.zeros_like(tokens, np.float32)
    mask[:, M + 1:] = 1.0
    return tokens, mask


def accuracy(engine, n=32, keep=4, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.integers(2, CFG.vocab_size, size=(n, M)).astype(np.int32)
    prompts = np.concatenate([np.ones((n, 1), np.int32), x, x[:, :keep]], axis=1)
    out = engine.generate(prompts, max_new_tokens=M - keep).cpu().numpy()
    return float((out == x[:, keep:]).mean())


def main(device: str = "cuda", steps: int = 300, ranks: Sequence[int] = RANKS,
         params=None, verbose: bool = True) -> dict:
    """Train for ``steps`` steps from ``params`` (fp32 on ``device``; default
    the seeded init, seed 0), then the baseline and the rank sweep over
    ``ranks``. Returns {"history": losses, "baseline": recall, "ranks":
    [(rank, compression ratio, recall)]}."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(CFG, gen, dtype=torch.float32, device=dev)
    if verbose:
        print(f"training induction model ({steps} steps)...")
    params, hist = train_lm(params, CFG, lambda i: make_batch(rng, 64), steps=steps, lr=2e-3,
                            log_every=100, verbose=verbose)
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    params = tree_map(lambda p: p.to(dtype), params)
    serve_kw = dict(tail_max=M, cache_dtype=dtype, factor_dtype=dtype, device=dev)

    base = accuracy(InferenceEngine(params, CFG, mode="none", **serve_kw))
    if verbose:
        print(f"\nuncompressed baseline accuracy: {base:.3f}")
        print(f"{'rank':>6} {'compression':>12} {'recall acc':>11}")
    rows = []
    for rank in ranks:
        xkv = generate_consecutive_xkv_config(
            num_layers=CFG.num_layers, end_layer=-1, group_size=2, rank_k=rank, rank_v=rank,
            extra_kwargs={"svd_method": "exact"})
        eng = InferenceEngine(params, CFG, xkv=xkv, mode="factored", **serve_kw)
        _, cache = eng.prefill(np.ones((1, 2 * M + 1), np.int32))
        ratio = cache.compression_ratio(CFG)
        acc = accuracy(eng)
        rows.append((rank, ratio, acc))
        if verbose:
            print(f"{rank:>6} {ratio:>11.2f}x {acc:>11.3f}")
    return {"history": hist, "baseline": base, "ranks": rows}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=300)
    args = parser.parse_args()
    main(args.device, steps=args.steps)
