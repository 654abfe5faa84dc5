"""Quickstart: xKV cross-layer-SVD compressed KV-cache inference.

Port of ``examples/quickstart.py``. Builds a small random Llama-shaped
model (8 layers, width 256, 8 q / 4 kv heads of size 32), prefills a
512-token prompt, compresses the KV cache with the xKV-4 scheme (groups of
4 layers, shared SVD factors, ranks 64 / 96) and greedy-decodes 32 tokens,
beside the uncompressed baseline: modes none, factored, fake, and factored
with keys rotated before the SVD (``rope_mode="post"``) in int8 factors.
Weights, cache and factors are bf16, as in the JAX example, on the card
and on the CPU (``dtype`` sets them; the CPU parity test runs fp32, where
the two frameworks' roundings cannot flip a near tie). On the card prefill runs K1 (head size 32 zero-padded to 64),
factored decode K3 (pre) and K2 (post).

Run:  python -m xkv_tpu_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from xkv_tpu_torch.configs import generate_consecutive_xkv_config
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.models.config import tiny_llama_config
from xkv_tpu_torch.models.llama import init_params

CFG = tiny_llama_config(
    num_layers=8, hidden_size=256, intermediate_size=512,
    num_q_heads=8, num_kv_heads=4, head_dim=32, vocab_size=1024,
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(device: str = "cuda", prompt_len: int = 512, new_tokens: int = 32,
         params=None, prompt=None, dtype: torch.dtype = torch.bfloat16,
         verbose: bool = True) -> List[dict]:
    """The four runs. ``params`` (``dtype``, on ``device``) and ``prompt``
    (1, prompt_len) replace the seeded ones (seeds 0 and 1); the int8 run
    quantises its factors, the others store them in ``dtype``. Returns one row a
    run: label, the (1, new_tokens) tokens on the host, the compression
    ratio, prefill + compress s and generate s (host clock)."""
    dev = torch.device(device)
    cfg = CFG
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, gen, dtype=dtype, device=dev)
    if prompt is None:
        gen = torch.Generator(device=dev).manual_seed(1)
        prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    if verbose:
        print(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                                  if dev.type == "cuda" else ""))

    xkv = generate_consecutive_xkv_config(
        num_layers=cfg.num_layers, end_layer=-1, group_size=4, rank_k=64, rank_v=96)
    # rank-space decode variant: rotate keys before the SVD; decode never
    # reconstructs. int8 factors for extra headroom.
    xkv_post = generate_consecutive_xkv_config(
        num_layers=cfg.num_layers, end_layer=-1, group_size=4, rank_k=64, rank_v=96,
        extra_kwargs={"rope_mode": "post"})
    runs = [
        ("none", "none", None, {"factor_dtype": dtype}),
        ("factored", "factored", xkv, {"factor_dtype": dtype}),
        ("fake", "fake", xkv, {"factor_dtype": dtype}),
        ("rope=post int8", "factored", xkv_post, {"factor_dtype": "int8"}),
    ]
    rows = []
    for label, mode, xcfg, extra in runs:
        eng = InferenceEngine(params, cfg, xkv=xcfg, mode=mode, tail_max=64, cache_dtype=dtype,
                              device=dev, **extra)
        t0 = time.perf_counter()
        _, cache = eng.prefill(prompt)
        _sync(dev)
        t1 = time.perf_counter()
        out = eng.generate(prompt, max_new_tokens=new_tokens).cpu()
        t2 = time.perf_counter()
        ratio = cache.compression_ratio(cfg)
        rows.append(dict(label=label, tokens=out, ratio=ratio, prefill_s=t1 - t0,
                         generate_s=t2 - t1))
        if verbose:
            print(f"mode={label:16s} prefill+compress {t1 - t0:6.2f}s  "
                  f"generate({new_tokens}) {t2 - t1:6.2f}s  KV compression {ratio:5.2f}x  "
                  f"tokens {out[0][:8].tolist()}...")
    return rows


def _args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(_args().device)
