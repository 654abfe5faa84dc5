"""Continuous-batching serving demo: many requests, few slots.

Port of ``examples/serving.py``. Requests with different prompt lengths
flow through a 2-slot ``BatchedEngine`` with bucketed prefill admission;
finished slots are recycled immediately. A second pass reruns the same
requests with batched speculative decoding (sparse top-2 drafts of
32-row chunks, one exact multi-token verify per round, per-slot
acceptance) and checks that the outputs are the same tokens.

The JAX example serves fp32 weights, cache and factors. The card's decode
kernels take bf16 (or int8) factors, so on ``cuda`` weights, cache and
factors are bf16; on the CPU they stay fp32. On the card admission runs K1,
the plain step K3, the drafts K5 and the verify K3 at ql 5 (head size 16
zero-padded to 64, ranks 32 padded to the kernels' layout).

Run:  python -m xkv_tpu_torch.examples.serving [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from xkv_tpu_torch.configs import generate_consecutive_xkv_config
from xkv_tpu_torch.engine.batching import BatchedEngine
from xkv_tpu_torch.models.config import tiny_llama_config
from xkv_tpu_torch.models.llama import init_params

CFG = tiny_llama_config(
    num_layers=4, hidden_size=128, intermediate_size=256,
    num_q_heads=8, num_kv_heads=4, head_dim=16, vocab_size=512,
)
N_REQUESTS = 6


def requests(vocab_size: int, n: int = N_REQUESTS, max_prompt: Optional[int] = None,
             max_new: Optional[int] = None) -> List[tuple]:
    """(prompt, max_new_tokens) of the example's requests, from numpy seed
    0 (the JAX example's draws); ``max_prompt`` / ``max_new`` cut them."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        length = int(rng.integers(16, 100))
        prompt = rng.integers(0, vocab_size, size=(length,)).astype(np.int32)
        new = int(rng.integers(4, 12))
        out.append((prompt[:max_prompt], new if max_new is None else min(new, max_new)))
    return out


def main(device: str = "cuda", max_prompt: Optional[int] = None,
         max_new: Optional[int] = None, params=None, verbose: bool = True
         ) -> Dict[str, Dict[int, List[int]]]:
    """Both passes. ``params`` replace the seeded weights (seed 0);
    ``max_prompt`` / ``max_new`` cut the requests. Returns {"plain": ...,
    "spec": ...}, each {request id: generated tokens}."""
    dev = torch.device(device)
    cfg = CFG
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, gen, dtype=dtype, device=dev)
    xkv = generate_consecutive_xkv_config(
        num_layers=cfg.num_layers, end_layer=-1, group_size=2, rank_k=32, rank_v=32)
    engine_kw = dict(num_slots=2, s_max=128, tail_max=16, prefill_buckets=[32, 64, 128],
                     cache_dtype=dtype, factor_dtype=dtype, device=dev)
    reqs = requests(cfg.vocab_size, max_prompt=max_prompt, max_new=max_new)

    be = BatchedEngine(params, cfg, xkv=xkv, **engine_kw)
    for prompt, new in reqs:
        rid = be.submit(prompt, max_new_tokens=new)
        if verbose:
            print(f"submitted request {rid}: prompt_len={len(prompt)}")
    t0 = time.perf_counter()
    done = be.run()
    dt = time.perf_counter() - t0
    if verbose:
        total_tokens = sum(len(r.generated) for r in done)
        print(f"\nfinished {len(done)} requests, {total_tokens} tokens in {dt:.2f}s")
        for r in sorted(done, key=lambda r: r.request_id):
            print(f"  request {r.request_id}: {len(r.generated)} tokens -> "
                  f"{r.generated[:6]}...")

    # Same requests through batched speculative decoding: the same tokens.
    be_spec = BatchedEngine(params, cfg, xkv=xkv, sparse_topk=2, sparse_block=32,
                            speculative_k=4, **engine_kw)
    for prompt, new in reqs:
        be_spec.submit(prompt, max_new_tokens=new)
    spec = {r.request_id: r.generated for r in be_spec.run()}
    plain = {r.request_id: r.generated for r in done}
    if spec != plain:
        raise AssertionError(f"speculative tokens {spec} differ from the plain ones {plain}")
    if verbose:
        print(f"speculative serving (k=4): same {len(spec)} requests, same tokens")
    return {"plain": plain, "spec": spec}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
