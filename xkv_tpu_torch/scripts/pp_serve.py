"""Pipeline parallelism, served by ranks on one machine.

    python -m xkv_tpu_torch.scripts.pp_serve [--stages 2] [--device cuda|cpu]
        [--tiny] [--layers 8] [--batch 4] [--prompt 2048] [--steps 8]
        [--tail 8] [--runs bf16,int8] [--check] [--out build/pp_serve]

Launches ``--stages`` processes, the ranks of a gloo process group on
127.0.0.1, each a stage of ``parallel.pipeline.make_pipe_mesh``. The model
is ``tp_serve``'s Llama (Llama-3.1-8B's widths, or ``--tiny``; random
weights from seed 0) cut to ``--layers`` layers, in xKV-4 groups of post
RoPE factors (ranks 512 / 768; tiny 16 / 16), so that each stage holds
whole groups. Rank 0 prefills the ``--batch`` x ``--prompt`` prompt on one
device (``InferenceEngine``, K1) and builds the factored cache in each
factor dtype of ``--runs``; the cache goes to every stage (a broadcast),
and each stage keeps its groups and its layers' tail rows
(``stage_cache``) and its layers' weights (``stage_params``). Then:

  * ``pipelined_forward`` of the prompt at 2 microbatches (the logits of
    the last position);
  * per factor dtype, ``--steps`` chained ``pipelined_decode_step``s, the
    first half at 2 microbatches and the rest at 4, each fed the greedy
    token of the step before (the prefill's first).

Each rank writes ``rank<r>.json`` to ``--out``: its stage, layers, peak
allocated GB on the card, the forward's s, each run's eager ms a step
(host clock around each synchronised step) at each microbatch count and
the launches. With ``--check`` rank 0 also runs one device on the same
inputs, holding its full weights and the whole cache: the forward's
logits against ``llama.prefill``'s, every step's logits against
``llama.decode_step``'s over the same cache fed the same token, and the
stages' joined tail rows (``join_stage_tails``) against that step's tail;
and it records its first K1 and K2 calls with their plain versions on the
same operands (``tp_serve.first_calls``; ``kernels.pt``). On one card the
stages share it through gloo, whose transfers go through the host: these
times are not pipeline parallelism's speed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import List, Optional

import torch

from xkv_tpu_torch.scripts import tp_serve


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt", type=int, default=2048)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--tail", type=int, default=8)
    p.add_argument("--runs", default="bf16,int8")
    p.add_argument("--check", action="store_true")
    p.add_argument("--out", default=os.path.join("build", "pp_serve"))
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--world", type=int, default=None)
    return p.parse_args(argv)


def model(args):
    """(config, post-RoPE xKV config, weights, prompt): ``tp_serve.model``'s."""
    targs = tp_serve.parse_args(["--device", args.device, "--layers", str(args.layers),
                                 "--batch", str(args.batch), "--prompt", str(args.prompt)]
                                + (["--tiny"] if args.tiny else []))
    cfg, xkv, params, prompt = tp_serve.model(targs)
    return cfg, xkv("post"), params, prompt


def _cache_tensors(cache) -> dict:
    """A factored cache's tensors by name (its groups' fields, the tail)."""
    flat = {f"g{gi}.{k}": v for gi, gf in enumerate(cache.groups)
            for k, v in vars(gf).items() if v is not None}
    flat.update(tail_k=cache.tail_k, tail_v=cache.tail_v, tail_len=cache.tail_len)
    return flat


def _cache_from(flat: dict, n_groups: int):
    from xkv_tpu_torch.cache import GroupFactors, XKVCache

    groups = tuple(GroupFactors(**{k.split(".", 1)[1]: v for k, v in flat.items()
                                   if k.startswith(f"g{gi}.")}) for gi in range(n_groups))
    return XKVCache(groups=groups, dense_k={}, dense_v={}, tail_k=flat["tail_k"],
                    tail_v=flat["tail_v"], tail_len=flat["tail_len"],
                    tail_count=int(flat["tail_len"]))


def serve_rank(args) -> None:
    """One stage: join the group, run the forward and the steps, write the
    results."""
    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.models import llama
    from xkv_tpu_torch.ops.kernels._build import read_counts, reset_counts
    from xkv_tpu_torch.ops.rope import rope_cos_sin
    from xkv_tpu_torch.parallel.distributed import barrier, init_distributed
    from xkv_tpu_torch.parallel.mesh import Mesh
    from xkv_tpu_torch.parallel.pipeline import (
        join_stage_tails,
        make_pipe_mesh,
        pipelined_decode_step,
        pipelined_forward,
        stage_cache,
        stage_params,
    )

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg, xkv, params, prompt = model(args)
    init_distributed("gloo", coordinator_address=f"127.0.0.1:{args.port}",
                     num_processes=args.world, process_id=args.rank)
    mesh = make_pipe_mesh(args.stages)
    # The default group as a model axis: its broadcast carries rank 0's cache.
    world = Mesh(data=1, model=args.world, rank=args.rank)
    check = args.check and args.rank == 0
    mine = stage_params(params, cfg, mesh)
    # Rank 0 prefills on one device: it keeps every layer.
    whole = params if args.rank == 0 else None
    del params
    s = prompt.shape[1]
    record = {"rank": args.rank, "stage": mesh.stage, "layers": len(mine["layers"]),
              "runs": {}}
    readings = {}
    kernels = {} if check else None

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    reset_counts()
    with tp_serve.first_calls(("K1",), kernels) if check else contextlib.nullcontext():
        _sync()
        t0 = time.perf_counter()
        logits = pipelined_forward(mine, cfg, prompt, mesh, num_microbatches=2,
                                   logits_position=s - 1)
        _sync()
        record["forward_s"] = time.perf_counter() - t0
    record["forward_counts"] = read_counts()
    if check:
        ref, _ = llama.prefill(whole, cfg, prompt, logits_position=s - 1)
        readings["forward_err"] = (logits - ref).abs().max().item()
    barrier()
    cos_sin = rope_cos_sin(torch.arange(s, device=dev), cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)
    for run in args.runs.split(","):
        full = None
        if args.rank == 0:
            eng = InferenceEngine(whole, cfg, xkv, tail_max=args.tail,
                                  cache_dtype=mine["embed"].dtype,
                                  factor_dtype=tp_serve.factor_dtype(run),
                                  prefill_logits="last", device=dev)
            first, full = eng.prefill(prompt)
            tok = first[:, -1].argmax(dim=-1)[:, None]
            flat = dict(_cache_tensors(full), tok=tok)
            del eng
        flat = world.broadcast_tensors(flat if args.rank == 0 else None, dev)
        tok = flat.pop("tok")
        cache = stage_cache(_cache_from(flat, len(xkv.layer_groups)), cfg, xkv, mesh)
        del flat
        rows, step_s = [], {2: [], 4: []}
        counts = dict.fromkeys(read_counts(), 0)  # the stage's own launches
        with tp_serve.first_calls(("K2",), kernels.setdefault(run, {})) if check \
                else contextlib.nullcontext():
            for i in range(args.steps):
                m = 2 if i < args.steps // 2 else 4
                reset_counts()
                _sync()
                t0 = time.perf_counter()
                logits, cache = pipelined_decode_step(mine, cfg, xkv, cache, tok, s + i, mesh,
                                                      num_microbatches=m)
                _sync()
                step_s[m].append(time.perf_counter() - t0)
                for k, n in read_counts().items():
                    counts[k] += n
                tail_k, tail_v = join_stage_tails(cache, cfg, mesh)
                if check:
                    ref, full = llama.decode_step(whole, cfg, xkv, full, tok, s + i, cos_sin)
                    top = ref[:, -1].float().amax(dim=-1)
                    picked = logits[:, -1].argmax(dim=-1)
                    rows.append(dict(
                        microbatches=m, logits_err=(logits - ref).abs().max().item(),
                        tail_err=max((tail_k - full.tail_k).abs().max().item(),
                                     (tail_v - full.tail_v).abs().max().item()),
                        shortfall=(top - ref[:, -1].float().gather(
                            1, picked[:, None])[:, 0]).max().item(),
                        tail_count=[cache.tail_count, full.tail_count]))
                tok = logits[:, -1].argmax(dim=-1)[:, None]
        record["runs"][run] = dict(
            ms_per_step={m: 1e3 * sum(v) / len(v) for m, v in step_s.items() if v},
            counts=counts, tokens=tok[:, 0].tolist())
        if check:
            readings[run] = rows
        del cache, full
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        record["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    os.makedirs(args.out, exist_ok=True)
    if check:
        record["readings"] = readings
        torch.save(kernels, os.path.join(args.out, "kernels.pt"))
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(record, f)
    barrier()
    import torch.distributed as dist

    dist.destroy_process_group()


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parse_args(argv)
    if args.rank is not None:
        serve_rank(args)
        return []
    args.out = os.path.abspath(args.out)
    argv = list(sys.argv[1:] if argv is None else argv) + ["--out", args.out]
    tp_serve.wait(tp_serve.launch(argv, args.stages, module="xkv_tpu_torch.scripts.pp_serve"),
                  timeout=3600)
    records = tp_serve.results(args.out, args.stages)
    for rec in records:
        print(f"stage {rec['stage']} ({rec['layers']} layers): forward {rec['forward_s']:.3f} s, "
              + ", ".join(f"{run} {row['ms_per_step']} ms a step, launches {row['counts']}"
                          for run, row in rec["runs"].items())
              + (f"; readings {json.dumps(rec['readings'])}" if "readings" in rec else ""))
    return records


if __name__ == "__main__":
    main()
