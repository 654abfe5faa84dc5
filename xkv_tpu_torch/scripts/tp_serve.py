"""Tensor and data parallelism, served by ranks on one machine.

    python -m xkv_tpu_torch.scripts.tp_serve [--nproc 2] [--data 1] [--batch 1]
        [--device cuda|cpu] [--tiny] [--mla] [--layers 4] [--prompt 4096]
        [--new 16] [--tail 8] [--runs pre:bf16,post:bf16,post:int8]
        [--out build/tp_serve]

Launches ``--data`` x ``--nproc`` processes, the ranks of a gloo process
group on 127.0.0.1, and each serves the model under ``make_mesh(data=data,
model=nproc)`` (``InferenceEngine(mesh=...)``): a ``--batch``-row batch
(each data row of ranks serves its share of the rows) of a ``--prompt``
token prompt, then ``--new`` greedy tokens with a ``--tail``-row tail, so
that a refold happens. The model, random weights from seed 0 (bf16 on the
card, fp32 on the CPU), cut to ``--layers`` layers:
  * Llama-3.1-8B's widths (32 q / 8 kv heads of 128, hidden 4096, FFN
    14336), or with ``--tiny`` ``tiny_llama_config`` (4 q / 2 kv heads of
    16), one xKV-4 group every 4 layers (ranks 512 / 768; tiny: 16 / 16).
    A run is ``rope:factor dtype[:sparseK]``: rope mode pre or post,
    factors bf16, int8, fp32 or int4 (mixed int8 + int4, post), and
    ``sparseK`` sparse top-K decode over ``SPARSE_BLOCK``-row chunks
    (per-shard selection; with int4 factors over every head);
  * with ``--mla`` DeepSeek-V2-Lite's widths (16 q heads, latent 512, 64
    routed experts of which 6 a token, 2 shared; the first layer dense),
    or with ``--tiny`` a tiny MLA + MoE model (4 q heads, 4 experts), one
    xKV group of 4 layers over the latent (rank 512; tiny 16). A run is
    ``mla:factor dtype`` (bf16, int8: K7; int4: K8). The default runs are
    ``mla:bf16,mla:int4``.
Each run runs on every rank at once.

Each run is ``generate`` (the tokens), then ``forced_pass``: the prompt
prefilled again and the decode steps fed a token sequence (the
``--teacher`` file's for the run, else the run's own tokens), refolding
as ``generate`` does, each step's logits kept. On one card the ranks share
it: the gloo backend (NCCL refuses two ranks on one device), whose
collectives go through the host, so these times are not tensor
parallelism's speed. Each rank writes ``rank<r>.json`` to ``--out``: its
mesh coordinates, head share and peak allocated GB on the card, and a
run's prefill s (host clock around a synchronised ``prefill``) and eager
decode ms a token (host clock around each synchronised step) of the
forced pass, kernel launches and tokens; rank 0 also writes ``rank0.pt``
(per run: the tokens; the forced pass's logits, the prefill's last
position then one row a step, rows of a step together; the cache joined
from every rank's shard (``gather_cache``) after the prefill and after the
pass; the logits of one more step on the ranks' shards past the pass, fed
the last token, and, for a sparse run, of that step over every chunk
(``full_logits``)). The launcher prints one line a run and rank.
``launch``, ``wait``, ``model``, ``engine`` and ``forced_pass`` serve
another program (``chip_smoke.py`` phases 13 and 14) too.

On the card the ranks reduce every product in fp32: the row-split
products are fp32 (``llama.row_product``), and cuBLAS is asked not to
reduce the bf16 column products' split sums in bf16
(``allow_bf16_reduced_precision_reduction``), so that the ranks and one
device differ by the order of fp32 sums alone when one device is asked
the same.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from typing import Callable, List, Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_RUNS = "pre:bf16,post:bf16,post:int8"
MLA_RUNS = "mla:bf16,mla:int4"
# The sparse runs' chunk rows (the JAX package's bench.py sparse setting).
SPARSE_BLOCK = 512


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nproc", type=int, default=2, help="the model axis")
    p.add_argument("--data", type=int, default=1, help="the data axis")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--mla", action="store_true")
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--prompt", type=int, default=4096)
    p.add_argument("--new", type=int, default=16)
    p.add_argument("--tail", type=int, default=8)
    p.add_argument("--runs", default=None)
    p.add_argument("--out", default=os.path.join("build", "tp_serve"))
    p.add_argument("--teacher", default=None,
                   help="JSON {run: tokens} the forced pass feeds (default: the run's own)")
    # Set by ``launch`` for each rank.
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--world", type=int, default=None)
    args = p.parse_args(argv)
    if args.runs is None:
        args.runs = MLA_RUNS if args.mla else DEFAULT_RUNS
    return args


def tiny_mla_config():
    """A tiny MLA + MoE model (4 q heads, latent 32, 4 routed experts of
    which 2 a token, one shared, the first layer dense)."""
    from xkv_tpu_torch.models.config import ModelConfig

    return ModelConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=4,
                       num_q_heads=4, num_kv_heads=4, head_dim=16, model_type="deepseek_v2",
                       kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16,
                       v_head_dim=16, n_routed_experts=4, n_shared_experts=1,
                       num_experts_per_tok=2, moe_intermediate_size=32, first_k_dense_replace=1)


def model(args):
    """(config, xKV config by rope mode, weights, prompt) of the run, from
    seed 0."""
    from xkv_tpu_torch.configs import generate_consecutive_xkv_config
    from xkv_tpu_torch.models import deepseek, llama
    from xkv_tpu_torch.models.config import (
        deepseek_v2_lite_config,
        llama31_8b_config,
        tiny_llama_config,
    )

    dev = torch.device(args.device)
    if args.mla:
        base = tiny_mla_config() if args.tiny else deepseek_v2_lite_config()
        ranks = (16, None) if args.tiny else (512, None)
    else:
        base = tiny_llama_config() if args.tiny else llama31_8b_config()
        ranks = (16, 16) if args.tiny else (512, 768)
    cfg = dataclasses.replace(base, num_layers=args.layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    params = (deepseek if args.mla else llama).init_params(cfg, gen, dtype, dev)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt), generator=gen,
                           device=dev)

    def xkv(rope):
        extra = {} if rope is None else {"rope_mode": rope}
        return generate_consecutive_xkv_config(
            num_layers=cfg.num_layers, end_layer=-1, group_size=4, rank_k=ranks[0],
            rank_v=ranks[1], merge_value=not args.mla, extra_kwargs=extra)

    return cfg, xkv, params, prompt


def parse_run(run: str) -> dict:
    """``rope:dtype[:sparseK]`` or ``mla:dtype`` -> {rope (None for MLA),
    fd, sparse (K or None)}."""
    parts = run.split(":")
    sparse = int(parts[2][len("sparse"):]) if len(parts) > 2 else None
    return dict(rope=None if parts[0] == "mla" else parts[0], fd=parts[1], sparse=sparse)


def engine(args, cfg, xkv, params, run: str, device, mesh=None):
    """The run's engine (``parse_run``), on one device or under ``mesh``."""
    from xkv_tpu_torch.engine import InferenceEngine

    spec = parse_run(run)
    sparse = {} if spec["sparse"] is None else dict(sparse_topk=spec["sparse"],
                                                    sparse_block=SPARSE_BLOCK)
    return InferenceEngine(params, cfg, xkv(spec["rope"]), mode="factored", tail_max=args.tail,
                           cache_dtype=params["embed"].dtype, factor_dtype=factor_dtype(spec["fd"]),
                           prefill_logits="last", device=device, mesh=mesh, **sparse)


def factor_dtype(name: str):
    return {"bf16": torch.bfloat16, "int8": "int8", "fp32": torch.float32, "int4": "int4"}[name]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def forced_pass(eng, prompt: torch.Tensor, n: int, tokens: Optional[torch.Tensor] = None,
                after_prefill: Optional[Callable] = None):
    """Prefill ``prompt`` (b, s), then ``n - 1`` eager decode steps, each
    fed the next of ``tokens`` (b, n) or, with none given, the greedy
    token; a full tail is folded as ``generate`` folds it;
    ``after_prefill(cache)`` is called with the prefill's cache before the
    steps. Returns (the fed or greedy tokens (b, n), the logits that chose
    them (n * b, V) fp32 on the host, a step's b rows together, prefill s,
    each step's s, the cache after the last step), host clocks around
    synchronised calls."""
    dev = prompt.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = eng.prefill(prompt)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    if after_prefill is not None:
        after_prefill(cache)
    rows = [logits[:, -1]]
    toks = [rows[0].argmax(dim=-1)[:, None]]
    pos = prompt.shape[1]
    step_s = []
    for i in range(n - 1):
        if cache.tail_count == cache.tail_max:
            cache = eng.refactorize(cache)
        tok = toks[-1] if tokens is None else tokens[:, i:i + 1].to(dev)
        t0 = time.perf_counter()
        out, cache = eng.decode_step(cache, tok, pos + i)
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        rows.append(out[:, -1])
        toks.append(rows[-1].argmax(dim=-1)[:, None])
    fed = torch.cat(toks, dim=1).cpu() if tokens is None else tokens.cpu()
    return fed, torch.cat(rows).float().cpu(), prefill_s, step_s, cache


def serve_rank(args) -> None:
    """One rank: join the group, serve every run, write the results."""
    from xkv_tpu_torch.ops.kernels._build import read_counts, reset_counts
    from xkv_tpu_torch.parallel.distributed import barrier, init_distributed
    from xkv_tpu_torch.parallel.mesh import make_mesh
    from xkv_tpu_torch.parallel.sharding import gather_cache

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg, xkv, params, prompt = model(args)
    init_distributed("gloo", coordinator_address=f"127.0.0.1:{args.port}",
                     num_processes=args.world, process_id=args.rank)
    mesh = make_mesh(data=args.data, model=args.world // args.data)
    barrier()
    teacher = {}
    if args.teacher:
        with open(args.teacher) as f:
            teacher = json.load(f)
    record = {"rank": args.rank, "coords": [mesh.data_rank, mesh.model_rank], "runs": {}}
    saved = {}
    for run in args.runs.split(","):
        eng = engine(args, cfg, xkv, params, run, dev, mesh)
        if not record.get("heads"):
            record["heads"] = [eng.shard_cfg.num_q_heads, eng.shard_cfg.num_kv_heads]
        reset_counts()
        tokens = eng.generate(prompt, args.new).cpu()
        fed = torch.tensor(teacher[run]) if run in teacher else tokens
        group_layers = [len(g.layers) for g in eng.xkv.layer_groups]
        heads = not args.mla

        def join(c):
            return gather_cache(c, group_layers, mesh, heads=heads)

        first = []
        _, logits, prefill_s, step_s, cache = forced_pass(
            eng, prompt, args.new, fed, after_prefill=lambda c: first.append(join(c)))
        joined = join(cache)
        pos = prompt.shape[1] + args.new - 1
        nxt, _ = eng.decode_step(cache, fed[:, -1:].to(dev), pos)
        keep = dict(tokens=tokens, logits=logits, prefill_joined=first[0], joined=joined,
                    next_logits=nxt[:, -1].float().cpu())
        if eng.step_kw:
            # The same step over every chunk: the sparse kernel at full
            # coverage, which one device's exact step over the same factors
            # must match.
            full_kw = dict(eng.step_kw, sparse_select=1 << 20)
            tok = mesh.rows(fed[:, -1:].to(dev))
            full, _ = eng.step(cache, tok, pos, full_kw)
            keep["full_logits"] = mesh.gather_rows(full[:, -1]).float().cpu()
        counts = read_counts()
        record["runs"][run] = dict(
            prefill_s=prefill_s, decode_ms_per_token=1e3 * sum(step_s) / len(step_s),
            steps=len(step_s), counts=counts, tokens=tokens.tolist())
        saved[run] = keep
        del cache, joined, first
        del eng
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        record["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(record, f)
    if args.rank == 0:
        torch.save(saved, os.path.join(args.out, "rank0.pt"))
    barrier()
    import torch.distributed as dist

    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: List[str], world: int) -> List[subprocess.Popen]:
    """Start ``world`` ranks of this script with ``argv`` (its options but
    the ranks'; ``--data`` among them when the mesh has a data axis)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen(
        [sys.executable, "-m", "xkv_tpu_torch.scripts.tp_serve", *argv, "--world", str(world),
         "--rank", str(r), "--port", str(port)], cwd=ROOT, env=env)
        for r in range(world)]


def wait(procs: List[subprocess.Popen], timeout: float) -> None:
    """Wait for the ranks; a rank that fails or outlasts ``timeout`` stops
    them all and raises."""
    t0 = time.time()
    try:
        for p in procs:
            rc = p.wait(timeout=max(1.0, timeout - (time.time() - t0)))
            if rc != 0:
                raise RuntimeError(f"a tensor-parallel rank exited with {rc}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def results(out: str, world: int) -> List[dict]:
    records = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            records.append(json.load(f))
    return records


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parse_args(argv)
    if args.rank is not None:
        serve_rank(args)
        return []
    args.out = os.path.abspath(args.out)
    argv = list(sys.argv[1:] if argv is None else argv) + ["--out", args.out]
    world = args.nproc * args.data
    wait(launch(argv, world), timeout=3600)
    records = results(args.out, world)
    for rec in records:
        for run, row in rec["runs"].items():
            print(f"rank {rec['rank']} at {tuple(rec['coords'])} ({rec['heads'][0]} q / "
                  f"{rec['heads'][1]} kv heads) "
                  f"{run}: prefill {row['prefill_s']:.3f} s, eager decode "
                  f"{row['decode_ms_per_token']:.2f} ms/token, launches {row['counts']}, "
                  f"tokens {row['tokens']}")
    return records


if __name__ == "__main__":
    main()
