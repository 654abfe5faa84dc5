"""Tensor, data and sequence parallelism and continuous batching, served by
ranks on one machine.

    python -m xkv_tpu_torch.scripts.tp_serve [--nproc 2] [--data 1] [--batch 1]
        [--device cuda|cpu] [--tiny] [--mla] [--layers 4] [--prompt 4096]
        [--new 16] [--tail 8] [--runs pre:bf16,post:bf16,post:int8]
        [--sequence_parallel] [--batched [--slots 4] [--s_max 4608]
        [--buckets 1024,2048,4096] [--requests 4096:20,1000:16,...]]
        [--check] [--out build/tp_serve]

Launches ``--data`` x ``--nproc`` processes, the ranks of a gloo process
group on 127.0.0.1, and each serves the model under ``make_mesh(data=data,
model=nproc)``:
  * by default ``InferenceEngine(mesh=...)``: a ``--batch``-row batch (each
    data row of ranks serves its share of the rows) of a ``--prompt``
    token prompt, then ``--new`` greedy tokens with a ``--tail``-row tail,
    so that a refold happens;
  * with ``--sequence_parallel``, the same engine with
    ``sequence_parallel=True``: the prompt's rows split over the data axis
    at prefill (ring attention), every data row decoding every batch row;
  * with ``--batched``, ``BatchedEngine(mesh=...)``: ``--slots`` slots of
    ``--s_max`` rows split over the data axis, admitting at the
    ``--buckets`` lengths, the ``--requests`` (prompt tokens:new tokens
    each; random tokens from seed 1) served to the end.
The model, random weights from seed 0 (bf16 on the card, fp32 on the CPU),
cut to ``--layers`` layers:
  * Llama-3.1-8B's widths (32 q / 8 kv heads of 128, hidden 4096, FFN
    14336), or with ``--tiny`` ``tiny_llama_config`` (4 q / 2 kv heads of
    16), one xKV-4 group every 4 layers (ranks 512 / 768; tiny: 16 / 16).
    A run is ``rope:factor dtype[:sparseK][:chunkN][:specK]``: rope mode
    pre or post, factors bf16, int8, fp32 or int4 (mixed int8 + int4,
    post), ``sparseK`` sparse top-K decode over ``SPARSE_BLOCK``-row
    chunks (per-shard selection; with int4 factors over every head), and
    for ``--batched`` ``chunkN`` admission in N-row chunks and ``specK``
    speculation with K drafts (the sparse step's);
  * with ``--mla`` DeepSeek-V2-Lite's widths (16 q heads, latent 512, 64
    routed experts of which 6 a token, 2 shared; the first layer dense),
    or with ``--tiny`` a tiny MLA + MoE model (4 q heads, 4 experts), one
    xKV group of 4 layers over the latent (rank 512; tiny 16). A run is
    ``mla:factor dtype`` (bf16, int8: K7; int4: K8). The default runs are
    ``mla:bf16,mla:int4``.
Each run runs on every rank at once.

An ``InferenceEngine`` run is ``generate`` (the tokens), then
``forced_pass``: the prompt prefilled again and the decode steps fed a
token sequence (the ``--teacher`` file's for the run, else the run's own
tokens), refolding as ``generate`` does, each step's logits kept. On one
card the ranks share it: the gloo backend (NCCL refuses two ranks on one
device), whose collectives go through the host, so these times are not
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
(``full_logits``)). A ``--batched`` run writes, per rank, each request's
tokens, the admissions' and the run's s, the eager ms a step (or round),
launches and peak GB, and every request's admitted cache joined over the
model axis (``admitted<r>.pt``, by the data row's first rank), the
factors its slot decodes. With ``--check`` rank 0 records the first call
of each decode kernel of the run (and K1's), at once held against its
plain version on the same operands (``kernels.pt``: outputs and lse of
both). The launcher prints one line a run and rank. ``launch``, ``wait``,
``model``, ``engine``, ``forced_pass`` and ``first_calls`` serve other
programs (``chip_smoke.py`` phases 13-15, ``scripts/pp_serve.py``) too.

On the card the ranks reduce every product in fp32: the row-split
products are fp32 (``llama.row_product``), and cuBLAS is asked not to
reduce the bf16 column products' split sums in bf16
(``allow_bf16_reduced_precision_reduction``), so that the ranks and one
device differ by the order of fp32 sums alone when one device is asked
the same.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_RUNS = "pre:bf16,post:bf16,post:int8"
MLA_RUNS = "mla:bf16,mla:int4"
# The sparse runs' chunk rows (the JAX package's bench.py sparse setting).
SPARSE_BLOCK = 512
# The kernels ``first_calls`` can record: key -> (module whose attribute
# the callers read, its name, the kernel module, the plain version's name).
KERNEL_FNS = {
    "K1": ("xkv_tpu_torch.models.llama", "flash_attention", "flash_attention",
           "flash_attention_plain"),
    "K2": ("xkv_tpu_torch.ops.kernels.rankspace_attention", "rankspace_kernel",
           "rankspace_attention", "rankspace_kernel_plain"),
    "K3": ("xkv_tpu_torch.ops.kernels.lowrank_attention", "lowrank_kernel",
           "lowrank_attention", "lowrank_kernel_plain"),
    "K4": ("xkv_tpu_torch.ops.kernels.rankspace_attention", "sparse_rankspace_kernel",
           "rankspace_attention", "sparse_rankspace_kernel_plain"),
}


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
    p.add_argument("--sequence_parallel", action="store_true",
                   help="split the prompt's rows over the data axis (ring attention)")
    p.add_argument("--batched", action="store_true", help="BatchedEngine(mesh=...)")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--s_max", type=int, default=4608)
    p.add_argument("--buckets", default="1024,2048,4096")
    p.add_argument("--requests", default="4096:20,1000:16,3000:24,2048:18,1500:22,4000:16",
                   help="prompt tokens:new tokens of each request (--batched)")
    p.add_argument("--check", action="store_true",
                   help="rank 0 holds its first kernel calls against their plain versions")
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
    """``rope:dtype[:sparseK][:chunkN][:specK]`` or ``mla:dtype`` -> {rope
    (None for MLA), fd, sparse, chunk, spec (each an int or None)}."""
    parts = run.split(":")
    spec = dict(rope=None if parts[0] == "mla" else parts[0], fd=parts[1], sparse=None,
                chunk=None, spec=None)
    for part in parts[2:]:
        key = next(k for k in ("sparse", "chunk", "spec") if part.startswith(k))
        spec[key] = int(part[len(key):])
    return spec


def engine(args, cfg, xkv, params, run: str, device, mesh=None):
    """The run's engine (``parse_run``), on one device or under ``mesh``."""
    from xkv_tpu_torch.engine import InferenceEngine

    spec = parse_run(run)
    sparse = {} if spec["sparse"] is None else dict(sparse_topk=spec["sparse"],
                                                    sparse_block=SPARSE_BLOCK)
    return InferenceEngine(params, cfg, xkv(spec["rope"]), mode="factored", tail_max=args.tail,
                           cache_dtype=params["embed"].dtype, factor_dtype=factor_dtype(spec["fd"]),
                           prefill_logits="last", device=device, mesh=mesh,
                           sequence_parallel=args.sequence_parallel and mesh is not None,
                           **sparse)


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


@contextlib.contextmanager
def first_calls(keys, out: Dict[str, dict], want: Optional[Callable] = None):
    """Record the first call of each kernel of ``keys`` (``KERNEL_FNS``)
    that ``want(key, args)`` accepts (any, without it): the call runs, then
    the plain version on the same operands, and ``out[key]`` gets both
    results on the host (``out``/``ref``, and ``lse``/``lse_ref`` for the
    decode kernels) with the operands' shapes."""
    patched = []
    for key in keys:
        where, name, kmod, plain_name = KERNEL_FNS[key]
        mod = importlib.import_module(where)
        plain = getattr(importlib.import_module(f"xkv_tpu_torch.ops.kernels.{kmod}"),
                        plain_name)
        orig = getattr(mod, name)

        def record(*a, _key=key, _orig=orig, _plain=plain, **kw):
            got = _orig(*a, **kw)
            if _key not in out and (want is None or want(_key, a)):
                ref = _plain(*a, **kw)
                pair = (got, ref) if _key == "K1" else (got[0], ref[0], got[1], ref[1])
                out[_key] = dict(zip(("out", "ref", "lse", "lse_ref"),
                                     (x.detach().float().cpu() for x in pair)),
                                 shapes=[list(x.shape) for x in a
                                         if isinstance(x, torch.Tensor)])
            return got

        setattr(mod, name, record)
        patched.append((mod, name, orig))
    try:
        yield out
    finally:
        for mod, name, orig in patched:
            setattr(mod, name, orig)


def parse_requests(text: str) -> List[tuple]:
    """``tokens:new,...`` -> [(prompt tokens, new tokens)]."""
    return [tuple(int(x) for x in item.split(":")) for item in text.split(",")]


def batched_engine(args, cfg, xkv, params, run: str, device, mesh=None):
    """The run's ``BatchedEngine`` (``parse_run``), on one device or under
    ``mesh``."""
    from xkv_tpu_torch.engine import BatchedEngine

    spec = parse_run(run)
    kw = {} if spec["sparse"] is None else dict(sparse_topk=spec["sparse"],
                                                sparse_block=SPARSE_BLOCK)
    buckets = [int(b) for b in args.buckets.split(",")]
    return BatchedEngine(params, cfg, xkv(spec["rope"]), num_slots=args.slots, s_max=args.s_max,
                         tail_max=args.tail, prefill_buckets=buckets,
                         cache_dtype=params["embed"].dtype, factor_dtype=factor_dtype(spec["fd"]),
                         prefill_chunk=spec["chunk"], speculative_k=spec["spec"], device=device,
                         mesh=mesh, **kw)


def batched_prompts(args, cfg) -> List[np.ndarray]:
    """The requests' prompts: random tokens from seed 1, on the host."""
    gen = torch.Generator().manual_seed(1)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy()
            for n, _ in parse_requests(args.requests)]


def serve_batched(args, cfg, eng, run: str, dev, mesh, record: dict,
                  kernels: Optional[Dict[str, dict]]) -> None:
    """One ``--batched`` run of ``eng`` on this rank: every request admitted
    and served to the end; the run's row into ``record``; each admitted
    request's cache joined over the model axis kept by the data row's first
    rank (``admitted_<run>_<rank>.pt``)."""
    from xkv_tpu_torch.ops.kernels._build import read_counts, reset_counts
    from xkv_tpu_torch.parallel.sharding import gather_cache

    group_layers = [len(g.layers) for g in eng.xkv.layer_groups]
    row_mesh = dataclasses.replace(mesh, data=1)  # the model axis of this data row
    admitted, timing = {}, {"admission_s": 0.0, "steps": 0, "step_s": []}
    admit_all = eng._admit_all

    def keep(req, admit):
        if admit is None:
            return None

        def run_admit():
            cache1, tok = admit()
            joined = gather_cache(cache1, group_layers, row_mesh, heads=not args.mla)
            if mesh.model_rank == 0:
                admitted[req.request_id] = joined
            return cache1, tok

        return run_admit

    def timed_admit_all(plan):
        _sync(dev)
        t0 = time.perf_counter()
        admit_all([(slot, req, keep(req, admit)) for slot, req, admit in plan])
        _sync(dev)
        timing["admission_s"] += time.perf_counter() - t0

    eng._admit_all = timed_admit_all
    ids = [eng.submit(p, n) for p, (_, n) in zip(batched_prompts(args, cfg),
                                                 parse_requests(args.requests))]
    spec = parse_run(run)
    want = (lambda key, a: key != "K2" or a[0].shape[1] == (spec["spec"] + 1) * cfg.num_q_heads
            // mesh.model) if spec["spec"] else None
    reset_counts()
    done = {}
    t_run = time.perf_counter()
    with first_calls(("K1", "K2", "K3", "K4"), kernels, want) if kernels is not None \
            else contextlib.nullcontext():
        while eng.queue or eng.slot_request or eng._admitting is not None:
            t0 = time.perf_counter()
            for req in eng.step():
                done[req.request_id] = req.generated
            _sync(dev)
            timing["step_s"].append(time.perf_counter() - t0)
    run_s = time.perf_counter() - t_run
    steps = len(timing["step_s"])
    record["runs"][run] = dict(
        run_s=run_s, admission_s=timing["admission_s"], steps=steps,
        step_ms=1e3 * (run_s - timing["admission_s"]) / steps, counts=read_counts(),
        tokens=[done[i] for i in ids], spec_stats=dict(eng.spec_stats),
        admitted=sorted(admitted))
    if admitted:
        torch.save(to_device(admitted),
                   os.path.join(args.out, f"admitted_{run.replace(':', '_')}_{args.rank}.pt"))


def to_device(tree, device="cpu"):
    """A cache (or any dataclass / dict / tuple tree of tensors) with its
    tensors on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: to_device(getattr(tree, f.name), device)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_device(v, device) for v in tree)
    return tree


def serve_rank(args) -> None:
    """One rank: join the group, serve every run, write the results."""
    from xkv_tpu_torch.ops.kernels._build import read_counts, reset_counts
    from xkv_tpu_torch.parallel.distributed import barrier, init_distributed
    from xkv_tpu_torch.parallel.mesh import make_mesh
    from xkv_tpu_torch.parallel.sharding import gather_cache

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    init_distributed("gloo", coordinator_address=f"127.0.0.1:{args.port}",
                     num_processes=args.world, process_id=args.rank)
    mesh = make_mesh(data=args.data, model=args.world // args.data)
    barrier()
    os.makedirs(args.out, exist_ok=True)
    teacher = {}
    if args.teacher:
        with open(args.teacher) as f:
            teacher = json.load(f)
    record = {"rank": args.rank, "coords": [mesh.data_rank, mesh.model_rank], "runs": {}}
    kernels = {} if args.check and args.rank == 0 else None
    saved = {}
    for run in args.runs.split(","):
        # The whole weights (seed 0) live only until the run's engine holds
        # its shard of them.
        cfg, xkv, params, prompt = model(args)
        eng = (batched_engine if args.batched else engine)(args, cfg, xkv, params, run, dev,
                                                            mesh)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if args.batched:
            serve_batched(args, cfg, eng, run, dev, mesh, record,
                          None if kernels is None else kernels.setdefault(run, {}))
            record.setdefault("heads", [eng.shard_cfg.num_q_heads, eng.shard_cfg.num_kv_heads])
            del eng
            continue
        if not record.get("heads"):
            record["heads"] = [eng.shard_cfg.num_q_heads, eng.shard_cfg.num_kv_heads]
        reset_counts()
        tokens = eng.generate(prompt, args.new).cpu()
        fed = torch.tensor(teacher[run]) if run in teacher else tokens
        group_layers = [len(g.layers) for g in eng.xkv.layer_groups]
        heads = not args.mla
        # Under sequence parallelism the data rows hold replicas: only the
        # model axis is joined.
        held = eng.mesh or mesh

        def join(c):
            return gather_cache(c, group_layers, held, heads=heads)

        first = []
        with first_calls(("K2", "K3", "K4"), kernels.setdefault(run, {})) \
                if kernels is not None else contextlib.nullcontext():
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
            tok = held.rows(fed[:, -1:].to(dev))
            full, _ = eng.step(cache, tok, pos, full_kw)
            keep["full_logits"] = held.gather_rows(full[:, -1]).float().cpu()
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
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(record, f)
    if args.rank == 0 and saved:
        torch.save(saved, os.path.join(args.out, "rank0.pt"))
    if kernels:
        torch.save(kernels, os.path.join(args.out, "kernels.pt"))
    barrier()
    import torch.distributed as dist

    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: List[str], world: int,
           module: str = "xkv_tpu_torch.scripts.tp_serve") -> List[subprocess.Popen]:
    """Start ``world`` ranks of ``module`` (this script by default) with
    ``argv`` (its options but the ranks'; ``--data`` among them when the
    mesh has a data axis)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--world", str(world),
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
            where = (f"rank {rec['rank']} at {tuple(rec['coords'])} ({rec['heads'][0]} q / "
                     f"{rec['heads'][1]} kv heads) {run}: ")
            if args.batched:
                print(where + f"run {row['run_s']:.3f} s (admissions {row['admission_s']:.3f} "
                      f"s), eager {row['step_ms']:.2f} ms a step of {row['steps']}, launches "
                      f"{row['counts']}, tokens {row['tokens']}")
                continue
            print(where + f"prefill {row['prefill_s']:.3f} s, eager decode "
                  f"{row['decode_ms_per_token']:.2f} ms/token, launches {row['counts']}, "
                  f"tokens {row['tokens']}")
    return records


if __name__ == "__main__":
    main()
