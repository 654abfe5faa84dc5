"""Accuracy evaluation CLI (RULER / LongBench / local jsonl).

Counterpart of the reference's `evaluate/eval_acc.py:92-165`:
seeds everything, loads the model, applies the xKV merge plan, iterates
datasets through the Evaluator, appends aggregated results (with timestamp
and full args) to ``{result_dir}/{benchmark}/{model}.json``.

The port's counterpart of ``xkv_tpu/cli/eval_acc.py``: the same flags
(plus ``--device``, ``cli/common.py``), the same output files. Prompts stay
numpy int32 arrays (``evalharness/dataset.py``); the engine moves them to
its device.

Data parallelism: the reference spawns torchrun ranks; here pass
--rank/--world_size (one process per rank, each in a torch.distributed
process group of that size, which gathers the summaries) or run
single-process.

  python -m xkv_tpu_torch.cli.eval_acc --model <dir> --xKV \\
      --layer_group_size 4 --rank_k 512 --rank_v 768 \\
      --datasets ruler/niah_single_1 --datalen 65536
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from xkv_tpu_torch.cli.common import (add_common_args, build_engine,
                                      load_model_and_tokenizer, refusal)


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--datasets", nargs="+", default=None)
    parser.add_argument("--dataset_name", type=str, default=None,
                        help="reference alias: comma-separated dataset list")
    parser.add_argument("--datalen", type=int, default=65536)
    parser.add_argument("--num_samples", type=int, default=-1)
    parser.add_argument("--batch_size", type=int, default=1,
                        help="accepted for reference compatibility "
                        "(evaluation generates per sample)")
    parser.add_argument("--result_dir", type=str, default="results")
    parser.add_argument("--benchmark", type=str, default="ruler")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--world_size", type=int, default=1)
    parser.add_argument("--gen_len", type=int, default=None)
    parser.add_argument("--probe_sparse_layers", action="store_true",
                        help="instead of evaluating: run the automated "
                        "sparse-layer probe (leave-one-out agreement sweep, "
                        "evalharness/sparse_probe.py) on the first "
                        "--num_samples prompts of the first dataset and "
                        "print the recommended --sparse_layers value")
    parser.add_argument("--probe_threshold", type=float, default=0.95,
                        help="greedy-output agreement target for the probe")
    parser.add_argument("--pad_to", type=int, default=None,
                        help="left-pad prompts with RULER noise sentences "
                        "to the next multiple of N tokens (+BOS), so that "
                        "samples share prompt shapes (the JAX package "
                        "compiles one prefill a shape)")
    args = parser.parse_args(argv)
    if args.dataset_name:
        args.datasets = (args.datasets or []) + args.dataset_name.split(",")
    if not args.datasets:
        parser.error("pass --datasets ... or --dataset_name a,b,c")
    reason = refusal(args)
    if reason is not None:
        parser.error(reason)

    np.random.seed(args.seed)

    params, cfg, tokenizer = load_model_and_tokenizer(args)

    from xkv_tpu_torch.evalharness import Dataset, Evaluator

    datasets = []
    max_gen = 1
    for name in args.datasets:
        ds = Dataset(
            name,
            tokenizer,
            args.datalen,
            num_samples=args.num_samples,
            data_dir=args.data_dir,
            gen_len=args.gen_len,
        )
        datasets.append(ds)
        max_gen = max(max_gen, ds.gen_len)

    if args.probe_sparse_layers:
        # Automated sparse-layer probe (VERDICT r4 #9): recommend the
        # per-layer sparse/dense mix instead of evaluating.
        from xkv_tpu_torch.cli.common import build_xkv_config
        from xkv_tpu_torch.evalharness.sparse_probe import probe_sparse_layers

        if not args.sparse_topk:
            raise SystemExit("--probe_sparse_layers needs --sparse_topk")
        xkv = build_xkv_config(args, cfg.num_layers)
        n = args.num_samples if args.num_samples > 0 else 4
        ds = datasets[0]
        prompts = [ds[i][0] for i in range(min(n, len(ds)))]
        rep = probe_sparse_layers(
            params, cfg, xkv, prompts,
            sparse_topk=args.sparse_topk, sparse_block=args.sparse_block,
            gen_len=min(datasets[0].gen_len, 16),
            threshold=args.probe_threshold,
            engine_kwargs={"device": args.device},
        )
        rec = rep["recommended_sparse_layers"]
        print(json.dumps({
            "recommended_sparse_layers": rec,
            "flag": "--sparse_layers " + ",".join(str(x) for x in rec),
            "agreement_all_sparse": round(rep["agreement_all_sparse"], 4),
            "agreement_final": round(rep["agreement_final"], 4),
            "per_layer_gain": {
                str(k): round(v, 4)
                for k, v in rep["per_layer_gain"].items()
            },
        }))
        return

    engine = build_engine(args, params, cfg, tail_max=max_gen + 8)

    eos = getattr(tokenizer, "eos_token_id", None)

    spec_k = getattr(args, "speculative_k", None)
    if spec_k is not None and not engine.draft_kw:
        raise SystemExit("--speculative_k needs --sparse_topk (llama) or "
                         "--draft_rank (MLA) — the draft path")

    pad_filler = None
    if args.pad_to:
        from xkv_tpu_torch.evalharness.ruler.generators import NOISE_SENTENCE

        pad_filler = np.asarray(
            tokenizer.encode(NOISE_SENTENCE + "\n"), np.int32
        )

    def bucket_pad(prompt_ids):
        """[BOS?, filler..., prompt] padded to a multiple of --pad_to.
        Left-padding with haystack noise is semantically inert for RULER
        (it IS the haystack sentence) and keeps prefill shapes shared
        across samples. A tokenizer with no BOS (bos_token_id is
        None) gets NO synthetic prefix — pad to an exact multiple instead
        (ADVICE r4: `or 1` silently injected an arbitrary vocab piece, and
        a legitimate bos_token_id of 0 was replaced)."""
        n = int(prompt_ids.shape[1])
        bos = getattr(tokenizer, "bos_token_id", None)
        n_bos = 0 if bos is None else 1
        tgt = -(-(n + n_bos) // args.pad_to) * args.pad_to
        need = tgt - n - n_bos
        reps = np.tile(pad_filler, need // len(pad_filler) + 1)[:need]
        head = [] if bos is None else [np.asarray([bos], np.int32)]
        row = np.concatenate(
            head + [reps, np.asarray(prompt_ids).reshape(-1)]
        )
        return row[None, :]

    def generate_fn(prompt_ids, gen_len):
        if pad_filler is not None:
            prompt_ids = bucket_pad(prompt_ids)
        if spec_k is not None:
            # Sparse-draft / exact-verify: same tokens as engine.generate,
            # ~(k+1)x fewer exact-attention rounds when drafts agree.
            out = engine.generate_speculative(
                prompt_ids, max_new_tokens=gen_len, draft_k=spec_k,
                eos_token_id=eos,
            )
            return out[0].numpy()
        out = engine.generate(prompt_ids, max_new_tokens=gen_len, eos_token_id=eos)
        return (out[0] if isinstance(out, list) else out[0].cpu()).numpy()

    def decode_fn(tokens):
        return tokenizer.decode(tokens, skip_special_tokens=True)

    evaluator = Evaluator(
        generate_fn, decode_fn, rank=args.rank, world_size=args.world_size
    )

    model_name = os.path.basename(os.path.normpath(args.model)).replace(":", "_")
    for ds in datasets:
        pred_path = os.path.join(
            args.result_dir,
            args.benchmark,
            model_name,
            f"{ds.dataset_name.replace('/', '_')}_rank{args.rank}.jsonl",
        )
        summary = evaluator.test(ds, output_path=pred_path)
        print(f"[rank {args.rank}] {ds.dataset_name}: {summary}")

    final = evaluator.summarize()
    if final or args.world_size == 1:
        out_path = os.path.join(args.result_dir, args.benchmark, f"{model_name}.json")
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        existing = []
        if os.path.exists(out_path):
            with open(out_path) as f:
                existing = json.load(f)
        existing.append(
            {
                "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
                "args": {k: str(v) for k, v in vars(args).items()},
                "results": final,
            }
        )
        with open(out_path, "w") as f:
            json.dump(existing, f, indent=2)
        print(evaluator.markdown_table())
        print(f"results appended to {out_path}")


if __name__ == "__main__":
    main()
