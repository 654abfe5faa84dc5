"""Perplexity CLI ("RNN mode" counterpart of `eval_perplexity_rnn.py:331-409`).

Scores texts token-by-token through the compressed cache after prefilling
(and compressing) the first ``--prefill_frac`` of each sequence.

Text sources (offline-friendly):
  --text-file <path>     newline-delimited or plain text file(s)
  --dataset wikitext2    HF datasets (requires network/cache)
  --synthetic N          N deterministic synthetic paragraphs (smoke runs)

The port's counterpart of ``xkv_tpu/cli/eval_perplexity.py``: the same
flags (plus ``--device``, ``cli/common.py``); scored steps replay the
engine's captured decode step on the card.

  python -m xkv_tpu_torch.cli.eval_perplexity --model tiny:4x64 --synthetic 3 \\
      --xKV --layer_group_size 2 --rank_k 16 --rank_v 16 --max_length 512
"""

from __future__ import annotations

import argparse
import json
import os
import time

from xkv_tpu_torch.cli.common import (add_common_args, build_engine,
                                      load_model_and_tokenizer, refusal)
from xkv_tpu_torch.evalharness.perplexity import evaluate_texts


def _synthetic_texts(n: int):
    from xkv_tpu_torch.evalharness.ruler.wordlists import essay_words
    import random

    texts = []
    for i in range(n):
        words = essay_words(random.Random(1234 + i), approx_words=600)
        texts.append(" ".join(words))
    return texts


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--text-file", nargs="*", default=None)
    parser.add_argument("--dataset", type=str, default=None,
                        choices=[None, "wikitext2", "c4"])
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--max_length", type=int, default=4096)
    parser.add_argument("--prefill_frac", type=float, default=0.5)
    parser.add_argument("--stride", type=int, default=None,
                        help="sliding-window stride for texts longer than "
                        "--max_length (reference --stride; default: truncate)")
    parser.add_argument("--num_texts", type=int, default=-1)
    parser.add_argument("--output", type=str, default=None)
    args = parser.parse_args(argv)

    texts = []
    if args.text_file:
        for path in args.text_file:
            with open(path) as f:
                content = f.read()
            texts.extend([t for t in content.split("\n\n") if len(t) > 200])
    if args.dataset == "wikitext2":
        from datasets import load_dataset

        ds = load_dataset("wikitext", "wikitext-2-raw-v1", split="test")
        blob = "\n\n".join(row["text"] for row in ds)
        texts.extend([t for t in blob.split("\n\n") if len(t) > 200])
    if args.synthetic:
        texts.extend(_synthetic_texts(args.synthetic))
    if not texts:
        parser.error("no texts: pass --text-file, --dataset, or --synthetic N")
    reason = refusal(args)
    if reason is not None:
        parser.error(reason)
    if args.num_texts > 0:
        texts = texts[: args.num_texts]

    params, cfg, tokenizer = load_model_and_tokenizer(args)
    engine = build_engine(args, params, cfg, tail_max=args.max_length)

    t0 = time.time()
    result = evaluate_texts(
        engine, tokenizer, texts, max_length=args.max_length,
        prefill_frac=args.prefill_frac, stride=args.stride,
    )
    elapsed = time.time() - t0

    summary = {
        "perplexity": result["perplexity"],
        "total_tokens": result["total_tokens"],
        "num_texts": result["num_texts"],
        "elapsed_s": elapsed,
        "args": {k: str(v) for k, v in vars(args).items()},
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    print(json.dumps({k: v for k, v in summary.items() if k != "args"}))
    if args.output:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        existing = []
        if os.path.exists(args.output):
            with open(args.output) as f:
                existing = json.load(f)
        existing.append(summary)
        with open(args.output, "w") as f:
            json.dump(existing, f, indent=2)
        print(f"written {args.output}")


if __name__ == "__main__":
    main()
