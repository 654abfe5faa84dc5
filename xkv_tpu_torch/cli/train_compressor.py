"""CLI: train a learned KV compressor against a frozen base model.

The port's counterpart of ``xkv_tpu/cli/train_compressor.py`` (the
reference's `scripts/train_dual1d_lightning.py` / `train_conv.py` /
`train_vae_conv.py`): the same flags, text, chunks and batch draws, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).
The base model loads through ``cli.common.load_model_and_tokenizer``: bf16
on the card (K1's one dtype, in every frozen forward), fp32 on the CPU.

  python -m xkv_tpu_torch.cli.train_compressor --model tiny:4x64 \\
      --compressor dual1d --steps 20 --batch 2 --seq-len 128 \\
      --output-dir /tmp/ckpt --device cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--compressor", default="dual1d",
                    choices=["identity", "conv", "enhanced", "dual1d", "vae"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--kl-weight", type=float, default=1e-3)
    ap.add_argument("--layer-stride", type=int, default=2)
    ap.add_argument("--seq-stride", type=int, default=2)
    ap.add_argument("--feature-ratio", type=int, default=8)
    ap.add_argument("--text-file", nargs="*", default=None)
    ap.add_argument("--output-dir", default="compressor_ckpt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to run on: cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    from xkv_tpu_torch.cli.common import load_model_and_tokenizer
    from xkv_tpu_torch.train import CompressorTrainer, TrainConfig

    on_card = torch.device(args.device).type == "cuda"
    params, cfg, tokenizer = load_model_and_tokenizer(
        args, dtype=torch.bfloat16 if on_card else torch.float32)

    # Token stream: local text or deterministic synthetic.
    if args.text_file:
        text = "\n".join(open(p).read() for p in args.text_file)
    else:
        import random

        from xkv_tpu_torch.evalharness.ruler.wordlists import essay_words

        text = " ".join(essay_words(random.Random(args.seed), approx_words=50_000))
    ids = np.asarray(tokenizer.encode(text), dtype=np.int32)
    n_chunks = len(ids) // args.seq_len
    chunks = ids[: n_chunks * args.seq_len].reshape(n_chunks, args.seq_len)

    comp_kwargs = {}
    if args.compressor == "dual1d":
        comp_kwargs = dict(
            layer_stride=args.layer_stride,
            seq_stride=args.seq_stride,
            feature_ratio=args.feature_ratio,
        )
    tcfg = TrainConfig(
        compressor=args.compressor,
        compressor_kwargs=comp_kwargs,
        learning_rate=args.lr,
        total_steps=args.steps,
        kl_weight=args.kl_weight,
        seed=args.seed,
    )
    trainer = CompressorTrainer(params, cfg, tcfg, device=args.device)

    rng = np.random.default_rng(args.seed)

    def batch():
        idx = rng.integers(0, n_chunks, size=args.batch)
        return chunks[idx]

    kv_shape = trainer.init(batch())
    print(f"KV tensor shape per batch: {kv_shape}")

    for step in range(args.steps):
        row = trainer.train_step(batch())
        if (step + 1) % args.eval_every == 0 or step == 0:
            print({k: round(v, 5) if isinstance(v, float) else v for k, v in row.items()})

    ckpt = os.path.join(args.output_dir, f"{args.compressor}.msgpack")
    trainer.save_checkpoint(ckpt)
    trainer.write_metrics_csv(os.path.join(args.output_dir, "metrics.csv"))
    print(f"checkpoint: {ckpt}")


if __name__ == "__main__":
    main()
