"""CLI: derive an xKV layer-group config from CKA similarity.

The port's counterpart of ``xkv_tpu/cli/group_layers.py`` (the reference's
`group_layers.py`, which reads a notebook-made similarity matrix): the same
flags, plus ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions). With ``--model`` the calibration prompt's tokens come from a
``torch.Generator`` seeded ``--seed`` (the JAX CLI draws them from
``jax.random``, whose stream the port cannot reproduce); the frozen prefill
runs K1 on the card.

  # from a saved similarity matrix (.npy):
  python -m xkv_tpu_torch.cli.group_layers --similarity sim.npy --n_groups 8 \\
      --rank_k 512 --rank_v 768 --output grouped.yaml

  # end-to-end from a model (synthetic prompt):
  python -m xkv_tpu_torch.cli.group_layers --model tiny:4x64 --n_groups 2 \\
      --rank_k 16 --rank_v 16 --output grouped.yaml --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--similarity", type=str, default=None, help=".npy matrix")
    ap.add_argument("--model", type=str, default=None)
    ap.add_argument("--calib_len", type=int, default=512)
    ap.add_argument("--which", choices=["k", "v"], default="k")
    ap.add_argument("--n_groups", type=int, required=True)
    ap.add_argument("--rank_k", type=int, default=512)
    ap.add_argument("--rank_v", type=int, default=768)
    ap.add_argument("--index_distance_scale", type=float, default=None)
    ap.add_argument("--output", type=str, required=True)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", type=str, default="cuda",
                    help="device to run on: cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    from xkv_tpu_torch.evalharness.cka import (
        cka_matrix,
        collect_kv_features,
        group_layers_from_cka,
        make_grouped_config,
    )

    if args.similarity:
        sim = np.load(args.similarity)
        num_layers = sim.shape[0]
    elif args.model:
        from xkv_tpu_torch.cli.common import load_model_and_tokenizer

        params, cfg, _ = load_model_and_tokenizer(args)
        gen = torch.Generator()
        gen.manual_seed(args.seed)
        tokens = torch.randint(0, cfg.vocab_size, (1, args.calib_len), generator=gen)
        feats = collect_kv_features(params, cfg, tokens.to(args.device), which=args.which)
        sim = cka_matrix(feats)
        num_layers = cfg.num_layers
    else:
        ap.error("pass --similarity or --model")

    groups = group_layers_from_cka(
        sim, args.n_groups, index_distance_scale=args.index_distance_scale
    )
    cfg_out = make_grouped_config(groups, num_layers, args.rank_k, args.rank_v)
    cfg_out.to_yaml(args.output)
    print(f"groups: {[g.layers for g in cfg_out.layer_groups]}")
    print(f"written {args.output}")


if __name__ == "__main__":
    main()
