"""Shared CLI plumbing: the reference's flag surface + engine construction.

The port's counterpart of ``xkv_tpu/cli/common.py``. Flag names kept
identical to the reference (`utils.py:96-137`) so existing invocations
translate directly: --xKV --rank_k --rank_v --layer_group_size
--layer_merge_impl --slerp_t --slerp_gamma --merge_key --merge_value
--start_layer_idx --end_layer_idx --customized_merge_config; and the JAX
package's additions: --mode (factored|fake|none), --rope_mode,
--svd_method, --factor_dtype and the sparse / speculative flags.

The port's differences:
  * ``--device`` (default ``cuda``): where the model runs; ``cpu`` runs the
    kernels' plain versions.
  * ``--attention_impl`` and ``--flash2`` are accepted so that invocations
    translate, and do nothing: on the card prefill attention is always the
    K1 kernel, on the CPU its plain version.
  * ``--mesh_model > 1`` (the engine runs under a mesh, but the CLIs
    start no ranks: ROADMAP item 17) and ``--sequence_parallel`` are
    refused, and so is ``--factor_dtype fp32`` on the card (the
    decode kernels take bf16, int8 or int4 factors); ``refusal`` says so
    before any weight is loaded.
  * ``ckpt:`` models load in fp32 on the CPU, as the JAX package loads them,
    and in bf16 on the card, the one dtype the K1 kernel takes.
  * ``tiny:<L>x<H>`` builds the JAX package's config; its weights are the
    port's ``init_params`` drawn from a ``torch.Generator`` seeded by
    ``--seed`` (not JAX's ``jax.random`` draws).
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from xkv_tpu_torch.configs import XKVConfig, generate_consecutive_xkv_config


def add_common_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--model", "--model_name_or_path", dest="model",
                        type=str, required=True,
                        help="local HF model dir, or tiny:<preset> for "
                        "synthetic (--model_name_or_path = reference alias)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda",
                        help="device to run on: cuda (the kernels) or cpu "
                        "(their plain versions)")
    parser.add_argument("--flash2", action="store_true",
                        help="reference alias, accepted and ignored: prefill "
                        "attention is the K1 kernel on the card and its plain "
                        "version on the CPU")
    # xKV flags (reference utils.py:96-137)
    parser.add_argument("--xKV", action="store_true", help="enable KV merging")
    parser.add_argument("--rank_k", type=int, default=256)
    parser.add_argument("--rank_v", type=int, default=768)
    parser.add_argument("--layer_group_size", type=int, default=2)
    parser.add_argument("--layer_merge_impl", type=str, default="svd",
                        choices=["svd", "slerp"])
    parser.add_argument("--slerp_t", type=float, default=0.5)
    parser.add_argument("--slerp_gamma", type=float, default=1.0)
    parser.add_argument("--merge_key", action="store_true", default=True)
    parser.add_argument("--no_merge_key", dest="merge_key", action="store_false")
    parser.add_argument("--merge_value", action="store_true", default=True)
    parser.add_argument("--no_merge_value", dest="merge_value", action="store_false")
    parser.add_argument("--start_layer_idx", type=int, default=0)
    parser.add_argument("--end_layer_idx", type=int, default=-1)
    parser.add_argument("--customized_merge_config", type=str, default=None)
    parser.add_argument("--mode", type=str, default="factored",
                        choices=["factored", "fake", "none"],
                        help="factored = real compressed cache; fake = "
                        "reference-parity dense reconstruction; none = baseline")
    parser.add_argument("--attention_impl", type=str, default=None,
                        choices=["xla", "pallas"],
                        help="accepted and ignored (JAX package flag): prefill "
                        "attention is the K1 kernel on the card and its plain "
                        "version on the CPU")
    parser.add_argument("--mesh_model", type=int, default=1,
                        help="tensor-parallel width; only 1 (the engine serves a "
                        "mesh, but the CLIs start no ranks yet: ROADMAP item 17)")
    parser.add_argument("--rope_mode", type=str, default="pre",
                        choices=["pre", "post"],
                        help="factored-key domain: 'pre' = reference "
                        "pre-RoPE semantics; 'post' = rotate before the "
                        "SVD for rank-space decode (docs/ROPE_MODES.md)")
    parser.add_argument("--svd_method", type=str, default="randomized",
                        choices=["exact", "randomized"])
    parser.add_argument("--factor_dtype", type=str, default="bf16",
                        choices=["bf16", "fp32", "int8", "int4"],
                        help="low-rank factor storage dtype (int8 = quantized; "
                        "fp32 on the CPU only: the decode kernels take bf16, "
                        "int8 or int4 factors)")
    parser.add_argument("--speculative_k", type=int, default=None,
                        help="speculative decoding: draft N tokens with the "
                        "cheap path, verify with one exact multi-token "
                        "pass (bit-exact greedy output; needs "
                        "--sparse_topk for llama or --draft_rank for MLA)")
    parser.add_argument("--draft_rank", type=int, default=None,
                        help="MLA speculative drafts: truncate the factored "
                        "latents to the top-r singular directions (draft "
                        "only; plain decode stays full-rank)")
    parser.add_argument("--sparse_topk", type=int, default=None,
                        help="sparse decode: attend to the N best prefill "
                        "chunks per step (Quest-bound selection)")
    parser.add_argument("--sparse_block", type=int, default=1024)
    parser.add_argument("--sparse_layers", type=str, default=None,
                        help="comma list of layer indices to decode "
                        "sparsely (others stay exact) — per-layer mixing "
                        "for layers whose Quest bounds are uninformative")
    parser.add_argument("--sparse_adaptive_band", type=float, default=0.5,
                        help="hot-chunk band for the adaptive budget "
                        "trigger (larger fires more often)")
    parser.add_argument("--sparse_topk_max", type=int, default=None,
                        help="adaptive sparse budget ceiling: steps whose "
                        "Quest bounds show many near-max chunks (the "
                        "multi-answer signature) spend this budget instead "
                        "of --sparse_topk")
    parser.add_argument("--slerp_compact", action="store_true",
                        help="compact MiniCache storage (direction + norms "
                        "+ exception rows) for slerp groups")
    parser.add_argument("--slerp_keep_frac", type=float, default=0.125)
    parser.add_argument("--sequence_parallel", action="store_true",
                        help="refused: the engine serves ring-attention prefill "
                        "over a mesh's data axis, but the CLIs start no ranks "
                        "yet (ROADMAP item 17)")
    return parser


def refusal(args) -> Optional[str]:
    """Why these arguments cannot run in the port, or None. The CLIs check
    it before any weight is loaded."""
    if args.mesh_model > 1:
        return (f"--mesh_model {args.mesh_model}: the CLIs have no launcher for "
                "tensor-parallel ranks yet (ROADMAP item 17; the engines serve a mesh: "
                "InferenceEngine(mesh=...), BatchedEngine(mesh=...), "
                "scripts/tp_serve.py); use --mesh_model 1")
    if args.sequence_parallel:
        return ("--sequence_parallel: the engine serves ring-attention prefill over a "
                "mesh's data axis (InferenceEngine(mesh=..., sequence_parallel=True), "
                "scripts/tp_serve.py --sequence_parallel), but the CLIs start no ranks yet "
                "(ROADMAP item 17)")
    if args.factor_dtype == "fp32" and torch.device(args.device).type == "cuda":
        return ("--factor_dtype fp32 on the card: the decode kernels take bf16, "
                "int8 or int4 factors; use one of those, or --device cpu")
    return None


def build_xkv_config(args, num_layers: int) -> Optional[XKVConfig]:
    """Reference `utils.py:68-93`: custom YAML wins, else consecutive groups."""
    if not args.xKV:
        return None
    if args.customized_merge_config:
        cfg = XKVConfig.from_yaml(args.customized_merge_config)
        if cfg.num_layers is None:
            cfg.num_layers = num_layers
        return cfg
    return generate_consecutive_xkv_config(
        layer_merge_impl=args.layer_merge_impl,
        start_layer=args.start_layer_idx,
        end_layer=args.end_layer_idx,
        num_layers=num_layers,
        group_size=args.layer_group_size,
        rank_k=args.rank_k,
        rank_v=args.rank_v,
        slerp_t=args.slerp_t,
        slerp_gamma=args.slerp_gamma,
        merge_key=args.merge_key,
        merge_value=args.merge_value,
        extra_kwargs={
            "svd_method": args.svd_method,
            "rope_mode": getattr(args, "rope_mode", "pre"),
            "slerp_compact": getattr(args, "slerp_compact", False),
            "slerp_keep_frac": getattr(args, "slerp_keep_frac", 0.125),
        },
    )


def load_model_and_tokenizer(args, dtype=torch.bfloat16):
    """Returns (params, model_cfg, tokenizer), the weights on ``args.device``."""
    device = torch.device(args.device)
    if args.model.startswith("tiny:"):
        # synthetic presets for offline testing: tiny:<layers>x<hidden>
        from xkv_tpu_torch.models.config import tiny_llama_config
        from xkv_tpu_torch.models.llama import init_params
        from xkv_tpu_torch.utils.tokenizer import ByteTokenizer

        spec = args.model[len("tiny:") :] or "4x64"
        n_layers, hidden = (int(x) for x in spec.split("x"))
        cfg = tiny_llama_config(
            num_layers=n_layers,
            hidden_size=hidden,
            intermediate_size=2 * hidden,
            num_q_heads=max(4, hidden // 16),
            num_kv_heads=max(2, hidden // 32),
            head_dim=16,
            vocab_size=259,
        )
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        params = init_params(cfg, gen, dtype=dtype, device=device)
        return params, cfg, ByteTokenizer()

    if args.model.startswith("ckpt:"):
        # locally-trained native checkpoint (models/ckpt.py), e.g. the
        # production-geometry study model for the offline RULER suite.
        # Byte-tokenized: its vocab covers ByteTokenizer ids (0..258).
        from xkv_tpu_torch.models.ckpt import load_checkpoint
        from xkv_tpu_torch.utils.tokenizer import ByteTokenizer

        # fp32 on the CPU, as the JAX package evaluates these models (the
        # training dtype isolates compression deltas from weight rounding);
        # bf16 on the card, the one dtype the K1 kernel takes.
        ckpt_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        params, cfg = load_checkpoint(args.model[len("ckpt:"):], dtype=ckpt_dtype,
                                      device=device)
        return params, cfg, ByteTokenizer()

    from xkv_tpu_torch.models.loader import load_params
    from xkv_tpu_torch.utils.tokenizer import load_tokenizer

    params, cfg = load_params(args.model, dtype=dtype, device=device)
    return params, cfg, load_tokenizer(args.model)


def build_engine(args, params, cfg, tail_max: int, **kw):
    from xkv_tpu_torch.engine import InferenceEngine

    reason = refusal(args)
    if reason is not None:
        raise ValueError(reason)
    xkv = build_xkv_config(args, cfg.num_layers)
    mode = args.mode if args.xKV else "none"
    factor_dtype = {
        "bf16": torch.bfloat16, "fp32": torch.float32, "int8": "int8",
        "int4": "int4",
    }[getattr(args, "factor_dtype", "bf16")]
    kw.setdefault("factor_dtype", factor_dtype)
    if getattr(args, "sparse_topk", None) and mode == "factored":
        kw.setdefault("sparse_topk", args.sparse_topk)
        kw.setdefault("sparse_block", args.sparse_block)
        if getattr(args, "sparse_layers", None):
            kw.setdefault("sparse_layers", frozenset(
                int(x) for x in args.sparse_layers.split(",")))
        if getattr(args, "sparse_topk_max", None):
            kw.setdefault("sparse_topk_max", args.sparse_topk_max)
            kw.setdefault("sparse_adaptive_band",
                          getattr(args, "sparse_adaptive_band", 0.5))
    if getattr(args, "draft_rank", None) and mode == "factored":
        kw.setdefault("draft_rank", args.draft_rank)
    return InferenceEngine(
        params, cfg, xkv=xkv, mode=mode, tail_max=tail_max, device=args.device, **kw,
    )
