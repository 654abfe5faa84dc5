"""Kernel-study tools of the port, run on the card:

    python -m xkv_tpu_torch.scripts.bench_kernel      # K3 against dense decode
    python -m xkv_tpu_torch.scripts.probe_int4        # K11 tensor-core rate probe
    python -m xkv_tpu_torch.scripts.kernel_ablation   # K10 stage ablation of K3
    python -m xkv_tpu_torch.scripts.kernel_variants   # K9 design variants of K3

Each keeps the flags and defaults of the JAX package's script of the same
name in ``scripts/`` (the TPU tools), adds ``--device`` (default ``cuda``)
and prints the card's name and power limit before its lines.
"""
