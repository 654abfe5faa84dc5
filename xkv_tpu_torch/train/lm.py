"""Minimal LM training for the functional models (tests, demos, the
accuracy gates).

The port's counterpart of ``xkv_tpu/train/lm.py``: next-token
cross-entropy through the prefill and an AdamW + warmup-cosine loop with
optax's numbers. K1 has no backward kernel, so the loss runs the prefill
on ``ops.attention.plain_prefill_attention`` (the JAX ``lm_loss``
differentiates its prefill at ``attention_impl="xla"``, the same plain
attention); the kernel wrappers refuse operands that require grad.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from xkv_tpu_torch.models import llama
from xkv_tpu_torch.models.config import ModelConfig
from xkv_tpu_torch.ops.attention import plain_prefill_attention

# optax.adamw's defaults: b1, b2, eps, weight decay.
ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over the first ``warmup_steps`` counts, then cosine to
    ``end_value`` at count ``decay_steps`` (which includes the warmup).
    Count 0 is the first update's."""
    decay = decay_steps - warmup_steps
    if decay <= 0:
        raise ValueError("the cosine part needs decay_steps > warmup_steps")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def tree_map(fn, tree):
    """``fn`` over the tensors of a parameter tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def lm_loss(params, cfg: ModelConfig, tokens: torch.Tensor,
            loss_mask: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy. tokens (b, s); loss_mask (b, s) weights the
    *target* positions (token at i predicts i+1)."""
    logits, _ = llama.prefill(params, cfg, tokens[:, :-1], attention=plain_prefill_attention)
    targets = tokens[:, 1:].long()
    mask = loss_mask[:, 1:].to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def train_lm(
    params,
    cfg: ModelConfig,
    batch_fn: Callable[[int], Tuple],
    steps: int = 1000,
    lr: float = 3e-3,
    log_every: int = 200,
    verbose: bool = False,
) -> Tuple[Dict, list]:
    """AdamW + cosine training loop (optax's ``adamw`` over
    ``warmup_cosine_decay_schedule(0, lr, min(50, steps // 10 + 1),
    steps)``). batch_fn(step) -> (tokens, loss_mask), arrays or tensors.
    Returns (trained parameters, a tree like ``params`` of tensors that do
    not require grad; the losses of step 1 and every ``log_every``-th)."""
    device = params["embed"].device
    trained = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    opt = torch.optim.AdamW(tree_leaves(trained), lr=0.0, betas=ADAMW_BETAS, eps=ADAMW_EPS,
                            weight_decay=ADAMW_WEIGHT_DECAY)
    schedule = warmup_cosine_decay_schedule(0.0, lr, min(50, steps // 10 + 1), steps)
    history = []
    for i in range(steps):
        tokens, mask = batch_fn(i)
        tokens = torch.as_tensor(tokens, device=device)
        mask = torch.as_tensor(mask, device=device)
        for group in opt.param_groups:
            group["lr"] = schedule(i)
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(trained, cfg, tokens, mask)
        loss.backward()
        opt.step()
        if (i + 1) % log_every == 0 or i == 0:
            history.append(loss.item())
            if verbose:
                print(f"step {i + 1}: loss {history[-1]:.4f}", flush=True)
    return tree_map(lambda p: p.detach(), trained), history
