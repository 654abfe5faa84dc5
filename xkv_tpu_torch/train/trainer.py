"""Compressor training loop: AdamW + warmup-cosine, MSE (+KL) reconstruction.

The port's counterpart of ``xkv_tpu/train/trainer.py`` (the rebuild of the
reference's Lightning module, `src/kv_lightning_module.py:22-519`): KV
collected per batch from a frozen base model (``collect_kv``: K1 on the
card), reconstruction loss, AdamW with optax's numbers over
``warmup_cosine_decay_schedule``, and **compressor-only checkpoints** in
flax's byte format (``train.serialization``), so a file written by either
package loads in the other; base-model weights are never saved (reference
`kv_lightning_module.py:404-469`).

The VAE's noise: a ``torch.Generator`` seeded ``seed * 100003 + step`` in
``train_step`` and 0 in ``eval_step``, where the JAX trainer takes
``PRNGKey``s of those seeds (the streams differ; tests hand both sides the
same noise).
"""

from __future__ import annotations

import csv
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from xkv_tpu_torch.models.config import ModelConfig
from xkv_tpu_torch.train import serialization
from xkv_tpu_torch.train.collector import collect_kv
from xkv_tpu_torch.train.compressors import (
    VAEConvCompressor,
    kl_divergence,
    make_compressor,
    params_from_flax,
    params_to_flax,
)
from xkv_tpu_torch.train.lm import ADAMW_BETAS, ADAMW_EPS, warmup_cosine_decay_schedule


@dataclass
class TrainConfig:
    compressor: str = "dual1d"
    compressor_kwargs: Dict[str, Any] = field(default_factory=dict)
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    warmup_steps: int = 10
    total_steps: int = 1000
    kl_weight: float = 1e-3
    seed: int = 0


class CompressorTrainer:
    def __init__(self, base_params, model_cfg: ModelConfig, cfg: TrainConfig,
                 device: str | torch.device = "cuda"):
        self.base_params = base_params
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = torch.device(device)
        self.schedule = warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, cfg.warmup_steps,
            max(cfg.total_steps, cfg.warmup_steps + 1))
        self.compressor: Optional[torch.nn.Module] = None
        self.is_vae = False
        self.opt: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self.history = []

    # ------------------------------------------------------------------ init
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.long).to(self.device)

    def init(self, sample_tokens) -> Tuple[int, ...]:
        """Build the compressor for the sample batch's K/V width, its
        parameters drawn from a generator seeded ``cfg.seed`` (flax's
        distributions), and the optimizer. Returns the K/V shape."""
        kv = collect_kv(self.base_params, self.model_cfg, self._tokens(sample_tokens))
        self.compressor = make_compressor(self.cfg.compressor, kv.shape[-1],
                                          **self.cfg.compressor_kwargs)
        gen = torch.Generator()
        gen.manual_seed(self.cfg.seed)
        self.compressor.reset_parameters(gen)
        self.compressor.to(self.device)
        self.is_vae = isinstance(self.compressor, VAEConvCompressor)
        self.opt = torch.optim.AdamW(self.compressor.parameters(), lr=0.0, betas=ADAMW_BETAS,
                                     eps=ADAMW_EPS, weight_decay=self.cfg.weight_decay)
        return tuple(kv.shape)

    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The compressor's parameters as flax's tree (``params_to_flax``)."""
        return params_to_flax(self.compressor)

    # ----------------------------------------------------------------- steps
    def _loss(self, kv: torch.Tensor, seed: int, eps: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        kv = kv.to(torch.float32)
        if self.is_vae:
            gen = None
            if eps is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed)
            else:
                eps = eps.to(self.device)
            recon, mu, logvar = self.compressor(kv, train=True, eps=eps, generator=gen)
            mse = torch.mean((recon - kv) ** 2)
            kl = kl_divergence(mu, logvar)
            return mse + self.cfg.kl_weight * kl, {"mse": mse, "kl": kl}
        recon = self.compressor(kv, train=True)
        mse = torch.mean((recon - kv) ** 2)
        mae = torch.mean(torch.abs(recon - kv))
        return mse, {"mse": mse, "mae": mae}

    def train_step(self, tokens) -> Dict[str, float]:
        kv = collect_kv(self.base_params, self.model_cfg, self._tokens(tokens))
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.step)
        self.opt.zero_grad(set_to_none=True)
        loss, metrics = self._loss(kv, self.cfg.seed * 100003 + self.step)
        loss.backward()
        self.opt.step()
        self.step += 1
        row = {"step": self.step, "loss": loss.item()}
        row.update({k: v.item() for k, v in metrics.items()})
        if hasattr(self.compressor, "compression_ratio"):
            row["compression_ratio"] = float(self.compressor.compression_ratio())
        self.history.append(row)
        return row

    @torch.no_grad()
    def eval_step(self, tokens, eps: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """The loss on one batch, no update. ``eps``: the VAE's noise
        (default: drawn from a generator seeded 0)."""
        kv = collect_kv(self.base_params, self.model_cfg, self._tokens(tokens))
        loss, metrics = self._loss(kv, 0, eps)
        return {"loss": loss.item(), **{k: v.item() for k, v in metrics.items()}}

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, path: str):
        """Compressor-only, in flax's bytes (base-model weights are excluded
        by construction; reference `tests/test_checkpoint_saving.py:15-80`),
        and the JAX trainer's sidecar JSON."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(serialization.to_bytes(params_to_flax(self.compressor)))
        meta = {
            "compressor": self.cfg.compressor,
            "compressor_kwargs": self.cfg.compressor_kwargs,
            "step": self.step,
            "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        }
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=2)

    @classmethod
    def load_checkpoint(cls, path: str, base_params, model_cfg: ModelConfig, sample_tokens,
                        device: str | torch.device = "cuda") -> "CompressorTrainer":
        """Load requires the base model supplied at load time (the checkpoint
        never contains it - reference `kv_lightning_module.py:484-519`)."""
        with open(path + ".json") as f:
            meta = json.load(f)
        cfg = TrainConfig(compressor=meta["compressor"],
                          compressor_kwargs=meta["compressor_kwargs"])
        trainer = cls(base_params, model_cfg, cfg, device=device)
        trainer.init(sample_tokens)
        with open(path, "rb") as f:
            params_from_flax(trainer.compressor, serialization.from_bytes(f.read()))
        trainer.step = meta.get("step", 0)
        return trainer

    def write_metrics_csv(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not self.history:
            return
        keys = sorted({k for row in self.history for k in row})
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=keys)
            writer.writeheader()
            writer.writerows(self.history)
