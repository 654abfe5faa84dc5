"""Model architecture configs for the supported families.

A copy of ``xkv_tpu/models/config.py`` kept inside the port, which imports
nothing of the JAX package.

The reference patches HF models of four families (Llama / Mistral / Qwen2 /
DeepSeek-V2-MLA; reference `xKV/patch.py:54-71`). Here models are defined
natively, so one config dataclass covers the Llama-shaped families
(Mistral = sliding window; Qwen2 = qkv bias + sliding window) and a second
covers DeepSeek-V2 MLA.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Llama-family decoder config (covers Llama, Mistral, Qwen2)."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 16
    num_q_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    max_position_embeddings: int = 131072
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # Qwen2: True (q/k/v only, not o)
    sliding_window: Optional[int] = None  # Mistral/Qwen2
    model_type: str = "llama"

    # MLA (DeepSeek-V2) extras; only used when model_type == "deepseek_v2"
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # MoE extras (DeepSeek-V2)
    n_routed_experts: Optional[int] = None
    n_shared_experts: Optional[int] = None
    num_experts_per_tok: int = 6
    moe_intermediate_size: Optional[int] = None
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.num_q_heads // self.num_kv_heads

    @property
    def qk_head_dim(self) -> int:
        """Query/Key head dim (MLA: nope + rope parts)."""
        if self.model_type == "deepseek_v2":
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim

    @classmethod
    def from_hf_config(cls, config: dict) -> "ModelConfig":
        """Build from a HF ``config.json`` dict (Llama/Mistral/Qwen2/DeepSeek-V2)."""
        model_type = config.get("model_type", "llama")
        num_q = config["num_attention_heads"]
        head_dim = config.get("head_dim") or config["hidden_size"] // num_q
        common = dict(
            vocab_size=config["vocab_size"],
            hidden_size=config["hidden_size"],
            intermediate_size=config["intermediate_size"],
            num_layers=config["num_hidden_layers"],
            num_q_heads=num_q,
            num_kv_heads=config.get("num_key_value_heads", num_q),
            head_dim=head_dim,
            rms_norm_eps=config.get("rms_norm_eps", 1e-5),
            rope_theta=config.get("rope_theta", 10000.0),
            rope_scaling=config.get("rope_scaling"),
            max_position_embeddings=config.get("max_position_embeddings", 131072),
            tie_word_embeddings=config.get("tie_word_embeddings", False),
            sliding_window=config.get("sliding_window"),
            model_type=model_type,
        )
        if model_type == "qwen2":
            common["attention_bias"] = True
        if model_type == "deepseek_v2":
            common.update(
                q_lora_rank=config.get("q_lora_rank"),
                kv_lora_rank=config["kv_lora_rank"],
                qk_rope_head_dim=config["qk_rope_head_dim"],
                qk_nope_head_dim=config["qk_nope_head_dim"],
                v_head_dim=config["v_head_dim"],
                n_routed_experts=config.get("n_routed_experts"),
                n_shared_experts=config.get("n_shared_experts"),
                num_experts_per_tok=config.get("num_experts_per_tok", 6),
                moe_intermediate_size=config.get("moe_intermediate_size"),
                first_k_dense_replace=config.get("first_k_dense_replace", 1),
                routed_scaling_factor=config.get("routed_scaling_factor", 1.0),
                norm_topk_prob=config.get("norm_topk_prob", False),
            )
        return cls(**common)

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "ModelConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_hf_config(json.load(f))


# Ready-made tiny configs for tests and known production shapes.
def tiny_llama_config(**overrides) -> ModelConfig:
    base = dict(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_layers=4,
        num_q_heads=4,
        num_kv_heads=2,
        head_dim=16,
        rope_theta=10000.0,
    )
    base.update(overrides)
    return ModelConfig(**base)


def llama31_8b_config() -> ModelConfig:
    """Llama-3.1-8B-Instruct (the reference's flagship eval model,
    reference README.md:87-88)."""
    return ModelConfig(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_q_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rms_norm_eps=1e-5,
        rope_theta=500000.0,
        rope_scaling={
            "rope_type": "llama3",
            "factor": 8.0,
            "low_freq_factor": 1.0,
            "high_freq_factor": 4.0,
            "original_max_position_embeddings": 8192,
        },
        max_position_embeddings=131072,
        model_type="llama",
    )


def llama32_1b_config() -> ModelConfig:
    """Llama-3.2-1B-Instruct."""
    return ModelConfig(
        vocab_size=128256,
        hidden_size=2048,
        intermediate_size=8192,
        num_layers=16,
        num_q_heads=32,
        num_kv_heads=8,
        head_dim=64,
        rms_norm_eps=1e-5,
        rope_theta=500000.0,
        rope_scaling={
            "rope_type": "llama3",
            "factor": 32.0,
            "low_freq_factor": 1.0,
            "high_freq_factor": 4.0,
            "original_max_position_embeddings": 8192,
        },
        tie_word_embeddings=True,
        max_position_embeddings=131072,
        model_type="llama",
    )


# DeepSeek-V2-Lite, the values of its published config.json
# (huggingface.co/deepseek-ai/DeepSeek-V2-Lite), the fields the model reads.
DEEPSEEK_V2_LITE = {
    "model_type": "deepseek_v2", "vocab_size": 102400, "hidden_size": 2048,
    "intermediate_size": 10944, "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "num_attention_heads": 16, "num_key_value_heads": 16, "n_shared_experts": 2,
    "n_routed_experts": 64, "num_experts_per_tok": 6, "routed_scaling_factor": 1.0,
    "first_k_dense_replace": 1, "norm_topk_prob": False, "kv_lora_rank": 512,
    "q_lora_rank": None, "qk_rope_head_dim": 64, "qk_nope_head_dim": 128,
    "v_head_dim": 128, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "max_position_embeddings": 163840, "tie_word_embeddings": False,
}


def deepseek_v2_lite_config() -> ModelConfig:
    """DeepSeek-V2-Lite (MLA + MoE: 16 heads, latent 512, 64 routed experts
    of which 6 a token, 2 shared, the first layer dense). Its rope_scaling
    (yarn, with the mscale softmax) is left out: neither the JAX package
    nor the port has yarn RoPE, so this runs plain RoPE at theta 10000."""
    return ModelConfig.from_hf_config(DEEPSEEK_V2_LITE)
