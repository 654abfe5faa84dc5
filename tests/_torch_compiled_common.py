"""The models, weights, engines and greedy loop that
``tests/test_torch_compiled.py`` and ``tests/test_torch_compiled_score.py``
share: the in-repo checkpoint, a tiny Mistral with a sliding window and the
tiny MLA + MoE config of ``tests/test_torch_deepseek.py`` (weights and
prompts from numpy seeds, exact SVD), as module-scoped fixtures a test file
imports (each file then builds its own, once)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xkv_tpu.configs import generate_consecutive_xkv_config as jax_xkv
from xkv_tpu.engine import InferenceEngine as JaxEngine
from xkv_tpu.models.ckpt import load_checkpoint as jax_load
from xkv_tpu.models.config import ModelConfig as JaxModelConfig
from xkv_tpu.models.config import tiny_llama_config as jax_tiny
from xkv_tpu.models.llama import init_params as jax_init
from xkv_tpu_torch.configs import generate_consecutive_xkv_config as torch_xkv
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.models import deepseek
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import ModelConfig, tiny_llama_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "results", "production_model")
MOE_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=4,
               num_q_heads=4, num_kv_heads=4, head_dim=16, model_type="deepseek_v2",
               q_lora_rank=None, kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16,
               v_head_dim=16, n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
               moe_intermediate_size=32, first_k_dense_replace=1, routed_scaling_factor=1.0,
               norm_topk_prob=True)
F32 = dict(cache_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def ckpt():
    return jax_load(CKPT)


@pytest.fixture(scope="module")
def mistral():
    jcfg = jax_tiny(model_type="mistral", sliding_window=10)
    np_params = jax.tree.map(np.array, jax_init(jcfg, jax.random.PRNGKey(2),
                                                  dtype=jnp.float32))
    return jcfg, tiny_llama_config(model_type="mistral", sliding_window=10), np_params


@pytest.fixture(scope="module")
def moe():
    return JaxModelConfig(**MOE_CFG), ModelConfig(**MOE_CFG), deepseek.numpy_params(
        ModelConfig(**MOE_CFG), 1)


def tokens(n, vocab, seed=0, b=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, n)).astype(np.int32)


def llama_kw(cfg, rope, rank_k=48, rank_v=64, group_size=2):
    return dict(group_size=group_size, rank_k=rank_k, rank_v=rank_v,
                num_layers=cfg.num_layers, end_layer=cfg.num_layers - 1,
                extra_kwargs={"svd_method": "exact", "rope_mode": rope})


def mla_kw(cfg, rank_k=40):
    return dict(group_size=2, rank_k=rank_k, rank_v=None, num_layers=cfg.num_layers,
                end_layer=cfg.num_layers - 1, merge_value=False,
                extra_kwargs={"svd_method": "exact"})


def port_llama(ckpt, mode, rope, factor=torch.float32, tail_max=16, **kw):
    np_params, cfg = ckpt
    xkv = None if mode == "none" else torch_xkv(**llama_kw(cfg, rope))
    return InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), cfg, xkv,
                           mode=mode, tail_max=tail_max, factor_dtype=factor, **F32, **kw)


def jax_llama(ckpt, mode, rope, factor=jnp.float32, tail_max=16, **kw):
    np_params, cfg = ckpt
    xkv = None if mode == "none" else jax_xkv(**llama_kw(cfg, rope))
    return JaxEngine(jax.tree.map(jnp.asarray, np_params), cfg, xkv, mode=mode,
                     tail_max=tail_max, cache_dtype=jnp.float32, factor_dtype=factor,
                     donate_cache=False, **kw)


def port_mla(moe, factor=torch.float32, tail_max=12):
    _, cfg, np_params = moe
    return InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), cfg,
                           torch_xkv(**mla_kw(cfg)), mode="factored", tail_max=tail_max,
                           factor_dtype=factor, **F32)


def eager_greedy(eng, prompt, n_new):
    """``generate``'s tokens from the eager step: prefill, then
    ``decode_step`` + argmax, refactorising a full tail."""
    logits, cache = eng.prefill(prompt)
    tok = logits[:, -1].argmax(-1)[:, None]
    out, pos = [tok], prompt.shape[1]
    for _ in range(n_new - 1):
        if cache.tail_count == cache.tail_max:
            cache = eng.refactorize(cache)
        logits, cache = eng.decode_step(cache, tok, pos)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
        pos += 1
    return torch.cat(out, dim=1)
