"""The port's engine against the JAX engine on other Llama-family configs.

Mistral's sliding window, mirroring
``tests/test_model_families.py:test_mistral_window_decode_matches_oracle``:
``tiny_llama_config(model_type="mistral", sliding_window=10)``, weights
from ``jax.random.PRNGKey(2)`` handed to both engines as numpy, a (2, 24)
prompt from ``np.random.default_rng(3)`` (the window's lower bound moves
through the prefix), full-rank factors of groups of 2 layers (lossless),
exact SVD, fp32 weights, cache and factors. The window reaches the port's
prefill attention (K1's plain version here) and every decode path. In fp32
the two frameworks differ only in the order of their sums, so the greedy
tokens must be equal.

Head size 64 (Llama-3.2-1B's) in ``pre`` mode, the factored decode that K3
serves on a card: ``tiny_llama_config(head_dim=64)``, the same weights
seed, prompt, full rank, exact SVD and fp32 setup; the greedy tokens must
be equal.

Post-mode paths: Qwen2's q/k/v biases (random, 0.2 scale; ``pre`` and
``post``, rank 16) and one-sided merges in ``post`` (K only with bf16 and
int8 factors, V only with int8 + int4 factors; full rank), with the same
weights seed and prompt; the greedy tokens must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xkv_tpu.configs import generate_consecutive_xkv_config as jax_xkv
from xkv_tpu.engine import InferenceEngine as JaxEngine
from xkv_tpu.models.config import tiny_llama_config as jax_tiny
from xkv_tpu.models.llama import init_params as jax_init
from xkv_tpu_torch.configs import generate_consecutive_xkv_config as torch_xkv
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import tiny_llama_config

N_NEW = 6


@pytest.fixture(scope="module")
def mistral():
    jcfg = jax_tiny(model_type="mistral", sliding_window=10)
    np_params = jax.tree.map(np.array, jax_init(jcfg, jax.random.PRNGKey(2),
                                                  dtype=jnp.float32))
    cfg = tiny_llama_config(model_type="mistral", sliding_window=10)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    return jcfg, cfg, np_params, prompt


@pytest.mark.parametrize("mode,rope", [("none", "pre"), ("factored", "pre"),
                                       ("factored", "post")])
def test_mistral_window_greedy_matches_jax(mistral, mode, rope):
    jcfg, cfg, np_params, prompt = mistral
    full_rank = 2 * cfg.num_kv_heads * cfg.head_dim
    kw = dict(num_layers=cfg.num_layers, end_layer=cfg.num_layers - 1, group_size=2,
              rank_k=full_rank, rank_v=full_rank,
              extra_kwargs={"svd_method": "exact", "rope_mode": rope})
    factored = mode == "factored"
    j = JaxEngine(jax.tree.map(jnp.asarray, np_params), jcfg,
                  jax_xkv(**kw) if factored else None, mode=mode, tail_max=N_NEW + 2,
                  cache_dtype=jnp.float32, factor_dtype=jnp.float32, donate_cache=False)
    want = np.asarray(j.generate(jnp.asarray(prompt), max_new_tokens=N_NEW))
    t = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), cfg,
                        torch_xkv(**kw) if factored else None, mode=mode,
                        tail_max=N_NEW + 2, cache_dtype=torch.float32,
                        factor_dtype=torch.float32, device="cpu")
    got = t.generate(prompt, N_NEW).numpy()
    assert got.shape == (2, N_NEW)
    np.testing.assert_array_equal(got, want)


def test_head_dim_64_factored_pre_greedy_matches_jax():
    jcfg = jax_tiny(head_dim=64)
    np_params = jax.tree.map(np.array, jax_init(jcfg, jax.random.PRNGKey(2),
                                                  dtype=jnp.float32))
    cfg = tiny_llama_config(head_dim=64)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    full_rank = 2 * cfg.num_kv_heads * cfg.head_dim
    kw = dict(num_layers=cfg.num_layers, end_layer=cfg.num_layers - 1, group_size=2,
              rank_k=full_rank, rank_v=full_rank,
              extra_kwargs={"svd_method": "exact", "rope_mode": "pre"})
    j = JaxEngine(jax.tree.map(jnp.asarray, np_params), jcfg, jax_xkv(**kw), mode="factored",
                  tail_max=N_NEW + 2, cache_dtype=jnp.float32, factor_dtype=jnp.float32,
                  donate_cache=False)
    want = np.asarray(j.generate(jnp.asarray(prompt), max_new_tokens=N_NEW))
    t = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), cfg, torch_xkv(**kw),
                        mode="factored", tail_max=N_NEW + 2, cache_dtype=torch.float32,
                        factor_dtype=torch.float32, device="cpu")
    got = t.generate(prompt, N_NEW).numpy()
    assert got.shape == (2, N_NEW)
    np.testing.assert_array_equal(got, want)


def _greedy_pair(jcfg, cfg, np_params, prompt, xkw, jax_fdt, torch_fdt):
    """Greedy tokens of the JAX and the port's engine, factored, fp32 cache."""
    j = JaxEngine(jax.tree.map(jnp.asarray, np_params), jcfg, jax_xkv(**xkw), mode="factored",
                  tail_max=N_NEW + 2, cache_dtype=jnp.float32, factor_dtype=jax_fdt,
                  donate_cache=False)
    want = np.asarray(j.generate(jnp.asarray(prompt), max_new_tokens=N_NEW))
    t = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), cfg,
                        torch_xkv(**xkw), mode="factored", tail_max=N_NEW + 2,
                        cache_dtype=torch.float32, factor_dtype=torch_fdt, device="cpu")
    return t.generate(prompt, N_NEW).numpy(), want


@pytest.mark.parametrize("rope", ["pre", "post"])
def test_qwen2_bias_greedy_matches_jax(rope):
    """Qwen2's q/k/v biases (mirror of tests/test_model_families.py::
    test_qwen2_bias_engine_runs, with random biases in place of its zeros):
    groups of 2 layers at rank 16, exact SVD, fp32."""
    jcfg = jax_tiny(attention_bias=True, model_type="qwen2")
    np_params = jax.tree.map(np.array, jax_init(jcfg, jax.random.PRNGKey(2),
                                                  dtype=jnp.float32))
    rng = np.random.default_rng(4)
    for layer in np_params["layers"]:
        for name in ("bq", "bk", "bv"):
            b = layer["attn"][name]
            layer["attn"][name] = (0.2 * rng.standard_normal(b.shape)).astype(np.float32)
    cfg = tiny_llama_config(attention_bias=True, model_type="qwen2")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 20)).astype(np.int32)
    xkw = dict(num_layers=cfg.num_layers, end_layer=cfg.num_layers - 1, group_size=2,
               rank_k=16, rank_v=16, extra_kwargs={"svd_method": "exact", "rope_mode": rope})
    got, want = _greedy_pair(jcfg, cfg, np_params, prompt, xkw, jnp.float32, torch.float32)
    assert got.shape == (2, N_NEW)
    np.testing.assert_array_equal(got, want)


# One-sided merges in post mode: K merged only (bf16 and int8 factors), V
# merged only (int8 + int4 factors). (merge_key, merge_value, JAX and port
# factor dtypes)
ONE_SIDED = [(True, False, jnp.bfloat16, torch.bfloat16), (True, False, "int8", "int8"),
             (False, True, "int4", "int4")]


@pytest.mark.parametrize("merge_key,merge_value,jax_fdt,torch_fdt", ONE_SIDED,
                         ids=["key-bf16", "key-int8", "value-int4"])
def test_one_sided_merge_post_greedy_matches_jax(merge_key, merge_value, jax_fdt, torch_fdt):
    jcfg = jax_tiny()
    np_params = jax.tree.map(np.array, jax_init(jcfg, jax.random.PRNGKey(2),
                                                  dtype=jnp.float32))
    cfg = tiny_llama_config()
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    full_rank = 2 * cfg.num_kv_heads * cfg.head_dim
    xkw = dict(num_layers=cfg.num_layers, end_layer=cfg.num_layers - 1, group_size=2,
               rank_k=full_rank, rank_v=full_rank, merge_key=merge_key,
               merge_value=merge_value,
               extra_kwargs={"svd_method": "exact", "rope_mode": "post"})
    got, want = _greedy_pair(jcfg, cfg, np_params, prompt, xkw, jax_fdt, torch_fdt)
    assert got.shape == (2, N_NEW)
    np.testing.assert_array_equal(got, want)
