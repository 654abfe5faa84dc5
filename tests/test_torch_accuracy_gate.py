"""The JAX package's two offline accuracy gates on the port's CPU engine.

``tests/test_accuracy_gate.py`` and ``tests/test_rope_post_accuracy.py``
train a tiny induction model (sequences ``[bos, x_1..x_m, x_1..x_m]``: the
second copy is recalled by attending back to the first, pure KV-cache
retrieval, what RULER's niah measures) and measure what compression costs
in recall. Here the model is trained by the port's ``train_lm`` (plain
prefill attention, differentiable) from the JAX package's init and data,
and served by the port's ``InferenceEngine`` on the CPU in fp32, and each
of the files' seven tests holds its gates with its thresholds. The
equalities (lossless factorisation, full-coverage sparse) are exact in
fp32. Recalls are computed once per configuration and shared.

Marked ``slow``, as the JAX gate files are: training the model takes ~64 s
on one torch thread, so the file takes ~70 s on one worker, past the ~60 s
a tier-1 file may take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from xkv_tpu.models.config import tiny_llama_config as jax_tiny
from xkv_tpu.models.llama import init_params as jax_init
from xkv_tpu_torch.configs import generate_consecutive_xkv_config
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import tiny_llama_config
from xkv_tpu_torch.train.lm import train_lm

pytestmark = pytest.mark.slow

M = 24  # repeated-segment length
SHAPE = dict(vocab_size=64, hidden_size=96, intermediate_size=192, num_layers=3,
             num_q_heads=4, num_kv_heads=2, head_dim=24)
CFG = tiny_llama_config(**SHAPE)
FULL_RANK = 2 * CFG.num_kv_heads * CFG.head_dim  # group of 2 -> lossless


def make_batch(rng: np.random.Generator, batch: int):
    x = rng.integers(2, CFG.vocab_size, size=(batch, M)).astype(np.int32)
    tokens = np.concatenate([np.ones((batch, 1), np.int32), x, x], axis=1)
    mask = np.zeros_like(tokens, np.float32)
    mask[:, M + 1:] = 1.0  # score the entire second copy
    return tokens, mask


@pytest.fixture(scope="module")
def trained_params():
    rng = np.random.default_rng(0)
    jp = jax_init(jax_tiny(**SHAPE), jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_numpy(jax.tree_util.tree_map(np.array, jp), device="cpu")
    params, history = train_lm(params, CFG, lambda i: make_batch(rng, 64), steps=300, lr=2e-3,
                               log_every=100)
    assert history[-1] < 0.05, f"induction task did not train: {history}"
    return params


def xkv_with_rank(rank, rope="pre", end_layer=-1):
    return generate_consecutive_xkv_config(
        num_layers=CFG.num_layers, end_layer=end_layer, group_size=2, rank_k=rank,
        rank_v=rank, extra_kwargs={"svd_method": "exact", "rope_mode": rope})


_RECALLS = {}


def recall(params, mode, rank=None, rope="pre", end_layer=-1, n=32, seed=123, keep=4, **kw):
    """Prompt = bos + x + x[:keep]; greedy-generate the remaining M - keep
    tokens and score exact match per token (cached per configuration)."""
    key = (mode, rank, rope, end_layer, tuple(sorted(kw.items())))
    if key not in _RECALLS:
        kw.setdefault("factor_dtype", torch.float32)
        xkv = None if rank is None else xkv_with_rank(rank, rope, end_layer)
        eng = InferenceEngine(params, CFG, xkv=xkv, mode=mode, tail_max=M,
                              cache_dtype=torch.float32, device="cpu", **kw)
        rng = np.random.default_rng(seed)
        x = rng.integers(2, CFG.vocab_size, size=(n, M)).astype(np.int32)
        prompts = np.concatenate([np.ones((n, 1), np.int32), x, x[:, :keep]], axis=1)
        out = eng.generate(prompts, max_new_tokens=M - keep).numpy()
        _RECALLS[key] = float((out == x[:, keep:]).mean())
    return _RECALLS[key]


# ------------------------------------------------ tests/test_accuracy_gate.py
def test_compression_accuracy_gate(trained_params):
    acc_base = recall(trained_params, "none")
    assert acc_base > 0.95, f"base model failed induction: {acc_base}"
    acc_full = recall(trained_params, "factored", FULL_RANK)
    assert acc_full == acc_base, "lossless factorization changed accuracy"
    acc_half = recall(trained_params, "factored", FULL_RANK // 2)
    assert acc_half >= acc_base - 0.10, f"2x compression lost too much: {acc_base} -> {acc_half}"
    acc_tiny = recall(trained_params, "factored", 2)
    assert acc_tiny < acc_base - 0.2, "rank-2 compression should degrade recall"


def test_int8_factors_accuracy(trained_params):
    acc_base = recall(trained_params, "none")
    acc_q = recall(trained_params, "factored", FULL_RANK // 2, factor_dtype="int8")
    assert acc_q >= acc_base - 0.12, f"int8 factors lost accuracy: {acc_q}"


def test_sparse_topk_accuracy(trained_params):
    """Full chunk coverage is exact; dropping a quarter of the chunks keeps
    recall close (prompt 29 rows -> 4 chunks of 8)."""
    acc_full = recall(trained_params, "factored", FULL_RANK)
    acc_all = recall(trained_params, "factored", FULL_RANK, sparse_topk=4, sparse_block=8)
    assert acc_all == acc_full, "full-coverage sparse changed accuracy"
    acc_3of4 = recall(trained_params, "factored", FULL_RANK, sparse_topk=3, sparse_block=8)
    assert acc_3of4 >= acc_full - 0.10, f"sparse 3/4 lost too much: {acc_full} -> {acc_3of4}"


def test_fake_mode_matches_factored_accuracy(trained_params):
    acc_fake = recall(trained_params, "fake", FULL_RANK // 2)
    acc_fact = recall(trained_params, "factored", FULL_RANK // 2)
    assert abs(acc_fake - acc_fact) <= 0.05


# ------------------------------------------------ tests/test_rope_post_accuracy.py
LAST = CFG.num_layers - 1


def test_post_parity_at_operating_compression(trained_params):
    """~12x compression (rank 8 of 96): post matches pre within noise."""
    a_pre = recall(trained_params, "factored", 8, "pre", LAST)
    a_post = recall(trained_params, "factored", 8, "post", LAST)
    assert a_post >= 0.9, f"post recall collapsed: {a_post}"
    assert a_post >= a_pre - 0.05, f"post {a_post} vs pre {a_pre}"


def test_post_degrades_faster_past_operating_point(trained_params):
    """24x compression (rank 4): both degrade, post no better than pre."""
    a_pre = recall(trained_params, "factored", 4, "pre", LAST)
    a_post = recall(trained_params, "factored", 4, "post", LAST)
    assert a_pre < 0.9 and a_post < 0.9
    assert a_post <= a_pre + 0.05


def test_int4_mixed_accuracy_neutral_at_operating_point(trained_params):
    """Mixed int8+int4 factors at rank 8, post: within 0.05 of fp32 factors."""
    a_f32 = recall(trained_params, "factored", 8, "post", LAST)
    a_i4 = recall(trained_params, "factored", 8, "post", LAST, factor_dtype="int4")
    assert a_i4 >= a_f32 - 0.05, f"int4 {a_i4} vs f32 {a_f32}"
