"""The port's compiled decode (``engine/graphs.py``) against its eager step
and the JAX engine's compiled entry points, on the CPU.

The decode state lives on the device: ``tail_len`` is a 0-d int32 tensor,
and ``decode_step`` takes its position as an int or a 0-d tensor. On the
CPU ``generate`` and ``score`` run ``DecodeGraph``'s step eagerly: the same
buffers and bookkeeping a CUDA graph replays on the card, without the
capture (``tests/test_torch_compiled_gpu.py`` holds that on the card).

Models: the in-repo checkpoint ``results/production_model/`` (4 layers,
head_dim 128, fp32), ``tiny_llama_config(model_type="mistral",
sliding_window=10)`` and the tiny MLA + MoE config of
``tests/test_torch_deepseek.py`` (4 experts, top-2), weights and prompts
from numpy seeds, exact SVD.

Tolerances: a tensor position gives the int position's logits bit for bit
(the same ops on the same values); the step runner gives the eager loop's
tokens exactly. ``score`` against the JAX engine's: fp32 log-probs within
1e-3, 3e-2 with int8 factors (the tolerances of
``test_torch_engine.py::test_greedy_tokens_match_jax_fp32``: the two
frameworks sum in another order, and an int8 factor entry near a rounding
boundary quantises to the neighbouring integer); against the full-forward
oracle 2e-4 (``tests/test_engine.py``'s). The dense MoE dispatch against
the sorted one 1e-5 (fp32 sums in another order).
"""

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
from xkv_tpu_torch.engine.graphs import DecodeGraph
from xkv_tpu_torch.models import deepseek
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import ModelConfig, tiny_llama_config
from xkv_tpu_torch.ops.kernels import _build

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


# ------------------------------------------------------- tensor positions
def _step_pairs(eng, prompt, steps):
    """Greedy decode from ``prompt``; each step run twice on the same cache,
    with the position as an int and as a 0-d tensor."""
    logits, cache = eng.prefill(prompt)
    tok = logits[:, -1].argmax(-1)[:, None]
    pos = prompt.shape[1]
    for _ in range(steps):
        by_int, _ = eng.decode_step(cache, tok, pos)
        by_tensor, cache = eng.decode_step(cache, tok, torch.tensor(pos))
        yield by_int, by_tensor
        tok = by_tensor[:, -1].argmax(-1)[:, None]
        pos += 1


@pytest.mark.parametrize("case", ["none", "factored pre", "factored post",
                                  "post sparse max", "mla", "mistral window"])
def test_tensor_pos_gives_int_pos_logits(case, ckpt, moe, mistral):
    if case == "mla":
        eng, prompt = port_mla(moe), tokens(24, 128, seed=8)
    elif case == "mistral window":
        # A 6-token prompt: the window's lower bound is clamped at 0, then
        # moves through the prefix, then into the tail (pos 16 on).
        _, cfg, np_params = mistral
        eng = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), cfg,
                              torch_xkv(**llama_kw(cfg, "post", 64, 64)), mode="factored",
                              tail_max=14, factor_dtype=torch.float32, **F32)
        prompt = tokens(6, cfg.vocab_size, seed=3, b=2)
    elif case == "post sparse max":
        eng = port_llama(ckpt, "factored", "post", sparse_topk=2, sparse_block=64,
                         sparse_topk_max=3)
        prompt = tokens(256, ckpt[1].vocab_size, seed=5)
    else:
        mode, rope = ("none", "pre") if case == "none" else case.split()
        eng = port_llama(ckpt, mode, rope)
        prompt = tokens(40, ckpt[1].vocab_size, seed=5)
    n = 0
    for by_int, by_tensor in _step_pairs(eng, prompt, 12 if case == "mistral window" else 3):
        assert torch.equal(by_int, by_tensor)
        n += 1
    assert n > 0


# ------------------------------------------------------- tail on the device
def test_tail_len_lives_on_the_device(ckpt):
    eng = port_llama(ckpt, "factored", "pre", tail_max=4)
    prompt = tokens(24, ckpt[1].vocab_size, seed=6)

    def held(cache, n):
        t = cache.tail_len
        assert isinstance(t, torch.Tensor) and t.dim() == 0 and t.dtype == torch.int32
        assert t.device == cache.tail_k.device and int(t) == n == cache.tail_count

    logits, cache = eng.prefill(prompt)
    held(cache, 0)
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(4):
        _, cache = eng.decode_step(cache, tok, 24 + i)
        held(cache, i + 1)
    # A full tail: the next step is refused before any row is written.
    before = cache.tail_k.clone(), cache.tail_v.clone()
    with pytest.raises(ValueError, match="tail overflow: 4 \\+ 1 > 4"):
        eng.decode_step(cache, tok, 28)
    with pytest.raises(ValueError, match="tail overflow: 4 \\+ 2 > 4"):
        eng.score(cache, torch.zeros((1, 2), dtype=torch.long), 28)
    assert torch.equal(cache.tail_k, before[0]) and torch.equal(cache.tail_v, before[1])
    cache = eng.refactorize(cache)
    held(cache, 0)
    assert cache.prefill_len == 28
    # refactorize reads the host count: a tail that is not full is refused.
    _, part = eng.decode_step(cache, tok, 28)
    with pytest.raises(ValueError, match="tail holds 1 of 4 rows"):
        eng.refactorize(part)


# ---------------------------------------------------------- step runner
@pytest.mark.parametrize("case", ["pre", "post", "sparse post", "mla"])
def test_step_runner_matches_eager_loop_across_refactorize(case, ckpt, moe):
    """``generate`` (``DecodeGraph``'s step, eager on the CPU) gives the
    eager loop's tokens over a tail of 4 and 10 tokens: two folds."""
    if case == "mla":
        eng, prompt = port_mla(moe, tail_max=4), tokens(24, 128, seed=9)
    else:
        sparse = dict(sparse_topk=2, sparse_block=16) if case == "sparse post" else {}
        eng = port_llama(ckpt, "factored", case.split()[-1], tail_max=4, **sparse)
        prompt = tokens(64, ckpt[1].vocab_size, seed=10)
    _build.reset_counts()
    got = eng.generate(prompt, 10)
    want = eager_greedy(eng, prompt, 10)
    assert got.shape == (1, 10)
    assert torch.equal(got, want)
    # Segments of 4, 4 and 1 steps; on the CPU nothing is captured and no
    # kernel launches.
    assert [t.steps for t in eng.last_timings] == [4, 4, 1]
    assert all(t.capture_ms is None and t.start is None for t in eng.last_timings)
    assert set(_build.read_counts().values()) == {0}


def test_capture_counts_move_launches_to_replays():
    """A capture's counts are taken back out of the counters and added once
    per replay, as ``DecodeGraph`` does around ``torch.cuda.graph``."""
    from xkv_tpu_torch.ops.kernels import lowrank_attention, rankspace_attention

    _build.reset_counts()
    lowrank_attention.launches += 2  # eager launches before the capture
    with _build.capture_counts() as delta:
        lowrank_attention.launches += 4
        rankspace_attention.sparse_launches += 4
    counts = _build.read_counts()
    assert counts["K3"] == 2 and counts["K4"] == 0
    assert {k: n for k, n in delta.items() if n} == {"K3": 4, "K4": 4}
    _build.add_counts(delta, 3)
    counts = _build.read_counts()
    assert counts["K3"] == 14 and counts["K4"] == 12
    assert sum(counts.values()) == 26
    _build.reset_counts()
    assert set(_build.read_counts().values()) == {0}


def test_decode_graph_refuses_two_sources(ckpt):
    eng = port_llama(ckpt, "none", "pre", tail_max=4)
    _, cache = eng.prefill(tokens(8, ckpt[1].vocab_size))
    tok = torch.zeros((1, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="exactly one"):
        DecodeGraph(eng, cache, 8, 2, first_token=tok, teacher=tok)
    with pytest.raises(ValueError, match="exactly one"):
        DecodeGraph(eng, cache, 8, 2)


# ---------------------------------------------------------------- score
@pytest.mark.parametrize("mode,rope,factor", [("none", "pre", "fp32"),
                                              ("factored", "pre", "fp32"),
                                              ("factored", "post", "fp32"),
                                              ("factored", "post", "int8")])
def test_score_matches_jax(ckpt, mode, rope, factor):
    """Teacher-forced log-probs of 6 steps, b = 2, against JAX
    ``InferenceEngine.score``; then the cache's tail holds the 6 rows and a
    second call scores on from there."""
    j = jax_llama(ckpt, mode, rope, "int8" if factor == "int8" else jnp.float32)
    t = port_llama(ckpt, mode, rope, "int8" if factor == "int8" else torch.float32)
    prompt = tokens(40, ckpt[1].vocab_size, seed=11, b=2)
    cont = tokens(9, ckpt[1].vocab_size, seed=12, b=2)
    _, jc = j.prefill(prompt)
    _, tc = t.prefill(prompt)
    want, jc = j.score(jc, jnp.asarray(cont[:, :6]), jnp.asarray(40, jnp.int32))
    got, tc = t.score(tc, cont[:, :6], 40)
    tol = 3e-2 if factor == "int8" else 1e-3
    assert got.shape == (2, 6, ckpt[1].vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    assert int(tc.tail_len) == tc.tail_count == 6 == int(jc.tail_len)
    want2, _ = j.score(jc, jnp.asarray(cont[:, 6:]), jnp.asarray(46, jnp.int32))
    got2, tc = t.score(tc, cont[:, 6:], torch.tensor(46))
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=tol, atol=tol)
    assert tc.tail_count == 9


def test_score_matches_full_forward_oracle(ckpt):
    """Scoring in mode none equals the log-softmax of one prefill over the
    whole sequence (``tests/test_engine.py``'s oracle, for the port)."""
    eng = port_llama(ckpt, "none", "pre")
    seq = tokens(24, ckpt[1].vocab_size, seed=13, b=2)
    _, cache = eng.prefill(seq[:, :16])
    got, _ = eng.score(cache, seq[:, 16:], 16)
    full, _ = eng.prefill(seq)
    want = torch.log_softmax(full[:, 16:], dim=-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


# ----------------------------------------------------------- eos_token_id
@pytest.mark.parametrize("eos_at", [3, None])
def test_generate_eos_matches_jax(ckpt, eos_at):
    """``generate(eos_token_id=...)`` rows against the JAX engine's, with
    the EOS taken from the first row's greedy token at step 3, and with an
    id that no row generates."""
    j = jax_llama(ckpt, "factored", "pre")
    t = port_llama(ckpt, "factored", "pre")
    prompt = tokens(32, ckpt[1].vocab_size, seed=14, b=2)
    full = np.asarray(j.generate(jnp.asarray(prompt), 8))
    eos = int(full[0, eos_at]) if eos_at is not None else next(
        v for v in range(ckpt[1].vocab_size) if v not in full)
    want = j.generate(jnp.asarray(prompt), 8, eos_token_id=eos)
    got = t.generate(prompt, 8, eos_token_id=eos)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if eos_at is None:
        assert all(len(g) == 8 for g in got)
    else:
        assert len(got[0]) <= eos_at + 1 and int(got[0][-1]) == eos


# -------------------------------------------------------- MoE at decode
def test_dense_moe_dispatch_equals_sorted(moe):
    """Decode with more (token, expert) pairs than experts takes the dense
    one-hot dispatch; it computes the sorted dispatch's function."""
    _, cfg, np_params = moe
    params = params_from_numpy(np_params, torch.float32, "cpu")
    layer = params["layers"][1]["mlp"]
    assert "router" in layer
    x = torch.as_tensor(np.random.default_rng(15).standard_normal((3, 1, 64)),
                        dtype=torch.float32)
    assert 3 * cfg.num_experts_per_tok > cfg.n_routed_experts
    dense = deepseek._moe(layer, cfg, x, decode=True)
    sorted_ = deepseek._moe(layer, cfg, x)
    np.testing.assert_allclose(dense.numpy(), sorted_.numpy(), rtol=1e-5, atol=1e-5)


def test_dense_moe_decode_greedy_matches_jax(moe):
    """b = 3 at one token a step: 6 pairs over 4 experts, the dense
    dispatch in every MoE layer; greedy tokens equal the JAX engine's."""
    jcfg, cfg, np_params = moe
    je = JaxEngine(jax.tree.map(jnp.asarray, np_params), jcfg, jax_xkv(**mla_kw(cfg)),
                   mode="factored", tail_max=8, attention_impl="pallas",
                   cache_dtype=jnp.float32, factor_dtype=jnp.float32, donate_cache=False)
    te = port_mla(moe, tail_max=8)
    prompt = tokens(24, 128, seed=16, b=3)
    want = np.asarray(je.generate(jnp.asarray(prompt), 5))
    np.testing.assert_array_equal(te.generate(prompt, 5).numpy(), want)
