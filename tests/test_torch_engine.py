"""The port's engine against the JAX engine on the in-repo checkpoint.

``results/production_model/`` (4 layers, 8 q/kv heads, head_dim 128) is
loaded once as numpy and handed to both engines (``params_from_numpy`` for
the port). Both run on the CPU with exact SVD.

Tolerances: in fp32 the greedy tokens must be equal and the first decode
step's logits agree to 1e-3 (the two frameworks sum in another order; the
logits are O(10)), 3e-2 with int8 factors. In bf16 (weights, cache and
factors) the first-step logits agree to 5% of the largest logit: each
framework rounds to bf16 at other points.

``python tests/test_torch_engine.py`` regenerates the golden file
``xkv_tpu_torch/testdata/production_model_golden.npz`` from the JAX engine:
the prompt, and for each run of ``GOLDEN_RUNS`` (rope_mode pre and post;
sparse top-2 of 64-row chunks in pre and post; int4 post) the greedy
tokens and the logits that chose them (prefill's last position, then one
row per decode step). ``chip_smoke.py`` holds the port on the card
against it.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from xkv_tpu.configs import generate_consecutive_xkv_config as jax_xkv
from xkv_tpu.engine import InferenceEngine as JaxEngine
from xkv_tpu.models.ckpt import load_checkpoint as jax_load
from xkv_tpu_torch.configs import generate_consecutive_xkv_config as torch_xkv
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.models.ckpt import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "results", "production_model")
GOLDEN = os.path.join(ROOT, "xkv_tpu_torch", "testdata", "production_model_golden.npz")
GOLDEN_SPEC = dict(group_size=4, rank_k=64, rank_v=96, prompt_len=256, steps=8)
# Golden runs: rope mode and engine options (fp32 weights and cache).
GOLDEN_RUNS = {
    "pre": ("pre", {}),
    "post": ("post", {}),
    "sparse_pre": ("pre", dict(sparse_topk=2, sparse_block=64)),
    "sparse_post": ("post", dict(sparse_topk=2, sparse_block=64)),
    "int4_post": ("post", dict(factor_dtype="int4")),
}


@pytest.fixture(scope="module")
def ckpt():
    np_params, cfg = jax_load(CKPT)
    return np_params, cfg


def prompt_tokens(n, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(1, n)).astype(np.int32)


def xkv_pair(rope, group_size=2, rank_k=48, rank_v=64):
    kw = dict(group_size=group_size, rank_k=rank_k, rank_v=rank_v, num_layers=4,
              end_layer=3, extra_kwargs={"svd_method": "exact", "rope_mode": rope})
    return jax_xkv(**kw), torch_xkv(**kw)


def engines(ckpt, mode, rope, dtype, factor, tail_max=16):
    np_params, cfg = ckpt
    jx, tx = xkv_pair(rope)
    jd = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    td = torch.float32 if dtype == "fp32" else torch.bfloat16
    jf = "int8" if factor == "int8" else jd
    tf = "int8" if factor == "int8" else td
    jp = jax.tree.map(lambda a: jnp.asarray(a, jd), np_params)
    j = JaxEngine(jp, cfg, jx if mode != "none" else None, mode=mode, tail_max=tail_max,
                  cache_dtype=jd, factor_dtype=jf)
    t = InferenceEngine(params_from_numpy(np_params, td, "cpu"), cfg, tx, mode=mode,
                        tail_max=tail_max, cache_dtype=td, factor_dtype=tf, device="cpu")
    return j, t


def first_step_logits(eng, prompt, is_jax):
    logits, cache = eng.prefill(prompt)
    if is_jax:
        tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        step, _ = eng.decode_step(cache, tok, jnp.asarray(prompt.shape[1], jnp.int32))
    else:
        tok = logits[:, -1, :].argmax(-1)[:, None]
        step, _ = eng.decode_step(cache, tok, prompt.shape[1])
    return np.asarray(step.astype(jnp.float32) if is_jax else step.float())


CASES = [("none", "pre", "fp32"), ("fake", "pre", "fp32"), ("fake", "post", "fp32"),
         ("factored", "pre", "fp32"), ("factored", "post", "fp32"),
         ("factored", "pre", "int8"), ("factored", "post", "int8")]


@pytest.mark.parametrize("mode,rope,factor", CASES)
def test_greedy_tokens_match_jax_fp32(ckpt, mode, rope, factor):
    """The port's ``generate`` against the JAX engine's greedy loop of
    prefill and decode steps (the steps of its ``generate``, compiled once
    instead of twice)."""
    j, t = engines(ckpt, mode, rope, "fp32", factor)
    prompt = prompt_tokens(40, ckpt[1].vocab_size)
    want, want_logits = golden_run(jax_step(j), j.prefill, prompt, 5)
    got = t.generate(prompt, 5).numpy()
    np.testing.assert_array_equal(got, want[None])
    # int8: a factor entry within fp32 noise of a rounding boundary
    # quantises to the neighbouring integer in one of the two frameworks.
    tol = 3e-2 if factor == "int8" else 1e-3
    np.testing.assert_allclose(first_step_logits(t, prompt, False)[0, -1], want_logits[1],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("mode,rope,factor", [("none", "pre", "bf16"),
                                              ("factored", "pre", "bf16"),
                                              ("factored", "post", "int8")])
def test_first_step_logits_match_jax_bf16(ckpt, mode, rope, factor):
    j, t = engines(ckpt, mode, rope, "bf16", factor)
    prompt = prompt_tokens(40, ckpt[1].vocab_size, seed=1)
    want = first_step_logits(j, prompt, True)
    got = first_step_logits(t, prompt, False)
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def test_factored_matches_fake(ckpt):
    """Factored and fake decode read the same factors, lazily vs
    materialised (mirror of test_engine.py:test_factored_matches_fake)."""
    np_params, cfg = ckpt
    _, tx = xkv_pair("pre", rank_k=16, rank_v=20)
    params = params_from_numpy(np_params, torch.float32, "cpu")
    kw = dict(tail_max=16, cache_dtype=torch.float32, factor_dtype=torch.float32,
              device="cpu")
    fake = InferenceEngine(params, cfg, tx, mode="fake", **kw)
    fact = InferenceEngine(params, cfg, tx, mode="factored", **kw)
    prompt = prompt_tokens(24, cfg.vocab_size, seed=2)
    lf, cf = fake.prefill(prompt)
    _, cr = fact.prefill(prompt)
    tok = lf[:, -1].argmax(-1)[:, None]
    pos = prompt.shape[1]
    for _ in range(4):
        lf, cf = fake.decode_step(cf, tok, pos)
        lr, cr = fact.decode_step(cr, tok, pos)
        np.testing.assert_allclose(lr.numpy(), lf.numpy(), rtol=2e-3, atol=2e-3)
        tok = lf[:, -1].argmax(-1)[:, None]
        pos += 1


def test_refactorize_extends_generation(ckpt):
    """A tail of 4 with refactorisation generates 10 tokens; a full-rank
    (lossless) factorisation must match the uncompressed baseline across
    the fold boundaries (mirror of the JAX test of the same name)."""
    np_params, cfg = ckpt
    full = 2 * cfg.num_kv_heads * cfg.head_dim
    _, tx = xkv_pair("pre", rank_k=full, rank_v=full)
    params = params_from_numpy(np_params, torch.float32, "cpu")
    kw = dict(cache_dtype=torch.float32, factor_dtype=torch.float32, device="cpu")
    prompt = prompt_tokens(24, cfg.vocab_size, seed=3)
    out_f = InferenceEngine(params, cfg, tx, mode="factored", tail_max=4, **kw).generate(
        prompt, 10)
    out_n = InferenceEngine(params, cfg, None, mode="none", tail_max=16, **kw).generate(
        prompt, 10)
    np.testing.assert_array_equal(out_f.numpy(), out_n.numpy())


def test_none_mode_ignores_merge_plan(ckpt):
    """Mode none with a merge plan set decodes the dense cache (the JAX
    engine raises IndexError here: ROADMAP queue 3)."""
    np_params, cfg = ckpt
    _, tx = xkv_pair("pre")
    params = params_from_numpy(np_params, torch.float32, "cpu")
    kw = dict(tail_max=8, cache_dtype=torch.float32, device="cpu")
    prompt = prompt_tokens(16, cfg.vocab_size, seed=4)
    with_plan = InferenceEngine(params, cfg, tx, mode="none", **kw).generate(prompt, 3)
    without = InferenceEngine(params, cfg, None, mode="none", **kw).generate(prompt, 3)
    np.testing.assert_array_equal(with_plan.numpy(), without.numpy())


def jax_step(eng):
    """The JAX engine's decode step on a Python token and position."""
    return lambda c, t, p: eng.decode_step(
        c, jnp.asarray([[t]], jnp.int32), jnp.asarray(p, jnp.int32))


def golden_run(run_step, prefill, prompt, steps):
    """Greedy tokens and the logits that chose them."""
    logits, cache = prefill(prompt)
    rows = [np.asarray(logits[0, -1], np.float32)]
    toks = [int(np.argmax(rows[-1]))]
    pos = prompt.shape[1]
    for i in range(steps - 1):
        step, cache = run_step(cache, toks[-1], pos + i)
        rows.append(np.asarray(step[0, -1], np.float32))
        toks.append(int(np.argmax(rows[-1])))
    return np.asarray(toks, np.int32), np.stack(rows)


def jax_golden(np_params, cfg, rope, prompt, **engine_kw):
    spec = GOLDEN_SPEC
    jx = jax_xkv(group_size=spec["group_size"], rank_k=spec["rank_k"],
                 rank_v=spec["rank_v"], num_layers=4, end_layer=3,
                 extra_kwargs={"svd_method": "exact", "rope_mode": rope})
    engine_kw.setdefault("factor_dtype", jnp.float32)
    eng = JaxEngine(jax.tree.map(jnp.asarray, np_params), cfg, jx, mode="factored",
                    tail_max=spec["steps"], cache_dtype=jnp.float32, **engine_kw)
    return golden_run(jax_step(eng), eng.prefill, prompt, spec["steps"])


def test_golden_reproduced_by_jax_and_port(ckpt):
    np_params, cfg = ckpt
    gold = np.load(GOLDEN)
    prompt = gold["prompt"]
    for rope in ("pre", "post"):
        toks, logits = jax_golden(np_params, cfg, rope, prompt)
        np.testing.assert_array_equal(toks, gold[f"tokens_{rope}"])
        np.testing.assert_allclose(logits, gold[f"logits_{rope}"], rtol=1e-4, atol=1e-4)
        _, tx = xkv_pair(rope, GOLDEN_SPEC["group_size"], GOLDEN_SPEC["rank_k"],
                         GOLDEN_SPEC["rank_v"])
        eng = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), cfg, tx,
                              mode="factored", tail_max=GOLDEN_SPEC["steps"],
                              cache_dtype=torch.float32, factor_dtype=torch.float32,
                              device="cpu")
        step = lambda c, t, p: eng.decode_step(c, [[t]], p)  # noqa: E731
        toks_t, logits_t = golden_run(step, eng.prefill, prompt, GOLDEN_SPEC["steps"])
        np.testing.assert_array_equal(toks_t, gold[f"tokens_{rope}"])
        np.testing.assert_allclose(logits_t, gold[f"logits_{rope}"], rtol=1e-3, atol=1e-3)


def write_golden():
    np_params, cfg = jax_load(CKPT)
    prompt = prompt_tokens(GOLDEN_SPEC["prompt_len"], cfg.vocab_size, seed=7)
    out = dict(prompt=prompt, **{k: np.int32(v) for k, v in GOLDEN_SPEC.items()})
    for run, (rope, kw) in GOLDEN_RUNS.items():
        out[f"tokens_{run}"], out[f"logits_{run}"] = jax_golden(np_params, cfg, rope, prompt,
                                                                **kw)
        print(f"{run}: tokens {out[f'tokens_{run}']}")
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.exit(write_golden())
