"""MiniCache SLERP serving in the port against the JAX package, on the CPU.

``layer_merge_impl="slerp"`` (groups of 2, gamma 0.05), in ``fake`` mode,
``factored`` with dense storage, and ``factored`` compact
(``slerp_compact``) at keep fractions 0.125 and 0.5, each with
refactorisations (tail 4); ``BatchedEngine`` with compact and dense slots
(2 slots, three prompt buckets, monolithic and chunked admission, slot
refolds, a reused slot, and a dense slot that finishes at tail capacity as
the JAX engine's does). Greedy tokens must equal the JAX engine's (fp32
weights and cache, weights carried across from numpy). Also: a JAX
compact cache carried across by ``cache_from_numpy`` decodes as the JAX
engine does; MLA with dense SLERP storage against the JAX engine; the
one refusal (MLA with ``slerp_compact``) beside the JAX engine's
``KeyError`` there (ROADMAP queue 3).

``python tests/test_torch_slerp_engine.py`` regenerates
``xkv_tpu_torch/testdata/minicache_golden.npz`` from the JAX engine: the
in-repo checkpoint's 4 layers in SLERP pairs (0, 1) and (2, 3), gamma
0.05, compact at keep 0.125, the prompt of ``production_model_golden.npz``,
and for dense and compact storage the greedy tokens and the logits that
chose them (prefill's last position, then one row per decode step; fp32).
``chip_smoke.py`` holds the port on the card against it.

Models: ``tiny_llama_config`` with JAX's init scaled by 5 (as
``tests/test_torch_batching.py``), the dense MLA config of
``tests/test_torch_deepseek.py``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_deepseek import CFG as MLA_CFG
from xkv_tpu.configs import generate_consecutive_xkv_config as jax_xkv
from xkv_tpu.engine import InferenceEngine as JaxEngine
from xkv_tpu.engine.batching import BatchedEngine as JaxBatched
from xkv_tpu.models import llama as jllama
from xkv_tpu.models.ckpt import load_checkpoint as jax_load
from xkv_tpu.models.config import ModelConfig as JaxModelConfig
from xkv_tpu.models.config import tiny_llama_config as jax_tiny
from xkv_tpu_torch.cache import cache_from_numpy
from xkv_tpu_torch.configs import generate_consecutive_xkv_config as torch_xkv
from xkv_tpu_torch.engine import BatchedEngine, InferenceEngine
from xkv_tpu_torch.models import deepseek
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import ModelConfig, tiny_llama_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "results", "production_model")
GOLDEN = os.path.join(ROOT, "xkv_tpu_torch", "testdata", "minicache_golden.npz")
PROD_GOLDEN = os.path.join(ROOT, "xkv_tpu_torch", "testdata", "production_model_golden.npz")
GOLDEN_SPEC = dict(group_size=2, gamma=0.05, keep_frac=0.125, steps=8)
GOLDEN_RUNS = ("dense", "compact")

# (xKV options, mode, tail_max, new tokens): every case folds its tail at
# least once (mode factored) or runs past one tail (fake: no fold, a long
# tail).
SINGLE = {
    "fake": (dict(compact=True), "fake", 12, 10),
    "factored dense": (dict(compact=False), "factored", 4, 10),
    "factored compact 0.125": (dict(compact=True, keep=0.125), "factored", 4, 10),
    "factored compact 0.5": (dict(compact=True, keep=0.5), "factored", 4, 10),
    "factored compact, keys only": (dict(compact=True, keep=0.25, merge_value=False),
                                    "factored", 4, 6),
}
ENGINE = dict(num_slots=2, s_max=32, tail_max=4, prefill_buckets=[8, 16, 24])
# (xKV options, prefill_chunk, prompt lengths, new tokens). The third
# request reuses the first's slot; compact slots fold their tails, dense
# ones finish at tail capacity (1 + tail_max tokens).
BATCHED = {
    "compact slots": (dict(compact=True, keep=0.125), None, (12, 19, 7), 10),
    "compact slots, chunked": (dict(compact=True, keep=0.5), 8, (12, 19, 7), 10),
    "dense slots": (dict(compact=False), None, (12, 19, 7), 10),
}


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(lambda a: np.array(a) * (1 if a.ndim == 1 else 5),
                        jllama.init_params(jax_tiny(), jax.random.PRNGKey(0), dtype=jnp.float32))


def slerp_kw(num_layers, compact=False, keep=0.125, merge_value=True, gamma=0.05,
             group_size=2):
    return dict(layer_merge_impl="slerp", num_layers=num_layers, end_layer=num_layers - 1,
                group_size=group_size, slerp_t=0.5, slerp_gamma=gamma, rank_k=None,
                rank_v=None, merge_value=merge_value,
                extra_kwargs={"slerp_compact": compact, "slerp_keep_frac": keep})


def prompt(n, vocab=256, seed=0, batch=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(batch, n)).astype(np.int32)


def engines(np_params, jcfg, tcfg, opts, mode, tail_max):
    kw = slerp_kw(tcfg.num_layers, **opts)
    j = JaxEngine(jax.tree.map(jnp.asarray, np_params), jcfg, jax_xkv(**kw), mode=mode,
                  tail_max=tail_max, cache_dtype=jnp.float32, factor_dtype=jnp.float32,
                  donate_cache=False)
    t = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), tcfg,
                        torch_xkv(**kw), mode=mode, tail_max=tail_max,
                        cache_dtype=torch.float32, factor_dtype=torch.float32, device="cpu")
    return j, t


@pytest.mark.parametrize("case", list(SINGLE))
def test_generate_matches_jax(params, case):
    """Greedy tokens of ``generate`` (batch 2, 20-token prompts) equal the
    JAX engine's, across the refactorisations of a tail of 4."""
    opts, mode, tail_max, n_new = SINGLE[case]
    j, t = engines(params, jax_tiny(), tiny_llama_config(), opts, mode, tail_max)
    p = prompt(20, batch=2)
    want = np.asarray(j.generate(p, n_new))
    got = t.generate(p, n_new).numpy()
    np.testing.assert_array_equal(got, want)


def test_compact_storage_counts_and_matches_fake(params):
    """The compact cache holds fewer bytes than the dense one, counts its
    leaves in ``num_cache_bytes``, and at a budget that covers every row
    the merge kept (keep 0.5) decodes the tokens of the fake (dense) path
    (the JAX test of the same semantics, ``test_slerp_compact.py``)."""
    _, dense = engines(params, jax_tiny(), tiny_llama_config(), dict(compact=False),
                       "factored", 8)
    _, compact = engines(params, jax_tiny(), tiny_llama_config(),
                         dict(compact=True, keep=0.125), "factored", 8)
    p = prompt(64, seed=4)
    _, cd = dense.prefill(p)
    _, cc = compact.prefill(p)
    cfg = tiny_llama_config()
    assert cd.compression_ratio(cfg) == pytest.approx(1.0)
    sc = cc.groups[0].slerp_k
    assert cc.prefill_len == 64 and sc.keep_idx.shape[-1] == 8
    assert cc.num_cache_bytes() < cd.num_cache_bytes()
    leaves = sum(x.numel() * x.element_size() for g in cc.groups
                 for x in (g.slerp_k.base, g.slerp_k.norms, g.slerp_k.keep_idx,
                           g.slerp_k.keep_rows, g.slerp_v.base, g.slerp_v.norms,
                           g.slerp_v.keep_idx, g.slerp_v.keep_rows))
    assert cc.num_cache_bytes() == leaves
    _, fake = engines(params, jax_tiny(), cfg, dict(compact=True), "fake", 8)
    _, half = engines(params, jax_tiny(), cfg, dict(compact=True, keep=0.5), "factored", 8)
    p = prompt(24, batch=2, seed=3)
    np.testing.assert_array_equal(half.generate(p, 6).numpy(), fake.generate(p, 6).numpy())


def test_cache_from_numpy_compact(params):
    """A JAX compact cache carried across: every leaf bit for bit, and the
    port's decode step over it gives the JAX step's logits (1e-5)."""
    j, t = engines(params, jax_tiny(), tiny_llama_config(), dict(compact=True, keep=0.25),
                   "factored", 8)
    p = prompt(20, seed=5)
    jl, jc = j.prefill(p)
    tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    cache = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    for gj, gt in zip(jc.groups, cache.groups):
        for side in ("slerp_k", "slerp_v"):
            for name in ("base", "norms", "keep_idx", "keep_rows"):
                np.testing.assert_array_equal(getattr(getattr(gt, side), name).numpy(),
                                              np.asarray(getattr(getattr(gj, side), name)))
    want, _ = j.decode_step(jc, tok, jnp.asarray(20, jnp.int32))
    got, _ = t.decode_step(cache, torch.from_numpy(np.asarray(tok)).long(), 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def serve(engine, prompts, n_new):
    ids = [engine.submit(p, n_new) for p in prompts]
    by_id = {r.request_id: r.generated for r in engine.run()}
    return [by_id[i] for i in ids]


@pytest.mark.parametrize("case", list(BATCHED))
def test_batched_tokens_match_jax(params, case):
    """``BatchedEngine`` over SLERP slots: every request's greedy tokens
    equal the JAX engine's. Compact slots fold (the port's refolds are
    counted); dense slots end each request at 1 + tail_max tokens."""
    opts, chunk, lengths, n_new = BATCHED[case]
    kw = slerp_kw(4, **opts)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=(n,)).astype(np.int32) for n in lengths]
    je = JaxBatched(jax.tree.map(jnp.asarray, params), jax_tiny(), jax_xkv(**kw),
                    cache_dtype=jnp.float32, factor_dtype=jnp.float32, prefill_chunk=chunk,
                    **ENGINE)
    want = serve(je, prompts, n_new)
    te = BatchedEngine(params_from_numpy(params, torch.float32, "cpu"), tiny_llama_config(),
                       torch_xkv(**kw), cache_dtype=torch.float32, factor_dtype=torch.float32,
                       prefill_chunk=chunk, device="cpu", **ENGINE)
    folds = []
    refactor = te._refactor
    te._refactor = lambda slot, plen: (folds.append(slot), refactor(slot, plen))
    got = serve(te, prompts, n_new)
    assert got == want
    if opts["compact"]:
        assert len(folds) >= 3 and [len(g) for g in got] == [n_new] * 3
    else:
        assert not folds and [len(g) for g in got] == [1 + ENGINE["tail_max"]] * 3


def mla_params():
    return deepseek.numpy_params(ModelConfig(**MLA_CFG), 0)


def test_mla_dense_slerp_matches_jax():
    """DeepSeek-V2 MLA with dense SLERP storage (latents merged in pairs):
    greedy tokens equal the JAX engine's across a refactorisation."""
    j, t = engines(mla_params(), JaxModelConfig(**MLA_CFG), ModelConfig(**MLA_CFG),
                   dict(compact=False, merge_value=False), "factored", 4)
    p = prompt(24, vocab=MLA_CFG["vocab_size"], seed=6)
    np.testing.assert_array_equal(t.generate(p, 8).numpy(), np.asarray(j.generate(p, 8)))


def test_mla_compact_refused_where_jax_raises_key_error():
    """MLA with ``slerp_compact``: the JAX engine builds the compact cache
    and fails at its first decode step (its MLA decode reads ``dense_k``
    of every group without factors: ``KeyError``, ROADMAP queue 3); the
    port refuses the configuration at construction, in both engines."""
    kw = slerp_kw(4, compact=True, keep=0.25, merge_value=False)
    j = JaxEngine(jax.tree.map(jnp.asarray, mla_params()), JaxModelConfig(**MLA_CFG),
                  jax_xkv(**kw), tail_max=8, cache_dtype=jnp.float32,
                  factor_dtype=jnp.float32, donate_cache=False)
    with pytest.raises(KeyError):
        j.generate(prompt(24, vocab=MLA_CFG["vocab_size"], seed=6), 4)
    with pytest.raises(ValueError, match="slerp_compact"):
        InferenceEngine({}, ModelConfig(**MLA_CFG), torch_xkv(**kw), device="cpu")
    with pytest.raises(ValueError, match="slerp_compact"):
        BatchedEngine({}, ModelConfig(**MLA_CFG), torch_xkv(**kw), s_max=16)
    # Fake and none modes store no compact groups: served.
    InferenceEngine({}, ModelConfig(**MLA_CFG), torch_xkv(**kw), mode="fake", device="cpu")


# ---------------------------------------------------------------- golden
def golden_xkv(pkg, compact):
    spec = GOLDEN_SPEC
    return pkg(**slerp_kw(4, compact=compact, keep=spec["keep_frac"], gamma=spec["gamma"],
                          group_size=spec["group_size"]))


def golden_run(step, prefill, p, steps):
    """Greedy tokens and the logits that chose them."""
    logits, cache = prefill(p)
    rows = [np.asarray(logits[0, -1], np.float32)]
    toks = [int(np.argmax(rows[-1]))]
    for i in range(steps - 1):
        out, cache = step(cache, toks[-1], p.shape[1] + i)
        rows.append(np.asarray(out[0, -1], np.float32))
        toks.append(int(np.argmax(rows[-1])))
    return np.asarray(toks, np.int32), np.stack(rows)


def jax_golden(np_params, cfg, p, compact):
    eng = JaxEngine(jax.tree.map(jnp.asarray, np_params), cfg, golden_xkv(jax_xkv, compact),
                    tail_max=GOLDEN_SPEC["steps"], cache_dtype=jnp.float32,
                    factor_dtype=jnp.float32, donate_cache=False)
    step = lambda c, t, pos: eng.decode_step(  # noqa: E731
        c, jnp.asarray([[t]], jnp.int32), jnp.asarray(pos, jnp.int32))
    return golden_run(step, eng.prefill, p, GOLDEN_SPEC["steps"])


def test_golden_reproduced_by_jax_and_port():
    """The golden file is what the JAX engine computes now (tokens equal,
    logits 1e-4), and the port in fp32 reproduces it (tokens equal, logits
    1e-3, ``tests/test_torch_engine.py``'s limit) in dense and compact
    storage."""
    np_params, cfg = jax_load(CKPT)
    gold = np.load(GOLDEN)
    p = gold["prompt"]
    params = params_from_numpy(np_params, torch.float32, "cpu")
    for run in GOLDEN_RUNS:
        compact = run == "compact"
        toks, logits = jax_golden(np_params, cfg, p, compact)
        np.testing.assert_array_equal(toks, gold[f"tokens_{run}"])
        np.testing.assert_allclose(logits, gold[f"logits_{run}"], rtol=1e-4, atol=1e-4)
        eng = InferenceEngine(params, cfg, golden_xkv(torch_xkv, compact),
                              tail_max=GOLDEN_SPEC["steps"], cache_dtype=torch.float32,
                              device="cpu")
        step = lambda c, t, pos: eng.decode_step(c, [[t]], pos)  # noqa: E731
        toks_t, logits_t = golden_run(step, eng.prefill, p, GOLDEN_SPEC["steps"])
        np.testing.assert_array_equal(toks_t, gold[f"tokens_{run}"])
        np.testing.assert_allclose(logits_t, gold[f"logits_{run}"], rtol=1e-3, atol=1e-3)


def write_golden():
    np_params, cfg = jax_load(CKPT)
    p = np.load(PROD_GOLDEN)["prompt"]
    out = dict(prompt=p, **{k: np.float32(v) if isinstance(v, float) else np.int32(v)
                            for k, v in GOLDEN_SPEC.items()})
    for run in GOLDEN_RUNS:
        out[f"tokens_{run}"], out[f"logits_{run}"] = jax_golden(np_params, cfg, p,
                                                                run == "compact")
        print(f"{run}: tokens {out[f'tokens_{run}']}")
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.exit(write_golden())
