"""The port's speculative decoding (``InferenceEngine.generate_speculative``,
``engine/graphs.py`` ``SpecRounds``) against the JAX engine's, on the CPU.

The contract is exactness: every emitted token comes from an exact verify
pass (or an exact top-up step), so the tokens equal exact greedy decoding
whatever the drafts. The port must also give the JAX engine's tokens and
``rounds`` / ``round_tokens`` / ``plain_steps`` exactly (fp32, exact SVD,
weights carried across from numpy). One fault of the reference is held
apart: the JAX engine tops the tail up before a refactorisation with its
``_generate_fn``, which runs the engine's own sparse step, so a sparse
engine's tokens past a top-up are not exact greedy's (ROADMAP queue 3).
The port tops up with exact steps; the cases across a refactorisation hold
it against the JAX rounds with the JAX engine's top-up made exact on the
test side (``exact_top_ups``), and the ``pre refactorize`` case pins the
fault.

Models: ``tiny_llama_config`` with JAX's init scaled by 5 (numpy, seed 0:
varied greedy tokens, drafts accepted and rejected), the tiny MLA + MoE
config of ``tests/test_torch_compiled.py`` (``draft_rank`` drafts), and the
in-repo trained checkpoint ``results/production_model/`` on its golden
prompt. Refusals are held by message against the JAX engine's, and the
port raises them before any device work (its engine is made for "cuda",
which this CPU-only machine cannot reach).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
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
GOLDEN = os.path.join(ROOT, "xkv_tpu_torch", "testdata", "production_model_golden.npz")
MOE_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=4,
               num_q_heads=4, num_kv_heads=4, head_dim=16, model_type="deepseek_v2",
               q_lora_rank=None, kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16,
               v_head_dim=16, n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
               moe_intermediate_size=32, first_k_dense_replace=1, routed_scaling_factor=1.0,
               norm_topk_prob=True)
SPARSE = dict(sparse_topk=2, sparse_block=8)
# (model, rope mode, factor dtype, tail_max, draft_k, new tokens, engine
# options, prompt seed). int4 factors put the two frameworks' logits up to
# ~7e-2 apart past a refactorisation (a factor entry near a rounding
# boundary quantises to the neighbouring level in one of them; max |logit|
# ~2.5 here), so exact greedy decoding itself parts wherever a step's top-2
# gap is below that: at prompt seed 1 the int4 post run has a step with a
# gap of 1.2e-4. Its case takes seed 6, where the two exact runs agree.
CASES = {
    "pre": ("llama", "pre", "fp32", 16, 4, 12, SPARSE, 1),
    "pre refactorize": ("llama", "pre", "fp32", 8, 3, 20, SPARSE, 1),
    "post refactorize": ("llama", "post", "fp32", 8, 3, 20, SPARSE, 1),
    "post int4 refactorize": ("llama", "post", "int4", 8, 3, 20, SPARSE, 6),
    "mla refactorize": ("mla", None, "fp32", 10, 3, 14, dict(draft_rank=8), 1),
    "mla int4 refactorize": ("mla", None, "int4", 10, 3, 14, dict(draft_rank=8), 1),
}
JAX_FACTOR = {"fp32": jnp.float32, "int4": "int4"}
TORCH_FACTOR = {"fp32": torch.float32, "int4": "int4"}


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jax_tiny(), tiny_llama_config()
    llama = jax.tree.map(lambda a: np.array(a) * (1 if a.ndim == 1 else 5),
                         jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    mla_cfg = ModelConfig(**MOE_CFG)
    return {"llama": (jcfg, tcfg, llama),
            "mla": (JaxModelConfig(**MOE_CFG), mla_cfg, deepseek.numpy_params(mla_cfg, 1))}


def xkv_kw(cfg, model, rope):
    if model == "mla":
        return dict(group_size=2, rank_k=32, rank_v=None, num_layers=cfg.num_layers,
                    end_layer=cfg.num_layers - 1, merge_value=False,
                    extra_kwargs={"svd_method": "exact"})
    return dict(group_size=2, rank_k=24, rank_v=24, num_layers=cfg.num_layers,
                end_layer=cfg.num_layers - 1,
                extra_kwargs={"svd_method": "exact", "rope_mode": rope})


def pair(models, model, rope, factor, tail_max, device="cpu", **kw):
    """(JAX engine, port engine) of one configuration, fp32."""
    jcfg, tcfg, np_params = models[model]
    je = JaxEngine(jax.tree.map(jnp.asarray, np_params), jcfg,
                   jax_xkv(**xkv_kw(tcfg, model, rope)), mode="factored", tail_max=tail_max,
                   cache_dtype=jnp.float32, factor_dtype=JAX_FACTOR[factor],
                   donate_cache=False, **kw)
    te = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), tcfg,
                         torch_xkv(**xkv_kw(tcfg, model, rope)), mode="factored",
                         tail_max=tail_max, cache_dtype=torch.float32,
                         factor_dtype=TORCH_FACTOR[factor], device=device, **kw)
    return je, te


def exact_top_ups(je, models, model, rope, factor, tail_max):
    """Give the JAX engine ``je`` exact top-up steps (its rounds stay its
    own): the single decode step of the same engine without the sparse
    options, once per token, which JAX compiles once for every top-up
    length."""
    jex, _ = pair(models, model, rope, factor, tail_max)

    def top_up(cache, params, tok, pos, cos_sin, n_steps):
        toks = []
        for i in range(n_steps):
            logits, cache = jex._decode_fn(cache, params, tok[:, None], pos + i, cos_sin)
            tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)
            toks.append(tok)
        return jnp.stack(toks, axis=1), cache

    je._generate_fn = top_up


def prompt_tokens(n, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(1, n)).astype(np.int32)


def stats_of(stats):
    return {k: stats[k] for k in ("rounds", "round_tokens", "plain_steps")}


@pytest.mark.parametrize("case", list(CASES))
def test_speculative_matches_jax_and_exact_greedy(case, models):
    """Tokens and stats equal the JAX engine's; tokens equal the port's
    exact greedy ``generate`` (the same configuration without drafts).
    ``pre refactorize`` also pins the reference's fault: with its own
    (sparse) top-up steps the JAX engine's tokens leave exact greedy's."""
    model, rope, factor, tail_max, k, n_new, kw, seed = CASES[case]
    je, te = pair(models, model, rope, factor, tail_max, **kw)
    prompt = prompt_tokens(32, models[model][1].vocab_size, seed)
    _, exact = pair(models, model, rope, factor, tail_max)
    greedy = exact.generate(prompt, n_new).numpy()
    if case == "pre refactorize":
        assert not np.array_equal(np.asarray(je.generate_speculative(prompt, n_new, k)),
                                  greedy)
    if model == "llama":
        exact_top_ups(je, models, model, rope, factor, tail_max)
    want, want_stats = je.generate_speculative(prompt, n_new, draft_k=k, return_stats=True)
    got, stats = te.generate_speculative(prompt, n_new, draft_k=k, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats_of(stats) == stats_of(want_stats)
    assert stats["tokens_per_round"] == want_stats["tokens_per_round"]
    np.testing.assert_array_equal(got.numpy(), greedy)
    if "refactorize" in case:
        assert stats["plain_steps"] > 0
        assert sum(1 for t in te.last_timings if hasattr(t, "draft_k")) >= 2


def test_speculative_eos_matches_jax(models):
    model, rope, factor, tail_max, k, n_new, kw, _ = CASES["pre"]
    je, te = pair(models, model, rope, factor, tail_max, **kw)
    prompt = prompt_tokens(32, models[model][1].vocab_size)
    full = te.generate_speculative(prompt, n_new, draft_k=k)[0].tolist()
    eos = full[5]
    want, want_stats = je.generate_speculative(prompt, n_new, draft_k=k, eos_token_id=eos,
                                               return_stats=True)
    got, stats = te.generate_speculative(prompt, n_new, draft_k=k, eos_token_id=eos,
                                         return_stats=True)
    assert got[0].tolist() == full[:full.index(eos) + 1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats_of(stats) == stats_of(want_stats)


def test_speculative_on_trained_model_matches_jax():
    """The in-repo checkpoint (fp32) on its golden prompt: sparse top-2 of
    64-row chunks drafts, 4 a round; tokens and stats equal the JAX
    engine's, and the first 8 tokens are the golden greedy ones."""
    np_params, cfg = jax_load(CKPT)
    gold = np.load(GOLDEN)
    kw = dict(group_size=int(gold["group_size"]), rank_k=int(gold["rank_k"]),
              rank_v=int(gold["rank_v"]), num_layers=cfg.num_layers,
              end_layer=cfg.num_layers - 1,
              extra_kwargs={"svd_method": "exact", "rope_mode": "pre"})
    opts = dict(mode="factored", tail_max=64, sparse_topk=2, sparse_block=64)
    je = JaxEngine(jax.tree.map(jnp.asarray, np_params), cfg, jax_xkv(**kw),
                   cache_dtype=jnp.float32, factor_dtype=jnp.float32, donate_cache=False,
                   **opts)
    te = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), cfg,
                         torch_xkv(**kw), cache_dtype=torch.float32,
                         factor_dtype=torch.float32, device="cpu", **opts)
    want, want_stats = je.generate_speculative(gold["prompt"], 12, draft_k=4,
                                               return_stats=True)
    got, stats = te.generate_speculative(gold["prompt"], 12, draft_k=4, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats_of(stats) == stats_of(want_stats)
    np.testing.assert_array_equal(got[0, :8].numpy(), gold["tokens_pre"])


# ------------------------------------------------------------------ refusals
REFUSALS = {
    # (model, engine options, prompt batch, draft_k, message)
    "no draft path": ("llama", {}, 1, 3, "requires sparse_topk"),
    "mla without draft_rank": ("mla", {}, 1, 3, "requires sparse_topk"),
    "sliding window": ("mistral", SPARSE, 1, 3, "sliding_window"),
    "batch 2": ("llama", SPARSE, 2, 3, "batch-1"),
    "draft_k + 1 > tail_max": ("llama", SPARSE, 1, 8, "needs tail_max > draft_k"),
}


@pytest.mark.parametrize("which", list(REFUSALS))
def test_speculative_refusals_match_jax_before_device_work(which, models):
    model, kw, batch, k, msg = REFUSALS[which]
    if model == "mistral":
        jcfg = jax_tiny(model_type="mistral", sliding_window=10)
        tcfg = tiny_llama_config(model_type="mistral", sliding_window=10)
        models = {"mistral": (jcfg, tcfg, models["llama"][2])}
    je, _ = pair(models, model, "pre", "fp32", 8, **kw)
    _, te = pair(models, model, "pre", "fp32", 8, device="cuda", **kw)
    prompt = prompt_tokens(16, 64).repeat(batch, axis=0)
    with pytest.raises(ValueError, match=msg) as jerr:
        je.generate_speculative(prompt, 6, draft_k=k)
    with pytest.raises(ValueError, match=msg) as terr:
        te.generate_speculative(prompt, 6, draft_k=k)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("model,mode,msg", [("llama", "factored", "MLA-only"),
                                            ("mla", "fake", "requires mode='factored'")])
def test_draft_rank_refusals_match_jax(model, mode, msg, models):
    jcfg, tcfg, np_params = models[model]
    with pytest.raises(ValueError, match=msg) as jerr:
        JaxEngine(jax.tree.map(jnp.asarray, np_params), jcfg,
                  jax_xkv(**xkv_kw(tcfg, model, "pre")), mode=mode, draft_rank=8)
    with pytest.raises(ValueError, match=msg) as terr:
        InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), tcfg,
                        torch_xkv(**xkv_kw(tcfg, model, "pre")), mode=mode, draft_rank=8,
                        device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_mla_draft_rank_truncates_the_rankspace_part(models):
    """A draft step at ``draft_rank`` equal to the factors' full rank is the
    exact step; a lower rank changes the logits (the truncation reaches the
    kernel's inputs)."""
    _, te = pair(models, "mla", None, "fp32", 8)
    prompt = prompt_tokens(32, MOE_CFG["vocab_size"])
    logits, cache = te.prefill(prompt)
    tok = logits[:, -1].argmax(-1)[:, None]
    s = prompt.shape[1]
    exact, _ = te.step(cache, tok, s, {})
    full, _ = te.step(cache, tok, s, {"draft_rank": 32})
    low, _ = te.step(cache, tok, s, {"draft_rank": 8})
    assert torch.equal(exact, full)
    assert (exact - low).abs().max() > 1e-4
