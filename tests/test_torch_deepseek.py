"""DeepSeek-V2 MLA + MoE in the port against the JAX package, on the CPU.

Weights come from a numpy seed (``deepseek.numpy_params``) and reach both
packages as the same fp32 arrays (``params_from_numpy`` for the port); the
configs are the two tiny ones of ``tests/test_deepseek_mla.py`` (dense and
MoE). Exact SVD on both sides.

Tolerances: fp32 ops to 1e-6 (RoPE) and 1e-5 (latent norm, MoE, kernels'
plain versions, row-relative); prefill logits 1e-4; the engines' greedy
tokens equal and first decode step's logits within 2e-4, the tolerance of
``test_deepseek_mla.py::test_mla_pallas_kernel_matches_xla``. The JAX
engine runs its MLA kernels (K7, K8) in interpret mode
(``attention_impl="pallas"``), whose numerics the port follows: with int8
and int4 factors both round the query and P * r to bf16. The kernel
cases hold the port's plain versions against the Pallas kernel called
directly with ``interpret=True``; in bf16 the Pallas kernel runs one block
(the same maximum as the plain version), so both round P * r alike.

``python tests/test_torch_deepseek.py`` regenerates
``xkv_tpu_torch/testdata/mla_golden.npz`` from the JAX engine: the config
and weight seed of a small MLA + MoE model, the prompt, and for a factored
run with bf16 factors and one with int4 factors the greedy tokens and the
logits that chose them. ``chip_smoke.py`` holds the port on the card
against it.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xkv_tpu.configs import generate_consecutive_xkv_config as jax_xkv
from xkv_tpu.engine import InferenceEngine as JaxEngine
from xkv_tpu.engine.compression import latent_rnorm as jax_latent_rnorm
from xkv_tpu.models import deepseek as jds
from xkv_tpu.models.config import ModelConfig as JaxModelConfig
from xkv_tpu.ops.pallas.rankspace_attention import mla_rankspace_decode_attention as jax_mla
from xkv_tpu.ops.rope import apply_rope_interleaved as jax_rope_interleaved
from xkv_tpu.ops.rope import rope_cos_sin as jax_rope_cos_sin
from xkv_tpu_torch.cache import cache_from_numpy
from xkv_tpu_torch.compress import quant as tq
from xkv_tpu_torch.configs import generate_consecutive_xkv_config as torch_xkv
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.engine.compression import latent_rnorm
from xkv_tpu_torch.models import deepseek
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import ModelConfig
from xkv_tpu_torch.ops.kernels import rankspace_attention as k2
from xkv_tpu_torch.ops.rope import apply_rope_interleaved, rope_cos_sin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "xkv_tpu_torch", "testdata", "mla_golden.npz")

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=4,
           num_q_heads=4, num_kv_heads=4, head_dim=16, model_type="deepseek_v2",
           q_lora_rank=None, kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16,
           v_head_dim=16)
MOE_CFG = dict(CFG, n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
               moe_intermediate_size=32, first_k_dense_replace=1, routed_scaling_factor=1.0,
               norm_topk_prob=True)
# The golden's model: every width a multiple of 16, so the kernels take it
# on the card; 8 experts, top-2, one shared.
GOLDEN_CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=4,
                  num_q_heads=4, num_kv_heads=4, head_dim=32, model_type="deepseek_v2",
                  kv_lora_rank=64, qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
                  n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
                  moe_intermediate_size=64, first_k_dense_replace=1)
GOLDEN_SPEC = dict(seed=0, group_size=4, rank_k=64, int4_rank_frac=0.25, prompt_len=256,
                   steps=8)
GOLDEN_RUNS = {"bf16": "bf16", "int4": "int4"}

JAX_FACTOR = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "int8": "int8", "int4": "int4"}
TORCH_FACTOR = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": "int8", "int4": "int4"}


def configs(fields):
    return JaxModelConfig(**fields), ModelConfig(**fields)


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(x):
    return None if x is None else torch.as_tensor(np.array(x))


def j(x):
    return None if x is None else jnp.asarray(x)


def row_rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).max(axis=-1), 1e-30)
    return float((np.abs(got - want).max(axis=-1) / scale).max())


def xkv_pair(num_layers=4, group_size=2, rank_k=48, int4_rank_frac=0.5, merge_value=False):
    kw = dict(group_size=group_size, rank_k=rank_k, rank_v=rank_k if merge_value else None,
              num_layers=num_layers,
              end_layer=num_layers - 1, merge_value=merge_value,
              extra_kwargs={"svd_method": "exact", "int4_rank_frac": int4_rank_frac})
    return jax_xkv(**kw), torch_xkv(**kw)


def prompt_tokens(n, vocab, seed=0, b=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, n)).astype(np.int32)


@pytest.fixture(scope="module")
def dense_model():
    jcfg, tcfg = configs(CFG)
    return jcfg, tcfg, deepseek.numpy_params(tcfg, 0)


@pytest.fixture(scope="module")
def moe_model():
    jcfg, tcfg = configs(MOE_CFG)
    return jcfg, tcfg, deepseek.numpy_params(tcfg, 1)


def engines(model, mode, factor="fp32", tail_max=12, **xkv_kw):
    jcfg, tcfg, np_params = model
    jx, tx = xkv_pair(tcfg.num_layers, **xkv_kw)
    je = JaxEngine(jax.tree.map(jnp.asarray, np_params), jcfg, None if mode == "none" else jx,
                   mode=mode, tail_max=tail_max, attention_impl="pallas",
                   cache_dtype=jnp.float32, factor_dtype=JAX_FACTOR[factor],
                   donate_cache=False)
    te = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), tcfg,
                         None if mode == "none" else tx, mode=mode, tail_max=tail_max,
                         cache_dtype=torch.float32, factor_dtype=TORCH_FACTOR[factor],
                         device="cpu")
    return je, te


def golden_run(run_step, prefill, prompt, steps, teacher=None):
    """Greedy tokens (or the ``teacher`` tokens, forced) and the logits of
    the prefill's last position and of each decode step."""
    logits, cache = prefill(prompt)
    rows = [np.asarray(logits[0, -1], np.float32)]
    toks = [int(np.argmax(rows[-1])) if teacher is None else int(teacher[0])]
    pos = prompt.shape[1]
    for i in range(steps - 1):
        step, cache = run_step(cache, toks[-1], pos + i)
        rows.append(np.asarray(step[0, -1], np.float32))
        toks.append(int(np.argmax(rows[-1])) if teacher is None else int(teacher[i + 1]))
    return np.asarray(toks, np.int32), np.stack(rows)


def jax_step(eng):
    return lambda c, tk, p: eng.decode_step(c, jnp.asarray([[tk]], jnp.int32),
                                            jnp.asarray(p, jnp.int32))


def torch_step(eng):
    return lambda c, tk, p: eng.decode_step(c, [[tk]], p)


# ------------------------------------------------------------------ ops
def test_apply_rope_interleaved_matches_jax():
    x = rnd(0, 2, 3, 5, 16)
    pos = np.arange(7, 12)[None]
    cos, sin = jax_rope_cos_sin(j(pos), 16, 10000.0)
    want = jax_rope_interleaved(j(x), cos, sin)
    tcos, tsin = rope_cos_sin(t(pos), 16, 10000.0)
    got = apply_rope_interleaved(t(x), tcos, tsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_latent_rnorm_matches_jax():
    mat = rnd(1, 2, 9, 3 * 32, scale=0.3)
    np.testing.assert_allclose(latent_rnorm(t(mat), 3).numpy(),
                               np.asarray(jax_latent_rnorm(j(mat), 3)), rtol=1e-5)


@pytest.mark.parametrize("norm,scaling,rows", [(True, 1.0, 24), (False, 2.5, 24),
                                               (True, 2.5, 2), (False, 1.0, 1)])
def test_moe_matches_jax(norm, scaling, rows):
    """Sorted per-expert products (24 rows) and gathered expert weights
    (1-2 rows, decode) against the dense one-hot dispatch."""
    fields = dict(MOE_CFG, norm_topk_prob=norm, routed_scaling_factor=scaling)
    jcfg, tcfg = configs(fields)
    mlp = deepseek.numpy_params(tcfg, 2)["layers"][1]["mlp"]
    x = rnd(3, 1, rows, tcfg.hidden_size)
    want = jax.jit(lambda p, v: jds._moe(p, jcfg, v))(jax.tree.map(jnp.asarray, mlp), j(x))
    got = deepseek._moe(params_from_numpy(mlp, torch.float32, "cpu"), tcfg, t(x))
    assert row_rel_err(got.numpy(), want) <= 1e-5


def test_params_from_numpy_carries_moe_tree(moe_model):
    """The MLA + MoE tree, stacked expert arrays included, arrives leaf for
    leaf with its layout."""
    _, _, np_params = moe_model
    tp = params_from_numpy(np_params, torch.float32, "cpu")
    np_leaves = jax.tree_util.tree_leaves_with_path(np_params)
    flat_t = {jax.tree_util.keystr(p): leaf for p, leaf in
              jax.tree_util.tree_leaves_with_path(tp, is_leaf=torch.is_tensor)}
    assert len(flat_t) == len(np_leaves)
    for path, leaf in np_leaves:
        np.testing.assert_array_equal(flat_t[jax.tree_util.keystr(path)].numpy(), leaf)
    experts = tp["layers"][1]["mlp"]["experts"]["w_gate"]
    assert tuple(experts.shape) == (4, 64, 32)


@pytest.mark.parametrize("which", ["dense", "moe"])
def test_prefill_matches_jax(which, dense_model, moe_model):
    jcfg, tcfg, np_params = dense_model if which == "dense" else moe_model
    prompt = prompt_tokens(20, tcfg.vocab_size, seed=5, b=2)
    want_logits, want_kvs = jax.jit(lambda p, tk: jds.prefill(p, jcfg, tk))(
        jax.tree.map(jnp.asarray, np_params), j(prompt))
    got_logits, got_kvs = deepseek.prefill(params_from_numpy(np_params, torch.float32, "cpu"),
                                           tcfg, t(prompt).long())
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=1e-4,
                               atol=1e-4)
    for (gl, gk), (wl, wk) in zip(got_kvs, want_kvs):
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- kernels
def _mla_inputs(seed, kind, b, nh, ql, s_p, rk, rope):
    q_emb = rnd(seed, b, nh, ql, rk, scale=0.3)
    q_pe = rnd(seed + 1, b, nh, ql, rope, scale=0.3)
    k_pe = rnd(seed + 2, b, s_p, rope)
    r = np.abs(rnd(seed + 3, b, s_p)) + 0.5
    if kind == "fp32":
        return q_emb, q_pe, rnd(seed + 4, b, s_p, rk), k_pe, r, None
    if kind == "int8":
        us = np.random.default_rng(seed + 4).integers(-127, 128, (b, s_p, rk)).astype(np.int8)
        return q_emb * 0.02, q_pe, us, k_pe, r, None
    us8 = np.random.default_rng(seed + 4).integers(-127, 128, (b, s_p, rk // 2)).astype(np.int8)
    lo = np.random.default_rng(seed + 5).integers(-7, 8, (b, s_p, rk // 2))
    us4 = tq.pack_int4_pairs(torch.as_tensor(lo)).numpy()
    return q_emb * 0.02, q_pe, us8, k_pe, r, us4


@pytest.mark.parametrize("kind,ql,lens", [("fp32", 1, None), ("fp32", 2, [30, 17]),
                                          ("int8", 1, [29, 40]), ("int8", 2, None),
                                          ("int4", 1, None), ("int4", 2, [33, 12])])
def test_mla_kernel_plain_matches_pallas_interpret(kind, ql, lens):
    """K7 (fp32, int8 us) and K8 (int8 + packed int4) wrappers on CPU
    tensors, i.e. their plain versions, against the Pallas kernel."""
    b, nh, s_p, rk, rope = 2, 4, 40, 32, 16
    q_emb, q_pe, us, k_pe, r, us4 = _mla_inputs(7, kind, b, nh, ql, s_p, rk, rope)
    block = 16 if kind == "fp32" else s_p
    want_t, want_lse = jax_mla(j(q_emb), j(q_pe), j(us), j(k_pe), j(r), j(lens), j(us4),
                               block_s=block, interpret=True)
    counts = (k2.mla_launches, k2.mla_mixed_launches)
    got_t, got_lse = k2.mla_rankspace_decode_attention(t(q_emb), t(q_pe), t(us), t(k_pe),
                                                       t(r), t(lens), t(us4))
    assert (k2.mla_launches, k2.mla_mixed_launches) == counts  # plain runs are no launch
    assert row_rel_err(got_t.numpy(), want_t) <= 1e-5
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=1e-5)


@pytest.mark.parametrize("kind,draft_rank,ql", [("fp32", 8, 1), ("fp32", 20, 2),
                                                ("int8", 12, 1), ("int8", 16, 2)])
def test_mla_draft_view_plain_matches_pallas_interpret(kind, draft_rank, ql):
    """A speculative draft's K7 call: the first ``draft_rank`` columns of
    wider factors, passed as a view (a rank that need not be a multiple of
    16: q_emb is padded to ``rank_width`` and t cut back), against the
    Pallas kernel over the same columns, as the JAX draft calls it."""
    b, nh, s_p, rk, rope = 2, 4, 40, 32, 16
    q_emb, q_pe, us, k_pe, r, _ = _mla_inputs(11, kind, b, nh, ql, s_p, rk, rope)
    q_emb, us_draft = q_emb[..., :draft_rank], us[..., :draft_rank]
    want_t, want_lse = jax_mla(j(q_emb), j(q_pe), j(us_draft), j(k_pe), j(r), None, None,
                               block_s=16 if kind == "fp32" else s_p, interpret=True)
    view = t(us)[..., :draft_rank]
    assert not view.is_contiguous()
    got_t, got_lse = k2.mla_rankspace_decode_attention(t(q_emb), t(q_pe), view, t(k_pe), t(r))
    assert tuple(got_t.shape) == (b, nh, ql, draft_rank)
    assert row_rel_err(got_t.numpy(), want_t) <= 1e-5
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=1e-5)


def test_mla_shapes_take_a_draft_view():
    """K7's shape rule: q_emb's width is the view's rank rounded up to 16."""
    meta = dict(device="meta")
    us = torch.empty((1, 100, 512), dtype=torch.bfloat16, **meta)[..., :120]
    args = (torch.empty((1, 16, 128), dtype=torch.bfloat16, **meta),
            torch.empty((1, 16, 64), dtype=torch.bfloat16, **meta), us,
            torch.empty((1, 100, 64), dtype=torch.bfloat16, **meta),
            torch.empty((1, 100), dtype=torch.float32, **meta))
    assert k2.mla_shapes(*args) == (1, 16, 100, 128, 64)
    with pytest.raises(ValueError, match="rounded up to 16"):
        k2.mla_shapes(args[0], args[1], us[..., :100], *args[3:])


# ---------------------------------------------------------------- engine
ENGINE_CASES = [("dense", "none", "fp32"), ("moe", "none", "fp32"),
                ("dense", "factored", "fp32"), ("moe", "factored", "fp32"),
                ("dense", "factored", "int8"), ("moe", "factored", "int4")]


@pytest.mark.parametrize("which,mode,factor", ENGINE_CASES)
def test_engine_matches_jax(which, mode, factor, dense_model, moe_model):
    je, te = engines(dense_model if which == "dense" else moe_model, mode, factor,
                     rank_k=16 if factor == "int4" else 48)
    prompt = prompt_tokens(24, 128, seed=8)
    want_toks, want_logits = golden_run(jax_step(je), je.prefill, prompt, 5)
    got_toks, got_logits = golden_run(torch_step(te), te.prefill, prompt, 5)
    np.testing.assert_array_equal(got_toks, want_toks)
    np.testing.assert_allclose(got_logits[:2], want_logits[:2], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("factor", ["fp32", "int8", "int4"])
def test_generate_across_refactorize_matches_jax(factor, moe_model):
    """A tail of 4 and 6 new tokens: one fold, re-factorising and
    re-quantising the latent and recomputing k_rnorm."""
    je, te = engines(moe_model, "factored", factor, tail_max=4,
                     rank_k=16 if factor == "int4" else 40)
    prompt = prompt_tokens(24, 128, seed=9)
    want = np.asarray(je.generate(prompt, 6))
    np.testing.assert_array_equal(te.generate(prompt, 6).numpy(), want)


@pytest.mark.parametrize("factor", ["bf16", "int8", "int4"])
def test_compression_ratio_matches_jax(factor, dense_model):
    je, te = engines(dense_model, "factored", factor, rank_k=16)
    prompt = prompt_tokens(32, 128, seed=10)
    _, jc = je.prefill(prompt)
    _, tc = te.prefill(prompt)
    assert tc.groups[0].k_rnorm is not None and tc.groups[0].v_us is None
    assert tc.compression_ratio(te.cfg) == pytest.approx(jc.compression_ratio(je.cfg),
                                                         rel=1e-12)


def test_merge_value_and_sparse_topk_rejected(dense_model):
    _, tcfg, np_params = dense_model
    params = params_from_numpy(np_params, torch.float32, "cpu")
    _, tx = xkv_pair(merge_value=True)
    with pytest.raises(ValueError, match="merge_value"):
        InferenceEngine(params, tcfg, tx, mode="factored", device="cpu")
    _, tx = xkv_pair()
    with pytest.raises(ValueError, match="sparse_topk is llama-family only"):
        InferenceEngine(params, tcfg, tx, mode="factored", sparse_topk=2, device="cpu")
    # int4 needs no post mode for MLA: construction succeeds.
    InferenceEngine(params, tcfg, tx, mode="factored", factor_dtype="int4", device="cpu")


@pytest.mark.parametrize("factor", ["fp32", "int8"])
@pytest.mark.parametrize("draft_rank", [None, 8])
def test_factored_latent_without_rnorm_matches_jax(factor, draft_rank, dense_model):
    """A factored latent saved without ``k_rnorm`` (caches persisted before
    it existed) decodes through the legacy reconstruct path: the JAX
    engine's cache with ``k_rnorm`` dropped, carried across, and the first
    decode step of both packages (all ranks, or a draft over the top 8)
    within the engine tolerance. The path rebuilds the latent (``k_us @
    vt`` or the int8 dequantisation) and is plain in both packages."""
    jcfg, tcfg, np_params = dense_model
    je, te = engines(dense_model, "factored", factor)
    jx, tx = xkv_pair(tcfg.num_layers)
    prompt = prompt_tokens(16, 128, seed=11)
    logits, jcache = je.prefill(prompt)
    jcache = jcache.replace(groups=tuple(g.replace(k_rnorm=None) for g in jcache.groups))
    cache = cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert cache.groups[0].k_us is not None and cache.groups[0].k_rnorm is None
    tok = int(np.argmax(np.asarray(logits[0, -1])))
    want, _ = jds.decode_step(jax.tree.map(jnp.asarray, np_params), jcfg, jx, jcache,
                              jnp.asarray([[tok]], jnp.int32), jnp.asarray(16, jnp.int32),
                              None, draft_rank=draft_rank)
    got, _ = deepseek.decode_step(te.params, tcfg, tx, cache, torch.tensor([[tok]]), 16,
                                  draft_rank=draft_rank)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_mla_fake_mode_runs(moe_model):
    """Fake mode splits an MLA group's reconstruction into its layers'
    single latent heads (the JAX package splits it into num_kv_heads heads,
    ROADMAP section 3): at full rank it decodes as factored does."""
    _, tcfg, np_params = moe_model
    _, tx = xkv_pair(rank_k=2 * tcfg.kv_lora_rank)
    params = params_from_numpy(np_params, torch.float32, "cpu")
    kw = dict(tail_max=8, cache_dtype=torch.float32, factor_dtype=torch.float32, device="cpu")
    fake = InferenceEngine(params, tcfg, tx, mode="fake", **kw)
    fact = InferenceEngine(params, tcfg, tx, mode="factored", **kw)
    prompt = prompt_tokens(24, 128, seed=12, b=2)
    _, cache = fake.prefill(prompt)
    for l in range(tcfg.num_layers):
        assert tuple(cache.dense_k[l].shape) == (2, 1, 24, tcfg.kv_lora_rank)
    np.testing.assert_array_equal(fake.generate(prompt, 6).numpy(),
                                  fact.generate(prompt, 6).numpy())


# ---------------------------------------------------------------- golden
def golden_model():
    jcfg, tcfg = configs(GOLDEN_CFG)
    return jcfg, tcfg, deepseek.numpy_params(tcfg, GOLDEN_SPEC["seed"])


def golden_xkv():
    spec = GOLDEN_SPEC
    return xkv_pair(GOLDEN_CFG["num_layers"], spec["group_size"], spec["rank_k"],
                    spec["int4_rank_frac"])


def test_mla_golden_reproduced_by_port():
    """The golden's runs teacher-forced through the port on the CPU (fp32
    weights and cache): the same tokens, logits to 2e-3 (the bf16 and int4
    factors round alike in both, from SVDs that agree to fp32 noise)."""
    gold = np.load(GOLDEN)
    assert json.loads(str(gold["config"])) == GOLDEN_CFG
    _, tcfg, np_params = golden_model()
    params = params_from_numpy(np_params, torch.float32, "cpu")
    for run, factor in GOLDEN_RUNS.items():
        _, tx = golden_xkv()
        eng = InferenceEngine(params, tcfg, tx, mode="factored", tail_max=GOLDEN_SPEC["steps"],
                              cache_dtype=torch.float32, factor_dtype=TORCH_FACTOR[factor],
                              device="cpu")
        toks, logits = golden_run(torch_step(eng), eng.prefill, gold["prompt"],
                                  GOLDEN_SPEC["steps"], teacher=gold[f"tokens_{run}"])
        np.testing.assert_array_equal(np.argmax(logits, axis=-1), gold[f"tokens_{run}"])
        np.testing.assert_allclose(logits, gold[f"logits_{run}"], rtol=2e-3, atol=2e-3)


def write_golden():
    jcfg, tcfg, np_params = golden_model()
    spec = GOLDEN_SPEC
    prompt = prompt_tokens(spec["prompt_len"], tcfg.vocab_size, seed=13)
    out = dict(prompt=prompt, config=np.array(json.dumps(GOLDEN_CFG)),
               **{k: np.asarray(v) for k, v in spec.items()})
    for run, factor in GOLDEN_RUNS.items():
        jx, _ = golden_xkv()
        eng = JaxEngine(jax.tree.map(jnp.asarray, np_params), jcfg, jx, mode="factored",
                        tail_max=spec["steps"], attention_impl="pallas",
                        cache_dtype=jnp.float32, factor_dtype=JAX_FACTOR[factor])
        out[f"tokens_{run}"], out[f"logits_{run}"] = golden_run(
            jax_step(eng), eng.prefill, prompt, spec["steps"])
        print(f"{run}: tokens {out[f'tokens_{run}']}")
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.exit(write_golden())
