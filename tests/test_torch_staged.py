"""The port's staged prefill (``InferenceEngine(staged_prefill=True)``,
``models/llama.py`` ``prefill_layer_span``) against its monolithic prefill
and the JAX engine's staged path, on the CPU; and ``prefill_logits="last"``
greedy decoding against the JAX engine's.

The staged path runs the monolithic path's layer body and group
compression one SVD group at a time, so against the port's monolithic
prefill its last-position logits, factors, chunk bounds and dense segments
are equal bit for bit, and so are the decode steps that follow. Against
the JAX engine's staged path (fp32, exact SVD, weights carried across from
numpy): last-position logits within 1e-3 (the engine tests' fp32
tolerance); each group's K and V matrices, rebuilt from the factors (an
SVD's signs are free), within 1e-4 of their largest entry, 2e-2 with int8
factors (``tests/test_torch_compress.py``'s); chunk bounds and dense
segments within 1e-4 (1e-3 with int8 factors, the JAX staged test's).
Refusals by message against the JAX engine's.

Model: ``tiny_llama_config`` with JAX's init scaled by 5 (numpy, seed 0;
varied greedy tokens), a 32-token prompt.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xkv_tpu.configs import LayerGroup as JaxLayerGroup
from xkv_tpu.configs import XKVConfig as JaxXKVConfig
from xkv_tpu.configs import generate_consecutive_xkv_config as jax_xkv
from xkv_tpu.engine import InferenceEngine as JaxEngine
from xkv_tpu.models.config import ModelConfig as JaxModelConfig
from xkv_tpu.models.config import tiny_llama_config as jax_tiny
from xkv_tpu.models.llama import init_params as jax_init
from xkv_tpu_torch.configs import LayerGroup, XKVConfig
from xkv_tpu_torch.configs import generate_consecutive_xkv_config as torch_xkv
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.models import deepseek
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import ModelConfig, tiny_llama_config

JAX_FACTOR = {"fp32": jnp.float32, "int8": "int8"}
TORCH_FACTOR = {"fp32": torch.float32, "int8": "int8"}


@pytest.fixture(scope="module")
def model():
    params = jax.tree.map(lambda a: np.array(a) * (1 if a.ndim == 1 else 5),
                          jax_init(jax_tiny(), jax.random.PRNGKey(0), dtype=jnp.float32))
    return jax_tiny(), tiny_llama_config(), params


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(3).integers(0, 256, size=(1, 32)).astype(np.int32)


def xkv_kw(rope="pre", end_layer=3):
    return dict(num_layers=4, end_layer=end_layer, group_size=2, rank_k=16, rank_v=20,
                extra_kwargs={"svd_method": "exact", "rope_mode": rope})


def port_engine(model, xkv, factor="fp32", staged=True, **kw):
    _, tcfg, np_params = model
    return InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), tcfg, xkv,
                           mode="factored", tail_max=8, cache_dtype=torch.float32,
                           factor_dtype=TORCH_FACTOR[factor], prefill_logits="last",
                           staged_prefill=staged, device="cpu", **kw)


def jax_engine(model, xkv, factor="fp32", staged=True, **kw):
    jcfg, _, np_params = model
    return JaxEngine(jax.tree.map(jnp.asarray, np_params), jcfg, xkv, mode="factored",
                     tail_max=8, cache_dtype=jnp.float32, factor_dtype=JAX_FACTOR[factor],
                     prefill_logits="last", staged_prefill=staged, donate_cache=False, **kw)


def f32(x):
    """A tensor of either framework as fp32 numpy."""
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def group_matrix(gf, side):
    """A group's K or V matrix (b, s, m) fp32, rebuilt from its factors."""
    us, vt = (gf.k_us, gf.k_vt) if side == "k" else (gf.v_us, gf.v_vt)
    us, vt = f32(us), f32(vt)
    if side == "k" and gf.k_scale is not None:
        return (us @ vt) * f32(gf.k_scale)
    if side == "v" and gf.v_scale is not None:
        us = us * f32(gf.v_scale)
    return us @ vt


def assert_caches_equal(a, b):
    """Two port caches, bit for bit."""
    assert len(a.groups) == len(b.groups) and sorted(a.dense_k) == sorted(b.dense_k)
    for ga, gb in zip(a.groups, b.groups):
        for name in ("k_us", "k_vt", "v_us", "v_vt", "k_scale", "v_scale", "k_cmin",
                     "k_cmax"):
            x, y = getattr(ga, name), getattr(gb, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert x.dtype == y.dtype and torch.equal(x, y), name
    for d_a, d_b in ((a.dense_k, b.dense_k), (a.dense_v, b.dense_v)):
        for l in d_a:
            assert torch.equal(d_a[l], d_b[l])


def assert_close_to_jax(tcache, jcache, tlogits, jlogits, tol):
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-3, atol=1e-3)
    for tg, jg in zip(tcache.groups, jcache.groups):
        for side in ("k", "v"):
            want = group_matrix(jg, side)
            np.testing.assert_allclose(group_matrix(tg, side), want, rtol=0,
                                       atol=tol * max(1.0, np.abs(want).max()))
    assert sorted(tcache.dense_k) == sorted(jcache.dense_k)
    for l in jcache.dense_k:
        np.testing.assert_allclose(tcache.dense_k[l].numpy(), np.asarray(jcache.dense_k[l]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tcache.dense_v[l].numpy(), np.asarray(jcache.dense_v[l]),
                                   rtol=1e-4, atol=1e-4)


def greedy(eng, prompt, logits, cache, steps=3):
    """Tokens and logits of ``steps`` greedy decode steps from a cache."""
    tok = logits[:, -1].argmax(-1)[:, None]
    out, rows = [tok], []
    for i in range(steps):
        step, cache = eng.decode_step(cache, tok, prompt.shape[1] + i)
        rows.append(step)
        tok = step[:, -1].argmax(-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1), torch.cat(rows, dim=1)


@pytest.mark.parametrize("rope", ["pre", "post"])
def test_staged_prefill_matches_monolithic_and_jax(rope, model, prompt):
    staged = port_engine(model, torch_xkv(**xkv_kw(rope)))
    mono = port_engine(model, torch_xkv(**xkv_kw(rope)), staged=False)
    ls, cs = staged.prefill(prompt)
    lm, cm = mono.prefill(prompt)
    assert tuple(ls.shape) == (1, 1, 256) and torch.equal(ls, lm)
    assert_caches_equal(cs, cm)
    toks_s, rows_s = greedy(staged, prompt, ls, cs)
    toks_m, rows_m = greedy(mono, prompt, lm, cm)
    assert torch.equal(toks_s, toks_m) and torch.equal(rows_s, rows_m)
    assert torch.equal(staged.generate(prompt, 10), mono.generate(prompt, 10))
    jl, jc = jax_engine(model, jax_xkv(**xkv_kw(rope))).prefill(prompt)
    assert_close_to_jax(cs, jc, ls, jl, 1e-4)


def test_staged_prefill_int8_and_sparse_bounds(model, prompt):
    """int8 factors and Quest chunk bounds through the staged path."""
    kw = dict(sparse_topk=2, sparse_block=8)
    staged = port_engine(model, torch_xkv(**xkv_kw("post")), "int8", **kw)
    ls, cs = staged.prefill(prompt)
    lm, cm = port_engine(model, torch_xkv(**xkv_kw("post")), "int8", staged=False,
                         **kw).prefill(prompt)
    assert torch.equal(ls, lm)
    assert_caches_equal(cs, cm)
    jl, jc = jax_engine(model, jax_xkv(**xkv_kw("post")), "int8", **kw).prefill(prompt)
    assert_close_to_jax(cs, jc, ls, jl, 2e-2)
    for tg, jg in zip(cs.groups, jc.groups):
        assert tg.k_us.dtype == torch.int8 and tg.k_cmin is not None
        for name in ("k_cmin", "k_cmax"):
            np.testing.assert_allclose(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                       rtol=1e-3, atol=1e-3)


def test_staged_prefill_partial_coverage(model, prompt):
    """Ungrouped layers (2, 3) after the grouped span: dense, rotated keys."""
    staged = port_engine(model, torch_xkv(**xkv_kw(end_layer=1)))
    ls, cs = staged.prefill(prompt)
    lm, cm = port_engine(model, torch_xkv(**xkv_kw(end_layer=1)), staged=False).prefill(prompt)
    assert sorted(cs.dense_k) == [2, 3]
    assert torch.equal(ls, lm)
    assert_caches_equal(cs, cm)
    jl, jc = jax_engine(model, jax_xkv(**xkv_kw(end_layer=1))).prefill(prompt)
    assert_close_to_jax(cs, jc, ls, jl, 1e-4)


def test_prefill_logits_last_greedy_matches_jax(model, prompt):
    """``prefill_logits="last"`` (monolithic): last-position logits and
    greedy tokens equal the JAX engine's."""
    tx, jx = torch_xkv(**xkv_kw()), jax_xkv(**xkv_kw())
    port = port_engine(model, tx, staged=False)
    jeng = jax_engine(model, jx, staged=False)
    tl, _ = port.prefill(prompt)
    jl, _ = jeng.prefill(prompt)
    assert tuple(tl.shape) == tuple(jl.shape) == (1, 1, 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(port.generate(prompt, 12).numpy(),
                                  np.asarray(jeng.generate(prompt, 12)))


def _noncontiguous(layer_group, config):
    return config(num_layers=4, rank_k=16, rank_v=20,
                  layer_groups=[layer_group(layers=[0, 2]), layer_group(layers=[1, 3])],
                  extra_kwargs={"svd_method": "exact"})


# (engine options, the xkv config: "consecutive", "slerp", "non-contiguous"
# or "mla", message)
REFUSALS = {
    "mode none": (dict(mode="none"), None, "requires mode='factored'"),
    "mode fake": (dict(mode="fake"), "consecutive", "requires mode='factored'"),
    "slerp": ({}, "slerp", "svd scheme only"),
    "mla": ({}, "mla", "llama-family only"),
    "all logits": (dict(prefill_logits="all"), "consecutive", "last-position logits only"),
    "non-contiguous groups": ({}, "non-contiguous", "contiguous layer groups"),
}


@pytest.mark.parametrize("which", list(REFUSALS))
def test_staged_prefill_refusals_match_jax(which, model):
    opts, xkv, msg = REFUSALS[which]
    jcfg, tcfg, np_params = model
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = params_from_numpy(np_params, torch.float32, "cpu")
    if xkv == "mla":
        fields = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=4,
                      num_q_heads=4, num_kv_heads=4, head_dim=16, model_type="deepseek_v2",
                      kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16)
        jcfg, tcfg = JaxModelConfig(**fields), ModelConfig(**fields)
        np_mla = deepseek.numpy_params(tcfg, 0)
        jparams = jax.tree.map(jnp.asarray, np_mla)
        tparams = params_from_numpy(np_mla, torch.float32, "cpu")
    kw = dict(xkv_kw(), merge_value=xkv != "mla")
    configs = {
        None: (None, None),
        "consecutive": (jax_xkv(**kw), torch_xkv(**kw)),
        "mla": (jax_xkv(**kw), torch_xkv(**kw)),
        "slerp": (jax_xkv(layer_merge_impl="slerp", **xkv_kw()),
                  torch_xkv(layer_merge_impl="slerp", **xkv_kw())),
        "non-contiguous": (_noncontiguous(JaxLayerGroup, JaxXKVConfig),
                           _noncontiguous(LayerGroup, XKVConfig)),
    }
    jx, tx = configs[xkv]
    opts = dict(dict(mode="factored", prefill_logits="last"), **opts)
    with pytest.raises(ValueError, match=msg) as jerr:
        JaxEngine(jparams, jcfg, jx, staged_prefill=True, **opts)
    with pytest.raises(ValueError, match=msg) as terr:
        InferenceEngine(tparams, tcfg, tx, staged_prefill=True, device="cpu", **opts)
    assert str(terr.value) == str(jerr.value)
