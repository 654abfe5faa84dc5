"""Prompt-cache persistence (``xkv_tpu_torch/engine/cache_io.py``) against
the JAX package's ``xkv_tpu/engine/cache_io.py``, on the CPU.

A cache saved and loaded by the port decodes bitwise as before (fp32,
bf16, int8 and int4 Llama caches with a non-empty tail, an MLA cache). A
file written by the JAX ``save_cache`` (fp32, int8, bf16) loads in the
port and decodes bitwise as the same JAX cache carried across by
``cache_from_numpy``. A port file (fp32, int8) holds the JAX leaves
bit for bit, and the JAX decode over it agrees with the JAX decode over
the JAX engine's own cache to the parity tolerances of
``tests/test_torch_engine.py`` (1e-3 fp32, 3e-2 int8: the two packages'
factorisations of one prompt differ by their rounding). One fault of the
reference is pinned: the JAX ``load_cache`` cannot read a bf16 leaf, its
own files' included (numpy stores bfloat16 as 2-byte void, which JAX does
not cast), so it reads neither package's bf16 caches nor their int8 ones
(whose V basis is bf16); the port reads such leaves by their bits. Refusals are held by message
against the JAX ``load_cache``'s. Compact MiniCache (SLERP) caches pass
both ways bit for bit, and a compact file is refused by a dense SLERP
cache's structure.

Model: ``tiny_llama_config`` with JAX's init (numpy, seed 0), xKV groups
of 2 at rank 24, exact SVD; MLA: the dense config of
``tests/test_torch_deepseek.py``.
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tests.test_torch_deepseek import CFG as MLA_CFG
from xkv_tpu.configs import generate_consecutive_xkv_config as jax_xkv
from xkv_tpu.engine import InferenceEngine as JaxEngine
from xkv_tpu.engine.cache_io import load_cache as jax_load_cache
from xkv_tpu.engine.cache_io import save_cache as jax_save_cache
from xkv_tpu.models import llama as jllama
from xkv_tpu.models.config import tiny_llama_config as jax_tiny
from xkv_tpu_torch.cache import GroupFactors, cache_from_numpy
from xkv_tpu_torch.configs import generate_consecutive_xkv_config as torch_xkv
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.engine.cache_io import cache_leaves, load_cache, save_cache
from xkv_tpu_torch.models import deepseek
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import ModelConfig, tiny_llama_config

JAX_DT = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "int8": "int8", "int4": "int4"}
TORCH_DT = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": "int8", "int4": "int4"}
# fp32 and int8 first-step logits of the two packages
# (tests/test_torch_engine.py).
PARITY_TOL = {"fp32": 1e-3, "int8": 3e-2}
PROMPT = np.random.default_rng(3).integers(0, 256, size=(1, 20)).astype(np.int32)


@pytest.fixture(scope="module")
def llama_params():
    return jax.tree.map(np.asarray, jllama.init_params(jax_tiny(), jax.random.PRNGKey(0),
                                                       dtype=jnp.float32))


def xkv_kw(rope="pre", rank=24, frac=0.5):
    return dict(group_size=2, rank_k=rank, rank_v=rank, num_layers=4, end_layer=3,
                extra_kwargs={"svd_method": "exact", "rope_mode": rope,
                              "int4_rank_frac": frac})


def cache_dtype(factor):
    return "bf16" if factor == "bf16" else "fp32"


def port_engine(np_params, factor, rope="pre"):
    return InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"),
                           tiny_llama_config(), torch_xkv(**xkv_kw(rope)), mode="factored",
                           tail_max=8, cache_dtype=TORCH_DT[cache_dtype(factor)],
                           factor_dtype=TORCH_DT[factor], device="cpu")


def jax_engine(np_params, factor):
    return JaxEngine(jax.tree.map(jnp.asarray, np_params), jax_tiny(), jax_xkv(**xkv_kw()),
                     mode="factored", tail_max=8, cache_dtype=JAX_DT[cache_dtype(factor)],
                     factor_dtype=JAX_DT[factor], donate_cache=False)


def bits(x):
    """A leaf of either package as numpy; bf16 as its bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def next_logits(engine, cache, tok=5, pos=20):
    logits, _ = engine.decode_step(cache, [[tok]], pos)
    return logits


def test_jax_leaf_order_is_the_ports(llama_params, tmp_path):
    """A JAX cache's leaves, as ``jax.tree_util`` orders them, are the
    port's ``cache_leaves`` of the same cache carried across: same
    shapes, same values (int8 factors, empty and dense fields mixed)."""
    _, jcache = jax_engine(llama_params, "int8").prefill(PROMPT)
    jleaves = jax.tree_util.tree_leaves(jcache)
    tleaves = cache_leaves(cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu"))
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_array_equal(bits(a), bits(b))


ROUND_TRIPS = {"fp32": ("fp32", "pre"), "bf16": ("bf16", "pre"), "int8": ("int8", "pre"),
               "int4": ("int4", "post")}


@pytest.mark.parametrize("case", list(ROUND_TRIPS) + ["mla"])
def test_round_trip_decodes_bitwise(case, llama_params, tmp_path):
    """Prefill, two decode steps (a tail of 2 rows), save, load into the
    same cache's structure: every leaf and the next step's logits equal
    bitwise, ``tail_count`` 2, the metadata back."""
    if case == "mla":
        cfg = ModelConfig(**MLA_CFG)
        eng = InferenceEngine(params_from_numpy(deepseek.numpy_params(cfg, 0), torch.float32,
                                                "cpu"), cfg,
                              torch_xkv(group_size=2, rank_k=24, rank_v=None, num_layers=4,
                                        end_layer=3, merge_value=False,
                                        extra_kwargs={"svd_method": "exact"}),
                              mode="factored", tail_max=8, cache_dtype=torch.float32,
                              factor_dtype=torch.float32, device="cpu")
    else:
        eng = port_engine(llama_params, *ROUND_TRIPS[case])
    _, cache = eng.prefill(PROMPT % 128)
    for i in range(2):
        _, cache = eng.decode_step(cache, [[7 + i]], 20 + i)
    path = str(tmp_path / "cache")
    save_cache(cache, path, metadata={"prompt_len": 20})
    loaded, meta = load_cache(path, cache)
    assert meta == {"prompt_len": 20} and loaded.tail_count == 2
    for a, b in zip(cache_leaves(cache), cache_leaves(loaded)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(next_logits(eng, loaded, pos=22), next_logits(eng, cache, pos=22))


@pytest.mark.parametrize("factor", ["fp32", "int8", "bf16"])
def test_jax_file_loads_in_port(factor, llama_params, tmp_path):
    """A file of the JAX ``save_cache`` loads in the port and decodes
    bitwise as ``cache_from_numpy`` of the same JAX cache."""
    _, jcache = jax_engine(llama_params, factor).prefill(PROMPT)
    path = str(tmp_path / "jax_cache")
    jax_save_cache(jcache, path, metadata={"from": "jax"})
    eng = port_engine(llama_params, factor)
    _, like = eng.prefill(PROMPT)
    loaded, meta = load_cache(path, like)
    assert meta == {"from": "jax"}
    carried = cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    for a, b in zip(cache_leaves(carried), cache_leaves(loaded)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(next_logits(eng, loaded), next_logits(eng, carried))


def jax_read_by_bits(path, like):
    """A cache file read for the JAX package the way the port reads it:
    ``like``'s tree, each leaf cast to its dtype, bf16 leaves by their
    bits (what the JAX ``load_cache`` cannot do)."""
    with open(path + ".json") as f:
        dtypes = json.load(f)["dtypes"]
    refs, treedef = jax.tree_util.tree_flatten(like)
    with np.load(path + ".npz") as data:
        leaves = [jnp.asarray(data[f"leaf_{i}"].view(ml_dtypes.bfloat16)) if d == "bfloat16"
                  else jnp.asarray(data[f"leaf_{i}"], dtype=ref.dtype)
                  for i, (d, ref) in enumerate(zip(dtypes, refs))]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.mark.parametrize("factor", ["fp32", "int8"])
def test_port_file_loads_in_jax(factor, llama_params, tmp_path):
    """A port file loads in the JAX ``load_cache`` leaf for leaf; its JAX
    decode agrees with the JAX decode over the JAX engine's own cache of
    the same prompt within the parity tolerance. An int8 cache keeps V's
    basis in bf16 (``v_vt``) in both packages, so the JAX ``load_cache``
    refuses it (the bf16 fault, ROADMAP queue 3); it is read for JAX by
    its bits on the test side (``jax_read_by_bits``)."""
    _, cache = port_engine(llama_params, factor).prefill(PROMPT)
    path = str(tmp_path / "port_cache")
    save_cache(cache, path)
    je = jax_engine(llama_params, factor)
    _, jcache = je.prefill(PROMPT)
    if factor == "int8":
        with pytest.raises(ValueError):
            jax_load_cache(path, jcache)
        loaded = jax_read_by_bits(path, jcache)
    else:
        loaded, meta = jax_load_cache(path, jcache)
        assert meta == {}
    for a, b in zip(jax.tree_util.tree_leaves(loaded), cache_leaves(cache)):
        np.testing.assert_array_equal(bits(a), bits(b))
    tok, pos = jnp.asarray([[5]], jnp.int32), jnp.asarray(20, jnp.int32)
    got, _ = je.decode_step(loaded, tok, pos)
    want, _ = je.decode_step(jcache, tok, pos)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=PARITY_TOL[factor],
                               rtol=0)


def test_jax_load_cache_cannot_read_bf16(llama_params, tmp_path):
    """Reference fault (ROADMAP queue 3): the JAX ``save_cache`` writes a
    bf16 leaf as numpy's 2-byte void, and its ``load_cache`` raises
    ``ValueError`` casting it back, on its own file. The port loads that
    file, bit for bit."""
    _, jcache = jax_engine(llama_params, "bf16").prefill(PROMPT)
    path = str(tmp_path / "bf16")
    jax_save_cache(jcache, path)
    with np.load(path + ".npz") as data:
        assert data["leaf_0"].dtype.str == "|V2"
    with pytest.raises(ValueError):
        jax_load_cache(path, jcache)
    _, like = port_engine(llama_params, "bf16").prefill(PROMPT)
    loaded, _ = load_cache(path, like)
    for a, b in zip(jax.tree_util.tree_leaves(jcache), cache_leaves(loaded)):
        np.testing.assert_array_equal(bits(a), bits(b))


REFUSALS = ["format version", "leaf count", "leaf shape"]


@pytest.mark.parametrize("refusal", REFUSALS)
def test_load_refusals_match_jax(refusal, llama_params, tmp_path):
    """A file and a ``like`` that do not fit, refused with the JAX
    messages: another format version, another leaf count (V left
    unfactored), another shape (a 24-token prompt)."""
    _, jcache = jax_engine(llama_params, "fp32").prefill(PROMPT)
    eng = port_engine(llama_params, "fp32")
    _, cache = eng.prefill(PROMPT)
    path = str(tmp_path / "cache")
    save_cache(cache, path)
    jlike, like = jcache, cache
    if refusal == "format version":
        with open(path + ".json") as f:
            sidecar = json.load(f)
        sidecar["format_version"] = 2
        with open(path + ".json", "w") as f:
            json.dump(sidecar, f)
        msg = "unsupported cache format 2"
    elif refusal == "leaf count":
        groups = tuple(GroupFactors(**{**vars(g), "v_us": None, "v_vt": None})
                       for g in cache.groups)
        like = type(cache)(**{**vars(cache), "groups": groups})
        jlike = jcache.replace(groups=tuple(g.replace(v_us=None, v_vt=None)
                                            for g in jcache.groups))
        msg = "cache structure mismatch"
    else:
        longer = np.concatenate([PROMPT, PROMPT[:, :4]], axis=1)
        _, like = eng.prefill(longer)
        _, jlike = jax_engine(llama_params, "fp32").prefill(longer)
        msg = "leaf 0 shape mismatch"
    with pytest.raises(ValueError, match=msg):
        jax_load_cache(path, jlike)
    with pytest.raises(ValueError, match=msg):
        load_cache(path, like)


def slerp_engines(np_params, compact):
    """The JAX and port engines of one SLERP config (pairs, gamma 0.05),
    compact at keep 0.25 or dense, fp32."""
    kw = dict(layer_merge_impl="slerp", group_size=2, num_layers=4, end_layer=3,
              slerp_gamma=0.05, rank_k=None, rank_v=None,
              extra_kwargs={"slerp_compact": compact, "slerp_keep_frac": 0.25})
    return (JaxEngine(jax.tree.map(jnp.asarray, np_params), jax_tiny(), jax_xkv(**kw),
                      mode="factored", tail_max=8, cache_dtype=jnp.float32,
                      donate_cache=False),
            InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"),
                            tiny_llama_config(), torch_xkv(**kw), mode="factored", tail_max=8,
                            cache_dtype=torch.float32, device="cpu"))


def test_compact_slerp_round_trip_both_ways(llama_params, tmp_path):
    """Compact MiniCache storage (``SlerpCompact``: four leaves at each
    side's field) passes both ways in fp32: a JAX file loads in the port
    bit for bit as ``cache_from_numpy`` of the same cache and decodes
    bitwise as it; a port file (two decode steps in its tail) loads in
    the JAX ``load_cache`` leaf for leaf, and back in the port decodes
    bitwise as the cache it was saved from."""
    je, te = slerp_engines(llama_params, compact=True)
    _, jcache = je.prefill(PROMPT)
    jpath = str(tmp_path / "jax_compact")
    jax_save_cache(jcache, jpath)
    _, like = te.prefill(PROMPT)
    assert like.groups[0].slerp_k is not None
    loaded, _ = load_cache(jpath, like)
    carried = cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    jleaves = jax.tree_util.tree_leaves(jcache)
    assert len(jleaves) == len(cache_leaves(loaded)) == len(cache_leaves(carried))
    for a, b, c in zip(jleaves, cache_leaves(carried), cache_leaves(loaded)):
        np.testing.assert_array_equal(bits(a), bits(c))
        assert b.dtype == c.dtype and torch.equal(b, c)
    assert torch.equal(next_logits(te, loaded), next_logits(te, carried))

    cache = like
    for i in range(2):
        _, cache = te.decode_step(cache, [[7 + i]], 20 + i)
    tpath = str(tmp_path / "port_compact")
    save_cache(cache, tpath)
    jloaded, _ = jax_load_cache(tpath, jcache)
    for a, b in zip(jax.tree_util.tree_leaves(jloaded), cache_leaves(cache)):
        np.testing.assert_array_equal(bits(a), bits(b))
    back, _ = load_cache(tpath, cache)
    assert back.tail_count == 2
    assert torch.equal(next_logits(te, back, pos=22), next_logits(te, cache, pos=22))


def test_slerp_storage_refused(llama_params, tmp_path):
    """A compact SLERP file loaded into a dense SLERP cache's structure
    (the same groups stored dense: other leaves) is refused with the JAX
    message, by both packages."""
    je, te = slerp_engines(llama_params, compact=True)
    _, cache = te.prefill(PROMPT)
    path = str(tmp_path / "c")
    save_cache(cache, path)
    jdense, tdense = slerp_engines(llama_params, compact=False)
    _, jlike = jdense.prefill(PROMPT)
    _, like = tdense.prefill(PROMPT)
    for load, ref in ((jax_load_cache, jlike), (load_cache, like)):
        with pytest.raises(ValueError, match="cache structure mismatch"):
            load(path, ref)
