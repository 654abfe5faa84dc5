"""Ring attention (``xkv_tpu_torch/ops/ring_attention.py``) and the mesh's
point-to-point shift (``parallel.mesh.Mesh.shift``) on the CPU, against
the JAX package.

Four gloo processes on 127.0.0.1 (``tests/_torch_ranks.py``) each hold
their s / n rows of the same numpy-seeded fp32 q, k, v (b 2, hq 4, hkv 2,
s 64, hd 16: the JAX test's shapes, ``tests/test_sharding_parallel.py``),
run the ring over the data axis and join their rows. The JAX side is
``ring_attention`` on ``make_mesh(data=4, model=2)`` over the 8 virtual
devices of ``tests/conftest.py`` (plain ``jnp``). Cases: causal, a
sliding window of 20, ``causal=False`` over ``make_mesh(data=4)``, and
causal over ``make_mesh(data=2, model=2)`` with each model rank's heads.
The output is held within 1e-5 of the JAX ring's (readings up to 4.2e-7:
both sides merge the same blocks in the same order) and within 2e-4 of
the plain attention (the JAX test's limit; readings up to 3.6e-7). The causal
ring computes n(n+1)/2 of its n^2 blocks (the JAX test counts them with a
callback; the port's ``COUNTS``), a window of 20 over 16-row blocks 9, the
full mask all 16. ``Mesh.shift`` moves each block to the axis's next rank,
on both axes of a 2 x 2 mesh and with two tensors at once.
"""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_ranks import run_ranks  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-5
TOL_PLAIN = 2e-4
B, HQ, HKV, S, HD = 2, 4, 2, 64, 16
# case: (mesh (data, model), causal, window, blocks computed over every rank)
CASES = {"causal": ((4, 1), True, None, 10), "window": ((4, 1), True, 20, 9),
         "noncausal": ((4, 1), False, None, 16), "causal 2x2": ((2, 2), True, None, 6)}

RANK = """
import numpy as np
from xkv_tpu_torch.ops import ring_attention as ra
from xkv_tpu_torch.parallel.distributed import allgather_obj
from xkv_tpu_torch.parallel.mesh import make_mesh

cases = json.loads(argv[0])
meshes = {(4, 1): make_mesh(data=4, model=1), (2, 2): make_mesh(data=2, model=2)}
qkv = {k: torch.from_numpy(v) for k, v in np.load(out + "/qkv.npz").items()}
res = {}
for name, ((data, model), causal, window, _) in cases.items():
    mesh = meshes[(data, model)]
    rows = qkv["q"].shape[2] // data
    mine = {}
    for k, x in qkv.items():
        heads = x.shape[1] // model
        mine[k] = x[:, mesh.model_rank * heads:(mesh.model_rank + 1) * heads,
                    mesh.data_rank * rows:(mesh.data_rank + 1) * rows].contiguous()
    ra.COUNTS["blocks"] = 0
    got = ra.ring_attention(mine["q"], mine["k"], mine["v"], mesh=mesh, axis_name="data",
                            scale=1 / mine["q"].shape[3] ** 0.5, causal=causal, window=window)
    joined = mesh.gather(mesh.join_rows(got, dim=2), dim=1)
    res[name] = {"blocks": sum(allgather_obj(ra.COUNTS["blocks"]))}
    if rank == 0:
        np.save(out + f"/{name}.npy", joined.numpy())

# The shift: each rank's block (its rank, in two dtypes) to the next rank
# of the axis; every rank's received blocks gathered.
for label, (data, model), axis in (("data 4", (4, 1), "data"), ("data 2x2", (2, 2), "data"),
                                   ("model 2x2", (2, 2), "model")):
    mesh = meshes[(data, model)]
    a = torch.full((3,), float(rank))
    b = torch.full((2, 2), rank, dtype=torch.int64)
    ga, gb = mesh.shift([a, b], axis)
    res["shift " + label] = allgather_obj([ga.tolist(), gb.tolist(), mesh.axis_ranks(axis)])
finish(res)
"""


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(shape, dtype=np.float32)
            for k, shape in (("q", (B, HQ, S, HD)), ("k", (B, HKV, S, HD)),
                             ("v", (B, HKV, S, HD)))}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ring"))
    np.savez(os.path.join(out, "qkv.npz"), **inputs)
    res = run_ranks(RANK, 4, out, json.dumps(CASES))
    return out, res


@pytest.fixture(scope="module")
def jax_rings(inputs):
    """The JAX ring and the plain attention of every case."""
    from xkv_tpu.ops.attention import mha_reference
    from xkv_tpu.ops.ring_attention import ring_attention
    from xkv_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(data=4, model=2)
    q, k, v = (jnp.asarray(inputs[n]) for n in ("q", "k", "v"))
    scale = 1 / math.sqrt(HD)
    out = {}
    for name, (_, causal, window, _) in CASES.items():
        ring = ring_attention(q, k, v, mesh=mesh, axis_name="data", scale=scale, causal=causal,
                              window=window)
        plain = mha_reference(q, k, v, scale, causal=causal, window=window)
        out[name] = (np.asarray(ring), np.asarray(plain))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_jax(ranks, jax_rings, name):
    out, _ = ranks
    got = np.load(os.path.join(out, f"{name}.npy"))
    ring, plain = jax_rings[name]
    assert got.shape == (B, HQ, S, HD)
    assert np.abs(got - ring).max() <= TOL, np.abs(got - ring).max()
    assert np.abs(got - plain).max() <= TOL_PLAIN


@pytest.mark.parametrize("name", list(CASES))
def test_ring_skips_masked_blocks(ranks, name):
    """Causal: n(n+1)/2 of n^2 blocks per model column; a window of 20
    skips the blocks behind it too; the full mask computes every block."""
    _, res = ranks
    assert res[name]["blocks"] == CASES[name][3]


@pytest.mark.parametrize("label,ring_of", [("data 4", lambda r: [0, 1, 2, 3]),
                                           ("data 2x2", lambda r: [r % 2, r % 2 + 2]),
                                           ("model 2x2", lambda r: [r // 2 * 2, r // 2 * 2 + 1])])
def test_shift_moves_each_block_to_the_next_rank(ranks, label, ring_of):
    _, res = ranks
    for r, (a, b, axis_ranks) in enumerate(res["shift " + label]):
        assert axis_ranks == ring_of(r)
        prev = axis_ranks[(axis_ranks.index(r) - 1) % len(axis_ranks)]
        assert a == [float(prev)] * 3 and b == [[prev, prev], [prev, prev]]


# ------------------------------------------------- the sequence-parallel engine
# The JAX test's model (``tests/test_sharding_parallel.py``: 4 layers, 8 q /
# 4 kv heads of 16, hidden 128), numpy-seeded fp32 weights, xKV groups of 2
# at rank 16 / 16 with the exact SVD, fp32 factors and cache, tail 8; b = 1,
# a prompt of 2 x 16 rows, 5 new tokens.
SP_CFG = dict(num_layers=4, num_q_heads=8, num_kv_heads=4, head_dim=16, hidden_size=128,
              intermediate_size=256)
SP_MESHES = {"data 2": (2, 1), "data 2 x model 2": (2, 2)}
SP_PROMPT, SP_NEW = 32, 5

SP_RANK = """
import hashlib
import numpy as np
from xkv_tpu_torch.configs import generate_consecutive_xkv_config
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.models import llama
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import tiny_llama_config
from xkv_tpu_torch.parallel.distributed import allgather_obj
from xkv_tpu_torch.parallel.mesh import make_mesh

(data, model), cfg_kw, (n_prompt, n_new) = (json.loads(a) for a in argv)
mesh = make_mesh(data=data, model=model)
cfg = tiny_llama_config(**cfg_kw)
params = params_from_numpy(numpy_llama(cfg, 0), device="cpu")
prompt = torch.from_numpy(np.load(out + "/prompt.npy"))
xkv = generate_consecutive_xkv_config(num_layers=4, end_layer=-1, group_size=2, rank_k=16,
                                      rank_v=16, extra_kwargs={"svd_method": "exact"})
kw = dict(xkv=xkv, mode="factored", tail_max=8, cache_dtype=torch.float32,
          factor_dtype=torch.float32, device="cpu")
sp = InferenceEngine(params, cfg, mesh=mesh, sequence_parallel=True, **kw)
one = InferenceEngine(params, cfg, **kw)
res = {"tokens": allgather_obj(sp.generate(prompt, n_new).tolist()),
       "tokens_one": one.generate(prompt, n_new).tolist()}
logits, cache = sp.prefill(prompt)
# Every rank's factors are the mesh's first rank's, bitwise.
res["factors"] = allgather_obj(hashlib.sha1(b"".join(
    x.numpy().tobytes() for gf in cache.groups for x in vars(gf).values()
    if x is not None)).hexdigest())
res["cache_rows"] = [cache.prefill_len, cache.tail_k.shape[1], cache.tail_k.shape[2]]
# The K/V rows the build joins over the data axis, against one device's
# prefill of this rank's kv heads.
_, kvs = llama.prefill(sp.params, sp.shard_cfg, prompt, mesh=sp._ring_mesh,
                       sequence_parallel=True)
_, kvs_one = llama.prefill(params, cfg, prompt)
h = sp.shard_cfg.num_kv_heads
lo = mesh.model_rank * h
diffs = [[(a - b[:, lo:lo + h]).abs().max().item() for a, b in zip(p, q)]
         for p, q in zip(kvs, kvs_one)]
res["kv"] = allgather_obj(diffs)
if rank == 0:
    np.save(out + "/logits.npy", logits.numpy())
    np.save(out + "/logits_one.npy", one.prefill(prompt)[0].numpy())
finish(res)
"""


@pytest.fixture(scope="module")
def sp_prompt():
    return np.random.default_rng(23).integers(0, 256, (1, SP_PROMPT)).astype(np.int32)


@pytest.fixture(scope="module", params=list(SP_MESHES))
def sp_ranks(request, sp_prompt, tmp_path_factory):
    data, model = SP_MESHES[request.param]
    out = str(tmp_path_factory.mktemp("sp"))
    np.save(os.path.join(out, "prompt.npy"), sp_prompt.astype(np.int64))
    res = run_ranks(SP_RANK, data * model, out, json.dumps([data, model]), json.dumps(SP_CFG),
                    json.dumps([SP_PROMPT, SP_NEW]))
    return out, res


@pytest.fixture(scope="module")
def sp_jax(sp_prompt):
    """The unsharded JAX engine's tokens and prefill logits."""
    from _torch_ranks import numpy_llama
    from xkv_tpu.configs import generate_consecutive_xkv_config
    from xkv_tpu.engine import InferenceEngine
    from xkv_tpu.models.config import tiny_llama_config

    cfg = tiny_llama_config(**SP_CFG)
    params = jax.tree.map(jnp.asarray, numpy_llama(cfg, 0))
    xkv = generate_consecutive_xkv_config(num_layers=4, end_layer=-1, group_size=2,
                                          rank_k=16, rank_v=16,
                                          extra_kwargs={"svd_method": "exact"})
    eng = InferenceEngine(params, cfg, xkv=xkv, mode="factored", tail_max=8,
                          cache_dtype=jnp.float32, factor_dtype=jnp.float32,
                          donate_cache=False)
    tokens = np.asarray(eng.generate(sp_prompt, max_new_tokens=SP_NEW)).tolist()
    return tokens, np.asarray(eng.prefill(sp_prompt)[0])


def test_sequence_parallel_engine_matches_one_device(sp_ranks, sp_jax):
    """Greedy tokens on every rank equal the unsharded port engine's and
    the unsharded JAX engine's; prefill logits within 2e-4 of both (the
    JAX test's limit); every rank holds the whole cache on its kv heads
    (every prompt row, b = 1 on every data rank), the same bitwise on every
    data rank."""
    out, res = sp_ranks
    jax_tokens, jax_logits = sp_jax
    assert all(t == jax_tokens for t in res["tokens"])
    assert res["tokens_one"] == jax_tokens
    assert np.asarray(jax_tokens).shape == (1, SP_NEW)
    logits = np.load(os.path.join(out, "logits.npy"))
    assert logits.shape == jax_logits.shape == (1, SP_PROMPT, 256)
    assert np.abs(logits - jax_logits).max() <= TOL_PLAIN
    assert np.abs(logits - np.load(os.path.join(out, "logits_one.npy"))).max() <= TOL_PLAIN
    model = len(res["factors"]) // 2
    assert all(h == res["factors"][r % model] for r, h in enumerate(res["factors"]))
    assert res["cache_rows"] == [SP_PROMPT, 1, SP_CFG["num_kv_heads"] // model]


def test_sequence_parallel_joins_the_kv_rows_in_order(sp_ranks):
    """The K/V rows the build factorises, joined over the data axis: layer
    0's equal one device's bitwise (the same rows through the same
    projections), the later layers' within 1e-5 (the ring's sums)."""
    _, res = sp_ranks
    for per_rank in res["kv"]:
        assert per_rank[0] == [0.0, 0.0]
        assert max(max(layer) for layer in per_rank) <= TOL


SP_REFUSALS = {  # label: (engine options, the JAX engine's message)
    "no mesh": (dict(mesh=None), "requires a mesh with a 'data' axis"),
    "mla": (dict(mla=True), "llama-family only"),
    "staged_prefill": (dict(staged_prefill=True, prefill_logits="last"),
                       "staged_prefill is single-device"),
}


@pytest.mark.parametrize("label", list(SP_REFUSALS))
def test_sequence_parallel_refusals(label):
    """The JAX engine's refusals, with its messages, on both sides."""
    from xkv_tpu.configs import generate_consecutive_xkv_config as jax_xkv
    from xkv_tpu.engine import InferenceEngine as JaxEngine
    from xkv_tpu.models import deepseek as jds
    from xkv_tpu.models import llama as jllama
    from xkv_tpu.models.config import tiny_llama_config as jax_tiny
    from xkv_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from xkv_tpu_torch.configs import generate_consecutive_xkv_config
    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.models.config import tiny_llama_config
    from xkv_tpu_torch.parallel.mesh import Mesh

    kw, msg = SP_REFUSALS[label]
    kw = dict(kw)
    mla = kw.pop("mla", False)
    cfg_kw = dict(model_type="deepseek_v2", kv_lora_rank=16, qk_rope_head_dim=8,
                  qk_nope_head_dim=16, v_head_dim=16) if mla else {}
    mesh = kw.pop("mesh", True)
    xkv_kw = dict(num_layers=4, end_layer=-1, group_size=2, rank_k=16,
                  rank_v=None if mla else 16, merge_value=not mla)
    jcfg = jax_tiny(**cfg_kw)
    jparams = (jds if mla else jllama).init_params(jcfg, jax.random.PRNGKey(0))
    jax_kw = dict(kw, mesh=None if mesh is None else jax_make_mesh(data=2, model=1,
                                                                   devices=jax.devices()[:2]))
    with pytest.raises(ValueError, match=msg):
        JaxEngine(jparams, jcfg, jax_xkv(**xkv_kw), mode="factored", sequence_parallel=True,
                  **jax_kw)
    with pytest.raises(ValueError, match=msg):
        InferenceEngine({}, tiny_llama_config(**cfg_kw), generate_consecutive_xkv_config(
            **xkv_kw), device="cpu", sequence_parallel=True,
            mesh=None if mesh is None else Mesh(data=2, model=1, rank=0), **kw)


def test_sequence_parallel_refuses_a_prompt_the_data_axis_does_not_divide():
    """33 rows over a data axis of 2: refused before any collective, with
    the JAX ``prefill``'s message."""
    import torch
    from xkv_tpu.models import llama as jllama
    from xkv_tpu.models.config import tiny_llama_config as jax_tiny
    from xkv_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.models.config import tiny_llama_config
    from xkv_tpu_torch.models.llama import init_params
    from xkv_tpu_torch.parallel.mesh import Mesh

    prompt = np.zeros((1, 33), np.int32)
    with pytest.raises(ValueError, match="data axis size 2 must divide seq 33"):
        jllama.prefill({}, jax_tiny(), jnp.asarray(prompt), sequence_parallel=True,
                       mesh=jax_make_mesh(data=2, model=1, devices=jax.devices()[:2]))
    cfg = tiny_llama_config()
    eng = InferenceEngine(init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                                      "cpu"), cfg, mode="none", device="cpu",
                          sequence_parallel=True, mesh=Mesh(data=2, model=1, rank=0))
    with pytest.raises(ValueError, match="data axis size 2 must divide seq 33"):
        eng.prefill(prompt)
