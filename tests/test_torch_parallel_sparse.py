"""Sparse top-k and mixed int8+int4 factors under tensor parallelism
(``InferenceEngine(mesh=...)``, ``models/llama.py``'s decode dispatch) on
the CPU, against the JAX package.

Op level, in this process: each rank's shard of a post-RoPE (K4's plain
version) and a pre-RoPE (K5's) factored group, its selection per shard
over its own heads' Quest bounds (``llama._factored_part`` on the rank's
``shard_group_factors``), joined over both ranks, against the JAX
``sparse_rankspace_decode_attention_tp`` / ``sparse_lowrank_decode_
attention_tp`` on a (data 1, model 2) mesh of the virtual CPU devices
(``tests/conftest.py``; Pallas in interpret mode), within 1e-5 (fp32), at
a budget below full coverage, with and without a ``win_lo``. The
selection of sparse x int4 over every head, each rank's bound maxima
joined by a max over the model axis (``head_max``), against JAX's
``select_topk_chunks`` over all heads: equal ids.

Engine level, two gloo processes (``tests/_torch_ranks.py``): the 4-layer
tiny model (4 q / 2 kv heads: one kv head a rank; numpy-seeded fp32
weights, one xKV-4 group of rank 16 / 16, exact SVD, fp32 factors and
cache, a 40-token prompt in 8-row chunks, ``tail_max`` 4, 10 tokens: two
refolds):
  * sparse top-k at full coverage (pre and post) against the unsharded
    engine in non-sparse mode: tokens equal (the counterpart of
    ``tests/test_sharding.py::test_sparse_tp_full_coverage_matches_
    unsharded``);
  * top-2 (below full coverage, per-shard selection) against the JAX mesh
    engine's golden (``xkv_tpu_torch/testdata/tp_sparse_golden.npz``,
    written by ``python tests/test_torch_parallel_sparse.py``): tokens
    equal, prefill logits and the first step's within 1e-5;
  * int4 post, and int4 sparse-mixed (top-2 in layers 0-2, layer 3 exact;
    global selection), against the unsharded engine: tokens equal.
Every sharded step that one device can take over the same factors (all
but the per-shard selections) is held within 1e-5 of one device over the
cache joined from both ranks (``gather_cache``), the first step and the
first after a refold; against the unsharded engine's own cache within
1e-5 with fp32 factors and within ``TOL_INT4`` with int4 ones: the two
sides' SVD inputs differ by ~1e-7 (the sharded model sums each ``wo`` /
``w_down`` product in two halves), which moves single int4 elements by a
rounding unit (1/7 of their column's range) at the build, and a refold
factorises matrices rebuilt from those elements: the first step read
3.9e-4 and 1.9e-4 (int4, int4 sparse-mixed), the first after a refold
2.8e-3 and 7.8e-3, with tokens equal; the limits are twice the largest.
"""

import functools
import os
import sys

if __name__ == "__main__":  # the golden's writer: the 8 virtual CPU devices
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_ranks import numpy_llama, run_ranks  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401
from xkv_tpu.ops.attention import select_topk_chunks as jax_select  # noqa: E402
from xkv_tpu.ops.pallas.lowrank_attention import (  # noqa: E402
    sparse_lowrank_decode_attention_tp as jax_k5_tp,
)
from xkv_tpu.ops.pallas.rankspace_attention import (  # noqa: E402
    sparse_rankspace_decode_attention_tp as jax_k4_tp,
)
from xkv_tpu.ops.rope import rope_cos_sin as jax_rope  # noqa: E402
from xkv_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from xkv_tpu_torch.cache import GroupFactors  # noqa: E402
from xkv_tpu_torch.models import llama  # noqa: E402
from xkv_tpu_torch.models.config import tiny_llama_config  # noqa: E402
from xkv_tpu_torch.ops.attention import select_topk_chunks  # noqa: E402
from xkv_tpu_torch.ops.rope import rope_cos_sin  # noqa: E402
from xkv_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from xkv_tpu_torch.parallel.sharding import shard_group_factors  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "xkv_tpu_torch", "testdata", "tp_sparse_golden.npz")
TOL = 1e-5
# Int4 factors, against the unsharded engine's own cache, by step: twice
# the largest readings (module docstring).
TOL_INT4 = {"first": 2 * 3.9e-4, "refold": 2 * 7.8e-3}
B, HQ, HKV, HD, S_P, RK, RV, BLK = 2, 4, 2, 16, 40, 16, 16, 8
# Per-shard op cases: (n_select, valid_len, win_lo).
OP_CASES = [(2, None, None), (3, [40, 29], [9, 0])]
MODEL = dict(num_layers=4, num_q_heads=4, num_kv_heads=2)
PROMPT, NEW, TAIL = 40, 10, 4
# Engine runs: label -> (rope mode, factor dtype, sparse_topk, sparse_layers,
# reference): "dense" the unsharded engine without sparse options, "same"
# the unsharded engine with them, "golden" the JAX mesh engine's golden.
RUNS = {
    "post sparse full": ("post", "fp32", 8, None, "dense"),
    "pre sparse full": ("pre", "fp32", 8, None, "dense"),
    "post sparse top-2": ("post", "fp32", 2, None, "golden"),
    "pre sparse top-2": ("pre", "fp32", 2, None, "golden"),
    "post int4": ("post", "int4", None, None, "same"),
    "post int4 sparse-mixed": ("post", "int4", 2, [0, 1, 2], "same"),
}


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])


def _group(seed):
    """A one-layer group's factors and Quest bounds (numpy, fp32)."""
    m = HKV * HD
    return dict(k_us=rnd(seed, B, S_P, RK), k_vt=rnd(seed + 1, B, RK, m, scale=0.3),
                v_us=rnd(seed + 2, B, S_P, RV), v_vt=rnd(seed + 3, B, RV, m, scale=0.3),
                k_cmin=rnd(seed + 4, B, 5, m) - 1.0, k_cmax=rnd(seed + 5, B, 5, m) + 1.0)


def _per_shard(f, q_pre, q, cos, sin, cos_p, sin_p, rope_post, n_sel, lens, lo):
    """Each rank's ``_factored_part`` on its shard, joined over the heads."""
    whole = GroupFactors(**{k: torch.from_numpy(v) for k, v in f.items()})
    cfg = tiny_llama_config(num_q_heads=HQ // 2, num_kv_heads=HKV // 2, head_dim=HD)
    outs, lses = [], []
    for r in range(2):
        gf = shard_group_factors(whole, 1, Mesh(data=1, model=2, rank=r))
        heads = slice(r * HQ // 2, (r + 1) * HQ // 2)
        part = llama._factored_part(
            torch.from_numpy(q_pre[:, heads]), torch.from_numpy(q[:, heads]), cos, sin, gf, 0, 0,
            cfg, rope_post, cos_p, sin_p, 1.0 / np.sqrt(HD),
            None if lens is None else torch.tensor(lens, dtype=torch.int32),
            None if lo is None else torch.tensor(lo, dtype=torch.int32),
            sparse_select=n_sel, sparse_block=BLK)
        outs.append(part.out)
        lses.append(part.lse)
    return torch.cat(outs, dim=1).numpy(), torch.cat(lses, dim=1).numpy()


@pytest.mark.parametrize("n_sel,lens,lo", OP_CASES, ids=["top2", "top3-lens-win"])
def test_per_shard_sparse_post_matches_jax_tp(jmesh, n_sel, lens, lo):
    f = _group(11)
    q = rnd(12, B, HQ, 1, HD)
    kw = dict(n_select=n_sel, scale=1.0 / np.sqrt(HD), num_kv_heads=HKV, block=BLK,
              interpret=True)
    want = jax.jit(functools.partial(jax_k4_tp, jmesh, **kw))(
        q, f["k_us"], f["k_vt"], f["v_us"], f["v_vt"], f["k_cmin"], f["k_cmax"],
        lengths=None if lens is None else jnp.asarray(lens, jnp.int32),
        win_lo=None if lo is None else jnp.asarray(lo, jnp.int32))
    got = _per_shard(f, q, q, None, None, None, None, True, n_sel, lens, lo)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w).reshape(g.shape), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_sel,lens,lo", OP_CASES, ids=["top2", "top3-lens-win"])
def test_per_shard_sparse_pre_matches_jax_tp(jmesh, n_sel, lens, lo):
    f = _group(21)
    q_pre = rnd(22, B, HQ, 1, HD)
    pos = S_P + 3
    jcos_p, jsin_p = jax_rope(jnp.arange(S_P), HD, theta=10000.0)
    jcos_t, jsin_t = jax_rope(jnp.full((B,), pos), HD, theta=10000.0)
    cos_p, sin_p = rope_cos_sin(torch.arange(S_P), HD, 10000.0)
    cos, sin = rope_cos_sin(torch.tensor([[pos]]), HD, 10000.0)
    q = llama.apply_rope(torch.from_numpy(q_pre), cos, sin).numpy()
    kw = dict(n_select=n_sel, scale=1.0 / np.sqrt(HD), num_kv_heads=HKV, block=BLK,
              interpret=True)
    want = jax.jit(functools.partial(jax_k5_tp, jmesh, **kw))(
        q_pre, q, f["k_us"], f["k_vt"], f["v_us"], f["v_vt"], jcos_p, jsin_p, jcos_t, jsin_t,
        f["k_cmin"], f["k_cmax"],
        lengths=None if lens is None else jnp.asarray(lens, jnp.int32),
        win_lo=None if lo is None else jnp.asarray(lo, jnp.int32))
    got = _per_shard(f, q_pre, q, cos, sin, cos_p, sin_p, False, n_sel, lens, lo)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w).reshape(g.shape), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_sel,lens,lo", [(3, None, None), (3, [40, 29], [9, 0])],
                         ids=["top3", "top3-lens-win"])
def test_int4_global_selection_matches_jax(n_sel, lens, lo):
    """Each rank's per-chunk maxima over its own heads, joined by a max
    over the model axis before the top-k: JAX's selection over all heads."""
    f = _group(31)
    q = rnd(32, B, HQ, 1, HD)
    lens_j = None if lens is None else jnp.asarray(lens, jnp.int32)
    lo_j = None if lo is None else jnp.asarray(lo, jnp.int32)
    want = np.asarray(jax_select(q, f["k_cmin"], f["k_cmax"], n_select=n_sel, num_kv_heads=HKV,
                                 valid_len=lens_j, block=BLK, win_lo=lo_j))
    whole = GroupFactors(k_cmin=torch.from_numpy(f["k_cmin"]),
                         k_cmax=torch.from_numpy(f["k_cmax"]))
    shards = [shard_group_factors(whole, 1, Mesh(data=1, model=2, rank=r)) for r in range(2)]
    kw = dict(n_select=n_sel, num_kv_heads=HKV // 2, block=BLK,
              valid_len=None if lens is None else torch.tensor(lens, dtype=torch.int32),
              win_lo=None if lo is None else torch.tensor(lo, dtype=torch.int32))
    maxima = []  # each rank's maxima over its own heads, as all_max receives them
    for r, gf in enumerate(shards):
        q_r = torch.from_numpy(q[:, r * HQ // 2:(r + 1) * HQ // 2])
        select_topk_chunks(q_r, gf.k_cmin, gf.k_cmax, head_max=lambda sc: maxima.append(sc) or sc,
                           **kw)
    joined = torch.maximum(*maxima)
    for r, gf in enumerate(shards):
        q_r = torch.from_numpy(q[:, r * HQ // 2:(r + 1) * HQ // 2])
        ids = select_topk_chunks(q_r, gf.k_cmin, gf.k_cmax, head_max=lambda sc: joined, **kw)
        np.testing.assert_array_equal(ids.numpy(), want)
    # Each rank alone chooses by its own heads, which is not JAX's choice.
    alone = [select_topk_chunks(torch.from_numpy(q[:, r * 2:(r + 1) * 2]), gf.k_cmin,
                                gf.k_cmax, **kw).numpy() for r, gf in enumerate(shards)]
    assert any((a != want).any() for a in alone)


RANK = """
import numpy as np
from xkv_tpu_torch.configs import generate_consecutive_xkv_config
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import tiny_llama_config
from xkv_tpu_torch.parallel.mesh import make_mesh
from xkv_tpu_torch.parallel.sharding import gather_cache

runs, model, (n_prompt, n_new, tail) = (json.loads(a) for a in argv)
mesh = make_mesh(data=1, model=2)
cfg = tiny_llama_config(**model)
params = params_from_numpy(numpy_llama(cfg, 0), device="cpu")
prompt = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, n_prompt)))
probe = torch.full((2, 3), float(rank)) + torch.arange(3.0) * (1 - 2 * rank)
res = {"all_max": mesh.all_max(probe).tolist()}

def diff(a, b):
    return (a - b).abs().max().item()

for label, (rope, fd, topk, layers, ref) in runs.items():
    xkv = generate_consecutive_xkv_config(
        num_layers=4, end_layer=-1, group_size=4, rank_k=16, rank_v=16,
        extra_kwargs={"rope_mode": rope, "svd_method": "exact"})
    kw = dict(xkv=xkv, mode="factored", tail_max=tail, cache_dtype=torch.float32,
              factor_dtype="int4" if fd == "int4" else torch.float32, device="cpu")
    sp = {} if topk is None else dict(sparse_topk=topk, sparse_block=8, sparse_layers=layers)
    tp = InferenceEngine(params, cfg, mesh=mesh, **kw, **sp)
    one = InferenceEngine(params, cfg, **kw, **({} if ref == "dense" else sp))
    row = {"tokens": tp.generate(prompt, n_new).tolist(),
           "tokens_one": one.generate(prompt, n_new).tolist()}
    lo, co = one.prefill(prompt)
    lt, ct = tp.prefill(prompt)
    row["prefill"] = diff(lo, lt)
    row["prefill_logits"] = lt[0, -1].tolist()
    toks = row["tokens"][0]
    pos = n_prompt
    for name in ("first", "refold"):
        i0 = tail if name == "refold" else 0
        if name == "refold":
            for i in range(1, tail + 1):
                t = torch.tensor([[toks[i - 1]]])
                _, co = one.decode_step(co, t, pos + i - 1)
                _, ct = tp.decode_step(ct, t, pos + i - 1)
            co, ct = one.refactorize(co), tp.refactorize(ct)
        t = torch.tensor([[toks[i0]]])
        joined = gather_cache(ct, [4], mesh)
        s_one, _ = one.decode_step(co, t, pos + i0)
        s_join, _ = one.decode_step(joined, t, pos + i0)
        s_tp, _ = tp.decode_step(ct, t, pos + i0)
        row[name] = [diff(s_tp, s_join), diff(s_tp, s_one)]
        row[name + "_logits"] = s_tp[0, -1].tolist()
    gf = ct.groups[0]
    row["shard"] = [gf.k_vt.shape[-1], gf.k_cmin.shape[-1] if gf.k_cmin is not None else None,
                    gf.k_vt4.shape[-1] if gf.k_vt4 is not None else None]
    res[label] = row
finish(res)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    import json

    out = str(tmp_path_factory.mktemp("tp_sparse"))
    return run_ranks(RANK, 2, out, json.dumps(RUNS), json.dumps(MODEL),
                     json.dumps([PROMPT, NEW, TAIL]))


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_all_max_over_the_model_axis(two_ranks):
    # rank 0 holds [0, 1, 2], rank 1 [1, 0, -1] in each row
    assert two_ranks["all_max"] == [[1.0, 1.0, 2.0]] * 2


@pytest.mark.parametrize("label", list(RUNS))
def test_sparse_and_int4_tp_engine(two_ranks, golden, label):
    row = two_ranks[label]
    rope, fd, topk, layers, ref = RUNS[label]
    assert len(row["tokens"][0]) == NEW
    if ref == "golden":
        key = label.replace(" ", "_")
        np.testing.assert_array_equal(row["tokens"], golden[key + "_tokens"])
        for name in ("prefill", "first"):
            np.testing.assert_allclose(row[name + "_logits"], golden[f"{key}_{name}"],
                                       rtol=TOL, atol=TOL)
    else:
        assert row["tokens"] == row["tokens_one"]
        assert row["prefill"] <= TOL
        for name in ("first", "refold"):
            joined, one = row[name]
            assert joined <= TOL, (name, joined)
            own = TOL_INT4[name] if fd == "int4" else TOL
            assert one <= own, (name, one)
    # a rank holds 1 of 2 kv heads: 4 layers x 16 columns of every column field
    k_vt, cmin, vt4 = row["shard"]
    assert k_vt == 4 * 16
    assert cmin == (None if topk is None else 4 * 16)
    assert vt4 == (4 * 16 if fd == "int4" else None)


def write_golden() -> None:
    """The JAX mesh engine (pallas, interpret mode on the CPU) over the
    engine runs' model, top-2 pre and post: tokens, prefill logits and the
    first step's logits (fed the first token)."""
    from xkv_tpu.configs import generate_consecutive_xkv_config as jax_xkv
    from xkv_tpu.engine import InferenceEngine as JaxEngine
    from xkv_tpu.models.config import tiny_llama_config as jax_tiny

    cfg = jax_tiny(**MODEL)
    params = jax.tree.map(jnp.asarray, numpy_llama(cfg, 0))
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, PROMPT))
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    out = {}
    for label, (rope, fd, topk, layers, ref) in RUNS.items():
        if ref != "golden":
            continue
        xkv = jax_xkv(num_layers=4, end_layer=-1, group_size=4, rank_k=16, rank_v=16,
                      extra_kwargs={"rope_mode": rope, "svd_method": "exact"})
        eng = JaxEngine(params, cfg, xkv=xkv, mode="factored", tail_max=TAIL,
                        cache_dtype=jnp.float32, factor_dtype=jnp.float32,
                        attention_impl="pallas", sparse_topk=topk, sparse_block=8, mesh=mesh,
                        donate_cache=False)
        key = label.replace(" ", "_")
        tokens = np.asarray(eng.generate(prompt, NEW))
        logits, cache = eng.prefill(prompt)
        step, _ = eng.decode_step(cache, tokens[:, :1], PROMPT)
        out[key + "_tokens"] = tokens
        out[key + "_prefill"] = np.asarray(logits)[0, -1]
        out[key + "_first"] = np.asarray(step)[0, -1]
        print(label, tokens.tolist())
    np.savez(GOLDEN, **out)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_golden()
