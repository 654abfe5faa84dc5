"""Sparse top-k decode of the port against the JAX package.

  * ``chunk_bounds`` (pre and post), ``chunk_bound_scores``,
    ``adaptive_hot_chunks`` in fp32 to 1e-5 (the rotations and sums run in
    another order; -inf and the 3e38 sentinels exactly), and
    ``select_topk_chunks`` as id sets, ties included: n_select 1, a
    window, and n_select above the live count.
  * ``sparse_factored_decode_attention_ref`` and
    ``sparse_rankspace_decode_attention_ref`` against their XLA
    counterparts in fp32 (1e-4).
  * The plain versions of K4 and K5 (the wrappers on CPU tensors, fp32
    factors) against the Pallas kernels ``sparse_rankspace_decode_attention``
    and ``sparse_lowrank_decode_attention`` in interpret mode (1e-4); K5
    also at head size 64.
  * The engine, fp32 weights and cache on the in-repo checkpoint: greedy
    tokens equal the JAX engine's in sparse pre, sparse post, sparse post
    with ``sparse_layers`` and with ``sparse_topk_max``, and in pre and post
    at ``sparse_block`` 24; full coverage
    equals dense factored decode; the JAX golden's sparse runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import (
    CKPT,
    GOLDEN,
    GOLDEN_SPEC,
    golden_run,
    jax_step,
    prompt_tokens,
    xkv_pair,
)
from _torch_threads import one_thread  # noqa: F401
from xkv_tpu.engine import InferenceEngine as JaxEngine
from xkv_tpu.engine.compression import chunk_bounds as jax_chunk_bounds
from xkv_tpu.models.ckpt import load_checkpoint as jax_load
from xkv_tpu.ops import attention as ja
from xkv_tpu.ops.pallas.lowrank_attention import sparse_lowrank_decode_attention as jax_k5
from xkv_tpu.ops.pallas.rankspace_attention import sparse_rankspace_decode_attention as jax_k4
from xkv_tpu.ops.rope import rope_cos_sin
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.engine.compression import chunk_bounds
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.ops import attention as ta
from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
from xkv_tpu_torch.ops.kernels import rankspace_attention as k2


# The JAX references, compiled whole: run op by op they spend seconds
# compiling every op.
jax_bound_scores = jax.jit(ja.chunk_bound_scores, static_argnums=3,
                           static_argnames="block")
jax_select = jax.jit(ja.select_topk_chunks, static_argnums=(3, 4), static_argnames="block")
jax_sparse_factored = jax.jit(ja.sparse_factored_decode_attention_xla,
                              static_argnums=(8, 9), static_argnames=("block", "pre_rotated"))
jax_sparse_rankspace = jax.jit(ja.sparse_rankspace_decode_attention_xla,
                               static_argnums=(6, 7), static_argnames="block")


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(x):
    return None if x is None else torch.as_tensor(np.array(x))


def j(x):
    return None if x is None else jnp.asarray(x)


@pytest.fixture(scope="module")
def ckpt():
    return jax_load(CKPT)


@pytest.mark.parametrize("rotate", [True, False], ids=["pre", "post"])
def test_chunk_bounds_match_jax(rotate):
    b, hkv, hd, s, blk = 2, 2, 16, 21, 8  # 3 chunks, the last partial
    k_mat = rnd(0, b, s, hkv * hd)
    cos, sin = rope_cos_sin(jnp.arange(s), hd, theta=10000.0) if rotate else (None, None)
    want = jax_chunk_bounds(j(k_mat), cos, sin, blk, hkv)
    got = chunk_bounds(t(k_mat), t(cos), t(sin), blk, hkv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


# (n_select, valid_len, win_lo) over 6 chunks of 8 rows
SELECT_CASES = [(1, None, None), (3, None, None), (2, [30, 17], None), (3, None, [20, 9]),
                (5, [20, 17], None), (4, None, [33, 41])]


@pytest.mark.parametrize("n_select,lens,lo", SELECT_CASES)
def test_selection_matches_jax(n_select, lens, lo):
    b, hq, hkv, hd, nc, blk = 2, 4, 2, 16, 6, 8
    q = rnd(1, b, hq, 1, hd)
    kmin, kmax = jax_chunk_bounds(j(rnd(2, b, nc * blk, hkv * hd)), None, None, blk, hkv)
    kmin, kmax = np.asarray(kmin), np.asarray(kmax)
    kw_j = dict(valid_len=j(lens), block=blk, win_lo=j(lo))
    kw_t = dict(valid_len=t(lens), block=blk, win_lo=t(lo))
    want = jax_bound_scores(j(q), j(kmin), j(kmax), hkv, **kw_j)
    got = ta.chunk_bound_scores(t(q), t(kmin), t(kmax), hkv, **kw_t)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)
    np.testing.assert_array_equal(ta.adaptive_hot_chunks(got[2], got[1], 0.5).numpy(),
                                  np.asarray(ja.adaptive_hot_chunks(want[2], want[1], 0.5)))
    ids_t = ta.select_topk_chunks(t(q), t(kmin), t(kmax), n_select, hkv, **kw_t)
    ids_j = jax_select(j(q), j(kmin), j(kmax), n_select, hkv, **kw_j)
    assert ids_t.dtype == torch.int32
    for row_t, row_j in zip(ids_t.numpy(), np.asarray(ids_j)):
        assert sorted(row_t.tolist()) == sorted(row_j.tolist())


def _factors(seed, b, s_p, rk, rv, m):
    return dict(k_us=rnd(seed, b, s_p, rk), k_vt=rnd(seed + 1, b, rk, m, scale=0.3),
                v_us=rnd(seed + 2, b, s_p, rv), v_vt=rnd(seed + 3, b, rv, m, scale=0.3))


# chunk ids of 4 chunks of 8 rows over 30 rows (chunk 3 is ragged)
SPARSE_CASES = [([[3, 0], [1, 2]], None, None), ([[2, 0, 3], [3, 1, 0]], [30, 21], [0, 5])]


@pytest.mark.parametrize("ids,lens,lo", SPARSE_CASES)
@pytest.mark.parametrize("pre_rotated", [False, True])
def test_sparse_factored_ref_matches_xla(ids, lens, lo, pre_rotated):
    b, hq, hkv, hd, s_p = 2, 4, 2, 16, 30
    f = _factors(3, b, s_p, 12, 10, hkv * hd)
    q = rnd(4, b, hq, 1, hd)
    cos, sin = rope_cos_sin(jnp.arange(s_p), hd, theta=10000.0)
    args = [f["k_us"], f["k_vt"], f["v_us"], f["v_vt"], cos, sin, ids]
    want = jax_sparse_factored(
        j(q), *map(j, args), 0.25, hkv, block=8, valid_len=j(lens),
        pre_rotated=pre_rotated, valid_lo=j(lo))
    got = ta.sparse_factored_decode_attention_ref(
        t(q), *map(t, args), 0.25, hkv, block=8, valid_len=t(lens), pre_rotated=pre_rotated,
        valid_lo=t(lo))
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.lse.numpy(), np.asarray(want.lse), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ids,lens,lo", SPARSE_CASES)
@pytest.mark.parametrize("mixed", [False, True])
def test_sparse_rankspace_ref_matches_xla(ids, lens, lo, mixed):
    from tests.test_torch_int4 import _mixed_factors

    b, hq, hkv, hd, s_p = 2, 4, 2, 16, 30
    if mixed:
        f = _mixed_factors(5, b, s_p, 16, 48, 24, 72, hkv * hd)
        names = dict(k_scale_slice="k_scale", v_rank_scale="v_scale", k_us4="k_us4",
                     k_vt4_slice="k_vt4", k_scale4_slice="k_scale4", v_us4="v_us4")
    else:
        f, names = _factors(5, b, s_p, 12, 10, hkv * hd), {}
    q = rnd(6, b, hq, 1, hd)
    args = [f["k_us"], f["k_vt"], f["v_us"], f["v_vt"], ids]
    want = jax_sparse_rankspace(
        j(q), *map(j, args), 0.25, hkv, block=8, valid_len=j(lens), valid_lo=j(lo),
        **{k: j(f[v]) for k, v in names.items()})
    got = ta.sparse_rankspace_decode_attention_ref(
        t(q), *map(t, args), 0.25, hkv, block=8, valid_len=t(lens), valid_lo=t(lo),
        **{k: t(f[v]) for k, v in names.items()})
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.lse.numpy(), np.asarray(want.lse), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ids,lens,lo", SPARSE_CASES)
def test_k4_k5_plain_match_pallas_interpret(ids, lens, lo):
    b, hq, hkv, hd, s_p, blk = 2, 4, 2, 16, 30, 8
    f = _factors(7, b, s_p, 12, 10, hkv * hd)
    q_pre = rnd(8, b, hq, 1, hd)
    ids_np = np.asarray(ids, np.int32)
    fac = [f["k_us"], f["k_vt"], f["v_us"], f["v_vt"]]
    kw = dict(scale=0.25, num_kv_heads=hkv, block=blk)
    # K4 (post-RoPE factors in rank space).
    want = jax_k4(j(q_pre), *map(j, fac), j(ids_np), j(lens), win_lo=j(lo), interpret=True, **kw)
    before = k2.sparse_launches
    got = k2.sparse_rankspace_decode_attention(t(q_pre), *map(t, fac), t(ids_np), t(lens),
                                               win_lo=t(lo), **kw)
    assert k2.sparse_launches == before  # the plain version is not a launch
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    # K5 (pre-RoPE factors, relative-angle RoPE at query position s_p + 2).
    cos_p, sin_p = rope_cos_sin(jnp.arange(s_p), hd, theta=10000.0)
    cos_t, sin_t = rope_cos_sin(jnp.full((b,), s_p + 2), hd, theta=10000.0)
    trig = [cos_p, sin_p, cos_t, sin_t]
    want = jax_k5(j(q_pre), *map(j, fac), *trig, j(ids_np), j(lens), win_lo=j(lo),
                  interpret=True, **kw)
    before = k3.sparse_launches
    got = k3.sparse_lowrank_decode_attention(t(q_pre), *map(t, fac), *map(t, trig), t(ids_np),
                                             t(lens), win_lo=t(lo), **kw)
    assert k3.sparse_launches == before
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


# Head size 64 (Llama-3.2-1B's), rk 64, rv 32, chunks of 16 rows over 72
# rows (chunk 4 is ragged): (ids, valid_len, win_lo).
K5_HD64_CASES = [([[4, 0], [1, 3]], None, None), ([[2, -1, 4], [0, 1, 3]], [72, 50], [9, 0])]


@pytest.mark.parametrize("ids,lens,lo", K5_HD64_CASES)
def test_k5_plain_matches_pallas_interpret_hd64(ids, lens, lo):
    b, hq, hkv, hd, s_p, blk = 2, 4, 2, 64, 72, 16
    f = _factors(9, b, s_p, 64, 32, hkv * hd)
    q_pre = rnd(10, b, hq, 1, hd)
    ids_np = np.asarray(ids, np.int32)
    fac = [f["k_us"], f["k_vt"], f["v_us"], f["v_vt"]]
    cos_p, sin_p = rope_cos_sin(jnp.arange(s_p), hd, theta=10000.0)
    cos_t, sin_t = rope_cos_sin(jnp.full((b,), s_p + 2), hd, theta=10000.0)
    trig = [cos_p, sin_p, cos_t, sin_t]
    kw = dict(scale=0.125, num_kv_heads=hkv, block=blk)
    want = jax_k5(j(q_pre), *map(j, fac), *trig, j(ids_np), j(lens), win_lo=j(lo),
                  interpret=True, **kw)
    before = k3.sparse_launches
    got = k3.sparse_lowrank_decode_attention(t(q_pre), *map(t, fac), *map(t, trig), t(ids_np),
                                             t(lens), win_lo=t(lo), **kw)
    assert k3.sparse_launches == before
    assert got[0].shape == (b, hq, 1, hd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def _engines(ckpt, rope, **sparse):
    np_params, cfg = ckpt
    jx, tx = xkv_pair(rope)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), np_params)
    je = JaxEngine(jp, cfg, jx, mode="factored", tail_max=16, cache_dtype=jnp.float32,
                   factor_dtype=jnp.float32, **sparse)
    te = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), cfg, tx,
                         mode="factored", tail_max=16, cache_dtype=torch.float32,
                         factor_dtype=torch.float32, device="cpu", **sparse)
    return je, te


ENGINE_CASES = {
    "pre": ("pre", dict(sparse_topk=2, sparse_block=16)),
    "post": ("post", dict(sparse_topk=2, sparse_block=16)),
    "post-layers": ("post", dict(sparse_topk=2, sparse_block=16, sparse_layers=(0, 2, 3))),
    "post-adaptive": ("post", dict(sparse_topk=2, sparse_block=8, sparse_topk_max=5)),
    # A chunk width that is not a power of two (3 chunks of the 72 rows):
    # on a card K4 and K5 walk each chunk as a 64-key block masked at 24.
    "pre-24": ("pre", dict(sparse_topk=2, sparse_block=24)),
    "post-24": ("post", dict(sparse_topk=2, sparse_block=24)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_sparse_greedy_tokens_match_jax_fp32(ckpt, case):
    """Greedy tokens (fp32 weights, cache and factors) equal the JAX
    engine's exactly, token for token."""
    rope, sparse = ENGINE_CASES[case]
    je, te = _engines(ckpt, rope, **sparse)
    prompt = prompt_tokens(72, ckpt[1].vocab_size, seed=21)
    want, _ = golden_run(jax_step(je), je.prefill, prompt, 5)
    np.testing.assert_array_equal(te.generate(prompt, 5).numpy(), want[None])


def test_adaptive_budget_step_matches_one_branch(ckpt):
    """With sparse_topk_max a layer's sparse attention equals the low or
    the high budget's exactly (mirror of test_sparse.py). The budget is
    chosen per layer, so the check is per layer, over queries that pick
    each branch (a zero query ties every bound: all chunks are hot)."""
    from xkv_tpu_torch.models.llama import _post_rope_factored_part

    np_params, cfg = ckpt
    _, tx = xkv_pair("post")
    eng = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), cfg, tx,
                          mode="factored", cache_dtype=torch.float32,
                          factor_dtype=torch.float32, device="cpu", sparse_topk=2,
                          sparse_block=8)
    _, cache = eng.prefill(prompt_tokens(72, cfg.vocab_size, seed=22))
    gf = cache.groups[0]
    picked = set()
    for seed in range(4):
        q = t(rnd(30 + seed, 1, cfg.num_q_heads, 1, cfg.head_dim, scale=min(seed, 1)))

        def part(n, n_max=None):
            return _post_rope_factored_part(q, gf, 1, cfg, 0.088, None, None, True, n, 8,
                                            n_max, 0.5)

        ad, lo, hi = part(2, 5), part(2), part(5)
        for name, ref in (("lo", lo), ("hi", hi)):
            if torch.equal(ad.out, ref.out) and torch.equal(ad.lse, ref.lse):
                picked.add(name)
                break
        else:
            raise AssertionError(f"seed {seed}: the adaptive step matches neither budget")
    assert picked == {"lo", "hi"}


@pytest.mark.parametrize("rope", ["pre", "post"])
def test_sparse_full_coverage_matches_dense(ckpt, rope):
    """Every chunk selected: the sparse path reads every row, so greedy
    tokens equal dense factored decode (mirror of test_sparse.py)."""
    np_params, cfg = ckpt
    _, tx = xkv_pair(rope)
    params = params_from_numpy(np_params, torch.float32, "cpu")
    kw = dict(mode="factored", tail_max=16, cache_dtype=torch.float32,
              factor_dtype=torch.float32, device="cpu")
    prompt = prompt_tokens(40, cfg.vocab_size, seed=23)
    dense = InferenceEngine(params, cfg, tx, **kw).generate(prompt, 6)
    sparse = InferenceEngine(params, cfg, tx, sparse_topk=5, sparse_block=8, **kw)
    np.testing.assert_array_equal(sparse.generate(prompt, 6).numpy(), dense.numpy())


def test_refactorize_keeps_chunk_width(ckpt):
    """Folds re-bound the keys in sparse_block-row chunks even when the
    folded length is not a multiple of it (64 -> 68 -> 72 rows: 5 chunks
    of 16). The JAX package re-derives the width as ceil(s_p / n_chunks)
    and its next decode step refuses the bounds (ROADMAP section 3)."""
    np_params, cfg = ckpt
    _, tx = xkv_pair("post")
    eng = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), cfg, tx,
                          mode="factored", tail_max=4, cache_dtype=torch.float32,
                          factor_dtype=torch.float32, device="cpu", sparse_topk=2,
                          sparse_block=16)
    prompt = prompt_tokens(64, cfg.vocab_size, seed=24)
    _, cache = eng.prefill(prompt)
    for fold in range(2):
        for i in range(4):
            _, cache = eng.decode_step(cache, [[1]], cache.prefill_len + i)
        cache = eng.refactorize(cache)
        assert cache.groups[0].k_cmin.shape[1] == -(-cache.prefill_len // 16)
    assert eng.generate(prompt, 10).shape == (1, 10)


def test_sparse_validation(ckpt):
    np_params, cfg = ckpt
    _, tx = xkv_pair("post")
    params = params_from_numpy(np_params, torch.float32, "cpu")
    kw = dict(device="cpu")
    with pytest.raises(ValueError, match="requires sparse_topk"):
        InferenceEngine(params, cfg, tx, mode="factored", sparse_topk_max=8, **kw)
    with pytest.raises(ValueError, match="must exceed"):
        InferenceEngine(params, cfg, tx, mode="factored", sparse_topk=4, sparse_topk_max=4,
                        **kw)
    with pytest.raises(ValueError, match="requires mode='factored'"):
        InferenceEngine(params, cfg, tx, mode="fake", sparse_topk=4, **kw)


@pytest.mark.parametrize("run", ["sparse_pre", "sparse_post"])
def test_sparse_golden_reproduced_by_port(ckpt, run):
    """The golden's sparse runs (JAX engine, fp32, top-2 of 64-row chunks)
    teacher-forced through the port on the CPU: the same tokens, logits to
    1e-3 (as for the golden's dense runs)."""
    np_params, cfg = ckpt
    gold = np.load(GOLDEN)
    _, tx = xkv_pair(run.split("_")[1], GOLDEN_SPEC["group_size"], GOLDEN_SPEC["rank_k"],
                     GOLDEN_SPEC["rank_v"])
    eng = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), cfg, tx,
                          mode="factored", tail_max=GOLDEN_SPEC["steps"],
                          cache_dtype=torch.float32, factor_dtype=torch.float32,
                          device="cpu", sparse_topk=2, sparse_block=64)
    toks, logits = golden_run(lambda c, tk, p: eng.decode_step(c, [[tk]], p), eng.prefill,
                              gold["prompt"], GOLDEN_SPEC["steps"])
    np.testing.assert_array_equal(toks, gold[f"tokens_{run}"])
    np.testing.assert_allclose(logits, gold[f"logits_{run}"], rtol=1e-3, atol=1e-3)
