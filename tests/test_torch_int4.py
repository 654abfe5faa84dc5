"""Mixed int8+int4 factors (``factor_dtype="int4"``) of the port against
the JAX package.

  * Quantisation: the packed nibbles, the eo permutation and every int8
    and int4 output of ``quantize_{k,v}_factors_mixed4`` equal JAX's
    exactly on the same fp32 inputs (both round x / scale half to even in
    fp32); the scales agree to fp32 rounding (rtol 1e-6) and the
    dequantised matrices to 1e-5.
  * ``int4_rank_hi`` equals JAX's over ranks 8-1024, refusals included.
  * The mixed ``rankspace_decode_attention_ref`` against
    ``rankspace_decode_attention_xla`` in fp32 (1e-4: the sums run in
    another order), and K6's wrapper on CPU tensors (its plain version)
    against the Pallas kernel ``rankspace_decode_attention(k_us4=...)`` in
    interpret mode: both round q_emb and P to bf16, against another
    maximum (running or final), so 1e-2 of values O(1).
  * The engine, fp32 weights and cache on the in-repo checkpoint: greedy
    tokens equal the JAX engine's in int4 post, int4 post + sparse and
    across refactorisations.
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
from xkv_tpu.compress import quant as jq
from xkv_tpu.engine import InferenceEngine as JaxEngine
from xkv_tpu.engine.compression import int4_rank_hi as jax_int4_rank_hi
from xkv_tpu.models.ckpt import load_checkpoint as jax_load
from xkv_tpu.ops.attention import rankspace_decode_attention_xla
from xkv_tpu.ops.pallas.rankspace_attention import rankspace_decode_attention as jax_k6
from xkv_tpu_torch.compress import quant as tq
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.engine.compression import int4_rank_hi
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.ops.attention import rankspace_decode_attention_ref
from xkv_tpu_torch.ops.kernels import rankspace_attention as k2


# The JAX references, compiled whole: run op by op they spend seconds
# compiling every op.
jax_quantize_k = jax.jit(jq.quantize_k_factors_mixed4, static_argnums=2)
jax_quantize_v = jax.jit(jq.quantize_v_factors_mixed4, static_argnums=2)
jax_rankspace_xla = jax.jit(rankspace_decode_attention_xla, static_argnums=(5, 6))


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(x):
    return None if x is None else torch.as_tensor(np.array(x))


def j(x):
    return None if x is None else jnp.asarray(x)


@pytest.fixture(scope="module")
def ckpt():
    return jax_load(CKPT)


def test_pack_unpack_and_eo_perm_match_jax():
    vals = np.random.default_rng(0).integers(-7, 8, size=(2, 5, 12)).astype(np.int32)
    packed = tq.pack_int4_pairs(t(vals))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_int4_pairs(j(vals))))
    for got, want in zip(tq.unpack_int4_pairs(packed), jq.unpack_int4_pairs(j(packed.numpy()))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ev, od = tq.unpack_int4_pairs(packed)
    np.testing.assert_array_equal(ev.numpy(), vals[..., ::2])
    np.testing.assert_array_equal(od.numpy(), vals[..., 1::2])
    for r_lo in (2, 8, 48, 256):
        np.testing.assert_array_equal(tq.eo_perm(r_lo).numpy(), np.asarray(jq.eo_perm(r_lo)))


@pytest.mark.parametrize("r_hi", [16, 24])
def test_quantize_mixed4_matches_jax(r_hi):
    us, vt = rnd(1, 2, 40, 64), rnd(2, 2, 64, 48, scale=0.3)
    got_k = tq.quantize_k_factors_mixed4(t(us), t(vt), r_hi)
    want_k = jax_quantize_k(j(us), j(vt), r_hi)
    for name in ("us8", "us4p", "vt8", "vt4"):
        np.testing.assert_array_equal(getattr(got_k, name).numpy(),
                                      np.asarray(getattr(want_k, name)), err_msg=name)
    for name in ("out_scale", "scale4"):
        np.testing.assert_allclose(getattr(got_k, name).numpy(),
                                   np.asarray(getattr(want_k, name)), rtol=1e-6)
    np.testing.assert_allclose(tq.dequantize_k_mixed4(got_k).numpy(),
                               np.asarray(jq.dequantize_k_mixed4(want_k)), atol=1e-5)
    got_v = tq.quantize_v_factors_mixed4(t(us), t(vt), r_hi)
    want_v = jax_quantize_v(j(us), j(vt), r_hi)
    for name in ("us8", "us4p"):
        np.testing.assert_array_equal(getattr(got_v, name).numpy(),
                                      np.asarray(getattr(want_v, name)), err_msg=name)
    np.testing.assert_allclose(got_v.rank_scale.numpy(), np.asarray(want_v.rank_scale),
                               rtol=1e-6)
    np.testing.assert_array_equal(got_v.vt.float().numpy(),
                                  np.asarray(want_v.vt.astype(jnp.float32)))
    np.testing.assert_allclose(tq.dequantize_v_mixed4(got_v).numpy(),
                               np.asarray(jq.dequantize_v_mixed4(want_v)), atol=1e-5)


def test_int4_rank_hi_matches_jax():
    for rank in range(8, 1025, 8):
        for frac in (0.1, 0.25, 0.5, 0.6, 0.9):
            try:
                want = jax_int4_rank_hi(rank, frac)
            except ValueError:
                with pytest.raises(ValueError, match="lane-alignment"):
                    int4_rank_hi(rank, frac)
                continue
            assert int4_rank_hi(rank, frac) == want, (rank, frac)
    with pytest.raises(ValueError):
        int4_rank_hi(512, 0.6)


def _mixed_factors(seed, b, s_p, r8k, r4k, r8v, r4v, m):
    """Mixed factors from the JAX quantiser, as numpy."""
    qk = jax_quantize_k(j(rnd(seed, b, s_p, r8k + r4k)),
                        j(rnd(seed + 1, b, r8k + r4k, m, scale=0.3)), r8k)
    qv = jax_quantize_v(j(rnd(seed + 2, b, s_p, r8v + r4v)),
                        j(rnd(seed + 3, b, r8v + r4v, m, scale=0.3)), r8v)
    return dict(k_us=np.asarray(qk.us8), k_us4=np.asarray(qk.us4p), k_vt=np.asarray(qk.vt8),
                k_vt4=np.asarray(qk.vt4), k_scale=np.asarray(qk.out_scale),
                k_scale4=np.asarray(qk.scale4), v_us=np.asarray(qv.us8),
                v_us4=np.asarray(qv.us4p), v_scale=np.asarray(qv.rank_scale),
                v_vt=np.asarray(qv.vt.astype(jnp.float32)))


MIXED_CASES = [(1, None, None), (2, [30, 21], None), (1, None, [5, 0])]


@pytest.mark.parametrize("ql,lens,lo", MIXED_CASES)
def test_mixed_rankspace_ref_matches_xla(ql, lens, lo):
    b, hq, hkv, hd, s_p = 2, 4, 2, 16, 32
    f = _mixed_factors(3, b, s_p, 16, 48, 24, 72, hkv * hd)
    q = rnd(4, b, hq, ql, hd)
    kw = dict(k_scale_slice="k_scale", v_rank_scale="v_scale", k_us4="k_us4",
              k_vt4_slice="k_vt4", k_scale4_slice="k_scale4", v_us4="v_us4")
    want = jax_rankspace_xla(
        j(q), j(f["k_us"]), j(f["k_vt"]), j(f["v_us"]), j(f["v_vt"]), 0.25, hkv,
        valid_len=j(lens), valid_lo=j(lo), **{k: j(f[v]) for k, v in kw.items()})
    got = rankspace_decode_attention_ref(
        t(q), t(f["k_us"]), t(f["k_vt"]), t(f["v_us"]), t(f["v_vt"]), 0.25, hkv,
        valid_len=t(lens), valid_lo=t(lo), **{k: t(f[v]) for k, v in kw.items()})
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.lse.numpy(), np.asarray(want.lse), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ql,lens,lo", MIXED_CASES)
def test_k6_plain_matches_pallas_interpret(ql, lens, lo):
    b, hq, hkv, hd, s_p = 2, 4, 2, 16, 32
    f = _mixed_factors(5, b, s_p, 16, 48, 24, 72, hkv * hd)
    q = rnd(6, b, hq, ql, hd)
    kw = dict(k_scale_slice="k_scale", v_rank_scale="v_scale", k_us4="k_us4",
              k_vt4_slice="k_vt4", k_scale4_slice="k_scale4", v_us4="v_us4")
    want_out, want_lse = jax_k6(
        j(q), j(f["k_us"]), j(f["k_vt"]), j(f["v_us"]), j(f["v_vt"]), j(lens),
        win_lo=j(lo), scale=0.25, num_kv_heads=hkv, block_s=16, interpret=True,
        **{k: j(f[v]) for k, v in kw.items()})
    before = k2.mixed_launches
    got_out, got_lse = k2.rankspace_decode_attention(
        t(q), t(f["k_us"]), t(f["k_vt"]), t(f["v_us"]), t(f["v_vt"]), t(lens),
        win_lo=t(lo), scale=0.25, num_kv_heads=hkv, **{k: t(f[v]) for k, v in kw.items()})
    assert k2.mixed_launches == before  # the plain version is not a launch
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=1e-2, atol=1e-2)


def _engines(ckpt, tail_max=16, **sparse):
    np_params, cfg = ckpt
    jx, tx = xkv_pair("post")
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), np_params)
    je = JaxEngine(jp, cfg, jx, mode="factored", tail_max=tail_max, cache_dtype=jnp.float32,
                   factor_dtype="int4", **sparse)
    te = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), cfg, tx,
                         mode="factored", tail_max=tail_max, cache_dtype=torch.float32,
                         factor_dtype="int4", device="cpu", **sparse)
    return je, te


@pytest.mark.parametrize("sparse", [{}, {"sparse_topk": 2, "sparse_block": 16}],
                         ids=["int4", "int4-sparse"])
def test_int4_greedy_tokens_match_jax_fp32(ckpt, sparse):
    je, te = _engines(ckpt, **sparse)
    prompt = prompt_tokens(72, ckpt[1].vocab_size, seed=11)
    want, _ = golden_run(jax_step(je), je.prefill, prompt, 5)
    got = te.generate(prompt, 5).numpy()
    np.testing.assert_array_equal(got, want[None])


def test_int4_and_sparse_across_refactorize_match_jax(ckpt):
    """Tail folds re-quantise into the mixed format (same rank split) and
    recompute the chunk bounds; greedy tokens stay the JAX engine's
    (mirror of test_rope_post.py::test_int4_refactorize_runs and
    test_sparse.py::test_sparse_survives_refactorization)."""
    je, te = _engines(ckpt, tail_max=8, sparse_topk=2, sparse_block=8)
    prompt = prompt_tokens(64, ckpt[1].vocab_size, seed=12)
    want = np.asarray(je.generate(prompt, 20))
    got = te.generate(prompt, 20).numpy()
    np.testing.assert_array_equal(got, want)


def test_int4_validation(ckpt):
    np_params, cfg = ckpt
    _, pre = xkv_pair("pre")
    params = params_from_numpy(np_params, torch.float32, "cpu")
    with pytest.raises(ValueError, match="rope_mode='post'"):
        InferenceEngine(params, cfg, pre, mode="factored", factor_dtype="int4", device="cpu")
    _, post = xkv_pair("post")
    # sparse x int4 composes: construction succeeds.
    InferenceEngine(params, cfg, post, mode="factored", factor_dtype="int4", sparse_topk=4,
                    device="cpu")


def test_int4_golden_reproduced_by_port(ckpt):
    """The golden's int4 post run (JAX engine, fp32) teacher-forced through
    the port on the CPU: the same tokens; logits to 3e-2, as for int8 in
    test_torch_engine.py (a factor entry within fp32 noise of a rounding
    boundary quantises to the neighbouring integer in one framework)."""
    np_params, cfg = ckpt
    gold = np.load(GOLDEN)
    _, tx = xkv_pair("post", GOLDEN_SPEC["group_size"], GOLDEN_SPEC["rank_k"],
                     GOLDEN_SPEC["rank_v"])
    eng = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), cfg, tx,
                          mode="factored", tail_max=GOLDEN_SPEC["steps"],
                          cache_dtype=torch.float32, factor_dtype="int4", device="cpu")
    toks, logits = golden_run(lambda c, tk, p: eng.decode_step(c, [[tk]], p), eng.prefill,
                              gold["prompt"], GOLDEN_SPEC["steps"])
    np.testing.assert_array_equal(toks, gold["tokens_int4_post"])
    np.testing.assert_allclose(logits, gold["logits_int4_post"], rtol=3e-2, atol=3e-2)
