"""The port's plain ops (xkv_tpu_torch.ops) against the JAX package's.

Same inputs, drawn with numpy from a seed, go through both. Everything runs
in fp32 on the CPU; tolerance 1e-5 absolute / 1e-5 relative (2e-5 where a
long reduction is summed in another order), which fp32 rounding of the two
frameworks' sums stays well inside.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xkv_tpu.ops import attention as jatt
from xkv_tpu.ops import rope as jrope
from xkv_tpu_torch.ops import attention as tatt
from xkv_tpu_torch.ops import rope as trope

TOL = dict(rtol=1e-5, atol=1e-5)


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("scaling", [None, {"rope_type": "llama3", "factor": 8.0,
                                            "low_freq_factor": 1.0,
                                            "high_freq_factor": 4.0,
                                            "original_max_position_embeddings": 8192}])
def test_rope_tables_and_apply(scaling):
    pos = np.arange(0, 3000, 7)
    cj, sj = jrope.rope_cos_sin(jnp.asarray(pos), 64, 500000.0, scaling)
    ct, st = trope.rope_cos_sin(torch.as_tensor(pos), 64, 500000.0, scaling)
    close(ct, cj)
    close(st, sj)
    x = rnd(0, 2, 3, len(pos), 64)
    close(trope.apply_rope(torch.as_tensor(x), ct[None], st[None]),
          jrope.apply_rope(jnp.asarray(x), cj[None], sj[None]), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [None, 9])
def test_mha_and_blockwise(window):
    b, hq, hkv, s, hd = 2, 4, 2, 40, 16
    q, k, v = rnd(1, b, hq, s, hd), rnd(2, b, hkv, s, hd), rnd(3, b, hkv, s, hd)
    scale = 1.0 / math.sqrt(hd)
    want = jatt.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                              window=window)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    close(tatt.mha_reference(tq, tk, tv, scale, window=window), want)
    close(tatt.blockwise_causal_attention(tq, tk, tv, scale, q_chunk=16, k_chunk=8,
                                          window=window), want)


def test_blockwise_offset_and_valid_rows():
    b, hq, hkv, hd = 1, 2, 1, 8
    q, k, v = rnd(4, b, hq, 6, hd), rnd(5, b, hkv, 20, hd), rnd(6, b, hkv, 20, hd)
    want = jatt.blockwise_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           0.3, q_chunk=4, k_chunk=8, q_offset=10,
                                           kv_valid=14)
    got = tatt.blockwise_causal_attention(*map(torch.as_tensor, (q, k, v)), 0.3,
                                          q_chunk=4, k_chunk=8, q_offset=10, kv_valid=14)
    close(got, want)


def _factors(seed, b, s_p, r, m, int8):
    us, vt = rnd(seed, b, s_p, r), rnd(seed + 1, b, r, m, scale=0.3)
    if not int8:
        return us, vt, None
    from xkv_tpu.compress.quant import quantize_k_factors

    qf = quantize_k_factors(jnp.asarray(us), jnp.asarray(vt))
    return np.asarray(qf.us_q), np.asarray(qf.vt_q), np.asarray(qf.out_scale)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_factored_decode_reference(int8, masked):
    b, hq, hkv, hd, s_p, rk, rv, ql = 2, 4, 2, 16, 24, 12, 10, 2
    m = hkv * hd
    q = rnd(10, b, hq, ql, hd)
    k_us, k_vt, k_scale = _factors(11, b, s_p, rk, m, int8)
    v_us, v_vt = rnd(13, b, s_p, rv), rnd(14, b, rv, m, scale=0.3)
    v_scale = np.abs(rnd(15, b, 1, rv)) + 0.5 if int8 else None
    cos, sin = jrope.rope_cos_sin(jnp.arange(s_p), hd)
    kw = {}
    if masked:
        kw = dict(valid_len=np.array([20, 24]), valid_lo=np.array([3, 0]))
    scale = 1.0 / math.sqrt(hd)
    opt = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    want = jatt.factored_decode_attention_xla(
        jnp.asarray(q), jnp.asarray(k_us), jnp.asarray(k_vt), jnp.asarray(v_us),
        jnp.asarray(v_vt), cos, sin, scale, hkv, k_scale_slice=opt(k_scale),
        v_rank_scale=opt(v_scale), **{k: jnp.asarray(v) for k, v in kw.items()})
    topt = lambda x: None if x is None else torch.as_tensor(np.asarray(x))  # noqa: E731
    got = tatt.factored_decode_attention_ref(
        *map(topt, (q, k_us, k_vt, v_us, v_vt, cos, sin)), scale, hkv,
        k_scale_slice=topt(k_scale), v_rank_scale=topt(v_scale),
        **{k: torch.as_tensor(v) for k, v in kw.items()})
    close(got.out, want.out, rtol=2e-5, atol=2e-5)
    close(got.lse, want.lse, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_rankspace_decode_reference(int8):
    b, hq, hkv, hd, s_p, rk, rv, ql = 2, 4, 2, 16, 24, 12, 10, 3
    m = hkv * hd
    q = rnd(20, b, hq, ql, hd)
    k_us, k_vt, k_scale = _factors(21, b, s_p, rk, m, int8)
    v_us, v_vt = rnd(23, b, s_p, rv), rnd(24, b, rv, m, scale=0.3)
    v_scale = np.abs(rnd(25, b, 1, rv)) + 0.5 if int8 else None
    lens, lo = np.array([17, 24]), np.array([0, 5])
    opt = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    topt = lambda x: None if x is None else torch.as_tensor(x)  # noqa: E731
    want = jatt.rankspace_decode_attention_xla(
        *map(jnp.asarray, (q, k_us, k_vt, v_us, v_vt)), 0.25, hkv,
        k_scale_slice=opt(k_scale), v_rank_scale=opt(v_scale),
        valid_len=jnp.asarray(lens), valid_lo=jnp.asarray(lo))
    got = tatt.rankspace_decode_attention_ref(
        *map(torch.as_tensor, (q, k_us, k_vt, v_us, v_vt)), 0.25, hkv,
        k_scale_slice=topt(k_scale), v_rank_scale=topt(v_scale),
        valid_len=torch.as_tensor(lens), valid_lo=torch.as_tensor(lo))
    close(got.out, want.out, rtol=2e-5, atol=2e-5)
    close(got.lse, want.lse, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("valid", ["shared", "per_query", "window"])
def test_dense_decode_reference(valid):
    b, hq, hkv, hd, s, ql = 2, 4, 2, 8, 16, 3
    q, k, v = rnd(30, b, hq, ql, hd), rnd(31, b, hkv, s, hd), rnd(32, b, hkv, s, hd)
    kw = {"shared": dict(valid_len=np.array([5, 16])),
          "per_query": dict(valid_len=np.array([[3, 4, 5], [9, 10, 11]])),
          "window": dict(valid_len=np.array([12, 16]), valid_lo=np.array([2, 7]))}[valid]
    want = jatt.dense_decode_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3,
        **{n: jnp.asarray(a) for n, a in kw.items()})
    got = tatt.dense_decode_attention_ref(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), 0.3,
        **{n: torch.as_tensor(a) for n, a in kw.items()})
    close(got.out, want.out)
    close(got.lse, want.lse)


def test_merge_partials_and_reconstruct():
    parts_np = [(rnd(40 + i, 2, 4, 3, 8), rnd(50 + i, 2, 4, 3) * 3) for i in range(3)]
    want = jatt.merge_partials(*[jatt.PartialAttention(jnp.asarray(o), jnp.asarray(l))
                                 for o, l in parts_np])
    got = tatt.merge_partials(*[tatt.PartialAttention(torch.as_tensor(o), torch.as_tensor(l))
                                for o, l in parts_np])
    close(got, want)
    us, vt = rnd(60, 2, 10, 6), rnd(61, 2, 6, 32)
    close(tatt.reconstruct_group_heads(torch.as_tensor(us), torch.as_tensor(vt), 4),
          jatt.reconstruct_group_heads(jnp.asarray(us), jnp.asarray(vt), 4))
