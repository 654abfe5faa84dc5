"""The port's compression (SVD, int8 factors, build_cache, refactorize)
against the JAX package's.

Singular vectors may differ in sign between the two frameworks, so the
tests compare reconstructions ``us @ vt``, never raw factors. Inputs are
numpy arrays from a seed. Tolerances: fp32 reconstructions 1e-4 (LAPACK
calls and sums in another order); bf16 factors 2e-2 of the largest entry
(one bf16 rounding of each factor); int8 factors 2e-2 of the largest entry
(one int8 step is 1/127 of a column's range, and a value within fp32 noise
of a half-integer quantises to the neighbouring integer in one framework;
a sign flip of a singular pair flips its integers exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xkv_tpu.compress import quant as jquant
from xkv_tpu.compress import svd as jsvd
from xkv_tpu.configs import generate_consecutive_xkv_config as jax_xkv
from xkv_tpu.engine import compression as jcomp
from xkv_tpu.models.config import tiny_llama_config as jax_tiny
from xkv_tpu.ops.rope import rope_cos_sin as jax_rope
from xkv_tpu_torch.compress import quant as tquant
from xkv_tpu_torch.compress import svd as tsvd
from xkv_tpu_torch.configs import generate_consecutive_xkv_config as torch_xkv
from xkv_tpu_torch.engine import compression as tcomp
from xkv_tpu_torch.models.config import tiny_llama_config as torch_tiny
from xkv_tpu_torch.ops.rope import rope_cos_sin as torch_rope


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def low_rank(seed, b, s, m, r):
    """Rank-r matrices plus a little noise: well-separated singular values."""
    return (np.einsum("bsr,brm->bsm", rnd(seed, b, s, r), rnd(seed + 1, b, r, m))
            + rnd(seed + 2, b, s, m, scale=1e-2)).astype(np.float32)


def test_truncated_svd_reconstruction():
    mat = low_rank(0, 2, 40, 24, 6)
    want = jsvd.reconstruct(jsvd.truncated_svd(jnp.asarray(mat), 6))
    got = tsvd.reconstruct(tsvd.truncated_svd(torch.as_tensor(mat), 6))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_randomized_svd_with_the_jax_sketch():
    mat = low_rank(3, 2, 50, 32, 5)
    rank, oversample, seed = 5, 4, 11
    want = jsvd.reconstruct(jsvd.randomized_svd(jnp.asarray(mat), rank,
                                                oversample=oversample, n_iter=2, seed=seed))
    omega = jax.random.normal(jax.random.PRNGKey(seed), (32, rank + oversample), jnp.float32)
    got = tsvd.reconstruct(tsvd.randomized_svd(
        torch.as_tensor(mat), rank, oversample=oversample, n_iter=2,
        omega=torch.as_tensor(np.array(omega))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # The port's own draw (a seeded torch.Generator) finds the same subspace.
    own = tsvd.reconstruct(tsvd.randomized_svd(torch.as_tensor(mat), rank,
                                               oversample=oversample, seed=seed))
    np.testing.assert_allclose(own.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)


def test_int8_quantisation_matches_jax():
    us, vt = rnd(5, 2, 30, 8), rnd(6, 2, 8, 40, scale=0.2)
    jk = jquant.quantize_k_factors(jnp.asarray(us), jnp.asarray(vt))
    tk = tquant.quantize_k_factors(torch.as_tensor(us), torch.as_tensor(vt))
    np.testing.assert_array_equal(tk.us_q.numpy(), np.asarray(jk.us_q))
    np.testing.assert_array_equal(tk.vt_q.numpy(), np.asarray(jk.vt_q))
    np.testing.assert_allclose(tquant.dequantize_k(tk).numpy(),
                               np.asarray(jquant.dequantize_k(jk)), rtol=1e-6, atol=1e-6)
    jv = jquant.quantize_v_factors(jnp.asarray(us), jnp.asarray(vt))
    tv = tquant.quantize_v_factors(torch.as_tensor(us), torch.as_tensor(vt))
    np.testing.assert_array_equal(tv.us_q.numpy(), np.asarray(jv.us_q))
    np.testing.assert_allclose(tquant.dequantize_v(tv).numpy(),
                               np.asarray(jquant.dequantize_v(jv)), rtol=1e-5, atol=1e-5)


def _group_mats(gf, side, deq_k, deq_v, recon):
    """Dense reconstruction of one group's K or V factors."""
    us, vt, scale = ((gf.k_us, gf.k_vt, gf.k_scale) if side == "k"
                     else (gf.v_us, gf.v_vt, gf.v_scale))
    if scale is None:
        return recon(us, vt)
    return deq_k(us, vt, scale) if side == "k" else deq_v(us, scale, vt)


def _jax_mats(gf, side):
    return np.asarray(_group_mats(
        gf, side,
        lambda u, v, s: jquant.dequantize_k(jquant.QuantizedKFactors(u, v, s)),
        lambda u, s, v: jquant.dequantize_v(jquant.QuantizedVFactors(u, s, v)),
        lambda u, v: jsvd.reconstruct(jsvd.LowRankFactors(u.astype(jnp.float32),
                                                          v.astype(jnp.float32)))))


def _torch_mats(gf, side):
    return _group_mats(
        gf, side,
        lambda u, v, s: tquant.dequantize_k(tquant.QuantizedKFactors(u, v, s)),
        lambda u, s, v: tquant.dequantize_v(tquant.QuantizedVFactors(u, s, v)),
        lambda u, v: tsvd.reconstruct(tsvd.LowRankFactors(u, v))).float().numpy()


CASES = [("pre", "bf16"), ("post", "bf16"), ("pre", "int8"), ("post", "int8"),
         ("pre", "fp32")]


@pytest.mark.parametrize("rope,factor", CASES)
def test_build_cache_and_refactorize_reconstructions(rope, factor):
    b, s, t_max = 1, 32, 4
    jcfg, tcfg = jax_tiny(), torch_tiny()  # 4 layers, 2 kv heads, hd 16
    hkv, hd, L = jcfg.num_kv_heads, jcfg.head_dim, jcfg.num_layers
    kw = dict(group_size=2, rank_k=8, rank_v=12, num_layers=L, end_layer=L - 1,
              extra_kwargs={"svd_method": "exact", "rope_mode": rope})
    jx, tx = jax_xkv(**kw), torch_xkv(**kw)
    kvs = [(low_rank(10 + 4 * l, b * hkv, s, hd, 3).reshape(b, hkv, s, hd),
            low_rank(12 + 4 * l, b * hkv, s, hd, 3).reshape(b, hkv, s, hd))
           for l in range(L)]
    jf = {"bf16": jnp.bfloat16, "int8": "int8", "fp32": jnp.float32}[factor]
    tf = {"bf16": torch.bfloat16, "int8": "int8", "fp32": torch.float32}[factor]
    cos_j, sin_j = jax_rope(jnp.arange(s), hd)
    cos_t, sin_t = torch_rope(torch.arange(s), hd)
    jc = jcomp.build_cache([(jnp.asarray(k), jnp.asarray(v)) for k, v in kvs], jx, jcfg,
                           cos_j, sin_j, t_max, factor_dtype=jf, cache_dtype=jnp.float32)
    tc = tcomp.build_cache([(torch.as_tensor(k), torch.as_tensor(v)) for k, v in kvs], tx,
                           tcfg, cos_t, sin_t, t_max, factor_dtype=tf,
                           cache_dtype=torch.float32)
    tol = 1e-4 if factor == "fp32" else 2e-2

    def check(jcache, tcache):
        for jg, tg in zip(jcache.groups, tcache.groups):
            for side in ("k", "v"):
                want = _jax_mats(jg, side)
                got = _torch_mats(tg, side)
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=tol * max(1.0, np.abs(want).max()))

    check(jc, tc)
    # The generic field walk counts the same bytes as the JAX name list.
    assert abs(tc.compression_ratio(tcfg) - float(jc.compression_ratio(jcfg))) < 1e-9
    # Fill the tail, then fold it into the factors on both sides.
    tail_k, tail_v = rnd(40, L, b, hkv, t_max, hd), rnd(41, L, b, hkv, t_max, hd)
    jc = jc.replace(tail_k=jnp.asarray(tail_k), tail_v=jnp.asarray(tail_v),
                    tail_len=jnp.asarray(t_max, jnp.int32))
    tc.tail_k.copy_(torch.as_tensor(tail_k))
    tc.tail_v.copy_(torch.as_tensor(tail_v))
    tc = tc.advance(t_max)
    jr = jcomp.refactorize_cache(jc, jx, jcfg, factor_dtype=jf, cache_dtype=jnp.float32)
    tr = tcomp.refactorize_cache(tc, tx, tcfg, factor_dtype=tf)
    assert tr.prefill_len == s + t_max and tr.tail_len == 0
    check(jr, tr)


def test_fake_and_uncompressed_dense_segments():
    b, s = 1, 24
    jcfg, tcfg = jax_tiny(), torch_tiny()
    hkv, hd, L = jcfg.num_kv_heads, jcfg.head_dim, jcfg.num_layers
    kw = dict(group_size=2, rank_k=6, rank_v=6, num_layers=L, end_layer=1,
              extra_kwargs={"svd_method": "exact"})
    kvs = [(rnd(50 + l, b, hkv, s, hd), rnd(60 + l, b, hkv, s, hd)) for l in range(L)]
    cos_j, sin_j = jax_rope(jnp.arange(s), hd)
    cos_t, sin_t = torch_rope(torch.arange(s), hd)
    jkv = [(jnp.asarray(k), jnp.asarray(v)) for k, v in kvs]
    tkv = [(torch.as_tensor(k), torch.as_tensor(v)) for k, v in kvs]
    jc = jcomp.build_cache(jkv, jax_xkv(**kw), jcfg, cos_j, sin_j, 4, fake=True,
                           cache_dtype=jnp.float32)
    tc = tcomp.build_cache(tkv, torch_xkv(**kw), tcfg, cos_t, sin_t, 4, fake=True,
                           cache_dtype=torch.float32)
    jn = jcomp.build_uncompressed_cache(jkv, jcfg, cos_j, sin_j, 4, cache_dtype=jnp.float32)
    tn = tcomp.build_uncompressed_cache(tkv, tcfg, cos_t, sin_t, 4, cache_dtype=torch.float32)
    for jcache, tcache in ((jc, tc), (jn, tn)):
        assert sorted(jcache.dense_k) == sorted(tcache.dense_k)
        for l in jcache.dense_k:
            np.testing.assert_allclose(tcache.dense_k[l].numpy(),
                                       np.asarray(jcache.dense_k[l]), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(tcache.dense_v[l].numpy(),
                                       np.asarray(jcache.dense_v[l]), rtol=1e-4, atol=1e-4)
    assert abs(tn.compression_ratio(tcfg) - float(jn.compression_ratio(jcfg))) < 1e-9
