"""The kernel wrappers of xkv_tpu_torch on CPU tensors (their plain
versions) against the JAX package.

  * K1 ``flash_attention`` against ``flash_attention_fwd`` in interpret
    mode, at the tiny shapes the JAX package's own tests use (fp32; 2e-4,
    as there), and at group sizes 7 and 3 and head size 64; K1's shape
    checks on ``meta`` tensors (any group size, every even head size up to
    128: 64 and 128 as built, the others zero-padded).
  * K2 ``rankspace_decode_attention`` against
    ``rankspace_decode_attention_xla`` and K3 ``lowrank_decode_attention``
    against ``factored_decode_attention_xla``, the oracles the JAX tests
    use (fp32 factors: 1e-4, the orders of the fp32 sums differ; int8
    factors run in bf16 as the kernels do, against fp32 oracles: 1e-2 for
    K2, 3e-2 for K3, which also rounds its rebuilt keys); K3 also at head
    size 64 (fp32, bf16 and int8 factors); K3's and K5's shape checks on
    ``meta`` tensors (every even head size up to 128, any group size), and
    their operands padded per RoPE half through the plain versions against
    the unpadded ones (head sizes 16, 24, 32; fp32, 1e-6).
  * K4's and K5's chunk widths on ``meta`` tensors: any positive width
    passes to the device checks, 0 and negative widths are refused.
  * The ctypes argument lists of ``_build.SIGNATURES`` against the
    parameters of the sources' ``extern "C"`` entry points.

The CUDA kernels themselves are held against these plain versions in
``test_torch_kernels_gpu.py`` (on a card) and by ``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xkv_tpu.compress.quant import (
    quantize_k_factors,
    quantize_k_factors_mixed4,
    quantize_v_factors,
    quantize_v_factors_mixed4,
)
from xkv_tpu.ops.attention import (
    factored_decode_attention_xla,
    rankspace_decode_attention_xla,
)
from xkv_tpu.ops.pallas.flash_attention import flash_attention_fwd
from xkv_tpu.ops.pallas.lowrank_attention import lowrank_decode_attention as jax_k3
from xkv_tpu.ops.pallas.rankspace_attention import mla_rankspace_decode_attention as jax_mla
from xkv_tpu.ops.pallas.rankspace_attention import rankspace_decode_attention as jax_k2
from xkv_tpu.ops.rope import apply_rope, rope_cos_sin
from xkv_tpu_torch.ops.kernels import flash_attention as k1
from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
from xkv_tpu_torch.ops.kernels import rankspace_attention as k2
from xkv_tpu_torch.scripts.kernel_variants import row_rel_err

jax_quantize_k4 = jax.jit(quantize_k_factors_mixed4, static_argnums=2)
jax_quantize_v4 = jax.jit(quantize_v_factors_mixed4, static_argnums=2)


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(x):
    return None if x is None else torch.as_tensor(np.array(x))


def j(x):
    return None if x is None else jnp.asarray(x)


def _flash_case(s, window, hq=4, hkv=2, hd=32):
    label = f"{s}-{window}" if (hq, hkv, hd) == (4, 2, 32) else f"{s}-{window}-{hq}q{hkv}kv-hd{hd}"
    return pytest.param(s, window, hq, hkv, hd, id=label)


# Group sizes 7 and 3 (Qwen2-7B's 28/4 and 1.5B's 12/2 reduced), and the
# head size of Llama-3.2-1B.
@pytest.mark.parametrize("s,window,hq,hkv,hd", [
    _flash_case(64, None), _flash_case(96, None), _flash_case(40, None), _flash_case(96, 40),
    _flash_case(64, None, 7, 1), _flash_case(96, 40, 6, 2), _flash_case(96, None, 4, 2, 64),
    _flash_case(40, 24, 6, 2, 64),
])
def test_flash_plain_matches_pallas_interpret(s, window, hq, hkv, hd):
    b = 2
    q, k, v = rnd(0, b, hq, s, hd), rnd(1, b, hkv, s, hd), rnd(2, b, hkv, s, hd)
    scale = 1.0 / math.sqrt(hd)
    want = flash_attention_fwd(j(q), j(k), j(v), scale=scale, causal=True, window=window,
                               block_q=32, block_k=32, interpret=True)
    before = k1.launches
    got = k1.flash_attention(t(q), t(k), t(v), scale=scale, window=window)
    assert k1.launches == before  # the plain version is not a launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("hq,hkv,hd", [(24, 8, 128), (28, 4, 128), (12, 2, 128), (32, 8, 64),
                                       (7, 7, 64), (5, 1, 128), (32, 8, 96), (4, 2, 16),
                                       (4, 2, 24), (4, 2, 32)])
def test_flash_kernel_takes_every_group_size(hq, hkv, hd):
    """The kernel's shape checks (run before the device checks) accept any
    group size hq / hkv and every even head size up to 128: 64 and 128 as
    built, the others zero-padded to the next of them (16, 24 and 32 are
    the head sizes of ``tiny_llama_config`` and the examples)."""
    q = torch.empty((2, hq, 40, hd), device="meta")
    k = torch.empty((2, hkv, 40, hd), device="meta")
    assert k1.kernel_shapes(q, k, k) == (2, hq, hkv, 40, hd)


@pytest.mark.parametrize("hq,hkv,hd", [(32, 8, 33), (32, 8, 256), (6, 4, 64)])
def test_flash_kernel_refuses_other_shapes(hq, hkv, hd):
    q = torch.empty((1, hq, 16, hd), device="meta")
    k = torch.empty((1, hkv, 16, hd), device="meta")
    want = "even, at most 128" if hq % hkv == 0 else "multiple"
    with pytest.raises(ValueError, match=want):
        k1.kernel_shapes(q, k, k)
    with pytest.raises(ValueError, match=want):
        k1.flash_attention(q, k, k, scale=0.1)  # refused before the device checks


def test_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    """No silent fallback: a tensor that is neither on the CPU nor a valid
    CUDA operand is refused, not sent to the plain version."""
    q = torch.empty((1, 4, 8, 64), device="meta")
    k = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError):
        k1.flash_attention(q, k, k, scale=0.1)
    with pytest.raises(ValueError):
        k2.rankspace_kernel(torch.empty((1, 4, 16), device="meta"),
                            torch.empty((1, 8, 16), device="meta"),
                            torch.empty((1, 8, 16), device="meta"))


def _factors(seed, b, s_p, rk, rv, m, int8):
    k_us, k_vt = rnd(seed, b, s_p, rk), rnd(seed + 1, b, rk, m, scale=0.3)
    v_us, v_vt = rnd(seed + 2, b, s_p, rv), rnd(seed + 3, b, rv, m, scale=0.3)
    if not int8:
        return dict(k_us=k_us, k_vt=k_vt, v_us=v_us, v_vt=v_vt, k_scale=None, v_scale=None)
    qk = quantize_k_factors(j(k_us), j(k_vt))
    qv = quantize_v_factors(j(v_us), j(v_vt))
    return dict(k_us=np.asarray(qk.us_q), k_vt=np.asarray(qk.vt_q),
                k_scale=np.asarray(qk.out_scale), v_us=np.asarray(qv.us_q),
                v_vt=np.asarray(qv.vt.astype(jnp.float32)),
                v_scale=np.asarray(qv.rank_scale))


DECODE_CASES = [(False, 1, None, None), (False, 3, [13, 24], [0, 5]),
                (True, 1, None, None), (True, 2, [20, 17], [4, 0])]


@pytest.mark.parametrize("int8,ql,lens,lo", DECODE_CASES)
def test_rankspace_plain_matches_xla_oracle(int8, ql, lens, lo):
    b, hq, hkv, hd, s_p, rk, rv = 2, 4, 2, 16, 24, 12, 10
    f = _factors(10, b, s_p, rk, rv, hkv * hd, int8)
    q = rnd(20, b, hq, ql, hd)
    want = rankspace_decode_attention_xla(
        j(q), j(f["k_us"]), j(f["k_vt"]), j(f["v_us"]), j(f["v_vt"]), 0.25, hkv,
        k_scale_slice=j(f["k_scale"]), v_rank_scale=j(f["v_scale"]),
        valid_len=j(lens), valid_lo=j(lo))
    got_out, got_lse = k2.rankspace_decode_attention(
        t(q), t(f["k_us"]), t(f["k_vt"]), t(f["v_us"]), t(f["v_vt"]), lengths=t(lens),
        k_scale_slice=t(f["k_scale"]), v_rank_scale=t(f["v_scale"]), win_lo=t(lo),
        scale=0.25, num_kv_heads=hkv)
    # int8 factors run in bf16 (the query embeds and probabilities are
    # rounded to bf16, as in the kernel); the XLA oracle keeps fp32.
    tol = dict(rtol=1e-2, atol=1e-2) if int8 else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want.out), **tol)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want.lse), **tol)


@pytest.mark.parametrize("int8,ql,lens,lo", DECODE_CASES)
def test_lowrank_plain_matches_xla_oracle(int8, ql, lens, lo):
    b, hq, hkv, hd, s_p, rk, rv = 2, 4, 2, 16, 24, 12, 10
    f = _factors(30, b, s_p, rk, rv, hkv * hd, int8)
    q_pre = rnd(40, b, hq, ql, hd)
    cos_p, sin_p = rope_cos_sin(jnp.arange(s_p), hd, theta=10000.0)
    cos_t, sin_t = rope_cos_sin(s_p + 3 + jnp.arange(ql)[None], hd, theta=10000.0)
    q = apply_rope(j(q_pre), cos_t, sin_t)
    want = factored_decode_attention_xla(
        q, j(f["k_us"]), j(f["k_vt"]), j(f["v_us"]), j(f["v_vt"]), cos_p, sin_p, 0.25, hkv,
        k_scale_slice=j(f["k_scale"]), v_rank_scale=j(f["v_scale"]),
        valid_len=j(lens), valid_lo=j(lo))
    got_out, got_lse = k3.lowrank_decode_attention(
        t(q_pre), t(f["k_us"]), t(f["k_vt"]), t(f["v_us"]), t(f["v_vt"]),
        t(cos_p), t(sin_p), t(cos_t), t(sin_t), lengths=t(lens),
        k_scale_slice=t(f["k_scale"]), v_rank_scale=t(f["v_scale"]), win_lo=t(lo),
        scale=0.25, num_kv_heads=hkv)
    if int8:
        # The int8 path rounds the rebuilt keys, the trig fields and the
        # probabilities to bf16, as the kernel does; the XLA oracle keeps
        # fp32 (its query is fp32): bf16 tolerance.
        tol = dict(rtol=3e-2, atol=3e-2)
    else:
        tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want.out), **tol)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want.lse), **tol)


def _bf16_values(x):
    return None if x is None else torch.as_tensor(x).to(torch.bfloat16).float().numpy()


# Head size 64 (Llama-3.2-1B's), rk 64, rv 32: (factors, b, ql, valid_len,
# win_lo). "bf16" factors are bf16 values, handed to the oracle as fp32.
LOWRANK_HD64_CASES = [("fp32", 2, 1, None, None), ("fp32", 1, 3, [90], [7]),
                      ("bf16", 2, 1, [70, 96], None), ("int8", 2, 1, None, None),
                      ("int8", 1, 2, [81], [30])]


@pytest.mark.parametrize("dtype,b,ql,lens,lo", LOWRANK_HD64_CASES)
def test_lowrank_plain_matches_xla_oracle_hd64(dtype, b, ql, lens, lo):
    hq, hkv, hd, s_p, rk, rv = 4, 2, 64, 96, 64, 32
    f = _factors(50, b, s_p, rk, rv, hkv * hd, dtype == "int8")
    if dtype == "bf16":
        f = {k: _bf16_values(v) for k, v in f.items()}
    q_pre = rnd(60, b, hq, ql, hd)
    cos_p, sin_p = rope_cos_sin(jnp.arange(s_p), hd, theta=10000.0)
    cos_t, sin_t = rope_cos_sin(s_p + 3 + jnp.arange(ql)[None], hd, theta=10000.0)
    scale = 1.0 / math.sqrt(hd)
    want = factored_decode_attention_xla(
        apply_rope(j(q_pre), cos_t, sin_t), j(f["k_us"]), j(f["k_vt"]), j(f["v_us"]),
        j(f["v_vt"]), cos_p, sin_p, scale, hkv, k_scale_slice=j(f["k_scale"]),
        v_rank_scale=j(f["v_scale"]), valid_len=j(lens), valid_lo=j(lo))
    fac = {k: t(f[k]) for k in ("k_us", "k_vt", "v_us", "v_vt")}
    if dtype == "bf16":
        fac = {k: v.to(torch.bfloat16) for k, v in fac.items()}
    before = k3.launches
    got_out, got_lse = k3.lowrank_decode_attention(
        t(q_pre), fac["k_us"], fac["k_vt"], fac["v_us"], fac["v_vt"],
        t(cos_p), t(sin_p), t(cos_t), t(sin_t), lengths=t(lens),
        k_scale_slice=t(f["k_scale"]), v_rank_scale=t(f["v_scale"]), win_lo=t(lo),
        scale=scale, num_kv_heads=hkv)
    assert k3.launches == before  # the plain version is not a launch
    assert got_out.shape == (b, hq, ql, hd)
    # bf16 and int8 factors round the rebuilt keys, the trig fields and the
    # probabilities to bf16, as the kernel does: the file's bf16 tolerance.
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "fp32" else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got_out.float().numpy(), np.asarray(want.out), **tol)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want.lse), **tol)


def _lowrank_meta(hq, hkv, hd, rk=64, rv=32, ql=1, s_p=40):
    meta = dict(device="meta")
    return (torch.empty((2, ql * hq, 2 * hd), dtype=torch.bfloat16, **meta),
            torch.empty((2, s_p, rk), dtype=torch.bfloat16, **meta),
            torch.empty((2, rk, hkv * hd), dtype=torch.bfloat16, **meta),
            torch.empty((2, s_p, rv), dtype=torch.bfloat16, **meta),
            torch.empty((2, rv, hkv * hd), dtype=torch.bfloat16, **meta),
            torch.empty((s_p, hd // 2), dtype=torch.bfloat16, **meta),
            torch.empty((s_p, hd // 2), dtype=torch.bfloat16, **meta))


# (hq, hkv, hd, ql, rk, rv): head sizes and group sizes, then value ranks
# past one CTA's 1024 (value slices) and rank 4096, the full rank of an
# 8B group of 4 layers.
@pytest.mark.parametrize("hq,hkv,hd,ql,rk,rv", [
    (32, 8, 64, 1, 64, 32), (32, 8, 128, 1, 64, 32), (24, 8, 128, 1, 64, 32),
    (12, 2, 64, 2, 64, 32), (28, 4, 128, 3, 64, 32), (7, 1, 64, 1, 64, 32),
    (32, 8, 128, 1, 512, 1088), (32, 8, 64, 1, 256, 4096), (8, 2, 128, 2, 4096, 4096),
    (8, 2, 96, 1, 64, 32), (8, 2, 32, 1, 64, 32), (4, 2, 16, 2, 64, 32), (6, 2, 24, 1, 64, 32)])
def test_lowrank_kernel_takes_head_and_group_sizes(hq, hkv, hd, ql, rk, rv):
    """K3's and K5's shape checks (run before the device checks) accept
    every even head size up to 128 (64 and 128 as built, the others padded
    per RoPE half), any group size hq / hkv (3, 6, 7 included) and any
    rank of the JAX kernels' layout (rk a multiple of 64, rv of 16)."""
    ops = _lowrank_meta(hq, hkv, hd, rk=rk, rv=rv, ql=ql)
    assert k3.kernel_shapes(*ops, hq, hkv) == (2, ql * hq, hd, 40, rk, rv)


@pytest.mark.parametrize("hd", [130, 256, 17])
def test_lowrank_kernel_refuses_other_head_sizes(hd):
    """Refused before the device checks: head sizes past 128, and odd ones
    (the RoPE halves would be uneven)."""
    ops = _lowrank_meta(8, 2, hd)
    with pytest.raises(ValueError, match="even, at most 128"):
        k3.kernel_shapes(*ops, 8, 2)
    kw = dict(num_q_heads=8, num_kv_heads=2)
    with pytest.raises(ValueError, match="even, at most 128"):  # before the device checks
        k3.lowrank_kernel(*ops, None, None, None, **kw)
    ids = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="even, at most 128"):
        k3.sparse_lowrank_kernel(*ops, None, ids, 64, None, None, **kw)


@pytest.mark.parametrize("hd", [16, 24, 32])
def test_padded_head_operands_match_plain(hd):
    """The operands K3 and K5 run at head sizes other than 64 and 128,
    padded per RoPE half to 64 (``pad_head_operands``), give through the
    plain versions the unpadded plain result once the output is sliced
    back (fp32 factors: 1e-6; the padded columns add exact zeros, only the
    order of the sums differs)."""
    b, hq, hkv, ql, s_p, rk, rv = 2, 4, 2, 2, 40, 12, 10
    m = hkv * hd
    qab = t(rnd(1, b, ql * hq, 2 * hd))
    k_us, v_us = t(rnd(2, b, s_p, rk)), t(rnd(3, b, s_p, rv))
    k_vt, v_vt = t(rnd(4, b, rk, 3 * m, scale=0.3)), t(rnd(5, b, rv, 3 * m, scale=0.3))
    k_vt, v_vt = k_vt[:, :, m:2 * m], v_vt[:, :, m:2 * m]  # a layer's slice of its group
    cos_h, sin_h = t(rnd(6, s_p, hd // 2)), t(rnd(7, s_p, hd // 2))
    hp = k1.padded_head_dim(hd)
    assert hp == 64
    padded = k3.pad_head_operands(qab, k_vt, v_vt, cos_h, sin_h, hp)
    assert padded[0].shape == (b, ql * hq, 2 * hp) and padded[1].shape == (b, rk, hkv * hp)
    assert padded[3].shape == (s_p, hp // 2)
    kw = dict(num_q_heads=hq, num_kv_heads=hkv)
    lens, lo = torch.tensor([33, 40]), torch.tensor([3, 0])
    want = k3.lowrank_kernel_plain(qab, k_us, k_vt, v_us, v_vt, cos_h, sin_h, None, lens, lo,
                                   **kw)
    q_p, kvt_p, vvt_p, cos_p, sin_p = padded
    got = k3.lowrank_kernel_plain(q_p, k_us, kvt_p, v_us, vvt_p, cos_p, sin_p, None, lens, lo,
                                  **kw)
    np.testing.assert_allclose(k3.unpad_head(got[0], hd).numpy(), want[0].numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=1e-6, atol=1e-6)
    ids = torch.tensor([[1, -1], [0, 2]], dtype=torch.int32)
    want5 = k3.sparse_lowrank_kernel_plain(qab[:, :hq], k_us, k_vt, v_us, v_vt, cos_h, sin_h,
                                           None, ids, 16, lens, lo, **kw)
    got5 = k3.sparse_lowrank_kernel_plain(q_p[:, :hq], k_us, kvt_p, v_us, vvt_p, cos_p, sin_p,
                                          None, ids, 16, lens, lo, **kw)
    np.testing.assert_allclose(k3.unpad_head(got5[0], hd).numpy(), want5[0].numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got5[1].numpy(), want5[1].numpy(), rtol=1e-6, atol=1e-6)


# K2/K4/K6 split counts on a 132-SM card: (64-key blocks, R, rv, b, splits).
# The 8B layer at ql 1 and 4 (R 32, 128), sparse top-4 of 512-row chunks
# (32 blocks), Qwen2-7B's 28 heads x ql 3 (R 84), two sequences, and a
# grid too large for one split per SM.
SPLIT_CASES = [(128, 32, 768, 1, 44), (128, 128, 768, 1, 33), (32, 32, 768, 1, 32),
               (128, 84, 768, 1, 44), (4, 32, 96, 2, 4), (128, 32, 1024, 2, 16),
               (1, 2000, 1024, 4, 1), (128, 128, 1536, 1, 16), (128, 32, 4096, 1, 8)]


@pytest.mark.parametrize("n_blocks,R,rv,b,want", SPLIT_CASES)
def test_rankspace_split_count(n_blocks, R, rv, b, want):
    """The grid (splits x value slices x 32-row tiles x sequences) fills the
    SMs once, with at least one 64-key block per split; 256-rank value
    slices for a single row tile, 1024-rank ones past 1024 for several."""
    nsplit = k2.split_count(n_blocks, R, rv, b, 132)
    assert nsplit == want
    assert 1 <= nsplit <= n_blocks


def test_rankspace_partials_are_a_small_part_of_the_factors():
    """At the 8B layer (s_p 8192, rk 512, rv 768, bf16, R 32) the fp32
    partials written and read back are under a quarter of the factor bytes."""
    s_p, rk, rv, R = 8192, 512, 768, 32
    nsplit = k2.split_count(s_p // 64, R, rv, 1, 132)
    assert nsplit * R * rv * 4 < 0.25 * s_p * (rk + rv) * 2


# K7/K8 split counts on a 132-SM card: (64-key blocks, R, rk, b, (splits,
# value slices)). DeepSeek-V2-Lite at s_p 8192 (128 blocks), rank 512, ql 1,
# 2 and 3 (R 16, 32, 48: one or two row tiles); two and three sequences;
# 32768 tokens; a segment of 7 blocks; ranks 1088, 2048 and 4096 (two and
# four value slices of at most 1024); a grid too large for one split per
# SM.
MLA_SPLIT_CASES = [(128, 16, 512, 1, (128, 1)), (128, 32, 512, 1, (128, 1)),
                   (128, 48, 512, 1, (66, 1)), (128, 16, 512, 2, (66, 1)),
                   (128, 16, 512, 3, (44, 1)), (512, 16, 512, 1, (132, 1)),
                   (7, 16, 512, 1, (7, 1)), (128, 16, 1088, 1, (66, 2)),
                   (128, 16, 2048, 1, (66, 2)), (128, 32, 4096, 1, (33, 4)),
                   (1, 2000, 512, 4, (1, 1))]


@pytest.mark.parametrize("n_blocks,R,rk,b,want", MLA_SPLIT_CASES)
def test_mla_split_count(n_blocks, R, rk, b, want):
    """The K7/K8 grid (splits x value slices x 32-row tiles x sequences)
    fills the SMs once with at least one 64-key block a split; value
    slices of at most 1024 ranks, none empty, as the kernel requires."""
    nsplit, slices = k2.mla_split_count(n_blocks, R, rk, b, 132)
    assert (nsplit, slices) == want
    assert 1 <= nsplit <= n_blocks
    panels = -(-rk // 64)
    per = -(-panels // slices)
    assert per <= 16 and (slices - 1) * per < panels


def test_mla_partials_stay_one_cta_a_sm():
    """At DeepSeek-V2-Lite (16 heads, rank 512, b 1) the fp32 partials that
    the split kernel writes and the merge reads are at most one CTA's rows
    a SM (132 x 16 x 512 x 4 B = 4.3 MB) at any length: half the bf16
    latent's 8.4 MB at 8192 tokens, under a seventh at 32768."""
    R, rk, n_sm = 16, 512, 132
    for s_p, share in ((8192, 0.5), (32768, 1 / 7)):
        nsplit, slices = k2.mla_split_count(s_p // 64, R, rk, 1, n_sm)
        partials = nsplit * R * rk * 4
        assert nsplit * slices <= n_sm
        assert partials <= n_sm * R * rk * 4
        assert partials <= share * s_p * rk * 2


def _rankspace_meta(b, R, s_p, rk, rv, dtype=torch.bfloat16):
    meta = dict(device="meta")
    return (torch.empty((b, R, rk), dtype=torch.bfloat16, **meta),
            torch.empty((b, s_p, rk), dtype=dtype, **meta),
            torch.empty((b, s_p, rv), dtype=dtype, **meta))


# (R, s_p, rk, rv): the 8B layer at ql 1 and 4, R 84, rv 16 and 1024, a
# segment shorter than a block and not a multiple of 64; past 1024 value
# ranks, and rk = rv = 4096 (the full rank of an 8B group of 4 layers).
RANKSPACE_SHAPES = [(32, 8192, 512, 768), (128, 8192, 512, 768), (84, 2000, 512, 768),
                    (32, 1000, 64, 16), (32, 1000, 256, 1024), (3, 40, 16, 16),
                    (32, 100, 64, 1040), (32, 8192, 4096, 4096), (128, 1000, 512, 1536)]


@pytest.mark.parametrize("R,s_p,rk,rv", RANKSPACE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_rankspace_kernel_takes_shapes(R, s_p, rk, rv, dtype):
    """K2's and K4's shape rules (run before the device checks) take any b
    and R, rk and rv positive multiples of 16."""
    assert k2.rankspace_shapes(*_rankspace_meta(2, R, s_p, rk, rv, dtype)) == (2, R, s_p, rk, rv)


@pytest.mark.parametrize("rk,rv", [(24, 64), (64, 24), (4096, 4104), (0, 64)])
def test_rankspace_kernel_refuses_other_ranks(rk, rv):
    ops = _rankspace_meta(1, 32, 100, rk, rv)
    with pytest.raises(ValueError, match="multiples of 16"):
        k2.rankspace_kernel(*ops)  # before the device checks
    ids = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="multiples of 16"):
        k2.sparse_rankspace_kernel(*ops, ids, 64)


def test_sparse_rankspace_kernel_refuses_other_chunks():
    ops = _rankspace_meta(1, 32, 100, 64, 64)
    ids = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    for block in (0, -64):
        with pytest.raises(ValueError, match="must be positive"):
            k2.sparse_rankspace_kernel(*ops, ids, block)
    ids3 = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    kw = dict(num_q_heads=8, num_kv_heads=2)
    with pytest.raises(ValueError, match="must be positive"):  # before the device checks
        k3.sparse_lowrank_kernel(*_lowrank_meta(8, 2, 128), None, ids3, 0, None, None, **kw)


@pytest.mark.parametrize("block", [32, 100, 16, 24, 8, 512, 576])
def test_sparse_kernels_take_any_chunk_width(block):
    """K4 and K5 take any positive chunk width, as the JAX kernels do: each
    chunk is walked as ceil(block / 64) blocks of 64 keys, the last masked
    at the chunk's end. On ``meta`` tensors the wrappers pass the chunk
    check and stop at the device check."""
    assert k2.chunk_blocks(block) == -(-block // 64)
    ids = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        k2.sparse_rankspace_kernel(*_rankspace_meta(1, 32, 100, 64, 64), ids, block)
    ids3 = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    kw = dict(num_q_heads=8, num_kv_heads=2)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        k3.sparse_lowrank_kernel(*_lowrank_meta(8, 2, 128), None, ids3, block, None, None, **kw)


def _mixed_meta(b, R, s_p, r8k, h4k, r8v, h4v):
    meta = dict(device="meta", dtype=torch.int8)
    return (torch.empty((b, R, r8k + 2 * h4k), device="meta", dtype=torch.bfloat16),
            torch.empty((b, s_p, r8k), **meta), torch.empty((b, s_p, h4k), **meta),
            torch.empty((b, s_p, r8v), **meta), torch.empty((b, s_p, h4v), **meta))


# (r8k, h4k, r8v, h4v): the 8B split (256 + 256 / 256 + 512 ranks), splits
# that are not whole 64-byte boxes, all int8, all int4, rv 1024, rv 1040,
# and rk = rv = 4096.
MIXED_SPLITS = [(256, 128, 256, 256), (16, 24, 24, 36), (64, 0, 96, 0), (0, 32, 0, 48),
                (2, 7, 256, 384), (16, 0, 512, 264), (2048, 1024, 2048, 1024)]


@pytest.mark.parametrize("r8k,h4k,r8v,h4v", MIXED_SPLITS)
def test_mixed_kernel_takes_any_split(r8k, h4k, r8v, h4v):
    ops = _mixed_meta(2, 84, 1000, r8k, h4k, r8v, h4v)
    assert k2.mixed_shapes(*ops) == (2, 84, 1000, r8k, h4k, r8v, h4v)


def test_mixed_kernel_refuses_other_totals():
    with pytest.raises(ValueError, match="multiples of 16"):
        k2.mixed_rankspace_kernel(*_mixed_meta(1, 32, 100, 8, 8, 16, 0))
    with pytest.raises(ValueError, match="multiples of 16"):
        k2.mixed_rankspace_kernel(*_mixed_meta(1, 32, 100, 16, 0, 512, 260))


def _mla_meta(R, s_p, r8, h4, rope):
    """K7's (h4 None) or K8's operands on ``meta``: q_emb, q_pe, us (int8
    ranks for K8), k_pe, r, and K8's packed int4 tail."""
    meta = dict(device="meta")
    rk = r8 + (0 if h4 is None else 2 * h4)
    return (torch.empty((2, R, rk), dtype=torch.bfloat16, **meta),
            torch.empty((2, R, rope), dtype=torch.bfloat16, **meta),
            torch.empty((2, s_p, r8), dtype=torch.bfloat16 if h4 is None else torch.int8, **meta),
            torch.empty((2, s_p, rope), dtype=torch.bfloat16, **meta),
            torch.empty((2, s_p), dtype=torch.float32, **meta),
            None if h4 is None else torch.empty((2, s_p, h4), dtype=torch.int8, **meta))


# (R, r8, h4): DeepSeek-V2-Lite's rank 512 (bf16; 256 int8 + 256 int4, ql
# 1), past one CTA's 1024 ranks (value slices), and 2048, the full rank of
# its groups of 4 layers (bf16; 1024 int8 + 1024 int4, ql 2).
@pytest.mark.parametrize("R,r8,h4", [(16, 512, None), (16, 256, 128), (32, 1088, None),
                                     (16, 2048, None), (32, 1024, 512)])
def test_mla_kernel_takes_ranks(R, r8, h4):
    """K7's and K8's shape rules (run before the device checks) take any
    rank of the JAX kernels' layout: a positive multiple of 16."""
    rk = r8 + (0 if h4 is None else 2 * h4)
    assert k2.mla_shapes(*_mla_meta(R, 100, r8, h4, 64)) == (2, R, 100, rk, 64)


@pytest.mark.parametrize("r8,h4,rope", [(1032, None, 64), (512, None, 24), (1024, 516, 64)])
def test_mla_kernel_refuses_other_ranks(r8, h4, rope):
    q_emb, q_pe, us, k_pe, r, us4 = _mla_meta(16, 100, r8, h4, rope)
    with pytest.raises(ValueError, match="multiples of 16"):  # before the device checks
        if us4 is None:
            k2.mla_rankspace_kernel(q_emb, q_pe, us, k_pe, r)
        else:
            k2.mla_mixed_rankspace_kernel(q_emb, q_pe, us, us4, k_pe, r)


WIDE = 1088  # a rank past one CTA's 1024: value slices on the card


@pytest.mark.parametrize("kernel", ["K2", "K6", "K3", "K7"])
def test_wide_rank_plain_matches_pallas_interpret(kernel):
    """The plain versions that the card holds the kernels against, at rank
    1088 (K2, K6 and K3: rv; K7: the latent rank), against the Pallas
    kernels in interpret mode, s_p 96 with ragged lengths. fp32 factors:
    1e-4 (the sums run in another order), K7 1e-5 of a row as in
    test_torch_deepseek.py; K6, mixed int8 + int4 in bf16: 1e-2 as in
    test_torch_int4.py."""
    b, hq, hkv, hd, s_p = 2, 4, 2, 16, 96
    lens, lo = [96, 70], [0, 9]
    kw = dict(scale=0.25, num_kv_heads=hkv)
    if kernel in ("K2", "K3"):
        f = _factors(30, b, s_p, 64, WIDE, hkv * hd, False)
        fac = [f["k_us"], f["k_vt"], f["v_us"], f["v_vt"]]
        q = rnd(31, b, hq, 1, hd)
        if kernel == "K2":
            want = jax_k2(j(q), *map(j, fac), j(lens), win_lo=j(lo), block_s=32,
                          interpret=True, **kw)
            got = k2.rankspace_decode_attention(t(q), *map(t, fac), t(lens), win_lo=t(lo),
                                                **kw)
        else:
            cos_p, sin_p = rope_cos_sin(jnp.arange(s_p), hd, theta=10000.0)
            cos_t, sin_t = rope_cos_sin(jnp.full((b,), s_p + 2), hd, theta=10000.0)
            trig = [cos_p, sin_p, cos_t, sin_t]
            want = jax_k3(j(q), *map(j, fac), *trig, j(lens), win_lo=j(lo), block_s=32,
                          interpret=True, **kw)
            got = k3.lowrank_decode_attention(t(q), *map(t, fac), *map(t, trig), lengths=t(lens),
                                              win_lo=t(lo), **kw)
        assert got[0].shape == (b, hq, 1, hd)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    elif kernel == "K6":
        m = hkv * hd
        qk = jax_quantize_k4(j(rnd(32, b, s_p, 128)), j(rnd(33, b, 128, m, scale=0.3)), 64)
        qv = jax_quantize_v4(j(rnd(34, b, s_p, WIDE)), j(rnd(35, b, WIDE, m, scale=0.3)), 512)
        f = [qk.us8, qk.vt8, qv.us8, qv.vt.astype(jnp.float32)]
        extra = dict(k_scale_slice=qk.out_scale, v_rank_scale=qv.rank_scale, k_us4=qk.us4p,
                     k_vt4_slice=qk.vt4, k_scale4_slice=qk.scale4, v_us4=qv.us4p)
        q = rnd(36, b, hq, 2, hd)
        want = jax_k2(j(q), *f, j(lens), win_lo=j(lo), block_s=32, interpret=True, **extra,
                      **kw)
        got = k2.rankspace_decode_attention(
            t(q), *map(t, f), t(lens), win_lo=t(lo), **kw, **{k: t(v) for k, v in extra.items()})
        assert got[0].shape == (b, hq, 2, hd)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-2, atol=1e-2)
    else:
        nh, rope = 4, 16
        q_emb, q_pe = rnd(37, b, nh, 1, WIDE, scale=0.1), rnd(38, b, nh, 1, rope, scale=0.3)
        us, k_pe = rnd(39, b, s_p, WIDE), rnd(40, b, s_p, rope)
        r = np.abs(rnd(41, b, s_p)) + 0.5
        want_t, want_lse = jax_mla(j(q_emb), j(q_pe), j(us), j(k_pe), j(r), j(lens),
                                   block_s=32, interpret=True)
        got_t, got_lse = k2.mla_rankspace_decode_attention(t(q_emb), t(q_pe), t(us), t(k_pe),
                                                           t(r), t(lens))
        assert got_t.shape == (b, nh, 1, WIDE)
        assert row_rel_err(got_t, t(want_t)) <= 1e-5
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=1e-5)


def _c_entry_points():
    """{name: [ctypes kind of each parameter]} of every ``extern "C"``
    function in the CUDA sources: pointers "P", long long "L", int "I",
    float "F"."""
    import re

    from xkv_tpu_torch.ops.kernels import _build

    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            kinds = []
            for p in (x.strip() for x in params.split(",")):
                kinds.append("P" if "*" in p else "L" if p.startswith("long long")
                             else "F" if p.startswith("float") else "I")
            found[name] = kinds
    return found


def test_ctypes_signatures_match_the_sources():
    """Each entry point's ctypes argument list has the C function's
    parameters, kind for kind: a mismatch passes garbage (or a cut
    pointer) to the kernel."""
    from xkv_tpu_torch.ops.kernels import _build

    kind = {_build._P: "P", _build._L: "L", _build._I: "I", _build._F: "F"}
    entry = _c_entry_points()
    assert set(entry) == set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        assert [kind[a] for a in argtypes] == entry[name], name
