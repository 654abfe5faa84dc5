"""The kernel-study kernels of the port (K9, K10, K11) against the JAX
package's TPU tools, on the CPU.

``scripts/kernel_variants.py``, ``kernel_ablation.py`` and ``probe_int4.py``
are loaded by path; their Pallas kernels run in interpret mode
(``pallas_call`` wrapped with ``interpret=True``) at small module
constants. The same inputs, numpy arrays, go through the JAX kernel and the
port's entry point, which runs the plain version on CPU tensors.

Tolerances, each with its reason:
- K9 (``variant_attention``): both sides round the same intermediates to
  bf16 (rebuilt keys, trig fields, probabilities, t) and differ only in the
  order of fp32 sums, which can flip a rounding: 2^-6 of each output row's
  largest value (two bf16 units in the last place, K3's limit on the card);
  lse, fp32 on both sides: 1e-5 of max(1, |lse|).
  Its plain version against K3's (``lowrank_kernel_plain``): fp32 factors
  differ only in the order of fp32 sums, 1e-5 of a row; int8 factors also
  round in bf16, 2^-6.
- K10 (``build_step``): the same stage arithmetic; the scores are sums of
  ~1e5-sized terms in another order and the bf16 output rows can move by
  a unit in the last place: 2^-6 of each row's largest value.
- K11 (``probe_int4``): integer products and sums are exact on both sides:
  equal bit for bit. bf16: fp32 sums in another order can flip the bf16
  rounding of the next input: 2^-6 of each row's largest value.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from xkv_tpu_torch.ops.kernels import kernel_ablation as k10
from xkv_tpu_torch.ops.kernels import kernel_variants as k9
from xkv_tpu_torch.ops.kernels import probe_int4 as k11

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_ROW = 2.0 ** -6
TOL_LSE = 1e-5


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Run every ``pallas_call`` in interpret mode for the test."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def t(x):
    """A JAX or numpy array as a torch tensor (bf16 kept bf16)."""
    x = np.asarray(x) if not isinstance(x, jax.Array) else x
    if x.dtype == jnp.bfloat16:
        return torch.as_tensor(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    return torch.as_tensor(np.array(x))


def row_rel_err(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    diff = np.abs(out - ref).max(-1)
    return float((diff / np.maximum(np.abs(ref).max(-1), np.finfo(np.float32).tiny)).max())


# ------------------------------------------------------------------- K10
ABL_GEOM = dict(HKV=2, HQ=8, HD=64, RK=32, RV=96)  # RV >= HD, HKV*HD % RK == 0


@pytest.mark.parametrize("name", [c[0] for c in k10.configs()])
def test_ablation_matches_pallas_interpret(interpret, monkeypatch, name):
    tool = _load("kernel_ablation")
    for key, val in ABL_GEOM.items():
        monkeypatch.setattr(tool, key, val)
    hkv, hq, hd, rk, rv = (ABL_GEOM[k] for k in ("HKV", "HQ", "HD", "RK", "RV"))
    stages = dict(k10.configs())[name]
    s, b = 128, 1
    q0 = np.random.default_rng(9).standard_normal((1, hq, hkv * hd)).astype(np.float32)
    q0 = jnp.asarray(q0, jnp.bfloat16)
    want = tool.build_step(tuple(stages), 64, s)(q0)
    # build_step's inputs, rebuilt from its own keys and tables.
    from xkv_tpu.ops.rope import rope_cos_sin

    ks = jax.random.split(jax.random.PRNGKey(0), 6)
    k_us = jax.random.randint(ks[0], (b, s, rk), -127, 127, jnp.int8)
    k_vt = jax.random.randint(ks[1], (b, rk, hkv * hd), -127, 127, jnp.int8)
    v_us = jax.random.randint(ks[2], (b, s, rv), -127, 127, jnp.int8)
    k_scale = jnp.abs(jax.random.normal(ks[3], (b, 1, hkv * hd), jnp.float32))
    cos_p, sin_p = rope_cos_sin(jnp.arange(s), hd, 500000.0, None)
    ch, sh = cos_p[:, :hd // 2], sin_p[:, :hd // 2]
    if k10.full_width_tables(stages):
        cos_t = jnp.concatenate([ch, ch], -1).astype(jnp.bfloat16)
        sin_t = jnp.concatenate([-sh, sh], -1).astype(jnp.bfloat16)
    else:
        cos_t, sin_t = ch.astype(jnp.bfloat16), sh.astype(jnp.bfloat16)
    trig = jnp.stack([jnp.cos(jnp.full((hd,), 0.37, jnp.float32)),
                      jnp.sin(jnp.full((hd,), 0.37, jnp.float32))])
    before = k10.launches
    got, m = k10.ablation_step(t(q0), t(k_us), t(k_vt), t(v_us), t(k_scale), t(cos_t),
                               t(sin_t), t(trig), stages, num_kv_heads=hkv)
    assert k10.launches == before  # the plain version is not a launch
    assert got.shape == (b, hq, hd) and got.dtype == torch.bfloat16
    assert row_rel_err(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= TOL_ROW
    if "softmax" in stages:
        assert torch.isfinite(m).all()
    else:
        assert bool((m == -torch.inf).all())


def test_ablation_plain_splits_merge_to_the_sequential_pass():
    """Dealing the blocks out to parts and merging them by their running
    maxima gives the sequential pass (every stage set but -vpath, whose
    per-block v_us row is weighted by the part's own running max)."""
    q, k_us, k_vt, v_us, k_scale = k10.inputs(1, 512, 4, 2, 64, 32, 96, "cpu")
    for name, stages in k10.configs():
        cos_t, sin_t, trig = k10.tables(512, 64, stages, "cpu")
        args = (q, k_us, k_vt, v_us, k_scale, cos_t, sin_t, trig, stages)
        o1, m1 = k10.ablation_step_plain(*args, num_kv_heads=2, nsplit=1)
        o3, m3 = k10.ablation_step_plain(*args, num_kv_heads=2, nsplit=3)
        assert torch.equal(m1, m3), name
        if name != "-vpath":
            assert row_rel_err(o3.float().numpy(), o1.float().numpy()) <= TOL_ROW, name


# -------------------------------------------------------------------- K9
VAR_GEOM = dict(b=1, s=256, hkv=2, hq=8, hd=64, rk=32, rv=48)
# (port variant, JAX variant, JAX block_s)
VARIANTS = [("scratch_ab", "scratch_ab", 128), ("two_gemm", "two_gemm", 128),
            ("b128", "scratch_ab", 128)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("variant,jax_variant,block", VARIANTS)
def test_variants_match_pallas_interpret(interpret, int8, variant, jax_variant, block):
    tool = _load("kernel_variants")
    from xkv_tpu.compress.quant import quantize_k_factors, quantize_v_factors
    from xkv_tpu.ops.rope import rope_cos_sin

    g = VAR_GEOM
    b, s, hkv, hq, hd, rk, rv = (g[k] for k in ("b", "s", "hkv", "hq", "hd", "rk", "rv"))
    rng = np.random.default_rng(3)
    q = jnp.asarray(rng.standard_normal((b, hq, 1, hd)), jnp.bfloat16)
    us_k = jnp.asarray(rng.standard_normal((b, s, rk)), jnp.float32)
    vt_k = jnp.asarray(rng.standard_normal((b, rk, hkv * hd)) * 0.03, jnp.float32)
    us_v = jnp.asarray(rng.standard_normal((b, s, rv)), jnp.float32)
    vt_v = jnp.asarray(rng.standard_normal((b, rv, hkv * hd)) * 0.03, jnp.float32)
    cos_p, sin_p = rope_cos_sin(jnp.arange(s), hd, 500000.0, None)
    cos_t, sin_t = (jnp.broadcast_to(x, (b, hd))
                    for x in rope_cos_sin(jnp.asarray([s]), hd, 500000.0, None))
    if int8:
        kq, vq = quantize_k_factors(us_k, vt_k), quantize_v_factors(us_v, vt_v)
        f = (kq.us_q, kq.vt_q, vq.us_q, vq.vt)
        kw = dict(k_scale_slice=kq.out_scale, v_rank_scale=vq.rank_scale)
    else:
        bf = jnp.bfloat16
        f = (us_k.astype(bf), vt_k.astype(bf), us_v.astype(bf), vt_v.astype(bf))
        kw = {}
    lengths = jnp.asarray([s - 37], jnp.int32)
    want_o, want_l = tool.variant_attention(
        q, *f, cos_p, sin_p, cos_t, sin_t, lengths, scale=hd ** -0.5, num_kv_heads=hkv,
        block_s=block, variant=jax_variant, **kw)
    before = k9.launches
    got_o, got_l = k9.variant_attention(
        t(q), *(t(x) for x in f), t(cos_p), t(sin_p), t(cos_t), t(sin_t), t(lengths),
        **{k: t(v) for k, v in kw.items()}, scale=hd ** -0.5, num_kv_heads=hkv,
        variant=variant)
    assert k9.launches == before
    assert got_o.shape == (b, hq, 1, hd)
    assert row_rel_err(got_o.float().numpy(), np.asarray(want_o.astype(jnp.float32))) <= TOL_ROW
    lse_err = np.abs(got_l.numpy() - np.asarray(want_l)) / np.maximum(1.0, np.abs(want_l))
    assert float(lse_err.max()) <= TOL_LSE


def test_variant_names():
    assert k9.parse_variant("two_gemm") == ("two_gemm", None)
    assert k9.parse_variant("scratch_ab") == ("scratch_ab", None)
    for n in (64, 512, 2048):
        assert k9.parse_variant(f"b{n}") == ("scratch_ab", n)
    for bad in ("b16", "b100", "b0"):
        with pytest.raises(ValueError, match="a positive multiple of 64 keys"):
            k9.parse_variant(bad)
    with pytest.raises(ValueError, match="unknown variant"):
        k9.parse_variant("concat")


def _k9_operands(device, hd=128, rk=512, rv=768, dtype=torch.bfloat16, hq=8, hkv=2, s_p=64):
    """Zero operands of K9's shapes (values do not matter to the checks)."""
    z = functools.partial(torch.zeros, device=device)
    m = hkv * hd
    return (z((1, hq, 2 * hd), dtype=torch.bfloat16), z((1, s_p, rk), dtype=dtype),
            z((1, rk, m), dtype=dtype), z((1, s_p, rv), dtype=dtype),
            z((1, rv, m), dtype=torch.bfloat16), z((s_p, hd // 2), dtype=torch.bfloat16),
            z((s_p, hd // 2), dtype=torch.bfloat16))


@pytest.mark.parametrize("kw", [dict(rv=640), dict(rv=1024), dict(rk=512),
                                dict(rk=1024, dtype=torch.int8)])
def test_variant_shapes_accept_k3_resident_instance(kw):
    ops = _k9_operands("cpu", **kw)
    rk, rv = kw.get("rk", 512), kw.get("rv", 768)
    assert k9.kernel_shapes(*ops, 8, 2) == (1, 8, 128, 64, rk, rv)
    # On meta tensors the shape check passes and the device check refuses.
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        k9.variant_kernel(*_k9_operands("meta", **kw), None, None, num_q_heads=8, num_kv_heads=2)


@pytest.mark.parametrize("kw,what", [(dict(hd=64), "head size 64"), (dict(rk=640), "rank_k 640"),
                                     (dict(rk=1088, dtype=torch.int8), "rank_k 1088"),
                                     (dict(rv=1100), "rv=1100"), (dict(rv=1040), "rank_v 1040")])
def test_variant_shapes_refuse_before_device_checks(kw, what):
    with pytest.raises(ValueError, match=what):
        k9.kernel_shapes(*_k9_operands("cpu", **kw), 8, 2)
    with pytest.raises(ValueError, match=what):
        k9.variant_kernel(*_k9_operands("meta", **kw), None, None, num_q_heads=8, num_kv_heads=2,
                          variant="b512")


@pytest.mark.parametrize("int8,lens", [(False, None), (False, 150), (True, 77)])
def test_variant_plain_equals_k3_plain(int8, lens):
    """The plain version (full-width embeds, one product of depth 2m) is
    K3's function: fp32 factors (no bf16 rounding to flip) agree with
    ``lowrank_kernel_plain`` to fp32 sum order; int8 factors to K3's
    rounding."""
    from xkv_tpu_torch.ops.kernels import lowrank_attention as k3

    rng = np.random.default_rng(11)
    b, s_p, hq, hkv, hd, rk, rv = 1, 200, 8, 2, 32, 64, 48

    def f(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)

    qab = f(b, hq, 2 * hd) * 0.3
    k_us, k_vt = f(b, s_p, rk), f(b, rk, hkv * hd) * 0.1
    v_us, v_vt = f(b, s_p, rv), f(b, rv, hkv * hd)
    theta = torch.arange(s_p)[:, None] * 0.01 * torch.arange(1, hd // 2 + 1)[None]
    cos_h, sin_h, v_scale = theta.cos(), theta.sin(), None
    if int8:
        k_us, k_vt, v_us = (torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
                            for x in (k_us, k_vt, v_us))
        qab, v_vt, cos_h, sin_h = (x.to(torch.bfloat16) for x in (qab * 1e-3, v_vt, cos_h, sin_h))
        v_scale = torch.full((b, 1, rv), 0.02)
    lengths = None if lens is None else torch.tensor([lens])
    args = (qab, k_us, k_vt, v_us, v_vt, cos_h, sin_h, v_scale)
    kw = dict(num_q_heads=hq, num_kv_heads=hkv)
    o, lse = k9.variant_kernel_plain(*args, lengths, **kw)
    o_ref, l_ref = k3.lowrank_kernel_plain(*args, lengths, None, **kw)
    tol = TOL_ROW if int8 else 1e-5
    assert o.dtype == o_ref.dtype and row_rel_err(o.float().numpy(), o_ref.float().numpy()) <= tol
    assert float(((lse - l_ref).abs() / l_ref.abs().clamp_min(1.0)).max()) <= 1e-5


def test_full_query_embeds_place_each_row_at_its_head():
    qab = torch.randn((2, 8, 2 * 16))
    full = k9.full_query_embeds(qab, 4, 2)  # rows (ql=2, hq=4), 2 kv heads
    assert full.shape == (2, 8, 2 * 2 * 16)
    for r in range(8):
        head = (r % 4) // 2
        qa = full[:, r, :32].reshape(2, 2, 16)
        qb = full[:, r, 32:].reshape(2, 2, 16)
        assert torch.equal(qa[:, head], qab[:, r, :16])
        assert torch.equal(qb[:, head], qab[:, r, 16:])
        assert not qa[:, 1 - head].any() and not qb[:, 1 - head].any()


# ------------------------------------------------------------------- K11
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_probe_matches_pallas_interpret(interpret, monkeypatch, kind):
    tool = _load("probe_int4")
    monkeypatch.setattr(tool, "M", 64)
    monkeypatch.setattr(tool, "K", 64)
    reps = 6
    fn, x, w = tool.build(jnp.bfloat16 if kind == "bf16" else jnp.int8, reps)
    want = np.asarray(fn(x, w))
    before = k11.launches
    got = k11.gemm_chain(t(x), t(w), reps, kind).numpy()
    assert k11.launches == before
    if kind == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        assert row_rel_err(got, want) <= TOL_ROW


def test_probe_int4_equals_int8_bit_for_bit():
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.integers(-8, 8, (48, 128)), dtype=torch.int8)
    w = torch.as_tensor(rng.integers(-8, 8, (128, 128)), dtype=torch.int8)
    a = k11.gemm_chain(x, w, 5, "int4")
    b = k11.gemm_chain(x, w, 5, "int8")
    assert torch.equal(a, b) and a.dtype == torch.float32 and a.shape == (48, 128)


def test_pack_int4_puts_the_lower_index_in_the_low_nibble():
    x = torch.tensor([[1, -2, -8, 7]], dtype=torch.int8)
    assert k11.pack_int4(x).tolist() == [[0xE1, 0x78]]


# ------------------------------------------------------------ the tools
def test_bench_kernel_entry_point_on_cpu(monkeypatch, capsys):
    from xkv_tpu_torch.scripts import bench_kernel

    for key, val in dict(HKV=2, HQ=4, HD=64, RK=32, RV=48).items():
        monkeypatch.setattr(bench_kernel, key, val)
    res = bench_kernel.main(["--device", "cpu", "--ctx", "128", "--n", "1", "--block-s", "64"])
    assert set(res) == {"dense_plain", "lowrank_bf16", "lowrank_int8"}
    out = capsys.readouterr().out
    assert "ignored" in out and "lowrank_int8" in out and "ms/call" in out


def test_ablation_entry_point_on_cpu(monkeypatch, capsys):
    from xkv_tpu_torch.scripts import kernel_ablation

    for key, val in ABL_GEOM.items():
        monkeypatch.setattr(kernel_ablation, key, val)
    res = kernel_ablation.main(["--device", "cpu", "--ctx", "128", "--n", "1",
                                "--configs", "full,-recon,ropeq2d"])
    assert list(res) == ["full", "-recon", "ropeq2d"]
    assert "saves" in capsys.readouterr().out


def test_variants_entry_point_on_cpu(monkeypatch, capsys):
    from xkv_tpu_torch.scripts import kernel_variants

    for key, val in dict(HKV=2, HQ=8, HD=64, RK=32, RV=48).items():
        monkeypatch.setattr(kernel_variants, key, val)
    res = kernel_variants.main(["--device", "cpu", "--ctx", "128", "--batch", "1", "--n", "1",
                                "--check"])
    out = capsys.readouterr().out
    assert set(res) == {"prod", "scratch_ab", "two_gemm", "b2048"}
    assert "parity ok: two_gemm" in out and "UNSUPPORTED" not in out
    assert "b2048" in out and "ms/call" in out


def test_probe_entry_point_on_cpu(monkeypatch, capsys):
    from xkv_tpu_torch.scripts import probe_int4

    monkeypatch.setattr(probe_int4, "M", 64)
    monkeypatch.setattr(probe_int4, "K", 64)
    res = probe_int4.main(["--device", "cpu", "--reps", "2"])
    assert set(res) == {"bf16", "int8", "int4"}
    assert "us/GEMM" in capsys.readouterr().out
