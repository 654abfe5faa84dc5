"""The CUDA kernels K1, K2 and K3 against their plain versions, on a card.

Marked ``gpu``: each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a machine that has only the
port's dependencies; ``tests/conftest.py`` imports JAX, so there run it as

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

Tolerances: each output row is held against its own largest value, since
a row that averages many keys has small values. K1 and K3 round P to bf16
against another maximum than the plain version and round their bf16
output once: 2^-6 (two units in bf16's last place). K2's fp32 t only
carries the rounding of P: 2^-7. The fp32 lse, whose error grows with
the scores: 1e-5 of max(1, |lse|).
"""

import pytest
import torch

from xkv_tpu_torch.compress.quant import quantize_k_factors, quantize_v_factors
from xkv_tpu_torch.ops.kernels import flash_attention as k1
from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
from xkv_tpu_torch.ops.kernels import rankspace_attention as k2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


TOL_BF16_OUT, TOL_T, TOL_LSE = 2.0 ** -6, 2.0 ** -7, 1e-5


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _row_rel_err(out, ref):
    """Largest over rows (the last axis) of max |out - ref| / max |ref|."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return (diff / scale).max().item()


def _lse_err(lse, ref):
    return ((lse - ref).abs() / ref.abs().clamp_min(1.0)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("s,hq,hkv,window", [(300, 8, 2, None), (200, 4, 4, 64)])
def test_flash_kernel_matches_plain(cuda, s, hq, hkv, window):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    bf = torch.bfloat16
    q = torch.randn((1, hq, s, 128), generator=gen, device=cuda).to(bf)
    k = torch.randn((1, hkv, s, 128), generator=gen, device=cuda).to(bf)
    v = torch.randn((1, hkv, s, 128), generator=gen, device=cuda).to(bf)
    before = k1.launches
    out = k1.flash_attention(q, k, v, scale=0.088, window=window)
    assert k1.launches == before + 1
    ref = k1.flash_attention_plain(q, k, v, scale=0.088, window=window)
    assert _row_rel_err(out, ref) <= TOL_BF16_OUT


def _factors(gen, cuda, s_p, rk, rv, m, int8):
    k_us = torch.randn((1, s_p, rk), generator=gen, device=cuda)
    k_vt = torch.randn((1, rk, m), generator=gen, device=cuda) * 0.05
    v_us = torch.randn((1, s_p, rv), generator=gen, device=cuda)
    v_vt = torch.randn((1, rv, m), generator=gen, device=cuda) * 0.05
    if int8:
        qk, qv = quantize_k_factors(k_us, k_vt), quantize_v_factors(v_us, v_vt)
        return qk.us_q, qk.vt_q, qv.us_q, qv.vt, qv.rank_scale
    bf = torch.bfloat16
    return k_us.to(bf), k_vt.to(bf), v_us.to(bf), v_vt.to(bf), None


@pytest.mark.gpu
@pytest.mark.parametrize("int8,ql,lens,lo", [(False, 1, None, None), (False, 3, 150, 20),
                                             (True, 1, None, None), (True, 2, 180, 70)])
def test_decode_kernels_match_plain(cuda, int8, ql, lens, lo):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    s_p, rk, rv, hq, hkv = 200, 64, 96, 8, 2
    k_us, k_vt, v_us, v_vt, v_scale = _factors(gen, cuda, s_p, rk, rv, hkv * 128, int8)
    lengths = None if lens is None else torch.tensor([lens], device=cuda)
    win_lo = None if lo is None else torch.tensor([lo], device=cuda)
    R = ql * hq
    q_emb = torch.randn((1, R, rk), generator=gen, device=cuda).to(torch.bfloat16) * 0.1
    t2, l2 = k2.rankspace_kernel(q_emb, k_us, v_us, lengths, win_lo)
    t2r, l2r = k2.rankspace_kernel_plain(q_emb, k_us, v_us, lengths, win_lo)
    assert _row_rel_err(t2, t2r) <= TOL_T and _lse_err(l2, l2r) <= TOL_LSE
    theta = torch.arange(s_p, device=cuda)[:, None] * 0.01 * torch.arange(
        1, 65, device=cuda)[None]
    cos_h, sin_h = theta.cos().to(torch.bfloat16), theta.sin().to(torch.bfloat16)
    qab = torch.randn((1, R, 256), generator=gen, device=cuda).to(torch.bfloat16) * 0.1
    args = (qab, k_us, k_vt, v_us, v_vt, cos_h, sin_h, v_scale, lengths, win_lo)
    o3, l3 = k3.lowrank_kernel(*args, num_q_heads=hq, num_kv_heads=hkv)
    o3r, l3r = k3.lowrank_kernel_plain(*args, num_q_heads=hq, num_kv_heads=hkv)
    assert _row_rel_err(o3, o3r) <= TOL_BF16_OUT and _lse_err(l3, l3r) <= TOL_LSE
