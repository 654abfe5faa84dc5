"""The CUDA kernels K1-K11 against their plain versions, on a card.

Marked ``gpu``: each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a machine that has only the
port's dependencies; ``tests/conftest.py`` imports JAX, so there run it as

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

K1 is held at the 8B shape's group size 4 and at group sizes 1, 3 and 7
and head sizes 64 and 128, with and without a sliding window. K3 and K5
likewise at head sizes 64 and 128, group size 7 with several row tiles,
the 8B ranks, ranks whose k_vt slice streams through the ring, and value
ranks past 1024 (1536, 4096). K2, K4 and K6 at the 8B layer (R 32 and 128,
bf16, int8 and the mixed split) and at the edges of their ring and splits:
s_p not a multiple of 64, a valid_len inside one CTA's run of blocks,
win_lo inside a block, two sequences of different lengths, R 84, rv 16 and
1024, a -1 chunk id, a ragged last chunk, K6 splits that are not whole
64-byte boxes, and the wide ranks (rk and rv up to 4096). K7 and K8 at rank
64, at DeepSeek-V2-Lite's widths (rank 512, RoPE 64, 16 heads, ql 1-3,
ragged and two-sequence lengths), and at ranks 1088 and 2048. K4 and K5 at
chunk widths 16, 24, 100 and 512 (each chunk walked as 64-key blocks
masked at its end); K1, K3 and K5 at head sizes 16, 24, 32 and 96, which
their wrappers zero-pad to the built sizes.

Tolerances: each output row is held against its own largest value, since
a row that averages many keys has small values. K1 and K3 round P to bf16
against another maximum than the plain version and round their bf16
output once: 2^-6 (two units in bf16's last place). K2's fp32 t only
carries the rounding of P: 2^-7; so do K6's (mixed int8+int4, whose
unpacked values are exact in bf16) and K4's (K2 over selected chunks).
K5 (K3 over selected chunks) as K3. K7 and K8 (the MLA rank-space decode
over bf16, int8 or int8 + int4 latent factors) round P * r to bf16 in
place of P: K2's 2^-7. The fp32 lse, whose error grows with the scores:
1e-5 of max(1, |lse|).

The kernel-study kernels: K9 (K3's function by other score designs, run
on K3's resident kernel) is held against K3's plain version within K3's
limits: both designs in bf16 and int8, b64, b512 and b2048, rank_v 640 to
1024, the largest resident rank_k, lengths inside a block, group size 7
at ql 3. K10 (stage ablation)
against its plain version at the kernel's split count, in every stage set
at the tool's geometry and at an odd number of kv heads, several blocks a
split, rk 64 and 128 and ragged value widths: its bf16 output
rows carry the rounding of P to bf16 (2^-6), its running max m is fp32
from sums in another order (1e-5 of max(1, |m|), -inf equal to -inf). K11
(tensor-core probe): integer products are exact, so int8 and int4 equal
the plain version bit for bit; bf16 sums in another order can flip the
rounding of the next input (2^-6 of a row's largest value).
"""

import pytest
import torch

from xkv_tpu_torch.compress.quant import (
    pack_int4_pairs,
    quantize_k_factors,
    quantize_v_factors,
)
from xkv_tpu_torch.ops.kernels import flash_attention as k1
from xkv_tpu_torch.ops.kernels import kernel_ablation as k10
from xkv_tpu_torch.ops.kernels import kernel_variants as k9
from xkv_tpu_torch.ops.kernels import probe_int4 as k11
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


# Group sizes 3 (Llama-3.2-3B, 24/8) and 7 (Qwen2-7B, 28/4), head size 64
# (Llama-3.2-1B, 32/8); lengths below one query tile, ragged, and one past
# a power of two; windows not a multiple of the key tile (40), and 512 and
# 4096 (Mistral-7B-v0.1's).
K1_SHAPES = [(24, 8, 128), (28, 4, 128), (32, 8, 64)]
K1_CASES = ([(hq, hkv, hd, s, None) for hq, hkv, hd in K1_SHAPES for s in (40, 1000, 4097)]
            + [(24, 8, 128, 1000, 40), (28, 4, 128, 4097, 512), (32, 8, 64, 4097, 4096),
               (32, 8, 64, 1000, 40), (24, 8, 128, 4097, 4096), (32, 8, 64, 40, 512)])


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,hd,s,window", K1_CASES)
def test_flash_kernel_group_and_head_sizes(cuda, hq, hkv, hd, s, window):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    bf = torch.bfloat16
    q = torch.randn((2, hq, s, hd), generator=gen, device=cuda).to(bf)
    k = torch.randn((2, hkv, s, hd), generator=gen, device=cuda).to(bf)
    v = torch.randn((2, hkv, s, hd), generator=gen, device=cuda).to(bf)
    scale = hd ** -0.5
    before = k1.launches
    out = k1.flash_attention(q, k, v, scale=scale, window=window)
    assert k1.launches == before + 1
    ref = k1.flash_attention_plain(q, k, v, scale=scale, window=window)
    assert out.shape == (2, s, hq, hd)
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


def _half_tables(cuda, s_p):
    theta = torch.arange(s_p, device=cuda)[:, None] * 0.01 * torch.arange(
        1, 65, device=cuda)[None]
    return theta.cos().to(torch.bfloat16), theta.sin().to(torch.bfloat16)


# ids over 4 chunks of 64 rows of a 200-row segment (chunk 3 is ragged);
# -1 selects nothing.
SPARSE_CASES = [(False, [[3, 0]], None, None), (False, [[2, -1, 0]], 150, 20),
                (True, [[0, 3, 1]], None, 70), (True, [[1, 2]], 190, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("int8,ids,lens,lo", SPARSE_CASES)
def test_sparse_kernels_match_plain(cuda, int8, ids, lens, lo):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    s_p, rk, rv, hq, hkv, block = 200, 64, 96, 8, 2, 64
    k_us, k_vt, v_us, v_vt, v_scale = _factors(gen, cuda, s_p, rk, rv, hkv * 128, int8)
    ids = torch.tensor(ids, device=cuda, dtype=torch.int32)
    lengths = None if lens is None else torch.tensor([lens], device=cuda)
    win_lo = None if lo is None else torch.tensor([lo], device=cuda)
    q_emb = torch.randn((1, hq, rk), generator=gen, device=cuda).to(torch.bfloat16) * 0.1
    before = k2.sparse_launches
    t4, l4 = k2.sparse_rankspace_kernel(q_emb, k_us, v_us, ids, block, lengths, win_lo)
    assert k2.sparse_launches == before + 1
    t4r, l4r = k2.sparse_rankspace_kernel_plain(q_emb, k_us, v_us, ids, block, lengths, win_lo)
    assert _row_rel_err(t4, t4r) <= TOL_T and _lse_err(l4, l4r) <= TOL_LSE
    cos_h, sin_h = _half_tables(cuda, s_p)
    qab = torch.randn((1, hq, 256), generator=gen, device=cuda).to(torch.bfloat16) * 0.1
    args = (qab, k_us, k_vt, v_us, v_vt, cos_h, sin_h, v_scale, ids, block, lengths, win_lo)
    before = k3.sparse_launches
    o5, l5 = k3.sparse_lowrank_kernel(*args, num_q_heads=hq, num_kv_heads=hkv)
    assert k3.sparse_launches == before + 1
    o5r, l5r = k3.sparse_lowrank_kernel_plain(*args, num_q_heads=hq, num_kv_heads=hkv)
    assert _row_rel_err(o5, o5r) <= TOL_BF16_OUT and _lse_err(l5, l5r) <= TOL_LSE


# K3 and K5 beyond the main shape: head size 64 (Llama-3.2-1B's 32/8
# reduced to 8/2), group size 7 (Qwen2-7B's 28/4) with ql 3 (21 rows of a
# head: two row tiles), the 8B ranks at a ragged length, ranks whose k_vt
# slice does not fit in shared memory (streamed through the ring), and
# value ranks past 1024.
# The vt slices are layer 1 of a 4-layer group's wider basis, as on the
# main path. (hq, hkv, hd, s_p, rk, rv, int8, ql, valid_len, win_lo)
LOWRANK_SHAPES = [
    (8, 2, 64, 200, 64, 96, False, 1, None, None),
    (8, 2, 64, 200, 64, 96, True, 2, 180, 30),
    (8, 2, 64, 1000, 256, 384, False, 1, 990, None),
    (28, 4, 128, 200, 64, 96, False, 3, 150, 20),
    (28, 4, 128, 200, 128, 96, True, 1, None, 70),
    (8, 2, 128, 1000, 512, 768, False, 1, 1000, None),
    (8, 2, 128, 1000, 512, 768, True, 2, 777, 100),
    (8, 2, 128, 300, 1024, 256, False, 1, None, None),
    (8, 2, 128, 300, 1408, 96, True, 1, 250, None),
    (8, 2, 64, 300, 1280, 128, False, 1, None, 40),
    # Past 1024 value ranks (value slices), at both head sizes, resident and
    # streamed k_vt.
    (8, 2, 64, 300, 256, 1536, False, 1, None, None),
    (8, 2, 64, 300, 256, 1536, True, 2, 250, 20),
    (8, 2, 128, 300, 512, 1536, False, 2, 280, None),
    (8, 2, 128, 300, 512, 1536, True, 1, None, 30),
    (8, 2, 128, 200, 1024, 4096, False, 1, 190, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,hd,s_p,rk,rv,int8,ql,lens,lo", LOWRANK_SHAPES)
def test_lowrank_kernels_shapes(cuda, hq, hkv, hd, s_p, rk, rv, int8, ql, lens, lo):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(9)
    m = hkv * hd
    k_us, k_vt, v_us, v_vt, v_scale = _factors(gen, cuda, s_p, rk, rv, 4 * m, int8)
    k_vt, v_vt = k_vt[:, :, m:2 * m], v_vt[:, :, m:2 * m]
    lengths = None if lens is None else torch.tensor([lens], device=cuda)
    win_lo = None if lo is None else torch.tensor([lo], device=cuda)
    theta = torch.arange(s_p, device=cuda)[:, None] * 0.01 * torch.arange(
        1, hd // 2 + 1, device=cuda)[None]
    cos_h, sin_h = theta.cos().to(torch.bfloat16), theta.sin().to(torch.bfloat16)
    kw = dict(num_q_heads=hq, num_kv_heads=hkv)
    # Scores of a few tenths: int8 factors rebuild keys ~2e4 times larger.
    scale = 0.5 / rk ** 0.5 / (2e4 if int8 else 1.0)
    qab = (torch.randn((1, ql * hq, 2 * hd), generator=gen, device=cuda) * scale).to(
        torch.bfloat16)
    args = (qab, k_us, k_vt, v_us, v_vt, cos_h, sin_h, v_scale, lengths, win_lo)
    before = k3.launches
    o3, l3 = k3.lowrank_kernel(*args, **kw)
    assert k3.launches == before + 1
    o3r, l3r = k3.lowrank_kernel_plain(*args, **kw)
    assert o3.shape == (1, ql * hq, hd)
    assert _row_rel_err(o3, o3r) <= TOL_BF16_OUT and _lse_err(l3, l3r) <= TOL_LSE
    # K5 over chunks of 64 rows: one past valid_len, one cut by win_lo, -1.
    nc = -(-s_p // 64)
    ids = torch.tensor([[nc - 1, 0, -1, nc // 2]], device=cuda, dtype=torch.int32)
    a5 = (qab[:, :hq], k_us, k_vt, v_us, v_vt, cos_h, sin_h, v_scale, ids, 64, lengths, win_lo)
    before = k3.sparse_launches
    o5, l5 = k3.sparse_lowrank_kernel(*a5, **kw)
    assert k3.sparse_launches == before + 1
    o5r, l5r = k3.sparse_lowrank_kernel_plain(*a5, **kw)
    assert _row_rel_err(o5, o5r) <= TOL_BF16_OUT and _lse_err(l5, l5r) <= TOL_LSE


@pytest.mark.gpu
def test_lowrank_streams_only_large_slices(cuda):
    """The k_vt slice stays resident at the main paths' ranks and streams
    where it does not fit (the cases above)."""
    assert not k3.streams_kvt(128, 512, False) and not k3.streams_kvt(64, 256, False)
    assert not k3.streams_kvt(128, 512, True) and not k3.streams_kvt(64, 256, True)
    assert k3.streams_kvt(128, 1024, False) and k3.streams_kvt(128, 1408, True)
    assert k3.streams_kvt(64, 1280, False)


@pytest.mark.gpu
def test_sparse_all_chunks_matches_dense_kernel(cuda):
    """Every chunk selected, in another order: K4 reads the rows K2 reads."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    s_p, rk, rv, hq = 200, 64, 96, 8
    k_us, _, v_us, _, _ = _factors(gen, cuda, s_p, rk, rv, 256, False)
    q_emb = torch.randn((1, hq, rk), generator=gen, device=cuda).to(torch.bfloat16) * 0.1
    ids = torch.tensor([[2, 0, 3, 1]], device=cuda, dtype=torch.int32)
    t4, l4 = k2.sparse_rankspace_kernel(q_emb, k_us, v_us, ids, 64)
    t2, l2 = k2.rankspace_kernel(q_emb, k_us, v_us)
    assert _row_rel_err(t4, t2) <= TOL_T and _lse_err(l4, l2) <= TOL_LSE


def _mixed(gen, cuda, s_p, r8, r4):
    us8 = torch.randint(-127, 128, (1, s_p, r8), generator=gen, device=cuda).to(torch.int8)
    q4 = torch.randint(-7, 8, (1, s_p, r4), generator=gen, device=cuda)
    return us8, pack_int4_pairs(q4)


@pytest.mark.gpu
@pytest.mark.parametrize("r8k,r4k,r8v,r4v,lens,lo", [(16, 48, 24, 72, None, None),
                                                     (16, 48, 24, 72, 150, 30),
                                                     (256, 256, 256, 512, None, 10)])
def test_mixed_kernel_matches_plain(cuda, r8k, r4k, r8v, r4v, lens, lo):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    s_p, hq = 200, 8
    k8, k4 = _mixed(gen, cuda, s_p, r8k, r4k)
    v8, v4 = _mixed(gen, cuda, s_p, r8v, r4v)
    lengths = None if lens is None else torch.tensor([lens], device=cuda)
    win_lo = None if lo is None else torch.tensor([lo], device=cuda)
    q_emb = (torch.randn((1, hq, r8k + r4k), generator=gen, device=cuda) * 0.01).to(
        torch.bfloat16)
    before = k2.mixed_launches
    t6, l6 = k2.mixed_rankspace_kernel(q_emb, k8, k4, v8, v4, lengths, win_lo)
    assert k2.mixed_launches == before + 1
    t6r, l6r = k2.mixed_rankspace_kernel_plain(q_emb, k8, k4, v8, v4, lengths, win_lo)
    assert _row_rel_err(t6, t6r) <= TOL_T and _lse_err(l6, l6r) <= TOL_LSE


# (kind, ql, valid_len(s), rank, heads, RoPE width, b), s_p 200 (not a
# multiple of 64): rank 64 at 8 heads and RoPE 16; DeepSeek-V2-Lite's
# widths (16 heads, RoPE 64, rank 512: bf16, int8, 256 int8 + 256 int4) at
# ql 1, 2, 3 (R 16, 32, 48: several row tiles), a length shorter than one
# block and two sequences of different lengths; rank 1088 (two value
# slices) and 2048 (the full rank of V2-Lite's groups of 4 layers).
MLA_CASES = [("bf16", 1, None, 64, 8, 16, 1), ("bf16", 2, 150, 64, 8, 16, 1),
             ("int8", 1, 37, 64, 8, 16, 1), ("int8+int4", 1, None, 64, 8, 16, 1),
             ("int8+int4", 2, 190, 64, 8, 16, 1),
             ("bf16", 1, None, 512, 16, 64, 1), ("bf16", 2, 150, 512, 16, 64, 1),
             ("bf16", 3, 37, 512, 16, 64, 1), ("int8", 1, 190, 512, 16, 64, 1),
             ("int8", 3, None, 512, 16, 64, 1), ("int8+int4", 1, None, 512, 16, 64, 1),
             ("int8+int4", 2, 37, 512, 16, 64, 1), ("bf16", 1, (200, 45), 512, 16, 64, 2),
             ("int8", 2, (70, 199), 512, 16, 64, 2), ("int8+int4", 3, (30, 200), 512, 16, 64, 2),
             ("bf16", 1, 150, 1088, 16, 64, 1), ("int8", 2, None, 1088, 16, 64, 1),
             ("int8+int4", 1, 190, 1088, 16, 64, 1),
             ("bf16", 1, None, 2048, 8, 16, 1), ("bf16", 2, 150, 2048, 8, 16, 1),
             ("int8", 2, 37, 2048, 8, 16, 1), ("int8+int4", 1, 190, 2048, 8, 16, 1),
             ("int8+int4", 2, None, 2048, 8, 16, 1), ("bf16", 3, 199, 2048, 16, 64, 1)]
# The mixed splits: whole 64-byte boxes (TMA) except at rank 64 and at
# rank 2048 ql 2, whose parts are not whole 16-byte units (gathered).
MLA_INT8_RANKS = {64: 16, 512: 256, 1088: 576, 2048: 1024}


@pytest.mark.gpu
@pytest.mark.parametrize("kind,ql,lens,rk,nh,rope,b", MLA_CASES)
def test_mla_kernels_match_plain(cuda, kind, ql, lens, rk, nh, rope, b):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    s_p = 200
    bf = torch.bfloat16
    R = ql * nh
    q_emb = (torch.randn((b, R, rk), generator=gen, device=cuda) * 0.4 / rk ** 0.5).to(bf)
    q_pe = (torch.randn((b, R, rope), generator=gen, device=cuda) * 0.1).to(bf)
    k_pe = torch.randn((b, s_p, rope), generator=gen, device=cuda).to(bf)
    r = torch.rand((b, s_p), generator=gen, device=cuda) + 0.5
    lengths = None if lens is None else torch.tensor(
        lens if isinstance(lens, tuple) else [lens], device=cuda)
    if kind == "int8+int4":
        r8 = MLA_INT8_RANKS[rk] + (8 * (ql - 1) if rk == 2048 else 0)
        us8 = torch.randint(-127, 128, (b, s_p, r8), generator=gen, device=cuda).to(torch.int8)
        us4 = pack_int4_pairs(torch.randint(-7, 8, (b, s_p, rk - r8), generator=gen,
                                            device=cuda))
        args = (q_emb * 0.02, q_pe, us8, us4, k_pe, r, lengths)
        run, plain, counter = (k2.mla_mixed_rankspace_kernel,
                               k2.mla_mixed_rankspace_kernel_plain, "mla_mixed_launches")
    else:
        us = torch.randn((b, s_p, rk), generator=gen, device=cuda)
        if kind == "int8":
            us, q_emb = (us * 40).round().clamp(-127, 127).to(torch.int8), q_emb * 0.02
        args = (q_emb, q_pe, us.to(bf) if kind == "bf16" else us, k_pe, r, lengths)
        run, plain, counter = (k2.mla_rankspace_kernel, k2.mla_rankspace_kernel_plain,
                               "mla_launches")
    before = getattr(k2, counter)
    t, lse = run(*args)
    assert getattr(k2, counter) == before + 1
    t_ref, lse_ref = plain(*args)
    assert t.shape == (b, R, rk) and lse.shape == (b, R)
    assert _row_rel_err(t, t_ref) <= TOL_T and _lse_err(lse, lse_ref) <= TOL_LSE


@pytest.mark.gpu
def test_mla_wrapper_refuses_fp32_factors_on_cuda(cuda):
    """A CUDA tensor launches the kernel or raises: fp32 factors, which the
    kernel does not take, raise instead of running the plain version."""
    s_p, rk, rope = 64, 32, 16
    with pytest.raises(ValueError, match="k_us dtype"):
        k2.mla_rankspace_decode_attention(
            torch.zeros((1, 2, 1, rk), device=cuda), torch.zeros((1, 2, 1, rope), device=cuda),
            torch.zeros((1, s_p, rk), device=cuda), torch.zeros((1, s_p, rope), device=cuda),
            torch.ones((1, s_p), device=cuda))


# (variant, int8, rk, rv, s_p, lengths, hq, ql): both designs in bf16 and
# int8, b<N> at 64, 512 (several splits) and 2048 (a last split of one
# ragged block), rv 640, 768 and 1024, the largest resident rk (512 bf16,
# 1024 int8), lengths that end inside a block, and group size 7 at ql 3 (two
# row tiles of a head).
VARIANT_CASES = [
    ("two_gemm", False, 64, 640, 200, None, 8, 1), ("two_gemm", True, 64, 640, 200, 170, 8, 1),
    ("two_gemm", True, 1024, 1024, 300, 299, 8, 1), ("two_gemm", False, 512, 768, 260, 250, 14, 3),
    ("scratch_ab", False, 512, 1024, 300, 250, 8, 1),
    ("scratch_ab", True, 1024, 640, 200, None, 8, 1),
    ("scratch_ab", True, 128, 768, 260, 199, 14, 3),
    ("b64", False, 64, 640, 200, 150, 8, 1), ("b512", True, 128, 1024, 1100, 1000, 8, 1),
    ("b512", False, 512, 640, 1100, None, 8, 1), ("b2048", False, 512, 768, 2100, None, 8, 1),
    ("b2048", True, 1024, 768, 2100, 2090, 8, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("variant,int8,rk,rv,s_p,lens,hq,ql", VARIANT_CASES)
def test_variant_kernels_match_k3_plain(cuda, variant, int8, rk, rv, s_p, lens, hq, ql):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6)
    hkv = 2
    k_us, k_vt, v_us, v_vt, v_scale = _factors(gen, cuda, s_p, rk, rv, hkv * 128, int8)
    lengths = None if lens is None else torch.tensor([lens], device=cuda)
    cos_h, sin_h = _half_tables(cuda, s_p)
    qab = torch.randn((1, ql * hq, 256), generator=gen, device=cuda).to(torch.bfloat16) * 0.1
    rest = (k_us, k_vt, v_us, v_vt, cos_h, sin_h, v_scale)
    before = k9.launches
    o, lse = k9.variant_kernel(qab, *rest, lengths, num_q_heads=hq, num_kv_heads=hkv,
                               variant=variant)
    assert k9.launches == before + 1
    o_ref, l_ref = k3.lowrank_kernel_plain(qab, *rest, lengths, None, num_q_heads=hq,
                                           num_kv_heads=hkv)
    assert _row_rel_err(o, o_ref) <= TOL_BF16_OUT and _lse_err(lse, l_ref) <= TOL_LSE


@pytest.mark.gpu
def test_variant_resident_ranks_are_k3s(cuda):
    """K9's rank_k limit is where K3 stops keeping the k_vt slice resident."""
    for dtype, rk in k9.RESIDENT_RANK_K.items():
        int8 = dtype == torch.int8
        assert not k3.streams_kvt(128, rk, int8) and k3.streams_kvt(128, rk + 64, int8)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [c[0] for c in k10.configs()])
def test_ablation_kernel_matches_plain(cuda, name):
    s, hq, hkv, rk, rv = 320, 8, 2, 64, 768
    stages = dict(k10.configs())[name]
    ops = k10.inputs(1, s, hq, hkv, 128, rk, rv, cuda, seed=7)
    args = (*ops, *k10.tables(s, 128, stages, cuda), stages)
    nsplit = k10.num_splits(1, s, cuda)
    before = k10.launches
    out, m = k10.ablation_step(*args, num_kv_heads=hkv, nsplit=nsplit)
    assert k10.launches == before + 1
    ref, m_ref = k10.ablation_step_plain(*args, num_kv_heads=hkv, nsplit=nsplit)
    assert _row_rel_err(out, ref) <= TOL_BF16_OUT
    inf = torch.isinf(m_ref)
    assert torch.equal(torch.isinf(m), inf)
    assert _lse_err(m[~inf], m_ref[~inf]) <= TOL_LSE if (~inf).any() else True


# (kind, M, K): small and ragged M, then at every K and kind the probe's M
# 512, chip_smoke.py's 2 * 32 * 132 = 8448 and a ragged 777.
PROBE_CASES = [("bf16", 64, 128), ("int8", 100, 256), ("int4", 70, 512), ("int8", 40, 512),
               ("bf16", 33, 512)] + [(kind, m, k) for kind in ("bf16", "int8", "int4")
                                     for k in (128, 256, 512) for m in (512, 8448, 777)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,m,k", PROBE_CASES)
def test_probe_kernel_matches_plain(cuda, kind, m, k):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(8)
    if kind == "bf16":
        x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
        w = torch.randn((k, k), generator=gen, device=cuda).to(torch.bfloat16)
    else:
        x = torch.randint(-8, 8, (m, k), generator=gen, device=cuda, dtype=torch.int8)
        w = torch.randint(-8, 8, (k, k), generator=gen, device=cuda, dtype=torch.int8)
    before = k11.launches
    got = k11.gemm_chain(x, w, 7, kind)
    assert k11.launches == before + 1
    ref = k11.gemm_chain_plain(x, w, 7, kind)
    if kind == "bf16":
        assert _row_rel_err(got, ref) <= TOL_BF16_OUT
    else:
        assert torch.equal(got, ref)
    if kind == "int4":
        assert torch.equal(got, k11.gemm_chain(x, w, 7, "int8"))


def _rs_factors(gen, cuda, b, s_p, rk, rv, dtype):
    """k_us, v_us and a q_emb whose scores are a few tenths."""
    if dtype == "int8":
        k_us = torch.randint(-127, 128, (b, s_p, rk), generator=gen, device=cuda).to(torch.int8)
        v_us = torch.randint(-127, 128, (b, s_p, rv), generator=gen, device=cuda).to(torch.int8)
        scale = 0.5 / rk ** 0.5 / 73.0
    else:
        k_us = torch.randn((b, s_p, rk), generator=gen, device=cuda).to(torch.bfloat16)
        v_us = torch.randn((b, s_p, rv), generator=gen, device=cuda).to(torch.bfloat16)
        scale = 0.5 / rk ** 0.5
    return k_us, v_us, scale


def _live(cuda, vals):
    return None if vals is None else torch.tensor(vals, device=cuda)


# K2 at the 8B layer (s_p 8192, rk 512, rv 768) at ql 1 and 4 (R 32, 128),
# bf16 and int8, then the edges of the ring and of the splits: s_p not a
# multiple of 64, a valid_len inside one CTA's run of blocks, win_lo inside
# a block, two sequences of different lengths, R 84 (28 heads x ql 3), rv
# 16 and 1024, rk 16; then the wide ranks.
# (dtype, b, R, s_p, rk, rv, valid_len, win_lo)
RS_CASES = [
    ("bf16", 1, 32, 8192, 512, 768, None, None),
    ("int8", 1, 32, 8192, 512, 768, None, None),
    ("bf16", 1, 128, 8192, 512, 768, None, None),
    ("int8", 1, 128, 8192, 512, 768, [8000], [1000]),
    ("bf16", 1, 32, 1000, 512, 768, None, None),
    ("int8", 1, 32, 8192, 512, 768, [150], None),
    ("bf16", 1, 32, 4096, 512, 768, None, [1000]),
    ("bf16", 2, 32, 3000, 512, 768, [3000, 1234], [0, 70]),
    ("int8", 2, 84, 2000, 512, 768, [1900, 2000], None),
    ("bf16", 1, 32, 1000, 64, 16, None, None),
    ("int8", 1, 32, 1000, 256, 1024, None, [10]),
    ("bf16", 1, 32, 100, 16, 1024, [77], None),
    # rk = rv = 4096 (q_emb streams beside the key panels), and rv 1536 at R
    # 128 (two 1024-rank value slices).
    ("bf16", 1, 32, 1000, 4096, 4096, None, None),
    ("int8", 1, 32, 1000, 4096, 4096, [900], [10]),
    ("bf16", 1, 128, 1000, 512, 1536, None, [70]),
    ("int8", 1, 128, 1000, 512, 1536, [999], None),
    ("bf16", 2, 64, 300, 3072, 1040, [300, 200], None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,R,s_p,rk,rv,lens,lo", RS_CASES)
def test_rankspace_kernel_shapes(cuda, dtype, b, R, s_p, rk, rv, lens, lo):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    k_us, v_us, scale = _rs_factors(gen, cuda, b, s_p, rk, rv, dtype)
    q_emb = (torch.randn((b, R, rk), generator=gen, device=cuda) * scale).to(torch.bfloat16)
    lengths, win_lo = _live(cuda, lens), _live(cuda, lo)
    before = k2.launches
    t2, l2 = k2.rankspace_kernel(q_emb, k_us, v_us, lengths, win_lo)
    assert k2.launches == before + 1
    t2r, l2r = k2.rankspace_kernel_plain(q_emb, k_us, v_us, lengths, win_lo)
    assert t2.shape == (b, R, rv) and l2.shape == (b, R)
    assert _row_rel_err(t2, t2r) <= TOL_T and _lse_err(l2, l2r) <= TOL_LSE


# K4 over 512-row chunks of a segment whose last chunk is ragged (s_p 8092):
# the main path's top-4, a -1 id, and a window inside chunk 1.
# (dtype, ids, valid_len, win_lo)
K4_CASES = [("bf16", [[15, 3, 9, 0]], None, None), ("int8", [[15, -1, 3, 7]], None, None),
            ("bf16", [[1, 15, -1, -1]], [8000], [1000]), ("int8", [[0, 2, 15, 1]], None, [700])]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,ids,lens,lo", K4_CASES)
def test_sparse_rankspace_kernel_ragged_chunks(cuda, dtype, ids, lens, lo):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(12)
    s_p, rk, rv, R = 8092, 512, 768, 32
    k_us, v_us, scale = _rs_factors(gen, cuda, 1, s_p, rk, rv, dtype)
    q_emb = (torch.randn((1, R, rk), generator=gen, device=cuda) * scale).to(torch.bfloat16)
    ids = torch.tensor(ids, device=cuda, dtype=torch.int32)
    lengths, win_lo = _live(cuda, lens), _live(cuda, lo)
    before = k2.sparse_launches
    t4, l4 = k2.sparse_rankspace_kernel(q_emb, k_us, v_us, ids, 512, lengths, win_lo)
    assert k2.sparse_launches == before + 1
    t4r, l4r = k2.sparse_rankspace_kernel_plain(q_emb, k_us, v_us, ids, 512, lengths, win_lo)
    assert _row_rel_err(t4, t4r) <= TOL_T and _lse_err(l4, l4r) <= TOL_LSE


# K6 at the 8B split (256 + 256 int8/int4 K ranks, 256 + 512 V ranks), at
# ql 1 and 4 and R 84, and a split of no whole 64-byte boxes (gathered
# panels) over two sequences and at R 64 (two row tiles); rk 4096 with rv
# 2048 in boxes and, gathered, at R 64 (streamed q_emb, value slices).
# (r8k, r4k, r8v, r4v, b, R, s_p, valid_len, win_lo)
K6_CASES = [(256, 256, 256, 512, 1, 32, 8192, None, None),
            (256, 256, 256, 512, 1, 128, 8192, [8100], [1000]),
            (256, 256, 256, 512, 2, 84, 1000, [1000, 333], [0, 40]),
            (16, 48, 24, 72, 2, 32, 1000, [999, 64], None),
            (16, 48, 24, 72, 1, 64, 300, None, [70]),
            (2048, 2048, 1024, 1024, 1, 32, 1000, None, None),
            (16, 4080, 24, 2024, 1, 64, 300, [290], [70])]


@pytest.mark.gpu
@pytest.mark.parametrize("r8k,r4k,r8v,r4v,b,R,s_p,lens,lo", K6_CASES)
def test_mixed_kernel_shapes(cuda, r8k, r4k, r8v, r4v, b, R, s_p, lens, lo):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(13)
    us8 = torch.randint(-127, 128, (b, s_p, r8k), generator=gen, device=cuda).to(torch.int8)
    k4 = pack_int4_pairs(torch.randint(-7, 8, (b, s_p, r4k), generator=gen, device=cuda))
    v8 = torch.randint(-127, 128, (b, s_p, r8v), generator=gen, device=cuda).to(torch.int8)
    v4 = pack_int4_pairs(torch.randint(-7, 8, (b, s_p, r4v), generator=gen, device=cuda))
    rk = r8k + r4k
    q_emb = (torch.randn((b, R, rk), generator=gen, device=cuda) * (0.5 / rk ** 0.5 / 40)).to(
        torch.bfloat16)
    lengths, win_lo = _live(cuda, lens), _live(cuda, lo)
    before = k2.mixed_launches
    t6, l6 = k2.mixed_rankspace_kernel(q_emb, us8, k4, v8, v4, lengths, win_lo)
    assert k2.mixed_launches == before + 1
    t6r, l6r = k2.mixed_rankspace_kernel_plain(q_emb, us8, k4, v8, v4, lengths, win_lo)
    assert t6.shape == (b, R, r8v + r4v)
    assert _row_rel_err(t6, t6r) <= TOL_T and _lse_err(l6, l6r) <= TOL_LSE


# K4 past 1024 value ranks: the top-4 of 512-row chunks at R 32 (256-rank
# slices) and R 128 (1024-rank slices), and rk 4096. (dtype, R, rk, rv)
K4_WIDE = [("bf16", 32, 512, 1536), ("int8", 32, 512, 1536), ("bf16", 128, 512, 1536),
           ("int8", 32, 4096, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,R,rk,rv", K4_WIDE)
def test_sparse_rankspace_kernel_wide_ranks(cuda, dtype, R, rk, rv):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(14)
    s_p = 4000
    k_us, v_us, scale = _rs_factors(gen, cuda, 1, s_p, rk, rv, dtype)
    q_emb = (torch.randn((1, R, rk), generator=gen, device=cuda) * scale).to(torch.bfloat16)
    ids = torch.tensor([[7, 0, 3, -1]], device=cuda, dtype=torch.int32)
    before = k2.sparse_launches
    t4, l4 = k2.sparse_rankspace_kernel(q_emb, k_us, v_us, ids, 512, None, None)
    assert k2.sparse_launches == before + 1
    t4r, l4r = k2.sparse_rankspace_kernel_plain(q_emb, k_us, v_us, ids, 512, None, None)
    assert t4.shape == (1, R, rv)
    assert _row_rel_err(t4, t4r) <= TOL_T and _lse_err(l4, l4r) <= TOL_LSE


# K4 and K5 at chunk widths that are not multiples of 64, each chunk walked
# as ceil(width / 64) blocks of 64 keys masked at the chunk's end: widths
# 16 and 24 (the port's engine tests and tiny_llama_config's runs), 100
# (two blocks, the second ragged), and 512 (the main path's). A -1 id, the
# last chunk past s_p 1000, a valid_len and a window inside a chunk.
# (block, dtype, ids, valid_len, win_lo)
CHUNK_CASES = [(16, "bf16", [[3, 40, 7, -1]], None, None),
               (16, "int8", [[0, 62, 5, 9]], [1000], [20]),
               (24, "bf16", [[41, 2, 17, 0]], [990], None),
               (24, "int8", [[1, -1, 30, 12]], None, [30]),
               (100, "bf16", [[9, 0, 4, 7]], None, [150]),
               (100, "int8", [[5, 9, -1, 2]], [950], None),
               (512, "bf16", [[1, 0]], [1000], [100])]


@pytest.mark.gpu
@pytest.mark.parametrize("block,dtype,ids,lens,lo", CHUNK_CASES)
def test_sparse_kernels_any_chunk_width(cuda, block, dtype, ids, lens, lo):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(15)
    s_p, rk, rv, R = 1000, 512, 768, 32
    k_us, v_us, scale = _rs_factors(gen, cuda, 1, s_p, rk, rv, dtype)
    q_emb = (torch.randn((1, R, rk), generator=gen, device=cuda) * scale).to(torch.bfloat16)
    ids = torch.tensor(ids, device=cuda, dtype=torch.int32)
    lengths, win_lo = _live(cuda, lens), _live(cuda, lo)
    before = k2.sparse_launches
    t4, l4 = k2.sparse_rankspace_kernel(q_emb, k_us, v_us, ids, block, lengths, win_lo)
    assert k2.sparse_launches == before + 1
    t4r, l4r = k2.sparse_rankspace_kernel_plain(q_emb, k_us, v_us, ids, block, lengths, win_lo)
    assert _row_rel_err(t4, t4r) <= TOL_T and _lse_err(l4, l4r) <= TOL_LSE
    # K5 at the 8B head geometry (8/2 heads), layer 1 of a group's basis.
    hq, hkv, hd = 8, 2, 128
    m = hkv * hd
    k_us5, k_vt, v_us5, v_vt, v_scale = _factors(gen, cuda, s_p, 512, 768, 4 * m,
                                                 dtype == "int8")
    k_vt, v_vt = k_vt[:, :, m:2 * m], v_vt[:, :, m:2 * m]
    cos_h, sin_h = _half_tables(cuda, s_p)
    qscale = 0.5 / 512 ** 0.5 / (2e4 if dtype == "int8" else 1.0)
    qab = (torch.randn((1, hq, 2 * hd), generator=gen, device=cuda) * qscale).to(torch.bfloat16)
    args = (qab, k_us5, k_vt, v_us5, v_vt, cos_h, sin_h, v_scale, ids, block, lengths, win_lo)
    kw = dict(num_q_heads=hq, num_kv_heads=hkv)
    before = k3.sparse_launches
    o5, l5 = k3.sparse_lowrank_kernel(*args, **kw)
    assert k3.sparse_launches == before + 1
    o5r, l5r = k3.sparse_lowrank_kernel_plain(*args, **kw)
    assert _row_rel_err(o5, o5r) <= TOL_BF16_OUT and _lse_err(l5, l5r) <= TOL_LSE


# Head sizes other than 64 and 128, which the wrappers zero-pad to the next
# built size (K1 at the end of each head, K3 and K5 per RoPE half):
# tiny_llama_config's 16, the examples' 24 and 32, and 96. K1 with and
# without a window; K3 at ql 2 with a window, K5 over 24-row chunks.
@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 24, 32, 96])
@pytest.mark.parametrize("int8", [False, True])
def test_padded_head_sizes_match_plain(cuda, hd, int8):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(16)
    bf = torch.bfloat16
    hq, hkv = 4, 2
    if not int8:  # K1 takes bf16 only
        for window in (None, 40):
            q = torch.randn((2, hq, 300, hd), generator=gen, device=cuda).to(bf)
            k = torch.randn((2, hkv, 300, hd), generator=gen, device=cuda).to(bf)
            v = torch.randn((2, hkv, 300, hd), generator=gen, device=cuda).to(bf)
            before = k1.launches
            out = k1.flash_attention(q, k, v, scale=hd ** -0.5, window=window)
            assert k1.launches == before + 1
            ref = k1.flash_attention_plain(q, k, v, scale=hd ** -0.5, window=window)
            assert out.shape == (2, 300, hq, hd) and out.is_contiguous()
            assert _row_rel_err(out, ref) <= TOL_BF16_OUT
    s_p, rk, rv, m = 300, 64, 96, hkv * hd
    k_us, k_vt, v_us, v_vt, v_scale = _factors(gen, cuda, s_p, rk, rv, 4 * m, int8)
    k_vt, v_vt = k_vt[:, :, m:2 * m], v_vt[:, :, m:2 * m]
    theta = torch.arange(s_p, device=cuda)[:, None] * 0.01 * torch.arange(
        1, hd // 2 + 1, device=cuda)[None]
    cos_h, sin_h = theta.cos().to(bf), theta.sin().to(bf)
    kw = dict(num_q_heads=hq, num_kv_heads=hkv)
    scale = 0.5 / rk ** 0.5 / (2e4 if int8 else 1.0)
    qab = (torch.randn((1, 2 * hq, 2 * hd), generator=gen, device=cuda) * scale).to(bf)
    lengths, win_lo = torch.tensor([290], device=cuda), torch.tensor([30], device=cuda)
    args = (qab, k_us, k_vt, v_us, v_vt, cos_h, sin_h, v_scale, lengths, win_lo)
    before = k3.launches
    o3, l3 = k3.lowrank_kernel(*args, **kw)
    assert k3.launches == before + 1
    o3r, l3r = k3.lowrank_kernel_plain(*args, **kw)
    assert o3.shape == (1, 2 * hq, hd)
    assert _row_rel_err(o3, o3r) <= TOL_BF16_OUT and _lse_err(l3, l3r) <= TOL_LSE
    ids = torch.tensor([[12, 0, -1, 5]], device=cuda, dtype=torch.int32)
    a5 = (qab[:, :hq], k_us, k_vt, v_us, v_vt, cos_h, sin_h, v_scale, ids, 24, lengths, win_lo)
    before = k3.sparse_launches
    o5, l5 = k3.sparse_lowrank_kernel(*a5, **kw)
    assert k3.sparse_launches == before + 1
    o5r, l5r = k3.sparse_lowrank_kernel_plain(*a5, **kw)
    assert o5.shape == (1, hq, hd)
    assert _row_rel_err(o5, o5r) <= TOL_BF16_OUT and _lse_err(l5, l5r) <= TOL_LSE


# K10 beyond the tool's geometry: an odd number of kv heads (one warpgroup
# takes one head more), hq below 32, several blocks a split (their online
# softmax and the held k_us buffer across blocks), rk 128 and a ragged value
# width (a v_us stage of one box); hkv * hd a multiple of rk, as -recon
# needs. (hq, hkv, s, rk, rv, nsplit)
ABL_SHAPES = [(8, 3, 640, 128, 208, 3), (32, 8, 1024, 512, 768, 5), (5, 1, 256, 64, 128, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,s,rk,rv,nsplit", ABL_SHAPES)
@pytest.mark.parametrize("name", [c[0] for c in k10.configs()])
def test_ablation_kernel_shapes(cuda, name, hq, hkv, s, rk, rv, nsplit):
    stages = dict(k10.configs())[name]
    ops = k10.inputs(1, s, hq, hkv, 128, rk, rv, cuda, seed=8)
    args = (*ops, *k10.tables(s, 128, stages, cuda), stages)
    out, m = k10.ablation_step(*args, num_kv_heads=hkv, nsplit=nsplit)
    ref, m_ref = k10.ablation_step_plain(*args, num_kv_heads=hkv, nsplit=nsplit)
    assert _row_rel_err(out, ref) <= TOL_BF16_OUT
    inf = torch.isinf(m_ref)
    assert torch.equal(torch.isinf(m), inf)
    assert _lse_err(m[~inf], m_ref[~inf]) <= TOL_LSE if (~inf).any() else True


# The speculative verify pass at the 8B shapes: ql = draft_k + 1 = 8 tokens
# of 32 query heads (R 256, eight row tiles), s_p 8192, rank_k 512, rank_v
# 768, 8 kv heads of 128; K6 with the xKV-4 int4 splits (K 256 + 256, V
# 256 + 512 int8 + int4 ranks). K3 the same rows as pre-RoPE [qa | qb].
@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K2", "K2 int8", "K3", "K6"])
def test_verify_pass_kernels_at_ql8(cuda, kernel):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(9)
    s_p, rk, rv, hq, hkv, ql = 8192, 512, 768, 32, 8, 8
    R = ql * hq
    lengths = torch.tensor([s_p - 37], device=cuda)
    if kernel == "K6":
        k8, k4 = _mixed(gen, cuda, s_p, 256, 256)
        v8, v4 = _mixed(gen, cuda, s_p, 256, 512)
        q_emb = (torch.randn((1, R, rk), generator=gen, device=cuda) * 0.002).to(
            torch.bfloat16)
        before = k2.mixed_launches
        t, lse = k2.mixed_rankspace_kernel(q_emb, k8, k4, v8, v4, lengths)
        assert k2.mixed_launches == before + 1
        t_ref, lse_ref = k2.mixed_rankspace_kernel_plain(q_emb, k8, k4, v8, v4, lengths)
        assert t.shape == (1, R, rv)
        assert _row_rel_err(t, t_ref) <= TOL_T and _lse_err(lse, lse_ref) <= TOL_LSE
        return
    k_us, k_vt, v_us, v_vt, v_scale = _factors(gen, cuda, s_p, rk, rv, hkv * 128,
                                               kernel == "K2 int8")
    if kernel.startswith("K2"):
        scale = 0.1 / rk ** 0.5 / (50.0 if kernel == "K2 int8" else 1.0)
        q_emb = (torch.randn((1, R, rk), generator=gen, device=cuda) * scale).to(
            torch.bfloat16)
        before = k2.launches
        t, lse = k2.rankspace_kernel(q_emb, k_us, v_us, lengths)
        assert k2.launches == before + 1
        t_ref, lse_ref = k2.rankspace_kernel_plain(q_emb, k_us, v_us, lengths)
        assert t.shape == (1, R, rv)
        assert _row_rel_err(t, t_ref) <= TOL_T and _lse_err(lse, lse_ref) <= TOL_LSE
        return
    cos_h, sin_h = _half_tables(cuda, s_p)
    qab = (torch.randn((1, R, 256), generator=gen, device=cuda) * 0.1).to(torch.bfloat16)
    args = (qab, k_us, k_vt, v_us, v_vt, cos_h, sin_h, v_scale, lengths, None)
    before = k3.launches
    o3, l3 = k3.lowrank_kernel(*args, num_q_heads=hq, num_kv_heads=hkv)
    assert k3.launches == before + 1
    o3r, l3r = k3.lowrank_kernel_plain(*args, num_q_heads=hq, num_kv_heads=hkv)
    assert o3.shape == (1, R, 128)
    assert _row_rel_err(o3, o3r) <= TOL_BF16_OUT and _lse_err(l3, l3r) <= TOL_LSE


# K7 over a speculative draft's view of DeepSeek-V2-Lite's factors (rank
# 512, 16 heads, RoPE 64): the top draft_rank columns of k_us read in place
# through its row stride (bf16, and int8 as the int4 factors' int8 ranks
# draft), at draft ranks 128 and 120 (not a multiple of 16: q_emb padded
# to 128, the kernel zero-fills k_us's columns past 120); a draft step (ql
# 1) and a verify-sized call (ql 8, R 128). Then the MLA verify pass itself:
# K7 and K8 at ql 8 over the whole factors.
@pytest.mark.gpu
@pytest.mark.parametrize("kind,draft_rank,ql", [("bf16", 128, 1), ("bf16", 120, 1),
                                                ("bf16", 120, 8), ("int8", 128, 1),
                                                ("int8", 120, 8), ("bf16", None, 8),
                                                ("int8", None, 8), ("int8+int4", None, 8)])
def test_mla_kernels_over_draft_view_and_at_ql8(cuda, kind, draft_rank, ql):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(10)
    s_p, rk, nh, rope = 8192, 512, 16, 64
    bf = torch.bfloat16
    R = ql * nh
    q_pe = (torch.randn((1, nh, ql, rope), generator=gen, device=cuda) * 0.1).to(bf)
    k_pe = torch.randn((1, s_p, rope), generator=gen, device=cuda).to(bf)
    r = torch.rand((1, s_p), generator=gen, device=cuda) + 0.5
    lengths = torch.tensor([s_p - 5], device=cuda)
    if kind == "int8+int4":
        us8, us4 = _mixed(gen, cuda, s_p, 256, 256)
        q_emb = torch.randn((1, nh, ql, rk), generator=gen, device=cuda) * 0.4 / rk ** 0.5
        before = k2.mla_mixed_launches
        t, lse = k2.mla_rankspace_decode_attention(q_emb * 0.02, q_pe, us8, k_pe, r, lengths,
                                                   k_us4=us4)
        assert k2.mla_mixed_launches == before + 1
        t_ref, lse_ref = k2.mla_mixed_rankspace_kernel_plain(
            (q_emb * 0.02).permute(0, 2, 1, 3).reshape(1, R, rk).to(bf),
            q_pe.permute(0, 2, 1, 3).reshape(1, R, rope), us8, us4, k_pe, r, lengths)
    else:
        us = torch.randn((1, s_p, rk), generator=gen, device=cuda)
        q_scale = 0.4 / rk ** 0.5
        if kind == "int8":
            us, q_scale = (us * 40).round().clamp(-127, 127).to(torch.int8), q_scale * 0.02
        else:
            us = us.to(bf)
        width = rk if draft_rank is None else draft_rank
        view = us[..., :width]
        assert draft_rank is None or not view.is_contiguous()
        q_emb = torch.randn((1, nh, ql, width), generator=gen, device=cuda) * q_scale
        before = k2.mla_launches
        t, lse = k2.mla_rankspace_decode_attention(q_emb, q_pe, view, k_pe, r, lengths)
        assert k2.mla_launches == before + 1
        t_ref, lse_ref = k2.mla_rankspace_kernel_plain(
            q_emb.permute(0, 2, 1, 3).reshape(1, R, width).to(bf),
            q_pe.permute(0, 2, 1, 3).reshape(1, R, rope), view.contiguous(), k_pe, r, lengths)
    t = t.permute(0, 2, 1, 3).reshape(t_ref.shape)
    lse = lse.permute(0, 2, 1).reshape(lse_ref.shape)
    assert _row_rel_err(t, t_ref) <= TOL_T and _lse_err(lse, lse_ref) <= TOL_LSE
