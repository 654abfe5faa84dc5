"""The accuracy gates' decode shapes: ranks the kernels' layout does not
take as they are.

The gates (``tests/test_accuracy_gate.py``, ``tests/test_rope_post_accuracy
.py``) decode at head size 24 with 2 kv heads (a group of 2 layers: rank
96 is lossless) and ranks 96, 48, 8, 4 and 2, over 29-row prompts in
8-row chunks. K3 / K5 take key ranks in multiples of 64 and K2 / K4 / K6
ranks in multiples of 16, where the JAX kernels take any rank, so the
kernels' wrappers zero-pad their operands on the card
(``lowrank_attention.pad_lowrank_ranks``,
``rankspace_attention.pad_rank_operands`` and ``unpad_t``): a zero rank
adds nothing to a score or an output. Here, on the CPU, the plain decode
whose kernel operands are padded so equals the plain decode over the
factors as they are (fp32: 1e-5 of the row's largest value), and the
padded ranks meet the kernels' rules. ``tests/test_torch_train_gpu.py``
runs the same cases through the kernels.

This file imports neither JAX nor the JAX package.
"""

import pytest
import torch

from xkv_tpu_torch.compress.quant import (
    quantize_k_factors,
    quantize_k_factors_mixed4,
    quantize_v_factors,
    quantize_v_factors_mixed4,
)
from xkv_tpu_torch.engine.compression import int4_rank_hi
from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
from xkv_tpu_torch.ops.kernels import rankspace_attention as k2
from xkv_tpu_torch.ops.rope import rope_cos_sin
from xkv_tpu_torch.scripts.kernel_variants import row_rel_err

B, HQ, HKV, HD, S, BLOCK = 32, 4, 2, 24, 29, 8
# (kernel, factor dtype, rank, selected chunks of BLOCK rows): the gates'
# runs, one per kernel and dtype.
CASES = {
    "K3 rank 48": ("K3", "bf16", 48, None),
    "K3 rank 2": ("K3", "bf16", 2, None),
    "K3 int8 rank 48": ("K3", "int8", 48, None),
    "K5 rank 96 top 3": ("K5", "bf16", 96, 3),
    "K2 rank 8": ("K2", "bf16", 8, None),
    "K2 rank 4": ("K2", "bf16", 4, None),
    "K6 rank 8": ("K6", "int4", 8, None),
}


def operands(name, device, seed=0):
    """(decode function, positional operands, keyword operands) of a case,
    from a seeded generator: random factors (int8 / int4 through the port's
    quantisers), bf16 queries, the RoPE tables of a 29-row prompt."""
    kernel, fdt, rank, n_sel = CASES[name]
    g = torch.Generator().manual_seed(seed)
    m = HKV * HD

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    us_k, vt_k = rnd(B, S, rank), rnd(B, rank, m, scale=0.3)
    us_v, vt_v = rnd(B, S, rank), rnd(B, rank, m, scale=0.3)
    q = rnd(B, HQ, 1, HD).to(torch.bfloat16)
    kw = dict(scale=HD ** -0.5, num_kv_heads=HKV)
    if fdt == "int4":
        hi = int4_rank_hi(rank, 0.25)  # the engine's split: 2 int8 + 6 int4 ranks
        kq = quantize_k_factors_mixed4(us_k, vt_k, hi)
        vq = quantize_v_factors_mixed4(us_v, vt_v, hi)
        args = (q, kq.us8, kq.vt8, vq.us8, vq.vt)
        kw.update(k_scale_slice=kq.out_scale, v_rank_scale=vq.rank_scale, k_us4=kq.us4p,
                  k_vt4_slice=kq.vt4, k_scale4_slice=kq.scale4, v_us4=vq.us4p)
    elif fdt == "int8":
        kq, vq = quantize_k_factors(us_k, vt_k), quantize_v_factors(us_v, vt_v)
        args = (q, kq.us_q, kq.vt_q, vq.us_q, vq.vt)
        kw.update(k_scale_slice=kq.out_scale, v_rank_scale=vq.rank_scale)
    else:
        args = tuple(t.to(torch.bfloat16) for t in (q, us_k, vt_k, us_v, vt_v))
    if kernel in ("K3", "K5"):
        cos, sin = rope_cos_sin(torch.arange(S + 1)[None], HD, 10000.0)
        args += (cos[0, :S], sin[0, :S], cos[0, S:], sin[0, S:])
    if n_sel:
        ids = torch.stack([torch.randperm(-(-S // BLOCK), generator=g)[:n_sel]
                           for _ in range(B)]).to(torch.int32)
        args += (ids,)
        kw["block"] = BLOCK
    fn = {"K2": k2.rankspace_decode_attention, "K6": k2.rankspace_decode_attention,
          "K3": k3.lowrank_decode_attention, "K5": k3.sparse_lowrank_decode_attention}[kernel]
    move = lambda t: t.to(device) if isinstance(t, torch.Tensor) else t  # noqa: E731
    return fn, tuple(move(a) for a in args), {k: move(v) for k, v in kw.items()}


# The plain version each kernel's wrapper runs on the CPU.
PLAIN = {"K2": (k2, "rankspace_kernel_plain"), "K6": (k2, "mixed_rankspace_kernel_plain"),
         "K3": (k3, "lowrank_kernel_plain"), "K5": (k3, "sparse_lowrank_kernel_plain")}


def padding(kernel, plain, grew):
    """``plain`` over its operands padded as the kernel's wrapper pads them
    on the card, t unpadded; appends to ``grew`` whether a rank grew."""
    def run(*args, **kw):
        if kernel in ("K3", "K5"):
            k_us, k_vt, v_us, v_vt, v_scale = k3.pad_lowrank_ranks(*args[1:5], args[7])
            assert k_us.shape[2] % 64 == 0 and v_us.shape[2] % 16 == 0
            grew.append(k_us.shape[2] > args[1].shape[2] or v_us.shape[2] > args[3].shape[2])
            return plain(args[0], k_us, k_vt, v_us, v_vt, *args[5:7], v_scale, *args[8:],
                         **kw)
        v_us, v_us4 = (args[3], args[4]) if kernel == "K6" else (args[2], None)
        rv = v_us.shape[2] + (0 if v_us4 is None else 2 * v_us4.shape[2])
        k_us = args[1]
        q_emb, pk_us, pv_us, pv = k2.pad_rank_operands(args[0], k_us, v_us, rv)
        assert q_emb.shape[2] % 16 == 0 and (rv + pv) % 16 == 0
        grew.append(q_emb.shape[2] > args[0].shape[2] or pv > 0)
        if kernel == "K6":
            t, lse = plain(q_emb, pk_us, args[2], pv_us, *args[4:], **kw)
        else:
            t, lse = plain(q_emb, pk_us, pv_us, *args[3:], **kw)
        return k2.unpad_t(t, v_us.shape[2], pv), lse
    return run


@pytest.mark.parametrize("name", list(CASES))
def test_rank_padding_leaves_the_plain_decode(name, monkeypatch):
    fn, args, kw = operands(name, "cpu")
    out, lse = fn(*args, **kw)
    module, attr = PLAIN[CASES[name][0]]
    grew = []
    monkeypatch.setattr(module, attr, padding(CASES[name][0], getattr(module, attr), grew))
    pout, plse = fn(*args, **kw)
    assert grew == [True]
    assert row_rel_err(pout, out) <= 1e-5
    torch.testing.assert_close(plse, lse, rtol=1e-6, atol=1e-6)


def test_pad_ranks_inserts_after_the_int8_ranks():
    """Mixed factors (K6): the zero key ranks go after the int8 ones, in
    q_emb before its int4 columns, the zero value ranks after v_us8's;
    ``unpad_t`` drops them from t, whose int4 tail stays last."""
    q_emb = torch.arange(1.0, 9.0)[None, None, :]  # 4 int8 + 4 int4 key ranks
    ones = torch.ones(1, 3, 4, dtype=torch.int8)
    q, k_us8, v_us8, pv = k2.pad_rank_operands(q_emb, ones, ones, 4 + 4)
    assert q[0, 0].tolist() == [1, 2, 3, 4] + [0] * 8 + [5, 6, 7, 8]
    assert k_us8.shape == (1, 3, 12) and v_us8.shape == (1, 3, 12) and pv == 8
    t = torch.cat([torch.arange(4.0), torch.zeros(8), torch.arange(4.0, 8.0)])[None, None]
    assert k2.unpad_t(t, 4, pv)[0, 0].tolist() == list(range(8))
    same = k2.pad_rank_operands(q, k_us8, v_us8, 16)
    assert all(a is b for a, b in zip(same, (q, k_us8, v_us8))) and same[3] == 0
