"""K2: rank-space decode attention over POST-RoPE factors
(``csrc/rankspace_attention.cu``).

Port of ``xkv_tpu/ops/pallas/rankspace_attention.py:rankspace_decode_attention``.
The factors store rotated keys, so

    scores = q . K^T = (q . vt_k^T) . k_us^T        (exact)
    out    = ((P . v_us) * v_scale) . v_vt          (V has no RoPE)

As on the TPU, the projections in and out of rank space (``_project_q``,
``_project_out``) are plain tensor code; ``rankspace_kernel`` is the kernel:
scores, mask, softmax and ``t = P @ v_us`` over the sequence. It launches
the CUDA kernel for CUDA tensors and runs ``rankspace_kernel_plain`` for
CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from xkv_tpu_torch.ops.kernels import _build

NEG_INF = -0.7 * torch.finfo(torch.float32).max

# Launches of the CUDA kernel since the last reset (plain runs not counted).
launches = 0


def compute_dtype_for(factor_dtype: torch.dtype) -> torch.dtype:
    """fp32 factors run in fp32 (tests); bf16 and int8 factors in bf16."""
    return torch.float32 if factor_dtype == torch.float32 else torch.bfloat16


def _project_q(
    q: torch.Tensor,  # (b, hq, ql, hd) POST-RoPE
    k_vt_slice: torch.Tensor,  # (b, rk, hkv*hd)
    num_kv_heads: int,
    scale: float,
    k_scale_slice: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """q -> rank space: (b, R, rk), rows ordered (ql, hq); the attention
    scale and the int8 K column scale folded in."""
    b, hq, ql, hd = q.shape
    hkv = num_kv_heads
    rk = k_vt_slice.shape[1]
    vt = k_vt_slice.to(torch.float32)
    if k_scale_slice is not None:
        vt = vt * k_scale_slice.to(torch.float32)
    vt = vt.reshape(b, rk, hkv, hd)
    qg = q.to(torch.float32).reshape(b, hkv, hq // hkv, ql, hd) * scale
    emb = torch.einsum("bgnqd,brgd->bqgnr", qg, vt)
    return emb.reshape(b, ql * hq, rk).to(compute_dtype).contiguous()


def _project_out(
    t: torch.Tensor,  # (b, R, rv) segment-normalised rank-space values
    v_vt_slice: torch.Tensor,  # (b, rv, hkv*hd)
    v_rank_scale: Optional[torch.Tensor],
    num_kv_heads: int,
    ql: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Project through V^T, each row taking its own head's columns.
    Returns (b, hq, ql, hd)."""
    b, R, rv = t.shape
    hq = R // ql
    hkv = num_kv_heads
    hd = v_vt_slice.shape[2] // hkv
    tf = t.to(torch.float32)
    if v_rank_scale is not None:
        tf = tf * v_rank_scale.to(torch.float32)
    tg = tf.reshape(b, ql, hkv, hq // hkv, rv)
    vt = v_vt_slice.to(torch.float32).reshape(b, rv, hkv, hd)
    out = torch.einsum("bqgnr,brgd->bgnqd", tg, vt)
    return out.reshape(b, hq, ql, hd).to(out_dtype)


def masked_softmax_stats(
    scores: torch.Tensor,  # (b, R, s) fp32
    lens: torch.Tensor,
    los: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decode kernels' softmax in one pass: masked columns (outside
    [los, lens)) take NEG_INF and probability exactly 0. Returns (p, l_inv,
    lse) with l_inv = 1/l, or 1 where l == 0."""
    s = scores.shape[-1]
    cols = torch.arange(s, device=scores.device)
    live = (cols[None, :] < lens[:, None]) & (cols[None, :] >= los[:, None])
    live = live[:, None, :]
    x = torch.where(live, scores, torch.full_like(scores, NEG_INF))
    m = x.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(x - m), torch.zeros_like(x))
    l = p.sum(dim=-1, keepdim=True)
    l_inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    lse = (m + torch.log(torch.clamp(l, min=1e-30))).squeeze(-1)
    return p, l_inv, lse


def rankspace_kernel_plain(
    q_emb: torch.Tensor,  # (b, R, rk) compute dtype
    k_us: torch.Tensor,  # (b, s_p, rk)
    v_us: torch.Tensor,  # (b, s_p, rv)
    lengths: Optional[torch.Tensor] = None,
    win_lo: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain tensor code, with its numerics:
    factors in the compute dtype, fp32 scores and softmax, probabilities
    rounded to the compute dtype before P @ v_us. Returns (t (b, R, rv)
    fp32 normalised, lse (b, R) fp32)."""
    b, s_p, _ = k_us.shape
    cd = q_emb.dtype
    lens, los = _build.live_range(b, s_p, lengths, win_lo, k_us.device)
    scores = q_emb.to(torch.float32) @ k_us.to(cd).to(torch.float32).transpose(1, 2)
    p, l_inv, lse = masked_softmax_stats(scores, lens, los)
    t = p.to(cd).to(torch.float32) @ v_us.to(cd).to(torch.float32)
    return t * l_inv, lse


def rankspace_kernel(
    q_emb: torch.Tensor,
    k_us: torch.Tensor,
    v_us: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    win_lo: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores, masked softmax and ``t = P @ v_us`` over the factored
    segment: (t (b, R, rv) fp32 normalised, lse (b, R) fp32). Live key
    columns are [win_lo, lengths) per sequence."""
    if k_us.device.type == "cpu":
        return rankspace_kernel_plain(q_emb, k_us, v_us, lengths, win_lo)
    global launches
    b, R, rk = q_emb.shape
    s_p, rv = k_us.shape[1], v_us.shape[2]
    _build.require_cuda_tensor(q_emb, "q_emb", (torch.bfloat16,), 3)
    for name, t in (("k_us", k_us), ("v_us", v_us)):
        _build.require_cuda_tensor(t, name, (torch.bfloat16, torch.int8), 3)
        _build.require(t.is_contiguous(), f"{name} must be contiguous")
    _build.require(q_emb.is_contiguous(), "q_emb must be contiguous")
    _build.require(v_us.dtype == k_us.dtype, "k_us and v_us must share a dtype")
    _build.require(k_us.shape == (b, s_p, rk) and v_us.shape[:2] == (b, s_p),
                   "factor shapes do not match q_emb")
    _build.require(rk % 16 == 0 and rv % 16 == 0 and rv <= 1024,
                   f"ranks rk={rk}, rv={rv} must be multiples of 16, rv <= 1024")
    dev = k_us.device
    lens, los = _build.live_range(b, s_p, lengths, win_lo, dev)
    chunks = -(-R // 32)
    nsplit = _build.num_splits(s_p, b * chunks, 2, dev)
    part_t = torch.empty((b, nsplit, R, rv), dtype=torch.float32, device=dev)
    part_m = torch.empty((b, nsplit, R), dtype=torch.float32, device=dev)
    part_l = torch.empty((b, nsplit, R), dtype=torch.float32, device=dev)
    t = torch.empty((b, R, rv), dtype=torch.float32, device=dev)
    lse = torch.empty((b, R), dtype=torch.float32, device=dev)
    status = _build.load().xkv_rankspace_decode(
        q_emb.data_ptr(), k_us.data_ptr(), v_us.data_ptr(), lens.data_ptr(),
        los.data_ptr(), part_t.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        t.data_ptr(), lse.data_ptr(), b, R, s_p, rk, rv, nsplit,
        int(k_us.dtype == torch.int8), _build.stream_ptr(dev),
    )
    _build.check(status, "rankspace_kernel")
    launches += 1
    return t, lse


def rankspace_decode_attention(
    q: torch.Tensor,  # (b, hq, ql, hd) POST-RoPE decode queries
    k_us: torch.Tensor,  # (b, s_p, rk)
    k_vt_slice: torch.Tensor,  # (b, rk, hkv*hd)
    v_us: torch.Tensor,  # (b, s_p, rv)
    v_vt_slice: torch.Tensor,  # (b, rv, hkv*hd)
    lengths: Optional[torch.Tensor] = None,  # (b,) valid prefill length
    k_scale_slice: Optional[torch.Tensor] = None,  # (b, 1, hkv*hd) int8 K scale
    v_rank_scale: Optional[torch.Tensor] = None,  # (b, 1, rv) int8 V scale
    win_lo: Optional[torch.Tensor] = None,  # (b,) sliding-window lower bound
    *,
    scale: float,
    num_kv_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-space decode attention over post-RoPE factors. ``ql > 1`` runs
    every (position, head) pair as its own row. Returns (out (b, hq, ql,
    hd), lse (b, hq, ql)), a partial mergeable with the dense tail."""
    b, hq, ql, hd = q.shape
    cd = compute_dtype_for(k_us.dtype)
    q_emb = _project_q(q, k_vt_slice, num_kv_heads, scale, k_scale_slice, cd)
    t, lse = rankspace_kernel(q_emb, k_us, v_us, lengths, win_lo)
    out = _project_out(t, v_vt_slice, v_rank_scale, num_kv_heads, ql, q.dtype)
    return out, lse.reshape(b, ql, hq).permute(0, 2, 1)
