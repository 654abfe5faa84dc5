"""K3 and K5: fused low-rank decode attention over PRE-RoPE factors
(``csrc/lowrank_attention.cu``).

Port of ``xkv_tpu/ops/pallas/lowrank_attention.py``: K3
``lowrank_decode_attention`` over the whole segment, and K5
``sparse_lowrank_decode_attention``, the same over the selected chunks.
The cache holds the factors ``K = k_us @ k_vt`` of pre-RoPE keys; every key
block is rebuilt on chip and RoPE is applied in relative-angle form:

    score_p = (q*c_t - q~*s_t) . (K_p*cos_p) + (q*s_t + q~*c_t) . (K_p*sin_p)

with q~ = [q2, -q1]. ``_query_embeds`` (plain tensor code, as on the TPU)
folds the query-position trig, the softmax scale and the int8 K column scale
into the two embeds [qa | qb]; here they are stored compactly, one
(2*hd)-wide row per query row for its own kv head, instead of the TPU's
block-diagonal (2*hkv*hd)-wide rows. ``lowrank_kernel`` is the kernel: key
rebuild, trig fields, scores, softmax, ``t = P @ v_us`` and the final
``t @ v_vt`` per head; ``sparse_lowrank_kernel`` does the same over the
rows (and position-table rows) of the selected chunks. Each launches its
CUDA kernel for CUDA tensors and runs its plain version for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from xkv_tpu_torch.ops.attention import gather_chunk_rows
from xkv_tpu_torch.ops.kernels import _build
from xkv_tpu_torch.ops.kernels.flash_attention import padded_head_dim
from xkv_tpu_torch.ops.kernels.rankspace_attention import (
    chunk_blocks,
    compute_dtype_for,
    live_chunk_rows,
    live_columns,
    masked_softmax_stats,
)

# Launches of each CUDA kernel since the last reset (plain runs not
# counted): K3 and K5 (sparse).
launches = 0
sparse_launches = 0


def _query_embeds(
    q_pre: torch.Tensor,  # (b, hq, ql, hd) PRE-RoPE queries
    cos_t: torch.Tensor,  # (b|1, hd) or (b|1, ql, hd) query-position trig
    sin_t: torch.Tensor,
    num_kv_heads: int,
    scale: float,
    k_scale_slice: Optional[torch.Tensor],  # (b, 1, hkv*hd) int8 K scale
) -> torch.Tensor:
    """Compact query embeds (b, R, 2*hd) in q_pre's dtype, rows ordered
    (ql, hq): [qa | qb] with qa = (q*c_t - q~*s_t) * fold and
    qb = (q*s_t + q~*c_t) * fold, fold = scale * (the row's kv head's
    K column scale)."""
    b, hq, ql, hd = q_pre.shape
    half = hd // 2
    if cos_t.dim() == 2:
        cos_t, sin_t = cos_t[:, None], sin_t[:, None]
    q3 = q_pre.permute(0, 2, 1, 3).to(torch.float32)  # (b, ql, hq, hd)
    qt3 = torch.cat([q3[..., half:], -q3[..., :half]], dim=-1)
    c_t = cos_t[:, :, None, :].to(torch.float32)
    s_t = sin_t[:, :, None, :].to(torch.float32)
    qa = q3 * c_t - qt3 * s_t
    qb = q3 * s_t + qt3 * c_t
    fold = torch.full((1, 1, hq, hd), scale, dtype=torch.float32, device=q_pre.device)
    if k_scale_slice is not None:
        ks = k_scale_slice.to(torch.float32).reshape(b, 1, num_kv_heads, hd)
        fold = fold * ks.repeat_interleave(hq // num_kv_heads, dim=2)
    emb = torch.cat([qa * fold, qb * fold], dim=-1)  # (b, ql, hq, 2*hd)
    return emb.reshape(b, ql * hq, 2 * hd).to(q_pre.dtype).contiguous()


def lowrank_kernel_plain(
    qab: torch.Tensor,  # (b, R, 2*hd)
    k_us: torch.Tensor,  # (b, s_p, rk)
    k_vt_slice: torch.Tensor,  # (b, rk, hkv*hd)
    v_us: torch.Tensor,  # (b, s_p, rv)
    v_vt_slice: torch.Tensor,  # (b, rv, hkv*hd)
    cos_h: torch.Tensor,  # (s_p, hd/2) half position tables
    sin_h: torch.Tensor,
    v_scale: Optional[torch.Tensor],  # (b, 1, rv) fp32, int8 factors only
    lengths: Optional[torch.Tensor],
    win_lo: Optional[torch.Tensor],
    *,
    num_q_heads: int,
    num_kv_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain tensor code, with its numerics: the
    rebuilt keys (fp32, or exact integer products for int8) rounded to the
    compute dtype; trig fields multiplied in the compute dtype; fp32 scores
    and softmax; probabilities rounded before P @ v_us; the normalised and
    V-scaled t rounded before t @ v_vt. Returns (out (b, R, hd) in qab's
    dtype, lse (b, R) fp32)."""
    b, s_p = k_us.shape[:2]
    lens, los = _build.live_range(b, s_p, lengths, win_lo, k_us.device)
    return _lowrank_rows(qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h[None], sin_h[None],
                         v_scale, live_columns(s_p, lens, los), num_q_heads, num_kv_heads)


def _lowrank_rows(qab, k_rows, k_vt_slice, v_rows, v_vt_slice, cos_rows, sin_rows, v_scale,
                  live, num_q_heads, num_kv_heads):
    """Low-rank attention of qab over the given factor rows and their
    position-table rows (1|b, s, hd/2), with the kernels' numerics (see
    ``lowrank_kernel_plain``)."""
    b, R, two_hd = qab.shape
    hd = two_hd // 2
    hq, hkv = num_q_heads, num_kv_heads
    ql, gsz = R // hq, hq // hkv
    s = k_rows.shape[1]
    k_cos, k_sin = trig_keys(k_rows, k_vt_slice, cos_rows, sin_rows, hkv)
    q5 = qab.to(torch.float32).reshape(b, ql, hkv, gsz, two_hd)
    scores = (torch.einsum("bqgnd,bsgd->bqgns", q5[..., :hd], k_cos)
              + torch.einsum("bqgnd,bsgd->bqgns", q5[..., hd:], k_sin))
    return attend_rank_space(scores.reshape(b, R, s), live, k_rows.dtype, v_rows, v_vt_slice,
                             v_scale, num_q_heads, num_kv_heads, qab.dtype)


def trig_keys(k_rows, k_vt_slice, cos_rows, sin_rows, num_kv_heads):
    """The rebuilt keys (fp32, or exact integer products for int8) rounded
    to the compute dtype and times the key-position cos and sin fields in
    that dtype: (K*cos, K*sin), each (b, s, hkv, hd) fp32."""
    b, s = k_rows.shape[:2]
    hd = k_vt_slice.shape[2] // num_kv_heads
    cd = compute_dtype_for(k_rows.dtype)
    if k_rows.dtype == torch.int8:
        k_rec = torch.bmm(k_rows.to(torch.float64), k_vt_slice.to(torch.float64))
        k_rec = k_rec.to(torch.float32).to(cd)
    else:
        k_rec = torch.bmm(k_rows.to(torch.float32), k_vt_slice.to(torch.float32)).to(cd)
    k_rec = k_rec.reshape(b, s, num_kv_heads, hd)
    cos_w = torch.cat([cos_rows, cos_rows], dim=-1).to(cd)[:, :, None, :]
    sin_w = torch.cat([sin_rows, sin_rows], dim=-1).to(cd)[:, :, None, :]
    return (k_rec * cos_w).to(torch.float32), (k_rec * sin_w).to(torch.float32)


def attend_rank_space(scores, live, factor_dtype, v_rows, v_vt_slice, v_scale, num_q_heads,
                      num_kv_heads, out_dtype):
    """From fp32 scores (b, R, s): the masked softmax, probabilities rounded
    before P @ v_us, the normalised and V-scaled t rounded before t @ v_vt
    for each row's own head. Returns (out (b, R, hd), lse (b, R) fp32)."""
    b, R, s = scores.shape
    hq, hkv = num_q_heads, num_kv_heads
    ql, gsz = R // hq, hq // hkv
    rv = v_rows.shape[2]
    hd = v_vt_slice.shape[2] // hkv
    cd = compute_dtype_for(factor_dtype)
    p, l_inv, lse = masked_softmax_stats(scores, live)
    t = p.to(cd).to(torch.float32) @ v_rows.to(cd).to(torch.float32)
    t = t * l_inv
    if v_scale is not None:
        t = t * v_scale.to(torch.float32)
    t = t.to(cd).to(torch.float32).reshape(b, ql, hkv, gsz, rv)
    vt = v_vt_slice.to(torch.float32).reshape(b, rv, hkv, hd)
    out = torch.einsum("bqgnr,brgd->bqgnd", t, vt).reshape(b, R, hd)
    return out.to(out_dtype), lse


def lowrank_kernel(
    qab: torch.Tensor,
    k_us: torch.Tensor,
    k_vt_slice: torch.Tensor,
    v_us: torch.Tensor,
    v_vt_slice: torch.Tensor,
    cos_h: torch.Tensor,
    sin_h: torch.Tensor,
    v_scale: Optional[torch.Tensor],
    lengths: Optional[torch.Tensor],
    win_lo: Optional[torch.Tensor],
    *,
    num_q_heads: int,
    num_kv_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode attention of the compact query embeds over one layer's
    factored segment: (out (b, R, hd), lse (b, R) fp32). Live key columns
    are [win_lo, lengths) per sequence."""
    if k_us.device.type == "cpu":
        return lowrank_kernel_plain(
            qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h, v_scale,
            lengths, win_lo, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads)
    global launches
    out = _launch(qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h, v_scale, None, 0,
                  lengths, win_lo, num_q_heads, num_kv_heads)
    launches += 1
    return out


def sparse_lowrank_kernel_plain(
    qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h, v_scale, ids, block,
    lengths, win_lo, *, num_q_heads: int, num_kv_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's function in plain tensor code: K3's numerics over the rows of
    the selected ``block``-row chunks (``ids`` (b, n_sel), < 0 selects
    nothing), position tables read at the rows' absolute positions."""
    b, s_p = k_us.shape[:2]
    lens, los = _build.live_range(b, s_p, lengths, win_lo, k_us.device)
    pos, live = live_chunk_rows(ids, block, s_p, lens, los)
    pos = torch.clamp(pos, 0, s_p - 1)  # rows past s_p are masked
    return _lowrank_rows(qab, gather_chunk_rows(k_us, pos), k_vt_slice,
                         gather_chunk_rows(v_us, pos), v_vt_slice, cos_h[pos], sin_h[pos],
                         v_scale, live, num_q_heads, num_kv_heads)


# Query rows of one CTA: the rows of one kv head, in tiles of this many
# (kHR in csrc/lowrank_tma.cuh); value ranks of one CTA, at most.
HEAD_ROW_TILE, SLICE_RANKS = 16, 1024


def kernel_shapes(qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h, num_q_heads,
                  num_kv_heads):
    """K3's and K5's shape checks, run before the device checks: every
    even head size up to 128 (64 and 128 run as they are, the others
    padded: ``pad_head_operands``), any group size, rk a positive multiple
    of 64, rv a positive multiple of 16 (past 1024 the kernels take value
    slices). Returns (b, R, hd, s_p, rk, rv)."""
    b, R, two_hd = qab.shape
    hd = two_hd // 2
    s_p, rk = k_us.shape[1], k_us.shape[2]
    rv = v_us.shape[2]
    m = num_kv_heads * hd
    padded_head_dim(hd)
    _build.require(num_q_heads % num_kv_heads == 0 and R % num_q_heads == 0,
                   "rows must be ql * hq with hq a multiple of hkv")
    _build.require(tuple(k_vt_slice.shape) == (b, rk, m) and tuple(v_vt_slice.shape) == (b, rv, m),
                   "vt slices must be (b, rank, hkv*hd)")
    _build.require(tuple(cos_h.shape) == (s_p, hd // 2) and sin_h.shape == cos_h.shape,
                   "half tables must be (s_p, hd/2)")
    _build.require(rk % 64 == 0 and rk > 0 and rv % 16 == 0 and rv > 0,
                   f"ranks rk={rk} (multiple of 64), rv={rv} (multiple of 16) must be positive")
    return b, R, hd, s_p, rk, rv


def _check_operands(qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h, v_scale,
                    num_q_heads, num_kv_heads) -> bool:
    """K3's, K5's and K9's operand checks; returns whether the factors are
    int8."""
    b, _, _, _, _, rv = kernel_shapes(qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h,
                                      num_q_heads, num_kv_heads)
    fdt = (torch.bfloat16, torch.int8)
    _build.require_cuda_tensor(qab, "qab", (torch.bfloat16,), 3)
    _build.require_cuda_tensor(k_us, "k_us", fdt, 3)
    _build.require_cuda_tensor(k_vt_slice, "k_vt_slice", (k_us.dtype,), 3)
    _build.require_cuda_tensor(v_us, "v_us", (k_us.dtype,), 3)
    _build.require_cuda_tensor(v_vt_slice, "v_vt_slice", (torch.bfloat16,), 3)
    _build.require_cuda_tensor(cos_h, "cos_h", (torch.bfloat16,), 2)
    _build.require_cuda_tensor(sin_h, "sin_h", (torch.bfloat16,), 2)
    for name, t in (("qab", qab), ("k_us", k_us), ("v_us", v_us),
                    ("cos_h", cos_h), ("sin_h", sin_h)):
        _build.require(t.is_contiguous(), f"{name} must be contiguous")
    _build.require(k_vt_slice.stride(1) % 16 == 0 and v_vt_slice.stride(1) % 8 == 0,
                   "vt row strides must keep 16-byte alignment")
    quantized = k_us.dtype == torch.int8
    if quantized:
        _build.require_cuda_tensor(v_scale, "v_scale", (torch.float32,), 3)
        _build.require(tuple(v_scale.shape) == (b, 1, rv) and v_scale.is_contiguous(),
                       "v_scale must be contiguous (b, 1, rv)")
    else:
        _build.require(v_scale is None, "v_scale applies to int8 factors only")
    return quantized


def streams_kvt(hd: int, rk: int, int8: bool) -> bool:
    """Whether K3/K5 stream the head's k_vt slice through their ring (True)
    or keep it resident in shared memory (False) at these sizes."""
    return bool(_build.load().xkv_lowrank_streams_kvt(hd, rk, int(int8)))


def _pad_halves(x: torch.Tensor, hd: int, hp: int) -> torch.Tensor:
    """(..., n*hd) -> (..., n*hp): each hd-wide group's two RoPE halves
    zero-padded on their own from hd/2 to hp/2."""
    lead = x.shape[:-1]
    halves = x.reshape(*lead, -1, 2, hd // 2)
    return torch.nn.functional.pad(halves, (0, (hp - hd) // 2)).reshape(*lead, -1)


def pad_head_operands(qab, k_vt_slice, v_vt_slice, cos_h, sin_h, hp):
    """K3's and K5's operands at head size hd, padded to the built head
    size ``hp``: the relative-angle RoPE pairs column d with d + hd/2, so
    each half of each head (both query embeds, the k_vt and v_vt head
    columns, the half tables) is padded with zeros on its own. The padded
    key columns are zero, so they add nothing to a score; the output's
    padded columns are dropped by ``unpad_head``."""
    hd = qab.shape[2] // 2
    return (_pad_halves(qab, hd, hp).contiguous(), _pad_halves(k_vt_slice, hd, hp),
            _pad_halves(v_vt_slice, hd, hp),
            *(torch.nn.functional.pad(t, (0, (hp - hd) // 2)).contiguous()
              for t in (cos_h, sin_h)))


def unpad_head(out: torch.Tensor, hd: int) -> torch.Tensor:
    """(b, R, hp) kernel output -> (b, R, hd): the two halves' first
    hd/2 columns each."""
    b, R, hp = out.shape
    return out.reshape(b, R, 2, hp // 2)[..., :hd // 2].reshape(b, R, hd)


def _launch(qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h, v_scale, ids, block,
            lengths, win_lo, num_q_heads, num_kv_heads):
    """Check the operands and launch K3 (``ids`` None) or K5 over the
    chunks ``ids`` of ``block`` rows. Returns (out, lse)."""
    per = None if ids is None else chunk_blocks(block)
    quantized = _check_operands(qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h,
                                v_scale, num_q_heads, num_kv_heads)
    b, R, hd, s_p, rk, rv = kernel_shapes(qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h,
                                          sin_h, num_q_heads, num_kv_heads)
    hp = padded_head_dim(hd)
    if hp != hd:
        qab, k_vt_slice, v_vt_slice, cos_h, sin_h = pad_head_operands(
            qab, k_vt_slice, v_vt_slice, cos_h, sin_h, hp)
    dev = k_us.device
    lens, los = _build.live_range(b, s_p, lengths, win_lo, dev)
    if ids is None:
        keys = s_p
    else:
        _build.require(ids.dim() == 2 and ids.shape[0] == b, "ids must be (b, n_sel)")
        ids = ids.to(device=dev, dtype=torch.int32).contiguous()
        keys = ids.shape[1] * per * 64
    # One CTA per (kv head, tile of its rows, split, value slice, sequence).
    tiles = -(-(R // num_kv_heads) // HEAD_ROW_TILE)
    slices = -(-rv // SLICE_RANKS)
    nsplit = _build.num_splits(keys, b * num_kv_heads * tiles * slices, 1, dev)
    part_t = torch.empty((b, nsplit, R, rv), dtype=torch.float32, device=dev)
    part_m = torch.empty((b, nsplit, R), dtype=torch.float32, device=dev)
    part_l = torch.empty((b, nsplit, R), dtype=torch.float32, device=dev)
    part_o = torch.empty((b, -(-rv // 64), R, hp), dtype=torch.float32, device=dev)
    done = torch.empty((b * num_kv_heads * tiles,), dtype=torch.int32, device=dev)
    out = torch.empty((b, R, hp), dtype=torch.bfloat16, device=dev)
    lse = torch.empty((b, R), dtype=torch.float32, device=dev)
    common = (qab.data_ptr(), k_us.data_ptr(), k_vt_slice.data_ptr(),
              k_vt_slice.stride(0), k_vt_slice.stride(1),
              v_us.data_ptr(), v_vt_slice.data_ptr(),
              v_vt_slice.stride(0), v_vt_slice.stride(1),
              cos_h.data_ptr(), sin_h.data_ptr(),
              v_scale.data_ptr() if quantized else None)
    scratch = (lens.data_ptr(), los.data_ptr(), part_t.data_ptr(), part_m.data_ptr(),
               part_l.data_ptr(), part_o.data_ptr(), done.data_ptr(), out.data_ptr(),
               lse.data_ptr(),
               b, R, num_q_heads, num_kv_heads, hp, s_p, rk, rv)
    lib = _build.load()
    if ids is None:
        status = lib.xkv_lowrank_decode(*common, *scratch, nsplit, int(quantized),
                                        _build.stream_ptr(dev))
    else:
        status = lib.xkv_sparse_lowrank_decode(*common, ids.data_ptr(), *scratch,
                                               ids.shape[1], block, nsplit, int(quantized),
                                               _build.stream_ptr(dev))
    _build.check(status, "lowrank_kernel" if ids is None else "sparse_lowrank_kernel")
    return (out if hp == hd else unpad_head(out, hd)), lse


def sparse_lowrank_kernel(
    qab: torch.Tensor,
    k_us: torch.Tensor,
    k_vt_slice: torch.Tensor,
    v_us: torch.Tensor,
    v_vt_slice: torch.Tensor,
    cos_h: torch.Tensor,
    sin_h: torch.Tensor,
    v_scale: Optional[torch.Tensor],
    ids: torch.Tensor,
    block: int,
    lengths: Optional[torch.Tensor],
    win_lo: Optional[torch.Tensor],
    *,
    num_q_heads: int,
    num_kv_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: K3 over the rows of the selected ``block``-row chunks only:
    (out (b, R, hd), lse (b, R) fp32)."""
    if k_us.device.type == "cpu":
        return sparse_lowrank_kernel_plain(
            qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h, v_scale, ids, block,
            lengths, win_lo, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads)
    global sparse_launches
    out = _launch(qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h, v_scale, ids, block,
                  lengths, win_lo, num_q_heads, num_kv_heads)
    sparse_launches += 1
    return out


def half_tables(cos_p: torch.Tensor, sin_p: torch.Tensor, factor_dtype: torch.dtype):
    """(s_p, hd) position tables -> (s_p, hd/2) halves (the hd halves are
    equal by construction), in bf16 unless the factors are fp32."""
    half = cos_p.shape[-1] // 2
    td = torch.float32 if factor_dtype == torch.float32 else torch.bfloat16
    return (cos_p[:, :half].to(td).contiguous(), sin_p[:, :half].to(td).contiguous())


def lowrank_decode_attention(
    q_pre: torch.Tensor,  # (b, hq, ql, hd) PRE-RoPE decode queries
    k_us: torch.Tensor,  # (b, s_p, rk)
    k_vt_slice: torch.Tensor,  # (b, rk, hkv*hd) this layer's V^T columns
    v_us: torch.Tensor,  # (b, s_p, rv)
    v_vt_slice: torch.Tensor,  # (b, rv, hkv*hd)
    cos_p: torch.Tensor,  # (s_p, hd) prefill-position tables
    sin_p: torch.Tensor,
    cos_t: torch.Tensor,  # (b|1, hd) or (b|1, ql, hd) query-position trig
    sin_t: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,  # (b,) valid prefill length
    k_scale_slice: Optional[torch.Tensor] = None,  # (b, 1, hkv*hd) int8 K scale
    v_rank_scale: Optional[torch.Tensor] = None,  # (b, 1, rv) int8 V scale
    win_lo: Optional[torch.Tensor] = None,  # (b,) sliding-window lower bound
    *,
    scale: float,
    num_kv_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused factored-cache decode attention for one layer. Takes PRE-RoPE
    queries plus their positions' cos/sin rows; ``ql > 1`` runs every
    (position, head) pair as its own row. Returns (out (b, hq, ql, hd),
    lse (b, hq, ql)), a partial mergeable with the dense tail."""
    b, hq, ql, hd = q_pre.shape
    quantized = k_us.dtype == torch.int8
    if quantized and (k_scale_slice is None or v_rank_scale is None):
        raise ValueError("int8 factors need k_scale_slice and v_rank_scale")
    if not quantized:
        k_scale_slice = v_rank_scale = None
    cos_h, sin_h = half_tables(cos_p, sin_p, k_us.dtype)
    qab = _query_embeds(q_pre, cos_t, sin_t, num_kv_heads, scale, k_scale_slice)
    v_scale = v_rank_scale.to(torch.float32).contiguous() if quantized else None
    out, lse = lowrank_kernel(
        qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h, v_scale,
        lengths, win_lo, num_q_heads=hq, num_kv_heads=num_kv_heads)
    out = out.reshape(b, ql, hq, hd).permute(0, 2, 1, 3).to(q_pre.dtype)
    return out, lse.reshape(b, ql, hq).permute(0, 2, 1)


def sparse_lowrank_decode_attention(
    q_pre: torch.Tensor,  # (b, hq, 1, hd) PRE-RoPE decode queries
    k_us: torch.Tensor,
    k_vt_slice: torch.Tensor,
    v_us: torch.Tensor,
    v_vt_slice: torch.Tensor,
    cos_p: torch.Tensor,  # (s_p, hd)
    sin_p: torch.Tensor,
    cos_t: torch.Tensor,  # (b|1, hd) or (b|1, 1, hd)
    sin_t: torch.Tensor,
    chunk_ids: torch.Tensor,  # (b, n_sel) int32 selected chunks
    lengths: Optional[torch.Tensor] = None,
    k_scale_slice: Optional[torch.Tensor] = None,
    v_rank_scale: Optional[torch.Tensor] = None,
    win_lo: Optional[torch.Tensor] = None,
    *,
    scale: float,
    num_kv_heads: int,
    block: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse top-k fused decode attention (K5): only the selected
    ``block``-row chunks are rebuilt and read. Same contract as
    ``lowrank_decode_attention`` otherwise."""
    b, hq, ql, hd = q_pre.shape
    if ql != 1:
        raise ValueError("sparse decode is single-token")
    quantized = k_us.dtype == torch.int8
    if quantized and (k_scale_slice is None or v_rank_scale is None):
        raise ValueError("int8 factors need k_scale_slice and v_rank_scale")
    if not quantized:
        k_scale_slice = v_rank_scale = None
    cos_h, sin_h = half_tables(cos_p, sin_p, k_us.dtype)
    qab = _query_embeds(q_pre, cos_t, sin_t, num_kv_heads, scale, k_scale_slice)
    v_scale = v_rank_scale.to(torch.float32).contiguous() if quantized else None
    out, lse = sparse_lowrank_kernel(
        qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h, v_scale, chunk_ids, block,
        lengths, win_lo, num_q_heads=hq, num_kv_heads=num_kv_heads)
    return out.reshape(b, 1, hq, hd).permute(0, 2, 1, 3).to(q_pre.dtype), lse[:, :, None]
