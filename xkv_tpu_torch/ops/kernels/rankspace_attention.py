"""K2, K4, K6, K7 and K8: rank-space decode attention over POST-RoPE
factors and over the factored MLA latent (``csrc/rankspace_attention.cu``).

Port of ``xkv_tpu/ops/pallas/rankspace_attention.py``:
  * K2 ``rankspace_kernel``: ``rankspace_decode_attention`` (bf16, fp32 or
    int8 factors);
  * K6 ``mixed_rankspace_kernel``: the same with mixed int8 + packed int4
    factors (``k_us4``/``v_us4``, Pallas body ``_rankspace_mixed_kernel``);
  * K4 ``sparse_rankspace_kernel``: ``sparse_rankspace_decode_attention``,
    K2 over the selected chunks only.
The factors store rotated keys, so

    scores = q . K^T = (q . vt_k^T) . k_us^T        (exact)
    out    = ((P . v_us) * v_scale) . v_vt          (V has no RoPE)

As on the TPU, the projections in and out of rank space (``_project_q``,
``_project_out``) are plain tensor code; each kernel computes scores,
mask, softmax and ``t = P @ v_us`` over its rows. A kernel wrapper
launches the CUDA kernel for CUDA tensors and runs its plain version for
CPU tensors.

  * K7 ``mla_rankspace_kernel``: ``mla_rankspace_decode_attention``, the
    absorbed DeepSeek-V2 MLA decode over the factored latent (Pallas body
    ``_mla_rankspace_kernel``): ``s = (q_emb . us^T) * r + q_pe . k_pe^T``,
    ``t = (P * r) @ us``, V being the latent's own ``us`` rows;
  * K8 ``mla_mixed_rankspace_kernel``: the same over int8 + packed int4
    latent factors (body ``_mla_rankspace_mixed_kernel``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from xkv_tpu_torch.compress.quant import unpack_int4_rows
from xkv_tpu_torch.ops.attention import chunk_positions, gather_chunk_rows, sparse_row_mask
from xkv_tpu_torch.ops.kernels import _build

NEG_INF = -0.7 * torch.finfo(torch.float32).max

# Launches of each CUDA kernel since the last reset (plain runs not
# counted): K2, K4 (sparse), K6 (mixed int8+int4), K7 (MLA) and K8 (MLA
# mixed int8+int4).
launches = 0
sparse_launches = 0
mixed_launches = 0
mla_launches = 0
mla_mixed_launches = 0

# K2, K4, K6: rows of a CTA and ranks of a value slice, taken when R fits
# one CTA, and of a value slice when it does not (csrc/rankspace_attention.cu);
# K7, K8: the widest value slice of a CTA.
CTA_ROWS, SLICE_RANKS, WIDE_SLICE_RANKS = 32, 256, 1024


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


def live_columns(s: int, lens: torch.Tensor, los: torch.Tensor) -> torch.Tensor:
    """(b, 1, s) mask of the live columns [los, lens)."""
    cols = torch.arange(s, device=lens.device)
    return ((cols[None, :] < lens[:, None]) & (cols[None, :] >= los[:, None]))[:, None, :]


def live_chunk_rows(
    ids: torch.Tensor, block: int, s_p: int, lens: torch.Tensor, los: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows of the selected chunks: (absolute positions (b, n_sel*block),
    live mask (b, 1, n_sel*block)); see ``sparse_row_mask``."""
    pos = chunk_positions(ids, block)
    return pos, sparse_row_mask(pos, ids, block, s_p, lens, los)[:, 0]


def masked_softmax_stats(
    scores: torch.Tensor,  # (b, R, s) fp32
    live: torch.Tensor,  # (b, 1, s) bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decode kernels' softmax in one pass: masked columns take
    NEG_INF and probability exactly 0. Returns (p, l_inv, lse) with
    l_inv = 1/l, or 1 where l == 0."""
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
    lens, los = _build.live_range(b, s_p, lengths, win_lo, k_us.device)
    return _rankspace_rows(q_emb, k_us, v_us, live_columns(s_p, lens, los))


def _rankspace_rows(q_emb, k_rows, v_rows, live):
    """Rank-space attention of q_emb over the given rows, with the
    kernels' numerics (see ``rankspace_kernel_plain``)."""
    cd = q_emb.dtype
    scores = q_emb.to(torch.float32) @ k_rows.to(cd).to(torch.float32).transpose(1, 2)
    p, l_inv, lse = masked_softmax_stats(scores, live)
    t = p.to(cd).to(torch.float32) @ v_rows.to(cd).to(torch.float32)
    return t * l_inv, lse


def mixed_rankspace_kernel_plain(
    q_emb: torch.Tensor,  # (b, R, r8k + r4k) bf16, [hi | lo-eo] columns
    k_us8: torch.Tensor,  # (b, s_p, r8k) int8
    k_us4: torch.Tensor,  # (b, s_p, r4k/2) packed int4 pairs
    v_us8: torch.Tensor,  # (b, s_p, r8v) int8
    v_us4: torch.Tensor,  # (b, s_p, r4v/2)
    lengths: Optional[torch.Tensor] = None,
    win_lo: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's function in plain tensor code: the packed tails unpacked to
    [evens | odds] beside the int8 ranks (values exact in bf16), then K2's
    numerics. Returns (t (b, R, r8v + r4v) fp32 in [hi | lo-eo] order, lse)."""
    k_all = torch.cat([k_us8, unpack_int4_rows(k_us4)], dim=-1)
    v_all = torch.cat([v_us8, unpack_int4_rows(v_us4)], dim=-1)
    return rankspace_kernel_plain(q_emb, k_all, v_all, lengths, win_lo)


def sparse_rankspace_kernel_plain(
    q_emb: torch.Tensor,  # (b, R, rk)
    k_us: torch.Tensor,  # (b, s_p, rk)
    v_us: torch.Tensor,  # (b, s_p, rv)
    ids: torch.Tensor,  # (b, n_sel) int32 chunk ids, < 0: none
    block: int,
    lengths: Optional[torch.Tensor] = None,
    win_lo: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's function in plain tensor code: K2's numerics over the rows of
    the selected chunks, masked by absolute position."""
    b, s_p, _ = k_us.shape
    lens, los = _build.live_range(b, s_p, lengths, win_lo, k_us.device)
    pos, live = live_chunk_rows(ids, block, s_p, lens, los)
    return _rankspace_rows(q_emb, gather_chunk_rows(k_us, pos), gather_chunk_rows(v_us, pos),
                           live)


def rankspace_kernel(
    q_emb: torch.Tensor,
    k_us: torch.Tensor,
    v_us: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    win_lo: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores, masked softmax and ``t = P @ v_us`` over the factored
    segment: (t (b, R, rv) fp32 normalised, lse (b, R) fp32). Live key
    columns are [win_lo, lengths) per sequence. On CUDA, K2, K4 and K6
    take any positive ranks (``pad_rank_operands``); on other devices
    ``rankspace_shapes`` holds them to the kernels' multiples of 16."""
    if k_us.device.type == "cpu":
        return rankspace_kernel_plain(q_emb, k_us, v_us, lengths, win_lo)
    global launches
    rv0, pv = v_us.shape[2], 0
    if q_emb.is_cuda:
        q_emb, k_us, v_us, pv = pad_rank_operands(q_emb, k_us, v_us, rv0)
    b, R, s_p, rk, rv = rankspace_shapes(q_emb, k_us, v_us)
    _check_factors(q_emb, k_us, v_us)
    dev = k_us.device
    lens, los = _live_range_or_none(b, lengths, win_lo, dev)
    nsplit = split_count(-(-s_p // 64), R, rv, b, _build.sm_count(dev))
    part_t, part_m, part_l, t, lse = _split_scratch(b, nsplit, R, rv, dev)
    status = _build.load().xkv_rankspace_decode(
        q_emb.data_ptr(), k_us.data_ptr(), v_us.data_ptr(), _ptr(lens), _ptr(los),
        part_t.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        t.data_ptr(), lse.data_ptr(), b, R, s_p, rk, rv, nsplit,
        int(k_us.dtype == torch.int8), _build.stream_ptr(dev),
    )
    _build.check(status, "rankspace_kernel")
    launches += 1
    return unpad_t(t, rv0, pv), lse


def split_count(n_blocks: int, R: int, rv: int, b: int, n_sm: int) -> int:
    """Key splits of a K2/K4/K6 launch: the grid (splits x value slices x
    32-row tiles x sequences) fills the SMs once, and no split is emptier
    than one 64-key block. One row tile (R <= 32) splits the value ranks
    into 256-rank slices; several tiles keep every rank up to 1024 in each
    CTA and take 1024-rank slices past that, as the kernel does."""
    tiles = -(-R // CTA_ROWS)
    slices = -(-rv // (SLICE_RANKS if tiles == 1 else WIDE_SLICE_RANKS))
    return max(1, min(n_blocks, n_sm // (b * tiles * slices)))


def pad_dim(x: Optional[torch.Tensor], dim: int, n: int, at: Optional[int] = None):
    """x with n zero slices inserted along ``dim`` before index ``at``
    (default: at the end); x itself when n is 0 or x is None."""
    if x is None or n == 0:
        return x
    at = x.shape[dim] if at is None else at
    shape = list(x.shape)
    shape[dim] = n
    zeros = torch.zeros(shape, dtype=x.dtype, device=x.device)
    return torch.cat([x.narrow(dim, 0, at), zeros, x.narrow(dim, at, x.shape[dim] - at)], dim)


def pad_rank_operands(q_emb, k_us, v_us, rv: int):
    """K2's, K4's and K6's operands zero-padded to the ranks the kernels'
    layout takes, multiples of 16 (the JAX kernels take any rank; the
    accuracy gates run ranks 8, 4 and 2): the key rank, ``q_emb``'s width,
    after ``k_us``'s columns (in ``q_emb``, before K6's int4 tail), the
    value rank ``rv`` (K6: int8 + int4) after ``v_us``'s. A zero rank adds
    nothing to a score or to t. Unaligned ranks are copied on every call:
    the caches keep the ranks they were built with. Returns (q_emb, k_us,
    v_us, pv): t's pv zero columns, which ``unpad_t`` drops."""
    pk, pv = -q_emb.shape[2] % 16, -rv % 16
    return (pad_dim(q_emb, 2, pk, at=k_us.shape[2]), pad_dim(k_us, 2, pk),
            pad_dim(v_us, 2, pv), pv)


def unpad_t(t: torch.Tensor, at: int, pv: int) -> torch.Tensor:
    """t without the ``pv`` zero value ranks ``pad_rank_operands`` put
    after its first ``at`` (``v_us``'s) columns."""
    if pv == 0:
        return t
    return torch.cat([t[..., :at], t[..., at + pv:]], dim=-1)


def rankspace_shapes(q_emb, k_us, v_us) -> Tuple[int, int, int, int, int]:
    """K2's and K4's shape rules, checked before any device check: (b, R,
    s_p, rk, rv). Any b and R; rk and rv positive multiples of 16, as the
    Pallas kernels' layout takes them."""
    _build.require(q_emb.dim() == 3 and k_us.dim() == 3 and v_us.dim() == 3,
                   "q_emb, k_us and v_us must be 3-D")
    b, R, rk = q_emb.shape
    s_p, rv = k_us.shape[1], v_us.shape[2]
    _build.require(tuple(k_us.shape) == (b, s_p, rk) and tuple(v_us.shape[:2]) == (b, s_p),
                   "factor shapes do not match q_emb")
    _build.require(rk % 16 == 0 and rv % 16 == 0 and rk > 0 and rv > 0,
                   f"ranks rk={rk}, rv={rv} must be positive multiples of 16")
    return b, R, s_p, rk, rv


def _check_factors(q_emb, k_us, v_us) -> None:
    """K2's and K4's device checks."""
    _build.require_cuda_tensor(q_emb, "q_emb", (torch.bfloat16,), 3)
    _build.require(q_emb.is_contiguous(), "q_emb must be contiguous")
    for name, t in (("k_us", k_us), ("v_us", v_us)):
        _build.require_cuda_tensor(t, name, (torch.bfloat16, torch.int8), 3)
        _build.require(t.is_contiguous(), f"{name} must be contiguous")
    _build.require(v_us.dtype == k_us.dtype, "k_us and v_us must share a dtype")


def _live_range_or_none(b, lengths, win_lo, dev):
    """(lens, los) int32 (b,) on ``dev``, each None where not given: the
    kernels read a null lens as s_p and a null los as 0, so no fill runs."""
    def as_i32(x):
        return None if x is None else x.reshape(b).to(device=dev, dtype=torch.int32).contiguous()
    return as_i32(lengths), as_i32(win_lo)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _split_scratch(b, nsplit, R, rv, dev):
    """Partials (t, m, l) of the splits and the merged (t, lse)."""
    f32 = torch.float32
    return (torch.empty((b, nsplit, R, rv), dtype=f32, device=dev),
            torch.empty((b, nsplit, R), dtype=f32, device=dev),
            torch.empty((b, nsplit, R), dtype=f32, device=dev),
            torch.empty((b, R, rv), dtype=f32, device=dev),
            torch.empty((b, R), dtype=f32, device=dev))


def mixed_rankspace_kernel(
    q_emb: torch.Tensor,
    k_us8: torch.Tensor,
    k_us4: torch.Tensor,
    v_us8: torch.Tensor,
    v_us4: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    win_lo: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: K2 over mixed int8 + packed int4 factors, the tails unpacked on
    chip to [evens | odds]. Returns (t (b, R, r8v + r4v) fp32 normalised,
    lse (b, R) fp32)."""
    if k_us8.device.type == "cpu":
        return mixed_rankspace_kernel_plain(q_emb, k_us8, k_us4, v_us8, v_us4, lengths,
                                            win_lo)
    global mixed_launches
    r8v0, pv = v_us8.shape[2], 0
    if q_emb.is_cuda:
        q_emb, k_us8, v_us8, pv = pad_rank_operands(q_emb, k_us8, v_us8,
                                                    r8v0 + 2 * v_us4.shape[2])
    b, R, s_p, r8k, h4k, r8v, h4v = mixed_shapes(q_emb, k_us8, k_us4, v_us8, v_us4)
    rv = r8v + 2 * h4v
    _build.require_cuda_tensor(q_emb, "q_emb", (torch.bfloat16,), 3)
    _build.require(q_emb.is_contiguous(), "q_emb must be contiguous")
    for name, t in (("k_us8", k_us8), ("k_us4", k_us4), ("v_us8", v_us8), ("v_us4", v_us4)):
        _build.require_cuda_tensor(t, name, (torch.int8,), 3)
        _build.require(t.is_contiguous(), f"{name} must be contiguous")
    dev = k_us8.device
    lens, los = _live_range_or_none(b, lengths, win_lo, dev)
    nsplit = split_count(-(-s_p // 64), R, rv, b, _build.sm_count(dev))
    part_t, part_m, part_l, t, lse = _split_scratch(b, nsplit, R, rv, dev)
    status = _build.load().xkv_mixed_rankspace_decode(
        q_emb.data_ptr(), k_us8.data_ptr(), k_us4.data_ptr(), v_us8.data_ptr(),
        v_us4.data_ptr(), _ptr(lens), _ptr(los), part_t.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), t.data_ptr(), lse.data_ptr(),
        b, R, s_p, r8k, h4k, r8v, h4v, nsplit, _build.stream_ptr(dev),
    )
    _build.check(status, "mixed_rankspace_kernel")
    mixed_launches += 1
    return unpad_t(t, r8v0, pv), lse


def mixed_shapes(q_emb, k_us8, k_us4, v_us8, v_us4) -> Tuple[int, ...]:
    """K6's shape rules, checked before any device check: (b, R, s_p, r8k,
    h4k, r8v, h4v). Any split of int8 and packed int4 ranks whose totals
    meet K2's rule (rk, rv positive multiples of 16)."""
    _build.require(all(x.dim() == 3 for x in (q_emb, k_us8, k_us4, v_us8, v_us4)),
                   "q_emb and the factors must be 3-D")
    b, R, rk = q_emb.shape
    s_p = k_us8.shape[1]
    r8k, h4k, r8v, h4v = k_us8.shape[2], k_us4.shape[2], v_us8.shape[2], v_us4.shape[2]
    for name, t in (("k_us8", k_us8), ("k_us4", k_us4), ("v_us8", v_us8), ("v_us4", v_us4)):
        _build.require(tuple(t.shape[:2]) == (b, s_p), f"{name} rows do not match k_us8")
    rv = r8v + 2 * h4v
    _build.require(rk == r8k + 2 * h4k, "q_emb width must be r8k + r4k")
    _build.require(rk % 16 == 0 and rv % 16 == 0 and rk > 0 and rv > 0,
                   f"total ranks rk={rk}, rv={rv} must be positive multiples of 16")
    return b, R, s_p, r8k, h4k, r8v, h4v


def chunk_blocks(block: int) -> int:
    """The 64-key blocks that K4 and K5 walk for each selected chunk of
    ``block`` rows: ceil(block / 64), the last one masked at the chunk's
    end. Any positive width is taken, as the JAX kernels take it."""
    _build.require(block > 0, f"chunk block {block} must be positive")
    return -(-block // 64)


def sparse_rankspace_kernel(
    q_emb: torch.Tensor,
    k_us: torch.Tensor,
    v_us: torch.Tensor,
    ids: torch.Tensor,
    block: int,
    lengths: Optional[torch.Tensor] = None,
    win_lo: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: K2 over the rows of the selected ``block``-row chunks only
    (``ids`` (b, n_sel); an id < 0 selects nothing). Returns (t (b, R, rv)
    fp32 normalised, lse (b, R) fp32)."""
    if k_us.device.type == "cpu":
        return sparse_rankspace_kernel_plain(q_emb, k_us, v_us, ids, block, lengths, win_lo)
    global sparse_launches
    rv0, pv = v_us.shape[2], 0
    if q_emb.is_cuda:
        q_emb, k_us, v_us, pv = pad_rank_operands(q_emb, k_us, v_us, rv0)
    b, R, s_p, rk, rv = rankspace_shapes(q_emb, k_us, v_us)
    per = chunk_blocks(block)
    _build.require(ids.dim() == 2 and ids.shape[0] == b, "ids must be (b, n_sel)")
    _check_factors(q_emb, k_us, v_us)
    dev = k_us.device
    ids = ids.to(device=dev, dtype=torch.int32).contiguous()
    n_sel = ids.shape[1]
    lens, los = _live_range_or_none(b, lengths, win_lo, dev)
    nsplit = split_count(n_sel * per, R, rv, b, _build.sm_count(dev))
    part_t, part_m, part_l, t, lse = _split_scratch(b, nsplit, R, rv, dev)
    status = _build.load().xkv_sparse_rankspace_decode(
        q_emb.data_ptr(), k_us.data_ptr(), v_us.data_ptr(), ids.data_ptr(),
        _ptr(lens), _ptr(los), part_t.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), t.data_ptr(), lse.data_ptr(), b, R, s_p, rk, rv, n_sel, block,
        nsplit, int(k_us.dtype == torch.int8), _build.stream_ptr(dev),
    )
    _build.check(status, "sparse_rankspace_kernel")
    sparse_launches += 1
    return unpad_t(t, rv0, pv), lse


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
    k_us4: Optional[torch.Tensor] = None,  # (b, s_p, r4k/2) packed int4 tail
    k_vt4_slice: Optional[torch.Tensor] = None,  # (b, r4k, hkv*hd) eo rows
    k_scale4_slice: Optional[torch.Tensor] = None,  # (b, 1, hkv*hd)
    v_us4: Optional[torch.Tensor] = None,  # (b, s_p, r4v/2) packed int4 tail
    *,
    scale: float,
    num_kv_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-space decode attention over post-RoPE factors. ``ql > 1`` runs
    every (position, head) pair as its own row. With ``k_us4``/``v_us4``
    the mixed int8+int4 kernel K6 runs in bf16; ``v_vt_slice`` and
    ``v_rank_scale`` are then in the stored [hi | lo-eo] rank order, which
    is the order of its t, so nothing is permuted. Returns (out (b, hq,
    ql, hd), lse (b, hq, ql)), a partial mergeable with the dense tail."""
    b, hq, ql, hd = q.shape
    if k_us4 is None:
        cd = compute_dtype_for(k_us.dtype)
        q_emb = _project_q(q, k_vt_slice, num_kv_heads, scale, k_scale_slice, cd)
        t, lse = rankspace_kernel(q_emb, k_us, v_us, lengths, win_lo)
    else:
        cd = torch.bfloat16
        q_emb = torch.cat([
            _project_q(q, k_vt_slice, num_kv_heads, scale, k_scale_slice, cd),
            _project_q(q, k_vt4_slice, num_kv_heads, scale, k_scale4_slice, cd)], dim=2)
        t, lse = mixed_rankspace_kernel(q_emb, k_us, k_us4, v_us, v_us4, lengths, win_lo)
    out = _project_out(t, v_vt_slice, v_rank_scale, num_kv_heads, ql, q.dtype)
    return out, lse.reshape(b, ql, hq).permute(0, 2, 1)


def sparse_rankspace_decode_attention(
    q: torch.Tensor,  # (b, hq, 1, hd) POST-RoPE decode queries
    k_us: torch.Tensor,
    k_vt_slice: torch.Tensor,
    v_us: torch.Tensor,
    v_vt_slice: torch.Tensor,
    chunk_ids: torch.Tensor,  # (b, n_sel) int32 from select_topk_chunks
    lengths: Optional[torch.Tensor] = None,
    k_scale_slice: Optional[torch.Tensor] = None,
    v_rank_scale: Optional[torch.Tensor] = None,
    win_lo: Optional[torch.Tensor] = None,
    *,
    scale: float,
    num_kv_heads: int,
    block: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse top-k rank-space decode (K4): only the selected chunks' rows
    are read. An id < 0 selects nothing (the adaptive budget's unused
    slots). Same contract as ``rankspace_decode_attention`` otherwise."""
    b, hq, ql, hd = q.shape
    if ql != 1:
        raise ValueError("sparse decode is single-token")
    cd = compute_dtype_for(k_us.dtype)
    q_emb = _project_q(q, k_vt_slice, num_kv_heads, scale, k_scale_slice, cd)
    t, lse = sparse_rankspace_kernel(q_emb, k_us, v_us, chunk_ids, block, lengths, win_lo)
    out = _project_out(t, v_vt_slice, v_rank_scale, num_kv_heads, 1, q.dtype)
    return out, lse[:, :, None]


# ----------------------------------------------------------------- MLA
def mla_rankspace_kernel_plain(
    q_emb: torch.Tensor,  # (b, R, rk) compute dtype, scale and folds applied
    q_pe: torch.Tensor,  # (b, R, rope) compute dtype, scale applied
    k_us: torch.Tensor,  # (b, s_p, rk) latent factors
    k_pe: torch.Tensor,  # (b, s_p, rope) rotated RoPE keys
    r: torch.Tensor,  # (b, s_p) fp32 latent inverse RMS
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's function in plain tensor code, with its numerics: factors and
    RoPE keys in the compute dtype, fp32 scores
    ``(q_emb . us^T) * r + q_pe . k_pe^T`` and softmax, ``P * r`` rounded to
    the compute dtype before the value product with the same ``us`` rows.
    Columns past ``lengths`` are masked. ``k_us`` may be narrower than
    ``q_emb`` (a draft's rank, ``mla_shapes``): its missing ranks are zero.
    Returns (t (b, R, rk) fp32 normalised, lse (b, R) fp32)."""
    b, s_p, ru = k_us.shape
    cd = q_emb.dtype
    lens, los = _build.live_range(b, s_p, lengths, None, k_us.device)
    us = F.pad(k_us.to(cd).to(torch.float32), (0, q_emb.shape[2] - ru))
    rr = r.to(torch.float32)[:, None, :]
    scores = (q_emb.to(torch.float32) @ us.transpose(1, 2)) * rr + (
        q_pe.to(torch.float32) @ k_pe.to(cd).to(torch.float32).transpose(1, 2))
    p, l_inv, lse = masked_softmax_stats(scores, live_columns(s_p, lens, los))
    t = (p * rr).to(cd).to(torch.float32) @ us
    return t * l_inv, lse


def mla_mixed_rankspace_kernel_plain(
    q_emb: torch.Tensor,  # (b, R, r8 + r4) bf16, [hi | lo-eo] columns
    q_pe: torch.Tensor,
    k_us8: torch.Tensor,  # (b, s_p, r8) int8
    k_us4: torch.Tensor,  # (b, s_p, r4/2) packed int4 pairs
    k_pe: torch.Tensor,
    r: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's function in plain tensor code: the packed tail unpacked to
    [evens | odds] beside the int8 ranks (exact in bf16), then K7's
    numerics. Returns (t (b, R, r8 + r4) fp32 in [hi | lo-eo] order, lse)."""
    us = torch.cat([k_us8, unpack_int4_rows(k_us4)], dim=-1)
    return mla_rankspace_kernel_plain(q_emb, q_pe, us, k_pe, r, lengths)


def rank_width(rank: int) -> int:
    """q_emb's width for ``rank`` factor ranks: the next multiple of 16."""
    return -(-rank // 16) * 16


def mla_shapes(q_emb, q_pe, k_us, k_pe, r, k_us4=None) -> Tuple[int, int, int, int, int]:
    """K7's and K8's shape rules, checked before any device check: (b, R,
    s_p, rk, rope), rk the width of q_emb and t, which is the factors'
    total rank (r8 + 2 * h4 with ``k_us4``) rounded up to a multiple of 16
    (``rank_width``; a draft's rank, K7 only, need not be one: the kernel
    reads ``k_us``'s columns and zero-fills the rest). Any b and R; rope a
    positive multiple of 16. Past 1024 ranks the kernel deals t's columns
    out to value slices of at most 1024 (``mla_split_count``)."""
    _build.require(all(x.dim() == 3 for x in (q_emb, q_pe, k_us, k_pe)) and r.dim() == 2,
                   "q_emb, q_pe, k_us and k_pe must be 3-D, r 2-D")
    b, R, rk = q_emb.shape
    s_p, rope = k_us.shape[1], q_pe.shape[2]
    width = k_us.shape[2] + (0 if k_us4 is None else 2 * k_us4.shape[2])
    _build.require(rk % 16 == 0 and rk > 0 and rope % 16 == 0 and rope > 0,
                   f"ranks rk={rk}, rope={rope} must be positive multiples of 16")
    _build.require(k_us.shape[0] == b and rank_width(width) == rk,
                   "q_emb width must be the factors' rank, rounded up to 16")
    _build.require(k_us4 is None or width == rk, "mixed factors' ranks must be a multiple of 16")
    if k_us4 is not None:
        _build.require(tuple(k_us4.shape[:2]) == (b, s_p), "k_us4 rows do not match k_us")
    _build.require(tuple(q_pe.shape) == (b, R, rope) and tuple(k_pe.shape) == (b, s_p, rope)
                   and tuple(r.shape) == (b, s_p),
                   "q_pe/k_pe/r shapes do not match q_emb and the factors")
    return b, R, s_p, rk, rope


def _check_mla(q_emb, q_pe, k_pe, r) -> None:
    """K7's and K8's device checks."""
    for name, x in (("q_emb", q_emb), ("q_pe", q_pe), ("k_pe", k_pe)):
        _build.require_cuda_tensor(x, name, (torch.bfloat16,), 3)
        _build.require(x.is_contiguous(), f"{name} must be contiguous")
    _build.require(r.is_cuda and r.dtype == torch.float32 and r.is_contiguous(),
                   "r must be contiguous fp32 on CUDA")


def mla_split_count(n_blocks: int, R: int, rk: int, b: int, n_sm: int) -> Tuple[int, int]:
    """(key splits, value slices) of a K7/K8 launch. The value slices are
    the fewest of at most 1024 ranks (64-rank panels dealt out evenly).
    The grid (splits x value slices x 32-row tiles x sequences) fills the
    SMs once, with at least one 64-key block a split: each SM takes one
    CTA, whose fp32 partials are its rows of t, however long the segment."""
    panels = -(-rk // 64)
    slices = -(-panels // (WIDE_SLICE_RANKS // 64))
    tiles = -(-R // CTA_ROWS)
    return max(1, min(n_blocks, n_sm // (b * tiles * slices))), slices


def _mla_launch(name, q_emb, q_pe, k_us, k_us4, k_pe, r, lengths, r8, h4, is_int8):
    """Launch K7 (``k_us4`` None) or K8 at ``mla_split_count``'s splits;
    the kernel reads ``k_us``'s columns through its row stride."""
    b, R, rk = q_emb.shape
    s_p = k_us.shape[1]
    dev = k_us.device
    lens, los = _live_range_or_none(b, lengths, None, dev)
    nsplit, vslices = mla_split_count(-(-s_p // 64), R, rk, b, _build.sm_count(dev))
    part_t, part_m, part_l, t, lse = _split_scratch(b, nsplit, R, rk, dev)
    status = _build.load().xkv_mla_rankspace_decode(
        q_emb.data_ptr(), q_pe.data_ptr(), k_us.data_ptr(), _ptr(k_us4), k_pe.data_ptr(),
        r.data_ptr(), _ptr(lens), _ptr(los), part_t.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), t.data_ptr(), lse.data_ptr(), b, R, s_p, r8, h4, k_us.shape[2],
        k_us.stride(1), q_pe.shape[2], nsplit, vslices, is_int8, _build.stream_ptr(dev),
    )
    _build.check(status, name)
    return t, lse


def mla_rankspace_kernel(
    q_emb: torch.Tensor,
    q_pe: torch.Tensor,
    k_us: torch.Tensor,
    k_pe: torch.Tensor,
    r: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: the absorbed MLA decode over the factored latent. Returns (t (b,
    R, rk) fp32 normalised, lse (b, R) fp32); live columns [0, lengths).
    ``k_us`` may be a column slice of wider factors (a draft's top ranks,
    read in place): unit column stride, a row stride of whole 16 bytes,
    and sequences one after another."""
    if k_us.device.type == "cpu":
        return mla_rankspace_kernel_plain(q_emb, q_pe, k_us, k_pe, r, lengths)
    global mla_launches
    rk = mla_shapes(q_emb, q_pe, k_us, k_pe, r)[3]
    _build.require_cuda_tensor(k_us, "k_us", (torch.bfloat16, torch.int8), 3)
    ld = k_us.stride(1)
    _build.require(k_us.stride(2) == 1 and (ld * k_us.element_size()) % 16 == 0
                   and (k_us.shape[0] == 1 or k_us.stride(0) == k_us.shape[1] * ld)
                   and k_us.data_ptr() % 16 == 0,
                   "k_us must be rows of unit column stride at a 16-byte row stride")
    _check_mla(q_emb, q_pe, k_pe, r)
    t, lse = _mla_launch("mla_rankspace_kernel", q_emb, q_pe, k_us, None, k_pe, r, lengths, rk,
                         0, int(k_us.dtype == torch.int8))
    mla_launches += 1
    return t, lse


def mla_mixed_rankspace_kernel(
    q_emb: torch.Tensor,
    q_pe: torch.Tensor,
    k_us8: torch.Tensor,
    k_us4: torch.Tensor,
    k_pe: torch.Tensor,
    r: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: K7 over int8 + packed int4 latent factors, the tail unpacked on
    chip to [evens | odds]. Returns (t (b, R, r8 + r4) fp32 normalised in
    [hi | lo-eo] order, lse (b, R) fp32)."""
    if k_us8.device.type == "cpu":
        return mla_mixed_rankspace_kernel_plain(q_emb, q_pe, k_us8, k_us4, k_pe, r, lengths)
    global mla_mixed_launches
    mla_shapes(q_emb, q_pe, k_us8, k_pe, r, k_us4)
    r8, h4 = k_us8.shape[2], k_us4.shape[2]
    for name, x in (("k_us8", k_us8), ("k_us4", k_us4)):
        _build.require_cuda_tensor(x, name, (torch.int8,), 3)
        _build.require(x.is_contiguous(), f"{name} must be contiguous")
    _check_mla(q_emb, q_pe, k_pe, r)
    t, lse = _mla_launch("mla_mixed_rankspace_kernel", q_emb, q_pe, k_us8, k_us4, k_pe, r,
                         lengths, r8, h4, 1)
    mla_mixed_launches += 1
    return t, lse


def mla_rankspace_decode_attention(
    q_emb: torch.Tensor,  # (b, nh, ql, rk) absorbed rank-space query, folded;
                          # with k_us4: (b, nh, ql, r8 + r4), [hi | lo-eo]
    q_pe: torch.Tensor,  # (b, nh, ql, rope) rotated RoPE query, scale folded
    k_us: torch.Tensor,  # (b, s_p, rk) latent factors (int8 hi ranks if mixed)
    k_pe: torch.Tensor,  # (b, s_p, rope) dense rotated RoPE keys
    r: torch.Tensor,  # (b, s_p) fp32 latent inverse RMS
    lengths: Optional[torch.Tensor] = None,  # (b,) valid prefill length
    k_us4: Optional[torch.Tensor] = None,  # (b, s_p, r4/2) packed int4 tail
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absorbed MLA decode over the factored latent and the dense RoPE keys
    (K7; K8 with ``k_us4``). Rows R = ql * nh are ordered (ql, nh). The
    compute dtype is fp32 for fp32 factors without ``k_us4``, else bf16;
    ``q_emb`` and ``q_pe`` are rounded to it and ``k_pe`` cast. Returns (t
    (b, nh, ql, rk_tot) fp32, normalised within the segment, in the rank
    order of ``q_emb``; lse (b, nh, ql)); the caller projects t through
    the group's vt and merges with the dense tail. ``k_us`` may be a
    column slice of wider factors (``mla_rankspace_kernel``), of any
    width: q_emb is zero-padded to ``rank_width`` and t cut back."""
    b, nh, ql, rk_q = q_emb.shape
    rope = q_pe.shape[3]
    cd = (torch.float32 if k_us.dtype == torch.float32 and k_us4 is None
          else torch.bfloat16)
    width = rank_width(rk_q)
    qe = F.pad(q_emb.permute(0, 2, 1, 3).reshape(b, ql * nh, rk_q).to(cd), (0, width - rk_q))
    qe = qe.contiguous()
    qp = q_pe.permute(0, 2, 1, 3).reshape(b, ql * nh, rope).to(cd).contiguous()
    k_pe = k_pe.to(cd).contiguous()
    r = r.to(torch.float32).contiguous()
    if k_us4 is None:
        t, lse = mla_rankspace_kernel(qe, qp, k_us, k_pe, r, lengths)
    else:
        t, lse = mla_mixed_rankspace_kernel(qe, qp, k_us, k_us4, k_pe, r, lengths)
    t = t[..., :rk_q].reshape(b, ql, nh, rk_q).permute(0, 2, 1, 3)
    return t, lse.reshape(b, ql, nh).permute(0, 2, 1)
