"""Plain attention ops and partial-softmax merging.

Port of ``xkv_tpu/ops/attention.py``. These are the numerically
authoritative versions that the CUDA kernels (``ops/kernels/``) are held
against, and the ops the port runs for CPU tensors. The JAX package's
``*_xla`` functions are named ``*_ref`` here (``factored_decode_attention_ref``
for ``factored_decode_attention_xla`` and so on); the arithmetic is the
same, in fp32 throughout.

The dense decode segment (dense prefill layers and the decode tail) and the
log-sum-exp merge stay on these plain ops on every device: the JAX package
ran them as XLA, not as Pallas kernels.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from xkv_tpu_torch.compress.quant import unpack_int4_rows

NEG_INF = -1e30


class PartialAttention(NamedTuple):
    """Result of attention over a subset of keys, mergeable via logsumexp.

    out: (..., q, hd) softmax-weighted values, normalised within the subset.
    lse: (..., q) log-sum-exp of the subset's scores.
    """

    out: torch.Tensor
    lse: torch.Tensor


def merge_partials(*parts: PartialAttention) -> torch.Tensor:
    """Merge attention computed over disjoint key subsets (flash-decoding
    combine): out = sum_i w_i out_i, w_i = exp(lse_i - lse_total)."""
    lses = torch.stack([p.lse.to(torch.float32) for p in parts], dim=0)
    lse_max = lses.max(dim=0).values
    weights = torch.exp(lses - lse_max[None])
    total = weights.sum(dim=0)
    out = None
    for p, w in zip(parts, weights):
        term = p.out.to(torch.float32) * (w / total)[..., None]
        out = term if out is None else out + term
    return out


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (b, hq, ql, hd), k: (b, hkv, s, hd) -> fp32 scores (b, hq, ql, s)."""
    b, hq, ql, hd = q.shape
    hkv = k.shape[1]
    qg = q.to(torch.float32).reshape(b, hkv, hq // hkv, ql, hd)
    scores = torch.einsum("bgnqd,bgsd->bgnqs", qg, k.to(torch.float32))
    return scores.reshape(b, hq, ql, -1)


def _gqa_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (b, hq, ql, s) fp32, v: (b, hkv, s, hd) -> fp32 (b, hq, ql, hd)."""
    b, hq, ql, s = p.shape
    hkv = v.shape[1]
    pg = p.reshape(b, hkv, hq // hkv, ql, s)
    out = torch.einsum("bgnqs,bgsd->bgnqd", pg, v.to(torch.float32))
    return out.reshape(b, hq, ql, -1)


def attention_partial(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    mask: Optional[torch.Tensor] = None,
) -> PartialAttention:
    """Softmax attention over one key subset, returning mergeable partials.

    q: (b, hq, ql, hd); k, v: (b, hkv, s, hd); mask broadcastable to
    (b, 1|hq, ql, s), True = attend. Outputs are fp32.
    """
    scores = _gqa_scores(q, k) * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.max(dim=-1, keepdim=True).values
    m_safe = torch.clamp(m, min=-1e29)  # fully-masked rows
    e = torch.exp(scores - m_safe)
    if mask is not None:
        e = torch.where(mask, e, torch.zeros_like(e))
    l = e.sum(dim=-1, keepdim=True)
    out = _gqa_values(e / torch.clamp(l, min=1e-30), v)
    lse = m_safe.squeeze(-1) + torch.log(torch.clamp(l.squeeze(-1), min=1e-30))
    return PartialAttention(out=out, lse=lse)


def causal_mask(q_len: int, kv_len: int, q_offset: int = 0, device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean causal mask; query i at absolute position
    q_offset + i attends to kv positions <= its own."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def sliding_window_mask(
    q_len: int, kv_len: int, window: int, q_offset: int = 0, device=None
) -> torch.Tensor:
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return (kv_pos <= q_pos) & (kv_pos > q_pos - window)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain attention (the prefill oracle). Returns (b, hq, ql, hd) in
    q's dtype."""
    ql, s = q.shape[2], k.shape[2]
    if window is not None:
        mask = sliding_window_mask(ql, s, window, q_offset=s - ql, device=q.device)
    elif causal:
        mask = causal_mask(ql, s, q_offset=s - ql, device=q.device)
    else:
        mask = None
    if mask is not None:
        mask = mask[None, None]
    return attention_partial(q, k, v, scale, mask).out.to(q.dtype)


def plain_prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal prefill attention in plain, differentiable tensor code, as the
    JAX prefill's ``attention_impl="xla"`` runs it: ``mha_reference`` up to
    2048 rows, ``blockwise_causal_attention`` above. The training route
    (``train.lm``); K1 (``flash_attention``) has the same contract and no
    backward. q (b, hq, s, hd), k/v (b, hkv, s, hd) -> (b, s, hq, hd)."""
    if q.shape[2] > 2048:
        out = blockwise_causal_attention(q, k, v, scale, window=window)
    else:
        out = mha_reference(q, k, v, scale, causal=True, window=window)
    return out.permute(0, 2, 1, 3)


# ------------------------------------------------------------------ factored
def reconstruct_group_heads(
    us: torch.Tensor,
    vt_slice: torch.Tensor,
    num_heads: int,
    out_scale: Optional[torch.Tensor] = None,
    rank_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reconstruct one layer's K (or V) from group factors in fp32.

    us: (b, s, r); vt_slice: (b, r, hkv*hd). Returns (b, hkv, s, hd).
    Int8 factors: ``out_scale`` (b, 1, m) for the K scheme (int8 x int8
    product, post-scale) or ``rank_scale`` (b, 1, r) for the V scheme.
    """
    b, s, r = us.shape
    m = vt_slice.shape[-1]
    if out_scale is not None:
        # Integer products of int8 values summed in fp64 are exact for any
        # rank this cache uses, as the int32 accumulation is.
        prod = torch.bmm(us.to(torch.float64), vt_slice.to(torch.float64))
        mat = prod.to(torch.float32) * out_scale.to(torch.float32)
    else:
        usf = us.to(torch.float32)
        if rank_scale is not None:
            usf = usf * rank_scale.to(torch.float32)
        mat = torch.bmm(usf, vt_slice.to(torch.float32))
    hd = m // num_heads
    return mat.reshape(b, s, num_heads, hd).permute(0, 2, 1, 3)


def _col_mask(
    b: int,
    s: int,
    valid_len: Optional[torch.Tensor],
    valid_lo: Optional[torch.Tensor],
    device,
) -> Optional[torch.Tensor]:
    """(b, 1, 1, s) live-column mask for columns in [valid_lo, valid_len)."""
    if valid_len is None and valid_lo is None:
        return None
    cols = torch.arange(s, device=device)[None, :]
    mask = torch.ones((b, s), dtype=torch.bool, device=device)
    if valid_len is not None:
        mask &= cols < valid_len.reshape(-1, 1)
    if valid_lo is not None:
        mask &= cols >= valid_lo.reshape(-1, 1)
    return mask[:, None, None, :]


def factored_decode_attention_ref(
    q: torch.Tensor,
    k_us: torch.Tensor,
    k_vt_slice: torch.Tensor,
    v_us: torch.Tensor,
    v_vt_slice: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    scale: float,
    num_kv_heads: int,
    k_scale_slice: Optional[torch.Tensor] = None,
    v_rank_scale: Optional[torch.Tensor] = None,
    valid_len: Optional[torch.Tensor] = None,
    pre_rotated: bool = False,
    valid_lo: Optional[torch.Tensor] = None,
) -> PartialAttention:
    """Decode attention over the factored prefill segment, by reconstruction.

    q: (b, hq, ql, hd) post-RoPE queries; k_us/v_us: (b, s_p, r);
    k_vt_slice/v_vt_slice: (b, r, hkv*hd); cos/sin: (s_p, hd) tables for the
    prefill positions, applied to the reconstructed keys unless
    ``pre_rotated`` (the factors hold post-RoPE keys).
    """
    from xkv_tpu_torch.ops.rope import apply_rope

    k_rec = reconstruct_group_heads(k_us, k_vt_slice, num_kv_heads, out_scale=k_scale_slice)
    k = k_rec if pre_rotated else apply_rope(k_rec, cos[None], sin[None])
    v = reconstruct_group_heads(v_us, v_vt_slice, num_kv_heads, rank_scale=v_rank_scale)
    mask = _col_mask(k.shape[0], k.shape[2], valid_len, valid_lo, q.device)
    return attention_partial(q, k.to(q.dtype), v.to(q.dtype), scale, mask)


def rankspace_decode_attention_ref(
    q: torch.Tensor,
    k_us: torch.Tensor,
    k_vt_slice: torch.Tensor,
    v_us: torch.Tensor,
    v_vt_slice: torch.Tensor,
    scale: float,
    num_kv_heads: int,
    k_scale_slice: Optional[torch.Tensor] = None,
    v_rank_scale: Optional[torch.Tensor] = None,
    valid_len: Optional[torch.Tensor] = None,
    valid_lo: Optional[torch.Tensor] = None,
    k_us4: Optional[torch.Tensor] = None,  # packed int4 tails (mixed storage)
    k_vt4_slice: Optional[torch.Tensor] = None,
    k_scale4_slice: Optional[torch.Tensor] = None,
    v_us4: Optional[torch.Tensor] = None,
) -> PartialAttention:
    """Decode attention over POST-RoPE factors in rank space: K is never
    reconstructed, scores = (q . vt^T) . us^T and out = ((P . us) * s) . vt.

    With ``k_us4``/``v_us4`` (mixed int8+int4) the packed tails are
    unpacked and contracted beside the int8 top ranks; ``v_vt_slice`` and
    ``v_rank_scale`` are in the stored [hi | lo-evens | lo-odds] order.
    """
    s_p = k_us.shape[1]
    mask = _col_mask(k_us.shape[0], s_p, valid_len, valid_lo, q.device)
    return _rankspace_partial(q, k_us, k_vt_slice, v_us, v_vt_slice, scale, num_kv_heads,
                              k_scale_slice, v_rank_scale, mask, k_us4, k_vt4_slice,
                              k_scale4_slice, v_us4)


def _rankspace_partial(q, k_us, k_vt_slice, v_us, v_vt_slice, scale, num_kv_heads,
                       k_scale_slice, v_rank_scale, mask, k_us4=None, k_vt4_slice=None,
                       k_scale4_slice=None, v_us4=None) -> PartialAttention:
    """The rank-space math over the rows given (all of a segment, or the
    gathered rows of selected chunks), ``mask`` (b, 1, 1, s) or None."""
    b, hq, ql, hd = q.shape
    hkv = num_kv_heads
    gsz = hq // hkv
    s = k_us.shape[1]

    def q_to_rank(vt_slice, col_scale):
        vt_f = vt_slice.to(torch.float32)
        if col_scale is not None:
            vt_f = vt_f * col_scale.to(torch.float32)
        vt_f = vt_f.reshape(b, vt_f.shape[1], hkv, hd)
        qg = q.to(torch.float32).reshape(b, hkv, gsz, ql, hd)
        return torch.einsum("bgnqd,brgd->bgnqr", qg, vt_f) * scale

    scores = torch.einsum("bgnqr,bsr->bgnqs", q_to_rank(k_vt_slice, k_scale_slice),
                          k_us.to(torch.float32))
    v_rows = v_us
    if k_us4 is not None:
        scores = scores + torch.einsum(
            "bgnqr,bsr->bgnqs", q_to_rank(k_vt4_slice, k_scale4_slice),
            unpack_int4_rows(k_us4).to(torch.float32))
        v_rows = torch.cat([v_us, unpack_int4_rows(v_us4)], dim=-1)
    scores = scores.reshape(b, hq, ql, s)

    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.max(dim=-1, keepdim=True).values
    m_safe = torch.clamp(m, min=-1e29)
    e = torch.exp(scores - m_safe)
    if mask is not None:
        e = torch.where(mask, e, torch.zeros_like(e))
    l = e.sum(dim=-1, keepdim=True)
    p = e / torch.clamp(l, min=1e-30)

    rv = v_rows.shape[2]
    t = torch.einsum("bhqs,bsr->bhqr", p, v_rows.to(torch.float32))
    if v_rank_scale is not None:
        t = t * v_rank_scale.to(torch.float32)[:, None]
    vt_v = v_vt_slice.to(torch.float32).reshape(b, rv, hkv, hd)
    tg = t.reshape(b, hkv, gsz, ql, rv)
    out = torch.einsum("bgnqr,brgd->bgnqd", tg, vt_v).reshape(b, hq, ql, hd)
    lse = m_safe.squeeze(-1) + torch.log(torch.clamp(l.squeeze(-1), min=1e-30))
    return PartialAttention(out=out, lse=lse)


# -------------------------------------------------------------- sparse top-k
def topk_ids(sc: torch.Tensor, n: int) -> torch.Tensor:
    """Ids (b, n) int32 of the n largest scores of each row, ties broken
    toward the lower index, as ``jax.lax.top_k`` breaks them: the sink and
    recency sentinels can tie, and so can dead chunks at -inf."""
    order = torch.sort(sc, dim=-1, descending=True, stable=True).indices
    return order[:, :n].to(torch.int32)


def chunk_bound_scores(
    q: torch.Tensor,  # (b, hq, ql, hd) post-RoPE decode queries
    k_cmin: torch.Tensor,  # (b, nc, hkv*hd) per-chunk min of post-RoPE keys
    k_cmax: torch.Tensor,  # (b, nc, hkv*hd) ... and max
    num_kv_heads: int,
    valid_len: Optional[torch.Tensor] = None,  # (b,)
    block: int = 512,
    win_lo: Optional[torch.Tensor] = None,  # (b,) sliding-window lower bound
    head_max: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quest upper-bound scores per chunk, max over heads and positions;
    ``head_max`` maps the max over these heads (b, nc) to the max over
    every head of the model (under a mesh, ``Mesh.all_max`` over the
    model axis).

    Returns (sc (b, nc): selection scores, the oldest live chunk (the sink,
    or the chunk holding ``win_lo``) and the last valid chunk (recency) set
    to the sentinel 3e38; live (b, nc) bool: chunks holding live rows;
    sc_raw (b, nc): the bounds with dead chunks at -inf and no sentinels).
    """
    b, hq, ql, hd = q.shape
    nc = k_cmin.shape[1]

    def to_heads(x):  # (b, nc, hkv*hd) -> (b, hkv, nc, hd)
        return x.to(torch.float32).reshape(b, nc, num_kv_heads, hd).permute(0, 2, 1, 3)

    qf = q.to(torch.float32)
    sc = (_gqa_scores(torch.clamp(qf, min=0.0), to_heads(k_cmax))
          + _gqa_scores(torch.clamp(qf, max=0.0), to_heads(k_cmin)))
    sc = sc.amax(dim=(1, 2))  # (b, nc)
    if head_max is not None:
        sc = head_max(sc)
    cidx = torch.arange(nc, device=q.device)[None, :]
    if valid_len is not None:
        n_valid = -(-valid_len.reshape(-1, 1).to(torch.int64) // block)
        sc = torch.where(cidx < n_valid, sc, -math.inf)
        last_valid = torch.clamp(n_valid - 1, min=0)
    else:
        last_valid = torch.full((b, 1), nc - 1, device=q.device)
    if win_lo is not None:
        first_live = win_lo.reshape(-1, 1).to(torch.int64) // block
        sc = torch.where(cidx < first_live, -math.inf, sc)
    else:
        first_live = torch.zeros((b, 1), dtype=torch.int64, device=q.device)
    live = torch.isfinite(sc)
    sc_raw = sc
    sc = torch.where(cidx == first_live, 3e38, sc)
    sc = torch.where(cidx == last_valid, 3e38, sc)
    return sc, live, sc_raw


def select_topk_chunks(
    q: torch.Tensor,
    k_cmin: torch.Tensor,
    k_cmax: torch.Tensor,
    n_select: int,
    num_kv_heads: int,
    valid_len: Optional[torch.Tensor] = None,
    block: int = 512,
    win_lo: Optional[torch.Tensor] = None,
    head_max: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Quest-style upper-bound chunk selection for sparse factored decode:
    the ``n_select`` chunks of highest ``U_c = qpos . kmax + qneg . kmin``,
    the sink and recency chunks always among them (``head_max``: as
    ``chunk_bound_scores``'s). Returns ids (b, n_select) int32."""
    sc, _, _ = chunk_bound_scores(q, k_cmin, k_cmax, num_kv_heads, valid_len=valid_len,
                                  block=block, win_lo=win_lo, head_max=head_max)
    return topk_ids(sc, n_select)


def adaptive_hot_chunks(sc_raw: torch.Tensor, live: torch.Tensor,
                        band: float = 0.5) -> torch.Tensor:
    """(b,) count of hot chunks: live chunks whose bound lies in the top
    ``band`` fraction of the (max - mean) spread. It picks the adaptive
    budget (``sparse_topk_max``) of a decode step."""
    scm = torch.where(live, sc_raw, torch.full_like(sc_raw, -3e38))
    sc_max = scm.amax(dim=1)
    cnt = torch.clamp(live.sum(dim=1), min=1)
    mean = torch.where(live, sc_raw, torch.zeros_like(sc_raw)).sum(dim=1) / cnt
    spread = torch.clamp(sc_max - mean, min=1e-6)
    thr = sc_max - band * spread
    return (live & (sc_raw >= thr[:, None])).sum(dim=1)


def chunk_positions(ids: torch.Tensor, block: int) -> torch.Tensor:
    """(b, n_sel) chunk ids -> (b, n_sel*block) absolute row positions."""
    b, n_sel = ids.shape
    j = torch.arange(block, device=ids.device)
    return (ids.to(torch.int64)[:, :, None] * block + j[None, None, :]).reshape(b, n_sel * block)


def gather_chunk_rows(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rows ``pos`` (b, n) of x (b, s, r), clamped into range (rows past s
    are masked by the caller). Returns (b, n, r)."""
    idx = torch.clamp(pos, 0, x.shape[1] - 1)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def sparse_row_mask(pos, ids, block, s_p, valid_len, valid_lo):
    """(b, 1, 1, n) live mask of the rows ``pos`` of chunks ``ids``: inside
    the segment and [valid_lo, valid_len), of a chunk that was selected
    (ids < 0 select nothing)."""
    vlen = valid_len.reshape(-1, 1) if valid_len is not None else s_p
    live = (pos < vlen) & (pos < s_p)
    live &= (ids >= 0).repeat_interleave(block, dim=1)
    if valid_lo is not None:
        live &= pos >= valid_lo.reshape(-1, 1)
    return live[:, None, None, :]


def sparse_factored_decode_attention_ref(
    q: torch.Tensor,  # (b, hq, ql, hd) post-RoPE
    k_us: torch.Tensor,  # (b, s_p, rk)
    k_vt_slice: torch.Tensor,
    v_us: torch.Tensor,
    v_vt_slice: torch.Tensor,
    cos: torch.Tensor,  # (s_p, hd)
    sin: torch.Tensor,
    ids: torch.Tensor,  # (b, n_select) chunk ids
    scale: float,
    num_kv_heads: int,
    block: int,
    k_scale_slice: Optional[torch.Tensor] = None,
    v_rank_scale: Optional[torch.Tensor] = None,
    valid_len: Optional[torch.Tensor] = None,
    pre_rotated: bool = False,
    valid_lo: Optional[torch.Tensor] = None,
) -> PartialAttention:
    """Sparse factored decode attention by reconstruction: gather the
    selected chunks' rows (and position-table rows), rebuild only those
    keys, rotate them unless ``pre_rotated`` (post-RoPE factors), attend."""
    from xkv_tpu_torch.ops.rope import apply_rope

    s_p = k_us.shape[1]
    pos = chunk_positions(ids, block)
    k_rec = reconstruct_group_heads(gather_chunk_rows(k_us, pos), k_vt_slice, num_kv_heads,
                                    out_scale=k_scale_slice)
    if pre_rotated:
        k = k_rec
    else:
        idx = torch.clamp(pos, 0, s_p - 1)
        k = apply_rope(k_rec, cos[idx][:, None], sin[idx][:, None])
    v = reconstruct_group_heads(gather_chunk_rows(v_us, pos), v_vt_slice, num_kv_heads,
                                rank_scale=v_rank_scale)
    mask = sparse_row_mask(pos, ids, block, s_p, valid_len, valid_lo)
    return attention_partial(q, k.to(q.dtype), v.to(q.dtype), scale, mask)


def sparse_rankspace_decode_attention_ref(
    q: torch.Tensor,  # (b, hq, ql, hd) POST-RoPE decode queries
    k_us: torch.Tensor,  # (b, s_p, rk) int8 top ranks (or full bf16/fp32)
    k_vt_slice: torch.Tensor,  # (b, rk, hkv*hd)
    v_us: torch.Tensor,
    v_vt_slice: torch.Tensor,  # (b, rv_tot, hkv*hd), [hi | lo-eo] if mixed
    ids: torch.Tensor,  # (b, n_select) chunk ids
    scale: float,
    num_kv_heads: int,
    block: int,
    k_scale_slice: Optional[torch.Tensor] = None,
    v_rank_scale: Optional[torch.Tensor] = None,
    valid_len: Optional[torch.Tensor] = None,
    k_us4: Optional[torch.Tensor] = None,
    k_vt4_slice: Optional[torch.Tensor] = None,
    k_scale4_slice: Optional[torch.Tensor] = None,
    v_us4: Optional[torch.Tensor] = None,
    valid_lo: Optional[torch.Tensor] = None,
) -> PartialAttention:
    """Sparse top-k decode over POST-RoPE factors in rank space, mixed
    int8+int4 storage included: gather the selected chunks' rows of every
    stream (packing runs along the rank axis, so row gathers keep it),
    then the rank-space math of ``rankspace_decode_attention_ref`` with
    per-row position masks."""
    s_p = k_us.shape[1]
    pos = chunk_positions(ids, block)

    def g(x):
        return None if x is None else gather_chunk_rows(x, pos)

    mask = sparse_row_mask(pos, ids, block, s_p, valid_len, valid_lo)
    return _rankspace_partial(q, g(k_us), k_vt_slice, g(v_us), v_vt_slice, scale,
                              num_kv_heads, k_scale_slice, v_rank_scale, mask, g(k_us4),
                              k_vt4_slice, k_scale4_slice, g(v_us4))


def dense_decode_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    valid_len: Optional[torch.Tensor] = None,
    valid_lo: Optional[torch.Tensor] = None,
) -> PartialAttention:
    """Decode attention over a dense segment (dense prefill layers or the
    decode tail). ``valid_len``: (b,) or (b, 1) for one shared length,
    (b, ql) for per-query lengths. ``valid_lo`` (b,) masks rows below a
    sliding-window lower bound."""
    mask = None
    s = k.shape[2]
    ql = q.shape[2]
    cols = torch.arange(s, device=q.device)
    if valid_len is not None:
        if valid_len.dim() == 1:
            valid_len = valid_len[:, None]
        if valid_len.shape[1] == ql:
            mask = cols[None, None, None, :] < valid_len[:, None, :, None]
        else:
            mask = (cols[None, :] < valid_len)[:, None, None, :]
    if valid_lo is not None:
        lo_mask = (cols[None, :] >= valid_lo[:, None])[:, None, None, :]
        mask = lo_mask if mask is None else (mask & lo_mask)
    return attention_partial(q, k, v, scale, mask)


# ----------------------------------------------------------------- blockwise
def blockwise_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    q_chunk: int = 512,
    k_chunk: int = 1024,
    window: Optional[int] = None,
    q_offset: int = 0,
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    """Memory-bounded causal attention with an online softmax: the (s, s)
    score matrix is never materialised, only (q_chunk, k_chunk) per head.

    q: (b, hq, s_q, hd); k: (b, hkv, s_k, hd); v: (b, hkv, s_k, hd_v).
    ``q_offset``: absolute position of q row 0; ``kv_valid``: number of
    valid kv rows (default s_k). Returns (b, hq, s_q, hd_v) in q's dtype.
    Probabilities are cast to v's dtype before the value product, as in the
    JAX version.
    """
    b, hq, s_q, hd = q.shape
    hkv = k.shape[1]
    s_k = k.shape[2]
    hd_v = v.shape[-1]
    g = hq // hkv
    q_chunk = min(q_chunk, s_q)
    k_chunk = min(k_chunk, s_k)
    if kv_valid is None:
        kv_valid = s_k
    qg = q.reshape(b, hkv, g, s_q, hd).to(torch.float32)
    out = torch.empty((b, hkv, g, s_q, hd_v), dtype=q.dtype, device=q.device)
    for q0 in range(0, s_q, q_chunk):
        qb = qg[:, :, :, q0:q0 + q_chunk]
        nq = qb.shape[3]
        rows = q_offset + q0 + torch.arange(nq, device=q.device)[:, None]
        m = torch.full((b, hkv, g, nq, 1), -math.inf, device=q.device)
        l = torch.zeros((b, hkv, g, nq, 1), device=q.device)
        acc = torch.zeros((b, hkv, g, nq, hd_v), device=q.device)
        for k0 in range(0, s_k, k_chunk):
            kb = k[:, :, k0:k0 + k_chunk].to(torch.float32)
            vb = v[:, :, k0:k0 + k_chunk]
            cols = k0 + torch.arange(kb.shape[2], device=q.device)[None, :]
            mask = (cols <= rows) & (cols < kv_valid)
            if window is not None:
                mask &= cols > rows - window
            sc = torch.einsum("bgnqd,bgkd->bgnqk", qb, kb) * scale
            sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
            m_next = torch.maximum(m, sc.max(dim=-1, keepdim=True).values)
            alpha = torch.exp(m - m_next)
            p = torch.where(mask, torch.exp(sc - m_next), torch.zeros_like(sc))
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            pv = torch.einsum(
                "bgnqk,bgkd->bgnqd",
                p.to(vb.dtype).to(torch.float32), vb.to(torch.float32),
            )
            acc = acc * alpha + pv
            m = m_next
        out[:, :, :, q0:q0 + nq] = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.reshape(b, hq, s_q, hd_v)
