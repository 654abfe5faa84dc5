"""K9: design variants of K3's score stage (``csrc/kernel_variants.cu``).

Port of ``scripts/kernel_variants.py`` ``variant_attention`` (Pallas body
``_variant_kernel``): K3's function, the same inputs and ``(out (b, hq, ql,
hd), lse (b, hq, ql))`` as ``lowrank_decode_attention`` with ``lengths`` and
no window, computed by candidate designs of the score stage
``s = qa . (K*cos)^T + qb . (K*sin)^T``:

- ``two_gemm``: two score products of depth hd, K*cos against qa and K*sin
  against qb, accumulated;
- ``scratch_ab``: [K*cos | K*sin] staged in one shared buffer and one score
  product of depth 2 hd;
- ``b<N>``: ``scratch_ab`` with N keys a split (N a positive multiple of 64),
  as the TPU tool's ``block_s`` is the run of keys one grid step walks into
  one accumulator. ``two_gemm`` and ``scratch_ab`` split the keys by K3's
  rule (``_build.num_splits``). The split width changes only the order of
  fp32 sums in the merge, so the plain version ignores it.

The kernels run K3's resident split kernel with another score stage and
read the compact embeds of each row's own head, as ``lowrank_kernel`` does.
The plain version builds the TPU's full-width embeds (``full_query_embeds``)
and contracts over depth 2m, as the JAX body does. The ``prod`` variant of
the tool is K3 itself. ``variant_kernel`` launches the CUDA kernel for CUDA
tensors and runs ``variant_kernel_plain`` for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from xkv_tpu_torch.ops.kernels import _build
from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
from xkv_tpu_torch.ops.kernels.lowrank_attention import (
    _check_operands,
    _query_embeds,
    attend_rank_space,
    half_tables,
    trig_keys,
)
from xkv_tpu_torch.ops.kernels.rankspace_attention import live_columns

# Launches of the CUDA kernel since the last reset (plain runs not counted).
launches = 0

# The head size K3's wgmma instance is built for, and the largest rank_k
# whose k_vt slice it keeps resident there, by factor dtype (K3 streams
# larger slices through another kernel: ``k3.streams_kvt``).
HEAD_DIM = 128
RESIDENT_RANK_K = {torch.bfloat16: 512, torch.int8: 1024}
_DESIGNS = {"two_gemm": 1, "scratch_ab": 2}


def parse_variant(name: str) -> Tuple[str, Optional[int]]:
    """A variant name of the tool -> (design, keys a split): ``two_gemm`` and
    ``scratch_ab`` take K3's split rule (None), ``b<N>`` is ``scratch_ab``
    with N keys a split. Raises ValueError for another name or N."""
    if name in _DESIGNS:
        return name, None
    if name.startswith("b") and name[1:].isdigit():
        n = int(name[1:])
        _build.require(n > 0 and n % 64 == 0,
                       f"{name}: N must be a positive multiple of 64 keys (the kernels' "
                       "64-key blocks)")
        return "scratch_ab", n
    raise ValueError(f"unknown variant {name!r}")


def full_query_embeds(qab: torch.Tensor, num_q_heads: int, num_kv_heads: int) -> torch.Tensor:
    """Compact embeds (b, R, 2*hd) [qa | qb] of each row's own head -> the
    TPU form (b, R, 2*m), m = hkv*hd: [qa | qb] placed at the row's head's
    columns of each half, zero elsewhere (the JAX ``_query_embeds`` with
    its head mask; the values are the same)."""
    b, R, two_hd = qab.shape
    hd = two_hd // 2
    hkv = num_kv_heads
    m = hkv * hd
    head = (torch.arange(R, device=qab.device) % num_q_heads) // (num_q_heads // hkv)
    mask = torch.nn.functional.one_hot(head, hkv).to(qab.dtype)  # (R, hkv)
    qa = (qab[..., None, :hd] * mask[None, :, :, None]).reshape(b, R, m)
    qb = (qab[..., None, hd:] * mask[None, :, :, None]).reshape(b, R, m)
    return torch.cat([qa, qb], dim=-1).contiguous()


def kernel_shapes(qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h, num_q_heads,
                  num_kv_heads):
    """K9's shape checks, run before the device checks: K3's
    (``lowrank_attention.kernel_shapes``), narrowed to what K3's resident
    wgmma instance takes, the main path's shape: head size 128, a k_vt
    slice that stays resident (rank_k up to 512 bf16, 1024 int8) and rank_v
    up to 1024 (one value slice). Returns (b, R, hd, s_p, rk, rv)."""
    shapes = k3.kernel_shapes(qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h,
                              num_q_heads, num_kv_heads)
    hd, rk, rv = shapes[2], shapes[4], shapes[5]
    _build.require(hd == HEAD_DIM, f"head size {hd}: K9 runs K3's wgmma instance, head size "
                                   f"{HEAD_DIM} only")
    limit = RESIDENT_RANK_K.get(k_us.dtype, RESIDENT_RANK_K[torch.bfloat16])
    _build.require(rk <= limit, f"rank_k {rk}: K9 needs the k_vt slice resident, rank_k <= "
                               f"{limit} for {k_us.dtype}")
    _build.require(rv <= k3.SLICE_RANKS, f"rank_v {rv}: K9 takes one value slice, rank_v <= "
                                         f"{k3.SLICE_RANKS}")
    return shapes


def variant_kernel_plain(
    qab: torch.Tensor,  # (b, R, 2*hd) compact [qa | qb] of each row's own head
    k_us: torch.Tensor,  # (b, s_p, rk)
    k_vt_slice: torch.Tensor,  # (b, rk, m)
    v_us: torch.Tensor,  # (b, s_p, rv)
    v_vt_slice: torch.Tensor,  # (b, rv, m)
    cos_h: torch.Tensor,  # (s_p, hd/2)
    sin_h: torch.Tensor,
    v_scale: Optional[torch.Tensor],  # (b, 1, rv) fp32, int8 factors only
    lengths: Optional[torch.Tensor],
    *,
    num_q_heads: int,
    num_kv_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The variants' function in plain tensor code, as the JAX body takes
    it: the TPU's full-width embeds (``full_query_embeds``) against
    [K*cos | K*sin] of all heads in one product of depth 2m, with K3's
    numerics."""
    b, s_p = k_us.shape[:2]
    lens, los = _build.live_range(b, s_p, lengths, None, k_us.device)
    qab_full = full_query_embeds(qab, num_q_heads, num_kv_heads)
    k_cos, k_sin = trig_keys(k_us, k_vt_slice, cos_h[None], sin_h[None], num_kv_heads)
    ab = torch.cat([k_cos.reshape(b, s_p, -1), k_sin.reshape(b, s_p, -1)], dim=-1)
    scores = qab_full.to(torch.float32) @ ab.transpose(1, 2)
    return attend_rank_space(scores, live_columns(s_p, lens, los), k_us.dtype, v_us, v_vt_slice,
                             v_scale, num_q_heads, num_kv_heads, qab.dtype)


def variant_kernel(
    qab: torch.Tensor,
    k_us: torch.Tensor,
    k_vt_slice: torch.Tensor,
    v_us: torch.Tensor,
    v_vt_slice: torch.Tensor,
    cos_h: torch.Tensor,
    sin_h: torch.Tensor,
    v_scale: Optional[torch.Tensor],
    lengths: Optional[torch.Tensor],
    *,
    num_q_heads: int,
    num_kv_heads: int,
    variant: str = "scratch_ab",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: (out (b, R, hd), lse (b, R) fp32) by the design ``variant``
    (``two_gemm``, ``scratch_ab`` or ``b<N>``), from the compact embeds."""
    design, keys = parse_variant(variant)
    if k_us.device.type == "cpu":
        return variant_kernel_plain(qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h,
                                    v_scale, lengths, num_q_heads=num_q_heads,
                                    num_kv_heads=num_kv_heads)
    global launches
    b, R, hd, s_p, rk, rv = kernel_shapes(qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h,
                                          num_q_heads, num_kv_heads)
    quantized = _check_operands(qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h,
                                v_scale, num_q_heads, num_kv_heads)
    dev = k_us.device
    lens, los = _build.live_range(b, s_p, lengths, None, dev)
    tiles = -(-(R // num_kv_heads) // k3.HEAD_ROW_TILE)
    if keys is None:  # K3's rule
        run, nsplit = 0, _build.num_splits(s_p, b * num_kv_heads * tiles, 1, dev)
    else:  # runs of keys / 64 blocks over s_p's; a split past a sequence's end walks nothing
        run = keys // 64
        blocks = -(-s_p // 64)
        nsplit = -(-blocks // run)
    part_t = torch.empty((b, nsplit, R, rv), dtype=torch.float32, device=dev)
    part_m = torch.empty((b, nsplit, R), dtype=torch.float32, device=dev)
    part_l = torch.empty((b, nsplit, R), dtype=torch.float32, device=dev)
    part_o = torch.empty((b, -(-rv // 64), R, hd), dtype=torch.float32, device=dev)
    done = torch.empty((b * num_kv_heads * tiles,), dtype=torch.int32, device=dev)
    out = torch.empty((b, R, hd), dtype=torch.bfloat16, device=dev)
    lse = torch.empty((b, R), dtype=torch.float32, device=dev)
    status = _build.load().xkv_variant_decode(
        qab.data_ptr(), k_us.data_ptr(), k_vt_slice.data_ptr(), k_vt_slice.stride(0),
        k_vt_slice.stride(1), v_us.data_ptr(), v_vt_slice.data_ptr(), v_vt_slice.stride(0),
        v_vt_slice.stride(1), cos_h.data_ptr(), sin_h.data_ptr(),
        v_scale.data_ptr() if quantized else None, lens.data_ptr(), los.data_ptr(),
        part_t.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), part_o.data_ptr(),
        done.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, R, num_q_heads, num_kv_heads, hd, s_p, rk, rv, nsplit, run, int(quantized),
        _DESIGNS[design], _build.stream_ptr(dev))
    _build.check(status, f"variant_kernel[{variant}]")
    launches += 1
    return out, lse


def variant_attention(
    q_pre: torch.Tensor,  # (b, hq, ql, hd) PRE-RoPE decode queries
    k_us: torch.Tensor,
    k_vt_slice: torch.Tensor,
    v_us: torch.Tensor,
    v_vt_slice: torch.Tensor,
    cos_p: torch.Tensor,  # (s_p, hd)
    sin_p: torch.Tensor,
    cos_t: torch.Tensor,  # (b|1, hd) or (b|1, ql, hd)
    sin_t: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    k_scale_slice: Optional[torch.Tensor] = None,
    v_rank_scale: Optional[torch.Tensor] = None,
    *,
    scale: float,
    num_kv_heads: int,
    variant: str = "scratch_ab",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lowrank_decode_attention`` (K3) by the design ``variant``: the same
    contract, with ``lengths`` and no window."""
    b, hq, ql, hd = q_pre.shape
    quantized = k_us.dtype == torch.int8
    if quantized and (k_scale_slice is None or v_rank_scale is None):
        raise ValueError("int8 factors need k_scale_slice and v_rank_scale")
    if not quantized:
        k_scale_slice = v_rank_scale = None
    cos_h, sin_h = half_tables(cos_p, sin_p, k_us.dtype)
    qab = _query_embeds(q_pre, cos_t, sin_t, num_kv_heads, scale, k_scale_slice)
    v_scale = v_rank_scale.to(torch.float32).contiguous() if quantized else None
    out, lse = variant_kernel(
        qab, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h, v_scale, lengths,
        num_q_heads=hq, num_kv_heads=num_kv_heads, variant=variant)
    out = out.reshape(b, ql, hq, hd).permute(0, 2, 1, 3).to(q_pre.dtype)
    return out, lse.reshape(b, ql, hq).permute(0, 2, 1)
