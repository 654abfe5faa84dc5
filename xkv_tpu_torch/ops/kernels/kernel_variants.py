"""K9: design variants of K3's score stage (``csrc/kernel_variants.cu``).

Port of ``scripts/kernel_variants.py`` ``variant_attention`` (Pallas body
``_variant_kernel``): K3's function, the same inputs and ``(out (b, hq, ql,
hd), lse (b, hq, ql))`` as ``lowrank_decode_attention`` with ``lengths`` and
no window, computed by candidate designs of the score stage:

- ``two_gemm``: two score products of depth m = hkv*hd (qa against K*cos,
  qb against K*sin), accumulated, 64-key blocks;
- ``scratch_ab``: [K*cos | K*sin] of all kv heads staged in one shared
  buffer and one score product of depth 2m; it stages 32 keys at a time,
  since 64 keys of 2m = 2048 bf16 columns would take 256 KB;
- ``b<N>``: ``scratch_ab`` staging N keys (16 or 32) at a time.

Both contract the TPU's full-width query embeds (``full_query_embeds``:
[qa | qb] over all heads' columns, zero off each row's head). The
``prod`` variant of the tool is K3 itself. ``variant_kernel`` launches the
CUDA kernel for CUDA tensors and runs ``variant_kernel_plain`` for CPU
tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from xkv_tpu_torch.ops.kernels import _build
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

# Keys staged at a time by scratch_ab: (N x 2m) bf16 must fit in a block's
# 227 KB beside the rest (2m <= 2048).
SCRATCH_AB_BLOCKS = (16, 32)


def parse_variant(name: str) -> Tuple[str, int]:
    """A variant name of the tool -> (design, keys per staged block):
    two_gemm 64, scratch_ab 32, b<N> scratch_ab with N. Raises ValueError
    for a name or an N the kernel does not take."""
    if name == "two_gemm":
        return "two_gemm", 64
    if name == "scratch_ab":
        return "scratch_ab", max(SCRATCH_AB_BLOCKS)
    if name.startswith("b") and name[1:].isdigit():
        n = int(name[1:])
        _build.require(n in SCRATCH_AB_BLOCKS,
                       f"{name}: scratch_ab stages (N x 2m) bf16 keys in shared memory, "
                       f"N in {SCRATCH_AB_BLOCKS} (227 KB a block)")
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


def variant_kernel_plain(
    qab_full: torch.Tensor,  # (b, R, 2m)
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
    """The variants' function in plain tensor code: K3's numerics with the
    scores taken as one product of depth 2m, [K*cos | K*sin] of all heads
    against the full-width embeds."""
    b, s_p = k_us.shape[:2]
    lens, los = _build.live_range(b, s_p, lengths, None, k_us.device)
    k_cos, k_sin = trig_keys(k_us, k_vt_slice, cos_h[None], sin_h[None], num_kv_heads)
    ab = torch.cat([k_cos.reshape(b, s_p, -1), k_sin.reshape(b, s_p, -1)], dim=-1)
    scores = qab_full.to(torch.float32) @ ab.transpose(1, 2)
    return attend_rank_space(scores, live_columns(s_p, lens, los), k_us.dtype, v_us, v_vt_slice,
                             v_scale, num_q_heads, num_kv_heads, qab_full.dtype)


def variant_kernel(
    qab_full: torch.Tensor,
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
    (``two_gemm``, ``scratch_ab`` or ``b<N>``)."""
    design, block = parse_variant(variant)
    if k_us.device.type == "cpu":
        return variant_kernel_plain(qab_full, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h,
                                    v_scale, lengths, num_q_heads=num_q_heads,
                                    num_kv_heads=num_kv_heads)
    global launches
    b, R, two_m = qab_full.shape
    hd = 128
    _build.require(two_m == 2 * num_kv_heads * hd, "qab_full must be (b, R, 2*hkv*hd)")
    quantized = _check_operands(qab_full, k_us, k_vt_slice, v_us, v_vt_slice, cos_h, sin_h,
                                v_scale, num_q_heads, num_kv_heads, hd)
    s_p, rk, rv = k_us.shape[1], k_us.shape[2], v_us.shape[2]
    _build.require(512 < rv <= 768, f"rv {rv} not in (512, 768]: the one value width built")
    dev = k_us.device
    lens, los = _build.live_range(b, s_p, lengths, None, dev)
    nsplit = _build.num_splits(s_p, b * -(-R // 32), 1, dev)
    part_t = torch.empty((b, nsplit, R, rv), dtype=torch.float32, device=dev)
    part_m = torch.empty((b, nsplit, R), dtype=torch.float32, device=dev)
    part_l = torch.empty((b, nsplit, R), dtype=torch.float32, device=dev)
    out = torch.empty((b, R, hd), dtype=torch.bfloat16, device=dev)
    lse = torch.empty((b, R), dtype=torch.float32, device=dev)
    status = _build.load().xkv_variant_decode(
        qab_full.data_ptr(), k_us.data_ptr(), k_vt_slice.data_ptr(), k_vt_slice.stride(0),
        k_vt_slice.stride(1), v_us.data_ptr(), v_vt_slice.data_ptr(), v_vt_slice.stride(0),
        v_vt_slice.stride(1), cos_h.data_ptr(), sin_h.data_ptr(),
        v_scale.data_ptr() if quantized else None, lens.data_ptr(), los.data_ptr(),
        part_t.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, R, num_q_heads, num_kv_heads, hd, s_p, rk, rv, nsplit, int(quantized),
        0 if design == "two_gemm" else 1, block, _build.stream_ptr(dev))
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
        full_query_embeds(qab, hq, num_kv_heads), k_us, k_vt_slice, v_us, v_vt_slice, cos_h,
        sin_h, v_scale, lengths, num_q_heads=hq, num_kv_heads=num_kv_heads, variant=variant)
    out = out.reshape(b, ql, hq, hd).permute(0, 2, 1, 3).to(q_pre.dtype)
    return out, lse.reshape(b, ql, hq).permute(0, 2, 1)
