"""K10: stage ablation of K3 (``csrc/kernel_ablation.cu``), a timing tool.

Port of ``scripts/kernel_ablation.py`` ``build_step`` (Pallas body
``_kernel``): a K3-shaped pass over int8 factors in which stages can be
switched off, so that the time each stage costs can be read off. With a
stage off the numbers are wrong on purpose; each stage set is still one
exact function, which ``ablation_step_plain`` computes and the tests hold
the TPU kernel and the CUDA kernel to.

Its output is not K3's: ``o = t[:, :hd]``, the rank-space accumulator at
the final running max (not normalised, no ``v_vt`` product), and the
running max ``m`` (``-inf`` with the softmax off). Scores contract all
``hkv * hd`` columns for every query row (``q_emb`` is (b, hq, hkv*hd)).

The keys are walked in 64-key blocks (K3's); the CUDA kernel, built on
K3's machinery (a producer warp's TMA ring, the key rebuild on ``wgmma``
s8, rotation in registers, scores and value product on ``wgmma``), deals
them out to ``nsplit`` CTAs and merges the parts as
``t = sum_j t_j exp(m_j - m)``.
The block structure is part of the function (``-vpath`` adds each block's
first ``v_us`` row), so the plain version takes the same ``nsplit``; with
``nsplit = 1`` it is the TPU kernel's function at ``block_s = 64``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from xkv_tpu_torch.ops.kernels import _build
from xkv_tpu_torch.ops.rope import rope_cos_sin

# Launches of the CUDA kernel since the last reset (plain runs not counted).
launches = 0

BLOCK = 64  # keys per block, as K3
ALL = ("recon", "scalemul", "rope", "scores", "softmax", "vpath")
# Stage bits of the CUDA kernel; "tile2d" only changes the TPU's lane
# layout of "ropeq" (the same function), so it adds no bit.
_BITS = {"recon": 1, "scalemul": 2, "rope": 4, "scores": 8, "softmax": 16, "vpath": 32,
         "rope_roll": 64, "ropeq": 128, "tile2d": 0}


def configs() -> list:
    """The tool's ten stage sets, as ``scripts/kernel_ablation.py:main``
    builds them: (name, stages)."""
    return (
        [("full", list(ALL))]
        + [(f"-{st}", [x for x in ALL if x != st]) for st in ALL]
        + [("roll-rope", [x if x != "rope" else "rope_roll" for x in ALL])]
        + [("ropeq", [x if x != "rope" else "ropeq" for x in ALL])]
        + [("ropeq2d", [x if x != "rope" else "ropeq" for x in ALL] + ["tile2d"])]
    )


def stage_bits(stages: Sequence[str]) -> int:
    unknown = [s for s in stages if s not in _BITS]
    _build.require(not unknown, f"unknown stages {unknown}")
    rot = [s for s in ("rope", "rope_roll", "ropeq") if s in stages]
    _build.require(len(rot) <= 1, f"at most one rotation stage, got {rot}")
    return sum(_BITS[s] for s in set(stages))


def full_width_tables(stages: Sequence[str]) -> bool:
    """Whether the stage set reads (s, hd) tables with rotate_half's sign
    folded into sin; else (s, hd/2) half tables."""
    return "rope_roll" in stages or "ropeq" in stages


def tables(s: int, hd: int, stages: Sequence[str], device) -> Tuple[torch.Tensor, ...]:
    """(cos_tab, sin_tab, trig) as ``build_step`` makes them: bf16 position
    tables at theta 500000 and the (2, hd) per-step relative-angle surrogate
    [cos(0.37); sin(0.37)]."""
    cos_p, sin_p = rope_cos_sin(torch.arange(s, device=device), hd, 500000.0)
    half = hd // 2
    ch, sh = cos_p[:, :half], sin_p[:, :half]
    if full_width_tables(stages):
        cos_t = torch.cat([ch, ch], dim=-1).to(torch.bfloat16)
        sin_t = torch.cat([-sh, sh], dim=-1).to(torch.bfloat16)
    else:
        cos_t, sin_t = ch.to(torch.bfloat16).contiguous(), sh.to(torch.bfloat16).contiguous()
    angle = torch.full((hd,), 0.37, dtype=torch.float32, device=device)
    return cos_t, sin_t, torch.stack([torch.cos(angle), torch.sin(angle)])


def inputs(b: int, s: int, hq: int, hkv: int, hd: int, rk: int, rv: int, device, seed: int = 0):
    """Random operands of ``build_step``'s shapes and types, from a torch
    generator: (q_emb, k_us, k_vt, v_us, k_scale)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    m = hkv * hd

    def ints(*shape):
        return torch.randint(-127, 127, shape, generator=gen, device=device, dtype=torch.int8)

    q = torch.randn((b, hq, m), generator=gen, device=device).to(torch.bfloat16)
    k_scale = torch.randn((b, 1, m), generator=gen, device=device).abs()
    return q, ints(b, s, rk), ints(b, rk, m), ints(b, s, rv), k_scale


def _rotated_keys(k_us, k_vt, k_scale, cos_tab, sin_tab, trig, stages, hkv):
    """Per key row: the rotated keys (b, s, m) in bf16, or the pair
    (K * cos_rel, K * sin_rel) for "ropeq"."""
    b, s, rk = k_us.shape
    m = k_vt.shape[2]
    hd = m // hkv
    half = hd // 2
    relative = "ropeq" in stages
    if "recon" in stages:  # exact: every partial sum is an integer below 2^53
        kp = torch.bmm(k_us.double(), k_vt.double()).float()
    else:
        kp = k_us.float().repeat(1, 1, m // rk)
    if "scalemul" in stages and not relative:
        kp = kp * k_scale.reshape(b, 1, m).float()
    k4 = kp.reshape(b, s, hkv, hd)
    if "rope" in stages:
        c = cos_tab.float()[None, :, None, :]
        sn = sin_tab.float()[None, :, None, :]
        k1, k2 = k4[..., :half], k4[..., half:]
        rot = torch.cat([k1 * c - k2 * sn, k2 * c + k1 * sn], dim=-1)
        return rot.to(torch.bfloat16).reshape(b, s, m)
    if "rope_roll" in stages:
        c = cos_tab.float()[None, :, None, :]
        sn = sin_tab.float()[None, :, None, :]
        rolled = torch.cat([k4[..., half:], k4[..., :half]], dim=-1)
        return (k4 * c + rolled * sn).to(torch.bfloat16).reshape(b, s, m)
    if relative:
        cb, sb = cos_tab.float(), sin_tab.float()
        ct, st = trig[0].float(), trig[1].float()
        crel = (cb * ct + sb * st).to(torch.bfloat16)[None, :, None, :]
        srel = (sb * ct - cb * st).to(torch.bfloat16)[None, :, None, :]
        kbf = k4.to(torch.bfloat16)
        return ((kbf * crel).reshape(b, s, m), (kbf * srel).reshape(b, s, m))
    return k4.to(torch.bfloat16).reshape(b, s, m)


def ablation_step_plain(
    q_emb: torch.Tensor,  # (b, hq, m) bf16
    k_us: torch.Tensor,  # (b, s, rk) int8
    k_vt: torch.Tensor,  # (b, rk, m) int8
    v_us: torch.Tensor,  # (b, s, rv) int8
    k_scale: torch.Tensor,  # (b, 1, m) fp32
    cos_tab: torch.Tensor,  # (s, hd/2) or (s, hd) bf16, see ``tables``
    sin_tab: torch.Tensor,
    trig: torch.Tensor,  # (2, hd) fp32
    stages: Sequence[str],
    *,
    num_kv_heads: int,
    nsplit: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10's function in plain tensor code: (o (b, hq, hd) bf16, m (b, hq)
    fp32), the 64-key blocks dealt out to ``nsplit`` parts as the kernel
    does (contiguous runs of ceil(blocks / nsplit))."""
    stage_bits(stages)
    b, hq, m = q_emb.shape
    s = k_us.shape[1]
    rv = v_us.shape[2]
    hd = m // num_kv_heads
    _build.require(s % BLOCK == 0, f"s {s} must be a multiple of {BLOCK}")
    scale = hd ** -0.5
    rot = _rotated_keys(k_us, k_vt, k_scale, cos_tab, sin_tab, trig, stages, num_kv_heads)
    qf = q_emb.float()
    if "scores" not in stages:
        scores = (rot[:, :, 0].float() * scale)[:, None, :].expand(b, hq, s)
    elif isinstance(rot, tuple):
        a, b2 = rot
        scores = qf @ a.float().transpose(1, 2) + qf @ b2.float().transpose(1, 2)
    else:
        scores = (qf @ rot.float().transpose(1, 2)) * scale
    nblk = s // BLOCK
    per = -(-nblk // nsplit)
    pad = nsplit * per - nblk
    sb = torch.nn.functional.pad(scores.reshape(b, hq, nblk, BLOCK), (0, 0, 0, pad))
    sb = sb.reshape(b, hq, nsplit, per, BLOCK).permute(0, 2, 3, 1, 4)  # (b, n, per, hq, 64)
    vb = torch.nn.functional.pad(v_us.float().reshape(b, nblk, BLOCK, rv), (0, 0, 0, 0, 0, pad))
    vb = vb.reshape(b, nsplit, per, BLOCK, rv)
    valid = (torch.arange(nsplit * per, device=q_emb.device) < nblk).reshape(nsplit, per)
    m_run = torch.full((b, nsplit, hq), -math.inf, device=q_emb.device)
    t = torch.zeros((b, nsplit, hq, rv), device=q_emb.device)
    for i in range(per):
        s_i, v_i = sb[:, :, i], vb[:, :, i]
        ok = valid[:, i][None, :, None]
        if "softmax" in stages:
            m_new = torch.maximum(m_run, s_i.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s_i - m_new[..., None])
        else:
            m_new, alpha, p = m_run, torch.ones_like(m_run), s_i
        if "vpath" in stages:
            t_new = t * alpha[..., None] + p.to(torch.bfloat16).float() @ v_i
        else:
            t_new = t * alpha[..., None] + p.sum(-1, keepdim=True) + v_i[:, :, None, 0]
        t = torch.where(ok[..., None], t_new, t)
        m_run = torch.where(ok, m_new, m_run)
    big_m = m_run.amax(1)
    w = torch.where(big_m[:, None] == -math.inf, torch.ones_like(m_run),
                    torch.exp(m_run - big_m[:, None]))
    out = (t * w[..., None]).sum(1)[..., :hd].to(torch.bfloat16)
    return out, big_m


def num_splits(b: int, s: int, device: torch.device) -> int:
    """The kernel's split count: one CTA per (split, sequence), enough to
    fill every SM once, at most one per 64-key block."""
    return _build.num_splits(s, b, 1, device)


def ablation_step(
    q_emb: torch.Tensor,
    k_us: torch.Tensor,
    k_vt: torch.Tensor,
    v_us: torch.Tensor,
    k_scale: torch.Tensor,
    cos_tab: torch.Tensor,
    sin_tab: torch.Tensor,
    trig: torch.Tensor,
    stages: Sequence[str],
    *,
    num_kv_heads: int,
    nsplit: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 for one stage set: (o (b, hq, hd) bf16, m (b, hq) fp32). On CUDA
    ``nsplit`` defaults to ``num_splits``; on the CPU to 1."""
    bits = stage_bits(stages)
    if k_us.device.type == "cpu":
        return ablation_step_plain(q_emb, k_us, k_vt, v_us, k_scale, cos_tab, sin_tab, trig,
                                   stages, num_kv_heads=num_kv_heads, nsplit=nsplit or 1)
    global launches
    b, hq, m = q_emb.shape
    s, rk = k_us.shape[1], k_us.shape[2]
    rv = v_us.shape[2]
    hd = m // num_kv_heads
    i8 = (torch.int8,)
    _build.require_cuda_tensor(q_emb, "q_emb", (torch.bfloat16,), 3)
    _build.require_cuda_tensor(k_us, "k_us", i8, 3)
    _build.require_cuda_tensor(k_vt, "k_vt", i8, 3)
    _build.require_cuda_tensor(v_us, "v_us", i8, 3)
    _build.require_cuda_tensor(k_scale, "k_scale", (torch.float32,), 3)
    _build.require_cuda_tensor(cos_tab, "cos_tab", (torch.bfloat16,), 2)
    _build.require_cuda_tensor(sin_tab, "sin_tab", (torch.bfloat16,), 2)
    _build.require_cuda_tensor(trig, "trig", (torch.float32,), 2)
    for name, x in (("q_emb", q_emb), ("k_us", k_us), ("k_vt", k_vt), ("v_us", v_us),
                    ("k_scale", k_scale), ("cos_tab", cos_tab), ("sin_tab", sin_tab),
                    ("trig", trig)):
        _build.require(x.is_contiguous(), f"{name} must be contiguous")
    tw = hd if full_width_tables(stages) else hd // 2
    _build.require(hd == 128 and m <= 1024, f"head_dim {hd} != 128 or hkv*hd {m} > 1024")
    _build.require(1 <= hq <= 32, f"hq {hq} not in [1, 32]")
    _build.require(s % BLOCK == 0 and s > 0, f"s {s} must be a positive multiple of {BLOCK}")
    _build.require(rk % 64 == 0 and 0 < rk <= 512 and hd <= rv <= 768 and rv % 16 == 0,
                   f"rk {rk} (a multiple of 64 up to 512, the k_us rows a block holds), rv "
                   f"{rv} (a multiple of 16 in [hd, 768], the value ranks two warpgroups hold)")
    _build.require("recon" in stages or m % rk == 0, "-recon tiles k_us: hkv*hd % rk == 0")
    _build.require(k_vt.shape == (b, rk, m) and v_us.shape[:2] == (b, s)
                   and k_scale.shape == (b, 1, m), "factor shapes")
    _build.require(cos_tab.shape == (s, tw) and sin_tab.shape == (s, tw)
                   and trig.shape == (2, hd), f"tables must be (s, {tw}), trig (2, hd)")
    dev = k_us.device
    nsplit = nsplit or num_splits(b, s, dev)
    kvt_t = torch.empty((b, m, rk), dtype=torch.int8, device=dev)  # k_vt, K-major
    part_t = torch.empty((b, nsplit, hq, hd), dtype=torch.float32, device=dev)
    part_m = torch.empty((b, nsplit, hq), dtype=torch.float32, device=dev)
    out = torch.empty((b, hq, hd), dtype=torch.bfloat16, device=dev)
    m_out = torch.empty((b, hq), dtype=torch.float32, device=dev)
    status = _build.load().xkv_ablation_step(
        q_emb.data_ptr(), k_us.data_ptr(), k_vt.data_ptr(), v_us.data_ptr(), k_scale.data_ptr(),
        cos_tab.data_ptr(), sin_tab.data_ptr(), trig.data_ptr(), kvt_t.data_ptr(),
        part_t.data_ptr(), part_m.data_ptr(), out.data_ptr(), m_out.data_ptr(), b, hq,
        num_kv_heads, hd, s, rk, rv, tw, hd ** -0.5, bits, nsplit, _build.stream_ptr(dev))
    _build.check(status, "ablation_step")
    launches += 1
    return out, m_out
