"""K11: tensor-core rate probe (``csrc/probe_int4.cu``).

Port of ``scripts/probe_int4.py`` ``build`` (Pallas body ``_kernel``):
``reps`` dependent products ``y_i = x_i @ w`` with ``x_{i+1} = y_i & 7``
(int8, int4; int32 accumulator) or ``bf16(y_i * 1e-3)`` (bf16; fp32
accumulator), returning ``sum_i y_i`` as fp32. ``x`` is (M, K) and ``w``
(K, K): at M = K this is the TPU probe's function, and a larger M only adds
independent rows. ``gemm_chain`` launches the CUDA kernel for CUDA tensors
and runs ``gemm_chain_plain`` for CPU tensors.

int4 operands are int8 tensors holding values in [-8, 7]; the wrapper packs
them two to a byte for the kernel's s4 tensor-core products. The kernel
runs a cluster of CTAs per 64-row tile of x, each keeping its column slice
of w resident and exchanging x.
"""

from __future__ import annotations

import torch

from xkv_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernel since the last reset (plain runs not counted).
launches = 0

KINDS = {"bf16": 0, "int8": 1, "int4": 2}


def gemm_chain_plain(x: torch.Tensor, w: torch.Tensor, reps: int, kind: str) -> torch.Tensor:
    """The probe's function in plain tensor code. Integer products are
    taken in fp32, exact here: every partial sum is an integer below 2^24
    (|x|, |w| <= 8, K <= 512)."""
    if kind == "bf16":
        total = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
        for _ in range(reps):
            y = x.float() @ w.float()
            total += y
            x = (y * 1e-3).to(torch.bfloat16)
        return total
    total = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int32, device=x.device)
    wf = w.float()
    for _ in range(reps):
        y = (x.float() @ wf).to(torch.int32)
        total += y
        x = (y & 7).to(torch.int8)
    return total.float()


def pack_int4(x: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 in [-8, 7] -> (..., K/2) uint8, element 2i in the low
    nibble of byte i."""
    lo = x[..., 0::2].to(torch.int32) & 0xF
    hi = x[..., 1::2].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8).contiguous()


def gemm_chain(x: torch.Tensor, w: torch.Tensor, reps: int, kind: str) -> torch.Tensor:
    """K11: (M, K) fp32 sum of ``reps`` chained products (see module)."""
    _build.require(kind in KINDS, f"kind {kind!r} not in {tuple(KINDS)}")
    if x.device.type == "cpu":
        return gemm_chain_plain(x, w, reps, kind)
    global launches
    dt = (torch.bfloat16 if kind == "bf16" else torch.int8,)
    _build.require_cuda_tensor(x, "x", dt, 2)
    _build.require_cuda_tensor(w, "w", dt, 2)
    m, k = x.shape
    _build.require(w.shape == (k, k), f"w must be (K, K) = ({k}, {k}), got {tuple(w.shape)}")
    _build.require(k in (128, 256, 512), f"K {k} not in (128, 256, 512)")
    _build.require(reps >= 1 and m >= 1, "reps and M must be positive")
    wt = w.t().contiguous()
    x = x.contiguous()
    if kind == "int4":
        for name, t in (("x", x), ("w", w)):
            torch._assert_async(((t >= -8) & (t <= 7)).all(), f"int4 {name} outside [-8, 7]")
        x, wt = pack_int4(x), pack_int4(wt)
    out = torch.empty((m, k), dtype=torch.float32, device=x.device)
    status = _build.load().xkv_probe_gemm_chain(
        x.data_ptr(), wt.data_ptr(), out.data_ptr(), m, k, reps, KINDS[kind],
        _build.stream_ptr(x.device))
    _build.check(status, "gemm_chain")
    launches += 1
    return out
