"""Build, load and launch helpers for the port's CUDA kernels.

The kernels live in ``xkv_tpu_torch/csrc/*.cu`` and expose plain C entry
points. At first use, ``load()`` compiles every source with its own
``nvcc`` process (all started together) for ``sm_90a``, links them into
one shared library under ``build/kernels/<source hash>/`` at the root of
the checkout (a directory git ignores), and loads it with ``ctypes``. A
later process with the same sources reuses the library.

Nothing here runs at import time, and nothing here falls back: a missing
compiler, a failed build or a non-zero CUDA status raises.

Each wrapper adds one to its kernel's launch counter (``COUNTERS``) where
it launches the kernel. Under CUDA-graph capture a launch is recorded, not
run: ``capture_counts`` takes the capture's counts back out, and
``add_counts`` adds them once per replay, so the counters count the
launches the device runs.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import importlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
LIB_NAME = "libxkv_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points (all return cudaError_t as int).
SIGNATURES = {
    "xkv_flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "xkv_rankspace_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _P],
    "xkv_lowrank_decode": [_P, _P, _P, _L, _L, _P, _P, _L, _L, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "xkv_sparse_rankspace_decode": [_P] * 11 + [_I] * 9 + [_P],
    "xkv_mixed_rankspace_decode": [_P] * 12 + [_I] * 8 + [_P],
    "xkv_sparse_lowrank_decode": [_P, _P, _P, _L, _L, _P, _P, _L, _L] + [_P] * 13
                                 + [_I] * 12 + [_P],
    "xkv_lowrank_streams_kvt": [_I, _I, _I],
    "xkv_mla_rankspace_decode": [_P] * 13 + [_I] * 11 + [_P],
    "xkv_probe_gemm_chain": [_P, _P, _P, _I, _I, _I, _I, _P],
    "xkv_ablation_step": [_P] * 13 + [_I] * 8 + [_F, _I, _I, _P],
    "xkv_variant_decode": [_P, _P, _P, _L, _L, _P, _P, _L, _L] + [_P] * 12 + [_I] * 12 + [_P],
}


# Launch counters: (module of ``ops/kernels``, attribute) per kernel.
COUNTERS = {"K1": ("flash_attention", "launches"), "K2": ("rankspace_attention", "launches"),
            "K3": ("lowrank_attention", "launches"),
            "K4": ("rankspace_attention", "sparse_launches"),
            "K5": ("lowrank_attention", "sparse_launches"),
            "K6": ("rankspace_attention", "mixed_launches"),
            "K7": ("rankspace_attention", "mla_launches"),
            "K8": ("rankspace_attention", "mla_mixed_launches"),
            "K9": ("kernel_variants", "launches"), "K10": ("kernel_ablation", "launches"),
            "K11": ("probe_int4", "launches")}


def _counter_module(name: str):
    return importlib.import_module(f"xkv_tpu_torch.ops.kernels.{name}")


def read_counts() -> Dict[str, int]:
    return {key: getattr(_counter_module(mod), attr) for key, (mod, attr) in COUNTERS.items()}


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(_counter_module(mod), attr, 0)


def add_counts(delta: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counters (a graph's launches, once
    per replay)."""
    for key, n in delta.items():
        mod, attr = COUNTERS[key]
        m = _counter_module(mod)
        setattr(m, attr, getattr(m, attr) + times * n)


@contextlib.contextmanager
def capture_counts() -> Iterator[Dict[str, int]]:
    """Around a CUDA-graph capture: the launches the wrappers count inside
    the block are taken back out of the counters (capture runs nothing on
    the device) and left in the yielded dict, for ``add_counts`` to add
    once per replay."""
    before = read_counts()
    delta: Dict[str, int] = {}
    try:
        yield delta
    finally:
        after = read_counts()
        delta.update({key: after[key] - before[key] for key in before})
        add_counts(delta, -1)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernel library if it is not built yet; return
    its path. The compiler's resource report (registers, shared memory,
    spills) is kept beside it in ``build.log``."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus, _ = _sources()
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        procs = []
        for src in cus:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                "-o", str(tmp / LIB_NAME), *[str(o) for _, o, _ in procs]]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{res.stdout}")
        (tmp / "build.log").write_text("\n".join(log))
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not lib.exists():  # another process did not win the race either
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def require_no_grad(t: torch.Tensor, name: str) -> None:
    """Refuse a kernel operand that autograd would differentiate: no kernel
    has a backward, and its output, written through a raw pointer, would
    carry no gradient, so a loss through it would train nothing and say
    nothing."""
    require(not (t.requires_grad and torch.is_grad_enabled()),
            f"{name} requires grad: the CUDA kernels have no backward; differentiate "
            "through the plain route (ops.attention.plain_prefill_attention, as "
            "train.lm does) or call under torch.no_grad()")


def require_cuda_tensor(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """Check a kernel operand: on CUDA, of an accepted dtype and rank, with a
    unit last stride and a 16-byte-aligned start, and not differentiated
    (``require_no_grad``)."""
    require(t.is_cuda, f"{name} must be a CUDA tensor")
    require_no_grad(t, name)
    require(t.dtype in dtypes, f"{name} dtype {t.dtype} not in {dtypes}")
    require(t.dim() == ndim, f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    require(t.stride(-1) == 1, f"{name} must have a unit last stride")
    require(t.data_ptr() % 16 == 0, f"{name} must start 16-byte aligned")


def live_range(
    b: int,
    s_p: int,
    lengths: Optional[torch.Tensor],
    win_lo: Optional[torch.Tensor],
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(valid_len, window_lo) int32 tensors of shape (b,) on ``device``;
    live key columns are [window_lo, valid_len)."""
    if lengths is None:
        lens = torch.full((b,), s_p, dtype=torch.int32, device=device)
    else:
        lens = lengths.reshape(b).to(device=device, dtype=torch.int32).contiguous()
    if win_lo is None:
        los = torch.zeros((b,), dtype=torch.int32, device=device)
    else:
        los = win_lo.reshape(b).to(device=device, dtype=torch.int32).contiguous()
    return lens, los


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def num_splits(s_p: int, ctas_per_split: int, ctas_per_sm: int, device: torch.device) -> int:
    """Splits of the key axis for a flash-decoding launch: enough CTAs to
    fill every SM ``ctas_per_sm`` deep, at most one per 64-key block."""
    n_sm = sm_count(device)
    blocks = -(-s_p // 64)
    return max(1, min(blocks, (n_sm * ctas_per_sm) // max(ctas_per_split, 1)))
