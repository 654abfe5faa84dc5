"""Profiling helpers (port of ``xkv_tpu/utils/profiling.py``).

  * ``trace(log_dir)`` — context manager around ``torch.profiler`` that
    writes a Chrome trace into ``log_dir`` (the CUDA activity too where a
    card is present).
  * ``device_op_times(trace_dir)`` — the device operations of the newest
    trace in ``trace_dir`` summed by name, in ms, largest first (the JAX
    reader sums the ``"X"`` events of the TPU process of a
    ``jax.profiler`` trace). ``profile_op_times(prof)`` is the same total
    from a finished ``torch.profiler.profile`` object; both sum through
    ``op_totals``. A device operation is a kernel, a memcpy or a memset
    (trace categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``; the
    profiler's events on the CUDA device type).
  * ``peak_memory_bytes(device)`` — the allocator's high-water mark,
    ``torch.cuda.max_memory_allocated``, on a CUDA device; ``None`` on the
    CPU, which keeps no allocator statistics (the reference's per-sample
    display, `evaluate/evaluator.py:79-80`).
  * ``PhaseTimer`` — wall-clock phase accounting with a JSON summary; a
    phase given a ``result`` waits for the device that holds it.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch

# Trace categories of the device's operations in a torch Chrome trace.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU ops, and the CUDA
    activity when a card is present) and write its Chrome trace to
    ``log_dir/<pid>.<ns>.pt.trace.json``; yields the profile object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def op_totals(events: Iterable[Tuple[str, float]]) -> Dict[str, float]:
    """(name, microseconds) pairs summed by name, in ms, largest first."""
    totals: Dict[str, float] = defaultdict(float)
    for name, dur_us in events:
        totals[name] += dur_us / 1e3
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))


def kernel_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of every device operation of a finished
    ``torch.profiler.profile``, in start order."""
    from torch.autograd import DeviceType

    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA), key=lambda e: e[1])


def profile_op_times(prof) -> Dict[str, float]:
    """``device_op_times`` of a finished ``torch.profiler.profile``."""
    return op_totals((name, end - start) for name, start, end in kernel_events(prof))


def device_op_times(trace_dir: str) -> Dict[str, float]:
    """Device-operation durations (ms) summed by name from the newest
    Chrome trace (``*.pt.trace.json``, or ``.gz``) under ``trace_dir``."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.pt.trace.json*")),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace files under {trace_dir}")
    opener = gzip.open if paths[-1].endswith(".gz") else open
    with opener(paths[-1], "rt") as f:
        events = json.load(f).get("traceEvents", [])
    return op_totals((e["name"], e.get("dur", 0)) for e in events
                     if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)


def peak_memory_bytes(device=None) -> Optional[int]:
    """Peak allocated device memory in bytes over the process's life, or
    None on a device without allocator statistics (the CPU). ``device``
    defaults to the current CUDA device when there is one."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for item in tree:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        """Time the block; with ``result`` (a tensor or a tree of them),
        first wait for the device that holds its first tensor."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t = _first_tensor(result) if result is not None else None
            if t is not None and t.is_cuda:
                torch.cuda.synchronize(t.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def mark(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
