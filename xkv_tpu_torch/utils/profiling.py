"""Profiling helpers of the evaluation path.

The port's counterparts of ``xkv_tpu/utils/profiling.py``'s
``peak_memory_bytes`` and ``PhaseTimer``:

  * ``peak_memory_bytes(device)`` — the allocator's high-water mark,
    ``torch.cuda.max_memory_allocated``, on a CUDA device; ``None`` on the
    CPU, which keeps no allocator statistics (the reference's per-sample
    display, `evaluate/evaluator.py:79-80`).
  * ``PhaseTimer`` — wall-clock phase accounting with a JSON summary; a
    phase given a ``result`` waits for the device that holds it.

The JAX package's ``trace`` and ``device_op_times`` read JAX profiler
traces; the port times its kernels with ``torch.profiler`` and CUDA events
(``chip_smoke.py``, ``scripts/timing.py``).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


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
