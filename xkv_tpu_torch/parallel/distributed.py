"""Multi-process runtime glue on ``torch.distributed``.

Port of ``xkv_tpu/parallel/distributed.py`` (the reference's torchrun
bootstrap, `evaluate/eval_acc.py:49-77`: env-derived rank / world size, a
process group, barrier + gather of objects):

  * ``init_distributed(backend)`` — joins the process group named by the
    torchrun variables ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
    ``MASTER_PORT`` (or the arguments), as the JAX version reads
    ``JAX_*``; a no-op in one process. The backend is explicit: ``gloo``
    (CPU tensors, and CUDA tensors for ``broadcast`` and ``all_reduce``:
    what two ranks sharing one card use, since NCCL refuses two ranks on
    one device) or ``nccl`` (one card a rank).
  * ``DistConfig`` — rank / world size / local devices.
  * ``barrier()`` / ``allgather_obj()`` — over the default group (the
    gather the Evaluator's summarize uses).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, List, Optional

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


@dataclass
class DistConfig:
    rank: int
    world_size: int
    local_devices: int
    coordinator: Optional[str] = None
    backend: Optional[str] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _local_devices() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(
    backend: str,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = 600.0,
) -> DistConfig:
    """Join (or describe) the process group.

    ``coordinator_address`` ("host:port") defaults to ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``num_processes`` to ``WORLD_SIZE``, ``process_id``
    to ``RANK``. One process (nothing configured, or a world of 1) starts
    no group. A group that is already up is described as it is."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if _group_up():
        return DistConfig(dist.get_rank(), dist.get_world_size(), _local_devices(),
                          coordinator_address, dist.get_backend())
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    n_proc = num_processes or int(os.environ.get("WORLD_SIZE", "0") or 0)
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0") or 0)
    if coordinator_address and n_proc > 1:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=n_proc, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
        return DistConfig(dist.get_rank(), dist.get_world_size(), _local_devices(),
                          coordinator_address, backend)
    return DistConfig(0, 1, _local_devices(), coordinator_address, None)


def barrier(name: str = "barrier") -> None:
    """Cross-process barrier (reference `evaluator.py:55,106`); ``name``
    is kept for the JAX signature."""
    if _group_up() and dist.get_world_size() > 1:
        dist.barrier()


def allgather_obj(obj: Any, max_bytes: int = 1 << 20) -> List[Any]:
    """All-gather a JSON-serializable object from every process, as the
    list by rank (reference's ``dist.gather_object``, `evaluator.py:115`).
    Each object makes the JSON round trip, as in the JAX version, and one
    past ``max_bytes`` encoded is refused."""
    if not _group_up() or dist.get_world_size() == 1:
        return [obj]
    blob = json.dumps(obj)
    if len(blob.encode()) > max_bytes:
        raise ValueError(f"object too large: {len(blob.encode())} > {max_bytes}")
    gathered: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, blob)
    return [json.loads(b) for b in gathered]
