"""The (data, model) layout of the ranks.

Port of ``xkv_tpu/parallel/mesh.py``. Axes:
  data  — data parallelism: batch / eval-sample sharding;
  model — tensor parallelism: attention heads / MLP features.

The JAX mesh is a grid of devices that GSPMD partitions over; the port's
is a grid of ranks of the ``torch.distributed`` process group, one process
each: ``Mesh`` holds the layout, this rank's coordinates and the model
axis's group, and the model axis's collectives (``all_reduce``,
``gather``, ``broadcast_tensors``) that tensor parallelism
(``sharding``, the engine under a mesh) runs. The data axis must be 1 in
this port: a data axis under a mesh is ROADMAP item 17.

Rank r sits at (r // model, r % model). With data 1 the model group is
the whole default group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    data: int
    model: int
    rank: int  # this process's rank in the default group

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def model_rank(self) -> int:
        """This rank's coordinate on the model axis."""
        return self.rank % self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def group(self):
        """The model axis's process group (None in a one-rank mesh)."""
        return None if self.model == 1 else dist.group.WORLD

    # ------------------------------------------------- model-axis collectives
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the model axis, in ``x``'s dtype and in its
        place (the caller passes fp32 partial products)."""
        if self.model > 1:
            dist.all_reduce(x, group=self.group)
        return x

    def gather(self, x: torch.Tensor, dim: int = -1, blocks: int = 1) -> torch.Tensor:
        """Every model rank's ``x`` joined along ``dim``: its ``blocks`` equal
        blocks each in rank order, so (..., blocks * w) of rank r becomes
        (..., blocks * model * w) with rank r's block i at [(i * model + r)
        * w, (i * model + r + 1) * w). gloo gathers no CUDA tensor, so it is
        an ``all_reduce`` over a zero-filled whole (adding zeros is exact
        in every dtype)."""
        if self.model == 1:
            return x
        if dim not in (-1, x.dim() - 1):
            return self.gather(x.movedim(dim, -1), -1, blocks).movedim(-1, dim)
        w = x.shape[-1] // blocks
        full = torch.zeros(*x.shape[:-1], blocks, self.model, w, dtype=x.dtype,
                           device=x.device)
        full[..., :, self.model_rank, :] = x.reshape(*x.shape[:-1], blocks, w)
        dist.all_reduce(full, group=self.group)
        return full.reshape(*x.shape[:-1], blocks * self.model * w)

    def broadcast_tensors(self, tensors: Optional[Dict[str, torch.Tensor]],
                          device: torch.device, src: int = 0) -> Dict[str, torch.Tensor]:
        """Rank ``src``'s {name: tensor} on every rank of the model axis
        (``tensors`` is read on ``src`` only): the names, shapes and dtypes
        first, then each tensor, received into new tensors on ``device``."""
        if self.model == 1:
            return dict(tensors)
        meta = [None if self.rank != src else
                [(k, tuple(t.shape), t.dtype) for k, t in tensors.items()]]
        dist.broadcast_object_list(meta, src=src, group=self.group)
        out = {}
        for name, shape, dtype in meta[0]:
            t = (tensors[name].contiguous() if self.rank == src
                 else torch.empty(shape, dtype=dtype, device=device))
            dist.broadcast(t, src=src, group=self.group)
            out[name] = t
        return out


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The (data, model) mesh over the default process group (one process:
    a world of 1). ``data=None`` takes the ranks the model axis leaves."""
    n, rank = _world()
    if data is None:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    if data != 1:
        raise ValueError(
            f"a data axis of {data}: data parallelism under a mesh is not ported yet "
            "(ROADMAP item 17); use data=1")
    return Mesh(data=data, model=model, rank=rank)


def single_device_mesh() -> Mesh:
    """A 1 x 1 mesh of this rank alone."""
    return Mesh(data=1, model=1, rank=_world()[1])
