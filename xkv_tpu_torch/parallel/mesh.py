"""The (data, model) layout of the ranks.

Port of ``xkv_tpu/parallel/mesh.py``. Axes:
  data  — data parallelism: batch / eval-sample sharding;
  model — tensor parallelism: attention heads / MLP features / experts.

The JAX mesh is a grid of devices that GSPMD partitions over; the port's
is a grid of ranks of the ``torch.distributed`` process group, one process
each. Rank r sits at (r // model, r % model): the ranks of one data row
form a model group (tensor parallelism runs inside it), the ranks of one
model column a data group (each holds its share of the batch rows, JAX
``token_pspec``). ``Mesh`` holds the layout, this rank's coordinates and
its two groups, and the collectives the engine under a mesh runs: over
the model group ``all_reduce``, ``all_max``, ``gather`` and
``broadcast_tensors`` (from the group's first rank), over the data group
``gather_rows``. ``make_mesh`` builds every group of the world on every
rank, in the same order (``dist.new_group`` must be called so, even for
groups a rank is not in).

The gloo backend (what ranks sharing one card use) takes CUDA tensors for
``broadcast`` and ``all_reduce`` only, so the gathers are ``all_reduce``
sums over zero-filled wholes and the max is an ``all_reduce`` with
``ReduceOp.MAX``, which gloo runs on a CUDA tensor through a host copy, as
it runs the sum.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    data: int
    model: int
    rank: int  # this process's rank in the default group
    # The process groups of this rank's data row (its model group) and of
    # its model column (its data group); built by ``make_mesh``. A mesh
    # made by hand, with no group, serves one data row over the default
    # group, or no collective at all.
    model_group: Any = field(default=None, compare=False, repr=False)
    data_group: Any = field(default=None, compare=False, repr=False)

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
        """The model axis's process group (None when the axis is 1)."""
        if self.model == 1:
            return None
        if self.model_group is not None:
            return self.model_group
        if self.data != 1:
            raise ValueError("a mesh with a data axis needs its groups: build it with make_mesh")
        return dist.group.WORLD

    @property
    def model_src(self) -> int:
        """The global rank of this model group's first rank."""
        return self.data_rank * self.model

    # ------------------------------------------------- model-axis collectives
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the model axis, in ``x``'s dtype and in its
        place (the caller passes fp32 partial products)."""
        if self.model > 1:
            dist.all_reduce(x, group=self.group)
        return x

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``x`` over the model axis, in place."""
        if self.model > 1:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
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
                          device: torch.device) -> Dict[str, torch.Tensor]:
        """The model group's first rank's {name: tensor} on every rank of
        the group (``tensors`` is read there only): the names, shapes and
        dtypes first, then each tensor, received into new tensors on
        ``device``."""
        if self.model == 1:
            return dict(tensors)
        src = self.model_src
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

    # -------------------------------------------------- data-axis collectives
    def rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This data rank's block of ``x``'s rows along ``dim`` (a view)."""
        if self.data == 1:
            return x
        n = x.shape[dim]
        if n % self.data:
            raise ValueError(
                f"a batch of {n} rows does not split over a data axis of {self.data} "
                "(the JAX engine's token sharding needs the batch divisible by it)")
        w = n // self.data
        return x.narrow(dim, self.data_rank * w, w)

    def gather_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every data rank's rows of ``x`` joined along ``dim`` in data-rank
        order (``rows`` inverted): an ``all_reduce`` over a zero-filled
        whole, as ``gather``."""
        if self.data == 1:
            return x
        x = x.movedim(dim, 0)
        full = torch.zeros(self.data, *x.shape, dtype=x.dtype, device=x.device)
        full[self.data_rank] = x
        dist.all_reduce(full, group=self.data_group)
        return full.reshape(self.data * x.shape[0], *x.shape[1:]).movedim(0, dim)


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The (data, model) mesh over the default process group (one process:
    a world of 1). ``data=None`` takes the ranks the model axis leaves.
    With more than one rank every rank must call it, at the same point:
    it builds every data row's and model column's group."""
    n, rank = _world()
    if data is None:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    if n == 1:
        return Mesh(data=1, model=1, rank=rank)
    model_group = data_group = None
    # Every rank creates every group, model rows first, in the same order.
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if d == rank // model:
            model_group = g
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if m == rank % model:
            data_group = g
    return Mesh(data=data, model=model, rank=rank, model_group=model_group,
                data_group=data_group)


def single_device_mesh() -> Mesh:
    """A 1 x 1 mesh of this rank alone."""
    return Mesh(data=1, model=1, rank=_world()[1])
