"""The (data, model) layout of the ranks.

Port of ``xkv_tpu/parallel/mesh.py``. Axes:
  data  — data parallelism: batch / eval-sample / slot sharding, or, under
          sequence parallelism, the prompt's rows at prefill;
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
``gather_rows`` and ``broadcast_tensors(axis="data")``, and along either
axis ``shift`` (the JAX ``ppermute`` to the next rank of a ring: the ring
attention's K/V blocks, the pipeline's activations). ``make_mesh`` builds
every group of the world on every rank, in the same order
(``dist.new_group`` must be called so, even for groups a rank is not in).

What the data axis carries is the caller's: the batch rows of an
``InferenceEngine``, the slots of a ``BatchedEngine``, the prompt's rows
of a sequence-parallel prefill, after which every data row holds the same
rows (``replicas``: ``rows`` and ``gather_rows`` are the identity, and a
build's factors come from the mesh's first rank, ``engine/compression.py``).

The gloo backend (what ranks sharing one card use) takes CUDA tensors for
``broadcast`` and ``all_reduce`` only, so the gathers are ``all_reduce``
sums over zero-filled wholes and the max is an ``all_reduce`` with
``ReduceOp.MAX``, which gloo runs on a CUDA tensor through a host copy, as
it runs the sum. Its ``send`` / ``recv`` take CPU tensors only: ``shift``
moves each block through a host copy (pinned for a CUDA tensor), with
``isend`` / ``irecv`` posted on both sides before either waits, so a ring
of sends cannot deadlock. A shift moves each block once, to one rank; an
``all_reduce`` over a zero-filled whole would move n blocks to every rank.
A transfer that fails raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
    # Every data row holds the same rows (after a sequence-parallel
    # prefill): ``rows`` / ``gather_rows`` are the identity.
    replicas: bool = False

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
                          device: torch.device, axis: str = MODEL_AXIS) -> Dict[str, torch.Tensor]:
        """The first rank's {name: tensor} on every rank of this rank's
        group along ``axis`` (the model group, or with ``axis="data"`` the
        data group; ``tensors`` is read on that first rank only): the
        names, shapes and dtypes first, then each tensor, received into
        new tensors on ``device``."""
        n, group = ((self.model, self.group) if axis == MODEL_AXIS
                    else (self.data, self.data_group))
        if n == 1:
            return dict(tensors)
        src = self.model_src if axis == MODEL_AXIS else self.model_rank
        meta = [None if self.rank != src else
                [(k, tuple(t.shape), t.dtype) for k, t in tensors.items()]]
        dist.broadcast_object_list(meta, src=src, group=group)
        out = {}
        for name, shape, dtype in meta[0]:
            t = (tensors[name].contiguous() if self.rank == src
                 else torch.empty(shape, dtype=dtype, device=device))
            dist.broadcast(t, src=src, group=group)
            out[name] = t
        return out

    # ------------------------------------------------------ point-to-point
    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's ring along ``axis``, in order."""
        if axis == MODEL_AXIS:
            return [self.model_src + m for m in range(self.model)]
        if axis == DATA_AXIS:
            return [d * self.model + self.model_rank for d in range(self.data)]
        raise ValueError(f"unknown mesh axis {axis!r}")

    def shift(self, tensors: Sequence[torch.Tensor], axis: str = DATA_AXIS
              ) -> List[torch.Tensor]:
        """The JAX ``ppermute`` with perm ``(j, j + 1 mod n)`` along
        ``axis``: each tensor sent to the axis's next rank, and the previous
        rank's received in its place (same shapes and dtypes, on the same
        device). An axis of 1 returns the tensors."""
        ranks = self.axis_ranks(axis)
        n = len(ranks)
        if n == 1:
            return list(tensors)
        i = ranks.index(self.rank)
        return exchange([(t, ranks[(i + 1) % n]) for t in tensors],
                        [(t, ranks[(i - 1) % n]) for t in tensors])

    # -------------------------------------------------- data-axis collectives
    def rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This data rank's block of ``x``'s rows along ``dim`` (a view;
        all of them on ``replicas``)."""
        if self.data == 1 or self.replicas:
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
        whole, as ``gather``. On ``replicas``, ``x`` itself."""
        if self.data == 1 or self.replicas:
            return x
        return self.join_rows(x, dim)

    def join_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every data rank's ``x`` joined along ``dim`` in data-rank order,
        whatever the data axis carries (a sequence-parallel prefill's rows
        of the prompt)."""
        if self.data == 1:
            return x
        x = x.movedim(dim, 0)
        full = torch.zeros(self.data, *x.shape, dtype=x.dtype, device=x.device)
        full[self.data_rank] = x
        dist.all_reduce(full, group=self.data_group)
        return full.reshape(self.data * x.shape[0], *x.shape[1:]).movedim(0, dim)


def _host(x: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy of ``x`` (pinned for a CUDA tensor), or ``x``."""
    if x.device.type == "cpu":
        return x.contiguous()
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]]) -> List[torch.Tensor]:
    """Point-to-point over the default group: every ``(tensor, peer)`` of
    ``sends`` sent to global rank ``peer``, and for every ``(like, peer)``
    of ``recvs`` a tensor of ``like``'s shape, dtype and device received
    from ``peer``. Every send and receive is posted (``isend`` /
    ``irecv``, tagged by its place in its list, so two tensors between the
    same pair cannot cross) before any is waited for, so ranks that all
    send first do not wait on one another. Through host copies, as gloo
    takes CPU tensors only; a transfer that fails raises."""
    out = [torch.empty(like.shape, dtype=like.dtype,
                       pin_memory=like.device.type == "cuda") for like, _ in recvs]
    staged = [_host(t) for t, _ in sends]
    works = [dist.isend(h, dst=peer, tag=i) for i, (h, (_, peer)) in enumerate(zip(staged, sends))]
    works += [dist.irecv(h, src=peer, tag=i) for i, (h, (_, peer)) in enumerate(zip(out, recvs))]
    for w in works:
        w.wait()
    return [h.to(like.device, non_blocking=True) if like.device.type != "cpu" else h
            for h, (like, _) in zip(out, recvs)]


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
