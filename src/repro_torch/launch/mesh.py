"""The (data, model) mesh over ``torch.distributed``, for sharded serving
and training.

The port of ``repro.launch.mesh.make_local_mesh``.  A JAX mesh is one
process over many devices; here a mesh is one process per position.  Rank
``r`` sits at ``(r // model, r % model)``.  Ranks with the same data index
form the model group, ranks with the same model index the data group.
Serving runs every collective of its step over the model group (an integer
sum) and replicates everything along the data axis.  Training splits the
batch over the data group and the parameter blocks over both
(``dist/sharding.py``); ``Mesh.axis`` names the group, size and index of
either axis, or of both at once (the world), and the collectives below run
over any of them.

The caller starts the processes and initialises the default process group
itself (``init_process_group(backend, init_method=..., world_size=data *
model, rank=r, timeout=...)``): nothing here reads a cluster's
environment (``launch/train.py`` reads torchrun's).  A timeout there makes
a collective that one rank never joins fail instead of hanging; the
groups take the same timeout.  On one card two ranks share the device, and
NCCL refuses that: such ranks use gloo, which moves CUDA tensors through
the host.

``make_production_mesh`` describes JAX's production mesh, (16, 16) or
(2, 16, 16) with axes ``pod, data, model``, for the dry run: a
``MeshDesc`` needs no process group, and its collectives return tensors
of the right shape on the ``meta`` device and count the bytes of each
kind.  ``data_axes_for`` names a mesh's data axes, which act as one data
group.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
from typing import Any, Dict, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist


AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of a mesh, or several taken together, as this rank sees
    it: the process group over it (None: the default group), its size,
    this rank's index along it, and the global ranks of its positions in
    index order."""

    group: Any
    size: int
    index: int
    ranks: Tuple[int, ...]


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a (data, model) mesh and its two groups."""

    shape: Tuple[int, int]       # (data, model)
    rank: int
    data_index: int
    model_index: int
    model_group: Any             # None: the default group (data == 1)
    data_group: Any = None       # None: the default group (model == 1)

    axis_names = AXES
    data_axes = ("data",)

    @property
    def model_size(self) -> int:
        return self.shape[1]

    @property
    def data_size(self) -> int:
        return self.shape[0]

    def axis(self, name: Union[str, Sequence[str]]) -> MeshAxis:
        """``"data"``, ``"model"``, or a sequence of both (the world, its
        index the rank; the order given is the major-to-minor order, and
        only ``("data", "model")`` is the rank order)."""
        names = (name,) if isinstance(name, str) else tuple(name)
        data, model = self.shape
        d, m = self.data_index, self.model_index
        if names == ("model",):
            return MeshAxis(self.model_group, model, m,
                            tuple(d * model + j for j in range(model)))
        if names == ("data",):
            return MeshAxis(self.data_group, data, d,
                            tuple(i * model + m for i in range(data)))
        if names == AXES:
            return MeshAxis(None, data * model, self.rank,
                            tuple(range(data * model)))
        raise ValueError(f"unknown mesh axes {names!r} (expected 'data', "
                         "'model' or ('data', 'model'))")

    def all_reduce(self, t: torch.Tensor, axis="model",
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``t`` in place over ``axis`` (``op``: a ``ReduceOp``)."""
        dist.all_reduce(t, op=op, group=self.axis(axis).group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int,
                   axis="model") -> torch.Tensor:
        """The blocks of ``axis``'s ranks, each ``t``'s shape,
        concatenated along ``dim`` in index order (a new tensor)."""
        ax = self.axis(axis)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(ax.size)]
        dist.all_gather(parts, t, group=ax.group)
        return torch.cat(parts, dim=dim)

    def model_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over this rank's model group."""
        return self.all_reduce(t, "model")

    def barrier(self) -> None:
        """Wait until every rank of the world arrives here."""
        dist.barrier()

    def decide(self, flags: Sequence[bool], device) -> List[bool]:
        """Rank 0's ``flags`` on every rank (one broadcast over the
        world).  Host decisions that read a per-process clock go through
        here, so that every rank's scheduler takes the same one."""
        t = torch.tensor([bool(f) for f in flags], dtype=torch.uint8,
                         device=device)
        dist.broadcast(t, src=0)
        return [bool(f) for f in t.tolist()]


def local_device(device: str = "cuda") -> torch.device:
    """This process's device: ``cuda:(local_rank % device_count)`` for
    ``"cuda"`` (the local rank from torchrun's ``LOCAL_RANK``, else the
    global rank of the initialised group, else 0), the device as given
    otherwise.  Two ranks land on one card when there are fewer cards
    than local ranks."""
    if device != "cuda":
        return torch.device(device)
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
    elif dist.is_available() and dist.is_initialized():
        local = dist.get_rank()
    else:
        local = 0
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def join_from_env(device: str = "cuda", timeout=None) -> bool:
    """Join the default process group from torchrun's environment
    (``env://``) unless one is initialised or the environment has no
    ``WORLD_SIZE``: NCCL when each local rank has a card of its own (the
    rank's card then becomes the current one), gloo when ranks share one
    or with a ``device`` other than ``"cuda"``.  Returns whether it
    joined here (the caller destroys the group then)."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ["WORLD_SIZE"]))
    nccl = device == "cuda" and torch.cuda.device_count() >= local_world
    if nccl:
        torch.cuda.set_device(local_device(device))
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group("nccl" if nccl else "gloo",
                            init_method="env://", **kw)
    return True


def _world_timeout():
    """The default group's timeout (None: torch's default), for the
    data and model groups."""
    pg = dist.distributed_c10d._get_default_group()
    dev = torch.device("cuda" if dist.get_backend() == "nccl" else "cpu")
    try:
        return pg._get_backend(dev).options._timeout
    except (AttributeError, RuntimeError):
        return None


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """This process's position in a ``(data, model)`` mesh over the
    initialised default process group.

    Raises a clear error when no process group is initialised or when its
    world size is not ``data * model``; nothing falls back to a single
    device.  Every rank must call it, in the same order (the groups are
    created collectively: the model groups when ``data > 1``, then the data
    groups when ``model > 1``; an axis of the whole world runs over the
    default group)."""
    need = data * model
    if data < 1 or model < 1:
        raise ValueError(f"mesh shape ({data}, {model}) must be positive")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"mesh shape ({data}, {model}) needs a torch.distributed process "
            f"group of {need} ranks, one process per mesh position: call "
            "torch.distributed.init_process_group(backend, init_method="
            "'tcp://localhost:<port>' or 'file://<path>', world_size="
            f"{need}, rank=<this process's rank>, timeout=...) in each "
            "process first")
    have = dist.get_world_size()
    if have != need:
        raise ValueError(
            f"mesh shape ({data}, {model}) needs {need} ranks but the "
            f"process group has world size {have}: start data * model "
            "processes, one per mesh position")
    rank = dist.get_rank()
    d, m = divmod(rank, model)
    model_group = data_group = None
    timeout = _world_timeout() if data > 1 or model > 1 else None
    if data > 1:
        groups = [dist.new_group(list(range(g * model, (g + 1) * model)),
                                 timeout=timeout) for g in range(data)]
        model_group = groups[d]
    if model > 1:
        groups = [dist.new_group(list(range(j, data * model, model)),
                                 timeout=timeout) for j in range(model)]
        data_group = groups[m]
    return Mesh(shape=(data, model), rank=rank, data_index=d,
                model_index=m, model_group=model_group,
                data_group=data_group)


class MeshDesc:
    """One rank's place in a mesh of any axes, without a process group:
    the dry run's stand-in for a ``Mesh`` (``make_production_mesh``).

    ``sizes`` maps the axis names, major to minor, to their sizes; rank
    ``r`` sits at the mixed-radix digits of ``r``.  The data axes
    (``data_axes_for``) act as one data group (``data_size``,
    ``data_index``), as JAX's specs name them together.  The
    collectives take ``meta`` tensors only: they return a tensor of the
    result's shape and add the bytes this rank hands over to ``traffic``
    by kind (an all-reduce or an all-gather its whole input)."""

    def __init__(self, sizes: Dict[str, int], rank: int = 0):
        self.sizes = dict(sizes)
        self.axis_names = tuple(self.sizes)
        self.data_axes = data_axes_for(self)
        n = math.prod(self.sizes.values())
        if not 0 <= rank < n:
            raise ValueError(f"rank {rank} outside a mesh of {n}")
        self.rank = rank
        self.coords, r = {}, rank
        for a in reversed(self.axis_names):
            r, self.coords[a] = divmod(r, self.sizes[a])
        self.traffic = collections.Counter()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.sizes)

    def axis(self, name: Union[str, Sequence[str]]) -> MeshAxis:
        """The axes ``name`` taken together, in the mesh's order (the
        ranks are not listed: a description holds no group)."""
        names = (name,) if isinstance(name, str) else tuple(name)
        if not set(names) <= set(self.axis_names):
            raise ValueError(f"unknown mesh axes {names!r} (the mesh has "
                             f"{self.axis_names})")
        size, index = 1, 0
        for a in self.axis_names:
            if a in names:
                size *= self.sizes[a]
                index = index * self.sizes[a] + self.coords[a]
        return MeshAxis(None, size, index, ())

    @property
    def data_size(self) -> int:
        return self.axis(self.data_axes).size

    @property
    def data_index(self) -> int:
        return self.axis(self.data_axes).index

    @property
    def model_size(self) -> int:
        return self.sizes.get("model", 1)

    @property
    def model_index(self) -> int:
        return self.coords.get("model", 0)

    @staticmethod
    def _meta(t: torch.Tensor) -> None:
        if t.device.type != "meta":
            raise ValueError("a mesh description moves meta tensors only, "
                             f"got one on {t.device}")

    def all_reduce(self, t: torch.Tensor, axis="model",
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        self._meta(t)
        if self.axis(axis).size > 1:
            self.traffic["all_reduce"] += t.numel() * t.element_size()
        return t

    def all_gather(self, t: torch.Tensor, dim: int,
                   axis="model") -> torch.Tensor:
        self._meta(t)
        n = self.axis(axis).size
        if n > 1:
            self.traffic["all_gather"] += t.numel() * t.element_size()
        shape = list(t.shape)
        shape[dim] *= n
        return torch.empty(shape, dtype=t.dtype, device=t.device)


def make_production_mesh(*, multi_pod: bool = False) -> MeshDesc:
    """JAX's production mesh as its rank 0 sees it: (16, 16) with axes
    ``data, model``, or (2, 16, 16) with ``pod, data, model``."""
    sizes = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    return MeshDesc(sizes)


def data_axes_for(mesh) -> tuple:
    """The mesh's data axes (``pod`` and ``data``), in its order."""
    return tuple(a for a in getattr(mesh, "axis_names", AXES)
                 if a in ("pod", "data"))


__all__ = ["AXES", "Mesh", "MeshAxis", "MeshDesc", "data_axes_for",
           "join_from_env", "local_device", "make_local_mesh",
           "make_production_mesh"]
