"""The (data, model) mesh of sharded serving over ``torch.distributed``.

The port of ``repro.launch.mesh.make_local_mesh``.  A JAX mesh is one
process over many devices; here a mesh is one process per position, each
holding a replica of the weights and of the host engine.  Ranks ``(d, m)``
with the same ``d`` form the model-axis group, over which every collective
of the serving step runs (an integer sum); the data axis replicates
everything.  Rank ``r`` sits at ``(r // model, r % model)``.

The caller starts the processes and initialises the default process group
itself (``init_process_group(backend, init_method=..., world_size=data *
model, rank=r, timeout=...)``): nothing here reads a cluster's
environment.  A timeout there makes a collective that one rank never joins
fail instead of hanging; the model groups take the same timeout.
``make_production_mesh`` is ROADMAP P18's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a (data, model) mesh and its model group."""

    shape: Tuple[int, int]       # (data, model)
    rank: int
    data_index: int
    model_index: int
    model_group: Any             # None: the default group (data == 1)

    @property
    def model_size(self) -> int:
        return self.shape[1]

    def model_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over this rank's model group."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.model_group)
        return t

    def decide(self, flags: Sequence[bool], device) -> List[bool]:
        """Rank 0's ``flags`` on every rank (one broadcast over the
        world).  Host decisions that read a per-process clock go through
        here, so that every rank's scheduler takes the same one."""
        t = torch.tensor([bool(f) for f in flags], dtype=torch.uint8,
                         device=device)
        dist.broadcast(t, src=0)
        return [bool(f) for f in t.tolist()]


def _world_timeout():
    """The default group's timeout (None: torch's default), for the
    model groups."""
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
    device.  Every rank must call it, in the same order (the model groups
    are created collectively)."""
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
    group = None
    if data > 1:
        timeout = _world_timeout()
        groups = [dist.new_group(list(range(g * model, (g + 1) * model)),
                                 timeout=timeout) for g in range(data)]
        group = groups[d]
    return Mesh(shape=(data, model), rank=rank, data_index=d,
                model_index=m, model_group=group)


__all__ = ["Mesh", "make_local_mesh"]
