"""Pipeline parallelism: the GPipe schedule over a stage group of ranks.

The port of ``repro.dist.pipeline``.  ``gpipe_reference`` is the
sequential oracle (the stage chain applied to every microbatch).
``gpipe_spmd`` runs the same computation with one stage a rank: at clock
tick ``t`` stage ``s`` processes microbatch ``t - s`` and sends its
activation to stage ``s + 1`` (point to point), the classic
``n_micro + S - 1``-tick schedule whose idle fraction is
``bubble_fraction``.  A stage whose tick falls in the bubble computes
nothing (JAX's SPMD stages compute on filler there and drop it).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.ckpt.checkpoint import tree_flatten, tree_unflatten
from repro_torch.launch.mesh import AXES


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """Idle fraction of the GPipe schedule: (S-1) / (n_micro + S - 1)."""
    if n_stages <= 1:
        return 0.0
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _stage(params, s: int):
    """Stage ``s``'s parameters: entry ``s`` of every leaf."""
    flat, _ = tree_flatten(params)
    return tree_unflatten(params, [a[s] for a in flat])


def gpipe_reference(stage_fn, params, x):
    """Sequential oracle.  params leaves are (S, ...); x is (n_micro, ...).

    Applies the S-stage chain to every microbatch.
    """
    S = tree_flatten(params)[0][0].shape[0]
    outs = []
    for micro in x:
        h = micro
        for s in range(S):
            h = stage_fn(_stage(params, s), h)
        outs.append(h)
    return torch.stack(outs)


def gpipe_spmd(stage_fn, params, x, mesh, axis=AXES):
    """GPipe over the ranks of ``axis`` of ``mesh`` (a ``launch.mesh.Mesh``;
    ``"data"``, ``"model"``, or both, the default: every rank a stage, in
    rank order), stage ``s`` the rank at index ``s``.

    params leaves: (S, ...), every stage's (each rank uses its own entry);
    x: (n_micro, mb, ...), the same on every rank (only stage 0 reads it).
    Returns the (n_micro, mb, ...) outputs of the last stage, broadcast to
    every rank of the axis.  Every rank of the axis must call it.  Over
    gloo the activations travel through the host (its point-to-point ops
    take CPU tensors)."""
    ax = mesh.axis(axis)
    S, sid = ax.size, ax.index
    n_micro = x.shape[0]
    p = _stage(params, sid)
    host = dist.get_backend(ax.group) == "gloo"
    buf = torch.empty_like(x[0], device="cpu" if host else x.device)
    outs = torch.zeros_like(x)
    for t in range(n_micro + S - 1):
        i = t - sid                                  # this stage's micro
        if not 0 <= i < n_micro:
            continue
        if sid == 0:
            inp = x[i]
        else:
            dist.recv(buf, src=ax.ranks[sid - 1], group=ax.group)
            inp = buf.to(x.device)
        out = stage_fn(p, inp)
        if sid == S - 1:
            outs[i] = out
        else:
            dist.send(out.to(buf.device).contiguous(), dst=ax.ranks[sid + 1],
                      group=ax.group)
    # only the last stage holds the outputs; it broadcasts them
    if host:
        outs = outs.cpu()
    dist.broadcast(outs, src=ax.ranks[S - 1], group=ax.group)
    return outs.to(x.device)
