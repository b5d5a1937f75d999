"""Optimizers: AdamW and Adafactor, the port of ``repro.optim.optimizers``.

The JAX functions return new trees.  On the card that would hold the old
and the new parameters and moments at once (a 3 B-parameter model in
float32 holds 48 GB of parameters, gradients and AdamW moments), so here
every update works in place under ``torch.no_grad()``: each leaf's
parameter and state tensors are overwritten, and the functions return the
same tree objects they were given, with the JAX package's signatures.
Peak memory is the state plus one leaf's temporaries (a stacked leaf is
updated one entry of its leading axis at a time).  The arithmetic is
JAX's, op for op, in float32.

The trees are nested dicts of tensors (``ckpt.checkpoint.tree_flatten``
order); Adafactor keeps a factored second moment (``vr``, ``vc``) for
every leaf of rank 2 or more whose last two axes exceed 1.

On a mesh each rank holds blocks of the leaves (``dist/sharding.py``),
and ``blocks`` (a tree of ``sharding.Block`` shaped like the gradients)
says where each lies: what the JAX package takes over a whole leaf is
taken over the whole leaf here too.  The global norm counts every element
once (a replicated leaf is held whole by every rank; one rank's copy
counts) and sums over the world; Adafactor's factored means, its
``denom`` and its update's RMS sum over the ranks that split the dims
they reduce, and the chunked path is chosen by the whole leaf's size.
AdamW is elementwise.  Where nothing is split, every result is the
single-device one bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.ckpt.checkpoint import (flatten_up_to, tree_flatten,
                                        tree_unflatten)


def _zip(*trees):
    """The leaves of ``trees`` (of one structure) side by side."""
    return zip(*(tree_flatten(t)[0] for t in trees))


def _zeros32(tree):
    """float32 zeros shaped like each leaf of ``tree``."""
    flat, _ = tree_flatten(tree)
    return tree_unflatten(tree, [torch.zeros_like(x, dtype=torch.float32)
                                 for x in flat])


def _slices(*xs):
    """Entries of the leading axis of stacked leaves (rank 3 or more),
    else the whole tensors: the elementwise update of each holds one
    entry's temporaries."""
    if xs[0].dim() >= 3:
        return zip(*(x.unbind(0) for x in xs))
    return [xs]


def _blocks(tree, blocks):
    """``blocks``' leaves in ``tree``'s order, or None for each leaf."""
    n = len(tree_flatten(tree)[0])
    return [None] * n if blocks is None else tree_flatten(blocks)[0]


def global_norm(tree, blocks=None) -> torch.Tensor:
    flat, _ = tree_flatten(tree)
    if blocks is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in flat))
    bl = _blocks(tree, blocks)
    # the same sum from 0 as above, of this rank's counted blocks, then
    # over the world
    total = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    for x, b in zip(flat, bl):
        if b.owner:
            total = total + torch.sum(torch.square(x.float()))
    bl[0].mesh.all_reduce(total, ("data", "model"))
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, blocks=None):
    """Scale ``grads`` in place by ``min(1, max_norm / norm)``; returns
    ``(grads, norm)``.  Each leaf is ``(g * scale)`` cast back to g's
    dtype."""
    norm = global_norm(grads, blocks)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g, in _zip(grads):
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, norm


# ------------------------------------------------------------------- AdamW

def adamw_init(params):
    return {"m": _zeros32(params), "v": _zeros32(params)}


@torch.no_grad()
def adamw_update(grads, state, params, step, lr, *, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, blocks=None):
    # elementwise: a block updates as its part of the whole leaf would
    t = (torch.as_tensor(step) + 1).to(torch.float32)
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    for leaf in _zip(grads, state["m"], state["v"], params):
        for g, m, v, p in _slices(*leaf):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_(((1 - b2) * g).mul_(g))
            u = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
            p32 = p.float()
            u = (u.add_(weight_decay * p32)).mul_(lr)
            p.copy_(p32 - u)
    return params, state


# --------------------------------------------------------------- Adafactor

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params):
    def init(p):
        z = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}
    flat, _ = tree_flatten(params)
    return {"v": tree_unflatten(params, [init(p) for p in flat])}


_CHUNK_THRESHOLD = 1 << 26   # elements; above this, update in chunks


def _mean(x, dim, blk, leaf_dim=None, keepdim=False):
    """``x.mean(dim)`` over the whole leaf's extent of ``leaf_dim`` (the
    leaf's dim that ``x``'s ``dim`` stands for, ``dim`` by default): where
    the block's spec splits it, this block's sum summed over the ranks
    that split it, over the whole length."""
    leaf_dim = dim if leaf_dim is None else leaf_dim
    if blk is None or not blk.split(leaf_dim):
        return x.mean(dim=dim, keepdim=keepdim)
    return (blk.sum(x.sum(dim=dim, keepdim=keepdim), (leaf_dim,))
            / blk.shape[leaf_dim])


def _adafactor_stats(g32, s, beta2, eps, blk=None):
    """The second-moment update, in place in ``s``."""
    g2 = (g32 * g32).add_(eps)
    if "vr" in s:
        s["vr"].mul_(beta2).add_((1 - beta2) * _mean(g2, -1, blk))
        s["vc"].mul_(beta2).add_((1 - beta2) * _mean(g2, -2, blk))
    else:
        s["v"].mul_(beta2).add_((1 - beta2) * g2)


def _adafactor_u(g32, s, eps, blk=None):
    """The unclipped update direction from the (updated) statistics."""
    if "vr" in s:
        vr, vc = s["vr"], s["vc"]
        # vr's last dim is the leaf's second-to-last
        denom = torch.clamp(_mean(vr, -1, blk, -2, keepdim=True), min=eps)
        return g32 / (torch.sqrt(vr / denom)[..., None]
                      * torch.sqrt(vc)[..., None, :])
    return g32 / torch.sqrt(s["v"])


def _adafactor_apply(p, u, lr, weight_decay):
    p32 = p.float()
    p.copy_(p32 - lr * (u.add_(weight_decay * p32)))


@torch.no_grad()
def adafactor_update(grads, state, params, step, lr, *, decay=0.8,
                     eps=1e-30, clip_threshold=1.0, weight_decay=0.0,
                     blocks=None):
    t = (torch.as_tensor(step) + 1).to(torch.float32)
    beta2 = 1.0 - t ** (-decay)

    def mean_square(u, blk):
        """The whole leaf's mean of ``u**2``."""
        if blk is None or not blk.any_split():
            return torch.mean(torch.square(u))
        return blk.sum(torch.sum(torch.square(u))) / float(blk.numel)

    def upd_small(g, s, p, blk):
        g32 = g.float()
        _adafactor_stats(g32, s, beta2, eps, blk)
        u = _adafactor_u(g32, s, eps, blk)
        rms_u = torch.sqrt(mean_square(u, blk) + 1e-12)
        u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
        _adafactor_apply(p, u, lr, weight_decay)

    def upd_chunked(g, s, p, blk):
        """Two passes over axis 0, as the JAX package's: the first updates
        the statistics and sums u^2, the second re-derives u (from the
        same statistics the first computed) and updates the parameter;
        the float32 temporaries are one entry's."""
        def entry(i):
            return {k: x[i] for k, x in s.items()}

        ss = []
        for i in range(g.shape[0]):
            g32 = g[i].float()
            _adafactor_stats(g32, entry(i), beta2, eps, blk)
            ss.append(torch.sum(torch.square(_adafactor_u(g32, entry(i),
                                                          eps, blk))))
        total = torch.stack(ss).sum()
        if blk is not None:
            blk.sum(total)
        numel = g.numel() if blk is None else blk.numel
        rms_u = torch.sqrt(total / float(numel) + 1e-12)
        scale = torch.clamp(rms_u / clip_threshold, min=1.0)
        for i in range(g.shape[0]):
            u = _adafactor_u(g[i].float(), entry(i), eps, blk)
            _adafactor_apply(p[i], u.div_(scale), lr, weight_decay)

    for g, s, p, blk in zip(tree_flatten(grads)[0],
                            flatten_up_to(params, state["v"]),
                            tree_flatten(params)[0],
                            _blocks(grads, blocks)):
        shape = g.shape if blk is None else blk.shape
        numel = g.numel() if blk is None else blk.numel
        if (numel > _CHUNK_THRESHOLD and _factored(shape)
                and len(shape) >= 3):
            upd_chunked(g, s, p, blk)
        else:
            upd_small(g, s, p, blk)
    return params, state


# ---------------------------------------------------------------- factory

@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    # (grads, state, params, step, lr, blocks=None) -> (params, state)
    update: Callable


def make_optimizer(name: str, **kwargs) -> Optimizer:
    if name == "adamw":
        upd = (lambda g, s, p, step, lr, blocks=None:
               adamw_update(g, s, p, step, lr, blocks=blocks, **kwargs))
        return Optimizer("adamw", adamw_init, upd)
    if name == "adafactor":
        upd = (lambda g, s, p, step, lr, blocks=None:
               adafactor_update(g, s, p, step, lr, blocks=blocks, **kwargs))
        return Optimizer("adafactor", adafactor_init, upd)
    raise ValueError(f"unknown optimizer {name!r}")
