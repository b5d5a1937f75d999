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


def global_norm(tree) -> torch.Tensor:
    flat, _ = tree_flatten(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in flat))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place by ``min(1, max_norm / norm)``; returns
    ``(grads, norm)``.  Each leaf is ``(g * scale)`` cast back to g's
    dtype."""
    norm = global_norm(grads)
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
                 eps=1e-8, weight_decay=0.1):
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


def _adafactor_stats(g32, s, beta2, eps):
    """The second-moment update, in place in ``s``."""
    g2 = (g32 * g32).add_(eps)
    if "vr" in s:
        s["vr"].mul_(beta2).add_((1 - beta2) * g2.mean(dim=-1))
        s["vc"].mul_(beta2).add_((1 - beta2) * g2.mean(dim=-2))
    else:
        s["v"].mul_(beta2).add_((1 - beta2) * g2)


def _adafactor_u(g32, s, eps):
    """The unclipped update direction from the (updated) statistics."""
    if "vr" in s:
        vr, vc = s["vr"], s["vc"]
        denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
        return g32 / (torch.sqrt(vr / denom)[..., None]
                      * torch.sqrt(vc)[..., None, :])
    return g32 / torch.sqrt(s["v"])


def _adafactor_apply(p, u, lr, weight_decay):
    p32 = p.float()
    p.copy_(p32 - lr * (u.add_(weight_decay * p32)))


@torch.no_grad()
def adafactor_update(grads, state, params, step, lr, *, decay=0.8,
                     eps=1e-30, clip_threshold=1.0, weight_decay=0.0):
    t = (torch.as_tensor(step) + 1).to(torch.float32)
    beta2 = 1.0 - t ** (-decay)

    def upd_small(g, s, p):
        g32 = g.float()
        _adafactor_stats(g32, s, beta2, eps)
        u = _adafactor_u(g32, s, eps)
        rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
        _adafactor_apply(p, u, lr, weight_decay)

    def upd_chunked(g, s, p):
        """Two passes over axis 0, as the JAX package's: the first updates
        the statistics and sums u^2, the second re-derives u (from the
        same statistics the first computed) and updates the parameter;
        the float32 temporaries are one entry's."""
        def entry(i):
            return {k: x[i] for k, x in s.items()}

        ss = []
        for i in range(g.shape[0]):
            g32 = g[i].float()
            _adafactor_stats(g32, entry(i), beta2, eps)
            ss.append(torch.sum(torch.square(_adafactor_u(g32, entry(i),
                                                          eps))))
        rms_u = torch.sqrt(torch.stack(ss).sum() / float(g.numel()) + 1e-12)
        scale = torch.clamp(rms_u / clip_threshold, min=1.0)
        for i in range(g.shape[0]):
            u = _adafactor_u(g[i].float(), entry(i), eps)
            _adafactor_apply(p[i], u.div_(scale), lr, weight_decay)

    for g, s, p in zip(tree_flatten(grads)[0],
                       flatten_up_to(params, state["v"]),
                       tree_flatten(params)[0]):
        if (g.numel() > _CHUNK_THRESHOLD and _factored(g.shape)
                and g.dim() >= 3):
            upd_chunked(g, s, p)
        else:
            upd_small(g, s, p)
    return params, state


# ---------------------------------------------------------------- factory

@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (grads, state, params, step, lr) -> (params, state)


def make_optimizer(name: str, **kwargs) -> Optimizer:
    if name == "adamw":
        upd = lambda g, s, p, step, lr: adamw_update(g, s, p, step, lr,
                                                     **kwargs)
        return Optimizer("adamw", adamw_init, upd)
    if name == "adafactor":
        upd = lambda g, s, p, step, lr: adafactor_update(g, s, p, step, lr,
                                                         **kwargs)
        return Optimizer("adafactor", adafactor_init, upd)
    raise ValueError(f"unknown optimizer {name!r}")
