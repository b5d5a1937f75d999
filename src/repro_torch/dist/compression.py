"""Gradient compression for the cross-pod data-parallel hop: the port of
``repro.dist.compression``.

int8 quantization with error feedback (EF): the quantization residual is
carried to the next step so the *sum* of transmitted gradients tracks the
sum of true gradients:

    g_hat_t = Q(g_t + e_{t-1});  e_t = (g_t + e_{t-1}) - g_hat_t
    =>  sum_t g_hat_t + e_T == sum_t g_t        (per leaf)

Only the transmitted tensor is quantized; optimizer math stays float32.
``torch.round`` rounds half to even, as ``jnp.round`` does.  On a mesh a
leaf's scale is its whole leaf's (``blocks``: where each block lies, see
``dist/sharding.py``; the largest magnitude is maxed over the ranks that
hold its other blocks).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.ckpt.checkpoint import (flatten_up_to, tree_flatten,
                                        tree_unflatten)


class EFState(NamedTuple):
    residual: torch.Tensor


def init_ef(params) -> dict:
    """Per-leaf EF residuals, mirroring the parameter tree."""
    flat, _ = tree_flatten(params)
    return tree_unflatten(params, [
        EFState(residual=torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)) for p in flat])


def quantize_int8(x: torch.Tensor, blk=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q int8, scale float32 scalar).
    ``blk``: where ``x`` lies in its whole tensor, whose scale it takes."""
    x32 = x.float()
    amax = torch.max(torch.abs(x32))
    if blk is not None:
        blk.max(amax)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_ef(g: torch.Tensor, ef: EFState, blk=None
                     ) -> Tuple[torch.Tensor, EFState]:
    """One leaf: quantize (g + residual), return (g_hat, new EF state)."""
    total = g.float() + ef.residual.float()
    q, scale = quantize_int8(total, blk)
    g_hat = dequantize_int8(q, scale)
    return g_hat.to(g.dtype), EFState(residual=total - g_hat)


def tree_compress_with_ef(grads, ef_tree, blocks=None):
    """Whole-tree EF compression; ``ef_tree`` leaves are ``EFState``."""
    flat_g, _ = tree_flatten(grads)
    flat_e = flatten_up_to(grads, ef_tree)
    flat_b = ([None] * len(flat_g) if blocks is None
              else tree_flatten(blocks)[0])
    out = [compress_with_ef(g, e, b)
           for g, e, b in zip(flat_g, flat_e, flat_b)]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))

