"""Attention: the dense reference and the dispatch to the flash kernel.

* ``dense_attention`` — materializes the scores; the plain version of the
  flash kernel (``kernels/flash_attention``) and the CPU path.
* ``attention(impl=...)`` — ``"flash"`` goes through the flash kernel's
  wrapper (the CUDA kernel on a CUDA tensor, ``dense_attention`` on a CPU
  tensor); ``"dense"`` always runs ``dense_attention``.

Both support GQA (n_heads = g * n_kv) and causal/full masks.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset=0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd) -> (B,Sq,H,hd) in q's dtype.

    ``q_offset`` positions the queries inside the causal mask: an int, or
    a ``(B,)`` tensor giving each row its own offset.  ``kv_len (B,)``
    masks keys at or past each row's length."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    dev = q.device
    qf = q.reshape(B, Sq, KV, g, D).float()
    s = torch.einsum("bqkgd,bckd->bkgqc", qf, k.float()) * (1.0 / math.sqrt(D))
    if causal:
        cpos = torch.arange(Skv, device=dev)
        if isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1:
            qpos = q_offset[:, None] + torch.arange(Sq, device=dev)[None, :]
            mask = qpos[:, :, None] >= cpos[None, None, :]   # (B, Sq, Skv)
            s = torch.where(mask[:, None, None], s, NEG_INF)
        else:
            qpos = torch.arange(Sq, device=dev) + q_offset
            s = torch.where(qpos[:, None] >= cpos[None, :], s, NEG_INF)
    if kv_len is not None:
        valid = torch.arange(Skv, device=dev)[None, :] < kv_len[:, None]
        s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def attention(q, k, v, *, impl: str = "flash", causal: bool = True):
    if impl == "dense":
        return dense_attention(q, k, v, causal=causal)
    if impl == "flash":
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return flash_attention(q, k, v, causal=causal)
    raise ValueError(f"unknown attention impl {impl!r} (expected 'flash' "
                     "or 'dense')")
