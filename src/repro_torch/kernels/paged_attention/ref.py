"""Plain torch version of paged attention over the hybrid pool.

Supports one query per sequence (decode, ``q (B, H, D)``) and multi-token
queries (``q (B, Q, H, D)``), with one extent per row ``ctx (B,)`` or one
per query ``ctx (B, Q)``.  Returns the UNNORMALIZED ``(o_weighted, m, l)``
so partial results over disjoint KV ranges can be merged.  Holes
(``slots < 0``) and positions at or past the extent are masked; a query
with extent 0 comes out with ``l == 0``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def gather_pool_blocks(pool: torch.Tensor, slots: torch.Tensor):
    """``pool (slots, bs, KV, D)`` gathered at ``slots (B, nblk)``
    (negative entries clamp to slot 0 and must be masked by the caller)
    -> ``(B, nblk, bs, KV, D)``."""
    return pool[slots.clamp(min=0).long()]


def paged_attention_ref(q, k_pool, v_pool, slots, ctx_len, *,
                        tok_offset: int = 0, tok_stride: int = 1,
                        block_tokens: int | None = None):
    """Same contract as the kernel: returns (o_weighted, m, l), float32,
    shaped (B[, Q], H, D) / (B[, Q], H) after the query rank."""
    k = gather_pool_blocks(k_pool, slots)
    v = gather_pool_blocks(v_pool, slots)
    return paged_attention_blocks(q, k, v, slots, ctx_len,
                                  tok_offset=tok_offset,
                                  tok_stride=tok_stride,
                                  block_tokens=block_tokens)


def paged_attention_blocks(q, k, v, slots, ctx_len, *,
                           tok_offset: int = 0, tok_stride: int = 1,
                           block_tokens: int | None = None):
    """``paged_attention_ref`` with the gather already done: ``k``/``v``
    are the per-row blocks ``(B, nblk, bs, KV, D)``; ``slots`` is still
    taken for the hole mask."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    B, Q, H, D = q.shape
    nblk, bs, KV = k.shape[1], k.shape[2], k.shape[3]
    if block_tokens is None:
        block_tokens = bs
    g = H // KV
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    pos = (torch.arange(nblk, device=dev)[:, None] * block_tokens
           + tok_offset
           + torch.arange(bs, device=dev)[None, :] * tok_stride)  # (nblk,bs)
    ctx_q = ctx_len[:, None] if ctx_len.dim() == 1 else ctx_len   # (B, Qc)
    valid = ((pos[None, None] < ctx_q[:, :, None, None])
             & (slots >= 0)[:, None, :, None])          # (B, Qc, nblk, bs)
    vflat = valid.reshape(B, 1, 1, valid.shape[1], -1)  # (B,1,1,Qc,nblk*bs)

    qk = q.float().reshape(B, Q, KV, g, D)
    s = torch.einsum("bqkgd,bjtkd->bkgqjt", qk, k.float()) * scale
    s = s.reshape(B, KV, g, Q, nblk * bs)
    s = torch.where(vflat, s, NEG_INF)
    m = s.amax(dim=-1)                                  # (B, KV, g, Q)
    p = torch.exp(s - m[..., None])
    p = torch.where(vflat, p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgqn,bnkd->bkgqd", p,
                     v.float().reshape(B, nblk * bs, KV, D))
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Q, H, D)
    m = m.permute(0, 3, 1, 2).reshape(B, Q, H)
    l = l.permute(0, 3, 1, 2).reshape(B, Q, H)
    if squeeze:
        return o[:, 0], m[:, 0], l[:, 0]
    return o, m, l


def normalize(o, l):
    return o / l.clamp(min=1e-30)[..., None]
