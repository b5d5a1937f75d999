"""Attention: the dense reference, the chunked flash attention, the
prefix-KV parts and the dispatch to the flash kernel.

* ``dense_attention`` — materializes the scores; the plain version of the
  flash kernel (``kernels/flash_attention``) and the CPU path.
* ``flash_attention_jax`` — the JAX package's chunked online-softmax
  attention (query chunks, each a loop over KV chunks, in float32), eager
  torch; the JAX engine's ``attn_impl="flash_jax"``.
* ``causal_attention_parts`` / ``merge_attention_parts`` — the chunk's own
  causal half of a prefix-KV chunk's attention as an unnormalized
  ``(o, m, l)`` partial, and the online-softmax combine of such partials
  (the other half comes from the paged-attention kernel).
* ``attention(impl=...)`` — ``"pallas"`` (the JAX package's name; alias
  ``"flash"``) goes through the flash kernel's wrapper (the CUDA kernel on
  a CUDA tensor, ``dense_attention`` on a CPU tensor); ``"dense"``, the
  default as in the JAX package, always runs ``dense_attention``;
  ``"flash_jax"`` runs ``flash_attention_jax``.

Both support GQA (n_heads = g * n_kv) and causal/full masks.
"""
from __future__ import annotations

import functools
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


def causal_attention_parts(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor):
    """Unnormalized causal attention over a chunk's OWN K/V.

    q: (B,S,H,hd), k/v: (B,S,KV,hd) -> (o_weighted (B,S,H,hd) float32,
    m (B,S,H), l (B,S,H)): the intra-chunk half of the prefix-KV merge,
    with the ``(o, m, l)`` contract of ``kernels.paged_attention``.  The
    mask is chunk-relative: query i attends chunk positions j <= i
    wherever the chunk sits in the sequence (the installed prefix is
    entirely in the other part)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    qf = q.reshape(B, Sq, KV, g, D).float()
    s = torch.einsum("bqkgd,bckd->bkgqc", qf, k.float()) * (1.0 / math.sqrt(D))
    mask = (torch.arange(Sq, device=q.device)[:, None]
            >= torch.arange(Skv, device=q.device)[None, :])
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)                                    # (B,KV,g,Sq)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgqc,bckd->bkgqd", p, v.float())
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return (o, m.permute(0, 3, 1, 2).reshape(B, Sq, H),
            l.permute(0, 3, 1, 2).reshape(B, Sq, H))


def merge_attention_parts(parts) -> torch.Tensor:
    """Flash-decoding combine: [(o_weighted, m, l), ...] -> normalized o
    (float32).  Each part is an unnormalized online-softmax partial over
    a disjoint KV range; a part with l == 0 everywhere (an empty prefix,
    m == -1e30) drops out exactly."""
    m_glob = functools.reduce(torch.maximum, [m for _, m, _ in parts])
    o = sum(o * torch.exp(m - m_glob)[..., None] for o, m, _ in parts)
    l = sum(l * torch.exp(m - m_glob) for _, m, l in parts)
    return o / l.clamp(min=1e-30)[..., None]


def pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (prefer multiples of 128)."""
    target = min(target, n)
    best = 1
    for c in range(target, 0, -1):
        if n % c == 0:
            if c % 128 == 0:
                return c
            best = max(best, c) if best == 1 else best
    return best


def flash_attention_jax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_chunk: int = 512,
                        kv_chunk: int = 512, q_offset: int = 0,
                        triangular_schedule: bool = False) -> torch.Tensor:
    """Chunked online-softmax attention, q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd)
    -> (B,Sq,H,hd) in q's dtype; the chunks are ``pick_chunk``'s divisors
    of the lengths, and the softmax runs in float32.

    ``q_offset`` (an int) positions the queries inside the causal mask.
    ``triangular_schedule``: for causal attention, skip KV chunks entirely
    above the diagonal; the baseline loops over every KV chunk and masks.
    """
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    q_chunk = pick_chunk(Sq, q_chunk)
    kv_chunk = pick_chunk(Skv, kv_chunk)
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    qc = q.reshape(B, nq, q_chunk, KV, g, D)
    kc = k.reshape(B, nk, kv_chunk, KV, D)
    vc = v.reshape(B, nk, kv_chunk, KV, D)
    outs = []
    for qi in range(nq):
        q32 = qc[:, qi].float() * scale                  # (B,qc,KV,g,D)
        m = torch.full((B, KV, g, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, g, q_chunk), dtype=torch.float32,
                        device=dev)
        o = torch.zeros((B, KV, g, q_chunk, D), dtype=torch.float32,
                        device=dev)
        n_active = nk
        if causal and triangular_schedule:
            # only chunks at or below the diagonal contribute
            n_active = min(
                (qi * q_chunk + q_chunk - 1 + q_offset) // kv_chunk + 1, nk)
        for j in range(n_active):
            s = torch.einsum("bqkgd,bckd->bkgqc", q32, kc[:, j].float())
            if causal:
                qpos = (qi * q_chunk + torch.arange(q_chunk, device=dev)
                        + q_offset)
                cpos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
                s = torch.where(qpos[:, None] >= cpos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p, vc[:, j].float())
            m = m_new
        o = o / l.clamp(min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, D))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention(q, k, v, *, impl: str = "dense", causal: bool = True,
              q_offset=0, q_chunk: int = 512, kv_chunk: int = 512,
              triangular_schedule: bool = False,
              kv_len: Optional[torch.Tensor] = None):
    """``impl``: ``"dense"``, ``"flash_jax"`` or ``"pallas"`` (the JAX
    package's name of the flash kernel; ``"flash"`` is the same), with the
    JAX package's arguments: the chunking ones reach ``"flash_jax"`` only,
    and ``"pallas"`` takes neither ``q_offset`` nor ``kv_len``."""
    if impl == "dense":
        return dense_attention(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len)
    if impl == "flash_jax":
        if kv_len is not None:
            raise NotImplementedError("flash_jax is for train/prefill "
                                      "(full-length KV)")
        return flash_attention_jax(
            q, k, v, causal=causal, q_offset=q_offset, q_chunk=q_chunk,
            kv_chunk=kv_chunk, triangular_schedule=triangular_schedule)
    if impl in ("pallas", "flash"):
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return flash_attention(q, k, v, causal=causal)
    raise ValueError(f"unknown attention impl {impl!r} (expected 'dense', "
                     "'flash_jax' or 'pallas')")
