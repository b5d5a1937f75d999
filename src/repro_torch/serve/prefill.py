"""Prefill step: install prompt K/V into the hybrid KV pool.

``make_prefill_step`` is the full-(re)compute forward of the JAX package's
``repro.serve.prefill.make_prefill_step``: the batch rows hold the WHOLE
prefix up to the chunk end, the forward recomputes every position and the
chunk's new blocks are installed.  (The prefix-KV chunk step is ROADMAP
P9.)

Calling convention (the engine's admission contract):

* ``batch["tokens"]`` (B, S) — right-padded token rows (exact under causal
  attention: a position never attends past itself);
* ``slots`` (B, S // bs) int32 — pool slot per cache block to install;
  ``-1`` blocks are not installed (pad blocks, blocks an earlier chunk
  installed);
* ``slot_ids`` (B,) int32 — the batch slot of each row; ``-1`` rows
  (bucket padding) write nothing;
* ``ctx`` (B,) int32 — post-install context length per row;
* ``last_pos`` (B,) int32 — index of each row's final real token.

The decode state is updated in place: the pools through the forward's
collected K/V (a ``-1`` block is written into the pool's sink slot
instead, see ``serve/decode.py``), ``ctx_len`` only at participating
slots.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import FwdOptions, ModelDims, forward
from .decode import DecodeSpec


def _install_kv(spec: DecodeSpec, dstate, caches, eff_slots, B: int) -> None:
    """Write per-layer chunk K/V (L, B, S, KV, hd) into the pools at
    ``eff_slots`` (B, S // bs); -1 entries go to the sink slot."""
    k, v = caches["k"], caches["v"]
    L, _, S, KV, hd = k.shape
    bs = spec.block_size
    nblk = S // bs
    sink = dstate["k_pool"].shape[1] - 1
    sl = eff_slots.reshape(-1)
    idx = torch.where(sl >= 0, sl, sink).long()
    for name, c in (("k_pool", k), ("v_pool", v)):
        pool = dstate[name]
        pool[:, idx] = c.reshape(L, B * nblk, bs, KV, hd).to(pool.dtype)


def _first_token_stats(last: torch.Tensor):
    """First generated token per row (greedy)."""
    return {"next_token": last.argmax(dim=-1).to(torch.int32)}


def make_prefill_step(cfg: ArchConfig, dims: ModelDims, spec: DecodeSpec,
                      fwd: FwdOptions = FwdOptions()):
    """Returns prefill_step(params, dstate, batch, slots, slot_ids, ctx,
    last_pos) -> (last_logits (B, V), dstate, stats);
    ``stats["next_token"]`` is the first generated token per row."""
    fwd_collect = dataclasses.replace(fwd, collect_cache=True)

    def prefill_step(params, dstate, batch, slots, slot_ids, ctx, last_pos):
        logits, _, caches = forward(params, batch, cfg, dims, fwd_collect)
        B = batch["tokens"].shape[0]
        row_ok = slot_ids >= 0
        _install_kv(spec, dstate, caches,
                    torch.where(row_ok[:, None], slots, -1), B)
        # scatter ctx to PARTICIPATING slots only: a one-hot match of the
        # batch slots against the rows (pad rows, -1, never match)
        ctx_len = dstate["ctx_len"]
        n = ctx_len.shape[0]
        match = (torch.arange(n, device=ctx_len.device)[:, None]
                 == slot_ids[None, :])                           # (n, B)
        new = (match.to(torch.int64) * ctx[None, :]).sum(dim=1)
        ctx_len.copy_(torch.where(match.any(dim=1), new.to(ctx_len.dtype),
                                  ctx_len))
        rows = torch.arange(B, device=logits.device)
        last = logits[rows, last_pos.long()]
        return last, dstate, _first_token_stats(last)

    return prefill_step
