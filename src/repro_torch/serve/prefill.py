"""Prefill steps: install prompt K/V into the hybrid KV pool.

The port of ``repro.serve.prefill`` for the six families (a MoE layer's
FFN is ``moe_layer`` over the whole padded batch, pad rows included, as
in the JAX package).  Two ways to admit a prompt
chunk, sharing the install and ``ctx_len`` scatter:

* ``make_prefill_step`` — the full-(re)compute forward: the batch rows
  hold the WHOLE prefix up to the chunk end, the forward recomputes every
  position and the chunk's new blocks are installed.  Exact, but a
  chunked admission pays O(chunks²) compute.
* ``make_prefix_prefill_step`` — the prefix-KV chunk forward (chunk
  k > 0, and the first chunk after a prefix-cache hit): the rows hold
  ONLY the chunk's new tokens, and each attention layer reads the
  prefix's installed pool blocks through the translated ``prefix_slots``
  besides the chunk's own causal K/V, while each mamba sublayer continues
  from the slot's saved ``ssm``/``conv`` rows.  Chunk cost is linear in
  chunk length.

The mamba sublayers mask each row's pad tail (dt = 0 past the row's real
length: ``batch["seq_len"]`` in the recompute step, ``ctx - prefix_ctx``
in the prefix step), so the installed SSM state and conv tail are those
at the row's real end, and both steps install them at the row's slot.

The frontend families: ``batch["frontend"]`` (B, F, d) goes into the
recompute forward.  For vlm its F positions precede the prompt in the
installed K/V (``ctx``, ``prefix_ctx`` and the block indices count them);
for audio the recompute step installs each layer's cross-attention K/V
of the encoder output at the row's slot (``cross_k``/``cross_v``), and
the prefix step's cross sublayer reads the slot's installed rows instead
of running the encoder again.

Calling convention (the engine's admission contract):

* ``batch["tokens"]`` (B, S) — right-padded token rows (exact under causal
  attention: a position never attends past itself);
* ``slots`` / ``new_slots`` (B, S // bs) int32 — pool slot per cache block
  to install; ``-1`` blocks are not installed (pad blocks, blocks an
  earlier chunk installed, cache-attached blocks).  The recompute step
  indexes blocks absolutely, the prefix step chunk-locally;
* ``slot_ids`` (B,) int32 — the batch slot of each row; ``-1`` rows
  (bucket padding) write nothing;
* ``ctx`` (B,) int32 — post-install context length per row;
* ``last_pos`` (B,) int32 — index of each row's final real token;
* ``sample`` (keyword) — False: the first token is the argmax; True: each
  row's sampled token (greedy rows still take the argmax).

Both steps keep the reference's contract that a prompt installs the same
blocks and state, and gives the same tokens, whether it is admitted
whole, in chunks recomputed, or in prefix-KV chunks: they run their
forward with ``FwdOptions.rows_invariant`` (the rows-invariant GEMM and
RMS-norm kernels, and the flash kernel with each row's ``q_offset``), so
on the card a row's bits depend only on its inputs, the weights and its
absolute position.  Not the token-split step, not ``attn_impl=
"flash_jax"`` and not the ``"paged"`` gather, which merges two partials
at the chunk start and so cannot be bitwise across splits.

The decode state is updated in place: the pools through the forward's
collected K/V (a ``-1`` block is written into the pool's sink slot
instead, see ``serve/decode.py``), ``ctx_len`` only at participating
slots.

On a rank of a mesh (the factories' ``mesh`` and ``part``, see
``serve/decode.py``) the forward is replicated, a block installs only on
the rank that owns it, and the prefix-KV step's reads (both gathers)
assemble the prefix blocks exactly from the sharded pool first, so the
installed blocks and the first tokens are the unsharded step's.

On a rank of the token-split layout (a mesh without ``part``, the JAX
package's ``kv_shards=0``; batch mode) the recompute step forwards its
data group's rows on the rank's blocks of the weights, tensor-parallel
over the model group (``FwdOptions.tp``, a ``dist.megatron.ServingTP``:
attention on the rank's query heads, the MoE expert-parallel, the mamba
sublayers on its heads; each layer gathered over the data axes where ZeRO
splits it), gathers each layer's K/V heads over the model group (one
all-gather) and installs its token sub-range of each block (the JAX
package's ``_scatter_pool``), and installs its rows' recurrent state (its
heads, its block of conv channels) and cross rows (a row's ``slot_ids``
entry must lie in its own group's slots, as the step's rows are laid out;
another writes nothing); it sets ``ctx_len`` for the whole batch and
returns the whole batch's last logits and first tokens (one all-gather
over the data group).  The prefix-KV step refuses that layout, as the JAX
package's does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import gather_pool_blocks
from repro_torch.models import layers as Lmod
from repro_torch.models.attention import (causal_attention_parts,
                                          dense_attention,
                                          merge_attention_parts)
from repro_torch.models.transformer import (FwdOptions, ModelDims, _ffn,
                                            check_family, forward,
                                            hybrid_ffn_select, layer_params,
                                            mamba_block, stack_caches, take)
from .decode import (BlockRead, DecodeSpec, TokenSplit, step_shard,
                     token_split_tp)
from .sampling import sample_tokens


def _install_kv(spec: DecodeSpec, dstate, caches, eff_slots, B: int,
                shard=None) -> None:
    """Write per-layer chunk K/V (L, B, S, KV, hd) into the pools at
    ``eff_slots`` (B, S // bs); -1 entries go to the sink slot, and on a
    rank of a mesh (``shard``) so do the blocks other ranks own.  A
    token-split rank (``shard``, a ``TokenSplit``) writes its token
    sub-range of each block."""
    k, v = caches["k"], caches["v"]
    L, _, S, KV, hd = k.shape
    bs = spec.block_size
    nblk = S // bs
    sink = dstate["k_pool"].shape[1] - 1
    sl = eff_slots.reshape(-1)
    tokens = slice(None)
    if shard is None or isinstance(shard, TokenSplit):
        idx = torch.where(sl >= 0, sl, sink).long()
        if shard is not None:
            tokens = slice(shard.m * shard.bs_loc,
                           (shard.m + 1) * shard.bs_loc)
    else:
        idx, _ = shard.local(sl)
    for name, c in (("k_pool", k), ("v_pool", v)):
        pool = dstate[name]
        c = c.reshape(L, B * nblk, bs, KV, hd)[:, :, tokens]
        pool[:, idx] = c.to(pool.dtype)


def _slot_rows(slot_ids, n: int):
    """For each of the ``n`` batch slots: the row of ``slot_ids`` (B,)
    that targets it (0 when none does) and whether one does; pad rows
    (-1) target nothing."""
    match = (torch.arange(n, device=slot_ids.device)[:, None]
             == slot_ids[None, :])                               # (n, B)
    return match.to(torch.int64).argmax(dim=1), match.any(dim=1)


def _install_rows(dstate, rows, slot_ids, B: int) -> None:
    """Write per-row state ``rows`` ({name: tensor with any leading
    sublayer axes, then B}) into ``dstate[name]`` (L, slots, ...) at the
    rows' slots; pad rows write nothing.  A gather of the new rows and a
    select, bitwise the rows computed, with no host sync."""
    name0 = next(iter(rows))
    row, hit = _slot_rows(slot_ids, dstate[name0].shape[1])
    for name, new in rows.items():
        dst = dstate[name]
        new = new.reshape(-1, B, *dst.shape[2:])[:, row].to(dst.dtype)
        keep = hit.reshape(1, -1, *([1] * (dst.dim() - 2)))
        dst.copy_(torch.where(keep, new, dst))


def _scatter_ctx(dstate, slot_ids, ctx) -> None:
    """Set ``ctx_len`` at PARTICIPATING slots only (pad rows, -1, target
    none)."""
    ctx_len = dstate["ctx_len"]
    row, hit = _slot_rows(slot_ids, ctx_len.shape[0])
    ctx_len.copy_(torch.where(hit, ctx[row].to(ctx_len.dtype), ctx_len))


def _first_token_stats(dstate, last, slot_ids, ctx, sample: bool):
    """First generated token per row.  Sampled rows use their slot's
    sampling state (scattered by the engine before the dispatch) and fold
    position ctx - 1: a token drawn from k context tokens folds k - 1, as
    the decode step does (its pre-step ctx_len is k), so the stream does
    not depend on chunking or schedule.  Pad rows read slot 0's state;
    their token is never read."""
    if sample:
        n = dstate["ctx_len"].shape[0]
        sid = slot_ids.clamp(0, n - 1).long()
        fold = (ctx - 1).clamp(min=0)
        return {"next_token": sample_tokens(
            last, dstate["samp_temp"][sid], dstate["samp_topk"][sid],
            dstate["samp_topp"][sid], dstate["samp_key"][sid], fold)}
    return {"next_token": last.argmax(dim=-1).to(torch.int32)}


def make_prefill_step(cfg: ArchConfig, dims: ModelDims, spec: DecodeSpec,
                      fwd: FwdOptions = FwdOptions(), mesh=None, part=None,
                      rules=None):
    """Returns prefill_step(params, dstate, batch, slots, slot_ids, ctx,
    last_pos, *, sample=False) -> (last_logits (B, V), dstate, stats);
    ``stats["next_token"]`` is the first generated token per row.  On a
    token-split rank ``params`` are its blocks (``make_serve_step``'s
    ``rules``)."""
    check_family(cfg)
    shard = step_shard(spec, mesh, part)
    split = shard if isinstance(shard, TokenSplit) else None
    if split is not None and split.striped:
        raise ValueError("the striped layout is decode-only (no JAX cell "
                         "prefills it)")
    tp = None if split is None else token_split_tp(cfg, dims, spec, mesh,
                                                   rules)
    fwd_collect = dataclasses.replace(
        fwd, collect_cache=True, tp=tp,
        rows_invariant=split is None and fwd.attn_impl != "flash_jax")

    def prefill_step(params, dstate, batch, slots, slot_ids, ctx, last_pos,
                     *, sample=False):
        whole_ids, whole_ctx = slot_ids, ctx
        row_ids = slot_ids                       # slots of the state's rows
        if split is not None:
            tp.check(params)
            rows = split.rows(batch["tokens"].shape[0])
            batch = {k: x[rows] for k, x in batch.items()}
            slots, slot_ids, ctx, last_pos = (
                t[rows] for t in (slots, slot_ids, ctx, last_pos))
            n = rows.stop - rows.start
            row_ids = slot_ids - rows.start
            row_ids = torch.where((row_ids >= 0) & (row_ids < n), row_ids,
                                  -1)
        logits, _, caches = forward(params, batch, cfg, dims, fwd_collect)
        B = batch["tokens"].shape[0]
        row_ok = slot_ids >= 0
        if "k" in caches:
            _install_kv(spec, dstate, caches,
                        torch.where(row_ok[:, None], slots, -1), B, shard)
        if "ssm" in caches:
            mc = caches["ssm"]
            _install_rows(dstate, {"ssm": mc.state, "conv": mc.conv},
                          row_ids, B)
        if "ck" in caches:
            _install_rows(dstate, {"cross_k": caches["ck"],
                                   "cross_v": caches["cv"]}, row_ids, B)
        _scatter_ctx(dstate, whole_ids, whole_ctx)
        rows = torch.arange(B, device=logits.device)
        last = logits[rows, last_pos.long()]
        stats = _first_token_stats(dstate, last, slot_ids, ctx, sample)
        if split is not None:
            last, stats["next_token"] = split.gather_groups(
                [last, stats["next_token"]])
        return last, dstate, stats

    return prefill_step


def make_prefix_prefill_step(cfg: ArchConfig, dims: ModelDims,
                             spec: DecodeSpec,
                             fwd: FwdOptions = FwdOptions(), mesh=None,
                             part=None):
    """Chunk-k (k > 0) prefill: forward ONLY the chunk's new tokens.

    Returns prefix_prefill_step(params, dstate, batch, new_slots,
    prefix_slots, slot_ids, ctx, prefix_ctx, last_pos, *, sample=False)
    -> (last_logits (B, V), dstate, stats) where

    * ``batch["tokens"]`` (B, S) — the chunk's tokens only, right-padded;
    * ``new_slots`` (B, S // bs) — install slot per CHUNK-LOCAL block;
    * ``prefix_slots`` (B, nblk_buf) — the translated pool slot of every
      absolute block below the row's prefix (entries at or after the
      chunk start, and pad rows, are -1);
    * ``prefix_ctx`` (B,) — installed prefix tokens: the absolute position
      of the chunk's first token;
    * ``ctx`` (B,) — post-install context length (= prefix_ctx + take).

    ``spec.prefix_gather``: ``"exact"`` places the gathered prefix blocks
    and the chunk's K/V at their absolute block positions and runs the
    recompute forward's own attention, the flash kernel (its plain
    version, ``dense_attention``, on the CPU) with the per-row
    ``q_offset``, and the rows-invariant projections and norms, so
    installed blocks and logits equal the recompute path's bitwise;
    ``"paged"`` reads the pool through the paged-attention kernel
    with Q = S queries per row (its plain version on the CPU) and merges
    that partial with ``causal_attention_parts`` over the chunk's own K/V,
    equal to "exact" up to float associativity.

    Each mamba sublayer starts from the slot's saved ``ssm``/``conv`` rows
    (pad rows read slot 0's and install nothing) and masks the row's pad
    tail past ``ctx - prefix_ctx``.  The audio decoder's cross sublayer
    reads the slot's installed ``cross_k``/``cross_v`` rows; nothing is
    installed there (the recompute chunk 0 did).
    """
    check_family(cfg)
    paged = spec.prefix_gather == "paged"
    rows = not paged
    fwd = dataclasses.replace(fwd, rows_invariant=rows)
    bs = spec.block_size
    H, KV, hd = dims.n_heads, dims.n_kv, dims.head_dim
    shard = step_shard(spec, mesh, part)
    if isinstance(shard, TokenSplit):
        raise NotImplementedError(
            "prefix-KV prefill is single-host for now; the SPMD admission "
            "path (ROADMAP) still drives the recompute prefill")

    def attn_read(q, k_new, v_new, kp_l, vp_l, prefix_slots, prefix_ctx,
                  read):
        """The attention of the chunk's queries over the installed prefix
        and the chunk's own K/V.  ``read``: on a rank of a mesh, the
        step's ``BlockRead`` of the prefix blocks (None on one device)."""
        B, S = q.shape[:2]
        if read is not None:
            kp_l, vp_l = read(kp_l, vp_l)    # (B * nbuf, bs, KV, hd) each
        if paged:
            pool = paged_attention(
                q, kp_l, vp_l,
                prefix_slots if read is None else read.slots, prefix_ctx)
            own = causal_attention_parts(q, k_new, v_new)
            return merge_attention_parts([pool, own]).to(q.dtype)
        nblk_buf = prefix_slots.shape[1]
        nblk_chunk = S // bs
        ok = (prefix_slots >= 0)[..., None, None, None]
        if read is None:
            gk = gather_pool_blocks(kp_l, prefix_slots)
            gv = gather_pool_blocks(vp_l, prefix_slots)
        else:          # assembled in order; the -1 blocks came back zero
            gk = kp_l.view(B, nblk_buf, *kp_l.shape[1:])
            gv = vp_l.view(B, nblk_buf, *vp_l.shape[1:])
        gk = torch.where(ok, gk, 0.0).to(k_new.dtype)  # (B, nbuf, bs, KV, hd)
        gv = torch.where(ok, gv, 0.0).to(v_new.dtype)
        ck = k_new.reshape(B, nblk_chunk, bs, KV, hd)
        cv = v_new.reshape(B, nblk_chunk, bs, KV, hd)
        start_blk = prefix_ctx // bs
        j = torch.arange(nblk_buf, device=q.device)
        is_prefix = j[None, :] < start_blk[:, None]
        cj = (j[None, :] - start_blk[:, None]).clamp(0, nblk_chunk - 1)
        rows = torch.arange(B, device=q.device)[:, None]
        sel = is_prefix[..., None, None, None]
        # buffer blocks past the row's chunk end hold clipped duplicates;
        # they sit above every real query position, so the causal mask
        # removes them exactly
        k_full = torch.where(sel, gk, ck[rows, cj]).reshape(
            B, nblk_buf * bs, KV, hd)
        v_full = torch.where(sel, gv, cv[rows, cj]).reshape(
            B, nblk_buf * bs, KV, hd)
        return flash_attention(q, k_full, v_full, causal=True,
                               q_offset=prefix_ctx)

    def prefix_prefill_step(params, dstate, batch, new_slots, prefix_slots,
                            slot_ids, ctx, prefix_ctx, last_pos, *,
                            sample=False):
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = Lmod.embed(params["embed"], tokens).to(fwd.dtype)
        positions = (prefix_ctx[:, None]
                     + torch.arange(S, dtype=torch.int32,
                                    device=tokens.device)[None, :])
        ks, vs, ssm = [], [], []
        # pad rows (-1) read slot 0's rows and install nothing
        sid = slot_ids.clamp(0, dstate["ctx_len"].shape[0] - 1).long()
        # per-row real chunk length: the pad tail's identity mask
        chunk_len = ctx - prefix_ctx
        read = None if shard is None else BlockRead(shard, prefix_slots)

        def mamba_sub(blk, x, j):
            x, c = mamba_block(blk, x, cfg, dims, collect=True,
                               seq_len=chunk_len,
                               initial_state=dstate["ssm"][j][sid],
                               initial_conv=dstate["conv"][j][sid],
                               rows=rows)
            ssm.append(c)
            return x

        def attn_sub(blk, x, j):
            """The attention sublayer on pool layer ``j``."""
            h = Lmod.rms_norm(x, blk["norm1"], cfg.norm_eps, rows)
            q, k, v = Lmod.qkv_project(blk["attn"], h, h, H, KV, hd,
                                       positions, positions, cfg.rope_theta,
                                       rows)
            o = attn_read(q, k, v, dstate["k_pool"][j], dstate["v_pool"][j],
                          prefix_slots, prefix_ctx, read)
            ks.append(k)
            vs.append(v)
            return x + Lmod.linear(blk["attn"]["o"], o.reshape(B, S, -1),
                                   rows)

        def cross_sub(blk, x, j):
            """The audio decoder's cross sublayer of layer ``j`` over the
            slots' installed cross K/V, through the dense softmax (as the
            JAX step reads them), or with ``rows`` the flash kernel, as
            the recompute forward's cross sublayer runs it."""
            h = Lmod.rms_norm(x, blk["norm_x"], cfg.norm_eps, rows)
            q = Lmod.linear(blk["cross"]["q"], h, rows).reshape(B, S, H, hd)
            attend = flash_attention if rows else dense_attention
            o = attend(q, dstate["cross_k"][j][sid],
                       dstate["cross_v"][j][sid], causal=False)
            return x + Lmod.linear(blk["cross"]["o"], o.reshape(B, S, -1),
                                   rows)

        if cfg.family == "hybrid":
            g = cfg.attn_every
            for gi in range(cfg.num_layers // g):
                blk = layer_params(params, gi)
                for i in range(g):
                    x = (mamba_sub(take(blk["mamba"], i), x,
                                   gi * (g - 1) + i) if i < g - 1
                         else attn_sub(blk["attn"], x, gi))
                    x, _ = _ffn(hybrid_ffn_select(cfg, blk, i), x, cfg, fwd)
        else:
            for i in range(cfg.num_layers):
                blk = layer_params(params, i)
                if cfg.family == "ssm":
                    x = mamba_sub(blk, x, i)
                    continue
                x = attn_sub(blk, x, i)
                if cfg.family == "audio":
                    x = cross_sub(blk, x, i)
                x, _ = _ffn(blk, x, cfg, fwd)
        row_ok = slot_ids >= 0
        if ks:
            _install_kv(spec, dstate,
                        {"k": torch.stack(ks), "v": torch.stack(vs)},
                        torch.where(row_ok[:, None], new_slots, -1), B,
                        shard)
        if ssm:
            mc = stack_caches(ssm)
            _install_rows(dstate, {"ssm": mc.state, "conv": mc.conv},
                          slot_ids, B)
        _scatter_ctx(dstate, slot_ids, ctx)
        x = Lmod.rms_norm(x, params["final_norm"], cfg.norm_eps, rows)
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        logits = Lmod.unembed(head, x, dims.logical_vocab, rows)
        last = logits[torch.arange(B, device=logits.device), last_pos.long()]
        return last, dstate, _first_token_stats(dstate, last, slot_ids, ctx,
                                                sample)

    return prefix_prefill_step
