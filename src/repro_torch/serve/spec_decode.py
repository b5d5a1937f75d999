"""Speculative decoding on the serve path: draft -> verify -> accept, up to
K+1 tokens a row per step, with no host sync inside the step.

The port of ``repro.serve.spec_decode``, on one device or on a rank of a
mesh (the sharded verify: the translation and the pool reads of
``serve/decode.py``'s sharded step, everything else replicated).  A step:

* **draft** — prompt lookup: each slot's token history (``dstate["hist"]``
  (B, max_seq_len) int32, -1 = unknown; the prompt is scattered at
  admission, accepted tokens are appended here) is matched against its own
  last ``ngram`` tokens, and the K tokens that followed the latest earlier
  occurrence are proposed;
* **verify** — the target model runs over the K+1 window positions (the
  fed token and the K drafts) in one forward.  The step's ONE translation
  is the RSW step kernel with a window of K+1 positions: it resolves every
  block and gives each position's write row and extent ``pos + i + 1``.
  Every layer writes all K+1 positions' K/V (an invalid position, past the
  vpn range, unmapped or of an inactive row, writes the sink slot) and
  reads the pool through the paged-attention kernel with one extent per
  query, the sequential decode's causal mask inside one read;
* **accept** — exact match against the argmax (greedy rows) or against the
  position-folded draw of ``sample_tokens_q`` (sampled rows), so the
  emitted stream is the non-speculative stream's wherever the logits are.
  The history append and the variable-length ``ctx_len`` advance run here
  too.

Rejected tails need no KV rewind: positions at or past the advanced
``ctx_len`` are masked by every later read and rewritten before they are
read.  The engine rewinds what the host sees (``Engine._commit_spec``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import ModelDims, check_family
from .decode import (DecodeSpec, TokenSplit, decode_layers, kv_access,
                     project_logits, step_shard, translate_step)
from .sampling import sample_tokens_q, verify_draft_tokens

# families whose decode state is position-indexed only: a rejected tail
# costs nothing to abandon (recurrent state would need a rollback)
SPEC_FAMILIES = ("dense", "moe", "vlm", "audio")

_I32_MIN = torch.iinfo(torch.int32).min


def _take(hist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``hist`` gathered along its last axis at ``idx >= 0``; an index
    past the end gives int32's minimum, which no history entry equals (the
    JAX package's out-of-bounds fill)."""
    H = hist.shape[1]
    return torch.where(idx < H, hist.gather(1, idx.clamp(max=H - 1)),
                       _I32_MIN)


def propose_ngram_drafts(hist: torch.Tensor, ctx: torch.Tensor, K: int,
                         ngram: int = 2) -> torch.Tensor:
    """Prompt-lookup drafter.

    ``hist (B, H) int32`` holds each slot's tokens with the CURRENT token
    already at position ``ctx[b]`` (unknown positions hold -1).  Returns
    ``(B, K) int32``: the tokens that followed the latest earlier
    occurrence of the history's last ``ngram`` tokens.  Without an earlier
    occurrence, or where the continuation runs past the known history, the
    current token is repeated: any proposal is valid, an unlikely one just
    accepts nothing."""
    B, H = hist.shape
    dev = hist.device
    ctx = ctx.to(torch.int64)[:, None]
    pos = torch.arange(H, device=dev)[None, :]               # candidate end
    match = (pos >= ngram - 1) & (pos < ctx)
    for d in range(ngram):
        suf = _take(hist, (ctx - d).clamp(min=0))            # (B, 1)
        # hist[j - d] by a roll; j >= ngram - 1 >= d masks the wrap
        match = match & (torch.roll(hist, d, dims=1) == suf)
    j_star = torch.where(match, pos, -1).amax(dim=1)         # latest match
    has = (j_star >= 0)[:, None]
    idx = j_star[:, None] + 1 + torch.arange(K, device=dev)[None, :]
    known = idx <= ctx
    gathered = hist.gather(1, idx.clamp(0, H - 1))
    t0 = hist.gather(1, ctx.clamp(0, H - 1))
    drafts = torch.where(has & known, gathered, t0)
    return drafts.clamp(min=0).to(torch.int32)               # -1 guard


def make_spec_decode_step(cfg: ArchConfig, dims: ModelDims,
                          spec: DecodeSpec, num_draft_tokens: int,
                          mesh=None, dtype=torch.float32, ngram: int = 2,
                          bound=None, part=None):
    """Returns spec_step(params, dstate, tokens (B,), active=None, *,
    sample=False) -> (logits (B, K+1, V), dstate, stats).

    ``dstate`` (with its ``hist`` buffer) is updated in place and
    returned.  ``stats`` holds the translation telemetry (as the serve
    step's) and ``acc_tokens (B, K+1)`` / ``n_emit (B,)`` (a row commits
    ``acc_tokens[b, :n_emit[b]]``) and ``draft_tokens (B, K)``, all on the
    device.  ``bound`` is the translation-binding dict shared with the
    serve step (``make_serve_step``); ``mesh`` and ``part`` run it on this
    rank's chunk of the sharded state, as ``make_serve_step`` does."""
    if cfg.family not in SPEC_FAMILIES:
        raise ValueError(
            f"speculative decode does not support family {cfg.family!r} "
            "(recurrent state rollback)")
    check_family(cfg)
    K = int(num_draft_tokens)
    if K < 1:
        raise ValueError(f"num_draft_tokens must be >= 1, got {K}")
    Qw = K + 1
    bound = {} if bound is None else bound   # the translation's bindings
    shard = step_shard(spec, mesh, part)
    if isinstance(shard, TokenSplit):
        raise NotImplementedError(
            "speculative decode is single-host for now; the SPMD serve "
            "path (ROADMAP) drives the non-speculative step")

    def spec_step(params, dstate, tokens, active=None, *, sample=False):
        pos0 = dstate["ctx_len"]                 # the fed token's position
        dev = pos0.device
        act = (torch.ones_like(pos0, dtype=torch.bool) if active is None
               else active.bool())
        t0 = tokens.to(torch.int32)
        hist = dstate["hist"]
        H = hist.shape[1]
        col = torch.arange(H, device=dev)[None, :]
        # the fed token enters the history BEFORE drafting (the drafter
        # matches the n-gram that ends at it); an inactive row, or a
        # position past the history, writes nothing
        here = (col == pos0[:, None]) & act[:, None]
        hist.copy_(torch.where(here, t0[:, None], hist))
        drafts = propose_ngram_drafts(hist, pos0, K, ngram)      # (B, K)
        seq_toks = torch.cat([t0[:, None], drafts], dim=1)       # (B, Qw)
        positions = (pos0[:, None]
                     + torch.arange(Qw, dtype=pos0.dtype, device=dev))

        x = params["embed"]["table"][seq_toks.long()].to(dtype)
        # the step's one translation: every block, and each window
        # position's write row and extent pos + i + 1
        trans = translate_step(dstate["tar"], dstate["sf"], dstate["flex"],
                               pos0, spec, None if active is None else act,
                               bound, window=Qw, shard=shard)
        stats = dict(slots=trans.slots, in_rest=trans.in_rest,
                     mapped=trans.mapped, accesses=trans.accesses,
                     telemetry=trans.telemetry)
        kv_at = kv_access(trans, shard)
        x = decode_layers(params, x, dstate, kv_at, positions, cfg, dims)
        logits = project_logits(params, x, cfg, dims)            # (B,Qw,V)

        # accept: every target draw folds its absolute position, the key
        # the non-speculative step folds there
        if sample:
            tgt = sample_tokens_q(logits, dstate["samp_temp"],
                                  dstate["samp_topk"], dstate["samp_topp"],
                                  dstate["samp_key"], positions)
        else:
            tgt = logits.argmax(dim=-1).to(torch.int32)
        acc_tokens, n_emit = verify_draft_tokens(tgt, drafts)

        # emitted token i sits at position pos + i + 1; rejected tails,
        # inactive rows and positions past the history drop
        off = col - (pos0[:, None] + 1)                          # (B, H)
        emit = (off >= 0) & (off < n_emit[:, None]) & act[:, None]
        hist.copy_(torch.where(
            emit, acc_tokens.gather(1, off.clamp(0, Qw - 1)), hist))
        # the variable-length advance: active rows move by n_emit
        pos0.add_(torch.where(act, n_emit, 0).to(pos0.dtype))
        stats.update(acc_tokens=acc_tokens, n_emit=n_emit,
                     draft_tokens=drafts)
        return logits, dstate, stats

    return spec_step
