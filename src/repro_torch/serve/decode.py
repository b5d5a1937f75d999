"""Single-device decode step: hybrid-translated paged attention.

Translation (the paper's technique) runs exactly once per step:
``translate_step`` resolves every block vpn of every sequence, plus the
block being written, in ONE launch of the RSW kernel before the layer
loop; the resolved slot table then flows into every attention layer, which
only writes the new token's K/V and runs the paged-attention kernel over
pre-resolved slots.  The same launch emits the per-vpn telemetry
(``in_rest`` / ``accesses`` / ``mapped``) the engine feeds back to the
promotion policy.

The decode state is a dict of device tensors updated IN PLACE (the JAX
package rebuilt them functionally): the per-layer KV pools
``(L, slots + 1, bs, KV, hd)``, the TAR/SF/flex translation tables and
``ctx_len``.  Pool slot ``slots`` (the last one) is a write sink: a write
the JAX package dropped out of bounds (an inactive row, an unmapped
block) lands there instead, which keeps the step free of host syncs.  No
translation ever resolves to it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import normalize
from repro_torch.kernels.utopia_rsw.ops import utopia_rsw
from repro_torch.models import layers as Lmod
from repro_torch.models.transformer import ModelDims, layer_params


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    block_size: int              # tokens per KV block
    max_blocks_per_seq: int
    slots_per_group: int         # pool slots (the sink comes on top)
    n_sets: int
    assoc: int
    mode: str = "batch"          # batch only (striped: ROADMAP P15)
    hash_name: str = "modulo"


def init_decode_state(cfg: ArchConfig, dims: ModelDims, spec: DecodeSpec,
                      batch: int, data_size: int = 1, dtype=torch.float32,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed decode state on ``device`` (flex entries -1 = unmapped)."""
    if data_size != 1 or spec.mode != "batch":
        raise NotImplementedError("only the single-device batch layout is "
                                  "ported (sharded serving: ROADMAP P15)")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP P10)")
    pool = (cfg.num_layers, spec.slots_per_group + 1, spec.block_size,
            dims.n_kv, dims.head_dim)
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "k_pool": torch.zeros(pool, dtype=dtype, device=device),
        "v_pool": torch.zeros(pool, dtype=dtype, device=device),
        "tar": torch.zeros((1, spec.n_sets, spec.assoc), **i32),
        "sf": torch.zeros((1, spec.n_sets), **i32),
        "flex": torch.full((1, batch * spec.max_blocks_per_seq), -1, **i32),
        "ctx_len": torch.zeros((batch,), **i32),
    }


# ----------------------------------------------- once-per-step translation

class StepTranslation(NamedTuple):
    """Result of the single hybrid translation of a decode step.

    Group-major like the JAX package's (``G == 1`` on one device)."""

    slots: torch.Tensor     # (G, B, nblk) int32 resolved pool slot, -1
    w_slot: torch.Tensor    # (G, B) int32 slot of the block being written
    w_valid: torch.Tensor   # (G, B) bool: mapped, in range (and active)
    in_rest: torch.Tensor   # (G, B, nblk) bool — resolved by the RSW
    mapped: torch.Tensor    # (G, B, nblk) bool
    accesses: torch.Tensor  # (G, B, nblk) int32 structure accesses
    vpns: torch.Tensor      # (B, nblk) int32 vpn grid


def _hybrid_lookup(vpns: torch.Tensor, tar: torch.Tensor, sf: torch.Tensor,
                   flex_flat: torch.Tensor, hash_name: str):
    """Hybrid RSW ∥ flex lookup with ``translate()``-compatible accounting:
    the step's only translation primitive, one RSW kernel launch.
    Returns (slot, in_rest, mapped, accesses), each shaped like ``vpns``."""
    slot, in_rest, mapped, accesses = utopia_rsw(vpns, tar, sf, flex_flat,
                                                 hash_name=hash_name)
    return slot, in_rest.bool(), mapped.bool(), accesses


def translate_step(tar: torch.Tensor, sf: torch.Tensor, flex: torch.Tensor,
                   positions: torch.Tensor, spec: DecodeSpec
                   ) -> StepTranslation:
    """Translate every block vpn of every sequence, plus each sequence's
    current (write) block, in one dispatch.

    tar (1, n_sets, assoc), sf (1, n_sets), flex (1, B*nblk);
    ``positions`` (B,) the pre-step context lengths (>= 0)."""
    if tar.shape[0] != 1:
        raise NotImplementedError("grouped translation is sharded serving "
                                  "(ROADMAP P15)")
    nblk, bs = spec.max_blocks_per_seq, spec.block_size
    B = positions.shape[0]
    dev = positions.device
    seq = torch.arange(B, dtype=torch.int32, device=dev)
    grid = (seq[:, None] * nblk
            + torch.arange(nblk, dtype=torch.int32, device=dev)[None, :])
    cur_block = positions // bs
    # an idle slot's position can run past its vpn range; without the clamp
    # its write vpn would alias ANOTHER sequence's block
    in_range = cur_block < nblk
    cur_vpn = seq * nblk + cur_block.clamp(max=nblk - 1)
    n_read = B * nblk
    queries = torch.cat([grid.reshape(-1), cur_vpn.to(torch.int32)])
    slot, hit, mapped, acc = _hybrid_lookup(queries, tar[0], sf[0], flex[0],
                                            spec.hash_name)
    shape3 = (1, B, nblk)
    return StepTranslation(
        slots=slot[:n_read].reshape(shape3),
        w_slot=slot[n_read:][None],
        w_valid=(mapped[n_read:] & in_range)[None],
        in_rest=hit[:n_read].reshape(shape3),
        mapped=mapped[:n_read].reshape(shape3),
        accesses=acc[:n_read].reshape(shape3),
        vpns=grid,
    )


# ------------------------------------------------------ paged attention

def _paged_attn_local(q, k_new, v_new, kp_l, vp_l, trans: StepTranslation,
                      pos, spec: DecodeSpec):
    """Write the new token's K/V into its pre-resolved slot (in place; an
    invalid row writes the sink slot) and attend over the resolved blocks
    through the paged-attention kernel.  Returns the normalized output
    (B, H, hd) in q's dtype."""
    slots = trans.slots[0]
    w_slot, w_valid = trans.w_slot[0], trans.w_valid[0]
    sink = kp_l.shape[0] - 1
    ws = torch.where(w_valid, w_slot, sink).long()
    t = (pos % spec.block_size).long()
    kp_l[ws, t] = k_new.to(kp_l.dtype)
    vp_l[ws, t] = v_new.to(vp_l.dtype)
    o, m, l = paged_attention(q, kp_l, vp_l, slots, pos + 1)
    return normalize(o, l).to(q.dtype)


# ------------------------------------------------ shared decode sublayers

def decode_ffn(blk, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Post-attention FFN sublayer (dense MLP)."""
    h = Lmod.rms_norm(x, blk["norm2"], cfg.norm_eps)
    return x + Lmod.mlp(blk["mlp"], h)


def project_logits(params, x: torch.Tensor, cfg: ArchConfig,
                   dims: ModelDims) -> torch.Tensor:
    """Final norm -> (tied) head matmul -> vocab-pad mask."""
    x = Lmod.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return Lmod.unembed(head, x, dims.logical_vocab)


# --------------------------------------------------------- full serve step

def make_serve_step(cfg: ArchConfig, dims: ModelDims, spec: DecodeSpec,
                    dtype=torch.float32):
    """Returns serve_step(params, dstate, tokens (B,), active=None) ->
    (logits (B, V), dstate, stats).  One new token per live sequence.

    ``dstate`` is updated in place and returned.  ``stats`` holds the
    step's translation telemetry (``slots`` / ``in_rest`` / ``mapped`` /
    ``accesses``, group-major) and the greedy ``next_token`` (B,) int32.
    ``active`` (B,) bool marks the slots decoding this step: inactive
    slots neither write their current KV block nor advance ``ctx_len``
    (None = all active)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP P10)")
    H, KV, hd = dims.n_heads, dims.n_kv, dims.head_dim

    def attn_sublayer(blk, x, kp_l, vp_l, trans, positions):
        B = x.shape[0]
        h = Lmod.rms_norm(x, blk["norm1"], cfg.norm_eps)
        q = Lmod.linear(blk["attn"]["q"], h).reshape(B, H, hd)
        k = Lmod.linear(blk["attn"]["k"], h).reshape(B, KV, hd)
        v = Lmod.linear(blk["attn"]["v"], h).reshape(B, KV, hd)
        if cfg.rope_theta > 0:
            q = Lmod.apply_rope(q[:, None], positions[:, None],
                                cfg.rope_theta)[:, 0]
            k = Lmod.apply_rope(k[:, None], positions[:, None],
                                cfg.rope_theta)[:, 0]
        out = _paged_attn_local(q, k, v, kp_l, vp_l, trans, positions, spec)
        o = Lmod.linear(blk["attn"]["o"], out.reshape(B, -1).to(x.dtype))
        return x + o

    def serve_step(params, dstate, tokens, active=None):
        positions = dstate["ctx_len"]
        act = (torch.ones_like(positions, dtype=torch.bool) if active is None
               else active.bool())
        x = params["embed"]["table"][tokens.long()].to(dtype)
        trans = translate_step(dstate["tar"], dstate["sf"], dstate["flex"],
                               positions, spec)
        trans = trans._replace(w_valid=trans.w_valid & act[None])
        stats = dict(slots=trans.slots, in_rest=trans.in_rest,
                     mapped=trans.mapped, accesses=trans.accesses)
        for i in range(cfg.num_layers):
            blk = layer_params(params, i)
            x = attn_sublayer(blk, x, dstate["k_pool"][i],
                              dstate["v_pool"][i], trans, positions)
            x = decode_ffn(blk, x, cfg)
        logits = project_logits(params, x, cfg, dims)
        stats["next_token"] = logits.argmax(dim=-1).to(torch.int32)
        # only active slots advance (in place, after every read above)
        dstate["ctx_len"] += act.to(torch.int32)
        return logits, dstate, stats

    return serve_step
