"""Single-device decode step: hybrid-translated paged attention.

Translation (the paper's technique) runs exactly once per step:
``translate_step`` resolves every block vpn of every sequence, plus the
block being written, in ONE launch of the RSW step kernel before the layer
loop.  The same launch emits the per-vpn telemetry (``in_rest`` /
``accesses`` / ``mapped``, one int32 block) that the engine feeds back to
the promotion policy, and per row the flat pool row of the new token's K/V
and the attention extent.  Every attention layer then only writes the new
token's K/V at that row and runs the paged-attention kernel over the
pre-resolved slots: no device op of the layer loop prepares either.

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
from typing import Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import normalize
from repro_torch.kernels.utopia_rsw.ops import translate_step_translator
from repro_torch.kernels.utopia_rsw.ref import StepTranslation
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

def _hybrid_lookup(tar: torch.Tensor, sf: torch.Tensor, flex: torch.Tensor,
                   positions: torch.Tensor, active, spec: DecodeSpec,
                   bound: Dict[tuple, Callable]) -> StepTranslation:
    """Hybrid RSW ∥ flex lookup of the whole step with
    ``translate()``-compatible accounting: the step's only translation
    primitive, ONE launch of the RSW step kernel (its plain version on the
    CPU).  The kernel is bound to the step's geometry, and the tables
    validated, on the first call for a (batch, device); ``bound`` keeps
    the bindings."""
    key = (positions.shape[0], positions.device)
    fn = bound.get(key)
    if fn is None:
        if tar.shape[0] != 1:
            raise NotImplementedError("grouped translation is sharded "
                                      "serving (ROADMAP P15)")
        fn = bound[key] = translate_step_translator(
            tar, sf, flex, positions, block_size=spec.block_size,
            nblk=spec.max_blocks_per_seq, hash_name=spec.hash_name,
            sink=spec.slots_per_group)
    return fn(tar, sf, flex, positions, active)


def translate_step(tar: torch.Tensor, sf: torch.Tensor, flex: torch.Tensor,
                   positions: torch.Tensor, spec: DecodeSpec, active=None,
                   bound=None) -> StepTranslation:
    """Translate every block vpn of every sequence, plus each sequence's
    current (write) block, in one launch, and derive in the same launch the
    write's flat pool row and the attention extent.

    tar (1, n_sets, assoc), sf (1, n_sets), flex (1, B*nblk);
    ``positions`` (B,) the pre-step context lengths (>= 0); ``active``
    (B,) bool or None (all active): an inactive row's write goes to the
    sink slot, as does one that is unmapped or past its vpn range.
    ``bound`` is the caller's dict of bindings (the decode step keeps one);
    without it the call binds anew."""
    return _hybrid_lookup(tar, sf, flex, positions, active, spec,
                          {} if bound is None else bound)


# ------------------------------------------------------ paged attention

def _paged_attn_local(q, k_new, v_new, kp_l, vp_l, slots, w_row, extent):
    """Write the new token's K/V at its precomputed flat pool row ``w_row``
    (B,) int64 (in place; an invalid row writes the sink slot's row) and
    attend over the resolved blocks ``slots`` (B, nblk) up to ``extent``
    (B,) through the paged-attention kernel: all three come from the
    step's translation.  Returns the normalized output (B, H, hd) in q's
    dtype."""
    rows = (w_row,)
    kp_l.view(-1, *kp_l.shape[2:]).index_put_(rows, k_new.to(kp_l.dtype))
    vp_l.view(-1, *vp_l.shape[2:]).index_put_(rows, v_new.to(vp_l.dtype))
    o, m, l = paged_attention(q, kp_l, vp_l, slots, extent)
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
    ``accesses``, group-major, and ``telemetry``, the last three as one
    int32 block) and the greedy ``next_token`` (B,) int32.
    ``active`` (B,) bool marks the slots decoding this step: inactive
    slots neither write their current KV block nor advance ``ctx_len``
    (None = all active)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP P10)")
    H, KV, hd = dims.n_heads, dims.n_kv, dims.head_dim
    bound = {}                       # the translation's bindings

    def attn_sublayer(blk, x, kp_l, vp_l, kv_at, positions):
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
        out = _paged_attn_local(q, k, v, kp_l, vp_l, *kv_at)
        o = Lmod.linear(blk["attn"]["o"], out.reshape(B, -1).to(x.dtype))
        return x + o

    def serve_step(params, dstate, tokens, active=None):
        positions = dstate["ctx_len"]
        act = None if active is None else active.bool()
        x = params["embed"]["table"][tokens.long()].to(dtype)
        trans = translate_step(dstate["tar"], dstate["sf"], dstate["flex"],
                               positions, spec, act, bound)
        stats = dict(slots=trans.slots, in_rest=trans.in_rest,
                     mapped=trans.mapped, accesses=trans.accesses,
                     telemetry=trans.telemetry)
        kv_at = (trans.slots[0], trans.w_row, trans.extent)
        for i in range(cfg.num_layers):
            blk = layer_params(params, i)
            x = attn_sublayer(blk, x, dstate["k_pool"][i],
                              dstate["v_pool"][i], kv_at, positions)
            x = decode_ffn(blk, x, cfg)
        logits = project_logits(params, x, cfg, dims)
        stats["next_token"] = logits.argmax(dim=-1).to(torch.int32)
        # only active slots advance (in place, after every read above)
        dstate["ctx_len"].add_(1 if act is None else act)
        return logits, dstate, stats

    return serve_step
