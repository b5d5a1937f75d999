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
package rebuilt them functionally): the KV pools ``(L_attn, slots + 1,
bs, KV, hd)`` of the model's attention layers, the TAR/SF/flex
translation tables and ``ctx_len``.  Pool slot ``slots`` (the last one)
is a write sink: a write the JAX package dropped out of bounds (an
inactive row, an unmapped block) lands there instead, which keeps the
step free of host syncs.  No translation ever resolves to it.

The recurrent families add each mamba sublayer's per-row state: ``ssm``
``(n_ssm, B, H, P, N)`` float32 and ``conv`` ``(n_ssm, B, W-1, C)`` in the
model dtype, which every fed token advances (an inactive row keeps its
rows).  The ssm family (mamba2) has no attention layer, hence no pool, no
translation tables and no RSW launch; the hybrid family (jamba) has one
pool layer per group, and the mamba sublayer ``i`` of group ``gi`` owns
state row ``gi * (attn_every - 1) + i``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import normalize
from repro_torch.kernels.utopia_rsw.ops import translate_step_translator
from repro_torch.kernels.utopia_rsw.ref import StepTranslation
from repro_torch.models import layers as Lmod
from repro_torch.models.moe import moe_decode
from repro_torch.models.ssm import MambaCache, mamba_decode_step
from repro_torch.models.transformer import (RECURRENT_FAMILIES, ModelDims,
                                            check_family, ffn_act,
                                            hybrid_ffn_select,
                                            layer_params, n_attn_layers,
                                            take)
from .sampling import sample_tokens


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    block_size: int              # tokens per KV block
    max_blocks_per_seq: int
    slots_per_group: int         # pool slots (the sink comes on top)
    n_sets: int
    assoc: int
    mode: str = "batch"          # batch only (striped: ROADMAP P15)
    hash_name: str = "modulo"
    # prefix-KV chunked prefill: how chunk queries read the installed
    # prefix blocks.  "exact" places the gathered K/V at their absolute
    # positions and reuses the recompute forward's dense softmax
    # (bit-identical to recompute); "paged" is the Q>1 paged-attention
    # read merged with the chunk's own causal part (equal up to float
    # associativity)
    prefix_gather: str = "exact"

    def __post_init__(self):
        if self.prefix_gather not in ("exact", "paged"):
            raise ValueError(f"unknown prefix gather impl "
                             f"{self.prefix_gather!r} (expected 'exact' "
                             "or 'paged')")


def init_decode_state(cfg: ArchConfig, dims: ModelDims, spec: DecodeSpec,
                      batch: int, data_size: int = 1, dtype=torch.float32,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed decode state on ``device`` (flex entries -1 = unmapped): the
    KV pools and translation tables when the model has attention layers,
    the ``ssm``/``conv`` rows when it has mamba sublayers, the
    ``cross_k``/``cross_v`` rows when it is an encoder-decoder."""
    if data_size != 1 or spec.mode != "batch":
        raise NotImplementedError("only the single-device batch layout is "
                                  "ported (sharded serving: ROADMAP P15)")
    check_family(cfg)
    n_attn = n_attn_layers(cfg)
    i32 = dict(dtype=torch.int32, device=device)
    st: Dict[str, torch.Tensor] = {}
    if n_attn:
        pool = (n_attn, spec.slots_per_group + 1, spec.block_size,
                dims.n_kv, dims.head_dim)
        st.update(
            k_pool=torch.zeros(pool, dtype=dtype, device=device),
            v_pool=torch.zeros(pool, dtype=dtype, device=device),
            tar=torch.zeros((1, spec.n_sets, spec.assoc), **i32),
            sf=torch.zeros((1, spec.n_sets), **i32),
            flex=torch.full((1, batch * spec.max_blocks_per_seq), -1,
                            **i32))
    if cfg.family in RECURRENT_FAMILIES:
        md = dims.mamba
        n_ssm = cfg.num_layers - n_attn
        st["ssm"] = torch.zeros((n_ssm, batch, md.n_heads, md.head_dim,
                                 md.d_state), dtype=torch.float32,
                                device=device)
        st["conv"] = torch.zeros((n_ssm, batch, md.conv_width - 1,
                                  md.conv_channels), dtype=dtype,
                                 device=device)
    if cfg.is_encoder_decoder:
        cross = (cfg.num_layers, batch, cfg.frontend_tokens, dims.n_kv,
                 dims.head_dim)
        st["cross_k"] = torch.zeros(cross, dtype=dtype, device=device)
        st["cross_v"] = torch.zeros(cross, dtype=dtype, device=device)
    return {
        **st,
        "ctx_len": torch.zeros((batch,), **i32),
        # per-slot sampling state (serve/sampling.py), scattered at
        # admission; zeros = greedy argmax.  The key data are uint32
        # values held in int64
        "samp_temp": torch.zeros((batch,), dtype=torch.float32,
                                 device=device),
        "samp_topk": torch.zeros((batch,), **i32),
        "samp_topp": torch.zeros((batch,), dtype=torch.float32,
                                 device=device),
        "samp_key": torch.zeros((batch, 2), dtype=torch.int64,
                                device=device),
    }


# ----------------------------------------------- once-per-step translation

def not_ported(what: str, item: str) -> NotImplementedError:
    """The error of a JAX feature that the port does not run yet."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _hybrid_lookup(tar: torch.Tensor, sf: torch.Tensor, flex: torch.Tensor,
                   positions: torch.Tensor, active, spec: DecodeSpec,
                   bound: Dict[tuple, Callable],
                   window: int) -> StepTranslation:
    """Hybrid RSW ∥ flex lookup of the whole step with
    ``translate()``-compatible accounting: the step's only translation
    primitive, ONE launch of the RSW step kernel (its plain version on the
    CPU).  The kernel is bound to the step's geometry, and the tables
    validated, on the first call for a (batch, device, window); ``bound``
    keeps the bindings."""
    key = (positions.shape[0], positions.device, window)
    fn = bound.get(key)
    if fn is None:
        if tar.shape[0] != 1:
            raise not_ported("grouped translation (sharded serving)", "P15")
        fn = bound[key] = translate_step_translator(
            tar, sf, flex, positions, block_size=spec.block_size,
            nblk=spec.max_blocks_per_seq, hash_name=spec.hash_name,
            sink=spec.slots_per_group, window=window)
    return fn(tar, sf, flex, positions, active)


def translate_step(tar: torch.Tensor, sf: torch.Tensor, flex: torch.Tensor,
                   positions: torch.Tensor, spec: DecodeSpec, active=None,
                   bound=None, window: int = 1) -> StepTranslation:
    """Translate every block vpn of every sequence in one launch, and
    derive in the same launch, for each of a row's ``window`` positions
    ``positions + i`` (1 for a decode step, K + 1 for a speculative verify
    step), the write's flat pool row and the attention extent.

    tar (1, n_sets, assoc), sf (1, n_sets), flex (1, B*nblk);
    ``positions`` (B,) the pre-step context lengths (>= 0); ``active``
    (B,) bool or None (all active): an inactive row's writes go to the
    sink slot, as do those that are unmapped or past the vpn range.
    ``bound`` is the caller's dict of bindings (the decode and verify
    steps share one); without it the call binds anew."""
    return _hybrid_lookup(tar, sf, flex, positions, active, spec,
                          {} if bound is None else bound, window)


# ------------------------------------------------------ paged attention

def _paged_attn_local(q, k_new, v_new, kp_l, vp_l, slots, w_row, extent):
    """Write the new tokens' K/V at their precomputed flat pool rows
    ``w_row`` (B[, Q]) int64 (in place; an invalid write goes to the sink
    slot's row) and attend over the resolved blocks ``slots`` (B, nblk) up
    to ``extent`` (B[, Q]), one extent per query, through the
    paged-attention kernel: all three come from the step's translation.
    Returns the normalized output (B[, Q], H, hd) in q's dtype.

    Several invalid writes of one call may land on the same sink row;
    which of them wins is undefined on the card, which is harmless
    because no translation resolves to the sink slot."""
    rows = (w_row,)
    kp_l.view(-1, *kp_l.shape[2:]).index_put_(rows, k_new.to(kp_l.dtype))
    vp_l.view(-1, *vp_l.shape[2:]).index_put_(rows, v_new.to(vp_l.dtype))
    o, m, l = paged_attention(q, kp_l, vp_l, slots, extent)
    return normalize(o, l).to(q.dtype)


# ------------------------------------------------ shared decode sublayers
#
# A verify step's (B, Q, ...) activations hold the rows that Q decode steps
# would compute B at a time.  A GEMM or a reduction may round a row
# otherwise at B * Q rows than at B, so the ops found to do so on the card
# (the K/V projections, whose rows enter the pool, and the RMS norms' mean
# square) run at the decode step's shape, one window position at a time,
# and every other projection does so where its GEMM rounds a row otherwise
# at B * Q rows (``decode_linear``).

def _per_position(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of a decode step's ``(B, ...)`` ``x``; a verify step's
    ``(B, Q, ...)`` ``x`` goes through ``fn`` one window position at a
    time, each a contiguous ``(B, ...)`` tensor (one copy makes them all),
    and is stacked back."""
    if x.dim() == 2:
        return fn(x)
    xt = x.transpose(0, 1).contiguous()
    return torch.stack([fn(xt[i]) for i in range(xt.shape[0])], 1)


# (weight shape, strides, dtype, device, B, Q) -> whether the GEMM rounds
# each row at B * Q rows as at B rows (``_rows_invariant``)
_ROWS_INVARIANT: Dict[tuple, bool] = {}


def _rows_invariant(w: torch.Tensor, B: int, Q: int) -> bool:
    """Whether ``x @ w`` at B * Q rows gives each row the bits it gets at
    B rows.  The BLAS library picks its kernel by shape, and one that
    splits the reduction at one row count and not at the other (as
    cuBLAS does for paligemma-3b's MLP at 4 rows) rounds every row
    otherwise.  Probed once per weight layout and (B, Q), on seeded
    random rows."""
    key = (tuple(w.shape), w.stride(), w.dtype, w.device, B, Q)
    hit = _ROWS_INVARIANT.get(key)
    if hit is None:
        gen = torch.Generator(device=w.device).manual_seed(0)
        x = torch.randn((B * Q, w.shape[0]), generator=gen, device=w.device,
                        dtype=torch.float32).to(w.dtype)
        wide = x @ w
        hit = all(torch.equal(x[i * B:(i + 1) * B] @ w,
                              wide[i * B:(i + 1) * B]) for i in range(Q))
        _ROWS_INVARIANT[key] = hit
    return hit


def probe_verify_gemms(params, cfg: ArchConfig, B: int, Q: int,
                       dtype) -> None:
    """Probe (``_rows_invariant``) each GEMM that a verify step at (B, Q)
    in ``dtype`` sends through ``decode_linear`` or the head, so that the
    step finds every outcome cached and probes nothing itself (no host
    sync).  Every layer's weights are views of one stacked tensor, so
    layer 0's layouts stand for all.  ``Engine`` calls it when it sets up
    speculative decoding."""
    blk = layer_params(params, 0)
    ps = [blk["attn"]["q"], blk["attn"]["o"]]
    ps += [blk["mlp"][k] for k in ("gate", "up", "down") if "mlp" in blk]
    ps += [blk["cross"][k] for k in ("q", "o") if "cross" in blk]
    for p in ps:
        _rows_invariant(p["w"].to(dtype), B, Q)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    _rows_invariant(head["table"].T.to(dtype), B, Q)


def verify_gemm_probes() -> Dict[tuple, bool]:
    """Every GEMM layout probed so far, ``(weight shape, strides, dtype,
    device, B, Q)``, and whether it rounds each row at B * Q rows as at B
    rows (False: the verify step runs it one window position at a
    time)."""
    return dict(_ROWS_INVARIANT)


def decode_linear(p, x: torch.Tensor) -> torch.Tensor:
    """``Lmod.linear`` of a decode step's (B, d) ``x``, or of a verify
    step's (B, Q, d) ``x``: at B * Q rows where that GEMM rounds a row as
    it does at B rows, else one window position at a time."""
    if x.dim() == 2 or _rows_invariant(p["w"].to(x.dtype), *x.shape[:2]):
        return Lmod.linear(p, x)
    return _per_position(lambda t: Lmod.linear(p, t), x)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor,
              eps: float) -> torch.Tensor:
    """``Lmod.rms_norm`` with the mean square taken per position (the
    square itself is elementwise)."""
    if x.dim() == 2:
        return Lmod.rms_norm(x, scale, eps)
    x32 = x.float()
    var = _per_position(lambda t: t.mean(dim=-1, keepdim=True), x32.square())
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def decode_ffn(blk, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Post-attention FFN sublayer: the dense MLP (its projections through
    ``decode_linear``), or the decode-time MoE over every row of ``x`` (B,
    d) or (B, Q, d).  The MoE's float32
    router runs one window position at a time, at the decode step's
    shape: a flipped near-tie there would pick another expert; its
    experts read every row at once (their rows round alike at both
    shapes, ``chip_smoke.py`` phase 8)."""
    h = _rms_norm(x, blk["norm2"], cfg.norm_eps)
    act = ffn_act(cfg)
    if "moe" not in blk:
        p = blk["mlp"]
        g = act(decode_linear(p["gate"], h)) * decode_linear(p["up"], h)
        return x + decode_linear(p["down"], g)
    p = blk["moe"]
    w = p["router"]["w"]
    logits = _per_position(lambda t: t.float() @ w, h)
    d = h.shape[-1]
    out = moe_decode(p, h.reshape(-1, d), top_k=cfg.moe_top_k,
                     logits=logits.reshape(-1, logits.shape[-1]), act=act)
    return x + out.reshape(h.shape)


def decode_mamba(blk, x: torch.Tensor, dstate, j: int, act,
                 cfg: ArchConfig, dims: ModelDims) -> torch.Tensor:
    """The mamba sublayer of a decode step: one token a row (``x`` (B,
    d)) advances state row ``j`` of ``dstate["ssm"]``/``["conv"]`` in
    place; an inactive row (``act`` (B,) bool, None = all active) keeps
    its rows."""
    h = Lmod.rms_norm(x, blk["norm1"], cfg.norm_eps)
    ssm, conv = dstate["ssm"][j], dstate["conv"][j]
    out, cache = mamba_decode_step(blk["mamba"], h,
                                   MambaCache(conv=conv, state=ssm),
                                   dims.mamba)
    new_state, new_conv = cache.state, cache.conv
    if act is not None:
        new_state = torch.where(act[:, None, None, None], new_state, ssm)
        new_conv = torch.where(act[:, None, None], new_conv, conv)
    ssm.copy_(new_state)
    conv.copy_(new_conv)
    return x + out


def _cross_core(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                dims: ModelDims) -> torch.Tensor:
    """Attention of ``q (B, H * hd)`` over a row's cross K/V ``(B, F, KV,
    hd)``: scores, softmax and products in float32; returns ``(B, H *
    hd)`` float32."""
    B = q.shape[0]
    g = dims.n_heads // dims.n_kv
    qf = q.reshape(B, dims.n_kv, g, dims.head_dim).float()
    s = torch.einsum("bkgd,bfkd->bkgf", qf, ck.float())
    p = torch.softmax(s / math.sqrt(dims.head_dim), dim=-1)
    return torch.einsum("bkgf,bfkd->bkgd", p, cv.float()).reshape(B, -1)


def decode_cross(blk, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 cfg: ArchConfig, dims: ModelDims) -> torch.Tensor:
    """The audio decoder's cross-attention sublayer over the slots'
    installed cross K/V ``(B, F, KV, hd)``, for ``x`` (B, d) of a decode
    step or (B, Q, d) of a verify step.  The verify step takes the norm's
    mean square and the attention itself one window position at a time,
    at the decode step's shape, so its rows are bitwise the decode
    step's; the q and o projections go through ``decode_linear``."""
    lead = x.shape[:-1]
    h = _rms_norm(x, blk["norm_x"], cfg.norm_eps)
    q = decode_linear(blk["cross"]["q"], h)
    o = _per_position(lambda t: _cross_core(t, ck, cv, dims), q)
    o = o.reshape(*lead, -1).to(x.dtype)
    return x + decode_linear(blk["cross"]["o"], o)


def project_logits(params, x: torch.Tensor, cfg: ArchConfig,
                   dims: ModelDims) -> torch.Tensor:
    """Final norm -> (tied) head matmul -> vocab-pad mask."""
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if x.dim() == 3 and not _rows_invariant(
            head["table"].T.to(x.dtype), *x.shape[:2]):
        return _per_position(
            lambda t: Lmod.unembed(head, t, dims.logical_vocab), x)
    return Lmod.unembed(head, x, dims.logical_vocab)


def decode_attn(blk, x: torch.Tensor, kp_l: torch.Tensor,
                vp_l: torch.Tensor, kv_at, positions: torch.Tensor,
                cfg: ArchConfig, dims: ModelDims) -> torch.Tensor:
    """The attention sublayer of a decode step (one token a row: ``x``
    (B, d), ``positions`` (B,)) or of a verify step (Q tokens a row: ``x``
    (B, Q, d), ``positions`` (B, Q)): project, rotate, write every token's
    K/V and read the pool through the paged-attention kernel.  ``kv_at``
    is the step translation's ``(slots, w_row, extent)``, shaped like
    ``positions`` past the slots; the verify's per-query extents are the
    sequential decode's causal mask inside one pool read.

    The verify step projects K and V (and takes the norm's mean square) one
    window position at a time, at the decode step's shape, so the rows it
    writes to the pool are bitwise the decode step's and spec-on streams
    stay spec-off's; q and o go through ``decode_linear``."""
    lead = x.shape[:-1]
    B = lead[0]
    H, KV, hd = dims.n_heads, dims.n_kv, dims.head_dim
    h = _rms_norm(x, blk["norm1"], cfg.norm_eps)
    q = decode_linear(blk["attn"]["q"], h).reshape(*lead, H, hd)
    k = _per_position(lambda t: Lmod.linear(blk["attn"]["k"], t),
                      h).reshape(*lead, KV, hd)
    v = _per_position(lambda t: Lmod.linear(blk["attn"]["v"], t),
                      h).reshape(*lead, KV, hd)
    if cfg.rope_theta > 0:
        pos = positions.reshape(B, -1)
        q = Lmod.apply_rope(q.reshape(B, -1, H, hd), pos,
                            cfg.rope_theta).reshape(q.shape)
        k = Lmod.apply_rope(k.reshape(B, -1, KV, hd), pos,
                            cfg.rope_theta).reshape(k.shape)
    out = _paged_attn_local(q, k, v, kp_l, vp_l, *kv_at)
    o = decode_linear(blk["attn"]["o"], out.reshape(*lead, -1).to(x.dtype))
    return x + o


def decode_layers(params, x: torch.Tensor, dstate, kv_at,
                  positions: torch.Tensor, cfg: ArchConfig,
                  dims: ModelDims) -> torch.Tensor:
    """The layer loop of the dense, moe, vlm and audio families, shared
    by the decode step (``x`` (B, d)) and the verify step (``x`` (B, Q,
    d)): per layer the attention sublayer on pool layer ``i``, the audio
    decoder's cross sublayer over ``dstate["cross_k"/"cross_v"][i]``, and
    the FFN."""
    cross = cfg.family == "audio"
    for i in range(cfg.num_layers):
        blk = layer_params(params, i)
        x = decode_attn(blk, x, dstate["k_pool"][i], dstate["v_pool"][i],
                        kv_at, positions, cfg, dims)
        if cross:
            x = decode_cross(blk, x, dstate["cross_k"][i],
                             dstate["cross_v"][i], cfg, dims)
        x = decode_ffn(blk, x, cfg)
    return x


# --------------------------------------------------------- full serve step

def make_serve_step(cfg: ArchConfig, dims: ModelDims, spec: DecodeSpec,
                    dtype=torch.float32, bound=None):
    """Returns serve_step(params, dstate, tokens (B,), active=None, *,
    sample=False) -> (logits (B, V), dstate, stats).  One new token per
    live sequence.

    ``dstate`` is updated in place and returned.  ``stats`` holds the
    step's translation telemetry (``slots`` / ``in_rest`` / ``mapped`` /
    ``accesses``, group-major, and ``telemetry``, the last three as one
    int32 block) and ``next_token`` (B,) int32: the argmax, or with
    ``sample=True`` each slot's sampled token (greedy slots still take the
    argmax), the key folded with the pre-step position.  ``active`` (B,)
    bool marks the slots decoding this step: inactive slots neither write
    their current KV block nor advance ``ctx_len`` (None = all
    active).  ``bound`` is a dict of translation bindings to share with a
    speculative verify step (``serve/spec_decode.py``).

    A model without attention layers (ssm) translates nothing: ``stats``
    then holds ``next_token`` only.  The hybrid family runs its groups'
    sublayers in order, the attention sublayer of group ``gi`` on pool
    layer ``gi``."""
    check_family(cfg)
    bound = {} if bound is None else bound   # the translation's bindings
    n_attn = n_attn_layers(cfg)
    fam = cfg.family

    def serve_step(params, dstate, tokens, active=None, *, sample=False):
        positions = dstate["ctx_len"]
        act = None if active is None else active.bool()
        x = params["embed"]["table"][tokens.long()].to(dtype)
        stats = {}
        if n_attn:
            trans = translate_step(dstate["tar"], dstate["sf"],
                                   dstate["flex"], positions, spec, act,
                                   bound)
            stats = dict(slots=trans.slots, in_rest=trans.in_rest,
                         mapped=trans.mapped, accesses=trans.accesses,
                         telemetry=trans.telemetry)
            kv_at = (trans.slots[0], trans.w_row, trans.extent)
        if fam == "ssm":
            for i in range(cfg.num_layers):
                x = decode_mamba(layer_params(params, i), x, dstate, i, act,
                                 cfg, dims)
        elif fam == "hybrid":
            g = cfg.attn_every
            for gi in range(cfg.num_layers // g):
                blk = layer_params(params, gi)
                for i in range(g):
                    if i < g - 1:
                        x = decode_mamba(take(blk["mamba"], i), x, dstate,
                                         gi * (g - 1) + i, act, cfg, dims)
                    else:
                        x = decode_attn(blk["attn"], x, dstate["k_pool"][gi],
                                        dstate["v_pool"][gi], kv_at,
                                        positions, cfg, dims)
                    x = decode_ffn(hybrid_ffn_select(cfg, blk, i), x, cfg)
        else:
            x = decode_layers(params, x, dstate, kv_at, positions, cfg,
                              dims)
        logits = project_logits(params, x, cfg, dims)
        if sample:
            stats["next_token"] = sample_tokens(
                logits, dstate["samp_temp"], dstate["samp_topk"],
                dstate["samp_topp"], dstate["samp_key"], positions)
        else:
            stats["next_token"] = logits.argmax(dim=-1).to(torch.int32)
        # only active slots advance (in place, after every read above)
        dstate["ctx_len"].add_(1 if act is None else act)
        return logits, dstate, stats

    return serve_step
