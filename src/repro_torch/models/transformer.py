"""The models of the port's six families in torch.

``forward`` mirrors ``repro.models.transformer.forward``: a loop over the
stacked layers (leading layer axis, as ``params.init_params`` lays them
out), returning ``(logits, aux, caches)``; ``opt.collect_cache``
additionally returns what the serving engine installs — the per-layer
K/V for the hybrid-translated KV pool, each mamba sublayer's SSM state
and conv tail, and the audio decoder's cross-attention K/V.  Attention
goes through ``attention(impl=opt.attn_impl)``: with ``"pallas"`` (alias
``"flash"``) a CUDA tensor runs the flash kernel and a CPU tensor its
plain version; ``"flash_jax"`` runs the chunked eager attention.  A
layer whose parameters hold ``"moe"`` runs the MoE FFN (``models/moe.py``)
in place of the MLP, and ``aux`` sums its losses over the layers.

* dense / moe: every layer is causal self-attention then the FFN.
* vlm (paligemma): the dense body over ``frontend_proj(frontend)``
  prepended to the token embeddings (causally masked, as the JAX package
  masks it); the frontend positions are sliced off before the head.
* audio (whisper): an encoder (non-causal self-attention without RoPE,
  then the FFN, a final norm) over ``frontend_proj(frontend)``, and a
  decoder whose layers add, between self-attention and the FFN, a
  cross-attention sublayer (``norm_x``, ``cross``) over the encoder
  output.
* ssm (mamba2): every layer is ``x + mamba(norm1(x))``, no FFN.
* hybrid (jamba): the layers form groups of ``cfg.attn_every``
  sublayers, ``attn_every - 1`` mamba sublayers then one attention
  sublayer, each followed by an FFN (the MoE on ``cfg.moe_on_layer(i)``
  of the group-local index ``i``, else the MLP; ``hybrid_ffn_select``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, resolve
from . import layers as L
from .attention import attention
from .moe import moe_layer
from .ssm import MambaCache, MambaDims, mamba_dims, mamba_forward

# the families the port runs
FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")
RECURRENT_FAMILIES = ("ssm", "hybrid")


class ModelDims(NamedTuple):
    n_heads: int
    n_kv: int
    head_dim: int
    vocab: int            # padded
    logical_vocab: int
    d_ff: int
    mamba: Optional[MambaDims]
    tp: int


def model_dims(cfg: ArchConfig, tp: int = 1) -> ModelDims:
    r = resolve(cfg, tp)
    md = None
    if cfg.family in RECURRENT_FAMILIES:
        md = mamba_dims(cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
                        cfg.ssm_expand, cfg.ssm_conv_width, tp=tp)
    return ModelDims(n_heads=r.num_heads, n_kv=r.num_kv_heads,
                     head_dim=cfg.resolved_head_dim, vocab=r.vocab_size,
                     logical_vocab=cfg.vocab_size, d_ff=r.d_ff, mamba=md,
                     tp=tp)


def n_attn_layers(cfg: ArchConfig) -> int:
    """Attention layers of the model: the KV pool's layer count."""
    return sum(cfg.attn_on_layer(i) for i in range(cfg.num_layers))


@dataclasses.dataclass(frozen=True)
class FwdOptions:
    attn_impl: str = "dense"           # dense | flash_jax | pallas (flash)
    dtype: Any = torch.float32
    q_chunk: int = 512                 # flash_jax's chunks
    kv_chunk: int = 512
    triangular_schedule: bool = False
    collect_cache: bool = False        # prefill: emit per-layer caches
    moe_groups: int = 1                # MoE dispatch groups (1 only)


def take(tree, i: int):
    """Entry ``i`` of every leaf of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: take(v, i) for k, v in tree.items()}
    return tree[i]


def layer_params(params, i: int) -> Dict[str, Any]:
    """Layer ``i``'s parameters (group ``i``'s in the hybrid family):
    views into the stacked layer tensors."""
    return take(params["layers"], i)


def _self_attn(blk, x, cfg: ArchConfig, dims: ModelDims, opt: FwdOptions,
               causal: bool = True):
    """Self-attention sublayer; ``causal=False`` is the audio encoder's
    (full mask, no RoPE)."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None, :]
    h = L.rms_norm(x, blk["norm1"], cfg.norm_eps)
    theta = cfg.rope_theta if causal else 0.0
    q, k, v = L.qkv_project(blk["attn"], h, h, dims.n_heads, dims.n_kv,
                            dims.head_dim, pos, pos, theta)
    o = attention(q, k, v, impl=opt.attn_impl, causal=causal,
                  q_chunk=opt.q_chunk, kv_chunk=opt.kv_chunk,
                  triangular_schedule=opt.triangular_schedule)
    o = L.linear(blk["attn"]["o"], o.reshape(B, S, -1))
    return x + o, (k, v)


def _cross_attn(blk, x, enc_out, cfg: ArchConfig, dims: ModelDims,
                opt: FwdOptions):
    """The audio decoder's cross-attention sublayer over the encoder
    output (no RoPE, full mask): ``(x + o, (ck, cv))``."""
    B, S, _ = x.shape
    h = L.rms_norm(x, blk["norm_x"], cfg.norm_eps)
    q, ck, cv = L.qkv_project(blk["cross"], h, enc_out, dims.n_heads,
                              dims.n_kv, dims.head_dim, None, None, 0.0)
    o = attention(q, ck, cv, impl=opt.attn_impl, causal=False,
                  q_chunk=opt.q_chunk, kv_chunk=opt.kv_chunk)
    return x + L.linear(blk["cross"]["o"], o.reshape(B, S, -1)), (ck, cv)


def encoder(params, frames: torch.Tensor, cfg: ArchConfig, dims: ModelDims,
            opt: FwdOptions):
    """The audio encoder: ``frontend_proj`` of the frame embeddings ``(B,
    F, d)``, then per layer non-causal self-attention and the FFN, then
    the encoder's final norm.  Returns ``(B, F, d)`` in ``opt.dtype``."""
    x = L.linear(params["frontend_proj"], frames.to(opt.dtype))
    enc = params["encoder"]
    for i in range(cfg.encoder_layers):
        blk = layer_params(enc, i)
        x, _ = _self_attn(blk, x, cfg, dims, opt, causal=False)
        x, _ = _ffn(blk, x, cfg, opt)
    return L.rms_norm(x, enc["final_norm"], cfg.norm_eps)


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family neither package knows."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} (expected "
                         f"one of {', '.join(FAMILIES)})")


def ffn_act(cfg: ArchConfig):
    """The FFN gate's activation: ``F.silu`` for dense and moe, the form
    XLA evaluates (``layers.silu``) for the recurrent families, whose SSM
    state would carry the bf16 rounding differences of ``F.silu`` into
    every later token."""
    return L.silu if cfg.family in RECURRENT_FAMILIES else F.silu


def _ffn(blk, x, cfg: ArchConfig, opt: FwdOptions = FwdOptions()):
    """The FFN sublayer: ``(x + ffn(norm(x)), aux)``; aux is None for the
    MLP, the MoE's losses otherwise."""
    h = L.rms_norm(x, blk["norm2"], cfg.norm_eps)
    act = ffn_act(cfg)
    if "moe" in blk:
        out, aux = moe_layer(blk["moe"], h, top_k=cfg.moe_top_k,
                             capacity_factor=cfg.moe_capacity_factor,
                             n_groups=opt.moe_groups, act=act)
        return x + out, aux
    return x + L.mlp(blk["mlp"], h, act), None


def hybrid_ffn_select(cfg: ArchConfig, blk, i: int):
    """The FFN parameters of sublayer ``i`` of a hybrid group ``blk``: the
    MoE stack's entry when ``cfg.moe_on_layer(i)``, else the MLP stack's,
    each counted group-locally.  The forward, the decode step and the
    prefix-KV chunk step all select through here."""
    n_moe_before = sum(cfg.moe_on_layer(j) for j in range(i))
    if cfg.moe_on_layer(i):
        return take(blk["moe"], n_moe_before)
    return take(blk["mlp"], i - n_moe_before)


def mamba_block(blk, x, cfg: ArchConfig, dims: ModelDims, *,
                collect: bool = False, seq_len=None, initial_state=None,
                initial_conv=None):
    """The mamba sublayer: ``(x + mamba(norm1(x)), MambaCache | None)``."""
    h = L.rms_norm(x, blk["norm1"], cfg.norm_eps)
    out, state = mamba_forward(blk["mamba"], h, dims.mamba,
                               chunk=cfg.ssm_chunk,
                               initial_state=initial_state,
                               initial_conv=initial_conv, seq_len=seq_len,
                               return_state=collect)
    return x + out, state


def stack_caches(caches, lead=()) -> MambaCache:
    """A list of per-sublayer ``MambaCache`` -> one, stacked on a leading
    axis and reshaped to ``lead`` + its per-row shape."""
    conv = torch.stack([c.conv for c in caches])
    state = torch.stack([c.state for c in caches])
    if lead:
        conv = conv.reshape(*lead, *conv.shape[1:])
        state = state.reshape(*lead, *state.shape[1:])
    return MambaCache(conv=conv, state=state)


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("lb_loss", "z_loss", "fraction_dropped")}


def forward(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            dims: ModelDims, opt: FwdOptions = FwdOptions()):
    """batch: tokens (B, S) [+ seq_len (B,), each row's real length, which
    the mamba sublayers mask their pad tail with] [+ frontend (B, F, d),
    the vlm and audio families' stub embeddings].  Returns (logits (B, S,
    vocab_pad), aux, caches): aux sums the MoE layers' ``lb_loss``,
    ``z_loss`` and ``fraction_dropped`` (float32 scalars, zero without
    MoE layers); caches is None unless ``opt.collect_cache``, else
    ``{"k", "v"}`` of shape (L_attn, B, S, KV, hd) for dense and moe (F +
    S positions for vlm), ``{"k", "v", "ck", "cv", "enc_out"}`` for audio
    (the cross K/V (L, B, F, KV, hd) and the encoder output (B, F, d)),
    ``{"ssm": MambaCache}`` stacked over the layers for ssm, and for
    hybrid ``{"k", "v", "ssm"}`` with one K/V a group and the SSM caches
    stacked (n_groups, attn_every - 1, B, ...)."""
    check_family(cfg)
    seq_len = batch.get("seq_len")
    x = L.embed(params["embed"], batch["tokens"]).to(opt.dtype)
    aux = _zero_aux(x.device)
    collect = opt.collect_cache
    ks, vs, ssm, cks, cvs = [], [], [], [], []
    n_front = 0
    enc_out = None
    if cfg.family == "vlm":
        front = L.linear(params["frontend_proj"],
                         batch["frontend"].to(opt.dtype))
        x = torch.cat([front, x], dim=1)
        n_front = front.shape[1]
    elif cfg.family == "audio":
        enc_out = encoder(params, batch["frontend"], cfg, dims, opt)

    def acc(a):
        return aux if a is None else {key: aux[key] + a[key] for key in aux}

    if cfg.family == "hybrid":
        g = cfg.attn_every
        n_groups = cfg.num_layers // g
        for gi in range(n_groups):
            blk = layer_params(params, gi)
            for i in range(g):
                if i < g - 1:
                    x, st = mamba_block(take(blk["mamba"], i), x, cfg, dims,
                                        collect=collect, seq_len=seq_len)
                    ssm.append(st)
                else:
                    x, (k, v) = _self_attn(blk["attn"], x, cfg, dims, opt)
                    ks.append(k)
                    vs.append(v)
                x, a = _ffn(hybrid_ffn_select(cfg, blk, i), x, cfg, opt)
                aux = acc(a)
        lead = (n_groups, g - 1)
    else:
        for i in range(cfg.num_layers):
            blk = layer_params(params, i)
            if cfg.family == "ssm":
                x, st = mamba_block(blk, x, cfg, dims, collect=collect,
                                    seq_len=seq_len)
                ssm.append(st)
                continue
            x, (k, v) = _self_attn(blk, x, cfg, dims, opt)
            ks.append(k)
            vs.append(v)
            if enc_out is not None:
                x, (ck, cv) = _cross_attn(blk, x, enc_out, cfg, dims, opt)
                cks.append(ck)
                cvs.append(cv)
            x, a = _ffn(blk, x, cfg, opt)
            aux = acc(a)
        lead = ()
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if n_front:
        x = x[:, n_front:]
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = L.unembed(head, x, dims.logical_vocab)
    caches = None
    if collect:
        caches = {}
        if ks:
            caches.update(k=torch.stack(ks), v=torch.stack(vs))
        if cks:
            caches.update(ck=torch.stack(cks), cv=torch.stack(cvs),
                          enc_out=enc_out)
        if ssm:
            caches["ssm"] = stack_caches(ssm, lead)
    return logits, aux, caches
