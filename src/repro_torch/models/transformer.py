"""The decoder-only LMs of the dense and moe families in torch.

``forward`` mirrors ``repro.models.transformer.forward`` for both
families: a loop over the stacked layers (leading layer axis, as
``params.init_params`` lays them out), returning ``(logits, aux,
caches)``; ``opt.collect_cache`` additionally returns the per-layer K/V
the serving engine installs into the hybrid-translated KV pool.  Causal
self-attention goes through ``attention(impl=opt.attn_impl)``: with
``"pallas"`` (alias ``"flash"``) a CUDA tensor runs the flash kernel and
a CPU tensor its plain version.  A layer whose parameters hold ``"moe"``
runs the MoE FFN (``models/moe.py``) in place of the MLP, and ``aux``
sums its losses over the layers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, resolve
from . import layers as L
from .attention import attention
from .moe import moe_layer

FAMILIES = ("dense", "moe")         # the families the port runs


class ModelDims(NamedTuple):
    n_heads: int
    n_kv: int
    head_dim: int
    vocab: int            # padded
    logical_vocab: int
    d_ff: int
    tp: int


def model_dims(cfg: ArchConfig, tp: int = 1) -> ModelDims:
    r = resolve(cfg, tp)
    return ModelDims(n_heads=r.num_heads, n_kv=r.num_kv_heads,
                     head_dim=cfg.resolved_head_dim, vocab=r.vocab_size,
                     logical_vocab=cfg.vocab_size, d_ff=r.d_ff, tp=tp)


@dataclasses.dataclass(frozen=True)
class FwdOptions:
    attn_impl: str = "dense"           # dense | pallas (alias flash)
    dtype: Any = torch.float32
    collect_cache: bool = False        # prefill: emit per-layer K/V
    moe_groups: int = 1                # MoE dispatch groups (1 only)


def layer_params(params, i: int) -> Dict[str, Any]:
    """Layer ``i``'s parameters: views into the stacked layer tensors."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params["layers"])


def _self_attn(blk, x, cfg: ArchConfig, dims: ModelDims, opt: FwdOptions):
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None, :]
    h = L.rms_norm(x, blk["norm1"], cfg.norm_eps)
    q, k, v = L.qkv_project(blk["attn"], h, h, dims.n_heads, dims.n_kv,
                            dims.head_dim, pos, pos, cfg.rope_theta)
    o = attention(q, k, v, impl=opt.attn_impl, causal=True)
    o = L.linear(blk["attn"]["o"], o.reshape(B, S, -1))
    return x + o, (k, v)


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family the port does not run yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP P10)")


def _ffn(blk, x, cfg: ArchConfig, opt: FwdOptions = FwdOptions()):
    """The FFN sublayer: ``(x + ffn(norm(x)), aux)``; aux is None for the
    MLP, the MoE's losses otherwise."""
    h = L.rms_norm(x, blk["norm2"], cfg.norm_eps)
    if "moe" in blk:
        out, aux = moe_layer(blk["moe"], h, top_k=cfg.moe_top_k,
                             capacity_factor=cfg.moe_capacity_factor,
                             n_groups=opt.moe_groups)
        return x + out, aux
    return x + L.mlp(blk["mlp"], h), None


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("lb_loss", "z_loss", "fraction_dropped")}


def forward(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            dims: ModelDims, opt: FwdOptions = FwdOptions()):
    """batch: tokens (B, S).  Returns (logits (B, S, vocab_pad), aux,
    caches): aux sums the MoE layers' ``lb_loss``, ``z_loss`` and
    ``fraction_dropped`` (float32 scalars, zero without MoE layers);
    caches is None unless ``opt.collect_cache``, else ``{"k", "v"}`` of
    shape (L, B, S, KV, hd)."""
    check_family(cfg)
    x = L.embed(params["embed"], batch["tokens"]).to(opt.dtype)
    aux = _zero_aux(x.device)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        blk = layer_params(params, i)
        x, (k, v) = _self_attn(blk, x, cfg, dims, opt)
        x, a = _ffn(blk, x, cfg, opt)
        if a is not None:
            aux = {key: aux[key] + a[key] for key in aux}
        if opt.collect_cache:
            ks.append(k)
            vs.append(v)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = L.unembed(head, x, dims.logical_vocab)
    caches = ({"k": torch.stack(ks), "v": torch.stack(vs)}
              if opt.collect_cache else None)
    return logits, aux, caches
