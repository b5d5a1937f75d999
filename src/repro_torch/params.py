"""Model parameters of the port: carried over from the JAX package, or
drawn on the device.

The layout is ``repro.models.transformer.init_params``'s:
``embed.table (V, d)``, ``lm_head.table`` unless tied, ``final_norm
(d,)`` and ``layers`` with a leading layer axis.

* dense, moe and vlm: ``norm1``/``norm2 (L, d)``, ``attn.{q,k,v,o}.w``
  (and ``.b`` of q, k, v with ``qkv_bias``), each ``linear`` weight
  ``(L, d_in, d_out)``, and either ``mlp.{gate,up,down}.w`` or, in the
  moe family, ``moe.{router.w (L, d, E), gate/up (L, E, d, F), down (L,
  E, F, d)}``; vlm adds ``frontend_proj.w (d, d)``;
* audio: ``frontend_proj.w (d, d)``, ``encoder.{layers, final_norm}``
  (the encoder's layers as the dense family's, ``encoder_layers`` deep)
  and decoder layers that hold, besides the dense family's, ``norm_x (L,
  d)`` and the cross-attention ``cross.{q,k,v,o}`` (biases as ``attn``);
* ssm: ``norm1 (L, d)`` and ``mamba`` (``models/ssm.py mamba_shapes``
  behind the layer axis);
* hybrid: a leading GROUP axis (``num_layers // attn_every`` groups):
  ``mamba.{norm1, mamba}`` stacked ``(G, attn_every - 1, ...)``,
  ``attn.{norm1, attn}`` ``(G, ...)``, and ``mlp.{norm2, mlp}`` /
  ``moe.{norm2, moe}`` stacked ``(G, n, ...)`` over the group's MLP and
  MoE sublayers, each present only when the group has that kind.

The MoE router and the mamba blocks' ``A_log``, ``D`` and ``dt_bias``
stay float32 under any model dtype, as ``init_moe`` and ``init_mamba``
make them.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import moe_shapes
from repro_torch.models.ssm import FLOAT32_LEAVES, mamba_shapes
from repro_torch.models.transformer import (RECURRENT_FAMILIES, ModelDims,
                                            check_family)

_KEEP_F32 = ("router",) + FLOAT32_LEAVES     # never cast by ``dtype``


def params_from_numpy(tree, device="cuda", dtype=None):
    """Nested dicts of numpy arrays (the JAX parameter pytree after
    ``np.asarray`` on each leaf) -> the same nesting of torch tensors on
    ``device``.  ``dtype`` (a torch dtype) casts every leaf but the MoE
    router's and the mamba blocks' ``A_log``, ``D`` and ``dt_bias``,
    which stay float32; None keeps each leaf's own.  bfloat16 leaves
    (numpy's extension dtype) convert exactly through float32."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device,
                                     None if k in _KEEP_F32 else dtype)
                for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _no_cut(path, x):
    return x


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dims: ModelDims, dtype=torch.float32,
                device="cuda", cut=None) -> Dict[str, Any]:
    """Draw parameters with ``init_params``'s shapes and scales (normal *
    1/sqrt(d_in) for projections and experts, 1/sqrt(conv width) for the
    mamba conv, 0.02 for the embeddings, ones for the norms, zero qkv and
    conv biases; ``A_log`` = log of 1..16 over the heads, ``D`` ones,
    ``dt_bias`` zeros) from ``generator``, which must live on ``device``.
    Every stack is filled one layer's matrix (or expert tensor) at a
    time, so the float32 draw never holds more than one of them.

    ``cut(path, x)``, when given, keeps a block of each drawn matrix ``x``
    (the leaf's trailing dims; ``path`` the keys down to the leaf) as soon
    as it is drawn: the tree then holds the blocks and never a whole leaf
    (``dist.megatron.ServingTP.draw``).  The numbers are those of the
    whole draw."""
    check_family(cfg)
    cut = _no_cut if cut is None else cut
    if cfg.family in RECURRENT_FAMILIES:
        return _init_recurrent(generator, cfg, dims, dtype, device, cut)
    if cfg.family == "moe" and not all(cfg.moe_on_layer(i)
                                       for i in range(cfg.num_layers)):
        raise ValueError(f"{cfg.name}: a moe-family model stacks one MoE "
                         "FFN a layer (moe_every=1, moe_offset=0)")
    d = cfg.d_model
    hd, H, KV, ff = dims.head_dim, dims.n_heads, dims.n_kv, dims.d_ff

    def normal(path, shape, scale, dt=dtype):
        return cut(path, (torch.randn(shape, generator=generator,
                                      device=device, dtype=torch.float32)
                          * scale).to(dt))

    def stack(path, nl, shape, scale, dt=dtype):
        block = cut(path, torch.empty(shape, device="meta")).shape
        w = torch.empty((nl, *block), dtype=dt, device=device)
        for i in range(nl):
            w[i] = normal(path, shape, scale, dt)
        return w

    def stacked(path, nl, d_in, d_out, scale=None):
        return {"w": stack(path + ("w",), nl, (d_in, d_out),
                           1.0 / math.sqrt(d_in) if scale is None
                           else scale)}

    def ones(nl):
        return torch.ones((nl, d), dtype=dtype, device=device)

    def attention(path, nl):
        attn = {"q": stacked(path + ("q",), nl, d, H * hd),
                "k": stacked(path + ("k",), nl, d, KV * hd),
                "v": stacked(path + ("v",), nl, d, KV * hd),
                "o": stacked(path + ("o",), nl, H * hd, d,
                             1.0 / math.sqrt(H * hd))}
        if cfg.qkv_bias:
            for name, n in (("q", H * hd), ("k", KV * hd), ("v", KV * hd)):
                attn[name]["b"] = torch.zeros((nl, n), dtype=dtype,
                                              device=device)
        return attn

    def mlp(path, nl):
        return {"gate": stacked(path + ("gate",), nl, d, ff),
                "up": stacked(path + ("up",), nl, d, ff),
                "down": stacked(path + ("down",), nl, ff, d,
                                1.0 / math.sqrt(ff))}

    # the draw order (attention, embedding, FFN, head) is fixed: a seed
    # gives the weights it gave before the audio and vlm trees came in
    nl = cfg.num_layers
    ly = ("layers",)
    layers: Dict[str, Any] = {"norm1": ones(nl),
                              "attn": attention(ly + ("attn",), nl)}
    if cfg.family == "audio":
        layers.update(norm_x=ones(nl), cross=attention(ly + ("cross",), nl))
    params: Dict[str, Any] = {
        "embed": {"table": normal(("embed", "table"), (dims.vocab, d),
                                  0.02)},
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
        "layers": layers,
    }
    layers["norm2"] = ones(nl)
    if cfg.family == "moe":
        shp = moe_shapes(d, ff, cfg.moe_num_experts)
        moe = ly + ("moe",)
        layers["moe"] = {
            "router": {"w": stack(moe + ("router", "w"), nl, shp["router"],
                                  1.0 / math.sqrt(d), torch.float32)},
            "gate": stack(moe + ("gate",), nl, shp["gate"],
                          1.0 / math.sqrt(d)),
            "up": stack(moe + ("up",), nl, shp["up"], 1.0 / math.sqrt(d)),
            "down": stack(moe + ("down",), nl, shp["down"],
                          1.0 / math.sqrt(ff))}
    else:
        layers["mlp"] = mlp(ly + ("mlp",), nl)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": normal(("lm_head", "table"),
                                             (dims.vocab, d), 0.02)}
    if cfg.frontend != "none":
        params["frontend_proj"] = {"w": normal(("frontend_proj", "w"),
                                               (d, d), 1.0 / math.sqrt(d))}
    if cfg.family == "audio":
        ne = cfg.encoder_layers
        enc = ("encoder", "layers")
        params["encoder"] = {
            "layers": {"norm1": ones(ne),
                       "attn": attention(enc + ("attn",), ne),
                       "norm2": ones(ne), "mlp": mlp(enc + ("mlp",), ne)},
            "final_norm": torch.ones((d,), dtype=dtype, device=device)}
    return params


def _init_recurrent(generator: torch.Generator, cfg: ArchConfig,
                    dims: ModelDims, dtype, device, cut) -> Dict[str, Any]:
    """``init_params`` of the ssm and hybrid families."""
    d = cfg.d_model
    md = dims.mamba
    f32 = torch.float32

    def fill(path, lead, shape, scale, dt=dtype):
        """(*lead, *shape) normal * scale, drawn one trailing (rows, cols)
        matrix at a time; each (*shape) entry cut by ``cut`` once drawn."""
        shape = tuple(shape)
        block = tuple(cut(path, torch.empty(shape, device="meta")).shape)
        w = torch.empty((*lead, *block), dtype=dt, device=device)
        for entry in w.view(-1, *block):
            x = entry if block == shape else torch.empty(
                shape, dtype=dt, device=device)
            for m in x.view(-1, *shape[-2:]):
                m.copy_(torch.randn(m.shape, generator=generator,
                                    device=device, dtype=f32) * scale)
            if x is not entry:
                entry.copy_(cut(path, x))
        return w

    def const(lead, shape, value, dt=dtype):
        return torch.full((*lead, *shape), value, dtype=dt, device=device)

    def mamba(path, lead):
        sh = mamba_shapes(md)
        s = 1.0 / math.sqrt(d)
        a_log = torch.log(torch.linspace(1.0, 16.0, md.n_heads, dtype=f32,
                                         device=device))
        return {
            "in_z": fill(path + ("in_z",), lead, sh["in_z"], s),
            "in_x": fill(path + ("in_x",), lead, sh["in_x"], s),
            "in_B": fill(path + ("in_B",), lead, sh["in_B"], s),
            "in_C": fill(path + ("in_C",), lead, sh["in_C"], s),
            "in_dt": fill(path + ("in_dt",), lead, sh["in_dt"], s),
            "conv_w": fill(path + ("conv_w",), lead, sh["conv_w"],
                           1.0 / math.sqrt(md.conv_width)),
            "conv_b": const(lead, sh["conv_b"], 0.0),
            "A_log": a_log.expand(*lead, md.n_heads).clone(),
            "D": const(lead, sh["D"], 1.0, f32),
            "dt_bias": const(lead, sh["dt_bias"], 0.0, f32),
            "norm": const(lead, sh["norm"], 1.0),
            "out_proj": fill(path + ("out_proj",), lead, sh["out_proj"],
                             1.0 / math.sqrt(md.d_inner))}

    params: Dict[str, Any] = {
        "embed": {"table": fill(("embed", "table"), (), (dims.vocab, d),
                                0.02)},
        "final_norm": const((), (d,), 1.0)}
    if cfg.family == "ssm":
        lead = (cfg.num_layers,)
        params["layers"] = {"norm1": const(lead, (d,), 1.0),
                            "mamba": mamba(("layers", "mamba"), lead)}
    else:
        g = cfg.attn_every
        G = cfg.num_layers // g
        H, KV, hd, ff = dims.n_heads, dims.n_kv, dims.head_dim, dims.d_ff

        def linear(path, lead, d_in, d_out):
            return {"w": fill(path + ("w",), lead, (d_in, d_out),
                              1.0 / math.sqrt(d_in))}

        at = ("layers", "attn", "attn")
        attn = {"q": linear(at + ("q",), (G,), d, H * hd),
                "k": linear(at + ("k",), (G,), d, KV * hd),
                "v": linear(at + ("v",), (G,), d, KV * hd),
                "o": linear(at + ("o",), (G,), H * hd, d)}
        if cfg.qkv_bias:
            for name, n in (("q", H * hd), ("k", KV * hd), ("v", KV * hd)):
                attn[name]["b"] = const((G,), (n,), 0.0)
        layers = {"mamba": {"norm1": const((G, g - 1), (d,), 1.0),
                            "mamba": mamba(("layers", "mamba", "mamba"),
                                           (G, g - 1))},
                  "attn": {"norm1": const((G,), (d,), 1.0), "attn": attn}}
        n_moe = sum(cfg.moe_on_layer(i) for i in range(g))
        if g - n_moe:
            lead = (G, g - n_moe)
            mp = ("layers", "mlp", "mlp")
            layers["mlp"] = {"norm2": const(lead, (d,), 1.0), "mlp": {
                "gate": linear(mp + ("gate",), lead, d, ff),
                "up": linear(mp + ("up",), lead, d, ff),
                "down": linear(mp + ("down",), lead, ff, d)}}
        if n_moe:
            lead = (G, n_moe)
            shp = moe_shapes(d, ff, cfg.moe_num_experts)
            mo = ("layers", "moe", "moe")
            layers["moe"] = {"norm2": const(lead, (d,), 1.0), "moe": {
                "router": {"w": fill(mo + ("router", "w"), lead,
                                     shp["router"], 1.0 / math.sqrt(d),
                                     f32)},
                "gate": fill(mo + ("gate",), lead, shp["gate"],
                             1.0 / math.sqrt(d)),
                "up": fill(mo + ("up",), lead, shp["up"],
                           1.0 / math.sqrt(d)),
                "down": fill(mo + ("down",), lead, shp["down"],
                             1.0 / math.sqrt(ff))}}
        params["layers"] = layers
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": fill(("lm_head", "table"), (),
                                           (dims.vocab, d), 0.02)}
    return params
