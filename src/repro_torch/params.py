"""Model parameters of the port: carried over from the JAX package, or
drawn on the device.

The layout is ``repro.models.transformer.init_params``'s for the dense
and moe families: ``embed.table (V, d)``, ``lm_head.table`` unless tied,
``final_norm (d,)`` and ``layers`` with a leading layer axis —
``norm1``/``norm2 (L, d)``, ``attn.{q,k,v,o}.w`` (and ``.b`` of q, k, v
with ``qkv_bias``), each ``linear`` weight ``(L, d_in, d_out)``, and
either ``mlp.{gate,up,down}.w`` or, in the moe family,
``moe.{router.w (L, d, E), gate/up (L, E, d, F), down (L, E, F, d)}``.
The router stays float32 under any model dtype, as ``init_moe`` makes
it.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import moe_shapes
from repro_torch.models.transformer import ModelDims, check_family


def params_from_numpy(tree, device="cuda", dtype=None):
    """Nested dicts of numpy arrays (the JAX parameter pytree after
    ``np.asarray`` on each leaf) -> the same nesting of torch tensors on
    ``device``.  ``dtype`` (a torch dtype) casts every leaf but the MoE
    router's, which stays float32; None keeps each leaf's own.  bfloat16
    leaves (numpy's extension dtype) convert exactly through float32."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device,
                                     None if k == "router" else dtype)
                for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dims: ModelDims, dtype=torch.float32,
                device="cuda") -> Dict[str, Any]:
    """Draw dense- or moe-family parameters with ``init_params``'s shapes
    and scales (normal * 1/sqrt(d_in) for projections and experts, 0.02
    for the embeddings, ones for the norms, zero qkv biases) from
    ``generator``, which must live on ``device``.  Stacked layer tensors
    are filled one layer at a time, so the float32 draw never holds more
    than one layer's matrix (or expert tensor)."""
    check_family(cfg)
    if cfg.family == "moe" and not all(cfg.moe_on_layer(i)
                                       for i in range(cfg.num_layers)):
        raise ValueError(f"{cfg.name}: a moe-family model stacks one MoE "
                         "FFN a layer (moe_every=1, moe_offset=0)")
    d, nl = cfg.d_model, cfg.num_layers
    hd, H, KV, ff = dims.head_dim, dims.n_heads, dims.n_kv, dims.d_ff

    def normal(shape, scale, dt=dtype):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dt)

    def stack(shape, scale, dt=dtype):
        w = torch.empty((nl, *shape), dtype=dt, device=device)
        for i in range(nl):
            w[i] = normal(shape, scale, dt)
        return w

    def stacked(d_in, d_out, scale=None):
        return {"w": stack((d_in, d_out), 1.0 / math.sqrt(d_in)
                           if scale is None else scale)}

    def bias(n):
        return torch.zeros((nl, n), dtype=dtype, device=device)

    attn = {"q": stacked(d, H * hd), "k": stacked(d, KV * hd),
            "v": stacked(d, KV * hd),
            "o": stacked(H * hd, d, 1.0 / math.sqrt(H * hd))}
    if cfg.qkv_bias:
        for name, n in (("q", H * hd), ("k", KV * hd), ("v", KV * hd)):
            attn[name]["b"] = bias(n)
    ones = torch.ones((nl, d), dtype=dtype, device=device)
    params: Dict[str, Any] = {
        "embed": {"table": normal((dims.vocab, d), 0.02)},
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
        "layers": {"norm1": ones, "attn": attn, "norm2": ones.clone()},
    }
    if cfg.family == "moe":
        shp = moe_shapes(d, ff, cfg.moe_num_experts)
        params["layers"]["moe"] = {
            "router": {"w": stack(shp["router"], 1.0 / math.sqrt(d),
                                  torch.float32)},
            "gate": stack(shp["gate"], 1.0 / math.sqrt(d)),
            "up": stack(shp["up"], 1.0 / math.sqrt(d)),
            "down": stack(shp["down"], 1.0 / math.sqrt(ff))}
    else:
        params["layers"]["mlp"] = {
            "gate": stacked(d, ff), "up": stacked(d, ff),
            "down": stacked(ff, d, 1.0 / math.sqrt(ff))}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": normal((dims.vocab, d), 0.02)}
    return params
