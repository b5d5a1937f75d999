"""Model parameters of the port: carried over from the JAX package, or
drawn on the device.

The layout is ``repro.models.transformer.init_params``'s for the dense
family: ``embed.table (V, d)``, ``lm_head.table`` unless tied,
``final_norm (d,)`` and ``layers`` with a leading layer axis —
``norm1``/``norm2 (L, d)``, ``attn.{q,k,v,o}.w`` and
``mlp.{gate,up,down}.w``, each ``linear`` weight ``(L, d_in, d_out)``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import ModelDims


def params_from_numpy(tree, device="cuda", dtype=None):
    """Nested dicts of numpy arrays (the JAX parameter pytree after
    ``np.asarray`` on each leaf) -> the same nesting of torch tensors on
    ``device``.  ``dtype`` (a torch dtype) casts every leaf; None keeps
    each leaf's own.  bfloat16 leaves (numpy's extension dtype) convert
    exactly through float32."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
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
    """Draw dense-family parameters with ``init_params``'s shapes and
    scales (normal * 1/sqrt(d_in) for projections, 0.02 for the
    embeddings, ones for the norms) from ``generator``, which must live on
    ``device``.  Stacked layer tensors are filled one layer at a time, so
    the float32 draw never holds more than one layer's matrix."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP P10)")
    d, nl = cfg.d_model, cfg.num_layers
    hd, H, KV, ff = dims.head_dim, dims.n_heads, dims.n_kv, dims.d_ff

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    def stacked(d_in, d_out, scale=None):
        w = torch.empty((nl, d_in, d_out), dtype=dtype, device=device)
        for i in range(nl):
            w[i] = normal((d_in, d_out),
                          1.0 / math.sqrt(d_in) if scale is None else scale)
        return {"w": w}

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
        "layers": {
            "norm1": ones, "attn": attn, "norm2": ones.clone(),
            "mlp": {"gate": stacked(d, ff), "up": stacked(d, ff),
                    "down": stacked(ff, d, 1.0 / math.sqrt(ff))},
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": normal((dims.vocab, d), 0.02)}
    return params
