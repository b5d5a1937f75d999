"""Dense building blocks: norms (Mamba2's gated one too), RoPE,
projections, SwiGLU MLP.

Conventions (as in ``repro.models.layers``):
* params are nested dicts of tensors; per-layer stacks carry a leading
  layer axis (``transformer.init_params``);
* ``linear`` weights are ``(d_in, d_out)``;
* activations compute in their own dtype, with float32 inside the norm and
  the RoPE rotation;
* ``rows=True`` (``FwdOptions.rows_invariant``, the prefill steps') sends
  the projections and norms through the rows-invariant kernels
  (``kernels/rows_gemm``, ``kernels/rms_norm``): on a CUDA tensor each
  output row's bits then depend only on that row, not on how many rows
  the call holds; on a CPU tensor the kernels' plain versions are these
  functions' own arithmetic.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rows_gemm.ops import rows_gemm


def _rms_norm_fwd(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _rms_norm_bwd(eps: float, x: torch.Tensor, scale: torch.Tensor,
                  g: torch.Tensor):
    """The JAX package's custom VJP: float32 internal math, ``dx`` in x's
    dtype, ``dscale`` summed over every axis but the last, in scale's
    dtype."""
    x32 = x.float()
    g32 = g.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = x32 * rstd
    gs = g32 * scale.float()
    dx = rstd * (gs - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
    dscale = (g32 * xhat).sum(dim=tuple(range(x.dim() - 1)))
    return dx.to(x.dtype), dscale.to(scale.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rms_norm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = _rms_norm_bwd(ctx.eps, x, scale, g)
        return dx, dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5, rows: bool = False) -> torch.Tensor:
    """RMS norm in float32, returned in x's dtype.  Under autograd its
    gradient is the JAX package's custom one (``_rms_norm_bwd``); without
    it (serving) the same forward runs as plain ops, or with ``rows``
    through the rows-invariant kernel."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    if rows:
        from repro_torch.kernels.rms_norm.ops import rms_norm as kernel
        return kernel(x, scale, eps)
    return _rms_norm_fwd(x, scale, eps)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, each
    op in x's dtype: how XLA evaluates ``jax.nn.silu``.  In bfloat16 this
    rounds otherwise than ``F.silu`` (one rounding from float32) in about
    a third of the elements; the recurrent families' state carries such
    one-ulp differences into every later token, so their layers take this
    form (``transformer.ffn_act``)."""
    return x * (1 / (1 + torch.exp(-x)))


def gated_rms_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5, tp=None,
                   rows: bool = False) -> torch.Tensor:
    """Mamba2's RMSNormGated: ``rms_norm(y) * silu(z)``, in y's dtype.
    With ``tp`` (``dist.megatron.ServingTP``) ``y``, ``z`` and ``scale``
    hold this rank's block of the features: the mean square is the sum
    of squares over the model group over the whole width.  ``rows``: the
    rows-invariant kernel, gate included (not with ``tp``)."""
    if rows and tp is None:
        from repro_torch.kernels.rms_norm.ops import rms_norm as kernel
        return kernel(y, scale, eps, z=z)
    if tp is None:
        return (rms_norm(y, scale, eps) * silu(z).to(y.dtype)).to(y.dtype)
    y32 = y.float()
    var = tp.sum(y32.square().sum(dim=-1, keepdim=True)) / (
        y.shape[-1] * tp.tp)
    out = (y32 * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)
    return (out * silu(z).to(y.dtype)).to(y.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to
    (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def linear(p: dict, x: torch.Tensor, rows: bool = False) -> torch.Tensor:
    w = p["w"].to(x.dtype)
    b = p["b"].to(x.dtype) if "b" in p else None
    if rows:
        return rows_gemm(x, w, b)
    y = x @ w
    if b is not None:
        y = y + b
    return y


def mlp(p: dict, x: torch.Tensor, act=F.silu,
        rows: bool = False) -> torch.Tensor:
    h = act(linear(p["gate"], x, rows)) * linear(p["up"], x, rows)
    return linear(p["down"], h, rows)


def qkv_project(p: dict, x: torch.Tensor, xkv: torch.Tensor, n_heads: int,
                n_kv: int, head_dim: int, positions, kv_positions,
                rope_theta: float, rows: bool = False):
    """Returns q (B,S,H,hd), k/v (B,Skv,KV,hd) with RoPE applied."""
    B, S, _ = x.shape
    Skv = xkv.shape[1]
    q = linear(p["q"], x, rows).reshape(B, S, n_heads, head_dim)
    k = linear(p["k"], xkv, rows).reshape(B, Skv, n_kv, head_dim)
    v = linear(p["v"], xkv, rows).reshape(B, Skv, n_kv, head_dim)
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, kv_positions, rope_theta)
    return q, k, v


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def unembed(p: dict, x: torch.Tensor, logical_vocab: int,
            rows: bool = False) -> torch.Tensor:
    """Project to the (padded) vocab; padded ids masked to -1e9.  With
    ``rows`` the kernel reads the table as its transpose in place."""
    w = p["table"].T.to(x.dtype)
    return mask_vocab(rows_gemm(x, w) if rows else x @ w, logical_vocab)


def mask_vocab(logits: torch.Tensor, logical_vocab: int) -> torch.Tensor:
    """``logits`` over the padded vocab with the ids past
    ``logical_vocab`` set to -1e9."""
    vpad = logits.shape[-1]
    if vpad > logical_vocab:
        dev = logits.device
        mask = torch.arange(vpad, device=dev) < logical_vocab
        logits = torch.where(mask, logits,
                             torch.tensor(-1e9, dtype=logits.dtype,
                                          device=dev))
    return logits
