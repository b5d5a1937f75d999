"""Hand-scheduled Megatron tensor-parallel forward (dense family).

The port of ``repro.dist.megatron``.  The single-device forward
(``repro_torch.models``) is the oracle; this module writes the
tensor-parallel schedule out with explicit collectives over the mesh's
model group:

* vocab-sharded embedding: local masked gather, closed by a sum over the
  model group;
* per layer: column-parallel q/k/v (heads sliced over the model axis,
  KV heads replicated when ``n_kv % tp != 0``, the MQA case), local
  attention over the head slice, row-parallel output projection closed by
  one sum; column-parallel gate/up and the row-parallel down projection
  closed by one sum for the MLP;
* vocab-sharded unembed closed by an all-gather.

Every model rank computes the same replicated loss, so each collective
has a conjugate in backward (Megatron-LM's operators): ``copy_to`` at a
column-parallel input is the identity forward and a sum backward (each
rank's gradient of the input is its heads' part); ``reduce_from`` at a
row-parallel output is a sum forward and the identity backward (the
gradient of the sum is already whole on every rank); ``gather_from`` at
the unembed is an all-gather forward and this rank's slice backward.  A
plain differentiable all-reduce would sum whole gradients in backward and
scale them by ``tp``.

The parameters come as this rank's blocks in ``megatron_param_shardings``'
layout (JAX's, which shards k/v by their shape; where the schedule keeps
KV replicated, the forward gathers those blocks), the batch as this
rank's rows (the mesh train step splits it over the data axis).
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import attention
from repro_torch.models.transformer import (ModelDims, _remat, _zero_aux,
                                            ce_terms, layer_stack, take)

from .sharding import P, ShardingRules, _path_names, _sizes, map_with_path


def _kv_sharded(dims: ModelDims, tp: int) -> bool:
    return (dims.n_kv * dims.head_dim) % tp == 0 and dims.n_kv % tp == 0


def _mega_spec(path: Tuple[str, ...], dims: ModelDims, tp: int, M: str):
    """PartitionSpec for one parameter leaf under the explicit schedule."""
    name = path[-1]
    if "norm" in name:
        return P()
    if name == "table":
        return P(M, None) if dims.vocab % tp == 0 else P()
    parent = path[-2] if len(path) > 1 else ""
    if name == "w":
        if parent == "q" or (parent in ("k", "v") and _kv_sharded(dims, tp)):
            return P(None, None, M)          # column-parallel (stacked)
        if parent in ("k", "v"):
            return P(None, None, None)       # replicated KV (MQA)
        if parent == "o":
            return P(None, M, None)          # row-parallel
        if parent in ("gate", "up"):
            return P(None, None, M)
        if parent == "down":
            return P(None, M, None)
        return P()
    if name == "b":
        if parent == "q" or (parent in ("k", "v") and _kv_sharded(dims, tp)):
            return P(None, M)
        return P()
    return P()


def megatron_param_shardings(params, mesh, rules: ShardingRules):
    """PartitionSpecs matching the explicit schedule's parameter layout
    (``params``: the whole tree, or its ``meta`` shapes)."""
    M = rules.model_axis
    tp = _sizes(mesh)[M]
    vocab_div = params["embed"]["table"].shape[0] % tp == 0
    kv_div = params["layers"]["attn"]["k"]["w"].shape[-1] % tp == 0

    def leaf(path, x):
        names = _path_names(path)
        name = names[-1]
        parent = names[-2] if len(names) > 1 else ""
        if name == "table":
            spec = P(M, None) if vocab_div else P()
        elif name == "w" and (parent in ("q", "gate", "up")
                              or (parent in ("k", "v") and kv_div)):
            spec = P(None, None, M)
        elif name == "w" and parent in ("o", "down"):
            spec = P(None, M, None)
        elif name == "b" and (parent == "q"
                              or (parent in ("k", "v") and kv_div)):
            spec = P(None, M)
        else:
            spec = P()
        return spec

    return map_with_path(leaf, params)


# ------------------------------------------- the conjugate collectives

class _CopyTo(torch.autograd.Function):
    """Identity forward; backward, the sum over the model group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous().clone(), "model"), None


class _ReduceFrom(torch.autograd.Function):
    """Sum over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.contiguous().clone(), "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """All-gather along ``dim`` over the model group forward; backward,
    this rank's slice of the (replicated, whole) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return mesh.all_gather(x, dim, "model")

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.model_index
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None


def copy_to(x, mesh):
    return _CopyTo.apply(x, mesh)


def reduce_from(x, mesh):
    return _ReduceFrom.apply(x, mesh)


def gather_from(x, mesh, dim):
    return _GatherFrom.apply(x, mesh, dim)


# ------------------------------------------------------------ forward

def make_megatron_forward(cfg: ArchConfig, dims: ModelDims, mesh,
                          data_axes: Tuple[str, ...] = ("data",),
                          attn_impl: str = "dense",
                          triangular: bool = False, remat: bool = False,
                          model_axis: str = "model"):
    """Returns ``fwd(params, batch) -> (logits, aux, None)`` for dense
    models: ``params`` this rank's blocks (``megatron_param_shardings``),
    ``batch`` this rank's rows; the logits are those rows' over the whole
    vocab, the same on every model rank.  ``data_axes`` is JAX's
    signature's (its shard_map splits the batch; here the rows arrive
    split)."""
    if cfg.family != "dense":
        raise ValueError("explicit megatron schedule is dense-only")
    if model_axis != "model" or tuple(data_axes) != tuple(
            getattr(mesh, "data_axes", ("data",))):
        raise ValueError(f"data axes {tuple(data_axes)} and model axis "
                         f"{model_axis!r} are not the mesh's")
    tp = mesh.model_size
    kv_sh = _kv_sharded(dims, tp)
    kv_div = (dims.n_kv * dims.head_dim) % tp == 0   # the state's k/v split
    vocab_sh = dims.vocab % tp == 0
    H_loc = dims.n_heads // tp
    KV_loc = dims.n_kv // tp if kv_sh else dims.n_kv
    hd = dims.head_dim

    def layer(blk, x, pos, m_idx):
        B, S, _ = x.shape
        # attention: column-parallel q (and k/v when sharded), row-parallel o
        h = L.rms_norm(x, blk["norm1"], cfg.norm_eps)
        hc = copy_to(h, mesh)
        att = blk["attn"]
        q = L.linear(att["q"], hc).reshape(B, S, H_loc, hd)
        if kv_sh:
            k = L.linear(att["k"], hc).reshape(B, S, KV_loc, hd)
            v = L.linear(att["v"], hc).reshape(B, S, KV_loc, hd)
        else:
            # replicated KV: every rank computes all heads, and the sum in
            # backward makes each rank's gradient the whole one
            kv = {n: {key: (gather_from(t, mesh, t.dim() - 1) if kv_div
                            else t) for key, t in att[n].items()}
                  for n in ("k", "v")}
            k = copy_to(L.linear(kv["k"], h), mesh).reshape(B, S, dims.n_kv,
                                                            hd)
            v = copy_to(L.linear(kv["v"], h), mesh).reshape(B, S, dims.n_kv,
                                                            hd)
            # each local query head reads its own KV head
            g = dims.n_heads // dims.n_kv
            idx = (m_idx * H_loc + torch.arange(H_loc, device=x.device)) // g
            k, v = k[:, :, idx], v[:, :, idx]
        if cfg.rope_theta > 0:
            q = L.apply_rope(q, pos, cfg.rope_theta)
            k = L.apply_rope(k, pos, cfg.rope_theta)
        o = attention(q, k, v, impl=attn_impl, causal=True,
                      triangular_schedule=triangular)
        o = L.linear(att["o"], o.reshape(B, S, -1))
        x = x + reduce_from(o, mesh)
        # MLP: column-parallel gate/up, row-parallel down
        h = copy_to(L.rms_norm(x, blk["norm2"], cfg.norm_eps), mesh)
        p = blk["mlp"]
        ff = F.silu(L.linear(p["gate"], h)) * L.linear(p["up"], h)
        return x + reduce_from(L.linear(p["down"], ff), mesh)

    def fwd(params, batch):
        tokens = batch["tokens"]
        m_idx = mesh.model_index
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)[None, :]

        # ---- vocab-sharded embedding -----------------------------------
        table = params["embed"]["table"]
        if vocab_sh:
            v_loc = table.shape[0]
            idx = tokens.long() - m_idx * v_loc
            ok = (idx >= 0) & (idx < v_loc)
            x = table[idx.clamp(0, v_loc - 1)]
            x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
            x = reduce_from(x, mesh)
        else:
            x = table[tokens.long()]

        layers = layer_stack(params["layers"], cfg)
        body = functools.partial(layer, pos=pos, m_idx=m_idx)
        for i in range(cfg.num_layers):
            x = _remat(body, remat, take(layers, i), x)

        # ---- final norm + vocab-sharded unembed ------------------------
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        if vocab_sh:
            logits = gather_from(copy_to(x, mesh) @ head["table"].T.to(
                x.dtype), mesh, 2)
        else:
            logits = x @ head["table"].T.to(x.dtype)
        if dims.vocab > dims.logical_vocab:
            mask = torch.arange(dims.vocab, device=x.device) \
                < dims.logical_vocab
            logits = torch.where(mask, logits, torch.tensor(
                -1e9, dtype=logits.dtype, device=x.device))
        return logits, _zero_aux(x.device), None

    return fwd


def megatron_loss(mfwd, mesh):
    """``loss_override`` for ``make_train_step`` over the schedule
    ``mfwd``: ``launch/dryrun.py``'s masked cross-entropy, as this rank's
    term of the whole batch's (``ce_terms`` over the data axis), with
    the whole batch's ``ce`` and ``loss`` as metrics.  It takes the
    parameters as this rank's model-axis blocks (``sharded_axes``, which
    the train step reads: it gathers them over the data axis only)."""
    data_sum = functools.partial(
        mesh.all_reduce, axis=tuple(getattr(mesh, "data_axes", ("data",))))

    def loss(params, batch):
        logits, _, _ = mfwd(params, batch)
        term, ce = ce_terms(logits, batch["labels"], data_sum)
        return term, {"ce": ce, "loss": ce}

    loss.sharded_axes = ("model",)
    return loss
