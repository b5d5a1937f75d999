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

``ServingTP`` is the same split, forward only and for every family, on a
token-split serving rank (``serve/decode.py``, ``serve/prefill.py``):
the weights are the rank's blocks under JAX's ``param_shardings``
(``ShardingRules(zero_params=cfg.zero_shard_params)``), gathered over
the data axes one layer at a time where ZeRO splits them; column-parallel
projections, row-parallel ones closed by one float32 sum over the model
group, the vocab-split embedding and head, expert-parallel MoE layers and
head-parallel mamba sublayers.  The model code takes it as
``FwdOptions.tp`` and the decode sublayers as ``tp``; both share the
helpers below with the training schedule.
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
from repro_torch.params import init_params

from .sharding import (P, ShardingRules, ZeroGather, _own, _path_names,
                       _sizes, block_of, block_shapes, map_with_path,
                       param_shardings, shard_tree)


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


# ------------------------------------------- shared by both schedules

def local_kv_heads(k, v, n_heads: int, n_kv: int, h_loc: int, m: int):
    """``k``/``v`` (B, S, n_kv, hd), whole, cut to the KV head of each of
    this rank's ``h_loc`` query heads (rank ``m`` holds query heads ``[m *
    h_loc, (m + 1) * h_loc)``): (B, S, h_loc, hd) each.  The schedules
    keep KV whole where ``n_kv`` does not split over the model axis."""
    g = n_heads // n_kv
    idx = (m * h_loc + torch.arange(h_loc, device=k.device)) // g
    return k[:, :, idx], v[:, :, idx]


def vocab_block_rows(table, tokens, m: int):
    """The embedding rows of ``tokens`` that rank ``m``'s vocab block
    ``table`` (V / tp, d) holds, zeros for the others: summed over the
    model group, the whole table's rows (one nonzero term each)."""
    v_loc = table.shape[0]
    idx = tokens.long() - m * v_loc
    ok = (idx >= 0) & (idx < v_loc)
    x = table[idx.clamp(0, v_loc - 1)]
    return torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))


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
            k, v = local_kv_heads(k, v, dims.n_heads, dims.n_kv, H_loc,
                                  m_idx)
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
            x = reduce_from(vocab_block_rows(table, tokens, m_idx), mesh)
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


# ---------------------------------------------- the serving schedule

def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes, its last dim widened by the element size (a
    collective then moves bytes, which gloo takes in any dtype)."""
    return t.contiguous().view(torch.uint8)


class ServingTP:
    """Tensor parallelism of a token-split serving rank, forward only.

    ``cfg``/``dims`` the model, ``mesh`` the rank's mesh, ``rules`` the
    sharding rules of its weights (``sharding.serving_rules``).  The
    rank's parameters are its blocks under ``specs``
    (``param_shardings``): ``blocks(whole)`` cuts them from a whole tree
    (on the host, or wherever the tree lies), ``layer``/``subtree`` give a
    layer's (or a top-level entry's) leaves gathered over the data axes
    (``ZeroGather``), still cut along the model axis, and ``check``
    refuses a tree whose leaves are not the blocks' shapes.

    The ops tell a model-split weight from a whole one by its shape
    against the whole width the caller names (``_guard`` keeps a dim
    whole where the axis does not divide it), so one call serves both:
    ``col`` is the column-parallel projection (the rank's columns, or
    all of them), ``row`` the row-parallel one (the rank's rows of the
    input times its block, closed by one float32 sum over the model
    group), ``embed``/``unembed`` the vocab-split table, ``qkv`` the
    attention projections on the rank's query heads, ``mlp`` the gated
    MLP.  ``sum``, ``cat`` and ``cat_cols`` are the collectives over the
    model group."""

    def __init__(self, cfg, dims, mesh, rules: ShardingRules):
        self.cfg, self.dims, self.mesh = cfg, dims, mesh
        ax = mesh.axis(rules.model_axis)
        self.tp, self.m, self.ma = ax.size, ax.index, rules.model_axis
        whole = init_params(None, cfg, dims, device="meta")
        self.specs = param_shardings(whole, rules, mesh)
        self.shapes = block_shapes(whole, self.specs, mesh)
        self.zero = ZeroGather(self.specs, mesh, rules.data_axes)
        self._checked = set()

    # -- the rank's weights ------------------------------------------
    def blocks(self, params):
        """This rank's blocks of the whole tree ``params``."""
        return shard_tree(params, self.specs, self.mesh)

    def draw(self, generator, dtype=torch.float32, device="cuda"):
        """This rank's blocks of ``params.init_params(generator, ...)``,
        each matrix cut as soon as it is drawn: bitwise ``blocks`` of the
        whole draw, without ever holding a whole leaf (an MoE layer's
        experts excepted) on ``device``."""

        def cut(path, x):
            spec = tuple(_leaf_at(self.specs, path))
            spec = (None,) * max(0, x.dim() - len(spec)) + spec
            return _own(block_of(x, P(*spec[len(spec) - x.dim():]),
                                 self.mesh), x)

        return init_params(generator, self.cfg, self.dims, dtype, device,
                           cut=cut)

    def check(self, params) -> None:
        """Raise unless every leaf of ``params`` has this rank's block's
        shape (once per tree)."""
        key = id(params)
        if key in self._checked:
            return

        def cmp(path, x):
            w = _leaf_at(self.shapes, path)
            if tuple(x.shape) != tuple(w):
                raise ValueError(
                    f"token-split weights: {'.'.join(path)} has shape "
                    f"{tuple(x.shape)}, this rank's block is {tuple(w)} "
                    "(cut the whole tree with ServingTP.blocks)")

        map_with_path(cmp, params)
        self._checked.add(key)

    def layer(self, params, i: int, path=("layers",)):
        return self.zero.take(params, tuple(path), i)

    def subtree(self, params, *path):
        return self.zero.subtree(params, tuple(path))

    # -- collectives over the model group --------------------------------
    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the model group in float32, in ``t``'s
        dtype."""
        if self.tp == 1:
            return t
        return self.mesh.all_reduce(t.float(), self.ma).to(t.dtype)

    def cat(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The model group's blocks of ``t`` concatenated along ``dim``
        in rank order (one all-gather of their bytes)."""
        if self.tp == 1:
            return t
        return self.mesh.all_gather(_bytes_of(t), dim % t.dim(),
                                    self.ma).view(t.dtype)

    def cat_cols(self, ts, widths):
        """Each of ``ts`` (same leading dims) whole along its last dim,
        ``widths`` the whole widths: the column blocks among them (last
        dim below its width) come from one all-gather, the rest are
        returned as they are."""
        part = [i for i, (t, n) in enumerate(zip(ts, widths))
                if t.shape[-1] != n]
        if not part:
            return list(ts)
        lead = ts[part[0]].shape[:-1]
        flat = [ts[i].reshape(-1, ts[i].shape[-1]) for i in part]
        buf = torch.cat(flat, dim=-1)
        got = self.mesh.all_gather(_bytes_of(buf)[None], 0, self.ma).view(
            buf.dtype)                                  # (tp, rows, sum)
        out, at = list(ts), 0
        for i, f in zip(part, flat):
            n = f.shape[-1]
            out[i] = got[..., at:at + n].transpose(0, 1).reshape(
                *lead, self.tp * n)
            at += n
        return out

    # -- the ops -----------------------------------------------------------
    def col(self, p, x: torch.Tensor, n_out: int,
            whole: bool = False) -> torch.Tensor:
        """``x @ w (+ b)`` of a column-parallel projection of ``n_out``
        whole columns: the rank's columns where ``w`` is split (all of
        them with ``whole``, one all-gather), else all."""
        w = p["w"]
        y = x @ w.to(x.dtype)
        n = w.shape[-1]
        split = n != n_out
        if "b" in p:
            b = p["b"]
            if split and b.shape[-1] == n_out:
                b = b.narrow(-1, self.m * n, n)
            y = y + b.to(x.dtype)
        if split and whole:
            y = self.cat(y)
        return y

    def row(self, p, x: torch.Tensor, n_in: int) -> torch.Tensor:
        """``x @ w (+ b)`` of a row-parallel projection of ``n_in`` whole
        input features; ``x`` holds them all or the rank's block.  Where
        ``w`` is split, the rank's product is summed over the model group
        in float32."""
        w = p["w"]
        n = w.shape[-2]
        if n == n_in:
            if x.shape[-1] != n_in:
                x = self.cat(x)
            y = x @ w.to(x.dtype)
        else:
            if x.shape[-1] == n_in:
                x = x.narrow(-1, self.m * n, n)
            y = self.sum(x @ w.to(x.dtype))
        if "b" in p:
            y = y + p["b"].to(x.dtype)
        return y

    def embed(self, table: torch.Tensor, tokens: torch.Tensor):
        """The rows of ``tokens`` from the (vocab-split) ``table``."""
        if table.shape[0] == self.dims.vocab:
            return table[tokens.long()]
        return self.sum(vocab_block_rows(table, tokens, self.m))

    def unembed(self, table: torch.Tensor, x: torch.Tensor,
                logical_vocab: int) -> torch.Tensor:
        """``layers.unembed`` over the (vocab-split) ``table``: the rank's
        logits, one all-gather, then the padded ids' mask."""
        logits = x @ table.T.to(x.dtype)
        if table.shape[0] != self.dims.vocab:
            logits = self.cat(logits)
        return L.mask_vocab(logits, logical_vocab)

    def heads_local(self, p_q) -> bool:
        """Whether the rank's query heads are whole heads of its own
        (``q``'s columns split on a head boundary)."""
        H, hd = self.dims.n_heads, self.dims.head_dim
        return p_q["w"].shape[-1] != H * hd and H % self.tp == 0

    def qkv(self, p, x, xkv, positions, kv_positions, theta: float,
            want_kv: bool = False):
        """``layers.qkv_project`` on this rank: ``(q, k, v, kv)`` with q
        the rank's query heads (B, S, H / tp, hd) and k/v the KV heads
        they read (its own KV heads where ``n_kv`` splits over the model
        axis; else the whole KV projection, from the gathered weight, cut
        to each query head's KV head, ``local_kv_heads``), and ``kv`` the
        whole KV heads ``(k, v)`` (B, Skv, n_kv, hd) when ``want_kv`` (one
        all-gather of the rank's KV heads), else None.  Where the query
        heads do not split on a head boundary every head is computed
        (the projections' columns gathered)."""
        H, KV, hd = self.dims.n_heads, self.dims.n_kv, self.dims.head_dim
        B, S = x.shape[:2]
        Skv = xkv.shape[1]
        if not self.heads_local(p["q"]):
            q, k, v = self.cat_cols(
                [self.col(p["q"], x, H * hd), self.col(p["k"], xkv, KV * hd),
                 self.col(p["v"], xkv, KV * hd)],
                [H * hd, KV * hd, KV * hd])
            q, k, v = (q.reshape(B, S, H, hd), k.reshape(B, Skv, KV, hd),
                       v.reshape(B, Skv, KV, hd))
            if theta > 0:
                q = L.apply_rope(q, positions, theta)
                k = L.apply_rope(k, kv_positions, theta)
            return q, k, v, ((k, v) if want_kv else None)
        h_loc = H // self.tp
        q = self.col(p["q"], x, H * hd).reshape(B, S, h_loc, hd)
        if theta > 0:
            q = L.apply_rope(q, positions, theta)
        if KV % self.tp == 0 and p["k"]["w"].shape[-1] != KV * hd:
            kv_loc = KV // self.tp
            k = self.col(p["k"], xkv, KV * hd).reshape(B, Skv, kv_loc, hd)
            v = self.col(p["v"], xkv, KV * hd).reshape(B, Skv, kv_loc, hd)
            if theta > 0:
                k = L.apply_rope(k, kv_positions, theta)
            kv = None
            if want_kv:
                kv = (self.cat(k, 2), self.cat(v, 2))
            return q, k, v, kv
        whole = {n: dict(p[n], w=self.cat(p[n]["w"])
                         if p[n]["w"].shape[-1] != KV * hd else p[n]["w"])
                 for n in ("k", "v")}
        k = L.linear(whole["k"], xkv).reshape(B, Skv, KV, hd)
        v = L.linear(whole["v"], xkv).reshape(B, Skv, KV, hd)
        if theta > 0:
            k = L.apply_rope(k, kv_positions, theta)
        kv = (k, v) if want_kv else None
        k, v = local_kv_heads(k, v, H, KV, h_loc, self.m)
        return q, k, v, kv

    def mlp(self, p, x: torch.Tensor, act=F.silu) -> torch.Tensor:
        """``layers.mlp``: column-parallel gate/up, row-parallel down."""
        ff = self.dims.d_ff
        g = act(self.col(p["gate"], x, ff)) * self.col(p["up"], x, ff)
        return self.row(p["down"], g, ff)


def _leaf_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree
