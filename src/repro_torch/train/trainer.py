"""Train step factory: the port of ``repro.train.trainer``.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)`` with:
* microbatch gradient accumulation (the losses and metrics the
  microbatches' mean, the gradients their sum over the count, in
  ``accum_dtype``),
* remat (``FwdOptions.remat``: each layer under ``torch.utils.checkpoint``),
* gradient clipping by the global norm and the LR schedule,
* optional int8 + error-feedback gradient compression,
* the in-place optimizer update (``optim``), then ``step + 1``,
* ``loss_override(params, batch) -> (loss, metrics)`` in place of the
  model's loss (the tensor-parallel forward of ``dist/megatron.py``).

The step runs with ``torch.use_deterministic_algorithms(True)``
(``deterministic``): on the card the backward of a gather (the embedding
lookup, the MoE dispatch and combine, the loss's label pick) accumulates
with atomics in an order that varies from run to run, and the
deterministic mode makes those sums sort-based, so that a step replayed
from a checkpoint repeats its first run bit for bit.  On the card that
mode also asks for ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (or ``:16:8``),
which cuBLAS reads once, at its first call in the process: the entry
points (``launch/train.py``, ``chip_smoke.py``) set it before any; a
caller of ``make_train_step`` on the card sets it likewise, or the first
matrix product of the step raises.

The state is ``{"params", "opt", "step" (int32 0-d), "ef"?}``.  On one
device every tensor is whole and the parameters are leaves that require
grad.  Over a ``(data, model)`` mesh (``launch/mesh.py``: one process a
position) each rank holds only its block of every leaf, laid out by
``state_shardings`` (JAX's rules, ``dist/sharding.py``), and a step gives
what the single-device step gives: see ``make_train_step``.
``abstract_state`` is the state on the ``meta`` device (shapes and
dtypes, no memory), from which the specs are taken.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from repro_torch.ckpt.checkpoint import (flatten_up_to, tree_flatten,
                                        tree_unflatten)
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import compression
from repro_torch.dist.sharding import (P, ShardingRules, block_of,
                                       block_tree, param_shardings,
                                       whole_of)
from repro_torch.launch.mesh import AXES
from repro_torch.models.transformer import FwdOptions, loss_fn
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.params import init_params


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    max_grad_norm: float = 1.0
    microbatches: int = 1
    grad_compression: bool = False     # int8 + error feedback (cross-pod DP)
    weight_decay: float = 0.1
    dtype: Any = torch.bfloat16
    accum_dtype: Any = torch.float32   # grad-accum buffer (bf16 for 100B+)


def make_schedule(tc: TrainConfig):
    return warmup_cosine(tc.lr, tc.warmup_steps, tc.total_steps)


def state_from_params(params, cfg: ArchConfig, tc: TrainConfig):
    """The train state around ``params`` (each leaf set to require grad):
    the optimizer's zero state, step 0, and the EF residuals when
    ``tc.grad_compression``."""
    leaves = tree_flatten(params)[0]
    for p in leaves:
        p.requires_grad_(True)
    opt = make_optimizer(cfg.optimizer, weight_decay=tc.weight_decay)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=leaves[0].device)}
    if tc.grad_compression:
        state["ef"] = compression.init_ef(params)
    return state


def init_state(generator: torch.Generator, cfg: ArchConfig, dims,
               tc: TrainConfig, param_dtype=torch.float32, device="cuda"):
    """Parameters drawn by ``params.init_params`` from ``generator`` (which
    lives on ``device``), in ``state_from_params``' state."""
    params = init_params(generator, cfg, dims, dtype=param_dtype,
                         device=device)
    return state_from_params(params, cfg, tc)


def abstract_state(cfg: ArchConfig, dims, tc: TrainConfig,
                   param_dtype=torch.bfloat16):
    """The state on the ``meta`` device: every leaf's shape and dtype, no
    memory (the JAX package's ``ShapeDtypeStruct`` tree)."""
    params = init_params(None, cfg, dims, dtype=param_dtype, device="meta")
    return state_from_params(params, cfg, tc)


@contextlib.contextmanager
def deterministic():
    """Hold ``torch.use_deterministic_algorithms(True)``, then restore the
    caller's setting."""
    enabled = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(enabled, warn_only=warn_only)


def make_train_step(cfg: ArchConfig, dims, tc: TrainConfig,
                    fwd: FwdOptions, mesh=None,
                    rules: Optional[ShardingRules] = None,
                    loss_override: Optional[Callable] = None, *,
                    specs=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds tensors on the state's device.  The step updates the state's
    tensors in place and returns a new dict around them (``step`` is a new
    tensor).

    ``loss_override(params, batch) -> (loss, metrics)`` swaps the model's
    loss (e.g. the explicit-schedule Megatron path, ``dist/megatron.py``).

    Over a mesh (``mesh``: this rank's ``launch.mesh.Mesh``; ``rules``:
    the ``ShardingRules``, JAX's defaults when None) the state holds this
    rank's blocks, and ``specs`` is its layout: the tree of
    ``PartitionSpec`` that ``state_shardings`` gives (or
    ``megatron_param_shardings`` for the parameters and their moments).
    It is the port's counterpart of the JAX step's ``jax.jit(
    in_shardings=...)``, from which JAX learns the layout.  ``batch`` is
    the global batch, the same on every rank (every rank draws
    ``data.batch_at(step)``).  The step

    * takes this rank's rows of it, as ``batch_spec`` splits the batch over
      the data axis (with microbatches, this rank's rows of each
      microbatch, so that a microbatch holds the single device's rows);
      where a microbatch's rows do not split evenly over the data axis,
      every data rank takes the whole microbatch, as ``batch_spec``'s
      ``_guard`` replicates it, and the step then sums neither the loss
      over the data group nor the gradients (each rank's are already the
      whole batch's);
    * gathers each parameter leaf whole; a ``loss_override`` with a
      ``sharded_axes`` attribute takes the blocks of those axes as they lie
      (``dist.megatron.megatron_loss``: the model axis's), and one without
      it takes whole leaves, as the model's loss does;
    * runs the forward and backward; the loss sums its numerator and its
      label count over the data axis (``models.transformer.ce_terms``);
      an MoE layer routes every data rank's rows and keeps this rank's, so
      that capacity and queue places are the single device's, and its
      aux losses, whole-batch means, count once over the data axis;
    * sums the gradients over the data group, keeps this rank's block, and
      clips, compresses and updates that block in place, with the
      whole-leaf statistics (``optim``, ``dist/compression.py``) taken over
      the whole leaf.

    Ranks along the model axis repeat the same compute; the model axis's
    own tensor-parallel compute is the Megatron schedule's.  A
    ``loss_override`` on a mesh returns this rank's term of the loss (the
    data group's terms sum to it) and the whole batch's metrics, as
    ``dist.megatron.megatron_loss`` does."""
    opt = make_optimizer(cfg.optimizer, weight_decay=tc.weight_decay)
    schedule = make_schedule(tc)
    if mesh is None:
        if specs is not None:
            raise ValueError("specs lay out a sharded state: pass the mesh")
        model_loss = functools.partial(loss_fn, cfg=cfg, dims=dims, opt=fwd)

        def split(batch):
            return _microbatches(batch, tc.microbatches)
    else:
        if specs is None:
            raise ValueError("a mesh step needs the state's specs "
                             "(state_shardings(abstract_state(...), mesh, "
                             "rules))")
        rules = rules or ShardingRules()
        data_axes = tuple(rules.data_axes)
        data_sum = functools.partial(mesh.all_reduce, axis=data_axes)
        model_loss = functools.partial(
            loss_fn, cfg=cfg, dims=dims,
            opt=dataclasses.replace(fwd, moe_rows=MoeRows(mesh, data_axes)),
            data_sum=data_sum, data_size=mesh.data_size)
        whole_loss = functools.partial(loss_fn, cfg=cfg, dims=dims, opt=fwd)

        rows = P(data_axes)                    # batch_spec's leading dim

        def split(batch):
            return [{k: block_of(x, rows, mesh) for k, x in m.items()}
                    for m in _microbatches(batch, tc.microbatches)]

    loss_of = loss_override or model_loss

    def metrics_and_grads(params, batch, loss_of=loss_of):
        """(metrics, the gradient of each leaf in tree_flatten order)."""
        loss, metrics = loss_of(params, batch)
        grads = torch.autograd.grad(loss, tree_flatten(params)[0],
                                    materialize_grads=True)
        return {k: m.detach() for k, m in metrics.items()}, list(grads)

    def compute_grads(params, batch, loss_of=loss_of, split=split):
        micros = split(batch)
        if len(micros) == 1:
            return metrics_and_grads(params, micros[0], loss_of)
        # gradient accumulation over microbatches; the metrics (the loss
        # among them) are the microbatches' mean
        acc, mets = None, []
        for micro in micros:
            metrics, grads = metrics_and_grads(params, micro, loss_of)
            grads = [g.to(tc.accum_dtype) for g in grads]
            if acc is None:
                acc = grads
            else:
                for a, g in zip(acc, grads):
                    a.add_(g)
            mets.append(metrics)
        metrics = {k: torch.stack([m[k] for m in mets]).mean()
                   for k in mets[0]}
        return metrics, [a.div_(len(micros)) for a in acc]

    def update(state, params, grads, metrics, blocks=None):
        grads, gnorm = clip_by_global_norm(grads, tc.max_grad_norm, blocks)
        new_state = dict(state)
        if tc.grad_compression:
            grads, new_state["ef"] = compression.tree_compress_with_ef(
                grads, state["ef"], blocks)
        lr = schedule(state["step"])
        new_params, new_opt = opt.update(grads, state["opt"], params,
                                         state["step"], lr, blocks=blocks)
        new_state.update(params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        metrics.update(grad_norm=gnorm, lr=lr)
        return new_state, metrics

    def train_step(state, batch):
        params = state["params"]
        with deterministic():
            metrics, grads = compute_grads(params, batch)
            return update(state, params, tree_unflatten(params, grads),
                          metrics)

    if mesh is None:
        return train_step
    p_specs = specs["params"]
    # the step gathers each leaf over the axes whose blocks the loss does
    # not take as they lie (``loss_override.sharded_axes``)
    kept = getattr(loss_override, "sharded_axes", ())
    axes = tuple(a for a in getattr(mesh, "axis_names", AXES)
                 if a not in kept)

    def replicated(batch) -> bool:
        """Whether a microbatch's rows do not split over the data axis."""
        rows = next(iter(batch.values())).shape[0] // max(tc.microbatches, 1)
        return rows % mesh.data_size != 0

    def mesh_train_step(state, batch):
        rep = replicated(batch)
        if rep and loss_override is not None:
            raise ValueError("a loss_override sums its terms over the data "
                             "axis: give it a batch whose microbatch rows "
                             "split over the data axis")
        blocks = state["params"]
        flat, sp = tree_flatten(blocks)[0], tree_flatten(p_specs)[0]
        with deterministic():
            with torch.no_grad():
                whole = [whole_of(b, s, mesh, axes) for b, s in zip(flat, sp)]
            params = tree_unflatten(blocks, [
                w.detach().requires_grad_(True) for w in whole])
            del whole
            if rep:
                metrics, grads = compute_grads(
                    params, batch, whole_loss,
                    lambda b: _microbatches(b, tc.microbatches))
            else:
                metrics, grads = compute_grads(params, batch)
            del params
            grads = [block_of(g if rep else data_sum(g), s, mesh, axes)
                     for g, s in zip(grads, sp)]
            return update(state, blocks, tree_unflatten(blocks, grads),
                          metrics, block_tree(blocks, p_specs, mesh))

    return mesh_train_step


def _microbatches(batch, mb: int):
    """``batch``'s microbatches (its leading dim in ``mb`` contiguous
    runs; the batch itself when ``mb <= 1``)."""
    rows = next(iter(batch.values())).shape[0]
    mb = max(mb, 1)
    if rows % mb:
        raise ValueError(f"a batch of {rows} rows does not split into {mb} "
                         "microbatches")
    if mb == 1:
        return [batch]
    return [{k: x.reshape(mb, rows // mb, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(mb)]


class _GatherRows(torch.autograd.Function):
    """All-gather of the data group's rows (dim 0) forward; backward, each
    rank's gradient of the whole is a partial one (its own rows' outputs,
    its share of the aux losses), so the rank's rows take the group's sum."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.rows = mesh, axes, x.shape[0]
        return mesh.all_gather(x, 0, axes)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_reduce(g.contiguous().clone(), ctx.axes)
        i = ctx.mesh.data_index
        return g[i * ctx.rows:(i + 1) * ctx.rows], None, None


class MoeRows:
    """``FwdOptions.moe_rows`` on a mesh whose data axis splits the batch:
    the MoE routes the whole batch's rows, in the single device's order,
    and each rank keeps its own rows of the output."""

    def __init__(self, mesh, axes=("data",)):
        self.mesh, self.axes = mesh, tuple(axes)

    def gather(self, h: torch.Tensor) -> torch.Tensor:
        return _GatherRows.apply(h, self.mesh, self.axes)

    def keep(self, out: torch.Tensor) -> torch.Tensor:
        n = out.shape[0] // self.mesh.data_size
        return out[self.mesh.data_index * n:(self.mesh.data_index + 1) * n]


def state_shardings(state_shape, mesh, rules: ShardingRules):
    """``PartitionSpec``s for the full train state (the optimizer state
    mirrors the parameters)."""
    p_sh = param_shardings(state_shape["params"], rules, mesh)
    out = {"params": p_sh, "step": P()}
    if "opt" in state_shape:
        o = state_shape["opt"]
        if "m" in o:   # adamw: m/v mirror params exactly
            out["opt"] = {"m": p_sh, "v": p_sh}
        else:          # adafactor: vr/vc factors drop one dim's spec
            out["opt"] = {"v": _adafactor_shardings(
                o["v"], state_shape["params"], p_sh)}
    if "ef" in state_shape:
        # EFState(residual) mirrors the parameter sharding
        out["ef"] = tree_unflatten(p_sh, [
            compression.EFState(residual=s)
            for s in tree_flatten(p_sh)[0]])
    return out


def _adafactor_shardings(v_tree, params_shape, p_sh):
    """vr drops the last dim's spec; vc drops the second-to-last."""
    flat_p = tree_flatten(params_shape)[0]
    flat_sh = flatten_up_to(params_shape, p_sh)
    flat_v = flatten_up_to(params_shape, v_tree)

    def factor_sh(p, sh, v):
        full = tuple(sh) + (None,) * (len(p.shape) - len(sh))
        if "vr" in v:
            return {"vr": P(*full[:-1]), "vc": P(*(full[:-2] + full[-1:]))}
        return {"v": sh}

    return tree_unflatten(params_shape, [
        factor_sh(p, sh, v) for p, sh, v in zip(flat_p, flat_sh, flat_v)])
