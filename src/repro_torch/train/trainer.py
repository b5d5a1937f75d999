"""Single-device train step factory: the port of ``repro.train.trainer``.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)`` with:
* microbatch gradient accumulation (the losses and metrics the
  microbatches' mean, the gradients their sum over the count, in
  ``accum_dtype``),
* remat (``FwdOptions.remat``: each layer under ``torch.utils.checkpoint``),
* gradient clipping by the global norm and the LR schedule,
* optional int8 + error-feedback gradient compression,
* the in-place optimizer update (``optim``), then ``step + 1``.

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

The state is ``{"params", "opt", "step" (int32 0-d), "ef"?}``, every
tensor on one device; parameters are leaves that require grad.  Training
over a mesh is not ported yet (ROADMAP, mesh training).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from repro_torch.ckpt.checkpoint import tree_flatten, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import compression
from repro_torch.models.transformer import FwdOptions, loss_fn
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.params import init_params

MESH_TODO = ("training over a mesh is not ported yet (ROADMAP Queue 1, "
             "mesh training)")


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
                    fwd: FwdOptions, mesh=None, rules=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds tensors on the state's device.  The step updates the state's
    tensors in place and returns a new dict around them (``step`` is a new
    tensor).  ``mesh`` and ``rules`` raise: training over a mesh is a
    later slice."""
    if mesh is not None or rules is not None:
        raise NotImplementedError(MESH_TODO)
    opt = make_optimizer(cfg.optimizer, weight_decay=tc.weight_decay)
    schedule = make_schedule(tc)

    def metrics_and_grads(params, batch):
        """(metrics, the gradient of each leaf in tree_flatten order)."""
        loss, metrics = loss_fn(params, batch, cfg, dims, fwd)
        grads = torch.autograd.grad(loss, tree_flatten(params)[0],
                                    materialize_grads=True)
        return {k: m.detach() for k, m in metrics.items()}, list(grads)

    def compute_grads(params, batch):
        if tc.microbatches <= 1:
            metrics, grads = metrics_and_grads(params, batch)
            return metrics, tree_unflatten(params, grads)
        # gradient accumulation over microbatches (the batch dim splits);
        # the metrics (the loss among them) are the microbatches' mean
        mb = tc.microbatches
        acc, mets = None, []
        for i in range(mb):
            micro = {k: x.reshape(mb, x.shape[0] // mb, *x.shape[1:])[i]
                     for k, x in batch.items()}
            metrics, grads = metrics_and_grads(params, micro)
            grads = [g.to(tc.accum_dtype) for g in grads]
            if acc is None:
                acc = grads
            else:
                for a, g in zip(acc, grads):
                    a.add_(g)
            mets.append(metrics)
        metrics = {k: torch.stack([m[k] for m in mets]).mean()
                   for k in mets[0]}
        return metrics, tree_unflatten(params, [a.div_(mb) for a in acc])

    def train_step(state, batch):
        params = state["params"]
        with deterministic():
            metrics, grads = compute_grads(params, batch)
            grads, gnorm = clip_by_global_norm(grads, tc.max_grad_norm)
            new_state = dict(state)
            if tc.grad_compression:
                grads, new_state["ef"] = compression.tree_compress_with_ef(
                    grads, state["ef"])
            lr = schedule(state["step"])
            new_params, new_opt = opt.update(grads, state["opt"], params,
                                             state["step"], lr)
        new_state.update(params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        metrics.update(grad_norm=gnorm, lr=lr)
        return new_state, metrics

    return train_step
