"""Training launcher of the port: ``repro.launch.train``'s counterpart.

Builds the train step for an ``--arch``, on one device or over a ``(data,
model)`` mesh, restores the latest checkpoint in ``--ckpt-dir`` if one is
committed there, and runs the resilient loop with checkpoints every 50
steps and deterministic data replay:

    python -m repro_torch.launch.train --arch granite-8b --steps 100 \\
        [--reduced] [--device cuda|cpu] [--ckpt-dir DIR]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch granite-8b --data-mesh 2 --model-mesh 2 [...]

Run it from ``src/`` or with ``repro_torch`` importable.  The step runs in
float32 with ``attn_impl="flash_jax"`` (``"dense"`` under ``--reduced``),
the config's remat, optimizer and microbatches.  With ``--data-mesh`` or
``--model-mesh`` above 1 it is one process of ``data * model``, one per
mesh position, as torchrun starts them: it joins the process group from
torchrun's environment (``env://``; NCCL when each local rank has a card
of its own, gloo when ranks share one or with ``--device cpu``), runs on
``cuda:(local_rank % device_count)``, lays the state out by JAX's rules
(``state_shardings``) and keeps only its blocks.  Without torchrun's
environment or an initialised group it raises ``make_local_mesh``'s
error: nothing falls back to one device.  Rank 0 prints and writes the
checkpoints.
"""
from __future__ import annotations

import argparse
import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.checkpoint import tree_flatten
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist.sharding import ShardingRules, shard_tree
from repro_torch.launch.mesh import (join_from_env, local_device,
                                     make_local_mesh)
from repro_torch.models import FwdOptions, model_dims
from repro_torch.runtime import ResilientLoop, restore_like
from repro_torch.train import (TrainConfig, abstract_state, init_state,
                               make_train_step, state_shardings)

COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def join_mesh(data: int, model: int, device: str):
    """``(mesh, device, created)``: this process's place in the ``(data,
    model)`` mesh, over the initialised group or one joined from
    torchrun's environment (``created``: joined here).  Without either,
    ``make_local_mesh`` raises its error."""
    created = join_from_env(device, COLLECTIVE_TIMEOUT)
    mesh = make_local_mesh(data, model)
    return mesh, local_device(device), created


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU friendly)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the train step's deterministic mode needs cuBLAS's deterministic
    # workspace on the card; cuBLAS reads it at its first call in the process
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    mesh = None
    device, created = args.device, False
    if args.data_mesh * args.model_mesh > 1:
        mesh, device, created = join_mesh(args.data_mesh, args.model_mesh,
                                          args.device)
    try:
        run(args, mesh, device)
    finally:
        if created:
            dist.destroy_process_group()


def run(args, mesh, device) -> None:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    rules = ShardingRules(data_axes=("data",),
                          zero_params=cfg.zero_shard_params)
    dims = model_dims(cfg, tp=args.model_mesh)
    tc = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                     total_steps=args.steps, dtype=torch.float32,
                     microbatches=cfg.train_microbatches)
    gen = torch.Generator(device).manual_seed(0)
    state = init_state(gen, cfg, dims, tc, device=device)
    n_params = sum(p.numel() for p in tree_flatten(state["params"])[0])
    specs = None
    if mesh is not None:
        # every rank draws the same whole state and keeps its blocks
        specs = state_shardings(abstract_state(cfg, dims, tc, torch.float32),
                                mesh, rules)
        state = shard_tree(state, specs, mesh)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    say(f"arch={cfg.name} params={n_params/1e6:.1f}M mesh="
        f"{args.data_mesh}x{args.model_mesh}")

    step_fn = make_train_step(cfg, dims, tc, FwdOptions(
        attn_impl="dense" if args.reduced else "flash_jax",
        dtype=torch.float32, remat=cfg.remat), mesh, rules, specs=specs)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, seed=0,
        frontend_tokens=cfg.frontend_tokens if cfg.frontend != "none" else 0,
        d_model=cfg.d_model))
    ckpt = CheckpointManager(args.ckpt_dir, keep_last=3, mesh=mesh,
                             specs=specs)
    if ckpt.latest_step() is not None:
        restored, s = ckpt.restore(state)
        state = restore_like(restored, state)
        say(f"restored checkpoint at step {s}")
    loop = ResilientLoop(ckpt, data, step_fn, ckpt_every=50)
    t0 = time.perf_counter()
    report = loop.run(state, total_steps=args.steps)
    ms = (time.perf_counter() - t0) * 1e3 / max(report.steps_run, 1)
    say(f"done: {report.steps_run} steps, loss "
        f"{report.losses[0]:.3f} -> {report.losses[-1]:.3f}, {ms:.1f} ms a "
        "step (wall, checkpoints included)")


if __name__ == "__main__":
    main()
