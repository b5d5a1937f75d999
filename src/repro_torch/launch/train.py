"""Training launcher of the port: ``repro.launch.train``'s counterpart.

Builds the train step for an ``--arch`` on one device, restores the latest
checkpoint in ``--ckpt-dir`` if one is committed there, and runs the
resilient loop with checkpoints every 50 steps and deterministic data
replay:

    python -m repro_torch.launch.train --arch granite-8b --steps 100 \\
        [--reduced] [--device cuda|cpu] [--ckpt-dir DIR]

Run it from ``src/`` or with ``repro_torch`` importable.  The step runs in
float32 with ``attn_impl="flash_jax"`` (``"dense"`` under ``--reduced``),
the config's remat, optimizer and microbatches.  ``--data-mesh`` and
``--model-mesh`` above 1 raise: training over a mesh is a later slice.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.checkpoint import tree_flatten
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import FwdOptions, model_dims
from repro_torch.runtime import ResilientLoop, restore_like
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.trainer import MESH_TODO


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

    if args.data_mesh * args.model_mesh > 1:
        raise NotImplementedError(MESH_TODO)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    dims = model_dims(cfg, tp=args.model_mesh)
    tc = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                     total_steps=args.steps, dtype=torch.float32,
                     microbatches=cfg.train_microbatches)
    gen = torch.Generator(args.device).manual_seed(0)
    state = init_state(gen, cfg, dims, tc, device=args.device)
    n_params = sum(p.numel() for p in tree_flatten(state["params"])[0])
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M mesh="
          f"{args.data_mesh}x{args.model_mesh}")

    step_fn = make_train_step(cfg, dims, tc, FwdOptions(
        attn_impl="dense" if args.reduced else "flash_jax",
        dtype=torch.float32, remat=cfg.remat))
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, seed=0,
        frontend_tokens=cfg.frontend_tokens if cfg.frontend != "none" else 0,
        d_model=cfg.d_model))
    ckpt = CheckpointManager(args.ckpt_dir, keep_last=3)
    if ckpt.latest_step() is not None:
        restored, s = ckpt.restore(state)
        state = restore_like(restored, state)
        print(f"restored checkpoint at step {s}")
    loop = ResilientLoop(ckpt, data, step_fn, ckpt_every=50)
    report = loop.run(state, total_steps=args.steps)
    print(f"done: {report.steps_run} steps, loss "
          f"{report.losses[0]:.3f} -> {report.losses[-1]:.3f}")


if __name__ == "__main__":
    main()
