"""End-to-end example of the PyTorch port: train a ~100M-param LM.

Uses the port's training stack on one device: the config system, the
synthetic data pipeline, AdamW with a warmup-cosine schedule, remat,
asynchronous checkpoints and the resilient loop (checkpoint and restart).
A failure is injected mid-run: the loop restores the last checkpoint and
replays the lost steps, and the final weights are bitwise those of a run
that never failed (``--fail-at -1``; the printed digest shows it).  The
counterpart of ``train_lm.py``; it imports only ``repro_torch``, torch
and numpy.

Run:  python examples/train_lm_torch.py [--steps 300] [--device cpu]
      [--reduced] [--fail-at STEP]
"""
import argparse
import dataclasses
import hashlib
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.ckpt.checkpoint import tree_flatten  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import FwdOptions, model_dims  # noqa: E402
from repro_torch.runtime import FaultInjector, ResilientLoop  # noqa: E402
from repro_torch.train import (TrainConfig, init_state,  # noqa: E402
                               make_train_step)


def config(arch: str, small: bool):
    """``arch`` rescaled to ~100M parameters (as ``train_lm.py`` does),
    or with ``small`` its smoke-test reduction."""
    base = ARCHS[arch]
    if small:
        return reduced(base)
    return dataclasses.replace(
        base, num_layers=min(base.num_layers, 8), d_model=640,
        num_heads=8 if base.num_heads else 0,
        num_kv_heads=min(base.num_kv_heads, 4) if base.num_kv_heads else 0,
        head_dim=64 if base.num_heads else None,
        d_ff=2560 if base.d_ff else 0, vocab_size=32768,
        moe_num_experts=min(base.moe_num_experts, 8),
        encoder_layers=2 if base.is_encoder_decoder else 0,
        frontend_tokens=16 if base.frontend != "none" else 0)


def digest(params) -> str:
    """sha256 of the parameters' bytes, leaf by leaf in tree order."""
    h = hashlib.sha256()
    for t in tree_flatten(params)[0]:
        h.update(t.detach().cpu().contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> str:
    """Train; returns what it printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="granite-8b",
                    help="any registry arch; dims rescaled to ~100M params")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's smoke-test reduction (CPU in seconds)")
    ap.add_argument("--device", default="cuda",
                    help="where training runs (default cuda)")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="the step whose first attempt fails (default "
                         "steps // 2; negative: none)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    args = ap.parse_args(argv)
    # the train step runs in torch's deterministic mode; on the card that
    # needs cuBLAS's deterministic workspace, read at its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    fail_at = args.steps // 2 if args.fail_at is None else args.fail_at
    lines = []

    def say(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    device = torch.device(args.device)
    cfg = config(args.arch, args.reduced)
    dims = model_dims(cfg, tp=1)
    tc = TrainConfig(lr=3e-4, warmup_steps=max(args.steps // 15, 1),
                     total_steps=args.steps, dtype=torch.float32)
    state = init_state(torch.Generator(device).manual_seed(0), cfg, dims, tc,
                       device=device)
    n_params = sum(t.numel() for t in tree_flatten(state["params"])[0])
    say(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
        f"optimizer={cfg.optimizer} device={device.type}")

    train_step = make_train_step(cfg, dims, tc, FwdOptions(
        attn_impl="dense", dtype=torch.float32, remat=True))
    last = {}

    def step_fn(state, batch):
        # the loop restores fresh tensors after a failure: keep the newest
        state, metrics = train_step(state, batch)
        last["state"] = state
        return state, metrics

    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, seed=0,
        frontend_tokens=cfg.frontend_tokens if cfg.frontend != "none" else 0,
        d_model=cfg.d_model))

    with tempfile.TemporaryDirectory() as ckpt_dir:
        ckpt = CheckpointManager(ckpt_dir, keep_last=2)
        loop = ResilientLoop(
            ckpt, data, step_fn, ckpt_every=args.ckpt_every,
            injector=FaultInjector([fail_at] if fail_at >= 0 else []))
        t0 = time.perf_counter()
        report = loop.run(state, total_steps=args.steps)
        dt = time.perf_counter() - t0
    say(f"ran {report.steps_run} steps ({report.restarts} restart) in "
        f"{dt:.1f}s  loss {report.losses[0]:.3f} -> "
        f"{report.losses[-1]:.3f}")
    say(f"final loss {report.losses[-1]!r} at step {report.final_step}")
    say(f"final params sha256 {digest(last['state']['params'])}")
    if not report.losses[-1] < report.losses[0]:
        raise AssertionError("the loss did not fall")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
