"""Scenarios of the port's mesh training tests (``tests/test_torch_dist.py``),
after the JAX package's (``tests/test_system.py``, ``tests/test_dist.py``,
``tests/test_train.py``).

The test process draws the inputs (the JAX package's weights as numpy,
pickled to ``ROOT/inputs.pkl``) and runs the oracles.  This file, run as a
script, is one rank of a gloo group over a file rendezvous:

    python tests/torch_train_mesh_cases.py RANK WORLD DATA,MODEL ROOT

It runs every scenario of ``SCENARIOS[(DATA, MODEL)]`` on that mesh and
pickles what each returned, or the traceback that stopped it, to
``ROOT/meshDxM/rankRANK.pkl``.  It imports the port only (``src`` goes on
its own path, not through ``PYTHONPATH``, which would load the JAX shims of
``src/sitecustomize.py``).  The (1, 2) group's elastic restore reads the
checkpoint that the (2, 2) group writes, and waits for it.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import sys
import time
import traceback
from pathlib import Path


SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

import torch  # noqa: E402

from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.ckpt.checkpoint import tree_flatten  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.dist import gpipe_spmd  # noqa: E402
from repro_torch.dist.megatron import (make_megatron_forward,  # noqa: E402
                                       megatron_loss,
                                       megatron_param_shardings)
from repro_torch.dist.sharding import (ShardingRules, block_of,  # noqa: E402
                                       gather_tree, shard_tree)
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import FwdOptions, model_dims  # noqa: E402
from repro_torch.params import params_from_numpy  # noqa: E402
from repro_torch.runtime import (FaultInjector, ResilientLoop,  # noqa: E402
                                 restore_like)
from repro_torch.train import (TrainConfig, abstract_state,  # noqa: E402
                               make_train_step, state_from_params,
                               state_shardings)

COLLECTIVE_TIMEOUT_S = 60      # a rank that never joins fails, not hangs
CKPT_WAIT_S = 180              # the (1, 2) group waits for (2, 2)'s save
STEPS = 3
TC = dict(lr=1e-3, warmup_steps=1, total_steps=10)
DATA = dict(seq_len=32, global_batch=8, seed=5)
MASKED = 20
# the resilient loop: test_train.py's scenario, shortened
LOOP_TC = dict(lr=1e-3, warmup_steps=5, total_steps=40, microbatches=2,
               grad_compression=True)
LOOP = dict(ckpt_every=4, fail_at=6, total=10)
SCENARIOS = {(2, 2): ("adamw", "adafactor", "moe", "megatron-forward",
                      "gpipe"),
             (1, 2): ("megatron-grads", "resilient-fault",
                      "elastic-restore"),
             (1, 1): ("one-position",)}


# ---------------------------------------------------------------- configs

def config(name):
    """(cfg, TrainConfig) of a scenario: reduced granite-8b with AdamW,
    with Adafactor, and reduced qwen3-moe at capacity 1.25 (tokens
    drop, so routing decides what trains)."""
    if name == "moe":
        cfg = dataclasses.replace(reduced(ARCHS["qwen3-moe-30b-a3b"]),
                                  moe_capacity_factor=1.25)
    else:
        cfg = reduced(ARCHS["granite-8b"])
        if name == "adafactor":
            cfg = dataclasses.replace(cfg, optimizer="adafactor")
    tc = TrainConfig(dtype=torch.float32, microbatches=cfg.train_microbatches,
                     **TC)
    return cfg, tc


def megatron_config(n_kv):
    cfg = dataclasses.replace(reduced(ARCHS["granite-8b"]),
                              num_kv_heads=n_kv)
    return cfg, model_dims(cfg, tp=2)


def data(cfg, **over):
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  **dict(DATA, **over)))


def batch_np(cfg, step):
    """Batch ``step`` of the scenarios' stream, with the first row's
    first ``MASKED`` labels masked: the first data rank holds fewer labels
    than the others, so that a mean of per-rank means would differ from
    the whole batch's mean."""
    b = data(cfg).batch_at(step)
    b["labels"][0, :MASKED] = -1
    return b


def batch_at(cfg, step):
    return {k: torch.as_tensor(v) for k, v in batch_np(cfg, step).items()}


def state_of(params_np, cfg, tc):
    """The train state around the JAX package's weights (as numpy)."""
    return state_from_params(params_from_numpy(params_np, device="cpu"),
                             cfg, tc)


def numpy_tree(tree):
    return [x.detach().numpy().copy() for x in tree_flatten(tree)[0]]


def train(cfg, tc, state, mesh=None, specs=None, steps=STEPS, first=0):
    """``steps`` steps from batch ``first``: (state, per-step metrics)."""
    step = make_train_step(cfg, model_dims(cfg), tc, FwdOptions(
        dtype=torch.float32, remat=True), mesh, specs=specs)
    mets = []
    for i in range(first, first + steps):
        state, m = step(state, batch_at(cfg, i))
        mets.append({k: float(v) for k, v in m.items()})
    return state, mets


def sharded(inputs, name, mesh):
    """(cfg, tc, specs, this rank's blocks of the scenario's state)."""
    cfg, tc = config(name)
    specs = state_shardings(abstract_state(cfg, model_dims(cfg), tc), mesh,
                            ShardingRules())
    state = state_of(inputs[name], cfg, tc)
    return cfg, tc, specs, shard_tree(state, specs, mesh)


# -------------------------------------------------------------- scenarios

def run_train(inputs, name, mesh, directory):
    """3 steps on the mesh; the gathered state after them; for AdamW also a
    checkpoint of the sharded state at step 3 and the 4th step's loss."""
    cfg, tc, specs, state = sharded(inputs, name, mesh)
    state, mets = train(cfg, tc, state, mesh, specs)
    whole = gather_tree(state, specs, mesh)
    out = {"metrics": mets, "state": numpy_tree(whole),
           "block_bytes": sum(x.numel() * x.element_size()
                              for x in tree_flatten(state)[0])}
    if name == "adamw":
        ckpt = CheckpointManager(str(directory / "ckpt"), mesh=mesh,
                                 specs=specs)
        ckpt.save(STEPS, state, blocking=True)
        ckpt.wait()
        out["saves"] = ckpt.save_count
        state, mets = train(cfg, tc, state, mesh, specs, steps=1,
                            first=STEPS)
        out["next_loss"] = mets[0]["loss"]
    return out


def megatron_forward(inputs, mesh):
    """Each n_kv's logits of this rank's rows under the schedule."""
    out = {}
    for n_kv in (4, 1):
        cfg, dims = megatron_config(n_kv)
        params = params_from_numpy(inputs[f"megatron{n_kv}"], device="cpu")
        specs = megatron_param_shardings(params, mesh, ShardingRules())
        blocks = shard_tree(params, specs, mesh)
        fwd = make_megatron_forward(cfg, dims, mesh, attn_impl="dense")
        rows = block_of(batch_at(cfg, 0)["tokens"], (("data",),), mesh)
        with torch.no_grad():
            logits, _, _ = fwd(blocks, {"tokens": rows})
        out[n_kv] = logits.numpy()
    return out


def megatron_grads(inputs, mesh):
    """Through ``loss_override``: each n_kv's gradients of this rank's
    blocks, then one mesh train step's metrics and gathered parameters."""
    out = {}
    for n_kv in (4, 1):
        cfg, dims = megatron_config(n_kv)
        tc = TrainConfig(dtype=torch.float32, **TC)
        params = params_from_numpy(inputs[f"megatron{n_kv}"], device="cpu")
        p_specs = megatron_param_shardings(params, mesh, ShardingRules())
        blocks = shard_tree(params, p_specs, mesh)
        loss = megatron_loss(make_megatron_forward(cfg, dims, mesh), mesh)
        leaves = [b.requires_grad_(True) for b in tree_flatten(blocks)[0]]
        term, mets = loss(blocks, batch_at(cfg, 0))
        grads = torch.autograd.grad(term, leaves)
        # the step over the schedule's layout (moments mirror the params)
        state = state_from_params(
            params_from_numpy(inputs[f"megatron{n_kv}"], device="cpu"), cfg,
            tc)
        specs = state_shardings(abstract_state(cfg, dims, tc), mesh,
                                ShardingRules())
        specs["params"] = p_specs
        specs["opt"] = {"m": p_specs, "v": p_specs}
        state = shard_tree(state, specs, mesh)
        step = make_train_step(cfg, dims, tc, FwdOptions(dtype=torch.float32),
                               mesh, ShardingRules(), loss_override=loss,
                               specs=specs)
        state, m = step(state, batch_at(cfg, 0))
        out[n_kv] = {"loss": float(term), "ce": float(mets["ce"]),
                     "grads": [g.numpy() for g in grads],
                     "step": {k: float(v) for k, v in m.items()},
                     "params": numpy_tree(gather_tree(state["params"],
                                                      specs["params"],
                                                      mesh))}
    return out


def gpipe(inputs, mesh):
    """The GPipe schedule over all four ranks as stages."""
    g = inputs["gpipe"]
    params = {k: torch.from_numpy(v) for k, v in g["params"].items()}

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    return {"out": gpipe_spmd(stage_fn, params, torch.from_numpy(g["x"]),
                              mesh).numpy()}


def resilient_fault(inputs, mesh, directory):
    """``ResilientLoop`` on the mesh with a fault after a checkpoint."""
    cfg = reduced(ARCHS["granite-8b"])
    tc = TrainConfig(dtype=torch.float32, **LOOP_TC)
    specs = state_shardings(abstract_state(cfg, model_dims(cfg), tc), mesh,
                            ShardingRules())
    state = shard_tree(state_of(inputs["adamw"], cfg, tc), specs, mesh)
    step = make_train_step(cfg, model_dims(cfg), tc, FwdOptions(
        dtype=torch.float32, remat=True), mesh, specs=specs)
    ckpt = CheckpointManager(str(directory / "loop"), keep_last=2,
                             mesh=mesh, specs=specs)
    loop = ResilientLoop(ckpt, data(cfg, seed=1), step,
                         ckpt_every=LOOP["ckpt_every"],
                         injector=FaultInjector([LOOP["fail_at"]]))
    rep = loop.run(state, total_steps=LOOP["total"])
    return {"losses": rep.losses, "restarts": rep.restarts,
            "final_step": rep.final_step, "steps_run": rep.steps_run,
            "saves": ckpt.save_count}


def elastic_restore(inputs, mesh, root):
    """The (2, 2) group's checkpoint of its AdamW state restored onto this
    mesh: the gathered state, then one more step's loss."""
    path = root / "mesh2x2" / "ckpt" / f"step_{STEPS}" / "COMMIT"
    t0 = time.perf_counter()
    while not path.exists():
        if time.perf_counter() - t0 > CKPT_WAIT_S:
            raise TimeoutError(f"no checkpoint at {path}")
        time.sleep(0.2)
    cfg, tc, specs, state = sharded(inputs, "adamw", mesh)
    ckpt = CheckpointManager(str(path.parents[1]), mesh=mesh, specs=specs)
    restored, step = ckpt.restore(state)
    state = restore_like(restored, state)
    whole = numpy_tree(gather_tree(state, specs, mesh))
    state, mets = train(cfg, tc, state, mesh, specs, steps=1, first=STEPS)
    return {"step": step, "state": whole, "next_loss": mets[0]["loss"]}


def one_position(inputs, mesh):
    """On a mesh of one position (its collectives over groups of one),
    each of the three configs' steps against the single-device step in
    this process: whether the losses, gradient norms and the whole state
    agree bit for bit."""
    out = {}
    for name in ("adamw", "adafactor", "moe"):
        cfg, tc, specs, state = sharded(inputs, name, mesh)
        state, mets = train(cfg, tc, state, mesh, specs)
        ref, ref_mets = train(cfg, tc, state_of(inputs[name], cfg, tc))
        out[name] = {"metrics": mets == ref_mets, "state": all(
            torch.equal(a, b) for a, b in zip(tree_flatten(state)[0],
                                              tree_flatten(ref)[0]))}
    return out


def run(name, inputs, mesh, root):
    directory = root / f"mesh{mesh.shape[0]}x{mesh.shape[1]}"
    if name in ("adamw", "adafactor", "moe"):
        return run_train(inputs, name, mesh, directory)
    if name == "megatron-forward":
        return megatron_forward(inputs, mesh)
    if name == "megatron-grads":
        return megatron_grads(inputs, mesh)
    if name == "gpipe":
        return gpipe(inputs, mesh)
    if name == "resilient-fault":
        return resilient_fault(inputs, mesh, directory)
    if name == "one-position":
        return one_position(inputs, mesh)
    return elastic_restore(inputs, mesh, root)


def main(argv) -> int:
    rank, world = int(argv[0]), int(argv[1])
    data_n, model_n = (int(x) for x in argv[2].split(","))
    root = Path(argv[3])
    directory = root / f"mesh{data_n}x{model_n}"
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{directory / 'rendezvous'}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    with open(root / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    results = {}
    try:
        mesh = make_local_mesh(data_n, model_n)
        for name in SCENARIOS[(data_n, model_n)]:
            t0 = time.perf_counter()
            results[name] = run(name, inputs, mesh, root)
            results[name]["seconds"] = time.perf_counter() - t0
    except BaseException:
        results["error"] = traceback.format_exc()
    with open(directory / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()
    return 1 if "error" in results else 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main(sys.argv[1:]))
