"""Scenarios of the port's sharded serving tests
(``tests/test_torch_sharded_serve.py``), after the JAX package's mesh tests
(``tests/test_sharded_serve.py:218,270,318``, ``tests/test_recovery.py:550``,
``tests/test_prefix_cache.py:252``, ``tests/test_metrics.py:162``).

The test process runs each scenario with ``mesh_shape=None``, the oracle.
This file, run as a script, is one rank of a gloo group over a file
rendezvous:

    python tests/torch_mesh_cases.py RANK WORLD DATA,MODEL DIRECTORY

It runs every scenario on the ``(DATA, MODEL)`` mesh and pickles what each
returned, or the traceback that stopped it, to ``DIRECTORY/rankRANK.pkl``.
It imports the port only (``src`` goes on its own path, not through
``PYTHONPATH``, which would load the JAX shims of ``src/sitecustomize.py``).
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

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

import torch  # noqa: E402

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import model_dims  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.runtime import (ResilientServe,  # noqa: E402
                                 ServeFaultInjector)
from repro_torch.serve import (Engine, EngineConfig, MemorySink,  # noqa: E402
                               MetricsLogger, Request, SamplingParams)

COLLECTIVE_TIMEOUT_S = 60      # a rank that never joins fails, not hangs
SAMPLED = SamplingParams(temperature=0.8, top_k=40, seed=123)

SCENARIOS = ("streams-greedy", "streams-sampled", "streams-spec-greedy",
             "streams-spec-sampled", "overload", "translate-once",
             "crash-restore", "persisted-restore", "prefix-cache",
             "metrics", "deadline-lockstep", "mesh-size-mismatch")


def model():
    """The 2-layer reduced granite-8b of the JAX mesh tests, float32,
    weights from a seeded generator (every rank draws the same)."""
    cfg = dataclasses.replace(reduced(ARCHS["granite-8b"]), num_layers=2)
    params = init_params(torch.Generator().manual_seed(2), cfg,
                         model_dims(cfg), device="cpu")
    return cfg, params


def _engine(cfg, params, mesh, **kw):
    return Engine(cfg, params, EngineConfig(mesh_shape=mesh, **kw),
                  device="cpu")


def _drain(poll, unfinished, outs=None, limit=900):
    outs = {} if outs is None else outs
    for _ in range(limit):
        for ro in poll():
            outs.setdefault(ro.seq_id, []).extend(ro.new_token_ids)
        if not unfinished():
            return outs
    raise AssertionError("failed to drain")


def _shard_sums(st, keys):
    """{key: (sum over shards, global)} of ``stats()``."""
    return {k: (sum(s[k] for s in st["shards"]), st[k]) for k in keys}


# ------------------------------------------------------------- scenarios

def streams(cfg, params, mesh, spec, sampling):
    """test_sharded_serve.py:218: four requests, one 6-block prompt under
    a 2-block budget (chunked admission through the prefix-KV step)."""
    bs = cfg.kv_block_size
    eng = _engine(cfg, params, mesh, max_batch=4, max_seq_len=8 * bs,
                  auto_release=True, prefill_budget=2 * bs, spec_decode=spec)
    rng = np.random.RandomState(7)
    for i, n in enumerate([2, 6, 2, 3]):
        eng.submit(Request(seq_id=i, prompt=rng.randint(0, cfg.vocab_size,
                                                        n * bs),
                           max_new_tokens=10, sampling=sampling))
    outs = _drain(eng.poll, eng.has_unfinished, limit=400)
    eng.check_invariants()
    st = eng.stats()
    out = {"streams": outs,
           "globals": {k: st[k] for k in ("rsw_hits", "flex_walks",
                                          "spec_drafted", "spec_accepted")}}
    if mesh is not None:
        out["n_shards"] = len(st["shards"])
        out["sums"] = _shard_sums(st, ("rsw_hits", "flex_walks",
                                       "spec_drafted", "spec_accepted"))
    return out


def overload(cfg, params, mesh):
    """test_sharded_serve.py:270: twelve requests on a pool for about
    four preempt to the host tier and resume; the oracle is the roomy
    single-device run."""
    bs = cfg.kv_block_size
    eng = _engine(cfg, params, mesh, max_batch=4, max_seq_len=8 * bs,
                  pool_headroom=2.0 if mesh is None else 0.5,
                  auto_release=True)
    rng = np.random.RandomState(7)
    for i in range(12):
        eng.submit(Request(seq_id=i, prompt=rng.randint(0, cfg.vocab_size,
                                                        2 * bs),
                           max_new_tokens=20))

    def poll():
        out = eng.poll()
        eng.manager.check_invariants()
        return out

    outs = _drain(poll, eng.has_unfinished)
    eng.check_invariants()
    st = eng.stats()
    out = {"streams": outs, "overload": st["overload"]}
    if mesh is not None:
        out["sums"] = _shard_sums(
            {**st, **{k: st["overload"][k] for k in ("swap_bytes_out",
                                                     "swap_bytes_in")}},
            ("swap_bytes_out", "swap_bytes_in", "rsw_hits", "flex_walks"))
    return out


def translate_once(cfg, params, mesh):
    """test_sharded_serve.py:318: a steady step calls the shard entry and
    the combine once each (their plain versions here), and makes ONE
    device-to-host copy, spec decoding included.  Returns per-step counts
    of 3 steady steps each, spec off and on."""
    if mesh is None:
        return {}
    from repro_torch.kernels.utopia_rsw import ops
    bs = cfg.kv_block_size
    rng = np.random.RandomState(3)
    out = {}
    for spec in (None, "ngram"):
        eng = _engine(cfg, params, mesh, max_batch=4, max_seq_len=4 * bs,
                      spec_decode=spec)
        for sid in (1, 2):
            eng.submit(Request(seq_id=sid, prompt=rng.randint(
                0, cfg.vocab_size, bs), max_new_tokens=32))
        for _ in range(2):
            eng.step()
        counts = {"shard": 0, "combine": 0, "cpu": 0}
        saved = (ops.translate_shard_ref, ops.combine_shard_ref,
                 torch.Tensor.cpu, torch.Tensor.item, torch.Tensor.tolist)

        def counting(key, fn):
            def call(*a, **k):
                counts[key] += 1
                return fn(*a, **k)
            return call

        def forbidden(self, *a, **k):
            raise AssertionError("a host sync outside the step's one copy")

        ops.translate_shard_ref = counting("shard", saved[0])
        ops.combine_shard_ref = counting("combine", saved[1])
        torch.Tensor.cpu = counting("cpu", saved[2])
        torch.Tensor.item = torch.Tensor.tolist = forbidden
        try:
            steps = []
            for _ in range(3):
                counts.update(shard=0, combine=0, cpu=0)
                produced = len(eng.step())
                steps.append(dict(counts, produced=produced))
        finally:
            (ops.translate_shard_ref, ops.combine_shard_ref,
             torch.Tensor.cpu, torch.Tensor.item,
             torch.Tensor.tolist) = saved
        out["spec" if spec else "plain"] = steps
    return out


def _recovery_engine(cfg, params, mesh, injector=None):
    bs = cfg.kv_block_size
    return _engine(cfg, params, mesh, max_batch=4, max_seq_len=8 * bs,
                   auto_release=True, prefill_budget=bs,
                   fault_injector=injector)


def _recovery_requests(cfg):
    rng = np.random.RandomState(7)
    return [Request(seq_id=i, prompt=rng.randint(0, cfg.vocab_size,
                                                 2 * cfg.kv_block_size),
                    max_new_tokens=8) for i in range(4)]


def crash_restore(cfg, params, mesh):
    """test_recovery.py:550: crash and restore replays bitwise ("pre" and
    "post" crashes at three steps), and a snapshot taken on the mesh
    restores onto a FRESH mesh engine."""
    ref_eng = _recovery_engine(cfg, params, mesh)
    for r in _recovery_requests(cfg):
        ref_eng.submit(r)
    ref = _drain(ref_eng.poll, ref_eng.has_unfinished, limit=500)
    out = {"streams": ref}
    if mesh is None:
        return out
    total = ref_eng._step_count
    replays = {}
    for s in (2, total // 2, total - 1):
        for phase in ("pre", "post"):
            eng = _recovery_engine(cfg, params, mesh, ServeFaultInjector(
                crash_at=[(s, phase)]))
            sup = ResilientServe(eng, snapshot_every=4, max_restarts=2)
            for r in _recovery_requests(cfg):
                sup.submit(r)
            replays[f"{s}/{phase}"] = _drain(sup.poll, sup.has_unfinished,
                                             limit=500)
            eng.check_invariants()
    eng = _recovery_engine(cfg, params, mesh)
    for r in _recovery_requests(cfg):
        eng.submit(r)
    outs = {}
    for _ in range(5):
        for ro in eng.poll():
            outs.setdefault(ro.seq_id, []).extend(ro.new_token_ids)
    snap = eng.snapshot()
    fresh = _recovery_engine(cfg, params, mesh)
    fresh.restore(snap)
    fresh.check_invariants()
    out.update(replays=replays,
               fresh=_drain(fresh.poll, fresh.has_unfinished, outs))
    return out


def persisted_restore(cfg, params, mesh, directory):
    """Persisted snapshots on a mesh: every rank snapshots, rank 0 alone
    writes the files, and every rank of a fresh mesh engine resumes from
    them (``ResilientServe.from_checkpoint``)."""
    from repro_torch.ckpt import CheckpointManager
    ref = crash_restore(cfg, params, None)["streams"]
    if mesh is None:
        return {"streams": ref}
    ck = CheckpointManager(str(Path(directory) / "ckpt"), keep_last=2)
    sup = ResilientServe(_recovery_engine(cfg, params, mesh), ck,
                         snapshot_every=3)
    for r in _recovery_requests(cfg):
        sup.submit(r)
    outs = {}
    for _ in range(7):
        for ro in sup.poll():
            outs.setdefault(ro.seq_id, []).extend(ro.new_token_ids)
    ck.wait()
    saves = ck.save_count
    torch.distributed.barrier()            # rank 0's files are complete
    fresh = _recovery_engine(cfg, params, mesh)
    sup2 = ResilientServe.from_checkpoint(fresh, ck)
    step = fresh._step_count
    fresh.check_invariants()
    tail = _drain(sup2.poll, sup2.has_unfinished, limit=500)
    ck.wait()
    return {"streams": ref, "saves": saves, "step": step, "tail": tail}


def prefix_cache(cfg, params, mesh):
    """test_prefix_cache.py:252: five requests sharing a 3-block prefix;
    the mesh runs the cache, the oracle runs without it."""
    bs = cfg.kv_block_size
    eng = _engine(cfg, params, mesh, max_batch=4, max_seq_len=7 * bs,
                  auto_release=True, prefill_budget=4 * bs,
                  prefix_cache="auto" if mesh is not None else False)
    rng = np.random.RandomState(13)
    shared = rng.randint(0, cfg.vocab_size, 3 * bs)
    for i in range(5):
        eng.submit(Request(seq_id=i, prompt=np.concatenate(
            [shared, rng.randint(0, cfg.vocab_size, bs)]), max_new_tokens=6))
    outs = _drain(eng.poll, eng.has_unfinished, limit=600)
    eng.check_invariants()
    return {"streams": outs, "hits": eng.stats()["prefix_cache"]["hits"]}


def metrics(cfg, params, mesh):
    """test_metrics.py:162: the logger on a mesh (fed on rank 0 only)
    leaves the streams bitwise the logger-off oracle's, and its per-shard
    swap deltas sum to the global swap counters."""
    bs = cfg.kv_block_size
    mem = MemorySink()
    log = MetricsLogger([mem]) if mesh is not None else None
    eng = _engine(cfg, params, mesh, max_batch=4, max_seq_len=8 * bs,
                  pool_headroom=0.5, auto_release=True, metrics=log)
    rng = np.random.RandomState(7)
    for i in range(12):
        eng.submit(Request(seq_id=i, prompt=rng.randint(0, cfg.vocab_size,
                                                        2 * bs),
                           max_new_tokens=20))
    outs = _drain(eng.poll, eng.has_unfinished)
    eng.check_invariants()
    out = {"streams": outs}
    if mesh is not None:
        steps = [e for e in mem.events if e["kind"] == "step"]
        ov = eng.stats()["overload"]
        out.update(
            n_steps=len(steps), writer=eng.writes_files,
            all_have_shards=all("shard_swap_bytes_out" in e for e in steps),
            out=(sum(sum(e["shard_swap_bytes_out"]) for e in steps),
                 ov["swap_bytes_out"]),
            into=(sum(sum(e["shard_swap_bytes_in"]) for e in steps),
                  ov["swap_bytes_in"]))
    return out


def deadline_lockstep(cfg, params, mesh):
    """Deadlines are rank 0's decision: requests with a one-minute budget,
    and on every rank but 0 a clock an hour and more ahead once they are
    submitted, so that rank alone would cancel them all.  Every rank must
    serve them whole (a rank that cancelled alone would desynchronise the
    model group's collectives)."""
    from repro_torch.serve import engine as engine_mod
    bs = cfg.kv_block_size
    eng = _engine(cfg, params, mesh, max_batch=4, max_seq_len=8 * bs,
                  auto_release=True)
    rng = np.random.RandomState(11)
    for i in range(4):
        eng.submit(Request(seq_id=i, prompt=rng.randint(0, cfg.vocab_size,
                                                        2 * bs),
                           max_new_tokens=6, deadline_ms=60_000))
    real = time.perf_counter
    ahead = mesh is not None and torch.distributed.get_rank() != 0
    if ahead:
        engine_mod.time.perf_counter = lambda: real() + 1e6
    try:
        outs = _drain(eng.poll, eng.has_unfinished)
    finally:
        engine_mod.time.perf_counter = real
    return {"streams": outs,
            "expired": eng.stats()["lifecycle"]["deadline_expired"]}


def mesh_size_mismatch(cfg, params, mesh):
    """A mesh shape whose size is not the group's raises a clear error
    (no silent fallback to one device)."""
    if mesh is None:
        return {}
    from repro_torch.launch.mesh import make_local_mesh
    world = torch.distributed.get_world_size()
    try:
        make_local_mesh(data=world, model=2)
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def run(name, cfg, params, mesh, directory=None):
    """Scenario ``name`` on ``mesh`` (None: the single-device oracle)."""
    if name.startswith("streams"):
        return streams(cfg, params, mesh,
                       "ngram" if "spec" in name else None,
                       SAMPLED if name.endswith("sampled")
                       else SamplingParams())
    if name == "persisted-restore":
        return persisted_restore(cfg, params, mesh, directory)
    return globals()[name.replace("-", "_")](cfg, params, mesh)


def main(argv) -> int:
    rank, world = int(argv[0]), int(argv[1])
    data, mdl = (int(x) for x in argv[2].split(","))
    directory = Path(argv[3])
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{directory / 'rendezvous'}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    cfg, params = model()
    results = {}
    try:
        for name in SCENARIOS:
            t0 = time.perf_counter()
            results[name] = run(name, cfg, params, (data, mdl),
                                directory / f"mesh{data}x{mdl}")
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
