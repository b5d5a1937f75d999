"""The port's checkpoint manager (``repro_torch.ckpt``) and persisted
serving snapshots against the JAX package's.

* The manager's durability contract, as ``tests/test_recovery.py`` holds
  the JAX one: the atomic manifest and COMMIT, the corrupt-shard fallback,
  named saves whose shapes vary, ``keep_last`` pruning, async writes.
* The same files: a checkpoint that JAX writes, the port reads, and the
  other way, named and positional; ``save``'s leaf order and treedef
  string are JAX's on a nested tree; bfloat16 tensors round-trip bitwise.
* Persisted snapshots: ``ResilientServe(engine, CheckpointManager)`` saves
  each snapshot, and ``ResilientServe.from_checkpoint`` resumes a fresh
  engine from the files, skipping a torn newest shard with a warning; the
  streams equal the uncrashed run's.

The engine runs the 2-layer reduced granite-8b of ``tests/test_recovery.py``
in float32 on the CPU.
"""
import collections
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import init_params as jinit, model_dims as jdims
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import ARCHS, reduced
from repro_torch.params import params_from_numpy
from repro_torch.runtime import ResilientServe, ServeFaultInjector
from repro_torch.serve import Engine, EngineConfig, Request, SamplingParams

torch.set_num_threads(2)

NT = collections.namedtuple("NT", "a b")


# ------------------------------------------------- checkpoint durability

def test_ckpt_atomic_manifest_and_commit(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep_last=2)
    state = {"w": np.arange(6, dtype=np.float32)}
    ck.save(3, state, blocking=True)
    step_dir = tmp_path / "step_3"
    assert (step_dir / "COMMIT").exists()
    assert not list(tmp_path.glob(".tmp_step_*")), "temp dir leaked"
    assert not list(step_dir.glob("*.tmp")), "non-atomic marker write"
    restored, step = ck.restore(state)
    assert step == 3 and np.array_equal(restored["w"], state["w"])
    man = json.loads((step_dir / "manifest.json").read_text())
    assert man["n_leaves"] == 1 and man["names"] == ["0"]
    assert man["leaves"] == [{"shape": [6], "dtype": "float32"}]


def test_ckpt_corrupt_shard_falls_back(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep_last=5)
    state = {"w": np.arange(4, dtype=np.float32)}
    ck.save(1, state, blocking=True)
    state2 = {"w": np.arange(4, dtype=np.float32) * 2}
    ck.save(2, state2, blocking=True)
    # truncate the latest shard UNDER its COMMIT marker (torn write)
    shard = tmp_path / "step_2" / "shard_0.npz"
    shard.write_bytes(shard.read_bytes()[:20])
    with pytest.warns(UserWarning, match="corrupt or truncated"):
        restored, step = ck.restore(state)
    assert step == 1 and np.array_equal(restored["w"], state["w"])
    # every step corrupt -> loud failure, not silence
    (tmp_path / "step_1" / "shard_0.npz").write_bytes(b"junk")
    with pytest.warns(UserWarning):
        with pytest.raises(FileNotFoundError, match="corrupt"):
            ck.restore(state)


def test_ckpt_save_named_variable_shapes(tmp_path):
    """Named checkpoints carry entries whose shapes change between steps
    (the engine's pickled host blob), which the positional pair's shape
    check forbids."""
    ck = CheckpointManager(str(tmp_path), keep_last=3)
    ck.save_named(1, {"host": np.frombuffer(b"abc", np.uint8),
                      "meta": np.asarray([1, 1])}, blocking=True)
    ck.save_named(2, {"host": np.frombuffer(b"abcdef", np.uint8),
                      "meta": np.asarray([1, 2])}, blocking=True)
    arrays, step = ck.restore_named()
    assert step == 2 and arrays["host"].tobytes() == b"abcdef"
    arrays, step = ck.restore_named(step=1)
    assert step == 1 and arrays["host"].tobytes() == b"abc"


def test_ckpt_keep_last_prunes_and_async_writes(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep_last=2)
    for s in range(1, 6):
        ck.save(s, {"w": np.full(3, s, np.int32)})      # background writes
    ck.wait()
    assert ck.all_steps() == [4, 5] and ck.latest_step() == 5
    assert ck.save_count == 5
    restored, step = ck.restore({"w": np.zeros(3, np.int32)}, step=4)
    assert step == 4 and restored["w"].tolist() == [4, 4, 4]
    with pytest.raises(ValueError, match="matching shapes"):
        ck.restore({"w": np.zeros(2, np.int32)})
    with pytest.raises(FileNotFoundError, match="at or before step 3"):
        ck.restore({"w": np.zeros(3, np.int32)}, step=3)
    assert CheckpointManager(str(tmp_path / "empty")).latest_step() is None


# ----------------------------------------------- the same files as JAX's

def _nested():
    rng = np.random.RandomState(4)
    return {"opt": (rng.randn(2, 3).astype(np.float32),
                    [np.arange(4), NT(np.ones(2, np.int8), None)]),
            "b": {"z": rng.randn(5), "a": np.asarray(7, np.int32)},
            "a": [rng.randint(0, 9, (3, 1))], "none": None}


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        assert x.dtype == np.asarray(y).dtype and np.array_equal(x, y)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ckpt_positional_files_cross_packages(tmp_path, writer):
    """``save`` of a nested tree by one package, ``restore`` by the other:
    the same leaf order (dict keys sorted, None holding no leaf), so every
    leaf lands where it was; the manifests agree, treedef included."""
    tree = _nested()
    mgrs = {"jax": JCheckpointManager, "port": CheckpointManager}
    reader = "port" if writer == "jax" else "jax"
    mgrs[writer](str(tmp_path / "w")).save(7, tree, blocking=True)
    got, step = mgrs[reader](str(tmp_path / "w")).restore(tree)
    assert step == 7
    _leaves_equal(got, tree)
    assert got["opt"][1][1].b is None and isinstance(got["opt"][1][1], NT)
    JCheckpointManager(str(tmp_path / "j")).save(7, tree, blocking=True)
    CheckpointManager(str(tmp_path / "p")).save(7, tree, blocking=True)
    man = {k: json.loads((tmp_path / k / "step_7" / "manifest.json")
                         .read_text()) for k in "jp"}
    for m in man.values():
        m.pop("time")
    assert man["j"] == man["p"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ckpt_named_files_cross_packages(tmp_path, writer):
    arrays = {"meta": np.asarray([1, 9], np.int64),
              "host": np.frombuffer(b"snapshot", np.uint8),
              "d.k_pool": np.random.RandomState(1).randn(2, 4, 3)
              .astype(np.float32)}
    mgrs = {"jax": JCheckpointManager, "port": CheckpointManager}
    reader = "port" if writer == "jax" else "jax"
    mgrs[writer](str(tmp_path)).save_named(9, arrays, blocking=True)
    got, step = mgrs[reader](str(tmp_path)).restore_named()
    assert step == 9 and set(got) == set(arrays)
    for k in arrays:
        assert got[k].dtype == arrays[k].dtype
        assert np.array_equal(got[k], arrays[k])


def test_ckpt_tensors_and_bf16_round_trip(tmp_path):
    """Tensor leaves come back as CPU tensors of their dtype, bfloat16
    bitwise through its int16 bits; numpy leaves stay numpy."""
    g = torch.Generator().manual_seed(0)
    tree = {"kv": torch.randn(3, 5, generator=g).to(torch.bfloat16),
            "w": torch.randn(4, generator=g), "n": np.arange(3)}
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, tree, blocking=True)
    got, _ = ck.restore({k: (torch.empty_like(v) if isinstance(
        v, torch.Tensor) else np.zeros(3, np.int64)) for k, v in tree.items()})
    assert got["kv"].dtype == torch.bfloat16
    assert torch.equal(got["kv"].view(torch.int16),
                       tree["kv"].view(torch.int16))
    assert torch.equal(got["w"], tree["w"])
    assert isinstance(got["n"], np.ndarray)
    man = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert man["names"] == ["0:bf16", "1", "2"]


# --------------------------------------------- persisted serving snapshots

@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jreduced(JARCHS["granite-8b"]), num_layers=2)
    jp = jinit(jax.random.PRNGKey(2), jcfg, jdims(jcfg))
    cfg = dataclasses.replace(reduced(ARCHS["granite-8b"]), num_layers=2)
    return cfg, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _mkeng(model, injector=None):
    cfg, params = model
    bs = cfg.kv_block_size
    return Engine(cfg, params, EngineConfig(
        max_batch=4, max_seq_len=8 * bs, auto_release=True,
        prefill_budget=bs, fault_injector=injector), device="cpu")


def _reqs(cfg):
    bs = cfg.kv_block_size
    rng = np.random.RandomState(7)
    return [Request(seq_id=i, prompt=rng.randint(0, cfg.vocab_size, 2 * bs),
                    max_new_tokens=8,
                    sampling=SamplingParams(temperature=0.8, top_p=0.9,
                                            seed=11) if i % 2 else
                    SamplingParams()) for i in range(4)]


def _drain(poller, has_unfinished, outs=None, max_steps=900):
    outs = {} if outs is None else outs
    for _ in range(max_steps):
        for ro in poller():
            outs.setdefault(ro.seq_id, []).extend(ro.new_token_ids)
        if not has_unfinished():
            return outs
    raise AssertionError("failed to drain")


@pytest.fixture(scope="module")
def reference(model):
    eng = _mkeng(model)
    for r in _reqs(model[0]):
        eng.submit(r)
    return _drain(eng.poll, eng.has_unfinished)


def test_persisted_snapshot_resume_with_corruption(tmp_path, model,
                                                   reference):
    """Kill-and-recover across engines WITH a torn latest snapshot:
    ``from_checkpoint`` skips the corrupt step (warning) and resumes
    from the previous one; the resumed tail matches the reference."""
    ck = CheckpointManager(str(tmp_path), keep_last=10)
    sup = ResilientServe(_mkeng(model), ck, snapshot_every=3)
    for r in _reqs(model[0]):
        sup.submit(r)
    for _ in range(8):
        sup.poll()
    ck.wait()
    steps = ck.all_steps()
    assert len(steps) >= 2, "cadence produced too few snapshots"
    assert sup.stats()["recovery"]["persisted"] is True
    shard = tmp_path / f"step_{steps[-1]}" / "shard_0.npz"
    shard.write_bytes(shard.read_bytes()[:50])
    fresh = _mkeng(model)
    with pytest.warns(UserWarning, match="corrupt or truncated"):
        sup2 = ResilientServe.from_checkpoint(fresh, ck)
    fresh.check_invariants()
    assert fresh._step_count == steps[-2]
    tail = _drain(sup2.poll, sup2.has_unfinished)
    ck.wait()
    assert tail, "nothing left to resume"
    for sid, toks in tail.items():
        assert reference[sid][-len(toks):] == toks, f"tail diverges {sid}"


def test_persisted_resume_after_crashes_equals_uncrashed(tmp_path, model,
                                                         reference):
    """Two in-process crashes under a persisting supervisor, then the
    process is lost: a fresh engine restored from the newest files
    delivers, after what the first process delivered, exactly the
    uncrashed run's streams."""
    ck = CheckpointManager(str(tmp_path), keep_last=3)
    inj = ServeFaultInjector(crash_at=[(4, "pre"), (7, "post")])
    sup = ResilientServe(_mkeng(model, inj), ck, snapshot_every=2)
    for r in _reqs(model[0]):
        sup.submit(r)
    delivered = {}
    while sup.restarts < 2 or sup.engine._step_count < 10:
        for ro in sup.poll():
            delivered.setdefault(ro.seq_id, []).extend(ro.new_token_ids)
    ck.wait()
    assert len(ck.all_steps()) == 3, "keep_last=3 did not prune"
    sup2 = ResilientServe.from_checkpoint(_mkeng(model), ck)
    sup2.engine.check_invariants()
    resumed = _drain(sup2.poll, sup2.has_unfinished)
    for sid, want in reference.items():
        got = list(delivered.get(sid, []))
        more = resumed.get(sid, [])
        # the new process re-delivers a stream from its start
        assert more[:len(got)] == got[:len(more)], sid
        got = more if len(more) > len(got) else got
        assert got == want, f"request {sid}"
