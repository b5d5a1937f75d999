"""The port's crash recovery: snapshot/restore, ``ResilientServe``,
cancellation and deadlines.

The oracle, port against port: a ``ServeFaultInjector`` crash at ANY
step boundary ("pre": before the step mutated anything; "post": after
its full commit), followed by ``ResilientServe`` restoring the latest
snapshot and replaying, delivers token streams BIT-IDENTICAL to an
uncrashed run, greedy and sampled, prefix cache on and off, with chunked
prefill and under preemption, and ``Engine.check_invariants()`` holds
after every recovery.  Also: the snapshot's array round trip is
byte-equal, restore onto a fresh engine, a snapshot taken while a
sequence is parked on the host tier, seq_id reuse across a restore, a
mismatched configuration rejected, cancel and deadlines (rebased across
a restore), the restart budget and the watchdog.

On the 2-layer reduced granite-8b of ``tests/test_recovery.py`` with
float32 weights from the JAX ``init_params``, on the CPU; a ``gpu``-marked
twin replays a crash on the card.
"""
import dataclasses
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import init_params as jinit, model_dims as jdims
from repro_torch.configs import ARCHS, reduced
from repro_torch.params import params_from_numpy
from repro_torch.runtime import (InjectedStepFault, ReplayDivergence,
                                 ResilientServe, ServeFaultInjector,
                                 StepWatchdog)
from repro_torch.serve import (Engine, EngineConfig, EngineSnapshot,
                               MemorySink, MetricsLogger, Request,
                               SamplingParams)

torch.set_num_threads(2)

SAMPLED = SamplingParams(temperature=0.8, top_p=0.9, seed=11)
# greedy/sampled x prefix cache on (prompts sharing a block, so it hits)
# / off
VARIANTS = {
    "greedy_cache": (SamplingParams(), {"prefix_cache": True}),
    "greedy_nocache": (SamplingParams(), {"prefix_cache": None}),
    "sampled_cache": (SAMPLED, {"prefix_cache": True}),
    "sampled_nocache": (SAMPLED, {"prefix_cache": None}),
}


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jreduced(JARCHS["granite-8b"]), num_layers=2)
    jp = jinit(jax.random.PRNGKey(2), jcfg, jdims(jcfg))
    cfg = dataclasses.replace(reduced(ARCHS["granite-8b"]), num_layers=2)
    return cfg, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _mkeng(model, injector=None, device="cpu", params=None, **ekw):
    cfg, tp = model
    bs = cfg.kv_block_size
    kw = dict(max_batch=4, max_seq_len=8 * bs, auto_release=True,
              prefill_budget=bs,      # every prompt crosses step boundaries
              fault_injector=injector)
    kw.update(ekw)
    return Engine(cfg, params if params is not None else tp,
                  EngineConfig(**kw), device=device)


def _reqs(cfg, sampling, n=4, max_new=8, shared_prefix=False):
    bs = cfg.kv_block_size
    rng = np.random.RandomState(7)
    prefix = rng.randint(0, cfg.vocab_size, bs)
    out = []
    for i in range(n):
        tail = rng.randint(0, cfg.vocab_size, bs)
        prompt = (np.concatenate([prefix, tail]) if shared_prefix
                  else rng.randint(0, cfg.vocab_size, 2 * bs))
        out.append(Request(seq_id=i, prompt=prompt, max_new_tokens=max_new,
                           sampling=sampling))
    return out


def _drain(poller, has_unfinished, outs=None, max_steps=900):
    outs = {} if outs is None else outs
    for _ in range(max_steps):
        for ro in poller():
            outs.setdefault(ro.seq_id, []).extend(ro.new_token_ids)
        if not has_unfinished():
            return outs
    raise AssertionError("failed to drain")


def _reference(model, sampling, ekw, *, shared_prefix=False, n=4,
               max_new=8):
    """Uncrashed run: streams and the step count (the crash domain)."""
    eng = _mkeng(model, **ekw)
    for r in _reqs(model[0], sampling, n=n, max_new=max_new,
                   shared_prefix=shared_prefix):
        eng.submit(r)
    return _drain(eng.poll, eng.has_unfinished), eng._step_count


def _crashed_run(model, sampling, ekw, crash_at, *, snapshot_every=5,
                 shared_prefix=False, n=4, max_new=8, max_restarts=None,
                 injector_kw=None):
    inj = ServeFaultInjector(crash_at=crash_at, **(injector_kw or {}))
    eng = _mkeng(model, injector=inj, **ekw)
    sup = ResilientServe(eng, snapshot_every=snapshot_every,
                         max_restarts=(max_restarts if max_restarts
                                       is not None else len(crash_at) + 1))
    for r in _reqs(model[0], sampling, n=n, max_new=max_new,
                   shared_prefix=shared_prefix):
        sup.submit(r)
    outs = _drain(sup.poll, sup.has_unfinished)
    eng.check_invariants()
    return outs, sup


# ------------------------------------------------------- the crash oracle

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_crash_at_every_step_boundary_bit_identical(model, variant):
    """Crash at EVERY boundary of the run (phases alternating pre/post),
    restore, replay: the delivered streams equal the uncrashed run's."""
    sampling, ekw = VARIANTS[variant]
    shared = ekw["prefix_cache"] is not None
    ref, total = _reference(model, sampling, ekw, shared_prefix=shared)
    assert total >= 8, "reference run too short to sweep boundaries"
    for s in range(1, total + 1):
        phase = "pre" if s % 2 else "post"
        outs, sup = _crashed_run(model, sampling, ekw, [(s, phase)],
                                 shared_prefix=shared)
        assert outs == ref, f"[{variant}] crash at step {s} ({phase})"
        assert sup.restarts == 1


def test_crash_under_preempt_resume_overload(model):
    """Crashes landing among preempt/resume traffic (a tight pool plus
    forced preemptions) replay bit-identically; the host-tier sequences
    inside the snapshot survive the round trip."""
    ekw = dict(pool_headroom=0.40)
    ref, total = _reference(model, SamplingParams(), ekw, n=6, max_new=10)
    forced = [(4, "post", "auto"), (6, "pre", "auto")]
    for s in (5, 7, max(8, total - 2)):
        for phase in ("pre", "post"):
            outs, sup = _crashed_run(
                model, SamplingParams(), ekw, [(s, phase)], n=6,
                max_new=10, snapshot_every=3,
                injector_kw={"preempt_at": list(forced)})
            assert outs == ref, f"overload crash at {s}/{phase} diverged"
            # a forced preemption fires once: a replay past it runs
            # without it, and the streams may not notice either way
            st = sup.stats()
            assert st["overload"]["request_preempts"] >= 1
            assert st["recovery"]["restarts"] == 1


def test_multi_crash_and_restart_budget(model):
    ref, _ = _reference(model, SamplingParams(), {})
    crash = [(3, "pre"), (6, "post"), (9, "pre")]
    outs, sup = _crashed_run(model, SamplingParams(), {}, crash,
                             snapshot_every=4)
    assert outs == ref
    rec = sup.stats()["recovery"]
    assert sup.restarts == 3 and rec["replayed_steps"] > 0
    assert rec["dedup_tokens"] > 0 and rec["persisted"] is False
    with pytest.raises(InjectedStepFault):
        _crashed_run(model, SamplingParams(), {}, crash, snapshot_every=4,
                     max_restarts=2)


def test_replay_divergence_is_loud(model):
    """A replay that re-emits a token other than the delivered one
    raises instead of passing a corrupt stream on."""
    eng = _mkeng(model)
    sup = ResilientServe(eng, snapshot_every=100)
    for r in _reqs(model[0], SamplingParams(), n=1):
        sup.submit(r)
    while not sup._delivered.get(0):
        sup.poll()
    sup._delivered[0][0] += 1
    with pytest.raises(ReplayDivergence):
        _drain(sup.poll, sup.has_unfinished)


def test_checkpoint_persistence(model, tmp_path):
    """With a ``CheckpointManager`` the supervisor persists every snapshot
    (the constructor's included), and ``from_checkpoint`` restores the
    newest onto a fresh engine, whose streams finish as the uncrashed
    run's."""
    from repro_torch.ckpt import CheckpointManager
    ref, _ = _reference(model, SamplingParams(), {})
    ck = CheckpointManager(str(tmp_path), keep_last=2)
    sup = ResilientServe(_mkeng(model), ck, snapshot_every=3)
    for r in _reqs(model[0], SamplingParams()):
        sup.submit(r)
    for _ in range(7):
        sup.poll()
    ck.wait()
    assert sup.snapshots == 3 and ck.save_count == 3
    assert ck.all_steps() == [3, 6]
    assert sup.stats()["recovery"]["persisted"] is True
    fresh = _mkeng(model)
    sup2 = ResilientServe.from_checkpoint(fresh, ck)
    assert fresh._step_count == 6
    fresh.check_invariants()
    tail = _drain(sup2.poll, sup2.has_unfinished)
    assert tail and all(ref[sid][-len(t):] == t for sid, t in tail.items())


# ----------------------------------------------------- snapshot round trip

def test_snapshot_roundtrip_bytes_equal(model):
    """snapshot -> to_arrays -> from_arrays reproduces the snapshot
    exactly (bfloat16 pools included), and restoring it leaves an engine
    whose own snapshot has byte-identical device arrays."""
    for dtype in (torch.float32, torch.bfloat16):
        eng = _mkeng(model, dtype=dtype)
        for r in _reqs(model[0], SamplingParams()):
            eng.submit(r)
        for _ in range(5):
            eng.poll()
        snap = eng.snapshot()
        rt = EngineSnapshot.from_arrays(snap.to_arrays())
        assert (rt.version, rt.step, rt.host_blob) == (
            snap.version, snap.step, snap.host_blob)
        assert set(rt.dstate) == set(snap.dstate)
        assert "tar" not in snap.dstate and "k_pool" in snap.dstate
        for k in snap.dstate:
            assert rt.dstate[k].dtype == snap.dstate[k].dtype, k
            assert torch.equal(rt.dstate[k], snap.dstate[k]), k
        fresh = _mkeng(model, dtype=dtype)
        fresh.restore(rt)
        fresh.check_invariants()
        again = fresh.snapshot()
        assert again.step == snap.step
        for k in snap.dstate:
            assert torch.equal(again.dstate[k], snap.dstate[k]), k


def test_restore_writes_in_place(model):
    """Restore copies into the engine's own tensors (the pool is never
    held twice; kernels keep reading the translation tables where they
    are) and rebuilds the translation tables from the host tables."""
    eng = _mkeng(model)
    for r in _reqs(model[0], SamplingParams()):
        eng.submit(r)
    for _ in range(6):
        eng.poll()
    snap = eng.snapshot()
    ptrs = {k: v.data_ptr() for k, v in eng.dstate.items()}
    for _ in range(4):
        eng.poll()
    eng.restore(snap)
    assert {k: v.data_ptr() for k, v in eng.dstate.items()} == ptrs
    assert eng._step_count == snap.step
    eng.check_invariants()


def test_restore_fresh_engine_replays_identically(model):
    ref, _ = _reference(model, SAMPLED, {})
    eng = _mkeng(model)
    for r in _reqs(model[0], SAMPLED):
        eng.submit(r)
    outs = {}
    for _ in range(6):
        for ro in eng.poll():
            outs.setdefault(ro.seq_id, []).extend(ro.new_token_ids)
    snap = eng.snapshot()
    fresh = _mkeng(model)
    fresh.restore(snap)
    fresh.check_invariants()
    _drain(fresh.poll, fresh.has_unfinished, outs)
    assert outs == ref


def test_snapshot_while_preempted(model):
    """A sequence parked on the host KV tier rides the snapshot: after a
    restore on a fresh engine it resumes and finishes with the uncrashed
    stream."""
    ref, _ = _reference(model, SamplingParams(), {})
    inj = ServeFaultInjector(preempt_at=[(3, "post", "auto")])
    eng = _mkeng(model, injector=inj)
    for r in _reqs(model[0], SamplingParams()):
        eng.submit(r)
    outs = {}
    for _ in range(4):
        for ro in eng.poll():
            outs.setdefault(ro.seq_id, []).extend(ro.new_token_ids)
    assert eng._preempted, "forced preempt did not land"
    snap = eng.snapshot()
    fresh = _mkeng(model)
    fresh.restore(snap)
    assert fresh._preempted.keys() == eng._preempted.keys()
    fresh.check_invariants()
    _drain(fresh.poll, fresh.has_unfinished, outs)
    assert outs == ref
    assert fresh.stats()["overload"]["host_tier_seqs"] == 0


def test_seq_id_reuse_across_restore(model):
    cfg = model[0]
    eng = _mkeng(model)
    for r in _reqs(cfg, SamplingParams(), n=2, max_new=4):
        eng.submit(r)
    _drain(eng.poll, eng.has_unfinished)
    fresh = _mkeng(model)
    fresh.restore(eng.snapshot())
    rng = np.random.RandomState(3)
    for i in range(2):
        fresh.submit(Request(
            seq_id=i, prompt=rng.randint(0, cfg.vocab_size,
                                         2 * cfg.kv_block_size),
            max_new_tokens=4))
    outs = _drain(fresh.poll, fresh.has_unfinished)
    assert set(outs) == {0, 1} and all(len(t) == 4 for t in outs.values())
    fresh.check_invariants()


def test_restore_rejects_mismatched_config(model):
    eng = _mkeng(model)
    snap = eng.snapshot()
    for other in (dict(max_batch=2), dict(dtype=torch.bfloat16),
                  dict(pool_headroom=0.5)):
        with pytest.raises(ValueError, match="does not match"):
            _mkeng(model, **other).restore(snap)
    bad = dataclasses.replace(snap, version=snap.version + 1)
    with pytest.raises(ValueError, match="version"):
        eng.restore(bad)


# ------------------------------------------------------- cancel / deadline

def test_cancel_releases_everything(model):
    """Cancel in every lifecycle stage (parked on the host tier, live,
    queued), then drain: no leaked blocks, references or slots."""
    inj = ServeFaultInjector(preempt_at=[(3, "post", "auto")])
    eng = _mkeng(model, injector=inj, prefix_cache=False)
    for r in _reqs(model[0], SamplingParams(), n=6, max_new=10):
        eng.submit(r)
    for _ in range(4):
        eng.poll()
    assert eng._preempted, "forced preempt did not land"
    parked = next(iter(eng._preempted))
    live = next(sid for sid in eng.requests
                if not eng._states[sid].done and sid != parked)
    queued = [r.seq_id for r in eng.waiting
              if r.seq_id not in eng._prefilling and r.seq_id != parked]
    assert queued, "nothing left queued to cancel"
    assert eng.cancel(parked) and eng.cancel(live)
    assert eng.cancel(queued[-1])
    eng.check_invariants()
    assert eng.cancel(live) is False            # idempotent
    for sid in (parked, live, queued[-1]):
        assert eng._states[sid].finish_reason == "cancelled"
        assert sid not in eng._slot_of and sid not in eng._preempted
    _drain(eng.poll, eng.has_unfinished)
    eng.check_invariants()
    assert not eng.manager.blocks, "leaked KV blocks after cancel"
    assert not any(eng.manager.slot_refcount.values()), "leaked refcounts"
    assert not eng.manager.seq_lengths, "leaked sequence slots"
    assert eng.stats()["lifecycle"] == {"cancelled": 3,
                                        "deadline_expired": 0}


def test_cancelled_outputs_and_metrics_events(model):
    sink = MemorySink()
    eng = _mkeng(model, metrics=MetricsLogger([sink]))
    for r in _reqs(model[0], SamplingParams(), n=3, max_new=12):
        eng.submit(r)
    for _ in range(3):
        eng.poll()
    assert eng.cancel(1)
    reasons = {}
    for _ in range(200):
        for ro in eng.poll():
            if ro.finished:
                reasons[ro.seq_id] = ro.finish_reason
        if not eng.has_unfinished():
            break
    assert reasons[1] == "cancelled"
    assert reasons[0] == reasons[2] == "length"
    fin = [e for e in sink.events if e["kind"] == "finish"]
    assert any(e["seq_id"] == 1 and e["finish_reason"] == "cancelled"
               for e in fin)
    assert eng.metrics.totals["cancelled"] == 1
    assert eng.metrics.totals["deadline_expired"] == 0


def test_deadline_expiry(model):
    cfg = model[0]
    bs = cfg.kv_block_size
    eng = _mkeng(model)
    rng = np.random.RandomState(5)
    eng.submit(Request(seq_id=0, prompt=rng.randint(0, cfg.vocab_size,
                                                    2 * bs),
                       max_new_tokens=12, deadline_ms=0.0))
    eng.submit(Request(seq_id=1, prompt=rng.randint(0, cfg.vocab_size,
                                                    2 * bs),
                       max_new_tokens=6))
    outs = _drain(eng.poll, eng.has_unfinished)
    assert eng._states[0].finish_reason == "deadline"
    assert eng._states[1].finish_reason == "length"
    assert len(outs[1]) == 6
    assert eng.stats()["lifecycle"]["deadline_expired"] == 1
    eng.check_invariants()
    with pytest.raises(ValueError, match="deadline_ms"):
        eng.submit(Request(seq_id=2, prompt=rng.randint(0, cfg.vocab_size,
                                                        2 * bs),
                           deadline_ms=-1.0))


def test_deadline_rebases_across_restore(model):
    """The remaining budget, not the absolute clock, rides the snapshot:
    a generous deadline survives a restore into a new engine, and an
    elapsed one still fires after it."""
    cfg = model[0]
    bs = cfg.kv_block_size
    eng = _mkeng(model)
    rng = np.random.RandomState(5)
    eng.submit(Request(seq_id=0, prompt=rng.randint(0, cfg.vocab_size,
                                                    2 * bs),
                       max_new_tokens=6, deadline_ms=600000.0))
    eng.submit(Request(seq_id=1, prompt=rng.randint(0, cfg.vocab_size,
                                                    2 * bs),
                       max_new_tokens=6, deadline_ms=30.0))
    eng.poll()
    snap = eng.snapshot()
    fresh = _mkeng(model)
    fresh.restore(snap)
    remaining = fresh._states[0].deadline_at - time.perf_counter()
    assert 590.0 < remaining <= 600.0
    time.sleep(0.05)
    _drain(fresh.poll, fresh.has_unfinished)
    assert fresh._states[0].finish_reason == "length"
    assert fresh._states[1].finish_reason == "deadline"
    fresh.check_invariants()


# ------------------------------------------------------------ watchdog

def test_step_watchdog_flags_hung_steps():
    wd = StepWatchdog(threshold=5.0, warmup=3)
    for _ in range(6):
        assert wd.record(0.01) is False
    assert wd.record(0.5) is True
    assert len(wd.flags) == 1
    assert wd.record(0.011) is False, "EMA poisoned by the outlier"


def test_supervisor_reports_hung_poll(model, monkeypatch):
    """A poll far slower than the smoothed poll time shows up in the
    supervisor's ``watchdog_flags``.  The supervisor's clock is a
    controlled one that each poll advances by a fixed 10 ms and poll 8 by
    1 s, so the answer does not depend on the host's load."""
    from repro_torch.runtime import resilient_serve
    clock = [0.0]
    monkeypatch.setattr(resilient_serve, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0]))
    eng = _mkeng(model)
    sup = ResilientServe(eng, watchdog=StepWatchdog(threshold=5.0,
                                                    warmup=2))
    for r in _reqs(model[0], SamplingParams()):
        sup.submit(r)
    poll = eng.poll
    calls = [0]

    def slow_poll():
        calls[0] += 1
        clock[0] += 1.0 if calls[0] == 8 else 0.01
        return poll()

    eng.poll = slow_poll
    _drain(sup.poll, sup.has_unfinished)
    assert calls[0] > 8
    assert sup.stats()["recovery"]["watchdog_flags"] == 1
    assert [i for i, _ in sup.watchdog.flags] == [8]


# --------------------------------------------------------- on the card

@pytest.mark.gpu
def test_gpu_crash_replay_bit_identical(model):
    """On the card: crashes at a "pre" and a "post" boundary under
    forced preemptions replay to streams bitwise equal to the uncrashed
    card run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    tpc = jax.tree.map(lambda t: t.to("cuda"), model[1])
    forced = [(4, "post", "auto"), (6, "pre", "auto")]

    def run(crash_at):
        inj = ServeFaultInjector(crash_at=crash_at, preempt_at=forced)
        eng = _mkeng(model, injector=inj, device="cuda", params=tpc,
                     pool_headroom=0.4)
        sup = ResilientServe(eng, snapshot_every=3, max_restarts=3)
        for r in _reqs(model[0], SAMPLED, n=6, max_new=10):
            sup.submit(r)
        outs = _drain(sup.poll, sup.has_unfinished)
        eng.check_invariants()
        return outs, sup

    ref, _ = run([])
    outs, sup = run([(5, "pre"), (9, "post")])
    assert outs == ref
    assert sup.restarts == 2
