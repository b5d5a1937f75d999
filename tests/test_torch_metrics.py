"""The port's live serving metrics (``serve/metrics.py``) and the engine's
hooks into them.

* ``RollingWindow`` against numpy over the same trailing slice;
* a JSONL sink replays to the in-memory sink's events;
* logger-on streams equal logger-off streams (greedy and sampled);
* the logger's re-integrated totals equal ``Engine.stats()`` after every
  step of an overloaded run (preempt/resume and swap traffic included);
* a crash restore rebases the logger: no negative delta;
* the port's per-step events equal the JAX engine's on the same run
  (same float32 weights, the 2-layer reduced granite-8b), wall time and
  latencies aside.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import init_params as jinit, model_dims as jdims
from repro.serve import Engine as JEngine, EngineConfig as JConfig
from repro.serve import Request as JRequest
from repro.serve.metrics import MetricsLogger as JMetricsLogger
from repro.serve.metrics import MemorySink as JMemorySink
from repro_torch.configs import ARCHS, reduced
from repro_torch.params import params_from_numpy
from repro_torch.runtime import ResilientServe, ServeFaultInjector
from repro_torch.serve import (Engine, EngineConfig, JsonlSink, MemorySink,
                               MetricsLogger, Request, RollingWindow,
                               SamplingParams)
from repro_torch.serve.metrics import STEP_COUNTER_KEYS, read_jsonl

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jreduced(JARCHS["granite-8b"]), num_layers=2)
    jp = jinit(jax.random.PRNGKey(2), jcfg, jdims(jcfg))
    cfg = dataclasses.replace(reduced(ARCHS["granite-8b"]), num_layers=2)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return {"jax": (jcfg, jp), "port": (cfg, tp)}


def _run(weights, *, metrics=None, headroom=0.5, n_req=8, max_new=10,
         sampled=False, jax_engine=False, step_hook=None, **ekw):
    """``n_req`` 2-block prompts on a 4-row engine; returns (streams,
    engine).  ``step_hook(engine)`` runs after every step."""
    cfg, params = weights["jax" if jax_engine else "port"]
    bs = cfg.kv_block_size
    kw = dict(max_batch=4, max_seq_len=8 * bs, pool_headroom=headroom,
              auto_release=True, metrics=metrics, **ekw)
    if jax_engine:
        eng, req_cls = JEngine(cfg, params, JConfig(**kw)), JRequest
    else:
        eng = Engine(cfg, params, EngineConfig(**kw), device="cpu")
        req_cls = Request
    rng = np.random.RandomState(7)
    for i in range(n_req):
        sp = (SamplingParams(temperature=0.8, top_k=40, seed=5 + i)
              if sampled and i % 2 else SamplingParams())
        kw = {} if jax_engine else {"sampling": sp}
        eng.submit(req_cls(
            seq_id=i, prompt=rng.randint(0, cfg.vocab_size, 2 * bs),
            max_new_tokens=max_new, **kw))
    outs = {}
    for _ in range(900):
        for ro in eng.poll():
            outs.setdefault(ro.seq_id, []).extend(ro.new_token_ids)
        if step_hook is not None:
            step_hook(eng)
        if not eng.has_unfinished():
            return outs, eng
    raise AssertionError("engine failed to drain")


# ------------------------------------------------------- rolling window

@pytest.mark.parametrize("capacity", [1, 7, 64])
def test_rolling_window_matches_numpy(capacity):
    """Median, p99 and sum of the window equal numpy over the same
    trailing slice at every push, across the ring's wrap."""
    feed = np.random.RandomState(capacity).exponential(3.0, 200)
    w = RollingWindow(capacity)
    for i, x in enumerate(feed):
        w.push(x)
        ref = feed[max(0, i + 1 - capacity):i + 1]
        assert len(w) == len(ref)
        np.testing.assert_allclose(w.values(), ref)
        assert w.median() == pytest.approx(float(np.median(ref)))
        assert w.percentile(99) == pytest.approx(
            float(np.percentile(ref, 99)))
        assert w.sum() == pytest.approx(float(ref.sum()))


def test_rolling_window_edge_cases():
    w = RollingWindow(4)
    assert len(w) == 0 and w.median() == 0.0 and w.percentile(99) == 0.0
    w.push(5.0)
    assert w.median() == 5.0
    with pytest.raises(ValueError):
        RollingWindow(0)


# --------------------------------------------------------- sink plumbing

def test_jsonl_sink_round_trips_memory_sink(weights, tmp_path):
    path = str(tmp_path / "events.jsonl")
    mem = MemorySink()
    with MetricsLogger([mem, JsonlSink(path)]) as log:
        _run(weights, metrics=log, n_req=4, max_new=6)
    assert log.sinks[1]._f.closed
    replay = read_jsonl(path)
    assert replay == mem.events
    kinds = [e["kind"] for e in replay]
    assert kinds.count("submit") == 4 and kinds.count("finish") == 4
    assert kinds.count("step") == log.n_steps > 0
    step0 = next(e for e in replay if e["kind"] == "step")
    for k in STEP_COUNTER_KEYS + ("occupancy", "mapped_blocks",
                                  "pool_blocks", "live", "queued",
                                  "host_tier_seqs", "wall_s"):
        assert k in step0, k


# ------------------------------------------------- stream invisibility

@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_streams_equal_logger_on_and_off(weights, sampled):
    kw = dict(n_req=12, max_new=20, sampled=sampled)
    off, _ = _run(weights, **kw)
    on, eng = _run(weights, metrics=MetricsLogger([MemorySink()]), **kw)
    assert on == off
    assert eng.stats()["overload"]["preempted_seqs"] > 0


def test_logger_totals_agree_with_stats_every_step(weights):
    """The logger's re-integrated totals equal ``Engine.stats()`` after
    every step of an overloaded run; the event deltas sum back to them
    and are never negative."""
    mem = MemorySink()
    log = MetricsLogger([mem])

    def check(eng):
        st = eng.stats()
        ov, pc = st["overload"], st["prefix_cache"]
        expect = {
            "tokens": sum(len(s.generated) for s in eng._states.values()),
            "rsw_hits": st.get("rsw_hits", 0),
            "flex_walks": st.get("flex_walks", 0),
            "swap_faults": st.get("faults", 0),
            "spec_drafted": 0, "spec_accepted": 0,
            "request_preempts": ov["request_preempts"],
            "request_resumes": ov["request_resumes"],
            "swap_bytes_out": ov["swap_bytes_out"],
            "swap_bytes_in": ov["swap_bytes_in"],
            "prefix_lookups": pc["lookups"], "prefix_hits": pc["hits"],
            "cancelled": st["lifecycle"]["cancelled"],
            "deadline_expired": st["lifecycle"]["deadline_expired"],
        }
        assert log.totals == expect, f"drift at step {eng.step_count}"

    _run(weights, metrics=log, n_req=12, max_new=20, step_hook=check)
    assert log.totals["request_preempts"] > 0, "overload never hit"
    steps = [e for e in mem.events if e["kind"] == "step"]
    for k in STEP_COUNTER_KEYS:
        assert sum(e[k] for e in steps) == log.totals[k]
    assert all(e[k] >= 0 for e in steps for k in STEP_COUNTER_KEYS)


def test_rebase_gives_no_negative_deltas(weights):
    """A crash restore rewinds the engine's absolute counters; the
    restore rebases the logger, so no step event carries a negative
    delta and the totals still equal the engine's."""
    cfg, tp = weights["port"]
    bs = cfg.kv_block_size
    sink = MemorySink()
    eng = Engine(cfg, tp, EngineConfig(
        max_batch=4, max_seq_len=8 * bs, auto_release=True,
        prefill_budget=bs, metrics=MetricsLogger([sink]),
        fault_injector=ServeFaultInjector(crash_at=[(5, "post")])),
        device="cpu")
    sup = ResilientServe(eng, snapshot_every=3, max_restarts=3)
    rng = np.random.RandomState(7)
    for i in range(4):
        sup.submit(Request(seq_id=i, max_new_tokens=8,
                           prompt=rng.randint(0, cfg.vocab_size, 2 * bs)))
    while sup.has_unfinished():
        sup.poll()
    assert sup.restarts == 1
    steps = [e for e in sink.events if e["kind"] == "step"]
    for e in steps:
        for k in STEP_COUNTER_KEYS:
            assert e[k] >= 0, (k, e)
    assert eng.metrics.totals["tokens"] == eng._tokens_emitted == 32


def test_rolling_dashboard_and_latency(weights):
    t = [0.0]

    def fake_clock():
        t[0] += 1.0
        return t[0]

    log = MetricsLogger([MemorySink()], window=8, clock=fake_clock)
    outs, eng = _run(weights, metrics=log, n_req=6, max_new=8)
    r = log.rolling()
    assert r["steps"] == eng.step_count
    assert r["window_steps"] == min(8, eng.step_count)
    assert r["tokens_per_s"] > 0 and 0.0 <= r["rsw_hit_rate"] <= 1.0
    line = log.dashboard_line()
    assert "tok/s" in line and "pre " in line
    assert set(log.request_latencies) == set(outs)
    assert all(v > 0 for v in log.request_latencies.values())


# ------------------------------------------------------ parity with JAX

def test_step_events_equal_jax(weights):
    """The same overloaded run (12 requests, a 16-slot pool) on both
    engines emits the same events: every counter delta and gauge of every
    step, and the submit/finish lifecycle, wall time and latency aside."""
    jsink, tsink = JMemorySink(), MemorySink()
    _run(weights, metrics=JMetricsLogger([jsink]), n_req=12, max_new=20,
         jax_engine=True)
    _run(weights, metrics=MetricsLogger([tsink]), n_req=12, max_new=20)

    def strip(events):
        return [{k: v for k, v in e.items()
                 if k not in ("wall_s", "latency_s")} for e in events]

    assert len(tsink.events) == len(jsink.events)
    assert strip(tsink.events) == strip(jsink.events)
    assert sum(e.get("request_preempts", 0) for e in tsink.events) > 0
