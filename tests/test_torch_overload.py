"""The port's overload layer: preemption to the host KV tier, the serve
fault injector and the victim policies.

Against the JAX engine (same float32 weights, the 2-layer reduced
granite-8b of ``tests/test_overload.py``), with ``overload_policy=
"preempt"``, the default of both: a pool sized for about 4 sequences
serving 12 requests, greedy and sampled, and fixed chaos schedules
(forced "pre"/"post" preemptions, one mid-chunk, allocation denials at
admit/decode/resume) give exactly equal admission logs,
``stats()["overload"]``, manager stats, per-request preempt/resume
counts, injector logs and token streams.

Port against port: tight-pool streams equal roomy-pool streams under
every victim policy, forced preemptions are stream-invisible (a resumed
sampled request draws what it would have drawn uninterrupted), and the
two schedules on which the JAX engine goes wrong serve correctly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import init_params as jinit, model_dims as jdims
from repro.runtime import ServeFaultInjector as JInjector
from repro.serve import Engine as JEngine, EngineConfig as JConfig
from repro.serve import Request as JRequest
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import PoolExhausted
from repro_torch.params import params_from_numpy
from repro_torch.runtime import (InjectedAllocFault, InjectedFault,
                                 InjectedStepFault, ServeFaultInjector)
from repro_torch.serve import Engine, EngineConfig, Request, SamplingParams
from repro_torch.serve.scheduler import (FIFOScheduler,
                                         PriorityAgingScheduler,
                                         ShortestPromptFirst, default_victim)

torch.set_num_threads(2)

SAMPLED = dict(temperature=0.8, top_k=40, seed=123)
PORT = (Engine, EngineConfig, Request, SamplingParams, ServeFaultInjector)
JAX = (JEngine, JConfig, JRequest, JSamplingParams, JInjector)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jreduced(JARCHS["granite-8b"]), num_layers=2)
    jp = jinit(jax.random.PRNGKey(2), jcfg, jdims(jcfg))
    cfg = dataclasses.replace(reduced(ARCHS["granite-8b"]), num_layers=2)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return {"jax": (jcfg, jp), "port": (cfg, tp)}


def _engine(weights, api, **ekw):
    if api is JAX:
        cfg, params = weights["jax"]
        return JEngine(cfg, params, JConfig(**ekw))
    cfg, params = weights["port"]
    return Engine(cfg, params, EngineConfig(**ekw), device="cpu")


def _drain(eng, max_steps=900):
    """Poll to completion, holding the pool's invariants after every
    step.  Returns {seq_id: [token, ...]}."""
    outs = {}
    for _ in range(max_steps):
        for ro in eng.poll():
            outs.setdefault(ro.seq_id, []).extend(ro.new_token_ids)
        if isinstance(eng, Engine):
            eng.check_invariants()
        else:
            eng.manager.check_invariants()
        if not eng.has_unfinished():
            return outs
    raise AssertionError("engine failed to drain")


def _run(weights, api, headroom, *, n_req=12, max_new=20, sampled=False,
         schedule=None, prompt_blocks=2, seed=7, **ekw):
    """``n_req`` requests of ``prompt_blocks`` blocks on a 4-row engine of
    8-block sequences; ``schedule`` (injector keyword arguments) attaches
    a fault injector.  Returns (streams, engine, injector)."""
    _, _, req_cls, sp_cls, inj_cls = api
    bs = weights["port"][0].kv_block_size
    vocab = weights["port"][0].vocab_size
    inj = inj_cls(**schedule) if schedule is not None else None
    eng = _engine(weights, api, max_batch=4, max_seq_len=8 * bs,
                  pool_headroom=headroom, auto_release=True,
                  fault_injector=inj, **ekw)
    rng = np.random.RandomState(seed)
    for i in range(n_req):
        sp = sp_cls(**SAMPLED) if sampled and i % 2 else sp_cls()
        eng.submit(req_cls(
            seq_id=i, prompt=rng.randint(0, vocab, prompt_blocks * bs),
            max_new_tokens=max_new, sampling=sp))
    outs = _drain(eng)
    assert set(outs) == set(range(n_req))
    return outs, eng, inj


_JAX_RUNS = {}


def _jax_run(weights, key, **kw):
    """JAX engine runs, each computed once per module."""
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _run(weights, JAX, **kw)
    return _JAX_RUNS[key]


def _assert_same(port, ref):
    """Everything two runs of one workload can be compared on."""
    (pout, peng, pinj), (jout, jeng, jinj) = port, ref
    assert peng.admission_log == jeng.admission_log
    assert dict(peng.manager.stats) == dict(jeng.manager.stats)
    pst, jst = peng.stats(), jeng.stats()
    assert pst["overload"] == jst["overload"]
    for sid, row in jst["per_request"].items():
        for key in ("preempts", "resumes", "rsw_hits", "flex_walks",
                    "cached_blocks"):
            assert pst["per_request"][sid][key] == row[key], (sid, key)
    if jinj is not None:
        assert pinj.log == jinj.log
    for sid in jout:
        assert pout[sid] == jout[sid], f"seq {sid} differs from JAX"


def _assert_drained(eng):
    ov = eng.stats()["overload"]
    assert ov["host_tier_seqs"] == 0
    assert ov["resumed_seqs"] == ov["preempted_seqs"]
    assert ov["swap_bytes_in"] == ov["swap_bytes_out"]
    assert not eng.manager.blocks and not eng.manager.seq_lengths


# ------------------------------------------------------ parity with JAX

def test_engine_config_defaults_equal_jax():
    """Field for field, ``overload_policy="preempt"`` included (the dtype
    compared by name)."""
    port, ref = EngineConfig(), JConfig()
    names = [f.name for f in dataclasses.fields(JConfig)]
    assert names == [f.name for f in dataclasses.fields(EngineConfig)]
    for n in names:
        if n == "dtype":
            assert str(port.dtype).split(".")[-1] == ref.dtype.__name__
        else:
            assert getattr(port, n) == getattr(ref, n), n
    assert port.overload_policy == "preempt"


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_overload_matches_jax(weights, sampled):
    """Pool sized for 4 sequences (16 slots), 12 submitted: the port
    preempts and resumes exactly as JAX does, and every stream is JAX's."""
    ref = _jax_run(weights, ("overload", sampled), headroom=0.5,
                   sampled=sampled)
    port = _run(weights, PORT, 0.5, sampled=sampled)
    _assert_same(port, ref)
    ov = port[1].stats()["overload"]
    assert ov["preempted_seqs"] > 0 and ov["swap_bytes_out"] > 0
    _assert_drained(port[1])


CHAOS = {
    # forced preemptions at both safe points plus admit/decode denials
    "pre_post": dict(headroom=2.0, n_req=6, max_new=12, schedule=dict(
        preempt_at=[(3, "pre", "auto"), (6, "post", 1), (9, "pre", "auto")],
        alloc_fail_at=[(4, "admit"), (7, "decode")])),
    # denials at decode and at a host-tier resume, under pressure
    "decode_resume": dict(headroom=0.75, n_req=6, max_new=12,
                          schedule=dict(
                              alloc_fail_at=[(3, "decode"), (5, "resume")],
                              preempt_at=[(4, "post", 0)])),
    # one block admitted a step: victims torn out between their chunks
    "mid_chunk": dict(headroom=2.0, n_req=3, max_new=6, prompt_blocks=4,
                      seed=11, prefill_budget=8, schedule=dict(
                          preempt_at=[(2, "pre", 0), (5, "pre", "auto")])),
}


@pytest.mark.parametrize("name", sorted(CHAOS))
def test_chaos_schedules_match_jax(weights, name):
    """Fixed chaos schedules: the port's run equals JAX's in every
    comparable, injector log included, and equals its own clean run."""
    kw = dict(CHAOS[name])
    ref = _jax_run(weights, ("chaos", name), **kw)
    port = _run(weights, PORT, **kw)
    _assert_same(port, ref)
    assert port[1].stats()["overload"]["request_preempts"] >= 1
    kw.pop("schedule")
    clean, _, _ = _run(weights, PORT, **kw)
    assert port[0] == clean
    _assert_drained(port[1])


# ----------------------------------------------------- port against port

@pytest.mark.parametrize("scheduler", ["fifo", "spf", "priority"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_tight_pool_equals_roomy_pool(weights, scheduler, sampled):
    """Every victim policy: a pool 4x smaller preempts and resumes, and
    every stream equals the roomy run's token for token."""
    roomy, _, _ = _run(weights, PORT, 2.0, sampled=sampled,
                       scheduler=scheduler)
    tight, eng, _ = _run(weights, PORT, 0.5, sampled=sampled,
                         scheduler=scheduler)
    assert tight == roomy
    assert all(len(t) == 20 for t in tight.values())
    assert eng.stats()["overload"]["preempted_seqs"] > 0
    _assert_drained(eng)


def test_forced_preempts_resume_sampled_draws(weights):
    """Forced preemptions of sampled and greedy requests, at both safe
    points and mid-chunk: each resumed request draws exactly the tokens
    of its uninterrupted run (sampling keys are re-derived, not saved)."""
    kw = dict(headroom=2.0, n_req=6, max_new=10, sampled=True,
              prefill_budget=16)
    clean, _, _ = _run(weights, PORT, **kw)
    chaos, eng, inj = _run(weights, PORT, schedule=dict(preempt_at=[
        (2, "pre", 0), (3, "post", 1), (5, "pre", 3), (7, "post", "auto")]),
        **kw)
    assert chaos == clean
    per = eng.stats()["per_request"]
    assert per[1]["preempts"] >= 1 and per[3]["preempts"] >= 1
    assert inj.faults()["preempt"] == 4
    _assert_drained(eng)


def test_reference_chaos_schedule_admits_each_range_once(weights):
    """The schedule on which the JAX engine emits a 13th token (recorded
    in ROADMAP Queue 3): at step 1 sequence 0 registers, its chunk is
    denied, and the "post" preemption takes it while it is still queued.
    The JAX engine queues it a second time, so after it finished the
    stale entry re-admits its prompt tail ((0, 8..16) through the prefix
    cache) and emits one token too many.  The port leaves a queued
    victim in place: each prompt range is admitted once, and every stream
    has 12 tokens and equals the clean run's."""
    kw = dict(headroom=0.75, n_req=6, max_new=12)
    clean, _, _ = _run(weights, PORT, **kw)
    chaos, eng, inj = _run(weights, PORT, schedule=dict(
        preempt_at=[(1, "post", "auto")], alloc_fail_at=[(1, "admit")]),
        **kw)
    assert inj.log == [("alloc", 1, "admit"), ("preempt", 1, "post", "auto")]
    assert chaos == clean
    assert all(len(t) == 12 for t in chaos.values())
    for sid in range(6):
        ranges = [(r.start, r.end) for r in eng.admission_log
                  if r.seq_id == sid]
        covered = [t for s, e in ranges for t in range(s, e)]
        assert sorted(covered) == sorted(set(covered)), (sid, ranges)
    assert eng.stats()["overload"]["request_preempts"] == 1
    _assert_drained(eng)


@pytest.mark.parametrize("max_new_b", [6, 1])
def test_victim_with_first_token_in_flight(weights, max_new_b):
    """A decode-time denial in the step that admits the only other
    sequence's final chunk: that sequence is the only victim, with its
    first token still in flight.  It parks as decode-live and resumes (or,
    when that token already finishes it, leaves the tier); its stream is
    the clean run's.  The JAX engine parks it mid-prefill and later
    raises PoolExhausted with work left (ROADMAP Queue 3)."""
    cfg, _ = weights["port"]
    bs = cfg.kv_block_size

    def run(inj):
        eng = _engine(weights, PORT, max_batch=2, max_seq_len=8 * bs,
                      pool_headroom=2.0, auto_release=True,
                      fault_injector=inj)
        rng = np.random.RandomState(3)
        prompts = [rng.randint(0, cfg.vocab_size, 2 * bs) for _ in "ab"]
        eng.submit(Request(seq_id=0, prompt=prompts[0], max_new_tokens=20))
        outs = {}
        for step in range(1, 80):
            if step == 10:           # sequence 0 crosses a block at step 10
                eng.submit(Request(seq_id=1, prompt=prompts[1],
                                   max_new_tokens=max_new_b))
            for ro in eng.poll():
                outs.setdefault(ro.seq_id, []).extend(ro.new_token_ids)
            eng.check_invariants()
            if step > 10 and not eng.has_unfinished():
                return outs, eng
        raise AssertionError("engine failed to drain")

    clean, _ = run(None)
    inj = ServeFaultInjector(alloc_fail_at=[(10, "decode")])
    chaos, eng = run(inj)
    assert inj.log == [("alloc", 10, "decode")]
    assert chaos == clean
    assert len(chaos[1]) == max_new_b
    ov = eng.stats()["overload"]
    assert ov["request_preempts"] == 1 and ov["host_tier_seqs"] == 0
    assert ov["request_resumes"] == (1 if max_new_b > 1 else 0)
    assert not eng._preempted and not eng.scheduler.pending()
    assert not eng.manager.blocks


def test_injected_denial_is_not_a_stuck_step(weights):
    """A step whose only event is an injected admission denial (one
    prompt, one block admitted a step, nothing decoding yet) is not a
    stuck step: poll() goes on and the request finishes.  The JAX engine's
    no-progress guard raises PoolExhausted there."""
    cfg, _ = weights["port"]
    bs = cfg.kv_block_size
    inj = ServeFaultInjector(alloc_fail_at=[(2, "admit")])
    eng = _engine(weights, PORT, max_batch=2, max_seq_len=8 * bs,
                  prefill_budget=bs, auto_release=True, fault_injector=inj)
    eng.submit(Request(seq_id=0, prompt=np.arange(4 * bs) % cfg.vocab_size,
                       max_new_tokens=4))
    out = _drain(eng)
    assert inj.log == [("alloc", 2, "admit")]
    assert len(out[0]) == 4
    assert [(r.start, r.end) for r in eng.admission_log] == [
        (0, 8), (8, 16), (16, 24), (24, 32)]


def test_fail_policy_is_fail_fast(weights):
    """``overload_policy="fail"``: footprint-gated admission, nothing
    preempted, the streams still the roomy run's; a decode-time miss
    raises PoolExhausted with the occupancy diagnostics."""
    roomy, _, _ = _run(weights, PORT, 2.0)
    tight, eng, _ = _run(weights, PORT, 0.5, overload_policy="fail")
    assert tight == roomy
    assert eng.stats()["overload"]["preempted_seqs"] == 0
    with pytest.raises(PoolExhausted, match="decode step") as ei:
        _run(weights, PORT, 2.0, n_req=2, overload_policy="fail",
             schedule=dict(alloc_fail_at=[(2, "decode")]))
    for key in ("pool_blocks", "mapped_blocks", "free_flex", "queued",
                "live", "finished_unreleased", "preempted"):
        assert key in ei.value.diag, key


def test_unadmittable_prompt_raises_with_diagnostics(weights):
    """A prompt whose blocks alone exceed the pool can never run:
    preemption cannot help, so PoolExhausted survives, with diagnostics."""
    cfg, _ = weights["port"]
    bs = cfg.kv_block_size
    eng = _engine(weights, PORT, max_batch=2, max_seq_len=24 * bs,
                  pool_headroom=0.4)
    assert eng.hybrid_cfg.total_slots < 20
    eng.submit(Request(seq_id=0, max_new_tokens=2,
                       prompt=np.arange(20 * bs) % cfg.vocab_size))
    with pytest.raises(PoolExhausted, match="cannot be admitted") as ei:
        for _ in range(10):
            eng.poll()
    assert ei.value.diag["pool_blocks"] < 20
    assert ei.value.diag["preempted"] == 0
    assert "pool_blocks=" in str(ei.value)


def test_finished_unreleased_still_raises(weights):
    """Every slot parked on a finished, unreleased sequence is a real
    deadlock: finished sequences are never victims, so poll() raises."""
    cfg, _ = weights["port"]
    bs = cfg.kv_block_size
    eng = _engine(weights, PORT, max_batch=2, max_seq_len=4 * bs)
    rng = np.random.RandomState(3)
    for i in range(3):
        eng.submit(Request(seq_id=i, max_new_tokens=2,
                           prompt=rng.randint(0, cfg.vocab_size, bs)))
    with pytest.raises(PoolExhausted, match="finished") as ei:
        for _ in range(40):
            eng.poll()
    assert ei.value.diag["finished_unreleased"] == 2


def test_preempt_counts_survive_seq_id_reuse(weights):
    """The monotone preempt/resume globals keep their counts when a
    finished seq_id is reused: submit() banks the dropped row."""
    cfg, _ = weights["port"]
    bs = cfg.kv_block_size
    inj = ServeFaultInjector(preempt_at=[(2, "post", 0), (4, "pre", 1)])
    eng = _engine(weights, PORT, max_batch=4, max_seq_len=8 * bs,
                  pool_headroom=2.0, auto_release=True, fault_injector=inj)
    rng = np.random.RandomState(3)
    for _ in range(2):
        for i in range(3):
            eng.submit(Request(
                seq_id=i, prompt=rng.randint(0, cfg.vocab_size, 2 * bs),
                max_new_tokens=6))
        _drain(eng)
    s = eng.stats()
    ov = s["overload"]
    assert ov["request_preempts"] == 2 == ov["request_resumes"]
    assert ov["dropped_request_preempts"] == 2
    assert ov["dropped_request_resumes"] == 2
    assert sum(r["preempts"] for r in s["per_request"].values()) == 0
    eng.check_invariants()


def test_overload_stats_shape(weights):
    _, eng, _ = _run(weights, PORT, 0.5, n_req=8)
    s = eng.stats()
    assert set(s["overload"]) == {
        "preempted_seqs", "resumed_seqs", "host_tier_seqs",
        "swap_bytes_out", "swap_bytes_in", "request_preempts",
        "request_resumes", "dropped_request_preempts",
        "dropped_request_resumes"}
    for row in s["per_request"].values():
        assert {"preempts", "resumes"} <= set(row)
    assert (sum(r["preempts"] for r in s["per_request"].values())
            == s["overload"]["request_preempts"] > 0)


def test_injector_schedule_validation_and_log():
    with pytest.raises(ValueError, match="phase"):
        ServeFaultInjector(preempt_at=[(1, "mid", "auto")])
    with pytest.raises(ValueError, match="phase"):
        ServeFaultInjector(crash_at=[(1, "mid")])
    inj = ServeFaultInjector(alloc_fail_at=[(2, "admit")],
                             crash_at=[(3, "pre")])
    assert inj.alloc_unavailable(1, "admit") is False
    assert inj.alloc_unavailable(2, "admit") is True
    assert inj.alloc_unavailable(2, "admit") is False      # fires once
    with pytest.raises(InjectedStepFault):
        inj.maybe_crash(3, "pre")
    inj.maybe_crash(3, "pre")                              # fires once
    assert inj.faults() == {"alloc": 1, "preempt": 0, "step": 1}
    assert issubclass(InjectedAllocFault, InjectedFault)
    assert InjectedAllocFault.kind == "alloc"
    # the seeded random chaos draws what JAX's injector draws
    a = ServeFaultInjector(seed=5, preempt_rate=0.3, alloc_fail_rate=0.2)
    b = JInjector(seed=5, preempt_rate=0.3, alloc_fail_rate=0.2)
    for step in range(1, 30):
        assert a.forced_preempts(step, "pre") == b.forced_preempts(step,
                                                                   "pre")
        assert (a.alloc_unavailable(step, "admit")
                == b.alloc_unavailable(step, "admit"))
    assert a.log == b.log


# ------------------------------------------------- victim-policy units

class _St:
    def __init__(self, seq_id, arrival, last_step, prompt_len=8,
                 priority=0):
        self.request = type("R", (), {
            "seq_id": seq_id, "priority": priority,
            "prompt": np.zeros(prompt_len)})()
        self.arrival = arrival
        self.last_step = last_step


def test_default_victim_lru_then_youngest():
    a = _St(0, arrival=0, last_step=5)
    b = _St(1, arrival=2, last_step=3)          # least recent commit
    c = _St(2, arrival=4, last_step=3)          # tie: younger arrival
    assert default_victim([a, b], now=9) is b
    assert default_victim([a, b, c], now=9) is c
    assert FIFOScheduler.victim([a, c], 9) is c
    assert FIFOScheduler().should_preempt(a.request, 0, b, 9) is False


def test_spf_victim_longest_prompt():
    a = _St(0, arrival=0, last_step=1, prompt_len=4)
    b = _St(1, arrival=1, last_step=9, prompt_len=32)
    assert ShortestPromptFirst.victim([a, b], now=9) is b
    assert ShortestPromptFirst().should_preempt(a.request, 0, b, 9) is False


def test_priority_victim_and_admission_gate():
    s = PriorityAgingScheduler(aging_rate=0.0)
    lo = _St(0, arrival=0, last_step=8, priority=1)
    hi = _St(1, arrival=0, last_step=2, priority=9)
    assert s.victim([lo, hi], now=10) is lo
    urgent = _St(2, arrival=10, last_step=0, priority=5).request
    assert s.should_preempt(urgent, 10, lo, 10) is True      # 5 > 1
    assert s.should_preempt(urgent, 10, hi, 10) is False     # 5 < 9
    equal = _St(3, arrival=10, last_step=0, priority=1).request
    assert s.should_preempt(equal, 10, lo, 10) is False      # strict >


def test_scheduler_policies_are_the_reference_copy():
    """The port's victim and admission policies are the JAX file's code,
    docstrings and comments aside (compared as syntax trees)."""
    import ast
    import inspect
    import textwrap
    from repro.serve import scheduler as jsched
    from repro_torch.serve import scheduler as tsched

    def tree(mod, name):
        t = ast.parse(textwrap.dedent(inspect.getsource(getattr(mod,
                                                                name))))
        for node in ast.walk(t):
            body = getattr(node, "body", None)
            if (isinstance(node, (ast.FunctionDef, ast.ClassDef)) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                node.body = body[1:] or [ast.Pass()]
        return ast.dump(t)

    for name in ("default_victim", "FIFOScheduler", "ShortestPromptFirst",
                 "PriorityAgingScheduler", "make_scheduler"):
        assert tree(tsched, name) == tree(jsched, name), name


# ---------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_preempt_round_trip(weights, cuda):
    """On the card: a preempted sequence's gathered blocks, scattered back
    by its resume, read byte-equal from the pool, and the tight run's
    streams equal the roomy run's and the CPU's."""
    cfg, tp = weights["port"]
    tpc = jax.tree.map(lambda t: t.to(cuda), tp)
    bs = cfg.kv_block_size

    def run(dev, params, headroom):
        eng = Engine(cfg, params, EngineConfig(
            max_batch=4, max_seq_len=8 * bs, pool_headroom=headroom,
            auto_release=True), device=dev)
        rng = np.random.RandomState(7)
        for i in range(12):
            eng.submit(Request(seq_id=i, max_new_tokens=20,
                               prompt=rng.randint(0, cfg.vocab_size,
                                                  2 * bs)))
        saved = {}
        preempt, resume = eng.preempt_request, eng._resume_preempted

        def spy_preempt(sid):
            preempt(sid)
            rec = eng._preempted[sid]
            saved[sid] = (list(rec.blocks), rec.kv.clone())

        def spy_resume(req, reserved, busy):
            ok = resume(req, reserved, busy)
            if ok:
                blocks, kv = saved.pop(req.seq_id)
                slots = [eng.manager.lookup(req.seq_id, b)[0]
                         for b, _ in blocks]
                idx = torch.tensor(slots, device=eng.device)
                back = torch.stack([eng.dstate["k_pool"][:, idx],
                                    eng.dstate["v_pool"][:, idx]]).cpu()
                assert torch.equal(back, kv)
            return ok

        eng.preempt_request, eng._resume_preempted = spy_preempt, spy_resume
        out = _drain(eng)
        return out, eng

    tight, eng = run(cuda, tpc, 0.5)
    assert eng.stats()["overload"]["preempted_seqs"] > 0
    _assert_drained(eng)
    assert tight == run(cuda, tpc, 2.0)[0]
    assert tight == run("cpu", tp, 0.5)[0]
