"""The port's speculative decoding against the JAX package's, and the
contracts of ``tests/test_spec_decode.py`` held port against port.

Against JAX (the same float32 weights, ``reduced(granite-8b)``):
``propose_ngram_drafts`` and ``verify_draft_tokens`` exactly,
``sample_tokens_q``'s draws exactly, every spec step's accepted tokens,
emitted counts, token history and context lengths exactly and its logits
within 2e-5, and whole-engine streams, ``spec_drafted`` /
``spec_accepted``, per-request counters and admission logs for K in
{1, 3, 4}, with greedy and sampled requests, a prompt-lookup-friendly
repetitive prompt and a prefix-cache hit.

Port against port: spec-on streams equal spec-off streams (greedy and
sampled, mid-decode admission, legacy prefix sharing), eos /
``max_new_tokens`` truncation mid-window, rejected-tail deallocation, a
window overrunning the KV capacity, the capacity ``"length"`` stop,
counters summing to the globals, slot reuse clearing the history, one
translation and one ``.cpu()`` a step, preemption to the host tier and
crash recovery (crashed + restored = uncrashed).  A ``gpu``-marked twin
holds the card against the CPU.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import init_params as jinit, model_dims as jdims
from repro.serve import Engine as JEngine, EngineConfig as JConfig
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import sampling as jsampling
from repro.serve.spec_decode import propose_ngram_drafts as j_propose
from repro_torch.configs import ARCHS, reduced
from repro_torch.params import params_from_numpy
from repro_torch.runtime import ResilientServe, ServeFaultInjector
from repro_torch.serve import Engine, EngineConfig, Request, SamplingParams
from repro_torch.serve import MemorySink, MetricsLogger
from repro_torch.serve import decode as tdecode
from repro_torch.serve import sampling as tsampling
from repro_torch.serve.spec_decode import propose_ngram_drafts

torch.set_num_threads(2)

SAMPLED = dict(temperature=0.9, top_k=8, top_p=0.95)
PORT = (Engine, EngineConfig, Request, SamplingParams)
JAX = (JEngine, JConfig, JRequest, JSamplingParams)


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(JARCHS["granite-8b"])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return {"jax": (jcfg, jp), "port": (reduced(ARCHS["granite-8b"]), tp)}


def _engine(weights, api, **ekw):
    if api is JAX:
        return JEngine(*weights["jax"], JConfig(**ekw))
    return Engine(*weights["port"], EngineConfig(**ekw), device="cpu")


def _repetitive(bs, blocks):
    """One n-gram pattern repeated: the drafter matches it at once."""
    return np.tile(np.asarray([11, 23, 42, 7]), blocks * bs // 4)[:blocks
                                                                  * bs]


def _drain(eng, limit=400, each_step=None):
    steps = 0
    while eng.has_unfinished():
        eng.step()
        steps += 1
        if each_step is not None:
            each_step(eng)
        assert steps < limit, "engine failed to drain"
    return steps


# ------------------------------------------------- drafter and verifier

def _hist(rows, H=32):
    h = -np.ones((len(rows), H), np.int32)
    for i, r in enumerate(rows):
        h[i, :len(r)] = r
    return h


DRAFT_CASES = {
    # rows (the current token last), ctx override
    "latest_match": ([[1, 5, 6, 7, 8, 9, 2, 5, 6],
                      [3, 4, 1, 1, 1, 3, 4, 9, 9, 9, 2, 3, 4]], None),
    "no_match": ([[1, 2, 3, 4, 5, 6]], None),
    "runs_off_history": ([[7, 8, 1, 7, 8]], None),
    "negative_prefix": ([[-1, -1, 2, 3]], None),
    "ctx_at_end": ([list(range(32))], [32]),
    "random": (np.random.RandomState(0).randint(0, 4, (5, 30)).tolist(),
               None),
}


@pytest.mark.parametrize("case", sorted(DRAFT_CASES))
@pytest.mark.parametrize("ngram", [1, 2, 3])
@pytest.mark.parametrize("K", [1, 4])
def test_ngram_drafter_matches_jax(case, ngram, K):
    rows, ctx = DRAFT_CASES[case]
    hist = _hist(rows)
    ctx = np.asarray(ctx if ctx is not None
                     else [len(r) - 1 for r in rows], np.int32)
    want = np.asarray(j_propose(jnp.asarray(hist), jnp.asarray(ctx), K,
                                ngram))
    got = propose_ngram_drafts(torch.from_numpy(hist),
                               torch.from_numpy(ctx), K, ngram)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "latest_match" and ngram == 2 and K == 4:
        np.testing.assert_array_equal(want[:, :3], [[7, 8, 9], [9, 9, 9]])


def test_verify_draft_tokens_matches_jax():
    rng = np.random.RandomState(1)
    for K in (1, 3, 7):
        tgt = rng.randint(0, 3, (16, K + 1)).astype(np.int32)
        drafts = rng.randint(0, 3, (16, K)).astype(np.int32)
        want = jsampling.verify_draft_tokens(jnp.asarray(tgt),
                                             jnp.asarray(drafts))
        got = tsampling.verify_draft_tokens(torch.from_numpy(tgt),
                                            torch.from_numpy(drafts))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sample_tokens_q_matches_jax_and_single_position():
    """Position i of row b draws the token ``sample_tokens`` draws after
    ``steps[b, i]`` tokens (bitwise, port against port), and the draws
    equal JAX's: the threefry bits are equal, and the logits here are
    integers + 0.5 so that no gumbel float rounding can turn a winner."""
    rng = np.random.RandomState(2)
    B, Q, V = 6, 5, 64
    logits = (rng.randint(-8, 8, (B, Q, V)) + 0.5).astype(np.float32)
    temp = np.asarray([0.0, 0.7, 1.0, 1.3, 0.9, 0.5], np.float32)
    ks = np.asarray([0, 0, 5, 40, 8, 0], np.int32)
    ps = np.asarray([1.0, 0.9, 1.0, 0.95, 1.0, 0.5], np.float32)
    keys = np.stack([jsampling.prng_key_data(JSamplingParams(seed=s), 0)
                     for s in (0, 1, 2 ** 31, 7, 2 ** 33 + 5, 99)])
    steps = (rng.randint(0, 4000, B)[:, None]
             + np.arange(Q)[None, :]).astype(np.int32)
    want = np.asarray(jsampling.sample_tokens_q(
        *map(jnp.asarray, (logits, temp, ks, ps, keys, steps))))
    t = [torch.from_numpy(a) for a in (logits, temp, ks, ps,
                                       keys.astype(np.int64), steps)]
    got = tsampling.sample_tokens_q(*t)
    assert got.dtype == torch.int32 and got.shape == (B, Q)
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(Q):
        one = tsampling.sample_tokens(t[0][:, i], *t[1:5], t[5][:, i])
        assert torch.equal(one, got[:, i])


# -------------------------------------------------- against the engine

def _workload(eng, api, K):
    """Four requests a run: a random prompt, a repetitive one, a sampled
    random one, and (two steps later) a sampled repetitive one that hits
    the prefix cache on the second's first block.  Returns the streams."""
    _, _, req_cls, sp_cls = api
    bs = eng.cfg.kv_block_size
    rng = np.random.RandomState(K)
    prompts = [rng.randint(0, 256, 2 * bs), _repetitive(bs, 2),
               rng.randint(0, 256, bs), _repetitive(bs, 3)]
    reqs = [req_cls(seq_id=i, prompt=p, max_new_tokens=18 + i,
                    sampling=(sp_cls(seed=40 + i, **SAMPLED) if i >= 2
                              else sp_cls()))
            for i, p in enumerate(prompts)]
    for r in reqs[:3]:
        eng.submit(r)
    eng.step()
    eng.step()
    eng.submit(reqs[3])
    _drain(eng)
    return {r.seq_id: list(r.generated) for r in reqs}


def _recording(eng, log):
    """Wrap the engine's spec step to keep, per step, the logits, the
    accepted tokens, the emitted counts and the post-step history and
    context lengths (as numpy)."""
    step = eng._spec_step

    def rec(params, dstate, tokens, active=None, **kw):
        logits, dstate, st = step(params, dstate, tokens, active, **kw)
        log.append({k: np.array(v) for k, v in (
            ("logits", logits), ("acc", st["acc_tokens"]),
            ("n_emit", st["n_emit"]), ("hist", dstate["hist"]),
            ("ctx", dstate["ctx_len"]))})
        return logits, dstate, st

    eng._spec_step = rec


ENGINE = dict(max_batch=4, max_seq_len=128, auto_release=False,
              prefill_budget=32)
_JAX_RUNS = {}


def _jax_run(weights, K):
    if K not in _JAX_RUNS:
        eng = _engine(weights, JAX, spec_decode="ngram", num_draft_tokens=K,
                      **ENGINE)
        log = []
        _recording(eng, log)
        _JAX_RUNS[K] = (_workload(eng, JAX, K), eng, log)
    return _JAX_RUNS[K]


@pytest.mark.parametrize("K", [1, 3, 4])
def test_engine_streams_match_jax(weights, K):
    """Streams (greedy and sampled), spec counters, per-request rows,
    manager stats, prefix-cache stats and admission logs equal JAX's; the
    cache hit fed the drafter's history from the attached prefix."""
    jout, jeng, _ = _jax_run(weights, K)
    eng = _engine(weights, PORT, spec_decode="ngram", num_draft_tokens=K,
                  **ENGINE)
    out = _workload(eng, PORT, K)
    assert out == jout
    assert eng.admission_log == jeng.admission_log
    assert dict(eng.manager.stats) == dict(jeng.manager.stats)
    st, jst = eng.stats(), jeng.stats()
    assert st["prefix_cache"] == jst["prefix_cache"]
    assert st["prefix_cache"]["hits"] > 0
    for key in ("spec_drafted", "spec_accepted"):
        assert st[key] == jst[key], key
    for sid, row in jst["per_request"].items():
        for key in ("drafted", "accepted", "rsw_hits", "flex_walks",
                    "cached_blocks"):
            assert st["per_request"][sid][key] == row[key], (sid, key)
    assert st["per_request"][1]["accepted"] > 0
    eng.check_invariants()


def test_spec_step_matches_jax(weights):
    """Every verify step of the K=4 run: accepted tokens, emitted counts,
    the token history and the context lengths exactly JAX's, the logits
    within 2e-5 (float32)."""
    _, _, jlog = _jax_run(weights, 4)
    eng = _engine(weights, PORT, spec_decode="ngram", num_draft_tokens=4,
                  **ENGINE)
    log = []
    _recording(eng, log)
    _workload(eng, PORT, 4)
    assert len(log) == len(jlog) > 5
    for i, (g, w) in enumerate(zip(log, jlog)):
        for key in ("acc", "n_emit", "hist", "ctx"):
            np.testing.assert_array_equal(g[key], w[key],
                                          err_msg=f"step {i}: {key}")
        np.testing.assert_allclose(g["logits"], w["logits"], rtol=2e-5,
                                   atol=2e-5, err_msg=f"step {i}")


# ---------------------------------------------- port against port

def _streams(weights, spec, K=4, reqs=(), **ekw):
    eng = _engine(weights, PORT, spec_decode=spec, num_draft_tokens=K,
                  **ekw)
    reqs = [dataclasses.replace(r) for r in reqs]
    for r in reqs:
        eng.submit(r)
    steps = _drain(eng, each_step=lambda e: e.check_invariants())
    return [list(r.generated) for r in reqs], steps, eng


def _port_requests(cfg, seed=3, sampled=False):
    bs = cfg.kv_block_size
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, 2 * bs), _repetitive(bs, 2),
               rng.randint(0, cfg.vocab_size, bs)]
    return [Request(seq_id=i, prompt=p, max_new_tokens=20,
                    sampling=(SamplingParams(seed=i, **SAMPLED)
                              if sampled and i != 2 else SamplingParams()))
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("K", [1, 3, 4])
@pytest.mark.parametrize("sampled", [False, True])
def test_spec_on_equals_spec_off(weights, K, sampled):
    cfg = weights["port"][0]
    reqs = _port_requests(cfg, seed=K, sampled=sampled)
    kw = dict(max_batch=4, max_seq_len=16 * cfg.kv_block_size)
    off, steps_off, _ = _streams(weights, None, reqs=reqs, **kw)
    on, steps_on, eng = _streams(weights, "ngram", K, reqs=reqs, **kw)
    assert on == off
    st = eng.stats()
    assert st["spec_drafted"] > 0 and st["per_request"][1]["accepted"] > 0
    assert steps_on <= steps_off


def test_mid_decode_admission_and_legacy_sharing(weights):
    """Spec-on composes with chunked admission mid-decode and the legacy
    ``share_prefix_from`` kwargs (the prefix cache shares instead)."""
    cfg = weights["port"][0]
    bs = cfg.kv_block_size
    rng = np.random.RandomState(7)
    p_long = rng.randint(0, cfg.vocab_size, 4 * bs)
    p_sys = _repetitive(bs, 2)

    def run(spec):
        eng = _engine(weights, PORT, max_batch=3, max_seq_len=16 * bs,
                      prefill_budget=bs, spec_decode=spec,
                      num_draft_tokens=4)
        r0 = Request(seq_id=0, prompt=p_sys, max_new_tokens=14)
        eng.submit(r0)
        eng.step()
        eng.step()
        r1 = Request(seq_id=1, prompt=p_long, max_new_tokens=10)
        eng.submit(r1)
        r2 = Request(seq_id=2, prompt=p_sys, max_new_tokens=14)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng.submit(r2, share_prefix_from=0, shared_blocks=1)
        _drain(eng, each_step=lambda e: e.check_invariants())
        return [list(r.generated) for r in (r0, r1, r2)], eng

    (off, _), (on, eng) = run(None), run("ngram")
    assert on == off and on[0] == on[2]
    assert eng.stats()["prefix_cache"]["hits"] > 0


def test_eos_and_max_tokens_truncate_mid_window(weights):
    cfg = weights["port"][0]
    bs = cfg.kv_block_size
    prompt = _repetitive(bs, 2)
    probe, _, _ = _streams(weights, None, reqs=[
        Request(seq_id=0, prompt=prompt, max_new_tokens=8)], max_batch=1,
        max_seq_len=16 * bs)
    eos = probe[0][2]
    first_eos = probe[0].index(eos)
    for kw in (dict(max_new_tokens=8, eos_token=eos),
               dict(max_new_tokens=5),
               dict(max_new_tokens=first_eos + 1, eos_token=eos)):
        got = {}
        for spec in (None, "ngram"):
            (toks,), _, eng = _streams(
                weights, spec, reqs=[Request(seq_id=0, prompt=prompt,
                                             **kw)],
                max_batch=1, max_seq_len=16 * bs)
            slot = eng._slot_of[0]
            assert int(eng.dstate["ctx_len"][slot]) == int(
                eng._ctx_host[slot])
            got[spec] = (toks, eng._states[0].finish_reason)
        assert got["ngram"] == got[None], kw


def test_rejected_tail_blocks_are_deallocated(weights):
    """K=7 windows (K+1 = bs) cross a block boundary every step: a live
    row keeps at most the block of its next write position past its
    context, a finished row nothing uncommitted."""
    cfg = weights["port"][0]
    bs = cfg.kv_block_size
    rng = np.random.RandomState(3)
    eng = _engine(weights, PORT, max_batch=2, max_seq_len=16 * bs,
                  spec_decode="ngram", num_draft_tokens=7)
    for s in (0, 1):
        eng.submit(Request(seq_id=s, prompt=rng.randint(0, cfg.vocab_size,
                                                        2 * bs),
                           max_new_tokens=12))

    def check(eng):
        eng.check_invariants()
        for sid in (0, 1):
            if sid not in eng._slot_of:
                continue
            ctx = int(eng._ctx_host[eng._slot_of[sid]])
            thr = ctx if eng._states[sid].done else ctx + 1
            for b in range((thr + bs - 1) // bs,
                           eng.spec.max_blocks_per_seq):
                assert eng.manager.lookup(sid, b)[0] < 0, (sid, b, ctx)

    _drain(eng, each_step=check)


@pytest.mark.parametrize("K", [3, 4, 7])
def test_window_overrunning_capacity_stays_lossless(weights, K):
    cfg = weights["port"][0]
    bs = cfg.kv_block_size
    prompt = np.random.RandomState(13).randint(0, cfg.vocab_size, 2 * bs)
    req = Request(seq_id=0, prompt=prompt, max_new_tokens=14)
    kw = dict(max_batch=1, max_seq_len=2 * bs + 14 + bs)
    off, _, _ = _streams(weights, None, reqs=[req], **kw)
    on, _, _ = _streams(weights, "ngram", K, reqs=[req], **kw)
    assert on == off


@pytest.mark.parametrize("K", [3, 4, 7])
def test_kv_capacity_exhaustion_stops_with_length(weights, K):
    """A row whose ``max_new_tokens`` overruns its block table commits
    only exact tokens, keeps ``ctx_len`` and its host mirror equal after
    every step, and stops with "length" at ``nblk * bs`` positions."""
    cfg = weights["port"][0]
    bs = cfg.kv_block_size
    prompt = np.random.RandomState(21).randint(0, cfg.vocab_size, 2 * bs)
    kw = dict(max_batch=1, max_seq_len=4 * bs)
    off, _, _ = _streams(weights, None, reqs=[Request(
        seq_id=0, prompt=prompt, max_new_tokens=2 * bs + 1)], **kw)

    def same_ctx(eng):
        slot = eng._slot_of[0]
        assert int(eng.dstate["ctx_len"][slot]) == int(eng._ctx_host[slot])

    eng = _engine(weights, PORT, spec_decode="ngram", num_draft_tokens=K,
                  **kw)
    r = Request(seq_id=0, prompt=prompt, max_new_tokens=100)
    eng.submit(r)
    _drain(eng, each_step=same_ctx)
    eng.check_invariants()
    assert eng._states[0].finish_reason == "length"
    assert len(r.generated) == eng.spec.max_blocks_per_seq * bs - 2 * bs + 1
    assert list(r.generated) == off[0]
    st = eng.stats()
    per = st["per_request"][0]
    assert per["drafted"] == st["spec_drafted"]
    assert per["accepted"] == st["spec_accepted"] <= per["drafted"]


def test_capacity_stop_frees_slot_for_waiting_request(weights):
    cfg = weights["port"][0]
    bs = cfg.kv_block_size
    rng = np.random.RandomState(5)
    eng = _engine(weights, PORT, max_batch=1, max_seq_len=4 * bs,
                  spec_decode="ngram", num_draft_tokens=4, auto_release=True)
    eng.submit(Request(seq_id=0, prompt=rng.randint(0, cfg.vocab_size,
                                                    2 * bs),
                       max_new_tokens=100))
    r1 = Request(seq_id=1, prompt=rng.randint(0, cfg.vocab_size, bs),
                 max_new_tokens=4)
    eng.submit(r1)
    outs, polls = [], 0
    while eng.has_unfinished():
        outs.extend(eng.poll())
        polls += 1
        assert polls < 200
    assert {o.seq_id: o.finish_reason for o in outs if o.finished} == {
        0: "length", 1: "length"}
    assert len(r1.generated) == 4


def test_counters_sum_to_globals_and_feed_the_metrics(weights):
    cfg = weights["port"][0]
    bs = cfg.kv_block_size
    rng = np.random.RandomState(9)
    log = MetricsLogger([MemorySink()])
    eng = _engine(weights, PORT, max_batch=3, max_seq_len=16 * bs,
                  spec_decode="ngram", num_draft_tokens=4, metrics=log)
    for s in range(3):
        prompt = (_repetitive(bs, 2) if s == 0
                  else rng.randint(0, cfg.vocab_size, 2 * bs))
        eng.submit(Request(seq_id=s, prompt=prompt,
                           max_new_tokens=24 if s == 0 else 10 + 3 * s))
    _drain(eng)
    st = eng.stats()
    per = st["per_request"]
    assert sum(r["drafted"] for r in per.values()) == st["spec_drafted"] > 0
    assert sum(r["accepted"] for r in per.values()) == st["spec_accepted"]
    assert all(0 <= r["accepted"] <= r["drafted"] for r in per.values())
    assert per[0]["accepted"] > 0
    assert log.totals["spec_drafted"] == st["spec_drafted"]
    assert log.totals["spec_accepted"] == st["spec_accepted"]
    assert log.totals["tokens"] == sum(
        len(s.generated) for s in eng._states.values())


def test_history_tracks_stream_and_slot_reuse_clears_it(weights):
    """The device history holds prompt + generated at every committed
    position; a released slot's row resets to -1, and its next occupant
    decodes as spec-off does."""
    cfg = weights["port"][0]
    bs = cfg.kv_block_size
    prompt = _repetitive(bs, 2)
    eng = _engine(weights, PORT, max_batch=1, max_seq_len=16 * bs,
                  spec_decode="ngram", num_draft_tokens=3)
    r = Request(seq_id=0, prompt=prompt, max_new_tokens=10)
    eng.submit(r)
    _drain(eng)
    ctx = int(eng._ctx_host[0])
    want = np.concatenate([prompt, np.asarray(r.generated)])
    np.testing.assert_array_equal(eng.dstate["hist"][0, :ctx].numpy(),
                                  want[:ctx])
    eng.release(0)
    assert (eng.dstate["hist"][0] == -1).all()
    p2 = np.random.RandomState(5).randint(0, cfg.vocab_size, 2 * bs)
    r2 = Request(seq_id=1, prompt=p2, max_new_tokens=8)
    eng.submit(r2)
    _drain(eng)
    off, _, _ = _streams(weights, None, reqs=[r2], max_batch=1,
                         max_seq_len=16 * bs)
    assert list(r2.generated) == off[0]


def test_spec_step_translates_once_and_copies_once(weights, monkeypatch):
    """A verify step runs ONE translation (the windowed step entry) and
    makes ONE device-to-host copy; no other host sync."""
    cfg = weights["port"][0]
    eng = _engine(weights, PORT, max_batch=3, max_seq_len=64,
                  spec_decode="ngram", num_draft_tokens=4)
    for r in _port_requests(cfg, sampled=True):
        eng.submit(r)
    eng.step()                                  # admission
    counts = {"lookup": 0, "cpu": 0}
    lookup, cpu = tdecode._hybrid_lookup, torch.Tensor.cpu

    def counting_lookup(*a, **k):
        counts["lookup"] += 1
        return lookup(*a, **k)

    def counting_cpu(self, *a, **k):
        counts["cpu"] += 1
        return cpu(self, *a, **k)

    def forbidden(self, *a, **k):
        raise AssertionError("a host sync outside the step's one copy")

    monkeypatch.setattr(tdecode, "_hybrid_lookup", counting_lookup)
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    monkeypatch.setattr(torch.Tensor, "item", forbidden)
    monkeypatch.setattr(torch.Tensor, "tolist", forbidden)
    monkeypatch.setattr(torch.Tensor, "__bool__", forbidden)
    for n in range(1, 4):
        assert len(eng.step()) == 3
        assert counts == {"lookup": n, "cpu": n}


def test_engine_probes_verify_gemms_at_setup(weights, monkeypatch):
    """Setting up speculative decoding probes, at (max_batch, K+1), each
    GEMM layout that the verify step sends through ``decode_linear`` or
    the head; serving then probes nothing more."""
    monkeypatch.setattr(tdecode, "_ROWS_INVARIANT", {})
    cfg, params = weights["port"]
    eng = _engine(weights, PORT, max_batch=3, max_seq_len=64,
                  spec_decode="ngram", num_draft_tokens=4)
    probed = tdecode.verify_gemm_probes()
    assert probed and {k[-2:] for k in probed} == {(3, 5)}
    blk = tdecode.layer_params(params, 0)
    head = params["embed" if cfg.tie_embeddings else "lm_head"]["table"].T
    for w in [blk["attn"][k]["w"] for k in ("q", "o")] + [
            blk["mlp"][k]["w"] for k in ("gate", "up", "down")] + [head]:
        key = (tuple(w.shape), w.stride(), w.dtype, w.device, 3, 5)
        assert key in probed
    for r in _port_requests(cfg, sampled=True):
        eng.submit(r)
    _drain(eng)
    assert tdecode.verify_gemm_probes() == probed


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3])
def test_verify_kv_rows_equal_decode_steps(weights, dtype, batch):
    """The layer-0 K/V rows one verify step writes to the pool equal,
    bitwise, the rows K+1 decode steps write for the same tokens: the
    verify's K/V projections run at the decode step's shape, B rows a
    product (layer 0's input passes through no GEMM before them, so the
    equality is exact).  At B = 1 the decode step's product is a
    matrix-vector one, which rounds otherwise than a product of K+1 rows
    on the CPU."""
    cfg = weights["port"][0]
    K = 4
    eng = _engine(weights, PORT, max_batch=batch, max_seq_len=64,
                  spec_decode="ngram", num_draft_tokens=K,
                  dtype=getattr(torch, dtype))
    for r in _port_requests(cfg)[-batch:]:
        eng.submit(r)
    eng.step()                                  # admission
    seen = {}
    step = eng._spec_step

    def rec(params, dstate, tokens, active=None, **kw):
        seen["before"] = {k: v.clone() for k, v in dstate.items()}
        out = step(params, dstate, tokens, active, **kw)
        seen["tokens"] = torch.cat([tokens[:, None].to(torch.int32),
                                    out[2]["draft_tokens"]], dim=1)
        seen["active"] = active
        return out

    eng._spec_step = rec
    eng.step()                                  # one verify step
    ds = seen["before"]
    for i in range(K + 1):
        _, ds, _ = eng._serve_step(eng.params, ds, seen["tokens"][:, i],
                                   seen["active"])
    assert bool(seen["active"].all())           # no write to the sink row
    for pool in ("k_pool", "v_pool"):
        assert torch.equal(ds[pool][0], eng.dstate[pool][0]), pool


def test_spec_under_preemption(weights):
    """A pool of about two sequences for six requests, plus forced "pre"
    and "post" preemptions (the latter between a window's commit and the
    next verify): spec-on streams equal a roomy spec-off run's, the
    history row travels through the host tier, and the host tier's bytes
    include it."""
    cfg = weights["port"][0]
    bs = cfg.kv_block_size
    rng = np.random.RandomState(11)
    reqs = [Request(seq_id=i, prompt=(_repetitive(bs, 2) if i % 3 == 0
                                      else rng.randint(0, cfg.vocab_size,
                                                       2 * bs)),
                    max_new_tokens=16,
                    sampling=(SamplingParams(seed=i, **SAMPLED) if i % 2
                              else SamplingParams()))
            for i in range(6)]
    kw = dict(max_batch=4, max_seq_len=8 * bs, auto_release=True)
    off, _, _ = _streams(weights, None, reqs=reqs, pool_headroom=1.25, **kw)
    inj = ServeFaultInjector(preempt_at=[(3, "post", "auto"),
                                         (6, "pre", "auto")])
    on, _, eng = _streams(weights, "ngram", reqs=reqs, pool_headroom=0.5,
                          fault_injector=inj, **kw)
    assert on == off
    ov = eng.stats()["overload"]
    assert ov["request_preempts"] >= 3
    assert ov["resumed_seqs"] == ov["preempted_seqs"]
    assert ov["host_tier_seqs"] == 0 and not eng._preempted
    # every swap carried its K/V blocks and its history row
    assert ov["swap_bytes_out"] == ov["swap_bytes_in"] > 0


@pytest.mark.parametrize("phase", ["pre", "post"])
def test_spec_crash_restore_bit_identical(weights, phase):
    """Crashes (and a snapshot cadence that puts the restore point
    mid-window) replay to streams bitwise equal to the uncrashed run's."""
    cfg = weights["port"][0]
    reqs = _port_requests(cfg, seed=4, sampled=True)
    kw = dict(max_batch=4, max_seq_len=128, auto_release=True,
              prefill_budget=8, spec_decode="ngram", num_draft_tokens=3)

    def run(crash_at):
        inj = ServeFaultInjector(crash_at=crash_at)
        eng = _engine(weights, PORT, fault_injector=inj, **kw)
        sup = ResilientServe(eng, snapshot_every=3,
                             max_restarts=len(crash_at) + 1)
        for r in reqs:
            sup.submit(dataclasses.replace(r))
        outs = {}
        while sup.has_unfinished():
            for ro in sup.poll():
                outs.setdefault(ro.seq_id, []).extend(ro.new_token_ids)
        eng.check_invariants()
        return outs, sup

    ref, _ = run([])
    crashed, sup = run([(4, phase), (9, phase)])
    assert sup.restarts == 2
    assert crashed == ref


def test_spec_config_validation_and_off_state(weights):
    for kw in (dict(num_draft_tokens=0), dict(spec_ngram=0),
               dict(spec_ngram=-1), dict(spec_decode="medusa")):
        with pytest.raises(ValueError):
            _engine(weights, PORT, max_batch=1, max_seq_len=64,
                    **dict(dict(spec_decode="ngram"), **kw))
    off = _engine(weights, PORT, max_batch=2, max_seq_len=64)
    assert "hist" not in off.dstate and off.spec_K == 0
    on = _engine(weights, PORT, max_batch=2, max_seq_len=64,
                 spec_decode=True, num_draft_tokens=2)
    assert on.spec_K == 2
    assert on.dstate["hist"].shape == (2, 64)
    assert (on.dstate["hist"] == -1).all()


# ------------------------------------------------------- card vs CPU

@pytest.mark.gpu
def test_gpu_spec_engine_matches_cpu(weights):
    """On a card: the spec engine's streams, counters and admission logs
    equal the CPU's (float32), the verify read launched the per-query
    paged kernel and the window translation one launch a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.utopia_rsw.ops import utopia_translate_step
    cfg, tp = weights["port"]
    kw = dict(max_batch=4, max_seq_len=128, spec_decode="ngram",
              num_draft_tokens=4)
    reqs = _port_requests(cfg, sampled=True)

    def run(device, params):
        eng = Engine(cfg, params, EngineConfig(**kw), device=device)
        rs = [dataclasses.replace(r) for r in reqs]
        for r in rs:
            eng.submit(r)
        steps = _drain(eng)
        return [list(r.generated) for r in rs], eng, steps

    cpu, ceng, _ = run("cpu", tp)
    n_q, n_t = (paged_attention.launches_q_per_query,
                utopia_translate_step.launches)
    card, geng, steps = run("cuda", jax.tree.map(lambda t: t.to("cuda"),
                                                 tp))
    assert card == cpu
    assert geng.admission_log == ceng.admission_log
    for key in ("spec_drafted", "spec_accepted"):
        assert geng.stats()[key] == ceng.stats()[key]
    assert paged_attention.launches_q_per_query > n_q
    assert utopia_translate_step.launches - n_t <= steps
