"""The port's Engine against the JAX Engine on the same requests.

Both run the reduced granite-8b with the same float32 weights, with
``prefill_mode="recompute"``, ``prefix_cache=None`` and
``overload_policy="fail"`` (the recompute admission path; the prefix-KV
path and the prefix cache have their own test files), the port on the
CPU.  The workload mixes prompt lengths, chunks one prompt longer than the
prefill budget, recycles slots (more requests than ``max_batch`` with
``auto_release``) and stops one request on its ``eos_token``.  Admission
log, manager stats, per-request RSW hits / flex walks and the greedy token
streams must be identical; on a diverging stream the failure names the
step and the port's top-2 logit margin there.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import init_params as jinit, model_dims as jdims
from repro.serve import Engine as JEngine, EngineConfig as JConfig
from repro.serve import Request as JRequest
from repro_torch.configs import ARCHS, reduced
from repro_torch.params import params_from_numpy
from repro_torch.serve import Engine, EngineConfig, Request

torch.set_num_threads(2)

ENGINE = dict(max_batch=3, max_seq_len=64, restseg_fraction=0.25,
              prefill_budget=24, auto_release=True)
PROMPT_BLOCKS = [1, 3, 5, 2, 1, 4, 2]      # 5 blocks = 40 tokens > budget
NEW_TOKENS = [5, 7, 6, 4, 8, 6, 5]
EOS_REQ = 3


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(JARCHS["granite-8b"])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, reduced(ARCHS["granite-8b"]), tp


def _prompts(vocab):
    rng = np.random.RandomState(11)
    return [rng.randint(0, vocab, n * 8) for n in PROMPT_BLOCKS]


def _run(eng, req_cls, prompts, eos=None, margins=None):
    """Submit everything, step to completion; returns {seq_id: [(step,
    token)]}."""
    for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS)):
        eng.submit(req_cls(seq_id=i, prompt=p, max_new_tokens=n,
                           eos_token=eos if i == EOS_REQ else None))
    streams = {i: [] for i in range(len(prompts))}
    for _ in range(200):
        if not eng.has_unfinished():
            break
        slots = dict(eng._slot_of)
        out = eng.step()
        for sid, tok in out.items():
            streams[sid].append((eng.step_count, tok))
        if margins is not None:
            margins["slots"][eng.step_count] = {**slots, **eng._slot_of}
    assert not eng.has_unfinished(), "engine failed to drain"
    return streams


def _recording(eng, margins):
    """Wrap the port engine's steps to keep each step's top-2 margins."""
    serve, pre = eng._serve_step, eng._prefill_step

    def top2(logits):
        v = logits.float().topk(2, dim=-1).values
        return (v[:, 0] - v[:, 1]).tolist()

    def serve_rec(params, dstate, tokens, active=None, **kw):
        logits, dstate, stats = serve(params, dstate, tokens, active, **kw)
        margins["decode"][eng.step_count] = top2(logits)
        return logits, dstate, stats

    def pre_rec(params, dstate, batch, slots, slot_ids, ctx, last_pos,
                **kw):
        last, dstate, stats = pre(params, dstate, batch, slots, slot_ids,
                                  ctx, last_pos, **kw)
        row = margins["prefill"].setdefault(eng.step_count, {})
        for i, sid in enumerate(slot_ids.tolist()):
            if sid >= 0:
                row[sid] = top2(last)[i]
        return last, dstate, stats

    eng._serve_step, eng._prefill_step = serve_rec, pre_rec


def test_engine_streams_and_telemetry_match(weights):
    jcfg, jp, cfg, tp = weights
    prompts = _prompts(cfg.vocab_size)

    # a port-only run picks an eos that the EOS request really produces
    port_cfg = EngineConfig(prefill_mode="recompute", prefix_cache=None,
                            overload_policy="fail", **ENGINE)
    probe = Engine(cfg, tp, port_cfg, device="cpu")
    eos = [t for _, t in _run(probe, Request, prompts)[EOS_REQ]][2]

    jeng = JEngine(jcfg, jp, JConfig(prefill_mode="recompute",
                                     prefix_cache=None,
                                     overload_policy="fail", **ENGINE))
    jstreams = _run(jeng, JRequest, prompts, eos)

    teng = Engine(cfg, tp, port_cfg, device="cpu")
    margins = {"decode": {}, "prefill": {}, "slots": {}}
    _recording(teng, margins)
    tstreams = _run(teng, Request, prompts, eos, margins)

    for sid in jstreams:
        want, got = jstreams[sid], tstreams[sid]
        if got != want:
            i = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
            step = got[i][0]
            slot = margins["slots"][step].get(sid)
            m = (margins["prefill"].get(step, {}).get(slot) if i == 0
                 else margins["decode"][step][slot])
            pytest.fail(f"request {sid} diverges at token {i} (step "
                        f"{step}): port {got[i][1]} vs JAX {want[i][1]}, "
                        f"port top-2 logit margin {m}")
    assert jeng.admission_log == teng.admission_log
    assert any(r.end - r.start < 40 and r.seq_id == 2
               for r in teng.admission_log), "the long prompt was chunked"
    assert dict(jeng.manager.stats) == dict(teng.manager.stats)
    jpr, tpr = jeng.stats()["per_request"], teng.stats()["per_request"]
    for sid in jpr:
        for key in ("rsw_hits", "flex_walks", "swap_faults"):
            assert jpr[sid][key] == tpr[sid][key], (sid, key)
    st = teng.stats()
    assert st["rsw_hits"] > 0 and st["flex_walks"] > 0
    assert st["migrations_flex_to_rest"] > 0       # promotions ran
    assert teng._states[EOS_REQ].finish_reason == "stop"
    assert not teng._slot_of and not teng.requests   # all auto-released
    teng.check_invariants()


def test_engine_refuses_unported_features(weights):
    """Only the features still unported raise (meshes); the JAX engine's
    defaults (prefix-KV prefill, the prefix cache, preemption to the host
    tier) construct, speculative decoding constructs, and a sampled
    request is accepted."""
    _, _, cfg, tp = weights
    with pytest.raises(NotImplementedError, match="ROADMAP P15"):
        Engine(cfg, tp, EngineConfig(mesh_shape=(1, 1)), device="cpu")
    assert Engine(cfg, tp, EngineConfig(spec_decode="ngram"),
                  device="cpu").spec_K == 4
    with pytest.raises(ValueError, match="overload_policy"):
        Engine(cfg, tp, EngineConfig(overload_policy="swap"), device="cpu")
    eng = Engine(cfg, tp, EngineConfig(), device="cpu")
    assert eng.prefill_mode == "prefix_kv"
    assert eng.prefix_cache is not None
    assert eng.overload_policy == "preempt"
    from repro_torch.serve import SamplingParams
    eng.submit(Request(seq_id=0, prompt=np.zeros(8, np.int64),
                       sampling=SamplingParams(temperature=1.0)))


def test_steady_step_translates_once_and_copies_once(weights, monkeypatch):
    """A steady decode step runs ONE translation dispatch and makes ONE
    device-to-host copy (``.cpu()``), whatever the batch holds; no
    ``.item()`` / ``.tolist()`` sneaks in another sync."""
    _, _, cfg, tp = weights
    from repro_torch.serve import decode as tdecode
    eng = Engine(cfg, tp, EngineConfig(max_batch=3, max_seq_len=64),
                 device="cpu")
    rng = np.random.RandomState(4)
    for i in range(3):
        eng.submit(Request(seq_id=i, prompt=rng.randint(0, 256, 16),
                           max_new_tokens=20))
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
    for n in range(1, 4):                       # steady decode steps
        out = eng.step()
        assert len(out) == 3
        assert counts == {"lookup": n, "cpu": n}


def _drain(eng, req_cls, prompts, max_new):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(seq_id=i, prompt=p, max_new_tokens=max_new))
    while eng.has_unfinished():
        eng.step()
    return ({i: list(eng._states[i].generated) for i in range(len(prompts))},
            dict(eng.manager.stats), list(eng.admission_log))


@pytest.mark.parametrize("mode", ["flexible_only", "restrictive_only"])
def test_engine_modes_match(weights, mode):
    """The paper's two baselines: every block flexible, or every block
    restrictive with set conflicts evicting to swap (a 16-slot pool, 2 sets,
    three 7-block sequences at once)."""
    jcfg, jp, cfg, tp = weights
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, 40) for _ in range(6)]
    kw = dict(max_batch=3, max_seq_len=64, pool_headroom=0.5,
              auto_release=True, mode=mode)
    want = _drain(JEngine(jcfg, jp, JConfig(
        prefill_mode="recompute", prefix_cache=None, overload_policy="fail",
        **kw)), JRequest, prompts, 12)
    got = _drain(Engine(cfg, tp, EngineConfig(
        prefill_mode="recompute", prefix_cache=None, overload_policy="fail",
        **kw), device="cpu"), Request, prompts, 12)
    assert got == want
    stats = got[1]
    if mode == "restrictive_only":
        assert stats["swap_out_evict"] > 0 and stats["flex_walks"] == 0
    else:
        assert stats["rsw_hits"] == 0 and stats["flex_walks"] > 0


@pytest.mark.gpu
def test_gpu_engine_matches_cpu(weights):
    """On a card: the same requests through the CUDA kernels and through
    the plain versions on the CPU give the same greedy streams and
    translation stats, and every kernel ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.utopia_rsw.ops import utopia_translate_step
    _, _, cfg, tp = weights
    prompts = _prompts(cfg.vocab_size)
    # the flash kernel runs on the recompute prefill only
    kw = dict(ENGINE, attn_impl="flash", prefill_mode="recompute",
              prefix_cache=None)
    cpu = _drain(Engine(cfg, tp, EngineConfig(**kw), device="cpu"), Request,
                 prompts, 8)
    before = (utopia_translate_step.launches, paged_attention.launches,
              flash_attention.launches)
    tp_cuda = jax.tree.map(lambda t: t.to("cuda"), tp)
    card = _drain(Engine(cfg, tp_cuda, EngineConfig(**kw), device="cuda"),
                  Request, prompts, 8)
    after = (utopia_translate_step.launches, paged_attention.launches,
             flash_attention.launches)
    assert all(a > b for a, b in zip(after, before))
    assert card == cpu
