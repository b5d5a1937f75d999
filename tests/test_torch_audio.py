"""The audio family (whisper) of the port against the JAX package's.

* The model: ``forward`` on the reduced whisper-medium with a frontend
  (8 frame embeddings into a 2-layer encoder), logits, the decoder's K/V,
  each layer's cross K/V and the encoder output: 1e-4 in float32, 3e-2
  of the tensor's scale in bfloat16; ``decode_cross`` at a decode step's
  (B,) and a verify step's (B, Q) leads; ``init_params`` gives the JAX
  tree (``encoder``, ``norm_x``, ``cross`` with biases, ``frontend_proj``,
  an untied head), ``params_from_numpy`` casts it; the decode state holds
  ``cross_k``/``cross_v`` rows.
* The engine, against the JAX engine: streams, admission logs, manager
  stats and per-request translation rows equal, greedy and sampled, for
  recompute and prefix-KV admission with the prefix read ``"exact"`` and
  ``"paged"`` and for speculative decoding.
* The prefix cache: two requests with one prompt and different audio,
  served one after the other: the JAX engine's ``"auto"`` cache attaches
  the prompt's blocks and serves the second otherwise than cache-off; the
  port's ``"auto"`` is off and serves JAX's cache-off streams;
  ``prefix_cache=True`` raises with the reason.
* Port against port, bitwise in float32: spec-on = spec-off, prefix-KV =
  recompute, a tight pool that preempts = a roomy one (each resume puts
  back the swapped cross rows byte for byte), crashed + restored =
  uncrashed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import FwdOptions as JFwd, forward as jforward
from repro.models import init_params as jinit, model_dims as jdims
from repro.serve import Engine as JEngine, EngineConfig as JConfig
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import FwdOptions, forward, model_dims
from repro_torch.params import init_params, params_from_numpy
from repro_torch.runtime import ResilientServe, ServeFaultInjector
from repro_torch.serve import (DecodeSpec, Engine, EngineConfig, Request,
                               SamplingParams, init_decode_state)

torch.set_num_threads(2)

ARCH = "whisper-medium"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = (1e-4 if dtype == "float32"
           else 3e-2 * max(1.0, float(np.abs(want).max())))
    npt.assert_allclose(got, want, rtol=tol, atol=tol)


def _specs(tree, torch_side):
    name = ((lambda l: str(l.dtype).split(".")[-1]) if torch_side
            else (lambda l: l.dtype.name))
    return {jax.tree_util.keystr(p): (tuple(l.shape), name(l))
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg, cfg = jreduced(JARCHS[ARCH]), reduced(ARCHS[ARCH])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg), dtype=jdt)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size, (2, 24))
    tokens[1, 16:] = 0                           # a padded row's tail
    front = rng.randn(2, cfg.frontend_tokens, cfg.d_model).astype(np.float32)
    jl, _, jc = jax.jit(lambda p, b: jforward(
        p, b, jcfg, jdims(jcfg), JFwd(dtype=jdt, collect_cache=True)))(
        jp, {"tokens": jnp.asarray(tokens), "frontend": jnp.asarray(front)})
    tl, aux, tc = forward(tp, {"tokens": _t(tokens), "frontend": _t(front)},
                          cfg, model_dims(cfg),
                          FwdOptions(dtype=tdt, collect_cache=True))
    assert tl.dtype == tdt and tuple(tl.shape) == jl.shape
    assert sorted(tc) == ["ck", "cv", "enc_out", "k", "v"]
    assert tuple(tc["ck"].shape) == (cfg.num_layers, 2, cfg.frontend_tokens,
                                     cfg.num_kv_heads, cfg.head_dim)
    for key in ("k", "v", "ck", "cv", "enc_out"):
        _close(tc[key], jc[key], dtype)
    _close(tl, jl, dtype)
    assert all(float(a) == 0.0 for a in aux.values())


@pytest.mark.parametrize("Q", [None, 5])
def test_decode_cross_matches_jax(Q):
    """The decode step's (B,) and the verify step's (B, Q) cross
    sublayer over installed cross K/V, float32."""
    from repro.serve.decode import decode_cross as jcross
    from repro_torch.serve.decode import decode_cross
    jcfg, cfg = jreduced(JARCHS[ARCH]), reduced(ARCHS[ARCH])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    blk = jax.tree.map(lambda a: a[1], jp["layers"])
    tblk = jax.tree.map(lambda t: t[1], tp["layers"])
    rng = np.random.RandomState(4)
    lead = (3,) if Q is None else (3, Q)
    x = rng.randn(*lead, cfg.d_model).astype(np.float32)
    ck, cv = (rng.randn(3, cfg.frontend_tokens, cfg.num_kv_heads,
                        cfg.head_dim).astype(np.float32) for _ in range(2))
    want = jcross(blk, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                  jcfg, jdims(jcfg), lambda name, a: a)
    got = decode_cross(tblk, _t(x), _t(ck), _t(cv), cfg, model_dims(cfg))
    _close(got, want, "float32")
    if Q is not None:       # each window position is the decode step's row
        for i in range(Q):
            one = decode_cross(tblk, _t(x[:, i]).contiguous(), _t(ck),
                               _t(cv), cfg, model_dims(cfg))
            assert torch.equal(one, got[:, i])


def test_init_params_tree_matches_jax():
    jcfg, cfg = jreduced(JARCHS[ARCH]), reduced(ARCHS[ARCH])
    for jdt, tdt in DTYPES.values():
        want = jax.eval_shape(lambda k: jinit(k, jcfg, jdims(jcfg),
                                              dtype=jdt),
                              jax.random.PRNGKey(0))
        got = init_params(torch.Generator().manual_seed(0), cfg,
                          model_dims(cfg), tdt, "cpu")
        assert _specs(got, True) == _specs(want, False)
        assert "lm_head" in got and "cross" in got["layers"]
        assert got["encoder"]["layers"]["attn"]["q"]["b"].shape == (
            cfg.encoder_layers, cfg.num_heads * cfg.head_dim)
    # the draw scale of the frontend projection: 1/sqrt(fan-in)
    w = init_params(torch.Generator().manual_seed(0), cfg, model_dims(cfg),
                    torch.float32, "cpu")["frontend_proj"]["w"]
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1


def test_params_from_numpy_casts_the_tree():
    jcfg = jreduced(JARCHS[ARCH])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           dtype=torch.bfloat16)
    flat = dict(jax.tree_util.tree_leaves_with_path(jp))
    for path, leaf in jax.tree_util.tree_leaves_with_path(tp):
        assert leaf.dtype == torch.bfloat16
        ref = np.asarray(jnp.asarray(flat[path], jnp.bfloat16)
                         .astype(jnp.float32))
        npt.assert_array_equal(leaf.float().numpy(), ref)


def test_decode_state_layout():
    cfg = reduced(ARCHS[ARCH])
    dims = model_dims(cfg)
    spec = DecodeSpec(block_size=8, max_blocks_per_seq=4,
                      slots_per_group=16, n_sets=2, assoc=8)
    st = init_decode_state(cfg, dims, spec, 3, device="cpu",
                           dtype=torch.bfloat16)
    assert st["k_pool"].shape == (cfg.num_layers, 17, 8, dims.n_kv,
                                  dims.head_dim)
    assert st["k_pool"].dtype == torch.bfloat16
    for key in ("cross_k", "cross_v"):
        assert st[key].shape == (cfg.num_layers, 3, cfg.frontend_tokens,
                                 dims.n_kv, dims.head_dim)
        assert st[key].dtype == torch.bfloat16
    assert "ssm" not in st


# ------------------------------------------------------------ the engine

SAMPLED = dict(temperature=0.9, top_k=8, top_p=0.95)
ENGINE = dict(max_batch=3, max_seq_len=128, prefill_budget=32,
              auto_release=True)
# (engine options, extra new tokens a request)
MODES = {
    "prefix_exact": ({}, 0),
    "prefix_paged": ({"prefix_gather": "paged"}, 0),
    "recompute": ({"prefill_mode": "recompute"}, 0),
    "spec": ({"prefix_gather": "paged", "spec_decode": "ngram",
              "num_draft_tokens": 4}, 0),
    "tight_pool": ({"prefix_gather": "paged", "pool_headroom": 0.3}, 16),
    "roomy_pool": ({"prefix_gather": "paged", "max_seq_len": 256}, 16),
}


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(JARCHS[ARCH])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg))
    return (jcfg, jp, reduced(ARCHS[ARCH]),
            params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))


def _requests(api, cfg, extra=0):
    """Five requests with seeded frame embeddings, two sampled, one long enough to
    chunk under the 32-token budget, one repeating a pattern (the
    drafter's), one submitted mid-decode; ``extra`` more new tokens each
    outgrow the tight pool."""
    req_cls, sp_cls = api
    bs = cfg.kv_block_size
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab_size, n * bs) for n in (5, 3, 2, 4)]
    prompts.insert(2, np.tile(np.asarray([11, 23, 42, 7]), 3 * bs // 4))
    return [req_cls(seq_id=i, prompt=p, frontend=rng.randn(
        cfg.frontend_tokens, cfg.d_model).astype(np.float32),
        max_new_tokens=8 + i + extra,
        sampling=(sp_cls(seed=50 + i, **SAMPLED) if i in (1, 4)
                  else sp_cls()))
        for i, p in enumerate(prompts)]


_RUNS = {}


def _run(weights, which, mode):
    key = (which, mode)
    if key not in _RUNS:
        jcfg, jp, cfg, tp = weights
        ekw, extra = MODES[mode]
        kw = dict(ENGINE, **ekw)
        if which == "jax":
            eng = JEngine(jcfg, jp, JConfig(**kw, prefix_cache=None))
            reqs = _requests((JRequest, JSamplingParams), cfg, extra)
        else:
            eng = Engine(cfg, tp, EngineConfig(**kw), device="cpu")
            reqs = _requests((Request, SamplingParams), cfg, extra)
        for r in reqs[:4]:
            eng.submit(r)
        eng.step()
        eng.submit(reqs[4])                     # mid-decode admission
        while eng.has_unfinished():
            eng.step()
            if which == "port":
                eng.check_invariants()
        _RUNS[key] = ({r.seq_id: list(r.generated) for r in reqs}, eng)
    return _RUNS[key]


@pytest.mark.parametrize("mode", ["prefix_exact", "prefix_paged",
                                  "recompute", "spec"])
def test_engine_matches_jax(weights, mode):
    out, eng = _run(weights, "port", mode)
    jout, jeng = _run(weights, "jax", mode)
    assert out == jout
    assert eng.admission_log == jeng.admission_log
    for rec in eng.admission_log:      # the frames hold no KV blocks
        assert rec.fwd_tokens == (rec.end - rec.start
                                  if rec.path == "prefix_kv" else rec.end)
    if mode != "recompute":
        assert any(r.path == "prefix_kv" for r in eng.admission_log)
    assert dict(eng.manager.stats) == dict(jeng.manager.stats)
    assert eng.manager.stats["rsw_hits"] > 0
    st, jst = eng.stats(), jeng.stats()
    keys = ["rsw_hits", "flex_walks", "swap_faults", "preempts"]
    if mode == "spec":
        keys += ["drafted", "accepted"]
        assert st["spec_drafted"] == jst["spec_drafted"] > 0
        assert st["spec_accepted"] == jst["spec_accepted"] > 0
    for sid, row in jst["per_request"].items():
        for key in keys:
            assert st["per_request"][sid][key] == row[key], (sid, key)
    assert not st["prefix_cache"]["enabled"]


@pytest.mark.parametrize("pair", [("spec", "prefix_paged"),
                                  ("prefix_exact", "recompute"),
                                  ("tight_pool", "roomy_pool")])
def test_port_runs_equal(weights, pair):
    """Bitwise port contracts: spec-on = spec-off, prefix-KV = recompute,
    a tight pool that preempts (KV blocks and cross rows) = a roomy one."""
    a, eng = _run(weights, "port", pair[0])
    b, reng = _run(weights, "port", pair[1])
    assert a == b
    if pair[0] == "tight_pool":
        assert eng.hybrid_cfg.total_slots < reng.hybrid_cfg.total_slots
        assert eng.stats()["overload"]["request_preempts"] > 0
        assert reng.stats()["overload"]["request_preempts"] == 0


def test_preempt_swaps_cross_rows(weights):
    """Each preemption saves the slot's cross rows to the host tier (their
    bytes counted in the swap traffic), and each resume writes them back
    bitwise into the request's new slot."""
    _, _, cfg, tp = weights
    ekw, extra = MODES["tight_pool"]
    eng = Engine(cfg, tp, EngineConfig(**ENGINE, **ekw), device="cpu")
    preempt, resume = eng.preempt_request, eng._resume_preempted
    saved, checked = {}, []

    def spy_preempt(sid):
        slot = eng._slot_of[sid]
        rows = {k: eng.dstate[k][:, slot].clone()
                for k in ("cross_k", "cross_v")}
        preempt(sid)
        rec = eng._preempted[sid]
        assert sorted(rec.rows) == ["cross_k", "cross_v"]
        for k, row in rows.items():
            assert torch.equal(rec.rows[k], row)
        saved[sid] = rows

    def spy_resume(req, reserved, busy):
        ok = resume(req, reserved, busy)
        if ok:
            slot = eng._slot_of[req.seq_id]
            for k, row in saved.pop(req.seq_id).items():
                assert torch.equal(eng.dstate[k][:, slot], row)
            checked.append(req.seq_id)
        return ok

    eng.preempt_request, eng._resume_preempted = spy_preempt, spy_resume
    reqs = _requests((Request, SamplingParams), cfg, extra)
    for r in reqs:
        eng.submit(r)
    while eng.has_unfinished():
        eng.step()
    assert checked and not saved
    ov = eng.stats()["overload"]
    row_bytes = 2 * eng.dstate["cross_k"][:, 0].nbytes
    assert ov["swap_bytes_out"] == ov["swap_bytes_in"] >= (
        len(checked) * row_bytes)
    assert {r.seq_id: list(r.generated) for r in reqs} == _run(
        weights, "port", "roomy_pool")[0]


def test_crashed_restored_equals_uncrashed(weights):
    _, _, cfg, tp = weights
    bs = cfg.kv_block_size

    def serve(inj=None):
        eng = Engine(cfg, tp, EngineConfig(
            max_batch=3, max_seq_len=8 * bs, auto_release=True,
            prefill_budget=bs, pool_headroom=0.6, fault_injector=inj),
            device="cpu")
        front = eng if inj is None else ResilientServe(eng, snapshot_every=3)
        rng = np.random.RandomState(5)
        for i in range(4):
            front.submit(Request(
                seq_id=i, prompt=rng.randint(0, cfg.vocab_size, 2 * bs),
                frontend=rng.randn(cfg.frontend_tokens, cfg.d_model),
                max_new_tokens=8,
                sampling=SamplingParams(seed=7 + i, **SAMPLED) if i % 2
                else SamplingParams()))
        outs = {}
        for _ in range(400):
            for ro in front.poll():
                outs.setdefault(ro.seq_id, []).extend(ro.new_token_ids)
            eng.check_invariants()
            if not front.has_unfinished():
                return outs, eng
        raise AssertionError("engine failed to drain")

    ref, _ = serve()
    outs, eng = serve(ServeFaultInjector(crash_at=[(4, "pre"), (9, "post")],
                                         preempt_at=[(6, "pre", "auto")]))
    assert outs == ref
    assert eng.stats()["overload"]["request_preempts"] >= 1


def test_audio_prefix_cache_flaw(weights):
    """Two requests with one 4-block prompt and different audio, served
    one after the other: the JAX engine's "auto" cache attaches 3 of the
    prompt's blocks to the second (its decoder K/V came from the first
    request's audio, and its prefix-KV chunk reads cross rows no chunk
    installed for it) and serves it otherwise than cache-off; the port's
    "auto" is off and serves the cache-off streams."""
    jcfg, jp, cfg, tp = weights
    bs = cfg.kv_block_size
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, cfg.vocab_size, 4 * bs)
    fronts = [rng.randn(cfg.frontend_tokens, cfg.d_model).astype(np.float32)
              for _ in range(2)]
    kw = dict(max_batch=2, max_seq_len=8 * bs)

    def serve(eng, req_cls):
        out = []
        for i, f in enumerate(fronts):
            r = req_cls(seq_id=i, prompt=prompt, frontend=f,
                        max_new_tokens=6)
            eng.submit(r)
            while eng.has_unfinished():
                eng.step()
            out.append(list(r.generated))
        return out, eng

    j_auto, jeng = serve(JEngine(jcfg, jp, JConfig(**kw)), JRequest)
    j_off, _ = serve(JEngine(jcfg, jp, JConfig(**kw, prefix_cache=None)),
                     JRequest)
    pc = jeng.stats()["prefix_cache"]
    assert pc["hits"] == 1 and pc["dedup_blocks"] == 3
    assert (1, 3 * bs, 4 * bs, "prefix_kv") == tuple(
        jeng.admission_log[-1])[:4]
    assert j_auto[0] == j_off[0] and j_auto[1] != j_off[1]
    port, eng = serve(Engine(cfg, tp, EngineConfig(**kw), device="cpu"),
                      Request)
    assert eng.prefix_cache is None and port == j_off
    with pytest.raises(ValueError, match="encoder input"):
        Engine(cfg, tp, EngineConfig(**kw, prefix_cache=True), device="cpu")


def test_frontend_checked(weights):
    _, _, cfg, tp = weights
    eng = Engine(cfg, tp, EngineConfig(), device="cpu")
    prompt = np.zeros(cfg.kv_block_size, np.int64)
    for front in (None, np.zeros((3, cfg.d_model), np.float32)):
        with pytest.raises(ValueError, match="frontend"):
            eng.submit(Request(seq_id=0, prompt=prompt, frontend=front))


# --------------------------------------------------------- on the card

@pytest.mark.gpu
def test_gpu_engine_equals_cpu(weights):
    """On the card, float32: the tight pool's run (the RSW step, the
    paged decode and Q > 1 reads, the cross rows swapped on preemption)
    serves the CPU engine's streams, admission log and translation
    stats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.utopia_rsw.ops import utopia_translate_step
    _, _, cfg, tp = weights
    ekw, extra = MODES["tight_pool"]
    out = {}
    for dev in ("cuda", "cpu"):
        params = jax.tree.map(lambda t: t.to(dev), tp)
        eng = Engine(cfg, params, EngineConfig(**ENGINE, **ekw), device=dev)
        reqs = _requests((Request, SamplingParams), cfg, extra)
        paged_attention.launches = paged_attention.launches_multi_query = 0
        utopia_translate_step.launches = 0
        for r in reqs:
            eng.submit(r)
        while eng.has_unfinished():
            eng.step()
            eng.check_invariants()
        out[dev] = ({r.seq_id: list(r.generated) for r in reqs},
                    eng.admission_log, dict(eng.manager.stats),
                    eng.stats()["overload"])
        if dev == "cuda":
            assert utopia_translate_step.launches > 0
            assert paged_attention.launches_multi_query > 0
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][3]["request_preempts"] > 0
