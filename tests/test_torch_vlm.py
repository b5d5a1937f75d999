"""The vlm family (paligemma) of the port against the JAX package's.

* The model: ``forward`` on the reduced paligemma-3b with a frontend (8
  patch embeddings, one KV block, prepended to the tokens and sliced off
  before the head), logits and the K/V of frontend + prompt: 1e-4 in
  float32, 3e-2 of the tensor's scale in bfloat16; ``init_params`` gives
  the JAX tree (``frontend_proj`` included), ``params_from_numpy`` casts
  it; the decode state has no cross rows.
* The engine, against the JAX engine: streams, admission logs (chunk 0's
  ``fwd_tokens`` count the frontend), manager stats and per-request
  translation rows equal, greedy and sampled, for recompute and prefix-KV
  admission with the prefix read ``"exact"`` and ``"paged"`` and for
  speculative decoding; the prefix cache is off for vlm with the JAX
  engine's reason.
* Port against port, bitwise in float32: spec-on = spec-off, prefix-KV =
  recompute, a tight pool that preempts = a roomy one, crashed + restored
  = uncrashed.
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

ARCH = "paligemma-3b"
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
    assert tl.dtype == tdt and tuple(tl.shape) == (2, 24, jl.shape[-1])
    assert sorted(tc) == ["k", "v"]
    assert tc["k"].shape[2] == cfg.frontend_tokens + 24
    for got, want in ((tl, jl), (tc["k"], jc["k"]), (tc["v"], jc["v"])):
        _close(got, want, dtype)
    assert all(float(a) == 0.0 for a in aux.values())


def test_init_params_tree_matches_jax():
    jcfg, cfg = jreduced(JARCHS[ARCH]), reduced(ARCHS[ARCH])
    for jdt, tdt in DTYPES.values():
        want = jax.eval_shape(lambda k: jinit(k, jcfg, jdims(jcfg),
                                              dtype=jdt),
                              jax.random.PRNGKey(0))
        got = init_params(torch.Generator().manual_seed(0), cfg,
                          model_dims(cfg), tdt, "cpu")
        assert _specs(got, True) == _specs(want, False)
        assert "frontend_proj" in got and "lm_head" not in got
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
    assert "cross_k" not in st and "ssm" not in st


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
    """Five requests with seeded frontends, two sampled, one long enough to
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
    front = eng.cfg.frontend_tokens
    for rec in eng.admission_log:
        assert rec.fwd_tokens == (rec.end - rec.start
                                  if rec.path == "prefix_kv"
                                  else front + rec.end)
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
    a tight pool that preempts (frontend blocks and all) = a roomy one."""
    a, eng = _run(weights, "port", pair[0])
    b, reng = _run(weights, "port", pair[1])
    assert a == b
    if pair[0] == "tight_pool":
        assert eng.hybrid_cfg.total_slots < reng.hybrid_cfg.total_slots
        assert eng.stats()["overload"]["request_preempts"] > 0
        assert reng.stats()["overload"]["request_preempts"] == 0


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


def test_prefix_cache_refused_and_frontend_checked(weights):
    _, _, cfg, tp = weights
    eng = Engine(cfg, tp, EngineConfig(), device="cpu")
    assert eng.prefix_cache is None
    assert "vlm frontend KV blocks" in eng._prefix_cache_unsupported()
    with pytest.raises(ValueError, match="vlm frontend KV blocks"):
        Engine(cfg, tp, EngineConfig(prefix_cache=True), device="cpu")
    prompt = np.zeros(cfg.kv_block_size, np.int64)
    for front in (None, np.zeros((3, cfg.d_model), np.float32)):
        with pytest.raises(ValueError, match="frontend"):
            eng.submit(Request(seq_id=0, prompt=prompt, frontend=front))


# --------------------------------------------------------- on the card

@pytest.mark.gpu
def test_gpu_engine_equals_cpu(weights):
    """On the card, float32: the tight pool's run (the RSW step, the
    paged decode and Q > 1 reads at 4/1 heads, preemption) serves the CPU
    engine's streams, admission log and translation stats."""
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
