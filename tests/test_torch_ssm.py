"""The port's SSM layer (``models/ssm.py``) and the ssm family (mamba2)
against the JAX package's.

* Functions, float32 on the same numpy inputs (2e-5 of the tensor's
  scale): ``ssd_chunked`` with and without an initial state,
  ``mamba_forward`` with a ``seq_len`` mask, an initial state and conv
  tail, its returned conv tail, ``mamba_decode_step`` and
  ``gated_rms_norm`` (bf16 too, 3e-2).  ``_segsum`` is -inf above the
  diagonal and its exp exactly 0 there.
* The model: ``forward`` on the reduced mamba2-130m, logits and the
  collected SSM caches (1e-4 in float32, 3e-2 of the scale in bf16);
  ``init_params`` gives the JAX tree's keys, shapes and dtypes, with
  ``A_log``, ``D`` and ``dt_bias`` float32 under a bf16 model, and
  ``params_from_numpy`` keeps them float32.
* The engine: streams and admission logs equal to the JAX engine's,
  greedy and sampled, on the recompute and the prefix-KV admission paths
  (the JAX engine with ``prefix_cache=None``, which its ``"auto"`` means
  for an attention-free family); no KV pool and no translation tables.
* Port against port, bitwise in float32: the state installed for a row
  padded in a pow2 bucket beside a shorter row equals an exact-length
  forward's, and the greedy stream a full re-forward per step; chunked
  prefix-KV admission installs the recompute path's state; forced
  preemptions (the host tier carries the ssm/conv rows only) and crashes
  restored by ``ResilientServe`` leave the streams unchanged; and
  ``spec_decode="ngram"`` warns once and decodes spec-off's streams.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import init_params as jinit, model_dims as jdims
from repro.models import FwdOptions as JFwd, forward as jforward
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.serve import Engine as JEngine, EngineConfig as JConfig
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import FwdOptions, forward, layers, model_dims
from repro_torch.models import ssm
from repro_torch.params import init_params, params_from_numpy
from repro_torch.runtime import ResilientServe, ServeFaultInjector
from repro_torch.serve import Engine, EngineConfig, Request, SamplingParams

torch.set_num_threads(2)

ARCH = "mamba2-130m"
DIMS = ssm.mamba_dims(32, 16, 8, 2, 4)      # d 32, 8 heads of 8, N 16


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    """Within ``tol`` of the reference tensor's own scale."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = tol * max(1.0, float(np.abs(want).max()))
    npt.assert_allclose(got, want, rtol=scale, atol=scale)


def _ssd_inputs(seed, b=2, l=24, h=3, p=4, n=5):
    rng = np.random.RandomState(seed)
    f = np.float32
    return (rng.randn(b, l, h, p).astype(f),
            -np.abs(rng.randn(b, l, h)).astype(f) * 0.3,
            rng.randn(b, l, n).astype(f), rng.randn(b, l, n).astype(f),
            rng.randn(b, h, p, n).astype(f))


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(with_state):
    xd, dta, B_, C_, s0 = _ssd_inputs(0)
    init = s0 if with_state else None
    jy, js = jax.jit(jssm.ssd_chunked, static_argnames="chunk")(
        jnp.asarray(xd), jnp.asarray(dta), jnp.asarray(B_), jnp.asarray(C_),
        chunk=8, initial_state=None if init is None else jnp.asarray(init))
    y, s = ssm.ssd_chunked(_t(xd), _t(dta), _t(B_), _t(C_), chunk=8,
                           initial_state=None if init is None
                           else _t(init))
    _close(y, jy, 2e-5)
    _close(s, js, 2e-5)
    with pytest.raises(ValueError, match="must divide chunk"):
        ssm.ssd_chunked(_t(xd)[:, :20], _t(dta)[:, :20], _t(B_)[:, :20],
                        _t(C_)[:, :20], chunk=8)


def test_segsum_masks_before_exp():
    x = torch.tensor([[-1e30, 0.5, -2.0, 3.0]])
    ss = ssm._segsum(x)
    upper = ~torch.ones(4, 4, dtype=torch.bool).tril()
    assert bool(torch.isneginf(ss[0][upper]).all())
    e = torch.exp(ss)
    assert not bool(e.isnan().any())
    assert bool((e[0][upper] == 0).all())


def _jax_block(seed, dtype=jnp.float32):
    p = jssm.init_mamba(jax.random.PRNGKey(seed), DIMS, dtype)
    rng = np.random.RandomState(seed)
    # nonzero conv bias and dt bias, so both enter the comparison
    p = dict(p, conv_b=jnp.asarray(0.1 * rng.randn(DIMS.conv_channels),
                                   dtype),
             dt_bias=jnp.asarray(0.5 * rng.randn(DIMS.n_heads),
                                 jnp.float32))
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


CASES = {"plain": {}, "seq_len": {"seq_len": True},
         "continued": {"seq_len": True, "initial": True}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mamba_forward_matches_jax(case):
    """``seq_len`` masks a padded row (12 of 20, not a chunk multiple);
    ``continued`` starts from a saved state and conv tail; the returned
    conv tail is gathered at each row's real end."""
    kw = CASES[case]
    jp, tp = _jax_block(1)
    rng = np.random.RandomState(2)
    B, L = 2, 24 if not kw else 20
    x = rng.randn(B, L, DIMS.d_model).astype(np.float32)
    jk, tk = {}, {}
    if kw.get("seq_len"):
        sl = np.asarray([L, 12], np.int32)
        jk["seq_len"], tk["seq_len"] = jnp.asarray(sl), _t(sl)
    if kw.get("initial"):
        st = rng.randn(B, DIMS.n_heads, DIMS.head_dim,
                       DIMS.d_state).astype(np.float32)
        cv = rng.randn(B, DIMS.conv_width - 1,
                       DIMS.conv_channels).astype(np.float32)
        jk.update(initial_state=jnp.asarray(st), initial_conv=jnp.asarray(cv))
        tk.update(initial_state=_t(st), initial_conv=_t(cv))
    jout, jc = jax.jit(lambda p, x, kw: jssm.mamba_forward(
        p, x, DIMS, chunk=8, return_state=True, **kw))(jp, jnp.asarray(x), jk)
    out, c = ssm.mamba_forward(tp, _t(x), DIMS, chunk=8, return_state=True,
                               **tk)
    _close(out, jout, 2e-5)
    _close(c.state, jc.state, 2e-5)
    _close(c.conv, jc.conv, 2e-5)
    if "seq_len" in kw:
        # the tail of the masked row ends at its real length
        full, _ = ssm.mamba_forward(tp, _t(x[1:, :12]), DIMS, chunk=8,
                                    **{k: v[1:] for k, v in tk.items()
                                       if k != "seq_len"})
        _close(out[1:, :12], full.numpy(), 2e-5)


def test_mamba_decode_step_matches_jax():
    jp, tp = _jax_block(3)
    rng = np.random.RandomState(4)
    B = 3
    x = rng.randn(B, DIMS.d_model).astype(np.float32)
    st = rng.randn(B, DIMS.n_heads, DIMS.head_dim,
                   DIMS.d_state).astype(np.float32)
    cv = rng.randn(B, DIMS.conv_width - 1,
                   DIMS.conv_channels).astype(np.float32)
    jout, jc = jax.jit(lambda p, x, c: jssm.mamba_decode_step(
        p, x, c, DIMS))(jp, jnp.asarray(x), jssm.MambaCache(
            conv=jnp.asarray(cv), state=jnp.asarray(st)))
    out, c = ssm.mamba_decode_step(tp, _t(x),
                                   ssm.MambaCache(conv=_t(cv), state=_t(st)),
                                   DIMS)
    _close(out, jout, 2e-5)
    _close(c.state, jc.state, 2e-5)
    _close(c.conv, jc.conv, 2e-5)
    assert c.state.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_rms_norm_matches_jax(dtype):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.RandomState(5)
    y, z = (rng.randn(4, 6, 48).astype(np.float32) for _ in range(2))
    scale = (1 + 0.1 * rng.randn(48)).astype(np.float32)
    want = jlayers.gated_rms_norm(jnp.asarray(y, jdt), jnp.asarray(z, jdt),
                                  jnp.asarray(scale))
    got = layers.gated_rms_norm(_t(y).to(tdt), _t(z).to(tdt), _t(scale))
    assert got.dtype == tdt
    _close(got, want, 2e-5 if dtype == "float32" else 3e-2)


# ------------------------------------------------------------- the model

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg, cfg = jreduced(JARCHS[ARCH]), reduced(ARCHS[ARCH])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg), dtype=jdt)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 24))
    sl = np.asarray([24, 13], np.int32)
    jl, _, jc = jax.jit(lambda p, b: jforward(
        p, b, jcfg, jdims(jcfg), JFwd(dtype=jdt, collect_cache=True)))(
        jp, {"tokens": jnp.asarray(tokens), "seq_len": jnp.asarray(sl)})
    tl, aux, tc = forward(tp, {"tokens": _t(tokens), "seq_len": _t(sl)},
                          cfg, model_dims(cfg),
                          FwdOptions(dtype=tdt, collect_cache=True))
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert tl.dtype == tdt and sorted(tc) == ["ssm"]
    _close(tl, jl, tol)
    _close(tc["ssm"].state, jc["ssm"].state, tol)
    _close(tc["ssm"].conv, jc["ssm"].conv, tol)
    assert tc["ssm"].state.dtype == torch.float32
    assert all(float(v) == 0.0 for v in aux.values())


def _leaf_specs(tree, torch_side):
    if torch_side:
        return {jax.tree_util.keystr(p): (tuple(l.shape),
                                          str(l.dtype).split(".")[-1])
                for p, l in jax.tree_util.tree_leaves_with_path(tree)}
    return {jax.tree_util.keystr(p): (tuple(l.shape), l.dtype.name)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


def test_init_params_tree_matches_jax():
    jcfg, cfg = jreduced(JARCHS[ARCH]), reduced(ARCHS[ARCH])
    for jdt, tdt in DTYPES.values():
        want = jax.eval_shape(lambda k: jinit(k, jcfg, jdims(jcfg),
                                              dtype=jdt),
                              jax.random.PRNGKey(0))
        got = init_params(torch.Generator().manual_seed(0), cfg,
                          model_dims(cfg), tdt, "cpu")
        assert _leaf_specs(got, True) == _leaf_specs(want, False)
        m = got["layers"]["mamba"]
        for k in ("A_log", "D", "dt_bias"):
            assert m[k].dtype == torch.float32
        npt.assert_allclose(m["A_log"][0].exp().numpy(),
                            np.linspace(1.0, 16.0, m["A_log"].shape[1]),
                            rtol=1e-6)
        std = float(m["in_x"].float().std())
        assert abs(std * cfg.d_model ** 0.5 - 1.0) < 0.1


def test_params_from_numpy_keeps_ssm_scalars_float32():
    jcfg = jreduced(JARCHS[ARCH])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           dtype=torch.bfloat16)
    m = tp["layers"]["mamba"]
    for k, v in m.items():
        want = torch.float32 if k in ("A_log", "D", "dt_bias") \
            else torch.bfloat16
        assert v.dtype == want, k
    npt.assert_array_equal(m["A_log"].numpy(),
                           np.asarray(jp["layers"]["mamba"]["A_log"]))


# ------------------------------------------------------------ the engine

SAMPLED = dict(temperature=0.9, top_k=8, top_p=0.95)
ENGINE = dict(max_batch=3, max_seq_len=96, prefill_budget=32,
              auto_release=True)


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(JARCHS[ARCH])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg))
    return (jcfg, jp, reduced(ARCHS[ARCH]),
            params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))


def _requests(api, cfg):
    """Five requests, two sampled, one long enough to chunk under the
    32-token budget, one submitted mid-decode."""
    req_cls, sp_cls = api
    bs = cfg.kv_block_size
    rng = np.random.RandomState(11)
    lens = (5, 3, 2, 4, 1)
    return [req_cls(seq_id=i, prompt=rng.randint(0, cfg.vocab_size, n * bs),
                    max_new_tokens=8 + i,
                    sampling=(sp_cls(seed=50 + i, **SAMPLED) if i in (1, 4)
                              else sp_cls()))
            for i, n in enumerate(lens)]


_RUNS = {}


def _run(weights, which, mode):
    """One engine run a (side, prefill mode), cached for the module."""
    key = (which, mode)
    if key not in _RUNS:
        jcfg, jp, cfg, tp = weights
        kw = dict(ENGINE, prefill_mode=mode)
        if which == "jax":
            eng = JEngine(jcfg, jp, JConfig(**kw, prefix_cache=None))
            reqs = _requests((JRequest, JSamplingParams), cfg)
        else:
            eng = Engine(cfg, tp, EngineConfig(**kw), device="cpu")
            reqs = _requests((Request, SamplingParams), cfg)
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


@pytest.mark.parametrize("mode", ["prefix_kv", "recompute"])
def test_engine_matches_jax(weights, mode):
    out, eng = _run(weights, "port", mode)
    jout, jeng = _run(weights, "jax", mode)
    assert out == jout
    assert eng.admission_log == jeng.admission_log
    paths = {r.path for r in eng.admission_log}
    assert paths == ({"recompute", "prefix_kv"} if mode == "prefix_kv"
                     else {"recompute"})
    assert dict(eng.manager.stats) == dict(jeng.manager.stats)
    for key in ("k_pool", "v_pool", "tar", "sf", "flex"):
        assert key not in eng.dstate
    cfg = weights[2]
    assert tuple(eng.dstate["ssm"].shape[:2]) == (cfg.num_layers, 3)
    st = eng.stats()["prefix_cache"]
    assert not st["enabled"] and st["bytes_saved"] == 0
    with pytest.raises(ValueError, match="no attention KV blocks"):
        Engine(cfg, weights[3], EngineConfig(prefix_cache=True),
               device="cpu")


def test_pad_tail_is_exact(weights):
    """A 7-block prompt padded to the 8-block bucket beside a 5-block row
    installs, bitwise, the state and conv tail of an exact-length
    forward; its greedy stream is a full re-forward per step's."""
    _, _, cfg, tp = weights
    dims = model_dims(cfg)
    bs = cfg.kv_block_size
    rng = np.random.RandomState(5)
    prompt = rng.randint(0, cfg.vocab_size, 7 * bs)
    short = rng.randint(0, cfg.vocab_size, 5 * bs)
    eng = Engine(cfg, tp, EngineConfig(max_batch=2, max_seq_len=12 * bs,
                                       prefill_budget=12 * bs),
                 device="cpu")
    r = Request(seq_id=0, prompt=prompt, max_new_tokens=4)
    eng.submit(r)
    eng.submit(Request(seq_id=1, prompt=short, max_new_tokens=1))
    eng.step()
    assert [c.end for c in eng.admission_log] == [7 * bs, 5 * bs]
    _, _, c = forward(tp, {"tokens": _t(prompt)[None]}, cfg, dims,
                      FwdOptions(collect_cache=True))
    assert torch.equal(eng.dstate["ssm"][:, 0], c["ssm"].state[:, 0])
    assert torch.equal(eng.dstate["conv"][:, 0], c["ssm"].conv[:, 0])
    while eng.has_unfinished():
        eng.step()
    toks, ref = list(prompt), []
    for _ in range(4):
        logits, _, _ = forward(tp, {"tokens": torch.tensor([toks])}, cfg,
                               dims)
        ref.append(int(logits[0, -1].argmax()))
        toks.append(ref[-1])
    assert list(r.generated) == ref


def _admitted_state(cfg, tp, prompt, **ekw):
    eng = Engine(cfg, tp, EngineConfig(max_batch=2, max_seq_len=12 * len(
        prompt) // 6, **ekw), device="cpu")
    r = Request(seq_id=0, prompt=prompt, max_new_tokens=3)
    eng.submit(r)
    while eng.waiting or eng._prefilling:
        eng.step()
    state = {k: eng.dstate[k][:, 0].clone() for k in ("ssm", "conv")}
    while eng.has_unfinished():
        eng.step()
    return state, [c.path for c in eng.admission_log], list(r.generated)


def test_chunked_state_equals_blocking(weights):
    """A 6-block prompt admitted in 2-block prefix-KV chunks installs
    bitwise the recompute path's and a blocking admission's state."""
    _, _, cfg, tp = weights
    bs = cfg.kv_block_size
    prompt = np.random.RandomState(8).randint(0, cfg.vocab_size, 6 * bs)
    a, pa, ta = _admitted_state(cfg, tp, prompt, prefill_budget=2 * bs)
    b, pb, tb = _admitted_state(cfg, tp, prompt, prefill_budget=2 * bs,
                                prefill_mode="recompute")
    c, pc, tc = _admitted_state(cfg, tp, prompt)
    assert pa == ["recompute", "prefix_kv", "prefix_kv"]
    assert pb == ["recompute"] * 3 and pc == ["recompute"]
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k]), k
    assert ta == tb == tc


def _serve(cfg, tp, inj=None, supervised=False, n=4):
    eng = Engine(cfg, tp, EngineConfig(
        max_batch=4, max_seq_len=8 * cfg.kv_block_size, auto_release=True,
        prefill_budget=cfg.kv_block_size, fault_injector=inj),
        device="cpu")
    front = ResilientServe(eng, snapshot_every=3) if supervised else eng
    rng = np.random.RandomState(5)
    for i in range(n):
        front.submit(Request(
            seq_id=i, prompt=rng.randint(0, cfg.vocab_size,
                                         (1 + i % 2) * cfg.kv_block_size),
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


def test_preempted_equals_clean(weights):
    """Forced preemptions ("pre" of a request between its prompt's
    chunks, "post" and "pre" of the policy's victim): the host tier
    carries the ssm/conv rows only, and the streams are the clean
    run's."""
    _, _, cfg, tp = weights
    clean, _ = _serve(cfg, tp)
    inj = ServeFaultInjector(preempt_at=[(2, "pre", 1), (4, "post", "auto"),
                                         (7, "pre", "auto")])
    chaos, eng = _serve(cfg, tp, inj)
    assert chaos == clean
    ov = eng.stats()["overload"]
    n = ov["request_preempts"]
    assert n >= 2 and ov["request_resumes"] == n
    md = model_dims(cfg).mamba
    row = cfg.num_layers * (md.n_heads * md.head_dim * md.d_state
                            + (md.conv_width - 1) * md.conv_channels) * 4
    assert ov["swap_bytes_out"] == ov["swap_bytes_in"] == n * row


def test_crashed_restored_equals_uncrashed(weights):
    _, _, cfg, tp = weights
    ref, _ = _serve(cfg, tp)
    inj = ServeFaultInjector(crash_at=[(4, "pre"), (7, "post")])
    outs, eng = _serve(cfg, tp, inj, supervised=True)
    assert outs == ref


def test_spec_fallback_warns_once(weights, monkeypatch):
    import repro_torch.serve.engine as engine_mod
    _, _, cfg, tp = weights
    monkeypatch.setattr(engine_mod, "_SPEC_FALLBACK_WARNED", False)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        engs = [Engine(cfg, tp, EngineConfig(
            max_batch=1, max_seq_len=8 * cfg.kv_block_size,
            spec_decode="ngram"), device="cpu") for _ in range(2)]
    spec = [x for x in w if "speculative" in str(x.message).lower()]
    assert len(spec) == 1 and "'ssm'" in str(spec[0].message)
    assert all(e.spec_K == 0 and "hist" not in e.dstate for e in engs)
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                              cfg.kv_block_size)
    streams = []
    for eng in (engs[0], Engine(cfg, tp, EngineConfig(
            max_batch=1, max_seq_len=8 * cfg.kv_block_size),
            device="cpu")):
        r = Request(seq_id=0, prompt=prompt, max_new_tokens=6)
        eng.submit(r)
        while eng.has_unfinished():
            eng.step()
        streams.append(list(r.generated))
    assert streams[0] == streams[1]


def test_dt_projection_is_row_invariant():
    """The prefill's dt projection gives a row the same bits at any
    number of rows around it, also where BLAS splits a narrow product's
    reduction by the row count (8 threads); it equals the plain product
    within float32 rounding."""
    rng = np.random.RandomState(9)
    x = _t(rng.randn(2, 512, 1024).astype(np.float32))
    w = _t(rng.randn(1024, 32).astype(np.float32) / 32)
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        full = ssm._dt_proj(x, w)
        part = ssm._dt_proj(x[:1, :448].contiguous(), w)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(full[:1, :448], part)
    _close(full, (x.double() @ w.double()).numpy(), 2e-5)


@pytest.mark.gpu
def test_gpu_engine_equals_cpu(weights):
    """On the card, float32: the reduced mamba2 serves the CPU engine's
    streams and admission log, through forced preemptions, and launches
    no CUDA kernel (an attention-free model translates nothing)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.utopia_rsw.ops import utopia_translate_step
    _, _, cfg, tp = weights
    paged_attention.launches = utopia_translate_step.launches = 0
    out = {}
    for dev in ("cuda", "cpu"):
        params = jax.tree.map(lambda t: t.to(dev), tp)
        inj = ServeFaultInjector(preempt_at=[(2, "pre", 1),
                                             (4, "post", "auto")])
        eng = Engine(cfg, params, EngineConfig(
            **ENGINE, fault_injector=inj), device=dev)
        reqs = _requests((Request, SamplingParams), cfg)
        for r in reqs:
            eng.submit(r)
        while eng.has_unfinished():
            eng.step()
        out[dev] = ({r.seq_id: list(r.generated) for r in reqs},
                    eng.admission_log, eng.stats()["overload"])
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][2]["request_preempts"] > 0
    assert paged_attention.launches == utopia_translate_step.launches == 0
