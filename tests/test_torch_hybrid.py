"""The hybrid family (jamba) of the port against the JAX package's.

* The model: ``forward`` on the reduced jamba-1.5-large-398b (groups of
  one mamba and one attention sublayer, the attention sublayer's FFN a
  top-2 MoE of 8 experts), logits, the groups' K/V and the stacked SSM
  caches: 1e-4 in float32, 3e-2 of the tensor's scale in bfloat16 with
  the near-tie tokens of ``tests/test_torch_families.py`` left out (and
  in bf16 every sublayer fed the JAX forward's input to it, SSM state
  and conv tail included, since every row holds a near-tie token);
  ``init_params`` gives the JAX tree's nested group layout, keys, shapes
  and dtypes, and ``params_from_numpy`` casts it leaving the router and
  ``A_log``/``D``/``dt_bias`` float32.  The decode state holds one pool
  layer a group and one ssm/conv row a mamba sublayer.
* The engine, against the JAX engine with ``prefix_cache=None``: streams,
  admission logs, manager stats and per-request translation rows equal,
  greedy and sampled, recompute and prefix-KV admission, the prefix read
  ``"exact"`` and ``"paged"``, a tight pool that preempts.
* The prefix cache: on two prompts that share a 3-block prefix, the JAX
  engine's default ``"auto"`` serves the second otherwise than with the
  cache off (its recurrent layers continue from the slot's stale rows
  after a hit); the port's ``"auto"`` is off and serves JAX's cache-off
  streams; ``prefix_cache=True`` raises with the reason.
* Port against port, bitwise in float32: pad exactness (the installed
  state of a row padded beside a shorter one, and greedy streams against
  a full re-forward per step), chunked prefix-KV = blocking admission
  state, tight-pool preemption = roomy run, crashed + restored =
  uncrashed.
"""
import warnings

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
from repro_torch.models import (FwdOptions, forward, hybrid_ffn_select,
                                model_dims)
from repro_torch.models.transformer import take
from repro_torch.params import init_params, params_from_numpy
from repro_torch.runtime import ResilientServe, ServeFaultInjector
from repro_torch.serve import (DecodeSpec, Engine, EngineConfig, Request,
                               SamplingParams, init_decode_state)

torch.set_num_threads(2)

ARCH = "jamba-1.5-large-398b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NEAR_TIE = 2e-3        # k-th minus (k+1)-th expert probability


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, dtype, keep=None):
    """``keep`` (B, S) bool selects the tokens compared: axes 0, 1 of the
    logits, the two axes after the leading ``lead`` of a cache."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if keep is not None:
        lead = next(i for i in range(got.ndim)
                    if got.shape[i:i + 2] == keep.shape)
        idx = (slice(None),) * lead + (keep,)
        got, want = got[idx], want[idx]
    tol = (1e-4 if dtype == "float32"
           else 3e-2 * max(1.0, float(np.abs(want).max())))
    npt.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_matches_jax(dtype, monkeypatch):
    jdt, tdt = DTYPES[dtype]
    jcfg, cfg = jreduced(JARCHS[ARCH]), reduced(ARCHS[ARCH])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg), dtype=jdt)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 24))
    sl = np.asarray([24, 13], np.int32)
    jl, jaux, jc = jax.jit(lambda p, b: jforward(
        p, b, jcfg, jdims(jcfg), JFwd(dtype=jdt, collect_cache=True)))(
        jp, {"tokens": jnp.asarray(tokens), "seq_len": jnp.asarray(sl)})
    margins = []
    import repro_torch.models.transformer as tmod
    orig = tmod.moe_layer

    def moe_layer(p, h, **kw):
        k = kw["top_k"]
        probs = torch.softmax(h.float() @ p["router"]["w"], dim=-1)
        top = probs.sort(dim=-1, descending=True).values
        margins.append((top[..., k - 1] - top[..., k]).numpy())
        return orig(p, h, **kw)

    monkeypatch.setattr(tmod, "moe_layer", moe_layer)
    tl, aux, tc = forward(tp, {"tokens": _t(tokens), "seq_len": _t(sl)},
                          cfg, model_dims(cfg),
                          FwdOptions(dtype=tdt, collect_cache=True))
    g = cfg.attn_every
    n_groups = cfg.num_layers // g
    assert len(margins) == n_groups * sum(cfg.moe_on_layer(i)
                                          for i in range(g))
    keep = None
    if dtype == "bfloat16":
        keep = np.min(margins, axis=0) >= NEAR_TIE
        assert (~keep).sum() <= 8, np.min(margins, axis=0)
    assert sorted(tc) == ["k", "ssm", "v"]
    assert tc["k"].shape[0] == n_groups
    assert tuple(tc["ssm"].state.shape[:3]) == (n_groups, g - 1, 2)
    assert tc["ssm"].state.dtype == torch.float32
    for got, want in ((tl, jl), (tc["k"], jc["k"]), (tc["v"], jc["v"])):
        _close(got, want, dtype, keep)
    if dtype == "float32":
        # in bf16 every row holds a near-tie token, on which its state
        # and conv tail depend: test_sublayers_match_jax_bf16 holds them
        _close(tc["ssm"].state, jc["ssm"].state, dtype)
        _close(tc["ssm"].conv, jc["ssm"].conv, dtype)
    for key in jaux:
        npt.assert_allclose(float(aux[key]), float(jaux[key]),
                            rtol=1e-4 if dtype == "float32" else 3e-2,
                            atol=1e-5, err_msg=key)


def test_sublayers_match_jax_bf16():
    """Each sublayer of the bf16 reduced jamba, fed the JAX forward's
    input to it: the mamba sublayers' output, SSM state and conv tail,
    the attention sublayers' output and K/V, and the MLP and MoE FFNs'
    output, within 3e-2 of the tensor's scale."""
    from repro.models import layers as jl
    from repro.models import transformer as jt
    from repro_torch.models import transformer as tt
    jcfg, cfg = jreduced(JARCHS[ARCH]), reduced(ARCHS[ARCH])
    jd_, td = jdims(jcfg), model_dims(cfg)
    jp = jinit(jax.random.PRNGKey(0), jcfg, jd_, dtype=jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 24))
    sl = np.asarray([24, 13], np.int32)
    jopt = JFwd(dtype=jnp.bfloat16)
    topt = FwdOptions(dtype=torch.bfloat16)
    x = jp["embed"]["table"][tokens]
    g = cfg.attn_every
    j_mamba = jax.jit(lambda b, x: jt._mamba_block(
        b, x, jcfg, jd_, jopt, jl.no_pins, collect=True,
        seq_len=jnp.asarray(sl)))
    j_attn = jax.jit(lambda b, x: jt._self_attn(b, x, jcfg, jd_, jopt,
                                                jl.no_pins))
    j_ffn = jax.jit(lambda b, x: jt._ffn(b, x, jcfg, jd_, jopt,
                                         jl.no_pins)[0])

    def bf(a):
        return _t(np.asarray(a, np.float32)).to(torch.bfloat16)

    for gi in range(cfg.num_layers // g):
        jb = jax.tree.map(lambda a: a[gi], jp["layers"])
        tb = tt.layer_params(tp, gi)
        for i in range(g):
            if i < g - 1:
                jy, jst = j_mamba(jax.tree.map(lambda a: a[i], jb["mamba"]),
                                  x)
                ty, tst = tt.mamba_block(take(tb["mamba"], i), bf(x), cfg,
                                         td, collect=True, seq_len=_t(sl))
                _close(tst.state, jst.state, "bfloat16")
                _close(tst.conv, jst.conv, "bfloat16")
            else:
                jy, (jk, jv) = j_attn(jb["attn"], x)
                ty, (tk, tv) = tt._self_attn(tb["attn"], bf(x), cfg, td,
                                             topt)
                _close(tk, jk, "bfloat16")
                _close(tv, jv, "bfloat16")
            _close(ty, jy, "bfloat16")
            x = jy
            jy = j_ffn(jt.hybrid_ffn_select(jcfg, jb, i), x)
            ty, _ = tt._ffn(hybrid_ffn_select(cfg, tb, i), bf(x), cfg, topt)
            _close(ty, jy, "bfloat16")
            x = jy


def _specs(tree, torch_side):
    name = ((lambda l: str(l.dtype).split(".")[-1]) if torch_side
            else (lambda l: l.dtype.name))
    return {jax.tree_util.keystr(p): (tuple(l.shape), name(l))
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("attn_every", [2, 6])
def test_init_params_tree_matches_jax(attn_every):
    """The nested group tree, at the reduced group of 2 (one MLP, one MoE
    sublayer) and at the chip's group of 6 (two MLP, three MoE)."""
    import dataclasses
    jcfg = dataclasses.replace(jreduced(JARCHS[ARCH]), attn_every=attn_every,
                               num_layers=attn_every)
    cfg = dataclasses.replace(reduced(ARCHS[ARCH]), attn_every=attn_every,
                              num_layers=attn_every)
    for jdt, tdt in DTYPES.values():
        want = jax.eval_shape(lambda k: jinit(k, jcfg, jdims(jcfg),
                                              dtype=jdt),
                              jax.random.PRNGKey(0))
        got = init_params(torch.Generator().manual_seed(0), cfg,
                          model_dims(cfg), tdt, "cpu")
        assert _specs(got, True) == _specs(want, False)
        lay = got["layers"]
        assert lay["moe"]["moe"]["router"]["w"].dtype == torch.float32
        assert lay["mamba"]["mamba"]["A_log"].dtype == torch.float32
        # sublayer i's FFN: MoE on the odd ones, group-local counts
        for i in range(attn_every):
            ffn = hybrid_ffn_select(cfg, take(lay, 0), i)
            assert ("moe" in ffn) == cfg.moe_on_layer(i)
            assert ffn["norm2"].shape == (cfg.d_model,)


def test_params_from_numpy_nested_tree():
    jcfg = jreduced(JARCHS[ARCH])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           dtype=torch.bfloat16)
    keep = ("['router']['w']", "['A_log']", "['D']", "['dt_bias']")
    for path, leaf in jax.tree_util.tree_leaves_with_path(tp):
        key = jax.tree_util.keystr(path)
        want = (torch.float32 if key.endswith(keep) else torch.bfloat16)
        assert leaf.dtype == want, key
    flat = dict(jax.tree_util.tree_leaves_with_path(jp))
    for path, leaf in jax.tree_util.tree_leaves_with_path(tp):
        ref = np.asarray(flat[path], np.float32)
        assert tuple(leaf.shape) == ref.shape
        npt.assert_array_equal(leaf.float().numpy(),
                               np.asarray(jnp.asarray(ref, jnp.bfloat16)
                                          .astype(jnp.float32))
                               if leaf.dtype == torch.bfloat16 else ref)


def test_decode_state_layout():
    cfg = reduced(ARCHS[ARCH])
    dims = model_dims(cfg)
    spec = DecodeSpec(block_size=8, max_blocks_per_seq=4,
                      slots_per_group=16, n_sets=2, assoc=8)
    st = init_decode_state(cfg, dims, spec, 3, device="cpu",
                           dtype=torch.bfloat16)
    n_groups = cfg.num_layers // cfg.attn_every
    n_ssm = cfg.num_layers - n_groups
    md = dims.mamba
    assert st["k_pool"].shape == (n_groups, 17, 8, dims.n_kv,
                                  dims.head_dim)
    assert st["ssm"].shape == (n_ssm, 3, md.n_heads, md.head_dim,
                               md.d_state)
    assert st["ssm"].dtype == torch.float32
    assert st["conv"].shape == (n_ssm, 3, md.conv_width - 1,
                                md.conv_channels)
    assert st["conv"].dtype == torch.bfloat16


# ------------------------------------------------------------ the engine

SAMPLED = dict(temperature=0.9, top_k=8, top_p=0.95)
ENGINE = dict(max_batch=3, max_seq_len=96, prefill_budget=32,
              auto_release=True)
# (engine options, extra new tokens a request)
MODES = {
    "prefix_exact": ({}, 0),
    "prefix_paged": ({"prefix_gather": "paged"}, 0),
    "recompute": ({"prefill_mode": "recompute"}, 0),
    "tight_pool": ({"prefix_gather": "paged", "pool_headroom": 0.4}, 16),
    "roomy_pool": ({"prefix_gather": "paged", "max_seq_len": 192}, 16),
}


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(JARCHS[ARCH])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg))
    return (jcfg, jp, reduced(ARCHS[ARCH]),
            params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))


def _requests(api, cfg, extra=0):
    """Five requests, two sampled, one long enough to chunk under the
    32-token budget, one submitted mid-decode; ``extra`` more new tokens
    each outgrow the smallest pool (16 blocks)."""
    req_cls, sp_cls = api
    bs = cfg.kv_block_size
    rng = np.random.RandomState(11)
    lens = (5, 3, 2, 4, 1)
    return [req_cls(seq_id=i, prompt=rng.randint(0, cfg.vocab_size, n * bs),
                    max_new_tokens=8 + i + extra,
                    sampling=(sp_cls(seed=50 + i, **SAMPLED) if i in (1, 4)
                              else sp_cls()))
            for i, n in enumerate(lens)]


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
                                  "recompute"])
def test_engine_matches_jax(weights, mode):
    out, eng = _run(weights, "port", mode)
    jout, jeng = _run(weights, "jax", mode)
    assert out == jout
    assert eng.admission_log == jeng.admission_log
    assert dict(eng.manager.stats) == dict(jeng.manager.stats)
    assert eng.manager.stats["rsw_hits"] > 0
    st, jst = eng.stats(), jeng.stats()
    assert st["overload"] == jst["overload"]
    for sid, row in jst["per_request"].items():
        for key in ("rsw_hits", "flex_walks", "swap_faults", "preempts"):
            assert st["per_request"][sid][key] == row[key], (sid, key)
    assert not st["prefix_cache"]["enabled"]


def test_tight_pool_equals_roomy(weights):
    """Preemption to the host tier (KV blocks and ssm/conv rows) under a
    16-block pool leaves every stream as a roomy pool serves it."""
    tight, eng = _run(weights, "port", "tight_pool")
    roomy, reng = _run(weights, "port", "roomy_pool")
    assert tight == roomy
    assert eng.hybrid_cfg.total_slots < reng.hybrid_cfg.total_slots
    assert eng.stats()["overload"]["request_preempts"] > 0
    assert reng.stats()["overload"]["request_preempts"] == 0


def test_prefix_cache_flaw(weights):
    """Two 4-block prompts sharing a 3-block prefix, served one after the
    other: the JAX engine's "auto" cache attaches the prefix and serves
    the second otherwise than cache-off; the port's "auto" is off."""
    jcfg, jp, cfg, tp = weights
    bs = cfg.kv_block_size
    rng = np.random.RandomState(3)
    shared = rng.randint(0, cfg.vocab_size, 3 * bs)
    prompts = [np.concatenate([shared, rng.randint(0, cfg.vocab_size, bs)])
               for _ in range(2)]
    kw = dict(max_batch=2, max_seq_len=8 * bs)

    def serve(eng, req_cls):
        out = []
        for i, p in enumerate(prompts):
            r = req_cls(seq_id=i, prompt=p, max_new_tokens=6)
            eng.submit(r)
            while eng.has_unfinished():
                eng.step()
            out.append(list(r.generated))
        return out, eng.stats()["prefix_cache"]

    j_auto, j_pc = serve(JEngine(jcfg, jp, JConfig(**kw)), JRequest)
    j_off, _ = serve(JEngine(jcfg, jp, JConfig(**kw, prefix_cache=None)),
                     JRequest)
    assert j_pc["hits"] == 1 and j_pc["dedup_blocks"] == 3
    assert j_auto[0] == j_off[0] and j_auto[1] != j_off[1]
    port, pc = serve(Engine(cfg, tp, EngineConfig(**kw), device="cpu"),
                     Request)
    assert not pc["enabled"] and port == j_off
    with pytest.raises(ValueError, match="recurrent layers' state"):
        Engine(cfg, tp, EngineConfig(**kw, prefix_cache=True), device="cpu")


def test_pad_tail_is_exact(weights):
    """A 7-block prompt padded to the 8-block bucket beside a 5-block row
    installs, bitwise, an exact-length forward's SSM state, conv tail
    and K/V; its greedy stream is a full re-forward per step's."""
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
    n = cfg.num_layers - cfg.num_layers // cfg.attn_every
    for name, want in (("ssm", c["ssm"].state), ("conv", c["ssm"].conv)):
        want = want.reshape(n, 1, *want.shape[3:])[:, 0]
        assert torch.equal(eng.dstate[name][:, 0], want), name
    m = eng.manager
    slots = [m.lookup(0, b)[0] for b in range(7)]
    k = eng.dstate["k_pool"][:, slots].reshape(c["k"].shape[0], 7 * bs,
                                               *c["k"].shape[3:])
    assert torch.equal(k, c["k"][:, 0])
    while eng.has_unfinished():
        eng.step()
    toks, ref = list(prompt), []
    for _ in range(4):
        logits, _, _ = forward(tp, {"tokens": torch.tensor([toks])}, cfg,
                               dims)
        ref.append(int(logits[0, -1].argmax()))
        toks.append(ref[-1])
    assert list(r.generated) == ref


def test_chunked_state_equals_blocking(weights):
    _, _, cfg, tp = weights
    bs = cfg.kv_block_size
    prompt = np.random.RandomState(8).randint(0, cfg.vocab_size, 6 * bs)
    got = {}
    for name, kw in (("chunked", dict(prefill_budget=2 * bs)),
                     ("recompute", dict(prefill_budget=2 * bs,
                                        prefill_mode="recompute")),
                     ("blocking", {})):
        eng = Engine(cfg, tp, EngineConfig(max_batch=2, max_seq_len=12 * bs,
                                           **kw), device="cpu")
        r = Request(seq_id=0, prompt=prompt, max_new_tokens=3)
        eng.submit(r)
        while eng.waiting or eng._prefilling:
            eng.step()
        st = {k: eng.dstate[k][:, 0].clone() for k in ("ssm", "conv")}
        while eng.has_unfinished():
            eng.step()
        got[name] = (st, [c.path for c in eng.admission_log],
                     list(r.generated))
    assert got["chunked"][1] == ["recompute", "prefix_kv", "prefix_kv"]
    for name in ("recompute", "blocking"):
        for k in ("ssm", "conv"):
            assert torch.equal(got["chunked"][0][k], got[name][0][k]), \
                (name, k)
        assert got["chunked"][2] == got[name][2]


def test_crashed_restored_equals_uncrashed(weights):
    _, _, cfg, tp = weights
    bs = cfg.kv_block_size

    def serve(inj=None):
        eng = Engine(cfg, tp, EngineConfig(
            max_batch=3, max_seq_len=8 * bs, auto_release=True,
            prefill_budget=bs, pool_headroom=0.5, fault_injector=inj),
            device="cpu")
        front = eng if inj is None else ResilientServe(eng, snapshot_every=3)
        rng = np.random.RandomState(5)
        for i in range(4):
            front.submit(Request(
                seq_id=i, prompt=rng.randint(0, cfg.vocab_size, 2 * bs),
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


def test_spec_fallback_warns_once(weights, monkeypatch):
    import repro_torch.serve.engine as engine_mod
    _, _, cfg, tp = weights
    monkeypatch.setattr(engine_mod, "_SPEC_FALLBACK_WARNED", False)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng = Engine(cfg, tp, EngineConfig(spec_decode="ngram"),
                     device="cpu")
    assert [str(x.message).count("'hybrid'") for x in w] == [1]
    assert eng.spec_K == 0 and "hist" not in eng.dstate
    from repro_torch.serve.spec_decode import make_spec_decode_step
    with pytest.raises(ValueError, match="recurrent state rollback"):
        make_spec_decode_step(cfg, model_dims(cfg), eng.spec, 4)


# --------------------------------------------------------- on the card

@pytest.mark.gpu
def test_gpu_engine_equals_cpu(weights):
    """On the card, float32: the reduced jamba on a tight pool (the RSW
    step, the paged decode and Q > 1 reads, preemption) serves the CPU
    engine's streams, admission log and translation stats, and every
    kernel on the path launched."""
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
