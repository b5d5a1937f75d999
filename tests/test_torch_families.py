"""The port's model families and configs against the JAX package's.

* Forward parity: ``forward`` logits, aux and K/V caches equal JAX's (the
  same weights, ``params_from_numpy`` of the JAX pytree) for the reduced
  qwen3-moe-30b-a3b (top-2 of 8 experts) and llama4-scout-17b-a16e
  (top-1), for the reduced qwen2.5-14b and qwen2-72b with nonzero qkv
  biases drawn on both sides (JAX initialises them to zero), and for
  granite-3-8b at its own vocab of 49155, which pads to 49280 (the pad
  mask at a vocab that is not a multiple of 128).  Tolerances as in
  ``tests/test_torch_model.py``: 1e-4 in float32; in bfloat16 3e-2 of
  the tensor's own scale.  In bfloat16 the two frameworks' router inputs
  differ by bf16 ulps (XLA keeps float32 inside its fusions), so a token
  whose k-th and (k+1)-th expert probabilities lie within ``NEAR_TIE``
  in some layer may take another expert: such near-tie tokens (at most
  8 of 48) are left out of the bf16 comparison, as the repo's stream
  comparisons leave out top-2 logit near-ties.
* Weights: ``init_params`` gives the JAX tree's keys, shapes and dtypes
  for every config of the port, the MoE router float32 under a bf16
  model.
* Engine streams: the port's ``Engine`` against the JAX ``Engine`` for the
  reduced qwen3-moe-30b-a3b on the default admission path (prefix-KV
  chunked prefill, the prefix cache, preemption), greedy and sampled:
  streams, admission logs, manager stats and ``stats()`` rows equal;
  again at the published capacity factor 1.25, where the padded prefill
  buckets' pad rows take expert capacity; speculative decoding (K = 4)
  against JAX spec-on, and the port's spec-on equal to its spec-off.
* Refusals: the verify step of the recurrent families, meshes (ROADMAP
  P15) and unknown families.  Every family of the JAX package runs (ssm,
  hybrid, vlm and audio: ``tests/test_torch_ssm.py``,
  ``tests/test_torch_hybrid.py``, ``tests/test_torch_vlm.py`` and
  ``tests/test_torch_audio.py``).
"""
import dataclasses

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
from repro_torch.serve import Engine, EngineConfig, Request, SamplingParams

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NEW_ARCHS = ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e", "qwen2.5-14b",
             "qwen2-72b", "granite-3-8b"]


def _cfgs(arch):
    jcfg, cfg = jreduced(JARCHS[arch]), reduced(ARCHS[arch])
    if arch == "granite-3-8b":
        jcfg = dataclasses.replace(jcfg, vocab_size=49155)
        cfg = dataclasses.replace(cfg, vocab_size=49155)
    return jcfg, cfg


def _jax_params(arch, jdt):
    jcfg, cfg = _cfgs(arch)
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg), dtype=jdt)
    if jcfg.qkv_bias:
        rng = np.random.RandomState(3)
        attn = dict(jp["layers"]["attn"])
        for name in "qkv":
            b = attn[name]["b"]
            assert not np.asarray(b).any()         # JAX draws zeros
            attn[name] = dict(attn[name], b=jnp.asarray(
                0.5 * rng.randn(*b.shape), jdt))
        jp["layers"] = dict(jp["layers"], attn=attn)
    return jcfg, cfg, jp


NEAR_TIE = 2e-3        # k-th minus (k+1)-th expert probability


def _close(got, want, dtype, keep=None):
    """``keep`` (B, S) bool selects the tokens compared (axes 0, 1 of the
    logits, 1, 2 of the (L, B, S, ...) caches)."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if keep is not None:
        lead = got.shape[:2] == keep.shape
        got = got[keep] if lead else got[:, keep]
        want = want[keep] if lead else want[:, keep]
    tol = (1e-4 if dtype == "float32"
           else 3e-2 * max(1.0, float(np.abs(want).max())))
    npt.assert_allclose(got, want, rtol=tol, atol=tol)


def _router_margins(monkeypatch, rec):
    """Record, for every MoE layer of the port's forward, each token's
    k-th minus (k+1)-th expert probability, shaped (B, S)."""
    import repro_torch.models.transformer as tmod
    orig = tmod.moe_layer

    def moe_layer(p, h, **kw):
        k = kw["top_k"]
        probs = torch.softmax(h.float() @ p["router"]["w"], dim=-1)
        top = probs.sort(dim=-1, descending=True).values
        rec.append((top[..., k - 1] - top[..., k]).numpy())
        return orig(p, h, **kw)

    monkeypatch.setattr(tmod, "moe_layer", moe_layer)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_matches_jax(arch, dtype, monkeypatch):
    jdt, tdt = DTYPES[dtype]
    jcfg, cfg, jp = _jax_params(arch, jdt)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    if cfg.qkv_bias:
        assert tp["layers"]["attn"]["k"]["b"].abs().min() > 0
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 24))
    tokens[1, 16:] = 0                           # a padded row's tail
    jl, jaux, jc = jforward(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                            jdims(jcfg), JFwd(dtype=jdt, collect_cache=True))
    margins = []
    _router_margins(monkeypatch, margins)
    tl, aux, tc = forward(tp, {"tokens": torch.from_numpy(tokens)}, cfg,
                          model_dims(cfg),
                          FwdOptions(dtype=tdt, collect_cache=True))
    assert len(margins) == (cfg.num_layers if cfg.family == "moe" else 0)
    keep = None
    if margins and dtype == "bfloat16":
        keep = np.min(margins, axis=0) >= NEAR_TIE
        assert (~keep).sum() <= 8, np.min(margins, axis=0)
    assert tl.dtype == tdt and tuple(tl.shape) == jl.shape
    for got, want in ((tl, jl), (tc["k"], jc["k"]), (tc["v"], jc["v"])):
        assert tuple(got.shape) == want.shape
        _close(got, want, dtype, keep)
    assert sorted(aux) == sorted(jaux)
    for key in jaux:
        assert aux[key].dtype == torch.float32
        npt.assert_allclose(float(aux[key]), float(jaux[key]),
                            rtol=1e-4 if dtype == "float32" else 3e-2,
                            atol=1e-5, err_msg=key)
    if cfg.family == "moe":
        assert float(aux["lb_loss"]) > 0 and float(
            aux["fraction_dropped"]) == 0.0
    if arch == "granite-3-8b":
        pad = tl[..., cfg.vocab_size:]
        assert tl.shape[-1] == 49280 and pad.shape[-1] == 125
        assert bool((pad == -1e9).all())


@pytest.mark.parametrize("arch", NEW_ARCHS + ["granite-8b"])
def test_init_params_tree_matches_jax(arch):
    jcfg, cfg = jreduced(JARCHS[arch]), reduced(ARCHS[arch])
    for jdt, tdt in DTYPES.values():
        want = jax.eval_shape(lambda k: jinit(k, jcfg, jdims(jcfg),
                                              dtype=jdt),
                              jax.random.PRNGKey(0))
        got = init_params(torch.Generator().manual_seed(0), cfg,
                          model_dims(cfg), tdt, "cpu")
        flat_w = {jax.tree_util.keystr(p): (tuple(l.shape), l.dtype.name)
                  for p, l in jax.tree_util.tree_leaves_with_path(want)}
        flat_g = {jax.tree_util.keystr(p): (tuple(l.shape),
                                            str(l.dtype).split(".")[-1])
                  for p, l in jax.tree_util.tree_leaves_with_path(got)}
        assert flat_g == flat_w
        if cfg.family == "moe":
            moe = got["layers"]["moe"]
            assert "mlp" not in got["layers"]
            assert moe["router"]["w"].dtype == torch.float32
            # the draw scales: 1/sqrt(fan-in)
            for key, fan in (("gate", cfg.d_model), ("down", cfg.d_ff)):
                std = float(moe[key].float().std())
                assert abs(std * fan ** 0.5 - 1.0) < 0.1, key


# ------------------------------------------------------------ the engine

MOE = "qwen3-moe-30b-a3b"
SAMPLED = dict(temperature=0.9, top_k=8, top_p=0.95)
ENGINE = dict(max_batch=3, max_seq_len=96, prefill_budget=32,
              auto_release=True)


@pytest.fixture(scope="module")
def moe_weights():
    jcfg, cfg = _cfgs(MOE)
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg))
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _requests(api, cfg):
    """Five requests: random and repetitive prompts, two sampled, two
    sharing a two-block prefix (a prefix-cache hit), one long enough to
    chunk under the 32-token budget."""
    req_cls, sp_cls = api
    bs = cfg.kv_block_size
    rng = np.random.RandomState(11)
    shared = rng.randint(0, cfg.vocab_size, 2 * bs)
    rep = np.tile(np.asarray([11, 23, 42, 7]), 3 * bs // 4)
    prompts = [rng.randint(0, cfg.vocab_size, 5 * bs),
               np.concatenate([shared, rng.randint(0, cfg.vocab_size, bs)]),
               rep, np.concatenate([shared, rep[:bs]]),
               rng.randint(0, cfg.vocab_size, bs)]
    return [req_cls(seq_id=i, prompt=p, max_new_tokens=12 + i,
                    sampling=(sp_cls(seed=50 + i, **SAMPLED) if i in (1, 4)
                              else sp_cls()))
            for i, p in enumerate(prompts)]


_RUNS = {}


def _run(moe_weights, which, spec=None, cf=None):
    """One engine run a (side, mode), cached for the module: (streams,
    engine)."""
    key = (which, spec, cf)
    if key not in _RUNS:
        jcfg, jp, cfg, tp = moe_weights
        if cf is not None:
            jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cf)
            cfg = dataclasses.replace(cfg, moe_capacity_factor=cf)
        kw = dict(ENGINE, spec_decode=spec, num_draft_tokens=4)
        if which == "jax":
            eng = JEngine(jcfg, jp, JConfig(**kw))
            reqs = _requests((JRequest, JSamplingParams), cfg)
        else:
            eng = Engine(cfg, tp, EngineConfig(**kw), device="cpu")
            reqs = _requests((Request, SamplingParams), cfg)
        for r in reqs[:4]:
            eng.submit(r)
        eng.step()
        eng.submit(reqs[4])                     # mid-decode admission
        steps = 0
        while eng.has_unfinished():
            eng.step()
            if which == "port":
                eng.check_invariants()
            steps += 1
            assert steps < 300, "engine failed to drain"
        _RUNS[key] = ({r.seq_id: list(r.generated) for r in reqs}, eng)
    return _RUNS[key]


@pytest.mark.parametrize("spec,cf", [(None, None), ("ngram", None),
                                     (None, 1.25)])
def test_moe_engine_matches_jax(moe_weights, spec, cf):
    out, eng = _run(moe_weights, "port", spec, cf)
    jout, jeng = _run(moe_weights, "jax", spec, cf)
    assert out == jout
    assert eng.admission_log == jeng.admission_log
    assert any(r.path == "prefix_kv" for r in eng.admission_log)
    assert dict(eng.manager.stats) == dict(jeng.manager.stats)
    st, jst = eng.stats(), jeng.stats()
    assert st["prefix_cache"] == jst["prefix_cache"]
    assert st["prefix_cache"]["hits"] > 0
    assert st["overload"] == jst["overload"]
    keys = ["rsw_hits", "flex_walks", "cached_blocks", "preempts"]
    if spec:
        keys += ["drafted", "accepted"]
        assert st["spec_drafted"] == jst["spec_drafted"] > 0
        assert st["spec_accepted"] == jst["spec_accepted"] > 0
    for sid, row in jst["per_request"].items():
        for key in keys:
            assert st["per_request"][sid][key] == row[key], (sid, key)


def test_moe_spec_on_equals_spec_off(moe_weights):
    on, eng = _run(moe_weights, "port", "ngram")
    off, _ = _run(moe_weights, "port")
    assert on == off
    assert eng.stats()["per_request"][2]["accepted"] > 0


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b"])
def test_what_still_raises(arch):
    """Every family runs; what is refused: the verify step for the
    recurrent families (a rejected draft would need a state rollback),
    meshes (ROADMAP P15) at every entry point that takes one, and an
    unknown family."""
    import types
    from repro_torch.serve import decode, spec_decode
    cfg = reduced(ARCHS[arch])
    dims = model_dims(cfg)
    spec = decode.DecodeSpec(block_size=8, max_blocks_per_seq=4,
                             slots_per_group=16, n_sets=2, assoc=8)
    with pytest.raises(ValueError, match="recurrent state rollback"):
        spec_decode.make_spec_decode_step(cfg, dims, spec, 4)
    dense = reduced(ARCHS["granite-8b"])
    ddims = model_dims(dense)
    for call in (lambda: EngineConfig(mesh_shape=(1, 2)).check_ported(),
                 lambda: spec_decode.make_spec_decode_step(
                     dense, ddims, spec, 4, mesh=object()),
                 lambda: decode.init_decode_state(dense, ddims, spec, 2,
                                                  data_size=2,
                                                  device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP P15"):
            call()
    odd = types.SimpleNamespace(family="retrieval")
    with pytest.raises(ValueError, match="unknown model family"):
        forward({}, {"tokens": torch.zeros((1, 8), dtype=torch.long)}, odd,
                dims)
