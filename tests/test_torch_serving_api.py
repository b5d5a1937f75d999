"""The port's legacy engine API and ``attn_impl`` names against the JAX
package's.

* ``Engine(cfg, params, **kwargs)`` builds an ``EngineConfig`` and warns
  once a process, with JAX's message; kwargs beside a config, or unknown
  ones, raise ``TypeError`` as in JAX;
* ``submit(req, share_prefix_from=, shared_blocks=)`` warns once and
  changes nothing (the prefix cache shares);
* ``add_request``, the blocking admission: the uses of
  ``tests/test_admission.py`` give identical streams and admission logs,
  it raises ``PoolExhausted`` without a free slot, and makes one
  ``.cpu()``;
* ``attn_impl``: ``"dense"``, ``"pallas"`` and ``"flash_jax"`` give the
  port the JAX engine's ``prefill_mode`` and fallback warning.

On ``reduced(granite-8b)`` with float32 weights from the JAX
``init_params``, on the CPU.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.serve.engine as jengine_mod
import repro_torch.serve.engine as engine_mod
from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import FwdOptions as JFwd
from repro.models import init_params as jinit, model_dims as jdims
from repro.serve import Engine as JEngine, EngineConfig as JConfig
from repro.serve import Request as JRequest
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import PoolExhausted
from repro_torch.models import FwdOptions
from repro_torch.params import params_from_numpy
from repro_torch.serve import Engine, EngineConfig, Request

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(JARCHS["granite-8b"])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return {"jax": (jcfg, jp), "port": (reduced(ARCHS["granite-8b"]), tp)}


def _legacy(weights, port, **kw):
    """An engine built from legacy kwargs (the port on the CPU)."""
    if port:
        return Engine(*weights["port"], device="cpu", **kw)
    return JEngine(*weights["jax"], **kw)


def _caught(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, [(x.category, str(x.message)) for x in w]


def _drain(eng, limit=400):
    steps = 0
    while eng.has_unfinished():
        eng.step()
        steps += 1
        assert steps < limit, "engine failed to drain"


# ---------------------------------------------------- legacy kwargs

def test_legacy_kwargs_warn_exactly_once(weights, monkeypatch):
    bs = weights["port"][0].kv_block_size
    msgs = {}
    for port, mod in ((True, engine_mod), (False, jengine_mod)):
        monkeypatch.setattr(mod, "_LEGACY_KWARGS_WARNED", False)
        (e1, e2), w = _caught(lambda: (
            _legacy(weights, port, max_batch=2, max_seq_len=4 * bs),
            _legacy(weights, port, max_batch=2, max_seq_len=4 * bs,
                    mode="flexible_only")))
        dep = [m for c, m in w if issubclass(c, DeprecationWarning)
               and "EngineConfig" in m]
        assert len(dep) == 1
        assert e1.max_batch == 2 and e2.hybrid_cfg.mode == "flexible_only"
        msgs[port] = dep[0]
    assert msgs[True] == msgs[False]


def test_config_and_kwargs_are_exclusive(weights):
    for port in (True, False):
        cfg, params = weights["port" if port else "jax"]
        eng, conf = (Engine, EngineConfig) if port else (JEngine, JConfig)
        with pytest.raises(TypeError, match="not both"):
            eng(cfg, params, conf(max_batch=2), max_seq_len=64)
        with pytest.raises(TypeError, match="unknown Engine kwargs"):
            eng(cfg, params, batch_size=2)


def test_device_stays_a_keyword(weights):
    cfg, tp = weights["port"]
    eng = Engine(cfg, tp, EngineConfig(max_batch=2), "cpu")
    assert eng.device == torch.device("cpu") and eng.max_batch == 2
    eng = Engine(cfg, tp, max_batch=3, device="cpu")
    assert eng.device == torch.device("cpu") and eng.max_batch == 3


# ------------------------------------------------ share_prefix_from

def test_share_kwargs_warn_once_and_change_nothing(weights, monkeypatch):
    bs = weights["port"][0].kv_block_size
    prompt = np.random.RandomState(11).randint(0, 256, 2 * bs)
    out = {}
    for port, mod, req_cls in ((True, engine_mod, Request),
                               (False, jengine_mod, JRequest)):
        monkeypatch.setattr(mod, "_SHARE_KWARG_WARNED", False)
        eng = _legacy(weights, port, max_batch=3, max_seq_len=6 * bs)
        reqs = [req_cls(seq_id=i, prompt=prompt, max_new_tokens=4)
                for i in range(3)]
        _, w = _caught(lambda: (
            eng.submit(reqs[0]),
            eng.submit(reqs[1], share_prefix_from=0, shared_blocks=2),
            eng.submit(reqs[2], share_prefix_from=0, shared_blocks=1)))
        dep = [m for c, m in w if issubclass(c, DeprecationWarning)]
        assert len(dep) == 1 and "share_prefix_from" in dep[0]
        _drain(eng)
        out[port] = ([list(r.generated) for r in reqs], dep[0],
                     eng.admission_log)
    assert out[True] == out[False]
    assert out[True][0][0] == out[True][0][1] == out[True][0][2]


def test_share_source_released_before_sharer_admitted(weights):
    """Sharing degrades to plain prefill when the source finished and
    auto-released while the sharer queued (``test_admission.py``)."""
    bs = weights["port"][0].kv_block_size
    prompt = np.random.RandomState(11).randint(0, 256, 2 * bs)
    out = {}
    for port, req_cls in ((True, Request), (False, JRequest)):
        solo = req_cls(seq_id=9, prompt=prompt, max_new_tokens=3)
        eng0 = _legacy(weights, port, max_batch=1, max_seq_len=6 * bs)
        eng0.add_request(solo)
        _drain(eng0)
        eng = _legacy(weights, port, max_batch=1, max_seq_len=6 * bs,
                      auto_release=True)
        src = req_cls(seq_id=0, prompt=prompt, max_new_tokens=3)
        eng.add_request(src)
        dup = req_cls(seq_id=1, prompt=prompt, max_new_tokens=3)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng.submit(dup, share_prefix_from=0, shared_blocks=2)
        _drain(eng)
        assert list(src.generated) == list(dup.generated) == list(
            solo.generated)
        eng.manager.check_invariants()
        out[port] = (list(dup.generated), eng.admission_log,
                     dict(eng.manager.stats))
    assert out[True] == out[False]


# ------------------------------------------------------ add_request

def test_add_request_interleaved_matches_sequential_and_jax(weights):
    """``test_admission.py``'s sequential equivalence: each request alone
    through ``add_request`` gives the tokens of the interleaved, chunked
    run; streams and admission logs equal JAX's."""
    bs = weights["port"][0].kv_block_size
    rng = np.random.RandomState(42)
    prompts = [rng.randint(0, 256, n * bs) for n in (2, 4, 2, 3)]
    n_new = [6, 5, 6, 4]
    out = {}
    for port, req_cls in ((True, Request), (False, JRequest)):
        ref = []
        for p, n in zip(prompts, n_new):
            eng = _legacy(weights, port, max_batch=4, max_seq_len=8 * bs)
            r = req_cls(seq_id=0, prompt=p, max_new_tokens=n)
            assert eng.add_request(r) == eng._slot_of[0]
            assert len(r.generated) == 1        # the prefill's first token
            _drain(eng)
            ref.append(list(r.generated))
        eng = _legacy(weights, port, max_batch=4, max_seq_len=8 * bs)
        eng.prefill_budget = 2 * bs
        reqs = [req_cls(seq_id=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, n_new))]
        eng.submit(reqs[0])
        eng.submit(reqs[1])
        eng.step()
        eng.step()
        eng.submit(reqs[2])
        eng.submit(reqs[3])
        _drain(eng)
        got = [list(r.generated) for r in reqs]
        assert got == ref
        out[port] = (got, eng.admission_log)
    assert out[True] == out[False]


def test_add_request_then_chunked_prefill_leaves_live_slot(weights):
    bs = weights["port"][0].kv_block_size
    rng = np.random.RandomState(0)
    pa, pb = (rng.randint(0, 256, n * bs) for n in (2, 4))
    out = {}
    for port, req_cls in ((True, Request), (False, JRequest)):
        eng = _legacy(weights, port, max_batch=4, max_seq_len=8 * bs,
                      prefill_budget=bs)
        a = req_cls(seq_id=0, prompt=pa, max_new_tokens=12)
        eng.add_request(a)
        slot_a = eng._slot_of[0]
        ctx_a = int(eng._ctx_host[slot_a])
        eng.submit(req_cls(seq_id=1, prompt=pb, max_new_tokens=4))
        for k in range(1, 4):
            eng.step()
            assert eng._prefilling.get(1, 4 * bs) < 4 * bs
            assert int(eng._ctx_host[slot_a]) == ctx_a + k
            np.testing.assert_array_equal(np.asarray(eng.dstate["ctx_len"]),
                                          eng._ctx_host)
        _drain(eng)
        out[port] = (list(a.generated), eng.admission_log)
    assert out[True] == out[False]


def test_add_request_without_a_free_slot_raises(weights):
    bs = weights["port"][0].kv_block_size
    prompt = np.random.RandomState(1).randint(0, 256, bs)
    for port, req_cls in ((True, Request), (False, JRequest)):
        eng = _legacy(weights, port, max_batch=1, max_seq_len=4 * bs)
        r0 = req_cls(seq_id=0, prompt=prompt, max_new_tokens=2)
        eng.add_request(r0)
        _drain(eng)
        r1 = req_cls(seq_id=1, prompt=prompt, max_new_tokens=2)
        exc = PoolExhausted if port else jengine_mod.PoolExhausted
        with pytest.raises(exc, match="no free sequence slot"):
            eng.add_request(r1)
        assert any(r is r1 for r in eng.waiting)     # still queued
        eng.release(0)
        _drain(eng)
        assert list(r1.generated) == list(r0.generated)


def test_add_request_makes_one_copy(weights, monkeypatch):
    """The blocking admission fetches every first token in one
    ``.cpu()`` (two requests, the second queued ahead of the call)."""
    cfg, tp = weights["port"]
    eng = Engine(cfg, tp, EngineConfig(max_batch=3, max_seq_len=64),
                 device="cpu")
    rng = np.random.RandomState(2)
    eng.submit(Request(seq_id=0, prompt=rng.randint(0, 256, 16)))
    counts = {"cpu": 0}
    cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        counts["cpu"] += 1
        return cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    eng.add_request(Request(seq_id=1, prompt=rng.randint(0, 256, 24)))
    assert counts["cpu"] == 1
    assert [len(eng._states[s].generated) for s in (0, 1)] == [1, 1]


# -------------------------------------------------------- attn_impl

@pytest.mark.parametrize("impl", ["dense", "pallas", "flash_jax"])
def test_attn_impl_config_parity(weights, impl):
    """The port takes JAX's attention names with JAX's consequences: the
    resulting ``prefill_mode`` and the prefix-KV fallback warning."""
    got = {}
    for port in (True, False):
        cfg, params = weights["port" if port else "jax"]
        eng, w = _caught(lambda: (
            Engine(cfg, params, EngineConfig(attn_impl=impl), device="cpu")
            if port else JEngine(cfg, params, JConfig(attn_impl=impl))))
        got[port] = (eng.prefill_mode, [m for _, m in w
                                         if "prefix-KV" in m])
    assert got[True] == got[False]
    assert got[True][0] == ("prefix_kv" if impl == "dense" else "recompute")
    assert len(got[True][1]) == (impl != "dense")
    assert FwdOptions().attn_impl == JFwd().attn_impl == "dense"


def test_attn_impl_flash_jax_falls_back_to_recompute(weights):
    """JAX's ``"flash_jax"`` constructs in both packages, with recompute
    prefill and the same one warning; the port still takes its own name
    ``"flash"`` as ``"pallas"``; an unknown name is a ValueError."""
    jcfg, jp = weights["jax"]
    cfg, tp = weights["port"]
    (jeng, teng), w = _caught(lambda: (
        JEngine(jcfg, jp, JConfig(attn_impl="flash_jax")),
        Engine(cfg, tp, EngineConfig(attn_impl="flash_jax"), device="cpu")))
    assert jeng.prefill_mode == teng.prefill_mode == "recompute"
    msgs = [m for _, m in w if "prefix-KV" in m]
    assert len(msgs) == 2 and msgs[0] == msgs[1]
    assert teng.fwd.attn_impl == "flash_jax"
    with pytest.raises(ValueError, match="attn_impl"):
        Engine(cfg, tp, EngineConfig(attn_impl="sdpa"), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert Engine(cfg, tp, EngineConfig(attn_impl="flash"),
                      device="cpu").prefill_mode == "recompute"
