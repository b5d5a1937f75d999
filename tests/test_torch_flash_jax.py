"""The port's ``flash_attention_jax`` (the JAX package's chunked online-
softmax attention, eager torch) and the engine's ``attn_impl="flash_jax"``
against the JAX package.

The function is held to JAX's on the same seeded inputs within 1e-5 in
float32 and 3e-2 in bfloat16: causal and full, a query offset, both
``triangular_schedule`` settings, GQA, and a 1500-long sequence whose
chunks ``pick_chunk`` picks (500).  The engine takes ``"flash_jax"`` as
the JAX engine does: it warns and falls back to recompute prefill, and on
the reduced granite-8b in float32 its streams and admission log equal the
JAX engine's.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import init_params as jinit, model_dims as jdims
from repro.serve import Engine as JEngine, EngineConfig as JConfig
from repro.serve import Request as JRequest
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import FwdOptions
from repro_torch.params import params_from_numpy
from repro_torch.serve import Engine, EngineConfig, Request

# the modules (each package's ``models`` exports a function of this name)
jattn = importlib.import_module("repro.models.attention")
tattn = importlib.import_module("repro_torch.models.attention")

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.mark.parametrize("n,target", [(1500, 512), (1536, 512), (256, 512),
                                      (192, 64), (7, 3), (1, 512)])
def test_pick_chunk_matches_jax(n, target):
    assert tattn.pick_chunk(n, target) == jattn.pick_chunk(n, target)


# (B, Sq, Skv, H, KV, D, causal, q_offset, q_chunk, kv_chunk, triangular)
CASES = {
    "causal": (2, 256, 256, 4, 2, 32, True, 0, 64, 64, False),
    "causal_triangular": (2, 256, 256, 4, 2, 32, True, 0, 64, 64, True),
    "full_gqa4": (1, 128, 192, 8, 2, 16, False, 0, 32, 64, False),
    "q_offset": (2, 64, 192, 4, 4, 32, True, 128, 32, 64, False),
    "q_offset_triangular": (2, 64, 192, 4, 4, 32, True, 128, 32, 64, True),
    "seq1500": (1, 1500, 1500, 2, 1, 16, True, 0, 512, 512, False),
    "seq1500_full": (1, 1500, 1500, 2, 2, 16, False, 0, 512, 512, False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_jax_matches_jax(case, dtype):
    B, Sq, Skv, H, KV, D, causal, off, qc, kc, tri = CASES[case]
    rng = np.random.RandomState(len(case))
    q, k, v = (rng.randn(B, S, n, D).astype(np.float32)
               for S, n in ((Sq, H), (Skv, KV), (Skv, KV)))
    kw = dict(causal=causal, q_chunk=qc, kv_chunk=kc, q_offset=off,
              triangular_schedule=tri)
    want = jattn.flash_attention_jax(
        *(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)), **kw)
    got = tattn.flash_attention_jax(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, Sq, H, D)
    err = np.abs(got.float().numpy()
                 - np.asarray(want.astype(jnp.float32))).max()
    assert err <= TOL[dtype], err
    if dtype == "float32":
        # and the dense reference (one softmax over every key)
        dense = tattn.dense_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
            q_offset=off)
        assert (got - dense).abs().max() <= 1e-5


def test_attention_dispatch_flash_jax():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 64, 4, 16).astype(np.float32))
               for _ in range(3))
    got = tattn.attention(q, k, v, impl="flash_jax", q_chunk=16,
                          kv_chunk=32, triangular_schedule=True)
    assert torch.allclose(got, tattn.dense_attention(q, k, v), atol=1e-5)
    with pytest.raises(NotImplementedError, match="full-length KV"):
        tattn.attention(q, k, v, impl="flash_jax",
                        kv_len=torch.tensor([64]))
    opt = FwdOptions()
    assert (opt.q_chunk, opt.kv_chunk, opt.triangular_schedule) == (
        512, 512, False)


ENGINE = dict(max_batch=3, max_seq_len=64, restseg_fraction=0.25,
              prefill_budget=24, auto_release=True, overload_policy="fail",
              prefix_cache=None)
PROMPT_BLOCKS = [1, 3, 5, 2, 1, 4]
NEW_TOKENS = [5, 7, 6, 4, 8, 6]


def _run(eng, req_cls, prompts):
    for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS)):
        eng.submit(req_cls(seq_id=i, prompt=p, max_new_tokens=n))
    streams = {i: [] for i in range(len(prompts))}
    for _ in range(200):
        if not eng.has_unfinished():
            break
        for sid, tok in eng.step().items():
            streams[sid].append(tok)
    assert not eng.has_unfinished(), "engine failed to drain"
    return streams


def test_engine_flash_jax_matches_jax_engine(monkeypatch):
    """``Engine(attn_impl="flash_jax")`` warns and falls back to recompute
    prefill as the JAX engine does, and serves the same streams with the
    same admission log (reduced granite-8b, float32, one long prompt
    chunked)."""
    jcfg = jreduced(JARCHS["granite-8b"])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    cfg = reduced(ARCHS["granite-8b"])
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab_size, n * 8) for n in PROMPT_BLOCKS]
    with pytest.warns(UserWarning, match="falling back") as jw:
        jeng = JEngine(jcfg, jp, JConfig(attn_impl="flash_jax", **ENGINE))
    with pytest.warns(UserWarning, match="falling back") as tw:
        teng = Engine(cfg, tp, EngineConfig(attn_impl="flash_jax", **ENGINE),
                      device="cpu")
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert teng.prefill_mode == jeng.prefill_mode == "recompute"
    assert teng.fwd.attn_impl == "flash_jax"
    calls = []
    orig = tattn.flash_attention_jax

    def counting(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)

    monkeypatch.setattr(tattn, "flash_attention_jax", counting)
    tstreams = _run(teng, Request, prompts)
    assert calls, "the recompute prefill never reached flash_attention_jax"
    assert _run(jeng, JRequest, prompts) == tstreams
    assert jeng.admission_log == teng.admission_log
    assert any(r.end - r.start < 40 and r.seq_id == 2
               for r in teng.admission_log), "the long prompt was chunked"
    assert dict(jeng.manager.stats) == dict(teng.manager.stats)
    teng.check_invariants()
