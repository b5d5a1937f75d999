"""The port's seeded sampling against the JAX package's.

* the torch threefry2x32: key data, ``fold_in`` and the random bits under
  ``gumbel`` exactly equal to jax's (threefry with
  ``jax_threefry_partitionable=True``, 64-bit types off), for seeds 0, 1,
  2**31 and 2**33+5; the gumbel floats within 1e-5 (log implementations
  differ by float32 ulps);
* ``apply_top_k_top_p`` masks equal to JAX's;
* ``sample_tokens`` and the engines' sampled streams equal to JAX's
  except on near-ties of logit + noise;
* port against port: seed-reproducible streams, independent of the
  admission schedule; greedy rows bitwise in mixed batches; one ``.cpu()``
  per sampled step.

On the reduced granite-8b with float32 weights from the JAX
``init_params``; ``gpu``-marked twins hold the card against the CPU.
"""
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
from repro_torch.configs import ARCHS, reduced
from repro_torch.params import params_from_numpy
from repro_torch.serve import Engine, EngineConfig, Request, SamplingParams
from repro_torch.serve import sampling as tsampling

torch.set_num_threads(2)

SEEDS = [0, 1, 2 ** 31, 2 ** 33 + 5]


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(JARCHS["granite-8b"])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, reduced(ARCHS["granite-8b"]), tp


# ------------------------------------------------------------ the bits

@pytest.mark.parametrize("seed", SEEDS)
def test_key_data_and_bits_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    kd = tsampling.prng_key_data(SamplingParams(seed=seed), 99)
    np.testing.assert_array_equal(kd, np.asarray(key, np.uint32))
    np.testing.assert_array_equal(
        tsampling.prng_key_data(SamplingParams(), seed),
        np.asarray(key, np.uint32))                 # seed None: the seq_id
    keys = torch.from_numpy(kd.astype(np.int64))[None]
    V = 300
    for step in (0, 1, 17, 2 ** 20 + 3):
        fk = jax.random.fold_in(key, step)
        tk = tsampling.fold_in(keys, torch.tensor([step]))
        np.testing.assert_array_equal(tk[0].numpy(), np.asarray(fk))
        np.testing.assert_array_equal(
            tsampling.random_bits(tk, V)[0].numpy(),
            np.asarray(jax.random.bits(fk, (V,), jnp.uint32)))
        tiny = jnp.finfo(jnp.float32).tiny
        np.testing.assert_array_equal(
            tsampling.uniform(tk, V)[0].numpy(),
            np.asarray(jax.random.uniform(fk, (V,), jnp.float32,
                                          minval=tiny, maxval=1.0)))
        np.testing.assert_allclose(
            tsampling.gumbel(tk, V)[0].numpy(),
            np.asarray(jax.random.gumbel(fk, (V,), jnp.float32)),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_k_top_p_masks_match_jax(seed):
    rng = np.random.RandomState(seed)
    B, V = 16, 64
    logits = (rng.randn(B, V) * 2).astype(np.float32)
    logits[0, :8] = logits[0, 8]                  # ties at the cut-off
    ks = rng.choice([0, 1, 3, 7, 8, V, V + 5], B).astype(np.int32)
    ps = rng.choice([0.25, 0.55, 0.9, 1.0, 1e-6], B).astype(np.float32)
    want = np.asarray(jsampling.apply_top_k_top_p(
        jnp.asarray(logits), jnp.asarray(ks), jnp.asarray(ps)))
    got = tsampling.apply_top_k_top_p(torch.from_numpy(logits),
                                      torch.from_numpy(ks),
                                      torch.from_numpy(ps)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  want[np.isfinite(want)])


def _near_tie(logits, temp, k, p, key, step, a, b):
    """Whether tokens ``a`` and ``b`` are within 1e-3 of each other on the
    noised, masked scores of one row (the port's own)."""
    lg = torch.from_numpy(logits)[None]
    masked = tsampling.apply_top_k_top_p(
        lg.float() / max(temp, tsampling.TEMP_EPS), torch.tensor([k]),
        torch.tensor([p], dtype=torch.float32))
    noise = tsampling.gumbel(tsampling.fold_in(key, torch.tensor([step])),
                             lg.shape[-1])
    s = (masked + noise)[0]
    return abs(float(s[a] - s[b])) < 1e-3


def test_sample_tokens_match_jax():
    rng = np.random.RandomState(3)
    B, V = 64, 256
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    temp = rng.choice([0.0, 0.5, 0.8, 1.0, 1.7], B).astype(np.float32)
    ks = rng.choice([0, 1, 5, 40], B).astype(np.int32)
    ps = rng.choice([0.5, 0.9, 1.0], B).astype(np.float32)
    keys = np.stack([jsampling.prng_key_data(JSamplingParams(seed=int(s)), 0)
                     for s in rng.randint(0, 2 ** 31, B)])
    steps = rng.randint(0, 5000, B).astype(np.int32)
    want = np.asarray(jsampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(ks),
        jnp.asarray(ps), jnp.asarray(keys), jnp.asarray(steps)))
    tkeys = torch.from_numpy(keys.astype(np.int64))
    got = tsampling.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(ks), torch.from_numpy(ps), tkeys,
        torch.from_numpy(steps)).numpy()
    greedy = temp == 0
    np.testing.assert_array_equal(got[greedy], logits[greedy].argmax(-1))
    np.testing.assert_array_equal(got[greedy], want[greedy])
    bad = [b for b in np.nonzero(got != want)[0]
           if not _near_tie(logits[b], float(temp[b]), int(ks[b]),
                            float(ps[b]), tkeys[b:b + 1], int(steps[b]),
                            int(got[b]), int(want[b]))]
    assert not bad, [(b, got[b], want[b]) for b in bad]
    assert (got == want).mean() > 0.9


# ---------------------------------------------------------- the engines

ENGINE = dict(max_batch=3, max_seq_len=96, prefill_budget=24,
              auto_release=True)
SAMPLED = dict(temperature=0.8, top_k=30, top_p=0.95)


def _requests(req_cls, sp_cls, vocab, sampled_every=2, seed=4):
    rng = np.random.RandomState(seed)
    out = []
    for i, nb in enumerate([2, 5, 3, 1, 4, 2]):
        sp = (sp_cls(seed=1000 + i, **SAMPLED) if i % sampled_every == 0
              else sp_cls())
        out.append(req_cls(seq_id=i, prompt=rng.randint(0, vocab, 8 * nb),
                           max_new_tokens=6, sampling=sp))
    return out


def _drain(eng, reqs, submit_at=None):
    """Submit ``reqs`` (request i at step ``submit_at[i]``, default all at
    once) and step to completion."""
    submit_at = submit_at or [0] * len(reqs)
    step = 0
    while True:
        for r, at in zip(reqs, submit_at):
            if at == step:
                eng.submit(r)
        if step > max(submit_at) and not eng.has_unfinished():
            break
        eng.step()
        step += 1
        assert step < 300, "engine failed to drain"
    return {r.seq_id: list(eng._states[r.seq_id].generated) for r in reqs}


def test_engine_sampled_streams_match_jax(weights):
    """Half the requests sampled (fixed seeds), prompts chunked through
    the prefix-KV path: admission log, manager stats and every stream,
    greedy and sampled, identical."""
    jcfg, jp, cfg, tp = weights
    jeng = JEngine(jcfg, jp, JConfig(overload_policy="fail", **ENGINE))
    want = _drain(jeng, _requests(JRequest, JSamplingParams,
                                  cfg.vocab_size))
    teng = Engine(cfg, tp, EngineConfig(overload_policy="fail", **ENGINE),
                  device="cpu")
    got = _drain(teng, _requests(Request, SamplingParams, cfg.vocab_size))
    assert teng.admission_log == jeng.admission_log
    assert dict(teng.manager.stats) == dict(jeng.manager.stats)
    for sid in want:
        assert got[sid] == want[sid], (sid, got[sid], want[sid])


def test_sampled_seed_reproducible_and_schedule_independent(weights):
    """The same sampled requests give the same tokens run twice, and when
    submitted one at a time on a different step schedule with a smaller
    budget (other chunking, slots and batch neighbours)."""
    _, _, cfg, tp = weights
    mk = lambda: _requests(Request, SamplingParams, cfg.vocab_size,
                           sampled_every=1)
    a = _drain(Engine(cfg, tp, EngineConfig(**ENGINE), device="cpu"), mk())
    b = _drain(Engine(cfg, tp, EngineConfig(**ENGINE), device="cpu"), mk())
    c = _drain(Engine(cfg, tp, EngineConfig(**dict(
        ENGINE, prefill_budget=8, max_batch=2)), device="cpu"), mk(),
        submit_at=[0, 3, 5, 6, 9, 14])
    assert a == b == c
    greedy = _drain(Engine(cfg, tp, EngineConfig(**ENGINE), device="cpu"),
                    _requests(Request, SamplingParams, cfg.vocab_size,
                              sampled_every=99))
    assert a != greedy                 # sampling changed the streams


def test_mixed_batch_greedy_rows_bitwise(weights):
    """Greedy requests decoded next to sampled ones give the tokens of an
    all-greedy run (the sampled branch leaves greedy rows on argmax)."""
    _, _, cfg, tp = weights
    mixed = _drain(Engine(cfg, tp, EngineConfig(**ENGINE), device="cpu"),
                   _requests(Request, SamplingParams, cfg.vocab_size))
    greedy = _drain(Engine(cfg, tp, EngineConfig(**ENGINE), device="cpu"),
                    _requests(Request, SamplingParams, cfg.vocab_size,
                              sampled_every=99))
    for sid in (1, 3, 5):
        assert mixed[sid] == greedy[sid]


def test_sampled_step_single_cpu_copy(weights, monkeypatch):
    """A steady decode step with sampled rows still makes ONE
    device-to-host copy and no other host sync."""
    _, _, cfg, tp = weights
    eng = Engine(cfg, tp, EngineConfig(max_batch=3, max_seq_len=64),
                 device="cpu")
    rng = np.random.RandomState(4)
    for i in range(3):
        eng.submit(Request(seq_id=i, prompt=rng.randint(0, 256, 16),
                           max_new_tokens=20,
                           sampling=SamplingParams(temperature=0.7,
                                                   top_k=10, seed=i)
                           if i != 1 else SamplingParams()))
    eng.step()                                  # admission
    counts = {"cpu": 0}
    cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        counts["cpu"] += 1
        return cpu(self, *a, **k)

    def forbidden(self, *a, **k):
        raise AssertionError("a host sync outside the step's one copy")

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    monkeypatch.setattr(torch.Tensor, "item", forbidden)
    monkeypatch.setattr(torch.Tensor, "tolist", forbidden)
    monkeypatch.setattr(torch.Tensor, "__bool__", forbidden)
    for n in range(1, 4):
        assert len(eng.step()) == 3
        assert counts["cpu"] == n


# ------------------------------------------------------- card vs CPU

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")


@pytest.mark.gpu
def test_gpu_sampling_matches_cpu():
    """Bits exactly, gumbel within 1e-5, tokens equal except near-ties."""
    _need_card()
    rng = np.random.RandomState(5)
    B, V = 32, 49152
    logits = torch.from_numpy((rng.randn(B, V) * 3).astype(np.float32))
    temp = torch.from_numpy(rng.choice([0.0, 0.8, 1.0], B).astype(
        np.float32))
    ks = torch.from_numpy(rng.choice([0, 50], B).astype(np.int32))
    ps = torch.from_numpy(rng.choice([0.95, 1.0], B).astype(np.float32))
    keys = torch.from_numpy(rng.randint(0, 2 ** 31, (B, 2)))
    steps = torch.from_numpy(rng.randint(0, 4096, B).astype(np.int32))
    fk = tsampling.fold_in(keys, steps)
    assert torch.equal(tsampling.fold_in(keys.cuda(), steps.cuda()).cpu(),
                       fk)
    assert torch.equal(tsampling.random_bits(fk.cuda(), V).cpu(),
                       tsampling.random_bits(fk, V))
    torch.testing.assert_close(tsampling.gumbel(fk.cuda(), V).cpu(),
                               tsampling.gumbel(fk, V), rtol=1e-5,
                               atol=1e-5)
    args = (logits, temp, ks, ps, keys, steps)
    cpu = tsampling.sample_tokens(*args)
    card = tsampling.sample_tokens(*(a.cuda() for a in args)).cpu()
    for b in torch.nonzero(card != cpu).flatten().tolist():
        assert _near_tie(logits[b].numpy(), float(temp[b]), int(ks[b]),
                         float(ps[b]), keys[b:b + 1], int(steps[b]),
                         int(card[b]), int(cpu[b])), b


@pytest.mark.gpu
def test_gpu_engine_sampled_matches_cpu(weights):
    _need_card()
    _, _, cfg, tp = weights
    runs = []
    for dev, p in (("cpu", tp), ("cuda", jax.tree.map(lambda t: t.cuda(),
                                                        tp))):
        eng = Engine(cfg, p, EngineConfig(**ENGINE), device=dev)
        runs.append((_drain(eng, _requests(Request, SamplingParams,
                                           cfg.vocab_size)),
                     list(eng.admission_log), dict(eng.manager.stats)))
    assert runs[0] == runs[1]
