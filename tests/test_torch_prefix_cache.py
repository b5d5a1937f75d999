"""The port's prefix cache against the JAX package's.

* ``block_hash_chain`` equal to JAX's on random prompts and block sizes;
* one ``PrefixCache`` op sequence (insert, match, dedup, a full set
  evicting, ``evict_one`` after releases, a forced set collision that
  must verify tokens) on the JAX and the port manager gives the same
  return values, directory contents, cache stats and manager state;
* the engines: ``stats()["prefix_cache"]``, the admission log, manager
  stats, per-request ``cached_blocks`` and the streams equal JAX's;
* port against port: cache-on streams equal cache-off, greedy and sampled,
  chunked; a tight pool reclaims cache entries before it refuses.

On the reduced granite-8b with float32 weights from the JAX
``init_params``; ``gpu``-marked twins hold the card against the CPU.
"""
import jax
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import init_params as jinit, model_dims as jdims
from repro.serve import Engine as JEngine, EngineConfig as JConfig
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro_torch import core as tcore
from repro_torch.configs import ARCHS, reduced
from repro_torch.params import params_from_numpy
from repro_torch.serve import Engine, EngineConfig, Request, SamplingParams

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(JARCHS["granite-8b"])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, reduced(ARCHS["granite-8b"]), tp


# ------------------------------------------------------- the directory

@pytest.mark.parametrize("bs", [4, 8, 16])
def test_block_hash_chain_matches_jax(bs):
    rng = np.random.RandomState(bs)
    assert tcore.CHAIN_SEED == jcore.CHAIN_SEED
    for n in (0, 3, bs - 1, bs, 5 * bs + 2, 40 * bs):
        t = rng.randint(0, 50000, n)
        np.testing.assert_array_equal(tcore.block_hash_chain(t, bs),
                                      jcore.block_hash_chain(t, bs))


def _cache_ops(core, hash_name):
    """One op sequence on a 32-slot manager with a 2-set x 2-way
    directory; returns every observable along the way."""
    m = core.HybridKVManager(core.HybridConfig(
        total_slots=32, assoc=4, max_seqs=4, max_blocks_per_seq=8,
        block_size=4, hash_name=hash_name))
    pc = core.PrefixCache(m, num_sets=2, assoc=2)
    trace = []

    def snap(tag):
        pc.check_invariants()
        m.check_invariants()
        ways = [[None if e is None else (e.chain, e.parent, e.slot,
                                         e.tokens.tolist()) for e in row]
                for row in pc.ways]
        trace.append((tag, ways, pc.n_entries, dict(pc.stats),
                      sorted(m.cached_slots), dict(m.slot_refcount),
                      dict(m.stats), m.flex_table.tolist(), m.tar.tolist(),
                      pc.evictable_count()))

    def insert(sid, tokens):
        ch = core.block_hash_chain(tokens, 4)
        parents = [core.CHAIN_SEED] + [int(c) for c in ch[:-1]]
        return [pc.insert(int(ch[b]), parents[b], tokens[4 * b:4 * b + 4],
                          sid, b) for b in range(len(ch))]

    rng = np.random.RandomState(1)
    a = rng.randint(0, 1000, 12)
    b = np.concatenate([a[:8], rng.randint(0, 1000, 8)])
    for sid in (0, 1, 2):
        m.register_sequence(sid)
    for bi in range(3):
        m.allocate_block(0, bi)
    for bi in range(4):
        m.allocate_block(1, bi)
    trace.append(("insert a", insert(0, a)))
    snap("after a")
    trace.append(("match b", [e.slot for e in pc.match(b)]))
    trace.append(("dedup b", insert(1, b)))       # shared blocks dedup
    snap("after b")
    m.free_sequence(0)
    snap("freed 0")
    # a third prompt fills sets: full sets evict unreferenced ways
    c = rng.randint(0, 1000, 16)
    for bi in range(4):
        m.allocate_block(2, bi)
    trace.append(("insert c", insert(2, c)))
    snap("after c")
    m.free_sequence(1)
    m.free_sequence(2)
    trace.append(("evict", [pc.evict_one() for _ in range(6)]))
    snap("evicted")
    # collision verification: same chain and parent, other tokens
    m.register_sequence(3)
    m.allocate_block(3, 0)
    d = rng.randint(0, 1000, 4)
    ch = int(core.block_hash_chain(d, 4)[0])
    trace.append(("insert d", pc.insert(ch, core.CHAIN_SEED, d, 3, 0)))
    trace.append(("collide", pc._find(ch, core.CHAIN_SEED, d + 1) is None,
                  [e.slot for e in pc.match(d)]))
    snap("final")
    return trace


@pytest.mark.parametrize("hash_name", ["modulo", "xor_fold",
                                       "multiplicative"])
def test_prefix_cache_ops_match_jax(hash_name):
    got = _cache_ops(tcore, hash_name)
    want = _cache_ops(jcore, hash_name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, g[0]
    stats = got[-1][3]
    assert stats["inserts"] > 0 and stats["evictions"] > 0


# ---------------------------------------------------------- the engines

def _fanout(eng, req_cls, sp_cls, vocab, *, n_req=6, shared_blocks=3,
            sampled=False, seed=13):
    """Shared-system-prompt fan-out: ``n_req`` requests share a
    ``shared_blocks`` prefix and differ in a random tail of 1-3 blocks;
    odd requests sampled when ``sampled``."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, shared_blocks * 8)
    for i in range(n_req):
        tail = rng.randint(0, vocab, 8 * (1 + i % 3))
        sp = (sp_cls(temperature=0.8, top_k=40, seed=123 + i)
              if sampled and i % 2 else sp_cls())
        eng.submit(req_cls(seq_id=i, prompt=np.concatenate([shared, tail]),
                           max_new_tokens=6, sampling=sp))
    for _ in range(400):
        if not eng.has_unfinished():
            break
        eng.step()
        # pool and directory consistency after every step (the device
        # tables sync lazily, before the next decode dispatch)
        eng.manager.check_invariants()
        if eng.prefix_cache is not None:
            eng.prefix_cache.check_invariants()
    assert not eng.has_unfinished(), "engine failed to drain"
    return {i: list(eng._states[i].generated) for i in range(n_req)}


ENGINE = dict(max_batch=3, max_seq_len=80, auto_release=True,
              prefill_budget=32)


@pytest.mark.parametrize("gather", ["exact", "paged"])
def test_engine_cache_matches_jax(weights, gather):
    jcfg, jp, cfg, tp = weights
    jeng = JEngine(jcfg, jp, JConfig(overload_policy="fail",
                                     prefix_gather=gather, **ENGINE))
    want = _fanout(jeng, JRequest, JSamplingParams, cfg.vocab_size,
                   sampled=True)
    teng = Engine(cfg, tp, EngineConfig(overload_policy="fail",
                                        prefix_gather=gather, **ENGINE),
                  device="cpu")
    got = _fanout(teng, Request, SamplingParams, cfg.vocab_size,
                  sampled=True)
    tst, jst = teng.stats(), jeng.stats()
    assert tst["prefix_cache"] == jst["prefix_cache"]
    assert tst["prefix_cache"]["hits"] > 0
    assert teng.admission_log == jeng.admission_log
    assert dict(teng.manager.stats) == dict(jeng.manager.stats)
    for sid in jst["per_request"]:
        assert (tst["per_request"][sid]["cached_blocks"]
                == jst["per_request"][sid]["cached_blocks"])
    assert sum(r["cached_blocks"] for r in tst["per_request"].values()) \
        == tst["prefix_cache"]["dedup_blocks"]
    assert got == want


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("budget", [32, 8])
def test_cache_on_equals_cache_off(weights, budget, sampled):
    """Port against port: the cache only changes how much prefill runs;
    every stream is the cache-off run's, with whole-prompt admission
    (budget 32) and one block per step (budget 8, chunked)."""
    _, _, cfg, tp = weights
    runs = {}
    for cache in ("auto", None):
        eng = Engine(cfg, tp, EngineConfig(**dict(
            ENGINE, prefill_budget=budget, prefix_cache=cache)),
            device="cpu")
        runs[cache] = _fanout(eng, Request, SamplingParams, cfg.vocab_size,
                              sampled=sampled)
        if cache:
            assert eng.stats()["prefix_cache"]["hits"] > 0
            assert eng.manager.cached_slots
            assert not eng.manager.blocks          # all released
    assert runs["auto"] == runs[None]


def test_tight_pool_reclaims_before_refusing(weights):
    """An all-flex pool just large enough for two sequences: sequential
    distinct prompts keep publishing blocks nobody reads again, so the
    capacity gate must reclaim unreferenced entries (``evict_one``) to
    admit the next request; the streams equal the cache-off run's."""
    _, _, cfg, tp = weights
    bs = cfg.kv_block_size

    def run(cache):
        eng = Engine(cfg, tp, EngineConfig(
            max_batch=2, max_seq_len=6 * bs, pool_headroom=1.0,
            restseg_fraction=0.0, auto_release=True, prefix_cache=cache),
            device="cpu")
        rng = np.random.RandomState(3)
        outs = {}
        for i in range(8):                     # sequential: drain each
            r = Request(seq_id=i, prompt=rng.randint(0, cfg.vocab_size,
                                                     2 * bs),
                        max_new_tokens=6)
            eng.submit(r)
            while eng.has_unfinished():
                eng.step()
            outs[i] = list(r.generated)
        eng.check_invariants()
        return outs, eng

    off, _ = run(None)
    on, eng = run("auto")
    assert on == off
    assert eng.stats()["prefix_cache"]["evictions"] > 0, \
        "pool pressure never exercised eviction"


def test_cache_modes_and_restrictive_only(weights):
    """``prefix_cache=True`` raises where unsupported (restrictive_only),
    "auto" switches off there, None/False disable it, and a ready
    ``PrefixCache`` is used as is."""
    _, _, cfg, tp = weights
    with pytest.raises(ValueError, match="unsupported"):
        Engine(cfg, tp, EngineConfig(mode="restrictive_only",
                                     prefix_cache=True), device="cpu")
    eng = Engine(cfg, tp, EngineConfig(mode="restrictive_only"),
                 device="cpu")
    assert eng.prefix_cache is None
    assert eng.stats()["prefix_cache"]["enabled"] is False
    for off in (None, False):
        assert Engine(cfg, tp, EngineConfig(prefix_cache=off),
                      device="cpu").prefix_cache is None
    eng = Engine(cfg, tp, EngineConfig(), device="cpu")
    pc = tcore.PrefixCache(eng.manager, num_sets=3, assoc=2)
    eng2 = Engine(cfg, tp, EngineConfig(prefix_cache=pc), device="cpu")
    assert eng2.prefix_cache is pc


# ------------------------------------------------------- card vs CPU

@pytest.mark.gpu
@pytest.mark.parametrize("gather", ["exact", "paged"])
def test_gpu_engine_cache_matches_cpu(weights, gather):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    _, _, cfg, tp = weights
    runs = []
    for dev, p in (("cpu", tp), ("cuda", jax.tree.map(lambda t: t.cuda(),
                                                        tp))):
        eng = Engine(cfg, p, EngineConfig(prefix_gather=gather, **ENGINE),
                     device=dev)
        streams = _fanout(eng, Request, SamplingParams, cfg.vocab_size,
                          sampled=True)
        runs.append((streams, list(eng.admission_log),
                     dict(eng.manager.stats), eng.stats()["prefix_cache"]))
    assert runs[0] == runs[1]
    assert runs[1][3]["hits"] > 0
