"""The port's translation structures and the paper's baselines
(``repro_torch.core``: ``tar_sf`` insert/remove, ``flex_table``, ``ech``,
``pom_tlb``, ``translate``) against the JAX package.

Every integer result must equal JAX's exactly: the RestSeg tables after
each functional update, the radix builder's levels, the cuckoo table's
keys, values, size, capacity and resizes, the POM-TLB's keys, values,
stamps and hit/miss counters, and every field of ``translate``,
``translate_radix``, ``translate_ech`` and ``translate_pom`` on the
translation benchmark's mapping and Zipf stream at all five hashes, vpns
past the table's end and below zero included.  On the CPU the plain walk
runs; the ``gpu`` tests hold the card's RSW kernel path to it.
"""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from repro import core as J
from repro_torch import core as T
from repro_torch.kernels.utopia_rsw.ops import utopia_rsw
from repro_torch.kernels.utopia_rsw.ref import rsw_ref, translate_step_ref

torch.set_num_threads(2)

HASHES = ["modulo", "xor_fold", "prime_displacement", "mersenne",
          "multiplicative"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, where=""):
    """Every field of two results (NamedTuples or tuples) equal, with the
    same dtype kind (bool stays bool)."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        name = getattr(want, "_fields", [str(j) for j in range(99)])[i]
        assert g.dtype.kind == w.dtype.kind, (where, name, g.dtype, w.dtype)
        npt.assert_array_equal(g, w, err_msg=f"{where}: {name}")


def _restseg_equal(ts, js, where):
    for f in ("tar", "sf", "meta"):
        npt.assert_array_equal(_np(getattr(ts, f)), _np(getattr(js, f)),
                               err_msg=f"{f} after {where}")


# ------------------------------------------------------------- TAR / SF

@pytest.mark.parametrize("hash_name", HASHES)
def test_insert_rsw_remove(hash_name):
    """``test_core.py::test_insert_rsw_remove``'s steps and more (an
    overwritten way, a removal that misses), with the tables after every
    functional update and the RSW of every touched vpn equal to JAX's."""
    ts, js = T.init_restseg(8, 2, device="cpu"), J.init_restseg(8, 2)
    ops = [("insert", 5, 0), ("insert", 13, 1), ("insert", 21, 1),
           ("insert", 2, 0), ("remove", 5), ("remove", 99), ("insert", 7, 1),
           ("remove", 13), ("remove", 21)]
    q = np.asarray([5, 13, 21, 2, 7, 99, 0], np.int32)
    for op in ops:
        if op[0] == "insert":
            ts2 = T.insert(ts, op[1], op[2], hash_name)
            js = J.insert(js, op[1], op[2], hash_name)
        else:
            ts2 = T.remove(ts, op[1], hash_name)
            js = J.remove(js, op[1], hash_name)
        assert ts2 is not ts
        ts = ts2
        _restseg_equal(ts, js, op)
        _same(T.rsw(ts, torch.from_numpy(q), hash_name),
              J.rsw(js, jnp.asarray(q), hash_name), op)
    if hash_name == "modulo":
        st = T.init_restseg(8, 2, device="cpu")
        st = T.insert(st, 5, 0)
        st = T.insert(st, 13, 1)     # 13 % 8 == 5: same set, way 1
        res = T.rsw(st, torch.tensor([5, 13, 21], dtype=torch.int32))
        assert res.hit.tolist() == [True, True, False]
        assert res.slot[:2].tolist() == [10, 11] and int(st.sf[5]) == 2
        res = T.rsw(T.remove(st, 5), torch.tensor([5, 13],
                                                  dtype=torch.int32))
        assert res.hit.tolist() == [False, True]


def test_sf_skips_empty_sets():
    st = T.init_restseg(8, 2, device="cpu")
    res = T.rsw(st, torch.arange(8, dtype=torch.int32))
    assert bool(res.sf_skipped.all()) and int(res.tar_touched.sum()) == 0
    _same(res, J.rsw(J.init_restseg(8, 2), jnp.arange(8, dtype=jnp.int32)))


@pytest.mark.parametrize("n_sets,assoc,bits", [(8, 2, 32), (576, 8, 32),
                                               (1, 16, 20)])
def test_structure_bytes(n_sets, assoc, bits):
    """The Fig. 13 accounting of the packed TAR and SF."""
    got = T.structure_bytes(T.init_restseg(n_sets, assoc, device="cpu"),
                            bits)
    assert got == J.tar_sf.structure_bytes(J.init_restseg(n_sets, assoc),
                                           bits)


# ------------------------------------------------------------ baselines

OUT_OF_RANGE = [1 << 30, (1 << 31) - 1, -1, -2, -(1 << 31), -100000]


@pytest.mark.parametrize("levels,fanout", [(4, 8), (4, 16), (3, 5)])
def test_radix_walk(levels, fanout):
    """``test_core.py::test_radix_walk`` and unmaps: the builder's levels
    after each map and unmap, and the walk over mapped, unmapped,
    aliased and negative vpns, equal to JAX's."""
    tb = T.RadixBuilder(num_levels=levels, fanout=fanout)
    jb = J.RadixBuilder(num_levels=levels, fanout=fanout)
    pairs = [(i * 37 % 4000, i) for i in range(200)]
    for k, (vpn, slot) in enumerate(pairs):
        tb.map(vpn, slot)
        jb.map(vpn, slot)
        if k % 50 == 0:
            tb.unmap(pairs[k // 2][0])
            jb.unmap(pairs[k // 2][0])
    for vpn in (pairs[3][0], 3999, 12345):       # mapped, absent, no node
        tb.unmap(vpn)
        jb.unmap(vpn)
    assert len(tb.levels) == len(jb.levels)
    for a, b in zip(tb.levels, jb.levels):
        npt.assert_array_equal(a, b)
    assert tb.table_bytes() == jb.table_bytes()
    q = np.asarray([p[0] for p in pairs] + list(range(0, 5000, 7))
                   + OUT_OF_RANGE, np.int32)
    got = tb.device_table("cpu").walk(torch.from_numpy(q))
    _same(got, jb.device_table().walk(jnp.asarray(q)))
    slot, ok, acc = got
    assert int(acc[4]) == levels              # one serial access a level
    if fanout ** levels > 4000:               # no vpn aliases another
        assert int(slot[4]) == dict(pairs)[pairs[4][0]] and bool(ok[4])


def test_ech_insert_lookup_resize():
    """``test_core.py::test_ech_insert_lookup_resize`` with the host table
    (keys, values, size, capacity, resizes) equal to JAX's after every
    insert, update and removal, and the probe over present, removed and
    negative vpns."""
    t = T.ElasticCuckooTable(capacity=16, n_tables=4)
    j = J.ElasticCuckooTable(capacity=16, n_tables=4)

    def same(where):
        npt.assert_array_equal(t.keys, j.keys, err_msg=f"keys {where}")
        npt.assert_array_equal(t.values, j.values, err_msg=f"vals {where}")
        assert (t.size, t.capacity, t.resizes) == (
            j.size, j.capacity, j.resizes), where

    for vpn in range(100):
        t.insert(vpn, vpn * 2)
        j.insert(vpn, vpn * 2)
        same(vpn)
    assert t.resizes >= 1
    for vpn in (3, 50, 99):
        t.insert(vpn, 7)                      # update in place
        j.insert(vpn, 7)
    for vpn in (10, 11, 500):
        t.remove(vpn)
        j.remove(vpn)
    same("updates and removals")
    for vpn in (3, 10, 64, 500):
        assert t.lookup_host(vpn) == j.lookup_host(vpn)
    assert t.table_bytes() == j.table_bytes()
    q = np.asarray(list(range(120)) + OUT_OF_RANGE, np.int32)
    got = t.device_state("cpu").lookup(torch.from_numpy(q))
    _same(got, j.device_state().lookup(jnp.asarray(q)))
    slot, hit, acc = got
    assert bool(hit[:10].all()) and not bool(hit[10]) and int(acc[0]) == 4


def test_pom_tlb_hit_path():
    """``test_core.py::test_pom_tlb_hit_path`` with evictions and an
    invalidation: keys, values, stamps and counters equal to JAX's, and
    the device probe."""
    t, j = T.POMTLB(entries=64, ways=4), J.POMTLB(entries=64, ways=4)
    rng = np.random.RandomState(3)
    seq = list(range(32)) + [5] + list(rng.randint(0, 200, 300))
    for vpn in seq:
        assert t.lookup_fill(int(vpn), int(vpn) + 100) == j.lookup_fill(
            int(vpn), int(vpn) + 100)
    for vpn in (5, 6, 1000):
        t.invalidate(vpn)
        j.invalidate(vpn)
    for a, b in ((t.keys, j.keys), (t.values, j.values),
                 (t.stamp, j.stamp)):
        npt.assert_array_equal(a, b)
    assert (t.hits, t.misses, t.table_bytes()) == (j.hits, j.misses,
                                                   j.table_bytes())
    q = np.asarray(list(range(250)) + OUT_OF_RANGE, np.int32)
    _same(t.device_state("cpu").lookup(torch.from_numpy(q)),
          j.device_state().lookup(jnp.asarray(q)))
    p = T.POMTLB(entries=64, ways=4)
    for vpn in range(32):
        p.lookup_fill(vpn, vpn + 100)
    slot, hit, acc = p.device_state("cpu").lookup(
        torch.arange(32, dtype=torch.int32))
    assert bool(hit.all()) and p.misses == 32 and p.hits == 0
    assert slot.tolist() == list(range(100, 132)) and int(acc[0]) == 1


# ------------------------------------------------- translate, all paths

def _make_manager(pkg, **kw):
    cfg = pkg.HybridConfig(total_slots=128, restseg_fraction=0.75, assoc=4,
                           max_seqs=8, max_blocks_per_seq=32, **kw)
    return pkg.HybridKVManager(cfg)


@pytest.mark.parametrize("hash_name", HASHES)
def test_device_host_agreement(hash_name):
    """``test_core.py::test_device_host_agreement``: ``translate`` of each
    mapped vpn gives the host's slot, and every field equals JAX's."""
    tm, jm = (_make_manager(p, hash_name=hash_name) for p in (T, J))
    for m in (tm, jm):
        for s in range(4):
            m.register_sequence(s)
            for b in range(20):
                m.allocate_block(s, b)
    ts, js = tm.device_state("cpu"), jm.device_state()
    assert ts._fields == js._fields
    assert ts.rest_base.dtype == torch.int32 and ts.rest_base.dim() == 0
    for s in range(4):
        for b in range(20):
            vpn = tm.cfg.vpn(tm.seq_slot(s), b)
            res = T.translate(ts, torch.tensor([vpn], dtype=torch.int32))
            assert int(res.slot[0]) == tm.lookup(s, b)[0]
    q = np.arange(8 * 32, dtype=np.int32)
    _same(T.translate(ts, torch.from_numpy(q)),
          J.translate(js, jnp.asarray(q)))


def zipf_block_stream(n_seqs, blocks_per_seq, n_accesses, a=1.2, seed=0):
    """The benchmark harness's (seq, block) Zipf stream recipe."""
    rng = np.random.Generator(np.random.Philox(seed))
    seqs = rng.integers(0, n_seqs, n_accesses)
    blocks = (rng.zipf(a, n_accesses) - 1) % blocks_per_seq
    return np.stack([seqs, blocks], axis=1)


def bench_setup(pkg, hash_name, n_seqs=8, blocks=28, seed=0):
    """``benchmarks/bench_translation.py:_setup`` in package ``pkg``: the
    manager, a 4-level radix tree, an ECH table and a small POM-TLB over
    the same mapping, the POM-TLB filled with the stream's first half."""
    cfg = pkg.HybridConfig(total_slots=512, restseg_fraction=0.75, assoc=8,
                           max_seqs=n_seqs, max_blocks_per_seq=32,
                           hash_name=hash_name)
    m = pkg.HybridKVManager(cfg)
    radix = pkg.RadixBuilder(num_levels=4, fanout=8)
    ech = pkg.ElasticCuckooTable(capacity=256)
    pom = pkg.POMTLB(entries=128, ways=8)
    for s in range(n_seqs):
        m.register_sequence(s)
        for b in range(blocks):
            info = m.allocate_block(s, b)
            vpn = cfg.vpn(m.seq_slot(s), b)
            radix.map(vpn, info.slot)
            ech.insert(vpn, info.slot)
    stream = zipf_block_stream(n_seqs, blocks, 4096, seed=seed)
    vpns = (stream[:, 0] * 32 + stream[:, 1]).astype(np.int32)
    for v in vpns[:2048]:
        pom.lookup_fill(int(v), m.blocks[int(v)].slot
                        if int(v) in m.blocks else -1)
    return m, radix, ech, pom, vpns


_SETUPS = {}


def _setups(hash_name):
    if hash_name not in _SETUPS:
        _SETUPS[hash_name] = (bench_setup(T, hash_name),
                              bench_setup(J, hash_name))
    return _SETUPS[hash_name]


def _queries(m, vpns):
    """The stream, then vpns past the flex table's end and below zero
    (the first rows' blocks reappear through the clamp and the wrap)."""
    V = m.cfg.max_seqs * m.cfg.max_blocks_per_seq
    extra = [V, V + 1, V + 77, -V, -V - 1, -V - 100, 0, 5, V - 1]
    return np.concatenate([vpns, np.asarray(extra + OUT_OF_RANGE, np.int32)])


BACKENDS = ["utopia", "radix", "radix_hybrid", "radix_hybrid_base5",
            "ech", "pom_tlb"]


def _backend(pkg, name, m, radix, ech, pom, device=None):
    """The named backend of package ``pkg`` as ``fn(vpns)``."""
    kw = {} if pkg is J else {"device": device}
    ts, rtab = m.device_state(**kw), radix.device_table(**kw)
    return {
        "utopia": lambda v: pkg.translate(ts, v),
        "radix": lambda v: pkg.translate_radix(None, rtab, v),
        "radix_hybrid": lambda v: pkg.translate_radix(
            ts.rest, rtab, v, ts.hash_name),
        "radix_hybrid_base5": lambda v: pkg.translate_radix(
            ts.rest, rtab, v, ts.hash_name, rest_base=5),
        "ech": lambda v: pkg.translate_ech(ech.device_state(**kw), v),
        "pom_tlb": lambda v: pkg.translate_pom(pom.device_state(**kw), rtab,
                                               v),
    }[name]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("hash_name", HASHES)
def test_translation_backends_match_jax(hash_name, backend):
    """Each backend on the benchmark's mapping and 4096-access Zipf
    stream, plus out-of-range vpns: every field equal to JAX's."""
    (tm, tr, te, tp, vpns), (jm, jr, je, jp, jv) = _setups(hash_name)
    npt.assert_array_equal(vpns, jv)
    for a, b in zip(tr.levels, jr.levels):
        npt.assert_array_equal(a, b)
    npt.assert_array_equal(te.keys, je.keys)
    npt.assert_array_equal(tp.keys, jp.keys)
    npt.assert_array_equal(tp.stamp, jp.stamp)
    assert (te.resizes, tp.hits, tp.misses) == (je.resizes, jp.hits,
                                                jp.misses)
    q = _queries(tm, vpns)
    got = _backend(T, backend, tm, tr, te, tp, "cpu")(torch.from_numpy(q))
    want = _backend(J, backend, jm, jr, je, jp)(jnp.asarray(q))
    _same(got, want, backend)
    assert got.slot.dtype == got.accesses.dtype == torch.int32
    assert got.bytes_touched.dtype == torch.int32
    # a 2-D query batch keeps its shape
    q2 = torch.from_numpy(q[:4096].reshape(64, 64))
    got2 = _backend(T, backend, tm, tr, te, tp, "cpu")(q2)
    assert got2.slot.shape == (64, 64)
    npt.assert_array_equal(got2.slot.reshape(-1).numpy(),
                           _np(want.slot)[:4096])


@pytest.mark.parametrize("hash_name", HASHES)
def test_rsw_ref_2d_flex_reads_as_translate(hash_name):
    """The kernel's plain version in its 2-D flex mode gives ``translate``'s
    slot, in_rest, mapped and accesses, out-of-range vpns included; in
    its flat mode (the decode step's) it agrees inside the table only."""
    (tm, *_, vpns), _ = _setups(hash_name)
    ts = tm.device_state("cpu")
    q = torch.from_numpy(_queries(tm, vpns))
    want = T.translate(ts, q)
    flex = ts.flex.table.reshape(-1)
    slot, in_rest, mapped, acc = rsw_ref(
        q, ts.rest.tar, ts.rest.sf, flex, hash_name=hash_name,
        max_blocks_per_seq=tm.cfg.max_blocks_per_seq)
    assert torch.equal(slot, want.slot)
    assert torch.equal(in_rest.bool(), want.in_rest)
    assert torch.equal(mapped.bool(), want.mapped)
    assert torch.equal(acc, want.accesses)
    # the CPU wrapper takes the same plain version
    got = utopia_rsw(q, ts.rest.tar, ts.rest.sf, flex, hash_name=hash_name,
                     max_blocks_per_seq=tm.cfg.max_blocks_per_seq)
    assert all(torch.equal(a, b) for a, b in zip(got, (slot, in_rest,
                                                        mapped, acc)))
    flat = rsw_ref(q, ts.rest.tar, ts.rest.sf, flex, hash_name=hash_name)
    n = vpns.size
    assert torch.equal(flat[0][:n], slot[:n])
    # past the end and below zero the two reads pick other entries: on a
    # table whose every entry differs, the slots differ
    distinct = torch.arange(flex.numel(), dtype=torch.int32)
    sf0 = torch.zeros_like(ts.rest.sf)
    kw = dict(hash_name=hash_name)
    two_d = rsw_ref(q, ts.rest.tar, sf0, distinct, **kw,
                    max_blocks_per_seq=tm.cfg.max_blocks_per_seq)[0]
    flat = rsw_ref(q, ts.rest.tar, sf0, distinct, **kw)[0]
    assert torch.equal(two_d[:n], flat[:n]) and torch.equal(two_d[:n], q[:n])
    assert (two_d[n:] != flat[n:]).sum() >= 5


def _random_workload(pkg, seed: int, n_ops: int = 80):
    """``tests/test_engine_hotpath.py``'s random alloc/free/share/promote
    history, in package ``pkg``."""
    rng = np.random.RandomState(seed)
    cfg = pkg.HybridConfig(total_slots=48, restseg_fraction=0.5, assoc=4,
                           max_seqs=4, max_blocks_per_seq=8,
                           promote_freq_threshold=2,
                           promote_cost_threshold=4)
    m = pkg.HybridKVManager(cfg)
    live = []
    for _ in range(n_ops):
        op = rng.randint(6)
        if op == 0 and len(live) < cfg.max_seqs:
            sid = int(rng.randint(1000))
            if sid not in live:
                m.register_sequence(sid)
                live.append(sid)
        elif op in (1, 2) and live:
            m.allocate_block(live[rng.randint(len(live))],
                             int(rng.randint(cfg.max_blocks_per_seq)))
        elif op == 3 and len(live) >= 2:
            src, dst = rng.choice(len(live), 2, replace=False)
            m.share_prefix(live[src], live[dst],
                           1 + int(rng.randint(3)))
        elif op == 4 and live and len(live) > 2 and rng.rand() < 0.3:
            sid = live.pop(rng.randint(len(live)))
            m.free_sequence(sid)
        elif op == 5 and m.blocks:
            vpns = np.array([v for v, i in m.blocks.items()
                             if i.seg != pkg.SWAP], np.int64)
            if vpns.size:
                m.record_device_stats(
                    vpns, rng.rand(vpns.size) < 0.5,
                    np.full(vpns.size, 3))
                m.run_promotions()
        m.check_invariants()
    return m


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_step_translation_matches_translate(seed):
    """The decode step's telemetry (``translate_step``'s plain version,
    what the engine feeds back to the manager) == ``core.translate`` on
    the same vpns (the port's counterpart of ``tests/test_engine_hotpath.py
    ::test_step_translation_matches_host_oracle``); and the port's
    ``translate`` equals JAX's there."""
    m, jm = _random_workload(T, seed), _random_workload(J, seed)
    npt.assert_array_equal(m.tar, jm.tar)
    npt.assert_array_equal(m.flex_table, jm.flex_table)
    cfg = m.cfg
    B, nblk, bs = cfg.max_seqs, cfg.max_blocks_per_seq, cfg.block_size
    ts = m.device_state("cpu")
    rng = np.random.RandomState(seed + 100)
    ctx = torch.from_numpy(rng.randint(0, nblk * bs, B).astype(np.int32))
    tr = translate_step_ref(
        torch.from_numpy(m.tar)[None], torch.from_numpy(m.sf)[None],
        torch.from_numpy(m.flex_table.reshape(1, -1)), ctx, block_size=bs,
        nblk=nblk, hash_name=cfg.hash_name, sink=cfg.total_slots)
    vpns = tr.vpns.reshape(-1)
    oracle = T.translate(ts, vpns)
    _same(oracle, J.translate(jm.device_state(), jnp.asarray(vpns.numpy())))
    assert torch.equal(tr.slots[0].reshape(-1), oracle.slot)
    assert torch.equal(tr.in_rest[0].reshape(-1).bool(), oracle.in_rest)
    assert torch.equal(tr.mapped[0].reshape(-1).bool(), oracle.mapped)
    assert torch.equal(tr.accesses[0].reshape(-1), oracle.accesses)
    # the write-slot lookup agrees with the oracle on the current blocks
    cur = torch.arange(B) * nblk + ctx // bs
    w = T.translate(ts, cur.to(torch.int32))
    assert torch.equal(tr.w_valid[0].bool(), w.mapped)
    assert torch.equal(tr.w_slot[0][w.mapped], w.slot[w.mapped])


def test_translate_rejects_mixed_devices():
    """The RSW wrapper's device check is translate's only one."""
    m = _make_manager(T)
    ts = m.device_state("cpu")
    with pytest.raises(ValueError, match="must be on one CUDA device"):
        T.translate(ts, torch.zeros(3, dtype=torch.int32, device="meta"))


# --------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("hash_name", HASHES)
def test_gpu_translate_paths_match_cpu(cuda, hash_name):
    """On the card ``translate`` launches the RSW kernel once a call, and
    every backend's outputs equal the CPU plain run's, out-of-range vpns
    included."""
    tm, tr, te, tp, vpns = _setups(hash_name)[0]
    q = torch.from_numpy(_queries(tm, vpns))
    for name in BACKENDS:
        want = _backend(T, name, tm, tr, te, tp, "cpu")(q)
        fn = _backend(T, name, tm, tr, te, tp, cuda)
        before = utopia_rsw.launches
        got = fn(q.to(cuda))
        torch.cuda.synchronize()
        launched = utopia_rsw.launches - before
        assert launched == (name in ("utopia", "radix_hybrid",
                                     "radix_hybrid_base5")), name
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), name


@pytest.mark.gpu
@pytest.mark.parametrize("hash_name", HASHES)
def test_gpu_rsw_kernel_2d_flex_mode(cuda, hash_name):
    """The vpn-list entry's 2-D flex mode against its plain version."""
    tm, *_, vpns = _setups(hash_name)[0]
    ts = tm.device_state("cpu")
    args = (torch.from_numpy(_queries(tm, vpns)), ts.rest.tar, ts.rest.sf,
            ts.flex.table.reshape(-1))
    kw = dict(hash_name=hash_name,
              max_blocks_per_seq=tm.cfg.max_blocks_per_seq)
    got = utopia_rsw(*(a.to(cuda) for a in args), **kw)
    for g, w in zip(got, rsw_ref(*args, **kw)):
        assert torch.equal(g.cpu(), w)
