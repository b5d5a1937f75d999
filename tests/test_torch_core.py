"""Port translation core (``repro_torch.core``) against the JAX package.

Integer results must match exactly: the hashes, the host manager's
tables, stats, pending copies and dirty sets after the same sequence of
operations, and the torch RestSeg walk against the jnp one.
"""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from repro.core import HybridConfig as JHybridConfig
from repro.core import HybridKVManager as JManager
from repro.core import hashes as jhashes
from repro.core import tar_sf as jtar_sf
from repro_torch.core import HybridConfig, HybridKVManager, REST, hashes
from repro_torch.core import tar_sf

torch.set_num_threads(2)

HASHES = ["modulo", "xor_fold", "prime_displacement", "mersenne",
          "multiplicative"]


@pytest.mark.parametrize("hash_name", HASHES)
@pytest.mark.parametrize("n_sets", [1, 4, 7, 96, 1000])
def test_hashes_match_jnp(hash_name, n_sets):
    rng = np.random.RandomState(n_sets)
    v = np.concatenate([np.arange(512), rng.randint(0, 2 ** 31 - 1, 512),
                        [2 ** 24, 2 ** 24 + 1, 2 ** 31 - 1]]).astype(np.int32)
    want = np.asarray(jhashes.get_hash(hash_name)(jnp.asarray(v), n_sets))
    got = hashes.get_hash(hash_name)(torch.from_numpy(v), n_sets).numpy()
    npt.assert_array_equal(got, want)
    # the host allocator calls the same functions on python ints
    for x in v[:40]:
        assert hashes.get_hash(hash_name)(int(x), n_sets) == want[
            list(v).index(x)]


def _snapshot(m):
    return {
        "tar": m.tar.copy(), "sf": m.sf.copy(),
        "flex": m.flex_table.copy(),
        "stats": dict(m.stats),
        "copies": m.take_pending_copies(),
        "dirty": tuple(a.tolist() for a in m.take_dirty()),
        "free": list(m.flex_free),
        "refcount": dict(m.slot_refcount),
    }


def _assert_same(jm, tm, where):
    a, b = _snapshot(jm), _snapshot(tm)
    for k in a:
        if isinstance(a[k], np.ndarray):
            npt.assert_array_equal(b[k], a[k], err_msg=f"{k} after {where}")
        else:
            assert b[k] == a[k], f"{k} differs after {where}"
    tm.check_invariants()


@pytest.mark.parametrize("hash_name", HASHES)
@pytest.mark.parametrize("mode", ["hybrid", "restrictive_only"])
def test_manager_same_ops_same_state(hash_name, mode):
    kw = dict(block_size=8, total_slots=48, restseg_fraction=0.5, assoc=4,
              max_seqs=6, max_blocks_per_seq=10, hash_name=hash_name,
              promote_freq_threshold=2, promote_cost_threshold=4, mode=mode)
    jm, tm = JManager(JHybridConfig(**kw)), HybridKVManager(
        HybridConfig(**kw))
    rng = np.random.RandomState(7)
    for sid in range(5):
        assert jm.register_sequence(sid) == tm.register_sequence(sid)
    for step in range(12):
        for sid in range(5):
            for b in rng.choice(10, size=rng.randint(1, 4), replace=False):
                ja = jm.allocate_block(sid, int(b))
                ta = tm.allocate_block(sid, int(b))
                assert (ja.seg, ja.slot) == (ta.seg, ta.slot)
        _assert_same(jm, tm, f"allocations of round {step}")
        # device telemetry for every mapped block, derived from the JAX
        # manager's own state and fed to both
        vpns = np.asarray(sorted(v for v, i in jm.blocks.items()
                                 if i.slot >= 0), np.int64)
        in_rest = np.asarray([jm.blocks[v].seg == REST for v in vpns])
        accesses = 1 + 1 + (~in_rest).astype(np.int32)
        jm.record_device_stats(vpns, in_rest, accesses)
        tm.record_device_stats(vpns, in_rest, accesses)
        assert jm.run_promotions() == tm.run_promotions()
        _assert_same(jm, tm, f"promotions of round {step}")
        sid = int(rng.randint(5))
        b = int(rng.randint(10))
        assert jm.free_block(sid, b) == tm.free_block(sid, b)
        _assert_same(jm, tm, f"free_block of round {step}")
        if step % 4 == 3:
            sid = int(rng.randint(5))
            jm.free_sequence(sid)
            tm.free_sequence(sid)
            assert jm.register_sequence(sid) == tm.register_sequence(sid)
            _assert_same(jm, tm, f"free_sequence of round {step}")
    assert jm.stats["rest_evictions"] > 0
    if mode == "hybrid":
        assert jm.stats["migrations_flex_to_rest"] > 0


def _populated(cls_cfg, cls_mgr, hash_name):
    m = cls_mgr(cls_cfg(total_slots=256, restseg_fraction=0.75, assoc=8,
                        max_seqs=16, max_blocks_per_seq=32,
                        hash_name=hash_name))
    for sid in range(6):
        m.register_sequence(sid)
        for b in range(20):
            m.allocate_block(sid, b)
    return m


@pytest.mark.parametrize("hash_name", HASHES)
def test_rsw_matches_jnp_on_populated_manager(hash_name):
    m = _populated(HybridConfig, HybridKVManager, hash_name)
    jm = _populated(JHybridConfig, JManager, hash_name)
    npt.assert_array_equal(m.tar, jm.tar)
    vpns = np.arange(16 * 32, dtype=np.int32)
    jst = jtar_sf.RestSegState(tar=jnp.asarray(m.tar), sf=jnp.asarray(m.sf),
                               meta=jnp.zeros_like(jnp.asarray(m.tar)))
    want = jtar_sf.rsw(jst, jnp.asarray(vpns), hash_name)
    ts = m.device_state("cpu")
    got = tar_sf.rsw(ts.rest, torch.from_numpy(vpns), hash_name)
    for f in want._fields:
        npt.assert_array_equal(getattr(got, f).numpy(),
                               np.asarray(getattr(want, f)), err_msg=f)
    assert got.hit.any() and not got.hit.all()


def test_rsw_large_tags_exact():
    """Tags (vpn+1) at and above 2^24 match exactly, and their near-miss
    neighbours do not (the case a float32 tag compare gets wrong)."""
    n_sets, assoc = 4, 4
    tar = np.zeros((n_sets, assoc), np.int32)
    big = [1 << 24, (1 << 24) + 6, (1 << 25) + 3, (1 << 26) + 9]
    for v in big:
        s = v % n_sets
        tar[s, int(np.nonzero(tar[s] == 0)[0][0])] = v + 1
    sf = (tar != 0).sum(axis=1).astype(np.int32)
    q = np.asarray(big + [v + 1 for v in big] + [v - 1 for v in big]
                   + [0, 7], np.int32)
    jst = jtar_sf.RestSegState(tar=jnp.asarray(tar), sf=jnp.asarray(sf),
                               meta=jnp.zeros_like(jnp.asarray(tar)))
    want = jtar_sf.rsw(jst, jnp.asarray(q), "modulo")
    st = tar_sf.RestSegState(tar=torch.from_numpy(tar),
                             sf=torch.from_numpy(sf),
                             meta=torch.zeros(n_sets, assoc, dtype=torch.int32))
    got = tar_sf.rsw(st, torch.from_numpy(q), "modulo")
    for f in want._fields:
        npt.assert_array_equal(getattr(got, f).numpy(),
                               np.asarray(getattr(want, f)), err_msg=f)
    n = len(big)
    assert got.hit[:n].all() and not got.hit[n:3 * n].any()
