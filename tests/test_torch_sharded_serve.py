"""The port's sharded serving (ROADMAP P15; DESIGN.md §sharded-serving).

Against the JAX package:

* ``Partition.phys`` equals JAX's on ``tests/test_sharded_serve.py``'s
  partition grid (three pool configurations at 1, 2 and 4 shards), and is
  a shard-contiguous bijection, the identity at one shard, and passes
  negative sentinels through;
* the RSW kernel's sharded step (its plain versions: each shard's
  ownership-masked contributions, summed in process as the all-reduce
  sums them, then the combine) equals JAX's ``translate_step`` on the
  same tables, every field, at 1, 2 and 4 shards, with out-of-range write
  probes; with a verify window of K + 1 = 5 it equals the port's
  unsharded step, and every write row is a row of the owning rank's chunk
  (the sink elsewhere).

Port against port, exactly: one spawn of a (1, 2) and one of a (2, 2)
gloo group (``tests/torch_mesh_cases.py``, file rendezvous, one thread a
rank, collective timeouts) run the JAX mesh tests' scenarios, and each
rank's streams equal ``mesh_shape=None``'s, run here: greedy and sampled,
spec decoding off and on, under chunked admission, preemption and resume,
crash and restore (in memory and from rank 0's files), the prefix cache
and the metrics logger; the per-shard sums equal the globals and
``check_invariants`` passes on every rank.  A steady step launches the
shard entry and the combine once each and makes one device-to-host copy;
a deadline is rank 0's decision; a mesh without a process group, or of
another size than the group, raises.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HybridConfig as JHybridConfig
from repro.core import HybridKVManager as JManager
from repro.core import SWAP as JSWAP
from repro.core.partition import Partition as JPartition
from repro.serve.decode import DecodeSpec as JDecodeSpec
from repro.serve.decode import translate_step as jtranslate_step
from repro_torch.core import HybridConfig
from repro_torch.core.partition import Partition
from repro_torch.kernels.utopia_rsw.ref import (combine_shard_ref,
                                                translate_shard_ref,
                                                translate_step_ref)
from repro_torch.launch.mesh import make_local_mesh

torch.set_num_threads(2)

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_mesh_cases as cases  # noqa: E402

MESHES = ((1, 2), (2, 2))
SPAWN_TIMEOUT_S = 240


# ------------------------------------------------------- partition math

def _hybrid_cfgs(mod):
    return [mod(total_slots=48, restseg_fraction=0.5, assoc=4, max_seqs=4,
                max_blocks_per_seq=8),
            mod(total_slots=16, restseg_fraction=0.5, assoc=8, max_seqs=4,
                max_blocks_per_seq=8),
            mod(total_slots=32, restseg_fraction=0.0, mode="flexible_only",
                max_seqs=4, max_blocks_per_seq=8)]


PARTS = [(i, m) for i in range(3) for m in (1, 2, 4)]


@pytest.mark.parametrize("i,m", PARTS)
def test_phys_matches_jax_and_is_a_bijection(i, m):
    """phys() equals JAX's on ints, numpy arrays and torch tensors, every
    logical slot lands in exactly one shard-local range, on the shard that
    owns it (the set's owner for RestSeg slots), and the per-shard
    geometry is JAX's."""
    part = Partition.for_hybrid(_hybrid_cfgs(HybridConfig)[i], m)
    jpart = JPartition.for_hybrid(_hybrid_cfgs(JHybridConfig)[i], m)
    for f in ("sets_per_shard", "n_sets_padded", "rest_per_shard",
              "flex_per_shard", "slots_per_shard", "pool_slots",
              "vpns_per_shard", "vpn_padded"):
        assert getattr(part, f) == getattr(jpart, f), f
    n = part.rest_slots + part.flex_slots
    sl = np.arange(-2, n)
    ph = part.phys(sl)
    np.testing.assert_array_equal(ph, jpart.phys(sl))
    np.testing.assert_array_equal(
        part.phys(torch.from_numpy(sl).to(torch.int32)).numpy(), ph)
    assert [int(part.phys(int(s))) for s in sl] == ph.tolist()
    ph = ph[2:]
    assert len(set(ph.tolist())) == n
    assert (ph >= 0).all() and (ph < part.pool_slots).all()
    owners = ph // part.slots_per_shard
    np.testing.assert_array_equal(owners, part.shard_of_slot(sl[2:]))
    if part.rest_slots:
        sets = sl[2:part.rest_slots + 2] // part.assoc
        np.testing.assert_array_equal(owners[:part.rest_slots],
                                      part.shard_of_set(sets))


def test_phys_identity_at_one_shard_and_sentinels_pass():
    cfg = HybridConfig(total_slots=48, restseg_fraction=0.5, assoc=4,
                       max_seqs=4, max_blocks_per_seq=8)
    sl = np.arange(cfg.total_slots)
    np.testing.assert_array_equal(Partition.for_hybrid(cfg, 1).phys(sl), sl)
    ph = Partition.for_hybrid(cfg, 2).phys(np.asarray([-1, 0, -1, 5]))
    assert (ph[[0, 2]] == -1).all() and (ph[[1, 3]] >= 0).all()


def test_mesh_too_big_raises_clear_error():
    """Without a process group (this test process has none) a mesh
    raises, naming the recipe, and so does an engine asked for one."""
    from repro_torch.serve import Engine, EngineConfig
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="init_process_group"):
        make_local_mesh(data=64, model=64)
    cfg, params = cases.model()
    with pytest.raises(ValueError, match="init_process_group"):
        Engine(cfg, params, EngineConfig(mesh_shape=(1, 2)), device="cpu")
    with pytest.raises(ValueError, match="mesh_shape"):
        EngineConfig(mesh_shape=(1, 0)).check_ported()


# ------------------------------------------- the sharded step vs JAX's

def _tables(hash_name):
    """A random alloc / share / promote table state of the JAX manager
    (tests/test_sharded_serve.py's recipe)."""
    hcfg = JHybridConfig(total_slots=48, restseg_fraction=0.5, assoc=4,
                         max_seqs=4, max_blocks_per_seq=8,
                         promote_freq_threshold=2, promote_cost_threshold=4,
                         hash_name=hash_name)
    m = JManager(hcfg)
    rng = np.random.RandomState(0)
    live = []
    for _ in range(80):
        op = rng.randint(6)
        if op == 0 and len(live) < hcfg.max_seqs:
            sid = int(rng.randint(1000))
            if sid not in live:
                m.register_sequence(sid)
                live.append(sid)
        elif op in (1, 2) and live:
            m.allocate_block(live[rng.randint(len(live))],
                             int(rng.randint(hcfg.max_blocks_per_seq)))
        elif op == 3 and len(live) >= 2:
            s, d = rng.choice(len(live), 2, replace=False)
            m.share_prefix(live[s], live[d], 1 + int(rng.randint(3)))
        elif op == 5 and m.blocks:
            vpns = np.array([v for v, i in m.blocks.items()
                             if i.seg != JSWAP], np.int64)
            if vpns.size:
                m.record_device_stats(vpns, rng.rand(vpns.size) < 0.5,
                                      np.full(vpns.size, 3))
                m.run_promotions()
        m.take_pending_copies()
    return hcfg, m, rng


def _shard_slices(m, part):
    """Each shard's (tar_l, sf_l, flex_l) of the padded mirrors, torch."""
    tar = np.zeros((part.n_sets_padded,) + m.tar.shape[1:], np.int32)
    tar[:m.tar.shape[0]] = m.tar
    sf = np.zeros(part.n_sets_padded, np.int32)
    sf[:m.sf.shape[0]] = m.sf
    flat = m.flex_table.reshape(-1)
    flex = np.full(part.vpn_padded, -1, np.int32)
    flex[:flat.size] = flat
    spm, vpm = part.sets_per_shard, part.vpns_per_shard
    return [tuple(torch.from_numpy(np.ascontiguousarray(a[None]))
                  for a in (tar[i * spm:(i + 1) * spm],
                            sf[i * spm:(i + 1) * spm],
                            flex[i * vpm:(i + 1) * vpm]))
            for i in range(part.n_shards)]


def _sharded_step(m, hcfg, M, ctx, active=None, window=1):
    """Every rank's translation from the plain shard entry, the sum of
    the contributions (the all-reduce) and the combine."""
    part = Partition.for_hybrid(hcfg, M)     # reads the geometry only
    geom = dict(nblk=hcfg.max_blocks_per_seq, hash_name=hcfg.hash_name,
                part=part)
    B = ctx.shape[0]
    slices = _shard_slices(m, part)
    sums = sum(translate_shard_ref(*sl, batch=B, m=i, **geom)
               for i, sl in enumerate(slices))
    return part, [combine_shard_ref(sums, ctx, active, m=i, window=window,
                                    block_size=hcfg.block_size, **geom)
                  for i in range(M)]


@pytest.mark.parametrize("hash_name", ["modulo", "xor_fold"])
@pytest.mark.parametrize("M", [1, 2, 4])
def test_shard_entry_matches_jax_translate_step(M, hash_name):
    """Summed shard contributions + the combine equal JAX's
    ``translate_step`` on the unsharded tables, every field, on every
    rank, for positions that include an out-of-range write probe."""
    hcfg, m, rng = _tables(hash_name)
    B, bs, nblk = hcfg.max_seqs, hcfg.block_size, hcfg.max_blocks_per_seq
    pos = np.r_[rng.randint(0, nblk * bs, B - 1), nblk * bs + 3]
    spec = JDecodeSpec(block_size=bs, max_blocks_per_seq=nblk,
                       slots_per_group=hcfg.total_slots, n_sets=hcfg.num_sets,
                       assoc=hcfg.assoc, hash_name=hash_name)
    ref = jtranslate_step(jnp.asarray(m.tar)[None], jnp.asarray(m.sf)[None],
                          jnp.asarray(m.flex_table.reshape(-1))[None],
                          jnp.asarray(pos, jnp.int32), spec)
    part, got = _sharded_step(m, hcfg, M,
                              torch.from_numpy(pos.astype(np.int32)))
    cps = part.slots_per_shard
    assert np.asarray(ref.mapped).any() and np.asarray(ref.in_rest).any()
    for i, t in enumerate(got):
        for f in ("slots", "w_slot", "w_valid", "in_rest", "mapped",
                  "accesses", "vpns"):
            np.testing.assert_array_equal(
                getattr(t, f).numpy().astype(np.int64),
                np.asarray(getattr(ref, f)).astype(np.int64), err_msg=f)
        np.testing.assert_array_equal(t.extent.numpy(), pos + 1)
        ws, wv = t.w_slot.numpy()[0], t.w_valid.numpy()[0].astype(bool)
        ph = part.phys(ws)
        own = wv & (ph // cps == i)
        np.testing.assert_array_equal(
            t.w_row.numpy(), np.where(own, ph - i * cps, cps) * bs + pos % bs)


@pytest.mark.parametrize("M", [2, 4])
def test_shard_entry_verify_window(M):
    """With the verify step's window of K + 1 = 5 positions (windows that
    cross into a mapped and an unmapped block, run past the last block and
    the vpn range, and an inactive row) every rank's translation equals the
    port's unsharded step field for field, its write rows excepted, which
    are rows of the owning rank's chunk (the sink elsewhere)."""
    hcfg, m, rng = _tables("modulo")
    B, bs, nblk = hcfg.max_seqs, hcfg.block_size, hcfg.max_blocks_per_seq
    pos = torch.tensor([bs - 2, 3 * bs - 1, nblk * bs - 2, nblk * bs + 1],
                       dtype=torch.int32)[:B]
    active = torch.tensor([True, True, False, True])[:B]
    tables = [torch.from_numpy(np.ascontiguousarray(a))[None]
              for a in (m.tar, m.sf, m.flex_table.reshape(-1))]
    ref = translate_step_ref(*tables, pos, active, block_size=bs, nblk=nblk,
                             hash_name="modulo", sink=hcfg.total_slots,
                             window=5)
    part, got = _sharded_step(m, hcfg, M, pos, active, window=5)
    cps = part.slots_per_shard
    p = (pos[:, None] + torch.arange(5)).numpy()
    for i, t in enumerate(got):
        for f in ("slots", "w_slot", "w_valid", "in_rest", "mapped",
                  "accesses", "extent", "telemetry"):
            assert torch.equal(getattr(t, f), getattr(ref, f)), f
        ph = part.phys(t.w_slot.numpy()[0])
        own = t.w_valid.numpy()[0].astype(bool) & (ph // cps == i)
        np.testing.assert_array_equal(
            t.w_row.numpy(), np.where(own, ph - i * cps, cps) * bs + p % bs)
    assert any(t.w_valid.any() for t in got)


# -------------------------------------------- the spawned gloo groups

@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Start both groups' ranks at once, compute the single-device oracles
    here while they run, then collect every rank's results."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs, dirs = [], {}
    for data, model in MESHES:
        d = dirs[(data, model)] = tmp_path_factory.mktemp(
            f"mesh{data}x{model}")
        world = data * model
        for r in range(world):
            log = open(d / f"rank{r}.log", "w")
            procs.append((log, subprocess.Popen(
                [sys.executable, str(HERE / "torch_mesh_cases.py"), str(r),
                 str(world), f"{data},{model}", str(d)],
                stdout=log, stderr=subprocess.STDOUT, env=env)))
    try:
        cfg, params = cases.model()
        oracle = {name: cases.run(name, cfg, params, None)
                  for name in cases.SCENARIOS}
        for _, p in procs:
            p.wait(timeout=SPAWN_TIMEOUT_S)
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    runs = {}
    for (data, model), d in dirs.items():
        got = []
        for r in range(data * model):
            path = d / f"rank{r}.pkl"
            if not path.exists():
                got.append({"error": (d / f"rank{r}.log").read_text()[-4000:]})
                continue
            with open(path, "rb") as f:
                got.append(pickle.load(f))
        runs[(data, model)] = got
    return oracle, runs


def _ranks(mesh_runs, mesh, name):
    oracle, runs = mesh_runs
    for r, res in enumerate(runs[mesh]):
        assert "error" not in res, f"rank {r} of {mesh}: {res['error']}"
    return oracle[name], [res[name] for res in runs[mesh]]


CASES = [(name, mesh) for name in cases.SCENARIOS for mesh in MESHES]


@pytest.mark.parametrize("name,mesh", CASES,
                         ids=[f"{n}-{d}x{m}" for n, (d, m) in CASES])
def test_sharded_serving(mesh_runs, name, mesh):
    want, got = _ranks(mesh_runs, mesh, name)
    M = mesh[1]
    for r, g in enumerate(got):
        if "streams" in want:
            assert g["streams"] == want["streams"], r
        if name.startswith("streams"):
            assert all(len(v) == 10 for v in want["streams"].values())
            assert g["n_shards"] == M
            for k, (tot, glob) in g["sums"].items():
                assert tot == glob, (r, k)
            assert g["globals"] == want["globals"], r
        elif name == "overload":
            ov = g["overload"]
            assert ov["preempted_seqs"] > 0, "tier never exercised"
            assert ov["swap_bytes_in"] == ov["swap_bytes_out"] > 0
            for k, (tot, glob) in g["sums"].items():
                assert tot == glob, (r, k)
        elif name == "translate-once":
            for steps in (g["plain"], g["spec"]):
                for s in steps:
                    assert s == dict(shard=1, combine=1, cpu=1, produced=2)
        elif name == "crash-restore":
            for key, outs in g["replays"].items():
                assert outs == want["streams"], (r, key)
            assert g["fresh"] == want["streams"], r
        elif name == "persisted-restore":
            assert g["saves"] == (3 if r == 0 else 0), r
            assert g["step"] == 6
            assert g["tail"] and all(
                want["streams"][sid][-len(t):] == t
                for sid, t in g["tail"].items())
        elif name == "prefix-cache":
            assert g["hits"] > 0
        elif name == "metrics":
            assert g["writer"] == (r == 0)
            if r == 0:
                assert g["n_steps"] > 0 and g["all_have_shards"]
                assert g["out"][0] == g["out"][1] > 0
                assert g["into"][0] == g["into"][1] > 0
            else:
                assert g["n_steps"] == 0
        elif name == "deadline-lockstep":
            assert g["expired"] == want["expired"] == 0
        elif name == "mesh-size-mismatch":
            assert "needs" in g["error"] and "world size" in g["error"]


# ------------------------------------------------ the kernels on a card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("window", [1, 5])
def test_gpu_shard_entries_match_plain(cuda, M, window):
    """The RSW kernel's shard entry equals ``translate_shard_ref`` on
    every rank's slices, and the bound translation (shard entry, the sum,
    the combine entry) equals ``combine_shard_ref`` in every field, one
    launch of each entry a call."""
    from repro_torch.kernels.utopia_rsw.ops import (shard_translator,
                                                    utopia_translate_shard)
    from repro_torch.kernels.utopia_rsw.ref import StepTranslation
    hcfg, m, _ = _tables("modulo")
    B, bs, nblk = hcfg.max_seqs, hcfg.block_size, hcfg.max_blocks_per_seq
    part = Partition.for_hybrid(hcfg, M)
    pos = torch.tensor([bs - 2, 3 * bs - 1, nblk * bs - 2, nblk * bs + 1],
                       dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    geom = dict(batch=B, nblk=nblk, hash_name="modulo", part=part)
    slices = _shard_slices(m, part)
    total = sum(translate_shard_ref(*sl, m=i, **geom)
                for i, sl in enumerate(slices))
    for i, sl in enumerate(slices):
        dsl = [t.to(cuda) for t in sl]
        got = utopia_translate_shard(*dsl, m=i, **geom)
        assert torch.equal(got.cpu(), translate_shard_ref(*sl, m=i, **geom))
        n0 = (utopia_translate_shard.launches,
              utopia_translate_shard.launches_combine)
        fn = shard_translator(*dsl, pos.to(cuda), part=part, m=i,
                              reduce=lambda c: c.copy_(total.to(cuda)),
                              block_size=bs, nblk=nblk, hash_name="modulo",
                              window=window)
        t = fn(*dsl, pos.to(cuda), active.to(cuda))
        want = combine_shard_ref(total, pos, active, block_size=bs,
                                 nblk=nblk, hash_name="modulo", part=part,
                                 m=i, window=window)
        for f in StepTranslation._fields:
            assert torch.equal(getattr(t, f).cpu(), getattr(want, f)), f
        assert (utopia_translate_shard.launches - n0[0],
                utopia_translate_shard.launches_combine - n0[1]) == (1, 1)
