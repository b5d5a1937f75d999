"""The port's launch tooling, held to the JAX package's: the perf variants,
the dry run's cell list and a tiny-mesh dry run on the ``meta`` device,
the serve CLI on the CPU, and the mesh train step on a batch whose rows do
not split over the data axis (JAX replicates it; one gloo group of two
processes at (2, 1)).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import repro.launch.perf_variants as jvariants
from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.dist.sharding import ShardingRules as JRules
from repro.models import FwdOptions as JFwd, model_dims as jdims
from repro.train import (TrainConfig as JTrainConfig,
                         init_state as jinit_state,
                         make_train_step as jmake_train_step)

import repro_torch.configs as configs
import repro_torch.launch.dryrun as dryrun
import repro_torch.launch.mesh as mesh_mod
import repro_torch.launch.perf_variants as variants
from repro_torch.configs import ARCHS, reduced
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist.sharding import ShardingRules
from repro_torch.models import FwdOptions, model_dims
from repro_torch.params import init_params, params_from_numpy
from repro_torch.train import (TrainConfig, make_train_step,
                               state_from_params)

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
SPAWN_TIMEOUT_S = 180
CLI_TIMEOUT_S = 120


# ------------------------------------------------------- perf variants

RAISE = {"gather_once", "gather_once_no_zero", "gather_once_triangular",
         "nosp_mb8", "nosp_mb8_triangular", "nosp_mb16"}


@pytest.mark.parametrize("name", variants.NAMES)
def test_perf_variant_matches_jax(name):
    assert len(variants.NAMES) == 25
    cfg, jcfg = ARCHS["granite-8b"], JARCHS["granite-8b"]
    rules, jrules = ShardingRules(), JRules()
    if name in RAISE:
        with pytest.raises(TypeError):
            jvariants.apply(name, jcfg, jrules, None, False)
        with pytest.raises(TypeError):
            variants.apply(name, cfg, rules, None, False)
        return
    c, r, f = variants.apply(name, cfg, rules, None, False)
    jc, jr, jf = jvariants.apply(name, jcfg, jrules, None, False)
    assert f == jf
    assert dataclasses.asdict(r) == dataclasses.asdict(jr)
    for field in dataclasses.fields(jc):
        assert getattr(c, field.name) == getattr(jc, field.name), field.name


def test_unknown_perf_variant_raises():
    with pytest.raises(ValueError, match="unknown perf variant"):
        variants.apply("nope", ARCHS["granite-8b"], ShardingRules(), None,
                       False)


# ------------------------------------------------------------ the dry run

def _run(cmd, env=None, timeout=CLI_TIMEOUT_S, cwd=None):
    p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=timeout, cwd=cwd)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    return p.stdout


def _port_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    return env


def _jax_env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))


def test_dryrun_list_matches_jax():
    want = _run([sys.executable, "-m", "repro.launch.dryrun", "--list"],
                _jax_env())
    got = _run([sys.executable, "-m", "repro_torch.launch.dryrun",
                "--list"], _port_env(), cwd=SRC)
    assert got == want
    assert "RUN " in got and "SKIP" in got


def test_dryrun_refuses_save_hlo():
    with pytest.raises(SystemExit, match="no XLA HLO"):
        dryrun.main(["--arch", "granite-8b", "--shape", "train_4k",
                     "--save-hlo"])


TINY = {"data": 2, "model": 4}
TINY_B, TINY_S = 8, 64


@pytest.fixture
def tiny_mesh(monkeypatch):
    """The production mesh, the config and the shapes cut to a (2, 4)
    mesh, a 2-layer reduced granite-8b and 8 rows of 64 tokens, as the
    JAX package's tiny dry-run test cuts them."""
    small = dataclasses.replace(reduced(ARCHS["granite-8b"]), num_layers=2)
    monkeypatch.setattr(mesh_mod, "make_production_mesh",
                        lambda multi_pod=False: mesh_mod.MeshDesc(TINY))
    monkeypatch.setattr(configs, "get_config", lambda name: small)
    cells = {s.name: dataclasses.replace(s, seq_len=TINY_S,
                                         global_batch=TINY_B)
             for s in configs.SHAPES}
    monkeypatch.setattr(configs, "shape_cell", lambda n: cells[n])
    return small


def _param_bytes(cfg, dims):
    p = init_params(None, cfg, dims, dtype=torch.bfloat16, device="meta")
    return dryrun.storage_bytes(p), p


def test_tiny_dryrun_decode_counts_by_hand(tiny_mesh):
    cfg = tiny_mesh
    res = dryrun.run_cell("granite-8b", "decode_32k", False)
    assert res["ok"] and res["data_shards"] == 2 and res["tp"] == 4
    dims = model_dims(cfg, tp=4)
    G, TP = TINY["data"], TINY["model"]
    Bl = TINY_B // G
    d, H, KV, hd, ff = (cfg.d_model, dims.n_heads, dims.n_kv,
                        dims.head_dim, cfg.d_ff)
    from repro_torch.serve.decode import make_decode_spec
    spec = make_decode_spec(cfg, TINY_S, TINY_B, G)
    bs_loc = spec.block_size // TP
    # the matrix products of a decode step on the rank's Bl rows: per layer
    # q, k, v, o and the gated MLP, then the head; the paged read's own
    # count: every row's nblk blocks of bs_loc tokens
    per_layer = 2 * Bl * (d * H * hd + 2 * d * KV * hd + H * hd * d
                          + 3 * d * ff)
    mm = cfg.num_layers * per_layer + 2 * Bl * d * dims.vocab
    paged = cfg.num_layers * 4 * hd * H * Bl * spec.max_blocks_per_seq \
        * bs_loc
    assert res["flops_aten"] == mm
    assert res["flops_per_device"] == mm + paged
    assert res["kernels"]["paged_attention"]["calls"] == cfg.num_layers
    assert res["kernels"]["utopia_translate_step"]["calls"] == 1
    # the arguments: the whole parameters, the rank's state, the tokens
    pbytes, _ = _param_bytes(cfg, dims)
    L = cfg.num_layers
    pool = 2 * L * (spec.slots_per_group + 1) * bs_loc * KV * hd * 2
    tables = 4 * (spec.n_sets * spec.assoc + spec.n_sets
                  + Bl * spec.max_blocks_per_seq)
    rows = TINY_B * (4 + 4 + 4 + 4 + 16)         # ctx, 3 sampling, key
    assert res["memory"]["argument_bytes"] == \
        pbytes + pool + tables + rows + 4 * TINY_B
    assert res["memory"]["peak_bytes"] > res["memory"]["argument_bytes"]
    coll = res["collectives"]["bytes_by_kind"]
    assert coll["all_reduce"] > 0 and coll["all_gather"] > 0


def test_tiny_dryrun_train_and_prefill(tiny_mesh):
    cfg = tiny_mesh
    dims = model_dims(cfg, tp=4)
    tr = dryrun.run_cell("granite-8b", "train_4k", False)
    pf = dryrun.run_cell("granite-8b", "prefill_32k", False)
    Bl = TINY_B // TINY["data"]
    for res in (tr, pf):
        assert res["ok"] and res["flops_per_device"] > 0
        assert res["memory"]["peak_bytes"] > res["memory"]["argument_bytes"]
    # train: every rank draws the global batch (tokens, labels) and holds
    # its blocks of the parameters and AdamW's two moments (float32 m, v
    # in bf16 here: the state's dtype), one storage each
    from repro_torch.train import abstract_state, state_shardings
    from repro_torch.dist.sharding import shard_tree
    tc = TrainConfig(dtype=torch.bfloat16)
    state = shard_tree(abstract_state(cfg, dims, tc, torch.bfloat16),
                       state_shardings(abstract_state(
                           cfg, dims, tc, torch.bfloat16),
                           mesh_mod.MeshDesc(TINY), ShardingRules()),
                       mesh_mod.MeshDesc(TINY))
    want = dryrun.storage_bytes(state) + 2 * 4 * TINY_B * TINY_S
    assert tr["memory"]["argument_bytes"] == want
    # the forward's matrix products alone, on the rank's rows, are at
    # least 2 * params * tokens; the backward doubles them
    n_mat = cfg.num_layers * (cfg.d_model * dims.n_heads * dims.head_dim
                              * 2 + 2 * cfg.d_model * dims.n_kv
                              * dims.head_dim + 3 * cfg.d_model * cfg.d_ff)
    assert tr["flops_per_device"] >= 6 * n_mat * Bl * TINY_S
    assert pf["flops_per_device"] >= 2 * n_mat * Bl * TINY_S


@pytest.mark.parametrize("shape,variant", [
    ("train_4k", "megatron"), ("train_4k", "no_zero"),
    ("decode_32k", "kv_int8"), ("prefill_32k", "baseline")])
def test_tiny_dryrun_multipod_cells(tiny_mesh, monkeypatch, shape, variant):
    """Cells on a (2, 2, 2) mesh with axes ``pod, data, model``: the data
    axes act as one group of 4, and the step's collectives cross it."""
    monkeypatch.setattr(mesh_mod, "make_production_mesh",
                        lambda multi_pod=False: mesh_mod.MeshDesc(
                            {"pod": 2, "data": 2, "model": 2}))
    res = dryrun.run_cell("granite-8b", shape, True, variant)
    assert res["ok"] and res["data_shards"] == 4 and res["tp"] == 2
    assert res["mesh"] == "2x2x2" and res["flops_per_device"] > 0
    assert res["collectives"]["collective_bytes_per_device"] > 0
    assert res["memory"]["peak_bytes"] > res["memory"]["argument_bytes"]


# ------------------------------------------------------------ the serve CLI

def _cli_lines(out):
    """The CLI's lines without the times: the run line's counts, the
    translation and prefix-cache lines, and the per-request lines without
    their latencies."""
    lines = out.strip().splitlines()
    head = lines[0]
    counts = head.split(": ", 1)[1].split(" in ")[0]
    steps = re.search(r"\d+ engine steps, budget=\d+", head).group(0)
    rest = [ln.split(" latency=")[0] for ln in lines[1:]]
    return counts, steps, rest


def test_serve_cli_matches_jax():
    flags = ["--arch", "granite-8b", "--requests", "5", "--max-new", "6",
             "--prompt-blocks", "3", "--prefill-budget", "32"]
    want = _run([sys.executable, "-m", "repro.launch.serve", *flags],
                _jax_env())
    got = _run([sys.executable, "-m", "repro_torch.launch.serve", *flags,
                "--device", "cpu"], _port_env(), cwd=SRC)
    assert _cli_lines(got) == _cli_lines(want)
    assert "translation: rsw_hit_rate=" in got


# ------------------------------ a batch whose rows do not split (repair)

REPAIR_CHILD = textwrap.dedent("""
    import datetime, pickle, sys
    sys.path.insert(0, sys.argv[3])
    import torch, torch.distributed as dist
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.dist.sharding import ShardingRules, shard_tree
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import FwdOptions, model_dims
    from repro_torch.params import params_from_numpy
    from repro_torch.train import (TrainConfig, abstract_state,
                                   make_train_step, state_from_params,
                                   state_shardings)
    rank, root = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/rdv",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    with open(f"{root}/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    cfg = reduced(ARCHS["granite-8b"])
    dims = model_dims(cfg)
    mesh = make_local_mesh(2, 1)
    rules = ShardingRules()
    out = {}
    for key, case in inp["cases"].items():
        tc = TrainConfig(dtype=torch.float32, **case["tc"])
        specs = state_shardings(abstract_state(cfg, dims, tc,
                                               torch.float32), mesh, rules)
        state = shard_tree(state_from_params(
            params_from_numpy(inp["params"], "cpu"), cfg, tc), specs, mesh)
        step = make_train_step(cfg, dims, tc,
                               FwdOptions(dtype=torch.float32), mesh, rules,
                               specs=specs)
        losses = []
        for b in case["batches"]:
            state, m = step(state, {k: torch.as_tensor(v)
                                    for k, v in b.items()})
            losses.append(float(m["loss"]))
        out[key] = losses
    with open(f"{root}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
""")

REPAIR_TC = dict(lr=1e-3, warmup_steps=1, total_steps=10)
REPAIR_CASES = [(3, 1), (6, 2)]       # rows, microbatches: 3 rows each


@pytest.fixture(scope="module")
def repair_runs(tmp_path_factory):
    """The (2, 1) gloo group's losses for each case, JAX's one-device
    losses and the port's, computed here while the group runs."""
    root = tmp_path_factory.mktemp("repair")
    jcfg = jreduced(JARCHS["granite-8b"])
    cfg = reduced(ARCHS["granite-8b"])
    jtc0 = JTrainConfig(dtype=jnp.float32, **REPAIR_TC)
    jstate0 = jinit_state(jax.random.PRNGKey(0), jcfg, jdims(jcfg), jtc0)
    np_params = jax.tree.map(np.asarray, jstate0["params"])
    cases = {}
    for rows, mb in REPAIR_CASES:
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                      global_batch=rows, seed=3))
        cases[(rows, mb)] = {"tc": dict(REPAIR_TC, microbatches=mb),
                             "batches": [data.batch_at(i) for i in range(3)]}
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump({"params": np_params, "cases": cases}, f)
    procs = []
    for r in range(2):
        log = open(root / f"rank{r}.log", "w")
        procs.append((log, subprocess.Popen(
            [sys.executable, "-c", REPAIR_CHILD, str(r), str(root),
             str(SRC)], stdout=log, stderr=subprocess.STDOUT,
            env=_port_env())))
    want = {}
    try:
        for key, case in cases.items():
            jtc = JTrainConfig(dtype=jnp.float32, **case["tc"])
            jstate = jinit_state(jax.random.PRNGKey(0), jcfg, jdims(jcfg),
                                 jtc)
            jstep = jax.jit(jmake_train_step(jcfg, jdims(jcfg), jtc,
                                             JFwd(dtype=jnp.float32)))
            tc = TrainConfig(dtype=torch.float32, **case["tc"])
            state = state_from_params(params_from_numpy(np_params, "cpu"),
                                      cfg, tc)
            step = make_train_step(cfg, model_dims(cfg), tc,
                                   FwdOptions(dtype=torch.float32))
            jl, one = [], []
            for b in case["batches"]:
                jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                            for k, v in b.items()})
                jl.append(float(jm["loss"]))
                state, m = step(state, {k: torch.as_tensor(v)
                                        for k, v in b.items()})
                one.append(float(m["loss"]))
            want[key] = (jl, one)
        for _, p in procs:
            p.wait(timeout=SPAWN_TIMEOUT_S)
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    got = []
    for r in range(2):
        path = root / f"rank{r}.pkl"
        assert path.exists(), (root / f"rank{r}.log").read_text()[-4000:]
        with open(path, "rb") as f:
            got.append(pickle.load(f))
    return want, got


@pytest.mark.parametrize("rows,mb", REPAIR_CASES)
def test_mesh_train_replicates_rows_that_do_not_split(repair_runs, rows, mb):
    """A (2, 1) mesh trains a batch whose microbatch rows (3) do not split
    over its 2 data ranks: every rank takes the whole microbatch, as JAX's
    ``batch_spec`` replicates it.  The losses equal JAX's (2e-4) and the
    port's single device (1e-6)."""
    (jl, one), got = repair_runs[0][(rows, mb)], repair_runs[1]
    for losses in got:
        npt.assert_allclose(losses[(rows, mb)], jl, rtol=0, atol=2e-4)
        npt.assert_allclose(losses[(rows, mb)], one, rtol=0, atol=1e-6)
