"""The token-split layout of the port (the JAX package's ``kv_shards=0``
mesh path and its dry run's decode state), held to the JAX package.

* ``make_decode_spec``, ``abstract_decode_state`` and
  ``decode_state_shardings`` equal JAX's for every arch and shape cell, in
  batch and striped mode, on a (2, 4) mesh (JAX's ``AbstractMesh``: specs
  need no devices).
* The RSW step's group and token-owner plain version equals JAX's
  ``_translate_queries`` exactly at G in {1, 2, 4} and TP in {1, 2, 4}, and
  the kernel equals the plain version on a card.
* The token-split install equals JAX's ``_scatter_pool`` bitwise.
* At (2, 2), in float32: the decode step in batch and striped mode against
  JAX's step of the same layout (1e-4) and the port's ``mesh=None`` step
  (1e-5 of the largest logit), the integers exact; the recompute prefill
  and the steps after it against ``mesh=None``.  The port's ranks are one
  gloo group of four processes (``tests/torch_token_split_cases.py``); the
  JAX mesh runs in a subprocess with four host devices.
* Each rank holds and computes with its blocks of the weights: for
  granite, qwen3-moe, mamba2, jamba and whisper (reduced, ZeRO on and
  off) every leaf has its block's shape under JAX's ``param_shardings``,
  the ``ssm``/``conv`` rows theirs under JAX's ``decode_state_shardings``,
  and the prefill and decode logits lie within 1e-5 of ``mesh=None`` and
  1e-4 of JAX's token-split steps (of the largest |logit|), the integers
  exact.
* The dry run's argument bytes of a serving cell are the spec blocks' of
  the weights plus the state's and the batch's.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
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
from jax.sharding import AbstractMesh

import repro.serve.decode as jdecode
from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES
from repro.configs import reduced as jreduced
from repro.dist.sharding import (ShardingRules as JRules,
                                 param_shardings as jparam_shardings)
from repro.models import init_params as jinit, model_dims as jdims

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.kernels.utopia_rsw.ops import utopia_translate_step
from repro_torch.kernels.utopia_rsw.ref import translate_step_ref
from repro_torch.launch.mesh import MeshDesc
from repro_torch.models import model_dims
from repro_torch.serve.decode import (DecodeSpec, TokenSplit,
                                      abstract_decode_state,
                                      decode_state_shardings,
                                      local_decode_state, make_decode_spec)
from repro_torch.serve.prefill import _install_kv

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_token_split_cases as cases  # noqa: E402

SPAWN_TIMEOUT_S = 240
SPEC_MESH = {"data": 2, "model": 4}


# --------------------------------------- the dry run's spec and state

CELLS = [(a, s.name, mode) for a in sorted(ARCHS) for s in SHAPES
         for mode in ("batch", "striped")]


@pytest.mark.parametrize("arch,shape,mode", CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in CELLS])
def test_decode_spec_state_and_shardings_match_jax(arch, shape, mode):
    shp = next(s for s in SHAPES if s.name == shape)
    jshp = next(s for s in JSHAPES if s.name == shape)
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    seq = shp.seq_len + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    G, tp = SPEC_MESH["data"], SPEC_MESH["model"]
    spec = make_decode_spec(cfg, seq, shp.global_batch, G, mode=mode)
    jspec = jdecode.make_decode_spec(jcfg, seq, jshp.global_batch, G,
                                     mode=mode)
    for f in dataclasses.fields(spec):
        assert getattr(spec, f.name) == getattr(jspec, f.name), f.name
    st = abstract_decode_state(cfg, model_dims(cfg, tp=tp), spec,
                               shp.global_batch, G, torch.bfloat16)
    jst = jdecode.abstract_decode_state(jcfg, jdims(jcfg, tp=tp), jspec,
                                        jshp.global_batch, G, jnp.bfloat16)
    assert set(st) == set(jst)
    for k, v in st.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(jst[k].shape), k
        want = {"uint32": "int64"}.get(str(jst[k].dtype), str(jst[k].dtype))
        assert str(v.dtype) == f"torch.{want}", k
    sh = decode_state_shardings(st, SPEC_MESH, spec)
    jsh = jdecode.decode_state_shardings(
        jst, AbstractMesh((G, tp), ("data", "model")), jspec)
    assert {k: tuple(v) for k, v in sh.items()} == \
        {k: tuple(v.spec) for k, v in jsh.items()}


# --------------------------------------- the step's group translation

def _group_tables(G, n_sets, assoc, rows, nblk, rng):
    tar = np.zeros((G, n_sets, assoc), np.int32)
    sf = np.zeros((G, n_sets), np.int32)
    flex = -np.ones((G, rows * nblk), np.int32)
    for g in range(G):
        nxt = n_sets * assoc
        for v in range(rows * nblk):
            r = rng.rand()
            s = v % n_sets
            if r < 0.4 and sf[g, s] < assoc:
                tar[g, s, sf[g, s]] = v + 1
                sf[g, s] += 1
            elif r < 0.85:
                flex[g, v] = nxt
                nxt += 1
    return tar, sf, flex


LAYOUTS = [(G, TP, mode) for G in (1, 2, 4) for TP in (1, 2, 4)
           for mode in ("batch", "striped")]


@pytest.mark.parametrize("G,TP,mode", LAYOUTS,
                         ids=[f"G{g}-TP{t}-{m}" for g, t, m in LAYOUTS])
def test_group_translation_matches_jax(G, TP, mode):
    rng = np.random.RandomState(G * 10 + TP)
    bs, nblk, B, n_sets, assoc = 8, 5, 8, 4, 4
    rows = B // G if mode == "batch" else B
    tar, sf, flex = _group_tables(G, n_sets, assoc, rows, nblk, rng)
    # positions within, at the end of and past the vpn range
    pos = rng.randint(0, (G if mode == "striped" else 1) * nblk * bs + 12,
                      B).astype(np.int32)
    spec = jdecode.DecodeSpec(block_size=bs, max_blocks_per_seq=nblk,
                              slots_per_group=64, n_sets=n_sets,
                              assoc=assoc, mode=mode)
    want = jdecode.translate_step(jnp.asarray(tar), jnp.asarray(sf),
                                  jnp.asarray(flex), jnp.asarray(pos), spec)
    sink, bs_loc = 64, bs // TP
    for g in range(G):
        sel = slice(g * rows, (g + 1) * rows) if mode == "batch" \
            else slice(None)
        p = pos[sel]
        for m in range(TP):
            got = translate_step_ref(
                torch.as_tensor(tar[g:g + 1]), torch.as_tensor(sf[g:g + 1]),
                torch.as_tensor(flex[g:g + 1]), torch.as_tensor(p),
                block_size=bs, nblk=nblk, hash_name="modulo", sink=sink,
                layout=(G, g, mode == "striped", TP, m))
            for k in ("slots", "in_rest", "mapped", "accesses", "w_slot",
                      "w_valid"):
                npt.assert_array_equal(
                    getattr(got, k).numpy()[0],
                    np.asarray(getattr(want, k))[g].astype(np.int32), k)
            own = (np.asarray(want.w_valid)[g]
                   & ((p % bs) // bs_loc == m))
            npt.assert_array_equal(
                got.w_row.numpy(),
                np.where(own, np.asarray(want.w_slot)[g], sink) * bs_loc
                + (p % bs) % bs_loc)
            npt.assert_array_equal(got.extent.numpy(), p + 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("G,TP,mode", LAYOUTS,
                         ids=[f"G{g}-TP{t}-{m}" for g, t, m in LAYOUTS])
def test_gpu_group_translation_matches_plain(cuda, G, TP, mode):
    """The RSW step entry with the group layout equals its plain version
    bitwise, one launch a call."""
    rng = np.random.RandomState(G * 10 + TP)
    bs, nblk, B = 8, 5, 8
    rows = B // G if mode == "batch" else B
    tar, sf, flex = _group_tables(G, 4, 4, rows, nblk, rng)
    pos = torch.as_tensor(rng.randint(0, G * nblk * bs + 12, rows)
                          .astype(np.int32))
    for g in range(G):
        for m in range(TP):
            args = [torch.as_tensor(x[g:g + 1]) for x in (tar, sf, flex)]
            kw = dict(block_size=bs, nblk=nblk, hash_name="modulo", sink=64,
                      layout=(G, g, mode == "striped", TP, m))
            want = translate_step_ref(*args, pos, **kw)
            n0 = utopia_translate_step.launches
            got = utopia_translate_step(*[a.to(cuda) for a in args],
                                        pos.to(cuda), **kw)
            assert utopia_translate_step.launches == n0 + 1
            assert torch.equal(got.out.cpu(), want.out)


# ------------------------------------------- the spawned runs

JAX_CHILD = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import ARCHS, reduced
    from repro.models import model_dims
    from repro.serve.decode import DecodeSpec, make_serve_step
    from repro.serve.prefill import _scatter_pool

    root = sys.argv[1]
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    cfg = dataclasses.replace(reduced(ARCHS["granite-8b"]), num_layers=2)
    dims = model_dims(cfg, tp=1)
    params = jax.tree.map(jnp.asarray, inp["params"])
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for name, geo in inp["geometry"].items():
        sc = inp["scenarios"][name]
        spec = DecodeSpec(**geo["spec"])
        B = len(sc["ctx_len"])
        st = {k: jnp.asarray(sc[k]) for k in
              ("k_pool", "v_pool", "tar", "sf", "flex", "ctx_len")}
        for k, dt in (("samp_temp", jnp.float32), ("samp_topk", jnp.int32),
                      ("samp_topp", jnp.float32)):
            st[k] = jnp.zeros((B,), dt)
        st["samp_key"] = jnp.zeros((B, 2), jnp.uint32)
        step = jax.jit(make_serve_step(cfg, dims, spec, mesh=mesh,
                                       dtype=jnp.float32))
        steps = []
        with mesh:
            for i, act in enumerate(geo["actives"]):
                tok = jnp.asarray(sc["tokens"][i])
                if act is None:
                    logits, st, stats = step(params, st, tok)
                else:
                    logits, st, stats = step(params, st, tok,
                                             jnp.asarray(act))
                steps.append({"logits": np.asarray(logits),
                              **{k: np.asarray(v) for k, v in
                                 stats.items()}})
        out[name] = {"steps": steps, "k_pool": np.asarray(st["k_pool"]),
                     "v_pool": np.asarray(st["v_pool"]),
                     "ctx_len": np.asarray(st["ctx_len"])}
    from repro.models import FwdOptions
    from repro.serve.prefill import make_prefill_step
    for arch, fam in inp["families"].items():
        fcfg = dataclasses.replace(reduced(ARCHS[arch]), num_layers=2)
        fdims = model_dims(fcfg, tp=1)
        fp = jax.tree.map(jnp.asarray, fam["params"])
        spec = DecodeSpec(**fam["spec"])
        st = {k: jnp.asarray(v) for k, v in fam["state"].items()}
        fi = fam["inputs"]
        B = len(fi["ctx"])
        batch = {"tokens": jnp.asarray(fi["prompt"])}
        if fcfg.family in ("ssm", "hybrid"):
            batch["seq_len"] = jnp.asarray(fi["ctx"])
        if "frontend" in fi:
            batch["frontend"] = jnp.asarray(fi["frontend"])
        pre = jax.jit(make_prefill_step(
            fcfg, fdims, spec, mesh,
            fwd=FwdOptions(dtype=jnp.float32, moe_groups=2)))
        step = jax.jit(make_serve_step(fcfg, fdims, spec, mesh=mesh,
                                       dtype=jnp.float32))
        ctx = jnp.asarray(fi["ctx"])
        with mesh:
            last, st, stats = pre(fp, st, batch, jnp.asarray(fam["slots"]),
                                  jnp.arange(B, dtype=jnp.int32), ctx,
                                  ctx - 1)
            res = {"prefill": (np.asarray(last),
                               np.asarray(stats["next_token"])),
                   "steps": []}
            if "flex" in st:
                st["flex"] = jnp.asarray(fam["flex_after"])
            for i, act in enumerate(fam["actives"]):
                tok = jnp.asarray(fi["tokens"][i])
                if act is None:
                    logits, st, stats = step(fp, st, tok)
                else:
                    logits, st, stats = step(fp, st, tok, jnp.asarray(act))
                res["steps"].append({"logits": np.asarray(logits),
                                     **{k: np.asarray(v) for k, v in
                                        stats.items()}})
        out[arch] = res
    ins = inp["install"]
    spec = DecodeSpec(**ins["spec"])
    with mesh:
        out["install"] = np.asarray(jax.jit(
            lambda p, c, s: _scatter_pool(p, c, s, mesh, spec))(
                jnp.asarray(ins["pool"]), jnp.asarray(ins["cache"]),
                jnp.asarray(ins["slots"])))
    with open(os.path.join(root, "jax.pkl"), "wb") as f:
        pickle.dump(out, f)
    print("JAX_TOKEN_SPLIT_DONE")
""")


def _spec_fields(spec):
    return {f: getattr(spec, f) for f in (
        "block_size", "max_blocks_per_seq", "slots_per_group", "n_sets",
        "assoc", "mode")}


def _install_inputs(rng):
    cfg = cases.config()
    dims = model_dims(cfg, tp=1)
    L, bs, KV, hd = cfg.num_layers, cfg.kv_block_size, dims.n_kv, \
        dims.head_dim
    B, nblk, G = 4, 3, cases.MESH[0]
    slots = rng.randint(0, cases.SLOTS, (B, nblk)).astype(np.int32)
    for g in range(G):                # distinct slots within a group
        slots[g * 2:(g + 1) * 2] = rng.permutation(cases.SLOTS)[
            :2 * nblk].reshape(2, nblk)
    slots[1, 2] = slots[2, 0] = -1
    return dict(
        spec=dict(block_size=bs, max_blocks_per_seq=nblk,
                  slots_per_group=cases.SLOTS, n_sets=cases.N_SETS,
                  assoc=cases.ASSOC),
        pool=rng.randn(L, G * cases.SLOTS, bs, KV, hd).astype(np.float32),
        cache=rng.randn(L, B, nblk, bs, KV, hd).astype(np.float32),
        slots=slots)


def _jcfg(arch):
    return dataclasses.replace(jreduced(JARCHS[arch]), num_layers=2)


def _family_inputs(arch, rng):
    """A family's JAX weights, its scenario's inputs, and for the JAX
    child the whole state in the JAX layout, the prefill's slots and the
    flex table of the decode steps."""
    jcfg = _jcfg(arch)
    jparams = jinit(jax.random.PRNGKey(1), jcfg, jdims(jcfg, tp=1))
    spec, _, B, actives = cases.geometry("prefill")
    G = cases.MESH[0]
    jspec = jdecode.DecodeSpec(**_spec_fields(spec))
    state = {}
    for k, v in jdecode.abstract_decode_state(
            jcfg, jdims(jcfg, tp=1), jspec, B, G, jnp.float32).items():
        state[k] = np.full(v.shape, -1 if k == "flex" else 0, v.dtype)
    blocks, slots = cases.prefill_blocks()
    rows = B // G
    flex = -np.ones((G, rows * spec.max_blocks_per_seq), np.int32)
    for r in range(B):
        g, rl = divmod(r, rows)
        flex[g, rl * spec.max_blocks_per_seq:
             rl * spec.max_blocks_per_seq + blocks.shape[1]] = blocks[r]
    return {"params": jax.tree.map(np.asarray, jparams),
            "inputs": cases.draw_family_inputs(cases.config(arch), rng),
            "spec": _spec_fields(spec), "state": state, "slots": slots,
            "flex_after": flex, "actives": actives}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, the four gloo ranks and the JAX mesh run at once; the
    port's one-device runs here while they work."""
    root = tmp_path_factory.mktemp("token_split")
    jcfg = _jcfg("granite-8b")
    jparams = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg, tp=1))
    scen = cases.draw_inputs()
    geo = {}
    for name in ("batch", "striped"):
        spec, _, _, actives = cases.geometry(name)
        geo[name] = {"spec": _spec_fields(spec), "actives": actives}
    rng = np.random.RandomState(11)
    inputs = {"params": jax.tree.map(np.asarray, jparams),
              "scenarios": scen, "geometry": geo,
              "families": {a: _family_inputs(a, rng)
                           for a in cases.FAMILIES},
              "install": _install_inputs(np.random.RandomState(7))}
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    jenv = dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=str(HERE.parent / "src"))
    data, model = cases.MESH
    world = data * model
    procs = []
    for r in range(world):
        log = open(root / f"rank{r}.log", "w")
        procs.append((log, subprocess.Popen(
            [sys.executable, str(HERE / "torch_token_split_cases.py"),
             str(r), str(world), f"{data},{model}", str(root)],
            stdout=log, stderr=subprocess.STDOUT, env=env)))
    log = open(root / "jax.log", "w")
    procs.append((log, subprocess.Popen(
        [sys.executable, "-c", JAX_CHILD, str(root)], stdout=log,
        stderr=subprocess.STDOUT, env=jenv)))
    try:
        cases.load(root)
        oracle = {name: cases.run(name, None) for name in cases.SCENARIOS}
        for _, p in procs:
            p.wait(timeout=SPAWN_TIMEOUT_S)
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    ranks = []
    for r in range(world):
        path = root / f"rank{r}.pkl"
        got = {}
        if path.exists():
            with open(path, "rb") as f:
                got = pickle.load(f)
        if not got or any("error" in v for v in got.values()):
            got = {"error": (root / f"rank{r}.log").read_text()[-4000:]}
        ranks.append(got)
    jres = None
    if (root / "jax.pkl").exists():
        with open(root / "jax.pkl", "rb") as f:
            jres = pickle.load(f)
    return {"oracle": oracle, "ranks": ranks, "jax": jres, "inputs": inputs,
            "jax_log": (root / "jax.log").read_text()[-4000:]}


def _ranks(runs, name):
    for r, res in enumerate(runs["ranks"]):
        assert "error" not in res, f"rank {r}: {res['error']}"
    return [res[name] for res in runs["ranks"]]


def _jax(runs):
    assert runs["jax"] is not None, runs["jax_log"]
    return runs["jax"]


def test_install_matches_jax_scatter_pool_bitwise(runs):
    ins = runs["inputs"]["install"]
    want = torch.as_tensor(_jax(runs)["install"])
    spec = DecodeSpec(**ins["spec"])
    cache = torch.as_tensor(ins["cache"])
    L, B, nblk, bs = cache.shape[:4]
    data, model = cases.MESH
    for rank in range(data * model):
        mesh = MeshDesc({"data": data, "model": model}, rank)
        split = TokenSplit(spec, mesh)
        pools = local_decode_state({"k_pool": torch.as_tensor(ins["pool"]),
                                    "v_pool": torch.as_tensor(ins["pool"])},
                                   spec, mesh)
        rows = split.rows(B)
        c = cache[:, rows].reshape(L, rows.stop - rows.start, nblk * bs,
                                   *cache.shape[4:])
        _install_kv(spec, pools, {"k": c, "v": c},
                    torch.as_tensor(ins["slots"])[rows],
                    rows.stop - rows.start, split)
        cut = local_decode_state({"k_pool": want}, spec, mesh)["k_pool"]
        assert torch.equal(pools["k_pool"][:, :-1], cut[:, :-1])
        assert torch.equal(pools["v_pool"][:, :-1], cut[:, :-1])


def _whole_pool(ranks, key, spec):
    """The whole pool (JAX layout) from the four ranks' pools."""
    data, model = cases.MESH
    S = spec.slots_per_group
    bs_loc = spec.block_size // model
    parts = [ranks[r][key] for r in range(data * model)]
    L, _, _, KV, hd = parts[0].shape
    whole = np.zeros((L, data * S, spec.block_size, KV, hd), np.float32)
    for r, p in enumerate(parts):
        g, m = divmod(r, model)
        whole[:, g * S:(g + 1) * S, m * bs_loc:(m + 1) * bs_loc] = p
    return whole


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1.0)
    npt.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("name", ["batch", "striped"])
def test_token_split_step_matches_jax_and_one_device(runs, name):
    ranks = _ranks(runs, name)
    jres = _jax(runs)[name]
    one = runs["oracle"][name]
    spec = cases.geometry(name)[0]
    for i, jstep in enumerate(jres["steps"]):
        for r, res in enumerate(ranks):
            got = res["steps"][i]
            npt.assert_allclose(got["logits"], jstep["logits"], rtol=0,
                                atol=1e-4)
            _close(got["logits"], one["steps"][i]["logits"], 1e-5)
            npt.assert_array_equal(got["next_token"], jstep["next_token"])
            npt.assert_array_equal(got["next_token"],
                                   one["steps"][i]["next_token"])
            for k in ("slots", "in_rest", "mapped", "accesses"):
                npt.assert_array_equal(got[k],
                                       jstep[k].astype(np.int32), k)
    for r, res in enumerate(ranks):
        npt.assert_array_equal(res["ctx_len"], jres["ctx_len"])
    for key in ("k_pool", "v_pool"):
        whole = _whole_pool(ranks, key, spec)
        npt.assert_allclose(whole, jres[key], rtol=0, atol=1e-5)


def test_token_split_prefill_matches_one_device(runs):
    ranks = _ranks(runs, "prefill")
    one = runs["oracle"]["prefill"]
    spec = cases.geometry("prefill")[0]
    for res in ranks:
        _close(res["prefill"][0], one["prefill"][0], 1e-5)
        npt.assert_array_equal(res["prefill"][1], one["prefill"][1])
        npt.assert_array_equal(res["ctx_len"], one["ctx_len"])
        for i, step in enumerate(res["steps"]):
            _close(step["logits"], one["steps"][i]["logits"], 1e-5)
            npt.assert_array_equal(step["next_token"],
                                   one["steps"][i]["next_token"])
    # the mesh's group g slot s is the device's slot g * SLOTS + s
    whole = _whole_pool(ranks, "k_pool", spec)
    G, S = cases.MESH[0], cases.SLOTS
    npt.assert_allclose(whole, one["k_pool"][:, :G * S], rtol=0, atol=1e-5)


def test_token_split_refusals_match_jax():
    """The prefix-KV prefill and the verify step refuse a token-split mesh
    with the JAX package's messages; a state of several data groups needs
    a rank's mesh."""
    from repro_torch.serve.prefill import make_prefix_prefill_step
    from repro_torch.serve.spec_decode import make_spec_decode_step
    from repro_torch.serve.decode import init_decode_state
    cfg = cases.config()
    dims = model_dims(cfg, tp=1)
    spec = cases.geometry("batch")[0]
    mesh = MeshDesc({"data": 2, "model": 2}, 1)
    with pytest.raises(NotImplementedError, match="single-host"):
        make_prefix_prefill_step(cfg, dims, spec, mesh=mesh)
    with pytest.raises(NotImplementedError, match="single-host"):
        make_spec_decode_step(cfg, dims, spec, 4, mesh=mesh)
    with pytest.raises(ValueError, match="ranks of a mesh"):
        init_decode_state(cfg, dims, spec, 4, 2, device="cpu")
    st = init_decode_state(cfg, dims, spec, 4, 2, device="cpu", mesh=mesh)
    assert st["k_pool"].shape == (cfg.num_layers, cases.SLOTS + 1,
                                  spec.block_size // 2, dims.n_kv,
                                  dims.head_dim)
    assert st["flex"].shape == (1, 2 * spec.max_blocks_per_seq)
    assert bool((st["flex"] == -1).all())


# ------------------------------- the families, on the ranks' weight blocks

def _block_shape(shape, spec, sizes):
    out = []
    for n, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            n //= sizes[a]
        out.append(n)
    return tuple(out)


def _jax_param_blocks(arch, zero, sizes, dims_tp=1, dtype=jnp.float32):
    """{dotted path: shape} of a rank's block of each leaf of ``arch``'s
    reduced 2-layer JAX parameters under JAX's ``param_shardings``."""
    jcfg = _jcfg(arch)
    jd = jdims(jcfg, tp=dims_tp)
    abs_ = jax.eval_shape(lambda k: jinit(k, jcfg, jd, dtype=dtype),
                          jax.random.PRNGKey(0))
    mesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    sh = jparam_shardings(abs_, JRules(data_axes=("data",),
                                       zero_params=zero), mesh)
    leaves = jax.tree_util.tree_flatten_with_path(abs_)[0]
    specs = jax.tree_util.tree_leaves(sh)
    return {".".join(str(k.key) for k in path):
            _block_shape(leaf.shape, s.spec, sizes)
            for (path, leaf), s in zip(leaves, specs)}


@pytest.mark.parametrize("name", cases.FAMILY_SCENARIOS)
def test_token_split_family_matches_jax_and_one_device(runs, name):
    """Each rank holds its blocks of the weights and of the recurrent
    state (JAX's specs), and its prefill and decode steps give the logits
    of ``mesh=None`` (1e-5) and of JAX's token-split steps (1e-4), the
    tokens and translation fields exactly."""
    arch, zero = cases.family_of(name)
    ranks = _ranks(runs, name)
    one = runs["oracle"][name]
    jres = _jax(runs)[arch]
    data, model = cases.MESH
    sizes = {"data": data, "model": model}
    want_params = _jax_param_blocks(arch, zero, sizes)
    spec = cases.geometry("prefill")[0]
    jcfg = _jcfg(arch)
    B = len(runs["inputs"]["families"][arch]["inputs"]["ctx"])
    jspec = jdecode.DecodeSpec(**_spec_fields(spec))
    jst = jdecode.abstract_decode_state(jcfg, jdims(jcfg, tp=1), jspec, B,
                                        data, jnp.float32)
    jsh = jdecode.decode_state_shardings(
        jst, AbstractMesh((data, model), ("data", "model")), jspec)
    for r, res in enumerate(ranks):
        assert res["param_shapes"] == want_params, r
        _close(res["prefill"][0], one["prefill"][0], 1e-5)
        _close(res["prefill"][0], jres["prefill"][0], 1e-4)
        npt.assert_array_equal(res["prefill"][1], one["prefill"][1])
        npt.assert_array_equal(res["prefill"][1], jres["prefill"][1])
        for i, step in enumerate(res["steps"]):
            _close(step["logits"], one["steps"][i]["logits"], 1e-5)
            _close(step["logits"], jres["steps"][i]["logits"], 1e-4)
            npt.assert_array_equal(step["next_token"],
                                   one["steps"][i]["next_token"])
            npt.assert_array_equal(step["next_token"],
                                   jres["steps"][i]["next_token"])
            for k in ("slots", "in_rest", "mapped", "accesses"):
                if k in step:
                    npt.assert_array_equal(
                        step[k], jres["steps"][i][k].astype(np.int32), k)
        npt.assert_array_equal(res["ctx_len"], one["ctx_len"])
        mesh = MeshDesc(sizes, r)
        for k in ("ssm", "conv"):
            if k not in one:
                continue
            assert res[k].shape == _block_shape(jst[k].shape, jsh[k].spec,
                                                sizes), k
            cut = local_decode_state({k: torch.as_tensor(one[k])}, spec,
                                     mesh)[k]
            _close(res[k], cut.numpy(), 1e-5)
    if "k_pool" in one:
        whole = _whole_pool(ranks, "k_pool", spec)
        G, S = cases.MESH[0], cases.SLOTS
        npt.assert_allclose(whole, one["k_pool"][:, :G * S], rtol=0,
                            atol=1e-5)


# ------------------------------------------------ the dry run's bytes

@pytest.mark.parametrize("arch,shape", [
    ("granite-8b", "decode_32k"), ("jamba-1.5-large-398b", "long_500k")])
def test_dryrun_serving_arguments_are_the_spec_blocks(arch, shape):
    """A serving cell's argument bytes a rank (the production (16, 16)
    mesh, on ``meta``) are the blocks of JAX's ``param_shardings`` of the
    bf16 parameters (ZeRO as the config sets it) plus the rank's decode
    state and the tokens; jamba's 500k-token cell, 740.75 GiB a rank with
    the weights whole, now holds under 10 GiB."""
    import repro_torch.launch.dryrun as dryrun
    _, args, mesh, info = dryrun.build_cell(arch, shape, False)
    params, dstate, tokens = args
    sizes = {"data": 16, "model": 16}
    jcfg = JARCHS[arch]
    jd = jdims(jcfg, tp=16)
    abs_ = jax.eval_shape(lambda k: jinit(k, jcfg, jd, dtype=jnp.bfloat16),
                          jax.random.PRNGKey(0))
    sh = jparam_shardings(abs_, JRules(data_axes=("data",),
                                       zero_params=jcfg.zero_shard_params),
                          AbstractMesh((16, 16), ("data", "model")))
    want = 0
    for leaf, s in zip(jax.tree_util.tree_leaves(abs_),
                       jax.tree_util.tree_leaves(sh)):
        want += int(np.prod(_block_shape(leaf.shape, s.spec, sizes))) \
            * leaf.dtype.itemsize
    got = dryrun.storage_bytes(args)
    assert got == want + dryrun.storage_bytes(dstate) \
        + tokens.numel() * tokens.element_size()
    if arch.startswith("jamba"):
        assert got < 10 * 2 ** 30
