"""The port's training over a (data, model) mesh against the JAX package's.

Against the JAX package, on the CPU, from the same numpy weights (the JAX
package's ``init_params``, carried across as in ``tests/test_torch_train.py``):

* the layouts, exactly, as tuples: ``param_shardings`` (ZeRO on and off)
  and ``state_shardings`` (AdamW, Adafactor, the ``ef`` residuals) for
  every leaf of every family's ``reduced`` state, ``megatron_param_
  shardings`` (``n_kv`` 4 and 1) and ``batch_spec``, on the (2, 2),
  (1, 4) and (4, 1) meshes; ``_guard``'s cases; ``bubble_fraction``;
* grouped MoE dispatch at 1, 2 and 4 groups and with ``T % n_groups``, in
  float32: the integer routing equal, outputs and aux within 1e-5.

One module-scoped spawn runs a (2, 2) and a (1, 2) gloo group
(``tests/torch_train_mesh_cases.py``, file rendezvous, one thread a rank,
60 s collective timeouts) while this process runs the oracles:

* (2, 2), on batches whose first row masks 20 labels (the first data
  rank holds fewer labels than the second): 3 steps of reduced
  granite-8b with AdamW, the losses within
  2e-4 of JAX's single-device losses (``tests/test_system.py:78``'s
  bound) and of the port's; Adafactor (q/k/v/gate/up split on their last
  dim over the model axis, their ``vc`` with them), likewise; reduced
  qwen3-moe at capacity 1.25 (two microbatches; tokens drop), whose
  ``fraction_dropped`` must equal the port's single-device step's and
  JAX's (within 1e-6) and whose losses lie within 2e-4 of both; every gathered
  state leaf against the port's single-device step (``_STATE_TOL``); the
  Megatron forward within 1e-4 of JAX's ``forward`` (``n_kv`` 4 and 1);
  ``gpipe_spmd`` over the four ranks within 2e-5 of JAX's
  ``gpipe_reference``; a checkpoint of the sharded AdamW state.
* (1, 2): the Megatron schedule's gradients through ``loss_override``
  within 1e-5 of the single-device gradients' blocks, and its step's
  gradient norm within 1e-5 relative of the single-device step's (a
  gradient scaled by tp shows in both); the (2, 2) checkpoint restored
  here, every gathered leaf byte for byte, then one step within 2e-4 of
  the uninterrupted run; a ``ResilientLoop`` fault whose replayed losses
  equal the first pass's bitwise, with rank 0 alone writing.
* (1, 1): the mesh step, its collectives over groups of one, equal to
  the single-device step bit for bit (AdamW, Adafactor, the MoE).
"""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.dist import pipeline as jpipe
from repro.dist.megatron import (megatron_param_shardings as
                                 jmegatron_shardings)
from repro.dist.sharding import ShardingRules as JRules
from repro.dist.sharding import _guard as jguard
from repro.dist.sharding import batch_spec as jbatch_spec
from repro.dist.sharding import param_shardings as jparam_shardings
from repro.models import FwdOptions as JFwd, forward as jforward
from repro.models import init_params as jinit, model_dims as jdims
from repro.models.moe import init_moe as jinit_moe
from repro.models.moe import moe_layer as jmoe_layer
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro.train import state_shardings as jstate_shardings
from repro_torch.ckpt.checkpoint import tree_flatten
from repro_torch.configs import ARCHS, reduced
from repro_torch.dist import bubble_fraction
from repro_torch.dist.megatron import megatron_param_shardings
from repro_torch.dist.sharding import (ShardingRules, _guard, batch_spec,
                                       block_of, param_shardings)
from repro_torch.dist.pipeline import gpipe_reference
from repro_torch.models import FwdOptions, loss_fn, model_dims
from repro_torch.models.moe import moe_layer
from repro_torch.params import params_from_numpy
from repro_torch.train import TrainConfig, abstract_state, state_shardings

torch.set_num_threads(2)

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_train_mesh_cases as cases  # noqa: E402

FAMILIES = ["granite-8b", "qwen3-moe-30b-a3b", "mamba2-130m",
            "jamba-1.5-large-398b", "paligemma-3b", "whisper-medium"]
MESHES = [(2, 2), (1, 4), (4, 1)]
SPAWN_TIMEOUT_S = 240
LOSS_TOL = 2e-4
# a gathered state leaf against the single-device step's after 3 steps:
# the two sum each gradient in another order (per data rank, then over
# the group), a rounding of ~1e-7 of it, which AdamW's and Adafactor's
# normalisation carries into the update as a relative change of the same
# size; 1e-5 of the leaf's largest element is a hundred such roundings
_STATE_TOL = 1e-5


def _isleaf(x):
    return isinstance(x, NamedSharding)


def _jax_specs(tree):
    return [tuple(s.spec) for s in jax.tree.leaves(tree, is_leaf=_isleaf)]


def _specs(tree):
    return [tuple(s) for s in tree_flatten(tree)[0]]


def _cfgs(arch, **over):
    return (dataclasses.replace(jreduced(JARCHS[arch]), **over),
            dataclasses.replace(reduced(ARCHS[arch]), **over))


# ------------------------------------------------------------- layouts

@functools.lru_cache(maxsize=None)
def _jax_state_shape(arch, optimizer):
    jcfg, _ = _cfgs(arch, optimizer=optimizer)
    return jax.eval_shape(
        lambda k: jinit_state(k, jcfg, jdims(jcfg),
                              JTrainConfig(grad_compression=True)),
        jax.random.PRNGKey(0))


def _port_state_shape(arch, optimizer):
    _, cfg = _cfgs(arch, optimizer=optimizer)
    return abstract_state(cfg, model_dims(cfg),
                          TrainConfig(grad_compression=True))


@pytest.mark.parametrize("zero", [True, False])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_specs_match_jax(arch, shape, zero):
    jspecs = _jax_specs(jparam_shardings(
        _jax_state_shape(arch, "adamw")["params"], JRules(zero_params=zero),
        AbstractMesh(shape, ("data", "model"))))
    got = _specs(param_shardings(_port_state_shape(arch, "adamw")["params"],
                                 ShardingRules(zero_params=zero), shape))
    assert got == jspecs
    assert any(any(e is not None for e in s) for s in got)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_state_specs_match_jax(arch, shape, optimizer):
    """The whole state: params, the optimizer's moments (Adafactor's
    factors drop a dim's spec), the ``ef`` residuals and the step."""
    jspecs = _jax_specs(jstate_shardings(
        _jax_state_shape(arch, optimizer),
        AbstractMesh(shape, ("data", "model")), JRules()))
    state = _port_state_shape(arch, optimizer)
    assert all(x.device.type == "meta" for x in tree_flatten(state)[0])
    got = _specs(state_shardings(state, shape, ShardingRules()))
    assert got == jspecs
    if optimizer == "adafactor":
        assert any(len(s) == 2 and s[-1] == "model" for s in got)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("n_kv", [4, 1])
def test_megatron_specs_match_jax(n_kv, shape):
    jcfg, cfg = _cfgs("granite-8b", num_kv_heads=n_kv)
    tp = shape[1]
    jp = jax.eval_shape(lambda k: jinit(k, jcfg, jdims(jcfg, tp=tp)),
                        jax.random.PRNGKey(0))
    jspecs = _jax_specs(jmegatron_shardings(
        jp, AbstractMesh(shape, ("data", "model")), JRules()))
    p = abstract_state(cfg, model_dims(cfg, tp=tp), TrainConfig())["params"]
    assert _specs(megatron_param_shardings(p, shape, ShardingRules())) \
        == jspecs


@pytest.mark.parametrize("rows", [8, 6, 1])
@pytest.mark.parametrize("shape", MESHES)
def test_batch_spec_matches_jax(shape, rows):
    batch = {"tokens": np.zeros((rows, 16), np.int32),
             "labels": np.zeros((rows, 16), np.int32),
             "frontend": np.zeros((rows, 4, 8), np.float32)}
    jspec = jbatch_spec(batch, JRules(), AbstractMesh(shape,
                                                      ("data", "model")))
    got = batch_spec(batch, ShardingRules(), shape)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v.spec) for k, v in jspec.items()}


@pytest.mark.parametrize("spec,dims", [
    (("model", None), (40, 16)),
    (("model", "data"), (6, 8)),
    ((("data",), "model"), (8, 3)),
    ((None, ("data", "model")), (5, 12)),
    (("model",), (8, 4, 2)),
    (("data", "model", None, "model"), (4, 4)),
])
@pytest.mark.parametrize("shape", MESHES + [(1, 1)])
def test_guard_matches_jax(spec, dims, shape):
    want = tuple(jguard(spec, dims, AbstractMesh(shape, ("data", "model"))))
    assert tuple(_guard(spec, dims, shape)) == want


def test_bubble_fraction():
    for n_micro, stages in ((8, 4), (1, 1), (6, 4), (1, 8), (32, 2)):
        assert bubble_fraction(n_micro, stages) == \
            jpipe.bubble_fraction(n_micro, stages)
    assert bubble_fraction(8, 4) == pytest.approx(3 / 11)


def test_gpipe_reference_matches_jax():
    g = _gpipe_inputs()
    want = jpipe.gpipe_reference(
        lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
        jax.tree.map(jnp.asarray, g["params"]), jnp.asarray(g["x"]))
    got = gpipe_reference(
        lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
        {k: torch.from_numpy(v) for k, v in g["params"].items()},
        torch.from_numpy(g["x"]))
    npt.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                        atol=2e-5)


# ------------------------------------------------------- grouped MoE

@pytest.mark.parametrize("rows,groups", [(2, 1), (2, 2), (2, 4), (3, 2),
                                         (3, 4), (1, 3)])
def test_grouped_moe_matches_jax(rows, groups):
    """``n_groups`` contiguous token groups, each with its own capacity and
    table (``T % n_groups``: one group); the integer routing against the
    JAX function's own steps on the same logits, per group."""
    D, FF, E, K, cf = 16, 8, 8, 2, 0.5
    jp = jinit_moe(jax.random.PRNGKey(3), D, FF, E)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.RandomState(rows * 10 + groups).randn(
        rows, 32, D).astype(np.float32)
    jout, jaux = jax.jit(functools.partial(
        jmoe_layer, top_k=K, capacity_factor=cf, n_groups=groups))(
        jp, jnp.asarray(x))
    trace = {}
    out, aux = moe_layer(tp, torch.from_numpy(x), top_k=K,
                         capacity_factor=cf, n_groups=groups, trace=trace)
    T = rows * 32
    G = groups if T % groups == 0 else 1
    idx, pos, keep, table = _jax_group_routing(jp, x.reshape(T, D), K, cf, G)
    lead = (G, T // G) if G > 1 else (T,)
    npt.assert_array_equal(trace["expert_idx"].numpy(),
                           idx.reshape(*lead, K))
    npt.assert_array_equal(trace["pos"].numpy(), pos.reshape(*lead, K))
    npt.assert_array_equal(trace["keep"].numpy(), keep.reshape(*lead, K))
    npt.assert_array_equal(trace["table"].numpy(),
                           table if G > 1 else table[0])
    assert float(aux["fraction_dropped"]) > 0      # the capacity bites
    for key in ("lb_loss", "z_loss", "fraction_dropped"):
        npt.assert_allclose(float(aux[key]), float(jaux[key]), rtol=1e-5,
                            atol=1e-5, err_msg=key)
    npt.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)


def _jax_group_routing(jp, x, top_k, cf, G):
    """``repro.models.moe.moe_layer``'s routing (lines 66-91) in jnp per
    group of ``T // G`` tokens: (expert_idx, pos, keep, table (G, E, C))."""
    from repro.models.moe import _capacity
    T, E = x.shape[0], jp["gate"].shape[0]
    Tg = T // G
    C = _capacity(Tg, E, top_k, cf)
    logits = jnp.asarray(x).reshape(G, Tg, -1) @ jp["router"]["w"]
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    sel = jax.nn.one_hot(idx, E, dtype=jnp.int32).reshape(G, Tg * top_k, E)
    pos = ((jnp.cumsum(sel, axis=1) - sel) * sel).sum(-1).reshape(
        G, Tg, top_k)
    keep = pos < C
    pos_c = jnp.where(keep, pos, C)
    g_ids = jnp.repeat(jnp.arange(G), Tg * top_k)
    tok = jnp.tile(jnp.repeat(jnp.arange(Tg, dtype=jnp.int32), top_k), G)
    table = jnp.zeros((G, E, C + 1), jnp.int32).at[
        g_ids, idx.reshape(-1), pos_c.reshape(-1)].set(tok + 1)[:, :, :C]
    return tuple(np.asarray(a) for a in (idx, pos, keep, table))


# ------------------------------------------------ the spawned groups

def _jax_params(jcfg, tp=1):
    return jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jcfg,
                                          jdims(jcfg, tp=tp),
                                          dtype=jnp.float32))


def _gpipe_inputs():
    rng = np.random.RandomState(11)
    S, n_micro, mb, d = 4, 6, 2, 8
    return {"params": {"w": (rng.randn(S, d, d) * 0.3).astype(np.float32),
                       "b": np.linspace(-1, 1, S * d).reshape(
                           S, d).astype(np.float32)},
            "x": rng.randn(n_micro, mb, d).astype(np.float32)}


def _inputs():
    """The JAX package's float32 weights of every scenario, as numpy."""
    granite = _jax_params(jreduced(JARCHS["granite-8b"]))
    out = {"adamw": granite, "adafactor": granite,
           "moe": _jax_params(jreduced(JARCHS["qwen3-moe-30b-a3b"])),
           "gpipe": _gpipe_inputs()}
    for n_kv in (4, 1):
        jcfg, _ = _cfgs("granite-8b", num_kv_heads=n_kv)
        out[f"megatron{n_kv}"] = _jax_params(jcfg, tp=2)
    return out


# each scenario's JAX config: (arch, overrides), as ``cases.config``'s
_JAX_SCENARIOS = {"adamw": ("granite-8b", {}),
                  "adafactor": ("granite-8b", {"optimizer": "adafactor"}),
                  "moe": ("qwen3-moe-30b-a3b", {"moe_capacity_factor": 1.25})}


def _jax_metrics(name):
    """JAX's single-device step on the scenario's weights and batches:
    each step's loss and, for the MoE, its ``fraction_dropped``."""
    arch, over = _JAX_SCENARIOS[name]
    jcfg, _ = _cfgs(arch, **over)
    cfg, tc = cases.config(name)
    jtc = JTrainConfig(dtype=jnp.float32, microbatches=tc.microbatches,
                       **cases.TC)
    state = jinit_state(jax.random.PRNGKey(0), jcfg, jdims(jcfg), jtc)
    step = jax.jit(jmake_train_step(jcfg, jdims(jcfg), jtc, JFwd(
        dtype=jnp.float32, remat=True)))
    out = []
    for i in range(cases.STEPS):
        b = cases.batch_np(cfg, i)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append({k: float(m[k]) for k in ("loss", "fraction_dropped")
                    if k in m})
    return out


def _oracles(inputs):
    """This process's references: the port's single-device runs, JAX's
    losses, forwards and pipeline."""
    out = {"jax": {name: _jax_metrics(name) for name in _JAX_SCENARIOS}}
    for name in _JAX_SCENARIOS:
        cfg, tc = cases.config(name)
        state, mets = cases.train(cfg, tc, cases.state_of(inputs[name], cfg,
                                                          tc))
        specs = state_shardings(abstract_state(cfg, model_dims(cfg), tc),
                                (2, 2), ShardingRules())
        out[name] = {"metrics": mets, "state": cases.numpy_tree(state),
                     "block_bytes": sum(
                         x.numel() * x.element_size() // _split(s)
                         for x, s in zip(tree_flatten(state)[0],
                                         tree_flatten(specs)[0]))}
    for n_kv in (4, 1):
        jcfg, cfg = _cfgs("granite-8b", num_kv_heads=n_kv)
        batch = cases.batch_np(cfg, 0)
        logits, _, _ = jforward(
            jax.tree.map(jnp.asarray, inputs[f"megatron{n_kv}"]),
            {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
            jdims(jcfg, tp=2), JFwd(attn_impl="dense", dtype=jnp.float32))
        dims = model_dims(cfg, tp=2)
        params = params_from_numpy(inputs[f"megatron{n_kv}"], device="cpu")
        leaves = [p.requires_grad_(True) for p in tree_flatten(params)[0]]
        loss, _ = loss_fn(params, cases.batch_at(cfg, 0), cfg, dims,
                          FwdOptions(dtype=torch.float32))
        grads = torch.autograd.grad(loss, leaves)
        tc = TrainConfig(dtype=torch.float32, **cases.TC)
        state, mets = cases.train(cfg, tc, cases.state_of(
            inputs[f"megatron{n_kv}"], cfg, tc), steps=1)
        out[f"megatron{n_kv}"] = {
            "logits": np.asarray(logits), "loss": loss.item(),
            "grads": grads, "specs": megatron_param_shardings(
                params, (1, 2), ShardingRules()),
            "step": mets[0], "params": cases.numpy_tree(state["params"])}
    g = inputs["gpipe"]
    out["gpipe"] = np.asarray(jpipe.gpipe_reference(
        lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
        jax.tree.map(jnp.asarray, g["params"]), jnp.asarray(g["x"])))
    return out


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Write the inputs, start both groups' ranks at once, run the oracles
    here while they train, then collect every rank's results."""
    root = tmp_path_factory.mktemp("train_mesh")
    inputs = _inputs()
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for data, model in cases.SCENARIOS:
        d = root / f"mesh{data}x{model}"
        d.mkdir()
        for r in range(data * model):
            log = open(d / f"rank{r}.log", "w")
            procs.append((log, subprocess.Popen(
                [sys.executable, str(HERE / "torch_train_mesh_cases.py"),
                 str(r), str(data * model), f"{data},{model}", str(root)],
                stdout=log, stderr=subprocess.STDOUT, env=env)))
    try:
        oracle = _oracles(inputs)
        for _, p in procs:
            p.wait(timeout=SPAWN_TIMEOUT_S)
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    runs = {}
    for data, model in cases.SCENARIOS:
        d = root / f"mesh{data}x{model}"
        got = []
        for r in range(data * model):
            path = d / f"rank{r}.pkl"
            if not path.exists():
                got.append({"error": (d / f"rank{r}.log").read_text()[-4000:]})
                continue
            with open(path, "rb") as f:
                got.append(pickle.load(f))
        runs[(data, model)] = got
    return oracle, runs, root


def _ranks(mesh_runs, mesh, name):
    oracle, runs, _ = mesh_runs
    for r, res in enumerate(runs[mesh]):
        assert "error" not in res, f"rank {r} of {mesh}: {res['error']}"
    return oracle, [res[name] for res in runs[mesh]]


def _split(spec, sizes={"data": 2, "model": 2}):
    """How many blocks ``spec`` cuts a leaf into on the (2, 2) mesh."""
    n = 1
    for e in spec:
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            n *= sizes[a]
    return n


def _assert_state_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        npt.assert_allclose(g, w, rtol=0,
                            atol=_STATE_TOL * max(np.abs(w).max(), 1e-30))


@pytest.mark.parametrize("name", ["adamw", "adafactor", "moe"])
def test_mesh_train_matches_single_device(mesh_runs, name):
    """3 steps at (2, 2): the losses (and, for the MoE, the routing's
    drops) of every rank against JAX's single-device step and the port's,
    the gathered state against the port's, and each rank holding only its
    blocks' bytes.  One token routed otherwise moves ``fraction_dropped``
    by a step of 1 / (a microbatch's tokens * top_k * microbatches), far
    above the 1e-6 it is held to."""
    oracle, ranks = _ranks(mesh_runs, (2, 2), name)
    want = oracle[name]
    for r, got in enumerate(ranks):
        for g, w, j in zip(got["metrics"], want["metrics"],
                           oracle["jax"][name]):
            npt.assert_allclose(g["loss"], w["loss"], rtol=0, atol=LOSS_TOL)
            npt.assert_allclose(g["loss"], j["loss"], rtol=0, atol=LOSS_TOL)
            npt.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-5)
            assert g["lr"] == w["lr"]
            if name == "moe":
                assert g["fraction_dropped"] == w["fraction_dropped"] > 0
                npt.assert_allclose(g["fraction_dropped"],
                                    j["fraction_dropped"], rtol=1e-6)
        assert got["metrics"] == ranks[0]["metrics"], r
        _assert_state_close(got["state"], want["state"])
        assert got["block_bytes"] == want["block_bytes"]


@pytest.mark.parametrize("n_kv", [4, 1])
def test_megatron_forward_matches_jax(mesh_runs, n_kv):
    """Each rank's rows of the schedule's logits against JAX's forward."""
    oracle, ranks = _ranks(mesh_runs, (2, 2), "megatron-forward")
    want = oracle[f"megatron{n_kv}"]["logits"]
    rows = want.shape[0] // 2
    for r, got in enumerate(ranks):
        d = r // 2
        npt.assert_allclose(got[n_kv], want[d * rows:(d + 1) * rows],
                            rtol=1e-4, atol=1e-4)


def test_gpipe_spmd_matches_jax(mesh_runs):
    oracle, ranks = _ranks(mesh_runs, (2, 2), "gpipe")
    for got in ranks:
        npt.assert_allclose(got["out"], oracle["gpipe"], rtol=2e-5,
                            atol=2e-5)


@pytest.mark.parametrize("n_kv", [4, 1])
def test_megatron_grads_match_single_device(mesh_runs, n_kv):
    """Through ``loss_override`` at (1, 2): every block's gradient against
    the single-device gradient's block, then one step's gradient norm and
    gathered parameters against the single-device step's."""
    oracle, ranks = _ranks(mesh_runs, (1, 2), "megatron-grads")
    want = oracle[f"megatron{n_kv}"]
    from repro_torch.launch.mesh import Mesh
    specs = tree_flatten(want["specs"])[0]
    for r, got in enumerate(ranks):
        got = got[n_kv]
        npt.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        mesh = Mesh(shape=(1, 2), rank=r, data_index=0, model_index=r,
                    model_group=None)
        assert len(got["grads"]) == len(want["grads"])
        for g, w, s in zip(got["grads"], want["grads"], specs):
            npt.assert_allclose(g, block_of(w, s, mesh).numpy(), rtol=0,
                                atol=1e-5)
        npt.assert_allclose(got["step"]["grad_norm"],
                            want["step"]["grad_norm"], rtol=1e-5)
        npt.assert_allclose(got["step"]["loss"], want["step"]["loss"],
                            rtol=1e-6)
        _assert_state_close(got["params"], want["params"])


def test_checkpoint_restores_onto_another_mesh(mesh_runs):
    """The (2, 2) AdamW state saved at step 3 (rank 0 alone writes),
    restored onto (1, 2): every gathered leaf byte for byte, and the next
    step within 2e-4 of the uninterrupted (2, 2) run's."""
    _, saved = _ranks(mesh_runs, (2, 2), "adamw")
    _, restored = _ranks(mesh_runs, (1, 2), "elastic-restore")
    assert [g["saves"] for g in saved] == [1, 0, 0, 0]
    for got in restored:
        assert got["step"] == cases.STEPS
        assert len(got["state"]) == len(saved[0]["state"])
        for a, b in zip(got["state"], saved[0]["state"]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        npt.assert_allclose(got["next_loss"], saved[0]["next_loss"], rtol=0,
                            atol=LOSS_TOL)


def test_resilient_loop_replays_bitwise_on_a_mesh(mesh_runs):
    _, ranks = _ranks(mesh_runs, (1, 2), "resilient-fault")
    every, fail = cases.LOOP["ckpt_every"], cases.LOOP["fail_at"]
    for r, got in enumerate(ranks):
        L = got["losses"]
        assert got["restarts"] == 1 and got["final_step"] == \
            cases.LOOP["total"]
        assert got["steps_run"] == cases.LOOP["total"] + fail - every
        assert L[every:fail] == L[fail:2 * fail - every]
        assert L == ranks[0]["losses"]
        saved = len(range(every, cases.LOOP["total"] + 1, every))
        assert got["saves"] == (saved if r == 0 else 0)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "moe"])
def test_mesh_of_one_position_is_bitwise(mesh_runs, name):
    _, ranks = _ranks(mesh_runs, (1, 1), "one-position")
    assert ranks[0][name] == {"metrics": True, "state": True}
