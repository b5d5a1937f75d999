"""The port's training path against the JAX package's, on the CPU.

The same inputs, drawn from seeds with numpy (or the JAX package's
weights as numpy arrays), go through the JAX function and its port.
Tolerances:

* schedules at steps 0..N: 1e-7 of the peak lr (near the end of the
  cosine, ``1 + cos`` cancels, so XLA's and torch's cos, one float32 ulp
  apart, differ there by more than 1e-7 of the value);
* AdamW and Adafactor (three in-place updates of one tree, Adafactor's
  chunked path too) and the clip: 1e-6;
* compression: int8 values and scales equal; the error-feedback identity
  ``sum_t g_hat_t + e_T == sum_t g_t`` to 1e-6 (sums in float64);
* the data pipeline: batches equal;
* ``rms_norm``'s gradient: 1e-6 in float32, one bf16 step (2^-7 of the
  value) in bfloat16, where ``dx`` must come out in bfloat16;
* ``loss_fn`` for the six families at ``reduced`` in float32: the loss to
  1e-6, every gradient leaf to 1e-4 of its largest element plus 1e-7
  (the attention ``k`` biases have a gradient of exactly zero in
  arithmetic, rounding noise of ~1e-9 on both sides);
* remat on against off: bitwise, port against port;
* the train step, three steps against JAX's ``make_train_step``: AdamW
  with two microbatches and int8 compression, and Adafactor: the losses
  to 1e-5, the parameters to 1e-5 (Adafactor) and, with compression, to
  1e-5 but at flipped int8 codes: an element whose code flips between the
  frameworks (at most 1e-3 of the elements) moves its AdamW update by at
  most ``2 lr`` a step, and its EF residual by one step (elsewhere the
  residuals agree to 1% of the leaf's largest);
* ``ResilientLoop``: the JAX tests' scenarios, replay bitwise.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.data import (DataConfig as JDataConfig,
                        PackedFileDataset as JPacked, SyntheticLM as JSynth,
                        host_slice as jhost_slice)
from repro.dist import compression as jcomp
from repro.models import FwdOptions as JFwd, init_params as jinit
from repro.models import loss_fn as jloss, model_dims as jdims
from repro.models import layers as jlayers
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.checkpoint import tree_flatten
from repro_torch.configs import ARCHS, reduced
from repro_torch.data import (DataConfig, PackedFileDataset, SyntheticLM,
                              host_slice)
from repro_torch.dist import compression
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import FwdOptions, layers, loss_fn, model_dims
from repro_torch.optim import optimizers, schedules
from repro_torch.params import params_from_numpy
from repro_torch.runtime import FaultInjector, InjectedFault, ResilientLoop
from repro_torch.train import (TrainConfig, init_state, make_train_step,
                               state_from_params)

torch.set_num_threads(2)

FAMILY_ARCHS = ["granite-8b", "qwen3-moe-30b-a3b", "mamba2-130m",
                "jamba-1.5-large-398b", "paligemma-3b", "whisper-medium"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return tree_flatten(tree)[0]


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("warmup_linear", (3e-4, 10, 100)),
    ("warmup_cosine", (3e-4, 10, 100)),
    ("warmup_cosine", (1.0, 7, 50, 0.2)),
])
def test_schedule_matches_jax(name, args):
    jf, f = getattr(jsched, name)(*args), getattr(schedules, name)(*args)
    for step in range(0, 121):
        want = np.asarray(jf(jnp.asarray(step, jnp.int32)))
        got = f(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        npt.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7 * args[0])


# --------------------------------------------------------------- optimizers

def _opt_tree(rng):
    return {"a": {"w": rng.randn(3, 8, 16).astype(np.float32)},
            "b": rng.randn(5).astype(np.float32),
            "c": rng.randn(8, 16).astype(np.float32),
            "d": rng.randn(1, 16).astype(np.float32)}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.tensor(np.array(a)), tree)


def _assert_tree_close(got, want, rtol, atol):
    gl, wl = _leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        npt.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol,
                            atol=atol)


@pytest.mark.parametrize("name,chunked", [("adamw", False),
                                          ("adafactor", False),
                                          ("adafactor", True)])
def test_optimizer_updates_match_jax(name, chunked, monkeypatch):
    if chunked:   # the leaf a.w (3 x 8 x 16) takes the two-pass path
        monkeypatch.setattr(jopt, "_CHUNK_THRESHOLD", 64)
        monkeypatch.setattr(optimizers, "_CHUNK_THRESHOLD", 64)
    rng = np.random.RandomState(0)
    p0 = _opt_tree(rng)
    jo = jopt.make_optimizer(name, weight_decay=0.1)
    to = optimizers.make_optimizer(name, weight_decay=0.1)
    jp, tp = jax.tree.map(jnp.asarray, p0), _torch_tree(p0)
    js, ts = jo.init(jp), to.init(tp)
    sched = (jsched.warmup_cosine(1e-2, 1, 10),
             schedules.warmup_cosine(1e-2, 1, 10))
    for step in range(3):
        g = jax.tree.map(lambda a: (rng.randn(*a.shape) * 3).astype(
            np.float32), p0)
        jstep, tstep = jnp.asarray(step, jnp.int32), torch.tensor(step)
        jg, _ = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 5.0)
        tg, _ = optimizers.clip_by_global_norm(_torch_tree(g), 5.0)
        jp, js = jo.update(jg, js, jp, jstep, sched[0](jstep))
        out = to.update(tg, ts, tp, tstep, sched[1](tstep))
        assert out[0] is tp and out[1] is ts          # updated in place
    _assert_tree_close(tp, jp, rtol=1e-6, atol=1e-6)
    _assert_tree_close(ts, js, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("max_norm", [0.1, 1.0, 1e4])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.RandomState(1)
    g = _opt_tree(rng)
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                      max_norm)
    tg = _torch_tree(g)
    out, tn = optimizers.clip_by_global_norm(tg, max_norm)
    assert out is tg
    npt.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    _assert_tree_close(tg, jg, rtol=1e-6, atol=0)
    npt.assert_allclose(optimizers.global_norm(tg).numpy(),
                        np.asarray(jopt.global_norm(jg)), rtol=1e-6)


def test_clip_keeps_bf16_dtype():
    g = {"w": torch.full((10,), 100.0, dtype=torch.bfloat16)}
    optimizers.clip_by_global_norm(g, 1.0)
    assert g["w"].dtype == torch.bfloat16
    want = (np.full(10, 100.0, np.float32)
            * np.float32(1.0 / np.sqrt(10 * 100.0 ** 2)))
    npt.assert_allclose(g["w"].float().numpy(), want, rtol=2 ** -7)


# -------------------------------------------------------------- compression

def test_quantize_int8_matches_jax():
    rng = np.random.RandomState(2)
    # halves land exactly on .5 (amax 127 -> scale 1): round half to even
    halves = np.arange(-127.0, 127.5, 0.5, dtype=np.float32)
    for x in (rng.randn(4, 33).astype(np.float32) * 3, halves,
              np.zeros(7, np.float32)):
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        q, s = compression.quantize_int8(torch.tensor(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        npt.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.item() == float(js)
        npt.assert_array_equal(
            compression.dequantize_int8(q, s).numpy(),
            np.asarray(jcomp.dequantize_int8(jq, js)))


def test_error_feedback_matches_jax_and_preserves_sum():
    rng = np.random.RandomState(3)
    shapes = {"w": (8, 16), "b": (16,)}
    ef = compression.init_ef({k: torch.zeros(s) for k, s in shapes.items()})
    jef = jcomp.init_ef({k: jnp.zeros(s) for k, s in shapes.items()})
    true_sum = {k: np.zeros(s) for k, s in shapes.items()}
    hat_sum = {k: np.zeros(s) for k, s in shapes.items()}
    for _ in range(50):
        g = {k: (rng.randn(*s) * 0.1).astype(np.float32)
             for k, s in shapes.items()}
        g_hat, ef = compression.tree_compress_with_ef(
            {k: torch.tensor(v) for k, v in g.items()}, ef)
        jg_hat, jef = jcomp.tree_compress_with_ef(
            {k: jnp.asarray(v) for k, v in g.items()}, jef)
        for k in shapes:
            npt.assert_array_equal(g_hat[k].numpy(), np.asarray(jg_hat[k]))
            npt.assert_array_equal(ef[k].residual.numpy(),
                                   np.asarray(jef[k].residual))
            true_sum[k] += g[k]
            hat_sum[k] += g_hat[k].numpy()
    for k in shapes:
        assert isinstance(ef[k], compression.EFState)
        npt.assert_allclose(hat_sum[k] + ef[k].residual.numpy(),
                            true_sum[k], rtol=0, atol=1e-6)


# --------------------------------------------------------------------- data

@pytest.mark.parametrize("frontend", [0, 8])
def test_synthetic_batches_equal_jax(frontend):
    kw = dict(vocab_size=100, seq_len=16, global_batch=8, seed=3,
              frontend_tokens=frontend, d_model=12 if frontend else 0)
    data, jdata = SyntheticLM(DataConfig(**kw)), JSynth(JDataConfig(**kw))
    for step, host, count in ((0, 0, 1), (7, 0, 1), (7, 1, 2), (3, 3, 4)):
        b, jb = data.batch_at(step, host, count), jdata.batch_at(step, host,
                                                                  count)
        assert sorted(b) == sorted(jb)
        for k in b:
            assert b[k].dtype == jb[k].dtype
            npt.assert_array_equal(b[k], jb[k])
    npt.assert_array_equal(next(iter(data))["tokens"],
                           next(iter(jdata))["tokens"])


def test_packed_file_and_host_slice_equal_jax(tmp_path):
    path = os.path.join(tmp_path, "tokens.bin")
    np.random.RandomState(4).randint(0, 70000, 10000).astype(
        np.uint32).tofile(path)
    kw = dict(vocab_size=50000, seq_len=32, global_batch=4, seed=5)
    ds, jds = PackedFileDataset(path, DataConfig(**kw)), JPacked(
        path, JDataConfig(**kw))
    for step in range(3):
        b, jb = ds.batch_at(step), jds.batch_at(step)
        for k in ("tokens", "labels"):
            npt.assert_array_equal(b[k], jb[k])
        for h in range(2):
            s, js = host_slice(b, h, 2), jhost_slice(jb, h, 2)
            for k in s:
                npt.assert_array_equal(s[k], js[k])
    with pytest.raises(ValueError):
        PackedFileDataset(path, DataConfig(vocab_size=10, seq_len=20000,
                                           global_batch=1))


# ------------------------------------------------------------ rms_norm grad

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_grad_matches_jax(dtype):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 5, 16).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    ct = rng.randn(2, 5, 16).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, js, jct = (jnp.asarray(a, jdt) for a in (x, scale, ct))
    jy, vjp = jax.vjp(lambda a, b: jlayers.rms_norm(a, b, 1e-5), jx, js)
    jdx, jds = vjp(jct)
    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    ts = torch.tensor(scale).to(tdt).requires_grad_(True)
    y = layers.rms_norm(tx, ts, 1e-5)
    # the forward is bitwise the one without autograd
    assert torch.equal(y.detach(), layers.rms_norm(tx.detach(), ts.detach(),
                                                   1e-5))
    dx, ds = torch.autograd.grad(y, (tx, ts), torch.tensor(ct).to(tdt))
    assert dx.dtype == tdt and ds.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    for got, want in ((y, jy), (dx, jdx), (ds, jds)):
        w = np.asarray(want.astype(jnp.float32))
        npt.assert_allclose(got.detach().float().numpy(), w, rtol=tol,
                            atol=tol * np.abs(w).max())


# ---------------------------------------------------------------- loss_fn

def _family(arch, **over):
    jcfg = dataclasses.replace(jreduced(JARCHS[arch]), **over)
    cfg = dataclasses.replace(reduced(ARCHS[arch]), **over)
    return jcfg, cfg


def _batch(cfg, rows=2, seq=16, seed=1, step=0):
    front = cfg.frontend_tokens if cfg.frontend != "none" else 0
    b = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=rows, seed=seed,
                               frontend_tokens=front,
                               d_model=cfg.d_model)).batch_at(step)
    b["labels"][0, :3] = -1                   # masked labels
    return b


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """The JAX package's reduced float32 weights of ``arch`` (drawn once a
    file: the draw costs seconds)."""
    jcfg = jreduced(JARCHS[arch])
    return jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg), dtype=jnp.float32)


def _port_params(jparams):
    params = params_from_numpy(_np(jparams), device="cpu")
    for p in _leaves(params):
        p.requires_grad_(True)
    return params


def _port_loss_and_grads(params, batch, cfg, fwd):
    loss, metrics = loss_fn(params, {k: torch.as_tensor(v)
                                     for k, v in batch.items()},
                            cfg, model_dims(cfg), fwd)
    grads = torch.autograd.grad(loss, _leaves(params),
                                materialize_grads=True)
    return loss, metrics, grads


@pytest.mark.parametrize("arch,impl", [(a, "dense") for a in FAMILY_ARCHS]
                         + [("granite-8b", "flash_jax")])
def test_loss_and_grads_match_jax(arch, impl):
    jcfg, cfg = _family(arch)
    jp = _jax_params(arch)
    batch = _batch(cfg)
    chunks = dict(q_chunk=8, kv_chunk=8)
    jfwd = JFwd(attn_impl=impl, dtype=jnp.float32, **chunks)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, b, jcfg, jdims(jcfg), jfwd), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _port_loss_and_grads(
        _port_params(jp), batch, cfg,
        FwdOptions(attn_impl=impl, dtype=torch.float32, **chunks))
    assert sorted(metrics) == sorted(jm)
    for k in metrics:
        npt.assert_allclose(metrics[k].item(), float(jm[k]), rtol=1e-6,
                            atol=1e-7)
    npt.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        w = np.asarray(w)
        assert g.shape == w.shape
        npt.assert_allclose(g.numpy(), w, rtol=0,
                            atol=1e-4 * np.abs(w).max() + 1e-7)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_is_bitwise(arch):
    _, cfg = _family(arch)
    params = _port_params(_jax_params(arch))
    batch = _batch(cfg, seed=2)
    out = [_port_loss_and_grads(params, batch, cfg, FwdOptions(
        dtype=torch.float32, remat=remat)) for remat in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)


def test_serving_forward_has_no_autograd_path():
    """Without grad the forward takes the plain rms_norm and the stacked
    views (``layer_stack`` returns the tree as it is)."""
    from repro_torch.models.transformer import layer_stack
    _, cfg = _family("jamba-1.5-large-398b")
    params = _port_params(_jax_params("jamba-1.5-large-398b"))
    with torch.no_grad():
        assert layer_stack(params["layers"], cfg) is params["layers"]
    stack = layer_stack(params["layers"], cfg)
    assert isinstance(stack["attn"]["norm1"], tuple)
    assert isinstance(stack["mamba"]["norm1"][0], tuple)


# --------------------------------------------------------------- train step

def _train_pair(arch, tc_kw, steps=3, **cfg_over):
    jcfg, cfg = _family(arch, **cfg_over)
    jtc = JTrainConfig(dtype=jnp.float32, **tc_kw)
    tc = TrainConfig(dtype=torch.float32, **tc_kw)
    jstate = jinit_state(jax.random.PRNGKey(0), jcfg, jdims(jcfg), jtc)
    state = state_from_params(params_from_numpy(_np(jstate["params"]),
                                                device="cpu"), cfg, tc)
    jstep = jax.jit(jmake_train_step(jcfg, jdims(jcfg), jtc, JFwd(
        dtype=jnp.float32, remat=True)))
    step = make_train_step(cfg, model_dims(cfg), tc, FwdOptions(
        dtype=torch.float32, remat=True))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=4, seed=1))
    for i in range(steps):
        b = data.batch_at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        assert sorted(m) == sorted(jm)
        for k in ("loss", "ce", "lr", "grad_norm"):
            npt.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5)
    assert int(state["step"]) == int(jstate["step"]) == steps
    return state, jstate, tc


def test_train_step_adamw_microbatches_compression_matches_jax():
    state, jstate, tc = _train_pair(
        "granite-8b", dict(lr=1e-3, warmup_steps=1, total_steps=10,
                           microbatches=2, grad_compression=True))
    # an int8 code that flips between the frameworks moves that element's
    # AdamW update (|u| <= ~1 at these steps) by at most 2 lr a step
    bound = 2 * tc.lr * 3
    flat, jflat = _leaves(state["params"]), jax.tree.leaves(
        jstate["params"])
    n_off = 0
    for p, w in zip(flat, jflat):
        d = np.abs(p.detach().numpy() - np.asarray(w))
        assert d.max() <= bound + 1e-5
        n_off += int((d > 1e-5).sum())
    assert n_off <= 1e-3 * sum(p.numel() for p in flat)
    # the EF residuals agree to 1% of the leaf's largest residual but at
    # flipped codes, where they differ by one step
    n_off = 0
    for e, je in zip(_leaves(state["ef"]), jax.tree.leaves(jstate["ef"])):
        je = np.asarray(je)
        n_off += int((np.abs(e.numpy() - je) > 1e-2 * np.abs(je).max()).sum())
    assert n_off <= 1e-3 * sum(p.numel() for p in flat)


def test_train_step_adafactor_matches_jax():
    state, jstate, _ = _train_pair(
        "granite-8b", dict(lr=1e-3, warmup_steps=1, total_steps=10),
        optimizer="adafactor")
    _assert_tree_close(state["params"], jstate["params"], rtol=0,
                       atol=1e-5)
    _assert_tree_close(state["opt"], jstate["opt"], rtol=1e-4, atol=1e-9)


def test_train_step_refuses_a_mesh(monkeypatch):
    """Without a process group a mesh of more than one position raises
    ``make_local_mesh``'s error, through the launcher too (nothing falls
    back to one device); a mesh step needs the state's specs, and specs
    need a mesh.  Mesh training itself: ``tests/test_torch_dist.py``."""
    _, cfg = _family("granite-8b")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="init_process_group"):
        make_local_mesh(2, 1)
    with pytest.raises(ValueError, match="init_process_group"):
        launch_train.main(["--arch", "granite-8b", "--reduced",
                           "--data-mesh", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="specs"):
        make_train_step(cfg, model_dims(cfg), TrainConfig(), FwdOptions(),
                        mesh=object())
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(cfg, model_dims(cfg), TrainConfig(), FwdOptions(),
                        specs={})


# ------------------------------------------------------------ resilient loop

def _granite_loop(tmp_path, tc, fwd, global_batch, **loop_kw):
    _, cfg = _family("granite-8b")
    dims = model_dims(cfg)
    state = init_state(torch.Generator().manual_seed(0), cfg, dims, tc,
                       device="cpu")
    step_fn = make_train_step(cfg, dims, tc, fwd)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=global_batch, seed=1))
    ckpt = CheckpointManager(str(tmp_path), keep_last=2)
    return state, ResilientLoop(ckpt, data, step_fn, **loop_kw)


def test_resilient_loop_restart_and_replay(tmp_path):
    tc = TrainConfig(lr=1e-3, warmup_steps=5, total_steps=40,
                     microbatches=2, grad_compression=True,
                     dtype=torch.float32)
    state, loop = _granite_loop(
        tmp_path, tc, FwdOptions(dtype=torch.float32, remat=True), 8,
        ckpt_every=10, injector=FaultInjector([17]))
    rep = loop.run(state, total_steps=25)
    assert rep.restarts == 1 and rep.final_step == 25
    assert rep.steps_run == 32
    assert rep.losses[-1] < rep.losses[0]
    # replayed steps 10..16 equal the first pass bit for bit
    assert rep.losses[10:17] == rep.losses[17:24]


def test_resilient_loop_restarts_from_scratch_without_checkpoint(tmp_path):
    tc = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=10,
                     dtype=torch.float32)
    fresh = []

    def on_restart(restored):
        assert restored is None
        state, _ = _granite_loop(tmp_path, tc, FwdOptions(), 4)
        fresh.append(state)
        return state

    state, loop = _granite_loop(tmp_path, tc, FwdOptions(), 4,
                                ckpt_every=100, on_restart=on_restart,
                                injector=FaultInjector([3]))
    rep = loop.run(state, total_steps=5)
    assert rep.restarts == 1 and rep.final_step == 5 and len(fresh) == 1
    assert rep.losses[:3] == rep.losses[3:6]


def test_retry_budget_exhausted(tmp_path):
    tc = TrainConfig(dtype=torch.float32)
    state, loop = _granite_loop(tmp_path, tc, FwdOptions(), 4,
                                ckpt_every=100, max_restarts=1,
                                injector=FaultInjector([2, 3]))
    with pytest.raises(InjectedFault):
        loop.run(state, total_steps=10)


def test_launch_train_runs_and_restores(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    launch_train.main(["--arch", "granite-8b", "--reduced", "--device",
                       "cpu", "--steps", "3", "--ckpt-dir", ckpt])
    out = capsys.readouterr().out
    assert "arch=granite-8b params=" in out and "mesh=1x1" in out
    assert "done: 3 steps, loss" in out
    # a committed step in --ckpt-dir is restored and training goes on
    _, cfg = _family("granite-8b")
    tc = TrainConfig(dtype=torch.float32)
    state = init_state(torch.Generator().manual_seed(0), cfg,
                       model_dims(cfg), tc, device="cpu")
    state["step"] = torch.tensor(2, dtype=torch.int32)
    CheckpointManager(ckpt).save(2, state, blocking=True)
    launch_train.main(["--arch", "granite-8b", "--reduced", "--device",
                       "cpu", "--steps", "3", "--ckpt-dir", ckpt])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 2" in out
    assert "done: 1 steps, loss" in out
