"""The port's MoE (``repro_torch.models.moe``) against the JAX package's
(``repro.models.moe``) on the same seeded inputs and weights.

``moe_layer`` at capacity factors 8.0 (the reduced configs': nothing
drops) and 1.25 (the published configs': tokens drop), on random rows,
on a batch whose padded tail repeats one row (the engine's pow2 buckets
pad with token 0), and with router columns duplicated so that experts
tie; ``moe_decode`` on random and tied rows.  The JAX function keeps its
routing inside, so the integer results (expert ids, queue positions, the
keep mask, the (E, C) index table) are held against the same steps
written in jnp on the same logits (``_jax_routing``, lines 66-91 of
``src/repro/models/moe.py``), and ``fraction_dropped`` against the JAX
function's own.

Tolerances: outputs 2e-5 in float32 (two summation orders); in bfloat16
3e-2 of the output's own scale (``max |ref|``, at least 1); aux 1e-5.
Integer results match exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from repro.models.moe import init_moe as jinit_moe
from repro.models.moe import moe_decode as jmoe_decode
from repro.models.moe import moe_layer as jmoe_layer
from repro_torch.models.moe import _capacity, moe_decode, moe_layer
from repro_torch.params import params_from_numpy

torch.set_num_threads(2)

D, FF, E, K = 64, 32, 8, 2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _weights(dtype, tie=False):
    jdt, _ = DTYPES[dtype]
    jp = jinit_moe(jax.random.PRNGKey(1), D, FF, E, jdt)
    if tie:
        # experts 0, 1 and 2 share one router column, scaled up so that
        # they lead on about half the tokens: top-2 must take 0 and 1
        w = np.array(jp["router"]["w"])
        w[:, 1] = w[:, 2] = w[:, 0] = 3.0 * w[:, 0]
        w[:, 6] = w[:, 4]
        jp = dict(jp, router={"w": jnp.asarray(w)})
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _rows(case, shape):
    rng = np.random.RandomState(7)
    x = rng.randn(*shape).astype(np.float32)
    if case == "pad_rows":
        # each row's tail is bucket padding: one repeated row
        x[:, shape[1] // 2:] = x[0, 0]
    return x


def _jax_routing(jp, x, top_k, cf):
    """The routing of ``repro.models.moe.moe_layer`` (one group) in jnp:
    (expert_idx, pos, keep, table) as numpy."""
    T = x.shape[0] * x.shape[1]
    C = _capacity(T, E, top_k, cf)
    logits = jnp.asarray(x, jnp.float32).reshape(T, D) @ jp["router"]["w"]
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    sel = jax.nn.one_hot(idx, E, dtype=jnp.int32).reshape(T * top_k, E)
    pos = ((jnp.cumsum(sel, axis=0) - sel) * sel).sum(-1).reshape(T, top_k)
    keep = pos < C
    pos_c = jnp.where(keep, pos, C)
    table = jnp.zeros((E, C + 1), jnp.int32).at[
        idx.reshape(-1), pos_c.reshape(-1)].set(
        jnp.repeat(jnp.arange(T, dtype=jnp.int32), top_k) + 1)[:, :C]
    return tuple(np.asarray(a) for a in (idx, pos, keep, table))


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    tol = (2e-5 if dtype == "float32"
           else 3e-2 * max(1.0, float(np.abs(want).max())))
    npt.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("case", ["random", "pad_rows", "ties"])
def test_moe_layer_matches_jax(dtype, cf, case):
    jdt, tdt = DTYPES[dtype]
    jp, tp = _weights(dtype, tie=case == "ties")
    x = _rows(case, (3, 16, D))
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(tdt)
    jout, jaux = jmoe_layer(jp, jx, top_k=K, capacity_factor=cf)
    trace = {}
    out, aux = moe_layer(tp, tx, top_k=K, capacity_factor=cf, trace=trace)
    assert out.dtype == tdt and tuple(out.shape) == jout.shape

    idx, pos, keep, table = _jax_routing(jp, np.asarray(jx, np.float32),
                                         K, cf)
    npt.assert_array_equal(trace["expert_idx"].numpy(), idx)
    npt.assert_array_equal(trace["pos"].numpy(), pos)
    npt.assert_array_equal(trace["keep"].numpy(), keep)
    npt.assert_array_equal(trace["table"].numpy(), table)
    dropped = float(jaux["fraction_dropped"])
    assert float(aux["fraction_dropped"]) == dropped
    assert dropped == pytest.approx(1.0 - keep.mean(), abs=1e-6)
    if cf == 1.25 and case != "random":
        assert dropped > 0               # the capacity bites
    if cf == 8.0:
        assert dropped == 0.0
    if case == "ties":
        # the tied leaders: expert 0 before 1, never 2 while both lead
        lead = (idx[:, 0] == 0)
        assert lead.any()
        npt.assert_array_equal(idx[lead, 1], 1)
        assert not (idx == 2).any()
    for key in ("lb_loss", "z_loss", "fraction_dropped"):
        assert aux[key].dtype == torch.float32
        npt.assert_allclose(float(aux[key]), float(jaux[key]), rtol=1e-5,
                            atol=1e-5, err_msg=key)
    _close(out, jout, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["random", "ties"])
def test_moe_decode_matches_jax(dtype, case):
    jdt, tdt = DTYPES[dtype]
    jp, tp = _weights(dtype, tie=case == "ties")
    x = _rows(case, (1, 6, D))[0]
    jx = jnp.asarray(x, jdt)
    out = moe_decode(tp, torch.from_numpy(x).to(tdt), top_k=K)
    assert out.dtype == tdt and tuple(out.shape) == (6, D)
    _close(out, jmoe_decode(jp, jx, top_k=K), dtype)
    # logits handed in (the verify step's per-position router) change
    # nothing
    logits = torch.from_numpy(np.array(jx, np.float32)) @ tp["router"]["w"]
    assert torch.equal(moe_decode(tp, torch.from_numpy(x).to(tdt), top_k=K,
                                  logits=logits), out)


def test_moe_decode_rows_do_not_depend_on_the_batch():
    """A row's decode MoE is bitwise the same alone, in a batch, and in
    another slot (the verify step runs B·(K+1) rows, the decode step B)."""
    _, tp = _weights("bfloat16")
    x = torch.from_numpy(_rows("random", (1, 20, D))[0]).to(
        torch.bfloat16)
    full = moe_decode(tp, x, top_k=K)
    for rows in (slice(0, 4), slice(4, 5), slice(8, 20)):
        assert torch.equal(moe_decode(tp, x[rows].contiguous(), top_k=K),
                           full[rows])
    perm = torch.arange(19, -1, -1)
    assert torch.equal(moe_decode(tp, x[perm].contiguous(), top_k=K),
                       full[perm])


def test_moe_router_stays_float32():
    """``params_from_numpy(dtype=bf16)`` casts every weight but the
    router, as ``init_moe`` keeps it float32 under a bf16 model."""
    jp = jinit_moe(jax.random.PRNGKey(0), D, FF, E, jnp.bfloat16)
    assert jp["router"]["w"].dtype == jnp.float32
    for tree in (jp, jinit_moe(jax.random.PRNGKey(0), D, FF, E)):
        tp = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu",
                               dtype=torch.bfloat16)
        assert tp["router"]["w"].dtype == torch.float32
        for key in ("gate", "up", "down"):
            assert tp[key].dtype == torch.bfloat16
    npt.assert_array_equal(tp["router"]["w"].numpy(),
                           np.asarray(jp["router"]["w"]))


def test_grouped_dispatch_raises():
    _, tp = _weights("float32")
    x = torch.zeros((2, 8, D))
    with pytest.raises(NotImplementedError, match="ROADMAP P15"):
        moe_layer(tp, x, top_k=K, n_groups=2)
