"""The rows-invariant kernels (``kernels/rows_gemm``, ``kernels/rms_norm``)
and the flash kernel's per-row ``q_offset``, which the prefill steps run so
that on a card a row's bits depend only on its inputs, the weights and its
absolute position.

* On the CPU each wrapper takes its plain version, which is the op the
  port's forward ran before: ``rows_gemm`` / ``rows_bmm`` /
  ``rows_einsum`` / ``rms_norm`` equal ``x @ w (+ b)``, ``torch.bmm``,
  ``torch.einsum`` and ``layers._rms_norm_fwd`` (gated too) bitwise, and
  ``forward`` with ``rows_invariant`` equals ``forward`` without it,
  bitwise, for the dense, moe, ssm and hybrid families.
* Against the JAX package, float32 on the same numpy inputs (2e-5 of the
  scale): the wrappers against ``linear``, ``unembed``, ``rms_norm``,
  ``gated_rms_norm`` and ``ssd_chunked``; the flash wrapper's plain
  path with a per-row ``q_offset`` against ``dense_attention``.
* The kernel's reads: each call's plan (operands, strides, batch axes)
  read back with ``as_strided`` gives the op's result, for the prefill's
  projections, the table read in place, the MoE's bmm and the SSD's four
  einsums (their operands read where they lie).
* ``meta`` tensors (the dry run): shapes, and the FLOPs and bytes each
  call records.
* ``gpu``: each kernel against its plain version on the card, and its
  rows bitwise across row counts, permutations and shifts; chunks at
  their offsets bitwise the whole sequence's through flash; RoPE's rows
  at an offset bitwise.  Run them on a card with ``pytest -m gpu``.
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    from repro.models import ssm as jssm
    from repro.models.attention import dense_attention as j_dense
except ImportError:         # a card machine without JAX: gpu tests only
    jnp = None
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rms_norm.ops import rms_norm
from repro_torch.kernels.rms_norm.ref import gated_rms_norm_ref
from repro_torch.kernels.rows_gemm.ops import (bmm_plan, einsum_plan,
                                               gemm_plan, rows_bmm,
                                               rows_einsum, rows_gemm)
from repro_torch.models import FwdOptions, forward, layers, model_dims
from repro_torch.models import ssm
from repro_torch.models.attention import dense_attention
from repro_torch.params import init_params

torch.set_num_threads(2)

SSD_EQS = ("bckn,bcln->bckl", "bchkl,bclhp->bckhp", "bclhp,bcln->bchpn",
           "bckn,bchpn->bckhp")


@pytest.fixture
def jax_ref():
    if jnp is None:
        pytest.skip("needs the JAX package (jax is not installed)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _ssd_operands(rng, b=2, c=3, k=8, h=4, p=5, n=6):
    """The SSD's four einsums' operands, laid out as ``ssd_chunked``
    makes them."""
    Cc, Bc = _rand(rng, b, c, k, n), _rand(rng, b, c, k, n)
    M = _rand(rng, b, c, h, k, k)
    xc = _rand(rng, b, c, k, h, p)
    prev = _rand(rng, b, c, h, p, n)
    return {SSD_EQS[0]: (Cc, Bc), SSD_EQS[1]: (M, xc),
            SSD_EQS[2]: (xc, Bc), SSD_EQS[3]: (Cc, prev)}


# ---------------------------------------- CPU: the plain ops, bitwise

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrappers_equal_the_plain_ops(dtype):
    rng = np.random.default_rng(0)
    x = _t(_rand(rng, 3, 5, 16), dtype)
    w = _t(_rand(rng, 16, 24), dtype)
    b = _t(_rand(rng, 24), dtype)
    table = _t(_rand(rng, 40, 16), dtype)
    assert torch.equal(rows_gemm(x, w), x @ w)
    assert torch.equal(rows_gemm(x, w, b), x @ w + b)
    assert torch.equal(rows_gemm(x, table.T), x @ table.T)
    assert torch.equal(layers.linear({"w": w, "b": b}, x, rows=True),
                       layers.linear({"w": w, "b": b}, x))
    assert torch.equal(layers.unembed({"table": table}, x, 30, rows=True),
                       layers.unembed({"table": table}, x, 30))
    xe, we = _t(_rand(rng, 4, 7, 16), dtype), _t(_rand(rng, 4, 16, 8), dtype)
    assert torch.equal(rows_bmm(xe, we), torch.bmm(xe, we))
    s = _t(_rand(rng, 16), dtype)
    assert torch.equal(rms_norm(x, s, 1e-5), layers._rms_norm_fwd(x, s, 1e-5))
    assert torch.equal(layers.rms_norm(x, s, 1e-5, rows=True),
                       layers.rms_norm(x, s, 1e-5))
    z = _t(_rand(rng, 3, 5, 16), dtype)
    assert torch.equal(rms_norm(x, s.float(), 1e-5, z=z),
                       layers.gated_rms_norm(x, z, s.float(), 1e-5))
    assert torch.equal(layers.gated_rms_norm(x, z, s.float(), rows=True),
                       layers.gated_rms_norm(x, z, s.float()))


def test_cpu_blocked_gemm_and_einsums_equal_the_plain_ops():
    """The dt projection's blocks (``block``) and the SSD's einsums."""
    rng = np.random.default_rng(1)
    x = _t(_rand(rng, 2, 100, 32))
    w = _t(_rand(rng, 32, 8))
    x2 = torch.nn.functional.pad(x.reshape(-1, 32), (0, 0, 0, 56))
    blocked = torch.cat([blk @ w for blk in x2.split(64)])[:200]
    assert torch.equal(rows_gemm(x, w, block=64), blocked.reshape(2, 100, 8))
    assert torch.equal(ssm._dt_proj(x, w, rows=True), ssm._dt_proj(x, w))
    for eq, (a, b) in _ssd_operands(rng).items():
        assert torch.equal(rows_einsum(eq, _t(a), _t(b)),
                           torch.einsum(eq, _t(a), _t(b)))


@pytest.mark.parametrize("arch,dtype", [
    ("granite-8b", torch.float32), ("granite-8b", torch.bfloat16),
    ("qwen3-moe-30b-a3b", torch.float32), ("mamba2-130m", torch.float32),
    ("jamba-1.5-large-398b", torch.float32)])
def test_cpu_forward_rows_invariant_is_the_plain_forward(arch, dtype):
    """On the CPU ``rows_invariant`` changes no bit of the forward: its
    logits and collected caches equal the forward's without it."""
    cfg = reduced(ARCHS[arch])
    dims = model_dims(cfg)
    gen = torch.Generator().manual_seed(0)
    params = init_params(gen, cfg, dims, dtype, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    batch = {"tokens": tokens}
    if cfg.family in ("ssm", "hybrid"):
        batch["seq_len"] = torch.tensor([16, 11])
    outs = [forward(params, batch, cfg, dims,
                    FwdOptions(dtype=dtype, collect_cache=True,
                               rows_invariant=rows))
            for rows in (False, True)]
    (la, aa, ca), (lb, ab, cb) = outs
    assert torch.equal(la, lb)
    for k in aa:
        assert torch.equal(aa[k], ab[k])
    for k in ca:
        if k == "ssm":
            assert torch.equal(ca[k].state, cb[k].state)
            assert torch.equal(ca[k].conv, cb[k].conv)
        else:
            assert torch.equal(ca[k], cb[k])


# ------------------------------------------------ CPU: the JAX package

def test_wrappers_match_jax(jax_ref):
    rng = np.random.default_rng(2)
    x, w, b = _rand(rng, 3, 5, 16), _rand(rng, 16, 24), _rand(rng, 24)
    table = _rand(rng, 40, 16)
    s, z = _rand(rng, 16), _rand(rng, 3, 5, 16)
    cases = [
        (rows_gemm(_t(x), _t(w), _t(b)),
         jlayers.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                        jnp.asarray(x))),
        (layers.unembed({"table": _t(table)}, _t(x), 30, rows=True),
         jlayers.unembed({"table": jnp.asarray(table)}, jnp.asarray(x), 30)),
        (rms_norm(_t(x), _t(s), 1e-5),
         jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5)),
        (rms_norm(_t(x), _t(s), 1e-5, z=_t(z)),
         jlayers.gated_rms_norm(jnp.asarray(x), jnp.asarray(z),
                                jnp.asarray(s), 1e-5)),
    ]
    for got, want in cases:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=2e-5 * np.abs(want).max())


def test_ssd_rows_matches_jax(jax_ref):
    rng = np.random.default_rng(3)
    b, l, h, p, n, chunk = 2, 32, 4, 8, 16, 8
    xd, B_, C_ = (_rand(rng, b, l, h, p), _rand(rng, b, l, n),
                  _rand(rng, b, l, n))
    dtA = -np.abs(_rand(rng, b, l, h, scale=0.1))
    s0 = _rand(rng, b, h, p, n)
    y, st = ssm.ssd_chunked(_t(xd), _t(dtA), _t(B_), _t(C_), chunk,
                            initial_state=_t(s0), rows=True)
    jy, jst = jssm.ssd_chunked(*(jnp.asarray(a) for a in (xd, dtA, B_, C_)),
                               chunk, initial_state=jnp.asarray(s0))
    for got, want in ((y, jy), (st, jst)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=2e-5 * np.abs(want).max())


def test_flash_plain_q_offset_matches_jax(jax_ref):
    """The flash wrapper on the CPU (its plain version) with a per-row
    ``q_offset``: each row's chunk over keys at absolute positions, keys
    past the chunk masked."""
    rng = np.random.default_rng(4)
    q, k, v = (_rand(rng, 3, 6, 8, 16), _rand(rng, 3, 20, 2, 16),
               _rand(rng, 3, 20, 2, 16))
    off = np.array([0, 5, 14], np.int32)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True,
                          q_offset=torch.from_numpy(off))
    want = np.asarray(j_dense(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True,
                              q_offset=jnp.asarray(off)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


# ------------------------------------------------ the kernel's reads

def _emulate(plan, b=None):
    """What the kernel computes for ``plan``: its operands read at the
    plan's strides (float64 products), then the result's view."""
    X = torch.as_strided(plan.x, (plan.G1, plan.G2, plan.M, plan.K),
                         plan.sx, plan.x.storage_offset())
    W = torch.as_strided(plan.w, (plan.G1, plan.G2, plan.K, plan.N),
                         plan.sw, plan.w.storage_offset())
    y = (X.double() @ W.double()).reshape(-1, plan.M, plan.N)
    if b is not None:
        y = y + b.double()
    return y.view(plan.shape).permute(plan.perm)


def test_plans_read_the_operands_in_place():
    rng = np.random.default_rng(5)
    x = _t(_rand(rng, 2, 3, 16))
    w, table = _t(_rand(rng, 16, 8)), _t(_rand(rng, 40, 16))
    for wt in (w, table.T):
        plan = gemm_plan(x, wt)
        assert plan.w.data_ptr() == wt.data_ptr()
        torch.testing.assert_close(_emulate(plan),
                                   x.double() @ wt.double())
    assert gemm_plan(x, table.T).sw[2:] == (1, 16)      # n-major, in place
    xe = _t(_rand(rng, 4, 7, 16))
    we = _t(_rand(rng, 4, 16, 8))
    torch.testing.assert_close(_emulate(bmm_plan(xe, we)),
                               torch.bmm(xe.double(), we.double()))
    for eq, (a, b) in _ssd_operands(rng).items():
        a, b = _t(a), _t(b)
        plan = einsum_plan(eq, a, b)
        assert plan.x.data_ptr() == a.data_ptr()
        assert plan.w.data_ptr() == b.data_ptr()
        torch.testing.assert_close(
            _emulate(plan), torch.einsum(eq, a.double(), b.double()))


def test_plan_copies_an_operand_that_does_not_merge():
    """A row index group that forms no single stride is copied once."""
    rng = np.random.default_rng(6)
    a = _t(_rand(rng, 3, 4, 5)).permute(1, 0, 2)      # (4, 3, 5) view
    b = _t(_rand(rng, 5, 6))
    plan = einsum_plan("ijk,kn->ijn", a, b)
    assert plan.x.data_ptr() != a.data_ptr()
    torch.testing.assert_close(_emulate(plan),
                               torch.einsum("ijk,kn->ijn", a.double(),
                                            b.double()))
    with pytest.raises(ValueError):
        einsum_plan("ij,jk->i", a[0], b)


# ------------------------------------------------------- meta (dry run)

def test_meta_calls_record_costs():
    _build.META_COSTS.clear()
    m = dict(device="meta")
    x = torch.empty((4, 512, 4096), dtype=torch.bfloat16, **m)
    w = torch.empty((4096, 1024), dtype=torch.bfloat16, **m)
    assert rows_gemm(x, w).shape == (4, 512, 1024)
    xe = torch.empty((8, 96, 512), dtype=torch.bfloat16, **m)
    we = torch.empty((8, 512, 768), dtype=torch.bfloat16, **m)
    assert rows_bmm(xe, we).shape == (8, 96, 768)
    a = torch.empty((2, 3, 4, 64, 64), **m)
    bb = torch.empty((2, 3, 64, 4, 16), **m)
    assert rows_einsum("bchkl,bclhp->bckhp", a, bb).shape == (2, 3, 64, 4,
                                                             16)
    c = _build.META_COSTS["rows_gemm"]
    assert c["calls"] == 3
    assert c["flops"] == 2 * (2048 * 1024 * 4096 + 8 * 96 * 768 * 512
                              + 24 * 64 * 16 * 64)
    assert c["bytes"] == (2 * (x.numel() + w.numel() + 2048 * 1024)
                          + 2 * (xe.numel() + we.numel() + 8 * 96 * 768)
                          + 4 * (a.numel() + bb.numel() + 24 * 64 * 16))
    y = torch.empty((2048, 4096), dtype=torch.bfloat16, **m)
    s = torch.empty(4096, dtype=torch.bfloat16, **m)
    assert rms_norm(y, s, 1e-5).shape == y.shape
    assert rms_norm(y, s, 1e-5, z=y).shape == y.shape
    r = _build.META_COSTS["rms_norm"]
    assert r["calls"] == 2
    assert r["flops"] == 14 * y.numel()
    assert r["bytes"] == 2 * 2 * y.numel() + 3 * 2 * y.numel() + 2 * 4 * 4096
    q = torch.empty((4, 512, 32, 128), dtype=torch.bfloat16, **m)
    kv = torch.empty((4, 1024, 8, 128), dtype=torch.bfloat16, **m)
    off = torch.empty((4,), dtype=torch.int32, **m)
    assert flash_attention(q, kv, kv, causal=True, q_offset=off).shape == \
        q.shape
    assert _build.META_COSTS["flash_attention"]["calls"] == 1
    _build.META_COSTS.clear()


# ------------------------------------------------------------- the card

ROWS_MS = (1, 7, 64, 448, 512, 1024)


def _rows_bitwise(fn, x):
    full = fn(x)
    n = x.shape[0]
    for m in ROWS_MS:
        assert torch.equal(fn(x[:m]), full[:m]), m
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0)
                          ).to(x.device)
    assert torch.equal(fn(x[perm]), full[perm])
    assert torch.equal(fn(x[3:3 + 200]), full[3:3 + 200])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
def test_gpu_rows_gemm(cuda, dtype, tol):
    """bf16 and float32 against ``x @ w`` (cuBLAS; both sum in f32 and
    round once in bf16), k-major and n-major weights and a bias; each row
    bitwise at every row count."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((1024, 512), generator=gen, device=cuda).to(dtype)
    w = (torch.randn((512, 264), generator=gen, device=cuda)
         / 512 ** 0.5).to(dtype)
    t = (torch.randn((392, 512), generator=gen, device=cuda)
         / 512 ** 0.5).to(dtype)
    b = torch.randn(264, generator=gen, device=cuda).to(dtype)
    before = rows_gemm.launches
    torch.testing.assert_close(rows_gemm(x, w, b), x @ w + b, rtol=tol,
                               atol=tol)
    torch.testing.assert_close(rows_gemm(x, t.T), x @ t.T, rtol=tol,
                               atol=tol)
    assert rows_gemm.launches - before == 2
    _rows_bitwise(lambda r: rows_gemm(r, w, b), x)
    _rows_bitwise(lambda r: rows_gemm(r, t.T), x)
    torch.cuda.synchronize()


# the bf16 kernel's tile edges: K off its 64-k stage, N off its column
# tile (128 columns up to N = 2048, else 256), rows across its 128-row tile
EDGE_MS = (1, 127, 129, 257)


@pytest.mark.gpu
@pytest.mark.parametrize("K,N,lay", [(520, 264, "k"), (520, 392, "n"),
                                     (512, 2312, "k"), (520, 2312, "n")])
def test_gpu_rows_gemm_tile_edges(cuda, K, N, lay):
    """bf16 against the float32 product (1e-2) with and without a bias, and
    each row bitwise the same at M = 1, 127, 129 and 257 as at 300."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((300, K), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((K, N) if lay == "k" else (N, K), generator=gen,
                     device=cuda) / K ** 0.5).bfloat16()
    w = w if lay == "k" else w.T                   # the table, in place
    b = torch.randn(N, generator=gen, device=cuda).bfloat16()
    want = x.float() @ w.float()
    torch.testing.assert_close(rows_gemm(x, w).float(), want, rtol=1e-2,
                               atol=1e-2)
    torch.testing.assert_close(rows_gemm(x, w, b).float(), want + b.float(),
                               rtol=1e-2, atol=1e-2)
    for fn in (lambda r: rows_gemm(r, w), lambda r: rows_gemm(r, w, b)):
        full = fn(x)
        for m in EDGE_MS:
            assert torch.equal(fn(x[:m]), full[:m]), m
        assert torch.equal(fn(x[129:]), full[129:])
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_gpu_rows_bmm_rows_cross_a_tile(cuda):
    """A batch of 3 whose 200 rows cross the 128-row tile, K off the
    stage: against the float32 bmm, and each batch's rows bitwise at M =
    1, 127 and 129 as at 200 (and batch 2 alone as among three)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    xe = torch.randn((3, 200, 520), generator=gen, device=cuda).bfloat16()
    we = (torch.randn((3, 520, 136), generator=gen, device=cuda)
          / 520 ** 0.5).bfloat16()
    full = rows_bmm(xe, we)
    torch.testing.assert_close(full.float(),
                               torch.bmm(xe.float(), we.float()),
                               rtol=1e-2, atol=1e-2)
    for m in EDGE_MS[:3]:
        assert torch.equal(rows_bmm(xe[:, :m], we), full[:, :m]), m
    assert torch.equal(rows_bmm(xe[2:], we[2:]), full[2:])
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_gpu_rows_bmm_and_einsums(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    xe = torch.randn((4, 96, 256), generator=gen, device=cuda).bfloat16()
    we = torch.randn((4, 256, 128), generator=gen, device=cuda).bfloat16()
    torch.testing.assert_close(rows_bmm(xe, we), torch.bmm(xe, we),
                               rtol=1e-2, atol=1e-2 * 16)
    assert torch.equal(rows_bmm(xe[:, :40], we), rows_bmm(xe, we)[:, :40])
    rng = np.random.default_rng(7)
    for eq, (a, b) in _ssd_operands(rng, b=3, c=4, k=16, h=6, p=8,
                                     n=16).items():
        a, b = _t(a).to(cuda), _t(b).to(cuda)
        got = rows_einsum(eq, a, b)
        torch.testing.assert_close(got, torch.einsum(eq, a, b), rtol=1e-4,
                                   atol=1e-4)
        assert torch.equal(rows_einsum(eq, a[:1], b[:1]), got[:1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-5)])
def test_gpu_rms_norm(cuda, dtype, tol):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((1024, 1000), generator=gen, device=cuda).to(dtype)
    z = torch.randn((1024, 1000), generator=gen, device=cuda).to(dtype)
    s = torch.randn(1000, generator=gen, device=cuda).to(dtype)
    before = rms_norm.launches
    torch.testing.assert_close(rms_norm(x, s, 1e-5),
                               layers._rms_norm_fwd(x, s, 1e-5), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(rms_norm(x, s.float(), 1e-5, z=z),
                               gated_rms_norm_ref(x, z, s.float(), 1e-5),
                               rtol=tol, atol=tol)
    assert rms_norm.launches - before == 2
    _rows_bitwise(lambda r: rms_norm(r, s, 1e-5), x)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gpu_flash_q_offset_chunks_equal_whole(cuda, dtype):
    """Against ``dense_attention`` with the offsets (3e-2 in bf16, 1e-4 in
    float32), and the prefill's contract: chunks at their offsets over a
    buffer whose keys past the chunk are other data give the whole
    sequence's rows bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    H, KV, D, S = 8, 2, 64, 448
    q, k, v = [torch.randn((2, S, n, D), generator=gen, device=cuda
                           ).to(dtype) for n in (H, KV, KV)]
    off = torch.tensor([64, 192], dtype=torch.int32, device=cuda)
    got = flash_attention(q[:, :128].contiguous(), k, v, causal=True,
                          q_offset=off)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(
        got, dense_attention(q[:, :128], k, v, causal=True, q_offset=off),
        rtol=tol, atol=tol)
    whole = flash_attention(q, k, v, causal=True)
    for chunk in (64, 192):
        for s0 in range(0, S, chunk):
            n = min(chunk, S - s0)
            buf = s0 + n + 96
            kb = torch.randn((2, buf, KV, D), generator=gen,
                             device=cuda).to(dtype)
            vb = torch.randn((2, buf, KV, D), generator=gen,
                             device=cuda).to(dtype)
            kb[:, :s0 + n] = k[:, :s0 + n]
            vb[:, :s0 + n] = v[:, :s0 + n]
            o = flash_attention(q[:, s0:s0 + n].contiguous(), kb, vb,
                                causal=True,
                                q_offset=torch.full((2,), s0,
                                                    dtype=torch.int32,
                                                    device=cuda))
            assert torch.equal(o, whole[:, s0:s0 + n]), (chunk, s0)


@pytest.mark.gpu
def test_gpu_rope_rows_at_an_offset(cuda):
    x = torch.randn((2, 512, 8, 128), device=cuda).bfloat16()
    whole = layers.apply_rope(x, torch.arange(512, device=cuda)[None],
                              10000.0)
    for s0, n in ((0, 64), (320, 128)):
        pos = (torch.full((2, 1), s0, device=cuda)
               + torch.arange(n, device=cuda)[None])
        assert torch.equal(layers.apply_rope(x[:, s0:s0 + n].contiguous(),
                                             pos, 10000.0),
                           whole[:, s0:s0 + n])
