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
* The float32 kernel's choices: ``f32_tile`` at the MoE routers' and the
  SSD's shapes of qwen3-moe, jamba and mamba2 at 256 and 2,048 tokens (the
  grid covers the SMs where the outputs allow; N <= 32 takes a 16-column
  tile; a router prefill of 16k rows and 8 batches of 2,048 rows take the
  128 x 16 tile), the C launch's tile table against ``F32_TILES``, and
  the strides from which the C launch picks each operand's copy, for the
  routers and the SSD's four products (which operand is contiguous along
  k, which along its rows, and whether its other strides allow 16-byte
  copies).
* ``gpu``: each kernel against its plain version on the card, and its
  rows bitwise across row counts, permutations and shifts; the float32
  kernel bitwise equal to its order's oracle (``rows_gemm_f32_ordered``)
  over a grid of M, N and K, both orientations of each operand, with and
  without a bias, two batch axes one of stride 0, on the 128 x 16 tile
  with 16- and 4-byte copies and a slice's tail, and at the routers' and
  the SSD's shapes (also within 1e-4 of torch's); chunks at their offsets
  bitwise the whole sequence's through flash; RoPE's rows at an offset
  bitwise.  Run them on a card with ``pytest -m gpu``.
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
from repro_torch.kernels.rows_gemm import ops as rows_ops
from repro_torch.kernels.rows_gemm.ops import (bmm_plan, einsum_plan,
                                               gemm_plan, rows_bmm,
                                               rows_einsum, rows_gemm,
                                               rows_gemm_f32_ordered)
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


@pytest.mark.parametrize("gated", [False, True])
def test_rms_norm_bf16_scale_equals_its_float32_scale(gated):
    """The wrapper takes the scale in its own dtype: a bf16 scale gives
    the bits of the same scale cast to float32 (bf16 -> float32 is exact),
    on the plain path, and the same shape and recorded cost on ``meta``."""
    rng = np.random.default_rng(3)
    x = _t(_rand(rng, 6, 96), torch.bfloat16)
    z = _t(_rand(rng, 6, 96), torch.bfloat16) if gated else None
    s16 = _t(_rand(rng, 96), torch.bfloat16)
    assert torch.equal(rms_norm(x, s16, 1e-5, z=z),
                       rms_norm(x, s16.float(), 1e-5, z=z))
    m = dict(device="meta")
    xm = torch.empty((2048, 4096), dtype=torch.bfloat16, **m)
    zm = None if z is None else xm
    costs = []
    for sm in (torch.empty(4096, dtype=torch.bfloat16, **m),
               torch.empty(4096, dtype=torch.float32, **m)):
        _build.META_COSTS.clear()
        assert rms_norm(xm, sm, 1e-5, z=zm).shape == xm.shape
        costs.append(dict(_build.META_COSTS["rms_norm"]))
    assert costs[0] == costs[1] and costs[0]["calls"] == 1


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


# ------------------------------------ the float32 kernel's tile, copies

def _ssd_dims(arch):
    """(heads, head dim, d_state, chunk) of ``arch``'s mamba layers."""
    cfg = ARCHS[arch]
    di = cfg.ssm_expand * cfg.d_model
    return di // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_chunk


def _ssd_shapes(arch, tokens):
    """(G, M, N, K) of the SSD's four products (``SSD_EQS``) for one
    prefill chunk of ``tokens`` tokens: one row of 256, or four of 512."""
    h, p, n, k = _ssd_dims(arch)
    b, l = (1, 256) if tokens == 256 else (4, 512)
    c = l // k
    return {SSD_EQS[0]: (b * c, k, k, n), SSD_EQS[1]: (b * c * h, k, p, k),
            SSD_EQS[2]: (b * c, h * p, n, k), SSD_EQS[3]: (b * c, k, h * p, n)}


def _f32_shapes():
    """(label, tokens, (G, M, N, K)) of the float32 products the prefill
    runs: qwen3-moe's and jamba's routers and the SSD of mamba2 and jamba,
    at an admission chunk's 256 tokens and at 2,048."""
    out = []
    for tokens in (256, 2048):
        for arch in ("qwen3-moe-30b-a3b", "jamba-1.5-large-398b"):
            cfg = ARCHS[arch]
            out.append((f"{arch} router", tokens,
                        (1, tokens, cfg.moe_num_experts, cfg.d_model)))
        for arch in ("mamba2-130m", "jamba-1.5-large-398b"):
            for eq, shape in _ssd_shapes(arch, tokens).items():
                out.append((f"{arch} {eq}", tokens, shape))
    return out


@pytest.mark.parametrize("label,tokens,shape", _f32_shapes(),
                         ids=lambda v: str(v).replace(" ", "_"))
def test_f32_tile_covers_the_sms(label, tokens, shape):
    """The tile fills the card wherever the smallest tile would, pads at
    most ``F32_WASTE`` of its outputs unless it is the smallest, and N <=
    32 takes a 16-column tile."""
    G, M, N, K = shape
    t = rows_ops.f32_tile(G, M, N)
    bm, bn = rows_ops.F32_TILES[t]
    fill = rows_ops.F32_FILL * rows_ops.SMS
    smallest = len(rows_ops.F32_TILES) - 1
    if N <= 32:
        assert bn == 16
    if rows_ops.f32_ctas(smallest, G, M, N) >= fill:
        assert rows_ops.f32_ctas(t, G, M, N) >= fill
    if t != smallest:
        assert -(-M // bm) * bm * -(-N // bn) * bn <= (
            rows_ops.F32_WASTE * M * N)


def test_f32_tile_table_is_the_launchs():
    """``F32_TILES`` (index: rows, columns) is the C launch's table."""
    import re
    src = _build.source("rows_gemm").read_text()
    tiles = dict(re.findall(r"using (\w+) = F32Tile<(\d+, \d+),", src))
    cases = re.findall(r"case (\d): return launch_f32<(\w+)>", src)
    assert {int(i): tuple(map(int, tiles[t].split(", ")))
            for i, t in cases} == dict(enumerate(rows_ops.F32_TILES))


# shapes that take the 128 x 16 tile: a float32 router prefill of 16k rows
# at 16 and 30 columns (ragged rows and columns), 8 batches of 2,048 rows
NARROW_SHAPES = ((1, 16384, 16), (1, 16381, 30), (8, 2048, 30))


@pytest.mark.parametrize("G,M,N", NARROW_SHAPES)
def test_f32_narrow_shapes_take_the_narrow_tile(G, M, N):
    assert rows_ops.f32_tile(G, M, N) == 3
    assert rows_ops.F32_TILES[3] == (128, 16)


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b"])
def test_ssd_plans_copy_each_operand_along_its_contiguous_axis(
        arch, monkeypatch):
    """The SSD's four products at full width, as ``ssd_chunked`` lays out
    their operands (one row of 256 tokens): each is read in place,
    k-contiguous (C and B in the scores, ``Lm`` in ``y_diag``, C in
    ``y_off``, and the previous states, k-major for ``y_off``) or
    contiguous along its rows (x in the states, m-contiguous; the
    n-contiguous x of ``y_diag`` and B of the states), its base and other
    strides 16-byte aligned: the C launch copies each 16 bytes along its
    contiguous axis."""
    want = {SSD_EQS[0]: ("k", "k"), SSD_EQS[1]: ("k", "n"),
            SSD_EQS[2]: ("m", "n"), SSD_EQS[3]: ("k", "k")}
    seen = {}

    def recording(eq, a, b):
        plan = einsum_plan(eq, a, b)
        assert plan.x.data_ptr() == a.data_ptr()
        assert plan.w.data_ptr() == b.data_ptr()
        seen[eq] = plan
        return torch.einsum(eq, a, b)

    monkeypatch.setattr(ssm, "rows_einsum", recording)
    h, p, n, chunk = _ssd_dims(arch)
    b, l = 1, 256
    g = torch.Generator().manual_seed(8)
    ssm.ssd_chunked(torch.randn((b, l, h, p), generator=g),
                    -torch.rand((b, l, h), generator=g),
                    torch.randn((b, l, n), generator=g),
                    torch.randn((b, l, n), generator=g), chunk, rows=True)
    for eq, (xa, wa) in want.items():
        plan = seen[eq]
        (x1, x2, xm, xk), (w1, w2, wk, wn) = plan.sx, plan.sw
        assert ("k" if xk == 1 else "m" if xm == 1 else None) == xa, eq
        assert ("k" if wk == 1 else "n" if wn == 1 else None) == wa, eq
        other = (x1, x2, xm if xa == "k" else xk, w1, w2,
                 wn if wa == "k" else wk)
        assert all(s % 4 == 0 for s in other), (eq, plan.sx, plan.sw)
        assert plan.x.data_ptr() % 16 == 0 and plan.w.data_ptr() % 16 == 0


def test_router_and_table_copies():
    """The strides (x: batch, batch, row, k; w: batch, batch, k, column)
    from which the C launch picks each copy: the router's x k-contiguous
    with whole 16-byte rows (16 bytes along k), its (D, E) weight
    n-contiguous (16 bytes along n); the embedding table read in place as
    its transpose, k-contiguous (16 bytes along k); a view whose row
    stride is not a multiple of 4 floats (4 bytes along k), a weight whose
    k stride is not (4 bytes along n), an operand contiguous along neither
    axis (4 bytes along k)."""
    x, router = torch.zeros(8, 2048), torch.zeros(2048, 128)
    table = torch.zeros(300, 64)
    plan = gemm_plan(x, router)
    assert (plan.sx, plan.sw) == ((0, 0, 2048, 1), (0, 0, 128, 1))
    assert gemm_plan(x[:, :64], table.T).sw == (0, 0, 1, 64)
    odd = torch.zeros(8, 67)[:, :64]
    assert gemm_plan(odd, table.T).sx == (0, 0, 67, 1)
    assert gemm_plan(odd[:, :8], odd).sw == (0, 0, 67, 1)
    plan = gemm_plan(x[:, ::2], router[::2, ::2])
    assert (plan.sx, plan.sw) == ((0, 0, 2048, 2), (0, 0, 256, 2))


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


# the float32 kernel against its order's oracle: every (M, N, K) of this
# grid, the operands' orientations and the bias turning over with the case
F32_MS = (1, 7, 64, 255, 256, 2048, 4097)
F32_NS = (1, 16, 24, 128, 130, 1536)
F32_KS = (1, 15, 17, 128, 2048, 8192)


def _f32_operands(gen, dev, M, N, K, case):
    """x (M, K) k- or m-contiguous, w (K, N) n- or k-contiguous, a bias
    or None, by the bits of ``case``."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = randn(M, K) if case & 1 else randn(K, M).T
    w = (randn(K, N) if case & 2 else randn(N, K).T) / K ** 0.5
    return x, w, randn(N) if case & 4 else None


@pytest.mark.gpu
@pytest.mark.parametrize("M", F32_MS)
def test_gpu_f32_equals_the_ordered_oracle(cuda, M):
    """Bitwise the oracle's over N x K, all four orientations and the
    bias among the cases; then two batch axes, one of stride 0, through
    ``rows_einsum``."""
    gen = torch.Generator(device=cuda).manual_seed(10 + M)
    case = 0
    for N in F32_NS:
        for K in F32_KS:
            x, w, b = _f32_operands(gen, cuda, M, N, K, case)
            case += 1
            got = rows_gemm(x, w, b)
            assert torch.equal(got, rows_gemm_f32_ordered(gemm_plan(x, w),
                                                          b)), (N, K, case)
    a = torch.randn((3, 2, M, 17), generator=gen, device=cuda)
    wb = torch.randn((3, 1, 17, 130), generator=gen, device=cuda).expand(
        3, 2, 17, 130)
    plan = einsum_plan("ghmk,ghkn->ghmn", a, wb)
    assert plan.G1 * plan.G2 == 6 and 0 in plan.sw[:2]
    assert torch.equal(rows_einsum("ghmk,ghkn->ghmn", a, wb),
                       rows_gemm_f32_ordered(plan))
    torch.cuda.synchronize()


def _f32_narrow_operands(gen, dev, G, M, N, K, case):
    """x (G, M, K) k- or m-contiguous and w (G, K, N) n- or k-contiguous
    by the bits 1 and 2 of ``case``, each cut from one wider by a float
    along its contiguous axis with bit 8 (a row or k stride that is not a
    multiple of 4 floats: 4-byte copies)."""
    pad = 1 if case & 8 else 0

    def randn(rows, cols):
        return torch.randn((G, rows, cols + pad), generator=gen,
                           device=dev)[..., :cols]
    x = randn(M, K) if case & 1 else randn(K, M).transpose(1, 2)
    w = randn(K, N) if case & 2 else randn(N, K).transpose(1, 2)
    return x, w / K ** 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("G,M,N", NARROW_SHAPES)
def test_gpu_f32_narrow_tile_equals_the_ordered_oracle(cuda, G, M, N):
    """The 128 x 16 tile bitwise the oracle's at K = 15 and 17 (a slice's
    tail) and 8,192, both orientations of each operand, 16- and 4-byte
    copies, and (one batch) with a bias and without."""
    assert rows_ops.f32_tile(G, M, N) == 3
    gen = torch.Generator(device=cuda).manual_seed(20 + N)
    for K in (15, 17, 8192):
        for case in range(16):
            x, w = _f32_narrow_operands(gen, cuda, G, M, N, K, case)
            b = None
            if G == 1:
                x, w = x[0], w[0]
                if case & 4:
                    b = torch.randn(N, generator=gen, device=cuda)
                got, plan = rows_gemm(x, w, b), gemm_plan(x, w)
            else:
                got, plan = rows_bmm(x, w), bmm_plan(x, w)
            assert torch.equal(got, rows_gemm_f32_ordered(plan, b)), (
                K, case)
            del x, w, got, plan
    torch.cuda.synchronize()


def _f32_family_operands(gen, dev, label, tokens):
    """(call, plan, torch's call) of one of ``_f32_shapes``: the router
    as ``x @ w``, an SSD product as its einsum on operands laid out as
    ``ssd_chunked`` makes them."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    arch, what = label.split(" ", 1)
    if what == "router":
        cfg = ARCHS[arch]
        x = randn(tokens, cfg.d_model)
        w = randn(cfg.d_model, cfg.moe_num_experts) / cfg.d_model ** 0.5
        return (lambda: rows_gemm(x, w)), gemm_plan(x, w), (lambda: x @ w)
    h, p, n, k = _ssd_dims(arch)
    b, l = (1, 256) if tokens == 256 else (4, 512)
    c = l // k
    ops = {SSD_EQS[0]: ((b, c, k, n), (b, c, k, n)),
           SSD_EQS[1]: ((b, c, h, k, k), (b, c, k, h, p)),
           SSD_EQS[2]: ((b, c, k, h, p), (b, c, k, n)),
           SSD_EQS[3]: ((b, c, k, n), (b, c, h, p, n))}
    sa, sb = ops[what]
    a, bb = randn(*sa), randn(*sb)
    return ((lambda: rows_einsum(what, a, bb)), einsum_plan(what, a, bb),
            (lambda: torch.einsum(what, a, bb)))


@pytest.mark.gpu
@pytest.mark.parametrize("label,tokens,shape", _f32_shapes(),
                         ids=lambda v: str(v).replace(" ", "_"))
def test_gpu_f32_family_shapes(cuda, label, tokens, shape):
    """The routers' and the SSD's products bitwise the oracle's and within
    1e-4 of torch's (which sums in another order; TF32 is off)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    call, plan, lib = _f32_family_operands(gen, cuda, label, tokens)
    assert (plan.G1 * plan.G2, plan.M, plan.N, plan.K) == shape
    got = call()
    assert torch.equal(got, rows_gemm_f32_ordered(plan))
    torch.testing.assert_close(got, lib(), rtol=1e-4, atol=1e-4)
    torch.cuda.synchronize()


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


# the configurations' norm widths (reduced 64; mamba2 768 and its gated
# 1536; whisper 1024; qwen3-moe / paligemma 2048; granite 4096; qwen2.5 /
# llama4 5120; jamba / qwen2-72b 8192 and jamba's gated 16384) and a
# width past the register kernel's (the two-pass loop)
RMS_WIDTHS = (64, 768, 1024, 1536, 2048, 4096, 5120, 8192, 16384, 20000)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gpu_rms_norm_is_the_two_pass_order(cuda, dtype):
    """The one-read kernel keeps the two-pass kernel's sums: bitwise equal
    to it (``rms_norm_two_pass``) at every width in ``ROWS_MS`` and the
    configurations' widths, plain and gated, with a bf16 and a float32
    scale, and one launch a call with a bf16 scale."""
    from repro_torch.kernels.rms_norm.ops import rms_norm_two_pass
    gen = torch.Generator(device=cuda).manual_seed(5)
    for n in ROWS_MS + RMS_WIDTHS:
        x = torch.randn((9, n), generator=gen, device=cuda).to(dtype)
        z = torch.randn((9, n), generator=gen, device=cuda).to(dtype)
        s = torch.randn(n, generator=gen, device=cuda).to(torch.bfloat16)
        for gate in (None, z):
            before = rms_norm.launches
            got = rms_norm(x, s, 1e-5, z=gate)
            assert rms_norm.launches - before == 1
            assert torch.equal(got, rms_norm_two_pass(x, s, 1e-5, z=gate)), n
            assert torch.equal(got, rms_norm(x, s.float(), 1e-5, z=gate)), n
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [(8, 2, 64), (8, 1, 256), (16, 16, 64),
                                   (32, 8, 128), (16, 4, 128)], ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gpu_flash_q_offset_chunks_equal_whole(cuda, dtype, heads):
    """Against ``dense_attention`` with the offsets (3e-2 in bf16, 1e-4 in
    float32), and the prefill's contract: chunks at their offsets over a
    buffer whose keys past the chunk are other data give the whole
    sequence's rows bitwise; at 8/2 heads of 64, paligemma-3b's 8/1 of
    256, whisper-medium's 16/16 of 64, granite-8b's 32/8 of 128 and a
    token-split rank's 16/4 of 128 (chunks of 64 on 64-row CTAs, of 192
    on 128-row ones)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    (H, KV, D), S = heads, 448
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
