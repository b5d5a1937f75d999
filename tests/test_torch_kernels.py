"""The port's kernels: plain versions against the JAX package, and (on a
card) the CUDA kernels against their plain versions.

On the CPU each wrapper takes its plain version, so the first group holds
the plain versions to the JAX Pallas kernels in interpret mode (as
``tests/test_kernels.py`` runs them) and to the jnp oracles: the RSW
exactly, attention within 2e-5 (float32) or 3e-2 (bfloat16).  The
``gpu`` group runs only where ``torch.cuda.is_available()``, and needs no
JAX: on a card machine without it, run ``pytest -m gpu`` on this file.
"""
import inspect

import numpy as np
import numpy.testing as npt
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.kernels.flash_attention.flash_attention import (
        flash_attention_pallas)
    from repro.kernels.paged_attention.paged_attention import (
        paged_attention_pallas)
    from repro.kernels.paged_attention.ref import (
        paged_attention_ref as j_paged_ref)
    from repro.kernels.utopia_rsw.ref import rsw_ref as j_rsw_ref
    from repro.kernels.utopia_rsw.utopia_rsw import rsw_pallas
    from repro.models.attention import dense_attention as j_dense
    from repro.serve.decode import _hybrid_lookup as j_hybrid_lookup
except ImportError:         # a card machine without JAX: gpu tests only
    jnp = None
from repro_torch.core import HybridConfig, HybridKVManager
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import (MAX_SPLIT,
                                                     paged_attention,
                                                     split_plan)
from repro_torch.kernels.paged_attention.ref import (normalize,
                                                     paged_attention_ref)
from repro_torch.kernels.utopia_rsw.ops import utopia_rsw
from repro_torch.kernels.utopia_rsw.ref import rsw_ref
from repro_torch.models.attention import dense_attention

torch.set_num_threads(2)

HASHES = ["modulo", "xor_fold", "prime_displacement", "mersenne",
          "multiplicative"]


@pytest.fixture
def jax_ref():
    if jnp is None:
        pytest.skip("needs the JAX package (jax is not installed)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _tables(hash_name):
    """A populated manager's tables (the port's manager: its state equals
    the JAX manager's, ``test_torch_core.py``)."""
    m = HybridKVManager(HybridConfig(
        total_slots=256, restseg_fraction=0.75, assoc=8, max_seqs=16,
        max_blocks_per_seq=32, hash_name=hash_name))
    for sid in range(6):
        m.register_sequence(sid)
        for b in range(20):
            m.allocate_block(sid, b)
    return m.tar, m.sf, m.flex_table.reshape(-1)


# ------------------------------------------------------------------- RSW

@pytest.mark.parametrize("hash_name", HASHES)
@pytest.mark.parametrize("n", [100, 16 * 32])
def test_rsw_plain_matches_pallas_and_oracle(hash_name, n, jax_ref):
    tar, sf, flex = _tables(hash_name)
    vpns = np.arange(n, dtype=np.int32)[::-1].copy()   # not a tile multiple
    got = utopia_rsw(_t(vpns), _t(tar), _t(sf), _t(flex),
                     hash_name=hash_name)
    jv = (jnp.asarray(vpns), jnp.asarray(tar), jnp.asarray(sf),
          jnp.asarray(flex))
    pallas = rsw_pallas(*jv, hash_name=hash_name, tile=128, interpret=True)
    oracle = j_rsw_ref(*jv, hash_name=hash_name)
    for g, p, o in zip(got[:3], pallas, oracle):
        npt.assert_array_equal(g.numpy(), np.asarray(p))
        npt.assert_array_equal(g.numpy(), np.asarray(o))
    _, _, _, acc = j_hybrid_lookup(jv[0], jv[1], jv[2], jv[3], hash_name)
    npt.assert_array_equal(got[3].numpy(), np.asarray(acc))
    assert utopia_rsw.launches == 0          # CPU tensors: plain version


def _big_tag_tables():
    n_sets, assoc = 4, 4
    tar = np.zeros((n_sets, assoc), np.int32)
    big = [1 << 24, (1 << 24) + 6, (1 << 25) + 3, (1 << 26) + 9]
    for v in big:
        s = v % n_sets
        tar[s, int(np.nonzero(tar[s] == 0)[0][0])] = v + 1
    sf = (tar != 0).sum(axis=1).astype(np.int32)
    q = np.asarray(big + [v + 1 for v in big] + [v - 1 for v in big]
                   + [0, 7], np.int32)
    return tar, sf, -np.ones(16, np.int32), q


def test_rsw_plain_large_tags_exact(jax_ref):
    tar, sf, flex, q = _big_tag_tables()
    got = rsw_ref(_t(q), _t(tar), _t(sf), _t(flex))
    want = j_rsw_ref(jnp.asarray(q), jnp.asarray(tar), jnp.asarray(sf),
                     jnp.asarray(flex))
    for g, w in zip(got, want):
        npt.assert_array_equal(g.numpy(), np.asarray(w))


def _out_of_range_case(hash_name):
    """A populated manager's TAR/SF with a flex table that maps its first,
    last and a third of its other entries, queried at vpns past its end
    and below zero (JAX's gather: -1 is the last entry, then clamp)."""
    tar, sf, flex = _tables(hash_name)
    rng = np.random.RandomState(11)
    V = flex.size
    flex = np.where(rng.rand(V) < 0.35, rng.randint(0, 4096, V), -1)
    flex[[0, V - 1, V - 2]] = [7, 4001, 4002]
    q = np.asarray([V, V + 1, V + 77, 1 << 30, -1, -2, -V, -V - 1, -V - 100,
                    -(1 << 31), 0, 5, V - 1], np.int32)
    return q, tar, sf, flex.astype(np.int32)


@pytest.mark.parametrize("hash_name", HASHES)
def test_rsw_plain_out_of_range_flex_gather_matches_jax(hash_name, jax_ref):
    q, tar, sf, flex = _out_of_range_case(hash_name)
    got = rsw_ref(_t(q), _t(tar), _t(sf), _t(flex), hash_name=hash_name)
    want = j_rsw_ref(jnp.asarray(q), jnp.asarray(tar), jnp.asarray(sf),
                     jnp.asarray(flex), hash_name=hash_name)
    for g, w in zip(got, want):
        npt.assert_array_equal(g.numpy(), np.asarray(w))
    mapped = got[2].numpy().astype(bool)
    assert mapped[:4].any() and mapped[4:10].any()   # the clamps read maps


# --------------------------------------------------------- paged attention

def _paged_inputs(B, Q, H, KV, D, bs, nblk, nslots, seed, per_query=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(*((B, H, D) if Q is None else (B, Q, H, D)))
    kp = rng.randn(nslots, bs, KV, D)
    vp = rng.randn(nslots, bs, KV, D)
    slots = rng.randint(0, nslots, (B, nblk)).astype(np.int32)
    slots[0, nblk // 2] = -1                        # hole
    if per_query:
        base = rng.randint(0, bs * nblk - Q, B)
        ctx = (base[:, None] + 1 + np.arange(Q)[None, :]).astype(np.int32)
        ctx[0, 0] = 0                               # zero-extent column
    else:
        ctx = rng.randint(1, bs * nblk, B).astype(np.int32)
        ctx[0] = 0                                  # empty row: l == 0
        if B > 2:
            ctx[1] = bs * (nblk // 2)               # block boundary
    return (q.astype(np.float32), kp.astype(np.float32),
            vp.astype(np.float32), slots, ctx)


PAGED_CASES = [
    # B, Q, H, KV, D, bs, nblk, nslots, per-query ctx
    (3, None, 8, 2, 32, 16, 6, 64, False),
    (2, None, 4, 4, 16, 8, 4, 32, False),
    (3, None, 8, 1, 64, 32, 8, 96, False),
    (3, 4, 8, 2, 32, 16, 6, 64, False),
    (2, 5, 4, 2, 16, 8, 6, 64, True),
    (2, None, 8, 2, 80, 16, 5, 32, False),
    (2, 3, 4, 1, 256, 16, 4, 32, True),
]


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_pallas_and_oracle(case, dtype, jax_ref):
    *shape, per_query = case
    q, kp, vp, slots, ctx = _paged_inputs(*shape, seed=sum(shape[2:6]),
                                          per_query=per_query)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jkp, jvp = jnp.asarray(kp, jdt), jnp.asarray(vp, jdt)
    jargs = (jnp.asarray(q), jkp, jvp, jnp.asarray(slots), jnp.asarray(ctx))
    got = paged_attention(_t(q), _t(kp, tdt), _t(vp, tdt), _t(slots),
                          _t(ctx))
    wants = [j_paged_ref(*jargs)]
    if dtype == "float32":      # interpret mode is slow: one dtype suffices
        wants.append(paged_attention_pallas(*jargs, interpret=True))
    tol = 2e-5 if dtype == "float32" else 3e-2
    for want in wants:
        for g, w in zip(got, want):
            npt.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)
    # the zero-extent row (or query column) carries no weight at all
    o, m, l = got
    empty = (0, 0) if per_query else (0,)
    assert (l[empty] == 0).all() and (normalize(o, l)[empty] == 0).all()
    assert (l[1:] > 0).all()


def _striped_case():
    """Model-axis token striping: each of 4 shards holds bs/4 tokens of
    every block (tok_offset = shard * bs/4, block_tokens = bs)."""
    B, H, KV, D, bs, nblk, nslots, TP = 2, 4, 2, 16, 16, 4, 32, 4
    q, kp, vp, slots, _ = _paged_inputs(B, None, H, KV, D, bs, nblk, nslots,
                                        3)
    ctx = np.asarray([60, 37], np.int32)
    lo = [t * (bs // TP) for t in range(TP)]
    shards = [(kp[:, o:o + bs // TP].copy(), vp[:, o:o + bs // TP].copy(), o)
              for o in lo]
    return q, slots, ctx, bs, shards


def test_paged_plain_token_striped_shards_match_oracle(jax_ref):
    q, slots, ctx, bs, shards = _striped_case()
    for kp, vp, off in shards:
        got = paged_attention(_t(q), _t(kp), _t(vp), _t(slots), _t(ctx),
                              tok_offset=off, block_tokens=bs)
        want = j_paged_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                           jnp.asarray(slots), jnp.asarray(ctx),
                           tok_offset=off, block_tokens=bs)
        for g, w in zip(got, want):
            npt.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                atol=2e-5)


@pytest.mark.parametrize("nblk", [1, 2, 5, 7, 8, 9, 16, 17, 31, 64, 1000])
def test_paged_split_plan_covers_each_block_once(nblk):
    n_split, per = split_plan(nblk)
    assert 1 <= n_split <= MAX_SPLIT
    chunks = [range(s * per, min(nblk, (s + 1) * per))
              for s in range(n_split)]
    assert all(len(c) > 0 for c in chunks)              # no idle chunk
    assert sorted(j for c in chunks for j in c) == list(range(nblk))


def test_paged_split_plan_depends_on_nblk_only():
    """The plan takes nblk and nothing else, so it is the same whatever
    the batch, the queries or the extents, call after call."""
    assert list(inspect.signature(split_plan).parameters) == ["nblk"]
    plans = [split_plan(n) for n in range(1, 200)]
    assert plans == [split_plan(n) for n in range(1, 200)]


def test_paged_q1_query_rank_round_trip():
    q, kp, vp, slots, ctx = _paged_inputs(2, None, 4, 2, 16, 8, 4, 32, 5)
    a = paged_attention(_t(q), _t(kp), _t(vp), _t(slots), _t(ctx))
    b = paged_attention(_t(q)[:, None], _t(kp), _t(vp), _t(slots), _t(ctx))
    for x, y in zip(a, b):
        assert torch.equal(x, y[:, 0])


# --------------------------------------------------------- flash attention

FLASH_SHAPES = [(2, 128, 4, 2, 32), (1, 256, 8, 8, 16), (2, 64, 4, 1, 64),
                (1, 128, 6, 3, 32), (2, 8, 4, 2, 16)]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_dense(shape, dtype, causal, jax_ref):
    B, S, H, KV, D = shape
    rng = np.random.RandomState(S + H)
    q, k, v = (rng.randn(B, S, n, D).astype(np.float32)
               for n in (H, KV, KV))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    got = flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal=causal)
    assert got.dtype == tdt and got.shape == (B, S, H, D)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    want_dense = np.asarray(j_dense(jq, jk, jv, causal=causal), np.float32)
    npt.assert_allclose(got.float().numpy(), want_dense, rtol=tol, atol=tol)
    if dtype == "bfloat16":     # interpret mode is slow: one dtype suffices
        return
    want_pallas = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=causal, q_tile=64, kv_tile=64, interpret=True),
        np.float32)
    npt.assert_allclose(got.float().numpy(), want_pallas, rtol=tol, atol=tol)


def test_dense_attention_row_offsets_and_kv_len(jax_ref):
    """Per-row q_offset and kv_len of the plain version (JAX contract)."""
    rng = np.random.RandomState(1)
    q = rng.randn(2, 8, 4, 16).astype(np.float32)
    k = rng.randn(2, 24, 2, 16).astype(np.float32)
    v = rng.randn(2, 24, 2, 16).astype(np.float32)
    off = np.asarray([16, 5], np.int32)
    kvl = np.asarray([24, 13], np.int32)
    got = dense_attention(_t(q), _t(k), _t(v), q_offset=_t(off),
                          kv_len=_t(kvl))
    want = j_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   q_offset=jnp.asarray(off), kv_len=jnp.asarray(kvl))
    npt.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# ------------------------------------------ on the card: kernel vs plain

@pytest.mark.gpu
@pytest.mark.parametrize("hash_name", HASHES)
def test_gpu_rsw_kernel_matches_plain(cuda, hash_name):
    tar, sf, flex = _tables(hash_name)
    vpns = np.arange(16 * 32, dtype=np.int32)
    args = [_t(a) for a in (vpns, tar, sf, flex)]
    want = rsw_ref(*args, hash_name=hash_name)
    n0 = utopia_rsw.launches
    got = utopia_rsw(*[a.to(cuda) for a in args], hash_name=hash_name)
    torch.cuda.synchronize()
    assert utopia_rsw.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    tar, sf, flex, q = _big_tag_tables()
    args = [_t(a) for a in (q, tar, sf, flex)]
    got = utopia_rsw(*[a.to(cuda) for a in args])
    for g, w in zip(got, rsw_ref(*args)):
        assert torch.equal(g.cpu(), w)
    args = [_t(a) for a in _out_of_range_case(hash_name)]
    got = utopia_rsw(*[a.to(cuda) for a in args], hash_name=hash_name)
    for g, w in zip(got, rsw_ref(*args, hash_name=hash_name)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_gpu_paged_kernel_matches_plain(cuda, case, dtype, q_dtype):
    """Every q/pool dtype pair; bf16 q with a bf16 pool is the decode
    path's tensor-core arithmetic."""
    *shape, per_query = case
    q, kp, vp, slots, ctx = _paged_inputs(*shape, seed=3,
                                          per_query=per_query)
    tdt = getattr(torch, dtype)
    args = (_t(q, getattr(torch, q_dtype)), _t(kp, tdt), _t(vp, tdt),
            _t(slots), _t(ctx))
    want = paged_attention_ref(*[a.to(cuda) for a in args])
    n0 = paged_attention.launches
    got = paged_attention(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert paged_attention.launches == n0 + 1
    # float32 sums on the CUDA cores unless both are bf16 (tensor cores)
    tol = 3e-2 if dtype == q_dtype == "bfloat16" else 1e-4
    for g, w in zip(got, want):
        npt.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=tol,
                            atol=tol)


@pytest.mark.gpu
def test_gpu_paged_kernel_token_striped_shards(cuda):
    q, slots, ctx, bs, shards = _striped_case()
    for kp, vp, off in shards:
        args = [_t(a).to(cuda) for a in (q, kp, vp, slots, ctx)]
        got = paged_attention(*args, tok_offset=off, block_tokens=bs)
        want = paged_attention_ref(*args, tok_offset=off, block_tokens=bs)
        for g, w in zip(got, want):
            npt.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-4,
                                atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FLASH_SHAPES + [(2, 1000, 32, 8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_gpu_flash_kernel_matches_plain(cuda, shape, dtype, causal):
    B, S, H, KV, D = shape
    g = torch.Generator(device=cuda).manual_seed(S)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.randn(B, S, n, D, generator=g, device=cuda).to(tdt)
               for n in (H, KV, KV))
    want = dense_attention(q, k, v, causal=causal)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    tol = 1e-4 if dtype == "float32" else 3e-2
    npt.assert_allclose(got.float().cpu().numpy(),
                        want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_paged_kernel_batch_and_query_rank_invariant(cuda, dtype):
    """Bitwise: each row alone equals the same row in the batch of 4, and
    Q=1 equals column 0 of Q=4 (the split follows nblk only)."""
    B, H, KV, D, bs, nblk = 4, 32, 8, 128, 64, 16
    rng = np.random.RandomState(7)
    tdt = getattr(torch, dtype)
    q4 = _t(rng.randn(B, 4, H, D).astype(np.float32)).to(cuda, tdt)
    kp = _t(rng.randn(81, bs, KV, D).astype(np.float32)).to(cuda, tdt)
    vp = _t(rng.randn(81, bs, KV, D).astype(np.float32)).to(cuda, tdt)
    slots = _t(rng.permutation(80)[:B * nblk].reshape(B, nblk)
               .astype(np.int32)).to(cuda)
    slots[0, 5] = -1
    ctx = torch.tensor([1024, 700, 64, 301], dtype=torch.int32, device=cuda)
    q1 = q4[:, 0].contiguous()
    full = paged_attention(q1, kp, vp, slots, ctx)
    for b in range(B):
        alone = paged_attention(q1[b:b + 1].contiguous(), kp, vp,
                                slots[b:b + 1].contiguous(), ctx[b:b + 1])
        for x, y in zip(alone, full):
            assert torch.equal(x[0], y[b])
    wide = paged_attention(q4, kp, vp, slots, ctx)
    for x, y in zip(full, wide):
        assert torch.equal(x, y[:, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1000, 32, 8, 128), (3, 8, 32, 8, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_gpu_flash_kernel_ragged_lengths(cuda, shape, causal):
    B, S, H, KV, D = shape
    g = torch.Generator(device=cuda).manual_seed(S + 1)
    q, k, v = (torch.randn(B, S, n, D, generator=g, device=cuda)
               .to(torch.bfloat16) for n in (H, KV, KV))
    got = flash_attention(q, k, v, causal=causal)
    want = dense_attention(q, k, v, causal=causal)
    npt.assert_allclose(got.float().cpu().numpy(),
                        want.float().cpu().numpy(), rtol=3e-2, atol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("skv", [77, 333])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_gpu_flash_kernel_kv_longer_or_shorter(cuda, skv, dtype, causal):
    """Skv != Sq: key j is visible to query i when j <= i (causal)."""
    B, S, H, KV, D = 2, 200, 8, 2, 128
    g = torch.Generator(device=cuda).manual_seed(skv)
    tdt = getattr(torch, dtype)
    q = torch.randn(B, S, H, D, generator=g, device=cuda).to(tdt)
    k, v = (torch.randn(B, skv, KV, D, generator=g, device=cuda).to(tdt)
            for _ in range(2))
    got = flash_attention(q, k, v, causal=causal)
    want = dense_attention(q, k, v, causal=causal)
    tol = 1e-4 if dtype == "float32" else 3e-2
    npt.assert_allclose(got.float().cpu().numpy(),
                        want.float().cpu().numpy(), rtol=tol, atol=tol)
