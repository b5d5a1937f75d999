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
    from repro.serve.decode import DecodeSpec as JDecodeSpec
    from repro.serve.decode import _hybrid_lookup as j_hybrid_lookup
    from repro.serve.decode import _paged_attn_local_ref as j_paged_local
    from repro.serve.decode import translate_step as j_translate_step
except ImportError:         # a card machine without JAX: gpu tests only
    jnp = None
from repro_torch.core import HybridConfig, HybridKVManager
from repro_torch.kernels.flash_attention.ops import (SMS, FlashPlan,
                                                     flash_attention,
                                                     flash_plan)
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ops import (MAX_FOLD, MAX_SPLIT,
                                                     cta_grid, fold_ctas,
                                                     paged_attention,
                                                     query_tile, read_plan,
                                                     split_plan)
from repro_torch.kernels.paged_attention.ref import (normalize,
                                                     paged_attention_ref)
from repro_torch.kernels.utopia_rsw.ops import (utopia_rsw,
                                                utopia_translate_step)
from repro_torch.kernels.utopia_rsw.ref import (StepTranslation, rsw_ref,
                                                translate_step_ref)
from repro_torch.serve import decode
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


def _tables(hash_name, assoc=8):
    """A populated manager's tables (the port's manager: its state equals
    the JAX manager's, ``test_torch_core.py``)."""
    m = HybridKVManager(HybridConfig(
        total_slots=256, restseg_fraction=0.75, assoc=assoc, max_seqs=16,
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


# ----------------------------------------------- the step's translation

def _step_tables(hash_name, restseg_fraction, B, nblk, bs, slots, seed=0):
    """A populated manager's tables and a batch's pre-step context lengths
    and active mask: row 0 is active but idle past its vpn range, row 1's
    write block is unmapped, row 2 is inactive; the other rows are mapped
    up to their write block.  Blocks are allocated block-major over the
    rows, so some land in the RestSeg and the rest go flexible."""
    m = HybridKVManager(HybridConfig(
        block_size=bs, total_slots=slots, restseg_fraction=restseg_fraction,
        assoc=8, max_seqs=B, max_blocks_per_seq=nblk, hash_name=hash_name))
    rng = np.random.RandomState(seed)
    ctx = rng.randint(0, nblk * bs, B).astype(np.int32)
    ctx[0] = nblk * bs + 5
    ctx[1] = max(ctx[1], bs)
    last = np.minimum(ctx // bs, nblk - 1)
    last[1] -= 1
    for sid in range(B):
        m.register_sequence(sid)
    for b in range(nblk):
        for sid in range(B):
            if b <= last[sid]:
                m.allocate_block(sid, b)
    active = np.ones(B, bool)
    active[2] = False
    geom = dict(block_size=bs, nblk=nblk, hash_name=hash_name, sink=slots)
    tables = (m.tar[None], m.sf[None], m.flex_table.reshape(1, -1))
    return tables, ctx, active, geom, m.cfg.num_sets


STEP_GEOMETRIES = {
    # B, nblk, bs, pool slots, restseg fraction
    "small": (6, 8, 8, 40, None),
    "engine": (4, 16, 64, 80, 0.75),          # the smoke engine's
    "deployment": (64, 64, 64, 5120, 0.25),   # granite-8b on one H100
}


@pytest.mark.parametrize("hash_name", HASHES)
@pytest.mark.parametrize("restseg_fraction", [0.25, 0.75])
def test_translate_step_plain_matches_jax(hash_name, restseg_fraction,
                                          jax_ref):
    B, nblk, bs, slots, _ = STEP_GEOMETRIES["small"]
    tables, ctx, active, geom, n_sets = _step_tables(
        hash_name, restseg_fraction, B, nblk, bs, slots)
    jspec = JDecodeSpec(block_size=bs, max_blocks_per_seq=nblk,
                        slots_per_group=slots, n_sets=n_sets, assoc=8,
                        hash_name=hash_name)
    want = j_translate_step(*map(jnp.asarray, tables), jnp.asarray(ctx),
                            jspec)
    spec = decode.DecodeSpec(block_size=bs, max_blocks_per_seq=nblk,
                             slots_per_group=slots, n_sets=n_sets, assoc=8,
                             hash_name=hash_name)
    targs = [_t(a) for a in (*tables, ctx)]
    for act in (None, active):
        ta = None if act is None else _t(act)
        for got in (translate_step_ref(*targs, ta, **geom),
                    decode.translate_step(*targs, spec, ta)):
            for f in want._fields:
                w = np.asarray(getattr(want, f))
                if f == "w_valid" and act is not None:
                    w = w & act[None]
                g = getattr(got, f).numpy()
                npt.assert_array_equal(g, w.astype(g.dtype), err_msg=f)
            # what _paged_attn_local_ref derives (decode.py:876-880), where
            # a dropped write (ws == slots) is the port's sink slot
            wv = np.asarray(want.w_valid[0]) & (True if act is None
                                                else act)
            ws = np.where(wv, np.asarray(want.w_slot[0]), slots)
            npt.assert_array_equal(got.w_row.numpy(), ws * bs + ctx % bs)
            assert got.w_row.dtype == torch.int64
            npt.assert_array_equal(got.extent.numpy(), ctx + 1)
            npt.assert_array_equal(got.telemetry.numpy(), np.concatenate(
                [getattr(got, k).reshape(-1).numpy()
                 for k in ("in_rest", "accesses", "mapped")]))
    w_valid = np.asarray(want.w_valid[0])
    assert not w_valid[0] and not w_valid[1] and w_valid[3:].all()
    hit = np.asarray(want.in_rest).reshape(B, nblk)
    mapped = np.asarray(want.mapped).reshape(B, nblk)
    assert hit.any() and (mapped & ~hit).any()      # both halves walked
    assert utopia_translate_step.launches == 0      # CPU: plain version


@pytest.mark.parametrize("restseg_fraction", [0.25, 0.75])
def test_paged_attn_local_writes_and_reads_as_jax(restseg_fraction,
                                                  jax_ref):
    """The decode layer's write through the precomputed flat row and its
    read up to the precomputed extent: the same pool entries and output as
    JAX's ``_paged_attn_local_ref``; a dropped write lands in the sink."""
    B, nblk, bs, slots, _ = STEP_GEOMETRIES["small"]
    H, KV, D = 4, 2, 16
    tables, ctx, active, geom, n_sets = _step_tables(
        "modulo", restseg_fraction, B, nblk, bs, slots)
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(B, n, D).astype(np.float32) for n in (H, KV, KV))
    kp, vp = (rng.randn(slots, bs, KV, D).astype(np.float32)
              for _ in range(2))
    jspec = JDecodeSpec(block_size=bs, max_blocks_per_seq=nblk,
                        slots_per_group=slots, n_sets=n_sets, assoc=8)
    jt = j_translate_step(*map(jnp.asarray, tables), jnp.asarray(ctx), jspec)
    jt = jt._replace(w_valid=jt.w_valid & jnp.asarray(active)[None])
    jout, jkp, jvp = j_paged_local(*map(jnp.asarray, (q, k, v, kp, vp)), jt,
                                   jnp.asarray(ctx), jspec)
    trans = translate_step_ref(*[_t(a) for a in (*tables, ctx)],
                               _t(active), **geom)
    tkp, tvp = (torch.from_numpy(np.concatenate(
        [p, np.zeros((1, bs, KV, D), np.float32)])) for p in (kp, vp))
    out = decode._paged_attn_local(_t(q), _t(k), _t(v), tkp, tvp,
                                   trans.slots[0], trans.w_row, trans.extent)
    npt.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5, atol=2e-5)
    for got, want in ((tkp, jkp), (tvp, jvp)):
        npt.assert_array_equal(got[:slots].numpy(), np.asarray(want))
    # rows 0 (past its range), 1 (unmapped) and 2 (inactive) wrote the sink
    sink_rows = {int(r) for r in trans.w_row[:3]}
    assert sink_rows == {slots * bs + int(c) % bs for c in ctx[:3]}
    assert (tkp[slots].reshape(bs, -1).abs().sum(1) > 0).sum() == len(
        sink_rows)


# ----------------------------- the verify step's windowed translation

WINDOW = 5                   # K + 1 positions of a K = 4 verify step


def _window_tables(hash_name, restseg_fraction, B=6, nblk=8, bs=8,
                   slots=40):
    """Tables and context lengths whose windows of ``WINDOW`` positions
    cross into a mapped next block (row 1), into an unmapped one (row 2),
    run past the last block (row 0), lie past the vpn range (row 4) or
    inside one block (row 5); row 3 is inactive."""
    m = HybridKVManager(HybridConfig(
        block_size=bs, total_slots=slots, restseg_fraction=restseg_fraction,
        assoc=8, max_seqs=B, max_blocks_per_seq=nblk, hash_name=hash_name))
    ctx = np.asarray([nblk * bs - 2, 2 * bs - 2, 3 * bs - 3, bs + 3,
                      nblk * bs + 5, 1], np.int32)
    last = [nblk - 1, 2, 2, 1, nblk - 1, 0]      # last mapped block a row
    for sid in range(B):
        m.register_sequence(sid)
    for b in range(nblk):
        for sid in range(B):
            if b <= last[sid]:
                m.allocate_block(sid, b)
    active = np.ones(B, bool)
    active[3] = False
    geom = dict(block_size=bs, nblk=nblk, hash_name=hash_name, sink=slots)
    tables = (m.tar[None], m.sf[None], m.flex_table.reshape(1, -1))
    return tables, ctx, active, geom, m.cfg.num_sets


@pytest.mark.parametrize("hash_name", HASHES)
@pytest.mark.parametrize("window", [1, WINDOW])
def test_window_translate_plain_matches_jax_gather(hash_name, window,
                                                   jax_ref):
    """The windowed step translation's plain version against what the JAX
    verify step derives from its one translation: the slot and mapped
    flag of each position's block gathered from the walk (the block index
    clamped into the row), valid when mapped, below ``nblk * bs`` and
    active; the flat write row (the sink's row when invalid) and the
    extent ``pos + i + 1``."""
    tables, ctx, active, geom, n_sets = _window_tables(hash_name, 0.25)
    bs, nblk, slots = geom["block_size"], geom["nblk"], geom["sink"]
    jspec = JDecodeSpec(block_size=bs, max_blocks_per_seq=nblk,
                        slots_per_group=slots, n_sets=n_sets, assoc=8,
                        hash_name=hash_name)
    jt = j_translate_step(*map(jnp.asarray, tables), jnp.asarray(ctx), jspec)
    pos = ctx[:, None] + np.arange(window)[None, :]
    blk = np.clip(pos // bs, 0, nblk - 1)
    w_slot = np.take_along_axis(np.asarray(jt.slots[0]), blk, axis=1)
    w_map = np.take_along_axis(np.asarray(jt.mapped[0]), blk, axis=1)
    got = translate_step_ref(*[_t(a) for a in (*tables, ctx)], _t(active),
                             window=window, **geom)
    w_valid = w_map & (pos < nblk * bs) & active[:, None]
    squeeze = (lambda a: a[:, 0]) if window == 1 else (lambda a: a)
    npt.assert_array_equal(got.w_slot[0].numpy(), squeeze(w_slot))
    npt.assert_array_equal(got.w_valid[0].numpy(), squeeze(w_valid))
    npt.assert_array_equal(got.w_row.numpy(), squeeze(
        np.where(w_valid, w_slot, slots) * bs + pos % bs))
    npt.assert_array_equal(got.extent.numpy(), squeeze(pos + 1))
    for f in ("slots", "in_rest", "mapped", "accesses"):
        npt.assert_array_equal(getattr(got, f).numpy(),
                               np.asarray(getattr(jt, f)), err_msg=f)
    if window > 1:
        wv = got.w_valid[0].numpy().astype(bool)
        assert wv[1].all() and wv[2, :3].all() and not wv[2, 3:].any()
        assert wv[0, :2].all() and not wv[0, 2:].any()
        assert not wv[3].any() and not wv[4].any() and wv[5].all()


@pytest.mark.parametrize("hash_name", HASHES)
def test_window_one_buffer_is_the_decode_layout(hash_name, jax_ref):
    """At W = 1 the step's one output buffer is, word for word, the decode
    step's layout built from JAX's ``translate_step``: w_row (int64), the
    write slot, its validity, the extent, then in_rest, accesses, mapped
    and the slots."""
    B, nblk, bs, slots, _ = STEP_GEOMETRIES["small"]
    tables, ctx, active, geom, n_sets = _step_tables(hash_name, 0.75, B, nblk,
                                                     bs, slots)
    jspec = JDecodeSpec(block_size=bs, max_blocks_per_seq=nblk,
                        slots_per_group=slots, n_sets=n_sets, assoc=8,
                        hash_name=hash_name)
    jt = j_translate_step(*map(jnp.asarray, tables), jnp.asarray(ctx), jspec)
    wv = np.asarray(jt.w_valid[0]) & active
    w_row = np.where(wv, np.asarray(jt.w_slot[0]), slots) * bs + ctx % bs
    want = np.concatenate([
        w_row.astype(np.int64).view(np.int32), np.asarray(jt.w_slot[0]),
        wv.astype(np.int32), ctx + 1]
        + [np.asarray(getattr(jt, f)).reshape(-1).astype(np.int32)
           for f in ("in_rest", "accesses", "mapped", "slots")])
    for window in (None, 1):
        kw = {} if window is None else {"window": window}
        got = translate_step_ref(*[_t(a) for a in (*tables, ctx)],
                                 _t(active), **geom, **kw)
        npt.assert_array_equal(got.out.numpy(), want)
        assert got.w_row.shape == (B,) and got.extent.shape == (B,)


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
    # serving geometries: g = 5 (qwen2.5-14b's 40 / 8 heads), g = 8 at
    # D = 128 (qwen3-moe-30b-a3b's 32 / 4)
    (2, None, 10, 2, 32, 16, 4, 32, False),
    (2, 3, 10, 2, 32, 16, 4, 32, True),
    (2, 4, 8, 1, 128, 16, 4, 32, False),
    # paligemma-3b's 8 / 1 heads of 256 and whisper-medium's 16 / 16 of 64
    (2, None, 8, 1, 256, 16, 4, 32, False),
    (2, 3, 8, 1, 256, 16, 4, 32, True),
    (2, None, 16, 16, 64, 16, 4, 32, False),
    (2, 4, 16, 16, 64, 16, 4, 32, False),
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


@pytest.mark.parametrize("Q", [1, 2, 3, 4, 5, 8, 9, 17, 64, 256])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 6, 8])
def test_paged_query_tiles_cover_each_query_once(Q, g):
    """The grid that ``query_tile`` gives: ceil(Q / QT) query tiles a row,
    none idle, every query in exactly one.  At Q > 1 on the tensor cores
    the QT * G (query, head) rows (g padded to G = 1, 2, 4, 8) are whole
    m16 MMA tiles, two a warp at D <= 128 and one above, so the P V
    accumulators stay at 128 floats a lane; on the CUDA cores QT * G <= 8
    rows keep their state in the registers of 8 heads; at Q = 1 the G <= 8
    heads are rows 0..7 of one MMA."""
    G = 1 << (g - 1).bit_length()
    for D in (16, 64, 80, 128, 200, 256):
        DP = next(p for p in (16, 32, 64, 128, 256) if D <= p)
        for tensor in (True, False):
            qt = query_tile(Q, g, D, tensor)
            rows = qt * G
            if Q == 1:
                assert qt == 1 and rows <= 8
            elif tensor:
                assert rows % 16 == 0 and rows == (32 if D <= 128 else 16)
                assert rows // 16 * (DP // 8) * 4 <= 128
            else:
                assert rows == 8
            B, KV, nblk = 3, 2, 9
            x, y, z = cta_grid(B, Q, g * KV, KV, D, nblk,
                               tensor_cores=tensor)
            plan = read_plan(nblk, KV, D, g)
            n = (fold_ctas(plan, Q, D, tensor) if plan.fold
                 else split_plan(nblk)[0])
            assert (x, z) == (KV * n, B)
            tiles = [range(t * qt, min(Q, (t + 1) * qt)) for t in range(y)]
            assert all(len(t) > 0 for t in tiles)          # no idle tile
            assert [i for t in tiles for i in t] == list(range(Q))


def test_paged_query_tile_depends_on_shape_only():
    """A query's tile follows from (Q, g, D) and the cores alone, never
    from the extents or the batch, and the split from nblk alone: no row's
    plan depends on its neighbours."""
    assert list(inspect.signature(query_tile).parameters) == [
        "Q", "g", "D", "tensor_cores"]
    for B in (1, 4, 64):
        assert cta_grid(B, 256, 32, 8, 128, 16) == (64, 32, B)
        assert cta_grid(B, 5, 32, 8, 128, 16) == (64, 1, B)
        assert cta_grid(B, 1, 32, 8, 128, 16) == (64, 1, B)
        assert cta_grid(B, 5, 32, 8, 128, 16, tensor_cores=False) == (
            64, 3, B)


# (H, KV, D) of the families' attention: granite-8b, qwen2.5-14b,
# qwen3-moe-30b-a3b, jamba-1.5-large-398b, a token-split rank's 16 / 4
CLUSTER_GEOMETRIES = [(32, 8, 128), (40, 8, 128), (32, 4, 128),
                      (64, 8, 128), (16, 4, 128)]
FOLD_GEOMETRIES = [(8, 1, 256), (16, 16, 64)]   # paligemma-3b, whisper


@pytest.mark.parametrize("nblk", [1, 2, 5, 8, 9, 16, 17, 31, 64, 1000])
@pytest.mark.parametrize("heads", FOLD_GEOMETRIES + [(4, 2, 16), (8, 2, 40),
                                                     (4, 4, 200)])
def test_paged_read_plan_covers_each_block_once(nblk, heads):
    """Every plan cuts a row's blocks into chunks of per_split blocks,
    each block in exactly one chunk and no chunk idle; the fold kernel's
    (D = 64 and 256) a chunk a block, with one CTA a chunk at Q <= 8 (two,
    a column half each, on the tensor cores at D = 256) up to 64 chunks,
    else one CTA taking every chunk."""
    H, KV, D = heads
    plan = read_plan(nblk, KV, D, H // KV)
    chunks = [range(s * plan.per_split,
                    min(nblk, (s + 1) * plan.per_split))
              for s in range(plan.n_split)]
    assert all(len(c) > 0 for c in chunks)              # no idle chunk
    assert sorted(j for c in chunks for j in c) == list(range(nblk))
    if not plan.fold:
        assert plan[:2] == split_plan(nblk)
        return
    assert (plan.n_split, plan.per_split) == (nblk, 1)
    halves = 2 if D > 128 else 1
    for Q in (1, 5, 8, 9, 256):
        want = 1 if Q > 8 or nblk > MAX_FOLD else nblk * halves
        assert fold_ctas(plan, Q, D) == want
        assert fold_ctas(plan, Q, D, tensor_cores=False) == (
            1 if want == 1 else nblk)


def test_paged_read_plan_depends_on_geometry_only():
    """The plan takes (nblk, KV, D, g) and nothing else, so no row's plan
    depends on its batch, its queries or the extents; ``cta_grid``'s
    CTAs a row likewise follow from the plan and Q alone."""
    assert list(inspect.signature(read_plan).parameters) == [
        "nblk", "KV", "D", "g"]
    plans = [read_plan(n, kv, d, g) for n in range(1, 80)
             for kv, d, g in ((1, 256, 8), (16, 64, 1), (8, 128, 4))]
    assert plans == [read_plan(n, kv, d, g) for n in range(1, 80)
                     for kv, d, g in ((1, 256, 8), (16, 64, 1), (8, 128, 4))]
    for H, KV, D in FOLD_GEOMETRIES:
        for Q in (1, 5, 256):
            rows = {cta_grid(B, Q, H, KV, D, 16)[0] for B in (1, 4, 64)}
            assert len(rows) == 1
            assert {cta_grid(B, Q, H, KV, D, 16)[2] for B in (1, 4)} == {1, 4}


@pytest.mark.parametrize("heads", CLUSTER_GEOMETRIES)
def test_paged_read_plan_is_split_plan_at_the_cluster_geometries(heads):
    """Granite's, qwen's, jamba's and the token split's reads keep the
    cluster kernel's plan (PRs 12 and 17), so their bits do not move."""
    H, KV, D = heads
    for nblk in (1, 7, 16, 18, 1024):
        plan = read_plan(nblk, KV, D, H // KV)
        assert not plan.fold and plan[:2] == split_plan(nblk)
        for Q in (1, 5, 256):
            assert cta_grid(4, Q, H, KV, D, nblk)[0] == KV * split_plan(
                nblk)[0]


def test_paged_read_plan_fills_the_card_at_the_frontend_reads():
    """paligemma-3b's decode read (B = 4, 8 / 1 heads of 256, 16 blocks of
    64) launches at least 128 CTAs (the cluster kernel's plan gave 32 for
    132 SMs), whisper-medium's (16 / 16 of 64) 1,024; their verify reads
    (Q = 5) a CTA a chunk too; the prefix reads (Q = 256) one CTA a (row,
    query tile, KV head) over every chunk."""
    x, y, z = cta_grid(4, 1, 8, 1, 256, 16)
    assert x * y * z >= 128 and (x, y, z) == (32, 1, 4)
    assert cta_grid(4, 1, 16, 16, 64, 16) == (256, 1, 4)
    assert cta_grid(4, 5, 8, 1, 256, 16) == (32, 3, 4)
    assert cta_grid(4, 5, 16, 16, 64, 16) == (256, 1, 4)
    assert cta_grid(4, 256, 8, 1, 256, 16) == (1, 128, 4)
    assert cta_grid(4, 256, 16, 16, 64, 16) == (16, 8, 4)
    plan = read_plan(16, 1, 256, 8)
    assert fold_ctas(plan, 1, 256) == 32 and plan.n_split <= MAX_FOLD
    assert fold_ctas(read_plan(MAX_FOLD + 1, 1, 256, 8), 1, 256) == 1


def test_paged_cluster_only_switch_restores_the_split_plan(monkeypatch):
    """``CLUSTER_ONLY`` (the measurement switch of chip_smoke.py
    --paged-reads) sends the fold geometries to the cluster kernel's
    plan."""
    monkeypatch.setattr(paged_ops, "CLUSTER_ONLY", True)
    for H, KV, D in FOLD_GEOMETRIES:
        plan = read_plan(16, KV, D, H // KV)
        assert not plan.fold and plan[:2] == split_plan(16)
        assert cta_grid(4, 1, H, KV, D, 16)[0] == KV * split_plan(16)[0]


@pytest.mark.parametrize("heads", FOLD_GEOMETRIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_read_at_the_frontend_geometries_matches_jax(
        heads, dtype, jax_ref):
    """The port's decode read at paligemma-3b's 8 / 1 heads of 256 and
    whisper-medium's 16 / 16 of 64 (64-token blocks, a hole, a zero
    extent, an extent on a block edge) against the JAX oracle within 2e-5
    (float32) or 3e-2 (bf16), and the Pallas kernel in float32."""
    H, KV, D = heads
    q, kp, vp, slots, ctx = _paged_inputs(4, None, H, KV, D, 64, 6, 32,
                                          seed=H + D)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = (jnp.asarray(q), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
             jnp.asarray(slots), jnp.asarray(ctx))
    got = paged_attention(_t(q), _t(kp, tdt), _t(vp, tdt), _t(slots),
                          _t(ctx))
    wants = [j_paged_ref(*jargs)]
    if dtype == "float32":
        wants.append(paged_attention_pallas(*jargs, interpret=True))
    tol = 2e-5 if dtype == "float32" else 3e-2
    for want in wants:
        for g, w in zip(got, want):
            npt.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)
    o, m, l = got
    assert float(l[0].abs().max()) == 0.0 and bool((m[0] == -1e30).all())


def test_paged_q1_query_rank_round_trip():
    q, kp, vp, slots, ctx = _paged_inputs(2, None, 4, 2, 16, 8, 4, 32, 5)
    a = paged_attention(_t(q), _t(kp), _t(vp), _t(slots), _t(ctx))
    b = paged_attention(_t(q)[:, None], _t(kp), _t(vp), _t(slots), _t(ctx))
    for x, y in zip(a, b):
        assert torch.equal(x, y[:, 0])


# --------------------------------------------------------- flash attention

# (B, S, H, KV, D[, Skv]): Skv defaults to S
FLASH_SHAPES = [(2, 128, 4, 2, 32), (1, 256, 8, 8, 16), (2, 64, 4, 1, 64),
                (1, 128, 6, 3, 32), (2, 8, 4, 2, 16),
                (1, 64, 10, 2, 32), (1, 64, 8, 1, 128),   # g = 5; g = 8
                # paligemma-3b's MQA at D = 256; whisper-medium's
                # cross-attention shape: Sq != Skv, Skv no multiple of 64
                (1, 64, 8, 1, 256), (1, 32, 4, 4, 16, 100)]


def _flash_qkv(shape, rng):
    B, S, H, KV, D, *skv = shape
    Skv = skv[0] if skv else S
    return (rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, Skv, KV, D).astype(np.float32),
            rng.randn(B, Skv, KV, D).astype(np.float32))


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_dense(shape, dtype, causal, jax_ref):
    B, S, H, KV, D = shape[:5]
    q, k, v = _flash_qkv(shape, np.random.RandomState(S + H))
    Skv = k.shape[1]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    got = flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal=causal)
    assert got.dtype == tdt and got.shape == (B, S, H, D)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    want_dense = np.asarray(j_dense(jq, jk, jv, causal=causal), np.float32)
    npt.assert_allclose(got.float().numpy(), want_dense, rtol=tol, atol=tol)
    # interpret mode is slow: one dtype suffices; and the Pallas kernel
    # asserts that its 64-row tiles divide both lengths
    if dtype == "bfloat16" or S % min(64, S) or Skv % min(64, Skv):
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


# ------------------------------------------ the bf16 flash launch's plan

# (H, KV, D) of the six families' attention: granite-8b (32/8), a
# token-split rank of it (16/4), qwen2.5-14b (40/8), qwen3-moe (32/4),
# jamba (64/8), paligemma-3b (8/1 of 256), whisper-medium (16/16 of 64)
FLASH_HEADS = [(32, 8, 128), (16, 4, 128), (40, 8, 128), (32, 4, 128),
               (64, 8, 128), (8, 1, 256), (16, 16, 64)]
# the engine's bucket lengths, the vlm's with its 256 image positions
# ahead, and whisper's 1500 encoder frames (its cross-attention's Sq runs
# over the buckets)
FLASH_SQ = (8, 16, 32, 64, 128, 256, 320, 384, 512, 768, 1024, 1280, 1500)


@pytest.mark.parametrize("heads", FLASH_HEADS, ids=str)
@pytest.mark.parametrize("B", [1, 2, 3, 4])
def test_flash_plan_fills_the_card(heads, B):
    """Rows and grid of every launch the serving path makes: D = 128 on
    the ping-pong kernel's 128 rows over a persistent grid of one CTA an
    SM when its 128-row tiles fill the 132 SMs, else (the engine's short
    buckets, a first chunk at B = 1) on the TMA kernel's 64; every other
    head dim on the TMA kernel's 64, so that its grid is the largest a key
    axis left whole allows.  (The launch's K/V stages and shared memory,
    by padded D and rows, are held at compile time by the source's
    static_assert.)"""
    H, KV, D = heads
    for Sq in FLASH_SQ:
        p = flash_plan(B, Sq, H, D)
        if D == 128 and B * H * -(-Sq // 128) >= SMS:
            assert p == (128, SMS)
        else:
            assert p == (64, B * H * -(-Sq // 64))
        assert 1 <= p.ctas <= B * H * -(-Sq // p.rows)


def test_flash_plan_depends_on_b_sq_h_d_alone():
    """The plan takes (B, Sq, H, D) and nothing else: the same for any KV
    (qwen3-moe's 32/4 and granite-8b's 32/8) and for a repeat, and 128
    rows at D = 128 exactly when B * H * ceil(Sq / 128) reaches the SMs."""
    assert list(inspect.signature(flash_plan).parameters) == [
        "B", "Sq", "H", "D"]
    for B in (1, 2, 4):
        for H in (16, 32, 40, 64):
            for Sq in FLASH_SQ:
                p = flash_plan(B, Sq, H, 128)
                assert p == flash_plan(B, Sq, H, 128)
                assert p.rows == (128 if B * H * -(-Sq // 128) >= SMS
                                  else 64)
    # granite-8b's prefill (2 x 1024, 512 tiles), a token-split rank's
    # (256), qwen3-moe's first chunk (1 x 256, 64 tiles) and a short bucket
    assert flash_plan(2, 1024, 32, 128) == (128, SMS)
    assert flash_plan(2, 1024, 16, 128) == (128, SMS)
    assert flash_plan(1, 256, 32, 128) == (64, 128)
    assert flash_plan(4, 64, 32, 128) == (64, 128)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_meta_cost_by_shape(causal):
    """The dry run's cost of a flash call on ``meta`` tensors: the pairs
    of its mask (half the square when causal), 4 D flops a pair and head,
    and q, k, v read and the output written once, whatever the plan."""
    from repro_torch.kernels import _build
    B, S, H, KV, D = 2, 1024, 32, 8, 128
    q = torch.empty(B, S, H, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, S, KV, D, dtype=torch.bfloat16, device="meta")
    _build.META_COSTS.clear()
    out = flash_attention(q, k, k, causal=causal)
    assert out.shape == q.shape and out.device.type == "meta"
    pairs = S * S // 2 if causal else S * S
    assert dict(_build.META_COSTS["flash_attention"]) == dict(
        calls=1, flops=4 * B * H * D * pairs,
        bytes=2 * (2 * B * S * H * D + 2 * B * S * KV * D))
    _build.META_COSTS.clear()


@pytest.mark.parametrize("B,Sq,H,D,rows,ctas", [
    (2, 512, 8, 256, 64, 128),      # paligemma-3b's prefill
    (4, 256, 8, 256, 64, 128),      # its exact prefix-KV chunk
    (2, 256, 16, 64, 64, 128),      # whisper's cross-attention
    (4, 256, 16, 64, 64, 256),      # its decoder's self-attention
    (2, 1500, 16, 64, 64, 768),     # its encoder
    (1, 1280, 8, 256, 64, 160),     # paligemma's longest recompute bucket
    (8, 512, 8, 256, 64, 512), (1, 512, 8, 256, 64, 64),
    (8, 512, 16, 64, 64, 1024), (1, 512, 16, 64, 64, 128)])
def test_flash_plan_at_the_frontend_shapes(B, Sq, H, D, rows, ctas):
    p = flash_plan(B, Sq, H, D)
    assert (p.rows, p.ctas) == (rows, ctas)


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
@pytest.mark.parametrize("assoc", [4, 6, 12, 16])
def test_gpu_rsw_kernel_any_assoc(cuda, assoc):
    """The walk's three TAR reads: two 16-byte loads at assoc 8 (above),
    a loop of them at any other multiple of 4, scalar loads otherwise."""
    tar, sf, flex = _tables("modulo", assoc)
    args = [_t(a) for a in (np.arange(16 * 32, dtype=np.int32), tar, sf,
                            flex)]
    got = utopia_rsw(*[a.to(cuda) for a in args])
    want = rsw_ref(*args)
    assert want[1].any() and not want[1].all()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", ["engine", "deployment"])
@pytest.mark.parametrize("hash_name", HASHES)
def test_gpu_translate_step_kernel_matches_plain(cuda, geometry, hash_name):
    """The step entry against ``translate_step_ref`` at the smoke engine's
    geometry and at a granite-8b deployment's (64 rows of 64 blocks, a
    5120-slot pool), with a row past its vpn range, an unmapped write block
    and an inactive row; one launch per call."""
    B, nblk, bs, slots, frac = STEP_GEOMETRIES[geometry]
    tables, ctx, active, geom, _ = _step_tables(hash_name, frac, B, nblk, bs,
                                                slots)
    args = [_t(a) for a in (*tables, ctx)]
    for act in (None, _t(active)):
        want = translate_step_ref(*args, act, **geom)
        n0 = utopia_translate_step.launches
        got = utopia_translate_step(*[a.to(cuda) for a in args],
                                    None if act is None else act.to(cuda),
                                    **geom)
        torch.cuda.synchronize()
        assert utopia_translate_step.launches == n0 + 1
        for f in StepTranslation._fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


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
@pytest.mark.parametrize("shape", FLASH_SHAPES + [
    (2, 1000, 32, 8, 128), (2, 512, 40, 8, 128),
    # paligemma-3b's prefill; whisper-medium's encoder and cross-attention
    (2, 512, 8, 1, 256), (2, 1500, 16, 16, 64), (2, 256, 16, 16, 64, 1500)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_gpu_flash_kernel_matches_plain(cuda, shape, dtype, causal):
    B, S, H, KV, D = shape[:5]
    Skv = shape[5] if len(shape) > 5 else S
    g = torch.Generator(device=cuda).manual_seed(S)
    tdt = getattr(torch, dtype)
    q = torch.randn(B, S, H, D, generator=g, device=cuda).to(tdt)
    k, v = (torch.randn(B, Skv, KV, D, generator=g, device=cuda).to(tdt)
            for _ in range(2))
    want = dense_attention(q, k, v, causal=causal)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    tol = 1e-4 if dtype == "float32" else 3e-2
    npt.assert_allclose(got.float().cpu().numpy(),
                        want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [(8, 1, 256), (32, 8, 128)], ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_gpu_flash_query_bits_do_not_depend_on_the_batch(cuda, causal,
                                                         heads):
    """A query's bf16 output at paligemma-3b's 8/1 heads of 256 is bitwise
    the same in a launch of one row (64 CTAs) as in one of eight (512),
    also at per-row offsets; likewise at granite-8b's 32/8 heads of 128,
    where one row runs 256 64-row CTAs and eight 132 persistent 128-row
    ones."""
    (H, KV, D), S = heads, 512
    g = torch.Generator(device=cuda).manual_seed(D + causal)
    q = torch.randn(8, S, H, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(8, S + 64, KV, D, generator=g, device=cuda)
            .bfloat16() for _ in range(2))
    offs = [None] + ([torch.tensor([64 * (i % 2) for i in range(8)],
                                   dtype=torch.int32, device=cuda)]
                     if causal else [])
    for off in offs:
        many = flash_attention(q, k, v, causal=causal, q_offset=off)
        for b in (0, 5):
            one = flash_attention(
                q[b:b + 1].contiguous(), k[b:b + 1].contiguous(),
                v[b:b + 1].contiguous(), causal=causal,
                q_offset=None if off is None else off[b:b + 1].contiguous())
            assert torch.equal(one[0], many[b]), (b, off is not None)


@pytest.mark.gpu
@pytest.mark.parametrize("Sq", [8, 16, 32, 64])
def test_gpu_flash_short_launch_rows_equal_long(cuda, Sq):
    """granite-8b's heads (32/8 of 128): the rows of a causal Sq <= 64
    launch (64-row CTAs, one warpgroup) equal, bitwise, the same queries'
    rows inside an Sq = 1024 launch (128-row tiles, two warpgroups, on the
    persistent grid), at offset 0 and as a chunk at offset 448 over the
    same keys."""
    g = torch.Generator(device=cuda).manual_seed(Sq)
    q = torch.randn(2, 1024, 32, 128, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, 1024, 8, 128, generator=g, device=cuda)
            .bfloat16() for _ in range(2))
    assert flash_plan(2, Sq, 32, 128).rows == 64
    assert flash_plan(2, 1024, 32, 128).rows == 128
    whole = flash_attention(q, k, v, causal=True)
    head = flash_attention(q[:, :Sq].contiguous(), k[:, :Sq].contiguous(),
                           v[:, :Sq].contiguous(), causal=True)
    assert torch.equal(head, whole[:, :Sq])
    chunk = flash_attention(
        q[:, 448:448 + Sq].contiguous(), k, v, causal=True,
        q_offset=torch.full((2,), 448, dtype=torch.int32, device=cuda))
    assert torch.equal(chunk, whole[:, 448:448 + Sq])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 1024, 32, 8), (2, 520, 16, 4),
                                   (1, 256, 32, 4), (3, 200, 8, 2)],
                         ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_gpu_flash_d128_designs_same_bits(cuda, shape, causal):
    """At D = 128 every bf16 design gives the plan's bits: one 64-row
    warpgroup a CTA, two on a CTA a 128-row tile, and two on persistent
    grids of 132, 7 and 1 CTAs (tiles in the snake order), also at
    per-row offsets."""
    B, S, H, KV = shape
    g = torch.Generator(device=cuda).manual_seed(S + causal)
    q = torch.randn(B, S, H, 128, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, S + 64, KV, 128, generator=g, device=cuda)
            .bfloat16() for _ in range(2))
    offs = [None] + ([torch.arange(B, dtype=torch.int32, device=cuda) * 32]
                     if causal else [])
    tiles = B * H * -(-S // 128)
    plans = [FlashPlan(64, B * H * -(-S // 64)), FlashPlan(128, tiles),
             FlashPlan(128, min(tiles, 132)), FlashPlan(128, 7),
             FlashPlan(128, 1)]
    for off in offs:
        want = flash_attention(q, k, v, causal=causal, q_offset=off)
        for p in plans:
            got = flash_attention(q, k, v, causal=causal, q_offset=off,
                                  plan=p)
            assert torch.equal(got, want), (p, off is not None)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [80, 200])
def test_gpu_flash_q_offset_tile_order_keeps_bits(cuda, B):
    """Per-row offsets at D = 128 with 160 (row, query tile) classes,
    which the persistent grid takes longest first, and 400, past the
    sorted order's 256, which keep the query tiles' rank order: each
    output bitwise one 64-row warpgroup a CTA's."""
    S, H, KV = 256, 4, 2
    g = torch.Generator(device=cuda).manual_seed(B)
    q = torch.randn(B, S, H, 128, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, 1024, KV, 128, generator=g, device=cuda)
            .bfloat16() for _ in range(2))
    off = (torch.arange(B, dtype=torch.int32, device=cuda) * 197) % 769
    assert flash_plan(B, S, H, 128).rows == 128
    got = flash_attention(q, k, v, causal=True, q_offset=off)
    one = flash_attention(q, k, v, causal=True, q_offset=off,
                          plan=FlashPlan(64, B * H * S // 64))
    assert torch.equal(got, one)


@pytest.mark.gpu
def test_gpu_flash_cross_rows_equal_at_any_sq(cuda):
    """whisper-medium's full cross-attention (16/16 heads of 64 over 1500
    frames): the rows of Sq = 64 calls equal the same queries inside Sq =
    256, bitwise."""
    g = torch.Generator(device=cuda).manual_seed(1500)
    q = torch.randn(2, 256, 16, 64, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, 1500, 16, 64, generator=g, device=cuda)
            .bfloat16() for _ in range(2))
    whole = flash_attention(q, k, v, causal=False)
    for s0 in (0, 64, 192):
        part = flash_attention(q[:, s0:s0 + 64].contiguous(), k, v,
                               causal=False)
        assert torch.equal(part, whole[:, s0:s0 + 64]), s0


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [(32, 8, 128), (8, 1, 256), (16, 16, 64)],
                         ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_paged_kernel_batch_and_query_rank_invariant(cuda, dtype, heads):
    """Bitwise: each row alone equals the same row in the batch of 4, and
    Q=1 equals column 0 of Q=4 (the split follows the geometry only), at
    granite-8b's heads (the cluster kernel) and paligemma-3b's and
    whisper-medium's (the fold kernel), where a second launch also gives
    the same bits (the fold's counters reset themselves)."""
    H, KV, D = heads
    B, bs, nblk = 4, 64, 16
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
    again = paged_attention(q1, kp, vp, slots, ctx)
    for x, y in zip(again, full):
        assert torch.equal(x, y)


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


@pytest.mark.gpu
@pytest.mark.parametrize("hash_name", HASHES)
@pytest.mark.parametrize("window", [1, WINDOW])
def test_gpu_window_translate_kernel_matches_plain(cuda, hash_name, window):
    """The step entry with a window of positions against its plain
    version, exactly, in every field: windows crossing into a mapped and
    an unmapped block, past the last block and the vpn range, and an
    inactive row; still one launch per call."""
    tables, ctx, active, geom, _ = _window_tables(hash_name, 0.25)
    args = [_t(a) for a in (*tables, ctx)]
    for act in (None, _t(active)):
        want = translate_step_ref(*args, act, window=window, **geom)
        n0 = utopia_translate_step.launches
        got = utopia_translate_step(*[a.to(cuda) for a in args],
                                    None if act is None else act.to(cuda),
                                    window=window, **geom)
        torch.cuda.synchronize()
        assert utopia_translate_step.launches == n0 + 1
        assert torch.equal(got.out.cpu(), want.out)


def _gpu_tiled_case(cuda, Q, dtype, per_query, H=32, KV=8, D=128, bs=64,
                    nblk=16, seed=0):
    """Three rows with holes; (B,) extents with a zero row, or (B, Q)
    extents pos+1 .. pos+Q (the verify read's) with a zero column."""
    B = 3
    rng = np.random.RandomState(seed + Q)
    tdt = getattr(torch, dtype)
    q = _t(rng.randn(B, Q, H, D).astype(np.float32)).to(cuda, tdt)
    kp = _t(rng.randn(81, bs, KV, D).astype(np.float32)).to(cuda, tdt)
    vp = _t(rng.randn(81, bs, KV, D).astype(np.float32)).to(cuda, tdt)
    slots = rng.permutation(80)[:B * nblk].reshape(B, nblk).astype(np.int32)
    slots[0, 3] = slots[1, 1] = -1
    cap = bs * nblk
    if per_query:
        pos = np.asarray([cap - Q, min(130, cap - Q), 0])
        ext = pos[:, None] + 1 + np.arange(Q)[None, :]
        ext[2, 0] = 0
    else:
        ext = np.asarray([cap - 24, 0, 301])
    return (q, kp, vp, _t(slots).to(cuda),
            _t(ext.astype(np.int32)).to(cuda))


def _assert_queries_are_single_launches(q, kp, vp, slots, ext, **kw):
    n0 = paged_attention.launches
    wide = paged_attention(q, kp, vp, slots, ext, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == n0 + 1
    for i in range(q.shape[1]):
        e = ext[:, i].contiguous() if ext.dim() == 2 else ext
        one = paged_attention(q[:, i].contiguous(), kp, vp, slots, e, **kw)
        for x, y in zip(one, wide):
            assert torch.equal(x, y[:, i]), f"query {i}"
    return wide


@pytest.mark.gpu
@pytest.mark.parametrize("Q", [2, 3, 4, 5, 8, 9, 17, 64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_query", [False, True])
def test_gpu_paged_query_tiles_equal_single_query(cuda, Q, dtype, per_query):
    """The query-tiled read: query i of a Q-query launch is bitwise a
    Q = 1 launch at its extent (granite-8b's H=32, KV=8, D=128; f32 on the
    CUDA cores, bf16 on the tensor cores), with holes and a zero extent
    (l == 0, m == -1e30); one launch a call."""
    case = _gpu_tiled_case(cuda, Q, dtype, per_query)
    o, m, l = _assert_queries_are_single_launches(*case)
    zero = (2, 0) if per_query else (1,)
    assert float(l[zero].abs().max()) == 0.0
    assert bool((m[zero] == -1e30).all())
    want = paged_attention_ref(*case)
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    for g, w in zip((o, m, l), want):
        npt.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=tol,
                            atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [(8, 8, 64), (16, 2, 256), (12, 4, 80),
                                   (4, 2, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_paged_query_tiles_other_shapes(cuda, heads, dtype):
    """Query tiles at g = 1, 8, 3 (padded to 4) and 2 and D = 64, 256, 80
    and 16 (bf16: QT = 32, 2, 8 and 16): query i bitwise a Q = 1
    launch."""
    H, KV, D = heads
    for Q, per_query in ((5, True), (33, False)):
        _assert_queries_are_single_launches(*_gpu_tiled_case(
            cuda, Q, dtype, per_query, H=H, KV=KV, D=D, bs=16, nblk=12))


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [(40, 8, 128), (32, 4, 128), (8, 1, 256),
                                   (16, 16, 64)])
def test_gpu_paged_reads_at_serving_geometries(cuda, heads):
    """qwen2.5-14b's g = 5 (query tiles padded to 8 head rows) and
    qwen3-moe-30b-a3b's g = 8 at D = 128, paligemma-3b's g = 8 at D = 256
    and whisper-medium's g = 1 at D = 64, bf16 on the tensor cores: the
    decode read (Q = 1), the prefix read (Q = 33) and the verify read
    (Q = 5, per-query extents) within tolerance of the plain version, and
    query i of each Q > 1 launch bitwise a Q = 1 launch."""
    H, KV, D = heads
    for Q, per_query in ((1, False), (33, False), (5, True)):
        case = _gpu_tiled_case(cuda, Q, "bfloat16", per_query, H=H, KV=KV,
                               D=D)
        if Q == 1:
            case = (case[0][:, 0].contiguous(),) + case[1:]
            n0 = paged_attention.launches
            got = paged_attention(*case)
            torch.cuda.synchronize()
            assert paged_attention.launches == n0 + 1
        else:
            got = _assert_queries_are_single_launches(*case)
        for g, w in zip(got, paged_attention_ref(*case)):
            npt.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=3e-2,
                                atol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_paged_query_tiles_token_striped(cuda, dtype):
    """Token-striped shards (4 shards of bs/4 tokens a block) with query
    tiles: query i bitwise a Q = 1 launch, and the plain version's within
    tolerance."""
    q, kp, vp, slots, ext = _gpu_tiled_case(cuda, 9, dtype, True)
    bs = kp.shape[1]
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    for off in range(0, bs, bs // 4):
        ks = kp[:, off:off + bs // 4].contiguous()
        vs = vp[:, off:off + bs // 4].contiguous()
        kw = dict(tok_offset=off, block_tokens=bs)
        got = _assert_queries_are_single_launches(q, ks, vs, slots, ext, **kw)
        want = paged_attention_ref(q, ks, vs, slots, ext, **kw)
        for g, w in zip(got, want):
            npt.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=tol,
                                atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_paged_per_query_equals_single_query(cuda, dtype):
    """The verify read's per-query mode: query i of a Q = K+1 launch with
    extents pos+1 .. pos+K+1 equals, bitwise, a Q = 1 launch of the same
    query at extent pos+i+1 (the kernel half of spec decode's
    losslessness)."""
    B, Q, H, KV, D, bs, nblk = 4, 5, 32, 8, 128, 64, 16
    rng = np.random.RandomState(11)
    tdt = getattr(torch, dtype)
    q = _t(rng.randn(B, Q, H, D).astype(np.float32)).to(cuda, tdt)
    kp = _t(rng.randn(81, bs, KV, D).astype(np.float32)).to(cuda, tdt)
    vp = _t(rng.randn(81, bs, KV, D).astype(np.float32)).to(cuda, tdt)
    slots = _t(rng.permutation(80)[:B * nblk].reshape(B, nblk)
               .astype(np.int32)).to(cuda)
    pos = torch.tensor([1017, 62, 0, 300], dtype=torch.int32, device=cuda)
    ext = (pos[:, None] + 1
           + torch.arange(Q, dtype=torch.int32, device=cuda)).contiguous()
    n0 = paged_attention.launches_q_per_query
    wide = paged_attention(q, kp, vp, slots, ext)
    assert paged_attention.launches_q_per_query == n0 + 1
    for i in range(Q):
        one = paged_attention(q[:, i].contiguous(), kp, vp, slots,
                              ext[:, i].contiguous())
        for x, y in zip(one, wide):
            assert torch.equal(x, y[:, i])
