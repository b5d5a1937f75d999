"""The port's model, decode step and prefill step against the JAX package,
with the same weights (``params_from_numpy`` of the JAX pytree) at the
reduced granite-8b size (4 layers, d=64, H=4, KV=1, hd=16, bs=8).

Tolerances: logits and K/V 1e-4 in float32 (two frameworks, two summation
orders); in bfloat16 3e-2 of the tensor's own scale (``max |ref|``, at
least 1): bf16 keeps 8 significant bits, and XLA keeps float32 precision
inside its fusions where torch rounds after every op, so from layer 1 on
the K/V entries (magnitudes up to ~3.5) differ by a few bf16 ulps.
Integer results (translation, ctx_len, tokens) match exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.core import HybridConfig as JHybridConfig
from repro.core import FLEX, HybridKVManager as JManager
from repro.models import FwdOptions as JFwd, forward as jforward
from repro.models import init_params as jinit, model_dims as jdims
from repro.serve import decode as jdecode
from repro.serve import prefill as jprefill
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import FwdOptions, forward, model_dims
from repro_torch.params import params_from_numpy
from repro_torch.serve import decode, prefill

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(JARCHS["granite-8b"])
    cfg = reduced(ARCHS["granite-8b"])
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.kv_block_size) == (4, 64, 4, 1, 16, 8)
    out = {}
    for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                           ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg), dtype=jdt)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        assert tp["layers"]["attn"]["q"]["w"].dtype == tdt
        out[name] = (jp, tp, jdt, tdt)
    return jcfg, cfg, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_forward_logits_and_cache_match(models, dtype, impl):
    jcfg, cfg, ps = models
    jp, tp, jdt, tdt = ps[dtype]
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 24))
    jl, _, jc = jforward(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                         jdims(jcfg), JFwd(dtype=jdt, collect_cache=True))
    tl, _, tc = forward(tp, {"tokens": torch.from_numpy(tokens)}, cfg,
                        model_dims(cfg),
                        FwdOptions(attn_impl=impl, dtype=tdt,
                                   collect_cache=True))
    assert tl.dtype == tdt and tuple(tl.shape) == jl.shape
    for got, want in ((tl, jl), (tc["k"], jc["k"]), (tc["v"], jc["v"])):
        assert tuple(got.shape) == want.shape
        want = np.asarray(want, np.float32)
        tol = (1e-4 if dtype == "float32"
               else 3e-2 * max(1.0, float(np.abs(want).max())))
        npt.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


# ------------------------------------------------------------ serve step

def _decode_setup(cfg, B=3, bs=8, nblk=4, slots=32):
    kw = dict(block_size=bs, total_slots=slots, restseg_fraction=0.25,
              assoc=4, max_seqs=B, max_blocks_per_seq=nblk)
    m = JManager(JHybridConfig(**kw))
    ctx = np.asarray([5, 16, 29], np.int32)
    last = [ctx[0] // bs, ctx[1] // bs, ctx[2] // bs - 1]  # row 2: unmapped
    for sid in range(B):
        m.register_sequence(sid)
    for b in range(nblk):               # interleave rows: some go flexible
        for sid in range(B):
            if b <= last[sid]:
                m.allocate_block(sid, b)
    assert any(i.seg == FLEX for i in m.blocks.values())
    spec = dict(block_size=bs, max_blocks_per_seq=nblk, slots_per_group=slots,
                n_sets=m.cfg.num_sets, assoc=4, hash_name=m.cfg.hash_name)
    rng = np.random.RandomState(1)
    pools = [rng.randn(cfg.num_layers, slots, bs, cfg.num_kv_heads,
                       cfg.resolved_head_dim).astype(np.float32)
             for _ in range(2)]
    return m, spec, ctx, pools


def test_serve_step_matches(models):
    jcfg, cfg, ps = models
    jp, tp, _, _ = ps["float32"]
    m, spec_kw, ctx, (kp, vp) = _decode_setup(cfg)
    B, slots = 3, spec_kw["slots_per_group"]
    tokens = np.asarray([3, 77, 200], np.int64)
    active = np.asarray([True, False, True])   # row 1 idle, row 2 unmapped

    jspec = jdecode.DecodeSpec(**spec_kw)
    jst = jdecode.init_decode_state(jcfg, jdims(jcfg), jspec, B, 1)
    jst.update(tar=jnp.asarray(m.tar)[None], sf=jnp.asarray(m.sf)[None],
               flex=jnp.asarray(m.flex_table.reshape(1, -1)),
               ctx_len=jnp.asarray(ctx), k_pool=jnp.asarray(kp),
               v_pool=jnp.asarray(vp))
    jstep = jax.jit(jdecode.make_serve_step(jcfg, jdims(jcfg), jspec,
                                            dtype=jnp.float32))
    jlog, jnew, jstats = jstep(jp, jst, jnp.asarray(tokens),
                               jnp.asarray(active))

    spec = decode.DecodeSpec(**spec_kw)
    st = decode.init_decode_state(cfg, model_dims(cfg), spec, B, 1,
                                  device="cpu")
    st["tar"][0] = torch.from_numpy(m.tar)
    st["sf"][0] = torch.from_numpy(m.sf)
    st["flex"][0] = torch.from_numpy(m.flex_table.reshape(-1))
    st["ctx_len"][:] = torch.from_numpy(ctx)
    st["k_pool"][:, :slots] = torch.from_numpy(kp)
    st["v_pool"][:, :slots] = torch.from_numpy(vp)
    step = decode.make_serve_step(cfg, model_dims(cfg), spec)
    tlog, tnew, tstats = step(tp, st, torch.from_numpy(tokens),
                              torch.from_numpy(active))
    assert tnew is st                                  # updated in place

    for key in ("slots", "in_rest", "mapped", "accesses"):
        npt.assert_array_equal(tstats[key].numpy(), np.asarray(jstats[key]),
                               err_msg=key)
    assert tstats["in_rest"].any() and not tstats["in_rest"].all()
    npt.assert_array_equal(tstats["next_token"].numpy(),
                           np.asarray(jstats["next_token"]))
    npt.assert_array_equal(tnew["ctx_len"].numpy(), np.asarray(jnew["ctx_len"]))
    npt.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    for key, before in (("k_pool", kp), ("v_pool", vp)):
        got = tnew[key][:, :slots].numpy()
        want = np.asarray(jnew[key])
        # the same entries are written (row 0 only), the rest untouched
        npt.assert_array_equal(got != before, want != before)
        assert (want != before).any()
        npt.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- prefill step

def test_prefill_step_matches(models):
    jcfg, cfg, ps = models
    jp, tp, _, _ = ps["float32"]
    bs, nblk, slots, n_batch = 8, 4, 32, 4
    spec_kw = dict(block_size=bs, max_blocks_per_seq=nblk,
                   slots_per_group=slots, n_sets=4, assoc=4)
    rng = np.random.RandomState(2)
    tokens = np.zeros((4, 2 * bs), np.int64)
    tokens[0] = rng.randint(0, cfg.vocab_size, 2 * bs)
    tokens[1, :bs] = rng.randint(0, cfg.vocab_size, bs)
    blk = np.asarray([[5, 17], [9, -1], [-1, -1], [-1, -1]], np.int32)
    slot_ids = np.asarray([2, 0, -1, -1], np.int32)
    ctx = np.asarray([2 * bs, bs, 0, 0], np.int32)
    last_pos = np.asarray([2 * bs - 1, bs - 1, 0, 0], np.int32)
    ctx0 = np.asarray([3, 0, 7, 1], np.int32)
    kp = rng.randn(cfg.num_layers, slots, bs, cfg.num_kv_heads,
                   cfg.resolved_head_dim).astype(np.float32)

    jspec = jdecode.DecodeSpec(**spec_kw)
    jst = jdecode.init_decode_state(jcfg, jdims(jcfg), jspec, n_batch, 1)
    jst.update(ctx_len=jnp.asarray(ctx0), k_pool=jnp.asarray(kp))
    jstep = jax.jit(jprefill.make_prefill_step(
        jcfg, jdims(jcfg), jspec, fwd=JFwd(dtype=jnp.float32)))
    jlast, jnew, jstats = jstep(jp, jst, {"tokens": jnp.asarray(tokens)},
                                *map(jnp.asarray, (blk, slot_ids, ctx,
                                                   last_pos)))

    spec = decode.DecodeSpec(**spec_kw)
    st = decode.init_decode_state(cfg, model_dims(cfg), spec, n_batch, 1,
                                  device="cpu")
    st["ctx_len"][:] = torch.from_numpy(ctx0)
    st["k_pool"][:, :slots] = torch.from_numpy(kp)
    step = prefill.make_prefill_step(cfg, model_dims(cfg), spec)
    tlast, tnew, tstats = step(tp, st, {"tokens": torch.from_numpy(tokens)},
                               *map(torch.from_numpy, (blk, slot_ids, ctx,
                                                       last_pos)))
    npt.assert_array_equal(tnew["ctx_len"].numpy(), [bs, 0, 2 * bs, 1])
    npt.assert_array_equal(tnew["ctx_len"].numpy(), np.asarray(jnew["ctx_len"]))
    npt.assert_array_equal(tstats["next_token"].numpy(),
                           np.asarray(jstats["next_token"]))
    npt.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=1e-4, atol=1e-4)
    for key, before in (("k_pool", kp), ("v_pool", np.zeros_like(kp))):
        got = tnew[key][:, :slots].numpy()
        want = np.asarray(jnew[key])
        npt.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        # installed blocks 5, 17, 9 only; everything else untouched
        keep = np.ones(slots, bool)
        keep[[5, 17, 9]] = False
        npt.assert_array_equal(got[:, keep], before[:, keep])
