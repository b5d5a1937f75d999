"""The port's prefix-KV chunked prefill against the JAX package's.

* the prefix step alone (``make_prefix_prefill_step``), ``exact`` and
  ``paged`` gathers, greedy and sampled, on the same pool contents and
  inputs: the pool slots written, ``ctx_len`` and the first tokens exact,
  logits and installed K/V within 1e-4 (float32);
* the engine (``prefill_mode="prefix_kv"``) against JAX's: admission log
  (path, fwd_tokens), manager stats and token streams identical;
* port against port: prefix-KV equals recompute and blocking admission
  bitwise under ``exact`` (installed blocks, ctx_len, streams), after the
  JAX package's own differential test;
* the flash fallback warns; unknown modes are rejected.

All on the reduced granite-8b with float32 weights from the JAX
``init_params``.  The ``gpu``-marked twins hold the card against the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import init_params as jinit, model_dims as jdims
from repro.serve import Engine as JEngine, EngineConfig as JConfig
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro.serve.decode import (DecodeSpec as JSpec,
                                init_decode_state as jinit_state)
from repro.serve.prefill import make_prefix_prefill_step as jmake_prefix
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import model_dims
from repro_torch.params import params_from_numpy
from repro_torch.serve import (DecodeSpec, Engine, EngineConfig, Request,
                               SamplingParams, init_decode_state,
                               make_prefix_prefill_step)

torch.set_num_threads(2)

SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(JARCHS["granite-8b"])
    jp = jinit(jax.random.PRNGKey(0), jcfg, jdims(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, reduced(ARCHS["granite-8b"]), tp


# ------------------------------------------------------- the step alone

SLOTS, NBLK, B_ROWS = 24, 8, 4


def _step_inputs(cfg, sample):
    """A bucket of 4 rows (3 real, 1 pad) of 2-block chunks over
    translated prefixes of 1, 3 and 4 blocks, in a 4-block read buffer;
    random pool contents; per-slot sampling state."""
    bs = cfg.kv_block_size
    rng = np.random.RandomState(7)
    S = 2 * bs
    prefix_blocks = [1, 3, 4]
    perm = rng.permutation(SLOTS)
    tokens = np.zeros((B_ROWS, S), np.int64)
    new_slots = -np.ones((B_ROWS, 2), np.int32)
    prefix_slots = -np.ones((B_ROWS, 4), np.int32)
    slot_ids = np.full(B_ROWS, -1, np.int32)
    ctx = np.zeros(B_ROWS, np.int32)
    pctx = np.zeros(B_ROWS, np.int32)
    last = np.zeros(B_ROWS, np.int32)
    used = 0
    for i, nb in enumerate(prefix_blocks):
        take = 2 * bs if i != 1 else bs          # row 1: a ragged chunk
        tokens[i, :take] = rng.randint(0, cfg.vocab_size, take)
        prefix_slots[i, :nb] = perm[used:used + nb]
        used += nb
        new_slots[i, :take // bs] = perm[used:used + take // bs]
        used += take // bs
        slot_ids[i] = [2, 0, 3][i]
        pctx[i] = nb * bs
        ctx[i] = nb * bs + take
        last[i] = take - 1
    dims = jdims(jreduced(JARCHS["granite-8b"]))
    pool = (cfg.num_layers, SLOTS, bs, dims.n_kv, dims.head_dim)
    kp = rng.randn(*pool).astype(np.float32)
    vp = rng.randn(*pool).astype(np.float32)
    samp = dict(temp=np.asarray([0.0, 0.8, 1.3, 0.0], np.float32) * sample,
                topk=np.asarray([0, 20, 0, 5], np.int32),
                topp=np.asarray([1.0, 0.9, 0.7, 1.0], np.float32),
                key=np.asarray([[0, s] for s in (3, 11, 2 ** 31, 5)],
                               np.uint32))
    return dict(tokens=tokens, new_slots=new_slots,
                prefix_slots=prefix_slots, slot_ids=slot_ids, ctx=ctx,
                pctx=pctx, last=last, kp=kp, vp=vp, samp=samp)


def _spec(mod, cfg, gather):
    return mod(block_size=cfg.kv_block_size, max_blocks_per_seq=NBLK,
               slots_per_group=SLOTS, n_sets=2, assoc=8,
               prefix_gather=gather)


def _run_jax_step(jcfg, jp, x, gather, sample):
    dims = jdims(jcfg)
    spec = _spec(JSpec, jcfg, gather)
    st = jinit_state(jcfg, dims, spec, B_ROWS, 1)
    st["k_pool"] = jnp.asarray(x["kp"])
    st["v_pool"] = jnp.asarray(x["vp"])
    st["ctx_len"] = jnp.asarray([5, 6, 7, 8], jnp.int32)
    s = x["samp"]
    st.update(samp_temp=jnp.asarray(s["temp"]), samp_topk=jnp.asarray(
        s["topk"]), samp_topp=jnp.asarray(s["topp"]),
        samp_key=jnp.asarray(s["key"]))
    step = jmake_prefix(jcfg, dims, spec)
    a = [jnp.asarray(x[k]) for k in ("new_slots", "prefix_slots",
                                     "slot_ids", "ctx", "pctx", "last")]
    last, st, stats = step(jp, st, {"tokens": jnp.asarray(x["tokens"])},
                           *a, sample=sample)
    return (np.asarray(last), np.asarray(st["k_pool"]),
            np.asarray(st["v_pool"]), np.asarray(st["ctx_len"]),
            np.asarray(stats["next_token"]))


def _run_port_step(cfg, tp, x, gather, sample, device="cpu"):
    dims = model_dims(cfg)
    spec = _spec(DecodeSpec, cfg, gather)
    st = init_decode_state(cfg, dims, spec, B_ROWS, device=device)
    st["k_pool"][:, :SLOTS] = torch.from_numpy(x["kp"])
    st["v_pool"][:, :SLOTS] = torch.from_numpy(x["vp"])
    st["ctx_len"].copy_(torch.tensor([5, 6, 7, 8]))
    s = x["samp"]
    st["samp_temp"].copy_(torch.from_numpy(s["temp"]))
    st["samp_topk"].copy_(torch.from_numpy(s["topk"]))
    st["samp_topp"].copy_(torch.from_numpy(s["topp"]))
    st["samp_key"].copy_(torch.from_numpy(s["key"].astype(np.int64)))
    step = make_prefix_prefill_step(cfg, dims, spec)
    a = [torch.from_numpy(x[k]).to(device) for k in (
        "new_slots", "prefix_slots", "slot_ids", "ctx", "pctx", "last")]
    tok = {"tokens": torch.from_numpy(x["tokens"]).to(device)}
    last, st, stats = step(tp, st, tok, *a, sample=sample)
    return (last.cpu().numpy(), st["k_pool"][:, :SLOTS].cpu().numpy(),
            st["v_pool"][:, :SLOTS].cpu().numpy(),
            st["ctx_len"].cpu().numpy(), stats["next_token"].cpu().numpy())


def _top2_margin(logits):
    s = np.sort(logits, axis=-1)
    return s[:, -1] - s[:, -2]


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("gather", ["exact", "paged"])
def test_prefix_step_matches_jax(weights, gather, sample):
    jcfg, jp, cfg, tp = weights
    x = _step_inputs(cfg, sample)
    j_last, j_k, j_v, j_ctx, j_tok = _run_jax_step(jcfg, jp, x, gather,
                                                   sample)
    t_last, t_k, t_v, t_ctx, t_tok = _run_port_step(cfg, tp, x, gather,
                                                    sample)
    # the same pool slots written (the others keep their bytes), the same
    # context lengths, K/V and logits within float32 tolerance
    written = (j_k != x["kp"]).any(axis=(0, 2, 3, 4))
    np.testing.assert_array_equal((t_k != x["kp"]).any(axis=(0, 2, 3, 4)),
                                  written)
    assert written.sum() == 5                  # 2 + 1 + 2 new blocks
    np.testing.assert_allclose(t_k, j_k, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_v, j_v, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(t_ctx, j_ctx)
    assert list(t_ctx) == [32, 6, 24, 48]      # slot 1 is no row's
    real = x["slot_ids"] >= 0
    np.testing.assert_allclose(t_last[real], j_last[real], atol=1e-4,
                               rtol=1e-4)
    if not sample:
        np.testing.assert_array_equal(t_tok[real], j_tok[real])
        return
    # sampled rows: equal except on a near-tie of logit + noise (the
    # gumbel noise differs by float32 ulps across log implementations)
    for i in np.nonzero(real)[0]:
        if t_tok[i] != j_tok[i]:
            m = _top2_margin(t_last[i:i + 1])[0]
            assert m < 1e-3, (i, t_tok[i], j_tok[i], m)


# ---------------------------------------------------------- the engines

ENGINE = dict(max_batch=2, max_seq_len=96, prefill_budget=16,
              auto_release=True, prefix_cache=None)
PROMPT_BLOCKS = [6, 3, 5, 1, 4]
NEW_TOKENS = [5, 6, 4, 7, 5]


def _prompts(vocab, seed=11):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, 8 * n) for n in PROMPT_BLOCKS]


def _serve(eng, req_cls, sp_cls, prompts, sampled=False):
    for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS)):
        sp = (sp_cls(seed=40 + i, **SAMPLED) if sampled and i % 2
              else sp_cls())
        eng.submit(req_cls(seq_id=i, prompt=p, max_new_tokens=n,
                           sampling=sp))
    for _ in range(300):
        if not eng.has_unfinished():
            break
        eng.step()
    assert not eng.has_unfinished(), "engine failed to drain"
    return {i: list(eng._states[i].generated) for i in range(len(prompts))}


@pytest.mark.parametrize("gather", ["exact", "paged"])
def test_engine_prefix_kv_matches_jax(weights, gather):
    """Chunked prompts (budget 2 blocks) through the prefix-KV path:
    the admission log, manager stats and greedy streams equal JAX's."""
    jcfg, jp, cfg, tp = weights
    prompts = _prompts(cfg.vocab_size)
    jeng = JEngine(jcfg, jp, JConfig(overload_policy="fail",
                                     prefix_gather=gather, **ENGINE))
    want = _serve(jeng, JRequest, JSamplingParams, prompts)
    teng = Engine(cfg, tp, EngineConfig(overload_policy="fail",
                                        prefix_gather=gather, **ENGINE),
                  device="cpu")
    got = _serve(teng, Request, SamplingParams, prompts)
    assert teng.admission_log == jeng.admission_log
    assert [r.path for r in teng.admission_log].count("prefix_kv") >= 6
    assert all(r.fwd_tokens == r.end - r.start
               for r in teng.admission_log if r.path == "prefix_kv")
    assert dict(teng.manager.stats) == dict(jeng.manager.stats)
    assert got == want
    teng.check_invariants()


def _admit_all(cfg, tp, mode, budget_blocks, prompt, device="cpu",
               dtype=torch.float32):
    """Admit one prompt (chunked by the budget) and return its installed
    blocks, ctx and 4-token stream."""
    bs = cfg.kv_block_size
    eng = Engine(cfg, tp, EngineConfig(
        max_batch=2, max_seq_len=16 * bs, prefix_cache=None,
        prefill_mode=mode, dtype=dtype,
        prefill_budget=(budget_blocks * bs if budget_blocks else None)),
        device=device)
    r = Request(seq_id=0, prompt=prompt, max_new_tokens=4)
    eng.submit(r)
    eng.step()
    while 0 in eng._prefilling:
        eng.step()
    nblk = len(prompt) // bs
    slots = [eng.manager.lookup(0, cb)[0] for cb in range(nblk)]
    state = (slots, eng.dstate["k_pool"][:, slots].cpu(),
             eng.dstate["v_pool"][:, slots].cpu(),
             int(eng._ctx_host[eng._slot_of[0]]))
    while eng.has_unfinished():
        eng.step()
    paths = [rec.path for rec in eng.admission_log]
    return state, list(r.generated), paths


@pytest.mark.parametrize("budget_blocks", [2, 3])
def test_prefix_kv_bitwise_equals_recompute_and_blocking(weights,
                                                         budget_blocks):
    """Port against port (the JAX package's differential contract):
    chunk boundaries that divide the prompt (2 blocks on 8) and a ragged
    final chunk (3 + 3 + 2) install bit-identical blocks with the
    prefix-KV path as with recompute, at the same ctx_len, and all three
    admissions (prefix-KV, recompute, blocking) give the same tokens."""
    _, _, cfg, tp = weights
    bs = cfg.kv_block_size
    prompt = np.random.RandomState(11).randint(0, cfg.vocab_size, 8 * bs)
    a, ta, pa = _admit_all(cfg, tp, "prefix_kv", budget_blocks, prompt)
    b, tb, pb = _admit_all(cfg, tp, "recompute", budget_blocks, prompt)
    _, tc, _ = _admit_all(cfg, tp, "prefix_kv", None, prompt)
    assert pa[0] == "recompute" and set(pa[1:]) == {"prefix_kv"}
    assert set(pb) == {"recompute"}
    assert a[0] == b[0] and a[3] == b[3] == 8 * bs
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert ta == tb == tc


def test_sampled_prefix_kv_equals_recompute(weights):
    """A sampled request's stream is the same whether its later chunks
    run prefix-KV or recompute (position-folded keys)."""
    _, _, cfg, tp = weights
    bs = cfg.kv_block_size
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size, 6 * bs)
    streams = []
    for mode in ("prefix_kv", "recompute"):
        eng = Engine(cfg, tp, EngineConfig(
            max_batch=2, max_seq_len=16 * bs, prefill_budget=2 * bs,
            prefill_mode=mode), device="cpu")
        r = Request(seq_id=0, prompt=prompt, max_new_tokens=6,
                    sampling=SamplingParams(temperature=0.8, top_k=7,
                                            seed=123))
        eng.submit(r)
        while eng.has_unfinished():
            eng.step()
        streams.append(list(r.generated))
    assert streams[0] == streams[1]


def test_flash_falls_back_and_unknown_modes_rejected(weights):
    _, _, cfg, tp = weights
    with pytest.warns(UserWarning, match="falling back"):
        eng = Engine(cfg, tp, EngineConfig(attn_impl="flash",
                                           prefill_mode="prefix_kv"),
                     device="cpu")
    assert eng.prefill_mode == "recompute"
    with pytest.raises(ValueError, match="prefill_mode"):
        Engine(cfg, tp, EngineConfig(prefill_mode="speculative"),
               device="cpu")
    with pytest.raises(ValueError, match="prefix gather"):
        Engine(cfg, tp, EngineConfig(prefix_gather="strided"), device="cpu")


# ------------------------------------------------------- card vs CPU

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")


@pytest.mark.gpu
@pytest.mark.parametrize("gather", ["exact", "paged"])
def test_gpu_prefix_step_matches_cpu(weights, gather):
    """The prefix step on the card (the paged gather launches the
    paged-attention kernel with Q = chunk length) against the CPU."""
    _need_card()
    from repro_torch.kernels.paged_attention.ops import paged_attention
    _, _, cfg, tp = weights
    x = _step_inputs(cfg, True)
    cpu = _run_port_step(cfg, tp, x, gather, True)
    before = paged_attention.launches_multi_query
    card = _run_port_step(cfg, jax.tree.map(lambda t: t.cuda(), tp), x,
                          gather, True, device="cuda")
    if gather == "paged":
        assert paged_attention.launches_multi_query - before == \
            cfg.num_layers
    for a, b in zip(card[:3], cpu[:3]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(card[3], cpu[3])
    real = x["slot_ids"] >= 0
    np.testing.assert_array_equal(card[4][real], cpu[4][real])


@pytest.mark.gpu
@pytest.mark.parametrize("gather", ["exact", "paged"])
def test_gpu_engine_prefix_kv_matches_cpu(weights, gather):
    _need_card()
    _, _, cfg, tp = weights
    prompts = _prompts(cfg.vocab_size)
    runs = []
    for dev, p in (("cpu", tp), ("cuda", jax.tree.map(lambda t: t.cuda(),
                                                        tp))):
        eng = Engine(cfg, p, EngineConfig(prefix_gather=gather, **ENGINE),
                     device=dev)
        streams = _serve(eng, Request, SamplingParams, prompts,
                         sampled=True)
        runs.append((streams, list(eng.admission_log),
                     dict(eng.manager.stats)))
    assert runs[0] == runs[1]


@pytest.mark.gpu
@pytest.mark.parametrize("budget_blocks", [2, 3])
def test_gpu_prefix_kv_bitwise_equals_recompute_and_blocking_bf16(
        weights, budget_blocks):
    """The port-against-port contract on the card in bf16: the prefill's
    rows-invariant kernels (GEMM, RMS norm, flash with each row's
    ``q_offset``) make the prefix-KV chunks install the recompute path's
    blocks bitwise, and all three admissions give the same tokens."""
    _need_card()
    _, _, cfg, tp = weights
    card = jax.tree.map(lambda t: t.to("cuda", torch.bfloat16), tp)
    bs = cfg.kv_block_size
    prompt = np.random.RandomState(11).randint(0, cfg.vocab_size, 8 * bs)
    run = dict(device="cuda", dtype=torch.bfloat16)
    a, ta, pa = _admit_all(cfg, card, "prefix_kv", budget_blocks, prompt,
                           **run)
    b, tb, pb = _admit_all(cfg, card, "recompute", budget_blocks, prompt,
                           **run)
    c, tc, _ = _admit_all(cfg, card, "prefix_kv", None, prompt, **run)
    assert pa[0] == "recompute" and set(pa[1:]) == {"prefix_kv"}
    assert a[3] == b[3] == c[3] == 8 * bs
    for x in (b, c):
        assert torch.equal(a[1].view(torch.int16), x[1].view(torch.int16))
        assert torch.equal(a[2].view(torch.int16), x[2].view(torch.int16))
    assert ta == tb == tc
