"""Scenarios of the token-split layout's tests (``tests/test_torch_token_split.py``):
the decode step in batch and striped mode and the recompute prefill over a
(2, 2) mesh, the JAX package's ``kv_shards=0`` mesh path, and per family
(granite, qwen3-moe, mamba2, jamba, whisper, reduced to 2 layers) the
recompute prefill then decode steps with the weights cut as JAX's
``param_shardings`` cuts them, ZeRO on and off.  A rank holds and computes
with its blocks of the weights (``ServingTP.blocks``).

The test process draws the inputs (the JAX package's weights as numpy and
each scenario's whole decode state in the JAX layout) and pickles them to
``ROOT/inputs.pkl``.  This file, run as a script, is one rank of a gloo
group over a file rendezvous:

    python tests/torch_token_split_cases.py RANK WORLD DATA,MODEL ROOT

It runs every scenario on its rank's share of the state and pickles what
each returned, or the traceback that stopped it, to ``ROOT/rankRANK.pkl``.
It imports the port only (``src`` goes on its own path, not through
``PYTHONPATH``, which would load the JAX shims of ``src/sitecustomize.py``).
"""
from __future__ import annotations

import dataclasses
import datetime
import pickle
import sys
import traceback
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

import torch  # noqa: E402

from repro_torch.ckpt.checkpoint import tree_flatten  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import FwdOptions, model_dims  # noqa: E402
from repro_torch.params import params_from_numpy  # noqa: E402
from repro_torch.serve.decode import (DecodeSpec, init_decode_state,  # noqa: E402
                                      local_decode_state, make_serve_step,
                                      token_split_tp)
from repro_torch.serve.prefill import make_prefill_step  # noqa: E402

COLLECTIVE_TIMEOUT_S = 60      # a rank that never joins fails, not hangs
MESH = (2, 2)
STEPS = 3
SLOTS = 16                     # pool slots of a data group
N_SETS, ASSOC = 2, 4           # 8 RestSeg slots a group, 8 flex slots
FAMILIES = ("granite-8b", "qwen3-moe-30b-a3b", "mamba2-130m",
            "jamba-1.5-large-398b", "whisper-medium")
# a family's scenario: "ARCH/zero" (ZeRO over the data axis) or
# "ARCH/nozero" (the weights cut over the model axis only)
FAMILY_SCENARIOS = tuple(f"{a}/{z}" for a in FAMILIES
                         for z in ("zero", "nozero"))
SCENARIOS = ("batch", "striped", "prefill") + FAMILY_SCENARIOS


def config(arch: str = "granite-8b", zero: bool = True):
    """``arch`` reduced, at 2 layers (d 64, 4 heads of 16, 8-token blocks;
    jamba one group of a mamba and an attention sublayer, whisper 2
    encoder layers and 8 frames), ``zero_shard_params=zero``."""
    return dataclasses.replace(reduced(ARCHS[arch]), num_layers=2,
                               zero_shard_params=zero)


def family_of(name: str):
    """(arch, zero) of a family scenario."""
    arch, z = name.split("/")
    return arch, z == "zero"


def draw_family_inputs(cfg, rng):
    """A family scenario's prompts (the prefill scenario's geometry), its
    decode steps' tokens and, for audio, the frames."""
    spec, _, B, _ = geometry("prefill")
    bs = cfg.kv_block_size
    out = dict(prompt=rng.randint(0, cfg.vocab_size,
                                  (B, 2 * bs)).astype(np.int32),
               ctx=np.array([16, 16, 11, 16], np.int32),
               tokens=rng.randint(0, cfg.vocab_size,
                                  (STEPS, B)).astype(np.int32))
    if cfg.frontend != "none":
        out["frontend"] = rng.randn(B, cfg.frontend_tokens,
                                    cfg.d_model).astype(np.float32)
    return out


def geometry(name):
    """(spec of the mesh, spec of one device, rows, steps' active masks):
    the mesh's groups hold ``SLOTS`` slots each; one device holds the G
    groups' pools one after the other (group g's slot s at g * SLOTS +
    s), and in striped mode the G groups' blocks of a row in order."""
    G = MESH[0]
    bs = config().kv_block_size
    if name == "striped":
        nblk, B = 3, 2
        mesh = DecodeSpec(block_size=bs, max_blocks_per_seq=nblk,
                          slots_per_group=SLOTS, n_sets=N_SETS, assoc=ASSOC,
                          mode="striped")
        one = DecodeSpec(block_size=bs, max_blocks_per_seq=G * nblk,
                         slots_per_group=G * SLOTS, n_sets=N_SETS,
                         assoc=ASSOC)
        return mesh, one, B, [None] * STEPS
    B = 4
    mesh = DecodeSpec(block_size=bs, max_blocks_per_seq=4,
                      slots_per_group=SLOTS, n_sets=N_SETS, assoc=ASSOC)
    one = DecodeSpec(block_size=bs, max_blocks_per_seq=4,
                     slots_per_group=G * SLOTS, n_sets=N_SETS, assoc=ASSOC)
    return mesh, one, B, [None, np.array([1, 0, 1, 1], bool), None]


def draw_inputs(seed: int = 0):
    """Each scenario's whole state in the JAX layout (numpy), its tokens,
    and the one-device state that holds the same blocks.  The batch and
    striped states map some blocks through the RestSeg (TAR tags, SF
    counts) and the rest through the flex table; the one-device state maps
    every block through its flex table."""
    rng = np.random.RandomState(seed)
    cfg = config()
    dims = model_dims(cfg, tp=1)
    G, bs = MESH[0], cfg.kv_block_size
    L, KV, hd = cfg.num_layers, dims.n_kv, dims.head_dim
    out = {}
    for name in ("batch", "striped"):
        spec, one, B, _ = geometry(name)
        nblk = spec.max_blocks_per_seq
        rows = B // G if name == "batch" else B
        kp = rng.randn(L, G * SLOTS, bs, KV, hd).astype(np.float32)
        vp = rng.randn(L, G * SLOTS, bs, KV, hd).astype(np.float32)
        tar = np.zeros((G, N_SETS, ASSOC), np.int32)
        sf = np.zeros((G, N_SETS), np.int32)
        flex = -np.ones((G, rows * nblk), np.int32)
        flex1 = -np.ones((1, B * one.max_blocks_per_seq), np.int32)
        for g in range(G):
            free_flex = iter(range(N_SETS * ASSOC, SLOTS))
            for r in range(rows):
                for j in range(nblk):
                    v = r * nblk + j
                    s = v % N_SETS
                    way = int(sf[g, s])
                    if rng.rand() < 0.5 and way < ASSOC:
                        tar[g, s, way] = v + 1
                        sf[g, s] += 1
                        slot = s * ASSOC + way
                    else:
                        slot = next(free_flex)
                        flex[g, v] = slot
                    if name == "batch":
                        row, blk = g * rows + r, j
                    else:
                        row, blk = r, j * G + g
                    flex1[0, row * one.max_blocks_per_seq + blk] = \
                        g * SLOTS + slot
        ctx = (np.array([13, 20, 7, 25], np.int32) if name == "batch"
               else np.array([29, 17], np.int32))
        out[name] = dict(k_pool=kp, v_pool=vp, tar=tar, sf=sf, flex=flex,
                         ctx_len=ctx, flex1=flex1,
                         tokens=rng.randint(0, cfg.vocab_size,
                                            (STEPS, B)).astype(np.int32))
    # the recompute prefill of 4 prompts of 16 tokens (2 blocks each) into
    # empty pools, then the decode steps
    # (group-local slots: rows 0, 1 are group 0's, rows 2, 3 group 1's;
    # block 2 takes the decode steps' writes; row 3's block 0 is not
    # installed)
    spec, one, B, _ = geometry("prefill")
    blocks, slots = prefill_blocks()
    out["prefill"] = dict(
        prompt=rng.randint(0, cfg.vocab_size, (B, 2 * bs)).astype(np.int32),
        slots=slots, blocks=blocks,
        ctx=np.array([16, 16, 11, 16], np.int32),
        tokens=rng.randint(0, cfg.vocab_size, (STEPS, B)).astype(np.int32))
    return out


def prefill_blocks():
    """(blocks, slots) of the prefill scenarios: each row's group-local
    slot of its blocks 0-2, and the slots its prompt's two blocks install
    to (-1: not installed)."""
    blocks = np.array([[0, 9, 4], [3, 12, 5], [1, 8, 6], [2, 10, 7]],
                      np.int32)
    slots = blocks[:, :2].copy()
    slots[3, 0] = -1
    return blocks, slots


def _t(x):
    return torch.as_tensor(np.asarray(x))


def whole_state(name, inp, cfg, dims, spec, B):
    """The scenario's whole state (JAX layout) as torch CPU tensors."""
    from repro_torch.serve.decode import abstract_decode_state
    st = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
          abstract_decode_state(cfg, dims, spec, B, MESH[0],
                                torch.float32).items()}
    if "flex" in st:
        st["flex"].fill_(-1)
    for k in ("k_pool", "v_pool", "tar", "sf", "flex", "ctx_len"):
        if k in inp and k in st:
            st[k] = _t(inp[k]).clone()
    return st


def one_state(name, inp, cfg, dims, one, B):
    """The one-device state holding the scenario's blocks."""
    st = init_decode_state(cfg, dims, one, B, 1, torch.float32, "cpu")
    if name in ("batch", "striped"):
        for k in ("k_pool", "v_pool"):
            st[k][:, :-1] = _t(inp[k])
        st["flex"] = _t(inp["flex1"]).clone()
        st["ctx_len"] = _t(inp["ctx_len"]).clone()
    return st


def _prefill(step, params, st, inp, B, prefill_slots, cfg):
    batch = {"tokens": _t(inp["prompt"])}
    if cfg.family in ("ssm", "hybrid"):
        batch["seq_len"] = _t(inp["ctx"])
    if "frontend" in inp:
        batch["frontend"] = _t(inp["frontend"])
    return step(params, st, batch, prefill_slots,
                torch.arange(B, dtype=torch.int32), _t(inp["ctx"]),
                _t(inp["ctx"]) - 1)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def run(name, mesh):
    """One scenario on this rank's share (``mesh``) or on one device
    (``mesh`` None): per step the logits, ``next_token`` and the stats,
    then the rank's (or the device's) pools, without the sink, its
    recurrent state and, on a rank, the shapes of its weights."""
    family = name in FAMILY_SCENARIOS
    if family:
        arch, zero = family_of(name)
        cfg = config(arch, zero)
        params, inp = FAMILY_PARAMS[arch], FAMILY_INPUTS[arch]
        spec, one, B, actives = geometry("prefill")
    else:
        cfg, params, inp = config(), PARAMS[0], INPUTS[name]
        spec, one, B, actives = geometry(name)
    prefills = family or name == "prefill"
    dims = model_dims(cfg, tp=1)
    # the one device routes each data group's rows as one MoE group, as
    # a token-split rank routes its group's
    fwd = FwdOptions(moe_groups=MESH[0] if mesh is None else 1)
    res = {"steps": []}
    if mesh is None:
        st = one_state(name, inp, cfg, dims, one, B)
        serve = make_serve_step(cfg, dims, one, torch.float32)
        first = None
        if prefills:
            # the mesh's group g slot s is the device's g * SLOTS + s; the
            # rows of group g are rows [g B/G, (g+1) B/G)
            grp = torch.arange(B)[:, None] // (B // MESH[0])

            def dev_slots(x):
                x = _t(x)
                return torch.where(x >= 0, x + grp * SLOTS,
                                   -1).to(torch.int32)
            blocks, slots = prefill_blocks()
            first = _prefill(make_prefill_step(cfg, dims, one, fwd), params,
                             st, inp, B, dev_slots(slots), cfg)
            blk = dev_slots(blocks)
            flex1 = -torch.ones((B, one.max_blocks_per_seq),
                                dtype=torch.int32)
            flex1[:, :blk.shape[1]] = blk
            if "flex" in st:
                st["flex"] = flex1.reshape(1, -1).clone()
    else:
        params = token_split_tp(cfg, dims, spec, mesh).blocks(params)
        res["param_shapes"] = {".".join(p): tuple(x.shape)
                               for p, x in _paths(params)}
        res["param_bytes"] = sum(x.numel() * x.element_size()
                                 for x in tree_flatten(params)[0])
        whole = whole_state(name, inp, cfg, dims, spec, B)
        st = local_decode_state(whole, spec, mesh)
        serve = make_serve_step(cfg, dims, spec, torch.float32, mesh=mesh)
        first = None
        if prefills:
            blocks, slots = prefill_blocks()
            first = _prefill(make_prefill_step(cfg, dims, spec, fwd,
                                               mesh=mesh),
                             params, st, inp, B, _t(slots), cfg)
            rows = B // MESH[0]
            g = mesh.data_index
            blk = _t(blocks[g * rows:(g + 1) * rows])
            flex = -torch.ones((rows, spec.max_blocks_per_seq),
                               dtype=torch.int32)
            flex[:, :blk.shape[1]] = blk
            if "flex" in st:
                st["flex"] = flex.reshape(1, -1).clone()
    if first is not None:
        res["prefill"] = (first[0].numpy().copy(),
                          first[2]["next_token"].numpy().copy())
    for i in range(STEPS):
        act = actives[i]
        logits, st, stats = serve(
            params, st, _t(inp["tokens"][i]),
            None if act is None else torch.as_tensor(act))
        res["steps"].append({
            "logits": logits.numpy().copy(),
            **{k: v.numpy().copy() for k, v in stats.items()
               if k != "telemetry"}})
    for k in ("k_pool", "v_pool"):
        if k in st:
            res[k] = st[k][:, :-1].numpy().copy()
    for k in ("ssm", "conv", "ctx_len"):
        if k in st:
            res[k] = st[k].numpy().copy()
    return res


INPUTS, PARAMS, FAMILY_INPUTS, FAMILY_PARAMS = {}, [], {}, {}


def load(root: Path) -> None:
    """The weights and inputs that the test process pickled."""
    with open(root / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    INPUTS.update(inputs["scenarios"])
    PARAMS[:] = [params_from_numpy(inputs["params"], "cpu")]
    for arch, fam in inputs["families"].items():
        FAMILY_PARAMS[arch] = params_from_numpy(fam["params"], "cpu")
        FAMILY_INPUTS[arch] = fam["inputs"]


def main(argv) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    rank, world = int(argv[0]), int(argv[1])
    data, model = (int(x) for x in argv[2].split(","))
    root = Path(argv[3])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{root / 'rendezvous'}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    results = {}
    try:
        load(root)
        mesh = make_local_mesh(data, model)
        for name in SCENARIOS:
            try:
                results[name] = run(name, mesh)
            except Exception:
                results[name] = {"error": traceback.format_exc()}
                raise
    finally:
        with open(root / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
