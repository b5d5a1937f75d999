"""Scenarios of the token-split layout's tests (``tests/test_torch_token_split.py``):
the decode step in batch and striped mode and the recompute prefill over a
(2, 2) mesh, the JAX package's ``kv_shards=0`` mesh path.

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

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import model_dims  # noqa: E402
from repro_torch.params import params_from_numpy  # noqa: E402
from repro_torch.serve.decode import (DecodeSpec, init_decode_state,  # noqa: E402
                                      local_decode_state, make_serve_step)
from repro_torch.serve.prefill import make_prefill_step  # noqa: E402

COLLECTIVE_TIMEOUT_S = 60      # a rank that never joins fails, not hangs
MESH = (2, 2)
STEPS = 3
SLOTS = 16                     # pool slots of a data group
N_SETS, ASSOC = 2, 4           # 8 RestSeg slots a group, 8 flex slots
SCENARIOS = ("batch", "striped", "prefill")


def config():
    """reduced granite-8b at 2 layers (d 64, 4/1 heads of 16, 8-token
    blocks)."""
    return dataclasses.replace(reduced(ARCHS["granite-8b"]), num_layers=2)


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
    blocks = np.array([[0, 9, 4], [3, 12, 5], [1, 8, 6], [2, 10, 7]],
                      np.int32)
    slots = blocks[:, :2].copy()
    slots[3, 0] = -1
    out["prefill"] = dict(
        prompt=rng.randint(0, cfg.vocab_size, (B, 2 * bs)).astype(np.int32),
        slots=slots, blocks=blocks,
        ctx=np.array([16, 16, 11, 16], np.int32),
        tokens=rng.randint(0, cfg.vocab_size, (STEPS, B)).astype(np.int32))
    return out


def _t(x):
    return torch.as_tensor(np.asarray(x))


def whole_state(name, inp, cfg, dims, spec, B):
    """The scenario's whole state (JAX layout) as torch CPU tensors."""
    from repro_torch.serve.decode import abstract_decode_state
    st = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
          abstract_decode_state(cfg, dims, spec, B, MESH[0],
                                torch.float32).items()}
    st["flex"].fill_(-1)
    for k in ("k_pool", "v_pool", "tar", "sf", "flex", "ctx_len"):
        if k in inp:
            st[k] = _t(inp[k]).clone()
    return st


def one_state(name, inp, cfg, dims, one, B):
    """The one-device state holding the scenario's blocks."""
    st = init_decode_state(cfg, dims, one, B, 1, torch.float32, "cpu")
    if name != "prefill":
        for k in ("k_pool", "v_pool"):
            st[k][:, :-1] = _t(inp[k])
        st["flex"] = _t(inp["flex1"]).clone()
        st["ctx_len"] = _t(inp["ctx_len"]).clone()
    return st


def _prefill(step, params, st, inp, B, prefill_slots):
    return step(params, st, {"tokens": _t(inp["prompt"])}, prefill_slots,
                torch.arange(B, dtype=torch.int32), _t(inp["ctx"]),
                _t(inp["ctx"]) - 1)


def run(name, cfg, params, mesh):
    """One scenario on this rank's share (``mesh``) or on one device
    (``mesh`` None): per step the logits, ``next_token`` and the stats,
    then the rank's (or the device's) pools, without the sink."""
    dims = model_dims(cfg, tp=1)
    spec, one, B, actives = geometry(name)
    inp = INPUTS[name]
    if mesh is None:
        st = one_state(name, inp, cfg, dims, one, B)
        serve = make_serve_step(cfg, dims, one, torch.float32)
        first = None
        if name == "prefill":
            # the mesh's group g slot s is the device's g * SLOTS + s; the
            # rows of group g are rows [g B/G, (g+1) B/G)
            grp = torch.arange(B)[:, None] // (B // MESH[0])

            def dev_slots(x):
                x = _t(x)
                return torch.where(x >= 0, x + grp * SLOTS,
                                   -1).to(torch.int32)
            first = _prefill(make_prefill_step(cfg, dims, one), params, st,
                             inp, B, dev_slots(inp["slots"]))
            blk = dev_slots(inp["blocks"])
            flex1 = -torch.ones((B, one.max_blocks_per_seq),
                                dtype=torch.int32)
            flex1[:, :blk.shape[1]] = blk
            st["flex"] = flex1.reshape(1, -1).clone()
    else:
        whole = whole_state(name, inp, cfg, dims, spec, B)
        st = local_decode_state(whole, spec, mesh)
        serve = make_serve_step(cfg, dims, spec, torch.float32, mesh=mesh)
        first = None
        if name == "prefill":
            first = _prefill(make_prefill_step(cfg, dims, spec, mesh=mesh),
                             params, st, inp, B, _t(inp["slots"]))
            rows = B // MESH[0]
            g = mesh.data_index
            blk = _t(inp["blocks"][g * rows:(g + 1) * rows])
            flex = -torch.ones((rows, spec.max_blocks_per_seq),
                               dtype=torch.int32)
            flex[:, :blk.shape[1]] = blk
            st["flex"] = flex.reshape(1, -1).clone()
    res = {"steps": []}
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
    res["k_pool"] = st["k_pool"][:, :-1].numpy().copy()
    res["v_pool"] = st["v_pool"][:, :-1].numpy().copy()
    res["ctx_len"] = st["ctx_len"].numpy().copy()
    return res


INPUTS = {}


def load(root: Path):
    """The weights and inputs that the test process pickled."""
    with open(root / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    INPUTS.update(inputs["scenarios"])
    return config(), params_from_numpy(inputs["params"], "cpu")


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
        cfg, params = load(root)
        mesh = make_local_mesh(data, model)
        for name in SCENARIOS:
            try:
                results[name] = run(name, cfg, params, mesh)
            except Exception:
                results[name] = {"error": traceback.format_exc()}
                raise
    finally:
        with open(root / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
