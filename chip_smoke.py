#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one card.

Run from the root of a checkout, without ``PYTHONPATH=src`` (the script
puts ``src`` on its own path, and ``src/sitecustomize.py`` would import
JAX):

    python3 chip_smoke.py
    python3 chip_smoke.py --decode-profile [--src OTHER_CHECKOUT/src]

The second form builds the kernels and runs only phase 4's decode-step
profile, of this checkout's port or of another commit's (a parent
unpacked with ``git archive``), so that two commits compare in one call.

Phases, each failing loudly:

1. build the three CUDA kernels from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` each, all started together) into
   ``build/repro_torch_kernels/``, printing from ptxas the registers,
   stack and spill bytes of each bf16 flash kernel and of every kernel
   that spills;
2. hold each kernel against its plain torch version on the card at
   granite-8b's serving shapes (H=32, KV=8, D=128, bs=64, B=4, extents
   and prompts up to 1024) in float32 (1e-4) and bfloat16 (3e-2): the RSW
   exactly, its vpn-list entry for all five hashes, tags >= 2^24 and vpns
   outside the flex table, and its decode-step entry (the whole step's
   translation in one launch) for all five hashes at the smoke engine's
   geometry and at a granite-8b deployment's (64 rows of 64 blocks, a
   5120-slot pool at restseg fraction 0.25), with a row past its vpn
   range, an unmapped write block and an inactive row; paged attention
   also with a zero-extent row, token-striped shards, and bitwise batch
   and query-rank invariance; flash attention also at every prefill
   bucket length (8 .. 1024).  Then time kernel, plain version, and for
   flash attention ``scaled_dot_product_attention`` (CUDA events and
   profiler device time) as a yardstick the port never calls; the step
   translation beside an empty kernel's device time and PR 12's eager
   composition.  The step translation and paged attention must each be
   one device kernel per call;
3. serve the same greedy requests with a 2-layer full-width granite-8b in
   float32 on the card and on the CPU, with the same weights, twice: as
   in earlier slices, and under pool pressure (restseg fraction 0.25, a
   40-slot pool), where the card must walk the flex table and promote
   blocks.  Admission logs and manager stats must be identical and the
   token streams agree (a divergence is tolerated only where the top-2
   logit margin is below 1e-3);
4. serve granite-8b at its published width and depth (36 layers, random
   bfloat16 weights from a seeded generator) through the port's Engine:
   8 requests, 32 new tokens each; every kernel's launch count must grow.
   Then profile one admission step and one steady decode step (device
   time by kernel, device kernels per step, idle share).

It prints the build times, the kernel checks, one JSON line of kernel
measurements, the serving numbers, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA card,
or without the rest of the repository beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12,    # CUDA cores, no tensor cores
              "bfloat16": 989e12}  # dense tensor cores
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fns, iters: int = 20) -> float:
    """Mean ms per call of ``fns[i % len(fns)]()`` over ``iters`` calls,
    after a warm-up, by CUDA events.  Cycling over several inputs keeps a
    call from finding the previous call's data in L2."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_device(torch, fn, iters: int):
    """Device time per call of ``fn`` by kernel, from ``torch.profiler``:
    [(kernel name, ms per call, launches per call)], largest first, over
    the device-side events only (the CPU ops that launched them would
    count the same time twice).  An empty list means the profiler saw no
    device time on this machine."""
    fn()
    torch.cuda.synchronize()
    return profile_cold(torch, fn, iters)


def profile_cold(torch, fn, iters: int = 1, tries: int = 3):
    """``profile_device`` without the warm-up call.  A session in which the
    profiler saw no device event at all is run again, up to ``tries``
    times (on the card's machine it now and then delivers none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            if us > 0:
                rows.append((e.key, us / iters / 1e3, e.count / iters))
        if rows:
            break
    return sorted(rows, key=lambda r: -r[1])


def device_ms(torch, fn, iters, symbols=None):
    """Summed device ms per call of the kernels whose names hold one of
    ``symbols``, or of every kernel when ``symbols`` is None (None when
    the profiler saw none)."""
    rows = profile_device(torch, fn, iters)
    hits = [ms for name, ms, _ in rows
            if symbols is None or any(x in name for x in symbols)]
    return sum(hits) if hits else None


def launches_per_call(torch, fn, iters=5):
    """Device kernels per call of ``fn`` (profiler), for the one-launch
    contract; fails when the profiler saw none, since then the contract
    cannot be checked."""
    rows = profile_device(torch, fn, iters)
    if not rows:
        raise AssertionError("the profiler saw no device kernel, so the "
                             "kernels per call cannot be counted")
    return sum(n for _, _, n in rows)


def ptxas_entries(out: str):
    """The kernels of an ``nvcc -Xptxas=-v`` log: [(demangled name,
    registers, stack bytes, spill store bytes, spill load bytes)]."""
    import re
    import shutil
    entries, name, props = [], None, (0, 0, 0)
    for ln in out.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name, props = m.group(1), (0, 0, 0)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and name:
            props = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            entries.append([name, int(m.group(1)), *props])
            name = None
    if entries and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            e[0] for e in entries), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        if len(names) == len(entries):
            for e, n in zip(entries, names):
                n = n.replace("(anonymous namespace)::", "")
                e[0] = n.split("(")[0].removeprefix("void ")
    return [tuple(e) for e in entries]


def _us(ms):
    return None if ms is None else 1e3 * ms


def _ms(us):
    return None if us is None else us / 1e3


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, tol) -> float:
    import torch
    got, want = got.float(), want.float()
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {max_err(got, want)}, "
                             f"tol {tol})")
    return max_err(got, want)


# ------------------------------------------------------------- phase 2

HASHES = ("modulo", "xor_fold", "prime_displacement", "mersenne",
          "multiplicative")


def _rsw_out_of_range(hash_name):
    """TAR/SF of a populated manager, a flex table mapping about a third of
    its entries (its first and last among them), and vpns past its end and
    below zero."""
    import numpy as np
    from repro_torch.core import HybridConfig, HybridKVManager
    m = HybridKVManager(HybridConfig(
        total_slots=256, restseg_fraction=0.75, assoc=8, max_seqs=16,
        max_blocks_per_seq=32, hash_name=hash_name))
    for sid in range(6):
        m.register_sequence(sid)
        for b in range(20):
            m.allocate_block(sid, b)
    rng = np.random.RandomState(SEED)
    V = m.flex_table.size
    flex = np.where(rng.rand(V) < 0.35, rng.randint(0, 4096, V), -1)
    flex[[0, V - 1, V - 2]] = [7, 4001, 4002]
    q = np.asarray([V, V + 1, V + 77, 1 << 30, -1, -2, -V, -V - 1, -V - 100,
                    -(1 << 31), 0, 5, V - 1], np.int32)
    return (q, np.ascontiguousarray(m.tar), np.ascontiguousarray(m.sf),
            flex.astype(np.int32))


def check_rsw(torch, dev):
    """The vpn-list entry (``utopia_rsw``, the counterpart of rsw_pallas)
    against its plain version: exact on all five hashes, tags >= 2^24 and
    vpns outside the flex table."""
    from repro_torch.core import HybridConfig, HybridKVManager
    from repro_torch.kernels.utopia_rsw.ops import utopia_rsw
    from repro_torch.kernels.utopia_rsw.ref import rsw_ref
    import numpy as np
    B, nblk = 4, 16                  # the engine's granite-8b geometry
    for h in HASHES:
        m = HybridKVManager(HybridConfig(
            block_size=64, total_slots=80, restseg_fraction=0.75, assoc=8,
            max_seqs=B, max_blocks_per_seq=nblk, hash_name=h))
        rng = np.random.RandomState(SEED)
        for sid in range(B):
            m.register_sequence(sid)
        for b in range(nblk):
            for sid in range(B):
                if rng.rand() < 0.9:
                    m.allocate_block(sid, b)
        grid = np.arange(B * nblk, dtype=np.int32)
        q = np.concatenate([grid, grid[::nblk] + 3]).astype(np.int32)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (q, m.tar, m.sf, m.flex_table.reshape(-1))]
        got = utopia_rsw(*args, hash_name=h)
        want = rsw_ref(*args, hash_name=h)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"utopia_rsw[{h}] != plain version")
    # tags (vpn + 1) at and above 2^24, and their near-miss neighbours
    tar = np.zeros((4, 4), np.int32)
    big = [1 << 24, (1 << 24) + 6, (1 << 25) + 3, (1 << 26) + 9]
    for v in big:
        tar[v % 4, int(np.nonzero(tar[v % 4] == 0)[0][0])] = v + 1
    q = np.asarray(big + [v + 1 for v in big] + [v - 1 for v in big],
                   np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (
        q, tar, (tar != 0).sum(axis=1).astype(np.int32),
        -np.ones(16, np.int32))]
    got = utopia_rsw(*args)
    for g, w in zip(got, rsw_ref(*args)):
        if not torch.equal(g, w):
            raise AssertionError("utopia_rsw != plain version on big tags")
    if not bool(got[1][:4].all()) or bool(got[1][4:].any()):
        raise AssertionError("utopia_rsw: big-tag hits wrong")
    # vpns past the flat table's end and below zero read it as JAX does
    # (-1 is the last entry, then clamp), on a table with mapped entries
    for h in HASHES:
        args = [torch.from_numpy(a).to(dev) for a in _rsw_out_of_range(h)]
        got = utopia_rsw(*args, hash_name=h)
        for g, w in zip(got, rsw_ref(*args, hash_name=h)):
            if not torch.equal(g, w):
                raise AssertionError(f"utopia_rsw[{h}] != plain version on "
                                     "out-of-range vpns")
        if not bool(got[2][:4].any()) or not bool(got[2][4:10].any()):
            raise AssertionError("utopia_rsw: out-of-range vpns unmapped")
    # the TAR row read at other associativities (the engine's is 8): a
    # loop of 16-byte loads at multiples of 4, scalar loads otherwise
    for assoc in (4, 6, 12, 16):
        m = HybridKVManager(HybridConfig(
            total_slots=256, restseg_fraction=0.75, assoc=assoc,
            max_seqs=16, max_blocks_per_seq=32))
        for sid in range(6):
            m.register_sequence(sid)
            for b in range(20):
                m.allocate_block(sid, b)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            np.arange(16 * 32, dtype=np.int32), m.tar, m.sf,
            m.flex_table.reshape(-1))]
        for g, w in zip(utopia_rsw(*args), rsw_ref(*args)):
            if not torch.equal(g, w):
                raise AssertionError(f"utopia_rsw[assoc {assoc}] != plain "
                                     "version")
    log("check utopia_rsw (vpn-list entry): exact on 5 hashes, tags >= 2^24, "
        "out-of-range vpns and associativities 4, 6, 12, 16")


# (B, nblk, bs, pool slots, restseg fraction): the smoke engine's decode
# step (phase 4), and granite-8b deployed on one H100 at max_batch=64,
# max_seq_len=4096: 5120 slots x 9.44 MB of bf16 K/V over 36 layers is
# 48.3 GB beside 16.5 GB of weights (only the manager's tables are built)
STEP_GEOMETRIES = {"engine": (4, 16, 64, 80, 0.75),
                   "deployment": (64, 64, 64, 5120, 0.25)}


def _step_case(torch, dev, hash_name, B, nblk, bs, slots, frac):
    """A populated manager's device tables and a batch's context lengths
    and active mask: row 0 is active but idle past its vpn range, row 1's
    write block is unmapped, row 2 is inactive; the other rows are mapped
    up to their write block, allocated block-major so that some blocks go
    flexible."""
    import numpy as np
    from repro_torch.core import HybridConfig, HybridKVManager
    m = HybridKVManager(HybridConfig(
        block_size=bs, total_slots=slots, restseg_fraction=frac, assoc=8,
        max_seqs=B, max_blocks_per_seq=nblk, hash_name=hash_name))
    rng = np.random.RandomState(SEED)
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
    up = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        m.tar[None], m.sf[None], m.flex_table.reshape(1, -1), ctx, active)]
    return up, m.cfg.num_sets


def pr12_translation(torch, tar, sf, flex, positions, act, nblk, bs, sink,
                     hash_name):
    """PR 12's translation as the decode step composed it around the
    vpn-list kernel: the query grid in eager ops, the walk, the flag
    conversions, the serve step's active mask, ONE layer's write-index
    derivation (PR 12 ran it in each of the 36 layers) and the engine's
    telemetry conversions.  The yardstick of the step entry; no serving
    path calls it."""
    from repro_torch.kernels.utopia_rsw.ops import utopia_rsw
    B = positions.shape[0]
    dev = positions.device
    seq = torch.arange(B, dtype=torch.int32, device=dev)
    grid = (seq[:, None] * nblk
            + torch.arange(nblk, dtype=torch.int32, device=dev)[None, :])
    cur_block = positions // bs
    in_range = cur_block < nblk
    cur_vpn = seq * nblk + cur_block.clamp(max=nblk - 1)
    n_read = B * nblk
    queries = torch.cat([grid.reshape(-1), cur_vpn.to(torch.int32)])
    slot, hit, mapped, acc = utopia_rsw(queries, tar[0], sf[0], flex[0],
                                        hash_name=hash_name)
    hit, mapped = hit.bool(), mapped.bool()
    w_valid = (mapped[n_read:] & in_range)[None] & act[None]
    ws = torch.where(w_valid[0], slot[n_read:], sink).long()
    t = (positions % bs).long()
    extent = positions + 1
    tele = [x[:n_read].reshape(-1).to(torch.int32) for x in (hit, acc,
                                                              mapped)]
    return slot, ws, t, extent, tele


def _step_bytes(torch, tables, nblk, hash_name, n_sets, assoc):
    """Bytes the step's translation must move for THIS data: the SF word
    of every distinct set probed, the TAR row of every distinct probed set
    whose SF is non-zero, the flex entry of every distinct vpn that
    missed, ctx_len and the active mask, each once; the output once."""
    from repro_torch.core.hashes import get_hash
    from repro_torch.kernels.utopia_rsw.ref import rsw_ref, step_words
    tar, sf, flex, ctx, _ = (t.cpu() for t in tables)
    B = ctx.shape[0]
    q = torch.arange(B * nblk, dtype=torch.int32)   # the write blocks too
    _, hit, _, _ = rsw_ref(q, tar[0], sf[0], flex[0], hash_name=hash_name)
    sets = torch.unique(get_hash(hash_name)(q, n_sets).long())
    live = sets[sf[0][sets] > 0]
    misses = torch.unique(q[hit == 0])
    read = (4 * sets.numel() + 4 * assoc * live.numel()
            + 4 * misses.numel() + 4 * B + B)
    return read + 4 * step_words(B, nblk)


def check_translate_step(torch, dev, results):
    """The step entry (``utopia_translate_step``, the main path's RSW
    launch) against ``translate_step_ref`` at both geometries, for all five
    hashes, exact in every field, with and without the active mask; then,
    with the engine's hash, its device time beside an empty kernel's, its
    bytes bound, the wall time per call of ``translate_step`` beside PR
    12's composition (in turns: new, old, old, new), and its device
    kernels per call, which must be 1."""
    from repro_torch.kernels.utopia_rsw.ops import (empty_launch,
                                                    utopia_translate_step)
    from repro_torch.kernels.utopia_rsw.ref import (StepTranslation,
                                                    translate_step_ref)
    from repro_torch.serve.decode import DecodeSpec, translate_step
    geoms = {}
    for gname, (B, nblk, bs, slots, frac) in STEP_GEOMETRIES.items():
        for h in HASHES:
            tables, n_sets = _step_case(torch, dev, h, B, nblk, bs, slots,
                                        frac)
            tar, sf, flex, ctx, active = tables
            geom = dict(block_size=bs, nblk=nblk, hash_name=h, sink=slots)
            for act in (None, active):
                got = utopia_translate_step(tar, sf, flex, ctx, act, **geom)
                want = translate_step_ref(tar, sf, flex, ctx, act, **geom)
                for f in StepTranslation._fields:
                    if not torch.equal(getattr(got, f), getattr(want, f)):
                        raise AssertionError(
                            f"translate_step[{gname}, {h}]: {f} differs "
                            "from the plain version")
        # timings with the engine's hash
        tables, n_sets = _step_case(torch, dev, "modulo", B, nblk, bs,
                                    slots, frac)
        tar, sf, flex, ctx, active = tables
        spec = DecodeSpec(block_size=bs, max_blocks_per_seq=nblk,
                          slots_per_group=slots, n_sets=n_sets, assoc=8)
        bound = {}                  # the bindings, kept as the step keeps them
        new = [lambda: translate_step(tar, sf, flex, ctx, spec, active,
                                      bound)]
        old = [lambda: pr12_translation(torch, tar, sf, flex, ctx, active,
                                        nblk, bs, slots, "modulo")]
        per_call = launches_per_call(torch, new[0])
        if per_call != 1:
            raise AssertionError(f"translate_step[{gname}]: {per_call} "
                                 "device kernels per call, expected 1")
        trans = new[0]()
        hits = int(trans.in_rest.sum())
        walks = int(((trans.mapped == 1) & (trans.in_rest == 0)).sum())
        nbytes = _step_bytes(torch, tables, nblk, "modulo", n_sets, 8)
        wall = [time_ms(torch, new, 400)]
        wall_old = [time_ms(torch, old, 400), time_ms(torch, old, 400)]
        wall.append(time_ms(torch, new, 400))
        # the step kernel and an empty kernel under one profiler session
        dev_us = {}
        for _ in range(3):            # the profiler can miss a tiny kernel
            rows = profile_device(torch, lambda: (new[0](), empty_launch(ctx)),
                                  100)
            for key, sym in (("kernel", "translate_step_kernel"),
                             ("empty", "empty_kernel")):
                ms = [r[1] for r in rows if sym in r[0]]
                if ms:
                    dev_us.setdefault(key, 1e3 * ms[0])
            if len(dev_us) == 2:
                break
        g = dict(
            vpns=B * nblk, pool_slots=slots, restseg_fraction=frac,
            hit_share=round(hits / max(hits + walks, 1), 4),
            device_us=dev_us.get("kernel"),
            empty_device_us=dev_us.get("empty"),
            bound_us=nbytes / HBM_BYTES_PER_S * 1e6, bytes=nbytes,
            wall_us=1e3 * statistics.mean(wall),
            pr12_wall_us=1e3 * statistics.mean(wall_old),
            pr12_list_kernel_device_us=_us(device_ms(
                torch, old[0], 100, ("rsw_kernel",))),
            pr12_kernels_per_call=launches_per_call(torch, old[0]),
            kernels_per_call=per_call,
            plain_us=1e3 * time_ms(torch, [lambda: translate_step_ref(
                tar, sf, flex, ctx, active, block_size=bs, nblk=nblk,
                hash_name="modulo", sink=slots)], 50))
        geoms[gname] = g
        log(f"check translate_step [{gname}: B={B}, nblk={nblk}, "
            f"{slots} slots, restseg {frac}]: exact on 5 hashes (a row past "
            f"its range, an unmapped write block, an inactive row); hit "
            f"share {g['hit_share']}; " + json.dumps(
                {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in g.items()}))
    e = geoms["engine"]
    results["utopia_translate_step"] = dict(
        max_abs_err=0.0, ms=e["wall_us"] / 1e3,
        device_ms=_ms(e["device_us"]), plain_ms=e["plain_us"] / 1e3,
        bound_ms=e["bound_us"] / 1e3, bound_by="bytes", library_ms=None,
        library_device_ms=None, empty_device_ms=_ms(e["empty_device_us"]),
        pr12_ms=e["pr12_wall_us"] / 1e3, geometries=geoms,
        shape="B=4 nblk=16 (64 vpns), 80 slots; geometries: "
              + ", ".join(f"{k} {v}" for k, v in STEP_GEOMETRIES.items()))


def _paged_case(torch, dev, dtype, B=4, H=32, KV=8, D=128, bs=64, nblk=16,
                L=1, Q=None, per_query=False, gen=None):
    """A granite-8b decode read: each row maps its first ceil(ctx/bs)
    blocks to distinct pool slots (one hole in row 0), the rest -1."""
    n_slots = 81
    ctx = torch.tensor([1024, 700, 64, 301], dtype=torch.int32)[:B]
    perm = torch.randperm(n_slots - 1, generator=gen)
    slots = torch.full((B, nblk), -1, dtype=torch.int32)
    used = 0
    for b in range(B):
        nb = -(-int(ctx[b]) // bs)
        slots[b, :nb] = perm[used:used + nb].to(torch.int32)
        used += nb
    slots[0, 5] = -1
    qshape = (B, H, D) if Q is None else (B, Q, H, D)
    q = torch.randn(qshape, generator=gen).to(dev)
    kp = torch.randn((L, n_slots, bs, KV, D), generator=gen).to(dev, dtype)
    vp = torch.randn((L, n_slots, bs, KV, D), generator=gen).to(dev, dtype)
    if per_query:
        c = ctx[:, None] - Q + 1 + torch.arange(Q)[None, :]
        ctx = c.clamp(min=0).to(torch.int32)
    return q, kp, vp, slots.to(dev), ctx.to(dev)


def check_paged(torch, dev, results):
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    gen = torch.Generator().manual_seed(SEED)

    def close(name, got, want, tol):
        return max(check_close(name, g, w, tol) for g, w in zip(got, want))

    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        for Q, per_query in ((None, False), (4, False), (4, True)):
            q, kp, vp, slots, ctx = _paged_case(torch, dev, dtype, Q=Q,
                                                per_query=per_query, gen=gen)
            err = close(f"paged_attention[{dtype}, Q={Q}]",
                        paged_attention(q, kp[0], vp[0], slots, ctx),
                        paged_attention_ref(q, kp[0], vp[0], slots, ctx), tol)
            log(f"check paged_attention {str(dtype)[6:]} Q={Q or 1} "
                f"{'per-query ' if per_query else ''}ctx: max abs err "
                f"{err:.3g} (tol {tol})")
    # the main path's call: bf16 q against a bf16 pool
    q, kp, vp, slots, ctx = _paged_case(torch, dev, torch.bfloat16, gen=gen)
    q = q.to(torch.bfloat16)
    main_err = close("paged_attention[bf16 q]",
                     paged_attention(q, kp[0], vp[0], slots, ctx),
                     paged_attention_ref(q, kp[0], vp[0], slots, ctx), 3e-2)
    log(f"check paged_attention bf16 q and pool (the decode path): max abs "
        f"err {main_err:.3g} (tol 3e-2)")
    # a zero-extent row: l == 0 and m == -1e30 exactly
    ctx0 = ctx.clone()
    ctx0[2] = 0
    o, m, l = paged_attention(q, kp[0], vp[0], slots, ctx0)
    close("paged_attention[zero extent]", (o, m, l),
          paged_attention_ref(q, kp[0], vp[0], slots, ctx0), 3e-2)
    if float(l[2].abs().max()) != 0.0 or bool((m[2] != -1e30).any()):
        raise AssertionError("paged_attention: a zero-extent row must give "
                             "l == 0 and m == -1e30")
    # bitwise: a row alone equals the row in the batch, Q=1 equals column 0
    # of Q=4 (the split follows nblk only)
    full = paged_attention(q, kp[0], vp[0], slots, ctx)
    for b in range(q.shape[0]):
        alone = paged_attention(q[b:b + 1].contiguous(), kp[0], vp[0],
                                slots[b:b + 1].contiguous(), ctx[b:b + 1])
        if not all(torch.equal(x[0], y[b]) for x, y in zip(alone, full)):
            raise AssertionError(f"paged_attention: row {b} alone differs "
                                 "from the batch")
    q4 = torch.randn((q.shape[0], 4) + q.shape[1:], generator=gen).to(
        dev, torch.bfloat16)
    q4[:, 0] = q
    wide = paged_attention(q4, kp[0], vp[0], slots, ctx)
    if not all(torch.equal(x, y[:, 0]) for x, y in zip(full, wide)):
        raise AssertionError("paged_attention: Q=1 differs from column 0 "
                             "of Q=4")
    # token-striped shards (model-axis striping: 4 shards of bs/4 tokens)
    bs = kp.shape[2]
    for off in range(0, bs, bs // 4):
        ks = kp[0][:, off:off + bs // 4].contiguous()
        vs = vp[0][:, off:off + bs // 4].contiguous()
        close(f"paged_attention[striped {off}]",
              paged_attention(q, ks, vs, slots, ctx, tok_offset=off,
                              block_tokens=bs),
              paged_attention_ref(q, ks, vs, slots, ctx, tok_offset=off,
                                  block_tokens=bs), 3e-2)
    log("check paged_attention: zero-extent row exact, rows alone == rows "
        "in the batch and Q=1 == column 0 of Q=4 bitwise, 4 token-striped "
        "shards within 3e-2")

    # time the main-path read (bf16 q and pool, Q=1) over 8 layers' pools
    L = 8
    q, kp, vp, slots, ctx = _paged_case(torch, dev, torch.bfloat16, L=L,
                                        gen=gen)
    q = q.to(torch.bfloat16)
    B, H, D = q.shape
    bs, KV = kp.shape[2], kp.shape[3]
    kern = [lambda i=i: paged_attention(q, kp[i], vp[i], slots, ctx)
            for i in range(L)]
    plain = [lambda i=i: paged_attention_ref(q, kp[i], vp[i], slots, ctx)
             for i in range(L)]
    per_call = launches_per_call(torch, kern[0])
    if per_call != 1:
        raise AssertionError(f"paged_attention: {per_call} device kernels "
                             "per call, expected 1")
    n_tok = int(sum(-(-int(c) // bs) * bs for c in ctx.tolist()))
    n_tok -= bs                                    # the hole in row 0
    nbytes = (q.numel() * 2 + 2 * n_tok * KV * D * 2 + slots.numel() * 4
              + ctx.numel() * 4 + B * H * D * 4 + 2 * B * H * 4)
    flops = 4 * D * H * int(ctx.sum())
    bound_bytes = nbytes / HBM_BYTES_PER_S
    bound_ops = flops / PEAK_FLOPS["bfloat16"]
    results["paged_attention"] = dict(
        max_abs_err=main_err, ms=time_ms(torch, kern, 80),
        device_ms=device_ms(torch, kern[0], 20, ("paged_attn_kernel",)),
        plain_ms=time_ms(torch, plain, 16),
        bound_ms=max(bound_bytes, bound_ops) * 1e3,
        bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        library_ms=None, library_device_ms=None,
        device_kernels_per_call=per_call,
        shape=f"B={B} H={H} KV={KV} D={D} bs={bs} ctx={ctx.tolist()} bf16")


def check_flash(torch, dev, results):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.attention import dense_attention
    gen = torch.Generator(device=dev).manual_seed(SEED)
    H, KV, D = 32, 8, 128

    def qkv(B, S, dtype):
        return [torch.randn((B, S, n, D), generator=gen, device=dev
                            ).to(dtype) for n in (H, KV, KV)]

    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        for B, S, causal in ((2, 1024, True), (1, 1000, True),
                             (4, 8, True), (1, 256, False)):
            q, k, v = qkv(B, S, dtype)
            err = check_close(f"flash_attention[{dtype}, B={B}, S={S}]",
                              flash_attention(q, k, v, causal=causal),
                              dense_attention(q, k, v, causal=causal), tol)
            log(f"check flash_attention {str(dtype)[6:]} B={B} S={S} "
                f"{'causal' if causal else 'full'}: max abs err {err:.3g} "
                f"(tol {tol})")
            if (B, S, dtype) == (2, 1024, torch.bfloat16):
                main_err = err
    # every prefill bucket length the engine makes, in the serving dtype
    errs = []
    for S in (8, 64, 128, 256, 512, 1024):
        q, k, v = qkv(4 if S <= 256 else 2, S, torch.bfloat16)
        errs.append(check_close(
            f"flash_attention[bf16 bucket S={S}]",
            flash_attention(q, k, v, causal=True),
            dense_attention(q, k, v, causal=True), 3e-2))
    log("check flash_attention bf16 causal at the engine's buckets "
        "S = 8, 64, 128, 256, 512, 1024: max abs err "
        + ", ".join(f"{e:.3g}" for e in errs) + " (tol 3e-2)")
    B, S = 2, 1024
    sets = [qkv(B, S, torch.bfloat16) for _ in range(4)]
    g = H // KV
    # the yardstick's inputs: heads-first layout, K/V expanded to H heads
    lib_sets = [(q.transpose(1, 2).contiguous(),
                 k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous(),
                 v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous())
                for q, k, v in sets]
    kern = [lambda s=s: flash_attention(*s, causal=True) for s in sets]
    plain = [lambda s=s: dense_attention(*s, causal=True) for s in sets]
    lib = [lambda s=s: F.scaled_dot_product_attention(*s, is_causal=True)
           for s in lib_sets]
    flops = 4 * B * H * D * (S * (S + 1) // 2)
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * KV * D)
    bound_bytes = nbytes / HBM_BYTES_PER_S
    bound_ops = flops / PEAK_FLOPS["bfloat16"]
    results["flash_attention"] = dict(
        max_abs_err=main_err, ms=time_ms(torch, kern, 20),
        device_ms=device_ms(torch, kern[0], 5,
                            ("flash_wgmma_kernel", "flash_kernel")),
        plain_ms=time_ms(torch, plain, 8),
        bound_ms=max(bound_bytes, bound_ops) * 1e3,
        bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        library_ms=time_ms(torch, lib, 20),
        library_device_ms=device_ms(torch, lib[0], 5),
        shape=f"B={B} S={S} H={H} KV={KV} D={D} causal bf16")


# --------------------------------------------------------- phases 3, 4

def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def serve(eng, requests):
    """Submit, step to completion.  Returns ({seq_id: tokens}, steps):
    one record per step of (wall s, chunks admitted, rows decoding,
    {seq_id: token}, {seq_id: batch slot})."""
    for r in requests:
        eng.submit(r)
    steps = []
    while eng.has_unfinished():
        n_log = len(eng.admission_log)
        live = sum(1 for sid in eng.requests if sid not in eng._prefilling
                   and not eng._states[sid].done)
        slots = dict(eng._slot_of)
        t0 = time.perf_counter()
        out = eng.step()             # ends in the step's one .cpu() copy
        steps.append((time.perf_counter() - t0,
                      len(eng.admission_log) - n_log, live, out,
                      {**slots, **eng._slot_of}))
        if len(steps) > 10000:
            raise RuntimeError("engine failed to drain")
    return ({sid: list(st.generated) for sid, st in eng._states.items()},
            steps)


def record_margins(eng, margins):
    """Wrap the engine's steps to keep each step's top-2 logit margins,
    keyed by (kind, step) and then batch slot."""
    serve_step, prefill_step = eng._serve_step, eng._prefill_step

    def top2(logits):
        v = logits.float().topk(2, dim=-1).values
        return (v[:, 0] - v[:, 1]).tolist()

    def serve_rec(params, dstate, tokens, active=None):
        logits, dstate, stats = serve_step(params, dstate, tokens, active)
        margins[("decode", eng.step_count)] = dict(enumerate(top2(logits)))
        return logits, dstate, stats

    def prefill_rec(params, dstate, batch, slots, slot_ids, *rest):
        last, dstate, stats = prefill_step(params, dstate, batch, slots,
                                           slot_ids, *rest)
        row = margins.setdefault(("prefill", eng.step_count), {})
        for sid, m in zip(slot_ids.tolist(), top2(last)):
            if sid >= 0:
                row[sid] = m
        return last, dstate, stats

    eng._serve_step, eng._prefill_step = serve_rec, prefill_rec


def margin_of(margins, steps, sid, i):
    """Top-2 margin of the logits that produced token ``i`` of ``sid``."""
    seen = 0
    for step, (_, _, _, out, slots) in enumerate(steps, start=1):
        if sid in out:
            if seen == i:
                kind = "prefill" if i == 0 else "decode"
                return margins[(kind, step)][slots[sid]]
            seen += 1
    return None


def card_vs_cpu(torch, dev, params, prompt_lens, new_tokens, label,
                **engine_kw):
    """Serve the same greedy requests on the card and on the CPU with the
    same weights (a 2-layer full-width granite-8b in float32).  Admission
    log and manager stats must be identical, and a stream may differ only
    from a near-tie (top-2 logit margin below 1e-3).  Returns the card's
    manager stats."""
    import numpy as np
    from repro_torch.serve import Engine, EngineConfig, Request
    cfg, params = params
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in prompt_lens]
    ecfg = EngineConfig(auto_release=True, **engine_kw)
    runs, margins = {}, {}
    for name, d, p in (("cuda", dev, to_device(params, dev)),
                       ("cpu", torch.device("cpu"), params)):
        eng = Engine(cfg, p, ecfg, device=d)
        if name == "cuda":
            record_margins(eng, margins)
        t0 = time.perf_counter()
        streams, steps = serve(eng, [
            Request(seq_id=i, prompt=pr, max_new_tokens=new_tokens)
            for i, pr in enumerate(prompts)])
        runs[name] = (streams, steps, eng, time.perf_counter() - t0)
    (cs, csteps, ceng, ct), (ps, _, peng, pt) = runs["cuda"], runs["cpu"]
    # no eos: the schedule, and so the translation, cannot depend on the
    # token values, only the streams can
    if ceng.admission_log != peng.admission_log:
        raise AssertionError(f"{label}: card and CPU admitted differently")
    if dict(ceng.manager.stats) != dict(peng.manager.stats):
        raise AssertionError(f"{label}: card and CPU translation stats "
                             "differ")
    ceng.check_invariants()
    same = 0
    for sid in sorted(cs):
        if cs[sid] == ps[sid]:
            same += 1
            continue
        i = next(k for k, (a, b) in enumerate(zip(cs[sid], ps[sid]))
                 if a != b)
        m = margin_of(margins, csteps, sid, i)
        log(f"card vs CPU ({label}): request {sid} diverges at token {i}: "
            f"card {cs[sid][i]} vs CPU {ps[sid][i]}, top-2 logit margin {m}")
        if m is None or m >= 1e-3:
            raise AssertionError("card and CPU streams diverge where the "
                                 "top-2 margin is not a near-tie")
    stats = dict(ceng.manager.stats)
    log(f"card vs CPU ({label}; granite-8b width, 2 layers, f32, "
        f"{len(prompts)} requests, {engine_kw}): {same} of {len(cs)} token "
        f"streams identical, the rest diverge only at near-ties; admission "
        f"log and manager stats identical: {json.dumps(stats)} "
        f"({ct:.1f} s on the card, {pt:.1f} s on the CPU)")
    return stats


def card_vs_cpu_runs(torch, dev):
    """Phase 3: the run of earlier slices, then a pressure run whose
    RestSeg (one set of 8 ways in a 40-slot pool) overflows, so the card
    walks the flex table, promotes hot flexible blocks and syncs the
    TAR/SF/flex deltas inside a serving run."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_dims
    from repro_torch.params import init_params
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=2)
    params = (cfg, init_params(torch.Generator().manual_seed(SEED), cfg,
                               model_dims(cfg), torch.float32, "cpu"))
    card_vs_cpu(torch, dev, params, (64, 128, 192), 6, "default",
                max_batch=4, max_seq_len=256)
    stats = card_vs_cpu(torch, dev, params, (64, 128, 192, 320, 64, 256), 8,
                        "pressure", max_batch=4, max_seq_len=512,
                        restseg_fraction=0.25)
    if stats.get("flex_walks", 0) <= 0 or stats.get(
            "migrations_flex_to_rest", 0) <= 0:
        raise AssertionError(f"pressure run: no flex walk or no promotion on "
                             f"the card ({stats})")


def full_width(torch, dev):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.utopia_rsw.ops import utopia_translate_step
    from repro_torch.models import model_dims
    from repro_torch.params import init_params
    from repro_torch.serve import Engine, EngineConfig, Request
    cfg = get_config("granite-8b")
    dims = model_dims(cfg)
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                         dims, torch.bfloat16, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"granite-8b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{dims.n_heads}/{dims.n_kv} heads, d_ff {dims.d_ff}, vocab "
        f"{dims.vocab}: {n_params / 1e9:.2f} B bf16 parameters drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = Engine(cfg, params, EngineConfig(
        max_batch=4, max_seq_len=1024, auto_release=True,
        dtype=torch.bfloat16), device=dev)
    bs = cfg.kv_block_size
    rng = np.random.RandomState(SEED)
    lens = [bs * n for n in (1, 11, 2, 7, 3, 9, 5, 4)]   # 64 .. 704 tokens
    reqs = [Request(seq_id=i, prompt=rng.randint(0, cfg.vocab_size, n),
                    max_new_tokens=32) for i, n in enumerate(lens)]
    first = {}

    serve_step = eng._serve_step

    def checked(params, dstate, tokens, active=None):
        logits, dstate, stats = serve_step(params, dstate, tokens, active)
        if not first:
            first["finite"] = bool(torch.isfinite(logits).all())
            first["shape"] = tuple(logits.shape)
        return logits, dstate, stats

    eng._serve_step = checked
    for fn in (utopia_translate_step, paged_attention, flash_attention):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams, steps = serve(eng, reqs)
    wall = time.perf_counter() - t0
    launches = {"utopia_translate_step": utopia_translate_step.launches,
                "paged_attention": paged_attention.launches,
                "flash_attention": flash_attention.launches}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 "path")
    eng.check_invariants()
    if not first.get("finite") or first["shape"] != (4, dims.vocab):
        raise AssertionError(f"decode logits not finite / wrong shape "
                             f"{first}")
    for r in reqs:
        toks = streams[r.seq_id]
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size
                                      for t in toks):
            raise AssertionError(f"request {r.seq_id} produced {toks}")
    st = eng.stats()
    decode_only = [w for w, admitted, live, _, _ in steps
                   if not admitted and live]
    admit = [w for w, admitted, _, _, _ in steps if admitted]
    n_tok = sum(len(t) for t in streams.values())
    hits, walks = st.get("rsw_hits", 0), st.get("flex_walks", 0)
    summary = dict(
        requests=len(reqs), prompt_tokens=lens, new_tokens_each=32,
        steps=len(steps), admission_steps=len(admit),
        admission_step_ms_total=round(sum(admit) * 1e3, 3),
        decode_step_ms_median=round(statistics.median(decode_only) * 1e3, 3),
        tokens_per_s=round(n_tok / wall, 2), wall_s=round(wall, 3),
        rsw_hit_share=round(hits / max(hits + walks, 1), 4),
        gpu_mem_peak_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30,
                               3),
        launches=launches)
    log("granite-8b full width, 36 layers, bf16, Engine(max_batch=4, "
        "max_seq_len=1024): " + json.dumps({"serving": summary}))
    profile_decode_step(torch, eng, rng, cfg)
    return launches


def profile_decode_step(torch, eng, rng, cfg):
    """An admission step under the profiler (device ms by kernel), then a
    steady decode step at B=4: its wall ms unprofiled, then the same kind
    of step under the profiler for the device ms by kernel (kernels run
    one at a time on one stream, so their sum is the busy time); the idle
    share compares the two."""
    from repro_torch.serve import Request
    for i in range(4):
        eng.submit(Request(seq_id=100 + i,
                           prompt=rng.randint(0, cfg.vocab_size, 512),
                           max_new_tokens=8))
    # the first admission step (prefill dispatch) under the profiler
    rows = profile_cold(torch, eng.step, tries=1)  # an admission runs once
    busy = sum(ms for _, ms, _ in rows)
    flash = sum(ms for name, ms, _ in rows if "flash_" in name)
    top = [dict(kernel=name[:90], ms=round(ms, 4), launches=n)
           for name, ms, n in rows[:6]]
    log("admission step under the profiler (4 prompts of 512): "
        + json.dumps({"profile": dict(
            device_busy_ms=round(busy, 3),
            flash_attention_ms=round(flash, 4),
            flash_attention_share=round(flash / busy, 4) if busy else None,
            kernels=len(rows), top=top)}))
    while eng._prefilling or eng.waiting:
        eng.step()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()               # ends in the step's one .cpu() copy
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    rows = profile_device(torch, eng.step, 1)
    while eng.has_unfinished():
        eng.step()
    busy = sum(ms for _, ms, _ in rows)
    n_kernels = int(round(sum(n for _, _, n in rows)))
    paged = sum(ms for name, ms, _ in rows if "paged_attn_kernel" in name)
    top = [dict(kernel=name[:90], ms=round(ms, 4), launches=n)
           for name, ms, n in rows[:8]]
    log("decode step under the profiler (B=4, ctx ~512): " + json.dumps(
        {"profile": dict(wall_ms=round(wall, 3),
                         device_busy_ms=round(busy, 3),
                         idle_share=round(1 - busy / wall, 4) if rows
                         else None,
                         paged_attention_ms=round(paged, 4),
                         paged_attention_share=round(paged / busy, 4)
                         if busy else None,
                         kernels=len(rows), device_kernels=n_kernels,
                         top=top)}))


def decode_profile(torch, dev):
    """Phase 4's decode-step profile alone (``--decode-profile``): the same
    engine and weights, so that another commit's port (``--src``) can be
    profiled in the same call."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model_dims
    from repro_torch.params import init_params
    from repro_torch.serve import Engine, EngineConfig
    cfg = get_config("granite-8b")
    params = init_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                         model_dims(cfg), torch.bfloat16, dev)
    eng = Engine(cfg, params, EngineConfig(
        max_batch=4, max_seq_len=1024, auto_release=True,
        dtype=torch.bfloat16), device=dev)
    profile_decode_step(torch, eng, np.random.RandomState(SEED), cfg)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


KERNEL_META = {
    "utopia_translate_step": (
        "src/repro_torch/kernels/utopia_rsw/csrc/utopia_rsw.cu",
        "src/repro/kernels/utopia_rsw/utopia_rsw.py:68"),
    "paged_attention": (
        "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/paged_attention.py:98"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:67"),
}


def card_line(torch) -> None:
    """The card's name and power limit, then the contract's last line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--decode-profile", action="store_true",
                    help="build the kernels and run only phase 4's "
                         "decode-step profile")
    ap.add_argument("--src", type=Path, default=None,
                    help="import repro_torch from this source tree instead "
                         "of the checkout's src/ (e.g. a parent commit's, "
                         "unpacked with git archive)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false); nothing runs on the CPU instead", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    src = args.src.resolve() if args.src else root / "src"
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build   # fails outside a checkout
    dev = torch.device("cuda")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, card "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build()
    for name, (secs, out) in sorted(built.items()):
        ents = ptxas_entries(out)
        spills = [e for e in ents if e[3] or e[4]]
        log(f"build {name}: {secs:.1f} s; {len(ents)} kernels, "
            f"{max((e[1] for e in ents), default=0)} registers at most, "
            f"{len(spills)} spilling")
        # the bf16 flash kernels and anything that spills, one line each
        for k, regs, stack, st, ld in ents:
            if "flash_wgmma_kernel" in k or st or ld:
                log(f"  ptxas {k}: {regs} registers, {stack} bytes stack, "
                    f"{st} bytes spill stores, {ld} bytes spill loads")
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} "
        f"kernel(s) into {_build.BUILD_DIR}")
    if args.decode_profile:
        log(f"decode-step profile of the port in {src}")
        decode_profile(torch, dev)
        card_line(torch)
        return 0

    results = {}
    check_rsw(torch, dev)
    check_translate_step(torch, dev, results)
    check_paged(torch, dev, results)
    check_flash(torch, dev, results)
    torch.cuda.synchronize()
    card_vs_cpu_runs(torch, dev)
    torch.cuda.empty_cache()
    launches = full_width(torch, dev)

    kernels = []
    for name in ("utopia_translate_step", "paged_attention",
                 "flash_attention"):
        r = dict(results[name])
        source, replaces = KERNEL_META[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r.pop("max_abs_err"),
            ms=r["ms"], kernel_ms=r.pop("ms"), **r))
    print(json.dumps({"kernels": kernels}), flush=True)
    card_line(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
