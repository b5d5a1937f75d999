#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one card.

Run from the root of a checkout, without ``PYTHONPATH=src`` (the script
puts ``src`` on its own path, and ``src/sitecustomize.py`` would import
JAX):

    python3 chip_smoke.py
    python3 chip_smoke.py --decode-profile [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --paged-reads [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --moe [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --recurrent [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --frontends [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --translation [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --mesh [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --train [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --mesh-train [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --token-split [--src OTHER_CHECKOUT/src]

The second form builds the kernels and runs only phase 4's decode-step
profile, the third only phase 2's paged-attention checks and timings (the
decode, verify and prefix reads), the fourth only phase 8, the fifth only
phase 9, the sixth only phase 10, the seventh only phase 11, the eighth
only the sharded step's check, phase 5 and phase 12, the ninth only
phase 13 and the tenth only phase 14 (both without building the kernels,
which training does not launch), the eleventh only phase 15, of this
checkout's port or of another
commit's (a parent unpacked with ``git archive``), so that two commits
compare in one call.
Phase 3's first two runs, phase 4 and the profile pass their engine
configuration explicitly (flash attention, recompute prefill, no prefix
cache, ``overload_policy="fail"``), so that their numbers compare with
earlier commits'; phases 5 and 6 run the engine's defaults (with the
paged prefix read), which include preemption to the host KV tier, and
phase 7 the defaults with speculative decoding.

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
   range, an unmapped write block and an inactive row, and with the
   verify step's window of 5 positions (windows crossing into a mapped
   and an unmapped block, past the last block and the vpn range, an
   inactive row), one launch a call; paged attention
   also with a zero-extent row, token-striped shards, and bitwise batch
   and query-rank invariance; flash attention also at every prefill
   bucket length (8 .. 1024).  Paged attention also at the prefix-KV
   prefill's read (Q = 256 queries a row over prefix extents 192, 448, 0
   and 320, the third a padded row that must give l == 0 and m == -1e30;
   queries 0, 3, 4, 127 and 255 must equal Q = 1 launches bitwise) and at
   the verify step's (Q = 5 queries a row, one extent a query: query i
   must equal a Q = 1 launch at its extent bitwise, f32 and bf16), with
   their CTAs a call.
   Then time kernel, plain version, and for
   flash attention ``scaled_dot_product_attention`` (CUDA events and
   profiler device time) as a yardstick the port never calls; the step
   translation beside an empty kernel's device time and PR 12's eager
   composition.  The step translation and paged attention must each be
   one device kernel per call;
3. serve the same requests with a 2-layer full-width granite-8b in
   float32 on the card and on the CPU, with the same weights, three
   times: greedy as in earlier slices, greedy under pool pressure
   (restseg fraction 0.25, a 40-slot pool), where the card must walk the
   flex table and promote blocks, and on the default admission path
   (prefix-KV prefill with the paged prefix read, the prefix cache, half
   the requests sampled with fixed seeds; two requests share a 3-block
   prefix).  Admission logs, manager stats and the cache's stats must be
   identical.  In the first two runs a stream may differ only where the
   top-2 logit margin is below 1e-3; in the third every stream must be
   identical, and a cache-off rerun on the card must give the same
   streams.  A fourth run overloads the engine (``OVERLOAD``: 12 requests
   on a 16-slot pool, budget 256, half sampled) under a fault schedule
   (forced "pre" and "post" preemptions, one of them between a prompt's
   chunks, denials at admit, decode and resume, and the schedule on which
   the JAX engine admits a prompt twice): admission logs, overload,
   manager and cache stats and injector logs identical card vs CPU,
   streams identical except at near-ties; on the card a roomy pool gives
   the same streams under the near-tie rule, and a ``ResilientServe`` run
   with a "pre" and a "post" crash delivers streams bitwise equal to the
   uncrashed run's.  A fifth run decodes speculatively (``SPEC3``: K = 4,
   two of six prompts repeating a passage, half sampled): admission logs,
   manager and cache stats and the spec counters identical card vs CPU,
   streams identical except at near-ties, and on the card spec-off gives
   the same streams under the near-tie rule;
4. serve granite-8b at its published width and depth (36 layers, random
   bfloat16 weights from a seeded generator) through the port's Engine
   with flash attention and recompute prefill: 8 requests, 32 new tokens
   each; every kernel's launch count must grow.  Then profile one
   admission step and one steady decode step (device time by kernel,
   device kernels per step, idle share).  (b), after phase 7: the same
   requests with ``attn_impl="flash_jax"`` (the JAX package's chunked
   eager attention) and recompute prefill: 32 in-vocab tokens a stream,
   no flash kernel launched, the translation and the paged decode read
   launched; it prints where a stream differs from (a)'s with the top-2
   margin there and the admission step's device ms beside (a)'s, then
   holds a 2-layer float32 copy card against CPU (admission logs
   identical, streams under the near-tie rule);
5. serve granite-8b at full width and depth again, with phase 4's
   weights, on the engine's default admission path (dense attention,
   prefix-KV prefill with the paged prefix read, the prefix cache;
   budget 256): 8 requests of 64-704 tokens, four sharing a 384-token
   system prompt, half sampled.  Paged attention must launch with Q > 1,
   the cache must hit, and every stream must hold 32 in-vocab tokens.
   Then profile one prefix-KV admission step;
6. serve granite-8b at full width and depth once more (``PHASE6_RUN``):
   12 requests of 320-704 tokens, 32 new tokens each, half sampled, on
   the engine's defaults with the paged prefix read, three times: (a) on
   the default 80-slot pool, which must not preempt; (b) on a 24-slot
   pool under a fault schedule, which must preempt and resume every
   victim, hold ``check_invariants`` after every step, admit each prompt
   range once, leave nothing mapped or on the host tier, and read back
   from the pool, at every resume, exactly the bytes its preemption
   gathered; (c) run (b) under ``ResilientServe(snapshot_every=8)`` with
   two crashes, whose delivered streams must equal (b)'s bitwise; then
   (d) and (e), runs (a) and (b) on the engine's default
   ``prefix_gather="exact"``, whose tight-vs-roomy streams it reports;
   (f), after phase 7: (c) with its snapshots persisted
   (``CheckpointManager``, ``keep_last=3``), stopped after its second
   crash, the newest committed shard truncated, then resumed in a fresh
   process on the card (``--resume-child``: the same seeded weights,
   ``ResilientServe.from_checkpoint``, which must warn and fall back),
   whose delivered streams with the first process's must equal (b)'s
   bitwise; it prints each save's ms and MB and the restore's ms.  It
   prints the preempt and resume ms, swap bytes, tokens/s of (a) and
   (b), snapshot and restore ms, and where a stream of (b) differs from
   (a)'s, the token, its step, the top-2 margin and both runs' prefill
   buckets;
7. serve granite-8b at full width and depth with speculative decoding
   (``PHASE7``: the engine's defaults plus ``spec_decode="ngram"``, K =
   4): phase 5's 8 requests and two whose prompts repeat a passage,
   spec-off and then spec-on in the same process, ``check_invariants``
   after every step.  Every stream must hold 32 in-vocab tokens, drafts
   must be proposed and accepted on a repetitive request, the per-query
   paged read must launch, each decoding step must launch the
   translation once, and every spec-on stream must equal its spec-off
   stream.  It prints tokens/s and steps of both, emitted tokens per
   row-step, the acceptance rate, a steady verify step's wall and device
   ms beside a decode step's, where a spec-on stream differs from
   spec-off the token, its step and both top-2 margins, and, on one
   verify step's recorded activations, which ops of a layer round a row
   otherwise at the verify's (B, K + 1) shape than at the decode's (B,).
8. free granite-8b's weights and serve the moe family: (a)
   qwen3-moe-30b-a3b at its published width and depth (48 layers, 32/4
   heads of 128, 128 experts of d_ff 768, top-8, vocab 151936; ~61 GB of
   random bf16 weights, the router float32) on phase 5's engine and
   requests, spec-off and then spec-on (K = 4), ``check_invariants``
   after every step: every stream must hold 32 in-vocab tokens, the
   translation, the decode read, the Q > 1 prefix read and the verify
   read must launch, every spec-on stream must equal its spec-off
   stream, and a steady decode step must copy no weight (its copy ops,
   by recorded input shape).  It prints the decode and verify steps'
   wall and device ms, idle share, kernels and largest kernels, a
   prefix-KV admission step's device ms by kernel, tokens/s, peak
   memory, launches, the MoE's ``fraction_dropped`` over the admission
   steps and the verify's MoE rows against the decode shape's; (b) the
   same model cut to 2 layers in float32, card against CPU (4 greedy
   requests of 64-256 tokens, 8 new each): streams, admission logs and
   translation stats identical; (c) qwen2.5-14b at full width cut to 8
   layers (of 48), bf16, nonzero qkv biases, through flash attention and
   recompute prefill (H = 40, KV = 8) and then phase 5's engine (the
   paged reads at g = 5), and the paged reads (decode, verify, prefix)
   and flash attention timed at g = 5 and g = 8 beside their bounds.
9. the recurrent families, in bf16 on phase 5's engine and requests:
   (a) mamba2-130m at its published width and depth (24 layers, d 768,
   24 heads of 64, d_state 128, vocab 50280 tied; attention-free), the
   defaults, then ``spec_decode="ngram"`` (one warning, spec_K = 0, the
   same streams), then forced preemptions (the same streams; the host
   tier carries the ssm/conv rows): no CUDA kernel may launch; (c) float32
   card = CPU (streams, admission logs, translation stats) for mamba2 cut
   to 4 layers and a reduced-width jamba, with a pad check (a 7-block
   prompt in an 8-block bucket beside a 5-block row installs the state of
   its exact-length forward: bitwise on the CPU, reported on the card);
   the paged decode and prefix reads and flash attention at jamba's
   64/8 heads of 128 against their plain versions and bounds; (b)
   jamba-1.5-large-398b at its published width (d 8192, 64/8 heads,
   d_ff 24576, 16 experts top-2, mamba d_inner 16384, d_state 16, vocab
   65536) cut to one group of 6 sublayers (34.05 B parameters, 68.1 GB),
   phase 5's defaults with the paged prefix read (the translation, the
   decode and Q > 1 reads must launch), then recompute prefill with
   ``attn_impl="pallas"`` (flash must launch); the prefix cache is off
   for a recurrent family.  Each prints weights and peak GiB, decode-step
   ms, a steady step's profile, ``fraction_dropped`` and the pad check in
   bf16.
10. the frontend families: the kernels at paligemma-3b's 8/1 heads of
   256 and whisper-medium's 16/16 of 64 (the decode, verify and prefix
   reads, each query of a Q > 1 read held bitwise to a Q = 1 launch;
   flash causal at (2, 512, 8, 1, 256) and full at (2, 1500, 16, 16,
   64), whisper's encoder, and (2, 256 vs 1500, 16, 16, 64), its
   cross-attention, in bf16 against the float32 plain version at limits
   scaled to the kernel's rounding and in float32 at 1e-4) against their
   plain versions, bounds and SDPA; (c)
   float32 card = CPU for both at d 512, cut to 2 layers (4 greedy
   requests with random frontends); then, in bf16 at full width and
   depth with seeded random weights and frontends, (a) paligemma-3b (18
   layers, d 2048, 8/1 heads of 256, d_ff 16384, vocab 257216 tied, 256
   image embeddings) on phase 5's engine and requests and (b)
   whisper-medium (24 encoder and 24 decoder layers, d 1024, 16/16
   heads of 64 with qkv biases, vocab 51865, 1500 frame embeddings) on
   phase 5's engine with a 448-position context and prompts of 64-384
   tokens: the defaults with the paged prefix read, spec-on against
   spec-off (held equal), recompute with ``attn_impl="pallas"`` (flash
   must run at D = 256, and on whisper's encoder and cross-attention),
   and for whisper forced preemptions of decode-live rows whose resumes
   must restore the pool blocks and the ``cross_k``/``cross_v`` rows
   byte for byte and keep the streams.  Each prints weights and peak
   GiB, a steady decode and verify step's profile, an admission step's
   (the encoder's share for whisper), the decode step's cross-attention
   device ms (whisper), tokens/s, launches and ``streams_sha256``; the
   prefix cache is off for both, and the phase prints why.
11. the paper's translation comparison (Figs. 18-20) at the translation
   tables of a full granite-8b KV pool on one H100 (``PHASE11``: 6,144
   slots, 576 sets of 8 ways and 1,536 flexible slots; 64 sequences of
   72 blocks mapped in the manager, a 4-level radix tree of fanout 16
   and an elastic cuckoo table; a 2,048-entry POM-TLB filled with the
   stream's first half): a Zipf (a = 1.2) stream of 2^20 accesses in
   batches of 8,192 vpns through Utopia's ``translate`` (one launch of
   the RSW kernel's vpn-list entry a call), the flat table, the radix
   walk, the RSW before the radix walk, ECH and the POM-TLB, every
   integer output equal to the CPU plain run's on every batch;
   ``translate`` on out-of-range vpns at every hash (the JAX package's
   2-D flex read) and against the decode step's translation telemetry.
   It prints accesses and bytes a translation, device and wall µs and
   kernels a batch, the RSW hit share, the table sizes, and the vpn-list
   entry's time at 8,192 vpns beside its plain version and bound.
12. sharded serving (after phase 6 (f), with granite-8b's weights):
   phase 2 first holds the RSW kernel's sharded step (``check_translate_
   shard``: each rank's shard entry, the sum of the contributions, the
   combine) against its plain version and the unsharded step at M = 1, 2
   and 4 ranks, windows 1 and 5, and times its two entries beside an
   empty kernel; then (a) ``mesh_shape=(1, 1)`` over NCCL (world size 1,
   this process) on phase 5's engine and requests, whose digest must be
   phase 5's, and (b) ``mesh_shape=(1, 2)`` as two processes on the card
   over gloo with CUDA tensors (``--mesh-child``; NCCL refuses two ranks
   on one device), granite-8b at full width, ``PHASE12_LAYERS`` deep,
   spec decoding on and a forced preemption (``PHASE12_PREEMPT``): each
   rank's streams, overload stats and per-shard sums must equal a
   ``mesh_shape=None`` run of the same configuration run here.  Every
   step that decodes must launch the shard entry and the combine once on
   each rank, and the unsharded step entry never.  It prints per-step
   wall and device ms at (1, 1) and (1, 2) and the bytes each step's
   exact gathers move.
13. training (last, every earlier model freed): (a) granite-8b at full
   width (d 4096, 32/8 heads, d_ff 14336, vocab 49152) cut to
   ``PHASE13["layers"]`` = 12 of its 36 layers (AdamW in float32 holds
   16 B a parameter: 48.3 GB at 12 layers, 132 GB at 36), 20 steps
   through ``ResilientLoop`` with the launcher's settings (float32, TF32
   off, ``flash_jax``, remat, AdamW, lr 3e-4, 5 warmup steps, batch 8 x
   128 ``SyntheticLM`` tokens, seed 0; no checkpoint in the window): the
   losses must be finite and the last below the first; it prints the
   median step's wall ms, a profiled step's device ms and idle share,
   peak memory, tokens/s and the AdamW update's ms beside its bytes
   bound; (b) the JAX test's restart-and-replay scenario on the card
   (reduced granite-8b, 2 microbatches, int8 compression, remat, a fault
   at step 17, checkpoints every 10 steps): the replayed losses must
   equal the first pass's bitwise; a checkpoint's MB and save ms; (c)
   float32 card = CPU for three train steps of each of the six families
   at ``reduced`` (``PHASE13_TOL``); (d) ``python -m
   repro_torch.launch.train --arch granite-8b --reduced --steps 10`` as
   a child process on the card, which must exit 0, print its ``done:``
   line and import nothing of JAX.  No kernel may launch in (a)-(c).
14. training over a (data, model) mesh (last, after phase 13's state is
   freed): (a) the mesh step at ``(1, 1)`` over NCCL (world size 1, this
   process) on phase 13 (a)'s model, schedule, seed and batches,
   ``PHASE14_STEPS`` = 5 steps through ``ResilientLoop`` with a sharded
   ``CheckpointManager``: its gathers and reductions run on groups of one
   (counted), and its losses must equal phase 13 (a)'s first five
   bitwise (``--mesh-train`` alone runs those five single-device steps
   first); (b) ``(1, 2)`` and then ``(2, 1)`` as two processes on the
   card over gloo (``--mesh-train-child``), granite-8b at full width cut
   to ``PHASE14_LAYERS`` = 2 layers, float32, AdamW, 3 steps: every
   rank's losses within ``PHASE14_TOL`` = 2e-4 of a single-device run
   here, its gradient norms within ``PHASE14_GNORM_RTOL`` and its
   gathered parameters' norms and ramp sums after the last step within
   ``PHASE14_PARAM_RTOL``, and at (1, 2) first the Megatron forward against the
   single-device forward (``PHASE14_MEGATRON_TOL``); each rank prints its
   state bytes, step wall ms, the bytes its gathers and reductions hand
   over a step and its peak memory; (c) ``torchrun --nproc-per-node 2 -m
   repro_torch.launch.train --arch granite-8b --reduced --steps 4
   --data-mesh 1 --model-mesh 2`` as a child, which must exit 0, print
   ``done:`` and import nothing of JAX.  No kernel may launch in (a) or
   (b).
15. the token-split layout (the JAX package's ``kv_shards=0`` mesh path,
   its dry run's) over a (2, 2) mesh: four processes on the card over
   gloo (``--token-split-child``), granite-8b at full width (64-token
   blocks, 32 a rank).  First the kernels at its geometries
   (``check_token_split_kernels``): the RSW step entry with the group
   layout bitwise its plain version at four layouts, one launch a call,
   and the paged read of a token shard and of a striped rank
   (``block_tokens = 128``) within 3e-2 of theirs, each timed beside its
   bound.  Then each rank runs, and this process runs on one device
   (``mesh=None``) with the same weights and inputs: (a) float32, 2
   layers, batch mode, 4 prompts through the token-split recompute
   prefill with the flash kernel, 16 greedy steps: logits within 1e-4 of
   the largest, streams equal, each rank's translation bitwise its plain
   version; (b) bf16, 12 layers, batch mode, prompts of 256-1024 tokens,
   32 steps: the streams' agreement (the top-2 margin where a row first
   differs), each rank's step wall and device ms, idle share, launches
   and gloo bytes a step; (c) bf16, 12 layers, striped mode, one row of a
   131,072-token context written straight into the pools, 16 steps held
   to mesh=None within ``PHASE15_C["tol"]``, peak memory a rank; (d) the
   serve CLI (``python -m repro_torch.launch.serve --arch granite-8b
   --requests 8 --max-new 16``), alone and at ``--data 1 --model 2``
   under torchrun, each exit 0 with its printout.

Each serving phase prints a digest of its streams (``streams_sha256``), so
that two commits' runs compare token for token.

It prints the build times, the kernel checks, the serving numbers, one
JSON line of kernel measurements (launches counted on phases 4, 5, 6, 7,
4 (b), 6 (f), 8 (a) and (c), 9 (a) and (b), 10 (a) and (b), 11, 12,
13, 14 and 15 (its four ranks' added), each from 0; the RSW's
``launches`` are its step entry's, ``launches_group_layout`` those of
them on a token-split rank, ``launches_vpn_list`` its vpn-list entry's
and ``launches_shard`` / ``launches_combine`` its sharded step's two
entries'), the card's name
and power limit, and as its last line ``{"ok": true, "device":
{...}}``.  Without a CUDA card, or without the rest of the repository
beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
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


def sync_ms(torch, fn, *args):
    """(``fn(*args)``, its wall ms between two device synchronisations)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


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
    """Device ms of the kernel whose name holds one of ``symbols`` (one
    launch a call of ``fn``), per launch the profiler captured: on the
    card's machine it now and then records only some of a profile's
    launches, and a sum per call would then read low.  With ``symbols``
    None, the device ms per call of every kernel ``fn`` launches.  None
    when the profiler saw none."""
    rows = profile_device(torch, fn, iters)
    if symbols is None:
        return sum(ms for _, ms, _ in rows) if rows else None
    hits = [(ms, n) for name, ms, n in rows
            if any(x in name for x in symbols)]
    n = sum(n for _, n in hits)
    return sum(ms for ms, _ in hits) / n if n else None


def launches_per_call(torch, fn, iters=5, tries=3):
    """Device kernels per call of ``fn`` (profiler), for the one-launch
    contract; fails when the profiler saw none, since then the contract
    cannot be checked.  A session that captured fewer launches than one a
    call lost events (the card's machine's profiler now and then does;
    every ``fn`` here launches at least one kernel) and is profiled again,
    up to ``tries`` times."""
    for _ in range(tries):
        rows = profile_device(torch, fn, iters)
        if not rows:
            raise AssertionError("the profiler saw no device kernel, so "
                                 "the kernels per call cannot be counted")
        n = sum(n for _, _, n in rows)
        if n >= 1:
            break
    return n


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


def check_flash_bf16(name, got, q, k, v, causal) -> dict:
    """Hold flash attention's bf16 output ``got`` to the float32 plain
    version on the same bf16 inputs, at limits scaled to what is compared.
    The kernel rounds each softmax weight to bf16 (within 2^-9 of itself)
    before its P V product and the output to bf16 (within 2^-8), so each
    element lies within 2^-7 (|want| + A) of the float32 value, A being
    the same weights' average of |v|; rounding keeps the error's norm
    near 0.29 bf16 ulps of the output's, held within 2^-8 of it.  A kernel
    that drops keys or lets masked ones in (a ragged tail) breaks one or
    both.  Returns the max abs error, the limit at that element and both
    ratios to their limits."""
    from repro_torch.models.attention import dense_attention
    q32, k32, v32 = (t.float() for t in (q, k, v))
    want = dense_attention(q32, k32, v32, causal=causal)
    lim = 2 ** -7 * (want.abs()
                     + dense_attention(q32, k32, v32.abs(), causal=causal))
    err = (got.float() - want).abs()
    at = int(err.argmax())
    out = dict(max_abs_err=float(err.max()),
               tol_at_max=float(lim.flatten()[at]),
               elem_ratio=float((err / lim.clamp_min(1e-30)).max()),
               norm_ratio=float(err.norm() / want.norm() / 2 ** -8))
    if not (out["elem_ratio"] <= 1 and out["norm_ratio"] <= 1):
        raise AssertionError(f"{name}: kernel disagrees with its float32 "
                             f"plain version: {out}")
    return out


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


def _rsw_table_bytes(torch, q, tar, sf, flex, hash_name, mbps=0):
    """Table bytes the RSW must read for the vpns ``q`` on THIS data: the
    SF word of every distinct set probed, the TAR row of every distinct
    probed set whose SF is non-zero and the flex entry of every distinct
    vpn that missed, each once.  ``tar`` (n_sets, assoc), ``sf`` and
    ``flex`` as the vpn-list entry takes them, on the CPU."""
    from repro_torch.core.hashes import get_hash
    from repro_torch.kernels.utopia_rsw.ref import rsw_ref
    n_sets, assoc = tar.shape
    _, hit, _, _ = rsw_ref(q, tar, sf, flex, hash_name=hash_name,
                           max_blocks_per_seq=mbps)
    sets = torch.unique(get_hash(hash_name)(q, n_sets).long())
    live = sets[sf[sets] > 0]
    misses = torch.unique(q[hit == 0])
    return (4 * sets.numel() + 4 * assoc * live.numel()
            + 4 * misses.numel())


def _step_bytes(torch, tables, nblk, hash_name):
    """Bytes the step's translation must move for THIS data: the RSW's
    tables (``_rsw_table_bytes``), ctx_len and the active mask, each
    once; the output once."""
    from repro_torch.kernels.utopia_rsw.ref import step_words
    tar, sf, flex, ctx, _ = (t.cpu() for t in tables)
    B = ctx.shape[0]
    q = torch.arange(B * nblk, dtype=torch.int32)   # the write blocks too
    read = (_rsw_table_bytes(torch, q, tar[0], sf[0], flex[0], hash_name)
            + 4 * B + B)
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
        nbytes = _step_bytes(torch, tables, nblk, "modulo")
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


# the verify step's window: K + 1 positions a row (K = 4 drafts)
WINDOW = 5


def _window_case(torch, dev, hash_name, B=6, nblk=16, bs=64, slots=80,
                 frac=0.25):
    """Tables and context lengths whose windows of ``WINDOW`` positions
    run past the last block (row 0), cross into a mapped next block
    (row 1) or an unmapped one (row 2), lie past the vpn range (row 4) or
    inside one block (row 5); row 3 is inactive."""
    import numpy as np
    from repro_torch.core import HybridConfig, HybridKVManager
    m = HybridKVManager(HybridConfig(
        block_size=bs, total_slots=slots, restseg_fraction=frac, assoc=8,
        max_seqs=B, max_blocks_per_seq=nblk, hash_name=hash_name))
    ctx = np.asarray([nblk * bs - 2, 2 * bs - 2, 3 * bs - 3, bs + 3,
                      nblk * bs + 5, 1], np.int32)
    last = [nblk - 1, 2, 2, 1, nblk - 1, 0]
    for sid in range(B):
        m.register_sequence(sid)
    for b in range(nblk):
        for sid in range(B):
            if b <= last[sid]:
                m.allocate_block(sid, b)
    active = np.asarray([True, True, True, False, True, True])
    up = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        m.tar[None], m.sf[None], m.flex_table.reshape(1, -1), ctx, active)]
    geom = dict(block_size=bs, nblk=nblk, hash_name=hash_name, sink=slots)
    return up, geom, m.cfg.num_sets


def check_translate_window(torch, dev, results):
    """The step entry with a window (the verify step's translation, W =
    K + 1) against its plain version, exactly (the whole output buffer),
    at W = 1 and W = ``WINDOW`` for all five hashes, with and without the
    active mask; then its device kernels per call through
    ``translate_step``, which must be 1, and its device time."""
    from repro_torch.kernels.utopia_rsw.ops import utopia_translate_step
    from repro_torch.kernels.utopia_rsw.ref import translate_step_ref
    from repro_torch.serve.decode import DecodeSpec, translate_step
    for h in HASHES:
        (tar, sf, flex, ctx, active), geom, n_sets = _window_case(torch, dev,
                                                                  h)
        for W in (1, WINDOW):
            for act in (None, active):
                got = utopia_translate_step(tar, sf, flex, ctx, act,
                                            window=W, **geom)
                want = translate_step_ref(tar, sf, flex, ctx, act, window=W,
                                          **geom)
                if not torch.equal(got.out, want.out):
                    raise AssertionError(f"translate_step window {W} [{h}] "
                                         "differs from the plain version")
    spec = DecodeSpec(block_size=geom["block_size"],
                      max_blocks_per_seq=geom["nblk"],
                      slots_per_group=geom["sink"], n_sets=n_sets, assoc=8,
                      hash_name=h)
    bound = {}
    fn = lambda: translate_step(tar, sf, flex, ctx, spec, active, bound,
                                window=WINDOW)
    per_call = launches_per_call(torch, fn)
    if per_call != 1:
        raise AssertionError(f"translate_step window {WINDOW}: {per_call} "
                             "device kernels per call, expected 1")
    r = dict(window=WINDOW, rows=int(ctx.shape[0]), kernels_per_call=per_call,
             device_ms=device_ms(torch, fn, 100, ("translate_step_kernel",)),
             ms=time_ms(torch, [fn], 400))
    results["utopia_translate_step"]["window"] = r
    log(f"check translate_step window: exact at W = 1 and {WINDOW} on 5 "
        "hashes (windows past the last block, into a mapped and an "
        "unmapped block, past the vpn range, an inactive row); "
        + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in r.items()}))


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


def check_paged_verify(torch, dev, results):
    """The verify step's read: one query a window position and one extent
    a query.  Query i of a Q = K + 1 launch with extents pos+1 .. pos+K+1
    must equal, bitwise, a Q = 1 launch at extent pos+i+1, in float32 and
    bf16 (the kernel half of spec decode's losslessness); then the bf16
    read at B=4, Q=5, H=32, KV=8, D=128 is held to its plain version
    (3e-2) and timed beside its bytes bound, each row's blocks up to its
    last extent read once."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    gen = torch.Generator().manual_seed(SEED + 2)
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, slots, ext = _paged_case(torch, dev, dtype, Q=WINDOW,
                                            per_query=True, gen=gen)
        q = q.to(dtype)
        wide = paged_attention(q, kp[0], vp[0], slots, ext)
        for i in range(WINDOW):
            one = paged_attention(q[:, i].contiguous(), kp[0], vp[0], slots,
                                  ext[:, i].contiguous())
            if not all(torch.equal(x, y[:, i]) for x, y in zip(one, wide)):
                raise AssertionError(
                    f"paged_attention per-query [{dtype}]: query {i} of "
                    f"Q={WINDOW} differs from a Q=1 launch at its extent")
    L = 8
    q, kp, vp, slots, ext = _paged_case(torch, dev, torch.bfloat16, L=L,
                                        Q=WINDOW, per_query=True, gen=gen)
    q = q.to(torch.bfloat16)
    err = max(check_close("paged_attention[verify read]", g, w, 3e-2)
              for g, w in zip(paged_attention(q, kp[0], vp[0], slots, ext),
                              paged_attention_ref(q, kp[0], vp[0], slots,
                                                  ext)))
    kern = [lambda i=i: paged_attention(q, kp[i], vp[i], slots, ext)
            for i in range(L)]
    plain = [lambda i=i: paged_attention_ref(q, kp[i], vp[i], slots, ext)
             for i in range(L)]
    per_call = launches_per_call(torch, kern[0])
    if per_call != 1:
        raise AssertionError(f"paged_attention verify read: {per_call} "
                             "device kernels per call, expected 1")
    B, Q, H, D = q.shape
    bs, KV = kp.shape[2], kp.shape[3]
    last = ext[:, -1].tolist()
    n_tok = sum(-(-e // bs) * bs for e in last) - bs    # the hole in row 0
    nbytes = (q.numel() * 2 + 2 * n_tok * KV * D * 2 + slots.numel() * 4
              + ext.numel() * 4 + B * Q * H * D * 4 + 2 * B * Q * H * 4)
    flops = 4 * D * H * int(ext.sum())
    bound_bytes = nbytes / HBM_BYTES_PER_S
    bound_ops = flops / PEAK_FLOPS["bfloat16"]
    r = dict(
        max_abs_err=err, ms=time_ms(torch, kern, 80),
        device_ms=device_ms(torch, kern[0], 20, ("paged_attn_kernel",)),
        plain_ms=time_ms(torch, plain, 16),
        bound_ms=max(bound_bytes, bound_ops) * 1e3,
        bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        bytes=nbytes, flops=flops, device_kernels_per_call=per_call,
        ctas=_grid_ctas(B, Q, H, KV, D, slots.shape[1]),
        shape=f"B={B} Q={Q} H={H} KV={KV} D={D} bs={bs} per-query extents "
              f"{ext.tolist()} bf16")
    results["paged_attention_verify_read"] = r
    log(f"check paged_attention verify read: query i of Q={WINDOW} == a "
        "Q=1 launch at extent pos+i+1 bitwise (f32 and bf16); max abs err "
        f"{err:.3g} (tol 3e-2); " + json.dumps(
            {k: (round(v, 6) if isinstance(v, float) else v)
             for k, v in r.items()}))


# the prefix-KV prefill's pool read: a bucket of 4 chunks of 256 tokens
# over prefix extents that are no multiples of 256; row 2 is a pad row
PREFIX_READ = dict(B=4, Q=256, H=32, KV=8, D=128, bs=64, nblk=16,
                   extents=(192, 448, 0, 320))


def _prefix_read_case(torch, dev, gen):
    """bf16 q (B, Q, H, D) and pools, each row's prefix blocks mapped to
    distinct slots (the rest -1, a pad row all -1) and its extent."""
    c = PREFIX_READ
    B, Q, H, KV, D, bs, nblk = (c[k] for k in ("B", "Q", "H", "KV", "D",
                                                "bs", "nblk"))
    n_slots = 64
    perm = torch.randperm(n_slots, generator=gen)
    slots = torch.full((B, nblk), -1, dtype=torch.int32)
    used = 0
    for b, e in enumerate(c["extents"]):
        nb = -(-e // bs)
        slots[b, :nb] = perm[used:used + nb].to(torch.int32)
        used += nb
    q = torch.randn((B, Q, H, D), generator=gen).to(dev, torch.bfloat16)
    kp = torch.randn((n_slots, bs, KV, D), generator=gen).to(
        dev, torch.bfloat16)
    vp = torch.randn((n_slots, bs, KV, D), generator=gen).to(
        dev, torch.bfloat16)
    ctx = torch.tensor(c["extents"], dtype=torch.int32)
    return q, kp, vp, slots.to(dev), ctx.to(dev)


def _grid_ctas(B, Q, H, KV, D, nblk):
    """CTAs a call of the paged read launches (None for a port from before
    the query tiles, run with ``--src``, whose ops have no ``cta_grid``)."""
    from repro_torch.kernels.paged_attention import ops
    if not hasattr(ops, "cta_grid"):
        return None
    x, y, z = ops.cta_grid(B, Q, H, KV, D, nblk)
    return x * y * z


PREFIX_QUERIES = (0, 3, 4, 127, 255)     # sampled queries held bitwise


def check_paged_prefix(torch, dev, results):
    """Paged attention at the prefix-KV prefill's read (the Q > 1 path of
    ``serve/prefill.py``, ``prefix_gather="paged"``): held against its
    plain version at 3e-2, the pad row exact (l == 0, m == -1e30), queries
    ``PREFIX_QUERIES`` bitwise equal to Q = 1 launches, one device kernel
    per call; timed beside its plain version and its bytes bound with each
    row's prefix K/V read once."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    gen = torch.Generator().manual_seed(SEED + 1)
    sets = [_prefix_read_case(torch, dev, gen) for _ in range(4)]
    q, kp, vp, slots, ctx = sets[0]
    got = paged_attention(q, kp, vp, slots, ctx)
    want = paged_attention_ref(q, kp, vp, slots, ctx)
    err = max(check_close("paged_attention[prefix read]", g, w, 3e-2)
              for g, w in zip(got, want))
    o, m, l = got
    if float(l[2].abs().max()) != 0.0 or bool((m[2] != -1e30).any()):
        raise AssertionError("paged_attention prefix read: the pad row "
                             "must give l == 0 and m == -1e30")
    for i in PREFIX_QUERIES:
        one = paged_attention(q[:, i].contiguous(), kp, vp, slots, ctx)
        if not all(torch.equal(x, y[:, i]) for x, y in zip(one, got)):
            raise AssertionError(f"paged_attention prefix read: query {i} "
                                 "differs from a Q=1 launch")
    kern = [lambda s=s: paged_attention(*s) for s in sets]
    plain = [lambda s=s: paged_attention_ref(*s) for s in sets]
    per_call = launches_per_call(torch, kern[0])
    if per_call != 1:
        raise AssertionError(f"paged_attention prefix read: {per_call} "
                             "device kernels per call, expected 1")
    c = PREFIX_READ
    B, Q, H, KV, D, bs = (c[k] for k in ("B", "Q", "H", "KV", "D", "bs"))
    n_tok = sum(-(-e // bs) * bs for e in c["extents"])
    nbytes = (B * Q * H * D * 2 + 2 * n_tok * KV * D * 2
              + slots.numel() * 4 + ctx.numel() * 4
              + B * Q * H * D * 4 + 2 * B * Q * H * 4)
    flops = 4 * D * H * Q * sum(c["extents"])
    bound_bytes = nbytes / HBM_BYTES_PER_S
    bound_ops = flops / PEAK_FLOPS["bfloat16"]
    r = dict(
        max_abs_err=err, ms=time_ms(torch, kern, 40),
        device_ms=device_ms(torch, kern[0], 10, ("paged_attn_kernel",)),
        plain_ms=time_ms(torch, plain, 8),
        bound_ms=max(bound_bytes, bound_ops) * 1e3,
        bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        bytes=nbytes, flops=flops, device_kernels_per_call=per_call,
        ctas=_grid_ctas(B, Q, H, KV, D, c["nblk"]),
        shape=f"B={B} Q={Q} H={H} KV={KV} D={D} bs={bs} nblk={c['nblk']} "
              f"extents={list(c['extents'])} bf16")
    results["paged_attention_prefix_read"] = r
    log("check paged_attention prefix read (" + r["shape"] + "): max abs "
        f"err {err:.3g} (tol 3e-2), pad row l == 0 and m == -1e30, queries "
        f"{list(PREFIX_QUERIES)} == Q=1 launches bitwise; "
        + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in r.items() if k != "shape"}))


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


def serve(eng, requests, each_step=None):
    """Submit, step to completion; ``each_step(eng)`` runs after every
    step, outside its timing.  Returns ({seq_id: tokens}, steps): one
    record per step of (wall s, chunks admitted (ChunkRecords), rows
    decoding, {seq_id: token}, {seq_id: batch slot})."""
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
        steps.append((time.perf_counter() - t0, eng.admission_log[n_log:],
                      live, out, {**slots, **eng._slot_of}))
        if each_step is not None:
            each_step(eng)
        if len(steps) > 10000:
            raise RuntimeError("engine failed to drain")
    return ({sid: list(st.generated) for sid, st in eng._states.items()},
            steps)


def record_margins(eng, margins):
    """Wrap the engine's steps to keep each step's top-2 logit margins,
    keyed by (kind, step) and then batch slot, a digest of each row's
    logits, keyed by (kind + "_digest", step), and the shape of each
    prefill bucket a slot ran in, keyed by ("bucket", step): (path,
    (padded rows, padded tokens[, prefix read width in blocks]))."""
    import torch
    serve_step = eng._serve_step

    def top2(logits):
        v = logits.float().topk(2, dim=-1).values
        return (v[:, 0] - v[:, 1]).tolist()

    def digest(logits):
        """A hash of each row's float32 bit pattern: two rows' logits are
        bitwise equal when (up to collisions) their digests are."""
        bits = logits.float().view(torch.int32).to(torch.int64)
        w = torch.arange(bits.shape[-1], device=bits.device) % 251 + 1
        return (bits * w).sum(-1).tolist()

    def serve_rec(params, dstate, tokens, active=None, **kw):
        logits, dstate, stats = serve_step(params, dstate, tokens, active,
                                           **kw)
        margins[("decode", eng.step_count)] = dict(enumerate(top2(logits)))
        margins[("decode_digest", eng.step_count)] = dict(
            enumerate(digest(logits)))
        return logits, dstate, stats

    def first_rec(step, sid_arg, path):
        """A prefill step's wrapper; its ``sid_arg``-th argument after the
        batch is ``slot_ids`` (the prefix-KV step's first is the new
        slots, its second the prefix read buffer)."""
        def rec(params, dstate, batch, *args, **kw):
            last, dstate, stats = step(params, dstate, batch, *args, **kw)
            row = margins.setdefault(("prefill", eng.step_count), {})
            shape = tuple(batch["tokens"].shape)
            if path == "prefix_kv":
                shape += (int(args[1].shape[1]),)
            buckets = margins.setdefault(("bucket", eng.step_count), {})
            digests = margins.setdefault(("prefill_digest", eng.step_count),
                                         {})
            for sid, m, d in zip(args[sid_arg].tolist(), top2(last),
                                 digest(last)):
                if sid >= 0:
                    row[sid] = m
                    buckets[sid] = (path, shape)
                    digests[sid] = d
            return last, dstate, stats
        return rec

    def spec_rec(params, dstate, tokens, active=None, **kw):
        """A verify step: per active slot, the stream length before the
        step and the top-2 margins of its K+1 window positions."""
        lens = {slot: len(eng._states[sid].generated)
                for sid, slot in eng._slot_of.items()}
        logits, dstate, stats = spec_step(params, dstate, tokens, active,
                                          **kw)
        v = logits.float().topk(2, dim=-1).values
        m = (v[..., 0] - v[..., 1]).tolist()
        act = active.tolist()
        margins[("verify", eng.step_count)] = {
            slot: (n, m[slot]) for slot, n in lens.items() if act[slot]}
        return logits, dstate, stats

    eng._serve_step = serve_rec
    eng._prefill_step = first_rec(eng._prefill_step, 1, "recompute")
    eng._prefix_step = first_rec(eng._prefix_step, 2, "prefix_kv")
    spec_step = getattr(eng, "_spec_step", None)
    if spec_step is not None:
        eng._spec_step = spec_rec


def buckets_of(margins, steps, sid):
    """[(step, path, bucket shape)] of every prefill dispatch ``sid`` ran
    in."""
    out = []
    for step, rec in enumerate(steps, start=1):
        row = margins.get(("bucket", step), {})
        slot = rec[4].get(sid)
        if slot in row:
            out.append((step,) + row[slot])
    return out


def first_logits_difference(run_a, run_b, sid):
    """Index of the first token of ``sid`` whose logits differ bitwise
    between two runs recorded by ``record_margins`` (each run given as
    (margins, steps)), or None when they never do."""
    def digests(margins, steps):
        out = []
        for step, (_, _, _, toks, slots) in enumerate(steps, start=1):
            if sid in toks:
                kind = "prefill" if not out else "decode"
                out.append(margins[(kind + "_digest", step)][slots[sid]])
        return out

    a, b = digests(*run_a), digests(*run_b)
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def margin_of(margins, steps, sid, i):
    """(step, top-2 margin of the logits) that produced token ``i`` of
    ``sid``: under speculative decoding, the window position of the last
    verify step whose window held token i."""
    seen, found = 0, (None, None)
    for step, (_, _, _, out, slots) in enumerate(steps, start=1):
        if sid not in out:
            continue
        spec = margins.get(("verify", step), {}).get(slots[sid])
        if spec is not None:
            n0, ms = spec
            if n0 <= i < n0 + len(ms):
                found = (step, ms[i - n0])
            continue
        if seen == i:
            kind = "prefill" if i == 0 else "decode"
            return step, margins[(kind, step)][slots[sid]]
        seen += 1
    return found


# phases 3 and 4 (and the decode profile) pin the configuration of earlier
# slices, so that their numbers compare with earlier commits'
EARLIER_PATH = dict(attn_impl="flash", prefill_mode="recompute",
                    prefix_cache=None, overload_policy="fail")
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


def smoke_requests(prompts, new_tokens, sampled=(), frontends=None):
    """One request per prompt (with ``frontends[i]`` as its frontend when
    given); those whose index is in ``sampled`` sample with fixed seeds."""
    from repro_torch.serve import Request, SamplingParams
    return [Request(seq_id=i, prompt=p, max_new_tokens=new_tokens,
                    frontend=None if frontends is None else frontends[i],
                    sampling=(SamplingParams(seed=SEED + 100 + i, **SAMPLED)
                              if i in sampled else SamplingParams()))
            for i, p in enumerate(prompts)]


def near_tie(margins, steps, a, b, sid):
    """None when streams ``a`` and ``b`` of ``sid`` are equal, else (index
    of the first differing token, its step, the top-2 logit margin of the
    run that recorded ``margins`` and ``steps``)."""
    if a == b:
        return None
    i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    step, m = margin_of(margins, steps, sid, i)
    return i, step, m


def card_vs_cpu(torch, dev, params, prompts, new_tokens, label,
                sampled=(), strict=False, rerun=None, schedule=None,
                frontends=None, **engine_kw):
    """Serve the same requests on the card and on the CPU with the same
    weights (a 2-layer full-width granite-8b in float32); requests whose
    index is in ``sampled`` sample with fixed seeds, and ``schedule``
    (``ServeFaultInjector`` arguments) gives each run a fault injector.
    Admission log, manager stats, the prefix cache's and the overload
    stats and the injector logs must be identical.  A stream may differ
    only from a near-tie (top-2 logit margin below 1e-3), or not at all
    with ``strict``.  ``rerun`` (engine overrides) serves the requests
    once more on the card, and its streams must equal the first card
    run's.  ``frontends`` gives each request its frontend.  Returns the
    card's ``stats()``, streams, margins and steps."""
    from repro_torch.runtime import ServeFaultInjector
    from repro_torch.serve import Engine, EngineConfig
    cfg, params = params

    def requests():
        return smoke_requests(prompts, new_tokens, sampled, frontends)

    ecfg = EngineConfig(auto_release=True, **engine_kw)
    runs, margins, logs = {}, {}, {}
    cuda_params = to_device(params, dev)
    for name, d, p in (("cuda", dev, cuda_params),
                       ("cpu", torch.device("cpu"), params)):
        inj = (ServeFaultInjector(**schedule) if schedule is not None
               else None)
        eng = Engine(cfg, p, dataclasses.replace(ecfg, fault_injector=inj),
                     device=d)
        if name == "cuda":
            record_margins(eng, margins)
        t0 = time.perf_counter()
        streams, steps = serve(eng, requests())
        runs[name] = (streams, steps, eng, time.perf_counter() - t0)
        logs[name] = None if inj is None else inj.log
    (cs, csteps, ceng, ct), (ps, _, peng, pt) = runs["cuda"], runs["cpu"]
    # no eos: the schedule, and so the translation, cannot depend on the
    # token values, only the streams can
    if ceng.admission_log != peng.admission_log:
        raise AssertionError(f"{label}: card and CPU admitted differently")
    if dict(ceng.manager.stats) != dict(peng.manager.stats):
        raise AssertionError(f"{label}: card and CPU translation stats "
                             "differ")
    cst, pst = ceng.stats(), peng.stats()
    for key in ("prefix_cache", "overload", "spec_drafted", "spec_accepted"):
        if cst[key] != pst[key]:
            raise AssertionError(f"{label}: card and CPU {key} stats "
                                 f"differ ({cst[key]} vs {pst[key]})")
    if logs["cuda"] != logs["cpu"]:
        raise AssertionError(f"{label}: card and CPU injector logs differ "
                             f"({logs['cuda']} vs {logs['cpu']})")
    ceng.check_invariants()
    same = 0
    for sid in sorted(cs):
        diff = near_tie(margins, csteps, cs[sid], ps[sid], sid)
        if diff is None:
            same += 1
            continue
        i, step, m = diff
        log(f"card vs CPU ({label}): request {sid} "
            f"({'sampled' if sid in sampled else 'greedy'}) diverges at "
            f"token {i} (step {step}): card {cs[sid][i]} vs CPU "
            f"{ps[sid][i]}, top-2 logit margin {m}")
        if strict or m is None or m >= 1e-3:
            raise AssertionError(f"{label}: card and CPU streams diverge "
                                 f"at step {step} (top-2 margin {m})")
    if rerun is not None:
        eng = Engine(cfg, cuda_params, dataclasses.replace(ecfg, **rerun),
                     device=dev)
        again, _ = serve(eng, requests())
        for sid in sorted(cs):
            if again[sid] != cs[sid]:
                i = next(k for k, (a, b) in enumerate(zip(again[sid],
                                                          cs[sid]))
                         if a != b)
                raise AssertionError(
                    f"{label}: the card's rerun with {rerun} diverges from "
                    f"its first run for request {sid} at token {i}")
    stats = dict(ceng.manager.stats)
    log(f"card vs CPU ({label}; {cfg.name} width, {cfg.num_layers} "
        "layers, f32, "
        f"{len(prompts)} requests, {len(sampled)} sampled, {engine_kw}"
        + (f", injector {schedule}" if schedule else "") + "): "
        f"{same} of {len(cs)} token streams identical"
        + ("" if strict else ", the rest diverge only at near-ties")
        + (f", the card's rerun with {rerun} identical" if rerun else "")
        + f"; admission log, manager, cache and overload stats identical: "
        f"{json.dumps(stats)} prefix cache {json.dumps(cst['prefix_cache'])}"
        f" overload {json.dumps(cst['overload'])}"
        + (f" injector log {logs['cuda']}" if schedule else "")
        + f" ({ct:.1f} s on the card, {pt:.1f} s on the CPU)")
    return cst, cs, margins, csteps


def card_vs_cpu_runs(torch, dev):
    """Phase 3: the run of earlier slices, a pressure run whose RestSeg
    (one set of 8 ways in a 40-slot pool) overflows, so the card walks the
    flex table, promotes hot flexible blocks and syncs the TAR/SF/flex
    deltas inside a serving run, and a run of the default admission path:
    prefix-KV chunks read the pool through the Q > 1 paged kernel, a
    request attaches a cached 3-block prefix, half the requests sample."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model_dims
    from repro_torch.params import init_params
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=2)
    params = (cfg, init_params(torch.Generator().manual_seed(SEED), cfg,
                               model_dims(cfg), torch.float32, "cpu"))
    rng = np.random.RandomState(SEED)

    def prompts(lens):
        return [rng.randint(0, cfg.vocab_size, n) for n in lens]

    card_vs_cpu(torch, dev, params, prompts((64, 128, 192)), 6, "default",
                max_batch=4, max_seq_len=256, **EARLIER_PATH)
    st, *_ = card_vs_cpu(torch, dev, params,
                         prompts((64, 128, 192, 320, 64, 256)), 8,
                         "pressure", max_batch=4, max_seq_len=512,
                         restseg_fraction=0.25, **EARLIER_PATH)
    if st.get("flex_walks", 0) <= 0 or st.get(
            "migrations_flex_to_rest", 0) <= 0:
        raise AssertionError(f"pressure run: no flex walk or no promotion on "
                             f"the card ({st})")
    # requests 0 and 1 share a 3-block prefix; request 0 (320 tokens) and
    # request 3 (448) chunk under the 256-token budget
    ps = prompts((320, 256, 128, 448, 64, 192))
    ps[1][:192] = ps[0][:192]
    from repro_torch.kernels.paged_attention.ops import paged_attention
    before = paged_attention.launches_multi_query
    st, *_ = card_vs_cpu(torch, dev, params, ps, 8,
                         "prefix-KV, cache, sampled",
                         sampled=(1, 3, 5), strict=True,
                         rerun=dict(prefix_cache=None), max_batch=4,
                         max_seq_len=512, prefill_budget=256,
                         prefill_mode="prefix_kv", prefix_gather="paged",
                         prefix_cache="auto")
    if st["prefix_cache"]["hits"] <= 0:
        raise AssertionError(f"prefix-KV run: no prefix-cache hit ({st})")
    if paged_attention.launches_multi_query <= before:
        raise AssertionError("prefix-KV run: paged attention never ran "
                             "with Q > 1 on the card")
    overload_card_vs_cpu(torch, dev, params, prompts(OVERLOAD["lens"]))
    # two prompts that repeat a pattern (prompt-lookup traffic) beside
    # random ones
    ps = prompts(SPEC3["lens"])
    for i, n in SPEC3["repeats"].items():
        ps[i] = np.tile(ps[i][:n], len(ps[i]) // n)
    spec_card_vs_cpu(torch, dev, params, ps)


# phase 3's fifth run: speculative decoding (K = 4, n-gram 2), card vs CPU
SPEC3 = dict(lens=(64, 256, 128, 192, 256, 128), repeats={1: 32, 4: 64},
             sampled=(1, 3, 5), new_tokens=16,
             engine=dict(max_batch=4, max_seq_len=512, spec_decode="ngram",
                         num_draft_tokens=4, spec_ngram=2))


def spec_card_vs_cpu(torch, dev, params, prompts):
    """Phase 3's fifth run (``SPEC3``): admission logs, manager and cache
    stats, spec counters identical card vs CPU, streams identical except
    at near-ties; on the card, spec-off serves the same requests with the
    same streams under the near-tie rule."""
    from repro_torch.serve import Engine, EngineConfig
    o = SPEC3
    label = "spec decode K=4"
    st, cs, margins, csteps = card_vs_cpu(
        torch, dev, params, prompts, o["new_tokens"], label,
        sampled=o["sampled"], **o["engine"])
    if st["spec_drafted"] <= 0:
        raise AssertionError(f"{label}: no draft proposed")
    cfg, cpu_params = params
    eng = Engine(cfg, to_device(cpu_params, dev), EngineConfig(
        auto_release=True, **dict(o["engine"], spec_decode=None)),
        device=dev)
    off, steps_off = serve(eng, smoke_requests(prompts, o["new_tokens"],
                                               o["sampled"]))
    same = 0
    for sid in sorted(cs):
        diff = near_tie(margins, csteps, cs[sid], off[sid], sid)
        if diff is None:
            same += 1
            continue
        i, step, m = diff
        log(f"{label}: spec-on vs spec-off on the card, request {sid} "
            f"diverges at token {i} (spec-on step {step}), top-2 margin {m}")
        if m is None or m >= 1e-3:
            raise AssertionError(f"{label}: spec-on and spec-off diverge at "
                                 f"step {step} (top-2 margin {m})")
    log(f"{label}: on the card, {same} of {len(cs)} spec-on streams equal "
        f"spec-off's (the rest differ only at near-ties), in {len(csteps)} "
        f"steps against {len(steps_off)}; drafted {st['spec_drafted']}, "
        f"accepted {st['spec_accepted']}")


# phase 3's fourth run: 12 requests on a 16-slot pool (room for about 4
# sequences), budget 256, prefix-KV chunks through the paged read, half the
# requests sampled, and a fault schedule: the reference engine's
# double-admission schedule at step 1 (a chunk denied, then its queued
# sequence preempted), a "pre" preemption of a sequence between its
# chunks, a "post" preemption, and denials at admit, decode and resume.
# The crashes come after every scheduled event and after a snapshot, so
# the replayed steps meet the same schedule as the uncrashed run.
OVERLOAD = dict(
    lens=(320, 64, 192, 320, 128, 256, 64, 320, 192, 128, 256, 64),
    new_tokens=16, sampled=(1, 3, 5, 7, 9, 11),
    engine=dict(max_batch=4, max_seq_len=512, pool_headroom=0.5,
                prefill_budget=256, prefix_gather="paged"),
    schedule=dict(preempt_at=[(1, "post", "auto"), (3, "pre", 0),
                              (6, "post", "auto")],
                  alloc_fail_at=[(1, "admit"), (4, "decode"),
                                 (36, "resume")]),
    snapshot_every=4, crash_at=[(41, "pre"), (46, "post")])


def admitted_once(eng, label):
    """Each prompt token is admitted by exactly one chunk."""
    seen = {}
    for r in eng.admission_log:
        seen.setdefault(r.seq_id, []).extend(range(r.start, r.end))
    for sid, toks in seen.items():
        if len(toks) != len(set(toks)):
            raise AssertionError(f"{label}: request {sid} had a prompt "
                                 "range admitted twice")


def supervised(sup, requests, each_step=None):
    """Submit through a ``ResilientServe`` and poll it to completion;
    returns the delivered streams."""
    for r in requests:
        sup.submit(r)
    outs = {r.seq_id: [] for r in requests}
    while sup.has_unfinished():
        for ro in sup.poll():
            outs[ro.seq_id].extend(ro.new_token_ids)
        if each_step is not None:
            each_step(sup.engine)
    return outs


def overload_card_vs_cpu(torch, dev, params, prompts):
    """Phase 3's fourth run (``OVERLOAD``): preemption to the host tier
    under a fault schedule, card against CPU (admission logs, overload,
    manager and cache stats, injector logs identical; streams identical
    except at near-ties); on the card, the same requests on a roomy pool
    (no preemption) give the same streams under the near-tie rule, and a
    ``ResilientServe`` run with a "pre" and a "post" crash delivers
    streams bitwise equal to the uncrashed card run's."""
    from repro_torch.runtime import ResilientServe, ServeFaultInjector
    from repro_torch.serve import Engine, EngineConfig
    cfg, cpu_params = params
    o = OVERLOAD
    label = "overload, host tier, faults"
    st, cs, margins, csteps = card_vs_cpu(
        torch, dev, params, prompts, o["new_tokens"], label,
        sampled=o["sampled"], schedule=o["schedule"], **o["engine"])
    ov = st["overload"]
    n_events = len(o["schedule"]["preempt_at"]) + len(
        o["schedule"]["alloc_fail_at"])
    if ov["preempted_seqs"] <= 0 or ov["resumed_seqs"] != ov[
            "preempted_seqs"] or ov["host_tier_seqs"]:
        raise AssertionError(f"{label}: overload stats {ov}")
    cuda_params = to_device(cpu_params, dev)

    def requests():
        return smoke_requests(prompts, o["new_tokens"], o["sampled"])

    def engine(**kw):
        return Engine(cfg, cuda_params, EngineConfig(
            auto_release=True, **dict(o["engine"], **kw)), device=dev)

    roomy, _ = serve(engine(pool_headroom=2.0), requests())
    same = 0
    for sid in sorted(cs):
        diff = near_tie(margins, csteps, cs[sid], roomy[sid], sid)
        if diff is None:
            same += 1
            continue
        i, step, m = diff
        log(f"{label}: tight vs roomy pool on the card, request {sid} "
            f"diverges at token {i} (tight run's step {step}), top-2 "
            f"margin {m}")
        if m is None or m >= 1e-3:
            raise AssertionError(f"{label}: tight and roomy pools diverge "
                                 f"at step {step} (top-2 margin {m})")
    inj = ServeFaultInjector(crash_at=o["crash_at"], **o["schedule"])
    eng = engine(fault_injector=inj)
    sup = ResilientServe(eng, snapshot_every=o["snapshot_every"])
    crashed = supervised(sup, requests())
    eng.check_invariants()
    admitted_once(eng, label)
    if sup.restarts != len(o["crash_at"]) or crashed != {
            sid: cs[sid] for sid in crashed}:
        raise AssertionError(f"{label}: the crashed run's delivered "
                             f"streams differ from the uncrashed run's "
                             f"({sup.restarts} restarts)")
    if sum(1 for ev in inj.log if ev[0] != "crash") != n_events:
        raise AssertionError(f"{label}: not every scheduled fault fired "
                             f"({inj.log})")
    log(f"{label}: on the card, {same} of {len(cs)} streams of the tight "
        f"pool equal the roomy pool's (the rest differ only at near-ties); "
        f"the ResilientServe run with crashes at {o['crash_at']} "
        f"(snapshot every {o['snapshot_every']} steps, "
        f"{sup.replayed_steps} steps replayed) delivered every stream "
        f"bitwise equal to the uncrashed run's")


def _kernel_counts(reset=False):
    """The kernel wrappers' launch counts (set to 0 first with
    ``reset``)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.utopia_rsw.ops import (utopia_rsw,
                                                    utopia_translate_shard,
                                                    utopia_translate_step)
    fns = {"utopia_translate_step": (utopia_translate_step, "launches"),
           "utopia_rsw": (utopia_rsw, "launches"),
           "paged_attention": (paged_attention, "launches"),
           "paged_attention_q_gt1": (paged_attention,
                                     "launches_multi_query"),
           "paged_attention_q_per_query": (paged_attention,
                                           "launches_q_per_query"),
           "utopia_translate_shard": (utopia_translate_shard, "launches"),
           "utopia_combine_shard": (utopia_translate_shard,
                                    "launches_combine"),
           "utopia_translate_step_group": (utopia_translate_step,
                                           "launches_group"),
           "flash_attention": (flash_attention, "launches")}
    if reset:
        for fn, attr in fns.values():
            setattr(fn, attr, 0)
    return {name: getattr(fn, attr) for name, (fn, attr) in fns.items()}


def stream_digest(streams) -> str:
    """16 hex digits of the sha256 of a run's streams (request id and
    tokens, in id order): two runs, or two commits' runs, served the same
    tokens when their digests agree."""
    import hashlib
    return hashlib.sha256(json.dumps(sorted(
        (int(k), [int(t) for t in v]) for k, v in streams.items())).encode()
    ).hexdigest()[:16]


def check_streams(reqs, streams, vocab):
    for r in reqs:
        toks = streams[r.seq_id]
        if len(toks) != r.max_new_tokens or not all(0 <= t < vocab
                                                    for t in toks):
            raise AssertionError(f"request {r.seq_id} produced {toks}")


def phase4_requests(cfg, rng):
    """Phase 4's 8 greedy requests of 64-704 tokens, 32 new tokens each."""
    from repro_torch.serve import Request
    bs = cfg.kv_block_size
    lens = [bs * n for n in (1, 11, 2, 7, 3, 9, 5, 4)]   # 64 .. 704 tokens
    return lens, [Request(seq_id=i, prompt=rng.randint(0, cfg.vocab_size, n),
                          max_new_tokens=32) for i, n in enumerate(lens)]


def full_width(torch, dev, cfg, dims, params):
    """Phase 4 (a).  Returns (launches, streams, the admission step's
    device ms)."""
    import numpy as np
    from repro_torch.serve import Engine, EngineConfig
    eng = Engine(cfg, params, EngineConfig(
        max_batch=4, max_seq_len=1024, auto_release=True,
        dtype=torch.bfloat16, **EARLIER_PATH), device=dev)
    rng = np.random.RandomState(SEED)
    lens, reqs = phase4_requests(cfg, rng)
    first = {}

    serve_step = eng._serve_step

    def checked(params, dstate, tokens, active=None, **kw):
        logits, dstate, stats = serve_step(params, dstate, tokens, active,
                                           **kw)
        if not first:
            first["finite"] = bool(torch.isfinite(logits).all())
            first["shape"] = tuple(logits.shape)
        return logits, dstate, stats

    eng._serve_step = checked
    _kernel_counts(reset=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams, steps = serve(eng, reqs)
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    for name in ("utopia_translate_step", "paged_attention",
                 "flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 "path")
    eng.check_invariants()
    if not first.get("finite") or first["shape"] != (4, dims.vocab):
        raise AssertionError(f"decode logits not finite / wrong shape "
                             f"{first}")
    check_streams(reqs, streams, cfg.vocab_size)
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
        streams_sha256=stream_digest(streams), launches=launches)
    log("granite-8b full width, 36 layers, bf16, Engine(max_batch=4, "
        "max_seq_len=1024, attn_impl='flash', prefill_mode='recompute', "
        "prefix_cache=None): " + json.dumps({"serving": summary}))
    return launches, streams, profile_decode_step(torch, eng, rng, cfg)


# phase 5: the engine's default admission path at full width
PHASE5 = dict(max_batch=4, max_seq_len=1024, attn_impl="dense",
              prefill_mode="prefix_kv", prefix_gather="paged",
              prefix_cache="auto", prefill_budget=256, auto_release=True)


def phase5_requests(cfg, rng):
    """Phase 5's 8 requests of 64-704 tokens, 32 new tokens each: requests
    1, 3, 5 and 7 open with one 384-token system prompt, requests 0, 3, 4
    and 7 sample (fixed seeds).  Returns (requests, prompt lengths, the
    sharing requests, the sampled ones)."""
    from repro_torch.serve import Request, SamplingParams
    bs = cfg.kv_block_size
    system = rng.randint(0, cfg.vocab_size, 384)
    lens = [bs * n for n in (1, 11, 2, 7, 3, 9, 5, 8)]   # 64 .. 704 tokens
    shared, sampled = (1, 3, 5, 7), (0, 3, 4, 7)
    reqs = []
    for i, n in enumerate(lens):
        p = rng.randint(0, cfg.vocab_size, n)
        if i in shared:
            p[:384] = system
        reqs.append(Request(
            seq_id=i, prompt=p, max_new_tokens=32,
            sampling=(SamplingParams(seed=SEED + 100 + i, **SAMPLED)
                      if i in sampled else SamplingParams())))
    return reqs, lens, shared, sampled


def full_width_prefix(torch, dev, cfg, dims, params):
    """Phase 5: 8 requests of 64-704 tokens, 32 new tokens each; requests
    1, 3, 5 and 7 open with one 384-token system prompt; requests 0, 3, 4
    and 7 sample (fixed seeds).  Reads the launch counts of this run
    alone; then profiles one prefix-KV admission step.  Returns (launches,
    the streams' digest)."""
    import numpy as np
    from repro_torch.serve import Engine, EngineConfig
    eng = Engine(cfg, params, EngineConfig(dtype=torch.bfloat16, **PHASE5),
                 device=dev)
    rng = np.random.RandomState(SEED + 5)
    reqs, lens, shared, sampled = phase5_requests(cfg, rng)
    _kernel_counts(reset=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams, steps = serve(eng, reqs)
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    for name in ("utopia_translate_step", "paged_attention",
                 "paged_attention_q_gt1"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 5: {name} was never launched on the "
                                 "default admission path")
    eng.check_invariants()
    check_streams(reqs, streams, cfg.vocab_size)
    st = eng.stats()
    pc = st["prefix_cache"]
    if pc["hits"] <= 0:
        raise AssertionError(f"phase 5: no prefix-cache hit ({pc})")
    admit = {"recompute": [], "prefix_kv": [], "mixed": []}
    for w, recs, _, _, _ in steps:
        paths = {r.path for r in recs}
        if paths:
            admit[paths.pop() if len(paths) == 1 else "mixed"].append(w)
    decode_only = [w for w, recs, live, _, _ in steps if not recs and live]
    n_tok = sum(len(t) for t in streams.values())
    summary = dict(
        requests=len(reqs), prompt_tokens=lens, new_tokens_each=32,
        shared_system_prompt=dict(tokens=384, requests=list(shared)),
        sampled_requests=list(sampled), steps=len(steps),
        admission_steps={k: dict(n=len(v), ms_total=round(sum(v) * 1e3, 3))
                         for k, v in admit.items()},
        chunks=[[r.seq_id, r.start, r.end, r.path]
                for r in eng.admission_log],
        decode_step_ms_median=round(statistics.median(decode_only) * 1e3, 3),
        tokens_per_s=round(n_tok / wall, 2), wall_s=round(wall, 3),
        gpu_mem_peak_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30,
                               3),
        prefix_cache=pc, streams_sha256=stream_digest(streams),
        launches=launches)
    log("phase 5: granite-8b full width, 36 layers, bf16, Engine("
        + ", ".join(f"{k}={v!r}" for k, v in PHASE5.items()) + "): "
        + json.dumps({"serving": summary}))
    profile_prefix_step(torch, eng, rng, cfg)
    return launches, summary["streams_sha256"]


def random_frontend(cfg, rng):
    """A request's random stub frontend ``(frontend_tokens, d_model)``
    float32 for a frontend family, else None."""
    if cfg.frontend == "none":
        return None
    return rng.randn(cfg.frontend_tokens, cfg.d_model).astype("float32")


def profile_prefix_step(torch, eng, rng, cfg, prompt_len=512):
    """A ``prompt_len``-token prompt admits as chunk 0 (recompute, 256
    tokens) and then one prefix-KV chunk of the rest over a 256-token
    prefix; that second admission step runs under the profiler (device
    ms by kernel, and the share of the Q > 1 paged read)."""
    from repro_torch.serve import Request
    eng.submit(Request(seq_id=200, prompt=rng.randint(0, cfg.vocab_size,
                                                      prompt_len),
                       max_new_tokens=4, frontend=random_frontend(cfg, rng)))
    eng.step()                                   # chunk 0
    n_log = len(eng.admission_log)
    rows = profile_cold(torch, eng.step, tries=1)  # an admission runs once
    recs = eng.admission_log[n_log:]
    if [r.path for r in recs] != ["prefix_kv"]:
        raise AssertionError(f"the profiled step admitted {recs}, not one "
                             "prefix-KV chunk")
    while eng.has_unfinished():
        eng.step()
    busy = sum(ms for _, ms, _ in rows)
    paged = sum(ms for name, ms, _ in rows if "paged_attn_kernel" in name)
    n_paged = sum(n for name, _, n in rows if "paged_attn_kernel" in name)
    top = [dict(kernel=name[:90], ms=round(ms, 4), launches=n)
           for name, ms, n in rows[:8]]
    log(f"prefix-KV admission step under the profiler (one chunk of "
        f"{prompt_len - 256} tokens over the first 256 prompt tokens): "
        + json.dumps({"profile": dict(
            device_busy_ms=round(busy, 3), paged_q_gt1_ms=round(paged, 4),
            paged_q_gt1_launches=n_paged,
            paged_q_gt1_share=round(paged / busy, 4) if busy else None,
            kernels=len(rows), top=top)}))


# phase 6: overload and recovery at full width and depth, on the engine's
# defaults (overload_policy="preempt") with phase 5's paged prefix read.
# Run (a) has the default 80-slot pool; (b) a 24-slot pool (room for
# about two of these requests) and a fault schedule; (c) is (b) under a
# ResilientServe with two crashes placed after every scheduled event and
# after a snapshot, so that its replayed steps meet (b)'s schedule.
PHASE6 = dict(max_batch=4, max_seq_len=1024, prefill_budget=256,
              auto_release=True, prefix_gather="paged")
PHASE6_RUN = dict(
    lens=tuple(64 * n for n in (5, 11, 7, 9, 6, 10, 8, 11, 5, 7, 9, 6)),
    sampled=(1, 3, 5, 7, 9, 11), roomy=1.25, tight=0.375,
    schedule=dict(preempt_at=[(2, "pre", 0), (5, "post", "auto")],
                  alloc_fail_at=[(3, "admit"), (8, "decode"),
                                 (107, "resume")]),
    snapshot_every=8, crash_at=[(121, "pre"), (138, "post")])


def decode_row_dependence(torch, eng, cfg):
    """Does a row's result depend on the batch around it, on the verify
    step's own activations?  One step of the spec-on engine ``eng`` (a
    (B, K + 1) window) runs with the input of every op of every layer
    recorded: the RMS norms, the q and o projections (k and v take q's
    input), RoPE on q and k, the attention's normalization, the MLP's
    gate, up and down, the final norm and the head.  Each op then runs
    again on each recorded input, at the verify's (B, K + 1, ...) shape and
    on every window position's contiguous (B, ...) slice (the decode
    step's shape), and the two are compared bitwise; for the norms also
    their float32 mean square, one value a row, whose rounding a bf16
    output mostly hides.  At the decode shape each op's rows are also
    compared with a permutation's (a row in another batch slot) and row 0
    beside other neighbours.  The norms run as ``Lmod.rms_norm`` does,
    over the whole window, whatever the verify step does with them.
    Reported, not held; ``verify_per_position`` names the ops that the
    verify step runs at the decode shape (``serve/decode.py``)."""
    import repro_torch.serve.decode as dmod
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import layer_params
    params = eng.params
    names = {params["final_norm"].data_ptr(): ("final_norm", None)}
    for li in range(cfg.num_layers):
        blk = layer_params(params, li)
        names[blk["norm1"].data_ptr()] = ("norm1", li)
        names[blk["norm2"].data_ptr()] = ("norm2", li)
        for grp, keys in (("attn", "qkvo"), ("mlp", ("gate", "up", "down"))):
            for k in keys:
                names[blk[grp][k]["w"].data_ptr()] = (k, li)
        if "cross" in blk:                     # the audio decoder's
            names[blk["norm_x"].data_ptr()] = ("norm_x", li)
            for k in "qo":
                names[blk["cross"][k]["w"].data_ptr()] = (f"cross_{k}", li)
    rec = []
    orig = (dmod._rms_norm, L.linear, L.apply_rope, L.unembed,
            dmod.normalize)

    def rms(x, scale, eps):
        if x.dim() == 3:
            rec.append((names[scale.data_ptr()], x,
                        lambda t, s=scale: L.rms_norm(t, s, eps)))
        return orig[0](x, scale, eps)

    def lin(p, x):
        key = names.get(p["w"].data_ptr())
        if x.dim() == 3 and key is not None:
            rec.append((key, x, lambda t, p=p: orig[1](p, t)))
            if key[0] == "q":
                blk = layer_params(params, key[1])["attn"]
                rec.extend(((k, key[1]), x, lambda t, p=blk[k]: orig[1](p, t))
                           for k in "kv")
        return orig[1](p, x)

    def rope(x, pos, theta):
        name = "rope_k" if x.shape[-2] == cfg.num_kv_heads else "rope_q"
        rec.append(((name, None), (x, pos),
                    lambda t, u: orig[2](t, u, theta)))
        return orig[2](x, pos, theta)

    def unembed(p, x, vocab):
        rec.append((("head", None), x, lambda t: orig[3](p, t, vocab)))
        return orig[3](p, x, vocab)

    def normalize(o, l):
        rec.append((("attn_normalize", None), (o, l), orig[4]))
        return orig[4](o, l)

    dmod._rms_norm, L.linear, L.apply_rope, L.unembed, dmod.normalize = (
        rms, lin, rope, unembed, normalize)
    try:
        eng.step()
    finally:
        (dmod._rms_norm, L.linear, L.apply_rope, L.unembed,
         dmod.normalize) = orig
    out, first_norm = {}, None
    for (name, li), x, f in rec:
        xs = x if isinstance(x, tuple) else (x,)
        if "rope" in name and xs[0].shape[1] == 1:
            continue                     # a decode step's, not the window's
        Q = xs[0].shape[1]
        r = out.setdefault(name, dict(rows=0, rows_differ=0,
                                      max_abs_diff=0.0, layers_differ=[],
                                      slot_moved_equal=True,
                                      neighbours_changed_equal=True))
        y = f(*xs)
        at = [tuple(t[:, c:c + 1].contiguous() if "rope" in name
                    else t[:, c].contiguous() for t in xs)
              for c in range(Q)]
        differ = 0
        for c, xc in enumerate(at):
            yc = f(*xc)
            yc = yc[:, 0] if "rope" in name else yc
            row = (yc != y[:, c]).flatten(1).any(1)
            differ += int(row.sum())
            r["max_abs_diff"] = max(r["max_abs_diff"], float(
                (yc.float() - y[:, c].float()).abs().max()))
        r["rows"] += y.shape[0] * Q
        r["rows_differ"] += differ
        if differ and li is not None and li not in r["layers_differ"]:
            r["layers_differ"].append(li)
        # the decode shape's own batch: a permutation, other neighbours
        x0, x1 = at[0], at[1]
        y0 = f(*x0)
        perm = torch.arange(y0.shape[0] - 1, -1, -1, device=y0.device)
        r["slot_moved_equal"] &= bool(torch.equal(
            f(*(t[perm].contiguous() for t in x0)), y0[perm]))
        mixed = tuple(torch.cat([t0[:1], t1[1:]]) for t0, t1 in zip(x0, x1))
        r["neighbours_changed_equal"] &= bool(torch.equal(f(*mixed)[0],
                                                          y0[0]))
        if name in ("norm1", "norm2", "final_norm"):
            ms = xs[0].float().square().mean(dim=-1)
            msd = sum(int((a[0].float().square().mean(dim=-1)
                           != ms[:, c]).sum()) for c, a in enumerate(at))
            r["mean_square_rows_differ"] = (
                r.get("mean_square_rows_differ", 0) + msd)
            if first_norm is None:
                first_norm = dict(
                    window=dict(shape=list(x.shape), stride=list(x.stride()),
                                dtype=str(x.dtype)),
                    position=dict(shape=list(at[0][0].shape),
                                  stride=list(at[0][0].stride())))
    out["norm_input"] = first_norm
    out["verify_per_position"] = ["norm1", "norm2", "final_norm", "k", "v"]
    return out


def full_width_overload(torch, dev, cfg, dims, params):
    """Phase 6 (``PHASE6_RUN``): 12 requests of 320-704 tokens, 32 new
    tokens each, half sampled.  (a) must not preempt; (b) must preempt and
    resume everything, leave no block mapped and nothing on the host tier,
    hold ``check_invariants`` after every step and admit each prompt range
    once, and every resume must read back from the pool exactly the bytes
    its preemption gathered; (c) must deliver (b)'s streams bitwise.
    Reads the launch counts of the three runs together.  (d) and (e)
    rerun (a) and (b) with ``prefix_gather="exact"``; their tight-vs-
    roomy streams are reported, not held."""
    from repro_torch.runtime import ResilientServe, ServeFaultInjector
    o = PHASE6_RUN

    def requests():
        return phase6_requests(cfg)

    def engine(headroom, injector=None, **kw):
        return phase6_engine(torch, dev, cfg, params, headroom, injector,
                             **kw)

    def tokens_per_s(streams, steps):
        return sum(len(t) for t in streams.values()) / sum(
            w for w, *_ in steps)

    _kernel_counts(reset=True)
    # (a) the default pool
    eng_a = engine(o["roomy"])
    margins_a = {}
    record_margins(eng_a, margins_a)
    streams_a, steps_a = serve(eng_a, requests())
    check_streams(requests(), streams_a, cfg.vocab_size)
    if eng_a.stats()["overload"]["preempted_seqs"]:
        raise AssertionError("phase 6 (a): the default pool preempted")
    pool_a = eng_a.hybrid_cfg.total_slots
    log_a = list(eng_a.admission_log)
    del eng_a
    torch.cuda.empty_cache()

    # (b) the tight pool and the fault schedule
    inj_b = ServeFaultInjector(**o["schedule"])
    eng_b = engine(o["tight"], inj_b)
    margins_b = {}
    record_margins(eng_b, margins_b)
    swap = {"preempt_ms": [], "resume_ms": [], "round_trips": 0}
    saved = {}
    preempt, resume = eng_b.preempt_request, eng_b._resume_preempted

    def timed_preempt(sid):
        _, ms = sync_ms(torch, preempt, sid)
        swap["preempt_ms"].append(ms)
        rec = eng_b._preempted[sid]
        saved[sid] = (list(rec.blocks), rec.kv)

    def timed_resume(req, reserved, busy):
        ok, ms = sync_ms(torch, resume, req, reserved, busy)
        if ok:
            swap["resume_ms"].append(ms)
            blocks, kv = saved.pop(req.seq_id)
            if kv is not None:
                idx = torch.tensor([eng_b.manager.lookup(req.seq_id, b)[0]
                                    for b, _ in blocks], device=dev)
                back = torch.stack([eng_b.dstate["k_pool"][:, idx],
                                    eng_b.dstate["v_pool"][:, idx]]).cpu()
                if not torch.equal(back.view(torch.int16),
                                   kv.view(torch.int16)):
                    raise AssertionError(
                        f"phase 6 (b): request {req.seq_id}'s resumed "
                        "blocks differ from the bytes its preemption "
                        "gathered")
                swap["round_trips"] += 1
        return ok

    eng_b.preempt_request, eng_b._resume_preempted = (timed_preempt,
                                                      timed_resume)
    streams_b, steps_b = serve(eng_b, requests(),
                               each_step=lambda e: e.check_invariants())
    check_streams(requests(), streams_b, cfg.vocab_size)
    admitted_once(eng_b, "phase 6 (b)")
    ov = eng_b.stats()["overload"]
    n_events = sum(len(v) for v in o["schedule"].values())
    if (ov["preempted_seqs"] <= 0 or ov["resumed_seqs"] != ov[
            "preempted_seqs"] or ov["host_tier_seqs"]
            or ov["swap_bytes_in"] != ov["swap_bytes_out"]
            or eng_b.manager.blocks or len(inj_b.log) != n_events
            or swap["round_trips"] <= 0):
        raise AssertionError(f"phase 6 (b): overload {ov}, blocks left "
                             f"{len(eng_b.manager.blocks)}, injector log "
                             f"{inj_b.log}, {swap['round_trips']} round "
                             "trips checked")
    pool_b = eng_b.hybrid_cfg.total_slots
    log_b = list(eng_b.admission_log)
    del eng_b
    torch.cuda.empty_cache()

    # (c) = (b) under ResilientServe with two crashes
    inj_c = ServeFaultInjector(crash_at=o["crash_at"], **o["schedule"])
    eng_c = engine(o["tight"], inj_c)
    rec = {"snapshot_ms": [], "snapshot_bytes": [], "restore_ms": []}
    snapshot, restore = eng_c.snapshot, eng_c.restore

    def timed_snapshot():
        snap, ms = sync_ms(torch, snapshot)
        rec["snapshot_ms"].append(ms)
        rec["snapshot_bytes"].append(len(snap.host_blob) + sum(
            t.nbytes for t in snap.dstate.values()))
        return snap

    def timed_restore(snap):
        _, ms = sync_ms(torch, restore, snap)
        rec["restore_ms"].append(ms)

    eng_c.snapshot, eng_c.restore = timed_snapshot, timed_restore
    sup = ResilientServe(eng_c, snapshot_every=o["snapshot_every"])
    t0 = time.perf_counter()
    streams_c = supervised(sup, requests(),
                           each_step=lambda e: e.check_invariants())
    wall_c = time.perf_counter() - t0
    admitted_once(eng_c, "phase 6 (c)")
    if sup.restarts != len(o["crash_at"]) or streams_c != streams_b:
        raise AssertionError(f"phase 6 (c): {sup.restarts} restarts; the "
                             "delivered streams differ from (b)'s")
    launches = _kernel_counts()
    for name in ("utopia_translate_step", "paged_attention",
                 "paged_attention_q_gt1"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 6: {name} was never launched")
    replayed = sup.replayed_steps
    del eng_c, sup
    torch.cuda.empty_cache()

    # (d, e) = (a, b) on the engine's default prefix gather, "exact"
    # (ROADMAP Queue 3: is the paged read where a prompt's split shows?);
    # tight = roomy is reported, not held
    exact = {}
    for run, headroom, injector in (
            ("d", o["roomy"], None),
            ("e", o["tight"], ServeFaultInjector(**o["schedule"]))):
        eng = engine(headroom, injector, prefix_gather="exact")
        margins = {}
        record_margins(eng, margins)
        streams, steps = serve(eng, requests())
        check_streams(requests(), streams, cfg.vocab_size)
        exact[run] = (streams, steps, margins, list(eng.admission_log),
                      eng.stats()["overload"]["preempted_seqs"])
        del eng
        torch.cuda.empty_cache()

    # tight against roomy: reported here, held in phase 3 (float32).  For
    # each request, the first token whose logits already differ bitwise,
    # and for a diverging stream both runs' prompt chunks (start, end):
    # the budget is shared by the requests of a step, so another schedule
    # splits a prompt elsewhere
    def chunks(log, sid):
        return [(r.start, r.end) for r in log if r.seq_id == sid]

    def compare(ra, rb):
        (s_a, st_a, m_a, log_a_), (s_b, st_b, m_b, log_b_) = ra, rb
        diverged, logits_from = [], {}
        for sid in sorted(s_a):
            logits_from[sid] = first_logits_difference((m_a, st_a),
                                                       (m_b, st_b), sid)
            diff = near_tie(m_b, st_b, s_b[sid], s_a[sid], sid)
            if diff is not None:
                i, step, m = diff
                diverged.append(dict(
                    request=sid, token=i, step_b=step, top2_margin_b=m,
                    buckets_a=buckets_of(m_a, st_a, sid),
                    buckets_b=buckets_of(m_b, st_b, sid),
                    chunks_a=chunks(log_a_, sid),
                    chunks_b=chunks(log_b_, sid)))
        return diverged, logits_from

    diverged, logits_from = compare(
        (streams_a, steps_a, margins_a, log_a),
        (streams_b, steps_b, margins_b, log_b))
    diverged_exact, _ = compare(exact["d"][:4], exact["e"][:4])

    def med_max(xs):
        return ([round(statistics.median(xs), 3), round(max(xs), 3)]
                if xs else None)

    summary = dict(
        requests=len(o["lens"]), prompt_tokens=list(o["lens"]),
        new_tokens_each=32, sampled_requests=list(o["sampled"]),
        pool_slots={"a": pool_a, "b": pool_b},
        schedule=o["schedule"], injector_log_b=inj_b.log,
        overload_b=ov, swap_mb_per_preempt_mean=round(
            ov["swap_bytes_out"] / max(ov["request_preempts"], 1) / 1e6, 3),
        preempt_ms_median_max=med_max(swap["preempt_ms"]),
        resume_ms_median_max=med_max(swap["resume_ms"]),
        round_trips_byte_equal=swap["round_trips"],
        steps={"a": len(steps_a), "b": len(steps_b)},
        tokens_per_s={"a": round(tokens_per_s(streams_a, steps_a), 2),
                      "b": round(tokens_per_s(streams_b, steps_b), 2)},
        snapshots=len(rec["snapshot_ms"]),
        snapshot_ms_median_max=med_max(rec["snapshot_ms"]),
        snapshot_mb_median=round(statistics.median(
            rec["snapshot_bytes"]) / 1e6, 3),
        restore_ms=[round(x, 3) for x in rec["restore_ms"]],
        replayed_steps=replayed, crash_at=o["crash_at"],
        wall_s_c=round(wall_c, 3),
        streams_sha256={"a": stream_digest(streams_a),
                        "b": stream_digest(streams_b),
                        "c": stream_digest(streams_c),
                        "d": stream_digest(exact["d"][0]),
                        "e": stream_digest(exact["e"][0])},
        streams_b_equal_a=len(streams_a) - len(diverged),
        diverged_b_vs_a=diverged,
        first_token_with_other_logits_b_vs_a=logits_from,
        exact_gather=dict(
            preempted_seqs={"d": exact["d"][4], "e": exact["e"][4]},
            steps={"d": len(exact["d"][1]), "e": len(exact["e"][1])},
            streams_e_equal_d=len(streams_a) - len(diverged_exact),
            diverged_e_vs_d=diverged_exact),
        launches=launches)
    log("phase 6: granite-8b full width, 36 layers, bf16, Engine("
        + ", ".join(f"{k}={v!r}" for k, v in PHASE6.items())
        + f", pool_headroom {o['roomy']} (a, d) / {o['tight']} (b, c, e); "
        "d and e with prefix_gather='exact'): "
        + json.dumps({"overload": summary}))
    return launches, streams_b


def phase6_engine(torch, dev, cfg, params, headroom, injector=None, **kw):
    """Phase 6's engine (``PHASE6``) on a pool of ``headroom``."""
    from repro_torch.serve import Engine, EngineConfig
    return Engine(cfg, params, EngineConfig(
        dtype=torch.bfloat16, pool_headroom=headroom,
        fault_injector=injector, **dict(PHASE6, **kw)), device=dev)


def phase6_requests(cfg):
    """Phase 6's 12 requests (``PHASE6_RUN``)."""
    import numpy as np
    o = PHASE6_RUN
    rng = np.random.RandomState(SEED + 6)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in o["lens"]]
    return smoke_requests(prompts, 32, o["sampled"])


CHILD_TAG = "phase 6 (f) resumed process: "


def persisted_recovery(torch, dev, cfg, params, streams_b, src):
    """Phase 6 (f): run (c) again with its snapshots persisted
    (``ResilientServe(engine, CheckpointManager(tmp, keep_last=3),
    snapshot_every=8)``) and its two crashes; after the second crash the
    process stops, the newest committed shard is truncated, and a FRESH
    process on the card (this script with ``--resume-child``, drawing the
    same seeded weights) resumes with ``ResilientServe.from_checkpoint``,
    which must warn and fall back to the previous snapshot, hold
    ``check_invariants`` after every step and finish the requests.  What
    the two processes delivered must be (b)'s streams bitwise.  Prints
    each save's ms and MB, the restore's ms and the child's total time.
    Returns the path's launch counts (both processes')."""
    import os
    import shutil
    import tempfile
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.runtime import ResilientServe, ServeFaultInjector
    o = PHASE6_RUN
    requests = phase6_requests(cfg)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase6f_")
    try:
        ck = CheckpointManager(tmp, keep_last=3)
        saves = []
        write = ck._write_step

        def timed_write(step, named, extra):
            t0 = time.perf_counter()
            write(step, named, extra)
            saves.append([step, round((time.perf_counter() - t0) * 1e3, 1),
                          round(sum(a.nbytes for a in named.values())
                                / 1e6, 1)])

        ck._write_step = timed_write
        eng = phase6_engine(torch, dev, cfg, params, o["tight"],
                            ServeFaultInjector(crash_at=o["crash_at"],
                                               **o["schedule"]))
        _kernel_counts(reset=True)
        t0 = time.perf_counter()
        sup = ResilientServe(eng, ck, snapshot_every=o["snapshot_every"])
        delivered = {r.seq_id: [] for r in requests}
        for r in requests:
            sup.submit(r)
        while sup.restarts < len(o["crash_at"]):
            if not sup.has_unfinished():
                raise AssertionError("phase 6 (f): the run finished before "
                                     "its second crash")
            for ro in sup.poll():
                delivered[ro.seq_id].extend(ro.new_token_ids)
            eng.check_invariants()
        ck.wait()
        parent_s = time.perf_counter() - t0
        stopped_at = eng._step_count
        counts = _kernel_counts()
        committed = ck.all_steps()
        if len(committed) < 2 or not sup.has_unfinished():
            raise AssertionError(f"phase 6 (f): committed steps {committed}"
                                 ", or nothing left to resume")
        shard = Path(tmp) / f"step_{committed[-1]}" / "shard_0.npz"
        with open(shard, "r+b") as f:
            f.truncate(shard.stat().st_size // 2)
        del sup, eng
        gc.collect()
        torch.cuda.empty_cache()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--resume-child",
             tmp, "--src", str(src)], capture_output=True, text=True,
            timeout=900, env=env)
        child_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lines = [x for x in proc.stdout.splitlines() if x.startswith(CHILD_TAG)]
    if proc.returncode != 0 or not lines:
        raise AssertionError(
            f"phase 6 (f): the resumed process failed (exit "
            f"{proc.returncode}):\n{proc.stdout[-4000:]}\n"
            f"{proc.stderr[-4000:]}")
    child = json.loads(lines[-1][len(CHILD_TAG):])
    if child["restored_step"] != committed[-2]:
        raise AssertionError(f"phase 6 (f): the resumed process restored "
                             f"step {child['restored_step']}, not the "
                             f"previous committed {committed[-2]}")
    resumed = {int(k): v for k, v in child.pop("delivered").items()}
    for sid, want in streams_b.items():
        got, more = delivered[sid], resumed.get(sid, [])
        # the new process delivers a live stream again from its start
        if more[:len(got)] != got[:len(more)]:
            raise AssertionError(f"phase 6 (f): request {sid}: the resumed "
                                 "process re-delivered other tokens")
        if (more if len(more) > len(got) else got) != want:
            raise AssertionError(f"phase 6 (f): request {sid}'s delivered "
                                 "stream differs from (b)'s")
    for k, n in child.pop("launches").items():
        counts[k] += n
    for name in ("utopia_translate_step", "paged_attention"):
        if counts[name] <= 0:
            raise AssertionError(f"phase 6 (f): {name} was never launched")
    log("phase 6 (f): run (c) with its snapshots persisted (keep_last=3), "
        "the newest shard truncated after the second crash, resumed in a "
        "fresh process; the delivered streams equal (b)'s bitwise: "
        + json.dumps({"persisted": dict(
            crash_at=o["crash_at"], stopped_at_step=stopped_at,
            committed_steps=committed, truncated_step=committed[-1],
            saves_step_ms_mb=saves, parent_s=round(parent_s, 2),
            child_s=round(child_s, 2), child=child,
            requests_resumed=len(resumed),
            streams_sha256=stream_digest(streams_b), launches=counts)}))
    return counts


def resume_child(torch, dev, directory):
    """Phase 6 (f)'s fresh process (``--resume-child DIR``): draw phase 6's
    seeded weights, build its tight-pool engine, resume it from the
    checkpoints in ``DIR`` with ``ResilientServe.from_checkpoint`` (which
    must warn that the newest is corrupt), hold ``check_invariants``
    after every step, serve to the end, and print what it delivered."""
    import warnings
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.runtime import ResilientServe
    t0 = time.perf_counter()
    cfg, _, params = served_model(torch, dev, "granite-8b", torch.bfloat16,
                                  seed=SEED)
    eng = phase6_engine(torch, dev, cfg, params, PHASE6_RUN["tight"])
    ck = CheckpointManager(directory, keep_last=3)
    timing = {}
    read, restore = ck.restore_named, eng.restore

    def timed_read(step=None):
        t = time.perf_counter()
        out = read(step)
        timing["read_ms"] = round((time.perf_counter() - t) * 1e3, 1)
        return out

    def timed_restore(snap):
        _, ms = sync_ms(torch, restore, snap)
        timing["restore_ms"] = round(ms, 1)

    ck.restore_named, eng.restore = timed_read, timed_restore
    _kernel_counts(reset=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sup = ResilientServe.from_checkpoint(
            eng, ck, snapshot_every=PHASE6_RUN["snapshot_every"])
    warned = [str(w.message) for w in caught
              if "corrupt or truncated" in str(w.message)]
    if not warned:
        raise AssertionError("phase 6 (f): from_checkpoint did not warn "
                             "about the truncated shard")
    restored = eng._step_count
    eng.check_invariants()
    delivered = {}
    while sup.has_unfinished():
        for ro in sup.poll():
            delivered.setdefault(ro.seq_id, []).extend(ro.new_token_ids)
        eng.check_invariants()
    ck.wait()
    print(CHILD_TAG + json.dumps(dict(
        restored_step=restored, steps=eng._step_count - restored,
        warning=warned[0][:160], **timing, delivered=delivered,
        launches=_kernel_counts(),
        total_s=round(time.perf_counter() - t0, 2))), flush=True)


def full_width_flash_jax(torch, dev, cfg, params, phase4):
    """Phase 4 (b): phase 4's requests at full width and depth in bf16
    with ``attn_impl="flash_jax"`` (the chunked eager attention) and
    recompute prefill: every stream must hold 32 in-vocab tokens, no
    flash kernel may launch, the translation and the paged decode read
    must.  Prints where a stream differs from phase 4's flash-kernel run
    (with this run's top-2 margin there) and the admission step's device
    ms beside phase 4's.  Then a 2-layer float32 copy, card against CPU:
    admission logs identical, streams under the near-tie rule.  Returns
    the path's launch counts."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model_dims
    from repro_torch.params import init_params
    from repro_torch.serve import Engine, EngineConfig
    streams4, admission4_ms = phase4
    path = dict(EARLIER_PATH, attn_impl="flash_jax")
    eng = Engine(cfg, params, EngineConfig(
        max_batch=4, max_seq_len=1024, auto_release=True,
        dtype=torch.bfloat16, **path), device=dev)
    rng = np.random.RandomState(SEED)
    _, reqs = phase4_requests(cfg, rng)
    margins = {}
    record_margins(eng, margins)
    _kernel_counts(reset=True)
    t0 = time.perf_counter()
    streams, steps = serve(eng, reqs)
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    if launches["flash_attention"] or launches["utopia_rsw"]:
        raise AssertionError(f"phase 4 (b): a kernel launched that the "
                             f"flash_jax path does not run ({launches})")
    for name in ("utopia_translate_step", "paged_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 4 (b): {name} was never launched")
    check_streams(reqs, streams, cfg.vocab_size)
    eng.check_invariants()
    differ = []
    for sid in sorted(streams):
        d = near_tie(margins, steps, streams[sid], streams4[sid], sid)
        if d is not None:
            differ.append(dict(request=sid, token=d[0], step=d[1],
                               top2_margin=d[2]))
    log("phase 4 (b): the same engine with attn_impl='flash_jax', its "
        "admission and decode steps under the profiler:")
    admission_ms = profile_decode_step(torch, eng, rng, cfg)
    log("phase 4 (b): granite-8b full width, 36 layers, bf16, Engine("
        "max_batch=4, max_seq_len=1024, " + ", ".join(
            f"{k}={v!r}" for k, v in path.items()) + "): " + json.dumps(
        {"flash_jax": dict(
            steps=len(steps), wall_s=round(wall, 3),
            tokens_per_s=round(sum(len(t) for t in streams.values())
                               / wall, 2),
            streams_equal_phase4=len(streams) - len(differ),
            differ_from_phase4=differ,
            admission_device_ms=admission_ms,
            admission_device_ms_phase4=admission4_ms,
            streams_sha256=stream_digest(streams), launches=launches)}))
    small = dataclasses.replace(get_config("granite-8b"), num_layers=2)
    small_params = (small, init_params(torch.Generator().manual_seed(SEED),
                                       small, model_dims(small),
                                       torch.float32, "cpu"))
    prng = np.random.RandomState(SEED)
    card_vs_cpu(torch, dev, small_params,
                [prng.randint(0, small.vocab_size, n) for n in (64, 128,
                                                                192)],
                6, "flash_jax", max_batch=4, max_seq_len=256, **path)
    return launches


# phase 7: speculative decoding at full width and depth, on the engine's
# defaults plus spec_decode="ngram" (K = 4): phase 5's 8 requests and two
# whose prompts repeat a passage (the "rewrite this document" and code-edit
# traffic whose output copies its prompt, which prompt lookup serves)
PHASE7 = dict(max_batch=4, max_seq_len=1024, auto_release=True)
PHASE7_K = 4


def phase7_requests(cfg):
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.RandomState(SEED + 5)
    reqs, *_ = phase5_requests(cfg, rng)
    doc = rng.randint(0, cfg.vocab_size, 128)
    snippet = rng.randint(0, cfg.vocab_size, 48)
    reqs += [Request(seq_id=8, prompt=np.tile(doc, 3), max_new_tokens=32),
             Request(seq_id=9, prompt=np.tile(snippet, 4),
                     max_new_tokens=32)]
    return reqs


def steady_step(torch, eng, cfg, probe=None, top=0, copies_of=None,
                prompt_len=512):
    """Four requests of ``prompt_len`` random tokens (and random frontends
    for a frontend family) admitted, then steady steps at
    B=4: the median wall ms of three, and one step's device ms under the
    profiler (busy ms, kernels, the paged read's ms, the idle share, and
    with ``top`` the largest kernels); with ``copies_of`` (the model's
    parameters) one more step's copy ops that read a tensor of a weight's
    shape (``weight_copies``); then ``probe(eng)``, if given, under
    ``probe``.  The requests are cancelled afterwards."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.RandomState(SEED + 7)
    sids = [300 + i for i in range(4)]
    for sid in sids:
        eng.submit(Request(seq_id=sid, prompt=rng.randint(
            0, cfg.vocab_size, prompt_len), max_new_tokens=64,
            frontend=random_frontend(cfg, rng)))
    while eng._prefilling or eng.waiting:
        eng.step()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        walls.append((time.perf_counter() - t0) * 1e3)
    rows = profile_device(torch, eng.step, 1)
    extra = {} if probe is None else {"probe": probe(eng)}
    if top:
        extra["top"] = [dict(kernel=name[:90], ms=round(ms, 4), launches=n)
                        for name, ms, n in rows[:top]]
    if copies_of is not None:
        extra["weight_copies"] = weight_copies(torch, eng.step, copies_of)
    for sid in sids:
        eng.cancel(sid)
    wall = statistics.median(walls)
    busy = sum(ms for _, ms, _ in rows)
    return dict(**extra,
        wall_ms=round(wall, 3), device_busy_ms=round(busy, 3),
        idle_share=round(1 - busy / wall, 4) if rows else None,
        device_kernels=int(round(sum(n for _, _, n in rows))),
        paged_attention_ms=round(sum(ms for name, ms, _ in rows
                                     if "paged_attn_kernel" in name), 4))


def weight_copies(torch, fn, params):
    """The copy ops of one call of ``fn`` (``aten::copy_``, ``_to_copy``,
    ``clone``, ``contiguous``, from the profiler's recorded input shapes)
    that read a tensor shaped like one of ``params``' weights, in any
    order of its dims (a layer's slice of a stacked weight, or a whole
    one; tensors under 65,536 elements, the norms, left out).  Copying a
    weight, e.g. an einsum that permutes the (E, d, F) experts, would show
    here.  Returns [(op, shape, calls)]."""
    import itertools
    from torch.profiler import ProfilerActivity, profile
    shapes = set()
    for t in _leaves(params):
        for shp in (tuple(t.shape), tuple(t.shape[1:])):
            if len(shp) and int(torch.tensor(shp).prod()) >= 1 << 16:
                shapes.update(itertools.permutations(shp))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    hits = {}
    for e in prof.events():
        if e.name not in ("aten::copy_", "aten::_to_copy", "aten::clone",
                          "aten::contiguous"):
            continue
        for shp in e.input_shapes:
            if tuple(shp) in shapes:
                key = (e.name, tuple(shp))
                hits[key] = hits.get(key, 0) + 1
    return [(name, list(shp), n) for (name, shp), n in sorted(hits.items())]


def spec_pair(torch, dev, cfg, params, make_requests, engine_kw, label,
              after=None, wrap=None):
    """The same requests spec-off, then spec-on (``PHASE7_K`` drafts),
    each step held by ``check_invariants``, each kernel's launch count
    set to 0 just before each run and read just after.  Fails unless
    every stream holds its tokens in the vocab and each step that decoded
    launched the translation exactly once.  ``wrap(name)`` (a context
    manager) surrounds each run; ``after(name, eng)`` runs after it and
    its result is kept.  Returns {"off": run, "on": run}: streams, steps,
    margins, stats, launches, wall s, peak GiB, after."""
    from repro_torch.kernels.utopia_rsw.ops import utopia_translate_step
    from repro_torch.serve import Engine, EngineConfig
    runs = {}
    for name, spec in (("off", None), ("on", "ngram")):
        eng = Engine(cfg, params, EngineConfig(
            dtype=torch.bfloat16, spec_decode=spec,
            num_draft_tokens=PHASE7_K, **engine_kw), device=dev)
        margins = {}
        record_margins(eng, margins)
        trans = {"last": utopia_translate_step.launches, "per_step": []}

        def each(e, trans=trans):
            n = utopia_translate_step.launches
            trans["per_step"].append(n - trans["last"])
            trans["last"] = n
            e.check_invariants()

        reqs = make_requests()
        torch.cuda.reset_peak_memory_stats()
        _kernel_counts(reset=True)
        trans["last"] = utopia_translate_step.launches
        t0 = time.perf_counter()
        with (wrap(name) if wrap else contextlib.nullcontext()):
            streams, steps = serve(eng, reqs, each_step=each)
        wall = time.perf_counter() - t0
        launches = _kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_streams(reqs, streams, cfg.vocab_size)
        want = [1 if live else 0 for _, _, live, _, _ in steps]
        if trans["per_step"] != want:
            raise AssertionError(f"{label} ({name}): translation launches "
                                 f"per step {trans['per_step']}, expected "
                                 f"{want}")
        runs[name] = dict(streams=streams, steps=steps, margins=margins,
                          stats=eng.stats(), launches=launches, wall=wall,
                          peak_gib=peak,
                          after=after(name, eng) if after else None)
        del eng
        torch.cuda.empty_cache()
    return runs


def spec_divergence(on, off):
    """For each request whose spec-on stream differs from its spec-off
    stream: the first differing token, the step of each run and both
    runs' top-2 logit margins there."""
    diverged = []
    for sid in sorted(on["streams"]):
        diff = near_tie(on["margins"], on["steps"], on["streams"][sid],
                        off["streams"][sid], sid)
        if diff is not None:
            i, step, m = diff
            step_off, m_off = margin_of(off["margins"], off["steps"], sid, i)
            diverged.append(dict(request=sid, token=i, step_on=step,
                                 top2_margin_on=m, step_off=step_off,
                                 top2_margin_off=m_off))
    return diverged


def tokens_per_s(run):
    return sum(len(t) for t in run["streams"].values()) / sum(
        w for w, *_ in run["steps"])


def decode_step_ms(run):
    """Median wall ms of the run's steps that decoded and admitted
    nothing."""
    ws = [w for w, recs, live, _, _ in run["steps"] if live and not recs]
    return round(statistics.median(ws) * 1e3, 3)


def full_width_spec(torch, dev, cfg, dims, params):
    """Phase 7: the same 10 requests spec-off, then spec-on (the path;
    its launch counts are read), each step held by ``check_invariants``.
    Fails unless every stream holds 32 in-vocab tokens, drafts were
    proposed and a repetitive request accepted some, the per-query paged
    read launched, each step that decoded launched the translation
    exactly once, and every spec-on stream equals its spec-off stream.
    Prints tokens/s and steps of both, emitted tokens per row-step, the
    acceptance rate, a steady verify step's wall and device ms beside a
    decode step's, where a spec-on stream differs from spec-off the first
    differing token, its step and both runs' top-2 margins (before
    failing), and each op's row dependence on a verify step's own
    activations (``decode_row_dependence``)."""
    def after(name, eng):
        probe = name == "on" and (
            lambda e: decode_row_dependence(torch, e, cfg))
        return steady_step(torch, eng, cfg, probe or None)

    runs = spec_pair(torch, dev, cfg, params, lambda: phase7_requests(cfg),
                     PHASE7, "phase 7", after=after)
    on, off = runs["on"], runs["off"]
    st = on["stats"]
    rep = {sid: st["per_request"][sid]["accepted"] for sid in (8, 9)}
    if st["spec_drafted"] <= 0 or max(rep.values()) <= 0:
        raise AssertionError(f"phase 7: drafted {st['spec_drafted']}, "
                             f"accepted on the repetitive requests {rep}")
    launches = on["launches"]
    if launches["paged_attention_q_per_query"] <= 0:
        raise AssertionError("phase 7: the per-query paged read was never "
                             "launched")
    n_req = len(on["streams"])
    row_steps = sum(live for _, _, live, _, _ in on["steps"])
    decoded = sum(len(t) for t in on["streams"].values()) - n_req
    diverged = spec_divergence(on, off)
    summary = dict(
        requests=n_req, new_tokens_each=32, repetitive_requests=[8, 9],
        num_draft_tokens=PHASE7_K,
        steps={"on": len(on["steps"]), "off": len(off["steps"])},
        tokens_per_s={k: round(tokens_per_s(r), 2) for k, r in runs.items()},
        step_ms_median={"verify": decode_step_ms(on),
                        "decode": decode_step_ms(off)},
        steady_b4={"verify": on["after"], "decode": off["after"]},
        emitted_per_row_step=round(decoded / max(row_steps, 1), 4),
        spec_drafted=st["spec_drafted"], spec_accepted=st["spec_accepted"],
        acceptance_rate=round(st["spec_accepted"]
                              / max(st["spec_drafted"], 1), 4),
        accepted_by_request={sid: row["accepted"] for sid, row
                             in st["per_request"].items()},
        streams_sha256={k: stream_digest(r["streams"])
                        for k, r in runs.items()},
        streams_on_equal_off=n_req - len(diverged), diverged=diverged,
        decode_rows=on["after"].pop("probe"), launches=launches)
    log("phase 7: granite-8b full width, 36 layers, bf16, Engine("
        + ", ".join(f"{k}={v!r}" for k, v in PHASE7.items())
        + f", spec_decode='ngram', num_draft_tokens={PHASE7_K}) against "
        "spec_decode=None: " + json.dumps({"spec": summary}))
    if diverged:
        raise AssertionError(f"phase 7: {len(diverged)} of {n_req} bf16 "
                             "spec-on streams differ from spec-off")
    return launches


# phase 8: the moe family at full width and depth (qwen3-moe-30b-a3b: 48
# layers, 32/4 heads of 128, 128 experts of d_ff 768, top-8, vocab
# 151936), on phase 5's engine and requests, spec-off and spec-on; then
# (b) card against CPU at 2 layers in float32 and (c) qwen2.5-14b (40/8
# heads: g = 5) cut to 8 layers, with nonzero qkv biases
PHASE8_ARCH = "qwen3-moe-30b-a3b"
PHASE8C = dict(arch="qwen2.5-14b", layers=8, lens=(512, 320, 448, 192),
               new_tokens=16)


def served_model(torch, dev, name, dtype, layers=None, device=None,
                 seed=SEED + 8, overrides=None):
    """``name`` at its published width (``layers`` cuts the depth,
    ``overrides`` replaces other config fields) with random weights from
    a generator seeded with ``seed`` on ``device`` (default the card);
    qkv biases, which ``init_params`` leaves at zero as the JAX package
    does, are drawn nonzero.  Returns (cfg, dims, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_dims
    from repro_torch.params import init_params
    cfg = get_config(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    dims = model_dims(cfg)
    device = dev if device is None else device
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(gen, cfg, dims, dtype, device)
    if cfg.qkv_bias:
        trees = [params["layers"]["attn"]]
        if cfg.is_encoder_decoder:
            trees += [params["layers"]["cross"],
                      params["encoder"]["layers"]["attn"]]
        for t in (tree[k]["b"] for tree in trees for k in "qkv"):
            t.copy_(0.5 * torch.randn(t.shape, generator=gen, device=device))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    md = dims.mamba
    log(f"{name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        + (f"{dims.n_heads}/{dims.n_kv} heads of {dims.head_dim}, d_ff "
           f"{dims.d_ff}" if dims.n_heads else "attention-free")
        + (f", {cfg.moe_num_experts} experts top-{cfg.moe_top_k}"
           if cfg.moe_num_experts else "")
        + (f", {cfg.encoder_layers} encoder layers" if cfg.encoder_layers
           else "")
        + (f", {cfg.frontend} frontend of {cfg.frontend_tokens} embeddings"
           if cfg.frontend != "none" else "")
        + (f", mamba d_inner {md.d_inner} ({md.n_heads} heads of "
           f"{md.head_dim}), d_state {md.d_state}"
           + (f", groups of {cfg.attn_every}" if cfg.attn_every else "")
           if md else "")
        + f", vocab {dims.vocab}: {n / 1e9:.2f} B {str(dtype)[6:]} "
        f"parameters drawn in {time.perf_counter() - t0:.1f} s on {device}")
    return cfg, dims, params


@contextlib.contextmanager
def moe_drops(torch, rec):
    """Record every ``moe_layer`` call's (tokens, ``fraction_dropped``)
    (a device scalar) into ``rec`` while the block runs: the admission
    steps' MoE layers."""
    import repro_torch.models.transformer as tmod
    orig = tmod.moe_layer

    def moe_layer(p, x, **kw):
        out, aux = orig(p, x, **kw)
        rec.append((x.shape[0] * x.shape[1], aux["fraction_dropped"]))
        return out, aux

    tmod.moe_layer = moe_layer
    try:
        yield rec
    finally:
        tmod.moe_layer = orig


def moe_row_dependence(torch, eng, cfg):
    """The verify step's MoE at the decode step's shape: one step of the
    spec-on engine ``eng`` runs with every ``moe_decode`` input recorded
    (a (B (K + 1), d) window of rows and their router logits, taken one
    window position at a time); each is then run again on every window
    position's contiguous (B, d) slice and compared bitwise, for the
    router's float32 logits (as one (B (K + 1), d) product against the
    per-position products) and for the MoE's output (the experts and the
    combine).  Reported; the verify step runs the router per position
    (``serve/decode.py decode_ffn``) and the experts over the window."""
    import repro_torch.serve.decode as dmod
    from repro_torch.models.moe import moe_decode
    rec = []
    orig = dmod.moe_decode

    def recording(p, x, *, top_k, logits=None, **kw):
        rec.append((p, x, logits))
        return orig(p, x, top_k=top_k, logits=logits, **kw)

    dmod.moe_decode = recording
    try:
        eng.step()
    finally:
        dmod.moe_decode = orig
    Q = eng.spec_K + 1
    out = dict(layers=0, rows=0, router_rows_differ=0, moe_rows_differ=0,
               moe_max_abs_diff=0.0)
    for p, x, lg in rec:
        M, d = x.shape
        if M % Q:
            continue
        B = M // Q
        out["layers"] += 1
        out["rows"] += M
        whole = x.float() @ p["router"]["w"]
        out["router_rows_differ"] += int((whole != lg).any(-1).sum())
        y = moe_decode(p, x, top_k=cfg.moe_top_k, logits=lg).reshape(
            B, Q, d)
        x3, l3 = x.reshape(B, Q, d), lg.reshape(B, Q, -1)
        for c in range(Q):
            yc = moe_decode(p, x3[:, c].contiguous(), top_k=cfg.moe_top_k,
                            logits=l3[:, c].contiguous())
            out["moe_rows_differ"] += int((yc != y[:, c]).any(-1).sum())
            out["moe_max_abs_diff"] = max(out["moe_max_abs_diff"], float(
                (yc.float() - y[:, c].float()).abs().max()))
    return out


def full_width_moe(torch, dev):
    """Phase 8 (a): qwen3-moe-30b-a3b at full width and depth, bf16,
    seeded random weights, on phase 5's engine configuration and
    requests, spec-off then spec-on (K = 4); each run's launch counts
    from 0.  Fails unless every stream holds 32 in-vocab tokens, each
    decoding step launched the translation once, the translation, the
    decode read, the Q > 1 prefix read and the per-query verify read all
    launched, every spec-on stream equals its spec-off stream, and a
    steady decode step copies no weight.  Prints the median decode-step
    wall ms, a steady decode and verify step's device ms (idle share,
    kernels, the largest kernels), a prefix-KV admission step's device ms
    by kernel, tokens/s, peak memory, launches, the MoE's
    ``fraction_dropped`` over the admission steps, the verify's MoE rows
    against the decode shape's, and both runs' ``streams_sha256``."""
    import numpy as np
    cfg, dims, params = served_model(torch, dev, PHASE8_ARCH, torch.bfloat16)
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    drops = {"off": [], "on": []}

    def after(name, eng):
        probe = name == "on" and (
            lambda e: moe_row_dependence(torch, e, cfg))
        r = {"steady": steady_step(torch, eng, cfg, probe or None, top=10,
                                   copies_of=params if name == "off"
                                   else None)}
        if name == "off":
            profile_prefix_step(torch, eng, np.random.RandomState(SEED + 8),
                                cfg)
        return r

    def requests():
        return phase5_requests(cfg, np.random.RandomState(SEED + 5))[0]

    runs = spec_pair(torch, dev, cfg, params, requests, PHASE5, "phase 8",
                     after=after,
                     wrap=lambda name: moe_drops(torch, drops[name]))
    on, off = runs["on"], runs["off"]
    launches = {k: off["launches"][k] + on["launches"][k]
                for k in off["launches"]}
    for name in ("utopia_translate_step", "paged_attention",
                 "paged_attention_q_gt1", "paged_attention_q_per_query"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 8: {name} was never launched")
    copies = off["after"]["steady"]["weight_copies"]
    if copies:
        raise AssertionError(f"phase 8: a decode step copies weights: "
                             f"{copies}")

    def dropped(rec):
        """Token-weighted mean share of (token, k) entries dropped, over
        all MoE layers and at the first and the last (the calls come
        layer by layer, each dispatch's in order), and the worst call."""
        L = cfg.num_layers

        def mean(sel):
            n = sum(t for t, _ in sel)
            return round(sum(t * float(f) for t, f in sel) / max(n, 1), 5)

        return dict(layer_calls=len(rec), tokens=sum(t for t, _ in rec),
                    mean=mean(rec), first_layer=mean(rec[0::L]),
                    last_layer=mean(rec[L - 1::L]),
                    max=round(max((float(f) for _, f in rec), default=0.0),
                              5))

    diverged = spec_divergence(on, off)
    n_req = len(on["streams"])
    st = on["stats"]
    summary = dict(
        requests=n_req, new_tokens_each=32, num_draft_tokens=PHASE7_K,
        weights_gib=round(weights_gib, 3),
        steps={"on": len(on["steps"]), "off": len(off["steps"])},
        decode_step_ms_median={"verify": decode_step_ms(on),
                               "decode": decode_step_ms(off)},
        tokens_per_s={k: round(tokens_per_s(r), 2) for k, r in runs.items()},
        wall_s={k: round(r["wall"], 3) for k, r in runs.items()},
        gpu_mem_peak_gib={k: round(r["peak_gib"], 3)
                          for k, r in runs.items()},
        steady_b4={"decode": off["after"]["steady"],
                   "verify": on["after"]["steady"]},
        moe_fraction_dropped={k: dropped(v) for k, v in drops.items()},
        spec_drafted=st["spec_drafted"], spec_accepted=st["spec_accepted"],
        prefix_cache=off["stats"]["prefix_cache"],
        streams_sha256={k: stream_digest(r["streams"])
                        for k, r in runs.items()},
        streams_on_equal_off=n_req - len(diverged), diverged=diverged,
        moe_rows=on["after"]["steady"].pop("probe"),
        launches={"off": off["launches"], "on": on["launches"]})
    log(f"phase 8 (a): {PHASE8_ARCH} full width, {cfg.num_layers} layers, "
        "bf16, Engine(" + ", ".join(f"{k}={v!r}" for k, v in PHASE5.items())
        + f"), spec_decode=None then 'ngram' (K={PHASE7_K}): "
        + json.dumps({"moe": summary}))
    if diverged:
        raise AssertionError(f"phase 8: {len(diverged)} of {n_req} bf16 "
                             "spec-on streams differ from spec-off")
    del params
    return launches


def moe_card_vs_cpu(torch, dev):
    """Phase 8 (b): qwen3-moe-30b-a3b at full width cut to 2 layers, in
    float32, on the card and on the CPU with the same weights: 4 greedy
    requests of 64-256 tokens, 8 new tokens each, on the default
    admission path with the paged prefix read; streams, admission logs,
    translation and cache stats identical."""
    import numpy as np
    cfg, _, params = served_model(torch, dev, PHASE8_ARCH, torch.float32,
                               layers=2, device="cpu")
    rng = np.random.RandomState(SEED + 8)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (64, 256, 128,
                                                           192)]
    card_vs_cpu(torch, dev, (cfg, params), prompts, 8, "moe", strict=True,
                max_batch=4, max_seq_len=512, prefill_budget=256,
                prefill_mode="prefix_kv", prefix_gather="paged",
                prefix_cache="auto")


def _bound_by(nbytes, flops, dtype="bfloat16"):
    """Which of the two bounds is the larger: "bytes" or "operations"."""
    return ("bytes" if nbytes / HBM_BYTES_PER_S
            >= flops / PEAK_FLOPS[dtype] else "operations")


def kernel_times(torch, fns, symbols, iters=20):
    """(CUDA-event ms a call, cycling over ``fns``, whose inputs together
    outgrow the L2; ``device_ms`` of the kernel named by ``symbols``, one
    launch a call of ``fns[0]``)."""
    return (time_ms(torch, fns, 4 * iters),
            device_ms(torch, fns[0], iters, symbols))


def geometry_reads(torch, dev, heads=((40, 8), (32, 4)),
                   kinds=("decode", "verify", "prefix"),
                   flash=((2, 512, 512, 40, 8, 128, True),),
                   label="phase 8 (c)"):
    """The kernels at a phase's head geometries (bf16, bs = 64): by
    default phase 8's, the paged decode read (B=4, Q=1), the verify read
    (Q=5, per-query extents) and a prefix read (Q=256) at qwen2.5-14b's
    40/8 heads (g = 5) and qwen3-moe-30b-a3b's 32/4 (g = 8) of D = 128,
    and flash attention at (B, Sq, Skv, H, KV, D) = (2, 512, 512, 40, 8,
    128), causal: each held to its plain version and timed (CUDA events
    over four input sets, which for the small reads is mostly the
    wrapper's host time, and profiler device ms a launch) beside its
    bound, each row's K/V read once; flash also beside SDPA's.  The paged
    reads are held at 3e-2, and every query of a verify read and queries
    ``PREFIX_QUERIES`` of a prefix read must equal Q = 1 launches at their
    extents bitwise; flash is held in bf16 by ``check_flash_bf16`` and in
    float32 at 1e-4 on the same inputs.  ``heads`` ((H, KV) or (H, KV,
    D)), ``kinds`` and ``flash`` ((B, Sq, Skv, H, KV, D, causal) each)
    pick another phase's geometries."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models.attention import dense_attention
    gen = torch.Generator().manual_seed(SEED + 8)
    out = {}
    shapes = {"decode": (None, False), "verify": (WINDOW, True),
              "prefix": (256, False)}
    for H, KV, *Dh in heads:
        D = Dh[0] if Dh else 128
        tag = f"H{H}_KV{KV}" + ("" if D == 128 else f"_D{D}")
        for kind in kinds:
            Q, per_query = shapes[kind]
            sets = []
            for _ in range(4):
                q, kp, vp, slots, ext = _paged_case(
                    torch, dev, torch.bfloat16, H=H, KV=KV, D=D, Q=Q,
                    per_query=per_query, gen=gen)
                sets.append((q.to(torch.bfloat16), kp[0], vp[0], slots,
                             ext))
            q, kp, _, slots, ext = args = sets[0]
            got = paged_attention(*args)
            err = max(check_close(f"paged_attention[{kind}, {tag}]", g, w,
                                  3e-2)
                      for g, w in zip(got, paged_attention_ref(*args)))
            if Q is not None:
                for i in (range(Q) if per_query else PREFIX_QUERIES):
                    e = ext[:, i].contiguous() if per_query else ext
                    one = paged_attention(q[:, i].contiguous(), *args[1:4],
                                          e)
                    if not all(torch.equal(x, y[:, i])
                               for x, y in zip(one, got)):
                        raise AssertionError(
                            f"paged_attention[{kind}, {tag}]: query {i} "
                            "differs from a Q=1 launch at its extent")
            bs = kp.shape[1]
            nq = 1 if Q is None else Q
            last = ext[:, -1] if per_query else ext
            n_tok = sum(-(-int(e) // bs) * bs for e in last.tolist()) - bs
            nbytes = (q.numel() * 2 + 2 * n_tok * KV * D * 2
                      + slots.numel() * 4 + ext.numel() * 4
                      + q.numel() * 4 + 2 * q.numel() // D * 4)
            flops = 4 * D * H * int(ext.sum()) * (1 if per_query else nq)
            bound = max(nbytes / HBM_BYTES_PER_S,
                        flops / PEAK_FLOPS["bfloat16"]) * 1e3
            ms, dms = kernel_times(
                torch, [lambda s=s: paged_attention(*s) for s in sets],
                ("paged_attn_kernel",))
            out[f"paged_{kind}_{tag}"] = dict(
                g=H // KV, D=D, Q=nq, max_abs_err=err, ms=ms, device_ms=dms,
                bound_ms=bound, bound_by=_bound_by(nbytes, flops),
                plain_ms=time_ms(
                    torch, [lambda s=s: paged_attention_ref(*s)
                            for s in sets], 8),
                ctas=_grid_ctas(q.shape[0], nq, H, KV, D, slots.shape[1]),
                **({"queries_bitwise_q1": True} if Q is not None else {}))
    g2 = torch.Generator(device=dev).manual_seed(SEED + 8)
    for B, S, Skv, H, KV, D, causal in flash:
        sets = [[torch.randn((B, n, h, D), generator=g2, device=dev).to(
            torch.bfloat16) for n, h in ((S, H), (Skv, KV), (Skv, KV))]
            for _ in range(4)]
        q, k, v = sets[0]
        tag = (f"flash_B{B}_S{S}_H{H}_KV{KV}"
               + ("" if Skv == S else f"_Skv{Skv}")
               + ("" if D == 128 else f"_D{D}")
               + ("" if causal else "_full"))
        held = check_flash_bf16(tag, flash_attention(q, k, v, causal=causal),
                                q, k, v, causal)
        q32, k32, v32 = (t.float() for t in (q, k, v))
        err32 = check_close(f"{tag} (float32)",
                            flash_attention(q32, k32, v32, causal=causal),
                            dense_attention(q32, k32, v32, causal=causal),
                            1e-4)
        del q32, k32, v32
        heads_first = [(
            q.transpose(1, 2).contiguous(),
            k.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous(),
            v.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous())
            for q, k, v in sets]
        lib = [lambda s=s: F.scaled_dot_product_attention(*s,
                                                          is_causal=causal)
               for s in heads_first]
        pairs = (S * (S + 1) // 2) if causal else S * Skv
        flops = 4 * B * H * D * pairs
        nbytes = 2 * (2 * B * S * H * D + 2 * B * Skv * KV * D)
        ms, dms = kernel_times(
            torch, [lambda s=s: flash_attention(*s, causal=causal)
                    for s in sets],
            ("flash_wgmma_kernel", "flash_kernel"), iters=5)
        out[tag] = dict(
            g=H // KV, D=D, Sq=S, Skv=Skv, causal=causal, **held,
            max_abs_err_f32=err32, tol_f32=1e-4,
            ms=ms, device_ms=dms,
            bound_ms=max(nbytes / HBM_BYTES_PER_S,
                         flops / PEAK_FLOPS["bfloat16"]) * 1e3,
            bound_by=_bound_by(nbytes, flops),
            sdpa_ms=time_ms(torch, lib, 20),
            sdpa_device_ms=device_ms(torch, lib[0], 5),
            plain_ms=time_ms(torch, [lambda s=s: dense_attention(
                *s, causal=causal) for s in sets], 8))
    log(f"{label} kernels at the serving geometries (bf16): "
        + json.dumps({k: {f: (round(x, 6) if isinstance(x, float) else x)
                          for f, x in r.items()} for k, r in out.items()}))
    return out


def dense_geometry(torch, dev):
    """Phase 8 (c): qwen2.5-14b at full width cut to 8 layers, bf16, with
    nonzero qkv biases: 4 requests (192-512 tokens, 16 new tokens each)
    through flash attention and recompute prefill (H = 40, KV = 8), then
    the same on phase 5's engine (the paged decode and prefix reads at g
    = 5); launch counts from 0 before the first and read after the
    second.  Fails unless flash attention, the translation and both paged
    reads launched and every stream holds its tokens in the vocab.  Then
    the kernels at the serving geometries (``geometry_reads``)."""
    import numpy as np
    from repro_torch.serve import Engine, EngineConfig
    c = PHASE8C
    cfg, dims, params = served_model(torch, dev, c["arch"], torch.bfloat16,
                                  layers=c["layers"])
    rng = np.random.RandomState(SEED + 9)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in c["lens"]]
    _kernel_counts(reset=True)
    out = {}
    for name, kw in (("flash_recompute", dict(max_batch=4,
                                              max_seq_len=1024,
                                              auto_release=True,
                                              **EARLIER_PATH)),
                     ("defaults_paged", PHASE5)):
        eng = Engine(cfg, params, EngineConfig(dtype=torch.bfloat16, **kw),
                     device=dev)
        reqs = smoke_requests(prompts, c["new_tokens"])
        t0 = time.perf_counter()
        streams, steps = serve(eng, reqs)
        wall = time.perf_counter() - t0
        check_streams(reqs, streams, cfg.vocab_size)
        eng.check_invariants()
        out[name] = dict(steps=len(steps), tokens_per_s=round(sum(
            len(t) for t in streams.values()) / wall, 2),
            decode_step_ms_median=round(statistics.median(
                [w for w, recs, live, _, _ in steps if live and not recs])
                * 1e3, 3),
            streams_sha256=stream_digest(streams))
        del eng
    launches = _kernel_counts()
    for name in ("flash_attention", "utopia_translate_step",
                 "paged_attention", "paged_attention_q_gt1"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 8 (c): {name} was never launched")
    log(f"phase 8 (c): {c['arch']} full width cut to {cfg.num_layers} "
        f"layers (of 48), bf16, nonzero qkv biases, {len(prompts)} requests "
        f"of {list(c['lens'])} tokens, {c['new_tokens']} new each: "
        + json.dumps({"dense": dict(runs=out, launches=launches)}))
    del params
    torch.cuda.empty_cache()
    geometry_reads(torch, dev)
    return launches


# phase 9: the recurrent families.  (a) mamba2-130m at its published
# width and depth; (b) jamba-1.5-large-398b at its published width, cut
# to ONE group of 6 sublayers (5 mamba + 1 attention, MoE on sublayers 1,
# 3 and 5): 34.05 B parameters, 68.1 GB bf16 (a full 8-sublayer group is
# 45.13 B, 90.3 GB, more than one card holds); (c) float32 card = CPU of
# mamba2-130m cut to 4 layers and of a reduced-width jamba (a float32
# full-width MoE layer is 38.7 GB, too slow on the CPU).
PHASE9_SSM = "mamba2-130m"
PHASE9_HYBRID = "jamba-1.5-large-398b"
PHASE9_CUT = dict(num_layers=6, attn_every=6)
PHASE9_CPU_HYBRID = dict(d_model=1024, num_heads=8, num_kv_heads=1,
                         head_dim=128, d_ff=3072, attn_every=2,
                         num_layers=2)
# mamba2's fault schedule: forced preemptions of decode-live sequences
# (no KV pool: the host tier carries the ssm/conv rows only), after the
# last prompt chunk is admitted (step 40).  An earlier preemption would
# admit a queued prompt in another prefill bucket than the clean run
# does, and bf16 GEMMs round a row otherwise at another bucket shape;
# tests/test_torch_ssm.py holds mid-prefill preemptions in float32.
PHASE9_OVERLOAD = dict(preempt_at=[(44, "post", "auto"), (50, "pre", "auto"),
                                   (56, "pre", 7)])
PHASE9_FLASH = dict(PHASE5, attn_impl="pallas", prefill_mode="recompute")


def pad_invariance(torch, cfg, params, dtype, device):
    """A 7-block prompt's installed SSM state and conv tail: admitted in
    the 8-block bucket beside a 5-block row (the engine's recompute
    prefill, the pad tail masked) against the model's forward at the
    prompt's exact length.  Returns whether each is bitwise equal, and
    the max abs difference."""
    import numpy as np
    from repro_torch.models import FwdOptions, forward, model_dims
    from repro_torch.serve import Engine, EngineConfig, Request
    bs = cfg.kv_block_size
    rng = np.random.RandomState(SEED + 19)
    prompt = rng.randint(0, cfg.vocab_size, 7 * bs)
    short = rng.randint(0, cfg.vocab_size, 5 * bs)
    dims = model_dims(cfg)
    _, _, c = forward(params, {"tokens": torch.tensor(
        prompt, device=device)[None]}, cfg, dims,
        FwdOptions(dtype=dtype, collect_cache=True))
    eng = Engine(cfg, params, EngineConfig(
        max_batch=2, max_seq_len=16 * bs, prefill_budget=12 * bs,
        dtype=dtype), device=device)
    eng.submit(Request(seq_id=0, prompt=prompt, max_new_tokens=1))
    eng.submit(Request(seq_id=1, prompt=short, max_new_tokens=1))
    eng.step()
    if [(r.end, r.path) for r in eng.admission_log] != [
            (7 * bs, "recompute"), (5 * bs, "recompute")]:
        raise AssertionError(f"pad check admitted {eng.admission_log}")
    slot = eng._slot_of[0]
    out = {}
    for name, want in (("ssm", c["ssm"].state), ("conv", c["ssm"].conv)):
        got = eng.dstate[name][:, slot]
        want = want.reshape(got.shape[0], -1, *got.shape[1:])[:, 0]
        out[f"{name}_bitwise"] = bool(torch.equal(got, want))
        out[f"{name}_max_abs_diff"] = float(
            (got.float() - want.float()).abs().max())
    del eng
    return out


def engine_runs(torch, dev, cfg, params, runs, make_requests, label,
                   wrap=None):
    """Serve ``make_requests()`` once per ``runs`` entry (name ->
    (EngineConfig fields, ServeFaultInjector arguments or None)) in bf16,
    ``check_invariants`` after every step, the kernels' launch counts set
    to 0 just before each run and read just after.  Returns {name:
    dict(streams, steps, stats, launches, wall, peak_gib, engine)}."""
    from repro_torch.runtime import ServeFaultInjector
    from repro_torch.serve import Engine, EngineConfig
    out = {}
    for name, (kw, schedule) in runs.items():
        inj = (ServeFaultInjector(**schedule) if schedule is not None
               else None)
        eng = Engine(cfg, params, EngineConfig(
            dtype=torch.bfloat16, fault_injector=inj, **kw), device=dev)
        reqs = make_requests()
        torch.cuda.reset_peak_memory_stats()
        _kernel_counts(reset=True)
        t0 = time.perf_counter()
        with (wrap(name) if wrap else contextlib.nullcontext()):
            streams, steps = serve(eng, reqs,
                                   each_step=lambda e: e.check_invariants())
        wall = time.perf_counter() - t0
        launches = _kernel_counts()
        check_streams(reqs, streams, cfg.vocab_size)
        out[name] = dict(streams=streams, steps=steps, stats=eng.stats(),
                         launches=launches, wall=wall, engine=eng,
                         injector_log=None if inj is None else inj.log,
                         peak_gib=torch.cuda.max_memory_allocated()
                         / 2 ** 30)
        log(f"{label} run {name!r}: {len(steps)} steps in {wall:.1f} s, "
            f"streams_sha256 {stream_digest(streams)}, launches "
            f"{json.dumps(launches)}")
    return out


def run_summary(run):
    """The printed numbers of one ``recurrent_runs`` entry."""
    decode = [w for w, recs, live, _, _ in run["steps"] if live and not recs]
    return dict(
        steps=len(run["steps"]),
        decode_step_ms_median=round(statistics.median(decode) * 1e3, 3),
        tokens_per_s=round(tokens_per_s(run), 2),
        wall_s=round(run["wall"], 3),
        gpu_mem_peak_gib=round(run["peak_gib"], 3),
        streams_sha256=stream_digest(run["streams"]),
        launches=run["launches"])


def full_width_ssm(torch, dev):
    """Phase 9 (a): mamba2-130m at its published width and depth, bf16,
    seeded random weights, on phase 5's engine and requests (8 of 64-704
    tokens, half sampled, 32 new each): the defaults, then with
    ``spec_decode="ngram"`` (one warning, ``spec_K == 0``, the same
    streams), then under ``PHASE9_OVERLOAD`` (forced preemptions; the same
    streams, swap bytes reported).  Fails unless no CUDA kernel launched
    (an attention-free model translates nothing and reads no pool).
    Prints weights and peak GiB, a steady decode step's wall and device
    ms, kernels, idle share and top kernels, a prefix-KV admission step's
    profile, the pad check in bf16 and each run's ``streams_sha256``."""
    import warnings
    import numpy as np
    import repro_torch.serve.engine as engine_mod
    cfg, dims, params = served_model(torch, dev, PHASE9_SSM, torch.bfloat16,
                                     seed=SEED + 9)
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30

    def requests():
        return phase5_requests(cfg, np.random.RandomState(SEED + 5))[0]

    engine_mod._SPEC_FALLBACK_WARNED = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runs = engine_runs(torch, dev, cfg, params, {
            "defaults": (PHASE5, None),
            "spec_ngram": (dict(PHASE5, spec_decode="ngram"), None),
            "preempt": (PHASE5, PHASE9_OVERLOAD)}, requests, "phase 9 (a)")
    spec_warn = [str(w.message) for w in caught
                 if "speculative" in str(w.message)]
    spec_eng = runs["spec_ngram"]["engine"]
    if len(spec_warn) != 1 or spec_eng.spec_K != 0 or (
            "hist" in spec_eng.dstate):
        raise AssertionError(f"phase 9 (a): spec fallback {spec_warn}, "
                             f"spec_K {spec_eng.spec_K}")
    clean = runs["defaults"]["streams"]
    for name in ("spec_ngram", "preempt"):
        if runs[name]["streams"] != clean:
            raise AssertionError(f"phase 9 (a): the {name} run's streams "
                                 "differ from the defaults'")
    ov = runs["preempt"]["stats"]["overload"]
    if ov["request_preempts"] <= 0 or ov["swap_bytes_in"] != ov[
            "swap_bytes_out"]:
        raise AssertionError(f"phase 9 (a): overload stats {ov}")
    for name, r in runs.items():
        if any(r["launches"].values()):
            raise AssertionError(f"phase 9 (a): {name} launched "
                                 f"{r['launches']}")
    eng = runs["defaults"]["engine"]
    pc = eng.stats()["prefix_cache"]
    steady = steady_step(torch, eng, cfg, top=8)
    profile_prefix_step(torch, eng, np.random.RandomState(SEED + 9), cfg)
    pad = pad_invariance(torch, cfg, params, torch.bfloat16, dev)
    summary = dict(
        weights_gib=round(weights_gib, 3),
        runs={k: run_summary(r) for k, r in runs.items()},
        spec_fallback_warning=spec_warn[0],
        preempt=dict(overload=ov, injector_log=runs["preempt"][
            "injector_log"]),
        prefix_cache=dict(enabled=pc["enabled"],
                          reason=eng._prefix_cache_unsupported()),
        steady_b4=steady, pad_invariance_bf16=pad)
    log(f"phase 9 (a): {PHASE9_SSM} full width and depth, bf16, Engine("
        + ", ".join(f"{k}={v!r}" for k, v in PHASE5.items()) + "): "
        + json.dumps({"ssm": summary}))
    del runs, eng, spec_eng, params
    return {k: 0 for k in _kernel_counts()}


def full_width_hybrid(torch, dev):
    """Phase 9 (b): jamba-1.5-large-398b at its published width, cut to
    one group of 6 sublayers (``PHASE9_CUT``), bf16, seeded random
    weights drawn on the card: phase 5's requests on phase 5's engine
    (the defaults with the paged prefix read: the RSW step, the paged
    decode and Q > 1 reads), then with recompute prefill and
    ``attn_impl="pallas"`` (flash attention), each run's launches from
    0.  The prefix cache is off (a recurrent family), and the phase
    prints why.  Fails unless the translation, the decode read and the
    Q > 1 read launched in the first run and flash attention in the
    second, and every stream holds 32 in-vocab tokens.  Prints weights
    and peak GiB, each run's steps, decode-step ms, tokens/s and
    ``streams_sha256``, a steady decode step's wall and device ms,
    kernels, idle share and top kernels, a prefix-KV admission step's
    profile, the MoE's ``fraction_dropped`` over the admission steps and
    the pad check in bf16.  Returns the launches of both runs summed."""
    import numpy as np
    cfg, dims, params = served_model(torch, dev, PHASE9_HYBRID,
                                     torch.bfloat16, seed=SEED + 9,
                                     overrides=PHASE9_CUT)
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    drops = {"paged": [], "flash_recompute": []}

    def requests():
        return phase5_requests(cfg, np.random.RandomState(SEED + 5))[0]

    runs = engine_runs(torch, dev, cfg, params, {
        "paged": (PHASE5, None), "flash_recompute": (PHASE9_FLASH, None)},
        requests, "phase 9 (b)",
        wrap=lambda name: moe_drops(torch, drops[name]))
    need = {"paged": ("utopia_translate_step", "paged_attention",
                      "paged_attention_q_gt1"),
            "flash_recompute": ("utopia_translate_step", "paged_attention",
                                "flash_attention")}
    for name, kernels in need.items():
        for k in kernels:
            if runs[name]["launches"][k] <= 0:
                raise AssertionError(f"phase 9 (b): {k} was never launched "
                                     f"in the {name} run")
    eng = runs["paged"]["engine"]
    pc = eng.stats()["prefix_cache"]
    if pc["enabled"]:
        raise AssertionError("phase 9 (b): the prefix cache is on")
    runs["flash_recompute"]["engine"] = None
    torch.cuda.empty_cache()
    steady = steady_step(torch, eng, cfg, top=10)
    profile_prefix_step(torch, eng, np.random.RandomState(SEED + 9), cfg)
    del eng, runs["paged"]["engine"]
    torch.cuda.empty_cache()
    pad = pad_invariance(torch, cfg, params, torch.bfloat16, dev)

    def dropped(rec):
        n = sum(t for t, _ in rec)
        return dict(layer_calls=len(rec), tokens=n, mean=round(
            sum(t * float(f) for t, f in rec) / max(n, 1), 5),
            max=round(max((float(f) for _, f in rec), default=0.0), 5))

    same = sum(runs["paged"]["streams"][sid]
               == runs["flash_recompute"]["streams"][sid]
               for sid in runs["paged"]["streams"])
    summary = dict(
        weights_gib=round(weights_gib, 3),
        runs={k: run_summary(r) for k, r in runs.items()},
        streams_equal_across_runs=same,
        prefix_cache=dict(enabled=pc["enabled"],
                          reason="the recurrent layers' state at a cached "
                                 "prefix's end is not cached"),
        rsw_hits=int(runs["paged"]["stats"].get("rsw_hits", 0)),
        flex_walks=int(runs["paged"]["stats"].get("flex_walks", 0)),
        steady_b4=steady, moe_fraction_dropped={
            k: dropped(v) for k, v in drops.items()},
        pad_invariance_bf16=pad)
    log(f"phase 9 (b): {PHASE9_HYBRID} full width, cut to "
        f"{cfg.num_layers} sublayers in groups of {cfg.attn_every}, bf16, "
        "Engine(" + ", ".join(f"{k}={v!r}" for k, v in PHASE5.items())
        + "), then attn_impl='pallas', prefill_mode='recompute': "
        + json.dumps({"hybrid": summary}))
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in runs["paged"]["launches"]}
    del runs, params
    return launches


def recurrent_card_vs_cpu(torch, dev):
    """Phase 9 (c): float32, card = CPU, on the default admission path
    with the paged prefix read: mamba2-130m at full width cut to 4
    layers, and a reduced-width jamba (``PHASE9_CPU_HYBRID``: d 1024, 8/1
    heads of 128, d_ff 3072, 16 experts top-2, the config's SSM
    settings, one group of 2); 4 greedy requests of 64-256 tokens, 8 new
    each.  Streams, admission logs and translation stats identical; the
    pad check held bitwise on the CPU and reported on the card."""
    import numpy as np
    out = {}
    for label, name, over in (("mamba2", PHASE9_SSM, dict(num_layers=4)),
                              ("jamba", PHASE9_HYBRID, PHASE9_CPU_HYBRID)):
        cfg, _, params = served_model(torch, dev, name, torch.float32,
                                      device="cpu", seed=SEED + 9,
                                      overrides=over)
        rng = np.random.RandomState(SEED + 9)
        prompts = [rng.randint(0, cfg.vocab_size, n) for n in (64, 256, 128,
                                                               192)]
        card_vs_cpu(torch, dev, (cfg, params), prompts, 8, label,
                    strict=True, max_batch=4, max_seq_len=512,
                    prefill_budget=256, prefill_mode="prefix_kv",
                    prefix_gather="paged", prefix_cache="auto")
        cpu = pad_invariance(torch, cfg, params, torch.float32,
                             torch.device("cpu"))
        card = pad_invariance(torch, cfg, to_device(params, dev),
                              torch.float32, dev)
        if not (cpu["ssm_bitwise"] and cpu["conv_bitwise"]):
            raise AssertionError(f"phase 9 (c) {label}: the pad tail "
                                 f"moved the installed state: {cpu}")
        out[label] = dict(cpu=cpu, card=card)
    log("phase 9 (c) pad invariance, float32 (a 7-block prompt beside a "
        "5-block row against its exact-length forward): "
        + json.dumps(out))


def recurrent(torch, dev, results):
    """Phase 9: (a), (c), the kernels at jamba's geometry (into
    ``results``), then (b).  Returns {path: launches}."""
    paths = {"phase9a": full_width_ssm(torch, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    recurrent_card_vs_cpu(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    geo = geometry_reads(torch, dev, heads=((64, 8),),
                         kinds=("decode", "prefix"),
                         flash=((2, 512, 512, 64, 8, 128, True),),
                         label="phase 9")
    results.setdefault("paged_attention", {})["jamba_H64_KV8"] = {
        k: geo[f"paged_{k}_H64_KV8"] for k in ("decode", "prefix")}
    results.setdefault("flash_attention", {})["jamba_H64_KV8"] = geo[
        "flash_B2_S512_H64_KV8"]
    gc.collect()
    torch.cuda.empty_cache()
    paths["phase9b"] = full_width_hybrid(torch, dev)
    return paths


# phase 10: the frontend families at their published width and depth, in
# bf16 on phase 5's engine.  (a) paligemma-3b (2.51 B parameters) with
# 256-token random image embeddings ahead of phase 5's requests; (b)
# whisper-medium (1.01 B) with 1500-frame random audio embeddings and
# prompts of 64-384 tokens (its decoder's context is 448 positions);
# (c) float32 card = CPU for reduced-width copies of both, cut to 2
# layers (a float32 full-width forward of 1500 frames is slow on the CPU).
PHASE10_VLM = "paligemma-3b"
PHASE10_AUDIO = "whisper-medium"
PHASE10_AUDIO_CTX = 448
PHASE10_AUDIO_BLOCKS = (1, 6, 2, 5, 3, 4, 2, 6)      # prompt blocks of 64
PHASE10_CPU = {PHASE10_VLM: dict(d_model=512, d_ff=2048, num_layers=2),
               PHASE10_AUDIO: dict(d_model=512, head_dim=64, d_ff=2048,
                                   num_layers=2, encoder_layers=2)}


@contextlib.contextmanager
def attention_calls(rec):
    """Record every ``attention`` call of the model's forward while the
    block runs: (Sq, Skv, H, KV, D, causal, impl)."""
    import repro_torch.models.transformer as tmod
    orig = tmod.attention

    def attention(q, k, v, **kw):
        rec.append((q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                    q.shape[3], kw.get("causal", True), kw.get("impl")))
        return orig(q, k, v, **kw)

    tmod.attention = attention
    try:
        yield
    finally:
        tmod.attention = orig


def phase10_requests(cfg, fronts):
    """Phase 10's 8 requests, 32 new tokens each, ``fronts[i]`` the
    frontend of request i: for vlm phase 5's requests (64-704 tokens),
    for audio prompts of ``PHASE10_AUDIO_BLOCKS`` blocks (64-384 tokens);
    requests 0, 3, 4 and 7 sample (fixed seeds)."""
    import numpy as np
    from repro_torch.serve import Request, SamplingParams
    if cfg.family == "vlm":
        reqs = phase5_requests(cfg, np.random.RandomState(SEED + 5))[0]
        return [dataclasses.replace(r, frontend=f)
                for r, f in zip(reqs, fronts)]
    rng = np.random.RandomState(SEED + 10)
    bs = cfg.kv_block_size
    return [Request(seq_id=i, prompt=rng.randint(0, cfg.vocab_size, n * bs),
                    frontend=fronts[i], max_new_tokens=32,
                    sampling=(SamplingParams(seed=SEED + 100 + i, **SAMPLED)
                              if i in (0, 3, 4, 7) else SamplingParams()))
            for i, n in enumerate(PHASE10_AUDIO_BLOCKS)]


def admission_profile(torch, eng, cfg, dims, rng):
    """One 256-token request's chunk 0 (the recompute prefill, with its
    frontend) under the profiler: device ms by kernel; for audio also the
    encoder alone on the same frames (its device ms and share of the
    step's)."""
    from repro_torch.models import FwdOptions
    from repro_torch.models.transformer import encoder
    from repro_torch.serve import Request
    front = random_frontend(cfg, rng)
    eng.submit(Request(seq_id=210, prompt=rng.randint(0, cfg.vocab_size,
                                                      256),
                       max_new_tokens=2, frontend=front))
    n_log = len(eng.admission_log)
    rows = profile_cold(torch, eng.step, tries=1)  # an admission runs once
    recs = eng.admission_log[n_log:]
    if [r.path for r in recs] != ["recompute"]:
        raise AssertionError(f"the profiled step admitted {recs}")
    while eng.has_unfinished():
        eng.step()
    busy = sum(ms for _, ms, _ in rows)
    out = dict(device_busy_ms=round(busy, 3), kernels=len(rows),
               top=[dict(kernel=name[:90], ms=round(ms, 4), launches=n)
                    for name, ms, n in rows[:6]])
    if cfg.family == "audio":
        frames = torch.from_numpy(front)[None].to(eng.device)
        opt = FwdOptions(attn_impl=eng.config.attn_impl, dtype=torch.bfloat16)
        enc = sum(ms for _, ms, _ in profile_device(
            torch, lambda: encoder(eng.params, frames, cfg, dims, opt), 1))
        out.update(encoder_device_ms=round(enc, 3),
                   encoder_share=round(enc / busy, 4) if busy else None)
    return out


def cross_decode_ms(torch, eng, cfg, dims):
    """Device ms of a decode step's cross-attention sublayers (every
    layer, B = max_batch rows) over the engine's installed cross rows,
    beside the bound of reading the rows once."""
    from repro_torch.models.transformer import layer_params
    from repro_torch.serve.decode import decode_cross
    gen = torch.Generator(device=eng.device).manual_seed(SEED + 10)
    x = torch.randn((eng.max_batch, cfg.d_model), generator=gen,
                    device=eng.device).to(torch.bfloat16)
    ck, cv = eng.dstate["cross_k"], eng.dstate["cross_v"]

    def run():
        for i in range(cfg.num_layers):
            decode_cross(layer_params(eng.params, i), x, ck[i], cv[i], cfg,
                         dims)

    rows = profile_device(torch, run, 3)
    return dict(device_ms=round(sum(ms for _, ms, _ in rows), 4),
                kernels=int(round(sum(n for _, _, n in rows))),
                bound_ms=round((ck.nbytes + cv.nbytes) / HBM_BYTES_PER_S
                               * 1e3, 4),
                cross_rows_mb=round((ck.nbytes + cv.nbytes) / 1e6, 1))


def audio_preempts(torch, dev, cfg, params, requests, engine_kw, clean,
                   label):
    """Phase 10 (b)'s forced preemptions of decode-live rows, after the
    clean run's last admission step (so that every prompt meets the
    clean run's prefill buckets): each resume must put back, byte for
    byte, the pool blocks and the ``cross_k``/``cross_v`` rows its
    preemption saved, and the streams must be the clean run's."""
    from repro_torch.runtime import ServeFaultInjector
    from repro_torch.serve import Engine, EngineConfig
    last = max(i + 1 for i, st in enumerate(clean["steps"]) if st[1])
    schedule = dict(preempt_at=[(last + 2, "post", "auto"),
                                (last + 5, "pre", "auto"),
                                (last + 9, "post", "auto")])
    inj = ServeFaultInjector(**schedule)
    eng = Engine(cfg, params, EngineConfig(
        dtype=torch.bfloat16, fault_injector=inj, **engine_kw), device=dev)
    preempt, resume = eng.preempt_request, eng._resume_preempted
    saved, swap = {}, {"preempt_ms": [], "resume_ms": [], "round_trips": 0}

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    def timed_preempt(sid):
        _, ms = sync_ms(torch, preempt, sid)
        swap["preempt_ms"].append(round(ms, 3))
        rec = eng._preempted[sid]
        if sorted(rec.rows) != ["cross_k", "cross_v"]:
            raise AssertionError(f"{label}: the host tier holds "
                                 f"{sorted(rec.rows)}")
        saved[sid] = (list(rec.blocks), rec.kv, dict(rec.rows))

    def timed_resume(req, reserved, busy):
        ok, ms = sync_ms(torch, resume, req, reserved, busy)
        if ok:
            swap["resume_ms"].append(round(ms, 3))
            blocks, kv, rows = saved.pop(req.seq_id)
            idx = torch.tensor([eng.manager.lookup(req.seq_id, b)[0]
                                for b, _ in blocks], device=dev)
            back = torch.stack([eng.dstate["k_pool"][:, idx],
                                eng.dstate["v_pool"][:, idx]]).cpu()
            slot = eng._slot_of[req.seq_id]
            if not torch.equal(bits(back), bits(kv)) or not all(
                    torch.equal(bits(eng.dstate[k][:, slot].cpu()),
                                bits(row)) for k, row in rows.items()):
                raise AssertionError(
                    f"{label}: request {req.seq_id}'s resumed blocks or "
                    "cross rows differ from the bytes its preemption saved")
            swap["round_trips"] += 1
        return ok

    eng.preempt_request, eng._resume_preempted = timed_preempt, timed_resume
    _kernel_counts(reset=True)
    streams, steps = serve(eng, requests(),
                           each_step=lambda e: e.check_invariants())
    launches = _kernel_counts()
    ov = eng.stats()["overload"]
    if (ov["request_preempts"] <= 0 or swap["round_trips"]
            != ov["request_preempts"] or saved
            or ov["swap_bytes_in"] != ov["swap_bytes_out"]):
        raise AssertionError(f"{label}: preemptions {ov}, round trips "
                             f"{swap['round_trips']}")
    if streams != clean["streams"]:
        raise AssertionError(f"{label}: the preempted run's streams "
                             "differ from the clean run's")
    return dict(schedule=schedule, overload=ov, injector_log=inj.log,
                steps=len(steps), streams_sha256=stream_digest(streams),
                **swap), launches


def full_width_frontend(torch, dev, name, label):
    """Phase 10 (a) or (b): ``name`` at its published width and depth,
    bf16, seeded random weights (nonzero qkv biases for whisper) and
    frontends, on phase 5's engine (whisper's context 448): the defaults
    with the paged prefix read, then ``spec_decode="ngram"`` (K = 4),
    then recompute prefill with ``attn_impl="pallas"``, and for whisper
    forced preemptions (``audio_preempts``); each run's launches from 0.
    Fails unless the translation, the decode read and the Q > 1 prefix
    read launch in the first run, the per-query verify read in the
    second, flash attention in the third (at D = 256 for paligemma; on
    the 1500 x 1500 non-causal encoder and the S x 1500 cross-attention
    for whisper), every stream holds 32 in-vocab tokens, every spec-on
    stream equals its spec-off stream (a request admitted in other
    prefill buckets is reported too), and the prefix cache is off.
    Prints weights and peak GiB, a steady decode and verify step's wall
    and device ms, kernels, idle share and top kernels, a prefix-KV and a
    recompute admission step's profile (the encoder's share for
    whisper), the decode step's cross-attention device ms (whisper),
    tokens/s, launches and ``streams_sha256``.  Returns the launches of
    all runs summed."""
    import numpy as np
    import repro_torch.serve.decode as dmod
    audio = name == PHASE10_AUDIO
    probed = set(dmod.verify_gemm_probes())
    cfg, dims, params = served_model(torch, dev, name, torch.bfloat16,
                                     seed=SEED + 10)
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    kw = dict(PHASE5, max_seq_len=PHASE10_AUDIO_CTX) if audio else PHASE5
    frng = np.random.RandomState(SEED + 10)
    fronts = [random_frontend(cfg, frng) for _ in range(8)]

    def requests():
        return phase10_requests(cfg, fronts)

    def after(run, eng):
        probe = run == "on" and (
            lambda e: decode_row_dependence(torch, e, cfg))
        r = {"steady": steady_step(torch, eng, cfg, probe or None, top=10,
                                   prompt_len=320 if audio else 512)}
        if run == "off":
            rng = np.random.RandomState(SEED + 10)
            profile_prefix_step(torch, eng, rng, cfg,
                                prompt_len=384 if audio else 512)
            r["admission"] = admission_profile(torch, eng, cfg, dims, rng)
            if audio:
                r["cross_decode"] = cross_decode_ms(torch, eng, cfg, dims)
            pc = eng.stats()["prefix_cache"]
            r["prefix_cache"] = dict(enabled=pc["enabled"],
                                     reason=eng._prefix_cache_unsupported())
        return r

    runs = spec_pair(torch, dev, cfg, params, requests, kw, label,
                     after=after)
    on, off = runs["on"], runs["off"]
    calls = []
    flash = engine_runs(
        torch, dev, cfg, params, {"flash_recompute": (dict(
            kw, attn_impl="pallas", prefill_mode="recompute"), None)},
        requests, label, wrap=lambda _: attention_calls(calls))[
        "flash_recompute"]
    flash["engine"] = None
    need = {"off": ("utopia_translate_step", "paged_attention",
                    "paged_attention_q_gt1"),
            "on": ("paged_attention_q_per_query",),
            "flash_recompute": ("flash_attention",)}
    for run, r in (("off", off), ("on", on), ("flash_recompute", flash)):
        for k in need[run]:
            if r["launches"][k] <= 0:
                raise AssertionError(f"{label}: {k} was never launched in "
                                     f"the {run} run")
    flashed = [c for c in calls if c[6] in ("pallas", "flash")]
    want = ([lambda c: c[4] == 256 and c[5]] if not audio else
            [lambda c: c[0] == c[1] == cfg.frontend_tokens and not c[5],
             lambda c: c[1] == cfg.frontend_tokens != c[0] and not c[5]])
    for w in want:
        if not any(w(c) for c in flashed):
            raise AssertionError(f"{label}: flash attention missed a "
                                 f"shape; it ran {sorted(set(flashed))}")
    pc = off["after"]["prefix_cache"]
    if pc["enabled"]:
        raise AssertionError(f"{label}: the prefix cache is on")
    launches = {k: off["launches"][k] + on["launches"][k]
                + flash["launches"][k] for k in off["launches"]}
    preempt = None
    if audio:
        preempt, pl = audio_preempts(torch, dev, cfg, params, requests, kw,
                                     off, label)
        launches = {k: launches[k] + pl[k] for k in launches}
    # spec-on = spec-off is the verify step's contract, held on every
    # request.  A request the two runs admitted in other prefill buckets
    # is reported (a bf16 chunk forward rounds otherwise at another
    # bucket shape, ROADMAP Queue 3) and held all the same
    def buckets(run, sid):
        return [b[1:] for b in buckets_of(run["margins"], run["steps"], sid)]

    other = {sid: dict(off=buckets(off, sid), on=buckets(on, sid),
                       stream_equal=on["streams"][sid] == off["streams"][sid])
             for sid in sorted(off["streams"])
             if buckets(on, sid) != buckets(off, sid)}
    diverged = spec_divergence(on, off)
    # the weights (shape, strides) whose verify GEMM runs per position
    per_position = sorted({str(k[:2]) for k, v in
                           dmod.verify_gemm_probes().items()
                           if not v and k not in probed})
    summary = dict(
        weights_gib=round(weights_gib, 3),
        steps={"off": len(off["steps"]), "on": len(on["steps"]),
               "flash_recompute": len(flash["steps"])},
        decode_step_ms_median={"decode": decode_step_ms(off),
                               "verify": decode_step_ms(on)},
        tokens_per_s={"off": round(tokens_per_s(off), 2),
                      "on": round(tokens_per_s(on), 2),
                      "flash_recompute": round(tokens_per_s(flash), 2)},
        gpu_mem_peak_gib={"off": round(off["peak_gib"], 3),
                          "on": round(on["peak_gib"], 3),
                          "flash_recompute": round(flash["peak_gib"], 3)},
        steady_b4={"decode": off["after"]["steady"],
                   "verify": on["after"]["steady"]},
        admission=off["after"]["admission"],
        spec_drafted=on["stats"]["spec_drafted"],
        spec_accepted=on["stats"]["spec_accepted"],
        prefix_cache=pc,
        rsw_hits=int(off["stats"].get("rsw_hits", 0)),
        flex_walks=int(off["stats"].get("flex_walks", 0)),
        flash_shapes=sorted(set(flashed)),
        streams_flash_equal_paged=sum(
            flash["streams"][sid] == off["streams"][sid]
            for sid in off["streams"]),
        streams_sha256={"off": stream_digest(off["streams"]),
                        "on": stream_digest(on["streams"]),
                        "flash_recompute": stream_digest(flash["streams"])},
        streams_on_equal_off=len(off["streams"]) - len(diverged),
        diverged=diverged, admitted_otherwise=other,
        verify_gemms_per_position=per_position,
        decode_rows=on["after"]["steady"].pop("probe"),
        launches={"off": off["launches"], "on": on["launches"],
                  "flash_recompute": flash["launches"]})
    if audio:
        summary.update(cross_decode=off["after"]["cross_decode"],
                       preempt=preempt)
    log(f"{label}: {name} full width and depth, bf16, Engine("
        + ", ".join(f"{k}={v!r}" for k, v in kw.items())
        + f"), spec_decode=None then 'ngram' (K={PHASE7_K}), then "
        "attn_impl='pallas', prefill_mode='recompute'"
        + (", then forced preemptions" if audio else "") + ": "
        + json.dumps({cfg.family: summary}))
    if diverged:
        raise AssertionError(f"{label}: {len(diverged)} of "
                             f"{len(off['streams'])} bf16 spec-on streams "
                             "differ from spec-off")
    del runs, on, off, flash, params
    return launches


def frontend_card_vs_cpu(torch, dev):
    """Phase 10 (c): float32, card = CPU, on the default admission path
    with the paged prefix read, for paligemma-3b and whisper-medium at a
    reduced width (``PHASE10_CPU``: d 512, d_ff 2048, 2 layers; the
    configs' heads, head dims, vocabularies and frontends): 4 greedy
    requests of 64-256 tokens with random frontends, 8 new each; streams,
    admission logs and translation stats identical."""
    import numpy as np
    for name, over in PHASE10_CPU.items():
        cfg, _, params = served_model(torch, dev, name, torch.float32,
                                      device="cpu", seed=SEED + 10,
                                      overrides=over)
        rng = np.random.RandomState(SEED + 10)
        prompts = [rng.randint(0, cfg.vocab_size, n)
                   for n in (64, 256, 128, 192)]
        fronts = [random_frontend(cfg, rng) for _ in prompts]
        card_vs_cpu(torch, dev, (cfg, params), prompts, 8, name,
                    strict=True, frontends=fronts, max_batch=4,
                    max_seq_len=(PHASE10_AUDIO_CTX if cfg.family == "audio"
                                 else 640),
                    prefill_budget=256, prefill_mode="prefix_kv",
                    prefix_gather="paged", prefix_cache="auto")


def frontends(torch, dev, results):
    """Phase 10: the kernels at both models' geometries (into
    ``results``), (c), then (a) and (b).  Returns {path: launches}."""
    geo = geometry_reads(
        torch, dev, heads=((8, 1, 256), (16, 16, 64)),
        flash=((2, 512, 512, 8, 1, 256, True),
               (2, 1500, 1500, 16, 16, 64, False),
               (2, 256, 1500, 16, 16, 64, False)),
        label="phase 10")
    for model, tag in (("paligemma", "H8_KV1_D256"),
                       ("whisper", "H16_KV16_D64")):
        results.setdefault("paged_attention", {})[f"{model}_{tag}"] = {
            k: geo[f"paged_{k}_{tag}"] for k in ("decode", "verify",
                                                   "prefix")}
    fl = results.setdefault("flash_attention", {})
    fl["paligemma_B2_S512_H8_KV1_D256"] = geo["flash_B2_S512_H8_KV1_D256"]
    fl["whisper_encoder_B2_S1500_H16_KV16_D64"] = geo[
        "flash_B2_S1500_H16_KV16_D64_full"]
    fl["whisper_cross_B2_S256_Skv1500_H16_KV16_D64"] = geo[
        "flash_B2_S256_H16_KV16_Skv1500_D64_full"]
    gc.collect()
    torch.cuda.empty_cache()
    frontend_card_vs_cpu(torch, dev)
    paths = {}
    for path, name in (("phase10a", PHASE10_VLM),
                       ("phase10b", PHASE10_AUDIO)):
        gc.collect()
        torch.cuda.empty_cache()
        paths[path] = full_width_frontend(
            torch, dev, name, f"phase 10 ({path[-1]})")
    return paths


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
    busy = admission_ms = sum(ms for _, ms, _ in rows)
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
    return admission_ms


def decode_profile(torch, dev):
    """Phase 4's decode-step profile alone (``--decode-profile``): the same
    engine and weights, so that another commit's port (``--src``) can be
    profiled in the same call."""
    import numpy as np
    from repro_torch.serve import Engine, EngineConfig
    cfg, _, params = served_model(torch, dev, "granite-8b", torch.bfloat16,
                                  seed=SEED)
    eng = Engine(cfg, params, EngineConfig(
        max_batch=4, max_seq_len=1024, auto_release=True,
        dtype=torch.bfloat16, **EARLIER_PATH), device=dev)
    profile_decode_step(torch, eng, np.random.RandomState(SEED), cfg)


# phase 11: the paper's translation comparison (Figs. 18-20) on the
# translation tables of a full granite-8b KV pool on one H100: a 64-token
# block holds 36 layers x 2 x 8 KV heads x 128 x 2 B x 64 = 9.44 MB, so
# ~58 GB of KV holds 6,144 slots (576 sets of 8 ways and 1,536 flexible)
PHASE11 = dict(
    hybrid=dict(total_slots=6144, restseg_fraction=0.75, assoc=8,
                max_seqs=64, max_blocks_per_seq=128),
    seqs=64, blocks=72, accesses=1 << 20, zipf_a=1.2, batch=8192,
    radix=dict(num_levels=4, fanout=16), ech=dict(capacity=256, n_tables=4),
    pom=dict(entries=2048, ways=16))
RSW_BACKENDS = ("utopia", "utopia_radix")    # backends that walk the RSW


def zipf_block_stream(n_seqs, blocks_per_seq, n_accesses, a=1.2, seed=0):
    """(seq, block) access stream with zipfian block popularity (the
    recipe of ``benchmarks/common.py``)."""
    import numpy as np
    rng = np.random.Generator(np.random.Philox(seed))
    seqs = rng.integers(0, n_seqs, n_accesses)
    blocks = (rng.zipf(a, n_accesses) - 1) % blocks_per_seq
    return np.stack([seqs, blocks], axis=1)


def translation_setup(hash_name="modulo"):
    """Phase 11's mapping, as ``benchmarks/bench_translation.py:_setup``
    builds it: each sequence's blocks allocated in the manager and mapped,
    at the slot the manager gave them, in a radix tree and an elastic
    cuckoo table; a Zipf stream of (seq, block) accesses; a POM-TLB
    smaller than the mapping, filled with the stream's first half.
    Returns (manager, radix builder, ECH table, POM-TLB, vpns int32)."""
    import numpy as np
    from repro_torch.core import (POMTLB, ElasticCuckooTable, HybridConfig,
                                  HybridKVManager, RadixBuilder)
    o = PHASE11
    cfg = HybridConfig(hash_name=hash_name, **o["hybrid"])
    m = HybridKVManager(cfg)
    radix = RadixBuilder(**o["radix"])
    ech = ElasticCuckooTable(**o["ech"])
    pom = POMTLB(**o["pom"])
    for s in range(o["seqs"]):
        m.register_sequence(s)
        for b in range(o["blocks"]):
            info = m.allocate_block(s, b)
            vpn = cfg.vpn(m.seq_slot(s), b)
            radix.map(vpn, info.slot)
            ech.insert(vpn, info.slot)
    stream = zipf_block_stream(o["seqs"], o["blocks"], o["accesses"],
                               a=o["zipf_a"], seed=SEED)
    vpns = (stream[:, 0] * cfg.max_blocks_per_seq
            + stream[:, 1]).astype(np.int32)
    slots = {v: info.slot for v, info in m.blocks.items()}
    for v in vpns[:len(vpns) // 2].tolist():
        pom.lookup_fill(v, slots.get(v, -1))
    return m, radix, ech, pom, vpns


def translation_backends(m, radix, ech, pom, device):
    """The five backends of the comparison, and Utopia's RSW in front of
    the radix walk, each as ``fn(vpns)`` over tables on ``device``."""
    from repro_torch.core import (translate, translate_ech, translate_pom,
                                  translate_radix)
    ts, rtab = m.device_state(device), radix.device_table(device)
    est, pst = ech.device_state(device), pom.device_state(device)
    mbps = m.cfg.max_blocks_per_seq
    return {"utopia": lambda v: translate(ts, v),
            "flat": lambda v: ts.flex.lookup_vpn(v, mbps),
            "radix": lambda v: translate_radix(None, rtab, v),
            "utopia_radix": lambda v: translate_radix(ts.rest, rtab, v,
                                                      ts.hash_name),
            "ech": lambda v: translate_ech(est, v),
            "pom_tlb": lambda v: translate_pom(pst, rtab, v)}


def translation_out_of_range(torch, dev):
    """``translate`` on the card gives the CPU plain run's (the JAX
    package's 2-D flex read) on ``_rsw_out_of_range``'s vpns at every
    hash, one kernel launch a call.  Returns how many of those vpns the
    decode step's flat read would resolve otherwise."""
    from repro_torch.core import (FlexTable, RestSegState, TranslationState,
                                  translate)
    from repro_torch.kernels.utopia_rsw.ops import utopia_rsw
    from repro_torch.kernels.utopia_rsw.ref import rsw_ref
    differ = {}
    for h in HASHES:
        q, tar, sf, flex = (torch.from_numpy(a) for a in _rsw_out_of_range(h))
        mbps = 32                       # _rsw_out_of_range's geometry

        def state(d):
            t = tar.to(d)
            return TranslationState(
                rest=RestSegState(tar=t, sf=sf.to(d),
                                  meta=torch.zeros_like(t)),
                flex=FlexTable(table=flex.view(-1, mbps).to(d)),
                rest_base=torch.zeros((), dtype=torch.int32, device=d),
                max_blocks_per_seq=mbps, hash_name=h)

        want = translate(state("cpu"), q)
        before = utopia_rsw.launches
        got = translate(state(dev), q.to(dev))
        if utopia_rsw.launches - before != 1:
            raise AssertionError(f"phase 11: translate[{h}] launched "
                                 f"{utopia_rsw.launches - before} kernels")
        for f, g, w in zip(want._fields, got, want):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"phase 11: translate[{h}] {f} differs "
                                     "card vs CPU on out-of-range vpns")
        flat = rsw_ref(q, tar, sf, flex, hash_name=h)[0]
        differ[h] = int((flat != want.slot).sum())
    return differ


def translation(torch, dev, results):
    """Phase 11 (``--translation``): the paper's comparison of Utopia's
    hybrid translation with a flat block table, a 4-level radix walk,
    elastic cuckoo hashing and a POM-TLB, on ``PHASE11``'s mapping and its
    2^20-access Zipf stream in batches of 8,192 vpns.  On the card every
    backend's integer outputs must equal the CPU plain run's on every
    batch, ``translate`` must launch the RSW kernel's vpn-list entry once
    a call (the baselines none), give the CPU's answer on out-of-range
    vpns at every hash, and agree with the decode step's translation
    telemetry.  Prints accesses and bytes a translation, device and wall
    µs a batch, the RSW hit share, table sizes, and times the vpn-list
    entry at 8,192 vpns.  Returns the path's launch counts."""
    from repro_torch.core import SWAP, structure_bytes, translate
    from repro_torch.kernels.utopia_rsw.ops import (utopia_rsw,
                                                    utopia_translate_step)
    from repro_torch.kernels.utopia_rsw.ref import rsw_ref
    o = PHASE11
    t_phase = time.perf_counter()
    m, radix, ech, pom, vpns = translation_setup()
    cfg = m.cfg
    setup_s = time.perf_counter() - t_phase
    swapped = sum(1 for i in m.blocks.values() if i.seg == SWAP)
    geometry = ", ".join(f"{k}={v}" for k, v in o["hybrid"].items())
    log(f"phase 11 mapping: HybridConfig({geometry}) ({cfg.num_sets} sets "
        f"of {cfg.assoc} ways, {cfg.flex_slots} flexible slots), "
        f"{o['seqs']} sequences of {o['blocks']} blocks: "
        f"{len(m.blocks)} mapped, {swapped} swapped, manager stats "
        f"{json.dumps(dict(m.stats))}; radix {o['radix']} nodes a level "
        f"{[a.shape[0] for a in radix.levels]}; ECH {o['ech']} resized "
        f"{ech.resizes} times to capacity {ech.capacity}; POM-TLB "
        f"{o['pom']} filled with {len(vpns) // 2} accesses: {pom.hits} hits,"
        f" {pom.misses} misses; set up in {setup_s:.1f} s on the host")
    card = translation_backends(m, radix, ech, pom, dev)
    cpu = translation_backends(m, radix, ech, pom, "cpu")
    batches = torch.from_numpy(vpns).split(o["batch"])
    card_batches = torch.from_numpy(vpns).to(dev).split(o["batch"])

    for fn in card.values():               # first calls load and cache
        fn(card_batches[0])
    # the main path: every backend over the whole stream, counted
    _kernel_counts(reset=True)
    outs, walls = {}, {}
    for name, fn in card.items():
        before = utopia_rsw.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = [fn(b) for b in card_batches]
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) / len(batches) * 1e6
        launched = utopia_rsw.launches - before
        want = len(batches) if name in RSW_BACKENDS else 0
        if launched != want:
            raise AssertionError(f"phase 11: {name} launched the RSW kernel "
                                 f"{launched} times over {len(batches)} "
                                 f"calls (expected {want})")
    counts = _kernel_counts()

    # card = CPU plain run, every integer output on every batch
    summary = {}
    for name, fn in cpu.items():
        for i, (b, got) in enumerate(zip(batches, outs[name])):
            for k, (g, w) in enumerate(zip(got, fn(b))):
                if not torch.equal(g.cpu(), w):
                    raise AssertionError(f"phase 11: {name} output {k} "
                                         f"differs card vs CPU on batch {i}")
        rows = profile_device(torch, lambda fn=card[name]: fn(
            card_batches[0]), 5)
        res = outs[name]
        rec = dict(wall_us_per_batch=round(walls[name], 2),
                   device_us_per_batch=round(sum(
                       ms for _, ms, _ in rows) * 1e3, 3) if rows else None,
                   kernels_per_batch=round(sum(n for *_, n in rows), 2))
        if hasattr(res[0], "accesses"):
            acc = torch.cat([r.accesses for r in res]).double()
            byt = torch.cat([r.bytes_touched for r in res]).double()
            rec.update(accesses_per_translation=float(acc.mean()),
                       bytes_per_translation=float(byt.mean()))
        mapped = torch.cat([r[1] for r in res])
        rec["mapped_share"] = float(mapped.double().mean())
        summary[name] = rec
    summary["flat"].update(accesses_per_translation=1,
                           bytes_per_translation=8)
    uto = outs["utopia"]
    hit = float(torch.cat([r.in_rest for r in uto]).double().mean())
    u_slot = torch.cat([r.slot for r in uto])
    agree = {n: float((torch.cat([r[0] for r in outs[n]]) == u_slot)
                      .double().mean()) for n in ("radix", "ech", "pom_tlb")}
    reduction = 1 - (summary["utopia"]["accesses_per_translation"]
                     / summary["radix"]["accesses_per_translation"])

    # translate = the decode step's telemetry on the same vpns
    ts = m.device_state(dev)
    B, nblk = cfg.max_seqs, cfg.max_blocks_per_seq
    ctx = torch.full((B,), o["blocks"] * cfg.block_size - 1,
                     dtype=torch.int32, device=dev)
    step = utopia_translate_step(
        ts.rest.tar[None], ts.rest.sf[None], ts.flex.table.reshape(1, -1),
        ctx, block_size=cfg.block_size, nblk=nblk, hash_name=cfg.hash_name,
        sink=cfg.total_slots)
    tr = translate(ts, step.vpns.reshape(-1))
    for f, got, want in (("slots", step.slots, tr.slot),
                         ("in_rest", step.in_rest, tr.in_rest),
                         ("mapped", step.mapped, tr.mapped),
                         ("accesses", step.accesses, tr.accesses)):
        if not torch.equal(got[0].reshape(-1), want.to(got.dtype)):
            raise AssertionError(f"phase 11: translate's {f} differs from "
                                 "the decode step's telemetry")
    differ = translation_out_of_range(torch, dev)

    # the vpn-list entry at 8,192 vpns: kernel, plain version, bound
    tar, sf, flex = ts.rest.tar, ts.rest.sf, ts.flex.table.reshape(-1)
    kw = dict(hash_name=cfg.hash_name, max_blocks_per_seq=nblk)
    n = o["batch"]
    ins = card_batches[:8]
    err = max(int((g - w).abs().max()) for g, w in zip(
        utopia_rsw(ins[0], tar, sf, flex, **kw),
        rsw_ref(ins[0], tar, sf, flex, **kw)))
    # each call's vpns read and 16 B a vpn written, and the tables as
    # this batch's data needs them; averaged over the timed batches
    cpu_tables = [t.cpu() for t in (tar, sf, flex)]
    nbytes = sum(20 * b.numel() + _rsw_table_bytes(
        torch, b.cpu(), *cpu_tables, cfg.hash_name, nblk)
        for b in ins) / len(ins)
    results["utopia_rsw_vpn_list"] = dict(
        vpns=n, max_abs_err=err,
        ms=round(time_ms(torch, [lambda b=b: utopia_rsw(b, tar, sf, flex,
                                                        **kw)
                                 for b in ins]), 5),
        device_ms=device_ms(torch, lambda: utopia_rsw(ins[0], tar, sf, flex,
                                                      **kw), 20,
                            symbols=("rsw_kernel",)),
        plain_ms=round(time_ms(torch, [lambda b=b: rsw_ref(b, tar, sf, flex,
                                                           **kw)
                                       for b in ins]), 5),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None)
    sizes = dict(utopia_tar_sf=structure_bytes(ts.rest),
                 flat_table=cfg.max_seqs * nblk * 4,
                 radix=radix.table_bytes(), ech=ech.table_bytes(),
                 pom_tlb=pom.table_bytes())
    log("phase 11: the paper's translation comparison, "
        f"{len(vpns)} Zipf (a = {o['zipf_a']}) accesses in batches of "
        f"{o['batch']}; card = CPU on every batch for every backend; "
        "translate launched the RSW kernel once a call; device us and "
        "kernels a batch from the profiler (the baselines are eager torch, "
        "so their wall time counts launches): "
        + json.dumps({"translation": dict(
            backends=summary, utopia_rsw_hit_share=hit,
            utopia_access_reduction_vs_radix=reduction,
            slots_equal_to_utopia=agree, table_bytes=sizes,
            out_of_range_vpns_the_flat_read_resolves_otherwise=differ,
            vpn_list_entry=results["utopia_rsw_vpn_list"],
            launches=counts,
            phase_s=round(time.perf_counter() - t_phase, 1))}))
    return counts


# ---------------------------------------------------------------- phase 12
#
# Sharded serving (DESIGN.md §sharded-serving): (a) a (1, 1) mesh over NCCL
# in this process on phase 5's engine and requests, (b) a (1, 2) mesh as
# two processes on the one card over gloo (NCCL refuses two ranks on one
# device), held bitwise to a mesh_shape=None run of the same configuration

PHASE12_B = dict(PHASE5, spec_decode="ngram", num_draft_tokens=PHASE7_K)
PHASE12_PREEMPT = [(14, "post", "auto")]   # a forced preemption in (b)
# (b)'s depth, cut from granite-8b's 36: at full depth each rank stages
# 604 MB of gathers a decode step through gloo (0.79 s a step on an H100
# at 700 W), and the phase took 119 s, over its 90 s
PHASE12_LAYERS = 12
PHASE12_TIMEOUT_S = 300                    # a collective never joined fails
MESH_CHILD_TAG = "phase 12 (b) rank: "


def _shard_case(torch, dev, M):
    """Phase 2's engine-geometry tables (``_step_case``, the modulo hash)
    as M ranks hold them: each rank's slices of the padded mirrors, and
    the partition.  Returns (slices, ctx, active, part, tables)."""
    from repro_torch.core.partition import Partition
    B, nblk, bs, slots, frac = STEP_GEOMETRIES["engine"]
    tables, n_sets = _step_case(torch, dev, "modulo", B, nblk, bs, slots,
                                frac)
    tar, sf, flex, ctx, active = tables
    part = Partition(n_shards=M, n_sets=n_sets, assoc=8,
                     rest_slots=n_sets * 8, flex_slots=slots - n_sets * 8,
                     vpn_space=B * nblk)
    spm, vpm = part.sets_per_shard, part.vpns_per_shard
    pad = dict(device=dev, dtype=torch.int32)
    tar_p = torch.zeros((1, part.n_sets_padded, 8), **pad)
    sf_p = torch.zeros((1, part.n_sets_padded), **pad)
    flex_p = torch.full((1, part.vpn_padded), -1, **pad)
    tar_p[:, :n_sets], sf_p[:, :n_sets] = tar, sf
    flex_p[:, :flex.shape[1]] = flex
    slices = [(tar_p[:, m * spm:(m + 1) * spm].contiguous(),
               sf_p[:, m * spm:(m + 1) * spm].contiguous(),
               flex_p[:, m * vpm:(m + 1) * vpm].contiguous())
              for m in range(M)]
    return slices, ctx, active, part, tables


def check_translate_shard(torch, dev, results):
    """The RSW kernel's sharded step at the engine's geometry (B = 4, nblk
    = 16, 80 slots, the modulo hash), as M = 1, 2 and 4 ranks hold the
    tables: each rank's shard entry (``utopia_translate_shard``) equal to
    its plain version, and the bound translation (``shard_translator``:
    the shard entry, the sum over the ranks, the combine) equal to
    ``combine_shard_ref`` in every field and to the unsharded step's in
    every field but the write rows, at windows 1 and 5 (the verify's),
    with and without the active mask.  Then, at M = 2, the two entries'
    device time beside an empty kernel's and their bytes bound."""
    from repro_torch.kernels.utopia_rsw.ops import (empty_launch,
                                                    shard_translator,
                                                    utopia_translate_shard)
    from repro_torch.kernels.utopia_rsw.ref import (StepTranslation,
                                                    combine_shard_ref,
                                                    translate_shard_ref,
                                                    translate_step_ref)
    B, nblk, bs, slots, _ = STEP_GEOMETRIES["engine"]
    n = B * nblk
    timed = None
    for M in (1, 2, 4):
        slices, ctx, active, part, (tar, sf, flex, _, _) = _shard_case(
            torch, dev, M)
        geom = dict(batch=B, nblk=nblk, hash_name="modulo", part=part)
        contribs = []
        for m, sl in enumerate(slices):
            got = utopia_translate_shard(*sl, m=m, **geom)
            want = translate_shard_ref(*(t.cpu() for t in sl), m=m, **geom)
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"translate_shard[M={M}, m={m}]: "
                                     "differs from the plain version")
            contribs.append(got)
        total = sum(contribs)
        for window in (1, 5):
            for act in (None, active):
                ref = translate_step_ref(tar, sf, flex, ctx, act,
                                         block_size=bs, nblk=nblk,
                                         hash_name="modulo", sink=slots,
                                         window=window)
                for m, sl in enumerate(slices):
                    fn = shard_translator(
                        *sl, ctx, part=part, m=m,
                        reduce=lambda c: c.copy_(total), block_size=bs,
                        nblk=nblk, hash_name="modulo", window=window)
                    got = fn(*sl, ctx, act)
                    want = combine_shard_ref(
                        total.cpu(), ctx.cpu(),
                        None if act is None else act.cpu(), block_size=bs,
                        nblk=nblk, hash_name="modulo", part=part, m=m,
                        window=window)
                    for f in StepTranslation._fields:
                        a = getattr(got, f).cpu()
                        if not torch.equal(a, getattr(want, f)):
                            raise AssertionError(
                                f"shard_translator[M={M}, m={m}, W="
                                f"{window}]: {f} differs from the plain "
                                "version")
                        if f != "w_row" and not torch.equal(
                                a, getattr(ref, f).cpu()):
                            raise AssertionError(
                                f"shard_translator[M={M}, m={m}, W="
                                f"{window}]: {f} differs from the "
                                "unsharded step's")
                    if M == 2 and window == 1 and act is not None and m == 0:
                        timed = (fn, sl, ctx, act, part)
    fn, sl, ctx, act, part = timed
    n_sets_l = part.sets_per_shard
    # bytes of the two entries for this data: the rank's SF words, TAR rows
    # and flex entries of its slices (each once), the contributions written
    # and read back, ctx_len, the mask and the step's output
    from repro_torch.kernels.utopia_rsw.ref import step_words
    nbytes = (4 * n_sets_l + 4 * 8 * n_sets_l + 4 * part.vpns_per_shard
              + 2 * 16 * n + 4 * B + B + 4 * step_words(B, nblk))
    dev_us = {}
    for _ in range(3):               # the profiler can miss a tiny kernel
        rows = profile_device(torch, lambda: (fn(*sl, ctx, act),
                                              empty_launch(ctx)), 100)
        for key, sym in (("shard", "translate_shard_kernel"),
                         ("combine", "combine_shard_kernel"),
                         ("empty", "empty_kernel")):
            ms = [r[1] for r in rows if sym in r[0]]
            if ms:
                dev_us.setdefault(key, 1e3 * ms[0])
        if len(dev_us) == 3:
            break
    wall_ms = time_ms(torch, [lambda: fn(*sl, ctx, act)], 400)
    plain_ms = time_ms(torch, [lambda: combine_shard_ref(
        translate_shard_ref(*sl, m=0, batch=B, nblk=nblk, hash_name="modulo",
                            part=part) * 2, ctx, act, block_size=bs,
        nblk=nblk, hash_name="modulo", part=part, m=0)], 50)
    r = dict(device_us=dev_us.get("shard"),
             combine_device_us=dev_us.get("combine"),
             empty_device_us=dev_us.get("empty"), bytes=nbytes,
             bound_us=nbytes / HBM_BYTES_PER_S * 1e6, wall_us=1e3 * wall_ms,
             plain_us=1e3 * plain_ms)
    log("check translate_shard [B=4, nblk=16, 80 slots at M = 1, 2, 4; "
        "windows 1 and 5]: the shard entry exact against its plain version "
        "on every rank, the bound translation against combine_shard_ref "
        "and the unsharded step; at M = 2 (one rank's two launches, the "
        "sum in place): " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in r.items()}))
    results["utopia_translate_shard"] = r


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gather_bytes(cfg, dims, engine_kw, dtype_bytes=2):
    """Bytes the exact gathers of one decode step move on a rank: every
    attention layer assembles the B x nblk blocks of K and of V."""
    B = engine_kw["max_batch"]
    nblk = engine_kw["max_seq_len"] // cfg.kv_block_size
    per = B * nblk * cfg.kv_block_size * dims.n_kv * dims.head_dim
    return dict(k_per_layer=per * dtype_bytes, v_per_layer=per * dtype_bytes,
                per_step=2 * per * dtype_bytes * cfg.num_layers)


def _mesh_run(torch, eng, reqs, label):
    """Serve ``reqs`` on ``eng`` with ``check_invariants`` after each
    step, holding one shard-entry and one combine launch to every step
    that decoded (none to the others) on a mesh engine.  Returns (streams,
    steps, launches, wall s)."""
    from repro_torch.kernels.utopia_rsw.ops import utopia_translate_shard
    per_step = []
    last = [0, 0]

    def each(e):
        now = [utopia_translate_shard.launches,
               utopia_translate_shard.launches_combine]
        per_step.append((now[0] - last[0], now[1] - last[1]))
        last[:] = now
        e.check_invariants()

    _kernel_counts(reset=True)
    t0 = time.perf_counter()
    streams, steps = serve(eng, reqs, each_step=each)
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    if eng.mesh is not None:
        want = [(1, 1) if live else (0, 0) for _, _, live, _, _ in steps]
        if per_step != want:
            raise AssertionError(f"{label}: (shard, combine) launches per "
                                 f"step {per_step}, expected {want}")
        if launches["utopia_translate_step"]:
            raise AssertionError(f"{label}: the unsharded step entry "
                                 "launched on a mesh")
    return streams, steps, launches, wall


def mesh_child(torch, dev, rank, directory):
    """Phase 12 (b)'s rank (``--mesh-child RANK DIR``): join the gloo group
    of two (file rendezvous in DIR), draw (b)'s seeded weights, serve (b)'s
    requests on the (1, 2) mesh, profile a steady step, and print what it
    served."""
    import datetime
    import torch.distributed as dist
    from repro_torch.runtime import ServeFaultInjector
    from repro_torch.serve import Engine, EngineConfig
    t0 = time.perf_counter()
    dist.init_process_group(
        "gloo", init_method=f"file://{Path(directory) / 'rendezvous'}",
        world_size=2, rank=rank,
        timeout=datetime.timedelta(seconds=PHASE12_TIMEOUT_S))
    try:
        cfg, dims, params = served_model(torch, dev, "granite-8b",
                                         torch.bfloat16, seed=SEED,
                                         layers=PHASE12_LAYERS)
        eng = Engine(cfg, params, EngineConfig(
            dtype=torch.bfloat16, mesh_shape=(1, 2),
            fault_injector=ServeFaultInjector(preempt_at=PHASE12_PREEMPT),
            **PHASE12_B), device=dev)
        reqs = phase7_requests(cfg)
        streams, steps, launches, wall = _mesh_run(torch, eng, reqs,
                                                   f"phase 12 (b) rank {rank}")
        check_streams(reqs, streams, cfg.vocab_size)
        st = eng.stats()
        decode = [w for w, recs, live, _, _ in steps if live and not recs]
        steady = steady_step(torch, eng, cfg)
        print(MESH_CHILD_TAG + json.dumps(dict(
            rank=rank, streams=streams, launches=launches,
            steps=len(steps), wall_s=round(wall, 2),
            decode_step_ms_median=round(statistics.median(decode) * 1e3, 3),
            steady=steady, shards=st["shards"], overload=st["overload"],
            spec=[st["spec_drafted"], st["spec_accepted"]],
            total_s=round(time.perf_counter() - t0, 2))), flush=True)
    finally:
        dist.destroy_process_group()


def mesh_phase(torch, dev, cfg, dims, params, phase5_digest, src):
    """Phase 12: sharded serving.  (a) ``mesh_shape=(1, 1)`` over NCCL
    (world size 1, this process) on phase 5's engine and requests: the
    streams' digest must equal phase 5's.  (b) ``mesh_shape=(1, 2)`` as
    two processes on this card over gloo with CUDA tensors, granite-8b at
    full width (``PHASE12_LAYERS`` deep) with spec decoding and a forced
    preemption (``PHASE12_PREEMPT``): each rank's streams must be bitwise
    a ``mesh_shape=None`` run of the same configuration, run here.  Each
    decoding step must launch the shard entry and the combine once on
    each rank.  Prints per-step wall and device ms at (1, 1) and (1, 2)
    and the bytes each step's exact gathers move.  Returns the path's
    launch counts (both ranks' of (b) added)."""
    import datetime
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch.distributed as dist
    from repro_torch.runtime import ServeFaultInjector
    from repro_torch.serve import Engine, EngineConfig
    t_phase = time.perf_counter()
    # (a): (1, 1) over NCCL
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=PHASE12_TIMEOUT_S))
    try:
        eng = Engine(cfg, params, EngineConfig(
            dtype=torch.bfloat16, mesh_shape=(1, 1), **PHASE5), device=dev)
        reqs, *_ = phase5_requests(cfg, np.random.RandomState(SEED + 5))
        streams, steps, counts, wall = _mesh_run(torch, eng, reqs,
                                                 "phase 12 (a)")
        check_streams(reqs, streams, cfg.vocab_size)
        digest = stream_digest(streams)
        if digest != phase5_digest:
            raise AssertionError(f"phase 12 (a): streams {digest} differ "
                                 f"from phase 5's {phase5_digest}")
        decode = [w for w, recs, live, _, _ in steps if live and not recs]
        steady_a = steady_step(torch, eng, cfg)
        a = dict(steps=len(steps), wall_s=round(wall, 2),
                 decode_step_ms_median=round(statistics.median(decode) * 1e3,
                                             3),
                 steady=steady_a, streams_sha256=digest,
                 gather_bytes=_gather_bytes(cfg, dims, PHASE5),
                 launches=counts)
        del eng
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"phase 12 (a): granite-8b full width, {cfg.num_layers} layers, "
        "bf16, mesh_shape="
        "(1, 1) over NCCL on phase 5's engine and requests; streams equal "
        "phase 5's: " + json.dumps({"mesh_1x1": a}))
    # (b): (1, 2) in two processes, and its mesh_shape=None reference here
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase12_")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = []
    try:
        for r in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--mesh-child", str(r), tmp, "--src", str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env))
        # the ranks' weights: the same seeded draw at (b)'s depth
        rcfg, rparams = cfg, params
        if PHASE12_LAYERS != cfg.num_layers:
            rcfg, _, rparams = served_model(torch, dev, "granite-8b",
                                            torch.bfloat16, seed=SEED,
                                            layers=PHASE12_LAYERS)
        ref_eng = Engine(rcfg, rparams, EngineConfig(
            dtype=torch.bfloat16,
            fault_injector=ServeFaultInjector(preempt_at=PHASE12_PREEMPT),
            **PHASE12_B), device=dev)
        ref, ref_steps, _, ref_wall = _mesh_run(torch, ref_eng,
                                                phase7_requests(rcfg),
                                                "phase 12 (b) reference")
        ref_st = ref_eng.stats()
        ref_ov = ref_st["overload"]
        del ref_eng, rparams
        torch.cuda.empty_cache()
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    ranks = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = [x for x in out.splitlines() if x.startswith(MESH_CHILD_TAG)]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"phase 12 (b): rank {r} failed (exit "
                                 f"{p.returncode}):\n{out[-3000:]}\n"
                                 f"{err[-4000:]}")
        ranks.append(json.loads(lines[-1][len(MESH_CHILD_TAG):]))
    if ref_ov["preempted_seqs"] <= 0:
        raise AssertionError("phase 12 (b): the forced preemption did not "
                             "preempt")
    for r, got in enumerate(ranks):
        got_streams = {int(k): v for k, v in got["streams"].items()}
        if got_streams != ref:
            bad = sorted(k for k in ref if got_streams.get(k) != ref[k])
            raise AssertionError(f"phase 12 (b): rank {r}'s streams differ "
                                 f"from mesh_shape=None's on {bad}")
        if got["overload"] != ref_ov:
            raise AssertionError(f"phase 12 (b): rank {r}'s overload stats "
                                 f"{got['overload']} != {ref_ov}")
        for k in ("rsw_hits", "flex_walks"):
            if sum(sh[k] for sh in got["shards"]) != ref_st[k]:
                raise AssertionError(f"phase 12 (b): rank {r}'s per-shard "
                                     f"{k} do not sum to the global")
    for k, n in ranks[0]["launches"].items():
        counts[k] += n + ranks[1]["launches"][k]
    b = dict(layers=PHASE12_LAYERS, layers_cut=PHASE12_LAYERS != 36,
             reference_wall_s=round(ref_wall, 2),
             reference_steps=len(ref_steps),
             streams_sha256=stream_digest(ref),
             gather_bytes=_gather_bytes(rcfg, dims, PHASE12_B),
             ranks=[{k: v for k, v in g.items() if k != "streams"}
                    for g in ranks],
             phase_s=round(time.perf_counter() - t_phase, 2))
    log(f"phase 12 (b): granite-8b full width, {PHASE12_LAYERS} of 36 "
        f"layers (depth cut: {PHASE12_LAYERS != 36}), bf16, "
        "mesh_shape=(1, 2) as two processes on one card over "
        "gloo, spec on (K = 4), a forced preemption; each rank's streams "
        "equal mesh_shape=None's: " + json.dumps({"mesh_1x2": b}))
    for name in ("utopia_translate_shard", "utopia_combine_shard",
                 "paged_attention"):
        if counts[name] <= 0:
            raise AssertionError(f"phase 12: {name} was never launched")
    return counts


PHASE13 = dict(arch="granite-8b", layers=12, global_batch=8, seq_len=128,
               steps=20, lr=3e-4, warmup=5)
PHASE13_FAMILIES = ("granite-8b", "qwen3-moe-30b-a3b", "mamba2-130m",
                    "jamba-1.5-large-398b", "paligemma-3b", "whisper-medium")
PHASE13_TOL = 1e-4
# the attention K biases: their gradient is zero in exact arithmetic (a
# bias on K adds one constant to a query's scores, which the softmax
# drops), so each device's is rounding noise (~1e-9 against JAX's, tests/
# test_torch_train.py), which AdamW's normalisation turns into steps of
# +-lr; held to 2 lr a step instead of PHASE13_TOL
PHASE13_NOISE_LEAVES = ("attn.k.b", "cross.k.b")
# leaves drawn as zeros under Adafactor (jamba's conv_b and dt_bias) hold
# nothing but three of its updates, which scale each element's gradient
# by a factored second moment and so keep an element's rounding error
# where a far larger one sets the leaf's scale: jamba's conv_b differed by
# 1.26e-4 of its largest element after three steps on an H100, held to
# 3e-4; every other leaf drawn as zeros is held to PHASE13_TOL.  The
# witness that this is float32 rounding is the CPU's own: the same three
# steps from weights each nudged by one float32 ulp (``_ulp_nudged``)
PHASE13_ADAFACTOR_ZERO_INIT_TOL = 3e-4


def _recording(step_fn, torch, wall=None):
    """``step_fn`` that keeps its last returned state in ``.last`` (the
    loop returns only its report) and, with ``wall``, appends each step's
    ms between two device synchronisations."""
    def fn(state, batch):
        if wall is None:
            out = step_fn(state, batch)
        else:
            out, ms = sync_ms(torch, step_fn, state, batch)
            wall.append(ms)
        fn.last = out[0]
        return out
    return fn


def _n_params(tree):
    return sum(x.numel() for x in _leaves(tree))


def phase13_setup(torch, layers=None):
    """Phase 13 (a)'s training, ``layers`` deep (``PHASE13["layers"]`` by
    default): (published config, cut config, dims, TrainConfig,
    FwdOptions, data), the launcher's settings."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import FwdOptions, model_dims
    from repro_torch.train import TrainConfig
    o = PHASE13
    full = get_config(o["arch"])
    cfg = dataclasses.replace(full, num_layers=layers or o["layers"])
    dims = model_dims(cfg)
    tc = TrainConfig(lr=o["lr"], warmup_steps=o["warmup"],
                     total_steps=o["steps"], dtype=torch.float32,
                     microbatches=cfg.train_microbatches)
    fwd = FwdOptions(attn_impl="flash_jax", dtype=torch.float32,
                     remat=cfg.remat)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=o["seq_len"],
                                  global_batch=o["global_batch"], seed=0))
    return full, cfg, dims, tc, fwd, data


def train_full_width(torch, dev):
    """Phase 13 (a): granite-8b at full width, ``PHASE13["layers"]`` of
    its 36 layers, trained ``PHASE13["steps"]`` steps through
    ``ResilientLoop`` with the launcher's settings (float32 with TF32 off,
    ``flash_jax``, remat, AdamW, lr 3e-4 with 5 warmup steps, a global
    batch of 8 x 128 ``SyntheticLM`` tokens, seed 0); no checkpoint falls
    inside the window.  Then one more step under the profiler (device
    ms, idle share, kernels, the largest by device time) and the AdamW
    update alone (CUDA events and device ms beside its bytes bound)."""
    import math
    import tempfile
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.ckpt.checkpoint import tree_flatten, tree_unflatten
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import ResilientLoop
    from repro_torch.train import init_state, make_train_step
    o = PHASE13
    full, cfg, dims, tc, fwd, data = phase13_setup(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(torch.Generator(dev).manual_seed(SEED), cfg, dims,
                       tc, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = _n_params(state["params"])
    n_layers = _n_params(state["params"]["layers"])
    log(f"phase 13 (a): {cfg.name} at full width (d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}) cut to {cfg.num_layers} of {full.num_layers} "
        f"layers: AdamW in float32 holds params, grads, m and v at 16 B a "
        f"parameter, {16 * n / 1e9:.1f} GB at {cfg.num_layers} layers and "
        f"{16 * (n + n_layers * (full.num_layers / cfg.num_layers - 1)) / 1e9:.0f} "
        f"GB at {full.num_layers}; {n / 1e9:.3f} B parameters, "
        f"{n_layers / 1e9:.3f} B in the layers; drawn in {init_s:.1f} s")
    wall = []
    step_fn = make_train_step(cfg, dims, tc, fwd)
    timed = _recording(step_fn, torch, wall)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_phase13a_") as d:
        loop = ResilientLoop(CheckpointManager(d), data, timed,
                             ckpt_every=o["steps"] + 1)
        rep = loop.run(state, total_steps=o["steps"])
        saved = loop.ckpt.all_steps()
    peak = torch.cuda.max_memory_allocated()
    losses = rep.losses
    if saved or rep.steps_run != o["steps"]:
        raise AssertionError(f"phase 13 (a): {rep.steps_run} steps, "
                             f"checkpoints {saved}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"phase 13 (a): the losses are not finite and "
                             f"falling: {losses}")
    state = timed.last
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in data.batch_at(o["steps"]).items()}
    step_med = statistics.median(wall[1:])
    rows = profile_device(torch, lambda: step_fn(state, batch), 1)
    step_dev = sum(ms for _, ms, _ in rows) if rows else None
    if step_dev is not None and step_dev > max(wall[1:]):
        raise AssertionError(
            f"phase 13 (a): a step's device time {step_dev:.2f} ms exceeds "
            f"the slowest timed step's wall {max(wall[1:]):.2f} ms")
    tokens = o["global_batch"] * o["seq_len"]
    # the step's multiply-adds: 6 T over the layers' and the LM head's
    # parameters (forward and backward), 2 T over the layers' again
    # (remat's second forward; the head is outside the checkpointed
    # layers); the embedding lookup does none, and the attention scores
    # and mixing (4 S d a token and layer forward, 0.5% of a layer's at
    # S = 128) are left out
    head = state["params"].get("lm_head", state["params"]["embed"])
    n_head = _n_params(head)
    flops = (6 * (n_layers + n_head) + 2 * n_layers) * tokens
    # the AdamW update alone, on gradients of the parameters' shapes
    opt = make_optimizer(cfg.optimizer, weight_decay=tc.weight_decay)
    params = state["params"]
    with torch.no_grad():
        grads = tree_unflatten(params, [torch.randn_like(p) * 1e-3
                                        for p in tree_flatten(params)[0]])
    lr = torch.tensor(o["lr"], device=dev)

    def update():
        opt.update(grads, state["opt"], params, state["step"], lr)

    update_ms = time_ms(torch, [update], iters=3)
    update_dev = device_ms(torch, update, 1)
    update_bytes = 7 * 4 * n     # read g, p, m, v; write p, m, v
    del grads
    out = dict(
        layers=f"{cfg.num_layers} of {full.num_layers}", params=n,
        steps=rep.steps_run, loss_first=losses[0], loss_last=losses[-1],
        losses=[round(x, 4) for x in losses],
        step_wall_ms_median=round(step_med, 2),
        step_wall_ms_first=round(wall[0], 1),
        step_device_ms=None if step_dev is None else round(step_dev, 2),
        idle_share=None if step_dev is None else round(
            1 - step_dev / step_med, 3),
        step_kernels=round(sum(k for _, _, k in rows)),
        step_top_kernels=[[name[:70], round(ms, 2), round(k)]
                          for name, ms, k in rows[:8]],
        tokens_per_s=round(tokens / (step_med / 1e3), 1),
        flops_per_step=flops,
        flops_bound_ms=round(flops / PEAK_FLOPS["float32"] * 1e3, 1),
        peak_gb=round(peak / 1e9, 2),
        update_ms=round(update_ms, 2),
        update_device_ms=None if update_dev is None else round(update_dev,
                                                               2),
        update_bytes=update_bytes,
        update_bound_ms=round(update_bytes / HBM_BYTES_PER_S * 1e3, 2))
    log("phase 13 (a) granite-8b training: " + json.dumps(out))
    return out, losses


def train_replay(torch, dev):
    """Phase 13 (b): restart and replay on the card, the JAX test's
    scenario (``tests/test_train.py`` ``test_resilient_loop_restart_and_
    replay``): reduced granite-8b, 2 microbatches, int8 compression,
    remat, ``FaultInjector([17])``, checkpoints every 10 steps, 25 steps.
    The replayed losses of steps 10..16 must equal the first pass's
    bitwise.  Prints a checkpoint's MB and a blocking save's ms."""
    import os
    import shutil
    import tempfile
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import FwdOptions, model_dims
    from repro_torch.runtime import FaultInjector, ResilientLoop
    from repro_torch.train import TrainConfig, init_state, make_train_step
    cfg = reduced(get_config("granite-8b"))
    dims = model_dims(cfg)
    tc = TrainConfig(lr=1e-3, warmup_steps=5, total_steps=40,
                     microbatches=2, grad_compression=True,
                     dtype=torch.float32)
    state = init_state(torch.Generator(dev).manual_seed(SEED), cfg, dims,
                       tc, device=dev)
    step_fn = _recording(make_train_step(cfg, dims, tc, FwdOptions(
        dtype=torch.float32, remat=True)), torch)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8, seed=1))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase13b_")
    try:
        ckpt = CheckpointManager(tmp, keep_last=2)
        loop = ResilientLoop(ckpt, data, step_fn, ckpt_every=10,
                             injector=FaultInjector([17]))
        t0 = time.perf_counter()
        rep = loop.run(state, total_steps=25)
        run_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ckpt.save(25, step_fn.last, blocking=True)
        save_ms = (time.perf_counter() - t0) * 1e3
        d = os.path.join(tmp, "step_25")
        mb = sum(os.path.getsize(os.path.join(d, f))
                 for f in os.listdir(d)) / 1e6
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    L = rep.losses
    if not (rep.restarts == 1 and rep.final_step == 25
            and L[10:17] == L[17:24] and L[-1] < L[0]):
        raise AssertionError(f"phase 13 (b): restarts {rep.restarts}, "
                             f"final step {rep.final_step}, losses {L}")
    out = dict(restarts=rep.restarts, final_step=rep.final_step,
               steps_run=rep.steps_run, replay_bitwise=True,
               loss_first=L[0], loss_last=L[-1], run_s=round(run_s, 2),
               ckpt_mb=round(mb, 3), save_ms=round(save_ms, 1))
    log("phase 13 (b) restart and replay: " + json.dumps(out))
    return out


def _named_leaves(tree, prefix=""):
    """(dotted path, leaf) in ``tree_flatten``'s order (keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _leaf_errors(got, want):
    """Per leaf path, ``(max |got - want|, max |want|)`` (got on any
    device, want on the CPU)."""
    out = {}
    for (name, g), (_, w) in zip(_named_leaves(got), _named_leaves(want)):
        w = w.detach()
        out[name] = (float((g.detach().cpu() - w).abs().max()),
                     float(w.abs().max()))
    return out


def _ulp_nudged(torch, params, seed):
    """``params`` (float32, on the CPU) with each nonzero element moved one
    ulp up or down, the sign drawn from ``seed``: a perturbation of one
    rounding's size."""
    from repro_torch.ckpt.checkpoint import tree_flatten, tree_unflatten
    gen = torch.Generator().manual_seed(seed)
    out = []
    for p in tree_flatten(params)[0]:
        p = p.detach()
        inf = torch.full_like(p, float("inf"))
        up = torch.rand(p.shape, generator=gen) < 0.5
        out.append(torch.where(p == 0, p, torch.nextafter(
            p, torch.where(up, inf, -inf))))
    return tree_unflatten(params, out)


def train_card_vs_cpu(torch, dev, cpu_dev=None):
    """Phase 13 (c): for each of the six families at ``reduced``, three
    train steps in float32 from the same weights (drawn on the CPU, then
    copied) and the same batches on the card and on the CPU, with the
    config's optimizer and microbatches: the losses and every parameter
    leaf must agree to ``PHASE13_TOL`` relative (a leaf's largest error
    over its largest element), a leaf drawn as zeros under Adafactor to
    ``PHASE13_ADAFACTOR_ZERO_INIT_TOL``, the attention K biases
    (``PHASE13_NOISE_LEAVES``) to 2 lr a step.  Beside each error it
    prints what float32 rounding alone moves on the CPU: the same steps
    from weights nudged by one ulp (``_ulp_nudged``) against the CPU
    run."""
    from repro_torch.ckpt.checkpoint import tree_flatten, tree_unflatten
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import FwdOptions, model_dims
    from repro_torch.params import init_params
    from repro_torch.train import (TrainConfig, make_train_step,
                                   state_from_params)
    cpu = cpu_dev or torch.device("cpu")
    out = {}
    for name in PHASE13_FAMILIES:
        cfg = reduced(get_config(name))
        dims = model_dims(cfg)
        tc = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                         microbatches=cfg.train_microbatches,
                         dtype=torch.float32)
        params = init_params(torch.Generator().manual_seed(SEED + 13), cfg,
                             dims, device="cpu")
        zero_init = {k for k, p in _named_leaves(params) if not p.any()}
        runs = {}
        for label, d, p0 in (("card", dev, params), ("cpu", cpu, params),
                             ("cpu_ulp", cpu, _ulp_nudged(torch, params,
                                                          SEED + 13))):
            state = state_from_params(tree_unflatten(p0, [
                p.to(d, copy=True) for p in tree_flatten(p0)[0]]), cfg,
                tc)
            step = make_train_step(cfg, dims, tc, FwdOptions(
                dtype=torch.float32, remat=True))
            front = cfg.frontend_tokens if cfg.frontend != "none" else 0
            data = SyntheticLM(DataConfig(
                vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                seed=SEED + 13, frontend_tokens=front, d_model=cfg.d_model))
            losses = []
            for i in range(3):
                batch = {k: torch.as_tensor(v).to(d)
                         for k, v in data.batch_at(i).items()}
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            runs[label] = (losses, state["params"])
        (lc, pc), (lw, pw), (lu, pu) = (runs["card"], runs["cpu"],
                                        runs["cpu_ulp"])

        def split(got, losses):
            """(loss rel err, drawn leaves' rel errs, zero-init leaves'
            rel errs, K biases' abs errs) of ``got`` against the CPU's."""
            errs = _leaf_errors(got, pw)
            noise = {k: d for k, (d, m) in errs.items()
                     if k.endswith(PHASE13_NOISE_LEAVES)}
            rel = {k: d / max(m, 1e-30) for k, (d, m) in errs.items()
                   if k not in noise}
            return (max(abs(a - b) / abs(b) for a, b in zip(losses, lw)),
                    {k: e for k, e in rel.items() if k not in zero_init},
                    {k: e for k, e in rel.items() if k in zero_init}, noise)
        loss_err, drawn, zeros, noise = split(pc, lc)
        u_loss, u_drawn, u_zeros, u_noise = split(pu, lu)
        zero_tol = (PHASE13_ADAFACTOR_ZERO_INIT_TOL
                    if cfg.optimizer == "adafactor" else PHASE13_TOL)
        out[name] = dict(optimizer=cfg.optimizer,
                         microbatches=cfg.train_microbatches,
                         losses=lc, loss_rel_err=loss_err,
                         param_rel_err_max=max(drawn.values()),
                         worst_leaf=max(drawn, key=drawn.get),
                         zero_init_rel_err=zeros, zero_init_tol=zero_tol,
                         k_bias_abs_err=noise,
                         ulp_nudge=dict(
                             loss_rel_change=u_loss,
                             param_rel_change_max=max(u_drawn.values()),
                             zero_init_rel_change=u_zeros,
                             k_bias_abs_change=u_noise))
        if (loss_err > PHASE13_TOL or max(drawn.values()) > PHASE13_TOL
                or any(e > zero_tol for e in zeros.values())
                or any(d > 2 * tc.lr * 3 for d in noise.values())):
            raise AssertionError(f"phase 13 (c) {name}: card != CPU: "
                                 + json.dumps(out[name]))
    log(f"phase 13 (c) float32 card = CPU, 3 train steps, tolerance "
        f"{PHASE13_TOL} relative: " + json.dumps(out))
    return out


def train_launcher(torch, root):
    """Phase 13 (d): ``python -m repro_torch.launch.train --arch
    granite-8b --reduced --steps 10 --ckpt-dir <tmp>`` as a child process
    on the card, run from the port's ``src`` without ``PYTHONPATH`` (so
    that ``src/sitecustomize.py`` stays unread) and with ``-X
    importtime``: it must exit 0, print its ``done:`` line and import no
    module of JAX."""
    import os
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase13d_")
    try:
        cmd = [sys.executable, "-X", "importtime", "-m",
               "repro_torch.launch.train", "--arch", "granite-8b",
               "--reduced", "--steps", "10", "--ckpt-dir", tmp]
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=str(root), env=env,
                              capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    done = [x for x in proc.stdout.splitlines() if x.startswith("done: ")]
    jax_mods = [x for x in proc.stderr.splitlines()
                if x.startswith("import time:")
                and x.rsplit("|", 1)[-1].strip().split(".")[0] in ("jax",
                                                                   "repro")]
    if proc.returncode != 0 or not done or jax_mods:
        raise AssertionError(
            f"phase 13 (d): the launcher exited {proc.returncode}, JAX "
            f"imports {jax_mods[:3]}:\n{proc.stdout[-3000:]}\n"
            f"{proc.stderr[-3000:]}")
    log(f"phase 13 (d) {' '.join(cmd[3:])}: exit 0 in {secs:.1f} s, no "
        f"JAX module imported; " + " | ".join(proc.stdout.splitlines()))
    return dict(exit=0, seconds=round(secs, 1), done=done[0])


def training(torch, dev, src):
    """Phase 13: (a), (b), (c), then (d).  Returns the kernels' launch
    counts of (a)-(c), each from 0 (the training path launches none of
    the three kernels, as in the JAX package), and (a)'s losses."""
    t0 = time.perf_counter()
    _kernel_counts(reset=True)
    _, losses = train_full_width(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_replay(torch, dev)
    train_card_vs_cpu(torch, dev)
    counts = _kernel_counts()
    train_launcher(torch, src)
    log(f"phase 13: {time.perf_counter() - t0:.1f} s; launches "
        + json.dumps(counts))
    return counts, losses


# ---------------------------------------------------------------- phase 14
PHASE14_STEPS = 5              # (a): phase 13 (a)'s first steps
PHASE14_LAYERS = 2             # (b)'s depth over gloo (full width)
PHASE14_B_STEPS = 3
PHASE14_MESHES = ((1, 2), (2, 1))
PHASE14_TOL = 2e-4             # (b)'s losses against the single device's
# (b)'s gradient norms against the single device's, relative: AdamW and
# the clip hide a gradient off by a constant factor from the losses, the
# norm shows it; the two sum each gradient in another order, ~1e-7 of it
PHASE14_GNORM_RTOL = 1e-5
# (b)'s gathered parameters after the last step, each leaf's norm and its
# ramp-weighted sum (``_fingerprint``) against the single device's, as a
# share of the leaf's norm: the updates differ by their rounding, and a
# sign flip of AdamW's first update where a gradient element is ~0 moves
# an element by 2 lr; a block laid in the wrong place moves the ramp sum
# by a share of order 1
PHASE14_PARAM_RTOL = 1e-5
# (b)'s Megatron logits against the single-device forward's, relative to
# the largest: the row-parallel sums add two halves of each dot product
PHASE14_MEGATRON_TOL = 1e-4
PHASE14_TIMEOUT_S = 300        # a collective never joined fails
MESH_TRAIN_TAG = "phase 14 (b) rank: "


def _counted(mesh):
    """Wrap ``mesh``'s all-gather and all-reduce to count the bytes of the
    tensors each hands over (the gathered whole, the reduced tensor) and
    the calls; returns the tally dict."""
    tally = {"gather_calls": 0, "gather_bytes": 0, "reduce_calls": 0,
             "reduce_bytes": 0}
    gather, reduce = mesh.all_gather, mesh.all_reduce

    def all_gather(t, dim, axis="model"):
        out = gather(t, dim, axis)
        tally["gather_calls"] += 1
        tally["gather_bytes"] += out.numel() * out.element_size()
        return out

    def all_reduce(t, axis="model", **kw):
        tally["reduce_calls"] += 1
        tally["reduce_bytes"] += t.numel() * t.element_size()
        return reduce(t, axis, **kw)

    mesh.all_gather, mesh.all_reduce = all_gather, all_reduce
    return tally


def _mesh_state(torch, dev, mesh, cfg, dims, tc):
    """(specs, this rank's blocks, the state's bytes on this rank): the
    phase's seeded whole state, laid out by JAX's rules."""
    from repro_torch.dist.sharding import ShardingRules, shard_tree
    from repro_torch.train import abstract_state, init_state, state_shardings
    specs = state_shardings(abstract_state(cfg, dims, tc, torch.float32),
                            mesh, ShardingRules(
                                zero_params=cfg.zero_shard_params))
    state = shard_tree(init_state(torch.Generator(dev).manual_seed(SEED),
                                  cfg, dims, tc, device=dev), specs, mesh)
    nbytes = sum(x.numel() * x.element_size() for x in _leaves(state))
    return specs, state, nbytes


def _per_step(tally, steps):
    return {k: v // steps for k, v in tally.items()}


def _fingerprint(torch, leaves):
    """For each leaf (whole, in ``tree_flatten`` order): its norm, its sum
    weighted by a ramp from 0 to 1 over its flat index (a block in the
    wrong place moves it), and the ramp's norm, in float64."""
    out = []
    for x in leaves:
        x = x.detach().reshape(-1).double()
        ramp = torch.linspace(0, 1, x.numel(), dtype=torch.float64,
                              device=x.device)
        out.append([float(x.norm()), float(x @ ramp), float(ramp.norm())])
        del x, ramp
    return out


def _fingerprints_differ(got, want):
    """The leaves whose ``_fingerprint`` differs from ``want``'s by more
    than ``PHASE14_PARAM_RTOL`` of the leaf's norm (the ramp sum's
    difference weighed by the ramp's norm, its bound per unit of the
    parameters' difference)."""
    bad = []
    for i, ((n, r, rn), (wn, wr, _)) in enumerate(zip(got, want)):
        if abs(n - wn) > PHASE14_PARAM_RTOL * wn \
                or abs(r - wr) > PHASE14_PARAM_RTOL * wn * rn:
            bad.append(i)
    return bad if len(got) == len(want) else ["leaf count"]


def train_reference(torch, dev, steps, layers=None):
    """Phase 13 (a)'s training for ``steps`` steps on one device (its
    schedule, seed and batches): (the losses, each step's gradient norm,
    the parameters after the last step)."""
    import tempfile
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.runtime import ResilientLoop
    from repro_torch.train import init_state, make_train_step
    _, cfg, dims, tc, fwd, data = phase13_setup(torch, layers)
    state = init_state(torch.Generator(dev).manual_seed(SEED), cfg, dims,
                       tc, device=dev)
    inner, norms = make_train_step(cfg, dims, tc, fwd), []

    def step(state, batch):
        state, m = inner(state, batch)
        norms.append(float(m["grad_norm"]))
        step.last = state
        return state, m

    with tempfile.TemporaryDirectory(prefix="chip_smoke_phase14r_") as d:
        rep = ResilientLoop(CheckpointManager(d), data, step,
                            ckpt_every=steps + 1).run(state, steps)
    return rep.losses, norms, step.last["params"]


def mesh_train_one(torch, dev, ref_losses):
    """Phase 14 (a): the mesh step at ``(1, 1)`` over NCCL (world size 1,
    this process) on phase 13 (a)'s model, schedule, seed and batches,
    ``PHASE14_STEPS`` steps through ``ResilientLoop`` with a sharded
    ``CheckpointManager``: its gathers and reductions run on groups of one
    (counted), and its losses must equal phase 13 (a)'s first bitwise."""
    import datetime
    import tempfile
    import torch.distributed as dist
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime import ResilientLoop
    from repro_torch.train import make_train_step
    steps = PHASE14_STEPS
    full, cfg, dims, tc, fwd, data = phase13_setup(torch)
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=PHASE14_TIMEOUT_S))
    try:
        mesh = make_local_mesh(1, 1)
        torch.cuda.reset_peak_memory_stats()
        specs, state, nbytes = _mesh_state(torch, dev, mesh, cfg, dims, tc)
        tally = _counted(mesh)
        wall = []
        step_fn = _recording(make_train_step(cfg, dims, tc, fwd, mesh,
                                             specs=specs), torch, wall)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_phase14a_") as d:
            rep = ResilientLoop(CheckpointManager(d, mesh=mesh, specs=specs),
                                data, step_fn, ckpt_every=steps + 1).run(
                state, steps)
        peak = torch.cuda.max_memory_allocated()
        del state, step_fn
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    want = ref_losses[:steps]
    if rep.losses != want or not tally["gather_calls"] \
            or not tally["reduce_calls"]:
        raise AssertionError(f"phase 14 (a): losses {rep.losses} != phase "
                             f"13 (a)'s {want} bitwise, or no collective "
                             f"ran: {tally}")
    out = dict(layers=f"{cfg.num_layers} of {full.num_layers}",
               steps=steps, losses=rep.losses, bitwise=True,
               state_bytes=nbytes,
               step_wall_ms_median=round(statistics.median(wall[1:]), 2),
               step_wall_ms_first=round(wall[0], 1),
               collectives_per_step=_per_step(tally, steps),
               peak_gb=round(peak / 1e9, 2))
    log("phase 14 (a) mesh step at (1, 1) over NCCL, granite-8b full "
        "width: " + json.dumps(out))
    return out


def mesh_train_child(torch, dev, rank, directory, shape):
    """Phase 14 (b)'s rank (``--mesh-train-child RANK DIR D,M``): join the
    gloo group of two (file rendezvous in DIR), draw phase 13 (a)'s seeded
    state at ``PHASE14_LAYERS`` deep, keep its blocks, train
    ``PHASE14_B_STEPS`` steps and print what it measured, with each step's
    gradient norm and the ``_fingerprint`` of the parameters gathered after
    the last step.  At (1, 2) it
    first holds the Megatron forward, the whole weights' schedule, against
    the single-device forward on the first batch."""
    import datetime
    import torch.distributed as dist
    from repro_torch.dist.megatron import (make_megatron_forward,
                                           megatron_param_shardings)
    from repro_torch.ckpt.checkpoint import tree_flatten
    from repro_torch.dist.sharding import ShardingRules, shard_tree, whole_of
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import forward
    from repro_torch.params import init_params
    from repro_torch.train import make_train_step
    t0 = time.perf_counter()
    dist.init_process_group(
        "gloo", init_method=f"file://{Path(directory) / 'rendezvous'}",
        world_size=shape[0] * shape[1], rank=rank,
        timeout=datetime.timedelta(seconds=PHASE14_TIMEOUT_S))
    try:
        _kernel_counts(reset=True)
        mesh = make_local_mesh(*shape)
        _, cfg, dims, tc, fwd, data = phase13_setup(torch, PHASE14_LAYERS)
        out = dict(rank=rank, shape=list(shape))
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in data.batch_at(0).items()}
        if shape == (1, 2):
            params = init_params(torch.Generator(dev).manual_seed(SEED), cfg,
                                 dims, device=dev)
            with torch.no_grad():
                want, _, _ = forward(params, batch, cfg, dims, fwd)
                blocks = shard_tree(params, megatron_param_shardings(
                    params, mesh, ShardingRules()), mesh)
                del params
                got, _, _ = make_megatron_forward(
                    cfg, dims, mesh, attn_impl=fwd.attn_impl)(blocks, batch)
            err = float((got - want).abs().max() / want.abs().max())
            del blocks, got, want
            if err > PHASE14_MEGATRON_TOL:
                raise AssertionError(f"Megatron logits differ by {err} of "
                                     "the largest")
            out["megatron_logits_rel_err"] = err
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        specs, state, nbytes = _mesh_state(torch, dev, mesh, cfg, dims, tc)
        tally = _counted(mesh)
        step = make_train_step(cfg, dims, tc, fwd, mesh, specs=specs)
        losses, norms, wall = [], [], []
        for i in range(PHASE14_B_STEPS):
            batch = {k: torch.as_tensor(v).to(dev)
                     for k, v in data.batch_at(i).items()}
            (state, m), ms = sync_ms(torch, step, state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            wall.append(ms)
        out.update(losses=losses, grad_norms=norms, state_bytes=nbytes,
                   step_wall_ms=[round(w, 1) for w in wall],
                   collectives_per_step=_per_step(tally, PHASE14_B_STEPS),
                   peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2),
                   launches=_kernel_counts())
        with torch.no_grad():
            out["params"] = _fingerprint(torch, (
                whole_of(b, s, mesh) for b, s in zip(
                    tree_flatten(state["params"])[0],
                    tree_flatten(specs["params"])[0])))
        out["total_s"] = round(time.perf_counter() - t0, 1)
        print(MESH_TRAIN_TAG + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def mesh_train_two(torch, dev, src):
    """Phase 14 (b): ``PHASE14_MESHES`` in turn, each as two processes on
    this card over gloo (``--mesh-train-child``), granite-8b at full width
    cut to ``PHASE14_LAYERS``, float32, AdamW, ``PHASE14_B_STEPS`` steps:
    every rank's losses within ``PHASE14_TOL`` of a single-device run here
    (run first, alone on the card), its gradient norms within
    ``PHASE14_GNORM_RTOL`` and its gathered parameters' ``_fingerprint``
    within ``PHASE14_PARAM_RTOL``.  Returns the ranks' reports."""
    import os
    import shutil
    import tempfile
    ref, ref_norms, params = train_reference(torch, dev, PHASE14_B_STEPS,
                                             PHASE14_LAYERS)
    from repro_torch.ckpt.checkpoint import tree_flatten
    ref_params = _fingerprint(torch, tree_flatten(params)[0])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    reports = []
    for shape in PHASE14_MESHES:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_phase14b_")
        procs = []
        try:
            for r in range(shape[0] * shape[1]):
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--mesh-train-child", str(r), tmp,
                     f"{shape[0]},{shape[1]}", "--src", str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, env=env))
            outs = [p.communicate(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            shutil.rmtree(tmp, ignore_errors=True)
        for r, (p, (out, err)) in enumerate(zip(procs, outs)):
            lines = [x for x in out.splitlines()
                     if x.startswith(MESH_TRAIN_TAG)]
            if p.returncode != 0 or not lines:
                raise AssertionError(
                    f"phase 14 (b) {shape}: rank {r} failed (exit "
                    f"{p.returncode}):\n{out[-3000:]}\n{err[-4000:]}")
            got = json.loads(lines[-1][len(MESH_TRAIN_TAG):])
            diff = max(abs(a - b) for a, b in zip(got["losses"], ref))
            if len(got["losses"]) != len(ref) or diff > PHASE14_TOL:
                raise AssertionError(f"phase 14 (b) {shape}: rank {r}'s "
                                     f"losses {got['losses']} against the "
                                     f"single device's {ref}")
            gdiff = max(abs(a - b) / b
                        for a, b in zip(got["grad_norms"], ref_norms))
            if len(got["grad_norms"]) != len(ref_norms) \
                    or gdiff > PHASE14_GNORM_RTOL:
                raise AssertionError(
                    f"phase 14 (b) {shape}: rank {r}'s gradient norms "
                    f"{got['grad_norms']} against the single device's "
                    f"{ref_norms}")
            bad = _fingerprints_differ(got["params"], ref_params)
            if bad:
                raise AssertionError(
                    f"phase 14 (b) {shape}: rank {r}'s parameters after "
                    f"step {PHASE14_B_STEPS} differ from the single "
                    f"device's in leaves {bad}: {got['params']} against "
                    f"{ref_params}")
            got["loss_max_abs_diff"] = diff
            got["grad_norm_max_rel_diff"] = gdiff
            got["param_norm_max_rel_diff"] = max(
                abs(g[0] - w[0]) / w[0]
                for g, w in zip(got.pop("params"), ref_params))
            reports.append(got)
    log(f"phase 14 (b) granite-8b full width, {PHASE14_LAYERS} of 36 "
        f"layers (depth cut: {PHASE14_LAYERS != 36}), float32, AdamW, "
        f"{PHASE14_B_STEPS} steps, two processes on one card over gloo; "
        f"single-device losses {ref}, gradient norms {ref_norms}: "
        + json.dumps(reports))
    return reports


def mesh_train_launcher(torch, root):
    """Phase 14 (c): ``torchrun --nproc-per-node 2 -m
    repro_torch.launch.train --arch granite-8b --reduced --steps 4
    --data-mesh 1 --model-mesh 2`` as a child (torchrun as ``python -m
    torch.distributed.run --standalone``, from the port's ``src`` without
    ``PYTHONPATH``, every process with ``PYTHONPROFILEIMPORTTIME``): it
    must exit 0, print ``done:`` and import nothing of JAX."""
    import os
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase14c_")
    try:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
               "--arch", "granite-8b", "--reduced", "--steps", "4",
               "--data-mesh", "1", "--model-mesh", "2", "--ckpt-dir", tmp]
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPROFILEIMPORTTIME"] = "1"
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=str(root), env=env,
                              capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    done = [x for x in proc.stdout.splitlines() if "done: " in x]
    jax_mods = [x for x in proc.stderr.splitlines()
                if "import time:" in x
                and x.rsplit("|", 1)[-1].strip().split(".")[0] in ("jax",
                                                                   "repro")]
    if proc.returncode != 0 or not done or jax_mods:
        raise AssertionError(
            f"phase 14 (c): torchrun exited {proc.returncode}, JAX imports "
            f"{jax_mods[:3]}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    log(f"phase 14 (c) torchrun {' '.join(cmd[4:-2])}: exit 0 in "
        f"{secs:.1f} s, no JAX module imported; "
        + " | ".join(proc.stdout.splitlines()))
    return dict(exit=0, seconds=round(secs, 1), done=done[0])


def mesh_training(torch, dev, src, ref_losses=None):
    """Phase 14: (a), (b), then (c).  ``ref_losses``: phase 13 (a)'s (run
    here for ``PHASE14_STEPS`` steps when not given).  Returns the kernels'
    launch counts of (a) and (b)'s ranks, each from 0: none may launch."""
    t0 = time.perf_counter()
    if ref_losses is None:
        ref_losses = train_reference(torch, dev, PHASE14_STEPS)[0]
        gc.collect()
        torch.cuda.empty_cache()
    _kernel_counts(reset=True)
    mesh_train_one(torch, dev, ref_losses)
    counts = _kernel_counts()
    for got in mesh_train_two(torch, dev, src):
        for k, n in got["launches"].items():
            counts[k] += n
    mesh_train_launcher(torch, src)
    if any(counts.values()):
        raise AssertionError(f"phase 14: a kernel launched: {counts}")
    log(f"phase 14: {time.perf_counter() - t0:.1f} s; launches "
        + json.dumps(counts))
    return counts


# ------------------------------------------------------------- phase 15

PHASE15_MESH = (2, 2)                      # (data, model): 4 ranks, gloo
PHASE15_TIMEOUT_S = 300                    # a collective never joined fails
PHASE15_ARCH = "granite-8b"                # full width: d 4096, 32/8 heads
# (a): float32, 2 layers, batch mode, 4 prompts, 16 greedy steps
PHASE15_A = dict(layers=2, prompts=(100, 64, 37, 128), steps=16, tol=1e-4)
# (b): bf16, 12 layers, batch mode, 4 prompts of 256-1024 tokens, 32 steps
PHASE15_B = dict(layers=12, prompts=(1024, 256, 700, 512), steps=32)
# (c): bf16, 12 layers, striped mode, one row of a 131,072-token context
# (2,048 blocks of 64), 16 teacher-forced steps; its logits are held to
# a mesh=None step's within PHASE15_C_TOL of the largest |logit|: the
# combine adds four partial softmax sums in float32, and one bf16 ulp
# (2^-8 relative) of the attention output, moved in a few elements and
# carried through 12 layers, stays far inside this bound
PHASE15_C = dict(layers=12, context=131072, steps=16, tol=5e-2)
PHASE15_ASSOC = 8
TOKEN_SPLIT_TAG = "phase 15 rank: "


def _ts_group_tables(rows, nblk, n_sets, assoc, extra):
    """A data group's tables for ``rows`` rows of ``nblk`` blocks: local
    vpn v = r * nblk + j in the RestSeg (set v % n_sets, its next free
    way) for every other vpn while the set has room, the rest in the flex
    table at slots n_sets * assoc + k.  Returns (tar, sf, flex, slot of
    each vpn, the group's slots) as lists."""
    tar = [[0] * assoc for _ in range(n_sets)]
    sf = [0] * n_sets
    flex = [-1] * (rows * nblk)
    slot_of = []
    nxt = n_sets * assoc
    for v in range(rows * nblk):
        s = v % n_sets
        if v % 2 == 0 and sf[s] < assoc:
            tar[s][sf[s]] = v + 1
            slot_of.append(s * assoc + sf[s])
            sf[s] += 1
        else:
            flex[v] = nxt
            slot_of.append(nxt)
            nxt += 1
    return tar, sf, flex, slot_of, nxt + extra


def _ts_batch_case(cfg, sub):
    """The batch-mode geometry of (a) or (b): each group's tables, the
    mesh spec and the one-device spec whose flex table maps row r's block
    j to group g's slot + g * slots (g = r // rows)."""
    from repro_torch.serve.decode import DecodeSpec
    G, _ = PHASE15_MESH
    bs = cfg.kv_block_size
    B = len(sub["prompts"])
    rows = B // G
    nblk = -(-(max(sub["prompts"]) + sub["steps"] + 2) // bs)
    n_sets = 2
    tables = [_ts_group_tables(rows, nblk, n_sets, PHASE15_ASSOC, 0)
              for _ in range(G)]
    S = max(t[4] for t in tables)
    mesh_spec = DecodeSpec(block_size=bs, max_blocks_per_seq=nblk,
                           slots_per_group=S, n_sets=n_sets,
                           assoc=PHASE15_ASSOC)
    one_spec = DecodeSpec(block_size=bs, max_blocks_per_seq=nblk,
                          slots_per_group=G * S, n_sets=1,
                          assoc=PHASE15_ASSOC)
    one_flex = [-1] * (B * nblk)
    for r in range(B):
        g, rl = divmod(r, rows)
        for j in range(nblk):
            one_flex[r * nblk + j] = g * S + tables[g][3][rl * nblk + j]
    return dict(G=G, B=B, rows=rows, nblk=nblk, S=S, tables=tables,
                mesh_spec=mesh_spec, one_spec=one_spec, one_flex=one_flex)


def _ts_prompts(torch, cfg, sub, seed):
    """(tokens (B, S_pad) int32, lengths) of the sub-phase's prompts, from
    a seeded CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    bs = cfg.kv_block_size
    lens = list(sub["prompts"])
    pad = -(-max(lens) // bs) * bs
    toks = torch.randint(0, cfg.vocab_size, (len(lens), pad), generator=gen,
                         dtype=torch.int32)
    return toks, lens


def _profile_once(torch, fn):
    """(device ms by kernel of one call of ``fn``, its wall ms) from one
    profiler session, without the retries of ``profile_cold``: every rank
    of a mesh runs it at once, and a rank that ran the step again alone
    would wait for the others in its collectives."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            if us > 0:
                rows.append((e.key, us / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1]), wall


def ts_batch_run(torch, dev, cfg, dims, params, sub, case, seed, dtype,
                 mesh=None, check_translation=False, profile=False):
    """(a)/(b) on this rank of the mesh (``mesh``) or on one device: the
    token-split recompute prefill of the prompts with the flash kernel
    (``attn_impl="pallas"``), then ``sub["steps"]`` greedy steps fed their
    own tokens.  Returns the streams, each step's logits (the prefill's
    last logits first), and per step the wall ms between two device
    synchronisations.  With ``check_translation`` every step's RSW output
    (this rank's group) is held bitwise to its plain version on the
    CPU; with ``profile`` one more step runs under the profiler (its
    device ms, wall ms, idle share and kernels in ``profile``)."""
    from repro_torch.kernels.utopia_rsw.ref import translate_step_ref
    from repro_torch.models import FwdOptions
    from repro_torch.serve.decode import init_decode_state, make_serve_step
    from repro_torch.serve.prefill import make_prefill_step
    G, B, rows, nblk, S = (case[k] for k in ("G", "B", "rows", "nblk", "S"))
    bs = cfg.kv_block_size
    i32 = dict(dtype=torch.int32, device=dev)
    toks, lens = _ts_prompts(torch, cfg, sub, seed)
    nb_prompt = toks.shape[1] // bs
    fwd = FwdOptions(attn_impl="pallas", dtype=dtype)
    if mesh is None:
        spec = case["one_spec"]
        st = init_decode_state(cfg, dims, spec, B, 1, dtype, dev)
        flex = torch.tensor(case["one_flex"], **i32)
        st["flex"].copy_(flex[None])
        slot_of = lambda r, j: case["one_flex"][r * nblk + j]  # noqa: E731
    else:
        spec = case["mesh_spec"]
        g = mesh.data_index
        st = init_decode_state(cfg, dims, spec, B, G, dtype, dev, mesh=mesh)
        tar, sf, flex, slots_g, _ = case["tables"][g]
        st["tar"].copy_(torch.tensor([tar], **i32))
        st["sf"].copy_(torch.tensor([sf], **i32))
        st["flex"].copy_(torch.tensor([flex], **i32))
        slot_of = lambda r, j: case["tables"][r // rows][3][  # noqa: E731
            (r % rows) * nblk + j]
    slots = torch.tensor([[slot_of(r, j) if j * bs < lens[r] else -1
                           for j in range(nb_prompt)] for r in range(B)],
                         **i32)
    ctx = torch.tensor(lens, **i32)
    prefill = make_prefill_step(cfg, dims, spec, fwd, mesh=mesh)
    serve = make_serve_step(cfg, dims, spec, dtype, mesh=mesh)
    logits_all, walls = [], []
    torch.cuda.synchronize()
    last, st, stats = prefill(params, st, {"tokens": toks.to(dev)}, slots,
                              torch.arange(B, **i32), ctx, ctx - 1)
    logits_all.append(last.float().cpu())
    tok = stats["next_token"]
    streams = [[int(t)] for t in tok.tolist()]
    for _ in range(sub["steps"]):
        if check_translation:
            rsel = slice(None) if mesh is None else slice(
                mesh.data_index * rows, (mesh.data_index + 1) * rows)
            pos = st["ctx_len"][rsel].cpu()
            tabs = [st[k].cpu() for k in ("tar", "sf", "flex")]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, st, stats = serve(params, st, tok)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if check_translation and mesh is not None:
            split = (G, mesh.data_index, False, PHASE15_MESH[1],
                     mesh.model_index)
            want = translate_step_ref(*tabs, pos, block_size=bs, nblk=nblk,
                                      hash_name=spec.hash_name,
                                      sink=spec.slots_per_group,
                                      layout=split)
            for k in ("slots", "in_rest", "mapped", "accesses"):
                got = stats[k][mesh.data_index].cpu()
                if not torch.equal(got, getattr(want, k)[0]):
                    raise AssertionError(f"phase 15 (a): rank "
                                         f"{mesh.rank}'s {k} differ from "
                                         "the plain translation")
        logits_all.append(logits.float().cpu())
        tok = stats["next_token"]
        for r, t in enumerate(tok.tolist()):
            streams[r].append(int(t))
    out = dict(streams=streams, logits=logits_all, walls=walls)
    if profile:
        rows, wall = _profile_once(torch, lambda: serve(params, st, tok))
        busy = sum(ms for _, ms, _ in rows)
        out["profile"] = dict(
            device_ms=busy if rows else None, wall_ms=wall,
            idle_share=1 - busy / wall if rows else None,
            kernels=int(sum(n for _, _, n in rows)),
            top=[(k[:60], round(ms, 4), n) for k, ms, n in rows[:6]])
    return out


def _ts_striped_case(cfg):
    """(c)'s geometry: one row of ``context`` tokens; global block b on
    group b % G at local block b // G, whose local slot is its vpn's
    (RestSeg for the first three quarters, flex for the rest)."""
    from repro_torch.serve.decode import DecodeSpec
    G, _ = PHASE15_MESH
    bs = cfg.kv_block_size
    nglob = PHASE15_C["context"] // bs
    nloc = nglob // G
    rest = nloc * 3 // 4
    n_sets = rest // PHASE15_ASSOC
    tar = [[0] * PHASE15_ASSOC for _ in range(n_sets)]
    sf = [0] * n_sets
    flex = [-1] * nloc
    slot_of = []
    for v in range(nloc):
        if v < rest:
            s, w = v % n_sets, v // n_sets
            tar[s][w] = v + 1
            sf[s] += 1
            slot_of.append(s * PHASE15_ASSOC + w)
        else:
            flex[v] = v
            slot_of.append(v)
    mesh_spec = DecodeSpec(block_size=bs, max_blocks_per_seq=nloc,
                           slots_per_group=nloc, n_sets=n_sets,
                           assoc=PHASE15_ASSOC, mode="striped")
    one_spec = DecodeSpec(block_size=bs, max_blocks_per_seq=nglob,
                          slots_per_group=nglob, n_sets=1,
                          assoc=PHASE15_ASSOC)
    return dict(G=G, nglob=nglob, nloc=nloc, tables=(tar, sf, flex),
                slot_of=slot_of, mesh_spec=mesh_spec, one_spec=one_spec)


def _ts_block_kv(torch, dev, cfg, dims, layer, kv, seed):
    """Layer ``layer``'s K (kv 0) or V (kv 1) of every block of (c)'s
    context, (n_blocks, bs, KV, hd) bf16, from a generator on the card
    seeded by (seed, layer, kv): each rank and the one-device run draw the
    same numbers."""
    gen = torch.Generator(device=dev).manual_seed(seed + 2 * layer + kv)
    nglob = PHASE15_C["context"] // cfg.kv_block_size
    return torch.randn((nglob, cfg.kv_block_size, dims.n_kv, dims.head_dim),
                       generator=gen, device=dev, dtype=torch.bfloat16)


def ts_striped_run(torch, dev, cfg, dims, params, case, seed, mesh=None):
    """(c) on this rank (``mesh``) or on one device: the state written
    straight from seeded numbers (no prefill), then ``steps`` decode steps
    fed seeded tokens.  Returns each step's logits and wall ms."""
    from repro_torch.serve.decode import init_decode_state, make_serve_step
    G, nloc, nglob = case["G"], case["nloc"], case["nglob"]
    bs = cfg.kv_block_size
    i32 = dict(dtype=torch.int32, device=dev)
    if mesh is None:
        spec = case["one_spec"]
        st = init_decode_state(cfg, dims, spec, 1, 1, torch.bfloat16, dev)
        st["flex"].copy_(torch.arange(nglob, **i32)[None])
    else:
        spec = case["mesh_spec"]
        st = init_decode_state(cfg, dims, spec, 1, G, torch.bfloat16, dev,
                               mesh=mesh)
        tar, sf, flex = case["tables"]
        st["tar"].copy_(torch.tensor([tar], **i32))
        st["sf"].copy_(torch.tensor([sf], **i32))
        st["flex"].copy_(torch.tensor([flex], **i32))
        g, m = mesh.data_index, mesh.model_index
        bs_loc = bs // PHASE15_MESH[1]
        blocks = torch.arange(nloc, device=dev) * G + g
        local = torch.tensor(case["slot_of"], dtype=torch.long, device=dev)
    for layer in range(cfg.num_layers):
        for kv, name in enumerate(("k_pool", "v_pool")):
            whole = _ts_block_kv(torch, dev, cfg, dims, layer, kv, seed)
            if mesh is None:
                st[name][layer, :nglob] = whole
            else:
                st[name][layer, local] = whole[blocks, m * bs_loc:
                                               (m + 1) * bs_loc]
            del whole
    st["ctx_len"].fill_(PHASE15_C["context"] - PHASE15_C["steps"] - 4)
    gen = torch.Generator().manual_seed(seed + 99)
    feed = torch.randint(0, cfg.vocab_size, (PHASE15_C["steps"], 1),
                         generator=gen, dtype=torch.int32)
    serve = make_serve_step(cfg, dims, spec, torch.bfloat16, mesh=mesh)
    logits_all, walls = [], []
    for i in range(PHASE15_C["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, st, stats = serve(params, st, feed[i].to(dev))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        logits_all.append(logits.float().cpu())
    del st
    return dict(logits=logits_all, walls=walls)


def token_split_child(torch, dev, rank, directory):
    """Phase 15's rank (``--token-split-child RANK DIR``): join the gloo
    group of four (file rendezvous in DIR) as rank (r // 2, r % 2) of the
    (2, 2) mesh and run (a), (b) and (c) on its share, counting its
    launches (from 0), its gloo bytes and its peak memory; it saves what
    it served and printed to DIR/rankRANK.pt."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    t0 = time.perf_counter()
    world = PHASE15_MESH[0] * PHASE15_MESH[1]
    dist.init_process_group(
        "gloo", init_method=f"file://{Path(directory) / 'rendezvous'}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=PHASE15_TIMEOUT_S))
    out = {"rank": rank}
    try:
        mesh = make_local_mesh(*PHASE15_MESH)
        tally = _counted(mesh)
        torch.cuda.reset_peak_memory_stats()
        _kernel_counts(reset=True)
        # (a)
        cfg, dims, params = served_model(torch, dev, PHASE15_ARCH,
                                         torch.float32, seed=SEED + 15,
                                         layers=PHASE15_A["layers"])
        case = _ts_batch_case(cfg, PHASE15_A)
        a = ts_batch_run(torch, dev, cfg, dims, params, PHASE15_A, case,
                         SEED + 151, torch.float32, mesh,
                         check_translation=True)
        out["a"] = {k: a[k] for k in ("streams", "logits")}
        del params
        torch.cuda.empty_cache()
        # (b)
        cfg, dims, params = served_model(torch, dev, PHASE15_ARCH,
                                         torch.bfloat16, seed=SEED + 16,
                                         layers=PHASE15_B["layers"])
        case = _ts_batch_case(cfg, PHASE15_B)
        before = dict(tally)
        counts0 = _kernel_counts()
        b = ts_batch_run(torch, dev, cfg, dims, params, PHASE15_B, case,
                         SEED + 152, torch.bfloat16, mesh, profile=True)
        counts1 = _kernel_counts()
        steps = PHASE15_B["steps"] + 1          # and the profiled one
        out["b"] = dict(
            streams=b["streams"], logits=b["logits"],
            step_wall_ms=b["walls"],
            step_wall_ms_median=statistics.median(b["walls"][2:]),
            profile=b["profile"],
            launches={k: counts1[k] - counts0[k] for k in counts1},
            # the steps' collectives, the prefill's one gather spread
            # over them
            gloo_per_step={k: (tally[k] - before[k]) / steps
                           for k in tally})
        del b
        # (c)
        case_c = _ts_striped_case(cfg)
        c = ts_striped_run(torch, dev, cfg, dims, params, case_c,
                           SEED + 153, mesh)
        out["c"] = dict(logits=c["logits"], step_wall_ms=c["walls"])
        out["launches"] = _kernel_counts()
        out["gloo_bytes"] = dict(tally)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["total_s"] = time.perf_counter() - t0
    finally:
        torch.save(out, Path(directory) / f"rank{rank}.pt")
        dist.destroy_process_group()
    print(TOKEN_SPLIT_TAG + json.dumps({"rank": rank,
                                        "total_s": out.get("total_s")}),
          flush=True)


def check_token_split_kernels(torch, dev, results):
    """The two kernels at phase 15's token-split geometries, against their
    plain versions and bounds: the RSW step entry with the group layout
    ((G, TP) = (2, 2) batch and striped, (4, 1) striped, (1, 4) batch;
    bitwise, one launch a call), timed at (b)'s geometry (2 rows of 18
    blocks, rank (0, 1)); the paged read of a token shard (``bs / TP =
    32`` of granite-8b's 64-token blocks at offset 32, 2 rows, bf16) and
    of a striped rank (1,024 local blocks of a 131,072-token row,
    ``block_tokens = 128``, offset 32), each within 3e-2 of its plain
    version, timed beside its bytes bound."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.kernels.utopia_rsw.ops import (
        translate_step_translator, utopia_translate_step)
    from repro_torch.kernels.utopia_rsw.ref import (step_words,
                                                    translate_step_ref)
    gen = torch.Generator().manual_seed(SEED + 150)
    bs, nblk, n_sets, assoc = 64, 18, 2, PHASE15_ASSOC

    def tables(rows):
        tar, sf, flex, _, S = _ts_group_tables(rows, nblk, n_sets, assoc, 0)
        i32 = dict(dtype=torch.int32, device=dev)
        return (torch.tensor([tar], **i32), torch.tensor([sf], **i32),
                torch.tensor([flex], **i32), S)

    for G, TP, striped in ((2, 2, False), (2, 2, True), (4, 1, True),
                           (1, 4, False)):
        for g in range(G):
            for m in range(TP):
                tar, sf, flex, S = tables(2)
                hi = (G if striped else 1) * nblk * bs + 70
                pos = torch.randint(0, hi, (2,), generator=gen,
                                    dtype=torch.int32).to(dev)
                kw = dict(block_size=bs, nblk=nblk, hash_name="modulo",
                          sink=S, layout=(G, g, striped, TP, m))
                n0 = utopia_translate_step.launches_group
                got = utopia_translate_step(tar, sf, flex, pos, **kw)
                want = translate_step_ref(tar, sf, flex, pos, **kw)
                if not torch.equal(got.out, want.out):
                    raise AssertionError(f"translate_step layout {kw['layout']}"
                                         ": differs from the plain version")
                if G * TP > 1 and utopia_translate_step.launches_group != \
                        n0 + 1:
                    raise AssertionError("translate_step: a group layout's "
                                         "launch went uncounted")
    tar, sf, flex, S = tables(2)
    pos = torch.tensor([1040, 290], dtype=torch.int32, device=dev)
    kw = dict(block_size=bs, nblk=nblk, hash_name="modulo", sink=S,
              layout=(2, 0, False, 2, 1))
    bound = translate_step_translator(tar, sf, flex, pos, **kw)  # as a step
    fn = [lambda: bound(tar, sf, flex, pos)]
    per_call = launches_per_call(torch, fn[0])
    if per_call != 1:
        raise AssertionError(f"translate_step (token split): {per_call} "
                             "device kernels per call, expected 1")
    nbytes = _step_bytes(torch, (tar, sf, flex, pos, pos), nblk, "modulo")
    results["utopia_translate_step_group"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, fn, 400),
        device_ms=device_ms(torch, fn[0], 100, ("translate_step_kernel",)),
        plain_ms=time_ms(torch, [lambda: translate_step_ref(
            tar, sf, flex, pos, **kw)], 50),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, bytes=nbytes, words=step_words(2, nblk),
        shape=f"2 rows x {nblk} blocks, layout (G, g, striped, TP, m) = "
              "(2, 0, False, 2, 1)")
    log("check translate_step group layouts: bitwise the plain version at "
        "(2, 2) batch and striped, (4, 1) striped, (1, 4) batch, one launch "
        "a call; " + json.dumps(results["utopia_translate_step_group"]))

    H, KV, D = 32, 8, 128
    reads = {}
    for name, (B, nb, ctx, off, bt) in {
            "token_split_read": (2, nblk, [1040, 290], 32, 64),
            "striped_read": (1, 1024, [PHASE15_C["context"] - 19], 32, 128),
    }.items():
        L = 4 if name == "striped_read" else 8
        kp = torch.randn((L, nb + 1, 32, KV, D), generator=gen).to(
            dev, torch.bfloat16)
        vp = torch.randn((L, nb + 1, 32, KV, D), generator=gen).to(
            dev, torch.bfloat16)
        slots = torch.stack([torch.randperm(nb, generator=gen)
                             for _ in range(B)]).to(dev, torch.int32)
        q = torch.randn((B, H, D), generator=gen).to(dev, torch.bfloat16)
        ext = torch.tensor(ctx, dtype=torch.int32, device=dev)
        geo = dict(tok_offset=off, block_tokens=bt)
        got = paged_attention(q, kp[0], vp[0], slots, ext, **geo)
        want = paged_attention_ref(q, kp[0], vp[0], slots, ext, **geo)
        err = max(check_close(f"paged_attention[{name}]", g, w, 3e-2)
                  for g, w in zip(got, want))
        kern = [lambda i=i: paged_attention(q, kp[i], vp[i], slots, ext,
                                            **geo) for i in range(L)]
        # the tokens below each row's extent that this rank holds
        n_tok = sum(sum(min(32, max(0, e - (j * bt + off)))
                        for j in range(nb)) for e in ctx)
        nbytes = (q.numel() * 2 + 2 * n_tok * KV * D * 2 + slots.numel() * 4
                  + B * 4 + B * H * D * 4 + 2 * B * H * 4)
        flops = 4 * D * H * n_tok
        reads[name] = dict(
            max_abs_err=err, ms=time_ms(torch, kern, 40),
            device_ms=device_ms(torch, kern[0], 20, ("paged_attn_kernel",)),
            plain_ms=time_ms(torch, [lambda: paged_attention_ref(
                q, kp[0], vp[0], slots, ext, **geo)], 4),
            bound_ms=max(nbytes / HBM_BYTES_PER_S,
                         flops / PEAK_FLOPS["bfloat16"]) * 1e3,
            bound_by=_bound_by(nbytes, flops), library_ms=None,
            bytes=nbytes, ctas=_grid_ctas(B, 1, H, KV, D, nb),
            shape=f"B={B} H={H} KV={KV} D={D} pool bs=32 nblk={nb} "
                  f"tok_offset={off} block_tokens={bt} ctx={ctx} bf16")
        del kp, vp
        log(f"check paged_attention [{name}]: within 3e-2 of the plain "
            "version; " + json.dumps(reads[name]))
    results["paged_attention_token_split"] = reads
    torch.cuda.empty_cache()


def _margin(logits_row):
    top = logits_row.float().topk(2).values
    return float(top[0] - top[1])


def _serve_cli(torch, root, mesh):
    """Phase 15 (d): ``python -m repro_torch.launch.serve --arch
    granite-8b --requests 8 --max-new 16`` on the card as a child process,
    and with ``--data 1 --model 2`` under torchrun (two ranks on one card:
    gloo); each must exit 0 and print its run and translation lines."""
    import os
    cmd = ["-m", "repro_torch.launch.serve", "--arch", "granite-8b",
           "--requests", "8", "--max-new", "16"]
    if mesh:
        cmd = ["-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2"] + cmd + ["--data", "1", "--model",
                                                 "2"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable] + cmd, cwd=str(root), env=env,
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if (proc.returncode != 0 or not any("engine steps" in x for x in lines)
            or not any(x.startswith("translation:") for x in lines)):
        raise AssertionError(
            f"phase 15 (d): {' '.join(cmd)} exited {proc.returncode}:\n"
            f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return dict(cmd=" ".join(cmd), exit=0, seconds=round(secs, 1),
                lines=lines[:3])


def token_split(torch, dev, src, results):
    """Phase 15: the token-split layout over a (2, 2) mesh, four
    processes on this card over gloo (``--token-split-child``), granite-8b
    at full width (64-token blocks, 32 tokens a rank).  The kernels first
    (``check_token_split_kernels``); then the ranks run (a), (b) and (c)
    while this process runs each on one device (``mesh=None``) with the
    same weights and inputs: (a) float32, 2 layers, batch mode, the
    recompute prefill with the flash kernel then 16 greedy steps: every
    step's logits within ``PHASE15_A["tol"]`` of the largest |logit|,
    every stream equal, and each rank's translation bitwise its plain
    version; (b) bf16, 12 layers, batch mode, prompts of 256-1024 tokens,
    32 steps: streams against mesh=None (agreement, and the top-2 margin
    where a row first differs), each rank's step wall and device ms, idle
    share, launches and gloo bytes a step; (c) bf16, 12 layers, striped
    mode, one row of 131,072 tokens written straight into the pools, 16
    teacher-forced steps held to mesh=None within ``PHASE15_C["tol"]``;
    peak memory a rank; (d) the serve CLI alone and at ``--data 1 --model
    2`` under torchrun.  Returns the ranks' launch counts, added."""
    import os
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    check_token_split_kernels(torch, dev, results)
    world = PHASE15_MESH[0] * PHASE15_MESH[1]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase15_")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs, ranks = [], []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--token-split-child", str(r), tmp, "--src", str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env))
        ref = {}
        cfg, dims, params = served_model(torch, dev, PHASE15_ARCH,
                                         torch.float32, seed=SEED + 15,
                                         layers=PHASE15_A["layers"])
        ref["a"] = ts_batch_run(torch, dev, cfg, dims, params, PHASE15_A,
                                _ts_batch_case(cfg, PHASE15_A),
                                SEED + 151, torch.float32)
        del params
        torch.cuda.empty_cache()
        cfg, dims, params = served_model(torch, dev, PHASE15_ARCH,
                                         torch.bfloat16, seed=SEED + 16,
                                         layers=PHASE15_B["layers"])
        ref["b"] = ts_batch_run(torch, dev, cfg, dims, params, PHASE15_B,
                                _ts_batch_case(cfg, PHASE15_B),
                                SEED + 152, torch.bfloat16, profile=True)
        torch.cuda.reset_peak_memory_stats()
        ref["c"] = ts_striped_run(torch, dev, cfg, dims, params,
                                  _ts_striped_case(cfg), SEED + 153)
        ref_peak = torch.cuda.max_memory_allocated() / 1e9
        del params
        torch.cuda.empty_cache()
        outs = [p.communicate(timeout=900) for p in procs]
        for r, (p, (out, err)) in enumerate(zip(procs, outs)):
            path = Path(tmp) / f"rank{r}.pt"
            got = torch.load(path, weights_only=False) if path.exists() \
                else {}
            if p.returncode != 0 or "total_s" not in got:
                raise AssertionError(f"phase 15: rank {r} failed (exit "
                                     f"{p.returncode}):\n{out[-2000:]}\n"
                                     f"{err[-4000:]}")
            ranks.append(got)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    report = {}
    # (a)
    errs = []
    for r, got in enumerate(ranks):
        if got["a"]["streams"] != ref["a"]["streams"]:
            raise AssertionError(f"phase 15 (a): rank {r}'s streams differ "
                                 "from mesh=None's")
        for i, (g, w) in enumerate(zip(got["a"]["logits"],
                                       ref["a"]["logits"])):
            e = float((g - w).abs().max()) / float(w.abs().max())
            errs.append(e)
            if e > PHASE15_A["tol"]:
                raise AssertionError(f"phase 15 (a): rank {r}'s logits at "
                                     f"step {i} differ by {e:.3g} of the "
                                     "largest |logit|")
    report["a"] = dict(max_rel_err=max(errs),
                       streams_sha256=stream_digest(dict(enumerate(
                           ref["a"]["streams"]))))
    # (b)
    want = ref["b"]["streams"]
    for r, got in enumerate(ranks[1:], 1):
        if got["b"]["streams"] != ranks[0]["b"]["streams"]:
            raise AssertionError(f"phase 15 (b): rank {r}'s streams differ "
                                 "from rank 0's")
    got = ranks[0]["b"]["streams"]
    div = []
    for row, (g, w) in enumerate(zip(got, want)):
        at = next((i for i, (x, y) in enumerate(zip(g, w)) if x != y), None)
        if at is not None:
            div.append(dict(row=row, step=at, margin=_margin(
                ref["b"]["logits"][at][row])))
    report["b"] = dict(
        rows_equal=sum(g == w for g, w in zip(got, want)), rows=len(want),
        divergences=div,
        streams_sha256=stream_digest(dict(enumerate(got))),
        reference_step_wall_ms_median=statistics.median(
            ref["b"]["walls"][2:]),
        reference_profile=ref["b"]["profile"],
        ranks=[dict(rank=g["rank"],
                    step_wall_ms_median=g["b"]["step_wall_ms_median"],
                    profile=g["b"]["profile"], launches={
                        k: v for k, v in g["b"]["launches"].items() if v},
                    gloo_per_step=g["b"]["gloo_per_step"])
               for g in ranks])
    # (c)
    errs, agree = [], 0
    for r, got in enumerate(ranks):
        for i, (g, w) in enumerate(zip(got["c"]["logits"],
                                       ref["c"]["logits"])):
            e = float((g - w).abs().max()) / float(w.abs().max())
            errs.append(e)
            if e > PHASE15_C["tol"]:
                raise AssertionError(f"phase 15 (c): rank {r}'s logits at "
                                     f"step {i} differ by {e:.3g} of the "
                                     "largest |logit|")
            agree += int(int(g.argmax()) == int(w.argmax()))
    report["c"] = dict(
        max_rel_err=max(errs), argmax_agree=agree,
        argmax_of=len(errs),
        step_wall_ms_median=[statistics.median(g["c"]["step_wall_ms"][2:])
                             for g in ranks],
        reference_step_wall_ms_median=statistics.median(
            ref["c"]["walls"][2:]),
        reference_peak_gb=ref_peak,
        peak_gb=[g["peak_gb"] for g in ranks])
    # (d)
    root = src
    report["d"] = [_serve_cli(torch, root, False),
                   _serve_cli(torch, root, True)]
    counts = {}
    for g in ranks:
        for k, v in g["launches"].items():
            counts[k] = counts.get(k, 0) + v
    report["launches"] = counts
    report["rank_s"] = [round(g["total_s"], 1) for g in ranks]
    report["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log("phase 15: granite-8b full width, the token-split layout over a "
        "(2, 2) mesh of four processes on one card over gloo: " + json.dumps(
            report, default=lambda x: round(x, 6) if isinstance(x, float)
            else str(x)))
    for name in ("utopia_translate_step", "utopia_translate_step_group",
                 "paged_attention", "flash_attention"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"phase 15: {name} was never launched")
    return counts


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
    ap.add_argument("--paged-reads", action="store_true",
                    help="build the kernels and run only phase 2's paged "
                         "attention checks and timings (the decode, verify "
                         "and prefix reads)")
    ap.add_argument("--moe", action="store_true",
                    help="build the kernels and run only phase 8 (the moe "
                         "family and the dense geometries)")
    ap.add_argument("--recurrent", action="store_true",
                    help="build the kernels and run only phase 9 (the ssm "
                         "and hybrid families and the kernels at jamba's "
                         "geometry)")
    ap.add_argument("--frontends", action="store_true",
                    help="build the kernels and run only phase 10 (the vlm "
                         "and audio families and the kernels at their "
                         "geometries)")
    ap.add_argument("--translation", action="store_true",
                    help="build the kernels and run only phase 11 (the "
                         "paper's translation comparison)")
    ap.add_argument("--mesh", action="store_true",
                    help="build the kernels and run only the sharded step's "
                         "check, phase 5 and phase 12 (sharded serving)")
    ap.add_argument("--train", action="store_true",
                    help="run only phase 13 (training on the card; no "
                         "kernel build: the training path launches none)")
    ap.add_argument("--mesh-train", action="store_true",
                    help="run only phase 14 (training over a mesh; no "
                         "kernel build)")
    ap.add_argument("--token-split", action="store_true",
                    help="build the kernels and run only phase 15 (the "
                         "token-split layout over a (2, 2) mesh, the serve "
                         "CLI)")
    ap.add_argument("--token-split-child", nargs=2, metavar=("RANK", "DIR"),
                    default=None, help=argparse.SUPPRESS)  # phase 15's ranks
    ap.add_argument("--mesh-train-child", nargs=3,
                    metavar=("RANK", "DIR", "SHAPE"), default=None,
                    help=argparse.SUPPRESS)  # phase 14 (b)'s ranks
    ap.add_argument("--resume-child", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)  # phase 6 (f)'s fresh process
    ap.add_argument("--mesh-child", nargs=2, metavar=("RANK", "DIR"),
                    default=None, help=argparse.SUPPRESS)  # phase 12 (b)
    ap.add_argument("--src", type=Path, default=None,
                    help="import repro_torch from this source tree instead "
                         "of the checkout's src/ (e.g. a parent commit's, "
                         "unpacked with git archive)")
    args = ap.parse_args()
    import os
    # phase 13's train step runs in torch's deterministic mode, which on
    # the card needs cuBLAS's deterministic workspace; cuBLAS reads the
    # setting once, at its first call in the process (32 MiB, the same
    # size as its default on Hopper)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    if args.resume_child:
        resume_child(torch, dev, args.resume_child)
        return 0
    if args.mesh_child:
        mesh_child(torch, dev, int(args.mesh_child[0]), args.mesh_child[1])
        return 0
    if args.token_split_child:
        token_split_child(torch, dev, int(args.token_split_child[0]),
                          args.token_split_child[1])
        return 0
    if args.mesh_train_child:
        rank, directory, shape = args.mesh_train_child
        mesh_train_child(torch, dev, int(rank), directory,
                         tuple(int(x) for x in shape.split(",")))
        return 0
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, card "
        f"{torch.cuda.get_device_name(0)}")
    if args.train:
        training(torch, dev, src)
        card_line(torch)
        return 0
    if args.mesh_train:
        mesh_training(torch, dev, src)
        card_line(torch)
        return 0

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
    if args.moe:
        full_width_moe(torch, dev)
        gc.collect()
        torch.cuda.empty_cache()
        moe_card_vs_cpu(torch, dev)
        gc.collect()
        torch.cuda.empty_cache()
        dense_geometry(torch, dev)
        card_line(torch)
        return 0
    results = {}
    if args.mesh:
        check_translate_shard(torch, dev, results)
        cfg, dims, params = served_model(torch, dev, "granite-8b",
                                         torch.bfloat16, seed=SEED)
        _, phase5_digest = full_width_prefix(torch, dev, cfg, dims, params)
        torch.cuda.empty_cache()
        counts = mesh_phase(torch, dev, cfg, dims, params, phase5_digest,
                            src)
        log("phase 12 launches: " + json.dumps(counts))
        card_line(torch)
        return 0
    if args.translation:
        translation(torch, dev, results)
        card_line(torch)
        return 0
    if args.token_split:
        counts = token_split(torch, dev, src, results)
        log("phase 15 launches: " + json.dumps(counts))
        card_line(torch)
        return 0
    if args.recurrent:
        recurrent(torch, dev, results)
        card_line(torch)
        return 0
    if args.frontends:
        frontends(torch, dev, results)
        card_line(torch)
        return 0
    if args.paged_reads:
        check_paged(torch, dev, results)
        check_paged_verify(torch, dev, results)
        check_paged_prefix(torch, dev, results)
        log(f"paged reads of the port in {src}: " + json.dumps({
            k: {f: r.get(f) for f in ("device_ms", "ms", "plain_ms",
                                      "bound_ms", "ctas")}
            for k, r in results.items()}))
        card_line(torch)
        return 0

    check_rsw(torch, dev)
    check_translate_step(torch, dev, results)
    check_translate_window(torch, dev, results)
    check_translate_shard(torch, dev, results)
    check_paged(torch, dev, results)
    check_paged_verify(torch, dev, results)
    check_paged_prefix(torch, dev, results)
    check_flash(torch, dev, results)
    torch.cuda.synchronize()
    card_vs_cpu_runs(torch, dev)
    torch.cuda.empty_cache()
    cfg, dims, params = served_model(torch, dev, "granite-8b",
                                     torch.bfloat16, seed=SEED)
    paths = {}
    paths["phase4"], *phase4 = full_width(torch, dev, cfg, dims, params)
    torch.cuda.empty_cache()
    paths["phase5"], phase5_digest = full_width_prefix(torch, dev, cfg, dims,
                                                       params)
    torch.cuda.empty_cache()
    paths["phase6"], streams_6b = full_width_overload(torch, dev, cfg, dims,
                                                      params)
    torch.cuda.empty_cache()
    paths["phase7"] = full_width_spec(torch, dev, cfg, dims, params)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths["phase4b"] = full_width_flash_jax(torch, dev, cfg, params, phase4)
    t4b = time.perf_counter()
    torch.cuda.empty_cache()
    paths["phase6f"] = persisted_recovery(torch, dev, cfg, params,
                                          streams_6b, src)
    t6f = time.perf_counter()
    torch.cuda.empty_cache()
    paths["phase12"] = mesh_phase(torch, dev, cfg, dims, params,
                                  phase5_digest, src)
    t12 = time.perf_counter()
    # phase 8 draws ~61 GB of MoE weights: granite-8b's go first
    del params
    gc.collect()
    torch.cuda.empty_cache()
    paths["phase8a"] = full_width_moe(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    moe_card_vs_cpu(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    paths["phase8c"] = dense_geometry(torch, dev)
    # phase 9 draws jamba's 68 GB last: qwen2.5-14b's weights go first
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(recurrent(torch, dev, results))
    # phase 10 after jamba's weights are freed
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(frontends(torch, dev, results))
    t11 = time.perf_counter()
    paths["phase11"] = translation(torch, dev, results)
    t13 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    paths["phase13"], phase13_losses = training(torch, dev, src)
    t14 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    paths["phase14"] = mesh_training(torch, dev, src, phase13_losses)
    t15 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    paths["phase15"] = token_split(torch, dev, src, results)
    log(f"new sub-runs: phase 4 (b) {t4b - t0:.1f} s, phase 6 (f) "
        f"{t6f - t4b:.1f} s, phase 12 {t12 - t6f:.1f} s, phase 11 "
        f"{t13 - t11:.1f} s, phase 13 {t14 - t13:.1f} s, phase 14 "
        f"{t15 - t14:.1f} s, phase 15 {time.perf_counter() - t15:.1f} s")

    # launches: each path's count was set to 0 just before it and read
    # just after; the line gives their sum and each path's
    results["paged_attention"]["prefix_read"] = results.pop(
        "paged_attention_prefix_read")
    results["paged_attention"]["verify_read"] = results.pop(
        "paged_attention_verify_read")
    kernels = []
    for name in ("utopia_translate_step", "paged_attention",
                 "flash_attention"):
        r = dict(results[name])
        source, replaces = KERNEL_META[name]
        extra = {}
        if name == "utopia_translate_step":
            extra["launches_vpn_list"] = sum(
                c.get("utopia_rsw", 0) for c in paths.values())
            extra["launches_vpn_list_by_path"] = {
                k: c["utopia_rsw"] for k, c in paths.items()
                if c.get("utopia_rsw")}
            extra["vpn_list"] = results.pop("utopia_rsw_vpn_list")
            # the sharded step's entries (phase 12's path)
            extra["launches_shard"] = sum(
                c.get("utopia_translate_shard", 0) for c in paths.values())
            extra["launches_combine"] = sum(
                c.get("utopia_combine_shard", 0) for c in paths.values())
            extra["shard"] = results.pop("utopia_translate_shard")
            # the token-split rank's layout (phase 15's path)
            extra["launches_group_layout"] = sum(
                c.get("utopia_translate_step_group", 0)
                for c in paths.values())
            extra["group_layout"] = results.pop(
                "utopia_translate_step_group")
        if name == "paged_attention":
            extra.update(results.pop("paged_attention_token_split"))
            extra["launches_q_gt1"] = sum(
                c["paged_attention_q_gt1"] for c in paths.values())
            extra["launches_q_per_query"] = sum(
                c["paged_attention_q_per_query"] for c in paths.values())
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(c[name] for c in paths.values()),
            launches_by_path={k: c[name] for k, c in paths.items()},
            **extra, max_abs_err=r.pop("max_abs_err"),
            ms=r["ms"], kernel_ms=r.pop("ms"), **r))
    print(json.dumps({"kernels": kernels}), flush=True)
    card_line(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
