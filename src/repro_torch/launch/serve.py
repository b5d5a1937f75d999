"""Serving launcher of the port: ``repro.launch.serve``'s counterpart,
continuous batching over the hybrid KV pool.

    python -m repro_torch.launch.serve --arch granite-8b \\
        --requests 8 --max-new 16 [--device cuda|cpu] \\
        [--mode hybrid|flexible_only|restrictive_only] \\
        [--prefill-budget 128] [--scheduler fifo|spf|priority] \\
        [--temperature 0.8 --top-k 40 --top-p 0.95 --seed 0] \\
        [--spec-decode --num-draft-tokens 4] \\
        [--shared-prefix-blocks 4] [--no-prefix-cache] \\
        [--metrics[=PATH] --metrics-every 10]
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch granite-8b --data 1 --model 2 [...]

Run it from ``src/`` or with ``repro_torch`` importable.  It takes every
flag of the JAX launcher, plus ``--device`` (default ``cuda``), and prints
the same lines: throughput, recovery, translation, prefix cache,
speculation and one line a request.  The requests are submitted up front
with per-request ``SamplingParams``; the scheduler admits them under the
per-step prefill budget, finished sequences release their slots, and the
outputs stream back as ``RequestOutput`` snapshots.  Latencies come from
the ``MetricsLogger``'s monotonic clock.

``--reduced`` is the JAX launcher's ``store_true`` flag with
``default=True``: it is always on, so the model is always the smoke-scale
config.  The port keeps that and adds no flag to turn it off.

With ``--data``/``--model`` above 1 it is one rank of the sharded engine
(``EngineConfig.mesh_shape``), one process a mesh position as torchrun
starts them: it joins the process group from torchrun's environment
(NCCL with a card per rank, gloo where ranks share one or with ``--device
cpu``; ``launch.mesh.join_from_env``) and runs on ``cuda:(local_rank %
device_count)``.  Rank 0 prints.  The weights are drawn from a seeded
generator on the device (``params.init_params``), not the JAX package's.
"""
from __future__ import annotations

import argparse
import datetime
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.launch.mesh import join_from_env, local_device
from repro_torch.models import model_dims
from repro_torch.params import init_params
from repro_torch.serve import (Engine, EngineConfig, JsonlSink, MetricsLogger,
                               Request, SamplingParams)

COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-blocks", type=int, default=2)
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="prompt tokens admitted per engine step "
                         "(default: 4 * block_size * max_batch)")
    ap.add_argument("--mode", default="hybrid",
                    choices=["hybrid", "flexible_only", "restrictive_only"])
    ap.add_argument("--scheduler", default="fifo",
                    choices=["fifo", "spf", "priority"])
    ap.add_argument("--prefill-mode", default="prefix_kv",
                    choices=["prefix_kv", "recompute"],
                    help="chunk k>0 path: prefix-KV pool read (linear "
                         "chunk cost) or full-prefix recompute (oracle)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (the fast path)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=None,
                    help="base sampling seed; request sid uses seed + sid "
                         "(default: per-request seq_id)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decoding: self-drafted n-gram "
                         "drafts verified in-graph, K tokens per "
                         "dispatch (lossless — streams are identical to "
                         "spec-off; recurrent families fall back)")
    ap.add_argument("--num-draft-tokens", type=int, default=4,
                    help="draft window width K (with --spec-decode)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the automatic content-addressed prefix "
                         "cache (on by default: identical prompt prefixes "
                         "dedupe to shared pool blocks)")
    ap.add_argument("--shared-prefix-blocks", type=int, default=0,
                    help="prepend this many IDENTICAL prompt blocks to "
                         "every request (a shared system prompt) — the "
                         "workload the prefix cache dedupes")
    ap.add_argument("--data", type=int, default=1,
                    help="mesh data-axis size (replicated engine state)")
    ap.add_argument("--model", type=int, default=1,
                    help="mesh model-axis size: shards the KV pool and "
                         "TAR/SF/flex tables (DESIGN.md §sharded-serving);"
                         " start data * model ranks under torchrun")
    ap.add_argument("--metrics", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="attach the live MetricsLogger and print a "
                         "rolling one-line dashboard; with a PATH, also "
                         "stream per-step events to a JSONL file")
    ap.add_argument("--metrics-every", type=int, default=10,
                    help="dashboard print interval in engine steps "
                         "(with --metrics)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="crash-safe serving: wrap the engine in "
                         "ResilientServe and snapshot every N steps "
                         "(0 = off; DESIGN.md §crash-recovery)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="persist snapshots through ckpt."
                         "CheckpointManager under this directory "
                         "(implies --snapshot-every 10 if unset)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="bounded restart budget before the supervisor "
                         "re-raises the fault (with --snapshot-every)")
    ap.add_argument("--crash-at", default=None, metavar="STEPS",
                    help="kill-and-recover demo: inject an "
                         "InjectedStepFault at these engine steps "
                         "(comma list) — with --snapshot-every the "
                         "supervisor restores and replays; streams are "
                         "bit-identical to an uncrashed run")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    created = False
    device = torch.device(args.device)
    if (args.data, args.model) != (1, 1):
        created = join_from_env(args.device, COLLECTIVE_TIMEOUT)
        device = local_device(args.device)
    try:
        run(args, device)
    finally:
        if created:
            dist.destroy_process_group()


def run(args, device) -> None:
    if args.snapshot_dir is not None and args.snapshot_every == 0:
        args.snapshot_every = 10

    # the logger is always attached (it is host-side arithmetic only and
    # provably stream-invisible); --metrics controls what gets SHOWN
    sinks = [JsonlSink(args.metrics)] if args.metrics else []
    logger = MetricsLogger(sinks)
    show_metrics = args.metrics is not None

    cfg = reduce_cfg(get_config(args.arch)) if args.reduced \
        else get_config(args.arch)
    dims = model_dims(cfg, tp=1)
    params = init_params(torch.Generator(device).manual_seed(0), cfg, dims,
                         device=device)
    bs = cfg.kv_block_size
    S = (args.prompt_blocks + args.shared_prefix_blocks) * bs
    # no speculative headroom: a verify window overrunning the last KV
    # block is re-verified, not committed, so spec-on and spec-off run
    # the same pool sizing (stats stay apples-to-apples)
    injector = None
    if args.crash_at:
        from repro_torch.runtime import ServeFaultInjector
        injector = ServeFaultInjector(crash_at=[
            (int(s), "pre") for s in args.crash_at.split(",")])
    eng = Engine(cfg, params, EngineConfig(
        max_batch=args.max_batch,
        max_seq_len=S + cfg.frontend_tokens + args.max_new + bs,
        # a shared-prefix demo needs a bounded admission budget: with
        # room for every prompt in round 1, followers admit before
        # request 0's blocks are published (insertion is post-dispatch)
        # and the cache never gets a chance to hit
        mode=args.mode, prefill_budget=(
            S if args.prefill_budget is None
            and args.shared_prefix_blocks > 0 else args.prefill_budget),
        auto_release=True, scheduler=args.scheduler,
        prefill_mode=args.prefill_mode,
        spec_decode="ngram" if args.spec_decode else None,
        num_draft_tokens=args.num_draft_tokens,
        prefix_cache=False if args.no_prefix_cache else "auto",
        metrics=logger,
        fault_injector=injector,
        mesh_shape=((args.data, args.model)
                    if (args.data, args.model) != (1, 1) else None)),
        device=device)
    sup = None
    if args.snapshot_every > 0:
        from repro_torch.runtime import ResilientServe
        ckpt_mgr = None
        if args.snapshot_dir is not None:
            from repro_torch.ckpt import CheckpointManager
            ckpt_mgr = CheckpointManager(args.snapshot_dir)
        sup = ResilientServe(eng, ckpt_mgr,
                             snapshot_every=args.snapshot_every,
                             max_restarts=args.max_restarts)
    drv = sup if sup is not None else eng
    # every rank prints the same lines (the engines' state is replicated)
    say = print if eng.mesh is None or eng.mesh.rank == 0 else \
        (lambda *a, **k: None)

    def sampling(sid):
        # distinct per-request PRNG streams: one shared seed would make
        # identical prompts produce identical "sampled" token streams
        return SamplingParams(
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p,
            seed=None if args.seed is None else args.seed + sid)

    rng = np.random.RandomState(0)
    shared = rng.randint(0, cfg.vocab_size,
                         args.shared_prefix_blocks * bs)
    # monotonic clock: wall-clock time.time() measures an NTP step as
    # request latency (the ISSUE 9 bugfix) — the MetricsLogger uses
    # perf_counter too, so the dashboard and this printout agree
    t0 = time.perf_counter()
    for sid in range(args.requests):
        frontend = (rng.randn(cfg.frontend_tokens, cfg.d_model)
                    .astype(np.float32) if cfg.frontend != "none" else None)
        prompt = np.concatenate([
            shared, rng.randint(0, cfg.vocab_size,
                                args.prompt_blocks * bs)])
        drv.submit(Request(
            seq_id=sid, prompt=prompt,
            frontend=frontend, max_new_tokens=args.max_new,
            sampling=sampling(sid), priority=sid % 3))
    tokens = 0
    shown_at = 0
    while drv.has_unfinished():
        for out in drv.poll():
            tokens += len(out.new_token_ids)
        if (show_metrics
                and eng.step_count - shown_at >= args.metrics_every):
            say(logger.dashboard_line(), flush=True)
            shown_at = eng.step_count
    if show_metrics and eng.step_count != shown_at:
        say(logger.dashboard_line(), flush=True)
    logger.close()
    dt = time.perf_counter() - t0
    steps = eng.step_count
    spec_note = (f", spec K={args.num_draft_tokens}" if eng.spec_K
                 else "")
    if eng.mesh is not None:
        spec_note += f", mesh=(data={args.data}, model={args.model})"
    say(f"arch={cfg.name} mode={args.mode} sched={args.scheduler}: "
          f"{args.requests} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens / dt:.1f} tok/s, {steps} engine steps, "
          f"budget={eng.prefill_budget} tok/step, "
          f"temp={args.temperature}{spec_note})")
    st = drv.stats()
    life = st.get("lifecycle", {})
    if sup is not None:
        rec = st["recovery"]
        say(f"recovery: restarts={rec['restarts']}/"
              f"{rec['max_restarts']} snapshots={rec['snapshots']} "
              f"(every {rec['snapshot_every']} steps, last at step "
              f"{rec['last_snapshot_step']}) "
              f"replayed_steps={rec['replayed_steps']} "
              f"dedup_tokens={rec['dedup_tokens']} "
              f"persisted={rec['persisted']} "
              f"cancelled={life.get('cancelled', 0)} "
              f"deadline_expired={life.get('deadline_expired', 0)}")
        if sup.ckpt is not None:
            sup.ckpt.wait()
    total = st.get("rsw_hits", 0) + st.get("flex_walks", 0)
    say(f"translation: rsw_hit_rate="
          f"{st.get('rsw_hits', 0) / max(total, 1):.2%} "
          f"migrations={st.get('migrations_rest_to_flex', 0) + st.get('migrations_flex_to_rest', 0)} "
          f"swaps={st.get('swap_out', 0)}")
    pcs = st["prefix_cache"]
    say(f"prefix cache: enabled={pcs['enabled']} "
          f"lookups={pcs['lookups']} hits={pcs['hits']} "
          f"dedup_blocks={pcs['dedup_blocks']} "
          f"bytes_saved={pcs['bytes_saved'] / 2**10:.0f}KiB "
          f"evictions={pcs['evictions']} "
          f"resident_entries={pcs['cached_blocks']}")
    if eng.spec_K:
        say(f"speculation: drafted={st['spec_drafted']} "
              f"accepted={st['spec_accepted']} "
              f"(acceptance "
              f"{st['spec_accepted'] / max(st['spec_drafted'], 1):.2%})")
    for sid, row in sorted(st["per_request"].items()):
        seen = row["rsw_hits"] + row["flex_walks"]
        spec_row = ""
        if eng.spec_K:
            spec_row = (f" accepted={row['accepted']}/{row['drafted']}"
                        f" ({row['accepted'] / max(row['drafted'], 1):.0%})")
        # submit-to-finish latency, from the logger's monotonic clock —
        # the single source the dashboard reads too
        lat = logger.request_latencies.get(sid)
        lat_row = f" latency={lat * 1e3:.0f}ms" if lat is not None else ""
        say(f"  seq {sid}: rsw_hits={row['rsw_hits']}/{seen} "
              f"flex_walks={row['flex_walks']} "
              f"swap_faults={row['swap_faults']} "
              f"cached_blocks={row['cached_blocks']}{lat_row}{spec_row}")


if __name__ == "__main__":
    main()
