"""End-to-end example of the PyTorch port: the request-centric serving API.

Continuous batching over the Utopia hybrid-translated KV pool: immutable
``Request`` submissions carry ``SamplingParams`` (greedy and sampled
requests share one batch), admission runs under a per-step prefill token
budget (a long prompt is CHUNKED across steps, so it interleaves with
decoding instead of stalling it), finished sequences auto-release so
their slots recycle, prefix sharing links requests with the same prompt
(the prefix cache attaches the first one's published blocks through
FlexSeg refcounts), and generation is consumed as a stream of
``RequestOutput`` snapshots.  Translation statistics print at the end,
both global and attributed per request.  The counterpart of the first
part of ``serve_engine.py``; it imports only ``repro_torch``, torch and
numpy, and the weights are drawn from a seeded generator on the device.

Run:  python examples/serve_engine_torch.py [--device cpu]
      [--no-prefix-sharing]
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import model_dims  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.serve import (Engine, EngineConfig, Request,  # noqa: E402
                               SamplingParams)


def main(argv=None) -> str:
    """Run the example; returns what it printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default cuda)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="serve with the prefix cache off (seq 1 then "
                         "prefills its own copy of seq 0's prompt)")
    args = ap.parse_args(argv)
    sharing = not args.no_prefix_sharing
    lines = []

    def say(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    device = torch.device(args.device)
    cfg = reduced(ARCHS["granite-8b"])
    dims = model_dims(cfg, tp=1)
    params = init_params(torch.Generator(device).manual_seed(0), cfg, dims,
                         device=device)
    bs = cfg.kv_block_size
    # budget = 2 blocks/step: the 6-block prompt below takes 3 admission
    # steps, decoding the already-live sequences in between
    eng = Engine(cfg, params, EngineConfig(
        max_batch=3, max_seq_len=10 * bs, prefill_budget=2 * bs,
        auto_release=True, scheduler="fifo",
        prefix_cache="auto" if sharing else None), device=device)
    rng = np.random.RandomState(0)

    system_prompt = rng.randint(0, cfg.vocab_size, 2 * bs)
    eng.submit(Request(seq_id=0, prompt=system_prompt, max_new_tokens=10))
    # the second request has the same prompt: with prefix sharing the
    # engine's prefix cache attaches seq 0's published blocks (FlexSeg
    # refcounts).  Both greedy, so seq 0 and seq 1 MUST print identical
    # token streams, with sharing on or off
    eng.submit(Request(seq_id=1, prompt=system_prompt, max_new_tokens=10))
    # long prompt: chunked over three steps under the 2-block budget
    eng.submit(Request(seq_id=2, prompt=rng.randint(0, cfg.vocab_size,
                                                    6 * bs),
                       max_new_tokens=6))
    # more requests than batch slots: admitted as soon as a slot recycles.
    # seq 4 SAMPLES at temperature 0.8; per-slot sampling state leaves the
    # greedy requests sharing its batch untouched
    eng.submit(Request(seq_id=3,
                       prompt=rng.randint(0, cfg.vocab_size, 2 * bs),
                       max_new_tokens=6))
    eng.submit(Request(seq_id=4,
                       prompt=rng.randint(0, cfg.vocab_size, 2 * bs),
                       max_new_tokens=6,
                       sampling=SamplingParams(temperature=0.8, top_k=40,
                                               seed=7)))

    t0 = time.perf_counter()
    results = {}
    for out in eng.stream():
        tag = f" [{out.finish_reason}]" if out.finished else ""
        say(f"step {eng.step_count:2d}: seq {out.seq_id} "
            f"+{list(out.new_token_ids)}{tag} (queued={len(eng.waiting)})")
        results[out.seq_id] = out
    dt = time.perf_counter() - t0

    say(f"generated in {dt:.2f}s over {eng.step_count} steps "
        f"(prefix sharing {'on' if sharing else 'off'}):")
    for sid, out in sorted(results.items()):
        say(f"  seq {sid}: {list(out.token_ids)} ({out.finish_reason})")
    if list(results[0].token_ids) != list(results[1].token_ids):
        raise AssertionError("seq 0 and seq 1 share a greedy prompt but "
                             "their streams differ")
    st = eng.stats()
    total = st.get("rsw_hits", 0) + st.get("flex_walks", 0)
    mapped = sum(1 for i in eng.manager.blocks.values() if i.slot >= 0)
    say(f"translation stats: rsw_hits={st.get('rsw_hits', 0)} "
        f"({100 * st.get('rsw_hits', 0) / max(total, 1):.1f}%) "
        f"flex_walks={st.get('flex_walks', 0)} "
        f"shared_blocks={st.get('shared_blocks', 0)} "
        f"swap_out={st.get('swap_out', 0)} "
        f"occupancy={mapped}/{eng.hybrid_cfg.total_slots}")
    pcs = st.get("prefix_cache") or {}
    say(f"prefix cache: lookups={pcs.get('lookups', 0)} "
        f"hits={pcs.get('hits', 0)} "
        f"dedup_blocks={pcs.get('dedup_blocks', 0)}")
    fwd = sum(c.fwd_tokens for c in eng.admission_log)
    say(f"admission: {len(eng.admission_log)} prompt chunks, "
        f"{fwd} tokens forwarded")
    for sid, row in sorted(st["per_request"].items()):
        say(f"  seq {sid}: rsw_hits={row['rsw_hits']} "
            f"flex_walks={row['flex_walks']} "
            f"swap_faults={row['swap_faults']} "
            f"cached_blocks={row['cached_blocks']}")
    for sid in list(eng.requests):
        eng.release(sid)
    eng.manager.check_invariants()
    say("released; invariants OK")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
