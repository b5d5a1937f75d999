"""Quickstart of the PyTorch port: the Utopia hybrid translation in 70 lines.

Builds a hybrid KV manager, allocates blocks fault-based into the RestSeg,
translates on the device (RSW ∥ flexible walk: the RSW kernel on a card,
its plain version on the CPU), triggers conflict evictions and
cost-tracked promotions, and prints the translation statistics the
paper's figures are built from.  The counterpart of ``quickstart.py``;
it imports only ``repro_torch``, torch and numpy.

Run:  python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
from repro_torch.core import (FLEX, HybridConfig,  # noqa: E402
                              HybridKVManager, translate)


def main(argv=None) -> str:
    """Run the quickstart; returns what it printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the translation runs (default cuda)")
    args = ap.parse_args(argv)
    lines = []

    def say(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    cfg = HybridConfig(
        block_size=64,            # tokens per KV block ("page size")
        total_slots=256,          # physical pool in blocks
        restseg_fraction=0.5,     # half set-associative, half flexible
        assoc=8,
        max_seqs=16,
        max_blocks_per_seq=32,
    )
    m = HybridKVManager(cfg)

    # --- fault-based allocation: new blocks go straight to the RestSeg ---
    for seq in range(8):
        m.register_sequence(seq)
        for block in range(24):
            m.allocate_block(seq, block)
    say(f"allocations: rest={m.stats['rest_allocs']} "
        f"flex={m.stats['flex_allocs']} "
        f"evictions={m.stats['rest_evictions']} "
        f"swap={m.stats['swap_out']}")

    # --- device-side hybrid translation (what the serve step does) -------
    ts = m.device_state(args.device)
    vpns = torch.tensor([m.cfg.vpn(m.seq_slot(s), b)
                         for s in range(8) for b in range(24)],
                        dtype=torch.int32, device=args.device)
    res = translate(ts, vpns)
    in_rest = res.in_rest.float()
    say(f"translations: {len(vpns)}  RSW hits: {int(in_rest.sum())} "
        f"({100 * float(in_rest.mean()):.1f}%)  "
        f"avg structure accesses/translation: "
        f"{float(res.accesses.float().mean()):.2f}  "
        f"avg metadata bytes: {float(res.bytes_touched.float().mean()):.1f}")

    # --- cost-tracked promotion (PTW-Tracking analogue) -------------------
    flex_vpns = np.array([v for v, i in m.blocks.items() if i.seg == FLEX])
    if flex_vpns.size:
        for _ in range(6):   # simulate frequent costly flexible walks
            m.record_device_stats(flex_vpns,
                                  np.zeros(len(flex_vpns), bool),
                                  np.full(len(flex_vpns), 4))
        promoted = m.run_promotions()
        say(f"promoted {promoted} costly-to-translate blocks into the "
            f"RestSeg (pending data copies: {len(m.pending_copies)})")

    # --- prefix sharing needs the flexible segment ------------------------
    shared = m.share_prefix(0, 1, 4)
    say(f"shared {shared} prompt-prefix blocks between seq 0 and 1 "
        f"(restrictive slots migrate to FlexSeg on share)")
    m.check_invariants()
    say("invariants OK")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
