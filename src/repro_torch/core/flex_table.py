"""FlexSeg translation structures: flat block table + radix-walk baseline.

Two device-side representations of the flexible mapping, in torch:

* ``FlexTable``  — flat (max_seqs, max_blocks_per_seq) table, one gather per
  translation (the vLLM-style block table the serving path uses for FlexSeg
  blocks).
* ``RadixTable`` — a multi-level radix tree over the vpn, requiring one
  *serial* dependent gather per level: each gather's index is the previous
  gather's result.  This reproduces the paper's baseline page-table walk
  (PTW) cost structure for the translation comparison.

A swapped-out (host-tier) block is -1 (unmapped) in the flat table: the
flex slot is freed at swap-out and re-acquired at resume, so a stale slot
is never read through the table while its data is on the host.  The host
builder (``RadixBuilder``) and the radix tables are numpy; ``device_table``
copies them to torch.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch


class FlexTable(NamedTuple):
    table: torch.Tensor  # (max_seqs, max_blocks_per_seq) int32 slot, -1

    def lookup_vpn(self, vpn: torch.Tensor, max_blocks_per_seq: int):
        """``(slot, slot >= 0)`` of ``table[vpn // mbps, vpn % mbps]``,
        indexed as JAX indexes it: the column is in range by the floor
        mod, the row counts from the end once when negative and then
        clamps into the rows."""
        rows = self.table.shape[0]
        v = vpn.long()
        seq = torch.div(v, max_blocks_per_seq, rounding_mode="floor")
        seq = torch.where(seq < 0, seq + rows, seq).clamp(0, rows - 1)
        slot = self.table[seq, torch.remainder(v, max_blocks_per_seq)]
        return slot, slot >= 0


def init_flex_table(max_seqs: int, max_blocks_per_seq: int,
                    device="cuda") -> FlexTable:
    return FlexTable(table=torch.full((max_seqs, max_blocks_per_seq), -1,
                                      dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# Radix ("x86-64 page-table") baseline
# ---------------------------------------------------------------------------

class RadixTable(NamedTuple):
    """Multi-level radix table stored as per-level node pools.

    ``levels[i]`` has shape (n_nodes_i, fanout) int32.  An entry at level i
    holds the node index for level i+1 (or -1).  The leaf level holds the
    physical slot (or -1).  A walk is ``levels`` dependent gathers: the
    serial pointer chase of the paper's Fig. 1.
    """
    levels: Tuple[torch.Tensor, ...]
    fanout: int

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def walk(self, vpn: torch.Tensor):
        """Serial radix walk.  Returns (slot int32, hit bool, accesses
        int32), shaped like ``vpn``.  A missing node's walk goes on
        through node 0 (the clamp, as JAX's ``jnp.maximum(node, 0)``) and
        stops counting accesses."""
        L = self.num_levels
        f = self.fanout
        v = vpn.to(torch.int32)
        # vpn digit for level 0 is the most significant
        node = torch.zeros_like(v)
        ok = torch.ones(v.shape, dtype=torch.bool, device=v.device)
        accesses = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
        for i in range(L):
            shift = f ** (L - 1 - i)
            digit = torch.remainder(torch.div(v, shift, rounding_mode="floor"),
                                    f)
            entry = self.levels[i][node.clamp(min=0).long(), digit.long()]
            accesses = accesses + ok.to(torch.int32)
            ok = ok & (entry >= 0)
            node = entry
        slot = torch.where(ok, node, -1)
        return slot.to(torch.int32), ok, accesses


class RadixBuilder:
    """Host-side (numpy) incremental builder mirroring ``RadixTable``."""

    def __init__(self, num_levels: int = 4, fanout: int = 8):
        self.num_levels = num_levels
        self.fanout = fanout
        self.levels: List[np.ndarray] = [
            -np.ones((1, fanout), np.int32)  # root pre-allocated
        ] + [
            -np.ones((0, fanout), np.int32) for _ in range(num_levels - 1)
        ]

    def _alloc_node(self, level: int) -> int:
        arr = self.levels[level]
        self.levels[level] = np.concatenate(
            [arr, -np.ones((1, self.fanout), np.int32)], axis=0)
        return arr.shape[0]

    def map(self, vpn: int, slot: int) -> None:
        node = 0
        for i in range(self.num_levels):
            shift = self.fanout ** (self.num_levels - 1 - i)
            digit = (vpn // shift) % self.fanout
            if i == self.num_levels - 1:
                self.levels[i][node, digit] = slot
                return
            nxt = self.levels[i][node, digit]
            if nxt < 0:
                nxt = self._alloc_node(i + 1)
                self.levels[i][node, digit] = nxt
            node = nxt

    def unmap(self, vpn: int) -> None:
        node = 0
        for i in range(self.num_levels):
            shift = self.fanout ** (self.num_levels - 1 - i)
            digit = (vpn // shift) % self.fanout
            if i == self.num_levels - 1:
                self.levels[i][node, digit] = -1
                return
            node = self.levels[i][node, digit]
            if node < 0:
                return

    def table_bytes(self, entry_bytes: int = 4) -> int:
        return sum(a.size * entry_bytes for a in self.levels)

    def device_table(self, device="cuda") -> RadixTable:
        return RadixTable(
            levels=tuple(torch.tensor(a, device=device) for a in self.levels),
            fanout=self.fanout,
        )
