"""POM-TLB baseline: a large software-managed set-associative TLB (paper §7).

A 64K-entry, 16-way part-of-memory TLB that caches vpn->slot translations in
front of the flexible walk.  On a hit, one set read resolves the
translation; on a miss, the full flexible walk runs and the entry is filled
(host-side fill mirrors the paper's software management).  The host TLB is
numpy; ``device_state`` copies it to torch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .hashes import modulo_hash


class POMTLBState(NamedTuple):
    keys: torch.Tensor    # (n_sets, ways) int32: vpn+1, 0 empty
    values: torch.Tensor  # (n_sets, ways) int32 slot

    @property
    def n_sets(self) -> int:
        return self.keys.shape[0]

    @property
    def ways(self) -> int:
        return self.keys.shape[1]

    def lookup(self, vpn: torch.Tensor):
        """(slot int32, hit bool, accesses int32), shaped like ``vpn``; the
        first matching way gives the slot."""
        v = vpn.to(torch.int32)
        idx = modulo_hash(v, self.n_sets).long()
        eq = self.keys[idx] == (v + 1).unsqueeze(-1)      # (..., ways)
        hit = eq.any(dim=-1)
        # argmax does not take bool: cast first (ties -> first index)
        way = eq.to(torch.int32).argmax(dim=-1)
        slot = torch.where(hit, self.values[idx].gather(
            -1, way.unsqueeze(-1)).squeeze(-1), -1)
        accesses = torch.ones(v.shape, dtype=torch.int32, device=v.device)
        return slot.to(torch.int32), hit, accesses


class POMTLB:
    """Host-side manager with SRRIP-ish (LRU-approx) replacement."""

    def __init__(self, entries: int = 65536, ways: int = 16):
        self.n_sets = max(1, entries // ways)
        self.ways = ways
        self.keys = np.zeros((self.n_sets, ways), np.int32)
        self.values = np.zeros((self.n_sets, ways), np.int32)
        self.stamp = np.zeros((self.n_sets, ways), np.int64)
        self._clock = 0
        self.hits = 0
        self.misses = 0

    def lookup_fill(self, vpn: int, slot_on_miss: int) -> tuple:
        """Probe; on miss, fill with ``slot_on_miss``. Returns (slot, hit)."""
        self._clock += 1
        s = vpn % self.n_sets
        key = vpn + 1
        row = self.keys[s]
        w = np.nonzero(row == key)[0]
        if w.size:
            self.hits += 1
            self.stamp[s, w[0]] = self._clock
            return int(self.values[s, w[0]]), True
        self.misses += 1
        empty = np.nonzero(row == 0)[0]
        victim = int(empty[0]) if empty.size else int(np.argmin(self.stamp[s]))
        self.keys[s, victim] = key
        self.values[s, victim] = slot_on_miss
        self.stamp[s, victim] = self._clock
        return slot_on_miss, False

    def invalidate(self, vpn: int) -> None:
        s = vpn % self.n_sets
        w = np.nonzero(self.keys[s] == vpn + 1)[0]
        if w.size:
            self.keys[s, w[0]] = 0
            self.values[s, w[0]] = 0

    def table_bytes(self, entry_bytes: int = 8) -> int:
        return self.n_sets * self.ways * entry_bytes

    def device_state(self, device="cuda") -> POMTLBState:
        return POMTLBState(keys=torch.tensor(self.keys, device=device),
                           values=torch.tensor(self.values, device=device))
