"""Placement/eviction policies (paper §5.5, §5.6).

* SRRIP re-reference interval prediction over the ways of each RestSeg set
  (the paper's replacement policy, [Jaleel et al.]).
* Cost tracking: per-vpn flexible-walk frequency and cost counters (the
  PTW-Tracking migration policy) stored in "unused PTE bits" — here, two
  small side arrays clamped to the 9 bits the paper steals from the PTE.
* Fault-based allocation preference (treat every new block as
  costly-to-translate; put it in the RestSeg at allocation time).

SRRIP also ages the prefix-cache DIRECTORY (core/prefix_cache.py,
DESIGN.md §prefix-cache): the content-addressed cache is a second
set-associative consumer of this class — hit promotion on every prefix
match, victim selection restricted to unreferenced entries — so cached
prompt blocks join the same replacement machinery as RestSeg ways.

Host-side (numpy): allocation decisions are made by the engine between
device steps, exactly as the OS makes them between faults in the paper.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class SRRIP:
    """SRRIP over (n_sets, assoc) ways.  rrpv in [0, 2^bits - 1]."""

    def __init__(self, n_sets: int, assoc: int, bits: int = 2):
        self.max_rrpv = (1 << bits) - 1
        # insert with "long re-reference interval" = max-1
        self.insert_rrpv = self.max_rrpv - 1
        self.rrpv = np.full((n_sets, assoc), self.max_rrpv, np.int8)

    def on_insert(self, s: int, w: int) -> None:
        self.rrpv[s, w] = self.insert_rrpv

    def on_hit(self, s: int, w: int) -> None:
        self.rrpv[s, w] = 0

    def on_hit_batch(self, s: np.ndarray, w: np.ndarray) -> None:
        """Vectorized hit promotion (one fancy-indexed write per step)."""
        self.rrpv[s, w] = 0

    def on_remove(self, s: int, w: int) -> None:
        self.rrpv[s, w] = self.max_rrpv

    def victim(self, s: int, valid_mask: np.ndarray) -> int:
        """Pick a victim among valid ways; age the set until one saturates."""
        row = self.rrpv[s]
        if not valid_mask.any():
            raise ValueError("victim() called on an empty set")
        while True:
            cand = np.nonzero(valid_mask & (row >= self.max_rrpv))[0]
            if cand.size:
                return int(cand[0])
            row[valid_mask] = np.minimum(row[valid_mask] + 1, self.max_rrpv)


@dataclasses.dataclass
class CostTrackerConfig:
    freq_threshold: int = 4    # flexible walks before a block is "frequent"
    cost_threshold: int = 8    # cumulative walk accesses before "costly"
    counter_bits: int = 9      # paper: unused PTE bits budget (split 5/4)


class CostTracker:
    """PTW-Tracking analogue: counts flexible-walk frequency & cost per vpn.

    ``record_walk`` is fed from device-side stats after each serve step;
    ``take_promotions`` drains vpns whose *both* counters crossed their
    thresholds (paper: migrate when frequency AND cost exceed the
    programmable registers), resetting their counters.
    """

    def __init__(self, vpn_space: int, cfg: CostTrackerConfig = CostTrackerConfig()):
        self.cfg = cfg
        fb = cfg.counter_bits - cfg.counter_bits // 2
        cb = cfg.counter_bits // 2
        self._freq_cap = (1 << fb) - 1
        self._cost_cap = (1 << cb) - 1
        self.freq = np.zeros(vpn_space, np.int16)
        self.cost = np.zeros(vpn_space, np.int16)

    def record_walk(self, vpn, accesses) -> None:
        vpn = np.atleast_1d(np.asarray(vpn, np.int64))
        accesses = np.broadcast_to(np.asarray(accesses, np.int64), vpn.shape)
        np.add.at(self.freq, vpn, 1)
        np.add.at(self.cost, vpn, accesses)
        np.minimum(self.freq, self._freq_cap, out=self.freq, casting="unsafe")
        np.minimum(self.cost, self._cost_cap, out=self.cost, casting="unsafe")

    def take_promotions(self) -> np.ndarray:
        mask = (self.freq >= self.cfg.freq_threshold) & \
               (self.cost >= self.cfg.cost_threshold)
        vpns = np.nonzero(mask)[0]
        self.freq[vpns] = 0
        self.cost[vpns] = 0
        return vpns

    def reset(self, vpn: int) -> None:
        self.freq[vpn] = 0
        self.cost[vpn] = 0
