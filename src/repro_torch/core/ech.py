"""Elastic Cuckoo Hash table baseline (paper's ECH comparison, §7).

n-way cuckoo hashing: a key may live in exactly one nest per table; lookup
probes all n tables *in parallel* (n independent gathers — more traffic than
one RSW, which is the paper's Fig. 5/20 observation: ECH issues ~62% more
memory requests than radix while being lower latency).  Insert displaces
residents along a cuckoo path, host-side, with bounded kicks and elastic
resize on failure.

The host table is numpy; ``device_state`` copies it to torch, where
``ECHState.lookup`` hashes in int32 (``mix32`` wraps as int32 does, so the
nest index is the host's on the CPU and on the card alike).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .hashes import mix32

_SALTS = (0x1E3779B9, 0x05EBCA6B, 0x42B2AE35, 0x27D4EB2F)  # int32-safe


def _ech_hash(key, salt: int, capacity: int):
    return mix32((key ^ salt) & 0x7FFFFFFF) % capacity


class ECHState(NamedTuple):
    keys: torch.Tensor    # (n_tables, capacity) int32: vpn+1, 0 empty
    values: torch.Tensor  # (n_tables, capacity) int32 physical slot

    @property
    def n_tables(self) -> int:
        return self.keys.shape[0]

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]

    def lookup(self, vpn: torch.Tensor):
        """Parallel n-way probe.  Returns (slot int32, hit bool, accesses
        int32), shaped like ``vpn``; the first table that holds the key
        gives the slot."""
        v = vpn.to(torch.int32)
        k = v + 1
        slot = torch.full(v.shape, -1, dtype=torch.int32, device=v.device)
        hit = torch.zeros(v.shape, dtype=torch.bool, device=v.device)
        for t in range(self.n_tables):
            idx = _ech_hash(v, _SALTS[t % 4], self.capacity).long()
            found = self.keys[t][idx] == k
            slot = torch.where(found & ~hit, self.values[t][idx], slot)
            hit = hit | found
        accesses = torch.full(v.shape, self.n_tables, dtype=torch.int32,
                              device=v.device)
        return slot, hit, accesses


class ElasticCuckooTable:
    """Host-side manager with elastic resize (numpy)."""

    def __init__(self, capacity: int = 256, n_tables: int = 4,
                 max_kicks: int = 32, occupancy_limit: float = 0.6):
        self.n_tables = n_tables
        self.capacity = capacity
        self.max_kicks = max_kicks
        self.occupancy_limit = occupancy_limit
        self.keys = np.zeros((n_tables, capacity), np.int32)
        self.values = np.zeros((n_tables, capacity), np.int32)
        self.size = 0
        self.resizes = 0

    def _occupancy(self) -> float:
        return self.size / (self.n_tables * self.capacity)

    def insert(self, vpn: int, slot: int) -> None:
        if self._occupancy() >= self.occupancy_limit:
            self._resize()
        key = vpn + 1
        # update in place if present
        for t in range(self.n_tables):
            idx = _ech_hash(np.int32(vpn), _SALTS[t % 4], self.capacity)
            if self.keys[t, idx] == key:
                self.values[t, idx] = slot
                return
        cur_key, cur_val = key, slot
        t = 0
        for _ in range(self.max_kicks):
            idx = _ech_hash(np.int32(cur_key - 1), _SALTS[t % 4],
                            self.capacity)
            if self.keys[t, idx] == 0:
                self.keys[t, idx] = cur_key
                self.values[t, idx] = cur_val
                self.size += 1
                return
            cur_key, self.keys[t, idx] = int(self.keys[t, idx]), cur_key
            cur_val, self.values[t, idx] = int(self.values[t, idx]), cur_val
            t = (t + 1) % self.n_tables
        self._resize()
        self.insert(cur_key - 1, cur_val)

    def remove(self, vpn: int) -> None:
        key = vpn + 1
        for t in range(self.n_tables):
            idx = _ech_hash(np.int32(vpn), _SALTS[t % 4], self.capacity)
            if self.keys[t, idx] == key:
                self.keys[t, idx] = 0
                self.values[t, idx] = 0
                self.size -= 1
                return

    def lookup_host(self, vpn: int) -> Tuple[int, bool]:
        key = vpn + 1
        for t in range(self.n_tables):
            idx = _ech_hash(np.int32(vpn), _SALTS[t % 4], self.capacity)
            if self.keys[t, idx] == key:
                return int(self.values[t, idx]), True
        return -1, False

    def _resize(self) -> None:
        """Elastic doubling with rehash (the 'elastic' in ECH)."""
        old_keys, old_values = self.keys, self.values
        self.capacity *= 2
        self.resizes += 1
        self.keys = np.zeros((self.n_tables, self.capacity), np.int32)
        self.values = np.zeros((self.n_tables, self.capacity), np.int32)
        self.size = 0
        for t in range(self.n_tables):
            for i in np.nonzero(old_keys[t])[0]:
                self.insert(int(old_keys[t, i]) - 1, int(old_values[t, i]))

    def table_bytes(self, entry_bytes: int = 8) -> int:
        return self.n_tables * self.capacity * entry_bytes

    def device_state(self, device="cuda") -> ECHState:
        return ECHState(keys=torch.tensor(self.keys, device=device),
                        values=torch.tensor(self.values, device=device))
