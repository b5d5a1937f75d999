"""Set-index / block-range partitioning of the hybrid mapping over shards.

The port of ``repro.core.partition``.  Sharded serving shards the
translation structures and the KV-block pool over the mesh's ``model``
axis: ``set = hash(vpn) % n_sets`` depends on the vpn alone, so the TAR/SF
tables partition by *set index* and the flat flex table by *vpn range*,
and no shard needs another shard's rows to answer its part of a lookup.

Shard ``m`` of ``M`` owns:

* restrictive sets ``[m*spm, (m+1)*spm)`` (``spm = ceil(n_sets / M)``),
  i.e. logical RestSeg slots ``[m*spm*assoc, (m+1)*spm*assoc)``,
* flex pool slots ``[m*fpm, (m+1)*fpm)`` of the flex region
  (``fpm = ceil(flex_slots / M)``),
* vpn rows ``[m*vpm, (m+1)*vpm)`` of the flat flex table
  (``vpm = ceil(vpn_space / M)``).

LOGICAL slot numbering, what the host ``HybridKVManager`` and the step's
translation carry, is unchanged by sharding: slots ``[0, rest_slots)`` are
RestSeg (``set * assoc + way``), the rest FlexSeg.  Only the device pool
layout changes: each shard's slots are contiguous, and :meth:`phys` is the
permutation from a logical slot to that shard-contiguous physical slot (the
identity at ``M == 1`` in hybrid mode).

Every size is padded per shard (ceil division), so every shard's chunk has
one shape: padded TAR rows stay zero (a tag is ``vpn + 1 >= 1``, so a zero
row never hits) and padded flex entries -1 (unmapped), which keeps the
padded lookup bitwise the unpadded one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Partition:
    """Static partition geometry of one hybrid mapping over ``n_shards``."""

    n_shards: int
    n_sets: int          # REAL set count (the hash modulus, never padded)
    assoc: int
    rest_slots: int      # logical RestSeg slots (0 in flexible_only mode)
    flex_slots: int      # logical FlexSeg slots
    vpn_space: int       # flat flex-table length (max_seqs * blocks_per_seq)

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.rest_slots not in (0, self.n_sets * self.assoc):
            raise ValueError(
                f"rest_slots {self.rest_slots} inconsistent with "
                f"{self.n_sets} sets x {self.assoc} ways")

    @classmethod
    def for_hybrid(cls, cfg, n_shards: int) -> "Partition":
        """Build from a :class:`core.segments.HybridConfig`."""
        return cls(n_shards=n_shards, n_sets=cfg.num_sets, assoc=cfg.assoc,
                   rest_slots=cfg.rest_slots, flex_slots=cfg.flex_slots,
                   vpn_space=cfg.vpn_space)

    # ------------------------------------------------- per-shard geometry
    @property
    def sets_per_shard(self) -> int:
        return _ceil_div(self.n_sets, self.n_shards)

    @property
    def n_sets_padded(self) -> int:
        return self.sets_per_shard * self.n_shards

    @property
    def rest_per_shard(self) -> int:
        return self.sets_per_shard * self.assoc

    @property
    def flex_per_shard(self) -> int:
        return _ceil_div(self.flex_slots, self.n_shards)

    @property
    def slots_per_shard(self) -> int:
        """Physical pool slots per shard (rest chunk followed by flex
        chunk)."""
        return self.rest_per_shard + self.flex_per_shard

    @property
    def pool_slots(self) -> int:
        """Padded pool size over all shards (>= rest_slots + flex_slots)."""
        return self.n_shards * self.slots_per_shard

    @property
    def vpns_per_shard(self) -> int:
        return _ceil_div(self.vpn_space, self.n_shards)

    @property
    def vpn_padded(self) -> int:
        return self.vpns_per_shard * self.n_shards

    # --------------------------------------------------------- ownership
    def shard_of_set(self, set_idx):
        return set_idx // self.sets_per_shard

    def shard_of_vpn(self, vpn):
        return vpn // self.vpns_per_shard

    def shard_of_slot(self, slot):
        """Owning shard of a LOGICAL pool slot (undefined for slot < 0)."""
        return self.phys(slot) // self.slots_per_shard

    # ------------------------------------------------ slot renumbering
    def phys(self, slot):
        """Logical pool slot -> shard-contiguous physical slot.

        Works on python ints, numpy arrays and torch tensors alike (a
        tensor keeps its dtype and device); negative (unmapped) slots pass
        through unchanged.  The identity when ``n_shards == 1`` and
        ``rest_slots == n_sets * assoc``."""
        where = torch.where if isinstance(slot, torch.Tensor) else np.where
        spm, assoc = self.sets_per_shard, self.assoc
        fpm = max(1, self.flex_per_shard)   # no //0 without a flex region
        cps = self.slots_per_shard
        i_r = (slot // assoc) // spm
        p_rest = i_r * cps + (slot - i_r * (spm * assoc))
        f_off = slot - self.rest_slots
        i_f = f_off // fpm
        p_flex = i_f * cps + spm * assoc + (f_off - i_f * fpm)
        p = where(slot < self.rest_slots, p_rest, p_flex)
        return where(slot >= 0, p, slot)


__all__ = ["Partition"]
