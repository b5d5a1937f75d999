"""Segment geometry for the hybrid restrictive/flexible KV-block mapping.

Paper mapping (Utopia, Kanellopoulos et al.):
  RestSeg  -> set-associative region of the physical KV-block pool.
  FlexSeg  -> fully-flexible region addressed through a block table.
  page     -> one KV block of ``block_size`` tokens (all layers share one
              translation; the pool carries a layer dimension).

Slot numbering is global over the pool: slots ``[0, rest_slots)`` belong to
the RestSeg (slot = set * assoc + way), slots ``[rest_slots, total_slots)``
belong to the FlexSeg.

Swap consistency: a third logical segment, SWAP, holds mappings
whose data lives on the host tier.  A SWAP mapping owns NO slot — the
slot was released at swap-out — so segment geometry never counts it
against RestSeg/FlexSeg occupancy; it only reserves the vpn so a
resume/fault can re-materialise through the normal allocation path.
See DESIGN.md §tiered-KV-and-overload.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class RestSegConfig:
    """Set-associative restrictive segment (paper §5.1)."""

    num_slots: int          # N physical KV blocks in the RestSeg
    assoc: int = 8          # M ways per set
    hash_name: str = "modulo"  # §8.3.8: modulo wins perf/complexity

    def __post_init__(self) -> None:
        if self.num_slots % self.assoc != 0:
            raise ValueError(
                f"RestSeg slots {self.num_slots} not divisible by assoc {self.assoc}"
            )
        if self.num_slots <= 0:
            raise ValueError("RestSeg must have at least one slot")

    @property
    def num_sets(self) -> int:
        return self.num_slots // self.assoc

    # --- structure sizes (paper §5.1.2, Fig. 13) -------------------------
    def tag_bits(self, vpn_space_bits: int = 48) -> int:
        """Bits per TAR tag: vpn bits minus set-index bits, plus 10 metadata."""
        set_bits = max(1, int(math.ceil(math.log2(self.num_sets))))
        return max(1, vpn_space_bits - set_bits) + 10

    def tar_bytes(self, vpn_space_bits: int = 48) -> int:
        return (self.num_slots * self.tag_bits(vpn_space_bits) + 7) // 8

    def sf_bytes(self) -> int:
        counter_bits = int(math.ceil(math.log2(self.assoc))) + 1
        return (self.num_sets * counter_bits + 7) // 8


@dataclasses.dataclass(frozen=True)
class FlexSegConfig:
    """Fully-flexible segment addressed by a block table (paper §5.3)."""

    num_slots: int
    radix_levels: int = 4   # baseline multi-level table ("radix PT" analogue)
    radix_fanout: int = 512 # 9 bits per level, as in x86-64

    def table_bytes(self, num_mapped: int, entry_bytes: int = 8) -> int:
        """Approximate radix-table footprint for ``num_mapped`` mapped blocks.

        Mirrors the paper's Fig. 13 accounting: leaf level is fully densely
        allocated per 512-entry node touched; upper levels amortize.
        """
        nodes = 0
        level_entries = num_mapped
        for _ in range(self.radix_levels):
            level_nodes = max(1, math.ceil(level_entries / self.radix_fanout))
            nodes += level_nodes
            level_entries = level_nodes
        return nodes * self.radix_fanout * entry_bytes


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Full hybrid mapping configuration (one RestSeg + one FlexSeg).

    The paper uses two RestSegs (4K/2M pages); for the KV cache a single
    block size is the norm, so one RestSeg suffices — ``n_restsegs`` pages
    the design if more granularities are needed.
    """

    block_size: int = 64            # tokens per KV block ("page size")
    total_slots: int = 1024         # pool size in blocks
    restseg_fraction: float = 0.75  # fraction of pool run restrictively
    assoc: int = 8
    hash_name: str = "modulo"
    max_seqs: int = 64
    max_blocks_per_seq: int = 64
    # policies (paper §5.5)
    alloc_evicts: bool = True       # page-fault alloc may evict (SRRIP) to flex
    promote_freq_threshold: int = 4  # flex-walk frequency counter threshold
    promote_cost_threshold: int = 8  # flex-walk cost (accesses) threshold
    mode: str = "hybrid"            # hybrid | restrictive_only | flexible_only

    def __post_init__(self) -> None:
        if self.mode not in ("hybrid", "restrictive_only", "flexible_only"):
            raise ValueError(f"bad mode {self.mode}")
        if self.rest_slots % self.assoc != 0:
            raise ValueError(
                f"rest slots {self.rest_slots} not divisible by assoc {self.assoc}"
            )

    @property
    def rest_slots(self) -> int:
        if self.mode == "flexible_only":
            return 0
        if self.mode == "restrictive_only":
            # round down to assoc multiple
            return (self.total_slots // self.assoc) * self.assoc
        raw = int(self.total_slots * self.restseg_fraction)
        return max(self.assoc, (raw // self.assoc) * self.assoc)

    @property
    def flex_slots(self) -> int:
        return self.total_slots - self.rest_slots

    @property
    def num_sets(self) -> int:
        return max(1, self.rest_slots // self.assoc)

    @property
    def vpn_space(self) -> int:
        return self.max_seqs * self.max_blocks_per_seq

    def restseg(self) -> RestSegConfig:
        return RestSegConfig(
            num_slots=max(self.assoc, self.rest_slots),
            assoc=self.assoc,
            hash_name=self.hash_name,
        )

    def flexseg(self) -> FlexSegConfig:
        return FlexSegConfig(num_slots=self.flex_slots)

    def vpn(self, seq_slot: int, block_idx: int) -> int:
        if not (0 <= seq_slot < self.max_seqs):
            raise ValueError(f"seq_slot {seq_slot} out of range")
        if not (0 <= block_idx < self.max_blocks_per_seq):
            raise ValueError(f"block_idx {block_idx} out of range")
        return seq_slot * self.max_blocks_per_seq + block_idx


def pool_slots_for(num_logical_blocks: int, headroom: float = 1.25,
                   assoc: int = 8) -> int:
    """Pool sizing helper: logical blocks plus headroom, assoc-aligned."""
    raw = int(math.ceil(num_logical_blocks * headroom))
    return max(assoc, ((raw + assoc - 1) // assoc) * assoc)
