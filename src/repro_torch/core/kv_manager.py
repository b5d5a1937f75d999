"""Hybrid paged-KV manager: the OS of the Utopia adaptation (paper §5.5/5.6).

Host-side authority over the physical KV-block pool.  Owns:

* the RestSeg (set-associative region): numpy TAR/SF mirrors + SRRIP rrpv,
* the FlexSeg (flexible region): free list + flat block table + refcounts
  (refcounts implement prefix sharing — the paper's "data sharing across
  processes", which is exactly what the restrictive mapping cannot do),
* allocation (page-fault-based: straight into the RestSeg),
* eviction (SRRIP within a set; evictee *migrates* to the FlexSeg — never
  dropped while flexible space remains, the paper's anti-swap argument),
* promotion (CostTracker: blocks with frequent+costly flexible walks move
  into the RestSeg),
* the swap analogue: when the whole pool is exhausted (or in
  ``restrictive_only`` mode, when a set conflicts with no flexible
  fallback), the block is evicted to "swap" = must be recomputed/host-
  fetched.  ``stats["swap_out"/"swap_in"]`` reproduce Fig. 9.

Device state (``device_state()``) is the packed TranslationState consumed by
``serve_step`` and the RSW kernel.  Migration of KV *data* between pool
slots is performed on device by ``serve/engine.py`` (gather/scatter); the
manager emits the (src, dst) slot copy list for each step, the analogue of
the paper's DMA-driven page copy (§5.6, Fig. 16).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .segments import HybridConfig
from .hashes import get_hash
from .policies import SRRIP, CostTracker, CostTrackerConfig

REST = 0
FLEX = 1
SWAP = 2


@dataclasses.dataclass
class BlockInfo:
    vpn: int
    seg: int           # REST / FLEX / SWAP
    slot: int          # global pool slot (-1 if swapped)
    refcount: int = 1  # >1 only in FlexSeg (sharing)
    writable: bool = True
    # per-vpn RSW-hit reuse counters (Fig. 26) live in
    # HybridKVManager.reuse_counts, not here: the vectorized stats
    # feedback writes them array-at-a-time


class PoolExhausted(RuntimeError):
    """Pool/slot exhaustion that cannot be served.

    ``diag`` carries structured occupancy diagnostics (the engine fills
    them in: pool size, mapped blocks, queued / live /
    finished-unreleased / preempted request counts) so operators see WHY
    admission failed, not just that it did.  The key=value pairs are also
    appended to the message for plain-string consumers."""

    def __init__(self, message: str = "pool exhausted", **diag):
        if diag:
            message = (message + " ["
                       + " ".join(f"{k}={v}"
                                  for k, v in sorted(diag.items())) + "]")
        super().__init__(message)
        self.diag = diag


class AllocLedger:
    """Exact dry-run of a sequence of ``allocate_block`` calls.

    Success of a batch of new-vpn allocations is order-independent under
    the manager's policy: each new vpn consumes an empty way of its own
    set when one exists and exactly one FlexSeg slot otherwise (an
    evict-migrate moves the SRRIP victim into the flex slot the new
    block would have taken — same net count; with ``alloc_evicts=False``
    the block lands in the flex slot directly).  A snapshot of per-set
    empty-way counts plus the flex free-list length therefore predicts
    allocate_block outcomes exactly, letting the serving engine decide
    preemption BEFORE mutating any table — a failed real allocation
    would leave a SWAP-state BlockInfo (and a dropped KV write) behind.

    ``reserve`` is all-or-nothing and updates the snapshot on success,
    so one ledger can gate a whole admission round incrementally.  In
    ``restrictive_only`` mode allocation never "fails" (a set conflict
    swaps the block, Fig. 9 semantics), so every reserve succeeds.

    A failed reserve is not necessarily final: the engine's capacity
    gate first reclaims unreferenced prefix-cache entries
    (``PrefixCache.evict_one`` frees a FlexSeg slot each) and retries
    with a FRESH ledger — dropping clean cache is the cheapest rung of
    the overload ladder, below preemption.
    """

    def __init__(self, mgr: "HybridKVManager"):
        self._mode = mgr.cfg.mode
        self._hash = mgr.hash
        self._num_sets = mgr.cfg.num_sets
        self._flex = len(mgr.flex_free)
        self._empty = ((mgr.tar == 0).sum(axis=1).astype(np.int64)
                       if self._mode != "flexible_only" else None)

    def reserve(self, vpns) -> bool:
        """Would allocating every (currently unmapped) vpn succeed?
        All-or-nothing: on True the capacity is deducted from the
        snapshot; on False the snapshot is unchanged."""
        if self._mode == "restrictive_only":
            return True
        flex = self._flex
        empty = None if self._empty is None else self._empty.copy()
        for vpn in vpns:
            if empty is not None:
                st = int(self._hash(int(vpn), self._num_sets))
                if empty[st] > 0:
                    empty[st] -= 1
                    continue
            if flex <= 0:
                return False
            flex -= 1
        self._flex = flex
        if empty is not None:
            self._empty = empty
        return True


class HybridKVManager:
    def __init__(self, cfg: HybridConfig):
        self.cfg = cfg
        self.hash = get_hash(cfg.hash_name)
        ns, assoc = cfg.num_sets, cfg.assoc
        # RestSeg mirrors
        self.tar = np.zeros((ns, assoc), np.int32)   # vpn+1, 0 empty
        self.sf = np.zeros(ns, np.int32)
        self.srrip = SRRIP(ns, assoc)
        # FlexSeg
        self.flex_free: List[int] = list(
            range(cfg.rest_slots, cfg.total_slots))
        self.flex_table = -np.ones(
            (cfg.max_seqs, cfg.max_blocks_per_seq), np.int32)
        # global views
        self.blocks: Dict[int, BlockInfo] = {}       # vpn -> info
        self.slot_refcount: Dict[int, int] = defaultdict(int)  # flex sharing
        self.slot_owner = -np.ones(cfg.total_slots, np.int64)  # slot -> vpn
        # slots owned (in addition to any live mappings) by the prefix
        # cache (core/prefix_cache.py): each holds one extra refcount so
        # cached content survives every sequence release.  Invariant:
        # slot_refcount[s] == flex-table occupancy + (s in cached_slots)
        self.cached_slots: set = set()
        self.seq_lengths: Dict[int, int] = {}        # seq_slot -> tokens
        self._free_seq_slots = list(range(cfg.max_seqs - 1, -1, -1))
        self._seq_ids: Dict[int, int] = {}           # user seq id -> seq slot
        self.tracker = CostTracker(
            cfg.vpn_space,
            CostTrackerConfig(freq_threshold=cfg.promote_freq_threshold,
                              cost_threshold=cfg.promote_cost_threshold))
        self.pending_copies: List[Tuple[int, int]] = []  # (src_slot, dst_slot)
        self.stats = defaultdict(int)
        self.reuse_histogram = defaultdict(int)      # reuse level at eviction
        # per-vpn RSW-hit counters (vectorized stats feedback writes here;
        # read at eviction for the Fig. 26 histogram)
        self.reuse_counts = np.zeros(cfg.vpn_space, np.int32)
        # dirty-entry tracking for delta device sync: set indices whose
        # TAR/SF row changed, and flat flex-table indices that changed,
        # since the last take_dirty() drain
        self._dirty_sets: set = set()
        self._dirty_flex: set = set()
        # sharded serving (DESIGN.md §sharded-serving): when the engine
        # partitions the translation structures over a mesh, per-shard
        # translation counters are attributed HERE — the same call site
        # that mutates the global counters — so cross-shard sums equal
        # the globals by construction, never by reconciliation
        self.partition = None
        self.shard_stats: List[Dict[str, int]] = []

    def __getstate__(self):
        """Pickle support (engine snapshot/restore): the resolved hash
        callable may not be picklable (vectorized/partial-backed
        registries) — drop it and re-derive from ``cfg.hash_name``."""
        state = dict(self.__dict__)
        state.pop("hash", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.hash = get_hash(self.cfg.hash_name)

    def set_partition(self, partition) -> None:
        """Attach a :class:`core.partition.Partition`: every subsequent
        ``record_device_stats`` also attributes rsw_hits (to the shard
        owning the vpn's SET) and flex_walks (to the shard owning the
        vpn's flex-table ROW) per shard."""
        self.partition = partition
        self.shard_stats = [defaultdict(int)
                            for _ in range(partition.n_shards)]

    # ----------------------------------------------------------- sequences
    def register_sequence(self, seq_id: int) -> int:
        if seq_id in self._seq_ids:
            return self._seq_ids[seq_id]
        if not self._free_seq_slots:
            raise PoolExhausted("out of sequence slots")
        s = self._free_seq_slots.pop()
        self._seq_ids[seq_id] = s
        self.seq_lengths[s] = 0
        return s

    def seq_slot(self, seq_id: int) -> int:
        return self._seq_ids[seq_id]

    def free_sequence(self, seq_id: int) -> None:
        s = self._seq_ids.pop(seq_id)
        for b in range(self.cfg.max_blocks_per_seq):
            vpn = s * self.cfg.max_blocks_per_seq + b
            if vpn in self.blocks:
                self._release(vpn)
        del self.seq_lengths[s]
        self._free_seq_slots.append(s)

    # ------------------------------------- whole-sequence preempt / resume
    def preempt(self, seq_id: int) -> List[Tuple[int, bool]]:
        """Swap a whole live sequence out to the host tier.

        Extends the per-block SWAP state to sequence granularity: every
        mapped block is released through the shared :meth:`_release` path
        (TAR/SF clears, flex-table unmaps, dirty marks), each counted as
        a ``swap_out`` with reason ``preempt``.  Shared-prefix blocks
        only drop THIS sequence's reference — the refcount decrement
        leaves the co-owner's physical slot untouched, so a sharer is
        never swapped out from under its co-owner; the preempted
        sequence gets a private copy of the prefix on resume.  The
        sequence slot is freed too, so resume may land on a different
        slot (the engine re-uploads the saved KV against the new
        mapping).

        Returns ``[(block_idx, writable)]`` for every block that was
        mapped (slot >= 0) at preemption — the caller must have gathered
        those slots' device data BEFORE calling this.  Blocks already in
        per-block SWAP state hold no pool data and are simply dropped.
        """
        if self.cfg.mode == "restrictive_only":
            raise ValueError(
                "preempt/resume needs a flexible segment to keep swapped "
                "sequences restorable (hybrid or flexible_only mode)")
        s = self.seq_slot(seq_id)
        saved: List[Tuple[int, bool]] = []
        for b in range(self.cfg.max_blocks_per_seq):
            info = self.blocks.get(self.cfg.vpn(s, b))
            if info is not None and info.slot >= 0:
                saved.append((b, info.writable))
        self.free_sequence(seq_id)
        self._count_swap_out("preempt", len(saved))
        self.stats["preempt_out"] += 1
        return saved

    def resume(self, seq_id: int, saved: List[Tuple[int, bool]]
               ) -> Dict[int, int]:
        """Re-admit a preempted sequence: a fresh sequence slot and fresh
        physical slots for every saved block, preserving per-block
        writability.  Returns ``{block_idx: new_slot}`` so the caller can
        scatter the host-tier KV back.  Capacity must be checked FIRST
        via :meth:`alloc_ledger` — this raises ``PoolExhausted`` if a
        saved block cannot be mapped, leaving the partial registration
        for the caller to tear down."""
        self.register_sequence(seq_id)
        out: Dict[int, int] = {}
        for b, writable in saved:
            info = self.allocate_block(seq_id, b, writable,
                                       count_fault=False)
            if info.slot < 0:
                raise PoolExhausted(
                    f"resume of sequence {seq_id} could not map block {b}")
            out[b] = info.slot
        self._count_swap_in("resume", len(saved))
        self.stats["preempt_in"] += 1
        return out

    def alloc_ledger(self) -> AllocLedger:
        """Snapshot an :class:`AllocLedger` for exact capacity dry-runs."""
        return AllocLedger(self)

    # ----------------- swap accounting: ONE mutation point per direction
    def _count_swap_out(self, reason: str, n: int = 1) -> None:
        """Sole mutation point for ``stats["swap_out"]`` (Fig. 9).  The
        per-reason breakdown (``swap_out_conflict`` — restrictive-only
        set conflict, ``swap_out_pool`` — flexible segment exhausted,
        ``swap_out_evict`` — RestSeg eviction with nowhere to migrate,
        ``swap_out_preempt`` — whole-sequence host-tier offload) always
        sums to the total, cross-checked by :meth:`check_invariants`, so
        the paper-figure counters and the overload/preemption counters
        cannot drift apart."""
        self.stats["swap_out"] += n
        self.stats[f"swap_out_{reason}"] += n

    def _count_swap_in(self, reason: str, n: int = 1) -> None:
        """Sole mutation point for ``stats["swap_in"]`` (reasons:
        ``fault`` — a per-block swap_in on access, ``resume`` — a
        host-tier sequence restore)."""
        self.stats["swap_in"] += n
        self.stats[f"swap_in_{reason}"] += n

    def free_block(self, seq_id: int, block_idx: int) -> bool:
        """Deallocate ONE block of a live sequence (speculative decode:
        a rejected draft tail crossed a block boundary, so the block it
        faulted in holds nothing committed).  RestSeg/FlexSeg bookkeeping
        — TAR/SF clears, flex-table unmap, refcounts, dirty marks for the
        delta sync — is the shared :meth:`_release` path.  Returns False
        when the block is not mapped (already freed / never allocated)."""
        s = self.seq_slot(seq_id)
        vpn = self.cfg.vpn(s, block_idx)
        if vpn not in self.blocks:
            return False
        self._release(vpn)
        return True

    # ---------------------------------------------------------- allocation
    def allocate_block(self, seq_id: int, block_idx: int,
                       writable: bool = True, *,
                       count_fault: bool = True) -> BlockInfo:
        """Page-fault-based allocation (§5.5): RestSeg first.

        ``count_fault=False`` is the swap-in re-entry path: the block
        already faulted when it was first allocated, so bringing it back
        must count a ``swap_in`` (Fig. 9), not a fresh fault.
        """
        s = self.seq_slot(seq_id)
        vpn = self.cfg.vpn(s, block_idx)
        if vpn in self.blocks:
            return self.blocks[vpn]
        if count_fault:
            self.stats["faults"] += 1
        if self.cfg.mode != "flexible_only":
            info = self._try_rest_alloc(vpn, writable)
            if info is not None:
                return info
            if self.cfg.mode == "restrictive_only":
                # no flexible fallback: the conflicting block goes to swap
                self._count_swap_out("conflict")
                info = BlockInfo(vpn=vpn, seg=SWAP, slot=-1, writable=writable)
                self.blocks[vpn] = info
                return info
        return self._flex_alloc(vpn, writable)

    def _try_rest_alloc(self, vpn: int, writable: bool,
                        allow_evict: Optional[bool] = None) -> Optional[BlockInfo]:
        st = self.hash(vpn, self.cfg.num_sets)
        row = self.tar[st]
        empty = np.nonzero(row == 0)[0]
        if empty.size:
            return self._rest_place(vpn, st, int(empty[0]), writable)
        if allow_evict is None:
            allow_evict = self.cfg.alloc_evicts
        if not allow_evict:
            return None
        if self.cfg.mode == "restrictive_only":
            victim_way = self.srrip.victim(st, row != 0)
            self._rest_evict(st, victim_way, to_swap=True)
            return self._rest_place(vpn, st, victim_way, writable)
        if not self.flex_free:
            return None  # nowhere to migrate the victim
        victim_way = self.srrip.victim(st, row != 0)
        self._rest_evict(st, victim_way, to_swap=False)
        return self._rest_place(vpn, st, victim_way, writable)

    def _rest_place(self, vpn: int, st: int, way: int, writable: bool) -> BlockInfo:
        self.tar[st, way] = vpn + 1
        self.sf[st] += 1
        self._dirty_sets.add(st)
        self.reuse_counts[vpn] = 0
        self.srrip.on_insert(st, way)
        slot = st * self.cfg.assoc + way
        info = BlockInfo(vpn=vpn, seg=REST, slot=slot, writable=writable)
        self.blocks[vpn] = info
        self.slot_owner[slot] = vpn
        self.stats["rest_allocs"] += 1
        return info

    def _flex_alloc(self, vpn: int, writable: bool) -> BlockInfo:
        if not self.flex_free:
            self._count_swap_out("pool")
            info = BlockInfo(vpn=vpn, seg=SWAP, slot=-1, writable=writable)
            self.blocks[vpn] = info
            return info
        slot = self.flex_free.pop()
        s, b = divmod(vpn, self.cfg.max_blocks_per_seq)
        self.flex_table[s, b] = slot
        self._dirty_flex.add(vpn)
        info = BlockInfo(vpn=vpn, seg=FLEX, slot=slot, writable=writable)
        self.blocks[vpn] = info
        self.slot_refcount[slot] = 1
        self.slot_owner[slot] = vpn
        self.stats["flex_allocs"] += 1
        return info

    # ------------------------------------------------------------ eviction
    def _rest_evict(self, st: int, way: int, to_swap: bool) -> None:
        """Evict a RestSeg way; migrate the victim to the FlexSeg (or swap)."""
        victim_vpn = int(self.tar[st, way]) - 1
        assert victim_vpn >= 0
        info = self.blocks[victim_vpn]
        self.reuse_histogram[min(int(self.reuse_counts[victim_vpn]), 64)] += 1
        old_slot = info.slot
        self.tar[st, way] = 0
        self.sf[st] -= 1
        self._dirty_sets.add(st)
        self.srrip.on_remove(st, way)
        self.slot_owner[old_slot] = -1
        self.stats["rest_evictions"] += 1
        if to_swap or not self.flex_free:
            self._count_swap_out("evict")
            info.seg, info.slot = SWAP, -1
            return
        new_slot = self.flex_free.pop()
        s, b = divmod(victim_vpn, self.cfg.max_blocks_per_seq)
        self.flex_table[s, b] = new_slot
        self._dirty_flex.add(victim_vpn)
        info.seg, info.slot = FLEX, new_slot
        self.reuse_counts[victim_vpn] = 0
        self.slot_refcount[new_slot] = 1
        self.slot_owner[new_slot] = victim_vpn
        self.pending_copies.append((old_slot, new_slot))
        self.stats["migrations_rest_to_flex"] += 1

    def _sync_shared_refcounts(self, slot: int) -> None:
        """Propagate ``slot_refcount[slot]`` to EVERY BlockInfo mapping the
        slot.  A shared slot has one BlockInfo per sharing vpn; updating
        only the src (the pre-fix behaviour) left prior sharers with a
        stale refcount when a third sequence joined.  The sharers are
        recovered from the flex table (one vectorized scan), not by
        sweeping the whole block registry."""
        rc = self.slot_refcount.get(slot, 0)
        for s, b in np.argwhere(self.flex_table == slot):
            info = self.blocks.get(
                int(s) * self.cfg.max_blocks_per_seq + int(b))
            if info is not None:
                info.refcount = rc

    def _release(self, vpn: int) -> None:
        info = self.blocks[vpn]
        if info.seg == FLEX:
            s, b = divmod(vpn, self.cfg.max_blocks_per_seq)
            self.flex_table[s, b] = -1
            self._dirty_flex.add(vpn)
            self.slot_refcount[info.slot] -= 1
            if self.slot_refcount[info.slot] > 0:
                # another sequence still references the shared slot
                del self.blocks[vpn]
                self._sync_shared_refcounts(info.slot)
                return
            del self.slot_refcount[info.slot]
            if self.slot_owner[info.slot] == vpn:
                self.slot_owner[info.slot] = -1
            self.flex_free.append(info.slot)
        elif info.seg == REST:
            st = self.hash(vpn, self.cfg.num_sets)
            way = info.slot - st * self.cfg.assoc
            self.tar[st, way] = 0
            self.sf[st] -= 1
            self._dirty_sets.add(st)
            self.srrip.on_remove(st, way)
            self.slot_owner[info.slot] = -1
        del self.blocks[vpn]

    # ----------------------------------------------------------- promotion
    def record_device_stats(self, vpns: np.ndarray, in_rest: np.ndarray,
                            accesses: np.ndarray) -> None:
        """Feed back per-step device translation stats (paper: PTE counters).

        Fully vectorized: the RSW-hit way recovery is a batched TAR tag
        match (tar[h(vpn)] == vpn+1 iff the vpn is REST-resident), SRRIP
        promotion and reuse counting are one fancy-indexed write each —
        no per-vpn Python loop on the per-step path.
        """
        vpns = np.asarray(vpns).ravel().astype(np.int64)
        in_rest = np.asarray(in_rest).ravel().astype(bool)
        accesses = np.asarray(accesses).ravel()
        hits = vpns[in_rest]
        if hits.size:
            sts = np.asarray(self.hash(hits.astype(np.int32),
                                       self.cfg.num_sets))
            eq = self.tar[sts] == (hits[:, None] + 1)
            ok = eq.any(axis=1)                  # still REST-resident
            ways = eq.argmax(axis=1)
            self.srrip.on_hit_batch(sts[ok], ways[ok])
            np.add.at(self.reuse_counts, hits[ok], 1)
        self.stats["rsw_hits"] += int(in_rest.sum())
        miss = ~in_rest
        self.stats["flex_walks"] += int(miss.sum())
        if self.partition is not None:
            part = self.partition
            hit_sets = np.asarray(self.hash(vpns[in_rest].astype(np.int32),
                                            self.cfg.num_sets))
            hit_owner = part.shard_of_set(hit_sets)
            walk_owner = part.shard_of_vpn(vpns[miss])
            for s in range(part.n_shards):
                self.shard_stats[s]["rsw_hits"] += int((hit_owner == s).sum())
                self.shard_stats[s]["flex_walks"] += int(
                    (walk_owner == s).sum())
        if miss.any():
            self.tracker.record_walk(vpns[miss], accesses[miss])

    def run_promotions(self) -> int:
        """Migrate costly-to-translate FlexSeg blocks into the RestSeg."""
        if self.cfg.mode != "hybrid":
            return 0
        n = 0
        for vpn in self.tracker.take_promotions():
            info = self.blocks.get(int(vpn))
            if (info is None or info.seg != FLEX
                    or self.slot_refcount.get(info.slot, 1) > 1):
                continue  # shared blocks must stay flexible (paper §5.1)
            old_slot = info.slot
            placed = self._try_rest_alloc(int(vpn), info.writable,
                                          allow_evict=True)
            if placed is None:
                continue
            # _try_rest_alloc re-registered vpn; fix bookkeeping of old slot
            s, b = divmod(int(vpn), self.cfg.max_blocks_per_seq)
            self.flex_table[s, b] = -1
            self._dirty_flex.add(int(vpn))
            self.slot_refcount.pop(old_slot, None)
            self.flex_free.append(old_slot)
            if self.slot_owner[old_slot] == vpn:
                self.slot_owner[old_slot] = -1
            self.pending_copies.append((old_slot, placed.slot))
            self.stats["migrations_flex_to_rest"] += 1
            n += 1
        return n

    # ------------------------------------------------------------- sharing
    def share_prefix(self, src_seq_id: int, dst_seq_id: int,
                     n_blocks: int) -> int:
        """Map dst's first n_blocks onto src's physical slots (copy-on-share
        migration out of the RestSeg first: restrictive slots are tag-bound
        to a single vpn, the paper's sharing limitation)."""
        ss = self.seq_slot(src_seq_id)
        ds = self.seq_slot(dst_seq_id)
        shared = 0
        for b in range(n_blocks):
            src_vpn = self.cfg.vpn(ss, b)
            info = self.blocks.get(src_vpn)
            if info is None or info.seg == SWAP:
                continue
            if info.seg == REST:
                info = self._migrate_rest_to_flex(src_vpn)
                if info is None:
                    continue
            dst_vpn = self.cfg.vpn(ds, b)
            if dst_vpn in self.blocks:
                self._release(dst_vpn)
            self.slot_refcount[info.slot] += 1
            rc = self.slot_refcount[info.slot]
            self.flex_table[ds, b] = info.slot
            self._dirty_flex.add(dst_vpn)
            self.blocks[dst_vpn] = BlockInfo(
                vpn=dst_vpn, seg=FLEX, slot=info.slot,
                refcount=rc, writable=False)
            # every sharer's BlockInfo must see the new refcount, not just
            # the src: a third joiner previously left the second with a
            # stale count
            self._sync_shared_refcounts(info.slot)
            info.writable = False  # copy-on-write semantics after sharing
            self.stats["shared_blocks"] += 1
            shared += 1
        return shared

    def _migrate_rest_to_flex(self, vpn: int) -> Optional[BlockInfo]:
        if not self.flex_free:
            return None
        info = self.blocks[vpn]
        st = self.hash(vpn, self.cfg.num_sets)
        way = info.slot - st * self.cfg.assoc
        old_slot = info.slot
        self.tar[st, way] = 0
        self.sf[st] -= 1
        self._dirty_sets.add(st)
        self.srrip.on_remove(st, way)
        self.slot_owner[old_slot] = -1
        new_slot = self.flex_free.pop()
        s, b = divmod(vpn, self.cfg.max_blocks_per_seq)
        self.flex_table[s, b] = new_slot
        self._dirty_flex.add(vpn)
        info.seg, info.slot = FLEX, new_slot
        self.slot_refcount[new_slot] = 1
        self.slot_owner[new_slot] = vpn
        self.pending_copies.append((old_slot, new_slot))
        self.stats["migrations_rest_to_flex"] += 1
        return info

    # ------------------------------------- prefix-cache slot ownership
    def cache_pin_block(self, seq_id: int, block_idx: int) -> Optional[int]:
        """Give the prefix cache a reference on a live block's slot.

        Same copy-on-share rules as :meth:`share_prefix`: the block must
        live in the FlexSeg (a restrictive slot is tag-bound to one vpn),
        so a REST-resident block migrates first — and the pin fails
        (``None``) when the block is swapped, unmapped, already cached,
        or no FlexSeg slot is free to migrate into.  On success the
        slot's refcount grows by one CACHE reference (not tied to any
        sequence), the block becomes read-only, and the slot is recorded
        in ``cached_slots`` for the invariant cross-check.
        """
        s = self.seq_slot(seq_id)
        vpn = self.cfg.vpn(s, block_idx)
        info = self.blocks.get(vpn)
        if info is None or info.seg == SWAP:
            return None
        if info.seg == REST:
            info = self._migrate_rest_to_flex(vpn)
            if info is None:
                return None
        if info.slot in self.cached_slots:
            return None  # one cache entry per physical slot
        self.slot_refcount[info.slot] += 1
        self.cached_slots.add(info.slot)
        info.writable = False  # cached content is immutable
        self._sync_shared_refcounts(info.slot)
        self.stats["cache_pinned_blocks"] += 1
        return info.slot

    def cache_unpin_slot(self, slot: int) -> None:
        """Drop the cache's reference on a slot (entry evicted).  When
        that was the last reference the slot returns to the free list;
        otherwise live attachers keep it (their refcounts re-synced)."""
        assert slot in self.cached_slots, f"slot {slot} not cache-owned"
        self.cached_slots.discard(slot)
        self.slot_refcount[slot] -= 1
        if self.slot_refcount[slot] <= 0:
            del self.slot_refcount[slot]
            self.slot_owner[slot] = -1
            self.flex_free.append(slot)
        else:
            self._sync_shared_refcounts(slot)

    def attach_cached_block(self, seq_id: int, block_idx: int,
                            slot: int) -> BlockInfo:
        """Map a sequence block onto a cache-owned slot, read-only.

        The cache-hit analogue of the dst half of :meth:`share_prefix`:
        the new vpn joins the slot's sharers (refcount + flex-table
        entry + dirty mark for the delta sync) without copying KV —
        the whole point of content-addressed dedup.
        """
        assert slot in self.cached_slots, f"slot {slot} not cache-owned"
        s = self.seq_slot(seq_id)
        vpn = self.cfg.vpn(s, block_idx)
        if vpn in self.blocks:
            self._release(vpn)
        self.slot_refcount[slot] += 1
        self.flex_table[s, block_idx] = slot
        self._dirty_flex.add(vpn)
        info = BlockInfo(vpn=vpn, seg=FLEX, slot=slot,
                         refcount=self.slot_refcount[slot], writable=False)
        self.blocks[vpn] = info
        self._sync_shared_refcounts(slot)
        self.stats["shared_blocks"] += 1
        self.stats["cache_attached_blocks"] += 1
        return info

    # ----------------------------------------------------------- swap path
    def swap_in(self, seq_id: int, block_idx: int) -> BlockInfo:
        """Bring a swapped block back (counts a swap access, Fig. 9)."""
        s = self.seq_slot(seq_id)
        vpn = self.cfg.vpn(s, block_idx)
        info = self.blocks.get(vpn)
        if info is None or info.seg != SWAP:
            raise ValueError(f"vpn {vpn} not in swap")
        self._count_swap_in("fault")
        del self.blocks[vpn]
        return self.allocate_block(seq_id, block_idx, info.writable,
                                   count_fault=False)

    # ------------------------------------------------------------- lookups
    def lookup(self, seq_id: int, block_idx: int) -> Tuple[int, int]:
        """Host-side translate; returns (slot, seg)."""
        s = self.seq_slot(seq_id)
        vpn = self.cfg.vpn(s, block_idx)
        info = self.blocks.get(vpn)
        if info is None:
            return -1, -1
        return info.slot, info.seg

    def take_pending_copies(self) -> List[Tuple[int, int]]:
        out, self.pending_copies = self.pending_copies, []
        self.stats["copies_issued"] += len(out)
        return out

    def take_dirty(self) -> Tuple[np.ndarray, np.ndarray]:
        """Drain the dirty-entry sets accumulated since the last call.

        Returns (set_indices, flat_flex_indices): the TAR/SF rows and the
        flat flex-table entries a delta device sync must re-upload.
        """
        sets = np.array(sorted(self._dirty_sets), np.int64)
        flex = np.array(sorted(self._dirty_flex), np.int64)
        self._dirty_sets.clear()
        self._dirty_flex.clear()
        return sets, flex

    # --------------------------------------------------------- device view
    def device_state(self, device="cuda"):
        """Pack host mirrors into a device TranslationState (torch
        tensors on ``device``; fresh copies, never views of the host
        tables)."""
        import torch
        from .flex_table import FlexTable
        from .tar_sf import RestSegState
        from .translate import TranslationState
        tar = torch.tensor(self.tar, device=device)
        return TranslationState(
            rest=RestSegState(tar=tar,
                              sf=torch.tensor(self.sf, device=device),
                              meta=torch.zeros_like(tar)),
            flex=FlexTable(table=torch.tensor(self.flex_table,
                                              device=device)),
            rest_base=torch.zeros((), dtype=torch.int32, device=device),
            max_blocks_per_seq=self.cfg.max_blocks_per_seq,
            hash_name=self.cfg.hash_name,
        )

    def slot_owner_array(self) -> np.ndarray:
        """slot -> vpn inverse map (slot-major attention layout)."""
        return self.slot_owner.copy()

    # ---------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        """Debug/property-test oracle: structural consistency."""
        assert (self.sf == (self.tar != 0).sum(axis=1)).all(), "SF != TAR occupancy"
        for vpn, info in self.blocks.items():
            if info.seg == REST:
                st = self.hash(vpn, self.cfg.num_sets)
                way = info.slot - st * self.cfg.assoc
                assert 0 <= way < self.cfg.assoc, f"slot {info.slot} not in set {st}"
                assert self.tar[st, way] == vpn + 1, "TAR tag mismatch"
                assert self.slot_owner[info.slot] == vpn
            elif info.seg == FLEX:
                s, b = divmod(vpn, self.cfg.max_blocks_per_seq)
                assert self.flex_table[s, b] == info.slot, "flex table mismatch"
                assert info.slot >= self.cfg.rest_slots
                assert info.refcount == self.slot_refcount.get(info.slot), \
                    (f"BlockInfo.refcount {info.refcount} stale for slot "
                     f"{info.slot} (slot_refcount="
                     f"{self.slot_refcount.get(info.slot)})")
        mapped_flex = set(int(x) for x in self.flex_table.ravel() if x >= 0)
        free_flex = set(self.flex_free)
        assert not (mapped_flex & free_flex), "slot both mapped and free"
        # slot_refcount must equal flex-table occupancy plus the prefix
        # cache's own reference exactly: each refcount is the number of
        # (seq, block) flex entries mapping the slot, +1 iff the cache
        # pinned it (the cache-ownership cross-check — a rogue
        # release of a cached slot, or a cache pin that leaked, breaks
        # this equality immediately)
        occ: Dict[int, int] = defaultdict(int)
        for x in self.flex_table.ravel():
            if x >= 0:
                occ[int(x)] += 1
        want = dict(occ)
        for slot in self.cached_slots:
            want[slot] = want.get(slot, 0) + 1
        rc = {s: c for s, c in self.slot_refcount.items() if c != 0}
        assert rc == want, \
            (f"slot_refcount {rc} != flex occupancy + cache refs {want} "
             f"(cached_slots={sorted(self.cached_slots)})")
        for slot in self.cached_slots:
            assert slot >= self.cfg.rest_slots, \
                f"cached slot {slot} is in the RestSeg (must be FlexSeg)"
            assert slot not in free_flex, \
                f"cached slot {slot} is also on the free list"
            for s, b in np.argwhere(self.flex_table == slot):
                info = self.blocks.get(
                    int(s) * self.cfg.max_blocks_per_seq + int(b))
                assert info is None or not info.writable, \
                    f"cached slot {slot} has a WRITABLE live mapping"
        # every mapped block must belong to a REGISTERED sequence: a
        # preempted/freed sequence leaving blocks behind is a pool leak
        for vpn in self.blocks:
            assert vpn // self.cfg.max_blocks_per_seq in self.seq_lengths, \
                f"block vpn {vpn} belongs to an unregistered sequence"
        # swap accounting: the totals are mutated ONLY through
        # _count_swap_out/_count_swap_in, so they must equal their
        # per-reason breakdowns exactly (Fig. 9 vs preemption counters)
        for d in ("swap_out", "swap_in"):
            parts = sum(v for k, v in self.stats.items()
                        if k.startswith(d + "_"))
            assert self.stats.get(d, 0) == parts, \
                (f"stats[{d!r}]={self.stats.get(d, 0)} != sum of "
                 f"per-reason counters {parts}")
        # sharded serving: per-shard attribution must sum EXACTLY to the
        # global counters (same mutation site, so drift is a bug)
        if self.partition is not None:
            for key in ("rsw_hits", "flex_walks"):
                total = sum(s.get(key, 0) for s in self.shard_stats)
                assert total == self.stats.get(key, 0), \
                    (f"per-shard {key} sum {total} != global "
                     f"{self.stats.get(key, 0)}")
