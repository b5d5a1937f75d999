"""Utopia-native global prefix cache: content-addressed KV dedup.

A copy of ``repro.core.prefix_cache`` (pure numpy; the port keeps its own
so that it never imports the JAX package).

The paper's restrictive mapping is a hash-indexed, set-associative
content->physical map with compact tags.  This module reuses exactly
that structure as an AUTOMATIC, engine-wide prompt-prefix cache: the
"content" being mapped is a hash CHAIN over prompt blocks —

    chain_0 = H(CHAIN_SEED,  tokens[0:bs])
    chain_k = H(chain_{k-1}, tokens[k*bs:(k+1)*bs])

at KV-block granularity (``H`` built from :func:`core.hashes.mix32`,
the same int32-safe family the RestSeg set index uses), so a chain hash
identifies a whole prefix, not just a block, and two prompts share a
cache entry iff they share every token up to and including that block.

Directory layout — the RestSeg recipe, one level up:

* ``num_sets x assoc`` ways, the set index = ``hash(chain, num_sets)``
  with the manager's configured hash function (paper §8.3.8 family);
* SRRIP re-reference prediction over the ways of each set (the same
  :class:`core.policies.SRRIP` the RestSeg eviction uses), aged on
  insert, promoted on every prefix match;
* an entry pins one FlexSeg pool slot via the manager's refcount
  machinery (``cache_pin_block`` / ``cache_unpin_slot``): physical
  sharing MUST live in the flexible segment — a restrictive slot is
  tag-bound to a single vpn, the paper's own sharing limitation — so
  pinning copy-on-share migrates REST-resident blocks out first, just
  like ``share_prefix``.

Ownership / eviction rules (cross-checked by ``check_invariants``):

* a cached slot's ``slot_refcount`` == live attachers + 1 (the cache's
  own reference), so a cached block survives every sequence release;
* only UNREFERENCED entries (refcount == 1, cache-only) are eviction
  victims — a block a live sequence reads is never dropped from under
  it, and cached blocks are never writable, so a cache hit can never
  observe a torn write;
* capacity pressure reclaims cache-only entries before any live
  sequence is preempted (the cheapest rung of the engine's overload
  ladder — dropping clean cache frees a slot for free).

Bit-identity contract: entries verify the EXACT block tokens (the hash
only routes; collisions cannot alias), and the pool bytes behind an
entry are whatever the writer's prefill installed — which the prefix-KV
differential oracle pins bitwise against the blocking recompute of the
same tokens, independent of chunk schedule or pow2 padding.  A cache
hit therefore feeds the prefix-KV chunk path the same bytes the
request's own prefill would have written, and cache-on streams are
bit-identical to cache-off.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import List, Optional

import numpy as np

from .hashes import get_hash, mix32
from .policies import SRRIP

# chain root: any odd int32 constant; shared by every engine so caches
# built over the same tokens agree across processes
CHAIN_SEED = 0x3C6EF372 & 0x7FFFFFFF


def block_hash_chain(tokens, block_size: int) -> np.ndarray:
    """Per-block chained content hashes of a token sequence.

    Within a block, order is captured by a per-position multiplier (one
    vectorized ``mix32`` pass over all blocks at once); across blocks
    the digests fold sequentially into the parent chain — only this
    short loop (#blocks iterations) is sequential.  Returns int64
    values in ``[0, 2^31)``; trailing tokens short of a full block are
    ignored (the cache stores whole KV blocks only).
    """
    t = np.asarray(tokens, np.int64)
    n = t.size // block_size
    if n == 0:
        return np.zeros(0, np.int64)
    t = t[:n * block_size].reshape(n, block_size)
    pos = mix32((np.arange(block_size, dtype=np.int64) + 131) & 0x7FFFFFFF)
    with np.errstate(over="ignore"):          # int64 wrap is deterministic
        digests = np.bitwise_xor.reduce(
            mix32(((t + 1) * (pos + 1)) & 0x7FFFFFFF), axis=1)
    out = np.empty(n, np.int64)
    h = CHAIN_SEED
    for k in range(n):
        h = int(mix32((h ^ int(digests[k])) & 0x7FFFFFFF))
        out[k] = h
    return out


@dataclasses.dataclass
class CacheEntry:
    """One cached prefix block: content identity + pinned pool slot."""
    chain: int            # chain hash of the prefix ending at this block
    parent: int           # parent chain hash (CHAIN_SEED for block 0)
    tokens: np.ndarray    # exact block tokens — hash collisions cannot alias
    slot: int             # FlexSeg pool slot, cache-pinned in the manager


class PrefixCache:
    """Set-associative content->physical directory over the KV pool."""

    def __init__(self, manager, num_sets: Optional[int] = None,
                 assoc: int = 4, hash_name: Optional[str] = None):
        self.mgr = manager
        cfg = manager.cfg
        self.assoc = assoc
        # directory capacity ~ the pool: every slot could in principle
        # be cached, and a too-small directory would thrash via SRRIP
        # instead of via pool pressure
        self.num_sets = (max(1, cfg.total_slots // assoc)
                         if num_sets is None else num_sets)
        self.hash_name = hash_name or cfg.hash_name
        self.hash = get_hash(self.hash_name)
        self.srrip = SRRIP(self.num_sets, assoc)
        self.ways: List[List[Optional[CacheEntry]]] = [
            [None] * assoc for _ in range(self.num_sets)]
        self._n = 0
        self.stats = defaultdict(int)

    @property
    def n_entries(self) -> int:
        return self._n

    def __getstate__(self):
        """Pickle support (engine snapshot/restore): drop the resolved
        hash callable, re-derive from the stored name on load.  ``mgr``
        pickles along WITH the cache — inside an engine snapshot the
        memo keeps it the same object as the engine's manager."""
        state = dict(self.__dict__)
        state.pop("hash", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.hash = get_hash(self.hash_name)

    # -------------------------------------------------------------- lookup
    def _find(self, chain: int, parent: int, tokens: np.ndarray
              ) -> Optional[CacheEntry]:
        st = int(self.hash(int(chain), self.num_sets))
        for w, e in enumerate(self.ways[st]):
            if (e is not None and e.chain == chain and e.parent == parent
                    and np.array_equal(e.tokens, tokens)):
                self.srrip.on_hit(st, w)        # re-referenced: promote
                return e
        return None

    def match(self, tokens, chains: Optional[np.ndarray] = None
              ) -> List[CacheEntry]:
        """Longest cached prefix of ``tokens``: one entry per matched
        block, walking the chain from the root and stopping at the
        first miss.  Every matched way is SRRIP-promoted."""
        bs = self.mgr.cfg.block_size
        t = np.asarray(tokens, np.int64)
        if chains is None:
            chains = block_hash_chain(t, bs)
        out: List[CacheEntry] = []
        parent = CHAIN_SEED
        for k in range(t.size // bs):
            e = self._find(int(chains[k]), parent, t[k * bs:(k + 1) * bs])
            if e is None:
                break
            out.append(e)
            parent = int(chains[k])
        return out

    # ------------------------------------------------------------- insert
    def _evictable(self, e: CacheEntry) -> bool:
        # cache-only: the pin is the sole reference — no live attacher
        return self.mgr.slot_refcount.get(e.slot, 0) == 1

    def _evict(self, st: int, way: int) -> None:
        e = self.ways[st][way]
        self.ways[st][way] = None
        self._n -= 1
        self.srrip.on_remove(st, way)
        self.mgr.cache_unpin_slot(e.slot)
        self.stats["evictions"] += 1

    def insert(self, chain: int, parent: int, tokens, seq_id: int,
               block_idx: int) -> bool:
        """Publish a freshly installed prompt block.

        Pins the block's physical slot under cache ownership (migrating
        it out of the RestSeg if needed — restrictive slots cannot be
        shared).  A full set evicts an UNREFERENCED way via SRRIP; a
        pin that fails because the FlexSeg has no free slot to migrate
        into reclaims unreferenced entries (``evict_one``) and retries.
        When every way is live-referenced, every entry is attached, or
        the block is swapped, the insert bypasses — the cache never
        blocks a live sequence.  Returns True iff a new entry was
        placed.
        """
        tok = np.asarray(tokens, np.int64)
        if self._find(chain, parent, tok) is not None:
            return False                       # already cached: dedup
        st = int(self.hash(int(chain), self.num_sets))
        row = self.ways[st]
        way = next((w for w, e in enumerate(row) if e is None), None)
        if way is None:
            mask = np.fromiter((e is not None and self._evictable(e)
                                for e in row), bool, self.assoc)
            if not mask.any():
                self.stats["insert_bypass"] += 1
                return False
            way = int(self.srrip.victim(st, mask))
            self._evict(st, way)
        slot = self.mgr.cache_pin_block(seq_id, block_idx)
        # pin failure with an EMPTY FlexSeg free list is a capacity
        # miss (a REST block with nowhere to migrate): reclaim our own
        # unreferenced entries and retry — old resident prefixes must
        # not starve new ones.  Any other failure (swapped, unmapped,
        # slot already cached) is final; the free-list guard exits the
        # loop after at most one eviction in those cases.
        while slot is None and not self.mgr.flex_free \
                and self.evict_one():
            slot = self.mgr.cache_pin_block(seq_id, block_idx)
        if slot is None:
            self.stats["insert_bypass"] += 1
            return False
        row[way] = CacheEntry(chain=int(chain), parent=int(parent),
                              tokens=np.array(tok, copy=True), slot=slot)
        self._n += 1
        self.srrip.on_insert(st, way)
        self.stats["inserts"] += 1
        return True

    # ----------------------------------------------------------- eviction
    def evict_one(self) -> bool:
        """Reclaim ONE unreferenced entry (capacity ladder rung): frees
        its pool slot back to the FlexSeg.  Returns False when every
        entry is attached by a live sequence."""
        for st in range(self.num_sets):
            row = self.ways[st]
            mask = np.fromiter((e is not None and self._evictable(e)
                                for e in row), bool, self.assoc)
            if mask.any():
                self._evict(st, int(self.srrip.victim(st, mask)))
                return True
        return False

    def evictable_count(self) -> int:
        return sum(1 for row in self.ways for e in row
                   if e is not None and self._evictable(e))

    # --------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        """Directory <-> manager consistency: every entry sits in its
        hash set, pins a distinct slot the manager also believes is
        cache-owned, and the counts agree (the manager's own
        ``check_invariants`` asserts refcount == attachers + pin)."""
        m = self.mgr
        slots: List[int] = []
        n = 0
        for st in range(self.num_sets):
            for e in self.ways[st]:
                if e is None:
                    continue
                n += 1
                assert int(self.hash(int(e.chain), self.num_sets)) == st, \
                    f"entry chain {e.chain} filed in the wrong set {st}"
                assert e.slot in m.cached_slots, \
                    f"cache entry slot {e.slot} not pinned in the manager"
                assert m.slot_refcount.get(e.slot, 0) >= 1, \
                    f"cached slot {e.slot} lost its pin refcount"
                slots.append(e.slot)
        assert len(slots) == len(set(slots)), \
            "two cache entries share one pool slot"
        assert set(slots) == m.cached_slots, \
            (f"directory slots {sorted(set(slots))} != manager "
             f"cached_slots {sorted(m.cached_slots)}")
        assert n == self._n, "entry counter drifted"
