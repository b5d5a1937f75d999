"""Tag Array (TAR) + Set Filter (SF): RestSeg translation structures.

Device side, in torch.  The host allocator in ``kv_manager.py`` keeps a
numpy mirror of the same arrays; both sides share the hash functions in
``hashes.py`` so they agree bit for bit.  The serving engine keeps one
device copy of each table and updates it in place with the host's dirty
deltas (``serve/engine.py::Engine._sync_translation``).

Encoding: a TAR entry stores ``vpn + 1`` (0 = invalid/empty way).

Paper §5.2 (RestSeg Walk):
  set   = hash(vpn) % n_sets
  SF[set] == 0  -> miss without touching TAR   (set filtering)
  else          -> compare vpn+1 against the M way tags (tag matching)
  slot  = set * assoc + way                     (restrictive mapping)

``rsw`` here is the plain torch version; the decode step runs the CUDA
kernel in ``kernels/utopia_rsw`` on the card, held to this function.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .hashes import get_hash


class RestSegState(NamedTuple):
    """Translation state of one RestSeg (device tensors)."""

    tar: torch.Tensor    # (n_sets, assoc) int32: vpn+1, 0 = empty
    sf: torch.Tensor     # (n_sets,)       int32: set occupancy counter
    meta: torch.Tensor   # (n_sets, assoc) int32: 10 metadata bits

    @property
    def n_sets(self) -> int:
        return self.tar.shape[0]

    @property
    def assoc(self) -> int:
        return self.tar.shape[1]


class TranslationState(NamedTuple):
    """Everything the device needs to translate vpn -> global pool slot
    (``HybridKVManager.device_state``)."""

    rest: RestSegState
    flex_table: torch.Tensor    # (max_seqs, max_blocks_per_seq) int32, -1
    max_blocks_per_seq: int
    hash_name: str = "modulo"


class RSWResult(NamedTuple):
    hit: torch.Tensor        # bool  — vpn resides in the RestSeg
    slot: torch.Tensor       # int32 — global RestSeg slot; 0 if miss
    way: torch.Tensor        # int32 — way index; -1 if miss
    sf_skipped: torch.Tensor  # bool — SF counter was 0: TAR lookup skipped
    tar_touched: torch.Tensor  # int32 — tag comparisons actually performed


def probe_rows(tags: torch.Tensor, counters: torch.Tensor,
               vpn: torch.Tensor):
    """SF ∥ TAR probe of PRE-GATHERED set rows.

    ``tags (..., assoc)`` and ``counters (...)`` are the TAR row and SF
    counter of each vpn's set.  A zero tag never matches (tags store
    ``vpn+1``) and an SF counter of 0 skips the TAR compare.  The way is
    the FIRST matching one.  Returns ``(hit, way, sf_skipped)`` shaped
    like ``vpn``.
    """
    eq = tags == (vpn.to(torch.int32) + 1).unsqueeze(-1)
    nonempty = counters > 0
    hit = eq.any(dim=-1) & nonempty
    # argmax does not take bool: cast first (ties -> first index)
    first = eq.to(torch.int32).argmax(dim=-1).to(torch.int32)
    way = torch.where(hit, first, torch.full_like(first, -1))
    return hit, way, ~nonempty


def rsw(state: RestSegState, vpn: torch.Tensor,
        hash_name: str = "modulo") -> RSWResult:
    """Batched RestSeg Walk.  ``vpn``: int32 tensor of any shape, >= 0
    (the hashes' ``%`` and ``>>`` agree with the kernel's only there)."""
    h = get_hash(hash_name)
    set_idx = h(vpn.to(torch.int32), state.n_sets).to(torch.int32)
    counters = state.sf[set_idx.long()]
    tags = state.tar[set_idx.long()]
    hit, way, sf_skipped = probe_rows(tags, counters, vpn)
    slot = torch.where(hit, set_idx * state.assoc + way.clamp(min=0),
                       torch.zeros_like(set_idx))
    tar_touched = torch.where(sf_skipped, 0, state.assoc).to(torch.int32)
    return RSWResult(hit=hit, slot=slot.to(torch.int32), way=way,
                     sf_skipped=sf_skipped, tar_touched=tar_touched)
