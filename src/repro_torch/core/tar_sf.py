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

``rsw`` here is the plain torch version; the decode step and
``core.translate`` run the CUDA kernel in ``kernels/utopia_rsw`` on the
card, held to this function.  ``insert``/``remove`` are the functional
device mirror of the host allocator's single-entry updates (allocation is
decided host-side), used by the tests.
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


def init_restseg(n_sets: int, assoc: int, device="cuda") -> RestSegState:
    return RestSegState(
        tar=torch.zeros((n_sets, assoc), dtype=torch.int32, device=device),
        sf=torch.zeros((n_sets,), dtype=torch.int32, device=device),
        meta=torch.zeros((n_sets, assoc), dtype=torch.int32, device=device),
    )


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


def _scalar(x, state: RestSegState) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=state.tar.device)


def insert(state: RestSegState, vpn, way, hash_name: str = "modulo",
           meta_bits: int = 1) -> RestSegState:
    """Functional single-entry insert at a chosen way: a new state, the
    given one unchanged."""
    vpn, way = _scalar(vpn, state), _scalar(way, state).long()
    set_idx = get_hash(hash_name)(vpn, state.n_sets).long()
    was_empty = state.tar[set_idx, way] == 0
    tar, meta, sf = state.tar.clone(), state.meta.clone(), state.sf.clone()
    tar[set_idx, way] = vpn + 1
    meta[set_idx, way] = meta_bits
    sf[set_idx] += was_empty.to(torch.int32)
    return RestSegState(tar=tar, sf=sf, meta=meta)


def remove(state: RestSegState, vpn,
           hash_name: str = "modulo") -> RestSegState:
    """Functional removal of ``vpn``'s way (a new state; unchanged values
    when the RSW misses it)."""
    vpn = _scalar(vpn, state)
    res = rsw(state, vpn[None], hash_name)
    hit = res.hit[0]
    set_idx = get_hash(hash_name)(vpn, state.n_sets).long()
    way = res.way[0].clamp(min=0).long()
    tar, meta, sf = state.tar.clone(), state.meta.clone(), state.sf.clone()
    tar[set_idx, way] = torch.where(hit, 0, state.tar[set_idx, way])
    meta[set_idx, way] = torch.where(hit, 0, state.meta[set_idx, way])
    sf[set_idx] -= hit.to(torch.int32)
    return RestSegState(tar=tar, sf=sf, meta=meta)


def structure_bytes(state: RestSegState, vpn_space_bits: int = 32) -> dict:
    """Actual byte footprint of the packed structures (Fig. 13 accounting)."""
    n_sets, assoc = state.tar.shape
    set_bits = max(1, (n_sets - 1).bit_length())
    tag_bits = max(1, vpn_space_bits - set_bits) + 10
    counter_bits = max(1, (assoc).bit_length())
    return {
        "tar_bytes": (n_sets * assoc * tag_bits + 7) // 8,
        "sf_bytes": (n_sets * counter_bits + 7) // 8,
    }
