"""Hybrid translation flow (paper §5.4) — device side, in torch.

On every translation request the RestSeg walk (RSW) runs *in parallel* with
the flexible path; only requests that miss the RestSeg pay the flexible
walk.  This module is the instrumented translation of the paper's
comparison: Utopia's hybrid ``translate`` over the flat flex table, and the
baselines' flexible backends (radix, ECH, POM-TLB), with access and byte
accounting.

Every RestSeg walk here goes through the RSW kernel's wrapper
(``kernels/utopia_rsw``, its vpn-list entry), which launches the kernel on
CUDA tensors and runs its plain version on CPU tensors: ``translate``
calls it once and derives its byte accounting from ``accesses`` and
``in_rest``, and ``translate_radix`` calls it over a flex table of -1 for
the RSW half.  The baselines' own lookups (the radix walk, the ECH probes,
the POM-TLB probe) are eager torch on either device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .ech import ECHState
from .flex_table import FlexTable, RadixTable
from .pom_tlb import POMTLBState
from .tar_sf import RestSegState


class TranslationState(NamedTuple):
    """Everything the device needs to translate vpn -> global pool slot."""

    rest: RestSegState
    flex: FlexTable
    rest_base: torch.Tensor     # () int32: RestSeg slot offset in pool (0)
    max_blocks_per_seq: int
    hash_name: str = "modulo"


class TranslateResult(NamedTuple):
    slot: torch.Tensor        # int32 global pool slot (-1 unmapped)
    mapped: torch.Tensor      # bool
    in_rest: torch.Tensor     # bool — resolved by the RestSeg walk
    accesses: torch.Tensor    # int32 translation-structure accesses performed
    bytes_touched: torch.Tensor  # int32 translation metadata bytes moved


def _rsw_kernel(rest: RestSegState, vpn: torch.Tensor, hash_name: str,
                flex_flat: torch.Tensor, max_blocks_per_seq: int = 0):
    """One call of the RSW kernel's vpn-list entry over ``vpn`` (any
    shape): (slot, in_rest, mapped, accesses), int32, shaped like ``vpn``.
    The wrapper launches the kernel on a card and runs its plain version
    on the CPU, and raises for inputs on more than one device."""
    from repro_torch.kernels.utopia_rsw.ops import utopia_rsw
    out = utopia_rsw(vpn.to(torch.int32).reshape(-1).contiguous(),
                     rest.tar, rest.sf, flex_flat, hash_name=hash_name,
                     max_blocks_per_seq=max_blocks_per_seq)
    return tuple(t.view(vpn.shape) for t in out)


def translate(state: TranslationState, vpn: torch.Tensor,
              tag_entry_bytes: int = 6, flex_entry_bytes: int = 8
              ) -> TranslateResult:
    """Hybrid translate.  ``vpn`` int32 tensor, any shape.

    Access accounting: RSW = SF probe (1 access, counter bytes) + TAR set
    read when SF > 0 (assoc tags); flexible walk = 1 flat-table access (the
    radix variant is benchmarked separately via ``translate_radix``).
    The flex table is read as ``FlexTable.lookup_vpn`` reads it, out-of-
    range vpns included.
    """
    rest = state.rest
    slot, in_rest, mapped, accesses = _rsw_kernel(
        rest, vpn, state.hash_name, state.flex.table.reshape(-1),
        state.max_blocks_per_seq)
    # accesses = 1 + (SF > 0) + (1 - in_rest): the TAR read follows
    sf_nonempty = accesses - 2 + in_rest
    bytes_touched = (1 + sf_nonempty * (rest.assoc * tag_entry_bytes)
                     + (1 - in_rest) * flex_entry_bytes)
    return TranslateResult(
        slot=(slot + state.rest_base * in_rest).to(torch.int32),
        mapped=mapped.bool(), in_rest=in_rest.bool(), accesses=accesses,
        bytes_touched=bytes_touched.to(torch.int32))


# --- benchmark variants: alternative flexible backends ---------------------

def translate_radix(rest: Optional[RestSegState], radix: RadixTable,
                    vpn: torch.Tensor, hash_name: str = "modulo",
                    entry_bytes: int = 8,
                    rest_base: int = 0) -> TranslateResult:
    """Hybrid (or pure when rest=None) translation over the radix baseline.

    ``rest_base`` is the RestSeg's slot offset in the global pool, exactly
    as in ``translate()`` — RSW hits resolve to ``rest_base + r.slot``.
    """
    flex_slot, flex_ok, walk_acc = radix.walk(vpn)
    if rest is None:
        return TranslateResult(slot=flex_slot, mapped=flex_ok,
                               in_rest=torch.zeros_like(flex_ok),
                               accesses=walk_acc,
                               bytes_touched=walk_acc * entry_bytes)
    # the kernel over a flex table of -1: a miss resolves to -1, and the
    # SF's verdict follows from the accesses
    no_flex = torch.full((1,), -1, dtype=torch.int32, device=vpn.device)
    r_slot, in_rest, _, acc = _rsw_kernel(rest, vpn, hash_name, no_flex)
    hit = in_rest.bool()
    sf_nonempty = acc - 2 + in_rest
    slot = torch.where(hit, rest_base + r_slot, flex_slot)
    mapped = hit | flex_ok
    accesses = 1 + sf_nonempty + torch.where(hit, 0, walk_acc)
    byt = (1 + sf_nonempty * (rest.assoc * 6)
           + torch.where(hit, 0, walk_acc * entry_bytes))
    return TranslateResult(slot=slot.to(torch.int32), mapped=mapped,
                           in_rest=hit, accesses=accesses.to(torch.int32),
                           bytes_touched=byt.to(torch.int32))


def translate_ech(ech: ECHState, vpn: torch.Tensor,
                  entry_bytes: int = 8) -> TranslateResult:
    slot, hit, acc = ech.lookup(vpn)
    return TranslateResult(slot=slot, mapped=hit,
                           in_rest=torch.zeros_like(hit),
                           accesses=acc, bytes_touched=acc * entry_bytes)


def translate_pom(pom: POMTLBState, radix: RadixTable, vpn: torch.Tensor,
                  entry_bytes: int = 8) -> TranslateResult:
    """POM-TLB probe backed by the radix walk on miss."""
    slot, hit, acc = pom.lookup(vpn)
    r_slot, r_ok, r_acc = radix.walk(vpn)
    out_slot = torch.where(hit, slot, r_slot)
    mapped = hit | r_ok
    accesses = acc + torch.where(hit, 0, r_acc)
    return TranslateResult(slot=out_slot, mapped=mapped,
                           in_rest=torch.zeros_like(hit),
                           accesses=accesses.to(torch.int32),
                           bytes_touched=(accesses * entry_bytes).to(
                               torch.int32))
