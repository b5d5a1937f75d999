"""Plain torch version of the RSW kernel: the hybrid RSW ∥ flex lookup."""
from __future__ import annotations

import torch

from repro_torch.core.tar_sf import RestSegState, rsw


def rsw_ref(vpns: torch.Tensor, tar: torch.Tensor, sf: torch.Tensor,
            flex_flat: torch.Tensor, *, hash_name: str = "modulo"):
    """vpns (N,) int32 -> (slot, in_rest, mapped, accesses), int32 (N,).

    ``slot`` is -1 when unmapped; ``accesses`` counts the SF probe, the
    TAR set read unless the SF filtered it, and the flex walk on a miss
    (the decode step's telemetry)."""
    r = rsw(RestSegState(tar=tar, sf=sf, meta=torch.zeros_like(tar)),
            vpns, hash_name)
    # JAX's gather: a negative vpn counts from the end once, then the
    # index clamps into the table
    n = flex_flat.numel()
    v = vpns.long()
    flex_slot = flex_flat[torch.where(v < 0, v + n, v).clamp(0, n - 1)]
    slot = torch.where(r.hit, r.slot, flex_slot)
    mapped = r.hit | (flex_slot >= 0)
    accesses = 1 + (~r.sf_skipped).to(torch.int32) + (~r.hit).to(torch.int32)
    return (torch.where(mapped, slot, -1).to(torch.int32),
            r.hit.to(torch.int32), mapped.to(torch.int32),
            accesses.to(torch.int32))
