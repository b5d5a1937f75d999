"""Plain torch versions of the RSW kernels: the hybrid RSW ∥ flex lookup
over a vpn list, and the decode step's whole translation built on it."""
from __future__ import annotations

import functools

import torch

from repro_torch.core.flex_table import FlexTable
from repro_torch.core.tar_sf import RestSegState, rsw

HASH_IDS = {"modulo": 0, "xor_fold": 1, "prime_displacement": 2,
            "mersenne": 3, "multiplicative": 4}


def hash_param(hash_name: str, n_sets: int) -> int:
    """The shift the C++ hash needs (set bits, or the Mersenne k)."""
    if hash_name == "mersenne":
        k = max(2, (n_sets - 1).bit_length())
        if k > 30:
            raise ValueError(f"mersenne hash needs n_sets < 2^30, got "
                             f"{n_sets}")
        return k
    return max(1, (n_sets - 1).bit_length())


def rsw_ref(vpns: torch.Tensor, tar: torch.Tensor, sf: torch.Tensor,
            flex_flat: torch.Tensor, *, hash_name: str = "modulo",
            max_blocks_per_seq: int = 0):
    """vpns (N,) int32 -> (slot, in_rest, mapped, accesses), int32 (N,).

    ``slot`` is -1 when unmapped; ``accesses`` counts the SF probe, the
    TAR set read unless the SF filtered it, and the flex walk on a miss
    (the decode step's telemetry).  A miss reads the flex table as JAX
    indexes it: with ``max_blocks_per_seq`` 0 a flat table (a negative
    vpn counts from the end once, then the index clamps into the table),
    else a ``(V / max_blocks_per_seq, max_blocks_per_seq)`` table as
    ``FlexTable.lookup_vpn`` reads it."""
    r = rsw(RestSegState(tar=tar, sf=sf, meta=torch.zeros_like(tar)),
            vpns, hash_name)
    if max_blocks_per_seq:
        flex_slot, _ = FlexTable(flex_flat.view(-1, max_blocks_per_seq)
                                 ).lookup_vpn(vpns, max_blocks_per_seq)
    else:
        n = flex_flat.numel()
        v = vpns.long()
        flex_slot = flex_flat[torch.where(v < 0, v + n, v).clamp(0, n - 1)]
    slot = torch.where(r.hit, r.slot, flex_slot)
    mapped = r.hit | (flex_slot >= 0)
    accesses = 1 + (~r.sf_skipped).to(torch.int32) + (~r.hit).to(torch.int32)
    return (torch.where(mapped, slot, -1).to(torch.int32),
            r.hit.to(torch.int32), mapped.to(torch.int32),
            accesses.to(torch.int32))


# ------------------------------------------------ the step's translation

class StepTranslation:
    """Result of the single hybrid translation of a decode step.

    Every field is a view of the step's ONE int32 output buffer, made the
    first time it is read (a step reads only what it uses: the layer loop
    ``slots``, ``w_row`` and ``extent``, the engine ``telemetry``).  The
    buffer's layout, in int32 words, N = B * nblk and W the window (1 for
    a decode step, K + 1 for a speculative verify step; entry (b, i) is
    row b's position ctx_len[b] + i), as the C source writes it:

    ================  ======================  ==============================
    words             field                   meaning
    ================  ======================  ==============================
    [0, 2BW)          w_row (B[, W]) int64    flat pool row of the position's
                                              K/V, w_slot * bs + pos % bs;
                                              the sink slot's row when the
                                              write is not valid
    [2BW, 3BW)        w_slot (G, B[, W])      slot of the block written
    [3BW, 4BW)        w_valid (G, B[, W])     mapped, in range and active
    [4BW, 5BW)        extent (B[, W])         attention extent, pos + 1
    [5BW, 5BW + 3N)   telemetry (3N,)         in_rest, accesses, mapped
    [5BW + 3N, +N)    slots (G, B, nblk)      resolved pool slot, -1
                                              unmapped
    ================  ======================  ==============================

    The per-position fields drop the window axis at W = 1.  ``in_rest``
    (resolved by the RSW), ``accesses`` (structure accesses) and
    ``mapped`` are the telemetry's thirds, each (G, B, nblk); ``vpns``
    (B, nblk) is the vpn grid.  Group-major like the JAX package's
    (``G == 1`` on one device); the flags are int32 0/1 where the JAX
    package's are bool."""

    _fields = ("slots", "w_slot", "w_valid", "in_rest", "mapped",
               "accesses", "vpns", "w_row", "extent", "telemetry")

    def __init__(self, out: torch.Tensor, vpns: torch.Tensor,
                 window: int = 1):
        self.out, self.vpns, self.window = out, vpns, window
        self._b, self._nblk = vpns.shape
        self._bw = self._b * window
        self._pos = (self._b,) if window == 1 else (self._b, window)

    def _words(self, start: int, *shape) -> torch.Tensor:
        """A contiguous view of ``shape`` from int32 word ``start`` on."""
        strides = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            strides[i] = strides[i + 1] * shape[i + 1]
        return self.out.as_strided(shape, strides, start)

    @functools.cached_property
    def w_row(self) -> torch.Tensor:
        return self.out[:2 * self._bw].view(torch.int64).view(self._pos)

    @functools.cached_property
    def w_slot(self) -> torch.Tensor:
        return self._words(2 * self._bw, 1, *self._pos)

    @functools.cached_property
    def w_valid(self) -> torch.Tensor:
        return self._words(3 * self._bw, 1, *self._pos)

    @functools.cached_property
    def extent(self) -> torch.Tensor:
        return self._words(4 * self._bw, *self._pos)

    @functools.cached_property
    def telemetry(self) -> torch.Tensor:
        return self._words(5 * self._bw, 3 * self._b * self._nblk)

    def _grid(self, k: int) -> torch.Tensor:
        B, nblk = self._b, self._nblk
        return self._words(5 * self._bw + k * B * nblk, 1, B, nblk)

    @functools.cached_property
    def in_rest(self) -> torch.Tensor:
        return self._grid(0)

    @functools.cached_property
    def accesses(self) -> torch.Tensor:
        return self._grid(1)

    @functools.cached_property
    def mapped(self) -> torch.Tensor:
        return self._grid(2)

    @functools.cached_property
    def slots(self) -> torch.Tensor:
        return self._grid(3)


def step_words(batch: int, nblk: int, window: int = 1) -> int:
    """int32 words of the step's one output buffer (``StepTranslation``)."""
    return 5 * batch * window + 4 * batch * nblk


def vpn_grid(batch: int, nblk: int, device) -> torch.Tensor:
    """(B, nblk) int32: row b's blocks are vpns ``b * nblk + j``."""
    return torch.arange(batch * nblk, dtype=torch.int32,
                        device=device).view(batch, nblk)


def translate_step_ref(tar: torch.Tensor, sf: torch.Tensor,
                       flex: torch.Tensor, ctx_len: torch.Tensor,
                       active=None, *, block_size: int, nblk: int,
                       hash_name: str, sink: int,
                       window: int = 1) -> StepTranslation:
    """The step's translation in plain torch: ``rsw_ref`` over the query
    grid (every block vpn of every row), and what the layer loop derives
    from the result for each of a row's ``window`` positions ctx_len + i:
    the slot and mapped flag of its block, gathered from the walk (the
    block index clamped into the row), its write row and its extent.

    tar (1, n_sets, assoc), sf (1, n_sets), flex (1, B * nblk) int32;
    ``ctx_len`` (B,) int32, the pre-step context lengths; ``active`` (B,)
    bool or None (all active); ``sink`` the pool's write-sink slot."""
    B = ctx_len.shape[0]
    bs = block_size
    dev = ctx_len.device
    grid = vpn_grid(B, nblk, dev)
    pos = (ctx_len[:, None]
           + torch.arange(window, dtype=torch.int32, device=dev)[None, :])
    blk = torch.div(pos, bs, rounding_mode="floor")
    # an idle row's position can run past its vpn range; without the clamp
    # its write block would alias ANOTHER row's block (a context length is
    # never negative: the lower clamp keeps the write block in the row,
    # as the kernel's is)
    in_range = blk < nblk
    blk = blk.clamp(0, nblk - 1).long()
    slot, hit, mapped, acc = rsw_ref(grid.reshape(-1), tar[0], sf[0],
                                     flex[0], hash_name=hash_name)
    w_slot = slot.view(B, nblk).gather(1, blk)
    act = (torch.ones(B, dtype=torch.bool, device=dev) if active is None
           else active.bool())
    w_valid = (mapped.view(B, nblk).gather(1, blk).bool() & in_range
               & act[:, None])
    w_row = (torch.where(w_valid, w_slot, sink).long() * bs
             + torch.remainder(pos, bs).long())
    out = torch.cat([w_row.reshape(-1).view(torch.int32),
                     w_slot.reshape(-1), w_valid.to(torch.int32).reshape(-1),
                     (pos + 1).to(torch.int32).reshape(-1),
                     hit, acc, mapped, slot])
    return StepTranslation(out, grid, window)
