"""Plain torch versions of the RSW kernels: the hybrid RSW ∥ flex lookup
over a vpn list, the decode step's whole translation built on it, and the
sharded step's two entries (a rank's contributions, and their combine)."""
from __future__ import annotations

import functools

import torch

from repro_torch.core.flex_table import FlexTable
from repro_torch.core.hashes import get_hash
from repro_torch.core.tar_sf import RestSegState, probe_rows, rsw

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


# The token-split layout of a rank of a (data, model) mesh (the JAX
# package's ``kv_shards=0`` mesh path): (groups G, this rank's group g,
# striped, token shards TP, this rank's shard m).  One device is
# ``ONE_RANK``.
ONE_RANK = (1, 0, False, 1, 0)


def translate_step_ref(tar: torch.Tensor, sf: torch.Tensor,
                       flex: torch.Tensor, ctx_len: torch.Tensor,
                       active=None, *, block_size: int, nblk: int,
                       hash_name: str, sink: int, window: int = 1,
                       layout=ONE_RANK) -> StepTranslation:
    """The step's translation in plain torch: ``rsw_ref`` over the query
    grid (every block vpn of every row), and what the layer loop derives
    from the result for each of a row's ``window`` positions ctx_len + i:
    the slot and mapped flag of its block, gathered from the walk (the
    block index clamped into the row), its write row and its extent.

    tar (1, n_sets, assoc), sf (1, n_sets), flex (1, B * nblk) int32;
    ``ctx_len`` (B,) int32, the pre-step context lengths; ``active`` (B,)
    bool or None (all active); ``sink`` the pool's write-sink slot.

    ``layout`` ``(G, g, striped, TP, m)``: the tables are group ``g``'s of
    ``G``; in striped mode global block b lives on group ``b % G`` at
    local block ``b // G``, and a write is valid only on the group that
    owns its block; the pool holds this rank's ``bs / TP`` tokens of every
    block, so a write lands (at row ``slot * bs / TP + pos % (bs / TP)``)
    only where ``(pos % bs) // (bs / TP) == m``, elsewhere in the sink.
    The extent stays the global ``pos + 1``."""
    B = ctx_len.shape[0]
    grid = vpn_grid(B, nblk, ctx_len.device)
    walk = rsw_ref(grid.reshape(-1), tar[0], sf[0], flex[0],
                   hash_name=hash_name)
    return _pack_step(walk, ctx_len, active, block_size, nblk, window,
                      lambda w_slot, w_valid: torch.where(w_valid, w_slot,
                                                          sink), layout)


def _pack_step(walk, ctx_len, active, block_size: int, nblk: int,
               window: int, write_slot, layout=ONE_RANK) -> StepTranslation:
    """The step's output buffer from the walk of its query grid
    (``walk``: slot, in_rest, mapped, accesses, each (B * nblk,) int32):
    for each of a row's ``window`` positions ctx_len + i, the slot and
    mapped flag of its block (the block index, local to the group in
    striped mode, clamped into the row), its validity and extent, and its
    write row ``write_slot(w_slot, w_valid & token owned) * bs_loc + pos %
    bs_loc`` (``layout``: see ``translate_step_ref``)."""
    slot, hit, mapped, acc = walk
    G, g, striped, TP, m = layout
    B = ctx_len.shape[0]
    bs = block_size
    bs_loc = bs // TP
    dev = ctx_len.device
    pos = (ctx_len[:, None]
           + torch.arange(window, dtype=torch.int32, device=dev)[None, :])
    blk = torch.div(pos, bs, rounding_mode="floor")
    owner = torch.ones_like(blk, dtype=torch.bool)
    if striped:
        owner = torch.remainder(blk, G) == g
        blk = torch.div(blk, G, rounding_mode="floor")
    # an idle row's position can run past its vpn range; without the clamp
    # its write block would alias ANOTHER row's block (a context length is
    # never negative: the lower clamp keeps the write block in the row,
    # as the kernel's is)
    in_range = blk < nblk
    blk = blk.clamp(0, nblk - 1).long()
    w_slot = slot.view(B, nblk).gather(1, blk)
    act = (torch.ones(B, dtype=torch.bool, device=dev) if active is None
           else active.bool())
    w_valid = (mapped.view(B, nblk).gather(1, blk).bool() & in_range
               & act[:, None] & owner)
    tok = torch.remainder(pos, bs)
    own_tok = torch.div(tok, bs_loc, rounding_mode="floor") == m
    w_row = (write_slot(w_slot, w_valid & own_tok).long() * bs_loc
             + torch.remainder(tok, bs_loc).long())
    out = torch.cat([w_row.reshape(-1).view(torch.int32),
                     w_slot.reshape(-1), w_valid.to(torch.int32).reshape(-1),
                     (pos + 1).to(torch.int32).reshape(-1),
                     hit, acc, mapped, slot])
    return StepTranslation(out, vpn_grid(B, nblk, dev), window)


# ------------------------------------------- the sharded step's two entries

def translate_shard_ref(tar_l: torch.Tensor, sf_l: torch.Tensor,
                        flex_l: torch.Tensor, *, batch: int, nblk: int,
                        hash_name: str, part, m: int) -> torch.Tensor:
    """A rank's ownership-masked contributions to the step's lookup, as
    the JAX package's ``_hybrid_lookup_sharded`` forms them: for query i
    (vpn i of the (batch, nblk) grid), (hit, way + 1, sf_skipped, flex
    entry + 2), each 0 where shard ``m`` of ``part`` (a
    ``core.partition.Partition``) does not own the query's set (the first
    three) or its vpn (the last).  tar_l (1, spm, assoc), sf_l (1, spm)
    and flex_l (1, vpm) are the rank's slices.  Returns (4 * batch * nblk,)
    int32; its sum over the shards is what ``combine_shard_ref`` takes."""
    spm, vpm = part.sets_per_shard, part.vpns_per_shard
    vpns = torch.arange(batch * nblk, dtype=torch.int32,
                        device=tar_l.device)
    set_g = get_hash(hash_name)(vpns, part.n_sets).to(torch.int32)
    mine = torch.div(set_g, spm, rounding_mode="floor") == m
    loc = (set_g - m * spm).clamp(0, spm - 1).long()
    hit, way, skip = probe_rows(tar_l[0][loc], sf_l[0][loc], vpns)
    hit = mine & hit
    mine_f = torch.div(vpns, vpm, rounding_mode="floor") == m
    ent = flex_l[0][(vpns - m * vpm).clamp(0, vpm - 1).long()]
    zero = torch.zeros_like(vpns)
    return torch.cat([hit.to(torch.int32), torch.where(hit, way + 1, zero),
                      (mine & skip).to(torch.int32),
                      torch.where(mine_f, ent + 2, zero)]).to(torch.int32)


def combine_shard_ref(sums: torch.Tensor, ctx_len: torch.Tensor,
                      active=None, *, block_size: int, nblk: int,
                      hash_name: str, part, m: int,
                      window: int = 1) -> StepTranslation:
    """The sharded step's translation from the contributions summed over
    the model group (``sums``, ``translate_shard_ref``'s layout): every
    field of the unsharded step's (logical slots), except that ``w_row``
    is the row of shard ``m``'s pool chunk (``part.slots_per_shard`` slots
    and a sink slot after them): the write block's physical slot rebased
    to the chunk where shard ``m`` owns it, else the chunk's sink."""
    n = ctx_len.shape[0] * nblk
    hit, way, skip, flex = (sums[k * n:(k + 1) * n] for k in range(4))
    hit = hit > 0
    flex = flex - 2
    vpns = torch.arange(n, dtype=torch.int32, device=sums.device)
    set_g = get_hash(hash_name)(vpns, part.n_sets).to(torch.int32)
    mapped = hit | (flex >= 0)
    slot = torch.where(hit, set_g * part.assoc + (way - 1).clamp(min=0),
                       torch.where(flex >= 0, flex, -1))
    acc = 1 + (skip <= 0).to(torch.int32) + (~hit).to(torch.int32)
    walk = (slot.to(torch.int32), hit.to(torch.int32),
            mapped.to(torch.int32), acc.to(torch.int32))
    cps = part.slots_per_shard

    def write_slot(w_slot, w_valid):
        ph = part.phys(w_slot)
        own = w_valid & (torch.div(ph, cps, rounding_mode="floor") == m)
        return torch.where(own, ph - m * cps, cps)

    return _pack_step(walk, ctx_len, active, block_size, nblk, window,
                      write_slot)
