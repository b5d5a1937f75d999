"""Decode step: hybrid-translated paged attention, on one device or on a
rank of a (data, model) mesh.

Translation (the paper's technique) runs exactly once per step:
``translate_step`` resolves every block vpn of every sequence, plus the
block being written, in ONE launch of the RSW step kernel before the layer
loop.  The same launch emits the per-vpn telemetry (``in_rest`` /
``accesses`` / ``mapped``, one int32 block) that the engine feeds back to
the promotion policy, and per row the flat pool row of the new token's K/V
and the attention extent.  Every attention layer then only writes the new
token's K/V at that row and runs the paged-attention kernel over the
pre-resolved slots: no device op of the layer loop prepares either.

The decode state is a dict of device tensors updated IN PLACE (the JAX
package rebuilt them functionally): the KV pools ``(L_attn, slots + 1,
bs, KV, hd)`` of the model's attention layers, the TAR/SF/flex
translation tables and ``ctx_len``.  Pool slot ``slots`` (the last one)
is a write sink: a write the JAX package dropped out of bounds (an
inactive row, an unmapped block) lands there instead, which keeps the
step free of host syncs.  No translation ever resolves to it.

Sharded serving (DESIGN.md §sharded-serving; ``spec.kv_shards >= 1`` with
a mesh and a ``core.partition.Partition``): a rank holds its chunk of the
pool, ``slots_per_shard`` physical slots and the sink, and its slices of
the TAR/SF (its sets) and flex (its vpns) tables; everything else, and
every float op, is replicated.  The step's translation is the RSW kernel's
shard entry over the rank's slices, one integer all-reduce of its packed
contributions over the model group, and the combine entry, which gives
the unsharded step's fields bitwise (slots stay logical) and each write's
row in the rank's chunk.  A write lands only on the rank that owns its
block (elsewhere in the chunk's sink), and a read first assembles the
step's blocks exactly: each rank gathers the blocks it owns, zeros
elsewhere, and one all-reduce SUM of the buffer's bytes (disjoint terms:
no carry, no rounding) gives every rank the same bits; the
paged-attention kernel then reads that buffer.  No float is ever reduced
across ranks, so the streams are bitwise the unsharded engine's.

The token-split layout (the JAX package's ``kv_shards=0`` with a mesh,
its dry run's; ``TokenSplit``): rank (g, m) of a (data, model) mesh holds
its data group's pool, ``slots_per_group`` slots and the sink of ``bs /
TP`` tokens each (token sub-range m of every block), and its group's
tables.  In batch mode group g owns rows ``[g B/G, (g+1) B/G)`` and their
blocks; in striped mode every group sees every row and global block b
lives on group ``b % G`` at local block ``b // G``.  A rank holds its
blocks of the weights as JAX's ``param_shardings`` lays them out
(``token_split_tp``; ZeRO over the data axes as ``cfg.zero_shard_params``,
gathered a layer at a time) and of the recurrent state as
``decode_state_shardings`` does (its ssm heads and conv channels).  It
translates its group's queries (one RSW launch, which also resolves the
token-owned write row) and computes its rows tensor-parallel over the
model group (``dist.megatron.ServingTP``): q, k and v column-parallel and
made whole by one all-gather, o and the MLP's down row-parallel closed by
a float32 sum, the vocab-split embedding and head, the MoE's experts, the
mamba heads.  It reads its token sub-range of each block through the
paged kernel at its token offset and combines the partial softmax
results ``(o, m, l)`` over the model group (batch mode) or the world
(striped mode) with a max and two sums, flash-decoding's combine.  The
step returns the whole batch's logits and stats on every rank (one
all-gather over the data group).  The combine and the row-parallel sums
reduce floats across ranks, as GSPMD does, so the step equals
``mesh=None`` to float rounding, not bitwise.

The recurrent families add each mamba sublayer's per-row state: ``ssm``
``(n_ssm, B, H, P, N)`` float32 and ``conv`` ``(n_ssm, B, W-1, C)`` in the
model dtype, which every fed token advances (an inactive row keeps its
rows).  The ssm family (mamba2) has no attention layer, hence no pool, no
translation tables and no RSW launch; the hybrid family (jamba) has one
pool layer per group, and the mamba sublayer ``i`` of group ``gi`` owns
state row ``gi * (attn_every - 1) + i``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.megatron import ServingTP
from repro_torch.dist.sharding import _guard, block_of, serving_rules
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import normalize
from repro_torch.kernels.utopia_rsw.ops import (shard_translator,
                                                translate_step_translator)
from repro_torch.kernels.utopia_rsw.ref import ONE_RANK, StepTranslation
from repro_torch.models import layers as Lmod
from repro_torch.models.moe import moe_decode
from repro_torch.models.ssm import MambaCache, mamba_decode_step
from repro_torch.models.transformer import (RECURRENT_FAMILIES, ModelDims,
                                            check_family, ffn_act,
                                            hybrid_ffn_select,
                                            layer_params, n_attn_layers,
                                            take)
from .sampling import sample_tokens


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    block_size: int              # tokens per KV block
    max_blocks_per_seq: int
    slots_per_group: int         # pool slots (the sink comes on top)
    n_sets: int
    assoc: int
    mode: str = "batch"          # batch | striped (per data group then)
    hash_name: str = "modulo"
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    # prefix-KV chunked prefill: how chunk queries read the installed
    # prefix blocks.  "exact" places the gathered K/V at their absolute
    # positions and reuses the recompute forward's dense softmax
    # (bit-identical to recompute); "paged" is the Q>1 paged-attention
    # read merged with the chunk's own causal part (equal up to float
    # associativity)
    prefix_gather: str = "exact"
    # KV/translation sharding over the mesh's model axis: 0 = one device;
    # >= 1 = the sharded serving layout (the pool and tables of a rank
    # are its chunk of a ``core.partition.Partition`` over kv_shards
    # shards; the step factories then take the mesh and the partition)
    kv_shards: int = 0

    def __post_init__(self):
        if self.prefix_gather not in ("exact", "paged"):
            raise ValueError(f"unknown prefix gather impl "
                             f"{self.prefix_gather!r} (expected 'exact' "
                             "or 'paged')")
        if self.mode not in ("batch", "striped"):
            raise ValueError(f"unknown decode mode {self.mode!r} (expected "
                             "'batch' or 'striped')")


def make_decode_spec(cfg: ArchConfig, seq_len: int, batch: int,
                     data_size: int, mode: str = "batch",
                     headroom: float = 1.25,
                     data_axes: Tuple[str, ...] = ("data",)) -> DecodeSpec:
    """The decode spec of ``batch`` sequences of ``seq_len`` tokens over
    ``data_size`` data groups, as the JAX package sizes it: in batch mode
    a group holds its rows' whole sequences, in striped mode its share of
    every sequence's blocks; a group's pool has the blocks it holds times
    ``headroom``, three quarters of them (whole sets of 8) in the
    RestSeg."""
    bs = cfg.kv_block_size
    seq_blocks = (seq_len + bs - 1) // bs
    blocks_per_group = seq_blocks * batch // data_size
    max_blocks = seq_blocks if mode == "batch" else seq_blocks // data_size
    assoc = 8
    slots = max(assoc * 2, int(blocks_per_group * headroom))
    rest = max(assoc, int(slots * 0.75) // assoc * assoc)
    slots = rest + max(assoc, slots - rest)
    return DecodeSpec(block_size=bs, max_blocks_per_seq=max_blocks,
                      slots_per_group=slots, n_sets=rest // assoc,
                      assoc=assoc, mode=mode,
                      hash_name=getattr(cfg, "hash_name", "modulo"),
                      data_axes=tuple(data_axes))


def abstract_decode_state(cfg: ArchConfig, dims: ModelDims,
                          spec: DecodeSpec, batch: int, data_size: int,
                          dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The whole decode state of ``data_size`` groups in the JAX package's
    layout, on the ``meta`` device (shapes and dtypes, no memory): pools
    ``(L_attn, G * slots, bs, KV, hd)`` without the port's sink slot,
    tables ``(G, ...)``, a group's flex over its rows' blocks.  The
    sampling keys, JAX's uint32, are the port's int64.  A rank's share is
    ``local_decode_state``'s."""
    check_family(cfg)
    G = data_size
    meta = dict(device="meta")
    n_attn = n_attn_layers(cfg)
    rows = max(1, batch // G) if spec.mode == "batch" else batch
    st: Dict[str, torch.Tensor] = {}
    if n_attn:
        pool = (n_attn, G * spec.slots_per_group, spec.block_size,
                max(dims.n_kv, 1), dims.head_dim)
        st["k_pool"] = torch.empty(pool, dtype=dtype, **meta)
        st["v_pool"] = torch.empty(pool, dtype=dtype, **meta)
        st["tar"] = torch.empty((G, spec.n_sets, spec.assoc),
                                dtype=torch.int32, **meta)
        st["sf"] = torch.empty((G, spec.n_sets), dtype=torch.int32, **meta)
        st["flex"] = torch.empty((G, rows * spec.max_blocks_per_seq),
                                 dtype=torch.int32, **meta)
    if cfg.family in RECURRENT_FAMILIES:
        md = dims.mamba
        n_ssm = cfg.num_layers - n_attn
        st["ssm"] = torch.empty((n_ssm, batch, md.n_heads, md.head_dim,
                                 md.d_state), dtype=torch.float32, **meta)
        st["conv"] = torch.empty((n_ssm, batch, md.conv_width - 1,
                                  md.conv_channels), dtype=dtype, **meta)
    if cfg.is_encoder_decoder:
        cross = (cfg.num_layers, batch, cfg.frontend_tokens, dims.n_kv,
                 dims.head_dim)
        st["cross_k"] = torch.empty(cross, dtype=dtype, **meta)
        st["cross_v"] = torch.empty(cross, dtype=dtype, **meta)
    for name, dt in (("ctx_len", torch.int32), ("samp_temp", torch.float32),
                     ("samp_topk", torch.int32),
                     ("samp_topp", torch.float32)):
        st[name] = torch.empty((batch,), dtype=dt, **meta)
    st["samp_key"] = torch.empty((batch, 2), dtype=torch.int64, **meta)
    return st


def decode_state_shardings(state_shape, mesh, spec: DecodeSpec):
    """The JAX package's ``PartitionSpec`` of each decode-state leaf over
    ``mesh`` (a ``Mesh``, a ``MeshDesc`` or ``{axis: size}``): pools by
    slot over the data axes and by token over the model axis, tables over
    the data axes, per-row state over the data axes in batch mode, the
    rest replicated; an axis that does not divide its dim is dropped
    (``_guard``)."""
    da, ma = tuple(spec.data_axes), spec.model_axis
    rows = da if spec.mode == "batch" else None
    table = {
        "k_pool": (None, da, ma, None, None),
        "v_pool": (None, da, ma, None, None),
        "tar": (da, None, None), "sf": (da, None), "flex": (da, None),
        "ssm": (None, rows, ma, None, None),
        "conv": (None, rows, None, ma),
        "cross_k": (None, rows, None, None, None),
        "cross_v": (None, rows, None, None, None),
    }
    return {k: _guard(table.get(k, ()), tuple(v.shape), mesh)
            for k, v in state_shape.items()}


def local_decode_state(whole, spec: DecodeSpec,
                       mesh) -> Dict[str, torch.Tensor]:
    """A rank's token-split decode state from the ``whole`` one (the JAX
    layout, ``abstract_decode_state``'s shapes; any device): every leaf
    cut to this rank's block under ``decode_state_shardings`` (the pools
    by slot over the data axes and to the rank's token sub-range, the
    tables and batch-mode rows over the data axes, the ``ssm`` state to
    the rank's heads and the ``conv`` tail to its block of channels over
    the model axis), then a zero sink slot after each pool's slots; a cut
    leaf is a copy, a whole one the leaf itself."""
    specs = decode_state_shardings(whole, mesh, spec)
    axes = tuple(spec.data_axes) + (spec.model_axis,)
    out = {}
    for k, x in whole.items():
        pool = k in ("k_pool", "v_pool")
        t = block_of(x, specs[k], mesh, axes)
        if pool:
            t = torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
        elif t.numel() != x.numel():
            t = t.clone(memory_format=torch.contiguous_format)
        out[k] = t.contiguous()
    return out


def init_decode_state(cfg: ArchConfig, dims: ModelDims, spec: DecodeSpec,
                      batch: int, data_size: int = 1, dtype=torch.float32,
                      device="cuda", part=None,
                      mesh=None) -> Dict[str, torch.Tensor]:
    """Zeroed decode state on ``device`` (flex entries -1 = unmapped): the
    KV pools and translation tables when the model has attention layers,
    the ``ssm``/``conv`` rows when it has mamba sublayers, the
    ``cross_k``/``cross_v`` rows when it is an encoder-decoder.

    With ``part`` (a ``core.partition.Partition``, the sharded layout) the
    pools and tables are one rank's padded chunk: ``slots_per_shard``
    pool slots plus the sink, tar ``(1, spm, assoc)`` and sf ``(1, spm)``
    with zero pad rows, flex ``(1, vpm)`` with -1 pads; ``data_size`` must
    be 1 there (the data axis replicates the state).  With ``mesh`` and no
    ``part`` it is this rank's state of the token-split layout over
    ``data_size`` groups (``local_decode_state``); a state of several
    data groups lives on the ranks of a mesh only."""
    if part is not None and data_size != 1:
        raise ValueError("the sharded decode state requires data_size == 1")
    if part is None and mesh is not None:
        local = local_decode_state(abstract_decode_state(
            cfg, dims, spec, batch, data_size, dtype), spec, mesh)
        st = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
              for k, v in local.items()}
        if "flex" in st:
            st["flex"].fill_(-1)
        return st
    if part is None and data_size != 1:
        raise ValueError(f"a decode state of {data_size} data groups lives "
                         "on the ranks of a mesh: pass the rank's mesh")
    check_family(cfg)
    n_attn = n_attn_layers(cfg)
    i32 = dict(dtype=torch.int32, device=device)
    st: Dict[str, torch.Tensor] = {}
    if n_attn:
        slots, n_sets, flex_len = (
            (spec.slots_per_group, spec.n_sets,
             batch * spec.max_blocks_per_seq) if part is None else
            (part.slots_per_shard, part.sets_per_shard, part.vpns_per_shard))
        pool = (n_attn, slots + 1, spec.block_size, dims.n_kv, dims.head_dim)
        st.update(
            k_pool=torch.zeros(pool, dtype=dtype, device=device),
            v_pool=torch.zeros(pool, dtype=dtype, device=device),
            tar=torch.zeros((1, n_sets, spec.assoc), **i32),
            sf=torch.zeros((1, n_sets), **i32),
            flex=torch.full((1, flex_len), -1, **i32))
    if cfg.family in RECURRENT_FAMILIES:
        md = dims.mamba
        n_ssm = cfg.num_layers - n_attn
        st["ssm"] = torch.zeros((n_ssm, batch, md.n_heads, md.head_dim,
                                 md.d_state), dtype=torch.float32,
                                device=device)
        st["conv"] = torch.zeros((n_ssm, batch, md.conv_width - 1,
                                  md.conv_channels), dtype=dtype,
                                 device=device)
    if cfg.is_encoder_decoder:
        cross = (cfg.num_layers, batch, cfg.frontend_tokens, dims.n_kv,
                 dims.head_dim)
        st["cross_k"] = torch.zeros(cross, dtype=dtype, device=device)
        st["cross_v"] = torch.zeros(cross, dtype=dtype, device=device)
    return {
        **st,
        "ctx_len": torch.zeros((batch,), **i32),
        # per-slot sampling state (serve/sampling.py), scattered at
        # admission; zeros = greedy argmax.  The key data are uint32
        # values held in int64
        "samp_temp": torch.zeros((batch,), dtype=torch.float32,
                                 device=device),
        "samp_topk": torch.zeros((batch,), **i32),
        "samp_topp": torch.zeros((batch,), dtype=torch.float32,
                                 device=device),
        "samp_key": torch.zeros((batch, 2), dtype=torch.int64,
                                device=device),
    }


# ----------------------------------------------- once-per-step translation

def _hybrid_lookup(tar: torch.Tensor, sf: torch.Tensor, flex: torch.Tensor,
                   positions: torch.Tensor, active, spec: DecodeSpec,
                   bound: Dict[tuple, Callable], window: int,
                   shard=None) -> StepTranslation:
    """Hybrid RSW ∥ flex lookup of the whole step with
    ``translate()``-compatible accounting: the step's only translation
    primitive, ONE launch of the RSW step kernel (its plain version on the
    CPU), or on a rank of a mesh (``shard``, a ``ShardedPool``) the shard
    entry, one all-reduce and the combine entry.  The kernel is bound to
    the step's geometry, and the tables validated, on the first call for a
    (batch, device, window); ``bound`` keeps the bindings."""
    key = (positions.shape[0], positions.device, window)
    fn = bound.get(key)
    if fn is None:
        geom = dict(block_size=spec.block_size,
                    nblk=spec.max_blocks_per_seq, hash_name=spec.hash_name,
                    window=window)
        if isinstance(shard, ShardedPool):
            fn = shard_translator(tar, sf, flex, positions, part=shard.part,
                                  m=shard.m, reduce=shard.reduce, **geom)
        else:
            fn = translate_step_translator(
                tar, sf, flex, positions, sink=spec.slots_per_group,
                layout=ONE_RANK if shard is None else shard.layout, **geom)
        bound[key] = fn
    return fn(tar, sf, flex, positions, active)


def translate_step(tar: torch.Tensor, sf: torch.Tensor, flex: torch.Tensor,
                   positions: torch.Tensor, spec: DecodeSpec, active=None,
                   bound=None, window: int = 1,
                   shard=None) -> StepTranslation:
    """Translate every block vpn of every sequence in one launch, and
    derive in the same launch, for each of a row's ``window`` positions
    ``positions + i`` (1 for a decode step, K + 1 for a speculative verify
    step), the write's flat pool row and the attention extent.

    tar (1, n_sets, assoc), sf (1, n_sets), flex (1, B*nblk);
    ``positions`` (B,) the pre-step context lengths (>= 0); ``active``
    (B,) bool or None (all active): an inactive row's writes go to the
    sink slot, as do those that are unmapped or past the vpn range.
    ``bound`` is the caller's dict of bindings (the decode and verify
    steps share one); without it the call binds anew.  On a rank of a mesh
    (``shard``, a ``ShardedPool``) the tables are the rank's slices, the
    slots stay logical and the write rows are rows of the rank's chunk;
    on a rank of the token-split layout (``shard``, a ``TokenSplit``) the
    tables and rows are its group's, and the write rows its token
    shard's."""
    return _hybrid_lookup(tar, sf, flex, positions, active, spec,
                          {} if bound is None else bound, window, shard)


# --------------------------------------------- the slot-sharded pool

class ShardedPool:
    """Rank ``m``'s chunk of the slot-sharded KV pool (sharded serving):
    the partition ``part``, the rank's shard ``m`` and ``reduce(t)``, the
    in-place sum over the model group.  The chunk holds the physical slots
    ``[m * cps, (m + 1) * cps)`` (``cps = part.slots_per_shard``) at local
    slots ``[0, cps)``, and the sink at ``cps``."""

    def __init__(self, part, m: int, reduce):
        self.part, self.m, self.reduce = part, m, reduce
        self.cps = part.slots_per_shard

    def local(self, slots: torch.Tensor):
        """Logical ``slots`` -> (their local slots in this chunk, int64,
        the sink where this rank does not own them or they are -1; the
        owned mask)."""
        ph = self.part.phys(slots)
        own = (slots >= 0) & (torch.div(ph, self.cps,
                                        rounding_mode="floor") == self.m)
        return torch.where(own, ph - self.m * self.cps, self.cps).long(), own

    def gather(self, pools, slots: torch.Tensor, dim: int = 0):
        """The blocks at logical ``slots`` (1-D) of each tensor of
        ``pools`` (this rank's chunks, slots along ``dim``), assembled
        exactly on every rank of the group: each rank gathers the blocks
        it owns, zeros the rest, and one all-reduce SUM over the buffer's
        bytes gives each element's bits from its one owner.  A -1 slot
        comes back as a zero block.  Returns one tensor per pool, ``dim``
        now indexing ``slots``."""
        return self.assemble(pools, *self.local(slots), dim)

    def assemble(self, pools, idx: torch.Tensor, own: torch.Tensor,
                 dim: int = 0):
        """``gather`` of the slots that ``local`` resolved to ``idx`` and
        ``own``."""
        buf = torch.stack([p.index_select(dim, idx) for p in pools])
        shape = [1] * buf.dim()
        shape[dim + 1] = -1
        buf = torch.where(own.view(shape), buf, 0)
        self.reduce(buf.view(torch.uint8))
        return buf.unbind(0)


class BlockRead:
    """One step's read of the blocks ``slots`` (B, nblk) logical from the
    sharded pool: ``read(k_pool_l, v_pool_l)`` assembles them exactly
    (``ShardedPool.gather``) into (B * nblk, bs, KV, hd) buffers, in which
    row b's block j sits at slot ``b * nblk + j``; ``slots`` is that
    renumbering, with the holes kept at -1.  The ownership is resolved
    once a step, the gathers run once a layer."""

    def __init__(self, pool: ShardedPool, slots: torch.Tensor):
        B, nblk = slots.shape
        self.pool = pool
        self.idx, self.own = pool.local(slots.reshape(-1))
        grid = torch.arange(B * nblk, dtype=torch.int32,
                            device=slots.device).view(B, nblk)
        self.slots = torch.where(slots >= 0, grid, -1)

    def __call__(self, k_pool_l, v_pool_l):
        return self.pool.assemble([k_pool_l, v_pool_l], self.idx, self.own)

    def attend(self, q, kp_l, vp_l, slots, extent):
        kp_l, vp_l = self(kp_l, vp_l)
        o, _, l = paged_attention(q, kp_l, vp_l, slots, extent)
        return normalize(o, l).to(q.dtype)


# ------------------------------------------------- the token-split layout

class TokenSplit:
    """Rank (g, m)'s place in the token-split layout over ``mesh`` (the
    JAX package's ``kv_shards=0`` mesh path, ``_paged_attn_shardmap``):
    group ``g`` of the ``G`` data groups (``spec.data_axes`` taken
    together), token shard ``m`` of the ``TP`` along ``spec.model_axis``.
    The rank's pool holds ``bs_loc = bs / TP`` tokens of each block, the
    range that starts at ``m * bs_loc``; ``rows`` are the batch rows it
    computes (its group's in batch mode, all in striped mode), and the
    paged read's positions are ``tok_offset + j * block_tokens + t``."""

    def __init__(self, spec: DecodeSpec, mesh):
        dax, mx = mesh.axis(spec.data_axes), mesh.axis(spec.model_axis)
        self.mesh, self.spec = mesh, spec
        self.G, self.g, self.TP, self.m = dax.size, dax.index, mx.size, \
            mx.index
        bs = spec.block_size
        if bs % self.TP:
            raise ValueError(f"{bs}-token blocks do not split over "
                             f"{self.TP} token shards")
        self.bs_loc = bs // self.TP
        self.striped = spec.mode == "striped"
        self.layout = (self.G, self.g, self.striped, self.TP, self.m)
        if self.striped:
            self.tok_offset = self.g * bs + self.m * self.bs_loc
            self.block_tokens = self.G * bs
            self.combine_axes = tuple(spec.data_axes) + (spec.model_axis,)
        else:
            self.tok_offset, self.block_tokens = self.m * self.bs_loc, bs
            self.combine_axes = (spec.model_axis,)

    def rows(self, batch: int) -> slice:
        """The rows of a ``batch``-row step that this rank computes."""
        if self.striped:
            return slice(0, batch)
        if batch % self.G:
            raise ValueError(f"a batch of {batch} rows does not split over "
                             f"{self.G} data groups")
        n = batch // self.G
        return slice(self.g * n, (self.g + 1) * n)

    def attend(self, q, kp_l, vp_l, slots, extent):
        """The paged read of this rank's token sub-range, combined over
        ``combine_axes`` as flash-decoding combines partial softmax
        results: the max of ``m`` over the group, then the sums of ``o *
        corr`` and ``l * corr`` (one all-reduce each).  Returns the
        normalized output in q's dtype."""
        o, m, l = paged_attention(q, kp_l, vp_l, slots, extent,
                                  tok_offset=self.tok_offset,
                                  block_tokens=self.block_tokens)
        m_glob = self.mesh.all_reduce(m.clone(), self.combine_axes,
                                      op=dist.ReduceOp.MAX)
        corr = torch.exp(m - m_glob)
        buf = torch.cat([(o * corr[..., None]).reshape(-1),
                         (l * corr).reshape(-1)])
        self.mesh.all_reduce(buf, self.combine_axes)
        o, l = buf[:o.numel()].view(o.shape), buf[o.numel():].view(l.shape)
        return normalize(o, l).to(q.dtype)

    def gather_groups(self, tensors):
        """Each of ``tensors`` (this group's share along dim 0) with every
        group's, in group order, from one all-gather of their bytes over
        the data group."""
        if self.G == 1:
            return list(tensors)
        flat = [t.contiguous().view(-1).view(torch.uint8) for t in tensors]
        got = self.mesh.all_gather(torch.cat(flat), 0,
                                   tuple(self.spec.data_axes))
        got = got.view(self.G, -1)
        out, at = [], 0
        for t, f in zip(tensors, flat):
            part = got[:, at:at + f.numel()].contiguous().view(t.dtype)
            out.append(part.view(self.G * t.shape[0], *t.shape[1:]))
            at += f.numel()
        return out


# ------------------------------------------------------ paged attention

def _paged_attn_local(q, k_new, v_new, kp_l, vp_l, slots, w_row, extent,
                      read=None):
    """Write the new tokens' K/V at their precomputed flat pool rows
    ``w_row`` (B[, Q]) int64 (in place; an invalid write goes to the sink
    slot's row) and attend over the resolved blocks ``slots`` (B, nblk) up
    to ``extent`` (B[, Q]), one extent per query, through the
    paged-attention kernel: all three come from the step's translation.
    On a rank of a mesh, ``read`` (a ``BlockRead`` or a ``TokenSplit``)
    attends instead: a ``BlockRead`` first assembles the blocks from the
    sharded pool and ``slots`` index its buffer; a ``TokenSplit`` reads
    the rank's token sub-range and combines over its group.
    Returns the normalized output (B[, Q], H, hd) in q's dtype.

    Several invalid writes of one call may land on the same sink row;
    which of them wins is undefined on the card, which is harmless
    because no translation resolves to the sink slot."""
    rows = (w_row,)
    kp_l.view(-1, *kp_l.shape[2:]).index_put_(rows, k_new.to(kp_l.dtype))
    vp_l.view(-1, *vp_l.shape[2:]).index_put_(rows, v_new.to(vp_l.dtype))
    if read is not None:
        return read.attend(q, kp_l, vp_l, slots, extent)
    o, m, l = paged_attention(q, kp_l, vp_l, slots, extent)
    return normalize(o, l).to(q.dtype)


# ------------------------------------------------ shared decode sublayers
#
# A verify step's (B, Q, ...) activations hold the rows that Q decode steps
# would compute B at a time.  A GEMM or a reduction may round a row
# otherwise at B * Q rows than at B, so the ops found to do so on the card
# (the K/V projections, whose rows enter the pool, and the RMS norms' mean
# square) run at the decode step's shape, one window position at a time,
# and every other projection does so where its GEMM rounds a row otherwise
# at B * Q rows (``decode_linear``).

def _per_position(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of a decode step's ``(B, ...)`` ``x``; a verify step's
    ``(B, Q, ...)`` ``x`` goes through ``fn`` one window position at a
    time, each a contiguous ``(B, ...)`` tensor (one copy makes them all),
    and is stacked back."""
    if x.dim() == 2:
        return fn(x)
    xt = x.transpose(0, 1).contiguous()
    return torch.stack([fn(xt[i]) for i in range(xt.shape[0])], 1)


# (weight shape, strides, dtype, device, B, Q) -> whether the GEMM rounds
# each row at B * Q rows as at B rows (``_rows_invariant``)
_ROWS_INVARIANT: Dict[tuple, bool] = {}


def _rows_invariant(w: torch.Tensor, B: int, Q: int) -> bool:
    """Whether ``x @ w`` at B * Q rows gives each row the bits it gets at
    B rows.  The BLAS library picks its kernel by shape, and one that
    splits the reduction at one row count and not at the other (as
    cuBLAS does for paligemma-3b's MLP at 4 rows) rounds every row
    otherwise.  Probed once per weight layout and (B, Q), on seeded
    random rows."""
    key = (tuple(w.shape), w.stride(), w.dtype, w.device, B, Q)
    hit = _ROWS_INVARIANT.get(key)
    if hit is None:
        gen = torch.Generator(device=w.device).manual_seed(0)
        x = torch.randn((B * Q, w.shape[0]), generator=gen, device=w.device,
                        dtype=torch.float32).to(w.dtype)
        wide = x @ w
        hit = all(torch.equal(x[i * B:(i + 1) * B] @ w,
                              wide[i * B:(i + 1) * B]) for i in range(Q))
        _ROWS_INVARIANT[key] = hit
    return hit


def probe_verify_gemms(params, cfg: ArchConfig, B: int, Q: int,
                       dtype) -> None:
    """Probe (``_rows_invariant``) each GEMM that a verify step at (B, Q)
    in ``dtype`` sends through ``decode_linear`` or the head, so that the
    step finds every outcome cached and probes nothing itself (no host
    sync).  Every layer's weights are views of one stacked tensor, so
    layer 0's layouts stand for all.  ``Engine`` calls it when it sets up
    speculative decoding."""
    blk = layer_params(params, 0)
    ps = [blk["attn"]["q"], blk["attn"]["o"]]
    ps += [blk["mlp"][k] for k in ("gate", "up", "down") if "mlp" in blk]
    ps += [blk["cross"][k] for k in ("q", "o") if "cross" in blk]
    for p in ps:
        _rows_invariant(p["w"].to(dtype), B, Q)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    _rows_invariant(head["table"].T.to(dtype), B, Q)


def verify_gemm_probes() -> Dict[tuple, bool]:
    """Every GEMM layout probed so far, ``(weight shape, strides, dtype,
    device, B, Q)``, and whether it rounds each row at B * Q rows as at B
    rows (False: the verify step runs it one window position at a
    time)."""
    return dict(_ROWS_INVARIANT)


def decode_linear(p, x: torch.Tensor) -> torch.Tensor:
    """``Lmod.linear`` of a decode step's (B, d) ``x``, or of a verify
    step's (B, Q, d) ``x``: at B * Q rows where that GEMM rounds a row as
    it does at B rows, else one window position at a time."""
    if x.dim() == 2 or _rows_invariant(p["w"].to(x.dtype), *x.shape[:2]):
        return Lmod.linear(p, x)
    return _per_position(lambda t: Lmod.linear(p, t), x)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor,
              eps: float) -> torch.Tensor:
    """``Lmod.rms_norm`` with the mean square taken per position (the
    square itself is elementwise)."""
    if x.dim() == 2:
        return Lmod.rms_norm(x, scale, eps)
    x32 = x.float()
    var = _per_position(lambda t: t.mean(dim=-1, keepdim=True), x32.square())
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def decode_ffn(blk, x: torch.Tensor, cfg: ArchConfig,
               tp=None) -> torch.Tensor:
    """Post-attention FFN sublayer: the dense MLP (its projections through
    ``decode_linear``), or the decode-time MoE over every row of ``x`` (B,
    d) or (B, Q, d).  The MoE's float32
    router runs one window position at a time, at the decode step's
    shape: a flipped near-tie there would pick another expert; its
    experts read every row at once (their rows round alike at both
    shapes, ``chip_smoke.py`` phase 8).  On a token-split rank (``tp``, a
    ``dist.megatron.ServingTP``) the MLP is column- then row-parallel and
    the MoE expert-parallel."""
    h = _rms_norm(x, blk["norm2"], cfg.norm_eps)
    act = ffn_act(cfg)
    if "moe" not in blk:
        p = blk["mlp"]
        if tp is not None:
            return x + tp.mlp(p, h, act)
        g = act(decode_linear(p["gate"], h)) * decode_linear(p["up"], h)
        return x + decode_linear(p["down"], g)
    p = blk["moe"]
    w = p["router"]["w"]
    logits = _per_position(lambda t: t.float() @ w, h)
    d = h.shape[-1]
    out = moe_decode(p, h.reshape(-1, d), top_k=cfg.moe_top_k,
                     logits=logits.reshape(-1, logits.shape[-1]), act=act,
                     ep=tp)
    return x + out.reshape(h.shape)


def decode_mamba(blk, x: torch.Tensor, dstate, j: int, act,
                 cfg: ArchConfig, dims: ModelDims, tp=None) -> torch.Tensor:
    """The mamba sublayer of a decode step: one token a row (``x`` (B,
    d)) advances state row ``j`` of ``dstate["ssm"]``/``["conv"]`` in
    place; an inactive row (``act`` (B,) bool, None = all active) keeps
    its rows.  On a token-split rank (``tp``) the rows are the rank's
    heads and conv channels (``mamba_decode_step``)."""
    h = Lmod.rms_norm(x, blk["norm1"], cfg.norm_eps)
    ssm, conv = dstate["ssm"][j], dstate["conv"][j]
    out, cache = mamba_decode_step(blk["mamba"], h,
                                   MambaCache(conv=conv, state=ssm),
                                   dims.mamba, tp=tp)
    new_state, new_conv = cache.state, cache.conv
    if act is not None:
        new_state = torch.where(act[:, None, None, None], new_state, ssm)
        new_conv = torch.where(act[:, None, None], new_conv, conv)
    ssm.copy_(new_state)
    conv.copy_(new_conv)
    return x + out


def _cross_core(q: torch.Tensor, ck: torch.Tensor,
                cv: torch.Tensor) -> torch.Tensor:
    """Attention of ``q (B, H * hd)`` over a row's cross K/V ``(B, F, KV,
    hd)``: scores, softmax and products in float32; returns ``(B, H *
    hd)`` float32."""
    B = q.shape[0]
    KV, hd = ck.shape[2], ck.shape[3]
    qf = q.reshape(B, KV, q.shape[-1] // (KV * hd), hd).float()
    s = torch.einsum("bkgd,bfkd->bkgf", qf, ck.float())
    p = torch.softmax(s / math.sqrt(hd), dim=-1)
    return torch.einsum("bkgf,bfkd->bkgd", p, cv.float()).reshape(B, -1)


def decode_cross(blk, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 cfg: ArchConfig, dims: ModelDims, tp=None) -> torch.Tensor:
    """The audio decoder's cross-attention sublayer over the slots'
    installed cross K/V ``(B, F, KV, hd)``, for ``x`` (B, d) of a decode
    step or (B, Q, d) of a verify step.  The verify step takes the norm's
    mean square and the attention itself one window position at a time,
    at the decode step's shape, so its rows are bitwise the decode
    step's; the q and o projections go through ``decode_linear``.  On a
    token-split rank (``tp``) q is column-parallel: the rank attends with
    its query heads over their KV heads where both split on a head
    boundary (else with every head), and o is row-parallel."""
    lead = x.shape[:-1]
    h = _rms_norm(x, blk["norm_x"], cfg.norm_eps)
    p = blk["cross"]
    if tp is None:
        q = decode_linear(p["q"], h)
        o = _per_position(lambda t: _cross_core(t, ck, cv), q)
        o = o.reshape(*lead, -1).to(x.dtype)
        return x + decode_linear(p["o"], o)
    width = dims.n_heads * dims.head_dim
    if tp.heads_local(p["q"]) and dims.n_kv % tp.tp == 0:
        n = dims.n_kv // tp.tp
        q = tp.col(p["q"], h, width)
        ck, cv = (c.narrow(2, tp.m * n, n) for c in (ck, cv))
    else:
        q = tp.col(p["q"], h, width, whole=True)
    o = _cross_core(q, ck, cv).to(x.dtype)
    return x + tp.row(p["o"], o, width)


def project_logits(params, x: torch.Tensor, cfg: ArchConfig,
                   dims: ModelDims, tp=None) -> torch.Tensor:
    """Final norm -> (tied) head matmul -> vocab-pad mask (on a token-split
    rank, ``tp``, the rank's vocab block's logits gathered)."""
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    name = "embed" if cfg.tie_embeddings else "lm_head"
    if tp is not None:
        return tp.unembed(tp.subtree(params, name)["table"], x,
                          dims.logical_vocab)
    head = params[name]
    if x.dim() == 3 and not _rows_invariant(
            head["table"].T.to(x.dtype), *x.shape[:2]):
        return _per_position(
            lambda t: Lmod.unembed(head, t, dims.logical_vocab), x)
    return Lmod.unembed(head, x, dims.logical_vocab)


def decode_attn(blk, x: torch.Tensor, kp_l: torch.Tensor,
                vp_l: torch.Tensor, kv_at, positions: torch.Tensor,
                cfg: ArchConfig, dims: ModelDims, tp=None) -> torch.Tensor:
    """The attention sublayer of a decode step (one token a row: ``x``
    (B, d), ``positions`` (B,)) or of a verify step (Q tokens a row: ``x``
    (B, Q, d), ``positions`` (B, Q)): project, rotate, write every token's
    K/V and read the pool through the paged-attention kernel.  ``kv_at``
    is the step's ``(slots, w_row, extent[, read])`` (``kv_access``),
    shaped like ``positions`` past the slots; the verify's per-query
    extents are the sequential decode's causal mask inside one pool read.

    The verify step projects K and V (and takes the norm's mean square) one
    window position at a time, at the decode step's shape, so the rows it
    writes to the pool are bitwise the decode step's and spec-on streams
    stay spec-off's; q and o go through ``decode_linear``.

    On a token-split rank (``tp``, a ``dist.megatron.ServingTP``; decode
    steps only) q, k and v are the rank's columns, made whole by one
    all-gather over the model group (the paged read of the rank's token
    sub-range and the pool write take every head), and o is
    row-parallel."""
    lead = x.shape[:-1]
    B = lead[0]
    H, KV, hd = dims.n_heads, dims.n_kv, dims.head_dim
    h = _rms_norm(x, blk["norm1"], cfg.norm_eps)
    att = blk["attn"]
    if tp is None:
        q = decode_linear(att["q"], h)
        k = _per_position(lambda t: Lmod.linear(att["k"], t), h)
        v = _per_position(lambda t: Lmod.linear(att["v"], t), h)
    else:
        widths = (H * hd, KV * hd, KV * hd)
        q, k, v = tp.cat_cols([tp.col(att[n], h, w) for n, w in
                               zip("qkv", widths)], widths)
    q = q.reshape(*lead, H, hd)
    k = k.reshape(*lead, KV, hd)
    v = v.reshape(*lead, KV, hd)
    if cfg.rope_theta > 0:
        pos = positions.reshape(B, -1)
        q = Lmod.apply_rope(q.reshape(B, -1, H, hd), pos,
                            cfg.rope_theta).reshape(q.shape)
        k = Lmod.apply_rope(k.reshape(B, -1, KV, hd), pos,
                            cfg.rope_theta).reshape(k.shape)
    out = _paged_attn_local(q, k, v, kp_l, vp_l, *kv_at)
    out = out.reshape(*lead, -1).to(x.dtype)
    if tp is not None:
        return x + tp.row(att["o"], out, H * hd)
    return x + decode_linear(att["o"], out)


def decode_layers(params, x: torch.Tensor, dstate, kv_at,
                  positions: torch.Tensor, cfg: ArchConfig,
                  dims: ModelDims, tp=None) -> torch.Tensor:
    """The layer loop of the dense, moe, vlm and audio families, shared
    by the decode step (``x`` (B, d)) and the verify step (``x`` (B, Q,
    d)): per layer the attention sublayer on pool layer ``i``, the audio
    decoder's cross sublayer over ``dstate["cross_k"/"cross_v"][i]``, and
    the FFN.  On a token-split rank (``tp``) each layer's blocks are
    gathered over the data axes first (``ServingTP.layer``)."""
    cross = cfg.family == "audio"
    for i in range(cfg.num_layers):
        blk = layer_params(params, i) if tp is None else tp.layer(params, i)
        x = decode_attn(blk, x, dstate["k_pool"][i], dstate["v_pool"][i],
                        kv_at, positions, cfg, dims, tp)
        if cross:
            x = decode_cross(blk, x, dstate["cross_k"][i],
                             dstate["cross_v"][i], cfg, dims, tp)
        x = decode_ffn(blk, x, cfg, tp)
    return x


# --------------------------------------------------------- full serve step

def step_shard(spec: DecodeSpec, mesh, part):
    """This rank's place for a step factory's ``mesh`` and ``part``: None
    on one device (``mesh`` None), its ``ShardedPool`` in the sharded
    layout (``spec.kv_shards >= 1``), its ``TokenSplit`` in the
    token-split layout (``kv_shards == 0``)."""
    if mesh is None:
        return None
    if spec.kv_shards < 1:
        return TokenSplit(spec, mesh)
    if part is None:
        raise ValueError("spec.kv_shards >= 1 requires a Partition")
    return ShardedPool(part, mesh.model_index, mesh.model_all_reduce)


def kv_access(trans: StepTranslation, shard):
    """The layer loop's ``kv_at`` from the step's translation: the slots,
    write rows and extents, and on a rank of a mesh the step's read: a
    ``BlockRead``, whose renumbered slots replace the logical ones, or
    the ``TokenSplit``."""
    if shard is None:
        return trans.slots[0], trans.w_row, trans.extent
    if isinstance(shard, TokenSplit):
        return trans.slots[0], trans.w_row, trans.extent, shard
    read = BlockRead(shard, trans.slots[0])
    return read.slots, trans.w_row, trans.extent, read


def make_serve_step(cfg: ArchConfig, dims: ModelDims, spec: DecodeSpec,
                    dtype=torch.float32, bound=None, mesh=None, part=None,
                    rules=None):
    """Returns serve_step(params, dstate, tokens (B,), active=None, *,
    sample=False) -> (logits (B, V), dstate, stats).  One new token per
    live sequence.

    ``dstate`` is updated in place and returned.  ``stats`` holds the
    step's translation telemetry (``slots`` / ``in_rest`` / ``mapped`` /
    ``accesses``, group-major, and ``telemetry``, the last three as one
    int32 block) and ``next_token`` (B,) int32: the argmax, or with
    ``sample=True`` each slot's sampled token (greedy slots still take the
    argmax), the key folded with the pre-step position.  ``active`` (B,)
    bool marks the slots decoding this step: inactive slots neither write
    their current KV block nor advance ``ctx_len`` (None = all
    active).  ``bound`` is a dict of translation bindings to share with a
    speculative verify step (``serve/spec_decode.py``).

    A model without attention layers (ssm) translates nothing: ``stats``
    then holds ``next_token`` only.  The hybrid family runs its groups'
    sublayers in order, the attention sublayer of group ``gi`` on pool
    layer ``gi``.

    With a ``mesh`` (``launch.mesh.Mesh``), ``spec.kv_shards >= 1`` and
    ``part`` the step runs on this rank's chunk of the sharded state (see
    the module's docstring); its outputs are the unsharded step's.  With a
    ``mesh`` and ``kv_shards == 0`` it runs on this rank's token-split
    state (``init_decode_state(mesh=)``, ``TokenSplit``) and weights (its
    blocks under ``param_shardings(..., rules)``, ``rules`` by default
    ``dist.sharding.serving_rules(cfg, spec)``; ``token_split_tp(...)
    .blocks`` cuts them), and returns the whole batch's logits and
    ``next_token``, and the stats of every group, ``(G, rows, nblk)``
    (one all-gather over the data group)."""
    check_family(cfg)
    bound = {} if bound is None else bound   # the translation's bindings
    shard = step_shard(spec, mesh, part)
    split = shard if isinstance(shard, TokenSplit) else None
    tp = None if split is None else token_split_tp(cfg, dims, spec, mesh,
                                                   rules)
    n_attn = n_attn_layers(cfg)
    fam = cfg.family

    def layer(params, i):
        return layer_params(params, i) if tp is None else tp.layer(params, i)

    def serve_step(params, dstate, tokens, active=None, *, sample=False):
        positions = dstate["ctx_len"]
        act = None if active is None else active.bool()
        whole_act = act
        rows = None
        if split is not None:
            tp.check(params)
            rows = split.rows(positions.shape[0])
            positions, tokens = positions[rows], tokens[rows]
            act = None if act is None else act[rows]
            x = tp.embed(tp.subtree(params, "embed")["table"], tokens)
        else:
            x = params["embed"]["table"][tokens.long()]
        x = x.to(dtype)
        stats = {}
        if n_attn:
            trans = translate_step(dstate["tar"], dstate["sf"],
                                   dstate["flex"], positions, spec, act,
                                   bound, shard=shard)
            stats = dict(slots=trans.slots, in_rest=trans.in_rest,
                         mapped=trans.mapped, accesses=trans.accesses,
                         telemetry=trans.telemetry)
            kv_at = kv_access(trans, shard)
        if fam == "ssm":
            for i in range(cfg.num_layers):
                x = decode_mamba(layer(params, i), x, dstate, i, act, cfg,
                                 dims, tp)
        elif fam == "hybrid":
            g = cfg.attn_every
            for gi in range(cfg.num_layers // g):
                blk = layer(params, gi)
                for i in range(g):
                    if i < g - 1:
                        x = decode_mamba(take(blk["mamba"], i), x, dstate,
                                         gi * (g - 1) + i, act, cfg, dims,
                                         tp)
                    else:
                        x = decode_attn(blk["attn"], x, dstate["k_pool"][gi],
                                        dstate["v_pool"][gi], kv_at,
                                        positions, cfg, dims, tp)
                    x = decode_ffn(hybrid_ffn_select(cfg, blk, i), x, cfg,
                                   tp)
        else:
            x = decode_layers(params, x, dstate, kv_at, positions, cfg,
                              dims, tp)
        logits = project_logits(params, x, cfg, dims, tp)
        samp = slice(None) if rows is None else rows
        if sample:
            stats["next_token"] = sample_tokens(
                logits, dstate["samp_temp"][samp], dstate["samp_topk"][samp],
                dstate["samp_topp"][samp], dstate["samp_key"][samp],
                positions)
        else:
            stats["next_token"] = logits.argmax(dim=-1).to(torch.int32)
        if split is not None:
            logits, stats = _gather_step(split, logits, stats)
        # only active slots advance (in place, after every read above)
        dstate["ctx_len"].add_(1 if whole_act is None else whole_act)
        return logits, dstate, stats

    return serve_step


def token_split_tp(cfg: ArchConfig, dims: ModelDims, spec: DecodeSpec,
                   mesh, rules=None) -> ServingTP:
    """The tensor parallelism of a token-split rank's steps: its weights
    are its blocks under ``param_shardings(..., rules)``, JAX's layout
    (``rules`` by default ``serving_rules(cfg, spec)``: the spec's axes,
    ZeRO as ``cfg.zero_shard_params``).  ``.blocks(whole)`` cuts them."""
    return ServingTP(cfg, dims, mesh,
                     serving_rules(cfg, spec) if rules is None else rules)


def _gather_step(split: TokenSplit, logits, stats):
    """A token-split rank's step outputs, whole: the batch's logits and
    ``next_token`` (in batch mode gathered over the data group; in striped
    mode every rank computed every row) and every group's translation
    stats, ``(G, rows, nblk)`` each, from one all-gather."""
    names = [k for k in ("slots", "in_rest", "mapped", "accesses")
             if k in stats]
    out = [logits, stats["next_token"]]
    grids = [stats[k] for k in names]
    if split.striped:
        grids = split.gather_groups(grids)
    else:
        out = split.gather_groups(out + grids)
        out, grids = out[:2], out[2:]
    new = dict(zip(names, grids))
    new["next_token"] = out[1]
    return out[0], new
