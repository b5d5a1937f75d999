"""Logical sharding rules for the train state, and the sharded serving
layout of the decode state.

The port of ``repro.dist.sharding``.  Two contracts live here:

* ``param_shardings`` — walks the parameter tree and gives each leaf a
  ``PartitionSpec`` from its *logical* spec (``_logical_param_spec``): the
  model axis carries tensor parallelism (column/row-parallel linears,
  vocab-sharded embeddings, expert-sharded MoE weights) and, when
  ``zero_params`` is set, the data axes additionally shard the non-model
  dimension (ZeRO-3/FSDP).  Per-layer stacks are never sharded: logical
  specs are written against the unstacked leaf and left-padded with
  ``None``.  ``batch_spec`` splits a batch's leading dim over the data
  axes.  A spec is JAX's ``PartitionSpec``: one entry a dim, each ``None``
  (whole) or the axis names that split it, ``()`` for a replicated leaf,
  and every spec passes ``_guard`` (axes that do not divide the dim are
  dropped).
* ``kv_state_specs`` — the sharded serving layout of the decode state.

A JAX mesh places the blocks itself (``jax.device_put`` with the specs);
here each rank holds its own block of every leaf: ``shard_tree`` cuts a
whole tree into this rank's blocks (a dim split over an axis of size n
into n equal blocks, this rank's by its index along the axis), and
``gather_tree`` rebuilds the whole leaves from every rank's blocks (one
all-gather a leaf).  ``Block`` tells the optimizers where a block
lies in its leaf, so that statistics over a whole leaf (the global norm,
Adafactor's factored means, int8 compression's scale) sum over the ranks
that hold its other blocks.

``make_pins`` is not ported: its activation pins steer GSPMD's layout and
never change numerics, and the port places every tensor itself (ROADMAP,
deliberate differences).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.ckpt.checkpoint import tree_flatten, tree_unflatten
from repro_torch.launch.mesh import AXES


class PartitionSpec:
    """JAX's ``PartitionSpec``: one entry a dim, each ``None`` or axis
    names (a string, or a tuple of several; a tuple of one is its name,
    as JAX normalises it).  It is a leaf of the port's trees (not a
    tuple), and equals the tuple of its entries."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else (tuple(e) if isinstance(e, list) else e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            other = other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"PartitionSpec{self.entries!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mesh-logical axis assignment.

    ``data_axes``: mesh axes carrying data parallelism (the port's mesh
    has one, ``("data",)``).  ``zero_params``: shard the non-model
    parameter dim over the data axes (ZeRO-3); off = pure replication
    outside the model axis (faster for small models).
    """

    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    zero_params: bool = True


def _sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``Mesh``, a ``(data, model)`` shape or a
    dict of sizes."""
    shape = getattr(mesh, "shape", mesh)
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(AXES, shape))


def _mesh_axes(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, major to minor (a ``Mesh``'s are ``AXES``;
    a ``MeshDesc`` may have a ``pod`` axis before them)."""
    return tuple(getattr(mesh, "axis_names", AXES))


def _names(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axes_size(axes, mesh) -> int:
    sizes = _sizes(mesh)
    n = 1
    for a in _names(axes):
        n *= sizes[a]
    return n


def _guard(spec, shape, mesh) -> PartitionSpec:
    """Drop spec entries whose mesh-axis product does not divide the dim."""
    spec = tuple(spec)[:len(shape)]
    spec = spec + (None,) * (len(shape) - len(spec))
    out = []
    for dim, axes in zip(shape, spec):
        if axes is None:
            out.append(None)
        else:
            out.append(axes if dim % _axes_size(axes, mesh) == 0 else None)
    return P(*out)


def _logical_param_spec(path: Tuple[str, ...],
                        rules: ShardingRules) -> Optional[tuple]:
    """Logical spec of one (unstacked) parameter leaf; None = replicated.

    ``path`` is the tuple of dict keys down to the leaf, e.g.
    ``("layers", "attn", "q", "w")``.
    """
    D = tuple(rules.data_axes) if rules.zero_params else None
    M = rules.model_axis
    name = path[-1]

    # small / replicated leaves: norms, biases, mamba scalars
    if "norm" in name or name in ("b", "conv_b", "A_log", "D", "dt_bias"):
        return None
    if name == "table":                 # embed / lm_head: vocab over model
        return (M, D)
    if name == "w":
        parent = path[-2] if len(path) > 1 else ""
        if parent in ("q", "k", "v", "gate", "up"):   # column-parallel
            return (D, M)
        if parent in ("o", "down"):                   # row-parallel
            return (M, D)
        if parent == "cross":
            return (D, M)
        return (D, None)                # router / frontend_proj / misc
    # MoE expert stacks are raw 3D arrays (E, d_in, d_out): experts over
    # the model axis (expert parallelism), ZeRO over d_model
    if name in ("gate", "up"):
        return (M, D, None)
    if name == "down":
        return (M, None, D)
    # mamba projections
    if name in ("in_z", "in_x", "in_dt"):
        return (D, M)
    if name in ("in_B", "in_C"):
        return (D, None)
    if name == "conv_w":
        return (None, M)
    if name == "out_proj":
        return (M, D)
    return None


def _path_names(path) -> Tuple[str, ...]:
    """The dict keys down to a leaf, as strings."""
    return tuple(str(k) for k in path)


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of a tree of nested dicts (a
    parameter tree; JAX's ``tree_map_with_path``), ``path`` the keys down
    to the leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    return fn(path, tree)


def param_shardings(params, rules: ShardingRules, mesh):
    """``PartitionSpec`` tree for a parameter tree (tensors of any device,
    ``meta`` included, or anything with a ``.shape``)."""

    def leaf_sharding(path, leaf):
        spec = _logical_param_spec(_path_names(path), rules)
        if spec is None:
            return P()
        # left-pad for scan-stack dims (layers / hybrid sub-stacks)
        pad = (None,) * max(0, len(leaf.shape) - len(spec))
        return _guard(pad + tuple(spec), leaf.shape, mesh)

    return map_with_path(leaf_sharding, params)


def batch_spec(batch, rules: ShardingRules, mesh):
    """Batch shardings: leading dim over the data axes, rest replicated."""
    D = tuple(rules.data_axes)
    return {k: _guard((D,), x.shape, mesh) for k, x in batch.items()}


# ------------------------------------------------- blocks on the ranks

def _entries(spec, ndim: int) -> Tuple[Any, ...]:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def block_of(x: torch.Tensor, spec, mesh,
             axes: Iterable[str] = None) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec``: a view,
    cut only along the dims split over ``axes`` (all of the mesh's by
    default)."""
    keep = set(_mesh_axes(mesh) if axes is None else axes)
    for dim, entry in enumerate(_entries(spec, x.dim())):
        if entry is None or not set(_names(entry)) <= keep:
            continue
        ax = mesh.axis(_names(entry))
        n = x.shape[dim] // ax.size
        x = x.narrow(dim, ax.index * n, n)
    return x


def whole_of(x: torch.Tensor, spec, mesh,
             axes: Iterable[str] = None) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` under ``spec``: one
    all-gather over the axes (among ``axes``) that split its dims, the
    blocks then laid into place (every rank of those axes must call it).
    A leaf that no dim of ``axes`` splits comes back as ``x`` itself.  On
    the card it returns once the gather has run: the collective's buffers
    are freed only then, and a host running ahead of the card would hold
    every leaf's at once."""
    keep = set(_mesh_axes(mesh) if axes is None else axes)
    split = {d: _names(e) for d, e in enumerate(_entries(spec, x.dim()))
             if e is not None and set(_names(e)) <= keep}
    if not split:
        return x
    names = tuple(a for a in _mesh_axes(mesh)
                  if any(a in n for n in split.values()))
    sizes = _sizes(mesh)
    # (blocks of each axis in index order, the block's dims)
    g = mesh.all_gather(x.unsqueeze(0), 0, names).reshape(
        *(sizes[a] for a in names), *x.shape)
    order = []
    for d in range(x.dim()):
        order += [names.index(a) for a in split.get(d, ())]
        order.append(len(names) + d)
    whole = g.permute(order).reshape(whole_shape(x.shape, P(*(
        split.get(d) for d in range(x.dim()))), mesh))
    if whole.is_cuda:
        torch.cuda.current_stream(whole.device).synchronize()
    return whole


def _own(block: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """``block`` in storage of its own, unless it is all of ``whole``."""
    if block.shape == whole.shape:
        return block
    return block.clone(memory_format=torch.contiguous_format)


@torch.no_grad()
def shard_tree(tree, specs, mesh):
    """This rank's block of every leaf of the whole ``tree`` under
    ``specs`` (a tree of ``PartitionSpec`` shaped like ``tree``), without
    autograd history: a contiguous copy, so that the whole tree can be
    freed, or the leaf's own storage where the block is the whole leaf
    (on axes of one position, a state costs no second copy)."""
    flat, _ = tree_flatten(tree)
    out = [_own(block_of(x.detach(), s, mesh), x.detach())
           for x, s in zip(flat, tree_flatten(specs)[0])]
    return tree_unflatten(tree, out)


@torch.no_grad()
def gather_tree(tree, specs, mesh):
    """The whole leaves of a sharded ``tree`` (every rank's blocks
    gathered; every rank must call it, leaf by leaf in the same order)."""
    flat, _ = tree_flatten(tree)
    out = [whole_of(x.detach(), s, mesh)
           for x, s in zip(flat, tree_flatten(specs)[0])]
    return tree_unflatten(tree, out)


def whole_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The whole leaf's shape from a block's ``shape`` under ``spec``."""
    return tuple(n * (1 if e is None else _axes_size(e, mesh))
                 for n, e in zip(shape, _entries(spec, len(shape))))


@dataclasses.dataclass(frozen=True)
class Block:
    """Where a tensor block lies in its whole leaf: the ``spec`` (one
    entry a dim of the leaf), the whole ``shape`` and the ``mesh``.
    Reductions over dims that the spec splits sum over the ranks holding
    the leaf's other blocks along them; an axis of one position splits
    nothing, so on such axes a block reduces as the whole leaf does, bit
    for bit."""

    spec: Tuple[Any, ...]
    shape: Tuple[int, ...]
    mesh: Any

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def _axes(self, dims) -> Tuple[str, ...]:
        """The mesh axes of more than one position that split ``dims``
        (dims of the leaf, negative from the end), in the mesh's order."""
        nd = len(self.shape)
        sizes = _sizes(self.mesh)
        names = set()
        for d in dims:
            e = self.spec[d % nd]
            if e is not None:
                names.update(a for a in _names(e) if sizes[a] > 1)
        return tuple(a for a in _mesh_axes(self.mesh) if a in names)

    def split(self, dim: int) -> bool:
        """Whether the spec splits leaf dim ``dim``."""
        return bool(self._axes((dim,)))

    def any_split(self) -> bool:
        return bool(self._axes(range(len(self.shape))))

    def sum(self, t: torch.Tensor, dims=None) -> torch.Tensor:
        """``t`` (this block's partial sum over leaf ``dims``, all of them
        by default) summed in place over the ranks that split them."""
        axes = self._axes(range(len(self.shape)) if dims is None else dims)
        if axes:
            self.mesh.all_reduce(t, axes)
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (this block's partial max) maxed in place over the ranks
        that hold the leaf's other blocks."""
        axes = self._axes(range(len(self.shape)))
        if axes:
            self.mesh.all_reduce(t, axes, op=torch.distributed.ReduceOp.MAX)
        return t

    @property
    def owner(self) -> bool:
        """Whether this rank holds the copy of its block that counts once
        in a sum over the world: index 0 along every axis that does not
        split the leaf."""
        split = self._axes(range(len(self.shape)))
        return all(self.mesh.axis(a).index == 0
                   for a in _mesh_axes(self.mesh) if a not in split)


def block_tree(tree, specs, mesh):
    """A ``Block`` for each leaf of the sharded ``tree`` (blocks) under
    ``specs``."""
    flat, _ = tree_flatten(tree)
    out = [Block(_entries(s, x.dim()), whole_shape(x.shape, s, mesh), mesh)
           for x, s in zip(flat, tree_flatten(specs)[0])]
    return tree_unflatten(tree, out)


# ---------------------------------------- KV / translation state rules

# decode-state tensors sharded over the model axis, and the dimension each
# one shards: the KV pools by physical slot, the TAR/SF tables by set
# index, the flat flex table by vpn range
_SHARDED = {"k_pool": 1, "v_pool": 1, "tar": 1, "sf": 1, "flex": 1}


def kv_state_specs(state: Iterable[str]) -> Dict[str, Optional[int]]:
    """Per decode-state key (``state``: the dict or its keys), the
    dimension it shards over the mesh's model axis, or None where every
    rank holds the whole tensor.

    The sharded serving layout (DESIGN.md §sharded-serving): the KV pool
    is slot-sharded in the shard-contiguous physical numbering of
    ``core.partition.Partition``, the TAR/SF tables are set-index
    partitioned and the flat flex table vpn-range partitioned over the
    same axis; everything else (context lengths, sampling state, ssm/conv
    rows, cross K/V, the drafter's history) is replicated, as all float
    compute is.  A rank's decode state holds its own chunk of each sharded
    tensor.  The engine's state placement, its translation-delta routing
    and its snapshots all read this one table."""
    return {k: _SHARDED.get(k) for k in state}
