"""Wrappers of the rows-invariant GEMM kernel (``csrc/rows_gemm.cu``).

Each output row's bits depend only on that row of x, the weights and the
bias, whatever the number of rows of the call: the prefill's projections
go through here so that a prompt rounds the same whether it is admitted
in one chunk or several, padded or not, alone or beside others.

* ``rows_gemm(x, w, b)`` — ``x (..., K) @ w (K, N) (+ b)``; ``w`` may be a
  k-major weight (``linear``'s) or an n-major one read in place
  (``unembed``'s ``table.T``);
* ``rows_bmm(x, w)`` — ``torch.bmm`` of ``(G, M, K)`` and ``(G, K, N)``
  (the MoE experts);
* ``rows_einsum(eq, a, b)`` — a two-operand ``torch.einsum`` with batch,
  row, column and contracted indices (the SSD's products), its operands
  read where they lie when their index groups merge.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``ref.py``: the op the forward runs without them).  On ``meta``
tensors (the dry run) each returns the output's shape and records the
kernel's cost.
``rows_gemm.launches`` counts kernel launches of all three,
``rows_gemm.launches_f32`` those of them in float32.

float32 runs on the CUDA cores: each output is one ``fmaf`` chain over k
in increasing order from ``+0.f``, then the bias added, so its bits depend
on no tile and ``f32_tile`` picks the tile (``F32_TILES``) by the whole
shape, M included, so that the grid covers the SMs wherever the outputs
allow; the C launch copies each operand along its contiguous axis, 16
bytes a copy where its strides and alignment allow.
``rows_gemm_f32_ordered(plan, b)`` launches the order's oracle (one thread
an output); the tiled kernel equals it bitwise.  Only tests and
``chip_smoke.py`` call it.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from .. import _build
from .ref import rows_bmm_ref, rows_einsum_ref, rows_gemm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BATCH = 65535          # the grid's z extent
SMS = 132                  # an H100 SXM's SMs

# the float32 kernel's tiles, by index (``rows_gemm_launch``'s ``tile``):
# (rows, columns) a CTA; the C launch names each tile's thread shape
F32_TILES = ((128, 128), (64, 64), (64, 32), (128, 16), (16, 16))
F32_NARROW = (3, 4)        # the 16-column tiles, for N <= 32
F32_FILL = 0.9             # a grid of this share of the SMs covers them
F32_WASTE = 1.25           # at most this share of a tile's outputs padding

_launch = {}        # the bound C entry points, once loaded


def _lib(entry="rows_gemm_launch"):
    if entry not in _launch:
        fn = getattr(_build.load("rows_gemm"), entry)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        main = entry == "rows_gemm_launch"
        fn.argtypes = (([i] if main else []) + [p] * 4 + [i] * 5 + [ll] * 8
                       + ([i] if main else []) + [p])  # dtype; tile
        fn.restype = ctypes.c_int
        _launch[entry] = fn
    return _launch[entry]


def f32_ctas(tile: int, G: int, M: int, N: int) -> int:
    """CTAs of the float32 grid over ``G`` batches of ``M x N`` with
    ``F32_TILES[tile]``."""
    bm, bn = F32_TILES[tile]
    return G * -(-M // bm) * -(-N // bn)


def f32_tile(G: int, M: int, N: int) -> int:
    """The float32 kernel's tile for ``G`` batches of ``M x N`` outputs:
    the largest tile (``F32_TILES``; for ``N <= 32`` the 16-column ones)
    whose grid covers ``F32_FILL`` of the ``SMS`` SMs with at most
    ``F32_WASTE`` of padded outputs, else the smallest.  Every output's
    bits are the same under every tile; K does not enter (each CTA walks
    all of it, no tile splits it)."""
    order = F32_NARROW if N <= 32 else (0, 1, 2, 4)
    for t in order[:-1]:
        bm, bn = F32_TILES[t]
        padded = -(-M // bm) * bm * -(-N // bn) * bn
        if (f32_ctas(t, G, M, N) >= F32_FILL * SMS
                and padded <= F32_WASTE * M * N):
            return t
    return order[-1]


class Plan(NamedTuple):
    """A call of the kernel: ``y (G1 * G2, M, N) = x @ w`` over the
    operands ``x``, ``w`` read at strides ``sx = (batch1, batch2, row,
    k)`` and ``sw = (batch1, batch2, k, column)`` (elements), the result
    seen as ``shape`` permuted by ``perm``."""
    x: torch.Tensor
    w: torch.Tensor
    G1: int
    G2: int
    M: int
    N: int
    K: int
    sx: Tuple[int, int, int, int]
    sw: Tuple[int, int, int, int]
    shape: Tuple[int, ...]
    perm: Tuple[int, ...]


def _execute(plan: Plan, b=None, ordered=False):
    """Launch ``plan`` (with the bias ``b``) into a new contiguous output
    and return the result's view; ``ordered``: through the float32
    oracle, uncounted."""
    x, w, G1, G2, M, N, K, sx, sw, shape, perm = plan
    if G1 * G2 > MAX_BATCH:
        raise ValueError(f"rows_gemm: {G1 * G2} batches (at most "
                         f"{MAX_BATCH})")
    if x.dtype == torch.bfloat16 and (
            sx[3] != 1 or (sw[3] != 1 and sw[2] != 1) or K % 8 or N % 8
            or any(s % 8 for s in (*sx[:3], *sw[:2]))
            or (sw[2] if sw[3] == 1 else sw[3]) % 8
            or any(t.data_ptr() % 16 for t in (x, w))):
        raise ValueError(
            "rows_gemm: bfloat16 needs x rows contiguous along K, a weight "
            "contiguous along K or N, K and N multiples of 8, the other "
            "strides multiples of 8 and 16-byte aligned operands (x "
            f"{tuple(x.shape)} strides {sx}, w strides {sw}, K {K}, N {N})")
    if b is not None and not b.is_contiguous():
        raise ValueError("rows_gemm: the bias must be contiguous")
    out = torch.empty((G1 * G2, M, N), dtype=x.dtype, device=x.device)
    if out.numel():
        args = (x.data_ptr(), w.data_ptr(), 0 if b is None else b.data_ptr(),
                out.data_ptr(), G1, G2, M, N, K, *sx, *sw)
        f32 = x.dtype == torch.float32
        if ordered:
            rc = _lib("rows_gemm_f32_ordered_launch")(
                *args, _build.stream_handle(x))
        else:
            tile = f32_tile(G1 * G2, M, N) if f32 else 0
            rc = _lib()(_DTYPES[x.dtype], *args, tile,
                        _build.stream_handle(x))
        _build.check_launch("rows_gemm", rc)
        if not ordered:
            rows_gemm.launches += 1
            rows_gemm.launches_f32 += f32
    return out.view(shape).permute(perm)


def _meta(plan: Plan, b=None):
    """The dry run: the output's shape, and the kernel's cost (each
    operand read once, the output written once)."""
    x, w, G1, G2, M, N, K = plan[:7]
    G = G1 * G2
    _build.count_meta("rows_gemm", 2 * G * M * N * K,
                      (x.numel() + w.numel() + G * M * N
                       + (0 if b is None else N)) * x.element_size())
    return torch.empty(plan.shape, dtype=x.dtype,
                       device="meta").permute(plan.perm)


def gemm_plan(x, w) -> Plan:
    """``x (..., K) @ w (K, N)``: the leading axes of x as rows."""
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"rows_gemm: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    lead = tuple(x.shape[:-1])
    K, N = w.shape
    M = math.prod(lead)
    x2 = x.reshape(M, K)
    return Plan(x2, w, 1, 1, M, N, K, (0, 0, *x2.stride()),
                (0, 0, *w.stride()), (*lead, N), tuple(range(len(lead) + 1)))


def bmm_plan(x, w) -> Plan:
    """``torch.bmm(x (G, M, K), w (G, K, N))``."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or (
            x.shape[2] != w.shape[1]):
        raise ValueError(f"rows_bmm: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    G, M, K = x.shape
    N = w.shape[2]
    return Plan(x, w, G, 1, M, N, K, (x.stride(0), 0, *x.stride()[1:]),
                (w.stride(0), 0, *w.stride()[1:]), (G, M, N), (0, 1, 2))


def _merge(sizes, strides):
    """One (size, stride) for dims laid out outer to inner, or None when
    they do not form one stride (size-1 dims are left out)."""
    dims = [(n, s) for n, s in zip(sizes, strides) if n != 1]
    if not dims:
        return 1, 0
    size, stride = dims[-1]
    for n, s in reversed(dims[:-1]):
        if s != stride * size:
            return None
        size *= n
    return size, stride


def _merged(p, groups):
    """Each group of ``p``'s leading dims (``groups``, lists of indices,
    in order) merged to one (size, stride), or None if one does not."""
    merged, i = [], 0
    for g in groups:
        m = _merge(p.shape[i:i + len(g)], p.stride()[i:i + len(g)])
        if m is None:
            return None
        merged.append(m)
        i += len(g)
    return merged


def _operand(t, order, groups, copy):
    """``t`` (indices ``order``) permuted to the concatenation of
    ``groups`` (lists of its indices) and each group merged to one (size,
    stride): ``(tensor, [(size, stride), ...])``; where a group does not
    merge in place, None, or with ``copy`` the tensor copied into that
    order once."""
    p = t.permute([order.index(c) for g in groups for c in g])
    merged = _merged(p, groups)
    if merged is None and copy:
        p = p.contiguous()
        merged = _merged(p, groups)
    return None if merged is None else (p, merged)


def einsum_plan(eq: str, a, b) -> Plan:
    """``torch.einsum(eq, a, b)`` for two operands whose indices are each
    batch (in a, b and the output), row (a and the output), column (b and
    the output) or contracted (a and b): a batched ``(G, M, K) @ (G, K,
    N)`` over the operands as they lie where each group of indices forms
    one stride (the batch indices as one axis, else as two), else over a
    copy of the operand in that order."""
    ins, out_ix = eq.replace(" ", "").split("->")
    ia, ib = ins.split(",")
    batch = [c for c in out_ix if c in ia and c in ib]
    rows = [c for c in out_ix if c in ia and c not in ib]
    cols = [c for c in out_ix if c in ib and c not in ia]
    red = [c for c in ia if c in ib and c not in out_ix]
    if (len(set(ia)) != len(ia) or len(set(ib)) != len(ib)
            or len(ia) != a.dim() or len(ib) != b.dim()
            or len(batch) + len(rows) + len(cols) != len(out_ix)
            or any(c not in out_ix and c not in red for c in ia + ib)):
        raise ValueError(f"rows_einsum: unsupported equation {eq!r} for "
                         f"shapes {tuple(a.shape)}, {tuple(b.shape)}")
    size = {c: n for ix, t in ((ia, a), (ib, b)) for c, n in zip(ix, t.shape)}
    for c in batch + red:
        if a.shape[ia.index(c)] != b.shape[ib.index(c)]:
            raise ValueError(f"rows_einsum: index {c!r} has sizes "
                             f"{a.shape[ia.index(c)]}, {b.shape[ib.index(c)]}")
    def operands(cut, copy):
        groups = [batch[:cut], batch[cut:]]
        return (_operand(a, ia, groups + [rows, red], copy),
                _operand(b, ib, groups + [red, cols], copy))

    # the first split of the batch indices under which both operands
    # merge in place, else the last, copying what does not merge
    cuts = [len(batch), *range(1, len(batch))]
    for cut in cuts:
        found = operands(cut, False)
        if all(found):
            break
    else:
        found = operands(cuts[-1], True)
    (pa, ma), (pb, mb) = found
    (G1, sa1), (G2, sa2), (M, sam), (K, sak) = ma
    (_, sb1), (_, sb2), (_, sbk), (N, sbn) = mb
    order = batch + rows + cols
    return Plan(pa, pb, G1, G2, M, N, K, (sa1, sa2, sam, sak),
                (sb1, sb2, sbk, sbn), tuple(size[c] for c in order),
                tuple(order.index(c) for c in out_ix))


def _where(name, *ts):
    """"cpu", "meta" or "cuda" for the call's tensors (raises on a mix)."""
    devs = {t.device for t in ts if t is not None}
    if all(d.type == "cpu" for d in devs):
        return "cpu"
    if len(devs) != 1 or next(iter(devs)).type not in ("meta", "cuda"):
        raise ValueError(f"{name}: the operands must lie on one CUDA or "
                         f"meta device, got {devs}")
    ts = [t for t in ts if t is not None]
    if ts[0].dtype not in _DTYPES or any(t.dtype != ts[0].dtype
                                         for t in ts):
        raise ValueError(f"{name}: operands must share float32 or bfloat16, "
                         f"got {[t.dtype for t in ts]}")
    return next(iter(devs)).type


def rows_gemm(x, w, b=None, *, block=None):
    """``x (..., K) @ w (K, N) (+ b (N,))`` in x's dtype (float32 or
    bfloat16, shared by all three), each row of the result independent of
    the others' count.  ``block``: the plain version's rows a product
    (``rows_gemm_ref``); the kernel's rows need none."""
    where = _where("rows_gemm", x, w, b)
    if where == "cpu":
        return rows_gemm_ref(x, w, b, block)
    plan = gemm_plan(x, w)
    if b is not None and tuple(b.shape) != (plan.N,):
        raise ValueError(f"rows_gemm: bias {tuple(b.shape)} for {plan.N} "
                         "columns")
    return (_meta if where == "meta" else _execute)(plan, b)


def rows_bmm(x, w):
    """``torch.bmm(x (G, M, K), w (G, K, N))`` with the kernel's rows."""
    where = _where("rows_bmm", x, w)
    if where == "cpu":
        return rows_bmm_ref(x, w)
    return (_meta if where == "meta" else _execute)(bmm_plan(x, w))


def rows_einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` with the kernel's rows (``einsum_plan``);
    the result is a view in ``eq``'s output order."""
    where = _where("rows_einsum", a, b)
    if where == "cpu":
        return rows_einsum_ref(eq, a, b)
    return (_meta if where == "meta" else _execute)(einsum_plan(eq, a, b))


def rows_gemm_f32_ordered(plan: Plan, b=None):
    """``plan`` (``gemm_plan``, ``bmm_plan`` or ``einsum_plan`` of float32
    CUDA operands) with the bias ``b``, through the float32 oracle: one
    thread an output, the kernel's chain and bias (the tiled kernel's bits,
    by another schedule).  For tests and ``chip_smoke.py``."""
    if _where("rows_gemm_f32_ordered", plan.x, plan.w, b) != "cuda" or (
            plan.x.dtype != torch.float32):
        raise ValueError("rows_gemm_f32_ordered: float32 CUDA operands only")
    return _execute(plan, b, ordered=True)


rows_gemm.launches = 0
rows_gemm.launches_f32 = 0
