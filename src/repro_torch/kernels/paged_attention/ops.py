"""Wrapper of the paged-attention kernel (``csrc/paged_attention.cu``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version in ``ref.py``.  ``paged_attention.launches`` counts kernel
launches; ``paged_attention.launches_multi_query`` counts those among them
with more than one query per row (the prefix-KV prefill's read and the
speculative verify read), and ``paged_attention.launches_q_per_query``
those with one extent per query, ``ctx_len (B, Q)`` (the verify read).

Two designs share the source: the cluster kernel (PRs 12 and 17; every
head dim but 64 and 256: granite's, qwen's, jamba's and the token-split
reads at D = 128) and the fold kernel (D = 64 and 256: whisper-medium's
and paligemma-3b's).  ``read_plan`` says which, and how a row is cut.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from .ref import paged_attention_ref

_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SPLIT = 8       # CTAs that merge one (row, query tile, KV head)
MAX_FOLD = 64       # chunks one CTA of the fold kernel folds from memory
FOLD_MAX_Q = 8      # queries a row up to which each chunk has its own CTA
STAMPS = 13         # stamps a CTA (``stamps=``)
# measurement switch: True sends every geometry to the cluster kernel
# (chip_smoke.py --paged-reads times the two designs side by side)
CLUSTER_ONLY = False


def split_plan(nblk: int):
    """How the kernel cuts a row's ``nblk`` blocks over CTAs: ``(n_split,
    per_split)``, chunk ``s`` taking blocks ``[s * per_split, min(nblk,
    (s + 1) * per_split))``.  At most ``MAX_SPLIT`` chunks (one thread-block
    cluster), none empty.  A function of ``nblk`` alone, so a row's result
    never depends on its batch neighbours or on the number of queries."""
    if nblk <= 0:
        return 1, 1
    per = -(-nblk // MAX_SPLIT)
    return -(-nblk // per), per


class ReadPlan(NamedTuple):
    """How the kernel cuts a row's blocks: chunk ``s`` takes blocks ``[s *
    per_split, min(nblk, (s + 1) * per_split))``; ``fold``: the fold
    kernel's plan (a chunk a block), else the cluster kernel's."""
    n_split: int
    per_split: int
    fold: bool


def _padded_d(D: int) -> int:
    return next(p for p in (16, 32, 64, 128, 256) if D <= p)


def read_plan(nblk: int, KV: int, D: int, g: int) -> ReadPlan:
    """The split of a row's ``nblk`` blocks at ``KV`` KV heads of dim ``D``
    with ``g`` query heads each: a function of these four alone, never of
    the batch, the queries or the extents, so a row's result never depends
    on its neighbours or on how many queries the launch holds.  At D = 64
    and 256 (padded) the fold kernel's, a chunk a block; elsewhere
    ``split_plan(nblk)``, the cluster kernel's.  ``g`` and ``KV`` do not
    change the cut today."""
    return _read_plan(nblk, D, CLUSTER_ONLY)


@functools.lru_cache(maxsize=None)
def _read_plan(nblk: int, D: int, cluster_only: bool) -> ReadPlan:
    if not cluster_only and _padded_d(D) in (64, 256):
        return ReadPlan(max(1, nblk), 1, True)
    return ReadPlan(*split_plan(nblk), False)


def fold_ctas(plan: ReadPlan, Q: int, D: int,
              tensor_cores: bool = True) -> int:
    """The fold kernel's CTAs a (row, query tile, KV head): up to
    ``FOLD_MAX_Q`` queries and ``MAX_FOLD`` chunks one a chunk, two (a
    column half each) on the tensor cores at D = 256, so the decode read
    fills the card at the serving batches (paligemma's 8 / 1 heads of
    256: 32 CTAs a row at 16 blocks; whisper's 16 / 16 of 64: 256); else
    one for every chunk (the prefix read: its partials would take
    hundreds of MB)."""
    if Q > FOLD_MAX_Q or plan.n_split > MAX_FOLD:
        return 1
    return plan.n_split * _column_halves(D, tensor_cores)


def _column_halves(D: int, tensor_cores: bool) -> int:
    return 2 if tensor_cores and _padded_d(D) == 256 else 1


def query_tile(Q: int, g: int, D: int, tensor_cores: bool = True) -> int:
    """How many consecutive queries of a row one CTA takes (the kernel's
    QT): 1 at Q = 1 (the decode read), else as many as fill, with the g
    heads of a KV head padded to G = 1, 2, 4 or 8 as the kernel pads them,
    32 (query, head) rows at D <= 128 and 16 above on the tensor cores (two
    m16 MMA tiles a warp, or one: an m16 tile's P V accumulators take 64
    registers a lane at D = 128), or 8 rows on the CUDA cores (whose state
    then takes the registers of 8 heads).  A function of (Q, g, D) and the
    cores alone, so which tile a query falls in never depends on the
    extents or on the row's batch neighbours."""
    if Q <= 1:
        return 1
    G = 1 << max(0, int(g) - 1).bit_length()
    if not tensor_cores:
        return 8 // G
    return (32 if D <= 128 else 16) // G


def cta_grid(B: int, Q: int, H: int, KV: int, D: int, nblk: int,
             tensor_cores: bool = True):
    """The launch grid ``(KV * n, ceil(Q / QT), B)``: the cluster kernel's
    one CTA per (row, query tile, KV head, split chunk), the chunks of one
    (row, query tile, KV head) a cluster (n = n_split); the fold kernel's
    ``fold_ctas`` CTAs per (row, query tile, KV head)."""
    qt = query_tile(Q, H // KV, D, tensor_cores)
    plan = read_plan(nblk, KV, D, H // KV)
    n = fold_ctas(plan, Q, D, tensor_cores) if plan.fold else plan.n_split
    return KV * n, -(-Q // qt), B


_launch = []        # the bound C entry point, once loaded


def _lib():
    if not _launch:
        fn = _build.load("paged_attention").paged_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int   # bare ints would be 32-bit
        fn.argtypes = [i, i] + [p] * 8 + [i] * 16 + [p] * 4
        fn.restype = ctypes.c_int
        _launch.append(fn)
    return _launch[0]


# per card: the fold kernel's counters, zeros that each launch's folding
# CTAs set back to 0 (so two streams must not run the kernel at once)
_counters = {}


def _fold_counters(dev, n: int):
    c = _counters.get(dev)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _counters[dev] = c
    return c


def paged_attention(q, k_pool, v_pool, slots, ctx_len, *,
                    tok_offset: int = 0, tok_stride: int = 1,
                    block_tokens: int | None = None, stamps=None):
    """Online-softmax attention of each row's queries over its pool blocks.

    ``q (B, H, D)`` or ``(B, Q, H, D)``; ``k_pool``/``v_pool (slots, bs,
    KV, D)`` float32 or bfloat16; ``slots (B, nblk)`` int32 (-1 = hole);
    ``ctx_len (B,)`` or ``(B, Q)`` int32.  Returns the unnormalized
    ``(o (B[, Q], H, D), m (B[, Q], H), l (B[, Q], H))``, all float32.
    The kernel reads q in float32 or bfloat16 as it comes; one launch per
    call, and no other device work (the fold kernel's workspace is an
    allocation).  ``stamps``: an int64 CUDA tensor of ``STAMPS`` entries a
    CTA of ``cta_grid`` (blockIdx order), which the kernel fills: the
    %globaltimer ns at the CTA's start and end, its SM's clock64 at start,
    first tile in, tiles done, CTA merge done, partial written (or cluster
    merge done) and end, 1 where the CTA wrote the result, the tiles it
    computed, and the fold kernel's folding CTA's clock64 after the counter,
    after its partials' m and l arrived and after the weights
    (chip_smoke.py --paged-reads' stage breakdown)."""
    # (the checks below are written out: this runs 36 times a decode step)
    tensors = (q, k_pool, v_pool, slots, ctx_len)
    dev = q.device
    if dev.type == "cpu" and all(t.device.type == "cpu" for t in tensors):
        return paged_attention_ref(q, k_pool, v_pool, slots, ctx_len,
                                   tok_offset=tok_offset,
                                   tok_stride=tok_stride,
                                   block_tokens=block_tokens)
    if dev.type == "meta":
        return _meta_call(q, k_pool, slots, ctx_len)
    if (dev.type != "cuda" or k_pool.device != dev or v_pool.device != dev
            or slots.device != dev or ctx_len.device != dev):
        raise ValueError("paged_attention: all inputs must be on one CUDA "
                         f"device (got {[str(t.device) for t in tensors]})")
    if q.dim() not in (3, 4):
        raise ValueError(f"paged_attention: q must be (B,H,D) or (B,Q,H,D), "
                         f"got {tuple(q.shape)}")
    if q.dtype not in _POOL_DTYPES:
        q = q.float()
    if not q.is_contiguous():
        q = q.contiguous()
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    Q = 1 if q.dim() == 3 else q.shape[1]
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("paged_attention: k_pool and v_pool must both be "
                         f"(slots, bs, KV, D), got {tuple(k_pool.shape)} and "
                         f"{tuple(v_pool.shape)}")
    _, bs, KV, Dp = k_pool.shape
    if Dp != D or H % KV or D > 256:
        raise ValueError(f"paged_attention: q heads/dim {H}/{D} do not fit "
                         f"pool KV heads/dim {KV}/{Dp} (H % KV == 0, "
                         "D <= 256)")
    if k_pool.dtype not in _POOL_DTYPES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"paged_attention: pools must be float32 or "
                         f"bfloat16 of one dtype, got {k_pool.dtype}, "
                         f"{v_pool.dtype}")
    if slots.dtype != torch.int32 or slots.dim() != 2 or slots.shape[0] != B:
        raise ValueError(f"paged_attention: slots must be (B, nblk) int32, "
                         f"got {slots.dtype} {tuple(slots.shape)}")
    if ctx_len.dtype != torch.int32 or tuple(ctx_len.shape) not in (
            (B,), (B, Q)):
        raise ValueError(f"paged_attention: ctx_len must be int32 (B,) or "
                         f"(B, Q), got {ctx_len.dtype} "
                         f"{tuple(ctx_len.shape)}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("slots", slots), ("ctx_len", ctx_len)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if H // KV > 8:
        raise ValueError(f"paged_attention: at most 8 query heads per KV "
                         f"head, got {H // KV}")
    nblk = slots.shape[1]
    kptr, vptr = k_pool.data_ptr(), v_pool.data_ptr()
    vec16 = (D * k_pool.element_size()) % 16 == 0 and not (
        kptr % 16 or vptr % 16)
    # the kernel's tensor cores take bf16 q and pool in whole 16-value rows
    tensor = (q.dtype == k_pool.dtype == torch.bfloat16 and vec16
              and D % 16 == 0)
    qt = query_tile(Q, H // KV, D, tensor)
    o = torch.empty(q.shape, dtype=torch.float32, device=dev)
    m, l = torch.empty((2,) + q.shape[:-1], dtype=torch.float32,
                       device=dev).unbind(0)
    if B and Q and nblk:
        plan = read_plan(nblk, KV, D, H // KV)
        ws = counters = None
        cta_split = 0
        if plan.fold:
            ctas = fold_ctas(plan, Q, D, tensor)
            cta_split = 1 if ctas == 1 else plan.n_split
            if ctas > 1:
                dh = ctas // plan.n_split           # column halves
                G = 1 << max(0, H // KV - 1).bit_length()
                nqt = -(-Q // qt)
                R = qt * G                          # a partial's rows
                ws = torch.empty(B * nqt * KV * ctas
                                 * (R * (_padded_d(D) // dh)
                                    + -(-2 * R // 4) * 4),
                                 dtype=torch.float32, device=dev)
                counters = _fold_counters(dev, B * nqt * KV * dh)
        rc = _lib()(_POOL_DTYPES[k_pool.dtype],
                    int(q.dtype == torch.bfloat16), q.data_ptr(), kptr, vptr,
                    slots.data_ptr(), ctx_len.data_ptr(), o.data_ptr(),
                    m.data_ptr(), l.data_ptr(), B, Q, H, KV, D, bs, nblk,
                    plan.n_split, plan.per_split,
                    bs if block_tokens is None else block_tokens,
                    tok_offset, tok_stride, int(ctx_len.dim() == 2),
                    int(vec16), qt, cta_split,
                    None if ws is None else ws.data_ptr(),
                    None if counters is None else counters.data_ptr(),
                    None if stamps is None else stamps.data_ptr(),
                    _build.stream_handle(q))
        _build.check_launch("paged_attention", rc)
        paged_attention.launches += 1
        if Q > 1:
            paged_attention.launches_multi_query += 1
        if ctx_len.dim() == 2:
            paged_attention.launches_q_per_query += 1
    return o, m, l


def _meta_call(q, k_pool, slots, ctx_len):
    """The kernel's outputs' shapes on the ``meta`` device, and its cost
    as if every row read all of its ``nblk`` blocks (the dry run)."""
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    Q = 1 if q.dim() == 3 else q.shape[1]
    _, bs, KV, _ = k_pool.shape
    tokens = B * slots.shape[1] * bs
    _build.count_meta(
        "paged_attention", 4 * D * H * Q * tokens,
        q.numel() * q.element_size() + 2 * tokens * KV * D
        * k_pool.element_size() + 4 * (slots.numel() + ctx_len.numel())
        + 4 * B * Q * H * (D + 2))
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m, l = torch.empty((2,) + q.shape[:-1], dtype=torch.float32,
                       device=q.device).unbind(0)
    return o, m, l


paged_attention.launches = 0
paged_attention.launches_multi_query = 0
paged_attention.launches_q_per_query = 0
