"""Wrapper of the paged-attention kernel (``csrc/paged_attention.cu``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version in ``ref.py``.  ``paged_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import paged_attention_ref

_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:          # ctypes passes bare ints as 32-bit
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 11 + [i] * 11 + [p]
        fn.restype = ctypes.c_int
        lib.paged_attention_splits.argtypes = [i]
        lib.paged_attention_splits.restype = i
    return fn, lib.paged_attention_splits


def paged_attention(q, k_pool, v_pool, slots, ctx_len, *,
                    tok_offset: int = 0, tok_stride: int = 1,
                    block_tokens: int | None = None):
    """Online-softmax attention of each row's queries over its pool blocks.

    ``q (B, H, D)`` or ``(B, Q, H, D)``; ``k_pool``/``v_pool (slots, bs,
    KV, D)`` float32 or bfloat16; ``slots (B, nblk)`` int32 (-1 = hole);
    ``ctx_len (B,)`` or ``(B, Q)`` int32.  Returns the unnormalized
    ``(o (B[, Q], H, D), m (B[, Q], H), l (B[, Q], H))``, all float32."""
    tensors = (q, k_pool, v_pool, slots, ctx_len)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_attention_ref(q, k_pool, v_pool, slots, ctx_len,
                                   tok_offset=tok_offset,
                                   tok_stride=tok_stride,
                                   block_tokens=block_tokens)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("paged_attention: all inputs must be on one CUDA "
                         f"device (got {[str(t.device) for t in tensors]})")
    squeeze = q.dim() == 3
    qf = (q[:, None] if squeeze else q).float().contiguous()
    if qf.dim() != 4:
        raise ValueError(f"paged_attention: q must be (B,H,D) or (B,Q,H,D), "
                         f"got {tuple(q.shape)}")
    B, Q, H, D = qf.shape
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
    f32 = dict(dtype=torch.float32, device=dev)
    o = torch.empty((B, Q, H, D), **f32)
    m = torch.empty((B, Q, H), **f32)
    l = torch.empty((B, Q, H), **f32)
    if B and Q and nblk:
        launch, splits = _lib()
        n_split = splits(nblk)
        # flash-decoding partials o (n_split, B, Q, H, D), then m and l
        # (n_split, B, Q, H), in one scratch buffer; merged by the
        # kernel's second pass (none when n_split == 1)
        rows = n_split * B * Q * H if n_split > 1 else 0
        part = torch.empty((rows * (D + 2),), **f32)
        p_o = part.data_ptr()
        p_m, p_l = p_o + 4 * rows * D, p_o + 4 * rows * (D + 1)
        rc = launch(_POOL_DTYPES[k_pool.dtype], qf.data_ptr(),
                    k_pool.data_ptr(), v_pool.data_ptr(), slots.data_ptr(),
                    ctx_len.data_ptr(), o.data_ptr(), m.data_ptr(),
                    l.data_ptr(), p_o, p_m, p_l, B, Q, H, KV, D,
                    bs, nblk, bs if block_tokens is None else block_tokens,
                    tok_offset, tok_stride, int(ctx_len.dim() == 2),
                    _build.stream_handle(q))
        _build.check_launch("paged_attention", rc)
        paged_attention.launches += 1
    if squeeze:
        return o[:, 0], m[:, 0], l[:, 0]
    return o, m, l


paged_attention.launches = 0
