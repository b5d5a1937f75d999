"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``models.attention.dense_attention``).
``flash_attention.launches`` counts kernel launches,
``flash_attention.launches_q_offset`` those with a per-row ``q_offset``.
``flash_plan`` is the bf16 launch's plan: query rows a CTA and grid.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from .ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


# the H100's streaming multiprocessors: the D = 128 kernel's persistent
# grid holds one CTA on each
SMS = 132


class FlashPlan(NamedTuple):
    rows: int      # query rows a CTA: 64 (one warpgroup) or 128 (two)
    ctas: int      # the grid


def flash_plan(B: int, Sq: int, H: int, D: int) -> FlashPlan:
    """The bf16 launch's plan, by (B, Sq, H, D) alone.  D = 128 takes the
    ping-pong kernel's 128 query rows a CTA (two consumer warpgroups) on a
    persistent grid of at most ``SMS`` CTAs when its 128-row tiles are at
    least ``SMS``; with fewer, which would leave SMs idle (the engine's
    short buckets, a prompt's first chunk at B = 1), the TMA kernel's 64
    rows, two CTAs an SM.  Every other head dim takes the TMA kernel's 64,
    so that B * H * ceil(Sq / 64) CTAs spread over the 132 SMs
    (paligemma-3b's and whisper-medium's prefill shapes make 64 CTAs at
    128 rows).  The launch picks its kernel, K/V stages and CTAs an SM by
    (padded D, rows)."""
    tiles = B * H * -(-Sq // 128)
    if D == 128 and tiles >= SMS:
        return FlashPlan(128, SMS)
    return FlashPlan(64, B * H * -(-Sq // 64))


_launch = []        # the bound C entry point, once loaded


def _lib():
    if not _launch:
        fn = _build.load("flash_attention").flash_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int   # bare ints would be 32-bit
        fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _launch.append(fn)
    return _launch[0]


def flash_attention(q, k, v, *, causal: bool = True, q_offset=None,
                    plan: FlashPlan | None = None):
    """Causal (or full) GQA attention, ``q (B, S, H, D)`` against ``k/v
    (B, Skv, KV, D)``, kv head = h // (H // KV).  Returns the normalized
    output ``(B, S, H, D)`` in q's dtype (float32 or bfloat16).

    ``q_offset`` (B,) int, causal only: row b's queries sit at positions
    ``q_offset[b] + i`` of the causal mask (keys at 0 .. Skv - 1), as
    ``dense_attention``'s per-row offset; a query's bits then do not
    depend on its offset, on S or on the keys past it.

    On the card, bf16 runs the ``flash_plan``'s kernel, TMA-fed at every
    head dim: at D = 128 two ping-pong consumer warpgroups a CTA (one when
    128-row tiles would not fill the card), at every other head dim one
    64-row warpgroup a CTA; float32 an FFMA kernel.  ``plan`` (bf16 only)
    launches another ``FlashPlan`` than ``flash_plan``'s, each the same
    bits (``chip_smoke.py --flash`` times the D = 128 designs so)."""
    ts = (q, k, v) if q_offset is None else (q, k, v, q_offset)
    if all(t.device.type == "cpu" for t in ts):
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    dev = q.device
    if dev.type == "meta":
        # the dry run: the output's shape, and the kernel's cost
        B, S, H, D = q.shape
        Skv = k.shape[1]
        pairs = S * Skv // 2 if causal else S * Skv
        _build.count_meta("flash_attention", 4 * B * H * D * pairs,
                          (2 * q.numel() + k.numel() + v.numel())
                          * q.element_size())
        return torch.empty_like(q)
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention: q, k, v must be on one CUDA "
                         f"device (got {q.device}, {k.device}, {v.device})")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: expected q (B,S,H,D) and k/v "
                         f"(B,S,KV,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    Bk, Skv, KV, Dk = k.shape
    if Bk != B or Dk != D or H % KV or D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)} / "
                         f"{tuple(k.shape)} unsupported (H % KV == 0, D in "
                         f"{HEAD_DIMS})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must start on a 16-byte "
                         "boundary (the kernel loads 16 bytes at a time)")
    if q_offset is not None:
        if not causal or q_offset.device != dev or tuple(
                q_offset.shape) != (B,):
            raise ValueError(f"flash_attention: q_offset must be a ({B},) "
                             f"tensor on {dev} of a causal call, got "
                             f"{tuple(q_offset.shape)} on {q_offset.device}"
                             f" (causal={causal})")
        q_offset = q_offset.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B and S and Skv:
        rows, ctas = ((plan or flash_plan(B, S, H, D))
                      if q.dtype == torch.bfloat16 else (0, 0))
        rc = _lib()(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(),
                    0 if q_offset is None else q_offset.data_ptr(), B, S,
                    Skv, H, KV, D, int(causal), rows, ctas,
                    _build.stream_handle(q))
        _build.check_launch("flash_attention", rc)
        flash_attention.launches += 1
        flash_attention.launches_q_offset += q_offset is not None
    return out


flash_attention.launches = 0
flash_attention.launches_q_offset = 0
