"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``models.attention.dense_attention``).
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


_launch = []        # the bound C entry point, once loaded


def _lib():
    if not _launch:
        fn = _build.load("flash_attention").flash_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int   # bare ints would be 32-bit
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _launch.append(fn)
    return _launch[0]


def flash_attention(q, k, v, *, causal: bool = True):
    """Causal (or full) GQA attention, ``q (B, S, H, D)`` against ``k/v
    (B, Skv, KV, D)``, kv head = h // (H // KV).  Returns the normalized
    output ``(B, S, H, D)`` in q's dtype (float32 or bfloat16)."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_ref(q, k, v, causal=causal)
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
    out = torch.empty_like(q)
    if B and S and Skv:
        rc = _lib()(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), B, S, Skv, H, KV, D,
                    int(causal), _build.stream_handle(q))
        _build.check_launch("flash_attention", rc)
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
