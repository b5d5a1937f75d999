"""Wrapper of the rows-invariant RMS-norm kernel (``csrc/rms_norm.cu``).

``rms_norm(x, scale, eps, z=None)``: the norm over the last axis in
float32, returned in x's dtype; with ``z`` Mamba2's gated norm,
``norm(x) * silu(z)`` with silu in XLA's form (``layers.silu``).  One CTA
a row with a fixed reduction order, so a row's bits do not depend on how
many rows the call holds.  A CUDA tensor launches the kernel or raises; a
CPU tensor takes the plain version (``ref.py``, the port's forward as
it is); on ``meta`` tensors (the dry run) it returns the shape and
records the kernel's cost.  ``rms_norm.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import gated_rms_norm_ref, rms_norm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_launch = []        # the bound C entry point, once loaded


def _lib():
    if not _launch:
        fn = _build.load("rms_norm").rms_norm_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _launch.append(fn)
    return _launch[0]


def rms_norm(x, scale, eps: float = 1e-5, z=None):
    """RMS norm of ``x (..., n)`` with ``scale (n,)``, times ``silu(z)``
    when the gate ``z`` (x's shape and dtype) is given."""
    ts = (x, scale) if z is None else (x, scale, z)
    if all(t.device.type == "cpu" for t in ts):
        if z is None:
            return rms_norm_ref(x, scale, eps)
        return gated_rms_norm_ref(x, z, scale, eps)
    dev = x.device
    n = x.shape[-1]
    if dev.type == "meta":
        _build.count_meta("rms_norm", (4 if z is None else 10) * x.numel(),
                          (2 + (z is not None)) * x.numel()
                          * x.element_size() + 4 * n)
        return torch.empty_like(x)
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"rms_norm: x, scale{', z' if z is not None else ''}"
                         f" must be on one CUDA device (got "
                         f"{[str(t.device) for t in ts]})")
    if x.dtype not in _DTYPES or (z is not None and (
            z.dtype != x.dtype or z.shape != x.shape)):
        raise ValueError(f"rms_norm: x float32 or bfloat16 and z of x's "
                         f"shape and dtype, got x {x.dtype} "
                         f"{tuple(x.shape)}, z "
                         f"{None if z is None else (z.dtype, tuple(z.shape))}")
    if tuple(scale.shape) != (n,):
        raise ValueError(f"rms_norm: scale {tuple(scale.shape)} for rows of "
                         f"{n}")
    xc = x.contiguous()
    zc = None if z is None else z.contiguous()
    s32 = scale.float().contiguous()
    out = torch.empty_like(xc)
    rows = math.prod(x.shape[:-1])
    if rows:
        rc = _lib()(_DTYPES[x.dtype], xc.data_ptr(),
                    0 if zc is None else zc.data_ptr(), s32.data_ptr(),
                    out.data_ptr(), rows, n, float(eps),
                    _build.stream_handle(x))
        _build.check_launch("rms_norm", rc)
        rms_norm.launches += 1
    return out


rms_norm.launches = 0
