"""Wrapper of the rows-invariant RMS-norm kernel (``csrc/rms_norm.cu``).

``rms_norm(x, scale, eps, z=None)``: the norm over the last axis in
float32, returned in x's dtype; with ``z`` Mamba2's gated norm,
``norm(x) * silu(z)`` with silu in XLA's form (``layers.silu``).  One CTA
a row with a fixed reduction order, so a row's bits do not depend on how
many rows the call holds.  The scale is read in its own dtype (float32 or
bfloat16; bf16 to float32 is exact, so either gives the same bits).  A
CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``ref.py``, the port's forward as it is); on ``meta`` tensors
(the dry run) it returns the shape and records the kernel's cost.
``rms_norm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import gated_rms_norm_ref, rms_norm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_launch = []        # the bound C entry points, once loaded


def _lib(two_pass: bool = False):
    if not _launch:
        lib = _build.load("rms_norm")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.rms_norm_launch, lib.rms_norm_two_pass_launch):
            fn.argtypes = [i, i, p, p, p, p, i, i, ctypes.c_float, p]
            fn.restype = ctypes.c_int
            _launch.append(fn)
    return _launch[two_pass]


def rms_norm(x, scale, eps: float = 1e-5, z=None):
    """RMS norm of ``x (..., n)`` with ``scale (n,)``, times ``silu(z)``
    when the gate ``z`` (x's shape and dtype) is given."""
    # (the checks below are written out: this runs twice a layer of every
    # prefill step)
    dev = x.device
    if dev.type == "cpu" and scale.device.type == "cpu" and (
            z is None or z.device.type == "cpu"):
        if z is None:
            return rms_norm_ref(x, scale, eps)
        return gated_rms_norm_ref(x, z, scale, eps)
    n = x.shape[-1]
    if dev.type == "meta":
        _build.count_meta("rms_norm", (4 if z is None else 10) * x.numel(),
                          (2 + (z is not None)) * x.numel()
                          * x.element_size() + 4 * n)
        return torch.empty_like(x)
    if dev.type != "cuda" or scale.device != dev or (
            z is not None and z.device != dev):
        ts = (x, scale) if z is None else (x, scale, z)
        raise ValueError(f"rms_norm: x, scale{', z' if z is not None else ''}"
                         f" must be on one CUDA device (got "
                         f"{[str(t.device) for t in ts]})")
    dt = _DTYPES.get(x.dtype)
    if dt is None or (z is not None and (z.dtype != x.dtype
                                         or z.shape != x.shape)):
        raise ValueError(f"rms_norm: x float32 or bfloat16 and z of x's "
                         f"shape and dtype, got x {x.dtype} "
                         f"{tuple(x.shape)}, z "
                         f"{None if z is None else (z.dtype, tuple(z.shape))}")
    if scale.shape != (n,):
        raise ValueError(f"rms_norm: scale {tuple(scale.shape)} for rows of "
                         f"{n}")
    sdt = _DTYPES.get(scale.dtype)
    if sdt is None:     # another float type: cast as the plain version does
        scale, sdt = scale.float(), 0
    if not scale.is_contiguous():
        scale = scale.contiguous()
    if not x.is_contiguous():
        x = x.contiguous()
    if z is not None and not z.is_contiguous():
        z = z.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // n if n else 0
    if rows:
        rc = _lib()(dt, sdt, x.data_ptr(),
                    0 if z is None else z.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), rows, n, eps,
                    _build.stream_handle(x))
        _build.check_launch("rms_norm", rc)
        rms_norm.launches += 1
    return out


rms_norm.launches = 0


def rms_norm_two_pass(x, scale, eps: float = 1e-5, z=None):
    """The same norm by the kernel's two-pass loop at any width (each row
    read twice): the oracle of the register kernel's order, bitwise.
    CUDA tensors only, contiguous rows; counts no launch."""
    n = x.shape[-1]
    out = torch.empty_like(x)
    rc = _lib(True)(_DTYPES[x.dtype], _DTYPES[scale.dtype], x.data_ptr(),
                    0 if z is None else z.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), x.numel() // n, n, eps,
                    _build.stream_handle(x))
    _build.check_launch("rms_norm_two_pass", rc)
    return out
