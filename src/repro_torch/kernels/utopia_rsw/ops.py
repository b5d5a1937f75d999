"""Wrapper of the RSW kernel (``csrc/utopia_rsw.cu``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version in ``ref.py``.  ``utopia_rsw.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import rsw_ref

HASH_IDS = {"modulo": 0, "xor_fold": 1, "prime_displacement": 2,
            "mersenne": 3, "multiplicative": 4}


def _hash_param(hash_name: str, n_sets: int) -> int:
    """The shift the C++ hash needs (set bits, or the Mersenne k)."""
    if hash_name == "mersenne":
        k = max(2, (n_sets - 1).bit_length())
        if k > 30:
            raise ValueError(f"mersenne hash needs n_sets < 2^30, got "
                             f"{n_sets}")
        return k
    return max(1, (n_sets - 1).bit_length())


_launch = []        # the bound C entry point, once loaded


def _lib():
    if not _launch:
        fn = _build.load("utopia_rsw").utopia_rsw_launch
        p, i = ctypes.c_void_p, ctypes.c_int   # bare ints would be 32-bit
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _launch.append(fn)
    return _launch[0]


def utopia_rsw(vpns: torch.Tensor, tar: torch.Tensor, sf: torch.Tensor,
               flex_flat: torch.Tensor, *, hash_name: str = "modulo"):
    """Hybrid translate vpns (N,) int32 against the TAR (n_sets, assoc),
    SF (n_sets,) and flat flex table (V,), all int32.

    Returns ``(slot, in_rest, mapped, accesses)``, int32 (N,) each, with
    ``slot == -1`` for an unmapped vpn.  A miss reads the flex table as
    JAX indexes it: a negative vpn counts from the end once, then the index
    clamps into ``[0, V)``."""
    tensors = (vpns, tar, sf, flex_flat)
    if all(t.device.type == "cpu" for t in tensors):
        return rsw_ref(vpns, tar, sf, flex_flat, hash_name=hash_name)
    dev = vpns.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("utopia_rsw: all inputs must be on one CUDA device "
                         f"(got {[str(t.device) for t in tensors]})")
    for name, t, nd in (("vpns", vpns, 1), ("tar", tar, 2), ("sf", sf, 1),
                        ("flex_flat", flex_flat, 1)):
        if t.dtype != torch.int32 or t.dim() != nd or not t.is_contiguous():
            raise ValueError(f"utopia_rsw: {name} must be a contiguous "
                             f"{nd}-D int32 tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    n_sets, assoc = tar.shape
    if sf.shape != (n_sets,):
        raise ValueError(f"utopia_rsw: sf shape {tuple(sf.shape)} != "
                         f"({n_sets},)")
    if hash_name not in HASH_IDS:
        raise KeyError(f"unknown hash {hash_name!r}")
    n = vpns.numel()
    out = torch.empty((4, n), dtype=torch.int32, device=dev)
    if n:
        rc = _lib()(vpns.data_ptr(), tar.data_ptr(), sf.data_ptr(),
                    flex_flat.data_ptr(), n, n_sets, assoc,
                    flex_flat.numel(), HASH_IDS[hash_name],
                    _hash_param(hash_name, n_sets), *(
                        out.data_ptr() + 4 * n * k for k in range(4)),
                    _build.stream_handle(vpns))
        _build.check_launch("utopia_rsw", rc)
        utopia_rsw.launches += 1
    return out[0], out[1], out[2], out[3]


utopia_rsw.launches = 0
