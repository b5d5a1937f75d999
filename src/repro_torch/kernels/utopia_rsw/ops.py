"""Wrappers of the RSW kernels (``csrc/utopia_rsw.cu``).

``translate_step_translator`` binds the decode step's whole translation
(one launch per step) to a geometry; ``utopia_rsw`` walks a list of vpns.
A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version in ``ref.py``.  ``utopia_translate_step.launches`` and
``utopia_rsw.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import (HASH_IDS, StepTranslation, hash_param, rsw_ref,
                  step_words, translate_step_ref, vpn_grid)

_P, _I = ctypes.c_void_p, ctypes.c_int       # bare ints would be 32-bit
_bound = {}                                  # entry name -> C function


def _entry(name: str, argtypes):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.load("utopia_rsw"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


class _StepParams(ctypes.Structure):
    """``StepParams`` of the C source: the step's fixed arguments."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "n_sets", "assoc", "flex_len", "hash_id", "p", "batch", "nblk",
        "block_size", "sink", "window")]


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(
            f"translate_step: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def translate_step_translator(tar: torch.Tensor, sf: torch.Tensor,
                              flex: torch.Tensor, ctx_len: torch.Tensor, *,
                              block_size: int, nblk: int, hash_name: str,
                              sink: int, window: int = 1):
    """Bind the decode step's translation to the geometry of these tables:
    tar ``(1, n_sets, assoc)``, sf ``(1, n_sets)``, flex ``(1, B * nblk)``,
    all int32, and ``ctx_len (B,)`` int32, on one device, and to the
    ``window`` of positions each row writes (1 for a decode step, K + 1
    for a speculative verify step).

    Validates shapes, dtypes and the device once, here, and returns
    ``translate(tar, sf, flex, ctx_len, active=None) -> StepTranslation``,
    which checks nothing: on a card it passes four pointers, the optional
    ``active (B,)`` bool mask, one output buffer and the stream to ONE
    launch; on the CPU it runs ``translate_step_ref``."""
    dev = ctx_len.device
    B = ctx_len.shape[0]
    if tar.dim() != 3 or tar.shape[0] != 1:
        raise ValueError(f"translate_step: tar must be (1, n_sets, assoc), "
                         f"got {tuple(tar.shape)}")
    _, n_sets, assoc = tar.shape
    for name, t, shape in (("tar", tar, (1, n_sets, assoc)),
                           ("sf", sf, (1, n_sets)),
                           ("flex", flex, (1, B * nblk)),
                           ("ctx_len", ctx_len, (B,))):
        _check(name, t, shape, torch.int32, dev)
    if hash_name not in HASH_IDS:
        raise KeyError(f"unknown hash {hash_name!r}")
    if window < 1:
        raise ValueError(f"translate_step: window must be >= 1, got "
                         f"{window}")
    geom = dict(block_size=block_size, nblk=nblk, hash_name=hash_name,
                sink=sink, window=window)
    if dev.type == "cpu":
        return lambda tar, sf, flex, ctx_len, active=None: (
            translate_step_ref(tar, sf, flex, ctx_len, active, **geom))
    if dev.type != "cuda":
        raise ValueError(f"translate_step: no kernel for device {dev}")
    fn = _entry("utopia_translate_step_launch", [_P] * 6 + [_P, _P])
    prm = _StepParams(n_sets, assoc, B * nblk, HASH_IDS[hash_name],
                      hash_param(hash_name, n_sets), B, nblk, block_size,
                      sink, window)
    prm_ptr = ctypes.addressof(prm)
    words = step_words(B, nblk, window)
    grid = vpn_grid(B, nblk, dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream
    empty, i32 = torch.empty, torch.int32

    def translate(tar, sf, flex, ctx_len, active=None):
        out = empty(words, dtype=i32, device=dev)
        rc = fn(tar.data_ptr(), sf.data_ptr(), flex.data_ptr(),
                ctx_len.data_ptr(), None if active is None
                else active.data_ptr(), out.data_ptr(), prm_ptr,
                stream(index))
        if rc:
            _build.check_launch("utopia_translate_step", rc)
        utopia_translate_step.launches += 1
        return StepTranslation(out, grid, window)

    translate.params = prm                   # keeps the struct alive
    return translate


def utopia_translate_step(tar, sf, flex, ctx_len, active=None, *,
                          block_size: int, nblk: int, hash_name: str,
                          sink: int, window: int = 1):
    """One call of the decode step's translation (binds, then launches).
    The decode step binds once and calls the bound function instead."""
    return translate_step_translator(
        tar, sf, flex, ctx_len, block_size=block_size, nblk=nblk,
        hash_name=hash_name, sink=sink, window=window)(tar, sf, flex,
                                                       ctx_len, active)


utopia_translate_step.launches = 0


def utopia_rsw(vpns: torch.Tensor, tar: torch.Tensor, sf: torch.Tensor,
               flex_flat: torch.Tensor, *, hash_name: str = "modulo",
               max_blocks_per_seq: int = 0):
    """Hybrid translate vpns (N,) int32 against the TAR (n_sets, assoc),
    SF (n_sets,) and flat flex table (V,), all int32.

    Returns ``(slot, in_rest, mapped, accesses)``, int32 (N,) each, with
    ``slot == -1`` for an unmapped vpn.  A miss reads the flex table as
    JAX indexes it: with ``max_blocks_per_seq`` 0 as a flat table (a
    negative vpn counts from the end once, then the index clamps into
    ``[0, V)``), else as the ``(V / max_blocks_per_seq,
    max_blocks_per_seq)`` table that ``core.translate`` reads
    (``FlexTable.lookup_vpn``)."""
    tensors = (vpns, tar, sf, flex_flat)
    if all(t.device.type == "cpu" for t in tensors):
        return rsw_ref(vpns, tar, sf, flex_flat, hash_name=hash_name,
                       max_blocks_per_seq=max_blocks_per_seq)
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
    if max_blocks_per_seq < 0 or (
            max_blocks_per_seq and flex_flat.numel() % max_blocks_per_seq):
        raise ValueError(f"utopia_rsw: max_blocks_per_seq "
                         f"{max_blocks_per_seq} does not divide the flex "
                         f"table's {flex_flat.numel()} entries")
    n = vpns.numel()
    out = torch.empty((4, n), dtype=torch.int32, device=dev)
    if n:
        fn = _entry("utopia_rsw_launch", [_P] * 4 + [_I] * 7 + [_P] * 5)
        rc = fn(vpns.data_ptr(), tar.data_ptr(), sf.data_ptr(),
                flex_flat.data_ptr(), n, n_sets, assoc, flex_flat.numel(),
                HASH_IDS[hash_name], hash_param(hash_name, n_sets),
                max_blocks_per_seq, *(
                    out.data_ptr() + 4 * n * k for k in range(4)),
                _build.stream_handle(vpns))
        _build.check_launch("utopia_rsw", rc)
        utopia_rsw.launches += 1
    return out[0], out[1], out[2], out[3]


utopia_rsw.launches = 0


def empty_launch(t: torch.Tensor) -> None:
    """Launch the library's empty kernel on ``t``'s card: the latency
    floor the step entry is measured against (not on any serving path)."""
    _build.check_launch("utopia_empty", _entry("utopia_empty_launch", [_P])(
        _build.stream_handle(t)))
