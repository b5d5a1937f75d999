"""Set-index hash functions for the RestSeg (paper §8.3.8, Fig. 30).

All functions are polymorphic over numpy int32 arrays, torch int32
tensors and Python ints: only ``%``, ``^``, ``>>``, ``*``, ``+`` are used so
the same code drives the host-side allocator and the plain torch RSW.
The CUDA RSW kernel (``kernels/utopia_rsw/csrc``) carries a C++ copy of
each function; the tests hold it to this module.  Inputs are virtual
block numbers (vpns); output is a set index in ``[0, n_sets)``.
"""
from __future__ import annotations

_MIX = 73244475      # int32-safe mixing prime (0x045D9F3B)


def mix32(x):
    """int32 wrap-around mixer, identical semantics on python ints, numpy
    int32 arrays and torch int32 tensors (callers must pass int32-typed
    arrays or masked python ints)."""
    import numpy as _np
    with _np.errstate(over="ignore"):   # int32 wrap is intended
        x = (x * _MIX) & 0x7FFFFFFF
        x = x ^ (x >> 15)
        x = (x * _MIX) & 0x7FFFFFFF
        return x ^ (x >> 13)


def modulo_hash(vpn, n_sets: int):
    """Paper's chosen function: best performance/complexity trade-off."""
    return vpn % n_sets


def xor_fold_hash(vpn, n_sets: int):
    """XOR-based hashing [Cho et al.]: fold upper bits into the index."""
    set_bits = max(1, (n_sets - 1).bit_length())
    folded = vpn ^ (vpn >> set_bits) ^ (vpn >> (2 * set_bits))
    return folded % n_sets


def prime_displacement_hash(vpn, n_sets: int):
    """Prime-displacement [Kharbutli et al.]: idx = (tag * p + idx0) mod sets."""
    set_bits = max(1, (n_sets - 1).bit_length())
    tag = vpn >> set_bits
    idx0 = vpn % n_sets
    return (tag * 17 + idx0) % n_sets


def mersenne_hash(vpn, n_sets: int):
    """Mersenne-modulo [Yang & Yang]: reduce mod (2^k - 1) first."""
    k = max(2, (n_sets - 1).bit_length())
    m = (1 << k) - 1
    x = vpn
    # two folding rounds bring any 32-bit value below 2^(k+1)
    x = (x & m) + (x >> k)
    x = (x & m) + (x >> k)
    return x % n_sets


def multiplicative_hash(vpn, n_sets: int):
    """Beyond-paper: multiplicative scramble."""
    return mix32(vpn) % n_sets


HASHES = {
    "modulo": modulo_hash,
    "xor_fold": xor_fold_hash,
    "prime_displacement": prime_displacement_hash,
    "mersenne": mersenne_hash,
    "multiplicative": multiplicative_hash,
}


def get_hash(name: str):
    try:
        return HASHES[name]
    except KeyError:
        raise KeyError(f"unknown hash {name!r}; options: {sorted(HASHES)}")
