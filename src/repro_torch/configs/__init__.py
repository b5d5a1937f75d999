"""Architecture registry of the port: ``get_config(name)`` resolves here.

The port carries the architectures it can serve; the JAX package's
registry (``repro.configs``) lists the rest, which arrive with their
families (ROADMAP P10).
"""
from .base import (ArchConfig, ResolvedDims, ShapeCell, SHAPES, shape_cell,
                   resolve, reduced, cell_applicable)
from .granite_8b import CONFIG as _granite8b

ARCHS = {c.name: c for c in (_granite8b,)}


def get_config(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")


def list_archs():
    return sorted(ARCHS)


__all__ = ["ArchConfig", "ResolvedDims", "ShapeCell", "SHAPES", "shape_cell",
           "resolve", "reduced", "cell_applicable", "ARCHS", "get_config",
           "list_archs"]
