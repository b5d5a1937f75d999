"""Architecture registry of the port: ``get_config(name)`` resolves here.

The port carries every architecture of the JAX package's registry
(``repro.configs``), in six families: dense (granite-8b, granite-3-8b,
qwen2.5-14b, qwen2-72b), moe (qwen3-moe-30b-a3b, llama4-scout-17b-a16e),
ssm (mamba2-130m), hybrid (jamba-1.5-large-398b), vlm (paligemma-3b) and
audio (whisper-medium).
"""
from .base import (ArchConfig, ResolvedDims, ShapeCell, SHAPES, shape_cell,
                   resolve, reduced, cell_applicable)
from .qwen3_moe_30b_a3b import CONFIG as _qwen3_moe
from .llama4_scout_17b_a16e import CONFIG as _llama4_scout
from .granite_3_8b import CONFIG as _granite3
from .qwen2_5_14b import CONFIG as _qwen25_14b
from .qwen2_72b import CONFIG as _qwen2_72b
from .granite_8b import CONFIG as _granite8b
from .mamba2_130m import CONFIG as _mamba2
from .jamba_1_5_large_398b import CONFIG as _jamba
from .paligemma_3b import CONFIG as _paligemma
from .whisper_medium import CONFIG as _whisper

ARCHS = {c.name: c for c in (
    _qwen3_moe, _llama4_scout, _granite3, _qwen25_14b, _qwen2_72b,
    _granite8b, _mamba2, _jamba, _paligemma, _whisper,
)}


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
