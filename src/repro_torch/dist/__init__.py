"""Distribution layer: sharding rules, pipeline/tensor parallelism,
gradient compression.

* ``sharding``    — logical parameter sharding rules, the blocks each
                    rank holds, and the sharded serving layout,
* ``pipeline``    — GPipe schedule (reference + one stage a rank),
* ``megatron``    — hand-scheduled tensor-parallel forward (explicit
                    collectives; the single-device forward is the oracle),
* ``compression`` — int8 + error-feedback gradient compression for the
                    cross-pod data-parallel hop.

The JAX package's ``make_pins`` is not ported (``sharding``'s docstring).
"""
from . import compression
from .sharding import (ShardingRules, param_shardings, batch_spec,
                       kv_state_specs)
from .pipeline import gpipe_reference, gpipe_spmd, bubble_fraction

__all__ = [
    "compression",
    "ShardingRules", "param_shardings", "batch_spec",
    "kv_state_specs",
    "gpipe_reference", "gpipe_spmd", "bubble_fraction",
]
