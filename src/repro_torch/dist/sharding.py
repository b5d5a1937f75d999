"""The sharded serving layout of the decode state.

The port of ``repro.dist.sharding.kv_state_specs`` (the rest of that
module, the training shardings, is ROADMAP P16's training part).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

# decode-state tensors sharded over the model axis, and the dimension each
# one shards: the KV pools by physical slot, the TAR/SF tables by set
# index, the flat flex table by vpn range
_SHARDED = {"k_pool": 1, "v_pool": 1, "tar": 1, "sf": 1, "flex": 1}


def kv_state_specs(state: Iterable[str]) -> Dict[str, Optional[int]]:
    """Per decode-state key (``state``: the dict or its keys), the
    dimension it shards over the mesh's model axis, or None where every
    rank holds the whole tensor.

    The sharded serving layout (DESIGN.md §sharded-serving): the KV pool
    is slot-sharded in the shard-contiguous physical numbering of
    ``core.partition.Partition``, the TAR/SF tables are set-index
    partitioned and the flat flex table vpn-range partitioned over the
    same axis; everything else (context lengths, sampling state, ssm/conv
    rows, cross K/V, the drafter's history) is replicated, as all float
    compute is.  A rank's decode state holds its own chunk of each sharded
    tensor.  The engine's state placement, its translation-delta routing
    and its snapshots all read this one table."""
    return {k: _SHARDED.get(k) for k in state}
