"""Which decode-state tensors shard over the mesh's model axis."""
from .sharding import kv_state_specs

__all__ = ["kv_state_specs"]
