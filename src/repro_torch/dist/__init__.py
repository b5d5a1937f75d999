"""Distribution layer: which decode-state tensors shard over the mesh's
model axis, and int8 + error-feedback gradient compression."""
from . import compression
from .sharding import kv_state_specs

__all__ = ["compression", "kv_state_specs"]
