"""Utopia core: hybrid restrictive/flexible KV-block translation."""
from .segments import (HybridConfig, RestSegConfig, FlexSegConfig,
                       pool_slots_for)
from .hashes import HASHES, get_hash, mix32
from .tar_sf import (RestSegState, RSWResult, TranslationState, rsw,
                     probe_rows)
from .policies import SRRIP, CostTracker, CostTrackerConfig
from .kv_manager import (HybridKVManager, BlockInfo, PoolExhausted,
                         AllocLedger, REST, FLEX, SWAP)

__all__ = [
    "HybridConfig", "RestSegConfig", "FlexSegConfig", "pool_slots_for",
    "HASHES", "get_hash", "mix32",
    "RestSegState", "RSWResult", "TranslationState", "rsw", "probe_rows",
    "SRRIP", "CostTracker", "CostTrackerConfig",
    "HybridKVManager", "BlockInfo", "PoolExhausted", "AllocLedger",
    "REST", "FLEX", "SWAP",
]
