"""Utopia core: hybrid restrictive/flexible KV-block translation."""
from .segments import (HybridConfig, RestSegConfig, FlexSegConfig,
                       pool_slots_for)
from .hashes import HASHES, get_hash, mix32
from .tar_sf import (RestSegState, RSWResult, init_restseg, rsw, insert,
                     remove, probe_rows, structure_bytes)
from .flex_table import FlexTable, RadixTable, RadixBuilder, init_flex_table
from .translate import (TranslationState, TranslateResult, translate,
                        translate_radix, translate_ech, translate_pom)
from .policies import SRRIP, CostTracker, CostTrackerConfig
from .kv_manager import (HybridKVManager, BlockInfo, PoolExhausted,
                         AllocLedger, REST, FLEX, SWAP)
from .prefix_cache import (CHAIN_SEED, CacheEntry, PrefixCache,
                           block_hash_chain)
from .ech import ElasticCuckooTable, ECHState
from .pom_tlb import POMTLB, POMTLBState

__all__ = [
    "HybridConfig", "RestSegConfig", "FlexSegConfig", "pool_slots_for",
    "HASHES", "get_hash", "mix32",
    "RestSegState", "RSWResult", "init_restseg", "rsw", "insert", "remove",
    "probe_rows", "structure_bytes",
    "FlexTable", "RadixTable", "RadixBuilder", "init_flex_table",
    "TranslationState", "TranslateResult", "translate",
    "translate_radix", "translate_ech", "translate_pom",
    "SRRIP", "CostTracker", "CostTrackerConfig",
    "HybridKVManager", "BlockInfo", "PoolExhausted", "AllocLedger",
    "REST", "FLEX", "SWAP",
    "CHAIN_SEED", "CacheEntry", "PrefixCache", "block_hash_chain",
    "ElasticCuckooTable", "ECHState", "POMTLB", "POMTLBState",
]
