"""Serving stack of the port: decode/prefill steps, the engine and its
metrics logger."""
from .decode import (DecodeSpec, StepTranslation, init_decode_state,
                     make_serve_step, translate_step)
from .prefill import make_prefill_step, make_prefix_prefill_step
from .engine import (ChunkRecord, Engine, EngineConfig, EngineSnapshot,
                     Request, RequestOutput, RequestState,
                     SNAPSHOT_VERSION)
from .metrics import (MetricsLogger, MetricsSink, MemorySink, JsonlSink,
                      RollingWindow)
from .sampling import GREEDY, SamplingParams
from .scheduler import (Scheduler, FIFOScheduler, ShortestPromptFirst,
                        PriorityAgingScheduler, make_scheduler, SCHEDULERS)

__all__ = ["DecodeSpec", "StepTranslation", "init_decode_state",
           "make_serve_step", "translate_step", "make_prefill_step",
           "make_prefix_prefill_step",
           "ChunkRecord", "Engine", "EngineConfig", "EngineSnapshot",
           "SNAPSHOT_VERSION", "Request", "RequestOutput", "RequestState",
           "MetricsLogger", "MetricsSink", "MemorySink", "JsonlSink",
           "RollingWindow", "GREEDY", "SamplingParams",
           "Scheduler", "FIFOScheduler", "ShortestPromptFirst",
           "PriorityAgingScheduler", "make_scheduler", "SCHEDULERS"]
