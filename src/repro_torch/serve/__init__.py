"""Serving stack of the port: decode/prefill steps and the engine."""
from .decode import (DecodeSpec, StepTranslation, init_decode_state,
                     make_serve_step, translate_step)
from .prefill import make_prefill_step, make_prefix_prefill_step
from .engine import (ChunkRecord, Engine, EngineConfig, Request,
                     RequestOutput, RequestState)
from .sampling import GREEDY, SamplingParams
from .scheduler import (Scheduler, FIFOScheduler, ShortestPromptFirst,
                        PriorityAgingScheduler, make_scheduler, SCHEDULERS)

__all__ = ["DecodeSpec", "StepTranslation", "init_decode_state",
           "make_serve_step", "translate_step", "make_prefill_step",
           "make_prefix_prefill_step",
           "ChunkRecord", "Engine", "EngineConfig", "Request",
           "RequestOutput", "RequestState", "GREEDY", "SamplingParams",
           "Scheduler", "FIFOScheduler", "ShortestPromptFirst",
           "PriorityAgingScheduler", "make_scheduler", "SCHEDULERS"]
