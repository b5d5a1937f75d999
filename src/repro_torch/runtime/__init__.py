"""Fault tolerance: the fault injectors, the step watchdog, the resilient
train loop and the serving snapshot/restore supervisor."""
from .fault import (FaultInjector, ServeFaultInjector, InjectedFault,
                    InjectedStepFault, InjectedAllocFault, StragglerMonitor,
                    StepWatchdog, ResilientLoop, LoopReport, restore_like)
from .resilient_serve import ResilientServe, ReplayDivergence

__all__ = ["FaultInjector", "ServeFaultInjector", "InjectedFault",
           "InjectedStepFault", "InjectedAllocFault", "StragglerMonitor",
           "StepWatchdog", "ResilientLoop", "LoopReport", "restore_like",
           "ResilientServe", "ReplayDivergence"]
