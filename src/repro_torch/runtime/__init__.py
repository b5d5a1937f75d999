"""Serving fault tolerance: the fault injector, the step watchdog and the
snapshot/restore supervisor (the serving half of ``repro.runtime``)."""
from .fault import (ServeFaultInjector, InjectedFault, InjectedStepFault,
                    InjectedAllocFault, StragglerMonitor, StepWatchdog)
from .resilient_serve import ResilientServe, ReplayDivergence

__all__ = ["ServeFaultInjector", "InjectedFault", "InjectedStepFault",
           "InjectedAllocFault", "StragglerMonitor", "StepWatchdog",
           "ResilientServe", "ReplayDivergence"]
