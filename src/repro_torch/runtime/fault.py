"""Fault injection and step-time monitoring for the serving engine.

The serving half of ``repro.runtime.fault``, copied (the port imports
nothing of the JAX package).  The training loop's ``FaultInjector`` and
``ResilientLoop`` are not ported yet (ROADMAP P16).

* ``ServeFaultInjector`` — chaos schedule for the serving engine: forced
                           allocation denials, preemptions and crashes at
                           the step's safe points.
* ``StragglerMonitor``   — per-host EMA of step times; hosts slower than
                           ``threshold`` x median are flagged.
* ``StepWatchdog``       — the serving loop's hung-step detector, built on
                           a one-host ``StragglerMonitor``.

The faults share one vocabulary, the ``InjectedFault`` taxonomy below: a
*step* fault kills a whole unit of work in flight (recovery restores a
snapshot and replays), an *alloc* fault denies a resource (the engine
degrades by preempting a victim to its host KV tier; it never unwinds a
dispatch).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


class InjectedFault(RuntimeError):
    """Base of the fault taxonomy.

    * :class:`InjectedStepFault`  — a step died mid-flight; the recovery
      unit is restore-and-replay (``runtime/resilient_serve.py``).
    * :class:`InjectedAllocFault` — a resource allocation was denied; the
      engine consults :class:`ServeFaultInjector` as a capacity check and
      preempts instead of catching an exception (the class exists so tests
      and logs can name the failure mode).
    """
    kind = "generic"


class InjectedStepFault(InjectedFault):
    kind = "step"


class InjectedAllocFault(InjectedFault):
    kind = "alloc"


class ServeFaultInjector:
    """Chaos schedule for the serving engine.

    The engine CONSULTS this injector instead of catching exceptions: an
    allocation denial is a normal capacity-check outcome the engine
    degrades through (preempt a victim to the host KV tier), never an
    unwound dispatch.

    * ``alloc_fail_at``: iterable of ``(step, point)`` — make ONE
      capacity check at that engine step report failure.  Points:
      ``"admit"`` (a prompt chunk's block reservation), ``"decode"`` (a
      decode boundary block), ``"resume"`` (a host-tier restore's
      capacity gate).
    * ``preempt_at``: iterable of ``(step, phase, target)`` — force a
      preemption at one of the step's two safe points: phase ``"pre"``
      (before admission: a mid-chunk-prefill victim is torn out between
      its chunks) or ``"post"`` (after the commit).  ``target`` is a
      seq_id or ``"auto"`` (the engine's victim policy picks).  Each
      entry fires once.
    * ``crash_at``: iterable of ``(step, phase)`` — the ONE schedule that
      raises: an :class:`InjectedStepFault` at the named step boundary
      (``"pre"``: before the step mutated anything; ``"post"``: after its
      full commit).  It simulates the process dying; recovery is
      restore-from-snapshot (``runtime/resilient_serve.py``).  Each entry
      fires once.
    * ``seed`` + ``alloc_fail_rate``/``preempt_rate``: random chaos from a
      seeded ``np.random.RandomState``, so a (seed, workload) run is
      exactly reproducible.

    ``log`` records every fired event as a tuple (``("alloc", step,
    point)`` / ``("preempt", step, phase, target)`` / ``("crash", step,
    phase)``); ``faults()`` counts them by taxonomy kind.
    """

    def __init__(self, alloc_fail_at=(), preempt_at=(), crash_at=(),
                 seed: Optional[int] = None,
                 alloc_fail_rate: float = 0.0,
                 preempt_rate: float = 0.0):
        self._alloc = {(int(s), str(p)) for s, p in alloc_fail_at}
        self._forced: Dict[Tuple[int, str], List] = defaultdict(list)
        for step, phase, target in preempt_at:
            if phase not in ("pre", "post"):
                raise ValueError(f"unknown preempt phase {phase!r} "
                                 "(expected 'pre' or 'post')")
            self._forced[(int(step), str(phase))].append(target)
        self._crash = set()
        for step, phase in crash_at:
            if phase not in ("pre", "post"):
                raise ValueError(f"unknown crash phase {phase!r} "
                                 "(expected 'pre' or 'post')")
            self._crash.add((int(step), str(phase)))
        self._rng = (np.random.RandomState(seed)
                     if seed is not None else None)
        self.alloc_fail_rate = float(alloc_fail_rate)
        self.preempt_rate = float(preempt_rate)
        self.log: List[tuple] = []

    def alloc_unavailable(self, step: int, point: str) -> bool:
        """Should this capacity check be forced to fail?"""
        key = (int(step), str(point))
        if key in self._alloc:
            self._alloc.discard(key)
            self.log.append(("alloc", key[0], key[1]))
            return True
        if (self._rng is not None and self.alloc_fail_rate > 0
                and self._rng.random_sample() < self.alloc_fail_rate):
            self.log.append(("alloc", int(step), str(point)))
            return True
        return False

    def forced_preempts(self, step: int, phase: str) -> List:
        """Sequences to forcibly preempt at this (step, phase)."""
        out = list(self._forced.pop((int(step), str(phase)), ()))
        if (self._rng is not None and self.preempt_rate > 0
                and self._rng.random_sample() < self.preempt_rate):
            out.append("auto")
        for t in out:
            self.log.append(("preempt", int(step), str(phase), t))
        return out

    def maybe_crash(self, step: int, phase: str) -> None:
        """Raise :class:`InjectedStepFault` if a crash is scheduled at
        this step boundary (fires once; the event is logged FIRST so a
        post-mortem sees the crash that killed the run)."""
        key = (int(step), str(phase))
        if key in self._crash:
            self._crash.discard(key)
            self.log.append(("crash", key[0], key[1]))
            raise InjectedStepFault(
                f"injected serve crash at step {key[0]} ({key[1]})")

    def faults(self) -> Dict[str, int]:
        """Fired-event counts keyed by taxonomy kind."""
        out: Dict[str, int] = {InjectedAllocFault.kind: 0, "preempt": 0,
                               InjectedStepFault.kind: 0}
        for ev in self.log:
            out[{"alloc": InjectedAllocFault.kind,
                 "crash": InjectedStepFault.kind}.get(ev[0],
                                                      "preempt")] += 1
        return out


class StragglerMonitor:
    """Per-host EMA of step times; hosts slower than ``threshold`` x the
    median are flagged."""

    def __init__(self, n_hosts: int, alpha: float = 0.3,
                 threshold: float = 1.5):
        self.ema = np.zeros(n_hosts)
        self.alpha = alpha
        self.threshold = threshold
        self.seen = np.zeros(n_hosts, bool)

    def record(self, host: int, step_time: float) -> None:
        if not self.seen[host]:
            self.ema[host] = step_time
            self.seen[host] = True
        else:
            self.ema[host] = (1 - self.alpha) * self.ema[host] \
                + self.alpha * step_time

    def stragglers(self) -> List[int]:
        if not self.seen.any():
            return []
        med = float(np.median(self.ema[self.seen]))
        if med <= 0:
            return []
        return [int(h) for h in np.nonzero(
            self.seen & (self.ema > self.threshold * med))[0]]


class StepWatchdog:
    """Hung-step detector for the serving loop, built on
    :class:`StragglerMonitor`.

    A single serving process has no peer hosts to compare against, so the
    watchdog treats the engine's OWN smoothed step time as the
    population: each step is recorded into a one-host monitor's EMA and
    flagged when it exceeds ``threshold`` x the EMA of the steps before
    it.  ``warmup`` steps are exempt (the first steps build kernels and
    would always flag).
    """

    def __init__(self, threshold: float = 10.0, alpha: float = 0.3,
                 warmup: int = 3):
        self._mon = StragglerMonitor(1, alpha=alpha, threshold=threshold)
        self.threshold = threshold
        self.warmup = warmup
        self.seen = 0
        self.flags: List[Tuple[int, float]] = []   # (step index, wall s)

    def record(self, step_time: float) -> bool:
        """Feed one step's wall time; True when it flagged as hung
        (recorded AFTER the check so the hung step does not drag the
        baseline up before judging itself)."""
        self.seen += 1
        hung = (self.seen > self.warmup and self._mon.seen[0]
                and step_time > self.threshold * float(self._mon.ema[0]))
        if hung:
            self.flags.append((self.seen, float(step_time)))
        self._mon.record(0, step_time)
        return bool(hung)
