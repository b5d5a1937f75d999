"""Pluggable admission schedulers: the Scheduler protocol + 3 policies.

The engine's admission loop (``serve/engine.py::Engine._admit``) is
policy-free: it asks its scheduler WHICH waiting request to prefill next
and keeps budgets / chunking / slot registration / sharing to itself.  A
scheduler orders only requests whose prefill has NOT started — once a
request's first chunk is admitted the engine pops it and owns it as the
in-progress chunk until the final chunk installs, so a policy can never
interleave half-prefilled prompts.

Shipped policies (``EngineConfig.scheduler`` takes the name, an
instance, or a zero-arg factory):

* ``fifo``     — submission order (a plain deque).
* ``spf``      — shortest-prompt-first: under a tight prefill budget,
  short prompts stop queueing behind long ones (ROADMAP item).
* ``priority`` — highest ``Request.priority`` first with linear aging:
  ``effective(now) = priority + aging_rate * (now - arrival)`` grows
  without bound while a request waits, so a low-priority long prompt is
  never starved by a stream of bounded-priority arrivals
  (hypothesis property test in tests/test_scheduler.py).

``now``/``arrival`` are in engine steps (the engine's step counter).
All policies break ties by submission order, so equal-keyed requests
drain FIFO.

Overload: policies additionally pick preemption VICTIMS.  When
the engine cannot get a KV block it calls ``victim(candidates, now)``
with the live ``RequestState`` objects (each exposing ``.request``,
``.arrival`` and ``.last_step`` — the step of its latest commit) and
preempts the returned one to the host tier; ``should_preempt(req,
arrival, victim_state, now)`` decides whether an INCOMING request may
evict a live one at admission time (only the priority policy ever says
yes — FIFO/SPF admission waits instead, avoiding preemption churn for
queue-position gains).  Both methods are optional on custom schedulers:
the engine falls back to :func:`default_victim` / never-preempt.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np


@runtime_checkable
class Scheduler(Protocol):
    """Admission-ordering policy over not-yet-prefilling requests."""

    def add(self, req, arrival: int) -> None:
        """Enqueue a submitted request (``arrival`` = engine step)."""

    def select(self, now: int) -> Optional[object]:
        """Return the request to prefill next (without removing it), or
        None when empty.  Must be stable: repeated calls with the same
        queue and ``now`` return the same request."""

    def pop(self, req) -> None:
        """Remove ``req`` (the one ``select`` returned) from the queue."""

    def remove(self, req) -> None:
        """Remove ``req`` from ANY queue position (cancellation /
        deadline expiry — unlike ``pop``, the target need not be the
        currently selected head).  Raises ``ValueError`` when not
        queued."""

    def pending(self) -> Tuple[object, ...]:
        """Queued requests, best-first is NOT required (introspection)."""

    def __len__(self) -> int:
        ...


def default_victim(candidates, now: int):
    """LRU-decode victim selection (the engine's fallback policy).

    Prefer the sequence that committed least recently (``last_step``);
    among those, the youngest arrival — the oldest request has the most
    sunk work, so it is protected — and finally the latest-submitted
    ``seq_id``.  ``candidates`` is a non-empty list of the engine's
    ``RequestState`` objects."""
    return min(candidates,
               key=lambda st: (st.last_step, -st.arrival,
                               -st.request.seq_id))


class FIFOScheduler:
    """Submission order (a plain deque)."""

    def __init__(self) -> None:
        self._q: Deque = deque()

    # overload hooks: FIFO preempts the least-recently-decoded/youngest
    # sequence and never preempts on behalf of an incoming request
    victim = staticmethod(default_victim)

    def should_preempt(self, req, arrival: int, victim_state,
                       now: int) -> bool:
        return False

    def add(self, req, arrival: int) -> None:
        self._q.append(req)

    def select(self, now: int):
        return self._q[0] if self._q else None

    def pop(self, req) -> None:
        assert self._q and self._q[0] is req, "pop != selected head"
        self._q.popleft()

    def remove(self, req) -> None:
        # deque.remove compares with ==; Request is eq=False so this is
        # identity matching, same as the scan-based policies below
        try:
            self._q.remove(req)
        except ValueError:
            raise ValueError("request not queued") from None

    def pending(self) -> tuple:
        return tuple(self._q)

    def __len__(self) -> int:
        return len(self._q)


class ShortestPromptFirst:
    """Admit the shortest queued prompt first (ties: submission order).

    Under a tight prefill budget a long prompt chunks across many steps;
    admitting short prompts first bounds every short request's queueing
    delay by one long-prompt CHUNK instead of the whole long prompt.
    """

    def __init__(self) -> None:
        self._entries: List[Tuple[int, int, object]] = []
        self._n = 0                                   # insertion counter

    def add(self, req, arrival: int) -> None:
        self._entries.append((int(np.asarray(req.prompt).size), self._n,
                              req))
        self._n += 1

    @staticmethod
    def victim(candidates, now: int):
        """Longest prompt first — the mirror of the admission order: the
        sequence SPF values least is the one holding the most blocks."""
        return max(candidates,
                   key=lambda st: (int(np.asarray(st.request.prompt).size),
                                   st.arrival, st.request.seq_id))

    def should_preempt(self, req, arrival: int, victim_state,
                       now: int) -> bool:
        return False

    def select(self, now: int):
        if not self._entries:
            return None
        return min(self._entries)[2]

    def pop(self, req) -> None:
        for i, (_, _, r) in enumerate(self._entries):
            if r is req:
                del self._entries[i]
                return
        raise ValueError("request not queued")

    remove = pop       # pop already removes from any queue position

    def pending(self) -> tuple:
        return tuple(r for _, _, r in self._entries)

    def __len__(self) -> int:
        return len(self._entries)


class PriorityAgingScheduler:
    """Highest effective priority first, aging linearly while waiting.

    ``effective(now) = priority + aging_rate * (now - arrival)``; ties go
    to the earliest submission.  With ``aging_rate > 0`` and bounded
    request priorities, every waiting request's effective priority
    eventually exceeds any fresh arrival's, so nothing starves; with
    ``aging_rate = 0`` this is strict priority scheduling.
    """

    def __init__(self, aging_rate: float = 0.25) -> None:
        if aging_rate < 0:
            raise ValueError("aging_rate must be >= 0")
        self.aging_rate = aging_rate
        self._entries: List[Tuple[object, int, int]] = []  # (req, arr, n)
        self._n = 0

    def add(self, req, arrival: int) -> None:
        self._entries.append((req, int(arrival), self._n))
        self._n += 1

    def _effective(self, req, arrival: int, now: int) -> float:
        return float(getattr(req, "priority", 0)
                     + self.aging_rate * max(0, now - arrival))

    def select(self, now: int):
        best, best_key = None, None
        for req, arrival, n in self._entries:
            key = (self._effective(req, arrival, now), -n)
            if best_key is None or key > best_key:
                best, best_key = req, key
        return best

    def pop(self, req) -> None:
        for i, (r, _, _) in enumerate(self._entries):
            if r is req:
                del self._entries[i]
                return
        raise ValueError("request not queued")

    remove = pop       # pop already removes from any queue position

    def victim(self, candidates, now: int):
        """Lowest effective priority loses its blocks first; ties go to
        the youngest arrival, then the latest submission."""
        return min(candidates,
                   key=lambda st: (self._effective(st.request, st.arrival,
                                                   now),
                                   -st.arrival, -st.request.seq_id))

    def should_preempt(self, req, arrival: int, victim_state,
                       now: int) -> bool:
        """An incoming request may evict a live one only when its aged
        effective priority STRICTLY exceeds the victim's — equal
        priorities wait, so same-class traffic never thrashes."""
        return (self._effective(req, arrival, now)
                > self._effective(victim_state.request,
                                  victim_state.arrival, now))

    def pending(self) -> tuple:
        return tuple(r for r, _, _ in self._entries)

    def __len__(self) -> int:
        return len(self._entries)


SCHEDULERS = {
    "fifo": FIFOScheduler,
    "spf": ShortestPromptFirst,
    "priority": PriorityAgingScheduler,
}


def make_scheduler(spec) -> Scheduler:
    """Resolve ``EngineConfig.scheduler``: a policy name, a ready
    Scheduler instance, or a zero-arg factory/class."""
    if spec is None:
        return FIFOScheduler()
    if isinstance(spec, str):
        try:
            return SCHEDULERS[spec]()
        except KeyError:
            raise ValueError(f"unknown scheduler {spec!r}; known: "
                             f"{sorted(SCHEDULERS)}") from None
    if isinstance(spec, type) or not hasattr(spec, "select"):
        if callable(spec):
            return spec()
        raise TypeError(f"cannot resolve scheduler from {spec!r}")
    return spec
