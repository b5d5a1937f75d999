"""Crash-safe serving supervisor: snapshot, restore, replay.

The port of ``repro.runtime.resilient_serve``.  The serving engine's unit
of recovery is an :class:`serve.engine.EngineSnapshot`: the COMPLETE
serving state (KV pool, translation tables, scheduler queue, mid-chunk
prefill progress, the host KV tier, sampling state, monotone counters) as
one value.  ``ResilientServe`` wraps ``Engine.poll()``/``stream()``:

* **Snapshot cadence**: every ``snapshot_every`` engine steps it calls
  ``Engine.snapshot()`` and keeps the newest one (one live snapshot);
  with a ``ckpt.CheckpointManager`` attached it also persists the
  snapshot through ``save_named`` (the atomic-commit, corrupt-shard-
  tolerant path), so a NEW process can resume with ``from_checkpoint``.
* **Recovery**: a caught fault (``InjectedStepFault`` by default; the
  ``catch`` tuple is the extension point for real device failures)
  restores the latest snapshot, resubmits every request the journal saw
  AFTER that snapshot, and replays.  Restarts are budgeted
  (``max_restarts``): a fault loop re-raises rather than spinning.
* **Exactly-once delivery**: replayed steps re-emit tokens the caller
  already received.  The supervisor remembers what it delivered per
  sequence and forwards only the suffix, so the externally observed
  stream of a crashed run is BIT-IDENTICAL to an uncrashed run's (pinned
  in tests/test_torch_recovery.py).  A replay whose re-emitted prefix
  DIFFERS from what was already delivered is a correctness bug and raises
  ``ReplayDivergence``.
* **Watchdog**: poll wall times feed a :class:`runtime.fault.StepWatchdog`
  (EMA-relative, built on ``StragglerMonitor``), so hung steps surface in
  ``stats()["recovery"]`` instead of in a silent stall.

The supervisor journals submissions, so requests MUST go through
``ResilientServe.submit`` (the constructor's initial snapshot covers
anything submitted before the supervisor existed).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple, Type

from repro_torch.serve.engine import EngineSnapshot, RequestOutput

from .fault import InjectedStepFault, StepWatchdog

__all__ = ["ResilientServe", "ReplayDivergence"]


class ReplayDivergence(AssertionError):
    """A restored replay re-emitted tokens that DIFFER from what was
    already delivered for the same sequence: the snapshot/restore
    bit-identity contract is broken (never expected in production;
    exists so a violation cannot masquerade as a clean stream)."""


class ResilientServe:
    """Supervise an :class:`serve.Engine` with snapshot/restore recovery.

    Parameters
    ----------
    engine:          the engine to supervise (its state at construction
                     is the first snapshot — nothing before is lost).
    ckpt_manager:    optional ``ckpt.CheckpointManager``; when given,
                     every snapshot is also persisted via ``save_named``
                     so a NEW process can resume with
                     :meth:`from_checkpoint`.
    snapshot_every:  engine steps between snapshots (a longer cadence
                     snapshots less often and replays more steps after a
                     crash).
    max_restarts:    recovery budget; exceeding it re-raises the fault.
    catch:           exception types treated as recoverable crashes.
    """

    def __init__(self, engine, ckpt_manager=None, *,
                 snapshot_every: int = 10, max_restarts: int = 3,
                 catch: Tuple[Type[BaseException], ...] =
                 (InjectedStepFault,),
                 watchdog: Optional[StepWatchdog] = None) -> None:
        if snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, got "
                             f"{snapshot_every}")
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got "
                             f"{max_restarts}")
        self.engine = engine
        self.ckpt = ckpt_manager
        self.snapshot_every = snapshot_every
        self.max_restarts = max_restarts
        self.catch = tuple(catch)
        self.watchdog = watchdog if watchdog is not None else StepWatchdog()
        # exactly-once delivery ledger: tokens already handed to the
        # caller per sequence, and sequences whose finish was reported
        self._delivered: Dict[int, List[int]] = {}
        self._finish_reported: set = set()
        # submissions since the LAST snapshot (cleared when a snapshot
        # captures them): the replay tail a restore must resubmit
        self._journal: List[Any] = []
        # telemetry
        self.restarts = 0
        self.snapshots = 0
        self.replayed_steps = 0
        self.resubmitted = 0
        self.dedup_tokens = 0
        # the recovery anchor: everything submitted before the
        # supervisor existed is inside this initial snapshot, so even a
        # crash on the very first step restores cleanly
        self._snap: EngineSnapshot = self._take_snapshot()

    # ----------------------------------------------------------- serving
    def submit(self, req, **kw) -> None:
        """Submit through the supervisor so the request is journaled for
        replay (a post-snapshot submission would otherwise vanish on
        restore)."""
        self.engine.submit(req, **kw)
        self._journal.append((req, dict(kw)))
        sid = req.seq_id
        # seq_id reuse: the new incarnation's stream starts empty
        self._delivered[sid] = []
        self._finish_reported.discard(sid)

    def cancel(self, seq_id: int, reason: str = "cancelled") -> bool:
        """Cancel on the engine AND in the journal: a cancelled request
        must not resurrect on replay."""
        out = self.engine.cancel(seq_id, reason=reason)
        self._journal = [(r, kw) for r, kw in self._journal
                         if r.seq_id != seq_id]
        return out

    def poll(self) -> List[RequestOutput]:
        """``Engine.poll`` with crash recovery and exactly-once
        delivery.  One call advances at most one engine step (plus the
        replayed steps hidden inside a recovery)."""
        while True:
            try:
                t0 = time.perf_counter()
                outs = self.engine.poll()
                self.watchdog.record(time.perf_counter() - t0)
                self._maybe_snapshot()
                return self._dedup(outs)
            except self.catch as e:
                self._recover(e)

    def stream(self):
        """Iterate deduplicated ``RequestOutput``s until every request
        finishes — the crash-safe twin of ``Engine.stream()``."""
        while self.engine.has_unfinished():
            yield from self.poll()

    def has_unfinished(self) -> bool:
        return self.engine.has_unfinished()

    # ---------------------------------------------------------- recovery
    def _take_snapshot(self) -> EngineSnapshot:
        snap = self.engine.snapshot()
        if self.ckpt is not None:
            self.ckpt.save_named(snap.step, snap.to_arrays())
        self.snapshots += 1
        return snap

    def _maybe_snapshot(self) -> None:
        if self.engine._step_count - self._snap.step >= self.snapshot_every:
            self._snap = self._take_snapshot()
            # everything journaled so far is inside the new snapshot
            self._journal.clear()

    def _recover(self, exc: BaseException) -> None:
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise exc
        crashed_at = self.engine._step_count
        self.engine.restore(self._snap)
        self.replayed_steps += max(0, crashed_at - self._snap.step)
        for req, kw in self._journal:
            self.engine.submit(req, **kw)
            self.resubmitted += 1

    def _dedup(self, outs: List[RequestOutput]) -> List[RequestOutput]:
        """Forward only what the caller has not seen: per-sequence
        delivered-token suffixing + report each finish exactly once."""
        fresh: List[RequestOutput] = []
        for ro in outs:
            seen = self._delivered.setdefault(ro.seq_id, [])
            full = list(ro.token_ids)
            # mid-replay the engine's stream is a PREFIX of what was
            # delivered (it is still catching up) — only a mismatch in
            # the overlapping region is divergence
            n = min(len(seen), len(full))
            if full[:n] != seen[:n]:
                raise ReplayDivergence(
                    f"seq {ro.seq_id}: replay re-emitted {full[:n]} "
                    f"where {seen[:n]} was already delivered — "
                    "snapshot/restore is not bit-identical")
            new = full[len(seen):]
            self.dedup_tokens += len(ro.new_token_ids) - len(new)
            seen.extend(new)
            finished = bool(ro.finished)
            if finished and ro.seq_id in self._finish_reported:
                finished = False               # already reported
            if finished:
                self._finish_reported.add(ro.seq_id)
            if new or finished:
                fresh.append(RequestOutput(
                    seq_id=ro.seq_id, new_token_ids=tuple(new),
                    token_ids=ro.token_ids, finished=finished,
                    finish_reason=ro.finish_reason))
        return fresh

    # --------------------------------------------------------- telemetry
    def stats(self) -> dict:
        """Engine ``stats()`` plus a ``"recovery"`` block."""
        s = self.engine.stats()
        s["recovery"] = {
            "restarts": self.restarts,
            "max_restarts": self.max_restarts,
            "snapshots": self.snapshots,
            "snapshot_every": self.snapshot_every,
            "last_snapshot_step": self._snap.step,
            "replayed_steps": self.replayed_steps,
            "resubmitted_requests": self.resubmitted,
            "dedup_tokens": self.dedup_tokens,
            "watchdog_flags": len(self.watchdog.flags),
            "persisted": self.ckpt is not None,
        }
        return s

    # -------------------------------------------------- cross-process resume
    @classmethod
    def from_checkpoint(cls, engine, ckpt_manager, **kw) -> "ResilientServe":
        """Resume serving in a NEW process: load the latest persisted
        snapshot (corrupt shards skip-and-warn to the previous step),
        restore it onto ``engine``, and supervise from there."""
        arrays, _step = ckpt_manager.restore_named()
        engine.restore(EngineSnapshot.from_arrays(arrays))
        return cls(engine, ckpt_manager, **kw)
