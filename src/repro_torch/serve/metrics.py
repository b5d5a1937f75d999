"""Live serving metrics: per-step events, rolling windows, pluggable sinks.

A copy of ``repro.serve.metrics`` (the port imports nothing of the JAX
package).  ``Engine.stats()`` is a point-in-time view of the serving
stack's counters (RestSeg hits, flexible walks, pool occupancy,
preempt/resume traffic); ``MetricsLogger`` turns them into a trajectory:
the engine feeds it ONE host-side event per step (cumulative counters +
gauges), the logger differentiates the counters into per-step deltas,
maintains rolling ring-buffer windows exposing medians/p99s, and fans
every event out to pluggable sinks (a JSONL file, an in-memory list for
tests — the ``wandblog`` idiom, backend-free).

Everything here is host-side arithmetic over counters the engine already
tracks: attaching a logger performs NO device operation, perturbs no
PRNG, and token streams are bit-identical logger-on vs logger-off
(pinned in tests/test_torch_metrics.py).

Event schema:

* ``{"kind": "step", "step": n, "wall_s": w, "tokens": d, ...}`` — one
  per engine step; counter fields are DELTAS over the previous step
  (``tokens``, ``rsw_hits``, ``flex_walks``, ``swap_faults``,
  ``spec_drafted``, ``spec_accepted``, ``request_preempts``,
  ``request_resumes``, ``swap_bytes_out``, ``swap_bytes_in``,
  ``prefix_lookups``, ``prefix_hits``, ``cancelled``,
  ``deadline_expired``, per-shard
  ``shard_swap_bytes_out/in`` lists), gauge fields are point-in-time
  (``occupancy``, ``mapped_blocks``, ``pool_blocks``, ``live``,
  ``queued``, ``host_tier_seqs``).
* ``{"kind": "submit", "step": n, "seq_id": s}`` — request enqueued.
* ``{"kind": "finish", "step": n, "seq_id": s, "latency_s": t,
  "tokens": k, "finish_reason": r}`` — request finished; ``latency_s``
  is submit-to-finish on the logger's monotonic clock
  (``time.perf_counter`` — wall-clock ``time.time`` is NTP-step-prone).
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Protocol

import numpy as np

__all__ = ["MetricsSink", "MemorySink", "JsonlSink", "RollingWindow",
           "MetricsLogger", "STEP_COUNTER_KEYS"]

# counter fields of a "step" event (monotone on the engine, emitted as
# per-step deltas; the logger's ``totals`` re-integrates them, so
# ``totals[k] == Engine counters`` at every step — the agreement oracle)
STEP_COUNTER_KEYS = (
    "tokens", "rsw_hits", "flex_walks", "swap_faults",
    "spec_drafted", "spec_accepted", "request_preempts",
    "request_resumes", "swap_bytes_out", "swap_bytes_in",
    "prefix_lookups", "prefix_hits", "cancelled", "deadline_expired",
)


class MetricsSink(Protocol):
    """Where events go.  ``emit`` receives one JSON-serializable mapping
    per event; ``close`` flushes/releases whatever the sink holds."""

    def emit(self, event: Mapping[str, Any]) -> None: ...

    def close(self) -> None: ...


class MemorySink:
    """In-memory sink: events accumulate on ``.events`` (tests, demos)."""

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []

    def emit(self, event: Mapping[str, Any]) -> None:
        self.events.append(dict(event))

    def close(self) -> None:
        pass


class JsonlSink:
    """Append-only JSONL file sink: one event per line, flushed per
    event so a ``tail -f`` (or a crashed run's post-mortem) sees every
    step that actually completed."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, "a")

    def emit(self, event: Mapping[str, Any]) -> None:
        self._f.write(json.dumps(event, separators=(",", ":")) + "\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a JSONL sink file back into the event list (round-trip
    helper for tests and offline analysis)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class RollingWindow:
    """Fixed-capacity ring buffer over floats with order-preserving
    reads: the rolling median/percentile of the last ``capacity``
    pushes, O(capacity) per query, zero allocation per push."""

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"window capacity must be >= 1, got "
                             f"{capacity}")
        self.capacity = capacity
        self._buf = np.zeros(capacity, np.float64)
        self._n = 0          # total pushes ever
        self._i = 0          # next write slot

    def push(self, x: float) -> None:
        self._buf[self._i] = float(x)
        self._i = (self._i + 1) % self.capacity
        self._n += 1

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def values(self) -> np.ndarray:
        """Window contents in push order (oldest first)."""
        k = len(self)
        if self._n <= self.capacity:
            return self._buf[:k].copy()
        return np.roll(self._buf, -self._i)[:k].copy()

    def median(self) -> float:
        return float(np.median(self.values())) if len(self) else 0.0

    def percentile(self, q: float) -> float:
        return (float(np.percentile(self.values(), q))
                if len(self) else 0.0)

    def sum(self) -> float:
        return float(self.values().sum()) if len(self) else 0.0


class MetricsLogger:
    """Streaming serving telemetry: per-step events in, rolling-window
    aggregates + sink fan-out.

    The engine calls ``on_submit`` / ``on_step`` / ``on_finish``
    (``EngineConfig.metrics``); drivers read ``rolling()`` /
    ``dashboard_line()`` / ``totals`` / ``request_latencies``.  The
    logger is purely observational — it never touches device state, so
    attaching it cannot change a token stream.

    ``clock`` is injectable for tests; the default is the monotonic
    ``time.perf_counter`` (request latencies must survive an NTP step).
    """

    def __init__(self, sinks: Optional[List[MetricsSink]] = None, *,
                 window: int = 128,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self.sinks: List[MetricsSink] = list(sinks or [])
        self.window = window
        self._clock = clock
        self.n_steps = 0                      # step events seen
        self.totals: Dict[str, int] = {k: 0 for k in STEP_COUNTER_KEYS}
        self._prev: Dict[str, int] = {}       # last absolute counters
        self._prev_shard: Dict[str, List[int]] = {}
        # rolling windows over the last ``window`` step events
        self._wall = RollingWindow(window)
        self._tokens = RollingWindow(window)
        self._occ = RollingWindow(window)
        self._hits = RollingWindow(window)       # rsw_hits deltas
        self._walks = RollingWindow(window)      # flex_walks deltas
        self._drafted = RollingWindow(window)
        self._accepted = RollingWindow(window)
        self._pc_lookups = RollingWindow(window)
        self._pc_hits = RollingWindow(window)
        # request lifecycle (latency on the injected monotonic clock)
        self._submit_t: Dict[int, float] = {}
        self.request_latencies: Dict[int, float] = {}
        self.wall_s_total = 0.0

    # ------------------------------------------------------ engine-facing
    def on_submit(self, seq_id: int, step: int) -> None:
        self._submit_t[seq_id] = self._clock()
        self._emit({"kind": "submit", "step": step, "seq_id": seq_id})

    def on_finish(self, seq_id: int, step: int, tokens: int,
                  finish_reason: Optional[str]) -> None:
        t0 = self._submit_t.pop(seq_id, None)
        lat = None if t0 is None else self._clock() - t0
        if lat is not None:
            self.request_latencies[seq_id] = lat
        self._emit({"kind": "finish", "step": step, "seq_id": seq_id,
                    "latency_s": lat, "tokens": tokens,
                    "finish_reason": finish_reason})

    def on_step(self, step: int, wall_s: float,
                counters: Mapping[str, int],
                gauges: Mapping[str, Any]) -> None:
        """One engine step: ``counters`` are the engine's ABSOLUTE
        monotone counters (the logger differentiates), ``gauges`` are
        point-in-time values copied into the event verbatim."""
        event: Dict[str, Any] = {"kind": "step", "step": step,
                                 "wall_s": round(float(wall_s), 9)}
        for k in STEP_COUNTER_KEYS:
            cur = int(counters.get(k, 0))
            d = cur - self._prev.get(k, 0)
            self._prev[k] = cur
            self.totals[k] = cur
            event[k] = d
        for k, v in counters.items():
            if k in STEP_COUNTER_KEYS:
                continue
            # list-valued counters (per-shard swap bytes): elementwise
            # deltas so the event stays a per-step account
            cur_list = [int(x) for x in v]
            prev = self._prev_shard.get(k, [0] * len(cur_list))
            event[k] = [c - p for c, p in zip(cur_list, prev)]
            self._prev_shard[k] = cur_list
        event.update(gauges)
        self.n_steps += 1
        self.wall_s_total += float(wall_s)
        self._wall.push(wall_s)
        self._tokens.push(event["tokens"])
        self._occ.push(float(gauges.get("occupancy", 0.0)))
        self._hits.push(event["rsw_hits"])
        self._walks.push(event["flex_walks"])
        self._drafted.push(event["spec_drafted"])
        self._accepted.push(event["spec_accepted"])
        self._pc_lookups.push(event["prefix_lookups"])
        self._pc_hits.push(event["prefix_hits"])
        self._emit(event)

    def rebase(self, counters: Mapping[str, int]) -> None:
        """Re-anchor the delta baseline at ``counters`` without emitting
        an event.  ``Engine.restore`` calls this: a snapshot restore
        REWINDS the engine's absolute counters, and differentiating
        across the rewind would emit large negative deltas (and corrupt
        ``totals``, which must agree with ``Engine.stats()`` at every
        step).  After rebase the next ``on_step`` sees deltas relative
        to the restored state — the replayed steps are counted again,
        which is truthful: the engine really did re-execute them."""
        for k in STEP_COUNTER_KEYS:
            cur = int(counters.get(k, 0))
            self._prev[k] = cur
            self.totals[k] = cur
        for k, v in counters.items():
            if k not in STEP_COUNTER_KEYS:
                self._prev_shard[k] = [int(x) for x in v]

    # ----------------------------------------------------------- rollups
    def rolling(self) -> Dict[str, float]:
        """Rolling-window aggregates over the last ``window`` steps:
        step-latency median/p99, throughput, and the paper's headline
        rates (RestSeg hit rate, spec acceptance, prefix-cache hit
        rate), plus the latest pool occupancy."""
        wall = self._wall.sum()
        seen = self._hits.sum() + self._walks.sum()
        drafted = self._drafted.sum()
        lookups = self._pc_lookups.sum()
        occ = self._occ.values()
        return {
            "steps": self.n_steps,
            "window_steps": len(self._wall),
            "step_ms_p50": self._wall.median() * 1e3,
            "step_ms_p99": self._wall.percentile(99) * 1e3,
            "tokens_per_s": (self._tokens.sum() / wall) if wall else 0.0,
            "rsw_hit_rate": (self._hits.sum() / seen) if seen else 0.0,
            "acceptance_rate": ((self._accepted.sum() / drafted)
                                if drafted else 0.0),
            "prefix_hit_rate": ((self._pc_hits.sum() / lookups)
                                if lookups else 0.0),
            "occupancy": float(occ[-1]) if occ.size else 0.0,
        }

    def dashboard_line(self) -> str:
        """A one-line live dashboard of the rolling window and totals."""
        r = self.rolling()
        t = self.totals
        return (f"[metrics] step {r['steps']:>5d} | "
                f"{r['tokens_per_s']:7.1f} tok/s | "
                f"p50 {r['step_ms_p50']:6.2f} ms "
                f"p99 {r['step_ms_p99']:6.2f} ms | "
                f"occ {r['occupancy']:4.0%} | "
                f"rsw {r['rsw_hit_rate']:4.0%} | "
                f"acc {r['acceptance_rate']:4.0%} | "
                f"pfx {r['prefix_hit_rate']:4.0%} | "
                f"pre {t['request_preempts']}/{t['request_resumes']} | "
                f"cxl {t['cancelled']}/{t['deadline_expired']}")

    # ------------------------------------------------------------ plumbing
    def _emit(self, event: Mapping[str, Any]) -> None:
        for s in self.sinks:
            s.emit(event)

    def close(self) -> None:
        for s in self.sinks:
            s.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
