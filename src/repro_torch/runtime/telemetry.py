"""Structured task telemetry: the event log is the runtime's source of truth.

Port of ``repro.runtime.telemetry``: the same events, the same JSON lines byte for
byte, the same summary and heartbeat report.

Every state transition in the engine emits one :class:`Event`; the ordered list
*is* the execution (simulated clock, no wall-clock fields), so

  * replay is checkable — same seed ⇒ byte-identical JSONL,
  * the error-vs-wallclock trace of the paper's Fig. 1 falls out of the ``arrive``
    events' ``error`` extras,
  * the summary report subsumes ``HeartbeatMonitor.report()`` (same keys plus the
    p50 / retry / timeout extensions) by replaying arrivals into a monitor.

Event kinds: ``dispatch`` | ``arrive`` | ``timeout`` | ``drop`` | ``retry`` |
``cancel`` | ``stop`` — ``drop`` is the process backend's crash signal (a worker
OS process died mid-task); it re-enters the same retry loop as ``timeout``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Event:
    seq: int            # global order (ties in t broken by dispatch order)
    t: float            # simulated seconds since the master started the job
    kind: str
    task_id: int        # stable id of the logical task (survives retries)
    worker_id: int
    round_id: int       # the key-fold round — retries get *fresh* rounds
    attempt: int
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        rec = {
            "seq": self.seq,
            "t": round(self.t, 9),
            "kind": self.kind,
            "task_id": self.task_id,
            "worker_id": self.worker_id,
            "round_id": self.round_id,
            "attempt": self.attempt,
        }
        rec.update({k: self.extra[k] for k in sorted(self.extra)})
        return json.dumps(rec)


class EventLog:
    """Append-only, simulated-time-ordered record of one engine run."""

    def __init__(self):
        self.events: List[Event] = []

    def emit(self, t, kind, task_id, worker_id, round_id, attempt, **extra) -> Event:
        ev = Event(
            seq=len(self.events), t=float(t), kind=kind, task_id=int(task_id),
            worker_id=int(worker_id), round_id=int(round_id), attempt=int(attempt),
            extra={k: float(v) for k, v in extra.items() if v is not None},
        )
        self.events.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def lines(self) -> List[str]:
        return [ev.to_json() for ev in self.events]

    def to_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for line in self.lines():
                f.write(line + "\n")
        return path

    # ------------------------------------------------------------------ queries

    def counts(self) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for ev in self.events:
            c[ev.kind] = c.get(ev.kind, 0) + 1
        return c

    def arrivals(self) -> List[Event]:
        return [ev for ev in self.events if ev.kind == "arrive"]

    def error_trace(self) -> List[Tuple[float, int, float]]:
        """(sim_time, running_count, running_error) at every arrival that carried an
        error estimate — the error-vs-wallclock curve of the paper's Fig. 1."""
        out = []
        for ev in self.arrivals():
            if "error" in ev.extra:
                out.append((ev.t, int(ev.extra.get("count", 0)), ev.extra["error"]))
        return out

    def heartbeat_report(self, q: int, deadline: float) -> Dict[str, float]:
        """Replay this log into a ``HeartbeatMonitor`` and emit its (extended) report.

        Attempt-0 latencies form the wave the monitor scores against ``deadline``
        (hard drops enter as +inf runtimes, i.e. missed); retry/timeout events feed
        the monitor's counters, and worker crashes (``drop``) count as timeouts —
        the monitor has no finer-grained bucket for a dead worker. The result is a strict superset of the pre-runtime
        ``HeartbeatMonitor.report()`` schema.
        """
        import numpy as np

        from repro_torch.distributed.fault_tolerance import HeartbeatMonitor

        mon = HeartbeatMonitor(q=q, deadline=deadline)
        wave = np.full((q,), np.inf)
        for ev in self.events:
            if ev.attempt == 0 and ev.kind in ("arrive", "timeout") and 0 <= ev.worker_id < q:
                lat = ev.extra.get("latency_s", np.inf)
                wave[ev.worker_id] = min(wave[ev.worker_id], lat)
            if ev.kind in ("timeout", "drop"):
                mon.record_timeout()
            if ev.kind == "retry":
                mon.record_retry()
        mon.record_step(wave)
        return mon.report()

    def summary(self, *, q: Optional[int] = None, deadline: Optional[float] = None) -> Dict:
        """One dict for JSON reports: event counts, latency percentiles over all
        arrivals, effective q' (results actually averaged), sim makespan, and —
        when (q, deadline) are given — the embedded heartbeat report."""
        import numpy as np

        counts = self.counts()
        lats = [ev.extra["latency_s"] for ev in self.arrivals() if "latency_s" in ev.extra]
        out: Dict = {
            "events": len(self.events),
            "counts": counts,
            "effective_q": counts.get("arrive", 0),
            "retries": counts.get("retry", 0),
            "timeouts": counts.get("timeout", 0),
            "drops": counts.get("drop", 0),
            "cancelled": counts.get("cancel", 0),
            "sim_makespan_s": self.events[-1].t if self.events else 0.0,
        }
        if lats:
            out["p50_latency_s"] = float(np.quantile(lats, 0.50))
            out["p95_latency_s"] = float(np.quantile(lats, 0.95))
            out["mean_latency_s"] = float(np.mean(lats))
        if q is not None and deadline is not None:
            out["heartbeat"] = self.heartbeat_report(q, deadline)
        return out
