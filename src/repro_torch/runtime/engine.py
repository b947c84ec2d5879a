"""Asynchronous serverless execution engine (the paper's master, made explicit).

Port of ``repro.runtime.engine``. Algorithm 1's deployment is an *event loop*:
the master invokes q stateless workers, results trickle in under a random
latency distribution, the master folds each one into a running average the
moment it arrives, re-invokes workers that blew the deadline, and stops as soon
as the estimate is good enough. This module is that loop, built to be both

  * **really parallel**: each task's compute (a sketch-and-solve on the card)
    runs on a pluggable :mod:`~repro_torch.runtime.backends` executor
    (``inline``, ``thread``, or a real multi-process pool), and
  * **exactly replayable**: *ordering* comes only from the simulated clock of a
    seeded :class:`~repro_torch.runtime.latency.LatencyModel` plus a
    deterministic dispatch-order tiebreak, never from thread or process
    scheduling, and no wall clock is read. Same seed ⇒ identical event log
    (byte-for-byte JSONL, the reference's for the same latency seed and config)
    and bitwise-identical x̄, *regardless of backend or pool width*.

Pieces:
  * :class:`TaskQueue`   — the priority queue of future events (arrivals/timeouts),
    keyed by (sim_time, seq) so ties resolve deterministically.
  * :class:`RuntimeConfig` — deadline, retry/backoff, early-stop target, backend.
  * :class:`DeadlinePolicy` — per-dispatch deadlines: :class:`StaticDeadline`
    or :class:`AdaptiveDeadline` (rolling-p95 of the telemetry stream, clamped,
    with a warm-up default before enough samples).
  * :class:`ServerlessEngine.run` — dispatch → {arrive | timeout → backoff+retry |
    crash → drop → backoff+retry} with a float64 Welford running mean on the host
    (partial averages exact at every event), early stopping on a pluggable error
    estimate, and cancellation of in-flight work.

Retries are *new i.i.d. sketches*, never replays: each resubmission draws a fresh
``round_id`` from a monotone counter, and the worker key is
``prng.worker_key(base_key, worker_id, round_id)``, the key the synchronous
``distributed_sketch_solve`` gives worker w of round r, which is what makes the
runtime-vs-masked-solve equivalence testable.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.runtime.backends import ExecutorBackend, WorkerCrashError, make_backend
from repro_torch.runtime.latency import LatencyModel
from repro_torch.runtime.telemetry import EventLog


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Knobs of the master loop.

    deadline_s:      per-invocation deadline; a task that would finish later times
                     out (its compute is never scheduled — the lambda is abandoned).
                     Overridden per dispatch when a :class:`DeadlinePolicy` is
                     passed to the engine.
    max_retries:     resubmissions per logical task after its first timeout/crash.
    backoff_base_s:  wait before the first retry; grows by ``backoff_factor``.
    target_error:    early-stop threshold for the run's error estimate (None = run
                     every task to completion).
    min_results:     never early-stop on fewer than this many folded results.
    max_threads:     pool width for the actual compute (threads or processes).
    backend:         default executor backend — ``"inline"`` | ``"thread"`` |
                     ``"process"`` (see :mod:`repro_torch.runtime.backends`).
    """

    deadline_s: float = 1.0
    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    target_error: Optional[float] = None
    min_results: int = 1
    max_threads: int = 8
    backend: str = "thread"


class TaskQueue:
    """Deterministic future-event queue: pops in (sim_time, push_order) order."""

    def __init__(self):
        self._heap: List[Tuple[float, int, dict]] = []
        self._pushes = 0

    def push(self, t: float, item: dict) -> None:
        heapq.heappush(self._heap, (float(t), self._pushes, item))
        self._pushes += 1

    def pop(self) -> Tuple[float, dict]:
        t, _, item = heapq.heappop(self._heap)
        return t, item

    def drain(self) -> List[Tuple[float, dict]]:
        out = []
        while self._heap:
            out.append(self.pop())
        return out

    def __len__(self) -> int:
        return len(self._heap)


# ------------------------------------------------------------------ deadline policies


class DeadlineTracker:
    """Mutable per-run state of a :class:`DeadlinePolicy`. ``current()`` is read at
    every dispatch; ``observe``/``observe_timeout`` are fed from the event stream
    in simulated-clock order, so the deadline sequence is replay-deterministic."""

    def observe(self, latency_s: float) -> None:
        pass

    def observe_timeout(self, deadline_s: float) -> None:
        pass

    def current(self) -> float:
        raise NotImplementedError


class DeadlinePolicy:
    """Immutable spec; ``start()`` yields a fresh tracker for one engine run."""

    def start(self) -> DeadlineTracker:
        raise NotImplementedError


class _StaticTracker(DeadlineTracker):
    def __init__(self, deadline_s: float):
        self._deadline_s = float(deadline_s)

    def current(self) -> float:
        return self._deadline_s


@dataclasses.dataclass(frozen=True)
class StaticDeadline(DeadlinePolicy):
    """The historical behavior: one fixed cutoff for every dispatch."""

    deadline_s: float = 1.0

    def start(self) -> DeadlineTracker:
        return _StaticTracker(self.deadline_s)


class _AdaptiveTracker(DeadlineTracker):
    def __init__(self, policy: "AdaptiveDeadline"):
        self._p = policy
        self._samples: deque = deque(maxlen=policy.window)

    def observe(self, latency_s: float) -> None:
        if math.isfinite(latency_s):
            self._samples.append(float(latency_s))

    def observe_timeout(self, deadline_s: float) -> None:
        # A timeout is a censored observation: the true latency is only known to
        # exceed the deadline. Recording deadline × timeout_factor lets repeated
        # timeouts push the estimate *up* instead of anchoring it at the cutoff.
        if math.isfinite(deadline_s):
            self._samples.append(float(deadline_s) * self._p.timeout_factor)

    def current(self) -> float:
        p = self._p
        if len(self._samples) < p.min_samples:
            raw = p.warmup_s
        else:
            raw = float(np.quantile(np.asarray(self._samples), p.quantile)) * p.margin
        return min(max(raw, p.min_s), p.max_s)


@dataclasses.dataclass(frozen=True)
class AdaptiveDeadline(DeadlinePolicy):
    """Online deadlines from the telemetry stream: rolling p-quantile (default p95)
    of the last ``window`` observed task latencies, scaled by ``margin`` and
    clamped to ``[min_s, max_s]``. Before ``min_samples`` observations the
    (clamped) ``warmup_s`` default applies — the whole initial wave dispatches at
    t=0, so adaptation kicks in on retries and later rounds, exactly where a
    mis-set static deadline burns its retry budget.

    The deadline is monotone in the observed latencies and always within the
    clamp.
    """

    warmup_s: float = 1.0
    quantile: float = 0.95
    margin: float = 1.25
    min_samples: int = 5
    window: int = 64
    min_s: float = 1e-3
    max_s: float = 120.0
    timeout_factor: float = 1.5

    def start(self) -> DeadlineTracker:
        return _AdaptiveTracker(self)


def resolve_deadline_policy(
    deadline: Union[None, float, DeadlinePolicy], config: RuntimeConfig
) -> DeadlinePolicy:
    """None → the config's static deadline; a float → a static policy; a policy →
    itself. Keeps every pre-policy call site working unchanged."""
    if deadline is None:
        return StaticDeadline(config.deadline_s)
    if isinstance(deadline, DeadlinePolicy):
        return deadline
    return StaticDeadline(float(deadline))


@dataclasses.dataclass
class RuntimeResult:
    """What one engine run produced (x̄ plus its full provenance)."""

    xbar: np.ndarray                    # running average over everything that arrived
    count: int                          # realized q' — results actually folded in
    submitted: int                      # logical tasks in the initial wave
    dispatched: int                     # invocations incl. retries
    arrived: List[Tuple[int, int, int]]  # (worker_id, round_id, attempt), arrival order
    stopped_early: bool
    final_error: Optional[float]        # last error estimate (None if no estimator)
    events: EventLog

    @property
    def realized_mask(self) -> np.ndarray:
        """(q,) float mask over the initial wave: 1 where worker w's *attempt-0*
        task arrived (and was folded in before any early stop). Feeding this to
        ``distributed_sketch_solve(..., straggler_mask=...)`` reproduces x̄ exactly
        when no retries arrived (retried tasks carry fresh rounds the synchronous
        call knows nothing about)."""
        mask = np.zeros((self.submitted,), np.float32)
        for w, _, attempt in self.arrived:
            if attempt == 0 and 0 <= w < self.submitted:
                mask[w] = 1.0
        return mask

    def summary(self, *, deadline: Optional[float] = None) -> Dict:
        s = self.events.summary(q=self.submitted, deadline=deadline)
        s.update(
            count=self.count,
            submitted=self.submitted,
            dispatched=self.dispatched,
            stopped_early=self.stopped_early,
            final_error=self.final_error,
        )
        return s


class ServerlessEngine:
    """The master loop: dispatch, fold arrivals, retry timeouts/crashes, stop when done.

    ``compute_fn(worker_id, round_id) -> np.ndarray`` is the worker payload — see
    :mod:`repro_torch.runtime.tasks` for the sketch-solve builders (picklable, as the
    ``process`` backend requires). It must be a pure function of its arguments
    (workers are stateless lambdas); it runs on the executor backend while the
    event loop orders everything by simulated time.

    ``backend``: a name (``"inline"``/``"thread"``/``"process"``), an
    :class:`~repro_torch.runtime.backends.ExecutorBackend` instance (reused across runs,
    never shut down by the engine), or None → ``config.backend``.
    ``deadline``: a :class:`DeadlinePolicy`, a float, or None → the config's
    static ``deadline_s``.
    """

    def __init__(
        self,
        compute_fn: Callable[[int, int], np.ndarray],
        latency: LatencyModel,
        config: Optional[RuntimeConfig] = None,
        *,
        backend: Union[None, str, ExecutorBackend] = None,
        deadline: Union[None, float, DeadlinePolicy] = None,
    ):
        self.compute_fn = compute_fn
        self.latency = latency
        self.config = config or RuntimeConfig()
        self.backend = backend
        self.deadline = deadline

    # ------------------------------------------------------------------ run

    def run(
        self,
        q: Optional[int] = None,
        *,
        tasks: Optional[Sequence[Tuple[int, int]]] = None,
        error_fn: Optional[Callable[[np.ndarray, int], float]] = None,
    ) -> RuntimeResult:
        """Execute one job: the initial wave is ``tasks`` ([(worker_id, round_id)])
        or, when only ``q`` is given, [(0,0) … (q-1,0)] — one task per worker,
        round 0, exactly Algorithm 1's single wave.

        ``error_fn(xbar, count)`` is evaluated at every arrival; its value is logged
        on the event (the error-vs-wallclock trace) and compared against
        ``config.target_error`` for early stopping.
        """
        cfg = self.config
        if tasks is None:
            if q is None:
                raise ValueError("pass q or an explicit task list")
            tasks = [(w, 0) for w in range(q)]
        tasks = [(int(w), int(r)) for w, r in tasks]
        next_round = max((r for _, r in tasks), default=-1) + 1

        tracker = resolve_deadline_policy(self.deadline, cfg).start()
        backend_owned = not isinstance(self.backend, ExecutorBackend)
        backend = make_backend(
            self.backend if self.backend is not None else cfg.backend,
            self.compute_fn,
            max_workers=cfg.max_threads,
        )

        queue = TaskQueue()
        log = EventLog()
        mean: Optional[np.ndarray] = None
        count = 0
        dispatched = 0
        arrived: List[Tuple[int, int, int]] = []
        final_error: Optional[float] = None
        stopped = False

        def dispatch(t: float, task_id: int, w: int, r: int, attempt: int) -> None:
            nonlocal dispatched
            dispatched += 1
            dl = tracker.current()
            lat = self.latency.sample(w, r, attempt)
            log.emit(t, "dispatch", task_id, w, r, attempt, latency_s=lat,
                     deadline_s=None if math.isinf(dl) else dl)
            if lat <= dl:
                handle = backend.submit(w, r)
                queue.push(
                    t + lat,
                    {"kind": "arrive", "task_id": task_id, "w": w, "r": r,
                     "attempt": attempt, "latency_s": lat, "deadline_s": dl,
                     "handle": handle},
                )
            else:
                # The result would miss the deadline — the master abandons the
                # invocation (never schedules its compute) and hears the timeout.
                queue.push(
                    t + dl,
                    {"kind": "timeout", "task_id": task_id, "w": w, "r": r,
                     "attempt": attempt, "latency_s": lat, "deadline_s": dl},
                )

        def retry(t: float, task_id: int, w: int, attempt: int) -> None:
            nonlocal next_round
            if attempt < cfg.max_retries:
                delay = cfg.backoff_base_s * cfg.backoff_factor ** attempt
                fresh = next_round
                next_round += 1
                log.emit(t, "retry", task_id, w, fresh, attempt + 1, backoff_s=delay)
                dispatch(t + delay, task_id, w, fresh, attempt + 1)

        try:
            for task_id, (w, r) in enumerate(tasks):
                dispatch(0.0, task_id, w, r, attempt=0)

            while len(queue):
                t, item = queue.pop()
                task_id, w, r, attempt = item["task_id"], item["w"], item["r"], item["attempt"]

                if item["kind"] == "arrive":
                    try:
                        x = np.asarray(backend.result(item["handle"]), dtype=np.float64)
                    except WorkerCrashError:
                        # The OS process running this task died mid-compute. The
                        # master hears silence where a result was due: a drop,
                        # re-entering the same backoff→retry loop as a timeout
                        # (fresh round-folded key, new i.i.d. sketch).
                        log.emit(t, "drop", task_id, w, r, attempt,
                                 latency_s=item["latency_s"])
                        retry(t, task_id, w, attempt)
                        continue
                    tracker.observe(item["latency_s"])
                    count += 1
                    mean = x.copy() if mean is None else mean + (x - mean) / count
                    arrived.append((w, r, attempt))
                    err = None
                    if error_fn is not None:
                        err = float(error_fn(mean, count))
                        final_error = err
                    log.emit(t, "arrive", task_id, w, r, attempt,
                             latency_s=item["latency_s"], count=count, error=err)
                    if (
                        cfg.target_error is not None
                        and err is not None
                        and err <= cfg.target_error
                        and count >= cfg.min_results
                    ):
                        log.emit(t, "stop", task_id, w, r, attempt,
                                 count=count, error=err)
                        stopped = True
                        for tc, pending in queue.drain():
                            log.emit(
                                tc, "cancel", pending["task_id"], pending["w"],
                                pending["r"], pending["attempt"],
                            )
                            handle = pending.get("handle")
                            if handle is not None:
                                backend.cancel(handle)
                        break

                elif item["kind"] == "timeout":
                    tracker.observe_timeout(item["deadline_s"])
                    log.emit(t, "timeout", task_id, w, r, attempt,
                             latency_s=item["latency_s"])
                    retry(t, task_id, w, attempt)
        finally:
            if backend_owned:
                backend.shutdown()

        if mean is None:
            raise RuntimeError(
                "no worker result ever arrived (all tasks dropped or timed out "
                f"after {cfg.max_retries} retries) — x̄ is undefined; loosen the "
                "deadline, raise max_retries, or use a lighter LatencyModel"
            )
        return RuntimeResult(
            xbar=mean, count=count, submitted=len(tasks), dispatched=dispatched,
            arrived=arrived, stopped_early=stopped, final_error=final_error,
            events=log,
        )
