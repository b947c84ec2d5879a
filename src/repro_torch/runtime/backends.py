"""Pluggable executor backends: where a task's compute actually runs.

Port of ``repro.runtime.backends``. The engine (:mod:`repro_torch.runtime.engine`)
separates *ordering* from *compute*: event order comes from the simulated clock
of a seeded ``LatencyModel``, while the task payloads run on one of these
backends. Because nothing in the event schedule depends on where (or when, in
wall-clock) the compute happens, the same seed produces a byte-identical event
log and bitwise-identical x̄ on every backend.

Backends:
  * ``inline``  — compute on the master thread, at the moment the arrival event
    pops. Zero concurrency; the reference for the other two.
  * ``thread``  — a ``ThreadPoolExecutor``. The tasks' kernels are launched from
    the pool's threads (the wrappers release the GIL in their C calls and the
    launch counters are locked); each thread's current stream is the default
    stream, so the launches run in order on the card.
  * ``process`` — a ``ProcessPoolExecutor`` over *picklable* task specs
    (see :class:`repro_torch.runtime.tasks.SketchSolveCompute`). Workers are
    spawned OS processes: each re-imports torch, loads the kernels the parent
    built and makes its own device copy of the data, so a task can die (SIGKILL,
    OOM); the backend detects the broken pool, rebuilds it, re-runs innocent
    casualties, and surfaces the genuinely crashing task as
    :class:`WorkerCrashError`, which the engine turns into a ``drop`` event that
    re-enters the deadline→backoff→retry loop with a fresh round-folded key.
    Only a broken pool becomes a drop: an exception a task raises (a CUDA error,
    a refused launch) comes out of ``result`` as itself.

:class:`KillSwitch` is the fault injector for the crash path: it wraps a picklable
compute and SIGKILLs its own OS process at chosen (worker, round) coordinates.
It lives here (not in the tests) so spawned workers can unpickle it by a stable
module path.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import pickle
import signal
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures.process import BrokenProcessPool, ProcessPoolExecutor
from typing import Callable, Optional, Tuple, Union

import numpy as np

ComputeFn = Callable[[int, int], np.ndarray]


class WorkerCrashError(RuntimeError):
    """The OS process running a task died (SIGKILL / OOM) before returning."""


class ExecutorBackend:
    """Minimal executor surface the engine needs. ``submit`` must not block on the
    compute; ``result`` blocks until the handle's value is available (or raises
    :class:`WorkerCrashError` if the worker died)."""

    name: str = "base"

    def submit(self, worker_id: int, round_id: int):
        raise NotImplementedError

    def result(self, handle) -> np.ndarray:
        raise NotImplementedError

    def cancel(self, handle) -> None:  # best-effort; cancelled handles are never read
        pass

    def shutdown(self) -> None:
        pass


class InlineBackend(ExecutorBackend):
    """Run the compute on the master thread when the arrival event pops."""

    name = "inline"

    def __init__(self, compute_fn: ComputeFn, max_workers: int = 1):
        self.compute_fn = compute_fn

    def submit(self, worker_id: int, round_id: int) -> Tuple[int, int]:
        return (int(worker_id), int(round_id))

    def result(self, handle) -> np.ndarray:
        return self.compute_fn(*handle)


class ThreadBackend(ExecutorBackend):
    """Thread-pool compute: tasks overlap their host work and queue their kernels
    on the card while the master folds earlier results."""

    name = "thread"

    def __init__(self, compute_fn: ComputeFn, max_workers: int = 8):
        self.compute_fn = compute_fn
        self._pool = ThreadPoolExecutor(max_workers=max(1, int(max_workers)))

    def submit(self, worker_id: int, round_id: int):
        return self._pool.submit(self.compute_fn, int(worker_id), int(round_id))

    def result(self, handle) -> np.ndarray:
        return handle.result()

    def cancel(self, handle) -> None:
        handle.cancel()

    def shutdown(self) -> None:
        """Cancel the tasks not started and wait for the running ones (at most the
        pool's width), so no task launches work on the card after the job."""
        self._pool.shutdown(wait=True, cancel_futures=True)


# ------------------------------------------------------------------ process backend

# Worker-process global: the unpickled compute, installed once per process by the
# pool initializer so task submissions ship only (worker_id, round_id) — the data
# (A, b, key) crosses the process boundary exactly once.
_PROCESS_COMPUTE: Optional[ComputeFn] = None


def _process_worker_init(payload: bytes) -> None:
    global _PROCESS_COMPUTE
    _PROCESS_COMPUTE = pickle.loads(payload)


def _process_worker_run(worker_id: int, round_id: int):
    return _PROCESS_COMPUTE(worker_id, round_id)


@dataclasses.dataclass
class _ProcessHandle:
    worker_id: int
    round_id: int
    future: object
    generation: int  # the pool the future was submitted to


class ProcessBackend(ExecutorBackend):
    """Multi-process compute over a picklable task spec, with crash detection.

    A SIGKILLed worker marks the whole ``ProcessPoolExecutor`` broken: every
    unresolved future raises ``BrokenProcessPool``, innocent or not. Each handle
    remembers the pool (its generation) it was submitted to. The first
    ``BrokenProcessPool`` read from the current pool replaces that pool; one read
    from a pool already replaced replaces nothing. Either way ``result`` resubmits
    the popped handle once to the current pool — a pure compute re-runs to the
    identical value, so innocent casualties stay invisible in the event log — and
    only a handle whose resubmission breaks its pool too is reported as
    :class:`WorkerCrashError` (the engine's ``drop`` path). One break builds one
    new pool, and a pool is shut down only once it is broken, so no submitted
    task is ever cancelled by a rebuild; the next submission (the retry with a
    fresh round key) finds a healthy pool.

    Workers are spawned, never forked: forking after the parent initialized CUDA
    is unsafe, and spawned children re-import torch and set up their own CUDA
    context (the dominant cost; keep ``max_workers`` small).
    """

    name = "process"

    def __init__(self, compute_fn: ComputeFn, max_workers: int = 2):
        # Pickling up front both validates the task spec and freezes the payload
        # the initializer ships to every worker process.
        self._payload = pickle.dumps(compute_fn)
        self._max_workers = max(1, int(max_workers))
        self._pool: Optional[ProcessPoolExecutor] = None
        self.pools_built = 0  # the current pool's generation

    def _current_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            self._pool = ProcessPoolExecutor(
                max_workers=self._max_workers,
                mp_context=mp.get_context("spawn"),
                initializer=_process_worker_init,
                initargs=(self._payload,),
            )
            self.pools_built += 1
        return self._pool

    def _replace_broken(self, generation: int) -> None:
        """Drop the pool of ``generation`` if it is still the current one (the
        next submission builds its successor). Its futures have all failed, so
        shutting it down cancels nothing."""
        if generation == self.pools_built and self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def submit(self, worker_id: int, round_id: int) -> _ProcessHandle:
        worker_id, round_id = int(worker_id), int(round_id)
        pool = self._current_pool()
        try:
            future = pool.submit(_process_worker_run, worker_id, round_id)
        except BrokenProcessPool:
            # A crash elsewhere already poisoned the pool; this task is innocent.
            self._replace_broken(self.pools_built)
            pool = self._current_pool()
            future = pool.submit(_process_worker_run, worker_id, round_id)
        return _ProcessHandle(worker_id, round_id, future, self.pools_built)

    def result(self, handle: _ProcessHandle) -> np.ndarray:
        for resubmitted in (False, True):
            try:
                return handle.future.result()
            except BrokenProcessPool:
                self._replace_broken(handle.generation)
                if not resubmitted:
                    fresh = self.submit(handle.worker_id, handle.round_id)
                    handle.future, handle.generation = fresh.future, fresh.generation
        raise WorkerCrashError(
            f"worker process died running task (worker={handle.worker_id}, "
            f"round={handle.round_id}) — killed twice in a row, reporting a drop"
        )

    def cancel(self, handle: _ProcessHandle) -> None:
        handle.future.cancel()

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None


# ---------------------------------------------------------------------- fault injection


@dataclasses.dataclass
class KillSwitch:
    """Chaos-monkey wrapper for fault-injection tests: SIGKILL the executing OS
    process when the task coordinate matches. Only meaningful on the ``process``
    backend — on ``inline``/``thread`` it would kill the master itself, so
    ``__call__`` refuses unless the current pid differs from ``master_pid``.
    """

    inner: ComputeFn
    kill_coords: Tuple[Tuple[int, int], ...] = ()
    master_pid: int = dataclasses.field(default_factory=os.getpid)

    def __call__(self, worker_id: int, round_id: int) -> np.ndarray:
        if (int(worker_id), int(round_id)) in {tuple(c) for c in self.kill_coords}:
            if os.getpid() == self.master_pid:
                raise RuntimeError(
                    "KillSwitch fired on the master process — use the 'process' backend"
                )
            os.kill(os.getpid(), signal.SIGKILL)
        return self.inner(worker_id, round_id)


# ----------------------------------------------------------------------------- factory

BACKENDS = {
    "inline": InlineBackend,
    "thread": ThreadBackend,
    "process": ProcessBackend,
}


def make_backend(
    kind: Union[str, ExecutorBackend],
    compute_fn: ComputeFn,
    *,
    max_workers: int = 8,
) -> ExecutorBackend:
    """Resolve a backend name (or pass through an instance) for one engine run."""
    if isinstance(kind, ExecutorBackend):
        return kind
    try:
        cls = BACKENDS[kind]
    except KeyError:
        raise ValueError(f"unknown backend {kind!r}; expected one of {sorted(BACKENDS)}")
    return cls(compute_fn, max_workers=max_workers)
