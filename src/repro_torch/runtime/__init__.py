"""`repro_torch.runtime` — asynchronous serverless execution engine, on the GPU.

Port of ``repro.runtime``: an event-driven master that invokes stateless
sketch-solve workers, folds results into a running average as they arrive
(Algorithm 1 with the realized q′), retries blown deadlines and crashed workers
with fresh i.i.d. sketches, stops early when the estimate is accurate enough,
and logs every transition as structured telemetry. Each task runs the port's
solver and kernels on the card (``device="cpu"`` for the CPU).

    from repro_torch import runtime as rt

    res = rt.serverless_sketch_solve(
        spec, key, A, b, q=32,
        latency=rt.HeavyTailLatency(scale_s=0.5, alpha=1.5, seed=0),
        config=rt.RuntimeConfig(deadline_s=1.0, max_retries=2, target_error=1e-2),
        error_fn="probe",
        backend="process",                  # or "inline" / "thread" (default)
        deadline=rt.AdaptiveDeadline(),     # rolling-p95 deadlines, else static
    )
    res.xbar                # the running average at stop time
    res.events.to_jsonl(p)  # deterministic replay log — identical on every backend
    res.summary()           # p50/p95, retries, timeouts, drops, effective q', ...
"""
from repro_torch.runtime.backends import (
    BACKENDS,
    ExecutorBackend,
    InlineBackend,
    KillSwitch,
    ProcessBackend,
    ThreadBackend,
    WorkerCrashError,
    make_backend,
)
from repro_torch.runtime.engine import (
    AdaptiveDeadline,
    DeadlinePolicy,
    DeadlineTracker,
    RuntimeConfig,
    RuntimeResult,
    ServerlessEngine,
    StaticDeadline,
    TaskQueue,
    resolve_deadline_policy,
)
from repro_torch.runtime.latency import (
    ConstantLatency,
    DriftLatency,
    DropLatency,
    HeavyTailLatency,
    LatencyModel,
    LognormalLatency,
)
from repro_torch.runtime.tasks import (
    LeastNormCompute,
    SketchSolveCompute,
    make_least_norm_compute,
    make_sketch_solve_compute,
    probe_error_fn,
    resolve_error_fn,
    serverless_sketch_solve,
    subsample_probe,
    theory_error_fn,
)
from repro_torch.runtime.telemetry import Event, EventLog

__all__ = [
    "RuntimeConfig",
    "RuntimeResult",
    "ServerlessEngine",
    "TaskQueue",
    "DeadlinePolicy",
    "DeadlineTracker",
    "StaticDeadline",
    "AdaptiveDeadline",
    "resolve_deadline_policy",
    "ExecutorBackend",
    "InlineBackend",
    "ThreadBackend",
    "ProcessBackend",
    "KillSwitch",
    "WorkerCrashError",
    "make_backend",
    "BACKENDS",
    "LatencyModel",
    "ConstantLatency",
    "LognormalLatency",
    "HeavyTailLatency",
    "DriftLatency",
    "DropLatency",
    "Event",
    "EventLog",
    "SketchSolveCompute",
    "LeastNormCompute",
    "make_sketch_solve_compute",
    "make_least_norm_compute",
    "serverless_sketch_solve",
    "theory_error_fn",
    "probe_error_fn",
    "resolve_error_fn",
    "subsample_probe",
]
