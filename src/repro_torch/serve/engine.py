"""Sketch-solve job admission: Algorithm 1 as a service, on the GPU.

Port of ``repro.serve.engine``'s :class:`SolveJob` and :class:`SolveServer`, the
*sketch-least-squares* front end: a job-admission API
(:meth:`SolveServer.submit_solve`) that routes regression jobs through the
asynchronous :class:`~repro_torch.runtime.engine.ServerlessEngine` (streaming
Welford averages, deadline→backoff→retry, adaptive deadlines optional, early
stop, and a per-job telemetry summary) on any executor backend
(``inline``/``thread``/``process``). The reference module's batched LM engine
waits for the port's LM scaffolding.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from repro_torch.runtime import tasks as rt_tasks
from repro_torch.runtime.engine import RuntimeConfig, RuntimeResult, ServerlessEngine
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class SolveJob:
    """One admitted sketch-solve job: the result plus its full provenance."""

    job_id: int
    spec: object                 # sketches.SketchSpec
    q: int
    backend: str
    result: RuntimeResult
    summary: Dict

    @property
    def xbar(self) -> np.ndarray:
        return self.result.xbar

    @property
    def realized_mask(self) -> np.ndarray:
        return self.result.realized_mask


def _backend_name(backend) -> str:
    return backend if isinstance(backend, str) else backend.name


class SolveServer:
    """Job admission for distributed sketch-least-squares (the paper's Algorithm 1
    as a *service*): every submitted job runs through the asynchronous
    :class:`~repro_torch.runtime.engine.ServerlessEngine` (the same deadline →
    backoff → retry loop, streaming Welford averaging and early stopping) and
    leaves a per-job telemetry summary behind. Every task runs on ``device``
    (``None`` means CUDA, raising when absent; ``"cpu"`` for the CPU).

        from repro_torch import runtime as rt
        from repro_torch.serve import SolveServer

        server = SolveServer(
            latency=rt.HeavyTailLatency(scale_s=0.5, alpha=1.5, seed=0),
            config=rt.RuntimeConfig(deadline_s=1.0, max_retries=2),
            backend="process",                 # or "inline" / "thread"
            deadline=rt.AdaptiveDeadline(),    # optional: rolling-p95 deadlines
        )
        job = server.submit_solve(A, b, spec, q=32, error_fn="probe")
        job.xbar, job.summary                  # solution + telemetry
        server.telemetry()                     # aggregate across jobs

    The server is synchronous at the job level (``submit_solve`` returns the
    finished job) while each job is asynchronous at the task level; per-job
    determinism is inherited from the engine (same seed ⇒ byte-identical event
    log on every backend).
    """

    def __init__(self, *, latency, config: Optional[RuntimeConfig] = None, backend: Union[str, object] = "thread",
                 deadline=None, device=None):
        self.latency = latency
        self.config = config or RuntimeConfig()
        self.backend = backend
        self.deadline = deadline
        self.device = resolve_device(device)
        self.jobs: List[SolveJob] = []

    # ------------------------------------------------------------------ admission

    def submit_solve(
        self,
        A,
        b,
        spec,
        q: int,
        *,
        key=None,
        seed: int = 0,
        rounds: int = 1,
        reg: float = 0.0,
        method: str = "fused",
        error_fn: Union[None, str, Callable[[np.ndarray, int], float]] = None,
        probe_rows: int = 1024,
        least_norm: bool = False,
        save_events: Optional[str] = None,
        backend: Union[None, str, object] = None,
        deadline=None,
    ) -> SolveJob:
        """Admit one job: ``rounds`` waves of ``q`` sketch-solve workers over
        (A, b) with sketch ``spec``, averaged as results arrive. ``key`` defaults
        to ``prng.prng_key(seed)``.

        ``error_fn``: ``"theory"`` / ``"probe"`` / callable / None (see
        :mod:`repro_torch.runtime.tasks`); combined with ``config.target_error``
        it enables early stop. ``least_norm=True`` routes the §V right-sketch
        worker (n < d). ``save_events`` dumps the job's JSONL event log to that
        path. ``backend`` and ``deadline`` replace the server's for this job.
        """
        if key is None:
            key = prng.prng_key(seed)
        if least_norm:
            compute = rt_tasks.make_least_norm_compute(spec, key, A, b, device=self.device)
        else:
            compute = rt_tasks.make_sketch_solve_compute(spec, key, A, b, reg=reg, method=method, device=self.device)
        err = rt_tasks.resolve_error_fn(error_fn, spec, key, A, b, probe_rows=probe_rows, device=self.device)

        backend = self.backend if backend is None else backend
        engine = ServerlessEngine(compute, self.latency, self.config, backend=backend,
                                  deadline=self.deadline if deadline is None else deadline)
        task_list = [(w, r) for r in range(rounds) for w in range(q)]
        result = engine.run(tasks=task_list, error_fn=err)
        if save_events is not None:
            result.events.to_jsonl(save_events)

        job = SolveJob(
            job_id=len(self.jobs),
            spec=spec,
            q=int(q),
            backend=_backend_name(backend),
            result=result,
            summary=result.summary(deadline=self.config.deadline_s),
        )
        self.jobs.append(job)
        return job

    # ------------------------------------------------------------------ telemetry

    def telemetry(self) -> Dict:
        """Aggregate report over every admitted job (the serving dashboard dict)."""
        n = len(self.jobs)
        agg: Dict = {"jobs": n, "backend": _backend_name(self.backend)}
        if n == 0:
            return agg
        for k in ("retries", "timeouts", "drops", "cancelled", "dispatched"):
            agg[k] = int(sum(j.summary.get(k, 0) for j in self.jobs))
        agg["effective_q_mean"] = float(np.mean([j.summary["effective_q"] for j in self.jobs]))
        agg["sim_makespan_s_mean"] = float(np.mean([j.summary["sim_makespan_s"] for j in self.jobs]))
        agg["stopped_early"] = int(sum(bool(j.summary.get("stopped_early")) for j in self.jobs))
        agg["per_job"] = [
            {
                "job_id": j.job_id,
                "q": j.q,
                "effective_q": j.summary["effective_q"],
                "retries": j.summary["retries"],
                "timeouts": j.summary["timeouts"],
                "drops": j.summary["drops"],
                "sim_makespan_s": j.summary["sim_makespan_s"],
                "final_error": j.summary.get("final_error"),
            }
            for j in self.jobs
        ]
        return agg
