"""Serving engines of the port: batched LM decode and sketch-solve job admission.

Port of ``repro.serve.engine``. Two serving surfaces share this module:

  * :class:`Engine`, the batched LM engine: a flash prefill of the left-padded
    prompts, then step-synchronized batched decode against a KV cache allocated
    once at ``max_len`` and written in place; EOS is mask-based (finished rows
    keep decoding into a dead slot, outputs are trimmed on the host). Sampling
    is greedy, or jax's categorical at temperature T > 0 (argmax of logits/T plus
    gumbel noise under the reference's key schedule), bitwise the reference's on
    the same logits.
  * :class:`SolveServer`, the *sketch-least-squares* front end: a job-admission
    API (:meth:`SolveServer.submit_solve`) that routes regression jobs through
    the asynchronous :class:`~repro_torch.runtime.engine.ServerlessEngine`
    (streaming Welford averages, deadline→backoff→retry, adaptive deadlines
    optional, early stop, and a per-job telemetry summary) on any executor
    backend (``inline``/``thread``/``process``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.runtime import tasks as rt_tasks
from repro_torch.runtime.engine import RuntimeConfig, RuntimeResult, ServerlessEngine
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


def sample_token(key: torch.Tensor, logits: torch.Tensor, temperature: float = 0.0) -> torch.Tensor:
    """(B, V) float32 logits -> (B,) int64 token ids. temperature <= 0 is greedy;
    else ``jax.random.categorical(key, logits / T)``: argmax of jax's gumbel
    noise (B, V) under ``key`` plus logits / T, drawn on the logits' device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    g = prng.gumbel(key, tuple(logits.shape), device=logits.device)
    return torch.argmax(g + logits / temperature, dim=-1)


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 256          # prompt + generation budget (cache allocation)
    temperature: float = 0.0
    eos_id: int = -1            # -1: never stop early
    seed: int = 0


class Engine:
    """Batched generation with an :class:`~repro_torch.models.lm.LM` on ``device``
    (``None`` means CUDA, raising when absent; ``"cpu"`` for the CPU). The model
    must already be there: it is used as given, never moved (``ValueError``).
    ``plan`` sets the prefill's attention key chunk: its float32 score tiles
    hold B·S·H·chunk entries, and another chunk changes only the order of the
    online softmax's float32 sums.

    Prompts are left-padded with token 0 to the longest in the batch, and the
    padding is not masked: it is attended to, and an SSM's recurrence (Mamba,
    the hybrid's Mamba branch) runs through it as through ordinary tokens,
    as in the reference. ``generate``'s ``frames`` (an encoder-decoder's, (N,
    enc_seq, d)) and ``patches`` (a VLM's, (N, P, vit_dim)) are the prompts'
    frontend stubs; each batch of ``max_batch`` prompts takes their first B
    rows, as the reference does. The patches take the place of the first P
    positions of the left-padded rectangle: for a prompt shorter than the
    longest, those are its padding first, as in the reference."""

    def __init__(self, cfg: ArchConfig, params: lm.LM, sc: ServeConfig, *, device=None,
                 plan: Optional[lm.ExecPlan] = None):
        self.device = resolve_device(device)
        held = next(params.parameters()).device
        if held.type != self.device.type or self.device.index not in (None, held.index):
            raise ValueError(f"the model is on {held}, the engine on {self.device}: build the model there")
        self.cfg = cfg
        self.params = params
        self.sc = sc
        self.plan = plan or lm.ExecPlan()

    def _mask_pad(self, logits: torch.Tensor) -> torch.Tensor:
        """Padded-vocab ids (the table's padding to a multiple of 256) are never sampled."""
        logits[..., self.cfg.vocab_size :] = -1e30
        return logits

    def _prefill(self, tokens: torch.Tensor, frames: Optional[torch.Tensor] = None,
                 patches: Optional[torch.Tensor] = None):
        batch = {"tokens": tokens}
        if patches is not None:
            batch["patches"] = patches
        if frames is not None:
            batch["frames"] = frames
        logits, cache = lm.batched_prefill(self.params, self.cfg, batch, cache_len=self.sc.max_len, plan=self.plan)
        return self._mask_pad(logits), cache

    def _decode(self, tok: torch.Tensor, cache, pos: int, key: Optional[torch.Tensor]):
        logits, cache = lm.decode_step(self.params, self.cfg, tok, cache, pos)
        logits = self._mask_pad(logits)
        return sample_token(key, logits, self.sc.temperature), logits, cache

    # ------------------------------------------------------------------ API
    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]], *, max_new_tokens: int = 32,
                 frames: Optional[torch.Tensor] = None, patches: Optional[torch.Tensor] = None) -> List[List[int]]:
        """Generate continuations, ``max_batch`` prompts at a time (step-synchronized);
        ``frames`` and ``patches`` as in the class's notes."""
        out: List[List[int]] = []
        for i in range(0, len(prompts), self.sc.max_batch):
            out.extend(self._generate_batch(prompts[i : i + self.sc.max_batch], max_new_tokens, frames, patches))
        return out

    def _generate_batch(self, prompts, max_new_tokens: int, frames=None, patches=None) -> List[List[int]]:
        B = len(prompts)
        S = max(len(p) for p in prompts)
        if S + max_new_tokens > self.sc.max_len:
            raise ValueError(f"prompt {S} + {max_new_tokens} new tokens exceed ServeConfig.max_len "
                             f"{self.sc.max_len}")
        # Left-pad to a rectangle with token 0: the padded prefix is ordinary
        # tokens, masked out of nothing (the fixed-shape serving trade-off); an
        # SSM's recurrence runs through them like any other tokens.
        toks = np.zeros((B, S), np.int64)
        for r, p in enumerate(prompts):
            toks[r, S - len(p) :] = np.asarray(p, np.int64)
        stubs = [None if t is None else t[:B].to(self.device) for t in (frames, patches)]
        logits, cache = self._prefill(torch.from_numpy(toks).to(self.device), *stubs)
        greedy = self.sc.temperature <= 0.0
        key = prng.prng_key(self.sc.seed)
        tok = sample_token(key, logits, self.sc.temperature)
        generated = [tok]
        for t in range(1, max_new_tokens):
            sub = None
            if not greedy:  # greedy draws nothing: the key schedule matters only when sampling
                key, sub = prng.split(key)
            tok, _, cache = self._decode(tok, cache, S + t - 1, sub)
            generated.append(tok)
        gen = torch.stack(generated, dim=1).cpu().numpy()  # (B, T)
        outs: List[List[int]] = []
        for r in range(B):
            row = gen[r].tolist()
            if self.sc.eos_id >= 0 and self.sc.eos_id in row:
                row = row[: row.index(self.sc.eos_id) + 1]
            outs.append(row)
        return outs


# ===================================================================== solve serving


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
