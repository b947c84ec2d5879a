"""Straggler policies and worker heartbeats: the systems contract behind the paper's claims.

Port of ``repro.distributed.fault_tolerance``: ``StragglerPolicy``,
``HeartbeatMonitor`` and ``elastic_restore`` (a checkpoint onto a device mesh
of any shape, each rank reading only its own shards).

  * ``StragglerPolicy``  — deadline-based masks for any averaged quantity. The
    mask is drawn from the key ``fold_in(prng_key(seed), step)``, bitwise the
    reference's (``averaging.simulate_straggler_mask``). Policies adapt onto the
    runtime engine's latency layer via :meth:`StragglerPolicy.to_latency_model`,
    so one straggler description drives both the synchronous mask simulation and
    the event-driven execution.
  * ``HeartbeatMonitor`` — records per-step arrival times, derives masks, and
    reports straggler statistics (the quantity Fig. 1's run-time captions measure).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from repro_torch.checkpoint.store import restore_checkpoint
from repro_torch.core.averaging import simulate_straggler_mask
from repro_torch.distributed import sharding
from repro_torch.utils import prng


@dataclasses.dataclass
class StragglerPolicy:
    """How the master decides which workers count for this step's average."""

    drop_prob: float = 0.0           # hard failures (worker never reports)
    deadline_quantile: float = 1.0   # keep only the fastest fraction
    seed: int = 0

    def mask_for_step(self, step: int, q: int, *, device=None) -> torch.Tensor:
        """The (q,) float mask of step ``step``, drawn on ``device`` (``None``
        means CUDA, raising when absent; pass ``"cpu"`` for the CPU)."""
        key = prng.fold_in(prng.prng_key(self.seed), step)
        return simulate_straggler_mask(
            key, q, drop_prob=self.drop_prob, deadline_quantile=self.deadline_quantile, device=device
        )

    def to_latency_model(self, *, mean_s: float = 1.0, sigma: float = 0.35):
        """The equivalent :class:`repro_torch.runtime.latency.LatencyModel`: lognormal
        runtimes (median ``mean_s``) with ``drop_prob`` hard failures layered on.
        Feed :meth:`deadline_for` to the engine to reproduce ``deadline_quantile``
        as a wall-clock cutoff instead of an order statistic."""
        from repro_torch.runtime.latency import DropLatency, LognormalLatency

        inner = LognormalLatency(seed=self.seed, mean_s=mean_s, sigma=sigma)
        return DropLatency(seed=self.seed, inner=inner, drop_prob=self.drop_prob)

    def deadline_for(self, *, mean_s: float = 1.0, sigma: float = 0.35) -> float:
        """The latency cutoff at which a lognormal wave keeps ~``deadline_quantile``
        of its workers (math.inf when the policy keeps everyone)."""
        if self.deadline_quantile >= 1.0:
            return math.inf
        from repro_torch.runtime.latency import LognormalLatency

        return LognormalLatency(mean_s=mean_s, sigma=sigma).quantile(self.deadline_quantile)

    def to_deadline_policy(self, *, mean_s: float = 1.0, sigma: float = 0.35, adaptive: bool = False):
        """The engine-side :class:`~repro_torch.runtime.engine.DeadlinePolicy`
        equivalent of ``deadline_quantile``: a static cutoff at the lognormal
        quantile, or, with ``adaptive=True``, an
        :class:`~repro_torch.runtime.engine.AdaptiveDeadline` warm-started there
        that keeps targeting the same quantile from the *observed* telemetry stream."""
        from repro_torch.runtime.engine import AdaptiveDeadline, StaticDeadline

        cutoff = self.deadline_for(mean_s=mean_s, sigma=sigma)
        if not adaptive:
            return StaticDeadline(deadline_s=cutoff)
        warmup = cutoff if math.isfinite(cutoff) else 4.0 * mean_s
        quantile = self.deadline_quantile if self.deadline_quantile < 1.0 else 0.95
        return AdaptiveDeadline(warmup_s=warmup, quantile=quantile)


class HeartbeatMonitor:
    """Tracks simulated worker arrival times; produces masks and reports.

    The runtime engine's telemetry subsumes this report
    (``EventLog.heartbeat_report`` replays an engine run into a monitor), so the
    schema here, with the p50 / timeout / retry extensions, is the one summary
    format shared by synchronous steps and asynchronous engine runs.
    """

    def __init__(self, q: int, *, deadline: float):
        self.q = q
        self.deadline = deadline
        self.arrivals: List[np.ndarray] = []
        self.timeouts = 0
        self.retries = 0

    def record_step(self, runtimes: np.ndarray) -> np.ndarray:
        """runtimes: (q,) seconds. Returns the 0/1 mask of on-time workers."""
        self.arrivals.append(runtimes)
        return (runtimes <= self.deadline).astype(np.float32)

    def record_timeout(self, count: int = 1) -> None:
        """A worker blew its deadline (engine ``timeout`` events)."""
        self.timeouts += int(count)

    def record_retry(self, count: int = 1) -> None:
        """A timed-out task was resubmitted with a fresh sketch (``retry`` events)."""
        self.retries += int(count)

    def report(self) -> Dict[str, float]:
        if not self.arrivals:
            return {}
        r = np.stack(self.arrivals)
        finite = r[np.isfinite(r)]
        on_time = (r <= self.deadline).mean()
        return {
            "steps": float(r.shape[0]),
            "mean_runtime": float(finite.mean()) if finite.size else float("inf"),
            "p50_runtime": float(np.quantile(finite, 0.50)) if finite.size else float("inf"),
            "p95_runtime": float(np.quantile(finite, 0.95)) if finite.size else float("inf"),
            "on_time_fraction": float(on_time),
            "effective_q": float(on_time * self.q),
            "timeouts": float(self.timeouts),
            "retries": float(self.retries),
        }


def elastic_restore(directory: str, step: int, like, mesh, pspecs):
    """Restore a checkpoint onto ``mesh`` (any shape or size: an elastic
    rescale). ``like``: the checkpoint's tree (``train.state.checkpoint_tree``
    of ``train_state_shapes``, for instance); ``pspecs``: its specs as nested
    dicts (``train_state_pspecs``). Every leaf comes back a DTensor placed by
    its spec (``sharding.to_placements``), each rank having read only its own
    slice of the leaf's file; placements that do not fit raise."""
    placements = sharding.map_specs(lambda s: sharding.to_placements(s, mesh), pspecs)
    return restore_checkpoint(directory, step, like, mesh=mesh, placements=placements)
