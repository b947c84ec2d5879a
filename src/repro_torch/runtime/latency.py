"""Seeded latency models: the serverless runtime distribution, injected not measured.

Port of ``repro.runtime.latency``. The paper's experiments run on AWS Lambda,
where worker runtimes are random and heavy-tailed; the whole point of Algorithm 1
is that the master does not wait for the tail. To study that regime
deterministically, the runtime engine never *measures* wall-clock; it *draws*
each task's runtime from a ``LatencyModel``.

Determinism contract: ``sample(worker_id, round_id, attempt)`` is a pure function
of ``(seed, worker_id, round_id, attempt)``: counter-based numpy Philox seeded by
the full coordinate, no global state. The draws are the reference's bit for bit,
so the same seed replays the identical event schedule in both packages, however
the executor interleaves the compute. ``math.inf`` means the invocation never
returns (a hard drop: the lambda was killed).

  * ``LognormalLatency`` — the paper's observed Lambda profile.
  * ``HeavyTailLatency`` — Pareto tail; stragglers arbitrarily late.
  * ``DropLatency``      — wraps another model with hard failures.
  * ``DriftLatency``     — lognormal whose median drifts geometrically with the
    round id (cold starts, queue buildup): the regime adaptive deadlines exist for.
  * ``ConstantLatency``  — degenerate model for tests and synchronous baselines.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.utils import prng


def _rng(seed: int, salt: int, worker_id: int, round_id: int, attempt: int) -> np.random.Generator:
    """Counter-based generator: a pure function of the full task coordinate."""
    ss = np.random.SeedSequence([int(seed), int(salt), int(worker_id), int(round_id), int(attempt)])
    return np.random.Generator(np.random.Philox(ss))


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Base class. Subclasses draw from ``_rng`` so samples are replayable."""

    seed: int = 0

    _SALT = 0x5E12  # distinguishes the latency stream from any other Philox user

    def sample(self, worker_id: int, round_id: int = 0, attempt: int = 0) -> float:
        """Simulated runtime in seconds for one invocation; ``math.inf`` = never."""
        raise NotImplementedError

    def sample_wave(self, q: int, round_id: int = 0, attempt: int = 0) -> np.ndarray:
        """(q,) runtimes for one wave of workers."""
        return np.array([self.sample(w, round_id, attempt) for w in range(q)])

    def mask_for_round(self, q: int, deadline: float, round_id: int = 0) -> np.ndarray:
        """0/1 float mask of workers that would beat ``deadline`` in this round."""
        return (self.sample_wave(q, round_id) <= deadline).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ConstantLatency(LatencyModel):
    value_s: float = 1.0

    def sample(self, worker_id: int, round_id: int = 0, attempt: int = 0) -> float:
        return float(self.value_s)


@dataclasses.dataclass(frozen=True)
class LognormalLatency(LatencyModel):
    """runtime = mean_s · exp(sigma·Z), Z ~ N(0,1) — median ``mean_s``."""

    mean_s: float = 1.0
    sigma: float = 0.35

    def sample(self, worker_id: int, round_id: int = 0, attempt: int = 0) -> float:
        g = _rng(self.seed, self._SALT, worker_id, round_id, attempt)
        return float(self.mean_s * math.exp(self.sigma * g.standard_normal()))

    def quantile(self, p: float) -> float:
        """Closed-form latency quantile, e.g. a deadline at the p-th percentile. The
        inverse normal CDF is float32, as the reference's (``prng.xla_ndtri``)."""
        z = float(prng.xla_ndtri(torch.tensor(p, dtype=torch.float32)))
        return float(self.mean_s * math.exp(self.sigma * z))


@dataclasses.dataclass(frozen=True)
class HeavyTailLatency(LatencyModel):
    """runtime = scale_s · (1 + Pareto(alpha)): support [scale_s, ∞), power-law tail."""

    scale_s: float = 1.0
    alpha: float = 1.5

    def sample(self, worker_id: int, round_id: int = 0, attempt: int = 0) -> float:
        g = _rng(self.seed, self._SALT, worker_id, round_id, attempt)
        return float(self.scale_s * (1.0 + g.pareto(self.alpha)))


@dataclasses.dataclass(frozen=True)
class DriftLatency(LatencyModel):
    """Non-stationary lognormal: median ``mean_s · growth^round_id``. With
    ``growth > 1`` later rounds (and every retry, which always carries a fresh,
    larger round id) run slower: a static deadline tuned on round 0 burns its
    whole retry budget, while an :class:`~repro_torch.runtime.engine.AdaptiveDeadline`
    tracks the drift through the telemetry stream."""

    mean_s: float = 1.0
    sigma: float = 0.35
    growth: float = 1.3

    def sample(self, worker_id: int, round_id: int = 0, attempt: int = 0) -> float:
        g = _rng(self.seed, self._SALT, worker_id, round_id, attempt)
        median = self.mean_s * self.growth ** round_id
        return float(median * math.exp(self.sigma * g.standard_normal()))


@dataclasses.dataclass(frozen=True)
class DropLatency(LatencyModel):
    """Hard failures layered on any base model: with prob ``drop_prob`` the task
    never returns (``inf``); otherwise the inner model's draw. The drop coin and the
    inner draw use distinct salts, so wrapping does not perturb the inner stream."""

    inner: LatencyModel = dataclasses.field(default_factory=LognormalLatency)
    drop_prob: float = 0.0

    _DROP_SALT = 0xD409

    def sample(self, worker_id: int, round_id: int = 0, attempt: int = 0) -> float:
        g = _rng(self.seed, self._DROP_SALT, worker_id, round_id, attempt)
        if g.random() < self.drop_prob:
            return math.inf
        return self.inner.sample(worker_id, round_id, attempt)
