"""Master-side averaging (Algorithm 1) with straggler masks (PyTorch port).

Because workers are i.i.d., the master may average whatever subset arrived: the
estimator is Algorithm 1 with the realized worker count q' ≤ q.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

def _guard_empty(avg: torch.Tensor, den: torch.Tensor, on_empty: str) -> torch.Tensor:
    """Define x̄ when no worker arrived (den == 0): ``"nan"`` poisons it,
    ``"zero"`` keeps x̄ = 0."""
    if on_empty == "zero":
        return avg
    if on_empty == "nan":
        return torch.where(den > 0, avg, torch.full_like(avg, float("nan")))
    raise ValueError(f"on_empty must be 'nan' or 'zero', got {on_empty!r}")


def masked_average(
    xs: torch.Tensor, mask: Optional[torch.Tensor] = None, *, on_empty: str = "nan"
) -> torch.Tensor:
    """Mean over axis 0 of xs (q, ...), counting only mask==1 rows.

    An all-zero mask yields NaN by default (``on_empty``, see :func:`_guard_empty`).
    """
    if mask is None:
        return xs.mean(dim=0)
    mask = torch.as_tensor(mask).to(device=xs.device, dtype=xs.dtype)
    w = mask.reshape((xs.shape[0],) + (1,) * (xs.ndim - 1))
    den = mask.sum()
    avg = (xs * w).sum(dim=0) / torch.clamp(den, min=1.0)
    return _guard_empty(avg, den, on_empty)


@dataclasses.dataclass
class StreamingAverage:
    """Incremental master: absorb worker outputs as they arrive (serverless mode)."""

    mean: torch.Tensor
    count: torch.Tensor

    @classmethod
    def init(cls, d: int, dtype=torch.float32, device=None) -> "StreamingAverage":
        return cls(
            mean=torch.zeros((d,), dtype=dtype, device=device),
            count=torch.zeros((), dtype=dtype, device=device),
        )

    def update(self, x: torch.Tensor) -> "StreamingAverage":
        c = self.count + 1.0
        return StreamingAverage(mean=self.mean + (x - self.mean) / c, count=c)


def _quantile_linear(t: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(t, q)`` of a float32 vector (jax's default "linear"), in
    jax's float32 arithmetic: position q·(n − 1), its floor and ceiling, and the
    value low·(1 − w) + high·w, w the position's fraction, the first product
    added to the second with one rounding (XLA's CPU backend fuses it)."""
    vals = torch.sort(t).values
    n = vals.shape[0]
    pos = torch.tensor(np.float32(q) * np.float32(n - 1), dtype=torch.float32)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    lv = vals[int(low.clamp(0, n - 1))]
    hv = vals[int(high.clamp(0, n - 1))]
    return prng._fma(hv, hw.to(t.device), lv * lw.to(t.device))


def simulate_straggler_mask(key: torch.Tensor, q: int, *, drop_prob: float = 0.0,
                            deadline_quantile: float = 1.0, device=None) -> torch.Tensor:
    """Which of q workers made the deadline: a float mask (q,), 1.0 = arrived.

    ``drop_prob`` models hard failures (a worker never returns), a Bernoulli draw;
    ``deadline_quantile`` a latency cutoff: runtimes ~ LogNormal and only those at
    or below their ``deadline_quantile`` quantile count. The draws are the
    reference's (``kd, kt = split(key)``, ``bernoulli(kd, 1 − drop_prob)``,
    ``lognormal(kt)``, ``jnp.quantile``), made on ``device`` (default CUDA, as
    every entry point); the mask is bitwise the reference's, since it depends
    only on the order of the runtimes and on the Bernoulli draw."""
    dev = resolve_device(device)
    halves = prng.split(key)
    alive = prng.bernoulli(halves[0], 1.0 - drop_prob, (q,), device=dev)
    if deadline_quantile >= 1.0:
        return alive.to(torch.float32)
    t = prng.lognormal(halves[1], (q,), device=dev)
    cutoff = _quantile_linear(t, deadline_quantile)
    return (alive & (t <= cutoff)).to(torch.float32)
