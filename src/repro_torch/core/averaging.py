"""Master-side averaging (Algorithm 1) with straggler masks (PyTorch port).

Because workers are i.i.d., the master may average whatever subset arrived: the
estimator is Algorithm 1 with the realized worker count q' ≤ q.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


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
