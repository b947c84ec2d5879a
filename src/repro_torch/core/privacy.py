"""Privacy accounting for distributed sketching (paper §III-A, Eq. 5); the
port's own copy of ``repro.core.privacy`` (pure Python).

When the master sketches locally and ships only ``(S_kA, S_kb)``, the information a
worker (or an eavesdropper on the worker link) sees about A is bounded by

    I(S_kA; A) / (nd)  ≤  (m/n) · log(2πeγ²)        [nats per matrix entry]

for A drawn entrywise from any distribution with variance γ². The framework exposes
this as an *accountant*: every sketched shipment registers (m, n, γ) and the report
aggregates the per-entry leakage across workers/rounds (mutual information is additive
across independent sketches of the same data in the worst case).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List


def mi_per_entry_bound(m: int, n: int, gamma: float = 1.0) -> float:
    """Eq. (5): nats of mutual information per entry of A leaked by one sketch."""
    if m <= 0 or n <= 0:
        raise ValueError("m, n must be positive")
    return (m / n) * math.log(2.0 * math.pi * math.e * gamma * gamma)


def sketch_dim_for_privacy(n: int, budget_nats_per_entry: float, gamma: float = 1.0) -> int:
    """Largest sketch size m whose Eq.-(5) bound stays within the budget."""
    denom = math.log(2.0 * math.pi * math.e * gamma * gamma)
    return max(1, int(budget_nats_per_entry * n / denom))


@dataclasses.dataclass
class SketchDisclosure:
    m: int
    n: int
    gamma: float
    tag: str = ""

    @property
    def per_entry_nats(self) -> float:
        return mi_per_entry_bound(self.m, self.n, self.gamma)


@dataclasses.dataclass
class PrivacyAccountant:
    """Aggregates worst-case MI leakage across all sketched shipments of a dataset.

    Independent sketches S_1..S_q of the same A compose additively in the worst case:
    I((S_1A,...,S_qA); A) ≤ Σ_k I(S_kA; A) — equivalently one tall sketch with q·m rows.
    """

    disclosures: List[SketchDisclosure] = dataclasses.field(default_factory=list)

    def record(self, m: int, n: int, gamma: float = 1.0, tag: str = "") -> SketchDisclosure:
        d = SketchDisclosure(m=m, n=n, gamma=gamma, tag=tag)
        self.disclosures.append(d)
        return d

    @property
    def total_per_entry_nats(self) -> float:
        return sum(d.per_entry_nats for d in self.disclosures)

    def report(self) -> str:
        lines = ["privacy accountant (Eq. 5 worst-case MI, nats/entry):"]
        for d in self.disclosures:
            lines.append(f"  [{d.tag or 'sketch'}] m={d.m} n={d.n} γ={d.gamma:g} -> {d.per_entry_nats:.3e}")
        lines.append(f"  TOTAL: {self.total_per_entry_nats:.3e}")
        return "\n".join(lines)
