"""The paper's regression workloads as configurations (``repro.configs.paper_lsq``
counterpart; the port keeps its own copy of what it needs)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RegressionConfig:
    name: str
    n: int
    d: int
    m: int                 # sketch dimension
    m_prime: int = 0       # hybrid first-stage sample size
    q: int = 100           # workers
    sketch: str = "sjlt"
    s: int = 20            # SJLT nonzeros per column (paper's Fig. 2 uses s=20)
    heavy_tail_df: float = 0.0   # student-t degrees of freedom (0 = gaussian data)
    planted: bool = False


# Paper Fig. 1 (airline, n=1.21e8×774, m=5e5, q=100) scaled to container size while
# preserving the ratios m/d ≈ 646 → we keep m/d large and n/m ≈ 242.
FIG1 = RegressionConfig("fig1_airline", n=2_000_000, d=774 // 4, m=8000, m_prime=80_000, q=100)

# Paper Fig. 3a: A ∈ R^{1e7×1e3}, m=1e4, m'=1e5, student-t(1.5), q=200 — the
# reference package's container-sized version of it.
FIG3A = RegressionConfig(
    "fig3a_synth", n=500_000, d=250, m=2500, m_prime=25_000, q=200, heavy_tail_df=1.5, planted=True
)

# Paper Fig. 4a: least-norm, n=50, d=1000, m=200, m'=500.
FIG4A = RegressionConfig("fig4a_leastnorm", n=50, d=1000, m=200, m_prime=500, q=100, sketch="gaussian")
