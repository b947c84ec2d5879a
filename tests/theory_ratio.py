"""rel_err / Theorem 1 of the JAX reference's Algorithm 1, per sketch kind.

Theorem 1's d/(q(m−d−1)) is exact for the Gaussian sketch only. This measures,
with the reference package (master-sketch mode: ``operators.gram_batched``, a
Cholesky solve per worker, the plain average; no kernels) on the planted
Gaussian data ``chip_smoke.py`` uses (the port's ``gaussian_regression``, drawn
on the CPU), what ratio each kind gives at a cut of FIG3A: the Gaussian, the
SRHT, the SJLT (s = 20), uniform sampling without replacement (Fig. 3's
"sampling"), leverage-score sampling, and the hybrid (m′ = 10·m uniformly
sampled rows, FIG3A's m′/m) with each inner kind. Worker mode draws the same
sketches, so its ratios are the same. ``chip_smoke.py`` gates its paths on a
band around these ratios (PERF.md §6). Not collected by pytest; run from the
root of the repository:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/theory_ratio.py N D M Q SEED[,SEED...] [KIND,...]

e.g. ``50000 25 250 200 1,2,3,4`` and ``100000 100 1000 50 1,2,3,4,5,6``. Leverage
sampling draws an (m, n) gumbel array per worker: keep q·m·n small for it.
"""
from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import averaging, operators, sketches, solve, theory
from repro.utils import prng
from repro_torch.data import regression

FAMILIES = ("gaussian", "srht", "sjlt", "uniform", "leverage", "hybrid_gaussian",
            "hybrid_rademacher", "hybrid_sjlt", "hybrid_srht")
SJLT_S = 20
M_PRIME_PER_M = 10  # FIG3A: m′ = 25,000 for m = 2,500


def spec_for(kind: str, m: int) -> sketches.SketchSpec:
    """The reference's spec for a FAMILIES entry at sketch size m."""
    if kind == "uniform":
        return sketches.SketchSpec("uniform", m, replacement=False)
    if kind.startswith("hybrid_"):
        return sketches.SketchSpec("hybrid", m, m_prime=M_PRIME_PER_M * m, inner=kind[7:], s=SJLT_S)
    return sketches.SketchSpec(kind, m, s=SJLT_S)


def ratios(n: int, d: int, m: int, q: int, seeds, kinds=FAMILIES) -> dict:
    """{kind: [rel_err / Theorem 1 for each seed]}."""
    pred = theory.gaussian_averaged_error(m, d, q)
    out: dict = {kind: [] for kind in kinds}
    for seed in seeds:
        A, b, _ = regression.gaussian_regression(seed, n, d, device="cpu")
        A64, b64 = A.double().numpy(), b.double().numpy()
        xstar, *_ = np.linalg.lstsq(A64, b64, rcond=None)
        fstar = float(np.sum((A64 @ xstar - b64) ** 2))
        for kind in kinds:
            keys = prng.worker_keys(jax.random.PRNGKey(seed), q)
            spec = spec_for(kind, m)
            Gs, cs = operators.gram_batched(spec, keys, jnp.asarray(A.numpy()), jnp.asarray(b.numpy()))
            xbar = np.asarray(averaging.masked_average(jax.vmap(solve.lstsq_gram)(Gs, cs), None), np.float64)
            rel = (float(np.sum((A64 @ xbar - b64) ** 2)) - fstar) / fstar
            out[kind].append(rel / pred)
    return out


def main(argv) -> int:
    n, d, m, q = (int(a) for a in argv[:4])
    seeds = [int(x) for x in argv[4].split(",")]
    kinds = tuple(argv[5].split(",")) if len(argv) > 5 else FAMILIES
    got = ratios(n, d, m, q, seeds, kinds)
    for kind, vals in got.items():
        print(json.dumps({"kind": kind, "n": n, "d": d, "m": m, "q": q, "seeds": seeds,
                          "ratios": vals, "mean": float(np.mean(vals)),
                          "min": float(np.min(vals)), "max": float(np.max(vals))}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
