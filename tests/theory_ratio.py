"""rel_err / Theorem 1 of the JAX reference's Algorithm 1, and ‖x̄ − x*‖²/‖x*‖² /
(Lemma 7 / q) of its §V right-sketch least-norm average, per sketch kind.

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

The least-norm mode (n < d) averages the reference's ``solve.sketch_least_norm``
over the q worker keys ``worker_key(PRNGKey(seed), w)`` on A ~ N(0,1)^{n×d},
b ~ N(0, I) (the port's ``gaussian_regression(..., planted=False)`` on the CPU,
the data ``chip_smoke.py`` draws on the card) and divides ‖x̄ − x*‖²/‖x*‖², x* the
float64 least-norm solution, by Lemma 7's (d − n)/(q(m − n − 1)). Lemma 7 is
exact for the Gaussian sketch only; ``chip_smoke.py`` gates its least-norm paths
on bands around these ratios. Kinds: LEAST_NORM_KINDS ("uniform_rep" samples
with replacement, "hybrid_K" takes m′ = M_PRIME rows):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/theory_ratio.py --least-norm N D M M_PRIME Q SEED[,SEED...] [KIND,...]

e.g. ``--least-norm 50 1000 200 500 100 0,1,2,3`` (FIG4A).
"""
from __future__ import annotations

import functools
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
LEAST_NORM_KINDS = ("gaussian", "rademacher", "srht", "sjlt", "uniform", "uniform_rep", "leverage",
                    "hybrid_gaussian", "hybrid_rademacher", "hybrid_sjlt", "hybrid_srht")
SJLT_S = 20
M_PRIME_PER_M = 10  # FIG3A: m′ = 25,000 for m = 2,500


def spec_for(kind: str, m: int, m_prime: int = 0) -> sketches.SketchSpec:
    """The reference's spec for a FAMILIES or LEAST_NORM_KINDS entry at sketch size
    m (a hybrid takes m′ = ``m_prime``, by default M_PRIME_PER_M · m)."""
    if kind == "uniform":
        return sketches.SketchSpec("uniform", m, replacement=False)
    if kind == "uniform_rep":
        return sketches.SketchSpec("uniform", m)
    if kind.startswith("hybrid_"):
        return sketches.SketchSpec("hybrid", m, m_prime=m_prime or M_PRIME_PER_M * m, inner=kind[7:],
                                   s=SJLT_S)
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


def least_norm_ratios(n: int, d: int, m: int, m_prime: int, q: int, seeds,
                      kinds=LEAST_NORM_KINDS) -> dict:
    """{kind: [‖x̄ − x*‖²/‖x*‖² / (Lemma 7 / q) for each seed]}."""
    pred = theory.gaussian_least_norm_error(m, n, d) / q
    out: dict = {kind: [] for kind in kinds}
    for seed in seeds:
        A, b, _ = regression.gaussian_regression(seed, n, d, planted=False, device="cpu")
        A64, b64 = A.double().numpy(), b.double().numpy()
        xstar = A64.T @ np.linalg.solve(A64 @ A64.T, b64)
        Aj, bj = jnp.asarray(A.numpy()), jnp.asarray(b.numpy())
        for kind in kinds:
            one = jax.jit(functools.partial(solve.sketch_least_norm, spec_for(kind, m, m_prime)))
            xs = [np.asarray(one(prng.worker_key(jax.random.PRNGKey(seed), w), Aj, bj), np.float64)
                  for w in range(q)]
            e = np.mean(xs, axis=0) - xstar
            out[kind].append(float(e @ e / (xstar @ xstar)) / pred)
    return out


def _report(got: dict, **shape) -> None:
    for kind, vals in got.items():
        print(json.dumps({"kind": kind, **shape, "ratios": vals, "mean": float(np.mean(vals)),
                          "min": float(np.min(vals)), "max": float(np.max(vals))}))


def main(argv) -> int:
    if argv[:1] == ["--least-norm"]:
        n, d, m, m_prime, q = (int(a) for a in argv[1:6])
        seeds = [int(x) for x in argv[6].split(",")]
        kinds = tuple(argv[7].split(",")) if len(argv) > 7 else LEAST_NORM_KINDS
        _report(least_norm_ratios(n, d, m, m_prime, q, seeds, kinds), mode="least_norm", n=n, d=d,
                m=m, m_prime=m_prime, q=q, seeds=seeds)
        return 0
    n, d, m, q = (int(a) for a in argv[:4])
    seeds = [int(x) for x in argv[4].split(",")]
    kinds = tuple(argv[5].split(",")) if len(argv) > 5 else FAMILIES
    _report(ratios(n, d, m, q, seeds, kinds), n=n, d=d, m=m, q=q, seeds=seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
