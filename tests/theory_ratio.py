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

Other data for Algorithm 1's ratio (the same kinds and columns):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/theory_ratio.py --student-t DF N D M Q SEED[,SEED...] [KIND,...]
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/theory_ratio.py --emnist N M Q SEED[,SEED...] [KIND,...]

``--student-t`` draws the port's ``student_t_regression(seed, N, D, df=DF,
noise=0.1)`` (Fig. 3a's data at DF = 1.5) and also prints, per seed and kind,
the float32 floor: worker 0's fp32 x̂ against a float64 solve of the same
(G, c) in rel_err terms. ``--emnist`` draws ``emnist_like(seed, N + 3N/20)`` (d = 784,
47 one-hot targets, Fig. 2's data), trains on the first N rows and measures
(f(X̄) − f(X*))/f(X*) with f(X) = ‖AX − B‖²_F over Theorem 1, also printing
the test accuracy of X̄ and X* on the last 3N/20 rows (one call, so the test
rows share the training rows' class templates).

Row-sharded workers (the smoke's ``row_sharded_fig3a_*`` gates): worker w of Q
sketches only its own rows [w·N/Q, (w+1)·N/Q) of A and b (the reference's
``solve.sketch_and_solve`` on (A_w, b_w) with ``worker_key(PRNGKey(seed), w)``,
the composition the port's ``row_sharded=True`` follows) and rel_err of the
average on all of A is divided by Theorem 1 at Q. This local-block estimator is
not Theorem 1's; on the planted Gaussian data it predicts about the same error
(each worker's sketch error on its block, plus the spread of the blocks' own
least-squares solutions around the global one, a term about q²d(m−d−1)/n² of
the first):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/theory_ratio.py --row-sharded N D M Q SEED[,SEED...] [KIND,...]

IHS's calibration (the smoke's ``ihs_fig3a_gaussian`` gate): the reference's
``ihs_trace`` with a Gaussian sketch of M rows on the planted Gaussian data,
rel_err after each of ITERS steps, beside Theorem 1 at Q workers:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/theory_ratio.py --ihs N D M ITERS Q SEED[,SEED...]
"""
from __future__ import annotations

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import averaging, ihs, operators, sketches, solve, theory
from repro.utils import prng
from repro_torch.data import regression

FAMILIES = ("gaussian", "srht", "sjlt", "uniform", "leverage", "hybrid_gaussian",
            "hybrid_rademacher", "hybrid_sjlt", "hybrid_srht")
LEAST_NORM_KINDS = ("gaussian", "rademacher", "srht", "sjlt", "uniform", "uniform_rep", "leverage",
                    "hybrid_gaussian", "hybrid_rademacher", "hybrid_sjlt", "hybrid_srht")
SJLT_S = 20
M_PRIME_PER_M = 10  # FIG3A: m′ = 25,000 for m = 2,500
WORKER_CHUNK = 8  # worker keys per reference gram_batched call


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


def gaussian_data(seed: int, n: int, d: int):
    return regression.gaussian_regression(seed, n, d, device="cpu")[:2]


def ratios(n: int, d: int, m: int, q: int, seeds, kinds=FAMILIES, data=gaussian_data, floor: dict | None = None,
           test=None, accuracy: dict | None = None) -> dict:
    """{kind: [rel_err / Theorem 1 for each seed]}, rel_err = (f(x̄) − f*)/f* with
    f the squared (Frobenius) residual of ``data(seed, n, d)`` (b may be (n, k)).
    With ``floor``, also {kind: [worker 0's float32 x̂ against a float64 solve
    of its own (G, c), in rel_err terms]}; with ``test(seed)`` -> (A, B, labels)
    and ``accuracy``, {kind: [(accuracy of x̄, of x*)]}."""
    pred = theory.gaussian_averaged_error(m, d, q)
    out: dict = {kind: [] for kind in kinds}
    for seed in seeds:
        A, b = data(seed, n, d)
        A64, b64 = A.double().numpy(), b.double().numpy()
        xstar, *_ = np.linalg.lstsq(A64, b64, rcond=None)
        fstar = float(np.sum((A64 @ xstar - b64) ** 2))
        cost = lambda x: (float(np.sum((A64 @ x - b64) ** 2)) - fstar) / fstar
        for kind in kinds:
            keys = prng.worker_keys(jax.random.PRNGKey(seed), q)
            spec = spec_for(kind, m)
            Aj, bj = jnp.asarray(A.numpy()), jnp.asarray(b.numpy())
            parts = [operators.gram_batched(spec, keys[w : w + WORKER_CHUNK], Aj, bj)
                     for w in range(0, q, WORKER_CHUNK)]  # the reference's batch of q workers can outgrow the host
            Gs, cs = (jnp.concatenate([p[i] for p in parts]) for i in (0, 1))
            xs = jax.vmap(solve.lstsq_gram)(Gs, cs)
            xbar = np.asarray(averaging.masked_average(xs, None), np.float64)
            out[kind].append(cost(xbar) / pred)
            if floor is not None:
                x64 = np.linalg.solve(np.asarray(Gs[0], np.float64), np.asarray(cs[0], np.float64))
                floor.setdefault(kind, []).append(abs(cost(np.asarray(xs[0], np.float64)) - cost(x64)))
            if accuracy is not None:
                At, Bt, labels = test(seed)
                acc = lambda x: float(np.mean(np.argmax(At @ x, axis=1) == labels))
                accuracy.setdefault(kind, []).append((acc(xbar), acc(xstar)))
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


def row_sharded_ratios(n: int, d: int, m: int, q: int, seeds, kinds) -> dict:
    """{kind: [rel_err / Theorem 1 of the q local-block workers' average, each seed]}."""
    pred = theory.gaussian_averaged_error(m, d, q)
    out: dict = {kind: [] for kind in kinds}
    blk = n // q
    for seed in seeds:
        A, b = gaussian_data(seed, n, d)
        A64, b64 = A.double().numpy(), b.double().numpy()
        xstar, *_ = np.linalg.lstsq(A64, b64, rcond=None)
        fstar = float(np.sum((A64 @ xstar - b64) ** 2))
        An, bn = A.numpy(), b.numpy()
        for kind in kinds:
            one = jax.jit(functools.partial(solve.sketch_and_solve, spec_for(kind, m)))
            xs = [np.asarray(one(prng.worker_key(jax.random.PRNGKey(seed), w), jnp.asarray(An[w * blk:(w + 1) * blk]),
                                 jnp.asarray(bn[w * blk:(w + 1) * blk])), np.float64) for w in range(q)]
            xbar = np.mean(xs, axis=0)
            out[kind].append((float(np.sum((A64 @ xbar - b64) ** 2)) - fstar) / fstar / pred)
    return out


def _report(got: dict, **shape) -> None:
    for kind, vals in got.items():
        print(json.dumps({"kind": kind, **shape, "ratios": vals, "mean": float(np.mean(vals)),
                          "min": float(np.min(vals)), "max": float(np.max(vals))}))


def main(argv) -> int:
    if argv[:1] == ["--student-t"]:
        df = float(argv[1])
        n, d, m, q = (int(a) for a in argv[2:6])
        seeds = [int(x) for x in argv[6].split(",")]
        kinds = tuple(argv[7].split(",")) if len(argv) > 7 else FAMILIES
        data = lambda seed, n, d: regression.student_t_regression(seed, n, d, df=df, noise=0.1, device="cpu")[:2]
        floor: dict = {}
        _report(ratios(n, d, m, q, seeds, kinds, data=data, floor=floor), data="student_t", df=df, n=n, d=d, m=m,
                q=q, seeds=seeds)
        for kind, vals in floor.items():
            print(json.dumps({"kind": kind, "fp32_floor_rel_err": vals, "theorem1": theory.gaussian_averaged_error(m, d, q),
                              "lemma1": theory.gaussian_single_error(m, d)}))
        return 0
    if argv[:1] == ["--ihs"]:
        n, d, m, iters, q = (int(a) for a in argv[1:6])
        for seed in (int(x) for x in argv[6].split(",")):
            A, b = gaussian_data(seed, n, d)
            A64, b64 = A.double().numpy(), b.double().numpy()
            xstar, *_ = np.linalg.lstsq(A64, b64, rcond=None)
            fstar = float(np.sum((A64 @ xstar - b64) ** 2))
            trace = ihs.ihs_trace(sketches.SketchSpec("gaussian", m), jax.random.PRNGKey(seed),
                                  jnp.asarray(A.numpy()), jnp.asarray(b.numpy()), iters=iters)
            rel = [(float(np.sum((A64 @ np.asarray(x, np.float64) - b64) ** 2)) - fstar) / fstar for x in trace]
            print(json.dumps({"mode": "ihs", "n": n, "d": d, "m": m, "seed": seed, "rel_err": rel,
                              "step_cuts": [rel[t] / rel[t + 1] for t in range(len(rel) - 1)],
                              "theorem1_q": q, "theorem1": theory.gaussian_averaged_error(m, d, q)}))
        return 0
    if argv[:1] == ["--emnist"]:
        n, m, q = (int(a) for a in argv[1:4])
        seeds = [int(x) for x in argv[4].split(",")]
        kinds = tuple(argv[5].split(",")) if len(argv) > 5 else ("sjlt", "uniform")
        n_test = n * 3 // 20  # Fig. 2's 30,000 test rows to 200,000 training rows
        drawn = {}

        def draw(seed):  # training and test rows from one call: the same class templates
            if seed not in drawn:
                drawn.clear()
                drawn[seed] = regression.emnist_like(seed, n + n_test, device="cpu")
            return drawn[seed]

        data = lambda seed, n, d: (draw(seed)[0][:n], draw(seed)[1][:n])

        def test(seed):
            A, _, meta = draw(seed)
            return A[n:].double().numpy(), None, meta["labels"][n:].numpy()

        acc: dict = {}
        _report(ratios(n, 784, m, q, seeds, kinds, data=data, test=test, accuracy=acc), data="emnist", n=n, d=784,
                m=m, q=q, seeds=seeds)
        for kind, vals in acc.items():
            print(json.dumps({"kind": kind, "test_accuracy_xbar_xstar": vals}))
        return 0
    if argv[:1] == ["--row-sharded"]:
        n, d, m, q = (int(a) for a in argv[1:5])
        seeds = [int(x) for x in argv[5].split(",")]
        kinds = tuple(argv[6].split(",")) if len(argv) > 6 else ("gaussian", "srht", "sjlt")
        _report(row_sharded_ratios(n, d, m, q, seeds, kinds), mode="row_sharded", n=n, d=d, m=m, q=q, seeds=seeds)
        return 0
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
