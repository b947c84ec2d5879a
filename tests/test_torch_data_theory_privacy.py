"""The port's data generators, FIG1, the theory remainder and the privacy
accountant against the JAX reference, on the CPU.

The generators draw with torch, not jax, so they are checked for the structure
the reference's have (and, where it is cheap, the reference's own draws are
put through the same checks); where a solve or a score is compared, both
packages get the same numpy arrays. Theory and privacy floats: equal to 1e-12
relative; tensor-valued theory: to float32 tolerance (1e-5 relative);
``accuracy``: the same rows right, the share within two float32 ulps.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from repro.configs import paper_lsq as jcfg
from repro.core import privacy as jpriv, theory as jth
from repro.data import regression as jdata
from repro_torch.configs import paper_lsq as tcfg
from repro_torch.core import privacy as tpriv, theory as tth
from repro_torch.data import regression as tdata

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

FLOAT_TOL = 1e-12


def _ks(sample: np.ndarray, cdf) -> float:
    x = np.sort(sample.ravel())
    n = x.size
    F = cdf(x)
    return float(max(np.max(np.arange(1, n + 1) / n - F), np.max(F - np.arange(n) / n)))


# ----------------------------------------------------------------------- data


@pytest.mark.parametrize("df", [1.5, 3.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_student_t_distribution_and_clip(seed, df):
    """Entries follow student-t(df) (Kolmogorov-Smirnov distance under 2/√N, a
    99.9% band) clipped at ±1e3; b = A x + 0.1·ε."""
    A, b, meta = tdata.student_t_regression(seed, 20_000, 10, df=df, device="cpu")
    assert A.shape == (20_000, 10) and b.shape == (20_000,) and meta["x_truth"].shape == (10,)
    assert float(A.abs().max()) <= 1e3
    An = A.numpy().astype(np.float64)
    inside = np.abs(An) < 1e3
    assert _ks(An[inside], scipy.stats.t(df).cdf) < 2 / math.sqrt(inside.sum())
    resid = (b - A @ meta["x_truth"]).numpy()
    assert abs(resid.std() / 0.1 - 1) < 0.05


def test_student_t_reference_draws_pass_the_same_check():
    A, _, _ = jdata.student_t_regression(jax.random.PRNGKey(0), 20_000, 10, df=1.5)
    An = np.asarray(A, np.float64)
    assert float(np.abs(An).max()) <= 1e3
    inside = np.abs(An) < 1e3
    assert _ks(An[inside], scipy.stats.t(1.5).cdf) < 2 / math.sqrt(inside.sum())


@pytest.mark.parametrize("seed", [0, 3])
def test_airline_structure(seed):
    cards = (12, 31, 7, 24, 60)
    A, b, meta = tdata.airline_like(seed, 30_000, device="cpu")
    assert meta["d"] == 136 == A.shape[1] and tuple(A.shape) == (30_000, 136)
    c0 = 0
    for c in cards:
        blk = A[:, c0 : c0 + c]
        assert set(torch.unique(blk).tolist()) <= {0.0, 1.0}
        assert torch.equal(blk.sum(1), torch.ones(30_000))
        freq = blk.mean(0)
        assert float((freq - 1 / c).abs().max()) < 4 * math.sqrt(1 / c / 30_000)
        c0 += c
    num = A[:, c0:].numpy().astype(np.float64)
    assert num.shape[1] == 2 and (num > 0).all()
    assert _ks(np.log(5 * num), scipy.stats.norm.cdf) < 2 / math.sqrt(num.size)
    assert set(torch.unique(b).tolist()) == {0.0, 1.0} and abs(float(b.mean()) - 0.5) < 1e-3
    # The reference's property: each one-hot block sums to the ones vector, so
    # rank = 136 − 5 + 1 = 132 (its every sketched solve is then singular).
    assert int(torch.linalg.matrix_rank(A.double())) == 132


def test_airline_reference_rank_is_132():
    A, b, meta = jdata.airline_like(jax.random.PRNGKey(0), 5_000)
    assert meta["d"] == 136
    assert int(np.linalg.matrix_rank(np.asarray(A, np.float64))) == 132


@pytest.mark.parametrize("seed", [0, 2])
def test_emnist_structure(seed):
    n, classes = 60_000, 47
    A, B, meta = tdata.emnist_like(seed, n, device="cpu")
    labels = meta["labels"]
    assert tuple(A.shape) == (n, 784) and tuple(B.shape) == (n, classes)
    assert torch.equal(B, torch.nn.functional.one_hot(labels, classes).float())
    probs = 1.0 / (1.0 + np.arange(classes))
    probs /= probs.sum()
    freq = np.bincount(labels.numpy(), minlength=classes) / n
    assert np.all(np.abs(freq - probs) < 5 * np.sqrt(probs / n))
    # Template scales: class c's mean row is its template, N(0, 4)·scale_c.
    scale = np.exp(np.linspace(np.log(0.5), np.log(4.0), classes))
    for c in (0, 10, 20, 30):
        rows = A[labels == c].double()
        est = float(rows.mean(0).pow(2).mean().sqrt()) / 2.0
        assert abs(est / scale[c] - 1) < 0.15, (c, est, scale[c])
    noise = (A[labels == 0] - A[labels == 0].mean(0)).std()
    assert abs(float(noise) - 1.0) < 0.02


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accuracy_matches_reference(seed):
    rs = np.random.default_rng(seed)
    A = rs.standard_normal((500, 30)).astype(np.float32)
    X = rs.standard_normal((30, 7)).astype(np.float32)
    labels = rs.integers(0, 7, 500)
    B = np.eye(7, dtype=np.float32)[labels]
    want = float(jdata.accuracy(jnp.asarray(A), jnp.asarray(B), jnp.asarray(X), jnp.asarray(labels)))
    got = float(tdata.accuracy(torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(X), torch.from_numpy(labels)))
    # The same rows right; XLA's float32 mean multiplies by 1/n, torch divides.
    assert round(got * 500) == round(want * 500)
    assert got == pytest.approx(want, rel=2.4e-7)


@pytest.mark.parametrize("name", ["FIG1", "FIG3A", "FIG4A"])
def test_configs_match_reference(name):
    assert dataclasses.asdict(getattr(tcfg, name)) == dataclasses.asdict(getattr(jcfg, name))


# --------------------------------------------------------------------- theory

GRID = [(m, d, q) for m in (40, 250, 2500) for d in (5, 25) for q in (1, 8, 200)]


def _eq(a: float, b: float) -> None:
    assert a == pytest.approx(b, rel=FLOAT_TOL, abs=0.0)


@pytest.mark.parametrize("m,d,q", GRID)
def test_theorem1_probability_and_workers(m, d, q):
    for eps in (0.5, 1.0, 4.0):
        _eq(tth.theorem1_success_probability(m, d, q, eps), jth.theorem1_success_probability(m, d, q, eps))
        _eq(tth.theorem1_success_probability(m, d, q, eps, c1=0.02),
            jth.theorem1_success_probability(m, d, q, eps, c1=0.02))
        assert tth.workers_for_error(m, d, eps / q) == jth.workers_for_error(m, d, eps / q)


@pytest.mark.parametrize("q", [1, 2, 8, 200])
def test_lemma2(q):
    for var, bias in ((1.0, 0.0), (0.3, 0.01), (2.5, 0.7)):
        _eq(tth.lemma2_error(var, bias, q), jth.lemma2_error(var, bias, q))


@pytest.mark.parametrize("m,d,q", GRID)
def test_bias_bounds(m, d, q):
    n, fstar = 50 * m, 3.7
    for eps in (0.1, 0.5):
        _eq(tth.ros_z_bound(m, d, fstar, 0.01), jth.ros_z_bound(m, d, fstar, 0.01))
        _eq(tth.ros_bias_bound(eps, m, d, fstar), jth.ros_bias_bound(eps, m, d, fstar))
        _eq(tth.leverage_z_bound(m, d, fstar), jth.leverage_z_bound(m, d, fstar))
        _eq(tth.leverage_bias_bound(eps, m, d, fstar), jth.leverage_bias_bound(eps, m, d, fstar))
        for rep in (True, False):
            _eq(tth.uniform_z_bound(m, n, fstar, d / n * q, replacement=rep),
                jth.uniform_z_bound(m, n, fstar, d / n * q, replacement=rep))
            _eq(tth.uniform_bias_bound(eps, m, n, fstar, d / n * q, replacement=rep),
                jth.uniform_bias_bound(eps, m, n, fstar, d / n * q, replacement=rep))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_empirical_bias_variance(seed):
    rs = np.random.default_rng(seed)
    Ax = rs.standard_normal((16, 300)).astype(np.float32)
    As = rs.standard_normal(300).astype(np.float32)
    vj, bj = jth.empirical_bias_variance(jnp.asarray(Ax), jnp.asarray(As))
    vt, bt = tth.empirical_bias_variance(torch.from_numpy(Ax), torch.from_numpy(As))
    assert float(vt) == pytest.approx(float(vj), rel=1e-5)
    assert float(bt) == pytest.approx(float(bj), rel=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_subspace_embedding_eps(seed):
    rs = np.random.default_rng(seed)
    U = np.linalg.qr(rs.standard_normal((400, 6)))[0].astype(np.float32)
    S = (rs.standard_normal((60, 400)) / math.sqrt(60)).astype(np.float32)
    SU = S @ U
    want = float(jth.subspace_embedding_eps(jnp.asarray(U), jnp.asarray(SU)))
    got = float(tth.subspace_embedding_eps(torch.from_numpy(U), torch.from_numpy(SU)))
    assert got == pytest.approx(want, rel=1e-5)


# -------------------------------------------------------------------- privacy


@pytest.mark.parametrize("gamma", [0.3, 1.0, 2.5])
@pytest.mark.parametrize("m,n", [(1, 10), (250, 50_000), (2500, 500_000), (8000, 2_000_000)])
def test_privacy_bounds_match_reference(m, n, gamma):
    _eq(tpriv.mi_per_entry_bound(m, n, gamma), jpriv.mi_per_entry_bound(m, n, gamma))
    for budget in (1e-3, 0.05, 1.0):
        assert tpriv.sketch_dim_for_privacy(n, budget, gamma) == jpriv.sketch_dim_for_privacy(n, budget, gamma)
    _eq(tpriv.SketchDisclosure(m, n, gamma).per_entry_nats, jpriv.SketchDisclosure(m, n, gamma).per_entry_nats)


def test_privacy_accountant_and_report_match_reference():
    ta, ja = tpriv.PrivacyAccountant(), jpriv.PrivacyAccountant()
    for args in ((2500, 500_000, 1.0, "worker0"), (2500, 500_000, 1.0, ""), (200, 1000, 0.5, "ln")):
        got, want = ta.record(*args), ja.record(*args)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    _eq(ta.total_per_entry_nats, ja.total_per_entry_nats)
    assert ta.report() == ja.report()


@pytest.mark.parametrize("m,n", [(0, 5), (5, 0), (-1, 3)])
def test_privacy_refuses_what_the_reference_refuses(m, n):
    with pytest.raises(ValueError):
        jpriv.mi_per_entry_bound(m, n)
    with pytest.raises(ValueError):
        tpriv.mi_per_entry_bound(m, n)


@pytest.mark.parametrize("kind", ["sjlt", "uniform_norep", "gaussian"])
def test_master_multi_target_matches_reference(kind):
    """Fig. 2's least squares: a one-hot B (n, k) through the port's master path
    against the reference's mesh-free master composition (``gram_batched``,
    ``lstsq_gram`` per worker, ``masked_average``) on the same numpy arrays; X̄
    (d, k) to 1e-4 of its largest entry."""
    from repro.core import averaging as javg, operators as jops, sketches as jsk, solve as jsolve
    from repro.utils import prng as jprng
    from repro_torch.core import distributed as tdist, sketches as tsk
    from repro_torch.utils import prng as tprng

    A, B, _ = tdata.emnist_like(4, 3000, classes=5, img_dim=12, device="cpu")
    An, Bn = A.numpy(), B.numpy()
    q, m = 4, 60

    def spec(sk):
        if kind == "uniform_norep":
            return sk.SketchSpec("uniform", m, replacement=False)
        return sk.SketchSpec(kind, m, s=20)

    keys = jprng.worker_keys(jax.random.PRNGKey(2), q)
    Gs, cs = jops.gram_batched(spec(jsk), keys, jnp.asarray(An), jnp.asarray(Bn))
    want = np.asarray(javg.masked_average(jax.vmap(jsolve.lstsq_gram)(Gs, cs), None))
    got = tdist.distributed_sketch_solve_master(spec(tsk), tprng.prng_key(2), A, B, q=q, device="cpu").numpy()
    assert got.shape == want.shape == (12, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    acc_t = float(tdata.accuracy(A, B, torch.from_numpy(got), torch.argmax(B, 1)))
    acc_j = float(jdata.accuracy(jnp.asarray(An), jnp.asarray(Bn), jnp.asarray(want), jnp.argmax(jnp.asarray(Bn), 1)))
    assert abs(acc_t - acc_j) <= 2 / 3000
