"""The port's solver remainder against the JAX reference, on the CPU.

* A Cholesky that fails: the reference's ``lstsq_gram`` and ``least_norm`` give
  NaN for a G that is not positive definite (``jnp.linalg.cholesky``); the port
  must give NaN in the same places, batch entry by batch entry, and raise
  nothing. ``masked_average`` then carries the NaN as the reference's does.
* ``lstsq(method="cg")`` (64 CG steps on the normal equations) and
  ``sketch_and_solve(method="cg")``: to 1e-4 of the largest entry (both run the
  same float32 recurrence; the reference's fused loop rounds in another order).
* ``SketchSpec.apply`` and ``SketchSpec.operator``: S·A to 1e-5 of its largest
  entry (the Gaussian's normals differ by float32 ulps between the packages),
  the sampled rows bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import averaging as javg, sketches as jsk, solve as jsolve
from repro_torch.core import averaging as tavg, sketches as tsk, solve as tsolve
from repro_torch.utils import prng as tprng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

D = 5
BAD = {"singular": np.diag([1.0, 1.0, 1.0, 1.0, 0.0]), "indefinite": np.diag([1.0, 1.0, 1.0, 1.0, -1.0])}


def _nan_pattern_equal(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)


def _spd(rs, q):
    X = rs.standard_normal((q, 20, D))
    return np.einsum("qnd,qne->qde", X, X).astype(np.float32)


@pytest.mark.parametrize("k", [None, 2])
@pytest.mark.parametrize("bad", sorted(BAD))
def test_lstsq_gram_single_failure_is_nan_as_reference(bad, k):
    rs = np.random.default_rng(0)
    G = BAD[bad].astype(np.float32)
    c = rs.standard_normal((D,) if k is None else (D, k)).astype(np.float32)
    want = np.asarray(jsolve.lstsq_gram(jnp.asarray(G), jnp.asarray(c)))
    got = tsolve.lstsq_gram(torch.from_numpy(G), torch.from_numpy(c)).numpy()
    assert np.isnan(want).all()
    _nan_pattern_equal(got, want)


@pytest.mark.parametrize("k", [None, 2])
@pytest.mark.parametrize("bad", sorted(BAD))
def test_lstsq_gram_batched_one_bad_worker_as_reference(bad, k):
    """q = 3 with worker 1's G not positive definite: its x is NaN, the others
    are the reference's."""
    rs = np.random.default_rng(1)
    G = _spd(rs, 3)
    G[1] = BAD[bad]
    c = rs.standard_normal((3, D) if k is None else (3, D, k)).astype(np.float32)
    want = np.asarray(jax.vmap(jsolve.lstsq_gram)(jnp.asarray(G), jnp.asarray(c)))
    got = tsolve.lstsq_gram(torch.from_numpy(G), torch.from_numpy(c)).numpy()
    assert np.isnan(want[1]).all() and not np.isnan(want[[0, 2]]).any()
    _nan_pattern_equal(got, want)


@pytest.mark.parametrize("mask", [None, [1, 1, 1], [1, 0, 1], [0, 1, 0]])
def test_masked_average_carries_nan_as_reference(mask):
    """The NaN solutions of a failed worker reach x̄ as in the reference: through
    the mean, and through the masked sum too (NaN · 0 is NaN)."""
    rs = np.random.default_rng(2)
    G = _spd(rs, 3)
    G[1] = BAD["singular"]
    c = rs.standard_normal((3, D)).astype(np.float32)
    xs_j = jax.vmap(jsolve.lstsq_gram)(jnp.asarray(G), jnp.asarray(c))
    xs_t = tsolve.lstsq_gram(torch.from_numpy(G), torch.from_numpy(c))
    mj = None if mask is None else jnp.asarray(mask, jnp.float32)
    mt = None if mask is None else torch.tensor(mask, dtype=torch.float32)
    want = np.asarray(javg.masked_average(xs_j, mj))
    got = tavg.masked_average(xs_t, mt).numpy()
    _nan_pattern_equal(got, want)


@pytest.mark.parametrize("case", ["repeated_row", "zero_row", "rank_one"])
def test_least_norm_failure_is_nan_as_reference(case):
    rs = np.random.default_rng(3)
    A = rs.standard_normal((4, 9)).astype(np.float32)
    if case == "repeated_row":
        A[2] = A[0]
    elif case == "zero_row":
        A[3] = 0.0
    else:
        A = np.outer(rs.standard_normal(4), rs.standard_normal(9)).astype(np.float32)
    b = rs.standard_normal(4).astype(np.float32)
    want = np.asarray(jsolve.least_norm(jnp.asarray(A), jnp.asarray(b)))
    got = tsolve.least_norm(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert np.isnan(want).any()
    _nan_pattern_equal(got, want)


def test_least_norm_full_rank_unchanged():
    rs = np.random.default_rng(4)
    A = rs.standard_normal((4, 9)).astype(np.float32)
    b = rs.standard_normal(4).astype(np.float32)
    want = np.asarray(jsolve.least_norm(jnp.asarray(A), jnp.asarray(b)))
    got = tsolve.least_norm(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("reg", [0.0, 0.1])
@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("n", [40, 300])
def test_lstsq_cg_matches_reference(n, k, reg):
    rs = np.random.default_rng(n + (k or 0))
    A = rs.standard_normal((n, 8)).astype(np.float32)
    b = rs.standard_normal((n,) if k is None else (n, k)).astype(np.float32)
    want = np.asarray(jsolve.lstsq(jnp.asarray(A), jnp.asarray(b), reg=reg, method="cg"))
    got = tsolve.lstsq(torch.from_numpy(A), torch.from_numpy(b), reg=reg, method="cg").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    exact = np.asarray(jsolve.lstsq(jnp.asarray(A), jnp.asarray(b), reg=reg, method="chol"))
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-4 * np.abs(exact).max())


def _spec(sk, kind, **kw):
    if kind == "uniform_norep":
        return sk.SketchSpec("uniform", 30, replacement=False, **kw)
    if kind == "hybrid":
        return sk.SketchSpec("hybrid", 30, m_prime=120, inner="sjlt", s=4, **kw)
    return sk.SketchSpec(kind, 30, s=4, **kw)


KINDS = ["gaussian", "rademacher", "srht", "sjlt", "uniform", "uniform_norep", "leverage", "hybrid"]


def _data(seed, n=500, d=6):
    rs = np.random.default_rng(seed)
    return rs.standard_normal((n, d)).astype(np.float32), rs.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("kind", ["gaussian", "rademacher", "srht", "sjlt", "uniform_norep", "hybrid"])
def test_sketch_and_solve_cg_matches_reference(kind):
    A, b = _data(5)
    jkey = jax.random.PRNGKey(9)
    want = np.asarray(jsolve.sketch_and_solve(_spec(jsk, kind), jkey, jnp.asarray(A), jnp.asarray(b), method="cg"))
    got = tsolve.sketch_and_solve(_spec(tsk, kind), tprng.prng_key(9), torch.from_numpy(A), torch.from_numpy(b),
                                  method="cg").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_spec_apply_matches_reference(kind, use_kernel):
    A, _ = _data(6)
    jspec, tspec = _spec(jsk, kind), _spec(tsk, kind, use_kernel=use_kernel)
    want = np.asarray(jspec.apply(jax.random.PRNGKey(4), jnp.asarray(A)))
    got = tspec.apply(tprng.prng_key(4), torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kind", KINDS)
def test_spec_operator_matches_reference(kind):
    n = 160
    scores = np.linspace(0.5, 2.0, n).astype(np.float32) if kind == "leverage" else None
    jop = _spec(jsk, kind).operator(jax.random.PRNGKey(5), n, scores=None if scores is None else jnp.asarray(scores))
    top = _spec(tsk, kind).operator(tprng.prng_key(5), n, scores=None if scores is None else torch.from_numpy(scores))
    assert top.shape == tuple(jop.shape)
    for attr in ("rows",):
        if hasattr(jop, attr) and getattr(jop, attr) is not None:
            np.testing.assert_array_equal(getattr(top, attr).numpy(), np.asarray(getattr(jop, attr)))
    want = np.asarray(jop.apply(jnp.eye(n, dtype=jnp.float32)))
    got = top.materialize().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
