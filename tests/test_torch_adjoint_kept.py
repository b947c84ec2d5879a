"""The kept-S Gaussian adjoint of the least-norm path (CPU), against the JAX reference.

A Gaussian operator with ``use_kernel`` hands its forward S·Aᵀ and its adjoint
Sᵀ·ẑ out together (``apply_with_adjoint``): where S fits the scratch
(``cuda.keeps_sketch``, by the shapes alone) the forward keeps the S it draws
and the adjoint reads it back. On the CPU the wrappers take their plain versions:
the forward ``ref.sketch`` with ``ref.sketch_matrix``, the adjoint the float32 S
and Y multiplied in float64 and rounded once. Same numpy-made inputs go to both
packages; outputs are compared relative to their largest entry (1e-5: float32
sums of at most 1,001 terms in two orders), least-norm x̂ and x̄ to 1e-4 (they
come out of an n×n Cholesky of the sketched problem).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as jops, sketches as jsk, solve as jsolve
from repro.kernels.gaussian import ops as jgops
from repro.utils import prng as jprng
from repro_torch.core import distributed as tdist, operators as tops, sketches as tsk, solve as tsolve
from repro_torch.kernels import cuda as tcuda
from repro_torch.kernels.gaussian import ops as gops, ref as gref
from repro_torch.utils import prng as tprng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

REL_TOL = 1e-5
SOLVE_TOL = 1e-4
N_OP, M, M_PRIME = 1001, 40, 150
N_LN, D_LN = 12, 301
OTHER_KINDS = ["rademacher", "srht", "sjlt", "uniform", "uniform_norep", "leverage", "hybrid_rademacher",
               "hybrid_sjlt", "hybrid_srht"]


def _spec(sk, kind, m=M, **kw):
    if kind == "uniform_norep":
        return sk.SketchSpec("uniform", m, replacement=False, **kw)
    if kind.startswith("hybrid_"):
        return sk.SketchSpec("hybrid", m, m_prime=M_PRIME, inner=kind[7:], s=4, **kw)
    return sk.SketchSpec(kind, m, s=4, **kw)


def _keys(seed):
    jkey = jax.random.PRNGKey(seed)
    return jkey, tprng.from_key_data(np.asarray(jax.random.key_data(jkey)))


def _close(got: torch.Tensor, want, tol=REL_TOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max rel err {err} > {tol}"


def _op(kind, seed, n=N_OP, use_kernel=True):
    _, tkey = _keys(seed)
    scores = torch.ones(n) if kind == "leverage" else None
    return tops.make_operator(_spec(tsk, kind, use_kernel=use_kernel), tkey, n, scores=scores)


def _problem(seed, n=N_LN, d=D_LN):
    rs = np.random.default_rng(seed)
    return rs.standard_normal((n, d)).astype(np.float32), rs.standard_normal(n).astype(np.float32)


# ------------------------------------------------------------ the two wrappers


@pytest.mark.parametrize("m,n,d", [(40, 1001, 3), (48, 137, 1), (200, 1000, 50), (1, 5, 2)])
def test_sketch_keep_is_the_sketch_and_the_reference_s(m, n, d):
    """The forward with S kept: S·A bitwise ``gaussian_sketch``'s; S bitwise the
    plain S and within float32 rounding of the reference's materialized S."""
    jkey, tkey = _keys(m + n)
    A = torch.from_numpy(np.random.default_rng(d).standard_normal((n, d)).astype(np.float32))
    SA, S = gops.gaussian_sketch_keep(tkey, A, m)
    assert torch.equal(SA, gops.gaussian_sketch(tkey, A, m))
    assert S.shape == (m, n) and torch.equal(S, gref.sketch_matrix(tkey, m, n))
    _close(S, jsk.materialize(jsk.SketchSpec("gaussian", m), jkey, n))


@pytest.mark.parametrize("m,n,k", [(40, 1001, 1), (48, 137, 3), (7, 300, 33), (1, 5, 1), (200, 1000, 1)])
def test_kept_adjoint_plain_version_matches_pallas_kernel(m, n, k):
    """The kept adjoint's plain version (what its wrapper runs on the CPU and what
    the CUDA kernel is held against) over the kept S: the exact Sᵀ·Y of that S,
    the redraw adjoint's plain version, and the reference's Pallas kernel in
    interpret mode on the same key and Y."""
    jkey, tkey = _keys(m * n + k)
    Y = torch.from_numpy(np.random.default_rng(k).standard_normal((m, k)).astype(np.float32))
    _, S = gops.gaussian_sketch_keep(tkey, torch.zeros((n, 1)), m)
    got = gops.gaussian_adjoint_kept(S, Y, n)
    assert torch.equal(got, (S.double().T @ Y.double()).float())
    _close(got, gref.adjoint(tkey, Y, n))
    _close(got, jgops.gaussian_adjoint(jkey, jnp.asarray(Y.numpy()), n, interpret=True))
    vec = gops.gaussian_adjoint_kept(S, Y[:, 0], n)
    assert vec.shape == (n,) and torch.equal(vec, got[:, 0])


def test_kept_adjoint_reads_only_the_first_n_columns():
    """A kept S padded past n (as on the card, rows of whole 16 bytes): the
    padding is never read."""
    _, tkey = _keys(3)
    _, S = gops.gaussian_sketch_keep(tkey, torch.zeros((1001, 1)), M)
    padded = torch.cat([S, torch.full((M, 3), float("nan"))], dim=1)
    Y = torch.from_numpy(np.random.default_rng(3).standard_normal((M, 2)).astype(np.float32))
    assert torch.equal(gops.gaussian_adjoint_kept(padded, Y, 1001), gops.gaussian_adjoint_kept(S, Y, 1001))


def test_wrappers_count_no_launches_on_the_cpu_and_raise_elsewhere():
    _, tkey = _keys(4)
    before = dict(gops.LAUNCHES)
    _, S = gops.gaussian_sketch_keep(tkey, torch.zeros((300, 2)), M)
    gops.gaussian_adjoint_kept(S, torch.ones((M, 1)), 300)
    assert dict(gops.LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA kernel"):
        gops.gaussian_adjoint_kept(S, torch.empty((M, 1), device="meta"), 300)
    with pytest.raises(ValueError, match="CUDA kernel"):
        gops.gaussian_sketch_keep(tkey, torch.empty((300, 2), device="meta"), M)


# -------------------------------------------------------------- apply_with_adjoint


@pytest.mark.parametrize("kind", ["gaussian", "hybrid_gaussian"])
@pytest.mark.parametrize("k", [None, 3])
def test_apply_with_adjoint_is_apply_and_adjoint(kind, k):
    """The kept path of a Gaussian (alone and inside the hybrid) gives the S·Aᵀ and
    the Sᵀ·ẑ of ``apply`` and ``adjoint`` on the same key, and matches the
    reference's operator."""
    jkey, tkey = _keys(5)
    top = tops.make_operator(_spec(tsk, kind, use_kernel=True), tkey, N_OP)
    jop = jops.make_operator(_spec(jsk, kind, use_kernel=True), jkey, N_OP)
    rs = np.random.default_rng(6)
    A = rs.standard_normal((N_OP, 12)).astype(np.float32)
    Y = rs.standard_normal((M,) if k is None else (M, k)).astype(np.float32)
    SA, adjoint = top.apply_with_adjoint(torch.from_numpy(A))
    assert adjoint != top.adjoint  # the kept path's own adjoint
    _close(SA, top.apply(torch.from_numpy(A)).numpy())
    _close(SA, jop.apply(jnp.asarray(A)))
    got = adjoint(torch.from_numpy(Y))
    assert got.dtype == torch.float32
    _close(got, top.adjoint(torch.from_numpy(Y)).numpy())
    _close(got, jop.adjoint(jnp.asarray(Y)))


@pytest.mark.parametrize("kind", OTHER_KINDS + ["gaussian_plain"])
def test_default_apply_with_adjoint_is_apply_and_the_operators_adjoint(kind):
    """Every other kind, and the Gaussian without kernels, gives ``apply(A)`` and
    ``adjoint`` bitwise: the default hands out the operator's own bound
    ``adjoint``; the hybrid its inner operator's, through the gather and scatter."""
    op = _op(kind.removesuffix("_plain"), 7, use_kernel=kind != "gaussian_plain")
    rs = np.random.default_rng(8)
    A = torch.from_numpy(rs.standard_normal((N_OP, 5)).astype(np.float32))
    Y = torch.from_numpy(rs.standard_normal((M, 2)).astype(np.float32))
    SA, adjoint = op.apply_with_adjoint(A)
    assert torch.equal(SA, op.apply(A))
    assert torch.equal(adjoint(Y), op.adjoint(Y)) and torch.equal(adjoint(Y[:, 0]), op.adjoint(Y[:, 0]))
    if not kind.startswith("hybrid_"):
        assert adjoint == op.adjoint


@pytest.mark.parametrize("m,n", [(40, 1001), (4000, 11_556), (200, 1000), (3, 1)])
def test_keeping_s_is_a_function_of_the_shapes_at_the_scratch_boundary(m, n, monkeypatch):
    """S (m, ld) is kept when its bytes fit SCRATCH_BYTES exactly, not one byte
    past; the operator then hands out the kept adjoint, else its own."""
    ld = tcuda.kept_sketch_ld(n)
    assert ld >= n and ld % 4 == 0 and ld - n < 4
    assert tcuda.keeps_sketch(m, n)  # every path shape fits the default scratch
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", 4 * m * ld)
    assert tcuda.keeps_sketch(m, n)
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", 4 * m * ld - 1)
    assert not tcuda.keeps_sketch(m, n)
    if m * n <= 40 * 1001:
        op = tops.make_operator(tsk.SketchSpec("gaussian", m, use_kernel=True), _keys(9)[1], n)
        A = torch.ones((n, 2))
        assert op.apply_with_adjoint(A)[1] == op.adjoint
        monkeypatch.setattr(tcuda, "SCRATCH_BYTES", 4 * m * ld)
        assert op.apply_with_adjoint(A)[1] != op.adjoint


@pytest.mark.parametrize("m,n,k", [(4000, 11_556, 1), (4000, 8000, 1), (200, 1000, 1), (200, 500, 1),
                                   (129, 1001, 3), (1, 1, 1), (10**6, 7, 9)])
def test_adjoint_plan_fits_one_cluster_of_the_kept_kernel(m, n, k):
    """Both adjoint kernels take plan_adjoint's splits: at most 64 (one cluster of
    eight blocks of eight warps), whole blocks of eight where there are eight or
    more and m allows, none empty, ADJOINT_MIN_SPLIT_ROWS rows or more."""
    n_splits, rows = tcuda.plan_adjoint(m, n, k)
    assert 1 <= n_splits <= tcuda.ADJOINT_MAX_SPLITS
    assert (n_splits - 1) * rows < m <= n_splits * rows
    assert n_splits == 1 or rows >= tcuda.ADJOINT_MIN_SPLIT_ROWS
    if m // tcuda.ADJOINT_MIN_SPLIT_ROWS >= 64:
        assert n_splits % tcuda.ADJOINT_SPLITS_PER_BLOCK == 0
    assert {(4000, 11_556): (16, 250), (4000, 8000): (32, 125), (200, 1000): (3, 67)}.get((m, n), (n_splits, rows)) \
        == (n_splits, rows)


# ------------------------------------------------------------------- solves


@pytest.mark.parametrize("kind", ["gaussian", "hybrid_gaussian"])
@pytest.mark.parametrize("keep", [True, False])
def test_sketch_least_norm_kept_or_redrawn_matches_reference(kind, keep, monkeypatch):
    """One worker with S kept (the default scratch) or redrawn (a scratch one
    byte short of S) against the reference's ``sketch_least_norm``."""
    A, b = _problem(10)
    jkey, tkey = _keys(11)
    if not keep:
        m, n = M, M_PRIME if kind.startswith("hybrid") else D_LN
        monkeypatch.setattr(tcuda, "SCRATCH_BYTES", 4 * m * tcuda.kept_sketch_ld(n) - 1)
    want = jsolve.sketch_least_norm(_spec(jsk, kind, use_kernel=True), jkey, jnp.asarray(A), jnp.asarray(b))
    got = tsolve.sketch_least_norm(_spec(tsk, kind, use_kernel=True), tkey, torch.from_numpy(A), torch.from_numpy(b))
    _close(got, want, SOLVE_TOL)


@pytest.mark.parametrize("kind", ["gaussian", "hybrid_gaussian"])
def test_distributed_least_norm_with_kept_s_matches_reference_workers(kind):
    """q = 3 workers, each keeping its S: the mean of the reference's workers."""
    A, b = _problem(12)
    jkey, tkey = _keys(13)
    spec = _spec(jsk, kind, use_kernel=True)
    want = np.mean([np.asarray(jsolve.sketch_least_norm(spec, jprng.worker_key(jkey, w, 0), jnp.asarray(A),
                                                        jnp.asarray(b))) for w in range(3)], axis=0)
    got = tdist.distributed_sketch_least_norm(_spec(tsk, kind, use_kernel=True), tkey, torch.from_numpy(A),
                                              torch.from_numpy(b), q=3, device="cpu")
    _close(got, want, SOLVE_TOL)
