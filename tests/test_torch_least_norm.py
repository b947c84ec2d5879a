"""The §V right-sketch least-norm path of the port against the JAX reference.

Same numpy-made inputs go to both packages. Each kind's ``adjoint`` (Sᵀ·Y) and
``materialize`` are held against the reference's operator on the same key; the
port's plain Gaussian adjoint against the reference's Pallas kernel in interpret
mode and its jnp adjoint; ``least_norm``, ``sketch_least_norm`` and
``distributed_sketch_least_norm`` against the reference's (the distributed one
against a mean over worker keys, and at q = 1 against the reference's entry point
on a 1-device mesh). Float outputs are compared relative to their largest entry:
both sides sum in float32 in different orders over at most 1,001 terms, so 1e-5
leaves two orders of magnitude of margin; x̂ and x̄ come out of an n×n Cholesky
of the sketched problem and are compared to 1e-4. The port's scatter of repeated
rows is checked bitwise against a left-to-right float32 sum in sample order, and
the SJLT's plain segment sum against one in (data row, t) order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import paper_lsq as jcfg
from repro.core import distributed as jdist, operators as jops, sketches as jsk, solve as jsolve
from repro.core import theory as jtheory
from repro.kernels.gaussian import ops as jgops
from repro.utils import prng as jprng
from repro_torch.configs import paper_lsq as tcfg
from repro_torch.core import distributed as tdist, operators as tops, sketches as tsk, solve as tsolve
from repro_torch.core import theory as ttheory
from repro_torch.kernels import cuda as tcuda
from repro_torch.kernels.gaussian import ops as gops, ref as gref
from repro_torch.kernels.sjlt import ref as tsref
from repro_torch.utils import prng as tprng

REL_TOL = 1e-5
SOLVE_TOL = 1e-4
# The operator's n is the data's d (a right sketch); 1001 is a multiple of no block.
N_OP, M, K, M_PRIME = 1001, 40, 3, 150
# Least-norm problems: n < m < m′ < d.
N_LN, D_LN = 12, 301
# Kinds as in test_torch_operators.py: "sjltK" is the SJLT with s = K, "uniform_norep"
# samples without replacement, "hybrid_K" is the hybrid with inner kind K.
ALL = ["gaussian", "rademacher", "srht", "sjlt1", "sjlt4", "uniform", "uniform_norep", "leverage",
       "hybrid_gaussian", "hybrid_rademacher", "hybrid_sjlt", "hybrid_srht"]


def _spec(sk, kind, m=M, **kw):
    if kind.startswith("sjlt"):
        return sk.SketchSpec("sjlt", m, s=int(kind[4:]), **kw)
    if kind == "uniform_norep":
        return sk.SketchSpec("uniform", m, replacement=False, **kw)
    if kind.startswith("hybrid_"):
        return sk.SketchSpec("hybrid", m, m_prime=M_PRIME, inner=kind[7:], s=4, **kw)
    return sk.SketchSpec(kind, m, **kw)


def _scores(kind, n):
    """Leverage scores for both packages (None for other kinds), multiples of 2**-16
    so that every float32 sum of them is exact."""
    if kind != "leverage":
        return None, None
    sc = (np.random.default_rng(n).integers(1, 2**16, n) / 2**16).astype(np.float32)
    return jnp.asarray(sc), torch.from_numpy(sc)


def _keys(seed):
    jkey = jax.random.PRNGKey(seed)
    return jkey, tprng.from_key_data(np.asarray(jax.random.key_data(jkey)))


def _ops(kind, seed, use_kernel=False, n=N_OP):
    jkey, tkey = _keys(seed)
    js, ts = _scores(kind, n)
    jop = jops.make_operator(_spec(jsk, kind, use_kernel=use_kernel), jkey, n, scores=js)
    top = tops.make_operator(_spec(tsk, kind, use_kernel=use_kernel), tkey, n, scores=ts)
    return jop, top


def _close(got: torch.Tensor, want, tol=REL_TOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max rel err {err} > {tol}"


def _problem(seed, n=N_LN, d=D_LN, k=None):
    rs = np.random.default_rng(seed)
    A = rs.standard_normal((n, d)).astype(np.float32)
    b = rs.standard_normal((n,) if k is None else (n, k)).astype(np.float32)
    return A, b


# ------------------------------------------------------------------ adjoint


@pytest.mark.parametrize("kind", ALL)
@pytest.mark.parametrize("k", [None, K])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_adjoint_matches_reference(kind, k, use_kernel):
    """Sᵀ·Y for Y (m,) and (m, k), n = 1001; the port on the CPU takes its plain
    versions where ``use_kernel`` routes the reference to a kernel."""
    jop, top = _ops(kind, 1, use_kernel)
    Y = np.random.default_rng(2).standard_normal((M,) if k is None else (M, k)).astype(np.float32)
    got = top.adjoint(torch.from_numpy(Y))
    assert got.dtype == torch.float32
    _close(got, jop.adjoint(jnp.asarray(Y)))


@pytest.mark.parametrize("kind", ["gaussian", "rademacher", "srht"])
@pytest.mark.parametrize("block_rows", [64, 300, 4096])
def test_streamed_adjoint_is_blocking_invariant(kind, block_rows):
    """The base adjoint streams column tiles of S; a ragged last tile changes nothing."""
    jop, top = _ops(kind, 3)
    Y = np.random.default_rng(4).standard_normal((M, 2)).astype(np.float32)
    _close(tops.SketchOp.adjoint(top, torch.from_numpy(Y), block_rows=block_rows),
           jops.SketchOp.adjoint(jop, jnp.asarray(Y), block_rows=block_rows))


@pytest.mark.parametrize("m,n,k", [(40, 1001, 1), (48, 137, 3), (7, 300, 33), (1, 5, 1), (200, 1000, 1)])
def test_plain_gaussian_adjoint_matches_pallas_kernel_and_jnp_adjoint(m, n, k):
    """The port's plain adjoint (what its wrapper runs on the CPU and what the CUDA
    kernel is held against) against the reference's Pallas kernel in interpret
    mode and its jnp adjoint, on the same key and Y."""
    jkey, tkey = _keys(m + n)
    Y = np.random.default_rng(k).standard_normal((m, k)).astype(np.float32)
    got = gref.adjoint(tkey, torch.from_numpy(Y), n)
    _close(got, jgops.gaussian_adjoint(jkey, jnp.asarray(Y), n, interpret=True))
    _close(got, jops.make_operator(jsk.SketchSpec("gaussian", m), jkey, n).adjoint(jnp.asarray(Y)))
    # Summed in float64 and rounded once: the exact Sᵀ·Y of the float32 S.
    S = gref.sketch_matrix(tkey, m, n).double()
    assert torch.equal(got, (S.T @ torch.from_numpy(Y).double()).float())


@pytest.mark.parametrize("kind", ALL)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_adjoint_identity(kind, use_kernel):
    """⟨S·x, y⟩ = ⟨x, Sᵀ·y⟩ for every kind, to float tolerance."""
    _, top = _ops(kind, 5, use_kernel)
    rs = np.random.default_rng(6)
    x = torch.from_numpy(rs.standard_normal(N_OP).astype(np.float32))
    y = torch.from_numpy(rs.standard_normal(M).astype(np.float32))
    Sx, Sty = top.apply(x), top.adjoint(y)
    assert Sx.shape == (M,) and Sty.shape == (N_OP,)
    lhs, rhs = float(Sx.double() @ y.double()), float(x.double() @ Sty.double())
    scale = float(Sx.norm() * y.norm() + x.norm() * Sty.norm())
    assert abs(lhs - rhs) <= REL_TOL * scale


@pytest.mark.parametrize("kind", ALL)
def test_materialize_matches_reference(kind):
    jop, top = _ops(kind, 7, n=197)
    S = top.materialize()
    assert S.shape == (M, 197) and S.dtype == torch.float32
    _close(S, jop.materialize())
    # Sᵀ is the adjoint of the same operator.
    _close(top.adjoint(torch.eye(M)), np.asarray(jop.materialize()).T)


@pytest.mark.parametrize("name", ["gaussian", "rademacher", "srht", "sjlt", "uniform", "leverage", "hybrid"])
def test_functional_materialize_matches_reference(name):
    jkey, tkey = _keys(8)
    kw = {"sjlt": dict(s=3), "hybrid": dict(m_prime=80, inner="sjlt", s=2)}.get(name, {})
    want = jsk.materialize(jsk.SketchSpec(name, M, **kw), jkey, 97)
    _close(tsk.materialize(tsk.SketchSpec(name, M, **kw), tkey, 97), want)


def test_gaussian_adjoint_wrapper_takes_the_plain_version_on_cpu_and_raises_elsewhere():
    key = tprng.prng_key(9)
    Y = torch.from_numpy(np.random.default_rng(9).standard_normal((M, 2)).astype(np.float32))
    before = dict(gops.LAUNCHES)
    assert torch.equal(gops.gaussian_adjoint(key, Y, N_OP), gref.adjoint(key, Y, N_OP))
    vec = gops.gaussian_adjoint(key, Y[:, 1], N_OP)
    assert vec.shape == (N_OP,) and torch.equal(vec, gref.adjoint(key, Y[:, 1:], N_OP)[:, 0])
    assert dict(gops.LAUNCHES) == before  # the counters count kernel launches only
    with pytest.raises(ValueError, match="CUDA kernel"):
        gops.gaussian_adjoint(key, torch.empty((M, 2), device="meta"), N_OP)


@pytest.mark.parametrize("m,n,k", [(4000, 11_556, 1), (4000, 8000, 1), (200, 1000, 1), (200, 500, 1),
                                   (1, 1, 1), (63, 129, 3), (65, 1001, 33), (10**6, 7, 9)])
def test_plan_adjoint_cuts_m_into_nonempty_splits(m, n, k):
    n_splits, rows = tcuda.plan_adjoint(m, n, k)
    assert (n_splits - 1) * rows < m <= n_splits * rows
    assert n_splits == 1 or rows >= tcuda.ADJOINT_MIN_SPLIT_ROWS
    assert tcuda.plan_adjoint(m, n, k) == (n_splits, rows)


# ---------------------------------------------------------- scatter of sampled rows


@pytest.mark.parametrize("kind", ["repeats", "distinct"])
@pytest.mark.parametrize("k", [None, 4])
def test_scatter_rows_adds_in_sample_order(kind, k):
    """Repeated rows are added in sample order: bitwise a left-to-right float32 sum
    (within float32 rounding of the float64 sum), the same on every rerun."""
    rs = np.random.default_rng(10)
    m = 400
    n = 50 if kind == "repeats" else 500
    rows = rs.integers(0, n, m) if kind == "repeats" else rs.permutation(n)[:m]
    Y = rs.standard_normal((m,) if k is None else (m, k)).astype(np.float32)
    want = np.zeros((n,) + Y.shape[1:], np.float32)
    for t, r in enumerate(rows):
        want[r] = want[r] + Y[t]
    got = tops._scatter_rows(torch.from_numpy(rows), torch.from_numpy(Y), n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tops._scatter_rows(torch.from_numpy(rows), torch.from_numpy(Y), n), got)
    exact = np.zeros((n,) + Y.shape[1:], np.float64)
    np.add.at(exact, rows, Y.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-5 * np.abs(Y).max())


@pytest.mark.parametrize("out", [False, True])
def test_sjlt_segment_sum_adds_in_pair_order(out):
    """The SJLT's plain S·A adds each sketch row's (data row, t) pairs in that order,
    after ``out``'s row when given: bitwise a left-to-right float32 sum, and empty
    sketch rows stay as they were."""
    rs = np.random.default_rng(16)
    n, s, m, d = 300, 3, 1000, 2
    A = rs.standard_normal((n, d)).astype(np.float32)
    buckets = rs.integers(0, m, (n, s))
    signs = rs.choice(np.array([-1, 1], np.float32), (n, s))
    acc = rs.standard_normal((m, d)).astype(np.float32) if out else np.zeros((m, d), np.float32)
    want = acc.copy()
    for i in range(n):
        for t in range(s):
            want[buckets[i, t]] = want[buckets[i, t]] + signs[i, t] * A[i]
    got = tsref.sjlt_apply(torch.from_numpy(A), torch.from_numpy(buckets), torch.from_numpy(signs), m,
                           out=torch.from_numpy(acc.copy()) if out else None)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------- solves


@pytest.mark.parametrize("n,d,k", [(12, 301, None), (12, 301, 2), (50, 1000, None)])
def test_least_norm_matches_reference(n, d, k):
    A, b = _problem(11, n, d, k)
    x = tsolve.least_norm(torch.from_numpy(A), torch.from_numpy(b))
    _close(x, jsolve.least_norm(jnp.asarray(A), jnp.asarray(b)), SOLVE_TOL)
    np.testing.assert_allclose(A.astype(np.float64) @ x.numpy(), b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ALL)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_sketch_least_norm_matches_reference(kind, use_kernel):
    A, b = _problem(12)
    jkey, tkey = _keys(13)
    want = jsolve.sketch_least_norm(_spec(jsk, kind, use_kernel=use_kernel), jkey, jnp.asarray(A), jnp.asarray(b))
    got = tsolve.sketch_least_norm(_spec(tsk, kind, use_kernel=use_kernel), tkey, torch.from_numpy(A),
                                   torch.from_numpy(b))
    _close(got, want, SOLVE_TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sketch_least_norm_at_fig4a_shape(use_kernel):
    """FIG4A's n = 50, d = 1,000, m = 200 with the Gaussian right sketch."""
    cfg = tcfg.FIG4A
    A, b = _problem(14, cfg.n, cfg.d)
    jkey, tkey = _keys(15)
    want = jsolve.sketch_least_norm(jsk.SketchSpec("gaussian", cfg.m, use_kernel=use_kernel), jkey,
                                    jnp.asarray(A), jnp.asarray(b))
    got = tsolve.sketch_least_norm(tsk.SketchSpec("gaussian", cfg.m, use_kernel=use_kernel), tkey,
                                   torch.from_numpy(A), torch.from_numpy(b))
    _close(got, want, SOLVE_TOL)


# ------------------------------------------------------------- distributed


MASKS = {"all": None, "stragglers": np.array([1, 0, 1, 1], np.float32)}


@pytest.mark.parametrize("kind", ["gaussian", "srht", "sjlt4", "uniform", "leverage", "hybrid_gaussian"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("mask", list(MASKS), ids=list(MASKS))
def test_distributed_least_norm_matches_mean_of_reference_workers(kind, use_kernel, mask):
    """q = 4: the masked mean of the reference's ``sketch_least_norm`` over
    ``worker_key(key, w, round_id)``; only the survivors count."""
    A, b = _problem(16)
    jkey, tkey = _keys(17)
    spec = _spec(jsk, kind, use_kernel=use_kernel)
    xs = [np.asarray(jsolve.sketch_least_norm(spec, jprng.worker_key(jkey, w, 2), jnp.asarray(A), jnp.asarray(b)))
          for w in range(4)]
    live = np.ones(4, bool) if MASKS[mask] is None else MASKS[mask].astype(bool)
    want = np.mean([x for x, keep in zip(xs, live) if keep], axis=0)
    got = tdist.distributed_sketch_least_norm(
        _spec(tsk, kind, use_kernel=use_kernel), tkey, torch.from_numpy(A), torch.from_numpy(b),
        q=4, round_id=2, straggler_mask=MASKS[mask], device="cpu",
    )
    _close(got, want, SOLVE_TOL)


@pytest.mark.parametrize("kind", ["gaussian", "uniform_norep"])
def test_distributed_least_norm_q1_matches_reference_entry_point(kind):
    """q = 1 against the reference's ``distributed_sketch_least_norm`` on a 1-device
    mesh (its 8-device mesh path is not the oracle)."""
    A, b = _problem(18, k=2)
    jkey, tkey = _keys(19)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    want = jdist.distributed_sketch_least_norm(mesh, _spec(jsk, kind), jkey, jnp.asarray(A), jnp.asarray(b),
                                               round_id=1)
    got = tdist.distributed_sketch_least_norm(_spec(tsk, kind), tkey, torch.from_numpy(A), torch.from_numpy(b),
                                              q=1, round_id=1, device="cpu")
    assert got.shape == (D_LN, 2)
    _close(got, want, SOLVE_TOL)


def test_distributed_least_norm_rejects_an_empty_round_and_bad_masks():
    A, b = _problem(20)
    spec = tsk.SketchSpec("gaussian", M)
    args = (spec, tprng.prng_key(0), torch.from_numpy(A), torch.from_numpy(b))
    with pytest.raises(ValueError, match="no surviving workers"):
        tdist.distributed_sketch_least_norm(*args, q=3, straggler_mask=np.zeros(3, np.float32), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tdist.distributed_sketch_least_norm(*args, q=3, straggler_mask=np.ones(2, np.float32), device="cpu")


def test_distributed_least_norm_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, b = _problem(21)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdist.distributed_sketch_least_norm(tsk.SketchSpec("gaussian", M), tprng.prng_key(0),
                                            torch.from_numpy(A), torch.from_numpy(b), q=2)


# ------------------------------------------------------- theory and config


@pytest.mark.parametrize("m,n,d", [(200, 50, 1000), (4000, 2000, 11_556), (53, 51, 60)])
def test_lemma7_matches_reference(m, n, d):
    assert ttheory.gaussian_least_norm_error(m, n, d) == jtheory.gaussian_least_norm_error(m, n, d)
    with pytest.raises(ValueError, match="Lemma 7"):
        ttheory.gaussian_least_norm_error(n + 1, n, d)


def test_fig4a_config_matches_reference():
    assert vars(tcfg.FIG4A) == vars(jcfg.FIG4A)
