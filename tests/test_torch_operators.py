"""The port's operators, plain versions and kernel wrappers against the JAX reference.

Same numpy-made inputs go to both packages. The reference runs its
``use_kernel=False`` streaming path and its ``use_kernel=True`` Pallas kernels in
interpret mode; the port runs its torch streaming path and, on CPU tensors, the
plain versions its kernel wrappers use there. Float outputs are compared relative
to their largest entry: both sides sum in float32 in different orders, over at
most n = 1001 terms, so 1e-5 of max|G| leaves two orders of magnitude of margin.
The sampled rows of the sampling kinds (uniform, leverage, the hybrid's first
stage) and their scales are compared bitwise; leverage sketches get the same
scores on both sides, with sums exact in float32, so the draws are compared apart
from the QR behind the scores.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as jops, sketches as jsk, solve as jsolve
from repro.utils import prng as jprng
from repro_torch.core import operators as tops, sketches as tsk, solve as tsolve
from repro_torch.kernels import cuda as tcuda
from repro_torch.kernels import common as tc
from repro_torch.kernels.fwht import ops as fops, ref as fref
from repro_torch.kernels.gaussian import ops as gops, ref as gref
from repro_torch.kernels.rademacher import ops as rops, ref as rref
from repro_torch.kernels.sjlt import ops as sops, ref as sref
from repro_torch.utils import prng as tprng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

REL_TOL = 1e-5
# Odd n with block_rows not dividing it: a ragged last tile on both paths.
N, D, M, Q, BLOCK = 1001, 7, 40, 3, 300
# Sketch kinds under test; "sjltK" is the SJLT with s = K nonzeros per column.
FAMILIES = ["gaussian", "rademacher", "srht", "sjlt1", "sjlt4", "sjlt20"]
# The sampling kinds: "uniform_norep" samples without replacement, "hybrid_K"
# is the hybrid with inner kind K over M_PRIME uniformly sampled rows.
HYBRIDS = ["hybrid_gaussian", "hybrid_rademacher", "hybrid_sjlt", "hybrid_srht"]
SAMPLING = ["uniform", "uniform_norep", "leverage"] + HYBRIDS
ALL = FAMILIES + SAMPLING
M_PRIME, HYBRID_S = 150, 4
# Kinds whose S has column tiles (the SJLT streams segment sums instead).
TILED = ["gaussian", "rademacher", "srht"]


def _spec(sk, kind, m=M, **kw):
    """``SketchSpec`` of either package for an ALL entry."""
    if kind.startswith("sjlt"):
        return sk.SketchSpec("sjlt", m, s=int(kind[4:]), **kw)
    if kind == "uniform_norep":
        return sk.SketchSpec("uniform", m, replacement=False, **kw)
    if kind.startswith("hybrid_"):
        return sk.SketchSpec("hybrid", m, m_prime=M_PRIME, inner=kind[7:], s=HYBRID_S, **kw)
    return sk.SketchSpec(kind, m, **kw)


def _scores(kind, A):
    """Leverage scores for both packages (None for other kinds): the reference's,
    rounded to multiples of 2**-16 so that every float32 sum of them is exact."""
    if kind != "leverage":
        return None
    sc = np.asarray(jsk.leverage_scores(jnp.asarray(A)))
    return np.maximum(np.round(sc * 2**16), 1).astype(np.float32) / 2**16


def _both(x):
    """(jax array, torch tensor) of a numpy array, or (None, None)."""
    return (None, None) if x is None else (jnp.asarray(x), torch.from_numpy(x))


def _data(seed=0, k=None):
    rs = np.random.default_rng(seed)
    A = rs.standard_normal((N, D)).astype(np.float32)
    b = rs.standard_normal((N,) if k is None else (N, k)).astype(np.float32)
    return A, b


def _keys(seed=5):
    jkey = jax.random.PRNGKey(seed)
    return jkey, tprng.from_key_data(np.asarray(jax.random.key_data(jkey)))


def _close(got: torch.Tensor, want, tol=REL_TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got.numpy() - want).max() / scale
    assert err <= tol, f"max rel err {err} > {tol}"


@pytest.mark.parametrize("kind", TILED)
@pytest.mark.parametrize("j0,block", [(0, N), (37, 64), (1000, 1)])
def test_columns_match_reference(kind, j0, block):
    jkey, tkey = _keys()
    want = jops.make_operator(jsk.SketchSpec(kind, M), jkey, N).columns(j0, block)
    got = tops.make_operator(tsk.SketchSpec(kind, M), tkey, N).columns(j0, block)
    if kind in ("rademacher", "srht"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6 / np.sqrt(M))


@pytest.mark.parametrize("kind", ALL)
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_b", [True, False])
def test_gram_blocked_matches_reference(kind, use_kernel, with_b):
    A, b = _data(1)
    jkey, tkey = _keys(2)
    jb = jnp.asarray(b) if with_b else None
    tb = torch.from_numpy(b) if with_b else None
    js, ts = _both(_scores(kind, A))
    Gj, cj = jops.gram_blocked(_spec(jsk, kind, use_kernel=use_kernel), jkey, jnp.asarray(A), jb,
                               block_rows=BLOCK, scores=js)
    Gt, ct = tops.gram_blocked(_spec(tsk, kind, use_kernel=use_kernel), tkey, torch.from_numpy(A), tb,
                               block_rows=BLOCK, scores=ts)
    _close(Gt, Gj)
    if with_b:
        scale = np.abs(np.asarray(Gj)).max()
        assert np.abs(ct.numpy() - np.asarray(cj)).max() <= REL_TOL * scale
    else:
        assert ct is None


@pytest.mark.parametrize("kind", ALL)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_gram_batched_matches_reference(kind, use_kernel):
    A, b = _data(3)
    jkey, tkey = _keys(4)
    js, ts = _both(_scores(kind, A))
    Gj, cj = jops.gram_batched(_spec(jsk, kind, use_kernel=use_kernel), jprng.worker_keys(jkey, Q, 1),
                               jnp.asarray(A), jnp.asarray(b), scores=js)
    Gt, ct = tops.gram_batched(_spec(tsk, kind, use_kernel=use_kernel), tprng.worker_keys(tkey, Q, 1),
                               torch.from_numpy(A), torch.from_numpy(b), scores=ts)
    assert Gt.shape == (Q, D, D) and ct.shape == (Q, D)
    _close(Gt, Gj)
    scale = np.abs(np.asarray(Gj)).max()
    assert np.abs(ct.numpy() - np.asarray(cj)).max() <= REL_TOL * scale


def test_gram_batched_matrix_b_and_no_b():
    A, b = _data(5, k=2)
    _, tkey = _keys(6)
    keys = tprng.worker_keys(tkey, 2)
    spec = tsk.SketchSpec("gaussian", M)
    Gs, cs = tops.gram_batched(spec, keys, torch.from_numpy(A), torch.from_numpy(b))
    assert cs.shape == (2, D, 2)
    G1, c1 = tops.gram_blocked(spec, keys[1], torch.from_numpy(A), torch.from_numpy(b))
    torch.testing.assert_close(Gs[1], G1, rtol=0, atol=0)
    Gn, cn = tops.gram_batched(spec, keys, torch.from_numpy(A))
    assert cn is None and Gn.shape == (2, D, D)


@pytest.mark.parametrize("kind", ALL)
def test_apply_and_apply_blocked_match_reference(kind):
    A, _ = _data(7)
    jkey, tkey = _keys(8)
    js, ts = _both(_scores(kind, A))
    want = np.asarray(jops.make_operator(_spec(jsk, kind), jkey, N, scores=js).apply(jnp.asarray(A)))
    op = tops.make_operator(_spec(tsk, kind), tkey, N, scores=ts)
    _close(op.apply(torch.from_numpy(A)), want)
    _close(op.apply_blocked(torch.from_numpy(A), block_rows=BLOCK), want)
    assert op.shape == (M, N)


@pytest.mark.parametrize("kind", ALL)
@pytest.mark.parametrize("method", ["fused", "qr"])
def test_sketch_and_solve_matches_reference(kind, method):
    A, b = _data(9)
    jkey, tkey = _keys(10)
    xj = jsolve.sketch_and_solve(_spec(jsk, kind), jkey, jnp.asarray(A), jnp.asarray(b), method=method)
    xt = tsolve.sketch_and_solve(_spec(tsk, kind), tkey, torch.from_numpy(A), torch.from_numpy(b), method=method)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("method", ["qr", "chol"])
@pytest.mark.parametrize("reg", [0.0, 0.5])
def test_lstsq_matches_reference(method, reg):
    A, b = _data(11)
    xj = jsolve.lstsq(jnp.asarray(A), jnp.asarray(b), reg=reg, method=method)
    xt = tsolve.lstsq(torch.from_numpy(A), torch.from_numpy(b), reg=reg, method=method)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-6)
    fj = jsolve.relative_error(jnp.asarray(A), jnp.asarray(b), xj, 1.0)
    ft = tsolve.relative_error(torch.from_numpy(A), torch.from_numpy(b), xt, 1.0)
    assert abs(float(ft) - float(fj)) <= 1e-4 * abs(float(fj))


def test_lstsq_gram_batches_like_single_solves():
    rs = np.random.default_rng(12)
    X = rs.standard_normal((4, 30, D))
    G = torch.from_numpy(np.einsum("qnd,qne->qde", X, X))
    c = torch.from_numpy(rs.standard_normal((4, D)))
    xs = tsolve.lstsq_gram(G, c, reg=0.1)
    for w in range(4):
        want = jsolve.lstsq_gram(jnp.asarray(G[w].numpy()), jnp.asarray(c[w].numpy()), reg=0.1)
        np.testing.assert_allclose(xs[w].numpy(), np.asarray(want), rtol=1e-5)
    An = rs.standard_normal((30, D)).astype(np.float32)
    bn = rs.standard_normal(30).astype(np.float32)
    want = jsolve.lstsq(jnp.asarray(An), jnp.asarray(bn), method="cg")
    got = tsolve.lstsq(torch.from_numpy(An), torch.from_numpy(bn), method="cg")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="unknown method"):
        tsolve.lstsq(torch.zeros(3, 2), torch.zeros(3), method="svd")


def test_spec_validation_matches_reference():
    assert tsk.KINDS == jsk.KINDS
    assert [f.name for f in dataclasses.fields(tsk.SketchSpec)] == [
        f.name for f in dataclasses.fields(jsk.SketchSpec)
    ]
    for bad in (dict(kind="nope", m=4), dict(kind="gaussian", m=0), dict(kind="hybrid", m=8, m_prime=4)):
        with pytest.raises(ValueError):
            tsk.SketchSpec(**bad)
    assert tops.registered_kinds() == tuple(sorted(tsk.KINDS))
    assert not hasattr(tops, "PENDING")
    with pytest.raises(ValueError, match="no SketchOp registered"):
        tops.make_operator(types.SimpleNamespace(kind="nope"), tprng.prng_key(0), N)


@pytest.mark.parametrize("seed", [0, 11, 2**31 - 1])
@pytest.mark.parametrize("n", [1, 2, 1001, 1024, 1025])
def test_srht_rows_and_diagonal_words_bitwise(seed, n):
    jkey, tkey = _keys(seed)
    jop = jops.make_operator(jsk.SketchSpec("srht", M), jkey, n)
    top = tops.make_operator(tsk.SketchSpec("srht", M), tkey, n)
    assert top.n_pad == jop.n_pad == tsk.next_pow2(n)
    np.testing.assert_array_equal(top.rows.numpy(), np.asarray(jop.rows).astype(np.int64))
    assert (top.kd0, top.kd1) == (int(jop.kd0), int(jop.kd1))
    # The batched draw the multi-worker path uses agrees with per-key builds.
    keys = tprng.worker_keys(tkey, Q)
    kd, rows = tops.srht_params(keys, M, tsk.next_pow2(n))
    for w in range(Q):
        op = tops.make_operator(tsk.SketchSpec("srht", M), keys[w], n)
        assert torch.equal(rows[w], op.rows) and tuple(kd[w].tolist()) == (op.kd0, op.kd1)


@pytest.mark.parametrize("n", [1, 2, 64, 1000])
def test_fwht_matches_reference(n):
    x = np.random.default_rng(n).standard_normal((tsk.next_pow2(n), 3)).astype(np.float32)
    np.testing.assert_allclose(tsk._fwht(torch.from_numpy(x)).numpy(), np.asarray(jsk._fwht(jnp.asarray(x))),
                               rtol=0, atol=1e-5 * max(1, np.sqrt(x.shape[0])))
    assert tsk.next_pow2(n) == jsk.next_pow2(n)
    with pytest.raises(ValueError, match="power-of-two"):
        tsk._fwht(torch.zeros(3, 2))


@pytest.mark.parametrize("s", [1, 4, 20])
def test_sjlt_params_match_reference(s):
    from repro.kernels.sjlt import ops as jsops

    jkey, tkey = _keys(s)
    bj, sj = jsops.sjlt_params(jkey, N, s, M)
    bt, st = sops.sjlt_params(tkey, N, s, M)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj).astype(np.int64))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize(
    "single,multi,ref_single,ref_multi,launches",
    [
        (gops.gaussian_gram, gops.gaussian_gram_multi, gref.gaussian_gram, gref.gaussian_gram_multi, gops.LAUNCHES),
        (rops.rademacher_gram, rops.rademacher_gram_multi, rref.rademacher_gram, rref.rademacher_gram_multi, rops.LAUNCHES),
    ],
)
def test_wrappers_take_the_plain_version_on_cpu_and_raise_elsewhere(single, multi, ref_single, ref_multi, launches):
    A, _ = _data(13)
    X = torch.from_numpy(A)
    keys = tprng.worker_keys(tprng.prng_key(3), 2)
    before = dict(launches)
    torch.testing.assert_close(single(keys[0], X, M), ref_single(keys[0], X, M), rtol=0, atol=0)
    Gm = multi(keys, X, M)
    torch.testing.assert_close(Gm, ref_multi(keys, X, M), rtol=0, atol=0)
    assert dict(launches) == before  # the counters count kernel launches only
    with pytest.raises(ValueError, match="CUDA kernel"):
        single(keys[0], torch.empty((N, D), device="meta"), M)
    with pytest.raises(ValueError, match="CUDA kernel"):
        multi(keys, torch.empty((N, D), device="meta"), M)


@pytest.mark.parametrize(
    "ref,gram", [(gref, gref.gaussian_gram), (rref, rref.rademacher_gram)], ids=FAMILIES[:2]
)
@pytest.mark.parametrize("block_rows", [64, 1000, 4096])
def test_plain_gram_is_blocking_invariant_to_tolerance(ref, gram, block_rows):
    A, _ = _data(14)
    X = torch.from_numpy(A)
    key = tprng.prng_key(9)
    SX = ref.sketch_matrix(key, M, N).double() @ X.double()
    _close(gram(key, X, M, block_rows=block_rows), (SX.T @ SX).numpy())


@pytest.mark.parametrize("kind", ["srht", "sjlt4", "sjlt20"])
def test_new_wrappers_take_the_plain_version_on_cpu_and_raise_elsewhere(kind):
    A, _ = _data(13)
    X = torch.from_numpy(A)
    keys = tprng.worker_keys(tprng.prng_key(3), 2)
    if kind == "srht":
        kd, rows = tops.srht_params(keys, M, tsk.next_pow2(N))
        single, multi = (lambda w, Y: fops.srht_gram(kd[w], rows[w], Y)), (lambda Y: fops.srht_gram_multi(kd, rows, Y))
        ref_single, ref_multi = fref.srht_gram(kd[0], rows[0], X), fref.srht_gram_multi(kd, rows, X)
        launches = fops.LAUNCHES
    else:
        s = int(kind[4:])
        single, multi = (lambda w, Y: sops.sjlt_gram(keys[w], Y, M, s)), (lambda Y: sops.sjlt_gram_multi(keys, Y, M, s))
        ref_single, ref_multi = sref.sjlt_gram(keys[0], X, M, s), sref.sjlt_gram_multi(keys, X, M, s)
        launches = sops.LAUNCHES
    before = dict(launches)
    torch.testing.assert_close(single(0, X), ref_single, rtol=0, atol=0)
    Gm = multi(X)
    torch.testing.assert_close(Gm, ref_multi, rtol=0, atol=0)
    torch.testing.assert_close(Gm[1], single(1, X), rtol=0, atol=0)
    assert dict(launches) == before  # the counters count kernel launches only
    with pytest.raises(ValueError, match="CUDA kernel"):
        single(0, torch.empty((N, D), device="meta"))
    with pytest.raises(ValueError, match="CUDA kernel"):
        multi(torch.empty((N, D), device="meta"))


@pytest.mark.parametrize("kind", ["srht", "sjlt1", "sjlt4", "sjlt20"])
@pytest.mark.parametrize("block_rows", [64, 1000, 4096])
def test_new_plain_grams_are_blocking_invariant_to_tolerance(kind, block_rows):
    A, _ = _data(14)
    X = torch.from_numpy(A)
    key = tprng.prng_key(9)
    if kind == "srht":
        kd, rows = tops.srht_params(key, M, tsk.next_pow2(N))
        S = fref.columns(*tc.key_words(kd), rows, 0, N)
        G = fref.srht_gram(kd, rows, X, block_rows=block_rows)
    else:
        s = int(kind[4:])
        buckets, signs = sops.sjlt_params(key, N, s, M)
        S = torch.zeros((M, N), dtype=torch.float64)
        S.index_put_((buckets, torch.arange(N)[:, None].expand(N, s)), signs.double(), accumulate=True)
        G = sref.sjlt_gram(key, X, M, s, block_rows=block_rows)
    SX = S.double() @ X.double()
    _close(G, (SX.T @ SX).numpy())


@pytest.mark.parametrize("n,m,d", [(500_000, 2500, 251), (1001, 40, 8), (31, 7, 300), (2**20, 64, 4),
                                   (25_000, 2500, 251), (1, 1, 1), (5, 40, 3), (33, 2500, 251)])
def test_plan_splits_covers_n_in_word_aligned_splits(n, m, d):
    plan = tcuda.plan_dense_gram(n, m, d)  # the dense Grams' n-splits
    n_splits, rows = plan.n_splits, plan.rows_per_split
    assert rows % 32 == 0
    assert (n_splits - 1) * rows < n <= n_splits * rows
    assert n_splits == 1 or rows >= 32 * tcuda.MIN_SPLIT_STEPS


@pytest.mark.parametrize("n,m,d,s", [(500_000, 2500, 251, 20), (1001, 40, 8, 4), (1000, 3100, 9, 1),
                                     (33, 1, 1, 20), (2**20, 1537, 300, 2048), (25_000, 2500, 251, 20),
                                     (1, 1, 1, 1), (5, 40, 3, 4), (150, 40, 8, 4)])
def test_plan_sjlt_covers_n_and_fits_the_kernel(n, m, d, s):
    plan = tcuda.plan_sjlt(n, m, d, s)
    assert (plan.n_splits - 1) * plan.rows_per_split < n <= plan.n_splits * plan.rows_per_split
    assert plan.rows_per_split % plan.chunk_rows == 0
    assert plan.chunk_rows <= tcuda.SJLT_MAX_CHUNK_ROWS and plan.chunk_rows * s <= tcuda.SJLT_MAX_PAIRS
    m_tiles = -(-m // plan.bucket_tile)
    assert plan.bucket_tile * tcuda.SJLT_BLOCK_COLS <= tcuda.SJLT_MAX_ACC and (m_tiles - 1) * plan.bucket_tile < m
    assert plan == tcuda.plan_sjlt(n, m, d, s)  # shapes only: never q
    # A worker's n-split partials and binned pair list fit the scratch of one call.
    chunk = tcuda.worker_chunk(n, m, d, 200, family="sjlt", s=s)
    assert chunk == 1 or chunk * 4 * (plan.n_splits * m * d + plan.list_ints) <= tcuda.SCRATCH_BYTES
    with pytest.raises(ValueError, match="s="):
        tcuda.plan_sjlt(n, m, d, tcuda.SJLT_MAX_PAIRS + 1)


def test_nvcc_command_targets_hopper_without_fast_math(tmp_path):
    cmd = tcuda.nvcc_command("nvcc", "sketch_gram", tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert not any("fast_math" in a or "fast-math" in a for a in cmd)
    assert cmd[-1].endswith("sketch_gram.cu") and (tcuda.CSRC / "sketch_gram.cu").is_file()
    assert set(tcuda.SOURCES) == {p.stem for p in tcuda.CSRC.glob("*.cu")}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(tcuda, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tcuda.build()
    assert not (tmp_path / "build").exists()


# ------------------------------------------------ sampling kinds and S·A kernels


@pytest.mark.parametrize("kind", SAMPLING)
@pytest.mark.parametrize("seed", [0, 17, 2**31 - 1])
def test_sampled_rows_bitwise(kind, seed):
    """Each operator's sampled rows (and leverage scales, and the hybrid's inner
    operator) are bitwise the reference's."""
    A, _ = _data(seed % 7)
    jkey, tkey = _keys(seed)
    js, ts = _both(_scores(kind, A))
    jop = jops.make_operator(_spec(jsk, kind), jkey, N, scores=js)
    top = tops.make_operator(_spec(tsk, kind), tkey, N, scores=ts)
    np.testing.assert_array_equal(top.rows.numpy(), np.asarray(jop.rows).astype(np.int64))
    if kind == "leverage":
        np.testing.assert_array_equal(top.scales.numpy(), np.asarray(jop.scales))
    if kind.startswith("hybrid_"):
        assert top.inner.n == jop.inner.n == M_PRIME
        assert tuple(top.inner.key.tolist()) == tuple(np.asarray(jax.random.key_data(jop.inner.key)).tolist())
        if kind == "hybrid_srht":
            assert top.inner.n_pad == jop.inner.n_pad == tsk.next_pow2(M_PRIME)
            np.testing.assert_array_equal(top.inner.rows.numpy(), np.asarray(jop.inner.rows).astype(np.int64))


@pytest.mark.parametrize("kind", FAMILIES)
def test_apply_with_kernel_matches_reference(kind):
    """``apply`` with ``use_kernel=True``: the port's kernel wrappers (plain versions on
    CPU tensors) against the reference's Pallas S·A kernels in interpret mode."""
    A, _ = _data(15, k=3)
    jkey, tkey = _keys(16)
    want = jops.make_operator(_spec(jsk, kind, use_kernel=True), jkey, N).apply(jnp.asarray(A))
    got = tops.make_operator(_spec(tsk, kind, use_kernel=True), tkey, N).apply(torch.from_numpy(A))
    _close(got, want)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("kind", ALL)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_batched_matches_reference(kind, use_kernel):
    A, _ = _data(17)
    jkey, tkey = _keys(18)
    js, ts = _both(_scores(kind, A))
    want = jops.apply_batched(_spec(jsk, kind, use_kernel=use_kernel), jprng.worker_keys(jkey, Q, 2),
                              jnp.asarray(A), scores=js)
    keys = tprng.worker_keys(tkey, Q, 2)
    got = tops.apply_batched(_spec(tsk, kind, use_kernel=use_kernel), keys, torch.from_numpy(A), scores=ts)
    assert got.shape == (Q, M, D)
    _close(got, want)
    # Worker slices are the per-key applies, bitwise (the multi-key kernel path included).
    one = tops.make_operator(_spec(tsk, kind, use_kernel=use_kernel), keys[Q - 1], N, scores=ts)
    assert torch.equal(got[Q - 1], one.apply(torch.from_numpy(A)))


@pytest.mark.parametrize("kind", ALL)
@pytest.mark.parametrize("k", [None, 2])
def test_sketch_data_batched_matches_reference(kind, k):
    """(S_k A, S_k b) for q keys; a leverage sketch takes its scores from [A | b]
    on both sides (computed by each package, so compared to tolerance)."""
    A, b = _data(19, k=k)
    jkey, tkey = _keys(20)
    spec_j, spec_t = _spec(jsk, kind, use_kernel=True), _spec(tsk, kind, use_kernel=True)
    SAj, Sbj = jops.sketch_data_batched(spec_j, jprng.worker_keys(jkey, Q), jnp.asarray(A), jnp.asarray(b))
    SAt, Sbt = tops.sketch_data_batched(spec_t, tprng.worker_keys(tkey, Q), torch.from_numpy(A), torch.from_numpy(b))
    assert SAt.shape == (Q, M, D) and Sbt.shape == ((Q, M) if k is None else (Q, M, k))
    _close(SAt, SAj)
    _close(Sbt, Sbj)


@pytest.mark.parametrize("method", ["qr", "svd", "approx"])
def test_leverage_scores_match_reference(method):
    """Scores from a float32 QR/SVD of another library: 1e-5 of the largest score
    (the factorizations round differently; the scores sum to d = 7 here)."""
    rs = np.random.default_rng(21)
    A = (rs.standard_normal((2000, 5)) * rs.standard_normal((2000, 1)) ** 2).astype(np.float32)
    jkey, tkey = _keys(22)
    want = np.asarray(jsk.leverage_scores(jnp.asarray(A), method=method, key=jkey))
    got = tsk.leverage_scores(torch.from_numpy(A), method=method, key=tkey)
    _close(got, want, tol=1e-5 if method != "approx" else 1e-4)
    assert abs(float(got.sum()) - (5 if method != "approx" else float(want.sum()))) < 1e-2
    # Too few rows to sketch: approx is exact.
    small = torch.from_numpy(A[:30])
    torch.testing.assert_close(tsk.leverage_scores(small, method="approx"), tsk.leverage_scores(small))
    with pytest.raises(ValueError, match="unknown leverage method"):
        tsk.leverage_scores(small, method="lu")


def test_leverage_operator_needs_scores_and_functional_api_computes_them():
    A, _ = _data(23)
    with pytest.raises(ValueError, match="scores="):
        tops.make_operator(tsk.SketchSpec("leverage", M), tprng.prng_key(0), N)
    # apply() computes the scores from A, as the reference does.
    jkey, tkey = _keys(24)
    want = jops.apply(jsk.SketchSpec("leverage", M), jkey, jnp.asarray(A))
    _close(tops.apply(tsk.SketchSpec("leverage", M), tkey, torch.from_numpy(A)), want)


@pytest.mark.parametrize("name", ["gaussian", "rademacher", "srht", "uniform", "leverage", "sjlt", "hybrid"])
def test_functional_wrappers_match_reference(name):
    A, _ = _data(25)
    jkey, tkey = _keys(26)
    extra = {"hybrid": (2 * M,)}.get(name, ())
    kw = {"uniform": dict(replacement=False), "sjlt": dict(s=3), "hybrid": dict(inner="sjlt", s=2)}.get(name, {})
    want = getattr(jsk, f"{name}_sketch")(jkey, jnp.asarray(A), M, *extra, **kw)
    got = getattr(tsk, f"{name}_sketch")(tkey, torch.from_numpy(A), M, *extra, **kw)
    _close(got, want)


@pytest.mark.parametrize("kind", ["gaussian", "rademacher", "sjlt4", "sjlt20"])
def test_apply_wrappers_take_the_plain_version_on_cpu_and_raise_elsewhere(kind):
    A, _ = _data(27)
    X = torch.from_numpy(A)
    keys = tprng.worker_keys(tprng.prng_key(5), 2)
    if kind.startswith("sjlt"):
        s = int(kind[4:])
        single = lambda w, Y: sops.sjlt_apply(keys[w], Y, M, s)
        multi = lambda Y: sops.sjlt_apply_multi(keys, Y, M, s)
        plain = lambda w: sref.sketch(keys[w], X, M, s)
        launches = sops.LAUNCHES
    else:
        ops, ref = (gops, gref) if kind == "gaussian" else (rops, rref)
        single = lambda w, Y: getattr(ops, f"{kind}_sketch")(keys[w], Y, M)
        multi = lambda Y: getattr(ops, f"{kind}_sketch_multi")(keys, Y, M)
        plain = lambda w: ref.sketch(keys[w], X, M)
        launches = ops.LAUNCHES
    before = dict(launches)
    torch.testing.assert_close(single(0, X), plain(0), rtol=0, atol=0)
    SX = multi(X)
    assert SX.shape == (2, M, D)
    torch.testing.assert_close(SX[1], single(1, X), rtol=0, atol=0)
    assert dict(launches) == before  # the counters count kernel launches only
    with pytest.raises(ValueError, match="CUDA kernel"):
        single(0, torch.empty((N, D), device="meta"))
    with pytest.raises(ValueError, match="CUDA kernel"):
        multi(torch.empty((N, D), device="meta"))


@pytest.mark.parametrize("n", [1, 2, 8, 1024, 2048])
def test_fwht_wrapper_is_the_plain_version_on_cpu(n):
    """On a CPU tensor ``fwht`` is the plain ``_fwht`` (bitwise); both agree with the
    reference's Kronecker-product FWHT kernel (interpret mode) to tolerance."""
    from repro.kernels.fwht import ops as jfops

    x = np.random.default_rng(n).standard_normal((n, 5)).astype(np.float32)
    before = dict(fops.LAUNCHES)
    got = fops.fwht(torch.from_numpy(x))
    assert torch.equal(got, tsk._fwht(torch.from_numpy(x))) and torch.equal(got, fref.fwht(torch.from_numpy(x)))
    assert dict(fops.LAUNCHES) == before
    np.testing.assert_allclose(got.numpy(), np.asarray(jfops.fwht(jnp.asarray(x))), rtol=0,
                               atol=1e-5 * np.sqrt(n) * np.abs(x).max())
    with pytest.raises(ValueError, match="CUDA kernel"):
        fops.fwht(torch.empty((n, 5), device="meta"))


@pytest.mark.parametrize("n,want", [(1, (0,)), (2, (1,)), (1024, (10,)), (2048, (6, 5)), (2**15, (8, 7)),
                                    (2**19, (10, 9)), (2**20, (10, 10)), (2**21, (7, 7, 7))])
def test_plan_fwht_cuts_stages_into_fewest_even_passes(n, want):
    plan = tcuda.plan_fwht(n)
    assert plan == want
    assert sum(plan) == n.bit_length() - 1 and max(plan) <= tcuda.FWHT_MAX_TILE_BITS
    with pytest.raises(ValueError, match="power-of-two"):
        tcuda.plan_fwht(n + 3 if n > 1 else 3)
