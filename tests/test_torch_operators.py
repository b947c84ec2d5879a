"""The port's operators, plain Gram versions and kernel wrappers against the JAX reference.

Same numpy-made inputs go to both packages. The reference runs its
``use_kernel=False`` streaming path and its ``use_kernel=True`` Pallas kernels in
interpret mode; the port runs its torch streaming path and, on CPU tensors, the
plain versions its kernel wrappers use there. Float outputs are compared relative
to their largest entry: both sides sum in float32 in different orders, over at
most n = 1001 terms, so 1e-5 of max|G| leaves two orders of magnitude of margin.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as jops, sketches as jsk, solve as jsolve
from repro.utils import prng as jprng
from repro_torch.core import operators as tops, sketches as tsk, solve as tsolve
from repro_torch.kernels import cuda as tcuda
from repro_torch.kernels.gaussian import ops as gops, ref as gref
from repro_torch.kernels.rademacher import ops as rops, ref as rref
from repro_torch.utils import prng as tprng

REL_TOL = 1e-5
# Odd n with block_rows not dividing it: a ragged last tile on both paths.
N, D, M, Q, BLOCK = 1001, 7, 40, 3, 300
FAMILIES = ["gaussian", "rademacher"]


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


@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("j0,block", [(0, N), (37, 64), (1000, 1)])
def test_columns_match_reference(kind, j0, block):
    jkey, tkey = _keys()
    want = jops.make_operator(jsk.SketchSpec(kind, M), jkey, N).columns(j0, block)
    got = tops.make_operator(tsk.SketchSpec(kind, M), tkey, N).columns(j0, block)
    if kind == "rademacher":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6 / np.sqrt(M))


@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_b", [True, False])
def test_gram_blocked_matches_reference(kind, use_kernel, with_b):
    A, b = _data(1)
    jkey, tkey = _keys(2)
    jb = jnp.asarray(b) if with_b else None
    tb = torch.from_numpy(b) if with_b else None
    Gj, cj = jops.gram_blocked(jsk.SketchSpec(kind, M, use_kernel=use_kernel), jkey, jnp.asarray(A), jb, block_rows=BLOCK)
    Gt, ct = tops.gram_blocked(tsk.SketchSpec(kind, M, use_kernel=use_kernel), tkey, torch.from_numpy(A), tb, block_rows=BLOCK)
    _close(Gt, Gj)
    if with_b:
        scale = np.abs(np.asarray(Gj)).max()
        assert np.abs(ct.numpy() - np.asarray(cj)).max() <= REL_TOL * scale
    else:
        assert ct is None


@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_gram_batched_matches_reference(kind, use_kernel):
    A, b = _data(3)
    jkey, tkey = _keys(4)
    Gj, cj = jops.gram_batched(jsk.SketchSpec(kind, M, use_kernel=use_kernel), jprng.worker_keys(jkey, Q, 1), jnp.asarray(A), jnp.asarray(b))
    Gt, ct = tops.gram_batched(tsk.SketchSpec(kind, M, use_kernel=use_kernel), tprng.worker_keys(tkey, Q, 1), torch.from_numpy(A), torch.from_numpy(b))
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


@pytest.mark.parametrize("kind", FAMILIES)
def test_apply_and_apply_blocked_match_reference(kind):
    A, _ = _data(7)
    jkey, tkey = _keys(8)
    want = np.asarray(jops.make_operator(jsk.SketchSpec(kind, M), jkey, N).apply(jnp.asarray(A)))
    op = tops.make_operator(tsk.SketchSpec(kind, M), tkey, N)
    _close(op.apply(torch.from_numpy(A)), want)
    _close(op.apply_blocked(torch.from_numpy(A), block_rows=BLOCK), want)
    assert op.shape == (M, N)


@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("method", ["fused", "qr"])
def test_sketch_and_solve_matches_reference(kind, method):
    A, b = _data(9)
    jkey, tkey = _keys(10)
    xj = jsolve.sketch_and_solve(jsk.SketchSpec(kind, M), jkey, jnp.asarray(A), jnp.asarray(b), method=method)
    xt = tsolve.sketch_and_solve(tsk.SketchSpec(kind, M), tkey, torch.from_numpy(A), torch.from_numpy(b), method=method)
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsolve.lstsq(torch.zeros(3, 2), torch.zeros(3), method="cg")
    with pytest.raises(ValueError, match="unknown method"):
        tsolve.lstsq(torch.zeros(3, 2), torch.zeros(3), method="svd")


@pytest.mark.parametrize("kind", ["srht", "sjlt", "uniform", "leverage"])
def test_unported_kinds_name_their_roadmap_entry(kind):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.make_operator(tsk.SketchSpec(kind, M), tprng.prng_key(0), N)


@pytest.mark.parametrize("inner", ["gaussian", "rademacher", "sjlt", "srht"])
def test_hybrid_names_its_roadmap_entry(inner):
    spec = tsk.SketchSpec("hybrid", M, m_prime=2 * M, inner=inner)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.gram_blocked(spec, tprng.prng_key(0), torch.zeros(N, D))


def test_spec_validation_matches_reference():
    assert tsk.KINDS == jsk.KINDS
    assert [f.name for f in dataclasses.fields(tsk.SketchSpec)] == [
        f.name for f in dataclasses.fields(jsk.SketchSpec)
    ]
    for bad in (dict(kind="nope", m=4), dict(kind="gaussian", m=0), dict(kind="hybrid", m=8, m_prime=4)):
        with pytest.raises(ValueError):
            tsk.SketchSpec(**bad)
    assert tops.registered_kinds() == ("gaussian", "rademacher")


def test_apply_with_kernel_raises_until_ported():
    op = tops.make_operator(tsk.SketchSpec("gaussian", M, use_kernel=True), tprng.prng_key(0), N)
    with pytest.raises(NotImplementedError, match="S·A kernel"):
        op.apply(torch.zeros(N, D))


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
    "ref,gram", [(gref, gref.gaussian_gram), (rref, rref.rademacher_gram)], ids=FAMILIES
)
@pytest.mark.parametrize("block_rows", [64, 1000, 4096])
def test_plain_gram_is_blocking_invariant_to_tolerance(ref, gram, block_rows):
    A, _ = _data(14)
    X = torch.from_numpy(A)
    key = tprng.prng_key(9)
    SX = ref.sketch_matrix(key, M, N).double() @ X.double()
    _close(gram(key, X, M, block_rows=block_rows), (SX.T @ SX).numpy())


@pytest.mark.parametrize("n,m,d", [(500_000, 2500, 251), (1001, 40, 8), (31, 7, 300), (2**20, 64, 4)])
def test_plan_splits_covers_n_in_word_aligned_splits(n, m, d):
    n_splits, rows = tcuda.plan_splits(n, m, d)
    assert rows % 32 == 0
    assert (n_splits - 1) * rows < n <= n_splits * rows
    assert n_splits == 1 or rows >= 32 * tcuda.MIN_SPLIT_STEPS


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
