"""Algorithm 1 in the port against a composition of the JAX reference's parts.

The reference's own distributed entry points go through ``shard_map`` meshes, so the
oracle is built from its mesh-free parts on the same numpy-made inputs:

* master mode: ``operators.gram_batched(spec, worker_keys(key, q, r), A, b)``,
  then ``solve.lstsq_gram`` per worker, then ``averaging.masked_average``;
* worker mode: ``solve.sketch_and_solve(spec, worker_key(key, w, r), A, b)`` per
  worker, then ``masked_average``;
* master mode with ``method="qr"``/``"chol"``: ``operators.sketch_data_batched``,
  then ``solve.lstsq`` per worker, then ``masked_average`` (the reference's
  ``distributed_sketch_solve_master`` without its mesh).

The sampling kinds draw the same rows as the reference (bitwise, tested in
``test_torch_operators.py``); a leverage sketch's scores come from each
package's own float32 QR here, as in the entry points.

x̄ is compared to 1e-4 relative: the d×d solves amplify the Grams' float32
differences (≤ 1e-5 of max|G|) by the sketched problem's condition number.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_lsq as jcfg
from repro.core import averaging as javg, operators as jops, sketches as jsk, solve as jsolve, theory as jtheory
from repro.utils import prng as jprng
from repro_torch.configs import paper_lsq as tcfg
from repro_torch.core import averaging as tavg, distributed as tdist, sketches as tsk, solve as tsolve, theory as ttheory
from repro_torch.data import regression as tdata
from repro_torch.utils import prng as tprng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

N, D, M, Q = 777, 6, 36, 4
FAMILIES = ["gaussian", "rademacher", "srht", "sjlt"]
# The sampling kinds: "uniform_norep" without replacement, "hybrid_K" the hybrid
# with inner kind K over M_PRIME uniformly sampled rows.
SAMPLING = ["uniform", "uniform_norep", "leverage", "hybrid_gaussian", "hybrid_rademacher",
            "hybrid_sjlt", "hybrid_srht"]
SJLT_S = 20  # FIG3A's nonzeros per column (RegressionConfig.s)
M_PRIME = 10 * M  # FIG3A's m′/m


def _spec(sk, kind, **kw):
    if kind == "sjlt":
        return sk.SketchSpec(kind, M, s=SJLT_S, **kw)
    if kind == "uniform_norep":
        return sk.SketchSpec("uniform", M, replacement=False, **kw)
    if kind.startswith("hybrid_"):
        return sk.SketchSpec("hybrid", M, m_prime=M_PRIME, inner=kind[7:], s=SJLT_S, **kw)
    return sk.SketchSpec(kind, M, **kw)
MASKS = {"all": None, "stragglers": np.array([1, 0, 1, 1], np.float32)}


def _problem(seed):
    rs = np.random.default_rng(seed)
    A = rs.standard_normal((N, D)).astype(np.float32)
    x = rs.standard_normal(D).astype(np.float32)
    b = (A @ x + 0.1 * rs.standard_normal(N)).astype(np.float32)
    return A, b


def _keys(seed):
    jkey = jax.random.PRNGKey(seed)
    return jkey, tprng.from_key_data(np.asarray(jax.random.key_data(jkey)))


def _oracle_master(spec, jkey, A, b, mask, round_id):
    Gs, cs = jops.gram_batched(spec, jprng.worker_keys(jkey, Q, round_id), jnp.asarray(A), jnp.asarray(b))
    xs = jnp.stack([jsolve.lstsq_gram(Gs[w], cs[w]) for w in range(Q)])
    return np.asarray(javg.masked_average(xs, None if mask is None else jnp.asarray(mask)))


def _oracle_worker(spec, jkey, A, b, mask, round_id):
    xs = jnp.stack(
        [jsolve.sketch_and_solve(spec, jprng.worker_key(jkey, w, round_id), jnp.asarray(A), jnp.asarray(b)) for w in range(Q)]
    )
    return np.asarray(javg.masked_average(xs, None if mask is None else jnp.asarray(mask)))


@pytest.mark.parametrize("kind", FAMILIES + SAMPLING)
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("mask", list(MASKS), ids=list(MASKS))
def test_master_mode_matches_oracle(kind, use_kernel, mask):
    A, b = _problem(1)
    jkey, tkey = _keys(2)
    want = _oracle_master(_spec(jsk, kind, use_kernel=use_kernel), jkey, A, b, MASKS[mask], 3)
    got = tdist.distributed_sketch_solve_master(
        _spec(tsk, kind, use_kernel=use_kernel), tkey, torch.from_numpy(A), torch.from_numpy(b),
        q=Q, round_id=3, straggler_mask=MASKS[mask], device="cpu",
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", FAMILIES + SAMPLING)
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("mask", list(MASKS), ids=list(MASKS))
def test_worker_mode_matches_oracle(kind, use_kernel, mask):
    A, b = _problem(4)
    jkey, tkey = _keys(5)
    want = _oracle_worker(_spec(jsk, kind, use_kernel=use_kernel), jkey, A, b, MASKS[mask], 1)
    got = tdist.distributed_sketch_solve(
        _spec(tsk, kind, use_kernel=use_kernel), tkey, torch.from_numpy(A), torch.from_numpy(b),
        q=Q, round_id=1, straggler_mask=MASKS[mask], device="cpu",
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def _oracle_master_two_pass(spec, jkey, A, b, mask, round_id, method):
    SA, Sb = jops.sketch_data_batched(spec, jprng.worker_keys(jkey, Q, round_id), jnp.asarray(A), jnp.asarray(b))
    xs = jnp.stack([jsolve.lstsq(SA[w], Sb[w], method=method) for w in range(Q)])
    return np.asarray(javg.masked_average(xs, None if mask is None else jnp.asarray(mask)))


@pytest.mark.parametrize("kind", FAMILIES + SAMPLING)
@pytest.mark.parametrize("method", ["qr", "chol"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_master_two_pass_matches_oracle(kind, method, use_kernel):
    """Master mode with ``method="qr"``/``"chol"``: the S·A kernels (their plain
    versions on the CPU) through ``sketch_data_batched``, a factorization per worker."""
    A, b = _problem(14)
    jkey, tkey = _keys(15)
    mask = MASKS["stragglers"]
    want = _oracle_master_two_pass(_spec(jsk, kind, use_kernel=use_kernel), jkey, A, b, mask, 2, method)
    got = tdist.distributed_sketch_solve_master(
        _spec(tsk, kind, use_kernel=use_kernel), tkey, torch.from_numpy(A), torch.from_numpy(b),
        q=Q, round_id=2, straggler_mask=mask, method=method, device="cpu",
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", FAMILIES + SAMPLING)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_worker_two_pass_matches_oracle(kind, use_kernel):
    """Worker mode passes ``method`` on to ``sketch_and_solve``."""
    A, b = _problem(16)
    jkey, tkey = _keys(17)
    spec_j = _spec(jsk, kind, use_kernel=use_kernel)
    xs = jnp.stack([jsolve.sketch_and_solve(spec_j, jprng.worker_key(jkey, w, 0), jnp.asarray(A), jnp.asarray(b),
                                            method="qr") for w in range(Q)])
    want = np.asarray(javg.masked_average(xs, None))
    got = tdist.distributed_sketch_solve(_spec(tsk, kind, use_kernel=use_kernel), tkey, torch.from_numpy(A),
                                         torch.from_numpy(b), q=Q, method="qr", device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", FAMILIES)
def test_two_pass_and_fused_agree(kind):
    """Same S, other factorization: the qr x̄ lies within 1e-4 of the fused x̄."""
    A, b = _problem(18)
    spec = _spec(tsk, kind, use_kernel=True)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    for entry in (tdist.distributed_sketch_solve, tdist.distributed_sketch_solve_master):
        fused = entry(spec, tprng.prng_key(19), At, bt, q=Q, device="cpu")
        qr = entry(spec, tprng.prng_key(19), At, bt, q=Q, method="qr", device="cpu")
        assert float((qr - fused).abs().max() / fused.abs().max()) <= 1e-4


def test_modes_agree_and_rounds_draw_fresh_sketches():
    A, b = _problem(6)
    _, tkey = _keys(7)
    spec = tsk.SketchSpec("gaussian", M)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    master = tdist.distributed_sketch_solve_master(spec, tkey, At, bt, q=Q, device="cpu")
    worker = tdist.distributed_sketch_solve(spec, tkey, At, bt, q=Q, device="cpu")
    torch.testing.assert_close(master, worker, rtol=1e-4, atol=1e-5)
    other = tdist.distributed_sketch_solve_master(spec, tkey, At, bt, q=Q, round_id=1, device="cpu")
    assert not torch.allclose(master, other)


@pytest.mark.parametrize("kind", ["srht", "sjlt"])
def test_fig3a_kinds_take_the_config_s_and_run_both_entry_points(kind):
    """The SRHT and the SJLT (with FIG3A's own s) run through both entry points, with
    the kernel wrappers' plain versions on CPU tensors; the two modes agree, and
    another round draws other sketches."""
    A, b = _problem(12)
    spec = tsk.SketchSpec(kind, M, s=tcfg.FIG3A.s, use_kernel=True)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    key = tprng.prng_key(13)
    master = tdist.distributed_sketch_solve_master(spec, key, At, bt, q=Q, device="cpu")
    worker = tdist.distributed_sketch_solve(spec, key, At, bt, q=Q, device="cpu")
    assert master.shape == (D,) and bool(torch.isfinite(master).all())
    torch.testing.assert_close(master, worker, rtol=1e-4, atol=1e-5)
    other = tdist.distributed_sketch_solve_master(spec, key, At, bt, q=Q, round_id=1, device="cpu")
    assert not torch.allclose(master, other)


@pytest.mark.parametrize("entry", [tdist.distributed_sketch_solve, tdist.distributed_sketch_solve_master])
def test_empty_round_raises(entry):
    A, b = _problem(8)
    with pytest.raises(ValueError, match="no surviving workers"):
        entry(tsk.SketchSpec("gaussian", M), tprng.prng_key(0), torch.from_numpy(A), torch.from_numpy(b),
              q=Q, straggler_mask=np.zeros(Q, np.float32), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        entry(tsk.SketchSpec("gaussian", M), tprng.prng_key(0), torch.from_numpy(A), torch.from_numpy(b),
              q=Q, straggler_mask=np.ones(Q + 1, np.float32), device="cpu")


@pytest.mark.parametrize("on_empty", ["nan", "zero"])
@pytest.mark.parametrize("mask", [[0, 0, 0], [1, 0, 1], None])
def test_masked_average_matches_reference(on_empty, mask):
    xs = np.random.default_rng(9).standard_normal((3, 5)).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask, jnp.float32)
    tm = None if mask is None else torch.tensor(mask, dtype=torch.float32)
    want = np.asarray(javg.masked_average(jnp.asarray(xs), jm, on_empty=on_empty))
    got = tavg.masked_average(torch.from_numpy(xs), tm, on_empty=on_empty).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
    with pytest.raises(ValueError, match="on_empty"):
        tavg.masked_average(torch.from_numpy(xs), torch.zeros(3), on_empty="skip")


def test_streaming_average_matches_reference():
    xs = np.random.default_rng(10).standard_normal((6, 4)).astype(np.float32)
    js, ts = javg.StreamingAverage.init(4), tavg.StreamingAverage.init(4)
    for x in xs:
        js, ts = js.update(jnp.asarray(x)), ts.update(torch.from_numpy(x))
    np.testing.assert_allclose(ts.mean.numpy(), np.asarray(js.mean), rtol=1e-6)
    assert float(ts.count) == float(js.count) == 6


@pytest.mark.parametrize("m,d,q", [(2500, 250, 200), (40, 6, 4), (100, 10, 1)])
def test_theory_matches_reference(m, d, q):
    assert ttheory.gaussian_single_error(m, d) == jtheory.gaussian_single_error(m, d)
    assert ttheory.gaussian_averaged_error(m, d, q) == jtheory.gaussian_averaged_error(m, d, q)
    with pytest.raises(ValueError, match="m > d"):
        ttheory.gaussian_single_error(d + 1, d)


def test_fig3a_matches_reference_config():
    assert dataclasses.asdict(tcfg.FIG3A) == dataclasses.asdict(jcfg.FIG3A)
    assert [f.name for f in dataclasses.fields(tcfg.RegressionConfig)] == [
        f.name for f in dataclasses.fields(jcfg.RegressionConfig)
    ]


def test_gaussian_regression_is_seeded_and_planted():
    A, b, meta = tdata.gaussian_regression(3, 400, 5, device="cpu")
    A2, b2, _ = tdata.gaussian_regression(3, 400, 5, device="cpu")
    assert A.shape == (400, 5) and b.shape == (400,) and A.dtype == torch.float32
    assert torch.equal(A, A2) and torch.equal(b, b2)
    resid = b - A @ meta["x_truth"]
    assert 0.05 < float(resid.std()) < 0.2  # noise = 0.1
    _, b3, meta3 = tdata.gaussian_regression(3, 400, 5, planted=False, device="cpu")
    assert meta3["x_truth"] is None and b3.shape == (400,)


def test_averaged_error_tracks_theorem1_on_cpu():
    """Small Monte Carlo: the mean of rel_err over trials sits near d/(q(m−d−1))."""
    A, b, _ = tdata.gaussian_regression(11, 2000, 8, device="cpu")
    A64, b64 = A.double(), b.double()
    xstar = tsolve.lstsq(A64, b64)
    fstar = tsolve.residual_cost(A64, b64, xstar)
    spec = tsk.SketchSpec("gaussian", 60)
    errs = [
        float(tsolve.relative_error(A64, b64, tdist.distributed_sketch_solve_master(
            spec, tprng.prng_key(100 + t), A, b, q=4, device="cpu").double(), fstar))
        for t in range(12)
    ]
    pred = ttheory.gaussian_averaged_error(60, 8, 4)
    assert pred / 2 < np.mean(errs) < 2 * pred


def test_theory_ratio_script_measures_each_family():
    """``tests/theory_ratio.py`` (the measurement behind chip_smoke.py's SRHT/SJLT
    rel_err band) runs the reference on the port's planted data, at a tiny size."""
    import theory_ratio

    got = theory_ratio.ratios(3000, 5, 60, 8, [1])
    assert set(got) == set(theory_ratio.FAMILIES)
    assert all(len(v) == 1 and np.isfinite(v[0]) and v[0] > 0 for v in got.values())
