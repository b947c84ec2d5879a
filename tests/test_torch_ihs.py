"""The port's Iterative Hessian Sketch against the JAX reference's ``ihs_trace``
and ``ihs_solve`` on the CPU, the same numpy data, ``use_kernel=False`` on the
reference's side.

Each iterate is compared to 1e-4 of its largest entry: the Hessians agree to
float32 rounding (≤ 1e-5 of max|G|; the Gaussian's normals differ by ulps) and
each step solves with a fresh one, so the iterates drift apart by the
Hessian's condition number times that per step, while both converge to the
same x*. The port's ``use_kernel=True`` (the multi-worker Gram wrappers' plain
versions on a CPU tensor) is held to the same trace.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ihs as jihs, sketches as jsk
from repro_torch.core import ihs as tihs, operators as tops, sketches as tsk
from repro_torch.utils import prng as tprng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

N, D, M = 2000, 8, 64
TOL = 1e-4
KINDS = ["gaussian", "rademacher", "srht", "sjlt", "uniform"]


def _spec(sk, kind, **kw):
    return sk.SketchSpec(kind, M, s=4, **kw)


def _data(seed):
    rs = np.random.default_rng(seed)
    A = rs.standard_normal((N, D)).astype(np.float32)
    b = (A @ rs.standard_normal(D) + 0.1 * rs.standard_normal(N)).astype(np.float32)
    return A, b


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("reg", [0.0, 0.5])
@pytest.mark.parametrize("kind", KINDS)
def test_trace_matches_reference(kind, reg, use_kernel):
    A, b = _data(1)
    want = np.asarray(jihs.ihs_trace(_spec(jsk, kind), jax.random.PRNGKey(3), jnp.asarray(A), jnp.asarray(b),
                                     iters=6, reg=reg))
    got = tihs.ihs_trace(_spec(tsk, kind, use_kernel=use_kernel), tprng.prng_key(3), torch.from_numpy(A),
                         torch.from_numpy(b), iters=6, reg=reg, device="cpu").numpy()
    assert got.shape == want.shape == (6, D)
    for t in range(6):
        np.testing.assert_allclose(got[t], want[t], rtol=0, atol=TOL * np.abs(want[t]).max())


@pytest.mark.parametrize("kind", ["gaussian", "sjlt"])
def test_solve_is_last_iterate_and_converges(kind):
    A, b = _data(2)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    spec = _spec(tsk, kind)
    trace = tihs.ihs_trace(spec, tprng.prng_key(5), At, bt, iters=8, device="cpu")
    x = tihs.ihs_solve(spec, tprng.prng_key(5), At, bt, iters=8, device="cpu")
    assert torch.equal(x, trace[-1])
    want = np.asarray(jihs.ihs_solve(_spec(jsk, kind), jax.random.PRNGKey(5), jnp.asarray(A), jnp.asarray(b),
                                     iters=8))
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())
    xstar = np.linalg.lstsq(A.astype(np.float64), b.astype(np.float64), rcond=None)[0]
    err = [float(np.sum((t - xstar) ** 2)) for t in trace.double().numpy()]
    # Every step cuts the error (by 1.7-15x here, m = 8d), 1e-5 of it after 8.
    assert all(err[t + 1] < err[t] for t in range(7))
    assert err[-1] < 1e-4 * err[0]


def test_hessians_come_from_one_batched_gram(monkeypatch):
    """All iters Hessians are one ``operators.gram_batched`` call over
    ``worker_keys(key, iters)``."""
    A, b = (torch.from_numpy(x) for x in _data(3))
    calls = []
    real = tops.gram_batched

    def spy(spec, keys, A_, b_=None, **kw):
        calls.append(keys.clone())
        return real(spec, keys, A_, b_, **kw)

    monkeypatch.setattr(tops, "gram_batched", spy)
    tihs.ihs_trace(_spec(tsk, "gaussian"), tprng.prng_key(7), A, b, iters=5, device="cpu")
    assert len(calls) == 1 and torch.equal(calls[0], tprng.worker_keys(tprng.prng_key(7), 5))
