"""The port's straggler masks and the float draws under them, against the JAX
reference on the CPU.

``simulate_straggler_mask`` must be bitwise the reference's: a Bernoulli draw
(``uniform < 1 − drop_prob``, bitwise) and a LogNormal deadline cut at its
``jnp.quantile``. The mask depends only on the order of the lognormal runtimes,
and the port's normal (√2·erfinv(u), XLA's CPU float32 polynomial ported
operation for operation) is bitwise jax's wherever erfinv's first branch runs
(w = −log1p(−u²) < 5). In the second branch (|z| above about 2.8) the values
are held to 1e-3 absolute; since the port takes erfinv's square root correctly
rounded, as XLA does, they are bitwise there too. The lognormal is exp of it:
held to 4.8e-7 relative (four float32 ulps; ``torch.exp`` is not XLA's exp)
where the normal is bitwise, and to 1.1e-3 relative in the tails.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import averaging as javg
from repro_torch.core import averaging as tavg
from repro_torch.utils import prng as tprng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

BRANCH_Z = 2.8  # |normal| below this: erfinv's first branch (w < 5), bitwise


@pytest.mark.parametrize("deadline_quantile", [0.5, 0.8, 1.0])
@pytest.mark.parametrize("drop_prob", [0.0, 0.1])
@pytest.mark.parametrize("q", [8, 200])
@pytest.mark.parametrize("seed", [0, 1, 2, 17, 20260])
def test_mask_bitwise_reference(seed, q, drop_prob, deadline_quantile):
    want = np.asarray(javg.simulate_straggler_mask(jax.random.PRNGKey(seed), q, drop_prob=drop_prob,
                                                   deadline_quantile=deadline_quantile))
    got = tavg.simulate_straggler_mask(tprng.prng_key(seed), q, drop_prob=drop_prob,
                                       deadline_quantile=deadline_quantile, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (q,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("q", [1, 2, 57, 1000])
@pytest.mark.parametrize("quantile", [0.0, 0.123, 0.37, 0.5, 0.8, 0.999])
def test_quantile_bitwise_reference(q, quantile):
    for seed in range(20):
        t = np.asarray(jax.random.lognormal(jax.random.PRNGKey(seed), shape=(q,)))
        want = np.asarray(jnp.quantile(jnp.asarray(t), quantile))
        got = tavg._quantile_linear(torch.from_numpy(t.copy()), quantile).numpy()
        assert got.view(np.int32) == want.view(np.int32), (seed, got, want)


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("seed", [0, 3])
def test_bernoulli_bitwise_reference(seed, p):
    want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p, (5000,)))
    got = tprng.bernoulli(tprng.prng_key(seed), p, (5000,)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 5, 99])
def test_normal_and_lognormal_match_reference(seed):
    n = 100_000
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,)))
    got = tprng.normal(tprng.prng_key(seed), (n,)).numpy()
    inner = np.abs(want) < BRANCH_Z
    np.testing.assert_array_equal(got[inner].view(np.int32), want[inner].view(np.int32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    want_l = np.asarray(jax.random.lognormal(jax.random.PRNGKey(seed), shape=(n,)))
    got_l = tprng.lognormal(tprng.prng_key(seed), (n,)).numpy()
    inner_l = np.abs(np.log(want_l)) < BRANCH_Z
    np.testing.assert_allclose(got_l[inner_l], want_l[inner_l], rtol=4.8e-7, atol=0)
    np.testing.assert_allclose(got_l, want_l, rtol=1.1e-3, atol=0)


def test_erfinv_over_every_uniform_the_normal_draws():
    """All 2**23 u that ``normal`` can draw: bitwise in erfinv's first branch,
    within 1e-3 of jax's √2·erfinv in the second."""
    f = (torch.arange(2**23, dtype=torch.int64) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = torch.clamp_min(tprng._fma(f, float(np.float32(1) - lo), float(lo)), float(lo))
    want = np.asarray(jax.jit(lambda u: jnp.float32(np.sqrt(2)) * jax.lax.erf_inv(u))(jnp.asarray(u.numpy())))
    got = (tprng.xla_erfinv(u) * tprng._SQRT2_F32).numpy()
    inner = np.abs(want) < BRANCH_Z
    assert inner.sum() > 0.99 * inner.size
    np.testing.assert_array_equal(got[inner].view(np.int32), want[inner].view(np.int32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_mask_on_another_device_argument_is_the_same():
    """``device`` only says where the draws run: a ``torch.device`` and its name
    give the same mask."""
    a = tavg.simulate_straggler_mask(tprng.prng_key(4), 50, drop_prob=0.1, deadline_quantile=0.8,
                                     device=torch.device("cpu"))
    b = tavg.simulate_straggler_mask(tprng.prng_key(4), 50, drop_prob=0.1, deadline_quantile=0.8, device="cpu")
    assert a.device.type == "cpu" and torch.equal(a, b)
