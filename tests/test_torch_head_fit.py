"""Sketched linear-head fitting in the port against the JAX reference (CPU).

``train.solvers.fit_head`` (Gaussian, SJLT, Rademacher; with and without a
straggler mask; one and several outputs) within 1e-5 of
``repro.train.solvers.fit_head`` on the same numpy-made features (relative,
∞-norm: the q d×d ridge solves amplify the Grams' float32 differences, which are
≤ 1e-5 of max|G|, by the small conditioning of (G + reg·I)), with the same
accountant disclosures (m, n, tag, and γ = std(H) in float32 to 1e-6);
``head_fit_quality`` against the reference's; and the reference's own checks of
``tests/test_fault_tolerance.py`` repeated on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import privacy as jpriv, sketches as jsk
from repro.train import solvers as jsolvers
from repro_torch.core import privacy as tpriv, sketches as tsk
from repro_torch.train import solvers as tsolvers
from repro_torch.utils import prng as tprng

N, D, Q = 2048, 12, 8
TOL = 1e-5
MASK = np.array([1, 1, 0, 1, 0, 1, 1, 1], np.float32)


def _features(seed, k):
    rs = np.random.default_rng(seed)
    H = rs.standard_normal((N, D)).astype(np.float32)
    W = rs.standard_normal((D, k)).astype(np.float32)
    Y = (H @ W + 0.1 * rs.standard_normal((N, k))).astype(np.float32)
    return H, (Y[:, 0] if k == 1 else Y)


def _spec(sk, kind):
    return sk.SketchSpec(kind, 6 * D, s=4)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(np.asarray(want, np.float64)).max())


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["gaussian", "sjlt", "rademacher"])
def test_fit_head_matches_the_reference(kind, masked, k):
    H, Y = _features(k + 10 * masked, k)
    jkey = jax.random.PRNGKey(3)
    tkey = tprng.from_key_data(np.asarray(jax.random.key_data(jkey)))
    jacc, tacc = jpriv.PrivacyAccountant(), tpriv.PrivacyAccountant()
    mask = MASK if masked else None
    want = jsolvers.fit_head(jkey, jnp.asarray(H), jnp.asarray(Y), _spec(jsk, kind), q=Q, reg=1e-4,
                             straggler_mask=None if mask is None else jnp.asarray(mask), accountant=jacc)
    got = tsolvers.fit_head(tkey, torch.from_numpy(H), torch.from_numpy(Y), _spec(tsk, kind), q=Q, reg=1e-4,
                            straggler_mask=None if mask is None else torch.from_numpy(mask), accountant=tacc,
                            device="cpu")
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got.numpy(), np.asarray(want)) <= TOL
    assert len(tacc.disclosures) == len(jacc.disclosures) == Q
    for a, b in zip(tacc.disclosures, jacc.disclosures):
        assert (a.m, a.n, a.tag) == (b.m, b.n, b.tag)
        assert abs(a.gamma - b.gamma) <= 1e-6 * b.gamma
    assert abs(tacc.total_per_entry_nats - jacc.total_per_entry_nats) <= 1e-5 * jacc.total_per_entry_nats


@pytest.mark.parametrize("k", [1, 3])
def test_head_fit_quality_matches_the_reference(k):
    H, Y = _features(20 + k, k)
    W = np.random.default_rng(k).standard_normal((D, k) if k > 1 else (D,)).astype(np.float32)
    want = jsolvers.head_fit_quality(jnp.asarray(H), jnp.asarray(Y), jnp.asarray(W))
    got = tsolvers.head_fit_quality(torch.from_numpy(H), torch.from_numpy(Y), torch.from_numpy(W))
    for key in ("f_star", "f_sketch"):
        assert abs(got[key] - want[key]) <= 1e-5 * want[key]
    assert abs(got["rel_err"] - want["rel_err"]) <= 1e-4 * abs(want["rel_err"])


def test_fit_head_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    H, Y = _features(0, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsolvers.fit_head(tprng.prng_key(0), torch.from_numpy(H), torch.from_numpy(Y), _spec(tsk, "gaussian"))


# ---------------------------------------------- the reference's own checks, on the port


def test_fit_head_converges_to_exact():
    rs = np.random.default_rng(0)
    n, d, k = 4096, 16, 3
    H = torch.from_numpy(rs.standard_normal((n, d)).astype(np.float32))
    W_true = torch.from_numpy(rs.standard_normal((d, k)).astype(np.float32))
    Y = H @ W_true + 0.1 * torch.from_numpy(rs.standard_normal((n, k)).astype(np.float32))
    acc = tpriv.PrivacyAccountant()
    W = tsolvers.fit_head(tprng.prng_key(0), H, Y, tsk.SketchSpec("gaussian", 8 * d), q=16, accountant=acc,
                          device="cpu")
    quality = tsolvers.head_fit_quality(H, Y, W)
    assert quality["rel_err"] < 0.05, quality
    assert len(acc.disclosures) == 16


def test_fit_head_straggler_mask():
    rs = np.random.default_rng(1)
    n, d = 1024, 8
    H = torch.from_numpy(rs.standard_normal((n, d)).astype(np.float32))
    # noisy target: f* must be bounded away from 0 or rel_err is ill-conditioned
    y = H @ torch.from_numpy(rs.standard_normal(d).astype(np.float32)) + torch.from_numpy(
        rs.standard_normal(n).astype(np.float32))
    mask = torch.tensor([1.0] * 4 + [0.0] * 4)
    W = tsolvers.fit_head(tprng.prng_key(0), H, y, tsk.SketchSpec("gaussian", 8 * d), q=8, straggler_mask=mask,
                          device="cpu")
    assert bool(torch.isfinite(W).all())
    assert tsolvers.head_fit_quality(H, y, W)["rel_err"] < 0.2
