"""The port's synchronous multi-round Algorithm 1
(``distributed.distributed_sketch_solve_multiround``) against the JAX reference
on the CPU.

With one worker a wave (q = 1) the oracle is the reference's own entry point on
a 1-device mesh. For q > 1 it is a composition of the reference's mesh-free
parts (its 8-device mesh path fails under this jax): per wave r,
``masked_average`` of ``sketch_and_solve`` over ``worker_key(key, w, r)``, then
the reference's running mean over the waves. x̄ to 1e-4 of its largest entry
(the d×d solves amplify float32 differences of the Grams, as in
``test_torch_distributed.py``); ``rounds=1`` is bitwise the port's
``distributed_sketch_solve``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import averaging as javg, distributed as jdist, sketches as jsk, solve as jsolve
from repro.utils import prng as jprng
from repro_torch.core import averaging as tavg, distributed as tdist, sketches as tsk
from repro_torch.utils import prng as tprng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

N, D, M = 600, 5, 30
TOL = 1e-4
KINDS = ["gaussian", "rademacher", "srht", "sjlt", "uniform", "hybrid_sjlt"]


def _spec(sk, kind, **kw):
    if kind.startswith("hybrid_"):
        return sk.SketchSpec("hybrid", M, m_prime=150, inner=kind[7:], s=4, **kw)
    return sk.SketchSpec(kind, M, s=4, **kw)


def _data(seed):
    rs = np.random.default_rng(seed)
    A = rs.standard_normal((N, D)).astype(np.float32)
    return A, (A @ rs.standard_normal(D) + 0.1 * rs.standard_normal(N)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("method", ["fused", "qr"])
@pytest.mark.parametrize("kind", KINDS)
def test_one_worker_waves_match_reference_mesh(kind, method):
    A, b = _data(1)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    want = jdist.distributed_sketch_solve_multiround(mesh, _spec(jsk, kind), jax.random.PRNGKey(6), jnp.asarray(A),
                                                     jnp.asarray(b), rounds=3, method=method)
    got = tdist.distributed_sketch_solve_multiround(_spec(tsk, kind), tprng.prng_key(6), torch.from_numpy(A),
                                                    torch.from_numpy(b), q=1, rounds=3, method=method,
                                                    device="cpu")
    _close(got, want)


def _reference_waves(kind, seed, A, b, q, rounds):
    key = jax.random.PRNGKey(seed)
    acc = None
    for r in range(rounds):
        xs = jnp.stack([jsolve.sketch_and_solve(_spec(jsk, kind), jprng.worker_key(key, w, r), jnp.asarray(A),
                                                jnp.asarray(b)) for w in range(q)])
        x = javg.masked_average(xs, jnp.ones((q,), jnp.float32))
        acc = x if acc is None else acc + (x - acc) / (r + 1.0)
    return acc


@pytest.mark.parametrize("q,rounds", [(3, 2), (4, 3)])
@pytest.mark.parametrize("kind", KINDS)
def test_waves_match_reference_composition(kind, q, rounds):
    A, b = _data(2)
    want = _reference_waves(kind, 12, A, b, q, rounds)
    got = tdist.distributed_sketch_solve_multiround(_spec(tsk, kind), tprng.prng_key(12), torch.from_numpy(A),
                                                    torch.from_numpy(b), q=q, rounds=rounds, device="cpu")
    _close(got, want)


@pytest.mark.parametrize("kind", ["gaussian", "sjlt", "uniform"])
def test_one_round_is_distributed_sketch_solve_bitwise(kind):
    A, b = (torch.from_numpy(x) for x in _data(3))
    spec = _spec(tsk, kind, use_kernel=True)
    one = tdist.distributed_sketch_solve_multiround(spec, tprng.prng_key(4), A, b, q=5, rounds=1, device="cpu")
    assert torch.equal(one, tdist.distributed_sketch_solve(spec, tprng.prng_key(4), A, b, q=5, device="cpu"))


def test_waves_are_the_running_mean_of_rounds():
    A, b = (torch.from_numpy(x) for x in _data(4))
    spec = _spec(tsk, "gaussian")
    waves = [tdist.distributed_sketch_solve(spec, tprng.prng_key(2), A, b, q=2, round_id=r, device="cpu")
             for r in range(3)]
    got = tdist.distributed_sketch_solve_multiround(spec, tprng.prng_key(2), A, b, q=2, rounds=3, device="cpu")
    torch.testing.assert_close(got, torch.stack(waves).mean(0), rtol=0, atol=1e-6)


ASYNC_MODES = {
    "latency": {},
    "runtime_config": {"runtime_config": dict(deadline_s=0.5, max_retries=1, backoff_base_s=0.1)},
    "error_fn": {"runtime_config": dict(deadline_s=10.0, max_retries=0, target_error=D / (M - D - 1) / 5),
                 "error_fn": "theory"},
}


@pytest.mark.parametrize("mode", list(ASYNC_MODES))
def test_asynchronous_mode_matches_the_reference_runtime(mode):
    """With a latency model the call runs on the serverless runtime: x̄ within 1e-5
    of the reference's ``repro.runtime.serverless_sketch_solve`` at the same q and
    rounds (and, with ``error_fn="theory"``, its early stop); rounds=0 raises."""
    from repro import runtime as jrt
    from repro_torch import runtime as trt

    A, b = _data(5)

    def args(rt):
        lat = rt.DropLatency(seed=7, inner=rt.LognormalLatency(seed=7, mean_s=0.4, sigma=0.6), drop_prob=0.2)
        kw = dict(ASYNC_MODES[mode])
        if "runtime_config" in kw:
            kw["runtime_config"] = rt.RuntimeConfig(**kw["runtime_config"])
        return lat, kw

    lat, kw = args(jrt)
    cfg = kw.pop("runtime_config", None)
    want = jrt.serverless_sketch_solve(_spec(jsk, "gaussian"), jax.random.PRNGKey(8), jnp.asarray(A), jnp.asarray(b),
                                       q=3, rounds=3, latency=lat, config=cfg, **kw)
    lat, kw = args(trt)
    got = tdist.distributed_sketch_solve_multiround(_spec(tsk, "gaussian"), tprng.prng_key(8), torch.from_numpy(A),
                                                    torch.from_numpy(b), q=3, rounds=3, latency=lat, device="cpu",
                                                    **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.xbar, rtol=0, atol=1e-5 * np.abs(want.xbar).max())
    if mode == "error_fn":
        assert want.stopped_early and want.count == 5
    with pytest.raises(ValueError, match="rounds"):
        tdist.distributed_sketch_solve_multiround(_spec(tsk, "gaussian"), tprng.prng_key(0), torch.from_numpy(A),
                                                  torch.from_numpy(b), q=2, rounds=0, latency=lat, device="cpu")


ENTRIES = ["multiround", "ihs_trace", "ihs_solve", "gram_blocked_host", "straggler_mask", "student_t", "airline",
           "emnist"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_new_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, entry):
    from repro_torch.core import ihs, operators
    from repro_torch.data import regression

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, b = torch.zeros(64, 3), torch.zeros(64)
    spec = tsk.SketchSpec("gaussian", 8)
    call = {
        "multiround": lambda: tdist.distributed_sketch_solve_multiround(spec, tprng.prng_key(0), A, b, q=2, rounds=2),
        "ihs_trace": lambda: ihs.ihs_trace(spec, tprng.prng_key(0), A, b, iters=2),
        "ihs_solve": lambda: ihs.ihs_solve(spec, tprng.prng_key(0), A, b, iters=2),
        "gram_blocked_host": lambda: operators.gram_blocked_host(spec, tprng.prng_key(0), A.numpy(), b.numpy()),
        "straggler_mask": lambda: tavg.simulate_straggler_mask(tprng.prng_key(0), 8, drop_prob=0.1,
                                                               deadline_quantile=0.8),
        "student_t": lambda: regression.student_t_regression(0, 16, 2),
        "airline": lambda: regression.airline_like(0, 16),
        "emnist": lambda: regression.emnist_like(0, 16),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
