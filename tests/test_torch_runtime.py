"""The port's serverless runtime (``repro_torch.runtime``) and fault-tolerance
pieces against the JAX package's, on the CPU.

* Latency draws (numpy Philox on the task coordinate) are bitwise the
  reference's; ``LognormalLatency.quantile`` (float32 inverse normal CDF) too, at
  the quantiles a deadline is set at.
* ``ServerlessEngine`` driven in both packages by one pure numpy task gives
  byte-identical event logs and a bitwise x̄, for static and adaptive deadlines,
  drops, retries and early stop.
* ``serverless_sketch_solve`` at n = 2,048, d = 16, m = 128, q = 8: the logs are
  byte-identical to the reference's for ``error_fn`` None and ``"theory"``, and
  x̄ lies within 1e-5 of its largest entry (the two packages' float32 solves of
  the same sketches); with ``"probe"`` only the logged error differs, within 1e-5.
* The probe's rows, ``StragglerPolicy`` masks and ``HeartbeatMonitor`` reports
  are the reference's; inline, thread and process backends and any pool width
  give the same run; a killed worker is a drop, an error raised in a worker
  propagates; the kernel wrappers' library load and launch counters hold under
  8 threads.

No test uses the reference's 8-device mesh paths as an oracle: the port's own
``distributed_sketch_solve`` is the synchronous oracle.
"""
import dataclasses
import math
import pickle
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core import sketches as jsk
from repro.distributed import fault_tolerance as jft
from repro_torch import runtime as trt
from repro_torch.core import distributed as tdist, sketches as tsk
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.kernels import cuda as tcuda
from repro_torch.utils import prng as tprng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

N, D, M, Q = 2048, 16, 128, 8
XBAR_TOL = 1e-5


# ------------------------------------------------------------------ latency models


def _models(rt, seed):
    return {
        "constant": rt.ConstantLatency(seed=seed, value_s=0.3),
        "lognormal": rt.LognormalLatency(seed=seed, mean_s=0.4, sigma=0.6),
        "heavytail": rt.HeavyTailLatency(seed=seed, scale_s=0.5, alpha=1.5),
        "drift": rt.DriftLatency(seed=seed, mean_s=0.5, sigma=0.35, growth=1.3),
        "drop": rt.DropLatency(seed=seed, inner=rt.LognormalLatency(seed=seed + 1, mean_s=0.4, sigma=0.6),
                               drop_prob=0.3),
    }


@pytest.mark.parametrize("seed", [0, 7, 20260])
@pytest.mark.parametrize("name", ["constant", "lognormal", "heavytail", "drift", "drop"])
def test_latency_draws_are_bitwise_the_reference(name, seed):
    want, got = _models(jrt, seed)[name], _models(trt, seed)[name]
    for attempt in range(3):
        for r in range(6):
            for w in range(16):
                a, b = want.sample(w, r, attempt), got.sample(w, r, attempt)
                assert a == b or (math.isinf(a) and math.isinf(b)), (w, r, attempt, a, b)
    np.testing.assert_array_equal(got.sample_wave(32, round_id=3, attempt=1), want.sample_wave(32, 3, 1))
    np.testing.assert_array_equal(got.mask_for_round(32, 0.6, round_id=2), want.mask_for_round(32, 0.6, 2))


QUANTILES = [round(0.01 * k, 2) for k in range(1, 100)] + [0.001, 0.995, 0.999, 0.9999]


@pytest.mark.parametrize("mean_s,sigma", [(1.0, 0.35), (0.4, 0.6), (2.0, 0.5)])
def test_lognormal_quantile_is_bitwise_the_reference(mean_s, sigma):
    want = jrt.LognormalLatency(mean_s=mean_s, sigma=sigma)
    got = trt.LognormalLatency(mean_s=mean_s, sigma=sigma)
    assert [got.quantile(p) for p in QUANTILES] == [want.quantile(p) for p in QUANTILES]


def test_ndtri_is_bitwise_jax_on_a_dense_grid():
    """On 400,001 float32 points of (0, 1) the port's ndtri is jax's bit for bit."""
    from jax.scipy.special import ndtri

    ps = np.linspace(1e-6, 1 - 1e-6, 400_001).astype(np.float32)
    want = np.asarray(ndtri(jnp.asarray(ps)))
    got = tprng.xla_ndtri(torch.from_numpy(ps)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ------------------------------------------------------------------ engine core


class _NumpyTask:
    """A pure numpy payload: (worker, round) -> a fixed vector, the same in both
    packages, so the engines alone are compared."""

    def __call__(self, worker_id, round_id):
        return np.random.default_rng([worker_id, round_id, 5]).standard_normal(6).astype(np.float32)


def _scenario(rt, name):
    """(latency, config, deadline policy, error_fn, tasks) of an engine scenario."""
    tasks = [(w, 0) for w in range(16)]
    if name == "drops":
        lat = rt.DropLatency(seed=23, inner=rt.LognormalLatency(seed=23, mean_s=0.4, sigma=0.6), drop_prob=0.2)
        return lat, rt.RuntimeConfig(deadline_s=0.5, max_retries=2, backoff_base_s=0.05), None, None, tasks
    if name == "heavytail_retries":
        lat = rt.HeavyTailLatency(seed=20260, scale_s=0.5, alpha=1.5)
        return lat, rt.RuntimeConfig(deadline_s=1.0, max_retries=2, backoff_base_s=0.05), None, None, tasks
    if name == "adaptive":
        lat = rt.LognormalLatency(seed=11, mean_s=1.0, sigma=0.4)
        cfg = rt.RuntimeConfig(deadline_s=0.6, max_retries=3, backoff_base_s=0.05)
        return lat, cfg, rt.AdaptiveDeadline(warmup_s=0.6, min_samples=3), None, tasks
    if name == "drift_adaptive":
        lat = rt.DriftLatency(seed=4, mean_s=0.5, sigma=0.35, growth=1.3)
        return lat, rt.RuntimeConfig(deadline_s=0.8, max_retries=3), rt.AdaptiveDeadline(), None, tasks
    if name == "static_float":
        lat = rt.LognormalLatency(seed=5, mean_s=0.4, sigma=0.7)
        return lat, rt.RuntimeConfig(max_retries=0), 0.45, None, tasks
    if name == "early_stop":
        cfg = rt.RuntimeConfig(deadline_s=10.0, max_retries=0, target_error=0.2)
        lat = rt.LognormalLatency(seed=2, mean_s=0.3)
        return lat, cfg, None, (lambda xbar, count: 1.0 / count), tasks
    if name == "early_stop_on_xbar":
        cfg = rt.RuntimeConfig(deadline_s=10.0, max_retries=1, target_error=0.5, min_results=3)
        lat = rt.DropLatency(seed=8, inner=rt.HeavyTailLatency(seed=8, scale_s=0.2), drop_prob=0.1)
        return lat, cfg, None, (lambda xbar, count: float(np.linalg.norm(xbar)) / math.sqrt(6)), tasks
    if name == "two_rounds":
        lat = rt.DropLatency(seed=3, inner=rt.LognormalLatency(seed=3, mean_s=0.4, sigma=0.6), drop_prob=0.2)
        cfg = rt.RuntimeConfig(deadline_s=0.5, max_retries=1)
        return lat, cfg, None, None, [(w, r) for r in range(2) for w in range(8)]
    raise KeyError(name)


SCENARIOS = ["drops", "heavytail_retries", "adaptive", "drift_adaptive", "static_float", "early_stop",
             "early_stop_on_xbar", "two_rounds"]


@pytest.mark.parametrize("backend", ["inline", "thread"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_engine_replays_the_reference_byte_for_byte(name, backend):
    lat, cfg, dl, err, tasks = _scenario(jrt, name)
    want = jrt.ServerlessEngine(_NumpyTask(), lat, cfg, backend="inline", deadline=dl).run(tasks=tasks, error_fn=err)
    lat, cfg, dl, err, tasks = _scenario(trt, name)
    got = trt.ServerlessEngine(_NumpyTask(), lat, cfg, backend=backend, deadline=dl).run(tasks=tasks, error_fn=err)
    assert got.events.lines() == want.events.lines()
    np.testing.assert_array_equal(got.xbar, want.xbar)
    assert got.arrived == want.arrived and got.count == want.count and got.dispatched == want.dispatched
    assert got.stopped_early == want.stopped_early and got.final_error == want.final_error
    np.testing.assert_array_equal(got.realized_mask, want.realized_mask)
    assert got.summary(deadline=cfg.deadline_s) == want.summary(deadline=cfg.deadline_s)
    if name.startswith("early_stop"):
        assert got.stopped_early and got.events.counts()["stop"] == 1
    if name in ("drops", "heavytail_retries", "adaptive", "drift_adaptive"):
        assert got.events.counts().get("retry", 0) > 0


def test_engine_all_dropped_raises_as_the_reference():
    lat = trt.DropLatency(seed=0, inner=trt.ConstantLatency(value_s=0.1), drop_prob=1.0)
    eng = trt.ServerlessEngine(_NumpyTask(), lat, trt.RuntimeConfig(max_retries=1))
    with pytest.raises(RuntimeError, match="no worker result"):
        eng.run(q=4)
    with pytest.raises(ValueError, match="pass q"):
        eng.run()


def test_deadline_policies_resolve_as_the_reference():
    cfg = trt.RuntimeConfig(deadline_s=0.7)
    assert trt.resolve_deadline_policy(None, cfg).start().current() == 0.7
    assert trt.resolve_deadline_policy(1.3, cfg).start().current() == 1.3
    pol = trt.AdaptiveDeadline(warmup_s=2.0)
    assert trt.resolve_deadline_policy(pol, cfg) is pol
    want, got = jrt.AdaptiveDeadline(min_samples=3).start(), trt.AdaptiveDeadline(min_samples=3).start()
    for lat in (0.3, math.inf, 0.9, 2.5, 0.1, 40.0, 0.2):
        want.observe(lat), got.observe(lat)
        want.observe_timeout(lat), got.observe_timeout(lat)
        assert got.current() == want.current()


def test_backend_factory_and_caller_owned_instances():
    with pytest.raises(ValueError, match="unknown backend"):
        trt.make_backend("quantum", _NumpyTask())
    assert set(trt.BACKENDS) == {"inline", "thread", "process"}
    shared = trt.ThreadBackend(_NumpyTask(), max_workers=2)
    assert trt.make_backend(shared, _NumpyTask()) is shared
    lat, cfg, _, _, _ = _scenario(trt, "drops")
    eng = trt.ServerlessEngine(_NumpyTask(), lat, cfg, backend=shared)
    assert eng.run(q=4).events.lines() == eng.run(q=4).events.lines()
    shared.shutdown()


# ------------------------------------------------------------- sketch-solve tasks


def _data(seed=0, n=N, d=D):
    rs = np.random.default_rng(seed)
    A = rs.standard_normal((n, d)).astype(np.float32)
    return A, (A @ rs.standard_normal(d) + 0.1 * rs.standard_normal(n)).astype(np.float32)


def _specs(kind):
    if kind == "sjlt":
        return jsk.SketchSpec("sjlt", M, s=4), tsk.SketchSpec("sjlt", M, s=4, use_kernel=True)
    return jsk.SketchSpec(kind, M), tsk.SketchSpec(kind, M, use_kernel=True)


def _latency(rt):
    return rt.DropLatency(seed=23, inner=rt.LognormalLatency(seed=23, mean_s=0.4, sigma=0.6), drop_prob=0.2)


def _both(kind, error_fn, *, config=None, seed=3, backend="inline", rounds=1):
    A, b = _data()
    jspec, tspec = _specs(kind)
    cfg = config or dict(deadline_s=0.5, max_retries=2, backoff_base_s=0.05)
    want = jrt.serverless_sketch_solve(jspec, jax.random.PRNGKey(seed), jnp.asarray(A), jnp.asarray(b), q=Q,
                                       rounds=rounds, latency=_latency(jrt), config=jrt.RuntimeConfig(**cfg),
                                       error_fn=error_fn, backend="inline")
    got = trt.serverless_sketch_solve(tspec, tprng.prng_key(seed), torch.from_numpy(A), torch.from_numpy(b), q=Q,
                                      rounds=rounds, latency=_latency(trt), config=trt.RuntimeConfig(**cfg),
                                      error_fn=error_fn, backend=backend, device="cpu")
    return want, got


def _close(got, want, tol=XBAR_TOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("error_fn", [None, "theory"])
@pytest.mark.parametrize("kind", ["gaussian", "sjlt"])
def test_serverless_sketch_solve_logs_are_the_reference_bytes(kind, error_fn):
    want, got = _both(kind, error_fn)
    assert got.events.lines() == want.events.lines()
    assert got.events.counts().get("retry", 0) > 0 and got.count < want.dispatched
    _close(got.xbar, want.xbar)


@pytest.mark.parametrize("kind", ["gaussian", "sjlt"])
def test_serverless_early_stop_on_theory_matches_the_reference(kind):
    single = D / (M - D - 1)
    cfg = dict(deadline_s=10.0, max_retries=0, target_error=single / 4)
    want, got = _both(kind, "theory", config=cfg)
    assert got.events.lines() == want.events.lines()
    assert got.stopped_early and got.count == 4 and got.events.counts()["cancel"] == Q - 4
    _close(got.xbar, want.xbar)


@pytest.mark.parametrize("kind", ["gaussian", "sjlt"])
def test_serverless_probe_error_is_the_reference_within_tolerance(kind):
    """With ``"probe"`` the logs differ only in the logged error (the probe's
    float32 residuals), by at most 1e-5 each."""
    want, got = _both(kind, "probe")
    assert len(got.events) == len(want.events)
    for g, w in zip(got.events, want.events):
        assert (g.kind, g.t, g.task_id, g.worker_id, g.round_id, g.attempt) == \
            (w.kind, w.t, w.task_id, w.worker_id, w.round_id, w.attempt)
        assert set(g.extra) == set(w.extra)
        for k in g.extra:
            assert g.extra[k] == pytest.approx(w.extra[k], rel=0, abs=1e-5 if k == "error" else 0)
    _close(got.xbar, want.xbar)


def test_serverless_rounds_and_masked_solve_agree():
    """Two waves against the reference; and, where no retried task arrived, x̄
    equals the port's synchronous ``distributed_sketch_solve`` with the realized
    mask (the same keys; float64 engine mean against a float32 masked mean)."""
    want, got = _both("gaussian", None, rounds=2)
    assert got.events.lines() == want.events.lines()
    _close(got.xbar, want.xbar)
    A, b = (torch.from_numpy(x) for x in _data())
    _, spec = _specs("gaussian")
    lat = trt.LognormalLatency(seed=5, mean_s=0.4, sigma=0.7)
    res = trt.serverless_sketch_solve(spec, tprng.prng_key(1), A, b, q=Q, latency=lat,
                                      config=trt.RuntimeConfig(deadline_s=0.45, max_retries=0), device="cpu")
    assert 0 < res.count < Q
    sync = tdist.distributed_sketch_solve(spec, tprng.prng_key(1), A, b, q=Q, straggler_mask=res.realized_mask,
                                          device="cpu")
    np.testing.assert_allclose(res.xbar, sync.double().numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n,rows", [(2048, 1024), (5000, 100), (700, 1024), (1621, 300)])
def test_probe_rows_are_bitwise_the_reference(n, rows):
    A, b = _data(4, n=n, d=3)
    key = jax.random.fold_in(jax.random.PRNGKey(9), 0x9B0BE)
    Aw, bw = jrt.subsample_probe(key, jnp.asarray(A), jnp.asarray(b), rows=rows)
    tkey = tprng.fold_in(tprng.prng_key(9), 0x9B0BE)
    for As, bs in ((A, b), (torch.from_numpy(A), torch.from_numpy(b))):
        Ag, bg = trt.subsample_probe(tkey, As, bs, rows=rows)
        np.testing.assert_array_equal(Ag.numpy(), np.asarray(Aw))
        np.testing.assert_array_equal(bg.numpy(), np.asarray(bw))


@pytest.mark.parametrize("n", [1, 7, 1622, 500_000])
def test_permutation_is_bitwise_jax(n):
    key = jax.random.fold_in(jax.random.PRNGKey(11), n)
    want = np.asarray(jax.random.permutation(key, n))
    got = tprng.permutation(tprng.fold_in(tprng.prng_key(11), n), n)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="without replacement"):
        tprng.choice(tprng.prng_key(0), n, (n + 1,))


def test_thread_and_inline_backends_agree_and_pool_width_is_invisible():
    A, b = (torch.from_numpy(x) for x in _data(2))
    _, spec = _specs("sjlt")
    runs = [trt.serverless_sketch_solve(spec, tprng.prng_key(6), A, b, q=Q, latency=_latency(trt),
                                        config=trt.RuntimeConfig(deadline_s=0.5, max_threads=width),
                                        backend=backend, device="cpu")
            for backend, width in (("inline", 1), ("thread", 1), ("thread", 8))]
    for r in runs[1:]:
        assert r.events.lines() == runs[0].events.lines()
        np.testing.assert_array_equal(r.xbar, runs[0].xbar)


def test_specs_pickle_without_their_device_copy():
    A, b = (torch.from_numpy(x) for x in _data(3))
    _, spec = _specs("gaussian")
    compute = trt.make_sketch_solve_compute(spec, tprng.prng_key(2), A, b, device="cpu")
    assert compute._data is not None and compute._data[0] is A  # the caller's tensors: no copy
    assert compute.A is None and compute.b is None  # and no host copy until pickled
    clone = pickle.loads(pickle.dumps(compute))
    assert clone._data is None and clone.device == "cpu"
    np.testing.assert_array_equal(clone.A, A.numpy())
    np.testing.assert_array_equal(clone.b, b.numpy())
    np.testing.assert_array_equal(compute(1, 0), clone(1, 0))
    np.testing.assert_array_equal(compute(0, 3), clone(0, 3))
    An, bn = np.ascontiguousarray(np.random.default_rng(1).standard_normal((8, 64), dtype=np.float32)), \
        np.ones(8, np.float32)
    ln = trt.make_least_norm_compute(tsk.SketchSpec("gaussian", 32, use_kernel=True), tprng.prng_key(0), An, bn,
                                     device="cpu")
    assert ln._data is None
    x = ln(2, 1)
    assert ln._data[0].T.is_contiguous() and x.shape == (64,)
    np.testing.assert_array_equal(pickle.loads(pickle.dumps(ln))(2, 1), x)


def test_one_device_copy_is_shared_by_every_thread(monkeypatch):
    A, b = _data(5)
    _, spec = _specs("gaussian")
    compute = trt.make_sketch_solve_compute(spec, tprng.prng_key(2), A, b, device="cpu")
    copies = []
    prepare = type(compute)._prepare

    def counting(self, A_, b_):
        copies.append(1)
        return prepare(self, A_, b_)

    monkeypatch.setattr(type(compute), "_prepare", counting)
    barrier = threading.Barrier(8)
    seen = []

    def task(w):
        barrier.wait(timeout=30)
        seen.append(compute._device_data()[0])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=task, args=(w,)) for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(copies) == 1 and len(seen) == 8 and all(s is seen[0] for s in seen)


# --------------------------------------------------- multi-round asynchronous mode


def test_multiround_asynchronous_mode_is_the_engine_bitwise():
    A, b = (torch.from_numpy(x) for x in _data(6))
    _, spec = _specs("sjlt")
    cfg = trt.RuntimeConfig(deadline_s=0.5, max_retries=1)
    got = tdist.distributed_sketch_solve_multiround(spec, tprng.prng_key(7), A, b, q=4, rounds=3,
                                                    latency=_latency(trt), runtime_config=cfg, device="cpu")
    res = trt.serverless_sketch_solve(spec, tprng.prng_key(7), A, b, q=4, rounds=3, latency=_latency(trt),
                                      config=cfg, device="cpu")
    assert got.dtype == A.dtype and torch.equal(got, torch.as_tensor(res.xbar, dtype=A.dtype))


# ------------------------------------------------------------- fault tolerance


@pytest.mark.parametrize("drop,quantile", [(0.0, 1.0), (0.2, 1.0), (0.1, 0.8), (0.0, 0.5)])
def test_straggler_policy_masks_are_bitwise_the_reference(drop, quantile):
    want = jft.StragglerPolicy(drop_prob=drop, deadline_quantile=quantile, seed=3)
    got = tft.StragglerPolicy(drop_prob=drop, deadline_quantile=quantile, seed=3)
    for step in range(6):
        np.testing.assert_array_equal(got.mask_for_step(step, 64, device="cpu").numpy(),
                                      np.asarray(want.mask_for_step(step, 64)))
    assert got.deadline_for(mean_s=0.7) == want.deadline_for(mean_s=0.7)
    lat_w, lat_g = want.to_latency_model(mean_s=0.4), got.to_latency_model(mean_s=0.4)
    np.testing.assert_array_equal(lat_g.sample_wave(32, 2), lat_w.sample_wave(32, 2))
    for adaptive in (False, True):
        pw = want.to_deadline_policy(mean_s=0.5, adaptive=adaptive)
        pg = got.to_deadline_policy(mean_s=0.5, adaptive=adaptive)
        assert type(pg).__name__ == type(pw).__name__
        assert dataclasses.asdict(pg) == dataclasses.asdict(pw)


def test_heartbeat_monitor_and_log_report_equal_the_reference():
    rs = np.random.default_rng(0)
    want, got = jft.HeartbeatMonitor(q=8, deadline=1.0), tft.HeartbeatMonitor(q=8, deadline=1.0)
    for _ in range(3):
        wave = rs.lognormal(0.0, 0.5, 8)
        wave[rs.integers(8)] = np.inf
        np.testing.assert_array_equal(got.record_step(wave), want.record_step(wave))
    for mon in (want, got):
        mon.record_timeout(2), mon.record_retry(3)
    assert got.report() == want.report()
    lat, cfg, dl, err, tasks = _scenario(jrt, "drops")
    jres = jrt.ServerlessEngine(_NumpyTask(), lat, cfg, backend="inline").run(tasks=tasks)
    lat, cfg, dl, err, tasks = _scenario(trt, "drops")
    tres = trt.ServerlessEngine(_NumpyTask(), lat, cfg, backend="inline").run(tasks=tasks)
    assert tres.events.heartbeat_report(16, 0.5) == jres.events.heartbeat_report(16, 0.5)


# ------------------------------------------------------------- device contract


NEW_ENTRIES = ["spec", "least_norm_spec", "serverless", "multiround_async", "server", "launcher", "straggler_mask"]


@pytest.mark.parametrize("entry", NEW_ENTRIES)
def test_runtime_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, entry):
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import SolveServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, b = torch.zeros(64, 3), torch.zeros(64)
    spec = tsk.SketchSpec("gaussian", 8)
    lat = trt.ConstantLatency(value_s=0.1)
    call = {
        "spec": lambda: trt.make_sketch_solve_compute(spec, tprng.prng_key(0), A, b),
        "least_norm_spec": lambda: trt.make_least_norm_compute(spec, tprng.prng_key(0), A.T, b[:3]),
        "serverless": lambda: trt.serverless_sketch_solve(spec, tprng.prng_key(0), A, b, q=2, latency=lat),
        "multiround_async": lambda: tdist.distributed_sketch_solve_multiround(
            spec, tprng.prng_key(0), A, b, q=2, rounds=2, latency=lat),
        "server": lambda: SolveServer(latency=lat),
        "launcher": lambda: launcher.main(["--solve", "--n", "64", "--d", "3", "--m", "8", "--q", "2"]),
        "straggler_mask": lambda: tft.StragglerPolicy(drop_prob=0.1).mask_for_step(0, 8),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


# ------------------------------------------------------------- process backend


@pytest.mark.subprocess
def test_process_backend_replays_inline_and_a_killed_worker_is_a_drop():
    """Spawned workers (pool 2) replay the inline run's bytes; a KillSwitch on one
    (worker, round) makes that task a ``drop`` and a retry with a fresh round."""
    A, b = (torch.from_numpy(x) for x in _data(7, n=512, d=6))
    spec = tsk.SketchSpec("sjlt", 48, s=4, use_kernel=True)
    cfg = trt.RuntimeConfig(deadline_s=0.5, max_retries=2, backoff_base_s=0.05, max_threads=2)
    inline = trt.serverless_sketch_solve(spec, tprng.prng_key(5), A, b, q=6, latency=_latency(trt), config=cfg,
                                         backend="inline", device="cpu")
    proc = trt.serverless_sketch_solve(spec, tprng.prng_key(5), A, b, q=6, latency=_latency(trt), config=cfg,
                                       backend="process", device="cpu")
    assert proc.events.lines() == inline.events.lines()
    np.testing.assert_array_equal(proc.xbar, inline.xbar)

    compute = trt.make_sketch_solve_compute(spec, tprng.prng_key(5), A, b, device="cpu")
    victim = next(w for w, r, attempt in inline.arrived if attempt == 0)
    killer = trt.KillSwitch(compute, kill_coords=((victim, 0),))
    res = trt.ServerlessEngine(killer, _latency(trt), cfg, backend="process").run(q=6)
    drops = [ev for ev in res.events if ev.kind == "drop"]
    assert [(ev.worker_id, ev.round_id) for ev in drops] == [(victim, 0)]
    retry = [ev for ev in res.events if ev.kind == "retry" and ev.task_id == drops[0].task_id]
    assert retry and retry[0].round_id >= 1 and np.isfinite(res.xbar).all()
    with pytest.raises(RuntimeError, match="KillSwitch fired on the master"):
        killer(victim, 0)


@pytest.mark.subprocess
def test_a_killed_worker_builds_one_pool_a_break():
    """One worker (pool 1) is killed at its first task, (0, 0), and again at its
    resubmission; tasks 1–5 queued behind it fail with the first pool. Each break
    builds one pool: the victim's two breaks make three pools in all, and the
    innocent tasks, resubmitted to the current pool without replacing it, arrive
    at their first attempt beside the victim's retry."""
    A, b = (torch.from_numpy(x) for x in _data(9, n=256, d=4))
    compute = trt.make_sketch_solve_compute(tsk.SketchSpec("sjlt", 32, s=2, use_kernel=True), tprng.prng_key(3),
                                            A, b, device="cpu")
    backend = trt.ProcessBackend(trt.KillSwitch(compute, kill_coords=((0, 0),)), max_workers=1)
    cfg = trt.RuntimeConfig(deadline_s=1.0, max_retries=2, backoff_base_s=0.05)
    try:
        res = trt.ServerlessEngine(compute, trt.ConstantLatency(value_s=0.1), cfg, backend=backend).run(q=6)
    finally:
        backend.shutdown()
    assert backend.pools_built == 3
    assert [(ev.worker_id, ev.round_id) for ev in res.events if ev.kind == "drop"] == [(0, 0)]
    assert sorted(res.arrived) == [(0, 1, 1)] + [(w, 0, 0) for w in range(1, 6)]
    want = np.mean([compute(w, r).astype(np.float64) for w, r, _ in res.arrived], axis=0)
    np.testing.assert_allclose(res.xbar, want, rtol=1e-12)


@pytest.mark.subprocess
def test_an_error_in_a_worker_process_propagates_and_is_not_a_drop():
    """A worker whose card is unusable raises in its process; the engine re-raises
    that error instead of logging a drop, a retry or a CPU result."""
    A, b = (torch.from_numpy(x) for x in _data(8, n=256, d=4))
    compute = trt.make_sketch_solve_compute(tsk.SketchSpec("gaussian", 32), tprng.prng_key(1), A, b, device="cpu")
    compute.device = "cuda"  # what the worker process will resolve; this one has no card
    eng = trt.ServerlessEngine(compute, trt.ConstantLatency(value_s=0.1), trt.RuntimeConfig(max_threads=1),
                               backend="process")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eng.run(q=2)


# ------------------------------------------------------------- thread safety


def test_library_is_built_and_loaded_once_under_8_threads(monkeypatch):
    built, loaded = [], []

    def fake_build(names):
        built.append(tuple(names))
        threading.Event().wait(0.05)  # a slow build: the other threads arrive meanwhile
        return []

    monkeypatch.setattr(tcuda, "_LIBS", {})
    monkeypatch.setattr(tcuda, "build", fake_build)
    monkeypatch.setattr(tcuda.ctypes, "CDLL", lambda path: loaded.append(path) or object())
    monkeypatch.setattr(tcuda, "_declare", lambda name, lib: None)
    barrier = threading.Barrier(8)
    libs = []

    def load():
        barrier.wait(timeout=30)
        libs.append(tcuda._library("sketch_gram"))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=load) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert built == [("sketch_gram",)] and len(loaded) == 1
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)


def test_concurrent_builds_write_distinct_temporary_files(monkeypatch, tmp_path):
    """Two threads building one cold library at once each compile into a file of
    their own, and both move a whole library into place."""
    outs, errors = [], []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            self.out = cmd[cmd.index("-o") + 1]
            outs.append(self.out)
            self.returncode = 0

        def communicate(self):
            threading.Event().wait(0.1)  # both threads are compiling now
            with open(self.out, "w") as f:
                f.write("lib")
            return "", None

    monkeypatch.setattr(tcuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tcuda, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(tcuda.subprocess, "Popen", FakeNvcc)
    barrier = threading.Barrier(2)

    def build():
        barrier.wait(timeout=30)
        try:
            tcuda.build(["fwht"])
        except Exception as exc:  # noqa: BLE001 - reported by the assertion below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(outs) == 2 and len(set(outs)) == 2
    assert tcuda.library_path("fwht").read_text() == "lib"


def test_launch_counts_are_exact_under_8_threads():
    import collections

    counter = collections.Counter()
    barrier = threading.Barrier(8)

    def launch():
        barrier.wait(timeout=30)
        for _ in range(20_000):
            tcuda.count_launch(counter, "sjlt_gram")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counter == {"sjlt_gram": 160_000}
