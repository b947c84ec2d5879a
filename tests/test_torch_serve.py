"""The port's sketch-solve server (``repro_torch.serve.SolveServer``) and its
``--solve`` launcher against the JAX package's, on the CPU.

The same seeded jobs on both servers: the summaries and ``telemetry()`` are the
reference's key for key except ``final_error`` (the probe's float32 residuals,
within 1e-5), the event logs byte for byte where no probe error is logged, and
x̄ within 1e-5 of its largest entry. The launchers, at the same arguments, print
job lines with the same q′, retries, timeouts, drops and makespan.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core import sketches as jsk
from repro.serve import SolveServer as JServer
from repro_torch import runtime as trt
from repro_torch.core import distributed as tdist, sketches as tsk
from repro_torch.serve import SolveServer as TServer
from repro_torch.utils import prng as tprng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

N, D, M = 1024, 16, 128
TOL = 1e-5


def _data(seed=0, n=N, d=D):
    rs = np.random.default_rng(seed)
    A = rs.standard_normal((n, d)).astype(np.float32)
    return A, (A @ rs.standard_normal(d) + 0.3 * rs.standard_normal(n)).astype(np.float32)


def _servers(latency, config, **kw):
    return (JServer(latency=latency(jrt), config=jrt.RuntimeConfig(**config), **kw),
            TServer(latency=latency(trt), config=trt.RuntimeConfig(**config), device="cpu", **kw))


def _drop(rt):
    return rt.DropLatency(seed=19, inner=rt.LognormalLatency(seed=19, mean_s=0.4, sigma=0.6), drop_prob=0.2)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def _same_summary(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if k == "final_error" and want[k] is not None:
            assert got[k] == pytest.approx(want[k], rel=0, abs=TOL)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("error_fn", [None, "theory", "probe"])
@pytest.mark.parametrize("kind", ["gaussian", "sjlt"])
def test_submit_solve_summaries_and_telemetry_equal_the_reference(kind, error_fn, tmp_path):
    A, b = _data()
    jspec, tspec = jsk.SketchSpec(kind, M, s=4), tsk.SketchSpec(kind, M, s=4, use_kernel=True)
    jserver, tserver = _servers(_drop, dict(deadline_s=0.5, max_retries=2, backoff_base_s=0.05))
    for seed in (4, 4, 9):
        want = jserver.submit_solve(jnp.asarray(A), jnp.asarray(b), jspec, q=8, seed=seed, error_fn=error_fn)
        path = tmp_path / f"job{len(tserver.jobs)}.jsonl"
        got = tserver.submit_solve(torch.from_numpy(A), torch.from_numpy(b), tspec, q=8, seed=seed,
                                   error_fn=error_fn, save_events=str(path))
        _same_summary(got.summary, want.summary)
        if error_fn != "probe":
            assert got.result.events.lines() == want.result.events.lines()
        assert path.read_text().splitlines() == got.result.events.lines()
        _close(got.xbar, want.xbar)
        np.testing.assert_array_equal(got.realized_mask, want.realized_mask)
        assert (got.job_id, got.q, got.backend) == (want.job_id, want.q, want.backend)
    j0, j1 = tserver.jobs[:2]
    np.testing.assert_array_equal(j0.xbar, j1.xbar)
    assert j0.result.events.lines() == j1.result.events.lines()
    tele_w, tele_g = jserver.telemetry(), tserver.telemetry()
    per_w, per_g = tele_w.pop("per_job"), tele_g.pop("per_job")
    assert tele_g == tele_w and tele_g["jobs"] == 3
    for g, w in zip(per_g, per_w):
        _same_summary(g, w)


def test_submit_solve_early_stop_rounds_and_key():
    A, b = _data(1)
    single = D / (M - D - 1)
    cfg = dict(deadline_s=10.0, max_retries=0, target_error=single / 8)
    jserver, tserver = _servers(lambda rt: rt.ConstantLatency(seed=0, value_s=0.1), cfg)
    want = jserver.submit_solve(jnp.asarray(A), jnp.asarray(b), jsk.SketchSpec("gaussian", M), q=16, rounds=2,
                                error_fn="theory", key=jax.random.PRNGKey(5))
    got = tserver.submit_solve(torch.from_numpy(A), torch.from_numpy(b), tsk.SketchSpec("gaussian", M), q=16,
                               rounds=2, error_fn="theory", key=tprng.prng_key(5))
    assert got.summary["stopped_early"] and got.result.count == 8 and got.result.submitted == 32
    assert got.result.events.lines() == want.result.events.lines()
    _same_summary(got.summary, want.summary)
    assert tserver.telemetry()["stopped_early"] == 1
    _close(got.xbar, want.xbar)


def test_least_norm_job_matches_the_reference():
    rs = np.random.default_rng(2)
    A = rs.standard_normal((12, 200)).astype(np.float32)
    b = rs.standard_normal(12).astype(np.float32)
    jserver, tserver = _servers(_drop, dict(deadline_s=0.5, max_retries=2))
    want = jserver.submit_solve(jnp.asarray(A), jnp.asarray(b), jsk.SketchSpec("gaussian", 40), q=8, seed=3,
                                least_norm=True)
    got = tserver.submit_solve(torch.from_numpy(A), torch.from_numpy(b),
                               tsk.SketchSpec("gaussian", 40, use_kernel=True), q=8, seed=3, least_norm=True)
    assert got.result.events.lines() == want.result.events.lines()
    _same_summary(got.summary, want.summary)
    _close(got.xbar, want.xbar)


def test_per_job_backend_and_deadline_and_the_masked_solve():
    """A job may name its own backend and deadline policy; and, where no retried
    task arrived, x̄ is the port's synchronous solve over the realized mask."""
    A, b = (torch.from_numpy(x) for x in _data(3))
    spec = tsk.SketchSpec("sjlt", M, s=4, use_kernel=True)
    server = TServer(latency=trt.LognormalLatency(seed=13, mean_s=0.5, sigma=0.6),
                     config=trt.RuntimeConfig(deadline_s=0.55, max_retries=0), device="cpu")
    job = server.submit_solve(A, b, spec, q=8, seed=2)
    assert job.backend == "thread"
    mask = job.realized_mask
    assert 0 < mask.sum() < 8
    sync = tdist.distributed_sketch_solve(spec, tprng.prng_key(2), A, b, q=8, straggler_mask=mask, device="cpu")
    np.testing.assert_allclose(job.xbar, sync.double().numpy(), rtol=1e-6, atol=1e-7)
    inline = server.submit_solve(A, b, spec, q=8, seed=2, backend="inline",
                                 deadline=trt.AdaptiveDeadline(warmup_s=2.0))
    assert inline.backend == "inline" and server.telemetry()["backend"] == "thread"
    first = [ev.extra["deadline_s"] for ev in inline.result.events if ev.kind == "dispatch"]
    assert first == [2.0] * 8 and inline.result.count == 8 > job.result.count


# ------------------------------------------------------------------ launcher

ARGS = ["--solve", "--n", "2048", "--d", "16", "--m", "128", "--q", "8", "--jobs", "2", "--latency", "drop",
        "--mean-s", "0.5", "--deadline", "0.6", "--backend", "inline"]
JOB = re.compile(r"^job (\d+): (q'=\S+ retries=\d+ timeouts=\d+ drops=\d+ makespan=\S+) rel_err=(\S+)$")


def _launch(module, argv, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    assert module.main() == 0
    return capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("extra", [[], ["--adaptive", "--sketch", "sjlt"]])
def test_launcher_job_lines_equal_the_reference_launchers(extra, monkeypatch, capsys):
    from repro.launch import serve as jlaunch
    from repro_torch.launch import serve as tlaunch

    want = _launch(jlaunch, ARGS + extra, monkeypatch, capsys)
    got = _launch(tlaunch, ARGS + extra + ["--device", "cpu"], monkeypatch, capsys)
    assert len(got) == len(want) == 3
    for g, w in zip(got[:2], want[:2]):
        mg, mw = JOB.match(g), JOB.match(w)
        assert mg and mw, (g, w)
        assert mg.group(1, 2) == mw.group(1, 2)
        assert float(mg.group(3)) == pytest.approx(float(mw.group(3)), rel=1e-2)
    strip = lambda line: re.sub(r" (wall|device)=\S+", "", line)
    assert strip(got[2]) == strip(want[2]) and got[2].endswith("device=cpu")


def test_launcher_refuses_the_lm_mode(capsys):
    """Without ``--arch`` (LM mode, ported since) or ``--solve`` the launcher exits
    with the reference launcher's usage error."""
    from repro_torch.launch import serve as tlaunch

    with pytest.raises(SystemExit) as exc:
        tlaunch.main(["--n", "64"])
    assert exc.value.code == 2
    assert "pass --arch <id> (LM serving) or --solve (sketch-solve serving)" in capsys.readouterr().err
