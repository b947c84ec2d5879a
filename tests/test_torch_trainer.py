"""The port's Trainer and training launcher against the JAX reference (CPU).

* ``fail_at_step`` replay: a run that checkpoints at step 2 (``AsyncCheckpointer``)
  and drops its state at step 3 ends bitwise where the run that never crashed
  ends (parameters, moments, count, step), with the sketch-DP step (CountSketch,
  keys folded from the step) under a seeded latency model's straggler mask.
* The straggler report: the port's ``Trainer`` and the reference's over the
  same 5 steps and ``LognormalLatency`` seed give the same report (the
  runtimes are the reference's draws; the report's floats within 1e-12).
* The launcher: ``python -m repro_torch.launch.train --arch granite-3-8b
  --reduced --device cpu`` (4 steps, a checkpoint at step 2) logs the
  reference launcher's losses and gradient norms within LAUNCH_TOL and leaves
  its checkpoints; the same for the reduced mixtral-8x7b, with its MoE
  auxiliary loss.
"""
import contextlib
import io
import os
import re
import sys

import jax
import pytest
import torch

import _torch_lm_train as lt
from repro import runtime as jrt
from repro.core import gradcomp as jgc
from repro.optim import AdamWConfig as JAdamW
from repro.train import Trainer as JTrainer, TrainerConfig as JTC
from repro_torch import runtime as trt
from repro_torch.core import gradcomp as tgc
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.train import Trainer as TTrainer, TrainerConfig as TTC, sketch_dp as tsdp, state as tstate
from repro_torch.utils import prng as tprng, tree as tu

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

LAUNCH_TOL = 1e-4  # the launcher prints 4 decimals
COMP = dict(enabled=True, ratio=0.1)
LATENCY = dict(seed=5, mean_s=1.0, sigma=0.5)


def _port_trainer(tcfg, tc):
    opt = TAdamW(lr=lt.LR, eps=lt.EPS)
    step = tsdp.make_sketch_dp_step(tcfg, opt, comp=tgc.GradCompressionConfig(**COMP))
    base = tprng.prng_key(1)
    return TTrainer(tcfg, opt, tc, device="cpu",
                    step_fn=lambda st, b, mask: step(st, b, tprng.fold_in(base, int(st["step"])), mask))


def _flat(state) -> dict:
    out = {}
    for path, leaf in tu.tree_flatten_with_path(tstate.checkpoint_tree(state))[0]:
        out[tu.path_str(path)] = torch.stack(leaf.parts) if isinstance(leaf, tu.Stacked) else leaf
    return out


def test_fail_at_step_replays_bitwise(tmp_path):
    _, tcfg = lt.configs()
    runs = {}
    for name, fail in (("clean", None), ("crash", 3)):
        tc = TTC(batch=lt.BATCH, seq=lt.SEQ, ckpt_dir=str(tmp_path / name), ckpt_every=2, fail_at_step=fail,
                 latency=trt.LognormalLatency(**LATENCY), straggler_q=4, deadline_s=1.2)
        runs[name] = _flat(_port_trainer(tcfg, tc).run(5))
    assert runs["clean"].keys() == runs["crash"].keys()
    for k, v in runs["clean"].items():
        assert torch.equal(v, runs["crash"][k]), k
    assert int(runs["crash"]["step"]) == 5 and int(runs["crash"]["opt/count"]) == 5


def test_straggler_report_matches_reference():
    jcfg, tcfg = lt.configs()
    kw = dict(batch=lt.BATCH, seq=lt.SEQ, straggler_q=8, deadline_s=1.2, log_every=1)
    jopt = JAdamW(lr=lt.LR, eps=lt.EPS)
    jstep = lt.reference_sketch_dp_step(jcfg, jopt, jgc.GradCompressionConfig(**COMP))
    base = jax.random.PRNGKey(1)
    jtr = JTrainer(jcfg, jopt, JTC(latency=jrt.LognormalLatency(**LATENCY), **kw),
                   step_fn=lambda st, b, mask: jstep(st, b, jax.random.fold_in(base, st["step"]), mask))
    jtr.run(5)
    ttr = _port_trainer(tcfg, TTC(latency=trt.LognormalLatency(**LATENCY), **kw))
    ttr.run(5)
    want, got = jtr.straggler_report(), ttr.straggler_report()
    assert got.keys() == want.keys() and want
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k
    assert [h["step"] for h in ttr.history] == [h["step"] for h in jtr.history]
    for h_t, h_j in zip(ttr.history, jtr.history):
        assert list(h_t) == list(h_j)
        assert h_t["loss"] == pytest.approx(h_j["loss"], rel=1e-5)


def _metrics(text: str) -> list:
    return [dict((k, float(v)) for k, v in re.findall(r"(\w+)=(-?[\d.]+)", line))
            for line in text.splitlines() if line.startswith("  step=")]


def test_launcher_trains_on_cpu_like_the_reference(tmp_path):
    _launcher_like_the_reference(tmp_path, "granite-3-8b")


def test_moe_launcher_trains_on_cpu_like_the_reference(tmp_path):
    """The reduced mixtral-8x7b: its metrics carry the MoE auxiliary term."""
    got = _launcher_like_the_reference(tmp_path, "mixtral-8x7b")
    assert all(m["moe_aux"] > 0 for m in got)


def _launcher_like_the_reference(tmp_path, arch: str) -> list:
    from repro.launch import train as jlaunch
    from repro_torch.launch import train as tlaunch

    argv = ["--arch", arch, "--reduced", "--steps", "4", "--ckpt-every", "2"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tlaunch.main(argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")]) == 0
    ref = io.StringIO()
    old = sys.argv
    sys.argv = ["train"] + argv
    try:
        with contextlib.redirect_stdout(ref):
            assert jlaunch.main() == 0
    finally:
        sys.argv = old
    got, want = _metrics(out.getvalue()), _metrics(ref.getvalue())
    assert out.getvalue().startswith(f"arch={arch} steps=4 wall=")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert abs(g[k] - w[k]) <= LAUNCH_TOL, (k, g[k], w[k])
    assert sorted(os.listdir(tmp_path / "port")) == ["step_00000002", "step_00000004"]
    return got
