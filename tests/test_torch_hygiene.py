"""Boundaries of the PyTorch port: what it imports, where it runs, how it fails.

* No module of ``src/repro_torch``, not ``chip_smoke.py`` and no script of
  ``tools/`` imports JAX or the JAX package ``repro`` (an AST scan, so a lazy
  import inside a function counts).
* Every module imports on CPU-only PyTorch without building anything.
* The entry points run on CUDA by default and raise when it is absent (the LM's
  ``init_params``, ``init_cache``, ``lm_batch``, ``Engine`` and the launcher's
  LM mode too, for the MoE, windowed, MLA, hybrid and attention-free configs as well; the training state,
  ``Trainer`` and the training launcher).
* ``chip_smoke.py`` exits non-zero, printing no result, without CUDA and outside
  a checkout.
"""
import ast
import importlib
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
PORT_FILES = sorted(PORT.rglob("*.py")) + [SMOKE] + sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = [(root, line) for root, line in _imported_roots(path) if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_every_kernel_module():
    """The S·A and FWHT launch modules and every wrapper are among the scanned files."""
    scanned = {str(p.relative_to(PORT)) for p in PORT_FILES if PORT in p.parents}
    for family in ("gaussian", "rademacher", "sjlt", "fwht"):
        assert {f"kernels/{family}/{m}.py" for m in ("kernel", "gram", "ops", "ref")} <= scanned
    assert {"kernels/cuda.py", "utils/prng.py", "core/operators.py", "core/distributed.py"} <= scanned


def test_scan_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    import jax.numpy\n    from repro.core import solve\n    import repro_torch\n")
    assert [r for r, _ in _imported_roots(probe) if r in FORBIDDEN] == ["jax", "repro"]


def test_every_port_module_imports_without_building(monkeypatch, tmp_path):
    from repro_torch.kernels import cuda

    names = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts).replace(".__init__", "")
        for p in PORT.rglob("*.py")
    )
    for name in names:
        importlib.import_module(name)
    assert cuda._LIBS == {}
    assert len(names) >= 24


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


SPECS = {
    "gaussian": dict(kind="gaussian", m=8),
    "uniform": dict(kind="uniform", m=8, replacement=False),
    "leverage": dict(kind="leverage", m=8),
    "hybrid_srht": dict(kind="hybrid", m=8, m_prime=16, inner="srht", use_kernel=True),
    "sjlt_kernel": dict(kind="sjlt", m=8, use_kernel=True),
}


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("method", ["fused", "qr"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, spec, method):
    from repro_torch.core import distributed, sketches
    from repro_torch.data import regression
    from repro_torch.utils import prng
    from repro_torch.utils.device import resolve_device

    _no_cuda(monkeypatch)
    A, b = torch.zeros(64, 3), torch.zeros(64)
    spec = sketches.SketchSpec(**SPECS[spec])
    for entry in (distributed.distributed_sketch_solve, distributed.distributed_sketch_solve_master):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry(spec, prng.prng_key(0), A, b, q=2, method=method)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry(spec, prng.prng_key(0), A, b, q=2, method=method, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        regression.gaussian_regression(0, 16, 2)
    assert resolve_device("cpu") == torch.device("cpu")


def test_lm_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.data import tokens
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.utils import prng

    cfg = get_config("granite-3-8b").reduced()
    model = lm.init_params(cfg, prng.prng_key(0), device="cpu")
    _no_cuda(monkeypatch)
    calls = (
        lambda: lm.init_params(cfg, prng.prng_key(0)),
        lambda: lm.init_cache(cfg, 1, 8),
        lambda: lm.params_from_reference(cfg, {}),
        lambda: tokens.lm_batch(0, 0, batch=1, seq=4, vocab=cfg.vocab_size),
        lambda: tokens.lm_eval_batch(0, 0, batch=1, seq=4, vocab=cfg.vocab_size),
        lambda: Engine(cfg, model, ServeConfig()),
        lambda: launch_serve.main(["--arch", "granite-3-8b", "--reduced"]),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert Engine(cfg, model, ServeConfig(), device="cpu").generate([[1, 2]], max_new_tokens=2)


def test_lm_modules_are_scanned():
    scanned = {str(p.relative_to(PORT)) for p in PORT_FILES if PORT in p.parents}
    assert {"models/layers.py", "models/attention.py", "models/lm.py", "data/tokens.py", "configs/base.py",
            "configs/granite_3_8b.py", "configs/chatglm3_6b.py", "serve/engine.py", "launch/serve.py"} <= scanned


def test_moe_and_windowed_modules_are_scanned():
    scanned = {str(p.relative_to(PORT)) for p in PORT_FILES if PORT in p.parents}
    assert {"models/moe.py", "configs/mixtral_8x7b.py", "configs/gemma3_12b.py", "configs/grok_1_314b.py"} <= scanned


def test_mla_and_ssm_modules_are_scanned():
    scanned = {str(p.relative_to(PORT)) for p in PORT_FILES if PORT in p.parents}
    assert {"models/ssm.py", "configs/minicpm3_4b.py", "configs/hymba_1_5b.py", "configs/falcon_mamba_7b.py"} <= scanned


@pytest.mark.parametrize("arch", ["minicpm3-4b", "hymba-1.5b", "falcon-mamba-7b"])
def test_mla_and_hybrid_lm_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, arch):
    _lm_entry_points_default_to_cuda(monkeypatch, arch)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "gemma3-12b", "grok-1-314b"])
def test_moe_and_windowed_lm_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, arch):
    _lm_entry_points_default_to_cuda(monkeypatch, arch)


def _lm_entry_points_default_to_cuda(monkeypatch, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.utils import prng

    cfg = get_config(arch).reduced()
    model = lm.init_params(cfg, prng.prng_key(0), device="cpu")
    _no_cuda(monkeypatch)
    for call in (lambda: lm.init_params(cfg, prng.prng_key(0)), lambda: lm.init_cache(cfg, 1, 8),
                 lambda: Engine(cfg, model, ServeConfig()), lambda: launch_serve.main(["--arch", arch, "--reduced"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert Engine(cfg, model, ServeConfig(), device="cpu").generate([list(range(1, 12))], max_new_tokens=2)


def test_training_modules_are_scanned():
    scanned = {str(p.relative_to(PORT)) for p in PORT_FILES if PORT in p.parents}
    assert {"optim/__init__.py", "optim/adamw.py", "optim/schedules.py", "train/state.py", "train/step.py",
            "train/sketch_dp.py", "train/trainer.py", "checkpoint/__init__.py", "checkpoint/store.py",
            "launch/train.py", "utils/tree.py"} <= scanned


def test_training_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig, init_train_state, state
    from repro_torch.utils import prng

    cfg = get_config("granite-3-8b").reduced()
    tree = state.checkpoint_tree(init_train_state(cfg, AdamWConfig(), prng.prng_key(0), device="cpu"))
    _no_cuda(monkeypatch)
    calls = (
        lambda: init_train_state(cfg, AdamWConfig(), torch.zeros(2, dtype=torch.int64)),
        lambda: state.state_from_tree(cfg, tree),
        lambda: Trainer(cfg, AdamWConfig(), TrainerConfig()),
        lambda: launch_train.main(["--arch", "granite-3-8b", "--reduced", "--steps", "1"]),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert Trainer(cfg, AdamWConfig(), TrainerConfig(batch=1, seq=4), device="cpu").run(1)["step"] == 1


def _run_smoke(cwd: pathlib.Path, script: pathlib.Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_chip_smoke_fails_without_cuda():
    res = _run_smoke(ROOT, SMOKE)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "CUDA is not available" in res.stderr


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, lone)
    res = _run_smoke(tmp_path, lone)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "run it from a checkout" in res.stderr


def test_straggler_mask_accepts_numpy_and_tensors():
    from repro_torch.core import distributed

    m = distributed._checked_mask(np.array([1, 0], np.float32), 2, torch.device("cpu"))
    assert m.dtype == torch.float32 and m.tolist() == [1.0, 0.0]
    assert distributed._checked_mask(None, 3, "cpu").tolist() == [1.0, 1.0, 1.0]
