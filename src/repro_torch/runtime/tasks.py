"""Worker payloads and error estimators for the runtime engine.

Port of ``repro.runtime.tasks``. A *task* is one serverless invocation: derive
the (worker, round) key, sketch, solve, return x̂_k. The builders here produce
``compute_fn(worker_id, round_id)`` callables over the port's solver stack
(``solve.sketch_and_solve``, with the fused single-pass sketch→Gram by default,
or ``solve.sketch_least_norm``) and the key schedule ``prng.worker_key(base_key,
w, round)`` of ``distributed_sketch_solve``, so an asynchronous run and a
synchronous one with the same realized worker set draw the same sketches.

The payloads are *picklable task specs*: plain classes over numpy state (the key
words, A and b) and the name of the device they run on. Each process makes one
device copy of A and b, lazily at its first task, and every task of that process
(every thread of the thread backend) uses it; the copy is dropped when the spec
is pickled, which is what lets the ``process`` backend ship one payload to each
worker process and submit bare ``(worker_id, round_id)`` coordinates afterwards.
A spec built on the caller's tensors that already lie on its device uses them
and keeps no host copy: the numpy A and b are made only when it is pickled. ``device=None`` means CUDA and raises when it is absent; a
spec runs on the CPU only when given ``device="cpu"``.

Early-stop estimators (for ``RuntimeConfig.target_error``):

  * :func:`theory_error_fn` — Theorem 1's closed form d/(q′(m−d−1)): predicted
    relative error after q′ Gaussian results (a heuristic proxy for other kinds).
  * :func:`probe_error_fn` — a held-out residual probe: relative excess cost of x̄
    on (A_p, b_p) against the probe's own optimum, no theory assumptions. On the
    card each arrival costs one (n_p, d) product and one wait for its value.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import sketches as sk, solve, theory
from repro_torch.runtime.backends import ExecutorBackend
from repro_torch.runtime.engine import DeadlinePolicy, RuntimeConfig, RuntimeResult, ServerlessEngine
from repro_torch.runtime.latency import LatencyModel
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

# Guards every spec's lazy device copy: the thread backend calls one spec from
# several threads at once, and the first makes the copy the others share. It is
# not a field of the spec, since a lock does not pickle.
_DEVICE_COPY_LOCK = threading.Lock()


def _key_data(key) -> np.ndarray:
    """A key's two words (an int64 tensor, or any array of them) as a picklable
    numpy int64 (2,) array."""
    words = np.asarray(key.detach().cpu() if isinstance(key, torch.Tensor) else key).astype(np.int64)
    if words.shape != (2,):
        raise ValueError(f"a key is two words, got shape {words.shape}")
    return words


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lies_on(x, dev: torch.device) -> bool:
    """Whether x is a tensor on ``dev`` (an index-less CUDA device: the current one)."""
    if not isinstance(x, torch.Tensor) or x.device.type != dev.type:
        return False
    return dev.type == "cpu" or x.device.index == (torch.cuda.current_device() if dev.index is None else dev.index)


class _PicklableCompute:
    """Base for process-shippable payloads: numpy state plus a device copy of (A, b)
    made once per process."""

    def __init__(self, spec: sk.SketchSpec, base_key, A, b, *, device=None):
        self.spec = spec
        dev = resolve_device(device)
        self.device = str(dev)
        self.base_key = _key_data(base_key)
        if _lies_on(A, dev) and _lies_on(b, dev):
            self.A = self.b = None  # the host copy is made only when the spec is pickled
            self._data = self._prepare(A, b)
        else:
            self.A, self.b = _host(A), _host(b)
            self._data = None

    def _prepare(self, A: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device form of (A, b) every task reads."""
        return A, b

    def _solve(self, wkey: torch.Tensor, A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _device_data(self) -> Tuple[torch.Tensor, torch.Tensor]:
        data = self._data
        if data is None:
            with _DEVICE_COPY_LOCK:
                if self._data is None:
                    dev = resolve_device(self.device)
                    self._data = self._prepare(torch.from_numpy(self.A).to(dev), torch.from_numpy(self.b).to(dev))
                data = self._data
        return data

    def __call__(self, worker_id: int, round_id: int) -> np.ndarray:
        A, b = self._device_data()
        wkey = prng.worker_key(torch.from_numpy(self.base_key), worker_id, round_id)
        return self._solve(wkey, A, b).cpu().numpy()

    def __getstate__(self):
        state = dict(self.__dict__)
        if self.A is None:
            state["A"], state["b"] = (_host(x) for x in self._data)
        state["_data"] = None  # device copies never cross process boundaries
        return state


class SketchSolveCompute(_PicklableCompute):
    """One Algorithm-1 worker as a task spec: (worker, round) ↦ x̂ ∈ R^d."""

    def __init__(self, spec, base_key, A, b, *, reg: float = 0.0, method: str = "fused", device=None):
        self.reg = float(reg)
        self.method = str(method)
        super().__init__(spec, base_key, A, b, device=device)

    def _solve(self, wkey, A, b):
        return solve.sketch_and_solve(self.spec, wkey, A, b, reg=self.reg, method=self.method)


class LeastNormCompute(_PicklableCompute):
    """§V right-sketch worker (n < d) as a task spec. The device copy of A is laid
    out so that Aᵀ is contiguous, so no task's forward S·Aᵀ copies it."""

    def _prepare(self, A, b):
        return A.T.contiguous().T, b

    def _solve(self, wkey, A, b):
        return solve.sketch_least_norm(self.spec, wkey, A, b)


def make_sketch_solve_compute(spec: sk.SketchSpec, base_key, A, b, *, reg: float = 0.0, method: str = "fused",
                              device=None) -> SketchSolveCompute:
    """One Algorithm-1 worker as a ``compute_fn``: (worker, round) ↦ x̂ ∈ R^d."""
    return SketchSolveCompute(spec, base_key, A, b, reg=reg, method=method, device=device)


def make_least_norm_compute(spec: sk.SketchSpec, base_key, A, b, *, device=None) -> LeastNormCompute:
    """§V right-sketch worker (n < d) as a ``compute_fn``."""
    return LeastNormCompute(spec, base_key, A, b, device=device)


# ----------------------------------------------------------------- error estimators


def theory_error_fn(spec: sk.SketchSpec, d: int) -> Callable[[np.ndarray, int], float]:
    """Predicted relative error after q′ arrivals — Theorem 1, exact for Gaussian
    sketches (documented heuristic otherwise). Ignores x̄: a pure function of the
    realized count, so stopping is decided without touching the data."""
    single = theory.gaussian_single_error(spec.m, d)

    def err(_xbar: np.ndarray, count: int) -> float:
        return single / max(count, 1)

    return err


def probe_error_fn(A_probe: torch.Tensor, b_probe: torch.Tensor) -> Callable[[np.ndarray, int], float]:
    """Held-out residual probe: (f_p(x̄) − f_p*) / f_p* on probe rows, on their device.

    The probe's own optimum f_p* is computed once; each arrival costs one (n_p, d)
    product. With probe rows subsampled from (A, b) this estimates the paper's
    relative approximation error without knowing the full problem's f*."""
    x_p = solve.lstsq(A_probe, b_probe)
    fstar = float(solve.residual_cost(A_probe, b_probe, x_p))

    def err(xbar: np.ndarray, _count: int) -> float:
        x = torch.as_tensor(np.asarray(xbar), dtype=A_probe.dtype).to(A_probe.device)
        f = float(solve.residual_cost(A_probe, b_probe, x))
        return (f - fstar) / max(fstar, 1e-30)

    return err


def subsample_probe(key: torch.Tensor, A, b, rows: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform row probe of (A, b) for :func:`probe_error_fn`: the rows
    ``jax.random.choice(key, n, (rows,), replace=False)`` picks, bitwise
    (``prng.choice``). Tensors are indexed on their device (the rows drawn
    there); numpy arrays on the CPU."""
    n = A.shape[0]
    if isinstance(A, torch.Tensor):
        idx = prng.choice(key, n, (min(rows, n),), device=A.device)
        return A[idx], b[idx.to(b.device)]
    idx = prng.choice(key, n, (min(rows, n),)).numpy()
    return torch.from_numpy(np.asarray(A)[idx]), torch.from_numpy(np.asarray(b)[idx])


def resolve_error_fn(
    error_fn: Union[None, str, Callable[[np.ndarray, int], float]],
    spec: sk.SketchSpec,
    key: torch.Tensor,
    A,
    b,
    *,
    probe_rows: int = 1024,
    device=None,
) -> Optional[Callable[[np.ndarray, int], float]]:
    """``"theory"`` / ``"probe"`` / callable / None → the engine's error callback
    (the probe on ``device``: ``None`` means CUDA)."""
    if error_fn == "theory":
        return theory_error_fn(spec, A.shape[1])
    if error_fn == "probe":
        pk = prng.fold_in(torch.from_numpy(_key_data(key)), 0x9B0BE)
        dev = resolve_device(device)
        A_p, b_p = subsample_probe(pk, A, b, rows=probe_rows)
        return probe_error_fn(A_p.to(dev), b_p.to(dev))
    return error_fn


# -------------------------------------------------------------- one-call entry point


def serverless_sketch_solve(
    spec: sk.SketchSpec,
    key: torch.Tensor,
    A,
    b,
    *,
    q: int,
    latency: LatencyModel,
    config: Optional[RuntimeConfig] = None,
    rounds: int = 1,
    reg: float = 0.0,
    method: str = "fused",
    error_fn: Union[None, str, Callable[[np.ndarray, int], float]] = None,
    probe_rows: int = 1024,
    backend: Union[None, str, ExecutorBackend] = None,
    deadline: Union[None, float, DeadlinePolicy] = None,
    device=None,
) -> RuntimeResult:
    """Algorithm 1 on the asynchronous engine: ``rounds`` waves of ``q`` workers,
    averaged as they arrive. ``error_fn``: a callable, ``"theory"``, ``"probe"``,
    or None (None still runs every task; "theory"/"probe" also enable the
    early-stop comparison when ``config.target_error`` is set). ``backend``
    selects the executor (``"inline"``/``"thread"``/``"process"``, default
    ``config.backend``); ``deadline`` an optional
    :class:`~repro_torch.runtime.engine.DeadlinePolicy`. ``device``: where every
    task runs (``None`` means CUDA, raising when absent; ``"cpu"`` for the CPU).
    """
    compute = make_sketch_solve_compute(spec, key, A, b, reg=reg, method=method, device=device)
    error_fn = resolve_error_fn(error_fn, spec, key, A, b, probe_rows=probe_rows, device=device)
    tasks: Sequence[Tuple[int, int]] = [(w, r) for r in range(rounds) for w in range(q)]
    engine = ServerlessEngine(compute, latency, config, backend=backend, deadline=deadline)
    return engine.run(tasks=tasks, error_fn=error_fn)
