"""Trainer loop: deterministic data, async checkpoints, crash recovery, stragglers.

Port of ``repro.train.trainer``, with its contract:

* restart determinism — batches are pure functions of (seed, step)
  (``data.tokens.lm_batch``) and any key is derived from the step, so a job
  restored from step k replays bitwise the run that never crashed;
* crash-safe saves — checkpoints are atomic and written asynchronously
  (``checkpoint``); ``Trainer.run`` resumes from the latest complete step;
* straggler simulation — given ``TrainerConfig.latency`` (a seeded
  ``runtime`` latency model) each step draws one wave of per-worker runtimes
  (a pure function of (seed, worker, step)), records it in a
  ``HeartbeatMonitor`` and passes the on-time mask as a third argument,
  ``step_fn(state, batch, mask)``. The sketch-DP step takes
  ``(state, batch, key, mask)``: callers wrap it with
  ``key = prng.fold_in(base_key, step)``. ``straggler_report()`` gives the
  monitor's report.

The state lives on ``device`` (default CUDA) and each step updates it in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import lm_batch
from repro_torch.optim import AdamWConfig
from repro_torch.train.state import checkpoint_tree, init_train_state, state_from_tree, train_state_shapes
from repro_torch.train.step import make_train_step
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainerConfig:
    seed: int = 0
    batch: int = 8
    seq: int = 128
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    accum_steps: int = 1
    remat: str = "full"
    # failure injection (tests and demos): drop the state at this step
    fail_at_step: Optional[int] = None
    # a runtime LatencyModel: each step samples a (straggler_q,) runtime wave
    # and step_fn is called as step_fn(state, batch, mask)
    latency: Optional[Any] = None
    straggler_q: int = 8
    deadline_s: float = 1.0


class Trainer:
    def __init__(self, cfg: ArchConfig, opt_cfg: AdamWConfig, tc: TrainerConfig, *,
                 step_fn: Optional[Callable] = None, schedule: Optional[Callable] = None, device=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tc = tc
        self.device = resolve_device(device)
        self.step_fn = step_fn or make_train_step(cfg, opt_cfg, schedule=schedule, remat=tc.remat,
                                                  accum_steps=tc.accum_steps)
        self.ckpt = AsyncCheckpointer(tc.ckpt_dir, keep=tc.ckpt_keep) if tc.ckpt_dir else None
        self.history: List[Dict[str, float]] = []
        self.monitor = None
        if tc.latency is not None:
            from repro_torch.distributed.fault_tolerance import HeartbeatMonitor

            self.monitor = HeartbeatMonitor(q=tc.straggler_q, deadline=tc.deadline_s)

    # ------------------------------------------------------------------ state
    def init_or_restore(self) -> dict:
        if self.tc.ckpt_dir:
            step = latest_step(self.tc.ckpt_dir)
            if step is not None:
                like = checkpoint_tree(train_state_shapes(self.cfg, self.opt_cfg))
                tree = restore_checkpoint(self.tc.ckpt_dir, step, like, device=self.device)
                return state_from_tree(self.cfg, tree, device=self.device)
        return init_train_state(self.cfg, self.opt_cfg, prng.prng_key(self.tc.seed), device=self.device)

    def batch_for_step(self, step: int) -> Dict[str, torch.Tensor]:
        return lm_batch(self.tc.seed, step, batch=self.tc.batch, seq=self.tc.seq, vocab=self.cfg.vocab_size,
                        device=self.device)

    # ------------------------------------------------------------------ loop
    def run(self, steps: int, *, state: Optional[dict] = None) -> dict:
        state = state if state is not None else self.init_or_restore()
        s = int(state["step"])
        while s < steps:
            if self.tc.fail_at_step is not None and s == self.tc.fail_at_step:
                # a node crash: the in-memory state is dropped and the loop
                # restarts from the last complete checkpoint and replays
                if self.ckpt:
                    self.ckpt.wait()
                self.tc.fail_at_step = None
                state = self.init_or_restore()
                s = int(state["step"])
                continue
            batch = self.batch_for_step(s)
            if self.monitor is not None:
                wave = self.tc.latency.sample_wave(self.tc.straggler_q, round_id=s)
                mask = self.monitor.record_step(wave)
                self.monitor.record_timeout(int(self.tc.straggler_q - mask.sum()))
                state, metrics = self.step_fn(state, batch, torch.as_tensor(mask, device=self.device))
            else:
                state, metrics = self.step_fn(state, batch)
            if s % self.tc.log_every == 0 or s == steps - 1:
                self.history.append({"step": s, **{k: float(metrics[k]) for k in sorted(metrics)}})
            if self.ckpt and (s + 1) % self.tc.ckpt_every == 0:
                self.ckpt.save(s + 1, checkpoint_tree(state))
            s += 1
        if self.ckpt:
            self.ckpt.save(steps, checkpoint_tree(state))
            self.ckpt.wait()
        return state

    def straggler_report(self) -> Dict[str, float]:
        """The monitor's report (p50/p95, timeouts, effective q′) for the run;
        empty without a latency model."""
        return self.monitor.report() if self.monitor is not None else {}
