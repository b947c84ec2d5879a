"""The train step: loss → grads → AdamW, with microbatch gradient accumulation.

Port of ``repro.train.step``. The reference's step is jitted and its
data-parallel mean is inserted by GSPMD; here one process takes the gradient
of its whole batch (``loss.backward()``) and updates in place. With
``rules`` and DTensor parameters (``distributed.sharding``) the step is the
sharded program: the forward's ``constrain`` points redistribute its
activations and :func:`_constrain_like_params` redistributes each gradient to
its parameter's placements (the reference pins them to their parameters'
sharding, so the data-parallel sum becomes a reduce-scatter to the owning
shard); without rules both are the identity. The sketch-compressed,
straggler-masked step lives in ``sketch_dp.py``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_update


def _constrain_like_params(grads: dict, rules: Optional[sharding.ShardingRules]) -> dict:
    """Each gradient (by parameter name) redistributed to its parameter's
    placements: the identity without rules or for plain tensors."""
    if rules is None:
        return grads
    specs = sharding.named_pspecs(grads, rules)
    return {name: _to_spec(g, specs[name]) for name, g in grads.items()}


def _to_spec(g, spec):
    from torch.distributed.tensor import DTensor

    if not isinstance(g, DTensor):
        return g
    placements = sharding.to_placements(spec, g.device_mesh)
    return g if tuple(g.placements) == placements else g.redistribute(g.device_mesh, placements)


def make_loss_fn(cfg: ArchConfig, *, rules: Optional[sharding.ShardingRules] = None,
                 plan: Optional[lm.ExecPlan] = None):
    plan = plan or lm.ExecPlan()

    def loss_fn(params, batch):
        return lm.lm_loss(params, cfg, batch, rules=rules, plan=plan)

    return loss_fn


def take_grads(params: lm.LM) -> dict:
    """Each parameter's ``.grad`` by name, detached from the module (its
    ``.grad`` set to None)."""
    grads = {}
    for name, p in params.named_parameters():
        grads[name], p.grad = p.grad, None
    return grads


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *, rules: Optional[sharding.ShardingRules] = None,
                    schedule: Optional[Callable] = None,
                    plan: Optional[lm.ExecPlan] = None, remat: str = "full", accum_steps: int = 1,
                    accum_dtype: str = "float32") -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``, the state updated
    in place.

    accum_steps > 1 splits the batch's leading dim into microbatches and sums
    their gradients in ``accum_dtype`` (each product of the sum in float32,
    rounded to the accumulator's dtype), then scales by 1/accum_steps, as the
    reference's scan does: peak activation memory divides by accum_steps."""
    plan = plan or lm.ExecPlan(remat=remat)
    acc_dt = torch.bfloat16 if accum_dtype == "bfloat16" else torch.float32
    loss_fn = make_loss_fn(cfg, rules=rules, plan=plan)

    def grad_fn(params, batch):
        with lm.sharded_region(params):
            loss, aux = loss_fn(params, batch)
            loss.backward()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, _constrain_like_params(take_grads(params), rules)

    def compute_grads(params, batch):
        if accum_steps <= 1:
            return grad_fn(params, batch)
        mb = next(iter(batch.values())).shape[0] // accum_steps
        z = torch.zeros((), dtype=torch.float32, device=next(params.parameters()).device)
        loss_acc, aux_acc = z, {"ce": z, "moe_aux": z}
        gacc = {name: torch.zeros(p.shape, dtype=acc_dt, device=p.device) for name, p in params.named_parameters()}
        for i in range(accum_steps):
            micro = {k: v[i * mb : (i + 1) * mb] for k, v in batch.items()}
            loss, aux, g = grad_fn(params, micro)
            for name in gacc:
                gacc[name] = (gacc[name].to(torch.float32) + g[name].to(torch.float32)).to(acc_dt)
            loss_acc = loss_acc + loss
            aux_acc = {"ce": aux_acc["ce"] + aux["ce"], "moe_aux": aux_acc["moe_aux"] + aux["moe_aux"]}
        inv = 1.0 / accum_steps
        return loss_acc * inv, {k: a * inv for k, a in aux_acc.items()}, {k: g * inv for k, g in gacc.items()}

    def train_step(state, batch):
        loss, aux, grads = compute_grads(state["params"], batch)
        lr_scale = schedule(state["step"]) if schedule is not None else 1.0
        _, _, om = adamw_update(opt_cfg, state["params"], grads, state["opt"], lr_scale=lr_scale)
        state["step"] = state["step"] + 1
        return state, {"loss": loss, **aux, **om}

    return train_step
