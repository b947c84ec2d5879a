"""Train state = {"params", "opt", "step"}: the model, AdamW's state and the step.

Port of ``repro.train.state``. ``params`` is the :class:`~repro_torch.models.lm.LM`
module (its parameters require grad), ``opt`` AdamW's {"mu", "nu", "count"}
with the moments as dicts by parameter name, ``step`` an int32 0-d tensor.
:func:`checkpoint_tree` lays the state out as the reference's tree (layer
leaves stacked on a leading L axis, :class:`~repro_torch.utils.tree.Stacked`),
which is what a checkpoint stores, and :func:`state_from_tree` reads it back.
:func:`train_state_pspecs` gives that tree's specs (``distributed.sharding``:
the moments take their parameter's spec, ``count`` and ``step`` replicated),
:func:`train_state_shardings` its DTensor placements on a mesh.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.utils import tree as tu
from repro_torch.utils.device import resolve_device


def _state(params: lm.LM, opt_cfg: AdamWConfig, step: torch.Tensor) -> dict:
    params.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(opt_cfg, params), "step": step}


def init_train_state(cfg: ArchConfig, opt_cfg: AdamWConfig, key: torch.Tensor, *, device=None) -> dict:
    """The reference's initial state for ``key``: its weights (``lm.init_params``),
    zero moments, step 0, on ``device`` (default CUDA)."""
    params = lm.init_params(cfg, key, device=device)
    return _state(params, opt_cfg, torch.zeros((), dtype=torch.int32, device=resolve_device(device)))


def train_state_shapes(cfg: ArchConfig, opt_cfg: AdamWConfig) -> dict:
    """The state's structure, shapes and dtypes on the ``meta`` device: nothing
    is allocated (a checkpoint's ``like``)."""
    return _state(lm.meta_params(cfg), opt_cfg, torch.zeros((), dtype=torch.int32, device="meta"))


def train_state_pspecs(cfg: ArchConfig, opt_cfg: AdamWConfig, rules: sharding.ShardingRules) -> dict:
    """Specs of the whole state as :func:`checkpoint_tree` lays it out (stacked
    layer leaves keep their leading L entry): the moments inherit their
    parameter's spec."""
    shapes = checkpoint_tree(train_state_shapes(cfg, opt_cfg))
    pspecs = sharding.param_pspecs(shapes["params"], rules)
    return {"params": pspecs, "opt": {"mu": pspecs, "nu": pspecs, "count": ()}, "step": ()}


def train_state_shardings(cfg: ArchConfig, opt_cfg: AdamWConfig, mesh, rules: sharding.ShardingRules) -> dict:
    """The DTensor placements of every leaf of :func:`train_state_pspecs` on ``mesh``."""
    return sharding.map_specs(lambda s: sharding.to_placements(s, mesh), train_state_pspecs(cfg, opt_cfg, rules))


def checkpoint_tree(state: dict) -> dict:
    """The state as the reference's tree: {"opt": {"count", "mu", "nu"},
    "params", "step"}, each of mu, nu and params nested by the reference's
    paths with its layer leaves :class:`~repro_torch.utils.tree.Stacked`."""
    opt = state["opt"]
    params = {name: p.detach() for name, p in state["params"].named_parameters()}
    return {"opt": {"count": opt["count"], "mu": tu.stacked_tree(opt["mu"]), "nu": tu.stacked_tree(opt["nu"])},
            "params": tu.stacked_tree(params), "step": state["step"]}


@torch.no_grad()
def state_from_tree(cfg: ArchConfig, tree: dict, *, device=None) -> dict:
    """The inverse of :func:`checkpoint_tree` (a restored checkpoint), its
    tensors moved to ``device`` (default CUDA)."""
    dev = resolve_device(device)
    move = lambda t: t.to(dev)
    params = lm.params_from_named(cfg, {k: move(t) for k, t in tu.unstack_tree(tree["params"]).items()})
    params.requires_grad_(True)
    opt = tree["opt"]
    return {"params": params,
            "opt": {"mu": {k: move(t) for k, t in tu.unstack_tree(opt["mu"]).items()},
                    "nu": {k: move(t) for k, t in tu.unstack_tree(opt["nu"]).items()},
                    "count": move(opt["count"])},
            "step": move(tree["step"])}
