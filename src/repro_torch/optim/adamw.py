"""AdamW with decoupled weight decay, on trees of tensors and on modules.

Port of ``repro.optim.adamw``. The arithmetic is the reference's: the moments
and the update in float32 (or bfloat16 moments with ``moment_dtype``), the bias
corrections 1 − β^count in float32, the new parameter rounded once to its
dtype. The square root is taken in float64 and rounded once, which is the
correctly rounded float32 root that XLA takes (torch's float32 ``sqrt`` is
not correctly rounded). Unlike the reference, which returns new trees, the
update writes the parameters and the moments in place under
``torch.no_grad()``, in pieces of at most ``PIECE`` elements: at a billion
parameters a second float32 copy of them does not fit beside the moments.

Parameters are a tree of tensors (nested dicts, lists, tuples: the reference's
leaf order) or an ``nn.Module``. A leaf skips weight decay when its path string
(the reference's: ``layers/norm1/scale``, ``final_norm/scale``) holds one of
``no_decay``; a module's parameter ``layers.<l>.norm1.scale`` has the path of
the reference's stacked leaf, ``layers/norm1/scale`` (:func:`leaf_paths`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from repro_torch.utils import tree as tu

# Elements of one piece of the in-place update: bounds its float32 temporaries.
PIECE = 1 << 25


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                      # peak lr if a schedule is used
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0                # global-norm clip; 0 disables
    moment_dtype: str = "float32"         # "float32" | "bfloat16"
    # leaves whose path holds any of these substrings skip weight decay
    no_decay: Tuple[str, ...] = ("norm", "scale", "bias", "beta_a", "beta_s", "A_log", "D")


def _mdtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def _named(params):
    """A module's parameters as a dict by name; a tree as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def leaf_paths(params) -> list:
    """``(path string, tensor)`` of every parameter in leaf order (``tu.tree_flatten``
    of :func:`_named`): a tree's leaves with ``tu.path_str`` of their paths; a
    module's parameters with their reference paths (the dotted name joined by
    "/", the layer index dropped: ``layers.3.norm1.scale`` → ``layers/norm1/scale``)."""
    pairs = tu.tree_flatten_with_path(_named(params))[0]
    if isinstance(params, nn.Module):
        return [("/".join(p for p in path[0].split(".") if not p.isdigit()), t) for path, t in pairs]
    return [(tu.path_str(path), t) for path, t in pairs]


def init_opt_state(cfg: AdamWConfig, params) -> dict:
    """{"mu", "nu", "count"}: zero moments in the moment dtype on each
    parameter's device, with the parameters' structure (a module's: a dict by
    parameter name), and an int32 count."""
    named = _named(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=_mdtype(cfg), device=p.device)
    dev = tu.tree_leaves(named)[0].device if tu.tree_leaves(named) else None
    return {"mu": tu.tree_map(zeros, named), "nu": tu.tree_map(zeros, named),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm_clip(grads, max_norm: float):
    """The gradient tree scaled so its global L2 norm is at most ``max_norm``
    (each leaf back in its dtype), and that norm."""
    gnorm = tu.tree_global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    return tu.tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gnorm


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).to(torch.float32)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state: dict, *, lr_scale=1.0):
    """One AdamW step, in place. ``grads`` has the structure of
    ``opt_state["mu"]`` (for a module: a dict by parameter name), leaves in any
    float dtype; ``lr_scale`` multiplies cfg.lr (schedules plug in here).
    Returns (params, opt_state, {"grad_norm", "lr"}), the same objects."""
    paths, p_leaves = zip(*leaf_paths(params))
    if tu.tree_flatten(grads)[1] != tu.tree_flatten(_named(params))[1]:
        raise ValueError("the gradients' structure is not the parameters'")
    if cfg.grad_clip > 0:
        grads, gnorm = global_norm_clip(grads, cfg.grad_clip)
    else:
        gnorm = tu.tree_global_norm(grads)
    g_leaves = tu.tree_leaves(grads)
    count = opt_state["count"] + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** cf
    bc2 = 1.0 - cfg.b2 ** cf
    lr = cfg.lr * lr_scale
    md = _mdtype(cfg)
    m_leaves, v_leaves = tu.tree_leaves(opt_state["mu"]), tu.tree_leaves(opt_state["nu"])
    for path, p, g, m, v in zip(paths, p_leaves, g_leaves, m_leaves, v_leaves):
        decay = cfg.weight_decay > 0 and not any(n in path for n in cfg.no_decay)
        pf, mf, vf, gf = p.view(-1), m.view(-1), v.view(-1), g.reshape(-1)
        for i in range(0, pf.numel(), PIECE):
            sl = slice(i, i + PIECE)
            gi = gf[sl].to(torch.float32)
            mi = mf[sl].to(torch.float32) * cfg.b1 + gi * (1.0 - cfg.b1)
            vi = vf[sl].to(torch.float32) * cfg.b2 + gi * gi * (1.0 - cfg.b2)
            step = (mi / bc1) / (_sqrt_rn(vi / bc2) + cfg.eps)
            if decay:
                step = step + cfg.weight_decay * pf[sl].to(torch.float32)
            pf[sl] = (pf[sl].to(torch.float32) - lr * step).to(p.dtype)
            mf[sl] = mi.to(md)
            vf[sl] = vi.to(md)
    opt_state["count"] = count
    return params, opt_state, {"grad_norm": gnorm, "lr": torch.as_tensor(lr, dtype=torch.float32)}
