"""Sketch-DP: the paper's operators applied to data-parallel gradient exchange.

Port of ``repro.train.sketch_dp``. Three of the paper's mechanisms become one
gradient exchange over a ``torch.distributed`` process group (the reference's
``shard_map`` over a mesh axis; ``group=None`` is one process alone):

1. sketched compression — each rank projects its gradient with the shared S
   (E[SᵀS] = I, unbiased) and the sum runs in sketch space (``core.gradcomp``);
2. straggler masking — ranks that missed the step deadline contribute 0 and the
   denominator is the realized count (Algorithm 1's partial average, applied to
   gradients);
3. deterministic keys — S comes from the step's key, so every rank builds the
   same S with no coordination (callers fold the step into a base key).

:func:`make_sketch_dp_step` is the training step around it. The gradient is
one float32 vector in the reference's leaf order (:func:`grad_layout`: sorted
paths, each stacked layer leaf's layers one after another), so coordinate j
meets column j of the reference's S; each ``.grad`` is written straight into
its slice and freed.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import averaging, gradcomp
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.utils import tree as tu


def masked_compressed_mean(cfg: gradcomp.GradCompressionConfig, key: torch.Tensor, grads, mask_local,
                           group=None):
    """Straggler-resilient mean of the gradient trees of ``group``'s ranks.

    ``mask_local`` is this rank's 0/1 (it arrived or not). Compression and
    masking compose because the sketch is linear:
    unsketch(Σ mask·S g / Σ mask) = unsketch(S · masked-mean g). With
    compression on, the masked payload and the mask go in one ``all_reduce``.
    A leaf comes back in the type its product with the float32 mask takes (the
    reference's promotion: a bf16 leaf's mean is float32 when compression is
    off), the denominator at least 1. The mask goes to the gradients' device
    (a scalar mask is a CPU tensor, which NCCL does not reduce).
    """
    leaves = tu.tree_leaves(grads)
    mask = torch.as_tensor(mask_local, dtype=torch.float32, device=leaves[0].device if leaves else None)
    if not cfg.enabled:
        den = torch.clamp(averaging.psum(mask, group), min=1.0)
        return tu.tree_map(lambda g: averaging.psum(g.to(torch.promote_types(g.dtype, mask.dtype)) * mask, group)
                           / den, grads)
    payload, ctx = gradcomp.compress(cfg, key, grads)
    packed = averaging.psum(torch.cat([payload * mask, mask.reshape(1)]), group)
    return gradcomp.decompress(cfg, packed[:-1] / torch.clamp(packed[-1], min=1.0), ctx)


def grad_layout(params: lm.LM) -> list:
    """``(reference path, [(name, parameter), …])`` in the reference's leaf
    order: a stacked layer leaf lists its L layers' parameters in layer order."""
    named = dict(params.named_parameters())
    tree = tu.stacked_tree({name: name for name in named})
    return [(tu.path_str(path), [(n, named[n]) for n in (leaf.parts if isinstance(leaf, tu.Stacked) else [leaf])])
            for path, leaf in tu.tree_flatten_with_path(tree)[0]]


def flatten_grads(params: lm.LM) -> tuple:
    """Every ``.grad`` of ``params`` as one float32 vector in the reference's
    coordinate order, each written into its slice and then freed (set to None),
    and each parameter's (offset, size) in the vector by name."""
    layout = grad_layout(params)
    offsets, total = {}, 0
    for _, parts in layout:
        for name, p in parts:
            offsets[name] = (total, p.numel())
            total += p.numel()
    vec = torch.empty(total, dtype=torch.float32, device=next(params.parameters()).device)
    for _, parts in layout:
        for name, p in parts:
            off, n = offsets[name]
            vec[off : off + n].copy_(p.grad.reshape(-1))
            p.grad = None
    return vec, offsets


def _all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the group's ranks, in place (no copy of a billion-entry vector)."""
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def make_sketch_dp_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *, group=None,
                        comp: Optional[gradcomp.GradCompressionConfig] = None,
                        schedule: Optional[Callable] = None, remat: str = "none",
                        clock: Optional[Callable[[str], None]] = None) -> Callable:
    """Returns ``step(state, batch, key, mask) -> (state, metrics)``, the state
    updated in place.

    ``batch`` is the global batch: rank r of a group of P takes rows
    [r·B/P, (r+1)·B/P) (the reference's batch sharding). ``mask`` (q,) float:
    1.0 for workers whose gradient made the deadline; this rank's entry is
    ``mask[worker_index(group)]``. Each rank takes the gradient of its rows,
    then the masked mean (compressed when ``comp.enabled``: payload and mask in
    one ``all_reduce``), the masked mean loss (one more ``all_reduce``), then
    AdamW. The mean gradient comes back as the reference's: after the sketch,
    each leaf rounded to its parameter's dtype; uncompressed, float32.
    ``clock(name)``, when given, is called at the end of each part of the step:
    forward_backward, compress, all_reduce, decompress, adamw (uncompressed:
    forward_backward, all_reduce, adamw)."""
    comp = comp or gradcomp.GradCompressionConfig(enabled=False)
    plan = lm.ExecPlan(remat=remat)
    tick = clock or (lambda name: None)

    def step(state, batch, key, mask):
        params = state["params"]
        rank = averaging.worker_index(group)
        if group is not None:
            import torch.distributed as dist

            rows = next(iter(batch.values())).shape[0] // dist.get_world_size(group)
            batch = {k: v[rank * rows : (rank + 1) * rows] for k, v in batch.items()}
        loss, _ = lm.lm_loss(params, cfg, batch, plan=plan)
        loss.backward()
        vec, offsets = flatten_grads(params)
        tick("forward_backward")
        m = torch.as_tensor(mask, dtype=torch.float32).to(vec.device)[rank]
        if comp.enabled:
            payload, adjoint = gradcomp.compress_vector(comp, key, vec)
            del vec
            tick("compress")
            packed = _all_reduce_(torch.cat([payload * m, m.reshape(1)]), group)
            del payload
            tick("all_reduce")
            mean = adjoint(packed[:-1] / torch.clamp(packed[-1], min=1.0))
            del adjoint
            tick("decompress")
        else:
            mean = _all_reduce_(vec.mul_(m), group)
            mean.div_(torch.clamp(_all_reduce_(m.clone(), group), min=1.0))
            del vec
            tick("all_reduce")
        lsum = _all_reduce_(torch.stack([loss.detach() * m, m]), group)
        grads = {}
        for name, p in params.named_parameters():
            off, n = offsets[name]
            g = mean[off : off + n].view(p.shape)
            grads[name] = g.to(p.dtype) if comp.enabled else g
        del mean
        lr_scale = schedule(state["step"]) if schedule is not None else 1.0
        _, _, om = adamw_update(opt_cfg, params, grads, state["opt"], lr_scale=lr_scale)
        del grads
        state["step"] = state["step"] + 1
        tick("adamw")
        return state, {"loss": lsum[0] / torch.clamp(lsum[1], min=1.0), **om}

    return step
