"""Sketch-DP: the paper's operators applied to data-parallel gradient exchange.

Port of ``repro.train.sketch_dp.masked_compressed_mean``, which joins two of the
paper's mechanisms in one reduction over a process group:

1. sketched compression — each rank projects its gradient with the shared S
   (E[SᵀS] = I, unbiased) and the sum runs in sketch space (``core.gradcomp``);
2. straggler masking — ranks that missed the step deadline contribute 0 and the
   denominator is the realized count (Algorithm 1's partial average, applied to
   gradients).

``make_sketch_dp_step``, the jitted step around it, waits for the port of the
LM (``models/lm``) and its optimizer.
"""
from __future__ import annotations

import torch

from repro_torch.core import averaging, gradcomp
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
