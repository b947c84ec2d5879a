"""Sketched gradient compression for a data-parallel all-reduce (PyTorch port).

Port of ``repro.core.gradcomp``. The paper's operators (E[SᵀS] = I) give an
unbiased linear compressor: a worker projects its gradient g → Sg (m ≪ D
floats), the ranks reduce in sketch space, and the mean is unsketched,
ŷ = Sᵀ(mean_k S g_k). Every rank derives the same S from the step key, so the
reduction commutes with the sketch and E[SᵀSḡ] = ḡ. CountSketch (the SJLT with
s = 1) makes both ends O(D).

Modes (``GradCompressionConfig.mode``):

* ``same_sketch`` (default): one S from ``key``; the payload is averaged with
  one ``all_reduce`` — the bandwidth saving;
* ``fresh_sketch``: rank r sketches with ``prng.fold_in(key, r)`` and each leaf
  of its reconstruction is averaged — q independent estimates, the sketch's
  variance cut by q, no bandwidth saving;
* ``enabled=False``: each leaf is averaged as it is.

The gradient tree is flattened in the reference's leaf order
(``utils.tree.tree_flatten_to_vector``), so coordinate j of the vector meets
column j of S in both packages. On a CUDA vector the compressor runs the
hand-written kernels (``use_kernel`` is set from the vector's device): the
CountSketch S·g through the SJLT S·A kernel's entry for few, long columns,
which keeps the pair list it draws, its adjoint a gather over that list
(``operators.sjlt_adjoint_kept``: no pair is drawn twice); the Gaussian S·g
through the dense S·A kernel and Sᵀy through the Gaussian adjoint kernel that
draws S again (a kept S would be m·D floats). On the CPU both run their plain
versions and the CountSketch's adjoint draws its pairs again. ``group`` is a
``torch.distributed`` process group (``launch.mesh.init_worker_group``), one
worker a rank; ``None`` is one worker alone, whose mean is its own gradient.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import averaging, operators
from repro_torch.core.sketches import SketchSpec
from repro_torch.utils import prng, tree as tu


@dataclasses.dataclass(frozen=True)
class GradCompressionConfig:
    enabled: bool = False
    ratio: float = 0.1          # m = ceil(ratio * D)
    kind: str = "countsketch"   # countsketch | gaussian
    mode: str = "same_sketch"   # same_sketch | fresh_sketch


def _sketch_spec(cfg: GradCompressionConfig, m: int, use_kernel: bool = False) -> SketchSpec:
    """The compressor as a SketchOp spec: CountSketch is SJLT with s = 1."""
    if cfg.kind == "countsketch":
        return SketchSpec("sjlt", m, s=1, use_kernel=use_kernel)
    if cfg.kind == "gaussian":
        return SketchSpec("gaussian", m, use_kernel=use_kernel)
    raise ValueError(cfg.kind)


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the ranks of ``group``: the reference's ``pmean``."""
    if group is None:
        return x
    import torch.distributed as dist

    return averaging.psum(x, group) / dist.get_world_size(group)


def compress(cfg: GradCompressionConfig, key: torch.Tensor, grads):
    """Project the gradient tree into sketch space. Returns (payload, ctx), ctx
    holding the adjoint that :func:`decompress` applies.

    The projection and its adjoint are one ``SketchOp`` (E[SᵀS] = I ⇒ unbiased),
    from the registry the solvers dispatch through, with the kernels on a CUDA
    vector; the CountSketch's comes from ``apply_with_adjoint``, so on the card
    its adjoint reads the pair list its S·A kept."""
    vec, vz = tu.tree_flatten_to_vector(grads)
    payload, adjoint = compress_vector(cfg, key, vec)
    return payload, (adjoint, vz)


def compress_vector(cfg: GradCompressionConfig, key: torch.Tensor, vec: torch.Tensor):
    """:func:`compress` of a gradient already flattened in the reference's leaf
    order: (payload (m,) float32, the adjoint), m = ⌈ratio·D⌉. The adjoint
    (m,) → (D,) holds no reference to ``vec``."""
    D = vec.shape[0]
    m = max(1, int(math.ceil(cfg.ratio * D)))
    spec = _sketch_spec(cfg, m, use_kernel=vec.device.type == "cuda")
    op = operators.make_operator(spec, key, D, device=vec.device)
    if cfg.kind == "countsketch":
        return op.apply_with_adjoint(vec)
    return op.apply(vec), op.adjoint


def decompress(cfg: GradCompressionConfig, payload: torch.Tensor, ctx):
    adjoint, vz = ctx
    return vz.unflatten(adjoint(payload))


def compressed_psum_mean(cfg: GradCompressionConfig, key: torch.Tensor, grads, group=None):
    """All-reduce-mean the gradient tree over ``group``, in sketch space when
    ``cfg.enabled``. Every rank derives the same S from ``key`` (same_sketch), so
    the linear sketch commutes with the sum; fresh_sketch folds in the rank first."""
    if not cfg.enabled:
        return tu.tree_map(lambda g: _pmean(g, group), grads)
    if cfg.mode == "fresh_sketch":
        key = prng.fold_in(key, averaging.worker_index(group))
        payload, ctx = compress(cfg, key, grads)
        local = decompress(cfg, payload, ctx)
        return tu.tree_map(lambda g: _pmean(g, group), local)
    payload, ctx = compress(cfg, key, grads)
    return decompress(cfg, _pmean(payload, group), ctx)


def compression_error(cfg: GradCompressionConfig, key: torch.Tensor, grads) -> torch.Tensor:
    """‖decompress(compress(g)) − g‖ / ‖g‖ — used by tests and benchmarks."""
    payload, ctx = compress(cfg, key, grads)
    rec = decompress(cfg, payload, ctx)
    num = tu.tree_global_norm(tu.tree_map(torch.subtract, rec, grads))
    den = tu.tree_global_norm(grads)
    return num / (den + 1e-30)
