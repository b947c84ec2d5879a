"""Sharding rules: logical axes → mesh axes → DTensor placements for parameters,
caches and activations.

Port of ``repro.distributed.sharding``. The reference's rules map three logical
axes onto a mesh and name each leaf's ``PartitionSpec``; GSPMD then partitions
the jitted program. Here the same rules give each tensor a list of DTensor
placements (``Shard``, ``Replicate``) on a ``torch.distributed.DeviceMesh``,
and the sharded program is the port's own code on DTensors: each op runs on the
local shards and DTensor inserts the collectives its sharding rules need.

The logical axes:

  * ``dp``     — data parallel (batch dim of activations): ("pod", "data") on
                 the multi-pod mesh, "data" on one pod.
  * ``fsdp``   — the parameter shard axis (ZeRO-3): "data" (or ("pod", "data")).
  * ``tensor`` — Megatron tensor parallelism (heads, FFN hidden, vocab, the
                 experts' hidden dim): "model".
  * ``sp``     — the activations' sequence axis between layers; rides the
                 tensor axis when ``sequence_parallel``.

A spec is a tuple with one entry per tensor dimension (fewer entries leave the
trailing dimensions whole, as a ``PartitionSpec`` does): a mesh-axis name, a
tuple of names, or None. Parameter specs are keyed by the reference's leaf path
(``layers/attn/wq``); a port layer's tensor is one layer of the reference's
stacked leaf and takes the stacked spec without its leading L entry, which
every rule leaves None. :func:`to_placements` turns a spec into placements:
a tensor dimension on a tuple of mesh axes is ``Shard(dim)`` on each of those
mesh dimensions, outer first as jax orders the tuple, and every other mesh
dimension is ``Replicate()``. DTensor splits an uneven dimension as
``torch.chunk`` does (the first shards take ⌈n/k⌉, the last what is left,
possibly nothing), where jax pads every shard to ⌈n/k⌉.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.utils import tree as tu

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical-axis → mesh-axis mapping. ``None`` disables an axis (replicate)."""

    dp: Tuple[str, ...] = ("data",)       # activation batch
    fsdp: Any = "data"                    # parameter shard axis or axes (ZeRO-3)
    tensor: Optional[str] = "model"       # Megatron TP axis
    sequence_parallel: bool = True        # layer-boundary acts sharded (dp, tensor)

    def resolve(self, logical: Optional[str]):
        if logical is None:
            return None
        if logical == "dp":
            return self.dp if len(self.dp) > 1 else (self.dp[0] if self.dp else None)
        if logical == "fsdp":
            return self.fsdp
        if logical == "tensor":
            return self.tensor
        if logical == "sp":
            return self.tensor if self.sequence_parallel else None
        raise ValueError(f"unknown logical axis {logical!r}")

    def spec(self, *logical_axes) -> Spec:
        return tuple(self.resolve(a) for a in logical_axes)


DEFAULT_RULES = ShardingRules()
REPLICATED_RULES = ShardingRules(dp=(), fsdp=None, tensor=None)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor."""
    return isinstance(t, DTensor)


def _mesh_axes(entry) -> tuple:
    """The mesh-axis names of one spec entry (None, a name or a tuple of names)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def to_placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (one per mesh dimension).

    Raises ``ValueError`` for a mesh-axis name the mesh lacks, an axis used
    twice, or a tuple whose order is not the mesh's (DTensor shards one tensor
    dimension over several mesh dimensions outer first, in the mesh's order)."""

    names = tuple(mesh.mesh_dim_names or ())
    placements = [Replicate() for _ in range(mesh.ndim)]
    seen = set()
    for dim, entry in enumerate(spec):
        axes = _mesh_axes(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names mesh axis {a!r}; the mesh has {names}")
            if a in seen:
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's order {names}")
        for i in idx:
            placements[i] = Shard(dim)
    return tuple(placements)


def constrain(x: torch.Tensor, rules: Optional[ShardingRules], *logical_axes) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to the spec of ``logical_axes`` (trailing
    dimensions past them whole); the identity when ``rules`` is None or ``x`` is
    not a DTensor (one process, the tests). Already so placed, ``x`` moves
    nothing, but the gradient that comes back through this point is still
    redistributed to the spec, as jax's sharding constraint pins the
    cotangent too."""
    if rules is None or not isinstance(x, DTensor):
        return x
    axes = list(logical_axes) + [None] * (x.ndim - len(logical_axes))
    return x.redistribute(x.device_mesh, to_placements(rules.spec(*axes), x.device_mesh))


def local_slices(global_shape, mesh, placements, coordinate=None) -> tuple:
    """This rank's slice of each dimension of a tensor of ``global_shape``
    under ``placements`` (``coordinate``: the rank's place in the mesh, by
    default ``mesh.get_coordinate()``), DTensor's split: the mesh dimensions
    that shard one tensor dimension split it in turn, outer first, each as
    ``torch.chunk`` does. ``ValueError`` for placements that do not fit: one
    a mesh dimension, ``Shard`` of a dimension the tensor lacks, anything but
    ``Shard`` and ``Replicate``."""

    placements = tuple(placements)
    if len(placements) != mesh.ndim:
        raise ValueError(f"{len(placements)} placements for a mesh of {mesh.ndim} dimensions")
    coord = mesh.get_coordinate() if coordinate is None else coordinate
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    bounds = [[0, int(n)] for n in global_shape]
    for i, p in enumerate(placements):
        if isinstance(p, Replicate):
            continue
        if not isinstance(p, Shard) or not 0 <= p.dim < len(bounds):
            raise ValueError(f"placement {p} does not fit a tensor of shape {tuple(global_shape)}")
        start, size = bounds[p.dim][0], bounds[p.dim][1] - bounds[p.dim][0]
        k = int(mesh.shape[i])
        chunk = -(-size // k)
        s = min(coord[i] * chunk, size)
        e = min(s + chunk, size)
        bounds[p.dim] = [start + s, start + e]
    return tuple(slice(a, b) for a, b in bounds)


def from_local(local: torch.Tensor, mesh, placements, global_shape):
    """A DTensor of ``global_shape`` (contiguous) from this rank's ``local`` shard."""

    shape = torch.Size(global_shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False, shape=shape, stride=stride)


def as_dtensor(t: torch.Tensor, mesh):
    """``t`` as it is when a DTensor, else replicated on ``mesh`` (every rank
    holds all of it)."""

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def shard_tensor(t: torch.Tensor, mesh, placements):
    """``t`` (the whole tensor on every rank; meta allocates nothing) as a
    DTensor whose local shard is this rank's slice of it, contiguous."""
    local = t[local_slices(t.shape, mesh, placements)].contiguous()
    return from_local(local, mesh, placements, t.shape)


def write_slots(dst, src: torch.Tensor, dst_index, src_index) -> None:
    """``dst[:, dst_index] = src[:, src_index]`` for a DTensor ``dst`` (a cache,
    axis 1 its positions, perhaps sharded): ``src`` goes to ``dst``'s
    placements with axis 1 whole, and each rank writes the slots it holds
    into its local shard. ``dst_index``, ``src_index``: Python ints."""

    mesh, pl = dst.device_mesh, tuple(dst.placements)
    src_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in pl)
    s_local = as_dtensor(src, mesh).redistribute(mesh, src_pl).to_local()
    held = local_slices(dst.shape, mesh, pl)[1]
    pairs = [(d - held.start, s) for d, s in zip(dst_index, src_index) if held.start <= d < held.stop]
    if not pairs:
        return
    d_local = dst.to_local()
    dev = d_local.device
    to = torch.tensor([a for a, _ in pairs], device=dev)
    frm = torch.tensor([b for _, b in pairs], device=dev)
    d_local[:, to] = s_local[:, frm].to(d_local.dtype)


def copy_into(dst, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; for a DTensor ``dst``, ``src`` redistributed to its
    placements first."""

    if isinstance(dst, DTensor):
        src = as_dtensor(src, dst.device_mesh).redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def zeros(shape, dtype, mesh, placements, device):
    """A DTensor of zeros of ``shape``, each rank allocating its own shard."""
    local = [s.stop - s.start for s in local_slices(shape, mesh, placements)]
    return from_local(torch.zeros(local, dtype=dtype, device=device), mesh, placements, shape)


def spec_leaves(tree, prefix: str = "") -> dict:
    """The leaves of a tree of specs (or of placements) by path string: nested
    dicts are walked, anything else is a leaf (a spec is a tuple)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(spec_leaves(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def map_specs(fn, tree, *rest):
    """``fn`` on each leaf of a tree of specs (nested dicts, tuple leaves) and on
    the same leaf of each tree of ``rest`` (a tree of tensors beside its specs)."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def local_count(shape, mesh, placements) -> int:
    """The elements of this rank's shard of a tensor of ``shape``."""
    n = 1
    for s in local_slices(shape, mesh, placements):
        n *= s.stop - s.start
    return n


# ------------------------------------------------------------------- param rules
#
# (regex on "/"-joined tree path, logical axes for the *trailing* dims of the leaf).
# Leading unmatched dims (the stacked-layer axis L, MoE expert axis E) are replicated
# unless the rule names them explicitly. First match wins. The reference's table.

_PARAM_RULES = [
    # embeddings: vocab-parallel (Megatron), fsdp on d
    (r"embed/table$", ("tensor", "fsdp")),
    (r"unembed/w$", ("fsdp", "tensor")),
    (r"vit_proj/w$", (None, None)),
    # attention (leaf shapes (L, d, H*hd) / (L, H*hd, d))
    (r"attn/wq$", (None, "fsdp", "tensor")),
    (r"attn/wk$", (None, "fsdp", "tensor")),
    (r"attn/wv$", (None, "fsdp", "tensor")),
    (r"attn/wo$", (None, "tensor", "fsdp")),
    (r"xattn/wq$", (None, "fsdp", "tensor")),
    (r"xattn/wk$", (None, "fsdp", "tensor")),
    (r"xattn/wv$", (None, "fsdp", "tensor")),
    (r"xattn/wo$", (None, "tensor", "fsdp")),
    # MLA: low-rank downs replicated-ish (small), ups tensor-parallel on heads
    (r"attn/w_dq$", (None, "fsdp", None)),
    (r"attn/w_uq$", (None, None, "tensor")),
    (r"attn/w_dkv$", (None, "fsdp", None)),
    (r"attn/w_ukv$", (None, None, "tensor")),
    # dense FFN (L, d, f) / (L, f, d)
    (r"ffn/w_gate$", (None, "fsdp", "tensor")),
    (r"ffn/w_up$", (None, "fsdp", "tensor")),
    (r"ffn/w_down$", (None, "tensor", "fsdp")),
    # MoE (L, E, d, f) / (L, E, f, d): TP over the expert-ffn hidden dim
    (r"moe/router$", (None, "fsdp", None)),
    (r"moe/w_gate$", (None, None, "fsdp", "tensor")),
    (r"moe/w_up$", (None, None, "fsdp", "tensor")),
    (r"moe/w_down$", (None, None, "tensor", "fsdp")),
    # mamba (channel dim C = d_inner is the TP axis)
    (r"mamba/in_proj$", (None, "fsdp", "tensor")),
    (r"mamba/conv_w$", (None, None, "tensor")),
    (r"mamba/conv_b$", (None, "tensor")),
    (r"mamba/x_proj$", (None, "tensor", None)),
    (r"mamba/dt_proj_w$", (None, None, "tensor")),
    (r"mamba/dt_proj_b$", (None, "tensor")),
    (r"mamba/A_log$", (None, "tensor", None)),
    (r"mamba/D$", (None, "tensor")),
    (r"mamba/out_proj$", (None, "tensor", "fsdp")),
    # norms & everything small: replicated
    (r".*", None),
]


def spec_for_path(path_s: str, ndim: int, rules: ShardingRules) -> Spec:
    """The spec of one leaf of ``ndim`` dimensions at the reference path
    ``path_s``: the rule's axes for the trailing dimensions, leading ones None
    (a rule longer than the leaf loses its leading entries)."""
    for pat, logical in _PARAM_RULES:
        if re.search(pat, path_s):
            if logical is None:
                return ()
            axes = list(logical)
            if len(axes) < ndim:
                axes = [None] * (ndim - len(axes)) + axes
            elif len(axes) > ndim:
                axes = axes[len(axes) - ndim:]
            return tuple(rules.resolve(a) for a in axes)
    return ()


def param_pspecs(params_tree, rules: ShardingRules):
    """The tree of specs of ``params_tree``, the reference's parameter tree
    (``utils.tree.stacked_tree`` of the model's tensors, or anything with a
    ``shape`` at the reference's paths): a :class:`~repro_torch.utils.tree.Stacked`
    leaf's spec has its leading L entry, as the reference's stacked leaf."""
    return _map_with_path(lambda ps, leaf: spec_for_path(ps, len(leaf.shape), rules), params_tree)


def _map_with_path(fn, tree):
    pairs, spec = tu.tree_flatten_with_path(tree)
    return tu.tree_unflatten(spec, [fn(tu.path_str(p), leaf) for p, leaf in pairs])


def _ref_path(name: str) -> tuple:
    """(the reference path of a state-dict name, whether it is one layer of a
    stack): ``layers.3.attn.wq`` → ("layers/attn/wq", True)."""
    parts = name.split(".")
    if parts[0] in tu.STACKS and len(parts) > 2 and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


def named_pspecs(named: dict, rules: ShardingRules) -> dict:
    """Each tensor's spec by state-dict name (``named``: name → anything with a
    ``shape``): a layer's tensor takes its stacked leaf's spec without the
    leading L entry."""
    out = {}
    for name, t in named.items():
        path, layer = _ref_path(name)
        spec = spec_for_path(path, len(t.shape) + int(layer), rules)
        out[name] = spec[1:] if layer else spec
    return out


def named_shardings(params, mesh, rules: ShardingRules) -> dict:
    """The placements of every parameter of ``params`` (an ``nn.Module`` or a
    dict of tensors by state-dict name) on ``mesh``, by name."""
    named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params
    return {name: to_placements(spec, mesh) for name, spec in named_pspecs(named, rules).items()}


# ------------------------------------------------------------------- cache rules


def cache_pspecs(cache_tree, rules: ShardingRules, *, batch_sharded: bool):
    """KV/state cache specs, the reference's rules.

    batch_sharded=True (decode_32k): batch dim → dp, *sequence* dim → tensor.
    batch_sharded=False (long_500k, batch=1): the sequence dim is sharded over
    every mesh axis; SSM states shard their channel dim over tensor only.

    Cache leaf layouts (leading L = stacked layers):
      k/v       (L, B, S, KV, hd)
      ckv       (L, B, S, r)         (MLA latent)
      krope     (L, B, S, rope_d)
      conv      (L, B, K-1, C)       (mamba; C → tensor)
      ssm       (L, B, C, N)
      xk/xv     (L, B, S_enc, KV, hd)
    """
    dp = rules.resolve("dp")
    tp = rules.resolve("tensor")

    def _axes(*logical):
        out = []
        for a in logical:
            if a is None:
                continue
            if isinstance(a, tuple):
                out.extend(x for x in a if x)
            else:
                out.append(a)
        return tuple(out) if out else None

    seq_all = _axes(dp, tp)

    def leaf_spec(path_s: str, leaf):
        name = path_s.split("/")[-1]
        nd = len(leaf.shape)
        if name in ("xk", "xv"):
            return (None, dp if batch_sharded else None, None, None, None)
        if name in ("k", "v"):
            if batch_sharded:
                return (None, dp, tp, None, None)
            return (None, None, seq_all, None, None)
        if name in ("ckv", "krope"):
            if batch_sharded:
                return (None, dp, tp, None)
            return (None, None, seq_all, None)
        if name == "conv":
            return (None, dp if batch_sharded else None, None, tp)
        if name == "ssm":
            return (None, dp if batch_sharded else None, tp, None)
        return (None,) * nd

    return _map_with_path(leaf_spec, cache_tree)
