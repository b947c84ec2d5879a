"""Trees of tensors (nested dicts, lists and tuples): sizes, norms, paths, one flat
float32 vector with its inverse, and the reference's stacked layer leaves.

Port of ``repro.utils.tree``. The leaf order is the reference's: a dict's values
in the order of its sorted keys, a list's or tuple's in their own order, depth
first. (``torch.utils._pytree`` keeps a dict's insertion order, so it is not
used.) A vector flattened from the same tree is then the same vector in both
packages: gradient compression sketches that vector, and the counter RNG ties
each of its coordinates to one column of S.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """A tree's structure: ``kind`` is "dict" (``keys`` sorted), "list", "tuple"
    or "leaf"; ``children`` the sub-structures in leaf order."""

    kind: str
    keys: tuple = ()
    children: tuple = ()


_LEAF = TreeDef("leaf")


def tree_flatten(tree: Tree) -> tuple[list, TreeDef]:
    """The leaves in the reference's order and the structure that rebuilds the tree."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        parts = [tree_flatten(tree[k]) for k in keys]
        return [x for leaves, _ in parts for x in leaves], TreeDef("dict", keys, tuple(s for _, s in parts))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(x) for x in tree]
        kind = "list" if isinstance(tree, list) else "tuple"
        return [x for leaves, _ in parts for x in leaves], TreeDef(kind, (), tuple(s for _, s in parts))
    return [tree], _LEAF


def _count(spec: TreeDef) -> int:
    return 1 if spec.kind == "leaf" else sum(_count(c) for c in spec.children)


def tree_unflatten(spec: TreeDef, leaves) -> Tree:
    """The tree of structure ``spec`` holding ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(s: TreeDef):
        if s.kind == "leaf":
            return next(it)
        parts = [build(c) for c in s.children]
        if s.kind == "dict":
            return dict(zip(s.keys, parts))
        return parts if s.kind == "list" else tuple(parts)

    out = build(spec)
    if next(it, None) is not None:
        raise ValueError(f"more leaves than the structure's {_count(spec)}")
    return out


def tree_leaves(tree: Tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` on each leaf (and the same leaf of each tree of ``rest``), same structure."""
    leaves, spec = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for _, s in others:
        if s != spec:
            raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(spec, [fn(*xs) for xs in zip(leaves, *(ls for ls, _ in others))])


def tree_size(tree: Tree) -> int:
    """Total number of elements across all leaves."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))


def tree_bytes(tree: Tree) -> int:
    return sum(math.prod(x.shape) * x.element_size() for x in tree_leaves(tree))


def tree_global_norm(tree: Tree) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), each leaf's sum in float32."""
    sums = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_scale(tree: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, tree)


def tree_flatten_to_vector(tree: Tree) -> tuple[torch.Tensor, "TreeVectorizer"]:
    """All leaves, in leaf order, as one float32 vector, with its inverse."""
    leaves, spec = tree_flatten(tree)
    shapes = [tuple(x.shape) for x in leaves]
    dtypes = [x.dtype for x in leaves]
    sizes = [math.prod(s) for s in shapes]
    if leaves:
        vec = torch.cat([x.reshape(-1).to(torch.float32) for x in leaves])
    else:
        vec = torch.zeros((0,), dtype=torch.float32)
    return vec, TreeVectorizer(spec, shapes, dtypes, sizes)


@dataclasses.dataclass(frozen=True)
class TreeVectorizer:
    """Inverse of :func:`tree_flatten_to_vector`: each leaf's slice of the vector,
    reshaped, in the leaf's own dtype (bf16 included)."""

    spec: TreeDef
    shapes: list
    dtypes: list
    sizes: list

    @property
    def total(self) -> int:
        return sum(self.sizes)

    def unflatten(self, vec: torch.Tensor) -> Tree:
        leaves, off = [], 0
        for shape, dtype, size in zip(self.shapes, self.dtypes, self.sizes):
            leaves.append(vec[off : off + size].reshape(shape).to(dtype))
            off += size
        return tree_unflatten(self.spec, leaves)


def tree_flatten_with_path(tree: Tree) -> tuple[list, TreeDef]:
    """``((path, leaf), …)`` in leaf order, and the structure: a path is the tuple
    of dict keys and list or tuple indices from the root to the leaf, as
    ``jax.tree_util.tree_flatten_with_path`` gives it."""
    leaves, spec = tree_flatten(tree)
    paths: list = []

    def walk(s: TreeDef, prefix: tuple):
        if s.kind == "leaf":
            paths.append(prefix)
            return
        labels = s.keys if s.kind == "dict" else range(len(s.children))
        for label, child in zip(labels, s.children):
            walk(child, prefix + (label,))

    walk(spec, ())
    return list(zip(paths, leaves)), spec


def path_str(path) -> str:
    """A path as the reference's checkpoint manifest and AdamW write it
    (``repro.checkpoint.store._path_str``): its keys and indices joined by "/"."""
    return "/".join(str(p) for p in path)


@dataclasses.dataclass(frozen=True)
class Stacked:
    """One leaf of the reference's layer stack held as its L per-layer tensors:
    the reference stacks every layer leaf on a leading L axis, the port keeps
    one tensor a layer. ``shape`` is (L, …) and the flat order is layer 0's
    elements, then layer 1's, …, the stacked array's row-major order."""

    parts: tuple

    @property
    def shape(self) -> tuple:
        return (len(self.parts),) + tuple(self.parts[0].shape)

    @property
    def dtype(self):
        return self.parts[0].dtype


STACKS = ("layers", "enc_layers")  # the reference's stacked layer trees: the decoder's and the encoder's


def stacked_tree(named: dict, prefixes: tuple = STACKS) -> dict:
    """The reference's nested tree of a module's named tensors (``"embed.table"``,
    ``"layers.3.attn.wq"``, …): dotted names become nested dict keys, and the
    tensors of ``<prefix>.<l>.<rest>`` for l = 0…L−1, for each stack prefix
    (the decoder's ``layers``, an encoder-decoder's ``enc_layers``), become one
    :class:`Stacked` leaf at ``<prefix>/<rest>``. Its leaf order
    (:func:`tree_flatten`) is then the reference's."""
    tree: dict = {}
    stacks: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] in prefixes and len(parts) > 2 and parts[1].isdigit():
            stacks.setdefault(tuple([parts[0]] + parts[2:]), {})[int(parts[1])] = t
            continue
        _put(tree, parts, t)
    for path, by_layer in stacks.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"layers of {'/'.join(path)} are not 0…{len(by_layer) - 1}: {sorted(by_layer)}")
        _put(tree, list(path), Stacked(tuple(by_layer[l] for l in range(len(by_layer)))))
    return tree


def _put(tree: dict, parts: list, leaf) -> None:
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def unstack_tree(tree: dict) -> dict:
    """The inverse of :func:`stacked_tree`: dotted names → tensors (each
    :class:`Stacked` leaf back to its layers' names)."""
    out: dict = {}
    for path, leaf in tree_flatten_with_path(tree)[0]:
        name = ".".join(str(p) for p in path)
        if isinstance(leaf, Stacked):
            head, rest = path[0], ".".join(str(p) for p in path[1:])
            for l, t in enumerate(leaf.parts):
                out[f"{head}.{l}.{rest}"] = t
        else:
            out[name] = leaf
    return out
