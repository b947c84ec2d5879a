"""The reference's version shims, in the port's terms.

Port of ``repro.utils.compat``. :func:`axis_size` is the size of a named
dimension of a ``torch.distributed.DeviceMesh`` (the reference's
``jax.lax.axis_size`` inside ``shard_map``). ``shard_map`` has no counterpart:
the port's sharded program is DTensor, whose ops run on the local shards and
insert their own collectives, so no per-device function is written by hand.
"""
from __future__ import annotations


def axis_size(mesh, name: str) -> int:
    """The size of the mesh dimension called ``name``; ``KeyError`` if the mesh
    has none."""
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise KeyError(f"mesh has no axis {name!r}: its axes are {names}")
    return int(mesh.shape[names.index(name)])
