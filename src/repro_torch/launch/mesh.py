"""The group of worker processes that Algorithm 1's entry points average over.

Port of the reference's mesh constructors (``repro.launch.mesh``) for the solver: its
mesh axes become one ``torch.distributed`` process group, a rank per process,
each rank running a slice of the q workers (``core.distributed``, ``group=``).
For the LM, the reference's production meshes become ``DeviceMesh``es over
the process group that is up (``make_production_mesh``, ``make_smoke_mesh``),
with the reference's ``production_rules`` (``distributed.sharding``).

Under ``torchrun --nproc_per_node=N`` every process calls ``init_worker_group()``
and gets NCCL on ``cuda:LOCAL_RANK``. Without torchrun the caller names its
rank, world size and rendezvous (``init_method="tcp://localhost:<port>"`` or
``"file://<path>"``), and ``device="cpu"`` (or ``backend="gloo"``) for the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import ShardingRules
from repro_torch.utils import env as envcfg
from repro_torch.utils.device import resolve_device


def init_worker_group(backend: str | None = None, device=None, *, rank: int | None = None,
                      world_size: int | None = None, init_method: str | None = None):
    """Join (or start) the default process group and return ``(group, device)``.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and ``WORLD_SIZE``
    (one of the two sources must give them), ``init_method`` to ``"env://"``
    (torchrun's ``MASTER_ADDR``/``MASTER_PORT``). ``device`` defaults to
    ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` from the environment, else the rank) and
    never to the CPU: a caller that wants the CPU says ``device="cpu"``.
    ``backend`` defaults to ``"nccl"`` on a CUDA device and ``"gloo"`` on the
    CPU; NCCL on the CPU raises, and so does a CUDA device with no CUDA. Gloo
    also reduces CUDA tensors (through the host), which lets several ranks share
    one card, as NCCL does not.
    """
    import torch.distributed as dist

    rank = envcfg.read_int("RANK") if rank is None else rank
    world_size = envcfg.read_int("WORLD_SIZE") if world_size is None else world_size
    if rank is None or world_size is None:
        raise ValueError("init_worker_group needs the rank and world size: run under torchrun (RANK, "
                         "WORLD_SIZE) or pass rank= and world_size=")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    if device is None:
        local = envcfg.read_int("LOCAL_RANK")
        device = f"cuda:{rank if local is None else local}"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend reduces CUDA tensors only; device is {dev}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size(), dist.get_backend()) != (rank, world_size, backend):
            raise RuntimeError(f"a process group is already up as rank {dist.get_rank()} of "
                               f"{dist.get_world_size()} on {dist.get_backend()}, not rank {rank} of "
                               f"{world_size} on {backend}")
    else:
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=world_size)
    return dist.group.WORLD, dev


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production mesh over the process group that is up: (16, 16)
    over ("data", "model"), or (2, 16, 16) over ("pod", "data", "model"), one rank
    a device (256 or 512 ranks). "model" carries Megatron TP, "data" FSDP and the
    batch, "pod" the batch only. Raises without a group of that size, and for a
    CUDA mesh without CUDA."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(dist, init_device_mesh, device_type, shape, axes)


def production_rules(*, multi_pod: bool = False) -> ShardingRules:
    dp = ("pod", "data") if multi_pod else ("data",)
    return ShardingRules(dp=dp, fsdp="data", tensor="model")


def make_smoke_mesh(n_devices: int = 0, *, device_type: str = "cuda"):
    """A small ("data", "model") mesh over the group's ranks (the reference's
    choice: "model" the first of 4, 2, 1 that divides n; one rank is (1, 1))."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 0)
    model = next(c for c in (4, 2, 1) if n % c == 0 and c <= max(n, 1))
    return _mesh(dist, init_device_mesh, device_type, (max(n, 1) // model, model), ("data", "model"))


def _mesh(dist, init_device_mesh, device_type: str, shape: tuple, axes: tuple):
    if not dist.is_initialized():
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs a process group of that many ranks; "
                           "none is up")
    size = 1
    for n in shape:
        size *= n
    if dist.get_world_size() != size:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs {size} ranks; the group has "
                           f"{dist.get_world_size()}")
    if device_type == "cuda":
        resolve_device("cuda")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
