"""The group of worker processes that Algorithm 1's entry points average over.

Port of the reference's mesh constructors (``repro.launch.mesh``) for the solver: its
mesh axes become one ``torch.distributed`` process group, a rank per process,
each rank running a slice of the q workers (``core.distributed``, ``group=``).
The reference's LM production meshes (data × model axes) wait for the LM port.

Under ``torchrun --nproc_per_node=N`` every process calls ``init_worker_group()``
and gets NCCL on ``cuda:LOCAL_RANK``. Without torchrun the caller names its
rank, world size and rendezvous (``init_method="tcp://localhost:<port>"`` or
``"file://<path>"``), and ``device="cpu"`` (or ``backend="gloo"``) for the CPU.
"""
from __future__ import annotations

import torch

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
