"""Multi-process launch: the counterpart of the JAX package's
`lbmdem_tpu/parallel/launch.py` (`jax.distributed.initialize`), on
`torch.distributed`.

Each process runs the same program on its own devices: one process per
card on NCCL, or processes on the CPU on gloo (the tests). A mesh made
after `init_distributed` (`make_mesh`) spans every process's devices in
rank order, as the JAX mesh spans `jax.devices()`; each rank holds its
own positions' shards and a replica of the disks, and the halo exchange
and the force sums go over the process group. Typical use, one process
per card:

    torchrun --nproc-per-node 4 -m lbmdem_tpu_torch.cli deck.par \\
        --distributed --mesh 2x2

or from Python:

    from lbmdem_tpu_torch.parallel import init_distributed, make_mesh
    init_distributed()            # RANK, WORLD_SIZE, ... from torchrun
    sim = Simulation(cfg, disks, mesh=make_mesh())
    sim.run()

A mesh in one process (`make_mesh` without `init_distributed`) needs
neither: it is the way to run several shards on one card, since NCCL
refuses two ranks on one card.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

_LOCAL: List[torch.device] = []  # this process's devices, in order
_GLOBAL_COUNT = 0  # every process's devices


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     device: Optional[str] = None) -> None:
    """Join the process group (idempotent).

    With no arguments the topology comes from what `torchrun` sets: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT and LOCAL_RANK (a lone process
    with none of them is a group of one). `coordinator_address`
    ("host:port") is rank 0's address, `num_processes` the world size,
    `process_id` this rank, `local_device_ids` the cards this process
    drives (default: card LOCAL_RANK when there are several processes,
    every visible card when there is one). `device` is "cuda" or "cpu"
    (default: "cuda" when a card is visible): the backend is NCCL when
    the process's devices are cards and gloo on the CPU."""
    global _GLOBAL_COUNT
    if dist.is_initialized():
        return
    env = os.environ
    rank = int(process_id if process_id is not None
               else env.get("RANK", 0))
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    if not 0 <= rank < world:
        raise ValueError(f"process {rank} outside a world of {world}")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is "
                               "available; pass device='cpu' for gloo")
        if local_device_ids is None:
            n = torch.cuda.device_count()
            local_device_ids = ([int(env.get("LOCAL_RANK", rank % n))]
                                if world > 1 else range(n))
        local = [torch.device("cuda", int(i)) for i in local_device_ids]
        torch.cuda.set_device(local[0])
        backend = "nccl"
    elif device == "cpu":
        local, backend = [torch.device("cpu")], "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    kw = {}
    if coordinator_address:
        kw["init_method"] = f"tcp://{coordinator_address}"
    elif world == 1 and "MASTER_ADDR" not in env:
        kw["store"] = dist.HashStore()  # a group of one, in this process
    else:
        kw["init_method"] = "env://"
    if backend == "nccl":
        kw["device_id"] = local[0]
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    _LOCAL[:] = local
    counts = [None] * world
    dist.all_gather_object(counts, len(local))
    _GLOBAL_COUNT = sum(counts)


def is_initialized() -> bool:
    """Whether this process joined a group through init_distributed."""
    return dist.is_initialized() and bool(_LOCAL)


def local_devices() -> List[torch.device]:
    """This process's devices (init_distributed's), in order."""
    if not is_initialized():
        raise RuntimeError("local_devices: call init_distributed first")
    return list(_LOCAL)


def process_info():
    """(process index, process count, local device count, global device
    count), the JAX tuple; a process outside a group is 0 of 1 with every
    visible card (or the CPU)."""
    if is_initialized():
        return (dist.get_rank(), dist.get_world_size(), len(_LOCAL),
                _GLOBAL_COUNT)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return 0, 1, n, n
