"""Device resolution and the process group of the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU:
``device=None`` means ``cuda``, and a missing CUDA device is an error —
the port never falls back to the CPU on its own.

A program over several devices runs one process a device, joined by a
``torch.distributed`` group: ``nccl`` on CUDA, where rank ``r`` binds
``cuda:r``, ``gloo`` on the CPU. A group that cannot be built raises;
nothing carries on as one process. ``new_subgroups`` cuts the group
into the lines of a mesh's axes (``sharding.mesh.axis_groups``).
"""
from __future__ import annotations

import datetime
import socket
from typing import Optional, Union

import torch
import torch.distributed as dist


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on a CUDA device unless "
            "the CPU is asked for explicitly (device='cpu' / --device cpu)")
    return dev


def start_process_group(rank: int, world_size: int, init_method: str,
                        device: Optional[Union[str, torch.device]] = None,
                        timeout_s: float = 600.0) -> torch.device:
    """Join this process to a group of ``world_size`` ranks as ``rank``
    and return the rank's device: ``cuda:rank`` over ``nccl``, or the CPU
    over ``gloo``. ``init_method`` is the rendezvous (``tcp://host:port``
    or ``file://path``); ``timeout_s`` bounds every collective."""
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a process group is already running in this "
                           "process")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} of a world of {world_size}")
    if dev.type == "cuda":
        if rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs cuda:{rank}; "
                               f"{torch.cuda.device_count()} present")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group backend for {dev}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def local_rendezvous() -> str:
    """A ``tcp://`` rendezvous on a free port of this host, for ranks
    that all run here."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def end_process_group() -> None:
    """Leave the group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def new_subgroups(rank_lists) -> Optional[dist.ProcessGroup]:
    """Each list of ranks made a process subgroup, in the order given
    (every rank of the group makes the same calls); the one holding this
    rank, or None."""
    rank = dist.get_rank()
    mine = None
    for ranks in rank_lists:
        group = dist.new_group([int(r) for r in ranks])
        if rank in ranks:
            mine = group
    return mine


def rank_and_world() -> tuple:
    """(this process's rank, the group's size); (0, 1) without a group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
