"""The shard engine's client group (counterpart of
``repro/launch/mesh.py:make_shard_mesh``).

The reference spans a 1-D ``('shard',)`` device mesh inside one program.
The port runs one process per rank, as ``torch.distributed`` does: the
caller starts the processes and initialises the default process group
(NCCL for CUDA tensors, gloo for CPU ones); each rank's engine sums its
cohort slice over that group. A single rank needs no launcher: with no
default group and one shard, ``shard_group`` creates a one-rank group on
an in-memory ``HashStore`` (no sockets), once, and reuses it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# the backends of the one-rank default group this module created, if any
_created: str | None = None


def _backend(device: torch.device) -> str:
    return "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"


def shard_group(shards: int | None, device) -> dist.ProcessGroup:
    """The process group of a shard engine of ``shards`` ranks on
    ``device``: the default group when one exists (its world size must be
    ``shards``; ``None`` takes it as it is), else, for one shard, a
    one-rank group this function creates."""
    global _created
    device = torch.device(device)
    if dist.is_initialized() and _created is not None and device.type == "cuda" \
            and "nccl" not in _created:
        # the one-rank group made earlier serves CPU tensors only
        dist.destroy_process_group()
        _created = None
    if dist.is_initialized():
        world = dist.get_world_size()
        if shards is not None and shards != world:
            raise ValueError(
                f"shard engine wants {shards} ranks, but the default process group "
                f"has {world} (one process per device: start {shards} processes and "
                f"call torch.distributed.init_process_group with world_size={shards} "
                f"in each before building the trainer)")
        return dist.group.WORLD
    if shards not in (None, 1):
        raise ValueError(
            f"shard engine wants {shards} ranks (devices), but no default process "
            f"group exists: start {shards} processes, one per device, and call "
            f"torch.distributed.init_process_group(backend, init_method=..., "
            f"rank=..., world_size={shards}) in each before building the trainer")
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        device_id = torch.device("cuda", index)
    else:
        device_id = None
    dist.init_process_group(_backend(device), store=dist.HashStore(), rank=0,
                            world_size=1, device_id=device_id)
    _created = _backend(device)
    return dist.group.WORLD
