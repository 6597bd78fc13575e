"""The client process groups of the shard engine and of the LM train
step's client-parallel plans (counterpart of ``repro/launch/mesh.py``'s
``make_shard_mesh`` and ``compat_make_mesh`` at tp = 1).

The reference spans a device mesh inside one program. The port runs one
process per rank, as ``torch.distributed`` does: the caller starts the
processes and initialises the default process group (NCCL for CUDA
tensors, gloo for CPU ones); each rank's engine sums its cohort slice,
and each client rank of a plan its levels, over that group. A single
rank needs no launcher: with no default group, ``shard_group`` and
``client_group`` create a one-rank group on an in-memory ``HashStore``
(no sockets), once, and reuse it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# the backends of the one-rank default group this module created, if any
_created: str | None = None


def _backend(device: torch.device) -> str:
    return "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"


def _group(ranks: int | None, device, who: str, start: str) -> dist.ProcessGroup:
    """The default group when one exists (its world size must be
    ``ranks``; ``None`` takes it as it is), else, for one rank, a
    one-rank group this function creates. ``who`` names the caller and
    ``start`` says how to start its ranks, in the errors."""
    global _created
    device = torch.device(device)
    if dist.is_initialized() and _created is not None and device.type == "cuda" \
            and "nccl" not in _created:
        # the one-rank group made earlier serves CPU tensors only
        dist.destroy_process_group()
        _created = None
    if dist.is_initialized():
        world = dist.get_world_size()
        if ranks is not None and ranks != world:
            raise ValueError(f"{who} wants {ranks} ranks, but the default process group "
                             f"has {world}: {start}")
        return dist.group.WORLD
    if ranks not in (None, 1):
        raise ValueError(f"{who} wants {ranks} ranks, but no default process group "
                         f"exists: {start}")
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        device_id = torch.device("cuda", index)
    else:
        device_id = None
    dist.init_process_group(_backend(device), store=dist.HashStore(), rank=0,
                            world_size=1, device_id=device_id)
    _created = _backend(device)
    return dist.group.WORLD


def shard_group(shards: int | None, device) -> dist.ProcessGroup:
    """The process group of a shard engine of ``shards`` ranks on
    ``device``: the default group when one exists (its world size must be
    ``shards``; ``None`` takes it as it is), else, for one shard, a
    one-rank group this function creates."""
    return _group(shards, device, "shard engine",
                  f"start {shards} processes, one per device, and call "
                  f"torch.distributed.init_process_group(backend, init_method=..., "
                  f"rank=..., world_size={shards}) in each before building the trainer")


def client_group(n_clients: int, device) -> dist.ProcessGroup:
    """The process group of a client-parallel plan of ``n_clients`` ranks
    on ``device`` (``distributed/step.py:MeshPlan``), by the rules of
    ``shard_group``: the default group, whose world size must be
    ``n_clients``, or for one client a one-rank group on an in-memory
    store (NCCL on the card)."""
    return _group(n_clients, device, "the client-parallel plan",
                  f"launch {n_clients} processes, one per device, e.g. torchrun "
                  f"--nproc-per-node {n_clients} -m repro_torch.launch.train ..., or call "
                  f"torch.distributed.init_process_group(backend, init_method=..., "
                  f"rank=..., world_size={n_clients}) in each before building the plan")
