"""The process groups of the shard engine and of the LM train step's
plans (counterpart of ``repro/launch/mesh.py``'s ``make_shard_mesh``,
``make_fed_mesh`` and ``compat_make_mesh``).

The reference spans a device mesh inside one program. The port runs one
process per rank, as ``torch.distributed`` does: the caller starts the
processes and initialises the default process group (NCCL for CUDA
tensors, gloo for CPU ones); each rank's engine sums its cohort slice,
and each client rank of a plan its levels, over that group. A single
rank needs no launcher: with no default group, ``shard_group`` and
``client_group`` create a one-rank group on an in-memory ``HashStore``
(no sockets), once, and reuse it.

A plan with a model axis (``mesh_groups``) splits the default group of
``n_clients * tp`` ranks into a 2-D grid ordered model-minor, as the
reference orders a mesh's devices: global rank = client_linear * tp +
model_index. Every rank creates, in the same order, one model group per
client, one client group per model index, and the aligned model-axis
subgroups of each power-of-two size between 1 and tp
(``ParallelCtx.subgroup_psum``).

Backend: ``backend(device, world)``. On the CPU gloo; on CUDA NCCL when
every rank has a card of its own, and gloo when the ranks outnumber the
visible cards (NCCL refuses two ranks on one device). Gloo then works on
the CUDA tensors themselves: no collective moves them to the CPU.

The dry run (``launch/dryrun.py``) plays one rank of a production mesh
in one process: ``fake_world`` starts a default group of PyTorch's
``fake`` backend, whose collectives return at once and move no data, and
``mesh_groups``/``client_group`` build a plan's groups over it as over a
real one (``new_group`` takes the default group's backend). ``H100`` holds
the card's roofline terms, as the reference's ``V5E`` holds the TPU's.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

# NVIDIA H100 SXM5 (80 GB HBM3), the keys of the reference's V5E, for
# launch/hlo_analysis.py:roofline_terms. Data-sheet figures: dense bfloat16
# tensor-core peak, HBM3 bandwidth, NVLink 4 in one direction (18 links of
# 25 GB/s); a mesh axis that leaves an 8-GPU node crosses InfiniBand at a
# small fraction of that. hbm_bytes is the total_memory that
# torch.cuda.get_device_properties reads on an NVIDIA H100 80GB HBM3 (at
# 700 W); on a card the dry run reads the card's own.
H100 = {
    "peak_flops_bf16": 989e12,
    "hbm_bandwidth": 3.35e12,
    "ici_link_bandwidth": 450e9,
    "hbm_bytes": 85_017_493_504,
}

# the backends of the one-rank default group this module created, if any
_created: str | None = None


def backend(device, world: int) -> str:
    """The backend of a default group of ``world`` ranks on ``device``:
    gloo on the CPU or when the ranks outnumber the visible cards (they
    share one), else NCCL for CUDA tensors and gloo for CPU ones."""
    device = torch.device(device)
    if device.type != "cuda" or world > torch.cuda.device_count():
        return "gloo"
    return "cpu:gloo,cuda:nccl"


class MeshGroups:
    """The groups of a 2-D plan on this rank: ``client`` (the ranks of its
    model index), ``model`` (its client's ranks), ``subgroups`` (``((size,
    group), ...)``, its aligned model-axis subgroups), and its
    ``client_index`` and ``model_index``."""

    def __init__(self, client, model, subgroups, client_index: int, model_index: int):
        self.client, self.model, self.subgroups = client, model, subgroups
        self.client_index, self.model_index = client_index, model_index


def mesh_groups(n_clients: int, tp: int, device) -> MeshGroups:
    """The groups of a plan of ``n_clients`` clients of ``tp`` model
    ranks each over the default group, whose world size must be
    ``n_clients * tp`` (see the module docstring)."""
    world = n_clients * tp
    if not dist.is_initialized() or dist.get_world_size() != world:
        have = (f"the default process group has {dist.get_world_size()}"
                if dist.is_initialized() else "no default process group exists")
        raise ValueError(
            f"a plan of {n_clients} clients x {tp} model ranks wants {world} ranks, but "
            f"{have}: launch {world} processes, e.g. torchrun --nproc-per-node {world} -m "
            f"repro_torch.launch.train --mesh-shape {n_clients}x{tp} ..., or call "
            f"torch.distributed.init_process_group(...) in each")
    rank = dist.get_rank()
    client_index, model_index = divmod(rank, tp)
    mine = {}
    for c in range(n_clients):  # one model group a client
        g = dist.new_group([c * tp + j for j in range(tp)])
        if c == client_index:
            mine["model"] = g
    for j in range(tp):  # one client group a model index
        g = dist.new_group([c * tp + j for c in range(n_clients)])
        if j == model_index:
            mine["client"] = g
    subgroups = []
    size = 2
    while size < tp:  # aligned blocks of each power-of-two size
        for c in range(n_clients):
            for b in range(tp // size):
                g = dist.new_group([c * tp + b * size + k for k in range(size)])
                if c == client_index and b == model_index // size:
                    subgroups.append((size, g))
        size *= 2
    return MeshGroups(mine["client"], mine["model"], tuple(subgroups), client_index,
                      model_index)


@contextlib.contextmanager
def fake_world(world: int):
    """A default process group of ``world`` ranks on PyTorch's ``fake``
    backend, this process its rank 0, for the block: its collectives
    return at once and move nothing (the dry run's). Refuses to start
    over an existing default group, and destroys its own on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    global _created
    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
        _created = None


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
    name = backend(device, 1)
    dist.init_process_group(name, store=dist.HashStore(), rank=0,
                            world_size=1, device_id=device_id)
    _created = name
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
