"""Client-data staging for the engines (counterpart of
``repro/fed/staging.py``): the whole population, or a block's cohorts.

``stage_full`` puts every client's dataset on the device once (about
213 MB at the paper's 3400 x 20 EMNIST images); under the shard engine
every rank holds the whole population, since any rank may draw any
client. ``stage_stream_block`` (``staging="stream"``) stages only the
next block's cohort slices of one rank, replaying the round stream on a
copy of the trainer's generator, so a population of 1e5 or 1e6 clients
never exists in memory at once.

Client data is the task's: every ``task.client_batch(cid)`` is a dict of
numpy arrays with the same shapes and dtypes, stacked leaf by leaf along
a leading clients axis (streamed: (rounds, clients) axes). Both return
``(data, nbytes)``; the trainer keeps the byte counters.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.fed import cohort
from repro_torch.fed.config import FedConfig


def _to_device(leaves: dict, device) -> tuple[dict, int]:
    data = {k: torch.from_numpy(v).to(device) for k, v in leaves.items()}
    return data, sum(v.nbytes for v in leaves.values())


def stage_full(task, cfg: FedConfig, device) -> tuple[dict, int]:
    """Every client's dataset, stacked along a leading (num_clients,) axis."""
    batches = [task.client_batch(i) for i in range(cfg.num_clients)]
    return _to_device({k: np.stack([b[k] for b in batches]) for k in batches[0]}, device)


def replay_cohorts(cfg: FedConfig, slate: int, generator: torch.Generator,
                   length: int) -> np.ndarray:
    """The (length, slate) cohort ids the next ``length`` rounds will draw
    from ``generator``, drawn on a copy of it (each round's ids, then its
    seed), so the trainer's own generator does not move."""
    replay = torch.Generator()
    replay.set_state(generator.get_state())
    return cohort.draw_block(cfg, slate, replay, length)[:, :slate].numpy().astype(np.int64)


def stage_stream_block(task, cfg: FedConfig, slate: int, generator: torch.Generator,
                       length: int, rank: int, shards: int, device) -> tuple[dict, int]:
    """This rank's slice of each of the next ``length`` rounds' cohorts,
    in drawn order: leaves of shape (length, slate // shards, ...)."""
    n_per = slate // shards
    ids = replay_cohorts(cfg, slate, generator, length)[:, rank * n_per:(rank + 1) * n_per]
    cache: dict = {}  # a client's data is deterministic: stage it once a block
    leaves = None
    for t in range(length):
        for u, cid in enumerate(ids[t]):
            cid = int(cid)
            if cid not in cache:
                cache[cid] = task.client_batch(cid)
            if leaves is None:
                leaves = {k: np.empty((length, n_per) + v.shape, v.dtype)
                          for k, v in cache[cid].items()}
            for k, v in cache[cid].items():
                leaves[k][t, u] = v
    return _to_device(leaves, device)
