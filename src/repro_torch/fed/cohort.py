"""Fixed-size cohort sampling (counterpart of ``repro/fed/cohort.py``).

The reference draws each round's cohort and kernel seed from a JAX key
stream. The port owns its own stream: one ``torch.Generator`` on the CPU,
from which each round draws its cohort first and its uint32 kernel seed
second. Same generator state, same cohort and seed, on any device.
"""
from __future__ import annotations

import torch

from repro_torch.fed.config import FedConfig


def sample_slate(cfg: FedConfig, slate: int, generator: torch.Generator) -> torch.Tensor:
    """``slate`` distinct client ids, uniformly without replacement."""
    return torch.randperm(cfg.num_clients, generator=generator)[:slate]


def draw_seed(generator: torch.Generator) -> int:
    """The round's uint32 kernel seed."""
    return int(torch.randint(0, 1 << 32, (), generator=generator, dtype=torch.int64))
