"""Fixed-size cohort sampling (counterpart of ``repro/fed/cohort.py``).

The reference draws each round's cohort and kernel seed from a JAX key
stream. The port owns its own stream: one ``torch.Generator`` on the CPU,
from which each round draws its cohort first and its uint32 kernel seed
second. Same generator state, same cohort and seed, on any device.
``draw_block`` draws a block's rounds in that order at once, for the scan
engine, which copies them to the device in one piece.
"""
from __future__ import annotations

import torch

from repro_torch.fed.config import FedConfig
from repro_torch.kernels.prng import seed_bits


def sample_slate(cfg: FedConfig, slate: int, generator: torch.Generator) -> torch.Tensor:
    """``slate`` distinct client ids, uniformly without replacement."""
    return torch.randperm(cfg.num_clients, generator=generator)[:slate]


def draw_seed(generator: torch.Generator) -> int:
    """The round's uint32 kernel seed."""
    return int(torch.randint(0, 1 << 32, (), generator=generator, dtype=torch.int64))


def draw_block(cfg: FedConfig, slate: int, generator: torch.Generator,
               length: int) -> torch.Tensor:
    """The next ``length`` rounds' draws, round by round (its cohort, then
    its seed, as ``sample_slate`` and ``draw_seed`` draw them): an int32
    (length, slate + 1) tensor, row t holding round t's client ids and
    then its seed's int32 bit pattern (``prng.seed_bits``)."""
    block = torch.empty((length, slate + 1), dtype=torch.int32)
    for t in range(length):
        block[t, :slate] = sample_slate(cfg, slate, generator)
        block[t, slate] = seed_bits(draw_seed(generator))
    return block
