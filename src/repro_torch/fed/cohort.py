"""Cohort realization: slate sizing, slate sampling, participation masks
(counterpart of ``repro/fed/cohort.py``).

Fixed cohorts draw ``clients_per_round`` distinct clients. Heterogeneous
cohorts (Poisson subsampling and/or dropout) make the realized size a
per-round random variable: every engine computes gradients for a slate
of a fixed size and masks the clients that do not take part out of the
SecAgg sum, and the accountant composes each round at its realized size.

The reference draws from a JAX key stream. The port owns its own stream:
one ``torch.Generator`` on the CPU, from which each round draws, in this
order (``draw_round``):

  1. its slate: fixed, ``randperm`` of the population cut to the slate;
     Poisson, one float64 uniform per client of the population, selected
     where it is below the rate, the selected ids ascending first, then
     the others ascending, cut to the slate (``valid = selected[ids]``);
  2. its uint32 kernel seed;
  3. when ``dropout > 0``, one float64 uniform per slot of the slate,
     dropped where it is below ``dropout``.

Same generator state, same cohort, seed and mask, on any device and under
every engine. ``draw_block`` draws a block's rounds in that order at
once, for the scan engine, which copies them to the device in one piece;
the realized size of each round is then known on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.fed.config import FedConfig
from repro_torch.kernels.prng import seed_bits


def is_hetero(cfg: FedConfig) -> bool:
    """Heterogeneous cohorts: the realized size varies from round to round
    (Poisson subsampling and/or dropout)."""
    return cfg.subsampling != "fixed" or cfg.dropout > 0


def poisson_rate(cfg: FedConfig) -> float:
    return cfg.clients_per_round / cfg.num_clients


def base_slate(cfg: FedConfig) -> int:
    """The slate the engines compute gradients for (before the shard
    engine rounds it to its ranks): clients_per_round for fixed cohorts;
    for Poisson cohorts mean + 6 sigma + 4 (truncated with probability
    ~1e-9 a round), capped by the population, unless ``max_cohort`` caps
    it."""
    if cfg.subsampling != "poisson":
        return cfg.clients_per_round
    rate = poisson_rate(cfg)
    if cfg.max_cohort is not None:
        slate = min(cfg.max_cohort, cfg.num_clients)
        if slate < 1:
            raise ValueError(f"max_cohort must be >= 1, got {slate}")
        return slate
    sigma = np.sqrt(cfg.num_clients * rate * (1.0 - rate))
    return min(cfg.num_clients, cfg.clients_per_round + int(np.ceil(6 * sigma)) + 4)


def sample_slate(cfg: FedConfig, slate: int, generator: torch.Generator) -> torch.Tensor:
    """``slate`` distinct client ids, uniformly without replacement (the
    fixed cohort's slate)."""
    return torch.randperm(cfg.num_clients, generator=generator)[:slate]


def sample_cohort(cfg: FedConfig, slate: int,
                  generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """One round's slate ``(ids, valid)``, both of shape (slate,) (the
    reference's ``sample_slate``): a fixed cohort fills the slate; a
    Poisson one selects each client at ``poisson_rate``, its ids first in
    ascending order, and marks the padding invalid."""
    if cfg.subsampling == "poisson":
        sel = torch.rand(cfg.num_clients, generator=generator,
                         dtype=torch.float64) < poisson_rate(cfg)
        ids = torch.cat([torch.nonzero(sel)[:, 0], torch.nonzero(~sel)[:, 0]])[:slate]
        return ids, sel[ids]
    return sample_slate(cfg, slate, generator), torch.ones(slate, dtype=torch.bool)


def participation(cfg: FedConfig, valid: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """The slate's participation mask: selected and not dropped out (each
    slot dropped with probability ``cfg.dropout``)."""
    if cfg.dropout > 0:
        drop = torch.rand(valid.shape[0], generator=generator,
                          dtype=torch.float64) < cfg.dropout
        return valid & ~drop
    return valid


def draw_seed(generator: torch.Generator) -> int:
    """The round's uint32 kernel seed."""
    return int(torch.randint(0, 1 << 32, (), generator=generator, dtype=torch.int64))


def draw_round(cfg: FedConfig, slate: int, generator: torch.Generator, ids=None, seed=None,
               part=None):
    """One round's draws in the stream's order, ``(ids, seed, part)``:
    ``part`` the int32 0/1 participation mask of a heterogeneous cohort,
    None for a fixed one. What is given is not drawn (tests inject the
    reference's cohort, seed and mask); a heterogeneous round given its
    ids must be given its mask."""
    valid = None
    if ids is None:
        ids, valid = sample_cohort(cfg, slate, generator)
    if seed is None:
        seed = draw_seed(generator)
    if not is_hetero(cfg):
        return ids, seed, None
    if part is None:
        if valid is None:
            raise ValueError("a heterogeneous round given its ids needs its mask (part=)")
        part = participation(cfg, valid, generator).to(torch.int32)
    return ids, seed, part


def block_width(cfg: FedConfig, slate: int) -> int:
    """Columns of a row of ``draw_block``: the ids and the seed, and the
    mask of a heterogeneous cohort."""
    return 2 * slate + 1 if is_hetero(cfg) else slate + 1


def draw_block(cfg: FedConfig, slate: int, generator: torch.Generator,
               length: int) -> torch.Tensor:
    """The next ``length`` rounds' draws, round by round in
    ``draw_round``'s order: an int32 (length, ``block_width``) tensor, row
    t holding round t's client ids, then its seed's int32 bit pattern
    (``prng.seed_bits``), then, for a heterogeneous cohort, its 0/1
    participation mask."""
    block = torch.empty((length, block_width(cfg, slate)), dtype=torch.int32)
    for t in range(length):
        ids, seed, part = draw_round(cfg, slate, generator)
        block[t, :slate] = ids
        block[t, slate] = seed_bits(seed)
        if part is not None:
            block[t, slate + 1:] = part
    return block


def realized_counts(cfg: FedConfig, slate: int, block: torch.Tensor) -> list:
    """The realized cohort size of each round of a ``draw_block`` block."""
    if not is_hetero(cfg):
        return [cfg.clients_per_round] * block.shape[0]
    return block[:, slate + 1:].sum(1).tolist()
