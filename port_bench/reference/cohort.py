"""The round stream, re-derived: one CPU generator seeded with ``seed +
11`` from which each round draws, in order, its slate (fixed: a random
permutation of the population cut to the cohort; Poisson: one float64
uniform a client, selected below the rate, the selected ids ascending
first, then the others, cut to the slate), its uint32 encode seed, and
with dropout one float64 uniform a slot, dropped below the dropout
rate. A Poisson slate is mean + ceil(6 sigma) + 4 slots."""
from __future__ import annotations

import math

import torch


def slate(num_clients: int, cohort: int, subsampling: str) -> int:
    if subsampling != "poisson":
        return cohort
    rate = cohort / num_clients
    sigma = math.sqrt(num_clients * rate * (1.0 - rate))
    return min(num_clients, cohort + int(math.ceil(6 * sigma)) + 4)


class Stream:
    def __init__(self, seed: int, num_clients: int, cohort: int, subsampling: str,
                 dropout: float):
        self.g = torch.Generator().manual_seed(seed + 11)
        self.n, self.cohort, self.poisson = num_clients, cohort, subsampling == "poisson"
        self.dropout = dropout
        self.slate = slate(num_clients, cohort, subsampling)

    def next(self):
        """(ids (slate,), uint32 seed, participation (slate,) bool)."""
        if self.poisson:
            sel = torch.rand(self.n, generator=self.g, dtype=torch.float64) < self.cohort / self.n
            ids = torch.cat([torch.nonzero(sel)[:, 0], torch.nonzero(~sel)[:, 0]])[:self.slate]
            part = sel[ids]
        else:
            ids = torch.randperm(self.n, generator=self.g)[:self.slate]
            part = torch.ones(self.slate, dtype=torch.bool)
        seed = int(torch.randint(0, 1 << 32, (), generator=self.g, dtype=torch.int64))
        if self.dropout > 0:
            drop = torch.rand(self.slate, generator=self.g, dtype=torch.float64) < self.dropout
            part = part & ~drop
        return ids, seed, part
