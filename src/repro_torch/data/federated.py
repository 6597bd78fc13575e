"""Federated data partitioning (paper setup: N=3400 local devices), a
numpy copy of ``repro/data/federated.py`` that gives the same arrays."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.emnist import NUM_CLASSES, SyntheticEMNIST


@dataclasses.dataclass
class FederatedPartition:
    """Per-client datasets. Non-iid by default: each client draws from a
    Dirichlet class mixture (alpha controls skew; alpha=inf ~ iid)."""

    num_clients: int = 3400
    samples_per_client: int = 20
    alpha: float = 1.0
    seed: int = 0
    deform: float = 0.35
    noise: float = 0.25

    def __post_init__(self):
        self.gen = SyntheticEMNIST(seed=self.seed, deform=self.deform,
                                   noise=self.noise)
        rng = np.random.default_rng(self.seed + 1)
        if np.isinf(self.alpha):
            mix = np.full((self.num_clients, NUM_CLASSES), 1.0 / NUM_CLASSES)
        else:
            mix = rng.dirichlet([self.alpha] * NUM_CLASSES, size=self.num_clients)
        self._mix = mix.astype(np.float64)
        self._rng_seed = self.seed + 2

    def client_data(self, client_id: int):
        """Deterministic per-client dataset: (images (m,28,28), labels (m,))."""
        rng = np.random.default_rng((self._rng_seed, client_id))
        labels = rng.choice(
            NUM_CLASSES, size=self.samples_per_client, p=self._mix[client_id]
        ).astype(np.int32)
        images = self.gen.sample(rng, labels)
        return images, labels

