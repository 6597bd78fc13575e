"""Procedural synthetic EMNIST, a numpy copy of ``repro/data/emnist.py``
that gives the same arrays for the same seeds.

62 classes (digits + upper + lower), 28x28 grayscale. Each class has a
deterministic prototype (low-frequency random field); samples are the
prototype plus per-sample deformation and pixel noise. Classes are
separable enough that the privacy-accuracy ordering of mechanisms
(noise-free > RQM > PBM), the paper's experimental claim, is measurable.
"""
from __future__ import annotations

import numpy as np

NUM_CLASSES = 62
IMAGE_SHAPE = (28, 28)


class SyntheticEMNIST:
    def __init__(self, seed: int = 0, deform: float = 0.35, noise: float = 0.25):
        rng = np.random.default_rng(seed)
        # low-frequency prototypes: random 7x7 fields upsampled to 28x28
        low = rng.normal(size=(NUM_CLASSES, 7, 7)).astype(np.float32)
        self.prototypes = np.kron(low, np.ones((4, 4), np.float32))
        self.deform = deform
        self.noise = noise

    def sample(self, rng: np.random.Generator, labels: np.ndarray) -> np.ndarray:
        """labels (n,) -> images (n, 28, 28) float32 in ~[-3, 3]."""
        n = labels.shape[0]
        base = self.prototypes[labels]
        # smooth per-sample deformation field
        low = rng.normal(size=(n, 7, 7)).astype(np.float32)
        deform = np.kron(low, np.ones((4, 4), np.float32))
        pix = rng.normal(size=(n, *IMAGE_SHAPE)).astype(np.float32)
        return base + self.deform * deform + self.noise * pix

    def make_split(self, seed: int, size: int):
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, NUM_CLASSES, size=size)
        images = self.sample(rng, labels)
        return images, labels.astype(np.int32)
