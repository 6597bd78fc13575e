"""The paper's EMNIST round, re-derived from the seed: the procedural
62-class 28x28 clients (a Dirichlet(1) class mixture a client, class
prototypes from 7x7 fields upsampled 4x, per-sample deformation and
pixel noise), the CNN of Appendix C (conv 5x5x16, max-pool, conv 5x5x32,
max-pool, dense 1568-128-62) with its initial weights, and its loss.

Parameters are kept by name in the flat layout the program's flat vector
uses: leaves in sorted key order, each row-major (convolutions HWIO,
dense (in, out)), so a flat coordinate means the same weight on both
sides and draws the same RNG counter.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NUM_CLASSES = 62


def shapes(channels=(16, 32), hidden: int = 128) -> dict:
    c1, c2 = channels
    return {"conv1": (5, 5, 1, c1), "conv2": (5, 5, c1, c2), "dense1": (7 * 7 * c2, hidden),
            "b1": (hidden,), "dense2": (hidden, NUM_CLASSES), "b2": (NUM_CLASSES,)}


def init(seed: int, channels=(16, 32), hidden: int = 128) -> dict:
    """Normal / sqrt(fan_in) weights, zero biases, drawn on the CPU from a
    generator seeded with ``seed``, in the model's declaration order."""
    g = torch.Generator().manual_seed(seed)
    fans = {"conv1": 25, "conv2": 25 * channels[0], "dense1": 7 * 7 * channels[1],
            "dense2": hidden}
    out = {}
    for name, shape in shapes(channels, hidden).items():
        out[name] = (torch.randn(shape, generator=g) / fans[name] ** 0.5 if name in fans
                     else torch.zeros(shape))
    return out


def flatten(params: dict) -> torch.Tensor:
    return torch.cat([params[k].reshape(-1) for k in sorted(params)])


def leaf_slices(shape_of: dict) -> dict:
    """name -> (start, stop) in the flat vector."""
    out, at = {}, 0
    for k in sorted(shape_of):
        n = int(np.prod(shape_of[k]))
        out[k] = (at, at + n)
        at += n
    return out


def unflatten(flat: torch.Tensor, shape_of: dict) -> dict:
    return {k: flat[a:b].reshape(shape_of[k]) for k, (a, b) in leaf_slices(shape_of).items()}


class Population:
    """The clients of a seed: ``client(cid)`` -> (images (m, 28, 28)
    float32, labels (m,) int32)."""

    def __init__(self, seed: int, num_clients: int, samples: int, deform: float, noise: float,
                 alpha: float = 1.0):
        low = np.random.default_rng(seed).normal(size=(NUM_CLASSES, 7, 7)).astype(np.float32)
        self.prototypes = np.kron(low, np.ones((4, 4), np.float32))
        self.mix = np.random.default_rng(seed + 1).dirichlet(
            [alpha] * NUM_CLASSES, size=num_clients).astype(np.float64)
        self.seed, self.samples, self.deform, self.noise = seed, samples, deform, noise

    def client(self, cid: int):
        rng = np.random.default_rng((self.seed + 2, cid))
        labels = rng.choice(NUM_CLASSES, size=self.samples, p=self.mix[cid]).astype(np.int32)
        n = labels.shape[0]
        low = rng.normal(size=(n, 7, 7)).astype(np.float32)
        warp = np.kron(low, np.ones((4, 4), np.float32))
        pix = rng.normal(size=(n, 28, 28)).astype(np.float32)
        return self.prototypes[labels] + self.deform * warp + self.noise * pix, labels


def logits(params: dict, images: torch.Tensor) -> torch.Tensor:
    x = images[:, None]
    for name in ("conv1", "conv2"):
        w = params[name].permute(3, 2, 0, 1)  # HWIO -> OIHW
        x = F.max_pool2d(F.relu(F.conv2d(x, w, padding=2)), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # features in (h, w, c) order
    x = F.relu(x @ params["dense1"] + params["b1"])
    return x @ params["dense2"] + params["b2"]


def loss(params: dict, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of a client's samples."""
    return F.cross_entropy(logits(params, images), labels.long())

