"""The paper's EMNIST CNN (Appendix C), counterpart of ``repro/fed/cnn.py``.

Parameters keep the reference's layouts, so the flat vector means the
same thing in both packages: convolution weights are HWIO (permuted to
OIHW only for ``F.conv2d``) and dense weights are (in, out). The
features are flattened in (h, w, c) order, as JAX flattens NHWC.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.data.emnist import NUM_CLASSES


def cnn_init(generator: torch.Generator, channels=(16, 32), hidden: int = 128,
             device="cuda") -> dict:
    """Random CNN parameters (normal / sqrt(fan_in), zero biases), drawn
    on the CPU from ``generator`` and moved to ``device``."""
    c1, c2 = channels

    def normal(shape, fan):
        return torch.randn(shape, generator=generator) / fan ** 0.5

    params = {
        "conv1": normal((5, 5, 1, c1), 25),
        "conv2": normal((5, 5, c1, c2), 25 * c1),
        "dense1": normal((7 * 7 * c2, hidden), 7 * 7 * c2),
        "b1": torch.zeros(hidden),
        "dense2": normal((hidden, NUM_CLASSES), hidden),
        "b2": torch.zeros(NUM_CLASSES),
    }
    return {k: v.to(device) for k, v in params.items()}


def _conv_same(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    # SAME padding of a 5x5 kernel at stride 1 is 2 on every side
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), padding=w_hwio.shape[0] // 2)


def cnn_apply(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images (B, 28, 28) -> logits (B, 62)."""
    x = images[:, None]
    x = F.max_pool2d(F.relu(_conv_same(x, params["conv1"])), 2)
    x = F.max_pool2d(F.relu(_conv_same(x, params["conv2"])), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten order
    x = F.relu(x @ params["dense1"] + params["b1"])
    return x @ params["dense2"] + params["b2"]


def cnn_loss(params: dict, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(cnn_apply(params, images), dim=-1)
    return -logp.gather(1, labels[:, None].long()).mean()


def cnn_accuracy(params: dict, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = cnn_apply(params, images)
    return (logits.argmax(-1) == labels).to(torch.float32).mean()
