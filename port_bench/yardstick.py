"""The yardstick, frozen: the H100's published peaks, the least time of
an encode or a fused round sum from its shapes, and the model FLOPs the
MFU metrics count. Nothing here reads the program: each count follows
from the widths in a configuration file and the shapes of a cell.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM5 80 GB data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# the integer pipes an encode's splitmix32 draws run on: 132 SMs x 64
# lanes at 1.98 GHz for the ALU pipe and for the FMA pipe
ALU_OPS_PER_S = 132 * 64 * 1.98e9
FMA_OPS_PER_S = 132 * 64 * 1.98e9
ALU_ONLY_OPS_PER_DRAW = 2  # the xors
FMA_ONLY_OPS_PER_DRAW = 2  # the multiplies
EITHER_OPS_PER_DRAW = 3    # the salt's add, the two shifts
# splitmix32 draws an element of the RQM encode needs at m=16, q=0.42 on
# uniform inputs over [-1.2c, 1.2c]: the keep draws walking out from the
# bin to the nearest kept level on each side, and the rounding draw
# unless the rounding is certain
RQM_DRAWS_PER_ELEMENT = 5.518855897851641


def bound_s(nbytes: float, draws: float = 0.0) -> float:
    """The least time of a kernel's work: the larger of its bytes (each
    input read once, each output written once) over HBM's rate and its
    needed draws' integer operations over the pipes, scheduled as evenly
    as each operation's pipe allows."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    ops = ALU_ONLY_OPS_PER_DRAW + FMA_ONLY_OPS_PER_DRAW + EITHER_OPS_PER_DRAW
    t_ops = draws * max(ALU_ONLY_OPS_PER_DRAW / ALU_OPS_PER_S,
                        FMA_ONLY_OPS_PER_DRAW / FMA_OPS_PER_S,
                        ops / (ALU_OPS_PER_S + FMA_OPS_PER_S))
    return max(t_bytes, t_ops)


def encode_bound_s(elements: int) -> float:
    """A materialized RQM encode of ``elements`` float32 values into int32
    levels: 4 bytes in and 4 out an element."""
    return bound_s(8 * elements, RQM_DRAWS_PER_ELEMENT * elements)


def packed_words(dim: int, bits: int) -> int:
    """int32 words of a planar packed sum of ``dim`` fields of ``bits``."""
    per_word = 32 // bits
    return -(-dim // per_word)


def round_sum_bound_s(rows: int, dim: int, bits: int | None) -> float:
    """The fused encode-and-sum of ``rows`` clients' float32 gradients of
    ``dim`` into one int32 sum, dense or packed at ``bits``: the rows read
    once, a weight a row, the sum written once."""
    out = 4 * (dim if bits is None else packed_words(dim, bits))
    return bound_s(4 * rows * dim + 4 * rows + out, RQM_DRAWS_PER_ELEMENT * rows * dim)


def sum_bits(bound: int) -> int:
    """Width of a wire field that holds sums up to ``bound``."""
    return max(1, int(bound).bit_length())


def cnn_flops_per_sample(channels=(16, 32), hidden: int = 128, classes: int = 62) -> int:
    """Forward FLOPs (2 a multiply-add) of the EMNIST CNN on one 28x28
    sample: two 5x5 SAME convolutions, each before a 2x2 max-pool, then
    the dense layers."""
    c1, c2 = channels
    macs = (28 * 28 * c1 * 25 + 14 * 14 * c2 * 25 * c1 + 7 * 7 * c2 * hidden
            + hidden * classes)
    return 2 * macs


def cnn_params(channels=(16, 32), hidden: int = 128, classes: int = 62) -> int:
    c1, c2 = channels
    return 25 * c1 + 25 * c1 * c2 + 49 * c2 * hidden + hidden + hidden * classes + classes


def padded_vocab(vocab: int, multiple: int) -> int:
    return -(-vocab // multiple) * multiple


def mamba2_params(cfg: dict) -> int:
    """Parameters of the Mamba-2 stack as the port lays it out: the
    embedding and an untied head over the padded vocabulary, and a layer
    of in-projections (z and x, B and C, dt), depthwise convolutions, A,
    D, dt's bias, the gated norm, the out-projection and the pre-norm."""
    d, n, hd, w = cfg["d_model"], cfg["d_state"], cfg["headdim"], cfg["d_conv"]
    di = cfg["expand"] * d
    h = di // hd
    v = padded_vocab(cfg["vocab_size"], cfg["pad_vocab_size_multiple"])
    layer = d + d * 2 * di + d * 2 * n + d * h + w * di + w * 2 * n + 3 * h + di + di * d
    heads = v * d * (1 if cfg["tie_embeddings"] else 2)
    return heads + cfg["n_layer"] * layer + d


def train_flops(n_params: int, tokens: int) -> float:
    """Model FLOPs of a training step: 6 N a token."""
    return 6.0 * n_params * tokens


def share(least_s: float, took_s: float) -> float | None:
    """100 * least / took, or None where nothing was timed."""
    if not took_s or took_s <= 0 or not math.isfinite(took_s):
        return None
    return 100.0 * least_s / took_s
