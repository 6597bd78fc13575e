"""Architecture + input-shape configuration system (counterpart of
``repro/configs/base.py``, pure Python).

A ModelConfig is a complete static description of one architecture: per-layer
block kinds (attention / ssm / shared-attention), attention geometry
(GQA / sliding-window / local:global mix / partial rotary), MLP kind, MoE
and SSM specs, vocab, and the modality-frontend stub for VLM/audio archs.

Each architecture's ``reduced_config()`` is the CPU-sized variant of the
same family (<=2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.attention import AttentionSpec
from repro_torch.models.moe import MoESpec
from repro_torch.models.ssm import SSMSpec


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One block: kind in {'attn', 'ssm', 'shared_attn'}; attn layers carry
    their own window/theta (gemma3 local/global layers differ)."""

    kind: str
    window: Optional[int] = None
    rope_theta: float = 10000.0


@dataclasses.dataclass(frozen=True)
class FrontendSpec:
    """Stubbed modality frontend (VLM vision tower / audio codec): the
    transformer consumes `prefix_len` precomputed d_model embeddings."""

    kind: str  # "vision" | "audio"
    prefix_len: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str  # citation bracket from the assignment
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layers: tuple[LayerSpec, ...]
    mlp_kind: Optional[str] = "swiglu"  # None for pure-SSM archs
    rotary_frac: float = 1.0
    qkv_bias: bool = False
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    shared_attn: bool = False  # zamba2: one attention block shared by layers
    shared_d_ff: int = 0
    frontend: Optional[FrontendSpec] = None
    norm_eps: float = 1e-6
    vocab_pad_to: int = 128  # vocab padded to a multiple of this * tp
    tie_embeddings: bool = False
    q_chunk: int = 256
    subquadratic: bool = False  # eligible for long_500k decode

    def padded_vocab(self, tp: int) -> int:
        mult = self.vocab_pad_to * tp
        return ((self.vocab_size + mult - 1) // mult) * mult

    def attn_spec(self, layer: LayerSpec) -> AttentionSpec:
        return AttentionSpec(
            d_model=self.d_model,
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim,
            rope_theta=layer.rope_theta,
            rotary_frac=self.rotary_frac,
            window=layer.window,
            qkv_bias=self.qkv_bias,
            q_chunk=self.q_chunk,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def uniform_layers(n: int, window: Optional[int] = None, theta: float = 10000.0):
    return tuple(LayerSpec("attn", window=window, rope_theta=theta) for _ in range(n))
