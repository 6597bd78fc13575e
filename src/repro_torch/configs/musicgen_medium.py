"""MusicGen-medium [audio]: decoder-only transformer over EnCodec tokens,
MHA (24H, kv=24), GELU FFN. Frontend (EnCodec + text conditioning) is a STUB:
input_specs provides 64 precomputed conditioning embeddings. [arXiv:2306.05284]

Simplification noted in DESIGN.md: single-codebook token stream (the 4-book
delay pattern is a data-layout concern orthogonal to the systems work).
"""
from repro_torch.configs.base import FrontendSpec, ModelConfig, uniform_layers


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        arch_type="audio",
        source="arXiv:2306.05284",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        layers=uniform_layers(48),
        mlp_kind="gelu",
        frontend=FrontendSpec(kind="audio", prefix_len=64),
        subquadratic=False,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-reduced",
        arch_type="audio",
        source="arXiv:2306.05284",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        layers=uniform_layers(2),
        mlp_kind="gelu",
        frontend=FrontendSpec(kind="audio", prefix_len=8),
        q_chunk=64,
    )
