"""Pixtral 12B [vlm]: Mistral-NeMo-style decoder consuming Pixtral-ViT patch
embeddings. Vision tower is a STUB: input_specs provides 1024 precomputed
patch embeddings per sample. [hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.configs.base import FrontendSpec, ModelConfig, uniform_layers


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        arch_type="vlm",
        source="hf:mistralai/Pixtral-12B-2409",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        layers=uniform_layers(40, theta=1_000_000.0),
        mlp_kind="swiglu",
        frontend=FrontendSpec(kind="vision", prefix_len=1024),
        subquadratic=False,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b-reduced",
        arch_type="vlm",
        source="hf:mistralai/Pixtral-12B-2409",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        layers=uniform_layers(2, theta=1_000_000.0),
        mlp_kind="swiglu",
        frontend=FrontendSpec(kind="vision", prefix_len=16),
        q_chunk=64,
    )
