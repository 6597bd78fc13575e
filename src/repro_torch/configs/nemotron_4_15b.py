"""Nemotron-4 15B [dense]: GQA (48H/8kv), squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig, uniform_layers


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        arch_type="dense",
        source="arXiv:2402.16819",
        num_layers=32,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=256000,
        layers=uniform_layers(32),
        mlp_kind="squared_relu",
        subquadratic=False,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b-reduced",
        arch_type="dense",
        source="arXiv:2402.16819",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        layers=uniform_layers(2),
        mlp_kind="squared_relu",
        q_chunk=64,
    )
