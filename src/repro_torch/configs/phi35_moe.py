"""Phi-3.5-MoE 42B (6.6B active) [moe]: 16 experts top-2, GQA 32H/8kv.
[hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.configs.base import ModelConfig, uniform_layers
from repro_torch.models.moe import MoESpec


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        arch_type="moe",
        source="hf:microsoft/Phi-3.5-MoE-instruct",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32064,
        layers=uniform_layers(32),
        mlp_kind=None,  # every layer's FFN is the MoE
        moe=MoESpec(d_model=4096, num_experts=16, top_k=2, d_ff_expert=6400),
        subquadratic=False,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-reduced",
        arch_type="moe",
        source="hf:microsoft/Phi-3.5-MoE-instruct",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        layers=uniform_layers(2),
        mlp_kind=None,
        moe=MoESpec(d_model=256, num_experts=4, top_k=2, d_ff_expert=256),
        q_chunk=64,
    )
