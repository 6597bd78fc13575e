"""Qwen3-MoE 30B (3B active) [moe]: 128 experts top-8 (d_ff 768 each),
GQA 32H/4kv, head_dim 128. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ModelConfig, uniform_layers
from repro_torch.models.moe import MoESpec


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        arch_type="moe",
        source="hf:Qwen/Qwen3-30B-A3B",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        layers=uniform_layers(48),
        mlp_kind=None,
        moe=MoESpec(d_model=2048, num_experts=128, top_k=8, d_ff_expert=768),
        subquadratic=False,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-reduced",
        arch_type="moe",
        source="hf:Qwen/Qwen3-30B-A3B",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        layers=uniform_layers(2),
        mlp_kind=None,
        moe=MoESpec(d_model=256, num_experts=4, top_k=2, d_ff_expert=128),
        q_chunk=64,
    )
