"""ChatGLM3 6B [dense]: GQA 32H/2kv, 2d (partial, rotary_frac=0.5) RoPE,
QKV bias. [arXiv:2406.12793]"""
from repro_torch.configs.base import ModelConfig, uniform_layers


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        arch_type="dense",
        source="arXiv:2406.12793",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=65024,
        layers=uniform_layers(28),
        mlp_kind="swiglu",
        rotary_frac=0.5,
        qkv_bias=True,
        subquadratic=False,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-reduced",
        arch_type="dense",
        source="arXiv:2406.12793",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        layers=uniform_layers(2),
        mlp_kind="swiglu",
        rotary_frac=0.5,
        qkv_bias=True,
        q_chunk=64,
    )
