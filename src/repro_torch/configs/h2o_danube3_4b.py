"""H2O-Danube3 4B [dense]: llama/mistral-style, GQA 32H/8kv, sliding-window
attention (4096). [arXiv:2401.16818]"""
from repro_torch.configs.base import ModelConfig, uniform_layers

WINDOW = 4096


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        arch_type="dense",
        source="arXiv:2401.16818",
        num_layers=24,
        d_model=3840,
        num_heads=32,
        num_kv_heads=8,
        head_dim=120,
        d_ff=10240,
        vocab_size=32000,
        layers=uniform_layers(24, window=WINDOW),
        mlp_kind="swiglu",
        subquadratic=True,  # SWA everywhere -> long_500k eligible
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b-reduced",
        arch_type="dense",
        source="arXiv:2401.16818",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        layers=uniform_layers(2, window=64),
        mlp_kind="swiglu",
        q_chunk=64,
        subquadratic=True,
    )
