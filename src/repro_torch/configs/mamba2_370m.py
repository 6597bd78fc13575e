"""Mamba2 370M [ssm]: attention-free SSD (state-space duality).
[arXiv:2405.21060]"""
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.ssm import SSMSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        arch_type="ssm",
        source="arXiv:2405.21060",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,  # padded per tp at build time (50280 % 16 != 0)
        layers=tuple(LayerSpec("ssm") for _ in range(48)),
        mlp_kind=None,
        ssm=SSMSpec(d_model=1024, state_dim=128, head_dim=64, expand=2),
        subquadratic=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-reduced",
        arch_type="ssm",
        source="arXiv:2405.21060",
        num_layers=2,
        d_model=256,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=512,
        layers=tuple(LayerSpec("ssm") for _ in range(2)),
        mlp_kind=None,
        ssm=SSMSpec(d_model=256, state_dim=32, head_dim=32, expand=2, chunk=32),
        subquadratic=True,
    )
