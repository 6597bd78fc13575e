"""Zamba2 1.2B [hybrid]: Mamba2 backbone + one SHARED attention block applied
every 6th layer (weight tying across applications). [arXiv:2411.15242]

Deviation noted in DESIGN.md: the shared attention block uses a 4096-token
sliding window so the architecture stays sub-quadratic at long_500k.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.ssm import SSMSpec

SHARED_EVERY = 6
ATTN_WINDOW = 4096


def _pattern(n: int, window):
    return tuple(
        LayerSpec("shared_attn", window=window)
        if (i + 1) % SHARED_EVERY == 0
        else LayerSpec("ssm")
        for i in range(n)
    )


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        arch_type="hybrid",
        source="arXiv:2411.15242",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=32000,
        layers=_pattern(38, ATTN_WINDOW),
        mlp_kind="swiglu",  # MLP of the shared attention block
        shared_attn=True,
        shared_d_ff=8192,
        ssm=SSMSpec(d_model=2048, state_dim=64, head_dim=64, expand=2),
        subquadratic=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-reduced",
        arch_type="hybrid",
        source="arXiv:2411.15242",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        layers=(LayerSpec("ssm"), LayerSpec("shared_attn", window=64)),
        mlp_kind="swiglu",
        shared_attn=True,
        shared_d_ff=512,
        ssm=SSMSpec(d_model=256, state_dim=16, head_dim=32, expand=2, chunk=32),
        q_chunk=64,
        subquadratic=True,
    )
