"""Gemma-3 4B [dense]: 5:1 local(SWA-1024):global attention, GeGLU, 128k ctx.
[hf:google/gemma-3-1b-pt family]"""
from repro_torch.configs.base import LayerSpec, ModelConfig

LOCAL_WINDOW = 1024
LOCAL_THETA = 10_000.0
GLOBAL_THETA = 1_000_000.0


def _pattern(n: int):
    # every 6th layer is global full attention; the rest are SWA-1024
    return tuple(
        LayerSpec("attn", window=None, rope_theta=GLOBAL_THETA)
        if (i + 1) % 6 == 0
        else LayerSpec("attn", window=LOCAL_WINDOW, rope_theta=LOCAL_THETA)
        for i in range(n)
    )


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        arch_type="dense",
        source="hf:google/gemma-3-1b-pt",
        num_layers=34,
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        layers=_pattern(34),
        mlp_kind="geglu",
        tie_embeddings=False,
        # eligible for long_500k: SWA local layers + seq-sharded
        # flash-decoding for the 1-in-6 global layers
        subquadratic=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b-reduced",
        arch_type="dense",
        source="hf:google/gemma-3-1b-pt",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        layers=(
            LayerSpec("attn", window=64, rope_theta=LOCAL_THETA),
            LayerSpec("attn", window=None, rope_theta=GLOBAL_THETA),
        ),
        mlp_kind="geglu",
        q_chunk=64,
        subquadratic=True,
    )
