"""The distributed LM train step (``distributed/step.py``)."""
from repro_torch.distributed.step import (
    MeshPlan,
    build_train_step_fn,
    encode_aggregate_decode,
    make_plan,
    make_train_step,
    round_privacy,
    shard_seed_indices,
    train_seeds,
)

__all__ = ["MeshPlan", "make_plan", "make_train_step", "build_train_step_fn",
           "encode_aggregate_decode", "round_privacy", "shard_seed_indices", "train_seeds"]
