"""The whole distributed LM train step of the port against the JAX
reference's on a reduced MoE config (qwen3-moe-30b-a3b), 2 steps with sgd
and adam, within tests/test_torch_train_step.py's tolerances (its
``check_train_step``; a file of its own, so that each file stays short
under the tier-1 run's workers)."""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import pytest

from test_torch_train_step import check_train_step


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_moe_train_step_matches_reference(opt_name, record_property):
    check_train_step("qwen3-moe-30b-a3b", opt_name, record_property)
