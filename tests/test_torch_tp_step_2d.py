"""The distributed LM train step at ``--mesh-shape 2x2`` (two clients,
each tensor-parallel over two gloo ranks; the levels summed over the
ranks of a model index) against the JAX reference's jitted
``make_train_step`` on four fake devices (tests/tp_step_check.py),
held as tests/test_torch_tp_step.py holds 1x2; on four more ranks the
launcher at 2x2 on reduced mamba2-370m: plain == packed == the ``PxDxM``
plan ``1x2x2``, bit for bit.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import pytest

import tp_step_check

MESH = "2x2"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tp_step_check.run(tmp_path_factory.mktemp("tp_step_2d"), MESH, "mamba2-370m", "1x2x2")


def test_step_matches_reference(runs, record_property):
    ref, port, _, _ = runs
    tp_step_check.check(ref, port, record_property)


def test_step_replicated_leaves_equal_across_ranks(runs):
    for out in runs[2]:
        assert "leaves bit-equal across their groups" in out, out


def test_launcher_packed_and_pxdxm(runs):
    arch = "mamba2-370m"
    for out in runs[3]:
        assert f"launch {arch} {MESH}: plain == packed == ['1x2x2']" in out, out
