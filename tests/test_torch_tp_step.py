"""The distributed LM train step at ``--mesh-shape 1x2`` (one client,
tensor-parallel over two gloo ranks) against the JAX reference's jitted
``make_train_step`` on two fake devices (tests/tp_step_check.py): a
reduced mamba2-370m (its B/C projection replicated over the model axis),
RQM, sgd, 2 steps, sequence parallel, from the reference's global
parameters at tp = 2 and its folded per-leaf seeds, held as
tests/test_torch_train_step.py holds tp = 1; the replicated leaves
bit-equal across the two ranks. On two more ranks, the launcher at 1x2
on reduced chatglm3-6b: plain == packed == ``1x1x2``, bit for bit; and
on reduced mamba2-370m 4 steps == checkpointed at 2 and resumed (sgd,
adam).
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import pytest

import tp_step_check

MESH = "1x2"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tp_step_check.run(tmp_path_factory.mktemp("tp_step"), MESH, "chatglm3-6b", "1x1x2")


def test_step_matches_reference(runs, record_property):
    ref, port, _, _ = runs
    tp_step_check.check(ref, port, record_property)


def test_step_replicated_leaves_equal_across_ranks(runs):
    for out in runs[2]:
        assert "leaves bit-equal across their groups" in out, out


def test_launcher_packed_and_spellings(runs):
    arch = "chatglm3-6b"
    for out in runs[3]:
        assert f"launch {arch} {MESH}: plain == packed" in out, out


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_launcher_resume(runs, opt):
    for out in runs[3]:
        assert f"resume {opt} at {MESH}: 4 steps == checkpointed at 2 and resumed" in out, out
