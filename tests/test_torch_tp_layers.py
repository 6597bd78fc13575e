"""The model zoo's layers over a model axis (tp = 2 and 4) in the port
against the JAX reference's manual shard_map, on the CPU
(tests/tp_cases.py's LAYERS, run by tests/tp_harness.py: the reference
on four fake devices, the port on gloo ranks, side by side): attention
(tp 2 sequence-parallel; tp 4 with its KV heads on aligned pairs of
ranks, ``subgroup_psum``; 2 query heads duplicated over tp 4, with bias
and window), the MLP (tp 2 sequence-parallel, tp 4), MoE (experts over
tp 2, the replicated router, drops), the SSM (heads over tp 2, the
replicated B/C projection), and the vocab-parallel embedding and cross
entropy. Each case: the gathered output (the head: the loss), and on every rank
its synced parameter gradients (of ``loss / tp``, the train step's
arithmetic) and its input gradient.

The global parameters are the port's ``init_params(..., tp)`` (the
reference's layouts, duplicated slices repeated), held against the
reference's shapes in tests/test_torch_tp_ops.py.

Tolerances, tests/test_torch_lm_layers.py's: ``FWD_RTOL`` of the largest
output, ``GRAD_RTOL`` of the largest gradient (float32 einsums summed in
another order; at tp = 4 a psum over the model axis adds four partials
in gloo's order, not XLA's, inside the same bounds). A leaf duplicated
over the model axis has the same gradient, bit for bit, on every rank of
its group.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import pytest
import torch

import tp_cases
import tp_harness
from repro_torch.convert import leaves
from torch_tp_worker import layer

FWD_RTOL = 2e-6
GRAD_RTOL = 1e-5


def _inputs() -> dict:
    out = {}
    for k, (name, case) in enumerate(tp_cases.LAYERS.items()):
        rng = np.random.default_rng(100 + k)
        tp, B, S, D = case["tp"], case["B"], case["S"], tp_cases.D
        meta, _ = layer(case)
        if case["layer"] == "head":
            V = case["spec"]["vocab"]
            glob = {k_: rng.normal(size=m.shape).astype(np.float32) * 0.3
                    for k_, m in meta.items()}
            out[f"{name}/tokens"] = rng.integers(0, V, (B, S)).astype(np.int32)
            labels = rng.integers(0, V, (B, S)).astype(np.int32)
            labels[:, :3] = -1
            out[f"{name}/labels"] = labels
        else:
            glob = _init(case, tp)
        for k_, a in glob.items():
            out[f"{name}/{k_}"] = a
        out[f"{name}/x"] = rng.normal(size=(B, S, D)).astype(np.float32)
        out[f"{name}/r"] = rng.normal(size=(B, S, D)).astype(np.float32)
    return out


def _init(case, tp: int) -> dict:
    """The port's global parameters at ``tp``, as numpy (norm and bias
    leaves made nonzero, so that their gradients are exercised)."""
    from repro_torch.models import attention, mlp, moe, ssm

    g = torch.Generator().manual_seed(7)
    spec = dict(case["spec"])
    if case["layer"] == "attn":
        p = attention.init_params(g, attention.AttentionSpec(**spec), "cpu", tp)
    elif case["layer"] == "mlp":
        kind = spec.pop("kind")
        p = mlp.init_params(g, kind, spec["d_model"], spec["d_ff"], "cpu", tp)
    elif case["layer"] == "moe":
        p = moe.init_params(g, moe.MoESpec(**spec), "cpu", tp)
    else:
        p = ssm.init_params(g, ssm.SSMSpec(**spec), "cpu", tp)
    out = {k: v.numpy().copy() for k, v in p.items()}
    for k in ("bq", "bkv", "norm"):
        if k in out:
            out[k] = out[k] + 0.1  # duplicated copies stay equal
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_layers")
    src = tmp / "inputs.npz"
    np.savez(src, **_inputs())
    ref = tp_harness.reference("layers", src, tmp / "ref.npz")
    procs = [ref] + tp_harness.ranks("layers", 2, tmp, src) + tp_harness.ranks("layers", 4, tmp,
                                                                                 src)
    tp_harness.wait(procs)
    return tp_harness.load(tmp / "ref.npz"), tmp


@pytest.mark.parametrize("name", list(tp_cases.LAYERS))
def test_layer_matches_reference(runs, name):
    ref, tmp = runs
    case = tp_cases.LAYERS[name]
    tp = case["tp"]
    meta, _ = layer(case)
    metas = leaves(meta)
    port = [tp_harness.load(tmp / f"layers_tp{tp}_rank{r}.npz") for r in range(tp)]
    for r in range(tp):
        if case["layer"] == "head":  # the cross entropy is its output
            tp_harness.close(port[r][f"{name}/loss"], ref[f"{name}/loss"], FWD_RTOL,
                             f"rank {r} loss")
        else:
            tp_harness.close(port[r][f"{name}/y"], ref[f"{name}/y"], FWD_RTOL,
                             f"rank {r} output")
    want = np.concatenate([ref[f"{name}/grad{i}"].reshape(-1) for i in range(len(metas))])
    got = np.concatenate([np.stack([port[r][f"{name}/grad{i}"] for r in range(tp)]).reshape(-1)
                          for i in range(len(metas))])
    tp_harness.close(got, want, GRAD_RTOL, "synced parameter gradients, every rank")
    tp_harness.close(np.stack([port[r][f"{name}/gx"] for r in range(tp)]), ref[f"{name}/gx"],
                     GRAD_RTOL, "input gradients, every rank")
    for i, m in enumerate(metas):
        if m.sync > 1:
            g = min(m.sync, tp)
            for r in range(tp):
                np.testing.assert_array_equal(port[r][f"{name}/grad{i}"],
                                              port[r // g * g][f"{name}/grad{i}"])
