"""The port's EMNIST task and Algorithm-1 round (src/repro_torch/fed)
against the JAX reference on the CPU, at the suite's small problem (24
clients, cohorts of 6).

  * data: identical arrays for identical seeds;
  * CNN: loss and per-client clipped gradients at the reference's initial
    parameters (carried over with ``tree_from_numpy``), allclose at
    rtol 1e-5, atol 1e-6;
  * one round handed the reference round's clipped gradient stack, cohort
    and ``key_to_seed(k_enc)``: the SecAgg sum exact, the parameters
    within the reference's 1-ULP bound of its jitted round and equal to
    its literal decode+apply expression (0 ULP);
  * one round end to end from the same parameters, cohort and seed (the
    port computes its own gradients): the sum differs in fewer than 0.1%
    of coordinates, by at most one level each (the measured counts are
    recorded as JUnit properties);
  * inside the port, packed and dense wires train bit-identically.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import ast
import dataclasses
import inspect
import math
import os
import re

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as jwire
from repro.core.grid import RQMParams as JaxRQMParams
from repro.core.mechanisms import make_mechanism as jax_make_mechanism
from repro.data.emnist import SyntheticEMNIST as JaxEMNIST
from repro.data.federated import FederatedPartition as JaxPartition
from repro.fed import cnn as jcnn
from repro.fed import cohort as jcohort
from repro.fed import rounds as jrounds
from repro.fed.config import FedConfig as JaxFedConfig
from repro.fed.trainer import FedTrainer as JaxFedTrainer
from repro.kernels import decode_apply_kernel as jdecode
from repro.kernels import ops as jops
from repro_torch.convert import ravel, tree_from_numpy
from repro_torch.core import wire
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.data.emnist import SyntheticEMNIST
from repro_torch.data.federated import FederatedPartition
from repro_torch.fed import cnn, rounds, trainer as trainer_mod
from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer
from repro_torch.kernels import ops

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SMALL = dict(num_clients=24, clients_per_round=6, lr=1.0, eval_size=64,
             samples_per_client=8)
SPEC = "rqm:c=0.05,m=16,q=0.42"
# the fused, packed round the reference replays below (FedConfig() is the
# materialized round: tests/test_torch_materialized.py)
FUSED = dict(engine="perround", fused_rounds=True)
N_DIFF_MAX = 0.001  # share of coordinates whose end-to-end sum may differ


def _ulps(a, b) -> int:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


@pytest.fixture(scope="module")
def reference_round():
    """One perround round of the reference on the small problem (fused,
    packed wire), with everything needed to replay it."""
    jtr = JaxFedTrainer(jax_make_mechanism(SPEC),
                        JaxFedConfig(engine="perround", fused_rounds=True,
                                     collect_sums=True, **SMALL))
    flat0 = np.asarray(jtr.flat)
    params0 = jax.device_get(jtr.params)
    _, k_sample, k_enc = jax.random.split(jtr._key, 3)
    ids, _ = jcohort.sample_slate(jtr.cfg, jtr.slate, k_sample)
    grads = jax.vmap(jtr._client_grad, in_axes=(None, 0))(
        jtr.flat, jrounds.index_batch(jtr.client_data, ids))
    jtr.round()
    out = {
        "flat0": flat0, "params0": params0, "ids": np.asarray(ids),
        "seed": int(np.asarray(jops.key_to_seed(k_enc))),
        "grads": np.asarray(grads), "flat1": np.asarray(jtr.flat),
        "sum": np.asarray(jtr.round_sums[-1]),
        "pack_bits": jrounds.hot_path_pack_bits(jtr.mech, jtr.cfg, jtr.slate),
        "client_data": {k: np.asarray(v) for k, v in jtr.client_data.items()},
        "eval": (np.asarray(jtr.task.eval_images), np.asarray(jtr.task.eval_labels)),
    }
    # writable copies: torch.from_numpy warns on JAX's read-only buffers
    return jax.tree_util.tree_map(np.array, out)


@pytest.fixture(scope="module")
def port_trainer(reference_round):
    """The port's trainer on the small problem, started from the
    reference's initial parameters."""
    tr = FedTrainer(SPEC, FedConfig(collect_sums=True, **FUSED, **SMALL), device="cpu")
    tr.flat, _ = ravel(tree_from_numpy(reference_round["params0"], device="cpu"))
    return tr


# ---------------------------------------------------------------------------
# data, layout, model
# ---------------------------------------------------------------------------


def test_data_matches_reference(reference_round, port_trainer):
    np.testing.assert_array_equal(SyntheticEMNIST(seed=3).prototypes,
                                  JaxEMNIST(seed=3).prototypes)
    for a, b in zip(SyntheticEMNIST(seed=1).make_split(seed=5, size=40),
                    JaxEMNIST(seed=1).make_split(seed=5, size=40)):
        np.testing.assert_array_equal(a, b)
    port, ref = FederatedPartition(num_clients=50, seed=2), JaxPartition(num_clients=50, seed=2)
    for cid in (0, 17, 49):
        for a, b in zip(port.client_data(cid), ref.client_data(cid)):
            np.testing.assert_array_equal(a, b)
    for k, v in reference_round["client_data"].items():
        np.testing.assert_array_equal(port_trainer.client_data[k].numpy(), v)
    np.testing.assert_array_equal(port_trainer.task.eval_images.numpy(),
                                  reference_round["eval"][0])


def test_flat_layout_matches_ravel_pytree(reference_round):
    params = tree_from_numpy(reference_round["params0"], device="cpu")
    flat, unravel = ravel(params)
    assert flat.shape == (222_030,)
    np.testing.assert_array_equal(flat.numpy(), reference_round["flat0"])
    for k, v in unravel(flat).items():
        assert torch.equal(v, params[k])
    with pytest.raises(ValueError):
        unravel(flat[:-1])


def test_cnn_loss_and_client_grads_match_reference(reference_round, port_trainer):
    ids = reference_round["ids"]
    data = reference_round["client_data"]
    params_j = reference_round["params0"]
    params_t = tree_from_numpy(params_j, device="cpu")
    im, lb = data["images"][ids[0]], data["labels"][ids[0]]
    want = float(jcnn.cnn_loss(params_j, im, lb))
    got = float(cnn.cnn_loss(params_t, torch.from_numpy(im), torch.from_numpy(lb)))
    assert math.isclose(got, want, rel_tol=1e-5, abs_tol=1e-6)
    acc = float(cnn.cnn_accuracy(params_t, torch.from_numpy(im), torch.from_numpy(lb)))
    assert acc == float(jcnn.cnn_accuracy(params_j, im, lb))
    flat = torch.from_numpy(reference_round["flat0"])
    batch = {k: torch.from_numpy(v[ids]) for k, v in data.items()}
    grads = port_trainer.client_grads(flat, batch)
    assert grads.shape == (len(ids), flat.numel())
    np.testing.assert_allclose(grads.numpy(), reference_round["grads"], rtol=1e-5, atol=1e-6)
    # and the unclipped gradient of one client
    g_ref = jax.grad(jcnn.cnn_loss)(params_j, im, lb)
    g_ref, _ = jax.flatten_util.ravel_pytree(g_ref)
    g = torch.func.grad(lambda f: cnn.cnn_loss(port_trainer.unravel(f), batch["images"][0],
                                               batch["labels"][0]))(flat)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# one round against the reference
# ---------------------------------------------------------------------------


def test_round_with_reference_grads_is_exact(reference_round, port_trainer, record_property):
    ref = reference_round
    tr = port_trainer
    assert tr.pack_bits == ref["pack_bits"] == 7
    handed = torch.from_numpy(ref["grads"])
    step = rounds.make_round_step(tr.mech, tr.cfg, tr.slate, lambda flat, batch: handed)
    new, _, z_sum = step(torch.from_numpy(ref["flat0"]), (), tr.client_data,
                         ids=ref["ids"], seed=ref["seed"])
    np.testing.assert_array_equal(z_sum.numpy(), ref["sum"])
    # XLA:CPU contracts the jitted round's decode+apply into FMAs; the
    # port rounds every operation, as the literal jnp expression does. So
    # it meets the jitted round within the reference's 1-ULP bound
    # (tests/test_fused_round_kernel.py) and the literal one exactly. The
    # measured spread goes into the JUnit report.
    got, want = new.numpy(), ref["flat1"]
    record_property("params_differing_from_jitted_round", int(np.count_nonzero(got != want)))
    record_property("max_abs_diff_from_jitted_round", float(np.abs(got - want).max()))
    params = tr.mech.params
    tol = (tr.cfg.lr * np.spacing(np.float32(2.0 * params.x_max))
           + np.spacing(np.maximum(np.abs(got), np.abs(ref["flat0"])).astype(np.float32)))
    assert np.all(np.abs(got - want) <= tol)
    words = jwire.pack_bits_np(ref["sum"], tr.pack_bits)
    literal = jdecode.decode_apply_sum(
        jnp.asarray(ref["flat0"]), jnp.asarray(words),
        JaxRQMParams(params.c, params.delta, params.m, params.q),
        tr.cfg.clients_per_round, tr.cfg.lr, pack_bits=tr.pack_bits)
    assert _ulps(got, np.asarray(literal)) == 0


def test_round_end_to_end_close_to_reference(reference_round, port_trainer, record_property):
    """The port's own gradients differ from XLA's in the last float bits,
    and RQM's rounding can turn such a difference into a one-level change.
    The measured counts go into the JUnit report."""
    ref = reference_round
    tr = port_trainer
    step = rounds.make_round_step(tr.mech, tr.cfg, tr.slate, tr.client_grads)
    new, _, z_sum = step(torch.from_numpy(ref["flat0"]), (), tr.client_data,
                         ids=ref["ids"], seed=ref["seed"])
    diff = np.abs(z_sum.numpy().astype(np.int64) - ref["sum"])
    grads = tr.client_grads(torch.from_numpy(ref["flat0"]),
                            rounds.index_batch(tr.client_data, torch.as_tensor(ref["ids"])))
    record_property("grad_entries_differing", int(np.count_nonzero(grads.numpy() != ref["grads"])))
    record_property("sum_coords_differing", int(np.count_nonzero(diff)))
    assert diff.max() <= 1
    assert np.count_nonzero(diff) < N_DIFF_MAX * diff.size
    assert np.all(np.isfinite(new.numpy()))


# ---------------------------------------------------------------------------
# the port's trainer
# ---------------------------------------------------------------------------


def _train(rounds_, **overrides):
    tr = FedTrainer(SPEC, FedConfig(collect_sums=True, **{**FUSED, **SMALL, **overrides}),
                    device="cpu")
    tr.train(rounds=rounds_, eval_every=rounds_, log=lambda msg: None)
    return tr


def test_packed_and_dense_wire_train_identically():
    ops.reset_launches()
    packed, dense = _train(2), _train(2, wire_packed=False)
    assert packed.pack_bits == 7 and dense.pack_bits is None
    assert torch.equal(packed.flat, dense.flat)
    for a, b in zip(packed.round_sums, dense.round_sums):
        np.testing.assert_array_equal(a, b)
    assert len(packed.round_sums) == 2
    assert dict(ops.launches) == {}  # CPU: plain versions only
    want = 2 * packed.mech.per_round_epsilon(6, 8.0)
    assert math.isclose(packed.accountant.rdp_epsilon(8.0), want, rel_tol=1e-12)
    assert packed.accountant.rounds == 2
    metrics = packed.evaluate()
    assert set(metrics) == {"accuracy", "loss"} and math.isfinite(metrics["loss"])


def test_cohort_stream_is_reproducible():
    a, b = _train(1), _train(1)
    assert torch.equal(a.flat, b.flat)
    assert not torch.equal(a.flat, _train(1, seed=1).flat)


def test_wire_width_selection():
    mech = make_mechanism(SPEC)
    cfg = FedConfig(fused_rounds=True)
    assert rounds.hot_path_pack_bits(mech, FedConfig(), 40) is None  # materialized
    assert rounds.hot_path_pack_bits(mech, cfg, 40) == 10
    assert wire.packed_words(222_030, 10) == 74_010
    assert rounds.hot_path_pack_bits(mech, dataclasses.replace(cfg, wire_packed=False), 40) is None
    with pytest.raises(ValueError, match="bit-packing unsafe"):
        rounds.hot_path_pack_bits(mech, dataclasses.replace(cfg, wire_packed=True), 5000)
    assert rounds.hot_path_pack_bits(mech, cfg, 5000) is None


@pytest.mark.parametrize("overrides,match", [
    # the shard engine's 2-D grid needs a task with a model axis
    pytest.param(dict(engine="shard", model_shards=2), "supports_model_axis",
                 id="engine=shard"),
    # the lm task has one; its grid needs shards x model_shards ranks
    # (tests/test_torch_tp_fed.py starts them)
    pytest.param(dict(task="lm:seq_len=16,batch=1", engine="shard", model_shards=2),
                 r"wants 2 ranks", id="task=lm"),
])
def test_unported_options_raise(overrides, match):
    with pytest.raises(ValueError, match=match):
        FedTrainer(SPEC, FedConfig(**{**SMALL, **overrides}), device="cpu")


def test_cnn_init_defaults_to_the_card():
    assert inspect.signature(cnn.cnn_init).parameters["device"].default == "cuda"
    params = cnn.cnn_init(torch.Generator().manual_seed(0), device="cpu")
    assert {v.device.type for v in params.values()} == {"cpu"}


def test_cuda_requested_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer_mod.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        FedTrainer(SPEC, FedConfig(**SMALL))  # the default device is cuda
    assert trainer_mod.resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------


def _port_sources():
    pkg = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_neither_jax_nor_reference():
    banned = re.compile(r"^(jax|jaxlib|repro)(\.|$)")
    sources = list(_port_sources())
    assert len(sources) > 20
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert not banned.match(name), f"{path} imports {name}"
