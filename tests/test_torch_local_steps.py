"""``local_steps > 1`` (FedAvg-RQM) in the port: each client releases the
clipped negative delta ``flat - flat_new`` of ``local_steps`` SGD steps
at ``local_lr`` (``fed/rounds.py:make_client_grad``), against the JAX
reference on the CPU.

Contracts:
  * the port's delta stack, from the reference's initial parameters, is
    within 2e-7 of the reference's (the gradient tolerance of
    tests/test_torch_shard.py: the reference's own jitted and eager
    gradients sit that far apart), and differs from the one-step gradient;
  * handed the reference's delta stack, cohort and seed, the port's
    round gives the reference's encoded SecAgg sum of that stack exactly,
    materialized and fused, and its literal decode + SGD;
  * the port's scan == perround, and fused == materialized, bit for bit;
    ``local_steps=1`` is Algorithm 1's single clipped gradient.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mechanisms as jmechs
from repro.fed import cohort as jcohort
from repro.fed import rounds as jrounds
from repro.fed.config import FedConfig as JaxFedConfig
from repro.fed.trainer import FedTrainer as JaxFedTrainer
from repro.kernels import ops as jops
from repro.optim import sgd as jax_sgd
from repro_torch.convert import ravel, tree_from_numpy
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.fed import rounds
from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer

SMALL = dict(num_clients=24, clients_per_round=4, lr=1.0, eval_size=64,
             samples_per_client=8, local_steps=3, local_lr=0.1)
SPEC = "rqm:c=0.05,m=16,q=0.42"
# the engines' own agreement needs no exact reference: the cheaper encode
ENGINE_SPEC = "qmgeo:c=0.05,m=16,r=0.6"
GRAD_ATOL = 2e-7


@pytest.fixture(scope="module")
def reference_local_round():
    """One perround, materialized round of the reference with local steps,
    and its delta stack by eager ``vmap``."""
    jtr = JaxFedTrainer(jmechs.make_mechanism(SPEC),
                        JaxFedConfig(engine="perround", collect_sums=True, **SMALL))
    _, k_sample, k_enc = jax.random.split(jtr._key, 3)
    ids, _ = jcohort.sample_slate(jtr.cfg, jtr.slate, k_sample)
    batch = jrounds.index_batch(jtr.client_data, ids)
    deltas = jax.vmap(jtr._client_grad, in_axes=(None, 0))(jtr.flat, batch)
    z = jtr.mech.quantize_batch(deltas, k_enc)
    flat0 = np.array(jtr.flat)
    jtr.round()
    enc_sum = np.array(jnp.sum(z, axis=0, dtype=z.dtype))
    g_hat = jtr.mech.decode_sum(jnp.asarray(enc_sum), jtr.cfg.clients_per_round)
    literal, _ = jax_sgd().update(g_hat, (), jnp.asarray(flat0), jtr.cfg.lr)
    return {"ids": np.array(ids), "seed": int(np.asarray(jops.key_to_seed(k_enc))),
            "deltas": np.array(deltas), "flat0": flat0, "params0": jax.device_get(jtr.params),
            "batch": {k: np.array(v) for k, v in batch.items()},
            "round_sum": np.array(jtr.round_sums[-1]), "enc_sum": enc_sum,
            "literal": np.array(literal)}


def test_delta_stack_matches_reference(reference_local_round, record_property):
    ref = reference_local_round
    tr = FedTrainer(SPEC, FedConfig(engine="perround", **SMALL), device="cpu")
    flat, _ = ravel(tree_from_numpy(ref["params0"], device="cpu"))
    np.testing.assert_array_equal(flat.numpy(), ref["flat0"])
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    deltas = tr.client_grads(flat, batch)
    assert deltas.shape == ref["deltas"].shape
    np.testing.assert_allclose(deltas.numpy(), ref["deltas"], rtol=0, atol=GRAD_ATOL)
    record_property("max_abs_delta_diff", float(np.abs(deltas.numpy() - ref["deltas"]).max()))
    assert float(deltas.abs().max()) <= np.float32(tr.mech.clip)
    one_step = rounds.make_client_grad(tr.mech, tr.unravel, tr.task)(flat, batch)
    assert not torch.allclose(deltas, one_step)
    # local_steps=1 is the single clipped gradient
    one = FedConfig(**{**SMALL, "local_steps": 1})
    assert torch.equal(rounds.make_client_grad(tr.mech, tr.unravel, tr.task, one)(flat, batch),
                       one_step)


@pytest.mark.parametrize("fused", [False, True], ids=["materialized", "fused packed"])
def test_reference_delta_stack_gives_its_exact_sum(reference_local_round, fused,
                                                   record_property):
    ref = reference_local_round
    cfg = FedConfig(engine="perround", collect_sums=True, fused_rounds=fused, **SMALL)
    mech = make_mechanism(SPEC)
    handed = torch.from_numpy(ref["deltas"])
    step = rounds.make_round_step(mech, cfg, 4, lambda flat, batch: handed)
    new, _, z_sum = step(torch.from_numpy(ref["flat0"]), (), {"ids": torch.arange(24)},
                         ids=ref["ids"], seed=ref["seed"])
    np.testing.assert_array_equal(z_sum.numpy(), ref["enc_sum"])
    np.testing.assert_array_equal(new.numpy(), ref["literal"])
    # the reference's jitted round computes its own deltas: measured, not gated
    record_property("round_sum_coords_differing_from_jitted_round",
                    int(np.count_nonzero(ref["round_sum"] != ref["enc_sum"])))


@pytest.mark.parametrize("fused", [False, True], ids=["materialized", "fused"])
def test_scan_equals_perround(fused):
    runs = {}
    for engine in ("scan", "perround"):
        tr = FedTrainer(ENGINE_SPEC, FedConfig(engine=engine, collect_sums=True,
                                               fused_rounds=fused, **SMALL), device="cpu")
        tr.train(3, eval_every=3, log=lambda msg: None)
        runs[engine] = tr
    a, b = runs["scan"], runs["perround"]
    assert torch.equal(a.flat, b.flat)
    for x, y in zip(a.round_sums, b.round_sums):
        np.testing.assert_array_equal(x, y)
    if fused:
        plain = FedTrainer(ENGINE_SPEC, FedConfig(collect_sums=True, **SMALL), device="cpu")
        plain.train(3, eval_every=3, log=lambda msg: None)
        assert torch.equal(plain.flat, a.flat)
