"""An lm round of the port against the JAX reference on the CPU, from a
handed gradient stack (ROADMAP C5: the gradients themselves are held
within a tolerance, so the round replays the reference's):

  * the reference's parameters of the reduced mamba2-370m carried over
    (``tree_from_numpy``); its per-client clipped gradients of four
    clients' token batches (``jax.vmap(jax.grad(LmTask.loss))``) and the
    port's (``rounds.make_client_grad``) within ``GRAD_RTOL`` of the
    largest;
  * the port's materialized round step, handed the reference's stack and
    the golden ``kernel_seed_u32``: its SecAgg sum equals the reference's
    RQM encode of that stack (``rqm_encode_counters``, run op by op) bit
    for bit, and its parameters the reference's decode + SGD exactly;
    the fused dense and packed round sums equal it too;
  * the reference's jitted fused twin (``round_sum_jnp``) on the same
    stack, where it differs from its own op-by-op encode, differs only
    there: XLA:CPU contracts ``-x_max + i * step`` into an FMA, which
    moves a rounding draw that sits on its threshold (ROADMAP C6);
  * the lm task's eval on the reference's parameters within ``LOSS_RTOL``.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import mechanisms as jmechs
from repro.fed import tasks as jtasks
from repro.fed.config import FedConfig as JaxFedConfig
from repro.kernels import fused_round_kernel as jfused
from repro.kernels import rqm_kernel as jrqm
from repro.optim.optimizers import sgd as jax_sgd
from repro_torch.convert import ravel, tree_from_numpy
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.fed import rounds
from repro_torch.fed.config import FedConfig
from repro_torch.fed.tasks import make_task

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "golden", "encoded_sums.json")) as f:
    KERNEL_SEED = json.load(f)["kernel_seed_u32"]
LM_TASK = "lm:model=mamba2-370m,seq_len=16,batch=1"
LM_FED = dict(num_clients=8, clients_per_round=4, lr=0.5, samples_per_client=8, task=LM_TASK)
SPEC = "rqm:c=0.02,m=16,q=0.42"
IDS = np.array([5, 1, 6, 2])  # a cohort of 4 of the 8 clients
GRAD_RTOL = 1e-5
LOSS_RTOL = 2e-6


@pytest.fixture(scope="module")
def reference():
    """The reference's parameters, the cohort's clipped gradient stack,
    its op-by-op RQM sum at the golden seed, and that sum decoded and
    applied by its literal SGD."""
    jt = jtasks.make_task(LM_TASK, JaxFedConfig(**LM_FED))
    jparams = jax.jit(jt.init_params)(jax.random.key(3))
    jflat, junravel = ravel_pytree(jparams)
    batches = [jt.client_batch(int(i)) for i in IDS]
    batch = {k: jnp.asarray(np.stack([b[k] for b in batches])) for k in batches[0]}
    jmech = jmechs.make_mechanism(SPEC)
    grads = jax.jit(jax.vmap(jax.grad(lambda f, b: jt.loss(junravel(f), b)),
                             in_axes=(None, 0)))(jflat, batch)
    clipped = np.array(jnp.clip(grads, -jmech.clip, jmech.clip))
    rows, dim = clipped.shape
    with jax.disable_jit():  # op by op: no float contraction
        levels = jrqm.rqm_encode_counters(
            jnp.asarray(clipped), jnp.uint32(KERNEL_SEED),
            jnp.arange(rows * dim, dtype=jnp.uint32).reshape(rows, dim), jmech.params)
    z_sum = np.asarray(levels).sum(0).astype(np.int32)
    g_hat = jmech.decode_sum(jnp.asarray(z_sum), rows)
    literal, _ = jax_sgd().update(g_hat, (), jflat, LM_FED["lr"])
    return {"params": jax.device_get(jparams), "flat0": np.array(jflat),
            "raw": np.asarray(grads), "grads": clipped, "sum": z_sum,
            "literal": np.asarray(literal), "mech": jmech}


def test_client_gradients_match_reference(reference):
    task = make_task(LM_TASK, FedConfig(**LM_FED), "cpu")
    flat, unravel = ravel(tree_from_numpy(reference["params"], "cpu"))
    np.testing.assert_array_equal(flat.numpy(), reference["flat0"])
    batches = [task.client_batch(int(i)) for i in IDS]
    batch = {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}
    # the unclipped per-client gradients: clipping is exact on equal inputs
    none = make_mechanism("none:c=1e30")
    got = rounds.make_client_grad(none, unravel, task)(flat, batch).numpy()
    want = reference["raw"]
    assert got.shape == want.shape == (4, 1_096_032)
    err = np.abs(got - want).max(axis=1)
    assert np.all(err <= GRAD_RTOL * np.abs(want).max(axis=1)), err
    mech = make_mechanism(SPEC)
    assert np.abs(rounds.make_client_grad(mech, unravel, task)(flat, batch).numpy()).max() \
        <= mech.clip


@pytest.mark.parametrize("path", ["materialized", "fused dense", "fused packed"])
def test_handed_round_matches_reference(reference, path):
    mech = make_mechanism(SPEC)
    cfg = FedConfig(engine="perround", collect_sums=True, **LM_FED)
    if path != "materialized":
        cfg = dataclasses.replace(cfg, fused_rounds=True,
                                  wire_packed=None if path == "fused packed" else False)
    assert (rounds.hot_path_pack_bits(mech, cfg, 4) is not None) == (path == "fused packed")
    handed = torch.from_numpy(reference["grads"])
    step = rounds.make_round_step(mech, cfg, 4, lambda flat, batch: handed)
    data = {"ids": torch.arange(LM_FED["num_clients"])}
    new, _, z_sum = step(torch.from_numpy(reference["flat0"]), (), data, ids=IDS,
                         seed=KERNEL_SEED)
    np.testing.assert_array_equal(z_sum.numpy(), reference["sum"])
    # decode + SGD (fused: the decode-apply kernel's plain version) as the
    # reference's literal expression
    np.testing.assert_array_equal(new.numpy(), reference["literal"])


def test_reference_jitted_twin_differs_only_at_contracted_draws(reference, record_property):
    """The reference's own jitted fused twin against its op-by-op encode:
    equal but where XLA:CPU's FMA contraction of the level value moves a
    rounding draw that sits on its threshold (recorded, at most 1 in
    100,000 coordinates)."""
    jmech = reference["mech"]
    twin = np.asarray(jfused.round_sum(jnp.asarray(reference["grads"]),
                                       jnp.uint32(KERNEL_SEED), jmech.params, "rqm"))
    differ = np.flatnonzero(twin != reference["sum"])
    record_property("coordinates_moved_by_contraction", int(differ.size))
    assert differ.size <= reference["sum"].size // 100_000
    for c in differ:  # one client's draw moved across one bracket: i_hi - i_lo
        assert 0 < abs(int(twin[c]) - int(reference["sum"][c])) <= jmech.params.m - 1


def test_lm_evaluate_matches_reference(reference):
    """The task's eval on the reference's parameters, carried over."""
    jt = jtasks.make_task(LM_TASK, JaxFedConfig(**LM_FED))
    jflat, junravel = ravel_pytree(reference["params"])
    want = jt.evaluate(jflat, junravel)
    t = make_task(LM_TASK, FedConfig(**LM_FED), "cpu")
    flat, unravel = ravel(tree_from_numpy(reference["params"], "cpu"))
    got = t.evaluate(flat, unravel)
    assert set(got) == set(want) == {"loss", "ppl", "eval_tokens"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["ppl"], np.exp(got["loss"]), rtol=1e-12)
    assert got["eval_tokens"] == want["eval_tokens"]
