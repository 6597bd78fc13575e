"""The whole distributed LM train step of the port
(``distributed/step.py:build_train_step_fn``) against the JAX
reference's, jitted, on the CPU at tp = 1: a reduced mamba2-370m for 2
steps with sgd and adam (the MoE config is
tests/test_torch_train_step_moe.py), RQM at the reference's per-leaf
seeds, the reference's parameters carried over.

The two packages' gradients differ within tests/test_torch_lm_model.py's
tolerances, and the reference's jitted decode and update contract into
FMAs, so:

  * the loss of each step within ``LOSS_RTOL``;
  * every parameter within a tolerance a step of the reference's (sgd: one
    ulp of the decode's ``lr * 2 x_max`` plus one of the parameter, as
    tests/test_torch_optimizers.py bounds the jitted decode + apply;
    adam: ``ADAM_RTOL`` of the parameter plus the steps' ``lr``), but at
    no more than ``MOVED_FRAC`` of the coordinates, where a rounding draw
    that sits on its threshold moves a level; each such coordinate
    within ``MOVED_LEVELS`` decoded levels a step (adam: 2 lr a step).
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import mechanisms as jmechs
from repro.data.lm import TokenPipeline as JaxTokenPipeline
from repro.distributed import step as jstep
from repro.models import model as jmodel
from repro.models.common import ParallelCtx as JaxParallelCtx
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import schedules as jschedules
from repro_torch.configs import registry
from repro_torch.convert import leaves, tree_from_numpy
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.distributed import step as tstep
from repro_torch.models.common import ParallelCtx
from repro_torch.optim import make_optimizer, schedules
from test_torch_train_encode import leaf_seeds

SEQ, BATCH, STEPS = 32, 2, 2
SPEC = "rqm:c=0.02,m=16,q=0.42"
LR = 0.2
LOSS_RTOL = 1e-5
ADAM_RTOL = 1e-6
MOVED_FRAC = 1e-4
MOVED_LEVELS = 2


def check_train_step(arch: str, opt_name: str, record_property) -> None:
    jcfg, cfg = jregistry.get_config(arch, reduced=True), registry.get_config(arch, reduced=True)
    jparams = jax.jit(lambda k: jmodel.init_params(k, jcfg))(jax.random.key(2))
    pipe = JaxTokenPipeline(jcfg, SEQ, BATCH, seed=4)
    batches = [pipe.batch(t) for t in range(STEPS)]
    keys = list(jax.random.split(jax.random.key(9), STEPS))
    # the reference, jitted
    jopt = jax_make_optimizer(opt_name)
    jstep_fn = jax.jit(jstep.build_train_step_fn(
        jcfg, jmechs.make_mechanism(SPEC), jopt, jschedules.constant(LR), JaxParallelCtx(),
        remat=False, compute_dtype=jnp.float32))
    want, jstate, want_losses = jparams, jopt.init(jparams), []
    for t, (batch, key) in enumerate(zip(batches, keys)):
        want, jstate, m = jstep_fn(want, jstate, jnp.int32(t),
                                   {k: jnp.asarray(v) for k, v in batch.items()}, key)
        want_losses.append(float(m["loss"]))
    # the port, at the seeds the reference derives
    mech, opt = make_mechanism(SPEC), make_optimizer(opt_name)
    step_fn = tstep.build_train_step_fn(cfg, mech, opt, schedules.constant(LR, device="cpu"),
                                        ParallelCtx())
    params = tree_from_numpy(jax.device_get(jparams), "cpu")
    state, losses = opt.init(params), []
    n = len(leaves(params))
    for t, (batch, key) in enumerate(zip(batches, keys)):
        params, state, metrics = step_fn(params, state, t,
                                         {k: torch.from_numpy(v) for k, v in batch.items()},
                                         leaf_seeds(key, n))
        assert set(metrics) == {"loss", "ce_loss", "moe_aux_loss"}
        assert all(v.shape == () for v in metrics.values())
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    if opt_name == "adam":
        assert int(state["t"]) == STEPS
    got = np.concatenate([p.numpy().reshape(-1) for p in leaves(params)])
    ref = np.concatenate([np.asarray(w).reshape(-1) for w in jax.tree_util.tree_leaves(want)])
    x_max = mech.params.x_max
    if opt_name == "adam":
        tol = ADAM_RTOL * (np.abs(ref) + STEPS * LR)
        jump = 2 * LR * STEPS
    else:
        tol = STEPS * (LR * np.spacing(np.float32(2 * x_max)) + np.spacing(np.abs(ref)))
        jump = STEPS * MOVED_LEVELS * LR * 2 * x_max / (mech.params.m - 1)
    diff = np.abs(got - ref)
    moved = diff > tol
    record_property("moved_coordinates", int(moved.sum()))
    assert moved.sum() <= MOVED_FRAC * got.size, int(moved.sum())
    assert diff.max() <= jump


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_train_step_matches_reference(opt_name, record_property):
    check_train_step("mamba2-370m", opt_name, record_property)
