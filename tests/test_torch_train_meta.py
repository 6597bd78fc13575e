"""The LM train step's parts that hold no kernel, against the JAX
reference on the CPU:

  * the learning-rate schedules (``optim/schedules.py``) at every step of
    three settings, against the reference run op by op: bit for bit,
    but where torch's float32 ``cos`` and XLA's differ (recorded): there
    the reference's ``cos`` put into the port's arithmetic gives the
    reference's rate bit for bit, so nothing else differs;
  * ``param_meta`` of all ten reduced configs (and the full ones' counts)
    field for field: shape, dtype name, pspec, sync; its leaf order is
    ``convert.leaves(init_params(...))``'s; ``param_count`` and
    ``param_bytes`` equal the reference's;
  * the optimizers' tree update (sgd, momentum, adam with a 0-d rate
    tensor): equal to the flat update of the raveled tree bit for bit,
    one ``t`` for the tree, and to the reference's ``tree_map`` within
    tests/test_torch_optimizers.py's tolerances;
  * the client half of ``ParallelCtx`` and ``MeshPlan``: a model axis
    without its process group refused (with ``sp_compress`` too); a
    one-rank gloo plan's psum/pmean;
  * ``fed/loop.py`` re-exports the trainer's names.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import registry as jregistry
from repro.models import meta as jmeta
from repro.models import model as jmodel
from repro.optim import schedules as jschedules
from repro_torch import optim
from repro_torch.configs import registry
from repro_torch.convert import leaves, ravel
from repro_torch.distributed import step as tstep
from repro_torch.models import meta, model
from repro_torch.models.common import ParallelCtx
from repro_torch.optim import schedules

SCHEDULES = [(0.2, 11, 100, 0.1),   # the launcher's at --steps 100
             (0.5, 16, 150, 0.1),   # the example's at --steps 150
             (1e-3, 1, 400, 0.05)]
ADAM_RTOL = 1e-6  # tests/test_torch_optimizers.py's tolerances


def _ulps(a, b) -> np.ndarray:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("kind", ["warmup_cosine", "cosine_decay"])
@pytest.mark.parametrize("setting", SCHEDULES, ids=lambda s: f"lr{s[0]}-wu{s[1]}-T{s[2]}")
def test_schedule_matches_reference(kind, setting, record_property):
    lr, warmup, total, final_frac = setting
    if kind == "warmup_cosine":
        jf = jschedules.warmup_cosine(lr, warmup, total, final_frac)
        f = schedules.warmup_cosine(lr, warmup, total, final_frac, device="cpu")
        decay_steps = max(1, total - warmup)
    else:
        jf = jschedules.cosine_decay(lr, total, final_frac)
        f = schedules.cosine_decay(lr, total, final_frac, device="cpu")
        warmup, decay_steps = 0, total
    steps = np.arange(total + 3)
    with jax.disable_jit():  # op by op: no contraction into FMAs
        want = np.array([np.asarray(jf(jnp.int32(s))) for s in steps])
    got = np.array([f(int(s)).numpy() for s in steps])
    assert got.dtype == np.float32 and f(0).shape == ()
    assert torch.equal(f(torch.tensor(7, dtype=torch.int32)), f(7))
    # the decay's cos argument, and the steps where the two cosines differ
    frac = np.clip((steps - warmup).astype(np.float32) / np.float32(decay_steps), 0, 1)
    arg = (np.float32(math.pi) * frac).astype(np.float32)
    with jax.disable_jit():
        jcos = np.asarray(jnp.cos(jnp.asarray(arg)))
    tcos = torch.cos(torch.from_numpy(arg)).numpy()
    cos_differs = set(np.flatnonzero((jcos != tcos) & (steps >= warmup)).tolist())
    differ = set(np.flatnonzero(got.view(np.int32) != want.view(np.int32)).tolist())
    record_property("cos_differs_at", sorted(cos_differs))
    record_property("rate_differs_at", sorted(differ))
    assert differ <= cos_differs, sorted(differ - cos_differs)
    assert not differ & set(range(warmup))  # the warmup ramp is exact
    # one ulp of cos apart, and the port's arithmetic on XLA's cos is exact
    for s in sorted(cos_differs):
        assert _ulps(jcos[s], tcos[s]) == 1
        c = torch.tensor(jcos[s])
        rate = torch.tensor(lr, dtype=torch.float32) * (
            final_frac + (1 - final_frac) * (0.5 * (1 + c)))
        assert rate.numpy().view(np.int32) == want[s].view(np.int32), s
    assert float(schedules.constant(lr, device="cpu")(7)) == np.float32(lr)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_meta_matches_reference(arch):
    cfg, jcfg = registry.get_config(arch, reduced=True), jregistry.get_config(arch, reduced=True)
    got, want = model.param_meta(cfg, tp=1), jmodel.param_meta(jcfg, tp=1)
    g_leaves = leaves(got)
    w_leaves = jax.tree_util.tree_leaves(want, is_leaf=jmeta.is_meta)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.shape == tuple(w.shape)
        assert str(g.dtype).removeprefix("torch.") == jnp.dtype(w.dtype).name
        assert g.pspec == tuple(w.pspec)
        assert g.sync == w.sync
    # the order is the parameters' (the seeds' meaning)
    params = model.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert [m.shape for m in g_leaves] == [tuple(p.shape) for p in leaves(params)]
    assert meta.param_count(got) == jmeta.param_count(want) == sum(
        p.numel() for p in leaves(params))
    assert meta.param_bytes(got) == jmeta.param_bytes(want)
    full = model.param_meta(registry.get_config(arch), tp=1)
    jfull = jmodel.param_meta(jregistry.get_config(arch), tp=1)
    assert meta.param_count(full) == jmeta.param_count(jfull)
    assert meta.param_bytes(full) == jmeta.param_bytes(jfull)
    assert meta.tree_map(lambda m: m.sync, got) == jax.tree_util.tree_map(
        lambda m: m.sync, want, is_leaf=jmeta.is_meta)
    assert meta.sync_grads(params, got, ParallelCtx()) is params
    # over a model axis, field for field (every tp: tests/test_torch_tp_ops.py)
    for g, w in zip(leaves(model.param_meta(cfg, tp=2)), jax.tree_util.tree_leaves(
            jmodel.param_meta(jregistry.get_config(arch, reduced=True), tp=2),
            is_leaf=jmeta.is_meta)):
        assert (g.shape, g.pspec, g.sync) == (tuple(w.shape), tuple(w.pspec), w.sync)


def _tree(rng, scale):
    return {"b": rng.normal(0, scale, (3, 5)).astype(np.float32),
            "a": (rng.normal(0, scale, 7).astype(np.float32),
                  {"z": rng.normal(0, scale, (2, 2, 2)).astype(np.float32)})}


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_tree_update_is_the_flat_update_leaf_by_leaf(name):
    rng = np.random.default_rng(3)
    p0 = _tree(rng, 0.05)
    grads = [_tree(rng, 0.02) for _ in range(2)]
    lr = torch.tensor(0.3, dtype=torch.float32)
    opt = optim.make_optimizer(name)
    params = jax.tree_util.tree_map(torch.from_numpy, p0)
    flat, unravel = ravel(params)
    state, flat_state = opt.init(params), opt.init(flat)
    jopt = joptim.make_optimizer(name)
    jparams = jax.tree_util.tree_map(jnp.asarray, p0)
    jstate = jopt.init(jparams)
    for g in grads:
        tg = jax.tree_util.tree_map(torch.from_numpy, g)
        params, state = opt.update(tg, state, params, lr)
        flat, flat_state = opt.update(ravel(tg)[0], flat_state, flat, lr)
        jparams, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate,
                                      jparams, jnp.float32(0.3))
    assert torch.equal(ravel(params)[0], flat)
    if name != "sgd":
        assert torch.equal(ravel(state["m"])[0], flat_state["m"])
    if name == "adam":
        assert torch.equal(ravel(state["v"])[0], flat_state["v"])
        assert state["t"].shape == () and int(state["t"]) == 2
    want = np.concatenate([np.asarray(x).reshape(-1)
                           for x in jax.tree_util.tree_leaves(jparams)])
    got = flat.numpy()
    if name == "adam":
        assert np.all(np.abs(got - want) <= ADAM_RTOL * np.abs(want))
    elif name == "momentum":
        assert _ulps(got, want).max() <= len(grads)
    else:
        np.testing.assert_array_equal(got, want)


def test_parallel_ctx_and_plan_refuse_a_model_axis():
    """A model axis needs its process group (the groups of a plan with
    one are made by ``launch/mesh.py:mesh_groups`` under a launcher, run
    in tests/test_torch_tp_*.py), the compressed all-gather too."""
    with pytest.raises(ValueError, match="process group"):
        ParallelCtx(model_axis="model", tp=2)
    with pytest.raises(ValueError, match="process group"):
        ParallelCtx(model_axis="model", tp=2, sp_compress=True)
    plan = tstep.MeshPlan((2, 2), ("data", "model"), ("data",))
    assert plan.tp == 2 and plan.n_clients == 2
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        tstep.make_plan((2, 2), "cpu")
    model_ctx = ParallelCtx(model_axis="model", tp=2, model_group=object())
    assert meta.sync_grads([], {}, model_ctx) == []
    with pytest.raises(ValueError, match="process group"):
        ParallelCtx(client_axes=("data",), n_clients=2)
    plan = tstep.MeshPlan((2, 2, 1), ("pod", "data", "model"), ("pod", "data"))
    assert plan.tp == 1 and plan.n_clients == 4
    x = torch.arange(3.0)
    assert ParallelCtx().psum_clients(x) is x and ParallelCtx().pmean_clients(x) is x


def test_one_rank_gloo_plan_sums_over_its_group():
    plan = tstep.make_plan((1, 1), "cpu")
    ctx = plan.ctx()
    assert (ctx.client_axes, ctx.n_clients, ctx.client_index) == (("data",), 1, 0)
    z = torch.tensor([3, -1, 7], dtype=torch.int32)
    s = ctx.psum_clients(z)
    assert torch.equal(s, z) and s is not z  # a new tensor: the partial stays
    assert torch.equal(ctx.pmean_clients(torch.tensor([2.0, 4.0])), torch.tensor([2.0, 4.0]))


def test_train_seeds_are_a_pure_function_of_seed_step_client_leaf():
    a = tstep.train_seeds(0, 5, 2, 9)
    assert a == tstep.train_seeds(0, 5, 2, 9)
    assert tstep.train_seeds(0, 5, 2, 4) == a[:4]  # leaf i's seed is the same in any count
    assert all(0 <= s < 2 ** 32 for s in a) and len(set(a)) == 9
    others = [tstep.train_seeds(1, 5, 2, 9), tstep.train_seeds(0, 6, 2, 9),
              tstep.train_seeds(0, 5, 3, 9)]
    assert all(o != a for o in others)


def test_fed_loop_reexports_the_trainer():
    from repro.fed import loop as jloop
    from repro_torch.fed import config, loop, trainer

    assert loop.FedConfig is config.FedConfig and loop.FedTrainer is trainer.FedTrainer
    assert loop.ENGINES == jloop.ENGINES
    assert loop.STAGINGS == jloop.STAGINGS and loop.SUBSAMPLINGS == jloop.SUBSAMPLINGS
    assert sorted(loop.__all__) == sorted(jloop.__all__)
