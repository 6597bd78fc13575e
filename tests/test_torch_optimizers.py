"""The port's server optimizers (src/repro_torch/optim) and the optimizer
state every engine carries, against the JAX reference on the CPU, at the
suite's small problem (24 clients, cohorts of 6).

Tolerances:
  * momentum and adam against ``repro.optim`` on the same numpy inputs,
    5 steps, with and without weight decay: momentum within 1 ULP a step
    (XLA:CPU may contract ``beta * m + g`` into an FMA, ROADMAP.md C5),
    adam within rtol 1e-6 (float32 ``pow`` and ``sqrt`` may round
    differently; torch's CPU ``sqrt`` is 1 ULP off in about 1 element in
    130), the parameters' relative to the operands of ``p - lr * step``
    (|p| + |lr * step|, summed over the steps: where the step nearly
    equals p the difference cancels); sgd with weight decay exact;
  * the port's scan == perround, bit for bit, with each optimizer:
    parameters and state;
  * two reference momentum rounds replayed through the port's round step
    (the reference's cohorts, kernel seeds and clipped gradients): the
    SecAgg sums exact; the parameters and the momentum buffer within t
    units after round t, a unit being the reference's 1-ULP bound of its
    jitted decode + apply (``lr * spacing(2 x_max)`` + a parameter's ULP);
  * SGD with weight decay on a fused round takes decode + optimizer, not
    the fused decode-apply kernel, whose parameters differ.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core.mechanisms import make_mechanism as jax_make_mechanism
from repro.fed import cohort as jcohort
from repro.fed import rounds as jrounds
from repro.fed.config import FedConfig as JaxFedConfig
from repro.fed.trainer import FedTrainer as JaxFedTrainer
from repro.kernels import ops as jops
from repro_torch import optim
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.fed import rounds
from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer
from repro_torch.kernels import decode_apply_kernel

SMALL = dict(num_clients=24, clients_per_round=6, lr=1.0, eval_size=64,
             samples_per_client=8)
SPEC = "rqm:c=0.05,m=16,q=0.42"
STEPS = 5
ADAM_RTOL = 1e-6
OPTS = {"momentum": {}, "adam": {}, "momentum-wd": {"weight_decay": 1e-3},
        "adam-wd": {"weight_decay": 1e-3}, "sgd-wd": {"weight_decay": 1e-3}}


def _ulps(a, b) -> np.ndarray:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _assert_close(name, got, want, steps, scale=None):
    if name.startswith("adam"):
        # relative to the operands' size: p - lr * step cancels where the
        # step nearly equals p
        scale = np.abs(want) if scale is None else scale
        assert np.all(np.abs(got - want) <= ADAM_RTOL * scale)
    elif name.startswith("momentum"):
        assert _ulps(got, want).max() <= steps
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_matches_reference(name):
    kind, options = name.split("-")[0], OPTS[name]
    rng = np.random.default_rng(len(name))
    p0 = rng.normal(0, 0.05, 4099).astype(np.float32)
    p0[:7] = [0.0, -0.0, 1e-30, -1e-30, 3.0, -3.0, 0.5]  # signed zeros, tiny, large
    grads = [rng.normal(0, 0.02, p0.size).astype(np.float32) for _ in range(STEPS)]
    grads[0][:3] = -0.0
    jopt, topt = joptim.make_optimizer(kind, **options), optim.make_optimizer(kind, **options)
    jp, tp = jnp.asarray(p0), torch.from_numpy(p0.copy())
    js, ts = jopt.init(jp), topt.init(tp)
    scale = np.zeros_like(p0)  # adam: the operands' sizes, summed over the steps
    for step, g in enumerate(grads, 1):
        prev = np.asarray(jp)
        jp, js = jopt.update(jnp.asarray(g), js, jp, 0.5)
        tp, ts = topt.update(torch.from_numpy(g), ts, tp, 0.5)
        want = np.asarray(jp)
        scale += np.abs(prev) + np.abs(want - prev)
        _assert_close(name, tp.numpy(), want, step, scale=scale)
        if kind == "sgd":
            assert ts == js == ()
            continue
        assert sorted(ts) == sorted(js)
        for k in ("m", "v"):
            if k in ts:
                _assert_close(name, ts[k].numpy(), np.asarray(js[k]), step)
        if kind == "adam":
            assert ts["t"].dtype == torch.int32 and ts["t"].shape == ()
            assert int(ts["t"]) == int(js["t"]) == step


def test_make_optimizer_and_state_helpers():
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make_optimizer("lion")
    with pytest.raises(TypeError):
        optim.make_optimizer("momentum", b1=0.9)
    assert optim.make_optimizer("momentum", beta=0.5).name == "momentum"
    cfg = FedConfig(server_opt="adam", server_opt_options={"b1": 0.8}, **SMALL)
    assert rounds.server_optimizer(cfg).name == "adam"
    state = optim.adam().init(torch.ones(3))
    copy = optim.optimizers.clone_state(state)
    optim.optimizers.copy_state_(copy, {"m": torch.ones(3), "v": torch.ones(3) * 2,
                                        "t": torch.tensor(4, dtype=torch.int32)})
    assert int(copy["t"]) == 4 and int(state["t"]) == 0 and float(state["v"].sum()) == 0
    assert optim.optimizers.clone_state(()) == ()


# ---------------------------------------------------------------------------
# the engines carry the state
# ---------------------------------------------------------------------------


def _trainer(engine, opt, spec="none:c=0.05", **overrides):
    return FedTrainer(spec, FedConfig(engine=engine, server_opt=opt, scan_block=2,
                                      **{**SMALL, **overrides}), device="cpu")


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_scan_equals_perround_with_each_optimizer(opt):
    """3 rounds of the scan engine in blocks of 2 against 3 perround
    rounds: parameters and optimizer state bit for bit."""
    scan, per = _trainer("scan", opt), _trainer("perround", opt)
    scan.run_block(3)
    for _ in range(3):
        per.round()
    assert torch.equal(scan.flat, per.flat)
    if opt == "sgd":
        assert scan.opt_state == per.opt_state == ()
    else:
        assert sorted(scan.opt_state) == sorted(per.opt_state)
        for k, v in scan.opt_state.items():
            assert torch.equal(v, per.opt_state[k]), k
        assert float(scan.opt_state["m"].abs().sum()) > 0
    if opt == "adam":
        assert int(scan.opt_state["t"]) == 3
    # the engine's static buffers are not the trainer's state
    if opt != "sgd":
        assert scan.opt_state["m"].data_ptr() != scan.engine.opt["m"].data_ptr()


def test_fused_momentum_takes_the_dense_sum_and_the_optimizer():
    """A stateful optimizer never takes the fused decode-apply: the fused
    round sums dense and decodes, then steps the optimizer, and equals the
    materialized round bit for bit."""
    cfg = dict(clients_per_round=2, num_clients=6)
    fused = _trainer("scan", "momentum", SPEC, fused_rounds=True, **cfg)
    assert fused.pack_bits is None
    assert not rounds.use_fused_apply(fused.mech, fused.cfg)
    with pytest.raises(ValueError, match="wire_packed=True requires"):
        _trainer("scan", "momentum", SPEC, fused_rounds=True, wire_packed=True, **cfg)
    plain = _trainer("perround", "momentum", SPEC, **cfg)
    fused.run_block(2)
    plain.round()
    plain.round()
    assert torch.equal(fused.flat, plain.flat)
    assert torch.equal(fused.opt_state["m"], plain.opt_state["m"])


# ---------------------------------------------------------------------------
# the use_fused_apply repair: weight decay is not the fused kernel's
# ---------------------------------------------------------------------------


def test_sgd_with_weight_decay_takes_decode_and_optimizer():
    mech = make_mechanism(SPEC)
    plain_cfg = FedConfig(fused_rounds=True, **SMALL)
    wd_cfg = dataclasses.replace(plain_cfg, server_opt_options={"weight_decay": 0.05})
    assert rounds.use_fused_apply(mech, plain_cfg)
    assert not rounds.use_fused_apply(mech, wd_cfg)
    assert rounds.hot_path_pack_bits(mech, plain_cfg, 6) == 7
    assert rounds.hot_path_pack_bits(mech, wd_cfg, 6) is None
    with pytest.raises(ValueError, match="no weight_decay"):
        rounds.hot_path_pack_bits(mech, dataclasses.replace(wd_cfg, wire_packed=True), 6)
    rng = np.random.default_rng(5)
    flat = torch.from_numpy(rng.normal(0, 0.05, 5000).astype(np.float32))
    z = torch.from_numpy(rng.integers(0, mech.sum_bound(6) + 1, 5000).astype(np.int32))
    dense = dataclasses.replace(plain_cfg, wire_packed=False)
    fused_new, state, _ = rounds.make_decode_apply(mech, dense, 6)(flat, (), z)
    wd_new, state_wd, _ = rounds.make_decode_apply(mech, wd_cfg, 6)(flat, (), z)
    assert state == state_wd == ()
    assert torch.equal(fused_new, decode_apply_kernel.decode_apply_sum(
        flat, z, mech.params, 6, plain_cfg.lr))
    want, _ = optim.sgd(weight_decay=0.05).update(mech.decode_sum(z, 6), (), flat, 1.0)
    assert torch.equal(wd_new, want)
    assert not torch.equal(wd_new, fused_new)
    # the trainer: no packed wire, and the same parameters as materialized
    tr = FedTrainer(SPEC, dataclasses.replace(wd_cfg, engine="perround", clients_per_round=2,
                                              num_clients=6), device="cpu")
    assert tr.pack_bits is None and tr._emitter.pack_bits is None


# ---------------------------------------------------------------------------
# a reference momentum run replayed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_momentum_rounds():
    """Two perround momentum rounds of the reference (materialized), with
    each round's cohort, kernel seed and clipped gradient stack."""
    jtr = JaxFedTrainer(jax_make_mechanism(SPEC),
                        JaxFedConfig(engine="perround", server_opt="momentum",
                                     collect_sums=True, **SMALL))
    out = {"flat0": np.array(jtr.flat), "rounds": []}
    for _ in range(2):
        _, k_sample, k_enc = jax.random.split(jtr._key, 3)
        ids, _ = jcohort.sample_slate(jtr.cfg, jtr.slate, k_sample)
        grads = jax.vmap(jtr._client_grad, in_axes=(None, 0))(
            jtr.flat, jrounds.index_batch(jtr.client_data, ids))
        jtr.round()
        out["rounds"].append({
            "ids": np.array(ids), "seed": int(np.asarray(jops.key_to_seed(k_enc))),
            "grads": np.array(grads), "sum": np.array(jtr.round_sums[-1]),
            "flat": np.array(jtr.flat), "m": np.array(jtr.opt_state["m"])})
    return out


def test_reference_momentum_rounds_replayed(reference_momentum_rounds, record_property):
    ref = reference_momentum_rounds
    cfg = FedConfig(engine="perround", server_opt="momentum", collect_sums=True, **SMALL)
    mech = make_mechanism(SPEC)
    flat = torch.from_numpy(ref["flat0"])
    state = optim.momentum().init(flat)
    data = {"ids": torch.arange(SMALL["num_clients"])}
    for t, r in enumerate(ref["rounds"], 1):
        handed = torch.from_numpy(r["grads"])
        step = rounds.make_round_step(mech, cfg, 6, lambda f, batch: handed)
        flat, state, z_sum = step(flat, state, data, ids=r["ids"], seed=r["seed"])
        np.testing.assert_array_equal(z_sum.numpy(), r["sum"])
        # the jitted decode + momentum may contract into FMAs: the unit is
        # the reference's 1-ULP bound of its jitted decode + apply
        # (tests/test_torch_round.py), compounded once a round
        got, want = flat.numpy(), r["flat"]
        unit = (cfg.lr * np.spacing(np.float32(2.0 * mech.params.x_max))
                + np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(np.float32)))
        err = np.abs(got - want) / unit
        merr = (np.abs(state["m"].numpy() - r["m"])
                / np.spacing(np.float32(2.0 * mech.params.x_max)))
        record_property(f"round{t}_params_differing", int(np.count_nonzero(got != want)))
        record_property(f"round{t}_max_param_error_in_units", float(err.max()))
        assert err.max() <= t and merr.max() <= t
