"""The port's async engine (``fed/async_engine.py``), arrival traffic
(``fed/arrivals.py``) and typed intake (``fed/updates.py``), against the
JAX reference on the CPU.

Contracts:
  * arrival traces equal the reference's exactly, for every registered
    process at several seeds (both draw from numpy);
  * ``StalenessPolicy``, ``UpdateBuffer`` and ``ClientUpdate`` give the
    reference's results on one shared script;
  * one reference async aggregation (``max_staleness`` 2, a poly
    discount, mixed staleness, weight-0 rows), replayed in the port given
    its ids, kernel seed, ``stale``, ``delivered``, ring and gradient
    stack: the integer sum exactly, the literal decode + discount + SGD
    exactly, the parameters within the reference's 1-ULP contract,
    materialized and fused;
  * the plain corner equals the port's perround bit for bit; off it the
    fused and materialized rounds agree bit for bit, streamed staging
    equals full staging, and per-row gradients are the rows' own;
  * every aggregation is accounted at its realized size: the reference
    trainer's ``_eps_vector`` to 1e-9, an all-timeout aggregation moves
    nothing and costs nothing;
  * a resumed run continues bit for bit; validation errors name their
    knob.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mechanisms as jmechs
from repro.core import wire as jwire
from repro.fed import arrivals as jarrivals
from repro.fed import cohort as jcohort
from repro.fed import rounds as jrounds
from repro.fed import updates as jupdates
from repro.fed.config import FedConfig as JaxFedConfig
from repro.fed.trainer import FedTrainer as JaxFedTrainer
from repro.kernels import ops as jops
from repro.optim import sgd as jax_sgd
from repro_torch.core import grid, wire
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.core.renyi import RenyiAccountant
from repro_torch.fed import arrivals, rounds, updates
from repro_torch.fed.async_engine import make_async_round_step
from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer

SMALL = dict(num_clients=24, clients_per_round=4, lr=1.0, eval_size=32,
             samples_per_client=2)
SPEC = "rqm:c=0.05,m=16,q=0.42"
# the port's engines against each other need no exact reference: cheaper
# encodes
ENGINE_SPEC = "qmgeo:c=0.05,m=16,r=0.6"
RESUME_SPEC = "none:c=0.05"
# seed 2: aggregation 2 has staleness [2, 1, 0, 0] and rows 0 and 3 late
REPLAY = dict(seed=2, async_max_staleness=2, async_staleness_weight="poly:0.5",
              async_latency=0.05, async_timeout=0.05)
REPLAY_ROUND = 2
STALE = "async:max_staleness=2,staleness_weight=poly:0.5,latency=0.05,timeout=0.05"
QUIET = dict(log=lambda msg: None)
PROCESSES = ("poisson", "diurnal", "diurnal:period=5,amplitude=0.5", "poisson:rate=2.5")


def _trainer(spec=ENGINE_SPEC, **overrides):
    return FedTrainer(spec, FedConfig(collect_sums=True, **{**SMALL, **overrides}),
                      device="cpu")


def _rounds(tr, k):
    for _ in range(k):
        tr.round()
    return tr


def _same(a, b, what):
    assert torch.equal(a.flat, b.flat), what
    assert a.realized_n == b.realized_n, what
    assert len(a.round_sums) == len(b.round_sums), what
    for x, y in zip(a.round_sums, b.round_sums):
        np.testing.assert_array_equal(x, y, err_msg=what)
    assert all(np.array_equal(x, y) for x, y in zip(a.accountant.history,
                                                   b.accountant.history)), what


# ---------------------------------------------------------------------------
# arrival traffic and the typed intake
# ---------------------------------------------------------------------------


def test_arrival_registry_is_the_reference():
    assert arrivals.arrival_names() == jarrivals.arrival_names() == ("poisson", "diurnal")
    for spec in ("", "nope", "poisson:rate", "diurnal:amplitude=1.0", "poisson:width=2",
                 "poisson:rate=-1"):
        with pytest.raises(ValueError) as ours:
            arrivals.make_arrivals(spec, rate=4.0)
        with pytest.raises(ValueError) as theirs:
            jarrivals.make_arrivals(spec, rate=4.0)
        assert str(ours.value) == str(theirs.value)
    assert arrivals.parse_arrivals_spec("diurnal:period=5,flag=true,x=a") == \
        jarrivals.parse_arrivals_spec("diurnal:period=5,flag=true,x=a")


@pytest.mark.parametrize("spec", PROCESSES)
def test_arrival_traces_are_the_reference(spec):
    for seed in (0, 1, 7):
        for timeout in (None, 0.6):
            kw = dict(seed=seed, max_staleness=3, mean_latency=0.5, timeout=timeout)
            ours = arrivals.ArrivalSimulator(arrivals.make_arrivals(spec, rate=6.0), 6, **kw)
            theirs = jarrivals.ArrivalSimulator(jarrivals.make_arrivals(spec, rate=6.0), 6,
                                                **kw)
            for _ in range(8):
                a, b = ours.next_buffer(), theirs.next_buffer()
                assert (a.index, a.time, a.realized) == (b.index, b.time, b.realized)
                for field in ("arrivals", "staleness", "delivered", "raw_staleness"):
                    x, y = getattr(a, field), getattr(b, field)
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
            assert ours.stats() == theirs.stats()
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(arrivals.make_arrivals(spec, rate=3.0).sample(rng, 40),
                                      jarrivals.make_arrivals(spec, rate=3.0).sample(jrng, 40))


def _intake_script(up, wr):
    """One script of policy, update and buffer calls; what it observes."""
    out = []

    def attempt(fn):
        try:
            out.append(("ok", fn()))
        except (ValueError, TypeError) as e:
            out.append(("raise", type(e).__name__, str(e)))

    for weight in ("uniform", "poly", "poly:0.5", "poly:2", "uniform:1", "poly:x",
                   "poly:-1", "fancy"):
        attempt(lambda: up.StalenessPolicy(max_staleness=2, weight=weight).describe())
    pol = up.StalenessPolicy(max_staleness=2, weight="poly:0.5")
    out.append([pol.admit(s) for s in range(5)])
    out.append([pol.discount(s) for s in ([], [0], [0, 1, 2], [3, 3], np.arange(7))])
    out.append(up.StalenessPolicy().discount([5, 9]))
    attempt(lambda: up.StalenessPolicy(max_staleness=-1))
    rng = np.random.default_rng(3)
    dense = rng.integers(0, 16, 10).astype(np.int32)
    packed = wr.PackedPayload.pack(dense, 4)
    for payload, kw in ((dense, {}), (packed, {}), (dense, dict(weight=2)),
                        (dense, dict(staleness=-1)), (dense.astype(np.float32), {}),
                        (dense.reshape(2, 5), {}), (np.array(["a"] * 10), {}),
                        (dense[:7], {}), (wr.PackedPayload.pack(dense[:8], 4), {})):
        attempt(lambda: (lambda u: (u.packed, u.payload_nbytes, u.payload_array().tolist(),
                                    u.validate(10).weight))(up.ClientUpdate(payload, **kw)))
    u = up.ClientUpdate(dense, client_id=4, round_tag=3)
    out.append([u.staleness_at(v) for v in (1, 3, 6)])
    out.append((u.stamped(6).staleness, up.ClientUpdate(dense, staleness=2).staleness_at(9)))
    out.append([x.round_tag for x in up.as_updates(np.stack([dense, dense]), round_tag=5)])
    out.append(len(up.as_updates(u)) + len(up.as_updates([u, u])))
    attempt(lambda: up.as_updates(dense))
    buf = up.UpdateBuffer(up.StalenessPolicy(max_staleness=1), dim=10)
    for tag in (0, 1, 2, None, 3, 0):
        buf.add(up.ClientUpdate(dense, client_id=len(buf), round_tag=tag,
                                weight=int(tag != 2)))
    attempt(lambda: buf.add(up.ClientUpdate(dense[:9])))
    out.append([(x.client_id, x.staleness, x.weight) for x in buf.peek(3, 2)])
    out.append((len(buf), buf.discarded))
    out.append([(x.client_id, x.staleness) for x in buf.take(2, 3)])
    out.append((len(buf), buf.discarded, buf.prune(9), len(buf)))
    buf.extend([up.ClientUpdate(packed, round_tag=9)])
    out.append([(x.client_id, x.staleness, x.packed) for x in buf.take(5, 9)])
    return out


def test_intake_is_the_reference():
    ours, theirs = _intake_script(updates, wire), _intake_script(jupdates, jwire)
    assert len(ours) == len(theirs) > 30
    for a, b in zip(ours, theirs):
        assert a == b


# ---------------------------------------------------------------------------
# one reference aggregation, replayed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_async_round():
    """Aggregation REPLAY_ROUND of a reference async trainer (materialized),
    with everything needed to replay it."""
    jtr = JaxFedTrainer(jmechs.make_mechanism(SPEC),
                        JaxFedConfig(engine="async", collect_sums=True, **{**SMALL, **REPLAY}))
    for _ in range(REPLAY_ROUND):
        jtr.round()
    eng = jtr.engine
    sched = copy.deepcopy(eng.sim).next_buffer()
    _, k_sample, k_enc, _ = jcohort.split_round_keys(jtr.cfg, jtr._key)
    ids, _ = jcohort.sample_slate(jtr.cfg, jtr.slate, k_sample)
    hist = np.array(eng._hist)
    grads = jax.vmap(jtr._client_grad, in_axes=(0, 0))(
        jnp.asarray(hist[sched.staleness]), jrounds.index_batch(jtr.client_data, ids))
    disc = eng.policy.discount(sched.staleness[sched.delivered])
    jtr.round()
    z_sum = np.array(jtr.round_sums[-1])
    n = int(jtr.realized_n[-1])
    # the reference's decode at a traced n, discount and SGD, op by op
    g_hat = jtr.mech.decode_sum(jnp.asarray(z_sum), jnp.int32(max(n, 1))) * jnp.float32(disc)
    literal, _ = jax_sgd().update(g_hat, (), jnp.asarray(hist[0]), jtr.cfg.lr)
    return {"jtr": jtr, "sched": sched, "ids": np.array(ids), "n": n,
            "seed": int(np.asarray(jops.key_to_seed(k_enc))), "hist": hist,
            "grads": np.array(grads), "disc": disc, "sum": z_sum,
            "hist1": np.array(eng._hist), "literal": np.array(literal),
            "extras": jtr.round_extras[-1]}


@pytest.mark.parametrize("fused", [False, True], ids=["materialized", "fused"])
def test_reference_async_round_replayed(reference_async_round, fused, record_property):
    ref = reference_async_round
    sched = ref["sched"]
    assert sched.index == REPLAY_ROUND and len(set(sched.staleness.tolist())) == 3
    assert 0 < ref["n"] < len(sched.delivered) and ref["n"] == sched.realized
    cfg = FedConfig(engine="async", fused_rounds=fused, **{**SMALL, **REPLAY})
    mech = make_mechanism(SPEC)
    opt = rounds.server_optimizer(cfg)
    stale = torch.from_numpy(sched.staleness.astype(np.int64))
    seen = {}

    def handed(params, batch):
        seen["params"] = params.clone()
        return torch.from_numpy(ref["grads"])

    step = make_async_round_step(mech, cfg, opt, 2, handed)
    hist = torch.from_numpy(ref["hist"])
    new_hist, state, z_sum = step(
        hist, (), {}, ref["seed"], stale,
        torch.from_numpy(sched.delivered.astype(np.int32)),
        torch.tensor(ref["disc"], dtype=torch.float32))
    np.testing.assert_array_equal(seen["params"].numpy(), ref["hist"][sched.staleness])
    np.testing.assert_array_equal(z_sum.numpy(), ref["sum"])
    got = new_hist[0].numpy()
    np.testing.assert_array_equal(got, ref["literal"])
    # the ring shifted by one version, as the reference's
    np.testing.assert_array_equal(new_hist[1:].numpy(), ref["hist1"][1:])
    # the reference's 1-ULP contract: lr x disc x one ulp of 2 x_max, plus
    # one of the output
    tol = SMALL["lr"] * np.spacing(np.float32(2.0 * mech.params.x_max)) \
        + np.spacing(np.maximum(np.abs(got), np.abs(ref["hist"][0])).astype(np.float32))
    assert np.all(np.abs(got - ref["hist1"][0]) <= tol)
    assert state == ()
    record_property(f"async_{'fused' if fused else 'materialized'}_params_off_jitted",
                    int(np.count_nonzero(got != ref["hist1"][0])))


def test_async_trainer_draws_the_replayed_buffer(reference_async_round):
    """The port's async trainer realizes the reference's schedules and
    extras, and accounts each aggregation as its trainer does."""
    ref = reference_async_round
    tr = _rounds(_trainer(SPEC, engine="async", **REPLAY), REPLAY_ROUND + 1)
    assert tr.realized_n == ref["jtr"].realized_n
    assert tr.round_extras == ref["jtr"].round_extras
    assert [(u.round_tag, u.staleness, u.weight) for u in tr.engine.last_buffer] == \
        [(u.round_tag, u.staleness, u.weight) for u in ref["jtr"].engine.last_buffer]
    for a, b in zip(tr.accountant.history, ref["jtr"].accountant.history):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)
    for n in range(0, 6):
        np.testing.assert_allclose(tr._eps_vector(n), np.asarray(ref["jtr"]._eps_vector(n)),
                                   rtol=1e-9, atol=1e-12)
    assert not tr._eps_vector(0).any()
    assert tr.engine.hist.shape == (3, tr.flat.numel())
    assert torch.equal(tr.flat, tr.engine.hist[0])


# ---------------------------------------------------------------------------
# the port's engine against itself and the perround engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["materialized", "fused"])
def test_plain_corner_is_perround(fused):
    plain = _rounds(_trainer(engine="async", fused_rounds=fused), 2)
    assert plain.engine._plain and plain.engine.hist is None
    _same(plain, _rounds(_trainer(engine="perround", fused_rounds=fused), 2),
          "the plain corner against perround")
    assert plain.round_extras[-1]["delivered"] == 4
    assert [u.client_id for u in plain.engine.last_buffer] == [-1] * 4


def test_off_corner_paths_agree():
    """Fused == materialized, streamed == full staging, every aggregation
    accounted at its realized size, and cadence != clients_per_round at
    max_staleness 0 (off the corner: hist[0] alone)."""
    base = _rounds(_trainer(engine=STALE, seed=2), 3)
    assert not base.engine._plain and min(base.realized_n) < 4
    _same(base, _rounds(_trainer(engine=STALE, seed=2, fused_rounds=True), 3), "fused")
    streamed = _rounds(_trainer(engine=STALE, seed=2, staging="stream"), 3)
    _same(base, streamed, "streamed staging")
    assert streamed.client_data is None
    one = sum(v.nbytes for v in streamed.task.client_batch(0).values())
    assert streamed.staged_bytes_last_block == 4 * one  # the cadence's datasets
    acc = RenyiAccountant(alphas=base.cfg.accountant_alphas)
    for n in base.realized_n:
        acc.step([base.mech.per_round_epsilon(n, a) if n else 0.0
                  for a in base.cfg.accountant_alphas])
    assert acc.rdp_epsilon(8.0) == base.accountant.rdp_epsilon(8.0)
    assert [e["delivered"] for e in base.round_extras] == base.realized_n
    s0 = _rounds(_trainer(engine="async:cadence=3,max_staleness=0"), 1)
    assert not s0.engine._plain and s0.engine.hist.shape[0] == 1 and s0.realized_n == [3]


def test_per_row_gradients_are_each_rows_own():
    tr = _trainer()
    batch = rounds.index_batch(tr.client_data, torch.tensor([3, 5, 7]))
    params = torch.stack([tr.flat, tr.flat * 0.9, tr.flat + 0.01])
    for local_steps in (1, 2):
        cfg = dataclasses.replace(tr.cfg, local_steps=local_steps)
        rows = rounds.make_client_grad(tr.mech, tr.unravel, tr.task, cfg, per_row=True)
        each = rounds.make_client_grad(tr.mech, tr.unravel, tr.task, cfg)
        got = rows(params, batch)
        for i in range(3):
            want = each(params[i], {k: v[i:i + 1] for k, v in batch.items()})[0]
            # one batched convolution against one of its own: float order only
            torch.testing.assert_close(got[i], want, rtol=1e-5, atol=1e-6)


def test_all_timeout_aggregation_moves_nothing():
    tr = _trainer(engine="async:max_staleness=1,timeout=1e-9", server_opt="momentum")
    before = tr.flat.clone()
    tr.train(2, eval_every=2, **QUIET)
    assert tr.realized_n == [0, 0]
    assert torch.equal(tr.flat, before) and not tr.opt_state["m"].any()
    assert tr.accountant.rdp_epsilon(8.0) == 0.0
    np.testing.assert_array_equal(tr.round_sums[0], 0)


@pytest.mark.parametrize("engine", ["async", STALE], ids=["plain", "stale"])
def test_resume_is_bit_for_bit(tmp_path, engine):
    kw = dict(engine=engine, seed=2, ckpt_dir=str(tmp_path), ckpt_every=2)
    full = _trainer(RESUME_SPEC, **kw)
    full.train(4, eval_every=4, **QUIET)
    resumed = _trainer(RESUME_SPEC, **kw)
    assert resumed.restore_checkpoint(2) == 2
    resumed.train(2, eval_every=2, **QUIET)
    assert torch.equal(resumed.flat, full.flat)
    assert resumed.realized_n == full.realized_n
    assert all(np.array_equal(a, b) for a, b in zip(resumed.accountant.history,
                                                   full.accountant.history))
    assert resumed.round_extras[2:] == full.round_extras[2:]
    assert resumed.engine.sim._agg_times == full.engine.sim._agg_times
    if engine != "async":
        assert torch.equal(resumed.engine.hist, full.engine.hist)
    # another arrival process is another trajectory
    other = _trainer(RESUME_SPEC, **{**kw, "async_rate": 2.0})
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        other.restore_checkpoint(2)


@pytest.mark.parametrize("overrides,match", [
    (dict(engine="async:cadence=25"), "async_cadence=25"),
    (dict(engine="async", async_cadence=30), "num_clients=24"),
    (dict(engine="async:max_staleness=-1"), "async_max_staleness"),
    (dict(engine="async", subsampling="poisson"), "subsampling='fixed'"),
    (dict(engine="async", dropout=0.1), "dropout=0"),
    (dict(engine="async:rate=0"), "async_rate"),
    (dict(engine="async:timeout=-1"), "async_timeout"),
    (dict(engine="async:staleness_weight=fancy"), "staleness weight"),
    (dict(engine="async:arrivals=bursty"), "arrival process"),
    (dict(engine="async:cadence=4,window=3"), "window"),
])
def test_validation_names_its_knob(overrides, match):
    with pytest.raises(ValueError, match=match):
        _trainer(**overrides)


def test_async_round_decodes_at_a_device_count():
    """At n = 2 of c = 0.03 the fixed cohort's double scale and the traced
    one differ: the async round decodes at the device count, with the
    reference's traced arithmetic (the aggregator, at a static n, takes
    the double)."""
    spec = "rqm:c=0.03,m=16,q=0.42"
    mech, jmech = make_mechanism(spec), jmechs.make_mechanism(spec)
    cfg = FedConfig(engine="async", **SMALL)
    rng = np.random.default_rng(9)
    grads = torch.from_numpy(rng.uniform(-0.03, 0.03, (4, 301)).astype(np.float32))
    hist = torch.from_numpy(rng.normal(0, 0.1, (2, 301)).astype(np.float32))
    delivered = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    step = make_async_round_step(mech, cfg, rounds.server_optimizer(cfg), 1,
                                 lambda params, batch: grads)
    new_hist, _, z_sum = step(hist, (), {}, 12345, torch.tensor([1, 0, 0, 1]), delivered)
    count = torch.tensor(2, dtype=torch.int32)
    traced = hist[0] - SMALL["lr"] * mech.decode_sum(z_sum, count)
    fixed = hist[0] - SMALL["lr"] * mech.decode_sum(z_sum, 2)
    assert torch.equal(new_hist[0], traced) and not torch.equal(new_hist[0], fixed)
    p = jmech.params
    jscale = jax.jit(lambda k: 2.0 * p.x_max / (k * (p.m - 1)))(jnp.int32(2))
    assert grid.decode_scale_dev(count, mech.params).numpy() == np.asarray(jscale)
