"""Heterogeneous cohorts in the port (Poisson subsampling, dropout,
``max_cohort``; ``fed/cohort.py``), against the JAX reference on the CPU.

Contracts:
  * the slate's size is the reference's ``base_slate``; a round's draws
    come from the round stream in one order (slate, seed, dropout), the
    selected ids first in ascending order, and a block holds each round's
    ids, seed and mask;
  * the decode at a device count (the realized size, a 0-d int32 tensor)
    reproduces the reference's arithmetic at a traced int32 n for every n
    in 1..89: PBM's and the noise-free decode bit for bit against the
    reference's jitted decode; the grid's (RQM, QMGeo) scale bit for bit
    against the reference's jitted scale, the decode bit for bit against
    the reference's expression op by op, and within one FMA contraction
    of its jitted decode (XLA:CPU contracts ``-x_max + z * scale``; ROADMAP
    C5). The fixed-cohort double differs from it at 18 sizes (22 for PBM),
    which the test counts;
  * one reference round (perround, materialized) under Poisson with
    ``max_cohort`` and dropout, given its ids, mask, seed and
    gradient stack: the port's materialized, fused packed and fused
    dense rounds give its integer sum exactly, its parameters within its
    1-ULP contract and its literal decode + SGD exactly;
  * realized-n accounting equals the reference trainer's ``_eps_vector``
    to 1e-9 (0 at n = 0);
  * the port's scan == perround == one-rank shard == streamed shard, bit
    for bit in parameters and sums, with the same realized sizes; four
    gloo ranks (``tests/torch_hetero_worker.py``) the same against scan;
  * an empty round moves neither the parameters nor the optimizer's
    state; the budget halt overshoots by at most one round; a hetero run
    resumed from a checkpoint continues bit for bit.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import os
import subprocess
import sys

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
from repro_torch.core import grid, wire
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.core.renyi import RenyiAccountant
from repro_torch.fed import cohort, rounds
from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer
from repro_torch.kernels import prng

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SMALL = dict(num_clients=24, clients_per_round=4, lr=1.0, eval_size=64,
             samples_per_client=8)
SPEC = "rqm:c=0.05,m=16,q=0.42"
# the port's engines against each other need no exact reference: the
# cheaper encode
ENGINE_SPEC = "qmgeo:c=0.05,m=16,r=0.6"
DECODE_SPECS = {"rqm": "rqm:c=0.02,m=16,q=0.42", "qmgeo": "qmgeo:c=0.02,m=16,r=0.6",
                "pbm": "pbm:c=0.02,m=16,theta=0.25", "none": "none:c=0.02"}
# the sizes at which the fixed-cohort scalars differ from the traced ones
# (n = 1..89, c = 0.02, m = 16)
DOUBLE_DIFFERS = {"rqm": 18, "qmgeo": 18, "pbm": 22, "none": 0}
HETERO = {"poisson": dict(subsampling="poisson", max_cohort=6),
          "dropout": dict(dropout=0.4),
          "both": dict(subsampling="poisson", max_cohort=5, dropout=0.3)}
ROUNDS = 2
QUIET = dict(log=lambda msg: None)


# ---------------------------------------------------------------------------
# the slate and the round stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overrides", [
    dict(), dict(subsampling="poisson"), dict(subsampling="poisson", max_cohort=8),
    dict(subsampling="poisson", num_clients=3400, clients_per_round=40),
    dict(subsampling="poisson", num_clients=10, clients_per_round=9),
    dict(dropout=0.1, num_clients=3400, clients_per_round=40),
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()) or "fixed")
def test_base_slate_is_the_reference(overrides):
    kw = {**SMALL, **overrides}
    want = jcohort.base_slate(JaxFedConfig(**kw))
    assert cohort.base_slate(FedConfig(**kw)) == want
    assert cohort.is_hetero(FedConfig(**kw)) == jcohort.is_hetero(JaxFedConfig(**kw))


def test_paper_poisson_slate_and_wire_width():
    cfg = FedConfig(subsampling="poisson", fused_rounds=True)
    slate = cohort.base_slate(cfg)
    mech = make_mechanism("rqm:c=0.02,m=16,q=0.42")
    assert slate == 82  # 40 + ceil(6 x 6.29) + 4
    assert rounds.hot_path_pack_bits(mech, cfg, slate) == 11  # bound 82 x 15 = 1230
    assert wire.packed_words(222_030, 11) == 111_015
    with pytest.raises(ValueError, match="max_cohort must be >= 1"):
        cohort.base_slate(FedConfig(subsampling="poisson", max_cohort=0))
    with pytest.raises(ValueError, match="max_cohort only applies"):
        FedTrainer(SPEC, FedConfig(**SMALL, max_cohort=4), device="cpu")
    with pytest.raises(ValueError, match="dropout must be in"):
        FedTrainer(SPEC, FedConfig(**SMALL, dropout=1.0), device="cpu")


@pytest.mark.parametrize("name", list(HETERO))
def test_round_draws_in_the_stream_order(name):
    cfg = FedConfig(**{**SMALL, **HETERO[name]})
    slate = cohort.base_slate(cfg)
    gen, ref = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    block = cohort.draw_block(cfg, slate, gen, 4)
    assert block.dtype == torch.int32 and block.shape == (4, 2 * slate + 1)
    assert cohort.realized_counts(cfg, slate, block) == block[:, slate + 1:].sum(1).tolist()
    for t in range(4):
        # the slate
        if cfg.subsampling == "poisson":
            sel = torch.rand(cfg.num_clients, generator=ref, dtype=torch.float64) \
                < cfg.clients_per_round / cfg.num_clients
            chosen = torch.nonzero(sel)[:, 0]
            ids = torch.cat([chosen, torch.nonzero(~sel)[:, 0]])[:slate]
            valid = torch.arange(slate) < len(chosen)
        else:
            ids = torch.randperm(cfg.num_clients, generator=ref)[:slate]
            valid = torch.ones(slate, dtype=torch.bool)
        # the seed, then the dropout draws
        seed = int(torch.randint(0, 1 << 32, (), generator=ref, dtype=torch.int64))
        part = valid
        if cfg.dropout:
            part = valid & ~(torch.rand(slate, generator=ref, dtype=torch.float64) < cfg.dropout)
        assert torch.equal(block[t, :slate].long(), ids)
        assert int(prng.seed_value(block[t, slate:slate + 1])) == seed
        assert torch.equal(block[t, slate + 1:], part.to(torch.int32))
        assert len(set(ids.tolist())) == slate
    assert torch.equal(gen.get_state(), ref.get_state())


# ---------------------------------------------------------------------------
# the decode at a device count
# ---------------------------------------------------------------------------


def _sum_for(name, n, rng):
    if name == "none":
        return rng.normal(0, 0.02 * n, 4096).astype(np.float32)
    return rng.integers(0, n * 16 + 1, 4096).astype(np.int32)


@pytest.mark.parametrize("name", list(DECODE_SPECS))
def test_decode_at_a_device_count_is_the_traced_reference(name):
    spec = DECODE_SPECS[name]
    mech, jmech = make_mechanism(spec), jmechs.make_mechanism(spec)
    jdecode = jax.jit(lambda z, n: jmech.decode_sum(z, n))
    p = getattr(jmech, "params", None)
    jscale = jax.jit(lambda k: 2.0 * p.x_max / (k * (p.m - 1)))  # grid.decode_sum's scale
    rng = np.random.default_rng(21)
    double_differs = 0
    for n in range(1, 90):
        z = _sum_for(name, n, rng)
        count = torch.tensor(n, dtype=torch.int32)
        got = mech.decode_sum(torch.from_numpy(z), count).numpy()
        jitted = np.asarray(jdecode(jnp.asarray(z), jnp.int32(n)))
        fixed = mech.decode_sum(torch.from_numpy(z), n).numpy()
        double_differs += not np.array_equal(fixed, got)
        if name in ("pbm", "none"):
            np.testing.assert_array_equal(got, jitted, err_msg=f"n={n}")
            continue
        scale = np.asarray(jscale(jnp.int32(n)))
        assert grid.decode_scale_dev(count, mech.params).numpy() == scale, n
        literal = np.asarray(-p.x_max + jnp.asarray(z).astype(jnp.float32) * jnp.asarray(scale))
        np.testing.assert_array_equal(got, literal, err_msg=f"n={n}")
        # one FMA contraction: half an ulp of the product, at most 2 x_max
        fma = np.spacing(np.float32(2.0 * p.x_max))
        assert np.abs(got.astype(np.float64) - jitted).max() <= fma, n
    assert double_differs == DOUBLE_DIFFERS[name]


# ---------------------------------------------------------------------------
# one reference round, replayed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_hetero_round():
    """One perround, materialized rqm round of the reference under a
    Poisson cohort with dropout, with everything needed to replay it."""
    # seed 3: a slate of 5 with 4 selected, 2 of them not dropped out
    jtr = JaxFedTrainer(jmechs.make_mechanism(SPEC),
                        JaxFedConfig(engine="perround", collect_sums=True, seed=3,
                                     **{**SMALL, **HETERO["both"]}))
    _, k_sample, k_enc, k_drop = jcohort.split_round_keys(jtr.cfg, jtr._key)
    ids, valid = jcohort.sample_slate(jtr.cfg, jtr.slate, k_sample)
    part = jcohort.participation(jtr.cfg, valid, k_drop)
    grads = jtr._client_grads(jtr.flat, jrounds.index_batch(jtr.client_data, ids))
    flat0 = np.array(jtr.flat)
    jtr.round()
    n = int(jtr.realized_n[-1])
    z_sum = np.array(jtr.round_sums[-1])
    # the reference's decode at a traced n and SGD, op by op (no fusion)
    g_hat = jtr.mech.decode_sum(jnp.asarray(z_sum), jnp.int32(max(n, 1)))
    literal, _ = jax_sgd().update(g_hat, (), jnp.asarray(flat0), jtr.cfg.lr)
    return {"name": "both", "jtr": jtr, "slate": jtr.slate, "ids": np.array(ids),
            "part": np.array(part), "n": n, "seed": int(np.asarray(jops.key_to_seed(k_enc))),
            "grads": np.array(grads), "flat0": flat0, "flat1": np.array(jtr.flat),
            "sum": z_sum, "literal": np.array(literal), "g_hat": np.array(g_hat)}


@pytest.mark.parametrize("path", ["materialized", "fused packed", "fused dense"])
def test_reference_hetero_round_replayed(reference_hetero_round, path, record_property):
    ref = reference_hetero_round
    assert 0 < ref["n"] < ref["part"].shape[0] and ref["part"].sum() == ref["n"]
    fused = path.startswith("fused")
    cfg = FedConfig(engine="perround", collect_sums=True, fused_rounds=fused, seed=3,
                    wire_packed=None if path == "fused packed" else False,
                    **{**SMALL, **HETERO[ref["name"]]})
    mech = make_mechanism(SPEC)
    slate = cohort.base_slate(cfg)
    assert slate == ref["slate"]
    assert (rounds.hot_path_pack_bits(mech, cfg, slate) is not None) == (path == "fused packed")
    handed = torch.from_numpy(ref["grads"])
    step = rounds.make_round_step(mech, cfg, slate, lambda flat, batch: handed)
    data = {"ids": torch.arange(SMALL["num_clients"])}
    new, _, z_sum = step(torch.from_numpy(ref["flat0"]), (), data, ids=ref["ids"],
                         seed=ref["seed"], part=torch.from_numpy(ref["part"]).to(torch.int32))
    np.testing.assert_array_equal(z_sum.numpy(), ref["sum"])
    got = new.numpy()
    np.testing.assert_array_equal(got, ref["literal"])
    # the reference's 1-ULP contract: lr x one ulp of 2 x_max, plus one of the output
    tol = SMALL["lr"] * np.spacing(np.float32(2.0 * mech.params.x_max)) \
        + np.spacing(np.maximum(np.abs(got), np.abs(ref["flat0"])).astype(np.float32))
    assert np.all(np.abs(got - ref["flat1"]) <= tol)
    record_property(f"{ref['name']}_{path}_params_differing_from_jitted_round",
                    int(np.count_nonzero(got != ref["flat1"])))


def test_realized_accounting_matches_reference(reference_hetero_round):
    jtr = reference_hetero_round["jtr"]
    tr = FedTrainer(SPEC, FedConfig(engine="perround", **{**SMALL, **HETERO["dropout"]}),
                    device="cpu")
    for n in (0, 1, 2, 3, 4, 7):
        want = np.asarray(jtr._eps_vector(n))
        np.testing.assert_allclose(tr._eps_vector(n), want, rtol=1e-9, atol=1e-12)
    assert not tr._eps_vector(0).any()
    assert tr._eps_vector(4) is tr.per_round_eps  # the nominal size's vector, memoized


# ---------------------------------------------------------------------------
# the port's engines against each other
# ---------------------------------------------------------------------------


def _train(spec=ENGINE_SPEC, rounds_=ROUNDS, **overrides):
    tr = FedTrainer(spec, FedConfig(collect_sums=True, **{**SMALL, **overrides}), device="cpu")
    if tr.engine.blocked:
        tr.run_block(rounds_)
    else:
        for _ in range(rounds_):
            tr.round()
    return tr


def _same(a, b, what):
    assert torch.equal(a.flat, b.flat), what
    assert a.realized_n == b.realized_n, what
    assert len(a.round_sums) == len(b.round_sums) == len(a.realized_n), what
    for x, y in zip(a.round_sums, b.round_sums):
        np.testing.assert_array_equal(x, y, err_msg=what)
    assert all(np.array_equal(x, y) for x, y in zip(a.accountant.history,
                                                   b.accountant.history)), what


@pytest.mark.parametrize("name,fused", [("both", False), ("both", True)], ids=str)
def test_engines_agree_bit_for_bit(name, fused):
    kw = dict(HETERO[name], fused_rounds=fused)
    scan = _train(**kw)
    assert scan.hetero and len(scan.realized_n) == ROUNDS
    for engine in ("perround", "shard"):
        _same(scan, _train(engine=engine, **kw), f"{name} {engine}")
    if name == "both":
        _same(scan, _train(engine="shard", staging="stream", scan_block=1, **kw),
              f"{name} streamed shard")
    for vec, n in zip(scan.accountant.history, scan.realized_n):
        np.testing.assert_array_equal(vec, scan._eps_vector(n))


@pytest.mark.parametrize("fused", [False, True], ids=["materialized", "fused"])
def test_empty_round_moves_nothing(fused):
    for engine in ("scan", "perround"):
        tr = FedTrainer(ENGINE_SPEC, FedConfig(engine=engine, server_opt="momentum",
                                               dropout=0.999, fused_rounds=fused, **SMALL),
                        device="cpu")
        before = tr.flat.clone()
        tr.train(2, eval_every=2, **QUIET)
        assert tr.realized_n == [0, 0]
        assert torch.equal(tr.flat, before)
        assert not tr.opt_state["m"].any()
        assert tr.accountant.rdp_epsilon(8.0) == 0.0
    # plain SGD (on the fused kernel's _dev path, dense and packed)
    for packed in ((None, False) if fused else (None,)):
        tr = FedTrainer(ENGINE_SPEC, FedConfig(dropout=0.999, fused_rounds=fused,
                                               wire_packed=packed if fused else None,
                                               **SMALL), device="cpu")
        before = tr.flat.clone()
        tr.run_block(2)
        assert tr.realized_n == [0, 0] and torch.equal(tr.flat, before)


@pytest.mark.parametrize("engine", ["scan", "perround"])
def test_budget_halt_overshoots_at_most_one_round(engine):
    probe = FedTrainer(ENGINE_SPEC, FedConfig(**SMALL), device="cpu")
    acc = RenyiAccountant(alphas=probe.cfg.accountant_alphas)
    budget = acc.projected_dp_epsilon(1e-5, probe.per_round_eps, 3)[0]
    tr = FedTrainer(ENGINE_SPEC, FedConfig(engine=engine, dropout=0.5, budget_eps=budget,
                                           **SMALL), device="cpu")
    hist = tr.train(12, eval_every=4, **QUIET)
    spent = tr.budget_spent()[0]
    before = RenyiAccountant(alphas=tr.cfg.accountant_alphas)
    for vec in tr.accountant.history[:-1]:
        before.step(vec)
    assert tr.accountant.rounds < 12
    assert spent <= budget or before.dp_epsilon(1e-5)[0] <= budget
    assert hist[-1]["round"] == tr.accountant.rounds


def test_hetero_resume_is_bit_for_bit(tmp_path):
    cfg = FedConfig(ckpt_dir=str(tmp_path), ckpt_every=2, **{**SMALL, **HETERO["both"]})
    # the noise-free mechanism: resuming depends on the round stream, not the encode
    full = FedTrainer("none:c=0.05", cfg, device="cpu")
    full.train(4, eval_every=2, **QUIET)
    res = FedTrainer("none:c=0.05", cfg, device="cpu")
    assert res.restore_checkpoint(2) == 2
    assert res.realized_n == full.realized_n[:2]
    res.train(2, eval_every=2, **QUIET)
    assert torch.equal(full.flat, res.flat) and full.realized_n == res.realized_n
    assert all(np.array_equal(a, b) for a, b in zip(full.accountant.history,
                                                   res.accountant.history))


def test_four_gloo_ranks_hetero(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    store = tmp_path / "store"
    worker = os.path.join(ROOT, "tests", "torch_hetero_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), "4", str(store)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-3000:]}"
        assert f"rank {r}: ALL HETERO SHARD CHECKS PASS" in out
