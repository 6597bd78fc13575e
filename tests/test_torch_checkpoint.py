"""The port's checkpoint/resume (src/repro_torch/checkpoint,
``fed/checkpointing.py``) and the privacy-budget halt, on the CPU, at the
suite's small problem (24 clients, cohorts of 6), against the JAX
reference where the two must agree.

Contracts (``tests/test_checkpoint_resume.py``'s, for the port):
  * the store names a leaf as ``jax.tree_util.keystr`` does, round-trips
    float32, bfloat16, int32 0-d, float64, int64 and uint8 leaves exactly
    (numpy leaves as numpy, tensors as tensors), checks presence, shape
    and dtype, and reads a reference checkpoint's arrays;
  * a run that checkpoints, is restored mid-way into a fresh trainer and
    trains on equals the uninterrupted run bit for bit (parameters,
    optimizer state, round stream, accountant history) on scan, perround
    and one-rank gloo shard, for sgd, momentum and adam, and across a
    budget halt;
  * checkpoints land on ckpt_every multiples, and round numbers continue
    after a resume;
  * the fingerprint refuses a changed mechanism, a changed config field
    and a reference checkpoint, and hashes the reference's blob but for
    its trajectory family;
  * with budget_eps set, train() halts at the reference's round with the
    reference's eps_spent (rqm, pbm; to 1e-12 relative).

The tests that need no privacy cost run the noise-free mechanism, whose
rounds are cheap on the CPU; the quantizing ones run rqm.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import hashlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.core.mechanisms import make_mechanism as jax_make_mechanism
from repro.fed import checkpointing as jcheckpointing
from repro.fed.config import FedConfig as JaxFedConfig
from repro.fed.trainer import FedTrainer as JaxFedTrainer
from repro_torch.checkpoint import store
from repro_torch.core.renyi import RenyiAccountant
from repro_torch.fed import checkpointing
from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer

SMALL = dict(num_clients=24, clients_per_round=6, lr=1.0, eval_size=64,
             samples_per_client=8)
NONE, RQM, PBM = "none:c=0.05", "rqm:c=0.05,m=16,q=0.42", "pbm:c=0.05,m=16,theta=0.25"
ROUNDS, MID = 4, 2
QUIET = dict(log=lambda *_: None)
EPS_RTOL = 1e-12


def _trainer(engine="scan", spec=NONE, **overrides):
    kw = {"shards": 1} if engine == "shard" else {}
    return FedTrainer(spec, FedConfig(engine=engine, scan_block=3, **kw,
                                      **{**SMALL, **overrides}), device="cpu")


def _train(tr, rounds_, eval_every=None):
    return tr.train(rounds=rounds_, eval_every=eval_every or rounds_, **QUIET)


def _assert_same_run(a, b):
    assert torch.equal(a.flat, b.flat)
    if isinstance(a.opt_state, dict):
        assert sorted(a.opt_state) == sorted(b.opt_state)
        for k, v in a.opt_state.items():
            assert v.dtype == b.opt_state[k].dtype and torch.equal(v, b.opt_state[k]), k
    else:
        assert a.opt_state == b.opt_state == ()
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.realized_n == b.realized_n
    assert len(a.accountant.history) == len(b.accountant.history)
    for t, (x, y) in enumerate(zip(a.accountant.history, b.accountant.history)):
        np.testing.assert_array_equal(x, y, err_msg=f"round {t}")
    assert a.accountant.dp_epsilon(1e-5) == b.accountant.dp_epsilon(1e-5)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def _tree():
    rng = np.random.default_rng(0)
    return {
        "flat": torch.from_numpy(rng.normal(size=7).astype(np.float32)),
        "opt": {"m": torch.from_numpy(rng.normal(size=7).astype(np.float32)).bfloat16(),
                "v": torch.ones(7), "t": torch.tensor(3, dtype=torch.int32)},
        "key": torch.Generator().manual_seed(5).get_state(),
        "eps_history": rng.normal(size=(3, 5)),
        "realized_n": np.asarray([6, 6, 5], np.int64),
        "pair": (torch.zeros(2, dtype=torch.int64), [np.float64(2.5)]),
        "f64": torch.linspace(-1, 1, 5, dtype=torch.float64) / 3,
        "empty": (),
    }


def test_leaf_names_match_reference():
    numpy_tree = {"flat": np.zeros(3), "opt": {"v": np.ones(2), "m": np.ones(2),
                                              "t": np.int32(1)},
                  "key": np.zeros(4, np.uint8), "eps_history": np.zeros((2, 5)),
                  "realized_n": np.zeros(2, np.int64), "pair": (np.zeros(1), [np.ones(1)]),
                  "empty": (), "none": None}
    want = [name for name, _ in jstore._flatten_with_names(numpy_tree)]
    assert [name for name, _ in store._flatten_with_names(numpy_tree)] == want
    assert want[:3] == ["['eps_history']", "['flat']", "['key']"]
    assert "['opt']['m']" in want and "['pair'][1][0]" in want


def test_store_round_trips_every_leaf_type(tmp_path):
    tree = _tree()
    path = store.save(str(tmp_path), 7, tree)
    assert path.endswith("step_00000007.npz") and store.latest_step(str(tmp_path)) == 7
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000007.npz"]  # no tmp left
    with np.load(path) as data:
        assert data["['opt']['m']"].dtype == np.float32  # bfloat16's upcast
    got = store.restore(str(tmp_path), 7, _tree())
    for (name, a), (_, b) in zip(store._flatten_with_names(tree),
                                 store._flatten_with_names(got)):
        assert type(a) is type(b) or isinstance(a, np.generic), name
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        else:
            assert np.asarray(a).dtype == b.dtype, name
            np.testing.assert_array_equal(a, b)
    assert got["empty"] == () and isinstance(got["pair"], tuple)
    assert store.latest_step(str(tmp_path / "nowhere")) is None


def test_store_checks_presence_shape_and_dtype(tmp_path):
    store.save(str(tmp_path), 1, {"a": torch.zeros(3), "b": np.zeros(2, np.int64)})
    with pytest.raises(KeyError, match="missing leaf"):
        store.restore(str(tmp_path), 1, {"c": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        store.restore(str(tmp_path), 1, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        store.restore(str(tmp_path), 1, {"a": torch.zeros(3, dtype=torch.float64)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        store.restore(str(tmp_path), 1, {"b": np.zeros(2, np.int32)})


def test_reference_checkpoint_restores_into_port_store(tmp_path):
    """The reference's npz of a trainer-like tree: the port's store reads
    its parameters, eps history and cohort sizes exactly."""
    rng = np.random.default_rng(1)
    flat = rng.normal(size=222).astype(np.float32)
    hist = rng.uniform(size=(3, 5))
    tree = {"flat": jnp.asarray(flat), "opt": {"m": jnp.asarray(flat * 2)},
            "key": np.zeros(2, np.uint32), "eps_history": hist,
            "realized_n": np.asarray([6, 6, 6], np.int64)}
    jstore.save(str(tmp_path), 3, tree)
    got = store.restore(str(tmp_path), 3, {
        "flat": torch.zeros(222), "opt": {"m": torch.zeros(222)},
        "eps_history": np.zeros((3, 5)), "realized_n": np.zeros(3, np.int64)})
    np.testing.assert_array_equal(got["flat"].numpy(), flat)
    np.testing.assert_array_equal(got["opt"]["m"].numpy(), flat * 2)
    np.testing.assert_array_equal(got["eps_history"], hist)  # float64, exact
    assert got["realized_n"].dtype == np.int64 and list(got["realized_n"]) == [6, 6, 6]


# ---------------------------------------------------------------------------
# resume, bit for bit
# ---------------------------------------------------------------------------


def _resume_case(tmp_path, engine, spec=NONE, **overrides):
    """Train ROUNDS rounds with checkpoints every MID; a fresh trainer
    restores MID and trains the rest. Returns (uninterrupted, resumed)."""
    ckpt = str(tmp_path / engine)
    full = _trainer(engine, spec, ckpt_dir=ckpt, ckpt_every=MID, **overrides)
    _train(full, ROUNDS)
    res = _trainer(engine, spec, ckpt_dir=ckpt, ckpt_every=MID, **overrides)
    assert res.restore_checkpoint(step=MID) == MID
    assert res.accountant.rounds == MID and len(res.realized_n) == MID
    _train(res, ROUNDS - MID)
    return full, res


@pytest.mark.parametrize("engine,opt,spec", [
    ("scan", "sgd", RQM), ("scan", "momentum", NONE), ("scan", "adam", NONE),
    ("perround", "sgd", NONE), ("perround", "momentum", NONE), ("perround", "adam", NONE),
    ("shard", "sgd", NONE), ("shard", "momentum", NONE), ("shard", "adam", NONE),
], ids=lambda v: v.split(":")[0])
def test_resumed_equals_uninterrupted(tmp_path, engine, opt, spec):
    full, res = _resume_case(tmp_path, engine, spec, server_opt=opt)
    _assert_same_run(full, res)
    if opt == "adam":
        assert int(res.opt_state["t"]) == ROUNDS


def test_uninterrupted_run_is_the_run_without_checkpoints(tmp_path):
    """Checkpointing splits blocks at its multiples and changes nothing;
    checkpoints land on the multiples even when eval_every does not."""
    ckpt = tmp_path / "cadence"
    tr = _trainer(ckpt_dir=str(ckpt), ckpt_every=2, server_opt="momentum")
    hist = _train(tr, 6, eval_every=5)
    assert sorted(int(p.name[5:-4]) for p in ckpt.glob("*.npz")) == [2, 4, 6]
    assert store.latest_step(str(ckpt)) == 6
    assert [h["round"] for h in hist] == [2, 4, 6]  # an eval point at each split
    plain = _trainer(server_opt="momentum")
    _train(plain, 6, eval_every=5)
    _assert_same_run(plain, tr)


def test_explicit_save_and_latest_restore(tmp_path):
    ckpt = str(tmp_path / "explicit")
    a = _trainer(ckpt_dir=ckpt, server_opt="adam")
    _train(a, 3)
    a.save_checkpoint()
    b = _trainer(ckpt_dir=ckpt, server_opt="adam")
    assert b.restore_checkpoint() == 3  # the latest by default
    _train(a, 2)
    _train(b, 2)
    _assert_same_run(a, b)


def test_round_numbers_continue_after_resume(tmp_path):
    ckpt = str(tmp_path / "roundno")
    _train(_trainer(ckpt_dir=ckpt, ckpt_every=MID), ROUNDS)
    b = _trainer(ckpt_dir=ckpt, ckpt_every=MID)
    b.restore_checkpoint(step=MID)
    hist = _train(b, ROUNDS - MID, eval_every=1)
    assert [h["round"] for h in hist] == list(range(MID + 1, ROUNDS + 1))


def test_errors(tmp_path):
    with pytest.raises(ValueError, match="ckpt_dir"):
        _trainer().save_checkpoint()
    with pytest.raises(ValueError, match="ckpt_dir"):
        _trainer().restore_checkpoint()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        _trainer(ckpt_dir=str(tmp_path / "empty")).restore_checkpoint()
    with pytest.raises(ValueError, match="no privacy budget"):
        _trainer().budget_spent()
    for bad, match in [(dict(ckpt_every=-1, ckpt_dir="x"), "ckpt_every must be"),
                       (dict(ckpt_every=2), "ckpt_every requires ckpt_dir"),
                       (dict(max_cohort=8), "max_cohort only applies"),
                       (dict(subsampling="bernoulli"), "unknown subsampling"),
                       (dict(dropout=1.0), "dropout must be in"),
                       (dict(server_opt="lion"), "unknown optimizer")]:
        with pytest.raises(ValueError, match=match):
            _trainer(**bad)
    with pytest.raises(TypeError):
        _trainer(server_opt="momentum", server_opt_options={"b1": 0.9})


# ---------------------------------------------------------------------------
# the fingerprint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    """A reference trainer (noise-free, momentum) and its checkpoint at
    round 0."""
    ckpt = str(tmp_path_factory.mktemp("reference"))
    jtr = JaxFedTrainer(jax_make_mechanism(NONE),
                        JaxFedConfig(server_opt="momentum", ckpt_dir=ckpt, **SMALL))
    jtr.save_checkpoint()
    return jtr, ckpt


def test_fingerprint_rejects_changed_mechanism_config_or_package(tmp_path,
                                                                 reference_checkpoint):
    ckpt = str(tmp_path / "fp")
    a = _trainer(ckpt_dir=ckpt, server_opt="momentum")
    _train(a, 2)
    a.save_checkpoint()
    for wrong in (_trainer(spec="none:c=0.1", ckpt_dir=ckpt, server_opt="momentum"),
                  _trainer(ckpt_dir=ckpt, server_opt="momentum", lr=0.5),
                  _trainer(ckpt_dir=ckpt, server_opt="momentum",
                           server_opt_options={"beta": 0.5}),
                  _trainer(ckpt_dir=ckpt)):  # sgd: no "m" leaf, still the fingerprint
        with pytest.raises(ValueError, match="fingerprint"):
            wrong.restore_checkpoint()
    # another ported engine is the same trajectory: fine, and bit-identical
    cross = _trainer("perround", ckpt_dir=ckpt, server_opt="momentum")
    assert cross.restore_checkpoint() == 2
    _train(a, 2)
    _train(cross, 2)
    _assert_same_run(a, cross)
    # the reference's checkpoint (its jax.random key stream) is refused
    jtr, ref_ckpt = reference_checkpoint
    port = _trainer(ckpt_dir=ref_ckpt, server_opt="momentum")
    with pytest.raises(ValueError, match="fingerprint"):
        port.restore_checkpoint()


def test_fingerprint_blob_is_the_reference_but_for_the_trajectory(reference_checkpoint):
    jtr, ckpt = reference_checkpoint
    port = _trainer(ckpt_dir=ckpt, server_opt="momentum")
    fields = checkpointing.fingerprint_fields(port)
    assert fields["trajectory"] == "torch" and fields["task"] == "emnist_cnn"
    assert tuple(checkpointing._FINGERPRINT_FIELDS) == tuple(jcheckpointing._FINGERPRINT_FIELDS)
    assert port.mech.spec() == jtr.mech.spec()
    as_device = checkpointing.fingerprint_blob(port.mech.spec(),
                                               {**fields, "trajectory": "device"})
    want = np.asarray(jcheckpointing.fingerprint(jtr))
    assert hashlib.sha256(as_device.encode()).digest() == bytes(want)
    assert not np.array_equal(checkpointing.fingerprint(port), want)
    # engine, staging, budget and cadence are not fingerprinted
    other = _trainer("perround", budget_eps=30.0, ckpt_dir="elsewhere", ckpt_every=3,
                     server_opt="momentum", server_opt_options={})
    assert np.array_equal(checkpointing.fingerprint(other), checkpointing.fingerprint(port))


# ---------------------------------------------------------------------------
# the privacy-budget halt
# ---------------------------------------------------------------------------


def _budget_for(spec, rounds_):
    """The eps that ``rounds_`` rounds spend, plus half a round's."""
    tr = _trainer(spec=spec)
    acc = RenyiAccountant(alphas=tr.cfg.accountant_alphas)
    at = [acc.projected_dp_epsilon(1e-5, tr.per_round_eps, k)[0] for k in (rounds_, rounds_ + 1)]
    return at[0] + (at[1] - at[0]) / 2


@pytest.mark.parametrize("spec", [RQM, PBM], ids=["rqm", "pbm"])
def test_budget_halt_matches_reference(spec):
    budget = _budget_for(spec, 2)
    jtr = JaxFedTrainer(jax_make_mechanism(spec),
                        JaxFedConfig(engine="perround", budget_eps=budget, **SMALL))
    jhist = jtr.train(rounds=10, eval_every=5, **QUIET)
    tr = _trainer(spec=spec, budget_eps=budget)
    assert tr.accountant.rounds_within_budget(budget, 1e-5, tr.per_round_eps) == 2
    hist = tr.train(rounds=10, eval_every=5, **QUIET)
    assert jtr.accountant.rounds == tr.accountant.rounds == 2
    assert [h["round"] for h in hist] == [h["round"] for h in jhist] == [2]
    spent, remaining = tr.budget_spent()
    jspent, jremaining = jtr.budget_spent()
    assert math.isclose(spent, jspent, rel_tol=EPS_RTOL)
    assert math.isclose(hist[-1]["eps_spent"], jhist[-1]["eps_spent"], rel_tol=EPS_RTOL)
    assert spent <= budget < tr.accountant.projected_dp_epsilon(1e-5, tr.per_round_eps, 1)[0]
    assert math.isclose(remaining, budget - spent, rel_tol=EPS_RTOL)


def test_mid_budget_resume(tmp_path):
    """Resume from a checkpoint taken before the halt: the resumed run
    halts at the same round with the same eps spent and parameters."""
    ckpt = str(tmp_path / "budget")
    budget = _budget_for(RQM, 3)
    full = _trainer(spec=RQM, budget_eps=budget, ckpt_dir=ckpt, ckpt_every=2)
    _train(full, 10, eval_every=10)
    assert full.accountant.rounds == 3
    res = _trainer(spec=RQM, budget_eps=budget, ckpt_dir=ckpt, ckpt_every=2)
    assert res.restore_checkpoint(step=2) == 2
    assert res.budget_spent()[1] > 0
    _train(res, 8, eval_every=10)
    _assert_same_run(full, res)
    assert res.budget_spent() == full.budget_spent()


def test_accountant_matches_reference():
    """history, total_rdp, the projection and rounds_within_budget, against
    the reference's accountant on the same per-round vectors, exactly."""
    from repro.core.renyi import RenyiAccountant as JaxAccountant

    rng = np.random.default_rng(3)
    alphas = (2.0, 4.0, 8.0, 16.0, 32.0)
    acc, jacc = RenyiAccountant(alphas=alphas), JaxAccountant(alphas=alphas)
    for _ in range(4):
        vec = rng.uniform(0.5, 3.0, len(alphas))
        acc.step(vec)
        jacc.step(vec)
        for a, b in zip(acc.history, jacc.history):
            np.testing.assert_array_equal(a, b)
        assert acc.total_rdp().tolist() == jacc.total_rdp().tolist()
        assert acc.dp_epsilon(1e-5) == jacc.dp_epsilon(1e-5)
        for k in (0, 1, 7):
            assert (acc.projected_dp_epsilon(1e-5, vec, k)
                    == jacc.projected_dp_epsilon(1e-5, vec, k))
        for budget in (1.0, 20.0, 60.0):
            assert (acc.rounds_within_budget(budget, 1e-5, vec)
                    == jacc.rounds_within_budget(budget, 1e-5, vec))
    assert acc.rounds_within_budget(40.0, 1e-5, np.zeros(5)) == math.inf
    assert acc.total_rdp() is not acc._eps
