"""The shard engine on its 2-D ("shard", "model") grid of gloo ranks
(``FedConfig(engine="shard", shards=S, model_shards=M)``), the port's
counterparts of tests/fed_lm_2d_checks.py's checks on its problem (the
lm task on a reduced mamba2-370m, RQM, 2 rounds; cohorts of 2 of 8 where
it takes 4), at
2x2 (four ranks), 1x2 and 2x1 (two each), side by side
(tests/torch_tp_worker.py ``fed``):

  1. the 2x2 grid trains the lm task end to end: finite parameters,
     bit-equal on every rank, the full cohorts accounted, a finite
     held-out loss;
  2. at a fixed model axis the trajectory does not depend on the shards:
     2x2 == 1x2 bit for bit, in every round's SecAgg sum and in the
     parameters (the cross-shard sum is an integer sum; the model axis
     sums the same values either way);
  3. the accountant sees the full cross-shard cohort, never a shard's or
     a model rank's count, so epsilon is exactly equal across tp (2x1).
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import pytest

import tp_cases
import tp_harness
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.fed.config import FedConfig


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_fed")
    procs, src = [], tmp / "none.npz"
    for grid in tp_cases.FED_GRIDS:
        S, M = (int(d) for d in grid.split("x"))
        procs += tp_harness.ranks("fed", S * M, tmp, src, grid)
    for out in tp_harness.wait(procs):
        assert "parameters bit-equal on every rank" in out, out
    return {grid: tp_harness.load(tmp / f"fed_{grid}.npz") for grid in tp_cases.FED_GRIDS}


def test_2d_grid_trains(runs):
    r = runs["2x2"]
    assert np.isfinite(r["flat"]).all()
    assert r["realized_n"].tolist() == [tp_cases.FED["clients_per_round"]] * 2
    assert np.isfinite(r["loss"]) and r["ppl"] > 1.0


def test_sums_and_parameters_independent_of_the_shards(runs):
    a, b = runs["1x2"], runs["2x2"]
    assert a["sums"].dtype == np.int32 and len(a["sums"]) == tp_cases.FED["rounds"]
    np.testing.assert_array_equal(a["sums"], b["sums"])
    np.testing.assert_array_equal(a["flat"].view(np.int32), b["flat"].view(np.int32))


def test_epsilon_accounts_the_full_cohort_exactly_across_tp(runs):
    mech, n = make_mechanism("rqm", c=0.05), tp_cases.FED["clients_per_round"]
    full = np.asarray([mech.per_round_epsilon(n, a) for a in FedConfig().accountant_alphas])
    r = runs["2x2"]
    np.testing.assert_array_equal(r["per_round_eps"], full)
    np.testing.assert_allclose(r["rdp8"], tp_cases.FED["rounds"]
                               * mech.per_round_epsilon(n, 8.0), rtol=1e-12)
    np.testing.assert_array_equal(runs["2x1"]["per_round_eps"], r["per_round_eps"])
    assert runs["2x1"]["realized_n"].tolist() == r["realized_n"].tolist()
