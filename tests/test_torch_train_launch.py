"""The LM training launcher of the port (``launch/train.py``) and its
example (``examples/train_lm_rqm_torch.py``) on the CPU, reduced configs:

  * a plain run: finite losses, the parameters moved, one tracker record
    a step;
  * ``--resume`` from the checkpoint at step 2 == the uninterrupted run
    of 4 steps, bit for bit (parameters and optimizer state), sgd and
    adam; a mismatched ``--server-opt`` refused with the reference's
    message;
  * ``--target-eps``'s knob == the reference's ``calibrate`` at the
    plan's cohort;
  * ``--fed-lm`` through the port's FedTrainer, with the reference's
    refusals;
  * ``--mesh-shape 2x2`` (a model axis of 2) refused naming queue A item
    12; ``--mesh-shape 4`` without a process group refused naming
    torchrun; a one-rank plan (gloo) == the plain run bit for bit,
    packed and not;
  (four gloo ranks: tests/test_torch_train_ranks.py);
  * the example's ``--compare`` (none, rqm, pbm).
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import importlib.util
import json
import os
import shutil

import pytest
import torch

from repro.privacy.calibrate import calibrate as jax_calibrate
from repro_torch.convert import leaves
from repro_torch.launch import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--arch", "mamba2-370m", "--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
        "--log-every", "1", "--seed", "1"]
# the runs that test the launcher's plumbing encode with QMGeo: its plain
# version takes 0.3 s a step at this size, RQM's 1.3 s
QMGEO = ["--mechanism", "qmgeo"]


def _equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_plain_run_trains_and_tracks(tmp_path, capsys):
    track = tmp_path / "lm.json"
    out = train.main(BASE + ["--steps", "3", "--track", f"json:{track}"])
    assert len(out["losses"]) == 3 and all(torch.isfinite(torch.tensor(out["losses"])))
    assert set(out["metrics"]) == {"loss", "ce_loss", "moe_aux_loss"}
    text = capsys.readouterr().out
    assert "[privacy] rqm:" in text and "n_clients=1" in text and "step     3" in text
    doc = json.loads(track.read_text())
    assert [r["round"] for r in doc["rounds"]] == [1, 2, 3]
    assert doc["meta"]["engine"] == "lm_step" and doc["meta"]["backend"] == "cpu"


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_resume_matches_the_uninterrupted_run(tmp_path, opt):
    full = train.main(BASE + QMGEO + ["--steps", "4", "--server-opt", opt, "--ckpt-every",
                                      "2", "--ckpt-dir", str(tmp_path / "a")])
    os.makedirs(tmp_path / "b")
    shutil.copy(tmp_path / "a" / "step_00000002.npz", tmp_path / "b")
    resumed = train.main(BASE + QMGEO + ["--steps", "4", "--server-opt", opt, "--resume",
                                         "--ckpt-dir", str(tmp_path / "b")])
    assert resumed["start"] == 2
    assert _equal(resumed["params"], full["params"])
    assert _equal(resumed["opt_state"], full["opt_state"])
    assert resumed["losses"] == full["losses"][2:]
    other = "adam" if opt == "sgd" else "sgd"
    with pytest.raises(SystemExit, match="different --server-opt than"):
        train.main(BASE + QMGEO + ["--steps", "4", "--server-opt", other, "--resume",
                                   "--ckpt-dir", str(tmp_path / "b")])


def test_target_eps_knob_matches_reference(capsys):
    out = train.main(BASE + ["--steps", "2", "--target-eps", "30", "--mesh-shape", "1"])
    want = jax_calibrate("rqm", target_eps=30.0, target_delta=1e-5, rounds=2, cohort=1,
                         c=0.02, m=16, delta_ratio=1.0)
    assert out["mechanism"].params.q == want.mechanism.params.q
    assert out["mechanism"].describe() == want.mechanism.describe()
    assert "[privacy] calibrated rqm:" in capsys.readouterr().out


def test_fed_lm_and_its_refusals(capsys):
    out = train.main(BASE + QMGEO + ["--fed-lm", "--steps", "2", "--clients", "8", "--cohort",
                                     "2", "--fed-engine", "perround", "--batch", "1"])
    assert len(out["trainer"].realized_n) == 2
    assert "[fed-lm] task=lm:batch=1,model=mamba2-370m,seq_len=16" in capsys.readouterr().out
    for extra in (["--target-eps", "10"], ["--mesh-shape", "2"]):
        with pytest.raises(SystemExit):
            train.main(BASE + ["--fed-lm", "--steps", "1"] + extra)
    with pytest.raises(SystemExit):
        train.main([a for a in BASE if a != "--reduced"] + ["--fed-lm", "--steps", "1"])


def test_plans_refused_and_one_rank_plan_equals_plain():
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        train.main(BASE + ["--steps", "1", "--mesh-shape", "2x2"])
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        train.main(BASE + ["--steps", "1", "--mesh-shape", "4"])
    plain = train.main(BASE + QMGEO + ["--steps", "2"])
    for packed in ([], ["--packed"]):
        one = train.main(BASE + QMGEO + ["--steps", "2", "--mesh-shape", "1"] + packed)
        assert _equal(one["params"], plain["params"]) and one["losses"] == plain["losses"]


def test_example_compare(capsys):
    spec = importlib.util.spec_from_file_location(
        "train_lm_rqm_torch", os.path.join(ROOT, "examples", "train_lm_rqm_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    final = example.main(["--arch", "mamba2-370m", "--steps", "2", "--batch", "2", "--seq",
                          "16", "--compare", "--device", "cpu"])
    assert set(final) == {"none", "rqm", "pbm"}
    assert all(torch.isfinite(torch.tensor(v)) for v in final.values())
    assert "final ce:" in capsys.readouterr().out
