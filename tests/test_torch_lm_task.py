"""The client-task registry and the ``lm`` task in the port
(``repro_torch/fed/tasks.py``) on the CPU:

  * the registry mirrors the reference's (``tests/test_fed_tasks.py``):
    names in registration order, unknown tasks and options refused with
    the accepted set, canonical spec strings, prebuilt tasks passed
    through, the model-axis refusals;
  * ``make_task("lm:...")`` takes the reference's options and defaults for
    every arch, and its client and eval batches are the reference's;
  * on ``LM_TASK`` (the reference's tiny federated LM problem): the scan
    engine (eager on the CPU) == perround == one-rank shard, bit for bit
    in parameters and sums; host == scan under dropout (the host engine
    replays the round stream there); materialized == fused (packed and
    dense); the async plain corner == perround; a checkpointed run
    resumed continues bit for bit. The engines' agreement needs no
    reference, so these run the cheaper QMGeo encode; RQM's exactness on
    an lm round is ``tests/test_torch_lm_round.py``'s.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import inspect

import numpy as np
import pytest
import torch

from repro.fed import tasks as jtasks
from repro.fed.config import FedConfig as JaxFedConfig
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.fed.config import FedConfig, validate_config
from repro_torch.fed.tasks import (
    ClientTask, LmTask, get_task, make_task, task_names,
)
from repro_torch.fed.trainer import FedTrainer

SMALL = dict(num_clients=24, clients_per_round=6, rounds=5, lr=1.0, eval_size=64,
             samples_per_client=8)
# tests/test_fed_tasks.py's tiny federated LM problem (a shrunk
# mamba2-370m over 8 clients), in cohorts of 2 (the CPU encodes 1.1M
# coordinates a client)
LM_TASK = "lm:model=mamba2-370m,seq_len=16,batch=1"
LM_FED = dict(num_clients=8, clients_per_round=2, rounds=3, lr=0.5, samples_per_client=8,
              task=LM_TASK)
SPEC = "rqm:c=0.02,m=16,q=0.42"
# the engines' own agreement needs no exact reference: the cheaper encode
ENGINE_SPEC = "qmgeo:c=0.02,m=16,r=0.6"
ROUNDS = 3


def _trainer(engine="scan", spec=ENGINE_SPEC, **overrides):
    return FedTrainer(spec, FedConfig(engine=engine, **{**LM_FED, **overrides}), device="cpu")


def _train(tr, rounds_=ROUNDS):
    return tr.train(rounds=rounds_, eval_every=rounds_, log=lambda msg: None)


def _same(a, b, sums=True):
    assert torch.equal(a.flat, b.flat)
    assert a.realized_n == b.realized_n
    if sums:
        assert len(a.round_sums) == len(b.round_sums) == ROUNDS
        for x, y in zip(a.round_sums, b.round_sums):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the registry (tests/test_fed_tasks.py:82-141)
# ---------------------------------------------------------------------------


def test_registered_names_in_order():
    assert task_names() == ("emnist_cnn", "lm") == jtasks.task_names()
    assert get_task("lm") is LmTask and issubclass(LmTask, ClientTask)


def test_unknown_task_rejected():
    with pytest.raises(ValueError, match="unknown task"):
        get_task("gan")
    with pytest.raises(ValueError, match="unknown task"):
        FedTrainer(SPEC, FedConfig(task="gan", **SMALL), device="cpu")


def test_unknown_option_rejected_with_accepted_set():
    with pytest.raises(ValueError, match="does not accept.*accepted"):
        make_task("lm:window=9", FedConfig(**SMALL), "cpu")
    with pytest.raises(ValueError, match="does not accept"):
        make_task("emnist_cnn:batch=4", FedConfig(**SMALL), "cpu")


def test_spec_round_trips_canonically():
    cfg = FedConfig(**SMALL)
    t = make_task("lm:seq_len=32,batch=1", cfg, "cpu")
    assert t.spec() == "lm:batch=1,seq_len=32"  # sorted, canonical
    assert make_task(t.spec(), cfg, "cpu").spec() == t.spec()
    assert make_task("emnist_cnn", cfg, "cpu").spec() == "emnist_cnn"
    jcfg = JaxFedConfig(**SMALL)
    for spec in ("lm:seq_len=32,batch=1", "lm:model=gemma3-4b,eval_seed=3", "emnist_cnn"):
        assert make_task(spec, cfg, "cpu").spec() == jtasks.make_task(spec, jcfg).spec()


def test_prebuilt_task_passes_through():
    cfg = FedConfig(**SMALL)
    t = make_task("emnist_cnn", cfg, "cpu")
    assert make_task(t, cfg, "cpu") is t


def test_model_axis_refusals():
    t = make_task("emnist_cnn", FedConfig(**SMALL), "cpu")
    assert not t.supports_model_axis
    with pytest.raises(ValueError, match="model axis"):
        t.bind_model_axis(None)
    lm = make_task(LM_TASK, FedConfig(**LM_FED), "cpu")
    assert lm.supports_model_axis and jtasks.LmTask.supports_model_axis
    # the lm task binds a model axis: its parameters are then the global
    # tree at that tp, a rank's slices those of meta.shard_leaf (the
    # hooks' collectives run in tests/test_torch_tp_fed.py)
    from repro_torch.convert import leaves
    from repro_torch.models import meta as meta_lib
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import ParallelCtx

    ctx = ParallelCtx(model_axis="model", tp=2, model_group=object(), model_rank=1)
    lm.bind_model_axis(ctx)
    assert lm.tp == 2
    glob = lm.init_params(torch.Generator().manual_seed(0))
    m = model_lib.param_meta(lm.model_cfg, tp=2)
    assert [tuple(t.shape) for t in leaves(glob)] == [x.shape for x in leaves(m)]
    mine = lm.shard_params(glob, ctx)
    assert [tuple(t.shape) for t in leaves(mine)] == [meta_lib.local_shape(x, 2)
                                                       for x in leaves(m)]
    assert all(torch.equal(a, meta_lib.shard_leaf(b, x, 2, 1))
               for a, b, x in zip(leaves(mine), leaves(glob), leaves(m)))


def test_emnist_batch_pytree_shape():
    t = make_task("emnist_cnn", FedConfig(**SMALL), "cpu")
    b = t.client_batch(0)
    assert set(b) == {"images", "labels"}
    s = SMALL["samples_per_client"]
    assert b["images"].shape == (s, 28, 28) and b["labels"].shape == (s,)
    assert b["images"].nbytes + b["labels"].nbytes == s * (28 * 28 * 4 + 4)


def test_model_shards_validation():
    with pytest.raises(ValueError, match="model_shards"):
        validate_config(FedConfig(model_shards=0, **SMALL))
    with pytest.raises(ValueError, match="engine"):
        validate_config(FedConfig(engine="scan", model_shards=2, **SMALL))
    # the 2-D grid is admitted (tests/test_torch_tp_fed.py runs it)
    validate_config(FedConfig(engine="shard", model_shards=2, **LM_FED))


# ---------------------------------------------------------------------------
# the lm task against the reference's
# ---------------------------------------------------------------------------


def test_lm_options_and_defaults_match_reference():
    def options(cls, skip):
        return {k: p.default for k, p in inspect.signature(cls.__init__).parameters.items()
                if k not in skip}

    assert options(LmTask, ("self", "cfg", "device")) == options(jtasks.LmTask, ("self", "cfg"))
    assert options(LmTask, ("self", "cfg", "device"))["model"] == "mamba2-370m"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_task_builds_every_arch_with_the_reference_batches(arch):
    spec = f"lm:model={arch},seq_len=24,batch=2,eval_batch=3"
    cfg = dict(num_clients=4, clients_per_round=2, seed=5)
    t = make_task(spec, FedConfig(**cfg), "cpu")
    jt = jtasks.make_task(spec, JaxFedConfig(**cfg))
    assert t.spec() == jt.spec() and t.model_cfg.name == jt.model_cfg.name
    assert t.model_cfg.name.endswith("-reduced")
    for cid in (0, 3):
        got, want = t.client_batch(cid), jt.client_batch(cid)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for i in range(2):
        got, want = t._eval_pipe.batch(i), jt._eval_pipe.batch(i)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# the engines on the lm task
# ---------------------------------------------------------------------------


def test_scan_perround_shard_equal_bit_for_bit():
    runs = {e: _trainer(e, collect_sums=True) for e in ("scan", "perround")}
    runs["shard"] = _trainer("shard", shards=1, collect_sums=True)
    for tr in runs.values():
        _train(tr)
    _same(runs["scan"], runs["perround"])
    _same(runs["scan"], runs["shard"])
    assert np.isfinite(runs["scan"].flat.numpy()).all()


def test_host_equals_scan_under_dropout():
    """Heterogeneous cohorts: the host engine replays the round stream's
    draws, so its cohorts, realized sizes and eps are scan's, and on the
    CPU its parameters and sums too."""
    scan = _trainer("scan", collect_sums=True, dropout=0.3)
    host = _trainer("host", collect_sums=True, dropout=0.3)
    _train(scan)
    _train(host)
    _same(scan, host)
    for x, y in zip(scan.accountant.history, host.accountant.history):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("packed", [None, False], ids=["packed", "dense"])
def test_materialized_equals_fused(packed):
    mat = _trainer("perround", collect_sums=True)
    fused = _trainer("scan", collect_sums=True, fused_rounds=True, wire_packed=packed)
    assert (fused.pack_bits is None) == (packed is False)
    _train(mat)
    _train(fused)
    _same(mat, fused)


def test_async_plain_corner_equals_perround():
    a = _trainer("async", collect_sums=True)
    b = _trainer("perround", collect_sums=True)
    assert a.engine._plain
    _train(a)
    _train(b)
    _same(a, b)


def test_train_reports_loss_and_ppl_and_moves_parameters():
    tr = _trainer("scan")
    before = tr.flat.clone()
    ev = _train(tr)[-1]
    assert np.isfinite(ev["loss"]) and ev["ppl"] > 1.0 and "accuracy" not in ev
    np.testing.assert_allclose(ev["ppl"], np.exp(ev["loss"]), rtol=1e-12)
    assert not torch.equal(before, tr.flat)
    assert tr.flat.numel() == 1_096_032  # the reduced mamba2-370m


def test_checkpoint_resume_is_bit_for_bit(tmp_path):
    full = _trainer("scan", rounds=2, ckpt_dir=str(tmp_path / "a"), ckpt_every=1)
    _train(full, 2)
    res = _trainer("scan", rounds=2, ckpt_dir=str(tmp_path / "a"), ckpt_every=1)
    assert res.restore_checkpoint(step=1) == 1
    _train(res, 1)
    assert torch.equal(full.flat, res.flat)
    for x, y in zip(full.accountant.history, res.accountant.history):
        np.testing.assert_array_equal(x, y)
    # another task's checkpoint is another trajectory
    other = _trainer("scan", rounds=2, ckpt_dir=str(tmp_path / "a"), ckpt_every=1,
                     task="lm:model=mamba2-370m,seq_len=16,batch=1,branch=3")
    with pytest.raises(ValueError, match="fingerprint"):
        other.restore_checkpoint(step=1)
