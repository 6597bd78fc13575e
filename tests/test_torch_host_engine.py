"""The port's host engine (``FedConfig(engine="host")``, the reference's
legacy loop and benchmark baseline) on the CPU.

Contracts:
  * fixed cohorts are the reference's: ``sample_clients`` on numpy's
    ``default_rng(seed + 7)``, the same ids round after round;
  * a fixed round stacks its clients' data on the host, encodes each
    client with its own seed from the round stream (one quantize a
    client), sums, decodes at the cohort size and applies: its sum and
    parameters equal that recomputation bit for bit;
  * heterogeneous cohorts replay the round stream's draws: the realized
    sizes, the eps history, the sums and (on the CPU) the parameters equal
    the scan engine's bit for bit;
  * the ``host_rng`` checkpoint leaf packs numpy's PCG64 state as the
    reference does; a host run resumed from a checkpoint continues bit
    for bit, fixed or heterogeneous, and a host checkpoint is another
    trajectory than the device engines';
  * it times the reference's scopes and refuses fused rounds.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import numpy as np
import pytest
import torch

from repro.data.federated import sample_clients as jax_sample_clients
from repro.fed import checkpointing as jcheckpointing
from repro_torch.data.federated import sample_clients
from repro_torch.fed import checkpointing, cohort, engines
from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer

SMALL = dict(num_clients=24, clients_per_round=4, lr=1.0, eval_size=64,
             samples_per_client=8)
SPEC = "rqm:c=0.05,m=16,q=0.42"
# the engines' own agreement needs no exact reference: the cheaper encode
ENGINE_SPEC = "qmgeo:c=0.05,m=16,r=0.6"
QUIET = dict(log=lambda msg: None)


def _host(spec=SPEC, **overrides):
    return FedTrainer(spec, FedConfig(engine="host", **{**SMALL, **overrides}), device="cpu")


@pytest.mark.parametrize("seed", [0, 3])
def test_fixed_cohorts_are_the_reference_stream(monkeypatch, seed):
    seen = []
    stack = engines.HostEngine._stack

    def spy(self, ids):
        seen.append([int(i) for i in ids])
        return stack(self, ids)

    monkeypatch.setattr(engines.HostEngine, "_stack", spy)
    tr = _host("none:c=0.05", seed=seed)
    for _ in range(3):
        tr.round()
    ref, mine = np.random.default_rng(seed + 7), np.random.default_rng(seed + 7)
    want = [jax_sample_clients(ref, 24, 4).tolist() for _ in range(3)]
    assert seen == want
    assert [sample_clients(mine, 24, 4).tolist() for _ in range(3)] == want
    assert checkpointing.pack_host_rng(tr._rng).tolist() == \
        jcheckpointing.pack_host_rng(ref).tolist()


def test_fixed_round_encodes_each_client_with_its_own_seed():
    tr = _host(collect_sums=True)
    flat0 = tr.flat.clone()
    rng = np.random.default_rng(7)
    gen = torch.Generator()
    gen.set_state(tr.generator.get_state())
    tr.round()
    ids = sample_clients(rng, 24, 4)
    data = {k: torch.from_numpy(np.stack([tr.task.client_batch(int(i))[k] for i in ids]))
            for k in ("images", "labels")}
    grads = tr.client_grads(flat0, data)
    seeds = [cohort.draw_seed(gen) for _ in range(4)]
    z = torch.stack([tr.mech.quantize(grads[i], s) for i, s in enumerate(seeds)])
    want_sum = z.sum(0, dtype=torch.int32)
    np.testing.assert_array_equal(tr.round_sums[-1], want_sum.numpy())
    g_hat = tr.mech.decode_sum(want_sum, torch.tensor(4, dtype=torch.int32))
    assert torch.equal(tr.flat, flat0 - float(np.float32(SMALL["lr"])) * g_hat)
    assert torch.equal(tr.generator.get_state(), gen.get_state())
    assert tr.realized_n == [4]
    # a batch encode with one seed would give another sum
    assert not torch.equal(tr.mech.quantize_batch(grads, seeds[0]).sum(0), want_sum)


@pytest.mark.parametrize("hetero", [dict(dropout=0.4),
                                    dict(subsampling="poisson", max_cohort=6, dropout=0.2)],
                         ids=["dropout", "poisson+dropout"])
def test_hetero_host_equals_scan(hetero):
    host = _host(ENGINE_SPEC, collect_sums=True, **hetero)
    scan = FedTrainer(ENGINE_SPEC, FedConfig(collect_sums=True, **{**SMALL, **hetero}),
                      device="cpu")
    for _ in range(3):
        host.round()
    scan.run_block(3)
    assert host.realized_n == scan.realized_n
    assert all(np.array_equal(a, b) for a, b in zip(host.accountant.history,
                                                   scan.accountant.history))
    for a, b in zip(host.round_sums, scan.round_sums):
        np.testing.assert_array_equal(a, b)
    # the same ops on the same inputs: bit for bit on the CPU (chip_smoke.py
    # phase 5e holds the card to atol 1e-5, the reference's host tolerance)
    assert torch.equal(host.flat, scan.flat)
    assert torch.equal(host.generator.get_state(), scan.generator.get_state())


def test_host_rng_leaf_round_trips():
    rng = np.random.default_rng(11)
    rng.random(5)
    rng.integers(0, 10, 3, dtype=np.uint32)  # leaves a buffered uint32
    packed = checkpointing.pack_host_rng(rng)
    assert packed.dtype == np.uint64 and packed.shape == (6,)
    assert packed.tolist() == jcheckpointing.pack_host_rng(rng).tolist()
    again = checkpointing.unpack_host_rng(packed)
    ref = jcheckpointing.unpack_host_rng(packed)
    want = rng.integers(0, 1 << 30, 8).tolist()
    assert again.integers(0, 1 << 30, 8).tolist() == want == ref.integers(0, 1 << 30, 8).tolist()


@pytest.mark.parametrize("hetero", [dict(), dict(dropout=0.4)], ids=["fixed", "dropout"])
def test_host_resume_is_bit_for_bit(tmp_path, hetero):
    cfg = dict(ckpt_dir=str(tmp_path), ckpt_every=2, **hetero)
    full = _host(ENGINE_SPEC, **cfg)
    full.train(4, eval_every=2, **QUIET)
    res = _host(ENGINE_SPEC, **cfg)
    assert res.restore_checkpoint(2) == 2
    # fixed cohorts drew from the numpy stream, heterogeneous ones did not
    moved = checkpointing.pack_host_rng(res._rng).tolist() != \
        checkpointing.pack_host_rng(np.random.default_rng(7)).tolist()
    assert moved == (not hetero)
    res.train(2, eval_every=2, **QUIET)
    assert torch.equal(full.flat, res.flat)
    assert full.realized_n == res.realized_n
    assert checkpointing.pack_host_rng(full._rng).tolist() == \
        checkpointing.pack_host_rng(res._rng).tolist()
    # a host checkpoint is another trajectory than the device engines'
    scan = FedTrainer(ENGINE_SPEC, FedConfig(**{**SMALL, **cfg}), device="cpu")
    assert checkpointing.fingerprint_fields(scan)["trajectory"] == "torch"
    assert checkpointing.fingerprint_fields(res)["trajectory"] == "torch_host"
    with pytest.raises(ValueError, match="fingerprint"):
        scan.restore_checkpoint(2)


def test_host_times_the_reference_scopes_and_refuses_fused_rounds():
    tr = _host("none:c=0.05")
    tr.train(2, eval_every=2, **QUIET)
    assert {"stage", "grads", "encode", "secure_sum", "apply"} <= set(tr.timings.summary())
    assert tr.client_data is None and tr.staged_bytes_total == 0
    with pytest.raises(ValueError, match="does not support fused_rounds=True"):
        _host(fused_rounds=True)
