"""One rank of the port's four-rank shard-engine checks (gloo, CPU).

Started four times by tests/test_torch_shard.py::test_four_gloo_ranks:

    PYTHONPATH=src python tests/torch_shard_worker.py <rank> <world> <store file>

Each rank joins the default process group on a FileStore, runs the
checks of the reference's tests/shard_engine_checks.py against the
port's own scan engine (which tests/test_torch_materialized.py holds
against the reference), prints one line per check and exits 0 when all
hold. Imports no JAX.

  1. the shard engine's per-round encoded sums equal the scan engine's
     exactly, and the parameters bit for bit;
  2. packed == unpacked cross-shard sum (bit-equal parameters);
  3. streamed staging == full staging (bit-equal parameters);
  4. the float 'none' baseline allclose to scan (other reduction order);
  5. per-round epsilon accounts the full cross-shard cohort, not n / S;
  plus: a cohort that does not divide across the ranks is refused, and
  a rank's partial sum is not overwritten by the in-place all_reduce.
"""
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import secagg
from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer

SMALL = dict(num_clients=24, clients_per_round=8, lr=1.0, eval_size=64, samples_per_client=8)
ROUNDS = 4
SPEC = "rqm:c=0.05"


def _train(spec=SPEC, **overrides):
    tr = FedTrainer(spec, FedConfig(**{**SMALL, **overrides}), device="cpu")
    tr.run_block(ROUNDS)
    return tr


def main(rank: int, world: int, store_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    scan = _train(collect_sums=True)
    shard = _train(engine="shard", shards=world, collect_sums=True)
    assert shard.shards == world
    assert len(scan.round_sums) == len(shard.round_sums) == ROUNDS
    for t, (a, b) in enumerate(zip(scan.round_sums, shard.round_sums)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b, err_msg=f"round {t} encoded sums differ")
    assert torch.equal(scan.flat, shard.flat)
    print(f"rank {rank}: 1. encoded per-round sums == scan (exact); params bit-equal")

    unpacked = _train(engine="shard", shard_packed=False)
    assert torch.equal(unpacked.flat, shard.flat)
    print(f"rank {rank}: 2. packed == unpacked cross-shard sum")

    streamed = _train(engine="shard", staging="stream", scan_block=3)
    assert torch.equal(streamed.flat, shard.flat)
    per_rank = ROUNDS * (SMALL["clients_per_round"] // world) * SMALL["samples_per_client"] \
        * (28 * 28 * 4 + 4)
    assert streamed.staged_bytes_total == per_rank, streamed.staged_bytes_total
    print(f"rank {rank}: 3. streamed == full staging; {per_rank} bytes staged on this rank")

    none_scan = _train("none:c=0.05")
    none_shard = _train("none:c=0.05", engine="shard")
    np.testing.assert_allclose(none_scan.flat.numpy(), none_shard.flat.numpy(),
                               rtol=1e-5, atol=1e-7)
    print(f"rank {rank}: 4. float 'none' baseline allclose")

    n = SMALL["clients_per_round"]
    mech = shard.mech
    full = np.asarray([mech.per_round_epsilon(n, a) for a in shard.cfg.accountant_alphas])
    per_shard = np.asarray([mech.per_round_epsilon(n // world, a)
                            for a in shard.cfg.accountant_alphas])
    np.testing.assert_array_equal(shard.per_round_eps, full)
    assert not np.allclose(full, per_shard)
    np.testing.assert_allclose(shard.accountant.rdp_epsilon(8.0),
                               ROUNDS * mech.per_round_epsilon(n, 8.0), rtol=1e-12)
    print(f"rank {rank}: 5. epsilon at the full cross-shard cohort")

    try:
        FedTrainer(SPEC, FedConfig(engine="shard", **{**SMALL, "clients_per_round": 6}),
                   device="cpu")
    except ValueError as e:
        assert "divide across" in str(e), e
    else:
        raise AssertionError("an indivisible cohort was accepted")
    want = world * (world + 1) // 2
    for packed in (True, False):
        part = torch.full((10,), rank + 1, dtype=torch.int32)
        total = secagg.secure_sum_bounded(part, dist.group.WORLD, want, packed=packed)
        assert torch.equal(part, torch.full((10,), rank + 1, dtype=torch.int32))
        assert torch.equal(total, torch.full((10,), want, dtype=torch.int32))
    print(f"rank {rank}: indivisible cohort refused; partials kept")
    dist.destroy_process_group()
    print(f"rank {rank}: ALL SHARD CHECKS PASS")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
