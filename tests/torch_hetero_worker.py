"""One rank of the port's four-rank checks of heterogeneous cohorts on the
shard engine (gloo, CPU).

Started four times by tests/test_torch_hetero.py::test_four_gloo_ranks_hetero:

    PYTHONPATH=src python tests/torch_hetero_worker.py <rank> <world> <store file>

Each rank joins the default process group on a FileStore and holds the
shard engine against the port's own scan engine (which
tests/test_torch_hetero.py holds against the reference) under Poisson
subsampling with dropout, fused packed, at a slate that divides across
the ranks: per-round sums exactly, parameters bit for bit, the same
realized sizes and eps history. A slate that does not divide is rounded
up to a multiple of the ranks (a wider slate draws other dropout
uniforms, so that run is another trajectory, as in the reference).
Prints one line per check and exits 0 when all hold. Imports no JAX.
"""
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer

SMALL = dict(num_clients=24, clients_per_round=4, lr=1.0, eval_size=64, samples_per_client=8,
             collect_sums=True)
ROUNDS = 2
SPEC = "qmgeo:c=0.05"
HETERO = dict(subsampling="poisson", max_cohort=8, dropout=0.3, fused_rounds=True)


def _train(**overrides):
    tr = FedTrainer(SPEC, FedConfig(**{**SMALL, **overrides}), device="cpu")
    tr.run_block(ROUNDS)
    return tr


def main(rank: int, world: int, store_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    scan = _train(**HETERO)
    shard = _train(engine="shard", shards=world, **HETERO)
    assert shard.shards == world and shard.slate == scan.slate == 8, shard.slate
    assert shard.realized_n == scan.realized_n, (shard.realized_n, scan.realized_n)
    for t, (a, b) in enumerate(zip(scan.round_sums, shard.round_sums)):
        np.testing.assert_array_equal(a, b, err_msg=f"round {t} sums differ")
    assert torch.equal(scan.flat, shard.flat)
    assert all(np.array_equal(a, b) for a, b in zip(scan.accountant.history,
                                                   shard.accountant.history))
    print(f"rank {rank}: poisson + dropout, fused packed: shard == scan, sums and "
          f"parameters bit for bit, realized {shard.realized_n} of a slate of {shard.slate}")
    rounded = FedTrainer(SPEC, FedConfig(engine="shard", shards=world, subsampling="poisson",
                                         max_cohort=7, **SMALL), device="cpu")
    assert rounded.slate == 8, rounded.slate
    print(f"rank {rank}: a poisson slate of 7 rounded to 8 over {world} ranks")
    dist.destroy_process_group()
    print(f"rank {rank}: ALL HETERO SHARD CHECKS PASS")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
