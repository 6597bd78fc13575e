"""Round engines (counterpart of ``repro/fed/engines.py``). The ported
engines run the same round, so a fixed seed gives bit-identical
parameters under any of them:

  * ``scan`` (the default): blocks of rounds (``FedTrainer.run_block``);
    a block keeps its SecAgg sums on the device and accounts its rounds
    when it ends, as the reference's scanned block does;
  * ``perround``: one round per step, accounted as it ends;
  * ``shard``: the scan engine over a ``torch.distributed`` process group
    (``launch/mesh.py``), one process per rank: each rank computes and
    encodes its slice of the cohort, and the integer level sums cross
    the ranks in one all_reduce, packed when the bound allows
    (``core/secagg.py``). Every round is accounted at the full
    cross-shard cohort. At one rank it equals ``scan`` bit for bit.

The reference's other engines are refused, naming their ROADMAP.md item.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.core import wire
from repro_torch.fed import rounds, staging
from repro_torch.launch.mesh import shard_group

_NOT_PORTED = {
    "host": "queue A item 5",
    "async": "queue A item 10",
}


class PerRoundEngine:
    """Drives the round step once per round and accounts each round at
    the fixed cohort size as it ends."""

    name = "perround"
    blocked = False

    def __init__(self, trainer):
        self.tr = trainer
        tr = trainer
        self.round_step = rounds.make_round_step(
            tr.mech, tr.cfg, tr.slate, tr.client_grads, tr.server_opt)

    def _round(self, **step_args):
        """One round on the device; its SecAgg sum when collected."""
        tr = self.tr
        tr.flat, z_sum = self.round_step(tr.flat, tr.client_data, tr.generator, **step_args)
        return z_sum if tr.cfg.collect_sums else None

    def _finish(self, sums: list) -> None:
        """The host side of finished rounds: keep their sums, account them."""
        tr = self.tr
        for z_sum in sums:
            if z_sum is not None:
                tr.round_sums.append(z_sum.cpu().numpy())
            tr.accountant.step(tr.per_round_eps)

    def advance(self, n_rounds: int) -> None:
        for _ in range(n_rounds):
            self._finish([self._round()])


class ScanEngine(PerRoundEngine):
    """The same round step over a block of rounds: nothing returns to
    the host until the block ends."""

    name = "scan"
    blocked = True

    def advance(self, n_rounds: int) -> None:
        self._finish([self._round() for _ in range(n_rounds)])


class ShardEngine(ScanEngine):
    """The scan engine over a process group of ``shards`` ranks, in chunks
    of ``cfg.scan_block`` rounds; with ``staging="stream"`` each chunk
    first stages this rank's slices of its cohorts."""

    name = "shard"

    def __init__(self, trainer):
        tr, cfg = trainer, trainer.cfg
        self.tr = tr
        self.group = shard_group(cfg.shards, tr.device)
        self.shards = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        tr.shards = self.shards
        if cfg.clients_per_round % self.shards:
            raise ValueError(f"clients_per_round={cfg.clients_per_round} must "
                             f"divide across {self.shards} shards")
        if cfg.shard_packed:
            wire.check_packable(tr.mech.sum_bound(tr.slate), where="shard_packed=True: ")
        self.round_step = rounds.make_shard_round_step(
            tr.mech, cfg, tr.slate, self.shards, self.rank, self.group,
            tr.client_grads, tr.server_opt)

    def advance(self, n_rounds: int) -> None:
        tr, cfg = self.tr, self.tr.cfg
        done = 0
        while done < n_rounds:
            length = min(cfg.scan_block, n_rounds - done)
            if cfg.staging == "stream":
                data, nbytes = staging.stage_stream_block(
                    tr.task, cfg, tr.slate, tr.generator, length, self.rank,
                    self.shards, tr.device)
                tr.staged_bytes_last_block = nbytes
                tr.staged_bytes_total += nbytes
                sums = [self._round(batch={k: v[t] for k, v in data.items()})
                        for t in range(length)]
            else:
                sums = [self._round() for _ in range(length)]
            self._finish(sums)
            done += length


ENGINES = {cls.name: cls for cls in (ScanEngine, PerRoundEngine, ShardEngine)}


def get_engine(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not ported yet: ROADMAP.md {_NOT_PORTED[name]}")
    if name not in ENGINES:
        raise ValueError(f"unknown engine {name!r}; ported: {', '.join(ENGINES)}")
    return ENGINES[name]
