"""Round engines (counterpart of ``repro/fed/engines.py``). Both ported
engines drive the same round step, so a fixed seed gives bit-identical
parameters under either:

  * ``scan`` (the default): blocks of rounds (``FedTrainer.run_block``);
    a block keeps its SecAgg sums on the device and accounts its rounds
    when it ends, as the reference's scanned block does;
  * ``perround``: one round per step, accounted as it ends.

The reference's other engines are refused, naming their ROADMAP.md item.
"""
from __future__ import annotations

from repro_torch.fed import rounds

_NOT_PORTED = {
    "host": "queue A item 5",
    "shard": "queue A item 9",
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

    def _round(self):
        """One round on the device; its SecAgg sum when collected."""
        tr = self.tr
        tr.flat, z_sum = self.round_step(tr.flat, tr.client_data, tr.generator)
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


ENGINES = {cls.name: cls for cls in (ScanEngine, PerRoundEngine)}


def get_engine(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not ported yet: ROADMAP.md {_NOT_PORTED[name]}")
    if name not in ENGINES:
        raise ValueError(f"unknown engine {name!r}; ported: {', '.join(ENGINES)}")
    return ENGINES[name]
