"""Round engines (counterpart of ``repro/fed/engines.py``): ``perround``,
one round step per call from Python. The reference's other engines are
not ported yet."""
from __future__ import annotations

from repro_torch.fed import rounds

_NOT_PORTED = {
    "scan": "queue A item 5",
    "host": "queue A item 5",
    "shard": "queue A item 9",
    "async": "queue A item 10",
}


class PerRoundEngine:
    """Drives the round step once per round and accounts each round at
    the fixed cohort size."""

    name = "perround"

    def __init__(self, trainer):
        self.tr = trainer
        tr = trainer
        self.round_step = rounds.make_round_step(
            tr.mech, tr.cfg, tr.slate, tr.client_grads)

    def advance(self, n_rounds: int) -> None:
        tr = self.tr
        for _ in range(n_rounds):
            tr.flat, z_sum = self.round_step(tr.flat, tr.client_data, tr.generator)
            if tr.cfg.collect_sums:
                tr.round_sums.append(z_sum.cpu().numpy())
            tr.accountant.step(tr.per_round_eps)


def get_engine(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not ported yet: ROADMAP.md {_NOT_PORTED[name]}")
    if name != PerRoundEngine.name:
        raise ValueError(f"unknown engine {name!r}; ported: perround")
    return PerRoundEngine
