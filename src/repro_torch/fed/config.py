"""FedConfig (the fields of ``repro/fed/config.py`` this package runs).

Defaults follow the reference: ``FedConfig()`` is its default round, the
materialized ``scan`` engine. Settings of the reference that the port
does not run yet are refused by ``validate_config`` with
NotImplementedError naming the ROADMAP.md item that carries them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class FedConfig:
    num_clients: int = 3400
    clients_per_round: int = 40
    rounds: int = 200
    lr: float = 0.5
    seed: int = 0
    eval_size: int = 2000
    samples_per_client: int = 20
    accountant_alphas: tuple = (2.0, 4.0, 8.0, 16.0, 32.0)
    data_deform: float = 0.35
    data_noise: float = 0.25
    # one clipped gradient per client per round (Algorithm 1)
    local_steps: int = 1
    # "scan" (blocks of rounds, sums kept on the device until the block
    # ends) or "perround" (one round per call): the same round step
    engine: str = "scan"
    task: str = "emnist_cnn"
    server_opt: str = "sgd"
    subsampling: str = "fixed"
    dropout: float = 0.0
    # False: encode the (clients, dim) batch, sum it, decode, apply.
    # True: clip -> encode -> sum as one fused kernel and, for grid
    # mechanisms with plain SGD, decode -> apply as another. Both give
    # the same parameters bit for bit.
    fused_rounds: bool = False
    # None: pack the fused SecAgg sum into b-bit wire fields when the
    # cohort's sum bound fits (10 bits, 3 per word, at a cohort of 40
    # with m=16); True: pack or raise; False: keep the dense int32 sum.
    wire_packed: Optional[bool] = None
    # keep each round's dense SecAgg sum on the host (trainer.round_sums)
    collect_sums: bool = False


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md {item}")


def validate_config(cfg: FedConfig) -> None:
    if not 1 <= cfg.clients_per_round <= cfg.num_clients:
        raise ValueError(
            f"clients_per_round={cfg.clients_per_round} must be in "
            f"[1, num_clients={cfg.num_clients}]"
        )
    if cfg.subsampling != "fixed" or cfg.dropout:
        raise _not_ported("heterogeneous cohorts (Poisson subsampling, dropout)",
                          "queue A item 5")
    if cfg.local_steps != 1:
        raise _not_ported("local_steps > 1 (FedAvg-RQM)", "queue A item 5")
    if cfg.server_opt != "sgd":
        raise _not_ported(f"server_opt={cfg.server_opt!r} (momentum, adam)",
                          "queue A item 8")
