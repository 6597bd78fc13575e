"""FedConfig (the fields of ``repro/fed/config.py`` this slice runs).

The port runs the fused hot path of the ``perround`` engine with fixed
cohorts and plain SGD. Settings of the reference that it does not run
yet are refused by ``validate_config`` with NotImplementedError naming
the ROADMAP.md item that carries them. Defaults follow the reference,
except ``engine`` and ``fused_rounds``, which default to the only values
ported.
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
    engine: str = "perround"
    task: str = "emnist_cnn"
    server_opt: str = "sgd"
    subsampling: str = "fixed"
    dropout: float = 0.0
    # clip -> encode -> sum as one fused kernel, decode -> apply as another
    fused_rounds: bool = True
    # None: pack the SecAgg sum into b-bit wire fields when the cohort's
    # sum bound fits (10 bits, 3 per word, at a cohort of 40 with m=16);
    # True: pack or raise; False: keep the dense int32 sum.
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
    if not cfg.fused_rounds:
        raise _not_ported("fused_rounds=False (the materialized encode path)",
                          "queue A item 5 and queue B row 5 (rqm_quantize_2d)")
    if cfg.subsampling != "fixed" or cfg.dropout:
        raise _not_ported("heterogeneous cohorts (Poisson subsampling, dropout)",
                          "queue A item 5")
    if cfg.local_steps != 1:
        raise _not_ported("local_steps > 1 (FedAvg-RQM)", "queue A item 5")
    if cfg.server_opt != "sgd":
        raise _not_ported(f"server_opt={cfg.server_opt!r} (momentum, adam)",
                          "queue A item 8")
