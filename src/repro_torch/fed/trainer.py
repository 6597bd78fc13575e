"""FedTrainer (counterpart of ``repro/fed/trainer.py``): owns the mechanism,
config, the population staged on the device, the flat parameters, the
cohort/seed generator and the Renyi accountant; the engine runs rounds.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.convert import ravel
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.core.renyi import RenyiAccountant
from repro_torch.fed import rounds, staging
from repro_torch.fed.config import FedConfig, validate_config
from repro_torch.fed.engines import get_engine
from repro_torch.fed.tasks import make_task
from repro_torch.optim.optimizers import make_optimizer


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raise when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return device


class FedTrainer:
    def __init__(self, mech, fed_cfg: FedConfig, device="cuda"):
        self.device = resolve_device(device)
        validate_config(fed_cfg)
        engine_cls = get_engine(fed_cfg.engine)
        self.mech = make_mechanism(mech)
        self.cfg = fed_cfg
        self.slate = fed_cfg.clients_per_round
        self.task = make_task(fed_cfg.task, fed_cfg, self.device)
        self.flat, self.unravel = ravel(
            self.task.init_params(torch.Generator().manual_seed(fed_cfg.seed)))
        # the round stream: each round's cohort, then its kernel seed
        self.generator = torch.Generator().manual_seed(fed_cfg.seed + 11)
        self.accountant = RenyiAccountant(alphas=fed_cfg.accountant_alphas)
        # fixed cohorts: every round costs the same per-alpha eps vector
        self.per_round_eps = np.asarray([
            self.mech.per_round_epsilon(fed_cfg.clients_per_round, a)
            for a in fed_cfg.accountant_alphas
        ])
        self.server_opt = make_optimizer(fed_cfg.server_opt)
        self.pack_bits = rounds.hot_path_pack_bits(self.mech, fed_cfg, self.slate)
        self.round_sums: list = []
        self.shards = 1  # the shard engine sets its rank count
        self.staged_bytes_total = 0
        self.staged_bytes_last_block = 0
        self.client_data = None  # streamed staging stages each block's cohorts
        if fed_cfg.staging != "stream":
            self.client_data, self.staged_bytes_total = staging.stage_full(
                self.task, fed_cfg, self.device)
        self.client_grads = rounds.make_client_grad(self.mech, self.unravel, self.task)
        self.engine = engine_cls(self)

    def round(self) -> None:
        """Advance one round (a 1-round block on the scan engine)."""
        self.engine.advance(1)

    def run_block(self, n_rounds: int) -> None:
        """Advance ``n_rounds`` rounds on a blocked engine, in blocks of at
        most ``cfg.scan_block`` rounds."""
        if not self.engine.blocked:
            raise ValueError(f"run_block requires a blocked engine ('scan', 'shard'), "
                             f"got {self.cfg.engine!r}")
        self.engine.advance(n_rounds)

    def evaluate(self) -> dict:
        """Held-out accuracy and loss of the current parameters."""
        return self.task.evaluate(self.flat, self.unravel)

    def train(self, rounds: int | None = None, eval_every: int = 25, log=print) -> list:
        """Run ``rounds`` more rounds, evaluating every ``eval_every``
        rounds and after the last; returns the eval records."""
        rounds = self.cfg.rounds if rounds is None else rounds
        history, t0, done = [], time.time(), 0
        while done < rounds:
            block = min(eval_every, rounds - done)
            self.engine.advance(block)
            done += block
            m = self.evaluate()
            m.update(round=self.accountant.rounds, seconds=time.time() - t0)
            history.append(m)
            log(f"[{self.mech.name}] round {m['round']:4d} loss={m['loss']:.4f} "
                f"acc={m['accuracy']:.4f}")
        return history
