"""FedTrainer (counterpart of ``repro/fed/trainer.py``): owns the mechanism,
config, the population staged on the device, the flat parameters, the
server optimizer's state, the round stream (cohort, seed, mask) and the
Renyi accountant; the registered engine (``fed/engine.py``) runs rounds.
Around them, the engine-independent services: accounting at the realized
cohort size, telemetry (a tracker fed at the
decode-apply boundary), the privacy-budget halt, periodic evaluation,
and checkpoint/resume (parameters, optimizer state, the round stream and
the accountant's history restore to a bit-identical continuation on
every engine).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.convert import ravel
from repro_torch.core import wire
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.core.renyi import RenyiAccountant
from repro_torch.fed import checkpointing, cohort, rounds, staging
from repro_torch.fed import async_engine as _async_engine  # noqa: F401  (registers "async")
from repro_torch.fed import engines as _engines  # noqa: F401  (registers the engines)
from repro_torch.fed.config import FedConfig, validate_config
from repro_torch.fed.engine import get_engine, make_engine
from repro_torch.fed.tasks import make_task
from repro_torch.telemetry import RoundEmitter, Timings, make_tracker


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raise when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return device


class FedTrainer:
    def __init__(self, mech, fed_cfg: FedConfig, device="cuda", tracker=None):
        self.device = resolve_device(device)
        # cfg.engine is a registered name or a spec string
        # ("shard:shards=1,packed=true"): make_engine parses and checks it,
        # apply() sets the bare name and the spec's fields on a copy
        espec = make_engine(fed_cfg.engine)
        fed_cfg = espec.apply(fed_cfg)
        engine_cls = get_engine(espec.name)
        validate_config(fed_cfg)
        self.mech = make_mechanism(mech)
        engine_cls.validate(fed_cfg, self.mech)
        self.cfg = fed_cfg
        # heterogeneous cohorts: the engines compute gradients for a slate
        # of a fixed size and mask those not taking part out of the sum;
        # each round is accounted at its realized size (realized_n)
        self.hetero = cohort.is_hetero(fed_cfg)
        self.slate = cohort.base_slate(fed_cfg)
        # telemetry: the tracker argument wins over cfg.track; the emitter
        # is built once the engine exists (the shard engine's wire width)
        self.tracker = make_tracker(tracker if tracker is not None else fed_cfg.track)
        self.timings = Timings()
        self.task = make_task(fed_cfg.task, fed_cfg, self.device)
        self.flat, self.unravel = ravel(
            self.task.init_params(torch.Generator().manual_seed(fed_cfg.seed)))
        # the round stream: each round's cohort, its kernel seed, its mask
        self.generator = torch.Generator().manual_seed(fed_cfg.seed + 11)
        # the host engine's fixed cohorts: the reference's numpy stream
        self._rng = np.random.default_rng(fed_cfg.seed + 7)
        self.accountant = RenyiAccountant(alphas=fed_cfg.accountant_alphas)
        # fixed cohorts: every round costs the same per-alpha eps vector;
        # a realized size n costs _eps_vector(n), memoized per size
        self.per_round_eps = np.asarray([
            self.mech.per_round_epsilon(fed_cfg.clients_per_round, a)
            for a in fed_cfg.accountant_alphas
        ])
        self._eps_by_n = {fed_cfg.clients_per_round: self.per_round_eps}
        self.server_opt = rounds.server_optimizer(fed_cfg)
        self.opt_state = self.server_opt.init(self.flat)
        self.round_sums: list = []
        # the cohort size of each accounted round, and per-round tracker
        # extras (indexed like the accountant's history)
        self.realized_n: list = []
        self.round_extras: list = []
        self._last_ckpt: Optional[int] = None
        self.shards = 1  # the shard engine sets its rank count
        self.staged_bytes_total = 0
        self.staged_bytes_last_block = 0
        # the engine may claim a process group and set the slate (the
        # shard engine rounds it to its ranks, the async engine makes it
        # its cadence) before anything is staged or built
        self.engine = engine_cls(self)
        self.pack_bits = rounds.hot_path_pack_bits(self.mech, fed_cfg, self.slate)
        self.client_data = None  # streamed staging stages each block's cohorts
        if self.engine.stages_population and fed_cfg.staging != "stream":
            with self.timings.scope("stage"):
                self.client_data, self.staged_bytes_total = staging.stage_full(
                    self.task, fed_cfg, self.device)
        self.client_grads = rounds.make_client_grad(self.mech, self.unravel, self.task,
                                                    fed_cfg)
        self.engine.build()
        self._emitter = RoundEmitter(
            self.tracker, engine=fed_cfg.engine, mechanism=self.mech,
            alphas=fed_cfg.accountant_alphas, delta=fed_cfg.budget_delta,
            budget_eps=fed_cfg.budget_eps, dim=self.flat.numel(),
            pack_bits=self._wire_pack_bits())
        self.tracker.run_started(self._run_meta())

    # -- telemetry ------------------------------------------------------------
    def _wire_pack_bits(self) -> Optional[int]:
        """The run's wire width for the round records' wire_bits and
        pack_width: the fused hot path's b-bit codec when it engages, else
        the shard engine's packed cross-rank sum, else None (dense)."""
        cfg = self.cfg
        bits = self.pack_bits
        if bits is None and cfg.engine == "shard" and cfg.shard_packed is not False:
            bound = self.mech.sum_bound(self.slate)
            if wire.packable(bound):
                bits = wire.sum_bits(bound)
        return bits

    def _run_meta(self) -> dict:
        """Run-level tracker metadata, with the reference's keys: the
        trajectory fingerprint the checkpoints carry, the mechanism, engine
        and task, and the process group's geometry."""
        cfg = self.cfg
        mesh = None
        if cfg.engine == "shard":
            mesh = {"axes": {"shard": self.shards}, "devices": self.shards}
        meta = {
            "kind": "fed_train",
            "fingerprint": bytes(checkpointing.fingerprint(self)).hex(),
            "engine": cfg.engine,
            "task": self.task.spec(),
            "mechanism": self.mech.describe(),
            "mechanism_spec": self.mech.spec(),
            "num_clients": cfg.num_clients,
            "clients_per_round": cfg.clients_per_round,
            "subsampling": cfg.subsampling,
            "dropout": cfg.dropout,
            "server_opt": cfg.server_opt,
            "budget_eps": cfg.budget_eps,
            "budget_delta": cfg.budget_delta,
            "accountant_alphas": list(cfg.accountant_alphas),
            "dim": self.flat.numel(),
            "shards": self.shards,
            "mesh": mesh,
            "backend": self.device.type,
        }
        if cfg.engine == "async":
            # the arrival traffic and staleness policy the run aggregates under
            meta["async"] = checkpointing.fingerprint_fields(self)["async"]
        return meta

    def _advance_tracked(self, n_rounds: int) -> None:
        """Every round of every engine goes through here: one timed scope
        an advance and, when a tracker records, one record a round whose
        eps/realized_n equal the accountant's. Only then does the host
        wait for the device, so that rounds_per_sec times the rounds and
        not their launch; an untracked run never synchronises."""
        t0 = time.perf_counter()
        with self.timings.scope("round_block"):
            self.engine.advance(n_rounds)
        if self._emitter.enabled:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._emitter.emit(self.accountant.history, self.realized_n,
                               time.perf_counter() - t0, extras=self.round_extras)
        else:
            self._emitter.emitted = self.accountant.rounds

    # -- privacy accounting -----------------------------------------------------
    def _eps_vector(self, n: int) -> np.ndarray:
        """The exact per-round eps vector (over cfg.accountant_alphas) of a
        realized cohort of n clients, memoized per size. n = 0 releases
        nothing (the all-zero sum does not depend on the data): eps 0."""
        n = int(n)
        if n not in self._eps_by_n:
            if n <= 0:
                v = np.zeros(len(self.cfg.accountant_alphas))
            else:
                v = np.asarray([self.mech.per_round_epsilon(n, a)
                                for a in self.cfg.accountant_alphas])
            self._eps_by_n[n] = v
        return self._eps_by_n[n]

    def _account(self, n_rounds: int) -> None:
        """Fixed-cohort composition: every round at clients_per_round."""
        for _ in range(n_rounds):
            self.realized_n.append(self.cfg.clients_per_round)
            self.accountant.step(self.per_round_eps)

    def _account_realized(self, ns) -> None:
        """Heterogeneous composition: each round at its realized size (the
        host knows them from the round stream's draws)."""
        for n in ns:
            self.realized_n.append(int(n))
            self.accountant.step(self._eps_vector(n))

    def budget_spent(self) -> tuple:
        """(eps spent at cfg.budget_delta, eps remaining); needs
        cfg.budget_eps."""
        cfg = self.cfg
        if cfg.budget_eps is None:
            raise ValueError("no privacy budget configured (cfg.budget_eps)")
        spent, _ = self.accountant.dp_epsilon(cfg.budget_delta)
        return spent, max(0.0, cfg.budget_eps - spent)

    # -- checkpoint / resume ----------------------------------------------------
    def save_checkpoint(self) -> str:
        """Checkpoint the resumable state at the current round count."""
        path = checkpointing.save_checkpoint(self)
        self._last_ckpt = self.accountant.rounds
        return path

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        """Restore from cfg.ckpt_dir (the latest step by default); returns
        the restored round count. The continuation is bit-identical to the
        uninterrupted run."""
        step = checkpointing.restore_checkpoint(self, step)
        self._last_ckpt = step
        return step

    def _maybe_checkpoint(self) -> None:
        cfg = self.cfg
        if not cfg.ckpt_dir or not cfg.ckpt_every:
            return
        done = self.accountant.rounds
        if done and done % cfg.ckpt_every == 0 and done != self._last_ckpt:
            self.save_checkpoint()

    def _cap_to_ckpt(self, want: int) -> int:
        """Split blocks so that their ends land on ckpt_every multiples
        (blocking never changes the parameters)."""
        if not self.cfg.ckpt_dir or not self.cfg.ckpt_every:
            return want
        return min(want, self.cfg.ckpt_every - self.accountant.rounds % self.cfg.ckpt_every)

    # -- the loop ---------------------------------------------------------------
    def round(self) -> None:
        """Advance one round (a 1-round block on the scan engine)."""
        self._advance_tracked(1)

    def run_block(self, n_rounds: int) -> None:
        """Advance ``n_rounds`` rounds on a blocked engine, in blocks of at
        most ``cfg.scan_block`` rounds."""
        if not self.engine.blocked:
            raise ValueError(f"run_block requires a blocked engine ('scan', 'shard'), "
                             f"got {self.cfg.engine!r}")
        self._advance_tracked(n_rounds)

    def evaluate(self) -> dict:
        """Held-out accuracy and loss of the current parameters."""
        return self.task.evaluate(self.flat, self.unravel)

    def train(self, rounds: int | None = None, eval_every: int = 25, log=print) -> list:
        """Run up to ``rounds`` more rounds, evaluating every
        ``eval_every`` rounds and after the last; returns the eval records.
        With cfg.budget_eps set, each record carries the (eps,
        budget_delta)-DP spent and remaining, and the run halts after the
        last round the budget affords (fixed cohorts), or at the first
        round whose realized spend crosses it (heterogeneous cohorts: an
        overshoot of at most one round). With cfg.ckpt_dir and ckpt_every
        set, checkpoints land on ckpt_every multiples (blocked engines
        split blocks there, with an eval point at each split); after
        restore_checkpoint(), round numbers continue from the restored
        count."""
        rounds = self.cfg.rounds if rounds is None else rounds
        cfg = self.cfg
        budget = cfg.budget_eps
        history = []
        t0 = time.time()
        done0 = self.accountant.rounds  # nonzero after a resume

        def record(done):
            m = self.evaluate()
            m.update(round=done, seconds=round(time.time() - t0, 1))
            msg = f"[{self.mech.name}] round {done:4d} loss={m['loss']:.4f}"
            if "accuracy" in m:
                msg += f" acc={m['accuracy']:.4f}"
            if budget is not None:
                spent, remaining = self.budget_spent()
                m.update(eps_spent=spent, eps_remaining=remaining)
                msg += f" eps_spent={spent:.3f}/{budget:g} (delta={cfg.budget_delta:g})"
            history.append(m)
            self.tracker.log_eval(dict(m))
            log(msg)

        def affordable(want: int) -> int:
            """How many of the next ``want`` rounds the budget still buys:
            an exact projection with the constant per-round vector (under
            heterogeneous cohorts a nominal-cohort lookahead, the realized
            spend checked again at the next call)."""
            if budget is None:
                return want
            if self.budget_spent()[1] <= 0:
                return 0
            k = self.accountant.rounds_within_budget(budget, cfg.budget_delta,
                                                     self.per_round_eps)
            return want if k > want else int(k)

        halted = False
        if self.engine.blocked:
            done = 0
            while done < rounds:
                block = affordable(self._cap_to_ckpt(min(eval_every, rounds - done)))
                if block == 0:
                    halted = True
                    break
                if budget is not None and self.hetero:
                    # the realized spend is known only after a round: one
                    # round at a time, halting at the first crossing (an
                    # overshoot of at most one round)
                    ran = 0
                    while ran < block:
                        self.run_block(1)
                        ran += 1
                        if self.budget_spent()[1] <= 0:
                            halted = True
                            break
                    done += ran
                    self._maybe_checkpoint()
                    record(done0 + done)
                    if halted:
                        break
                    continue
                self.run_block(block)
                done += block
                self._maybe_checkpoint()
                record(done0 + done)
        else:
            for t in range(rounds):
                if affordable(1) == 0:
                    halted = True
                    break
                self.round()
                self._maybe_checkpoint()
                if (t + 1) % eval_every == 0 or t == rounds - 1:
                    record(done0 + t + 1)
        if halted:
            spent, _ = self.budget_spent()
            log(f"[{self.mech.name}] privacy budget exhausted after "
                f"{self.accountant.rounds} rounds: eps_spent={spent:.4f} of "
                f"{budget:g} at delta={cfg.budget_delta:g}; halting")
            if not history or history[-1]["round"] != self.accountant.rounds:
                record(self.accountant.rounds)
        self.tracker.log_timings(self.timings.summary())
        self.tracker.flush()
        return history
