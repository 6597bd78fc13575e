"""Checkpoint/resume for FedTrainer (counterpart of
``repro/fed/checkpointing.py``), through ``checkpoint/store.py``.

One checkpoint is the whole resumable state at a round boundary: the
flat parameters, the server optimizer's state, the round stream (the
``torch.Generator`` that draws each round's cohort and kernel seed, as
its uint8 state tensor) and the accountant's per-round history (eps
vectors and cohort sizes). Every ported engine is a function of (flat,
opt_state, generator) and the deterministically staged data, and the
accountant is replayed from its history, so a restored trainer continues
the uninterrupted run bit for bit. (The reference also saves its host
engine's numpy sampling stream; the port has no host engine yet.)

Every checkpoint carries a fingerprint of what defines the trajectory
and its accounting: the mechanism's spec, the task's spec, the FedConfig
fields below and the trajectory family. The blob hashed is the
reference's but for the family: the port's engines draw from a
``torch.Generator``, not ``jax.random``, so they are a trajectory of
their own, ``"torch"``, and a checkpoint of either package is refused by
the other with the fingerprint's ValueError. Restoring into a trainer of
another fingerprint raises: replaying one mechanism's eps history under
another would claim an epsilon no mechanism spent.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np

from repro_torch.checkpoint import store

# the reference's: FedConfig fields that define the trajectory and its
# accounting (engine, staging, budget and checkpoint knobs do not)
_FINGERPRINT_FIELDS = (
    "num_clients", "clients_per_round", "seed", "lr", "samples_per_client",
    "accountant_alphas", "data_deform", "data_noise", "local_steps",
    "local_lr", "subsampling", "dropout", "max_cohort", "server_opt",
    "server_opt_options",
)
TRAJECTORY = "torch"


def fingerprint_fields(trainer) -> dict:
    """The fingerprinted fields of ``trainer``'s config, with its task's
    spec and its trajectory family."""
    cfg = trainer.cfg
    fields = {f: getattr(cfg, f) for f in _FINGERPRINT_FIELDS}
    # None and {} build the same optimizer
    fields["server_opt_options"] = fields["server_opt_options"] or {}
    fields["task"] = trainer.task.spec()
    fields["trajectory"] = TRAJECTORY
    return fields


def fingerprint_blob(mech_spec: dict, fields: dict) -> str:
    """The JSON the fingerprint hashes, serialized as the reference does."""
    return json.dumps({"mechanism": mech_spec, "config": fields}, sort_keys=True,
                      default=repr)


def fingerprint(trainer) -> np.ndarray:
    """sha256 of the mechanism spec, the task spec and the trajectory's
    config, as a (32,) uint8 array (a fixed-shape checkpoint leaf)."""
    blob = fingerprint_blob(trainer.mech.spec(), fingerprint_fields(trainer))
    return np.frombuffer(hashlib.sha256(blob.encode()).digest(), np.uint8)


def _tree(trainer, eps_history: np.ndarray, realized_n: np.ndarray, fp: np.ndarray) -> dict:
    return {
        "flat": trainer.flat,
        "opt": trainer.opt_state,
        "key": trainer.generator.get_state(),
        "eps_history": eps_history,
        "realized_n": realized_n,
        "fingerprint": fp,
    }


def save_checkpoint(trainer) -> str:
    """Write the trainer's resumable state at its current round count."""
    cfg = trainer.cfg
    if not cfg.ckpt_dir:
        raise ValueError("no checkpoint directory configured (cfg.ckpt_dir)")
    hist = trainer.accountant.history
    eps = np.stack(hist) if hist else np.zeros((0, len(cfg.accountant_alphas)))
    tree = _tree(trainer, eps, np.asarray(trainer.realized_n, np.int64), fingerprint(trainer))
    return store.save(cfg.ckpt_dir, trainer.accountant.rounds, tree)


def restore_checkpoint(trainer, step=None) -> int:
    """Load a checkpoint into the trainer (the latest step by default) and
    return the restored round count."""
    cfg = trainer.cfg
    if not cfg.ckpt_dir:
        raise ValueError("no checkpoint directory configured (cfg.ckpt_dir)")
    if step is None:
        step = store.latest_step(cfg.ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {cfg.ckpt_dir}")
    # the fingerprint first and alone: a checkpoint of another config may
    # not even share this trainer's tree (sgd's empty state against
    # momentum's m), and of the reference not its round stream's shape
    fp = store.restore(cfg.ckpt_dir, step, {"fingerprint": np.zeros(32, np.uint8)})
    if not np.array_equal(fp["fingerprint"], fingerprint(trainer)):
        raise ValueError(
            f"checkpoint step {step} in {cfg.ckpt_dir} was written by a DIFFERENT "
            f"mechanism/config or package (fingerprint mismatch): resuming would "
            f"replay its epsilon history under parameters it does not describe. Match "
            f"the original mechanism spec and the trajectory-defining FedConfig fields "
            f"({', '.join(_FINGERPRINT_FIELDS)}), or start a fresh checkpoint directory.")
    like = _tree(trainer, np.zeros((step, len(cfg.accountant_alphas)), np.float64),
                 np.zeros(step, np.int64), np.zeros(32, np.uint8))
    data = store.restore(cfg.ckpt_dir, step, like)
    trainer.flat = data["flat"]
    trainer.opt_state = data["opt"]
    trainer.generator.set_state(data["key"])
    trainer.accountant = type(trainer.accountant)(alphas=cfg.accountant_alphas)
    trainer.realized_n = []
    for n, vec in zip(data["realized_n"], data["eps_history"]):
        trainer.realized_n.append(int(n))
        trainer.accountant.step(vec)
    trainer.round_sums = []
    # extras line up with the accountant's history by absolute round
    trainer.round_extras = [{}] * step
    # the tracker continues the same series: the emitter re-anchors to the
    # replayed accountant and drops any record past the restored round
    trainer._emitter.sync(trainer.accountant.total_rdp(), step)
    return step
