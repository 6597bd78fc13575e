"""RoundEmitter (counterpart of ``repro/telemetry/emit.py``): the one
decode-apply-boundary hook.

Every round an engine completes lands in the trainer's accountant as
(realized_n, per-round eps vector). The emitter turns that history into
schema-stable tracker records: it keeps a cumulative RDP mirror advanced
in the order the accountant composes and converts it through the same
``core.renyi.rdp_to_dp``, so the emitted ``eps_spent`` series equals the
accountant queried after each round, bit for bit, and ``realized_n`` is
the accountant's history verbatim.

After a checkpoint restore, ``sync(total_rdp, rounds)`` re-anchors the
mirror to the replayed accountant, so the continued series has no
duplicate or missing round.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch.core import wire
from repro_torch.core.renyi import rdp_to_dp
from repro_torch.telemetry.tracker import NoopTracker, Tracker


class RoundEmitter:
    def __init__(self, tracker: Tracker, *, engine: str, mechanism,
                 alphas, delta: float, budget_eps: Optional[float] = None,
                 dim: Optional[int] = None,
                 pack_bits: Optional[int] = None):
        self.tracker = tracker
        self.engine = engine
        self.mech = mechanism
        self.alphas = tuple(alphas)
        self.delta = float(delta)
        self.budget_eps = budget_eps
        self.dim = dim
        # wire width of the run's hot path (rounds.hot_path_pack_bits /
        # the shard engine's packed cross-rank sum); None = the dense
        # int32 wire
        self.pack_bits = pack_bits
        self.enabled = not isinstance(tracker, NoopTracker)
        self.emitted = 0
        self._cum = np.zeros(len(self.alphas), dtype=np.float64)
        self._desc = mechanism.describe()
        self._sum_bits_by_n: dict = {}

    def sync(self, total_rdp, rounds: int) -> None:
        """Re-anchor after a checkpoint restore: the accountant has
        replayed ``rounds`` rounds summing to ``total_rdp``."""
        self._cum = np.asarray(total_rdp, dtype=np.float64).copy()
        self.emitted = int(rounds)
        self.tracker.on_resume(self.emitted)

    def secagg_sum_bits(self, n: int) -> Optional[int]:
        """Size in bits of one round's SecAgg sum message for a realized
        cohort of n: dim lanes of ceil(log2(sum_bound+1)) bits for
        integer-coded mechanisms, dim * mech.bits for the float
        baseline. None when the flat dimension is unknown."""
        if self.dim is None:
            return None
        n = int(n)
        if n not in self._sum_bits_by_n:
            bound = self.mech.sum_bound(n)
            lane = (math.ceil(math.log2(bound + 1)) if bound > 0
                    else self.mech.bits)
            self._sum_bits_by_n[n] = int(self.dim * lane)
        return self._sum_bits_by_n[n]

    def wire_bits(self) -> Optional[int]:
        """Size in bits of the round's SecAgg sum AS SHIPPED: packed wire
        words (32 * word count at pack_width bits per field) on the
        packed hot path, dim dense lanes (int32, or the float baseline's
        mech.bits) otherwise. ``secagg_sum_bits`` is the
        information-theoretic floor; ``wire_bits / secagg_sum_bits``
        measures the residual packing slack. None when dim is unknown."""
        if self.dim is None:
            return None
        if self.pack_bits is not None:
            return 32 * wire.packed_words(self.dim, self.pack_bits)
        lane = 32 if self.mech.sum_bound(1) > 0 else self.mech.bits
        return int(self.dim * lane)

    def emit(self, history, realized_n, elapsed: float,
             extras=None) -> int:
        """Emit one record per not-yet-emitted round in ``history`` (the
        accountant's per-round eps vectors) / ``realized_n``, stamping
        each with the advance's aggregate rounds/sec. ``extras`` is an
        optional per-round list of dicts (indexed like ``history``) whose
        keys ride each record — the tracker folds unknown keys into the
        schema's trailing "extra" column, so engine-specific stats never
        perturb the schema. Returns the number of records emitted."""
        total = len(history)
        new = total - self.emitted
        if new <= 0:
            return 0
        rps = new / max(elapsed, 1e-9)
        for i in range(self.emitted, total):
            # the accountant composes with `_eps += vec`; += and
            # `a = a + vec` are the same float op sequence, so the mirror
            # stays bit-identical to accountant.total_rdp()
            self._cum = self._cum + np.asarray(history[i], dtype=np.float64)
            eps_spent, _ = rdp_to_dp(self._cum, self.alphas, self.delta)
            n = int(realized_n[i])
            rec = {
                "round": i + 1,
                "engine": self.engine,
                "mechanism": self._desc,
                "realized_n": n,
                "eps_spent": eps_spent,
                "eps_remaining": (max(0.0, self.budget_eps - eps_spent)
                                  if self.budget_eps is not None else None),
                "rounds_per_sec": rps,
                "secagg_sum_bits": self.secagg_sum_bits(n),
                "wire_bits": self.wire_bits(),
                "pack_width": self.pack_bits,
            }
            if extras is not None and i < len(extras) and extras[i]:
                for k, v in extras[i].items():
                    rec.setdefault(k, v)
            self.tracker.log_round(rec)
        self.emitted = total
        return new
