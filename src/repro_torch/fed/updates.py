"""The typed client-update API shared by every aggregation surface
(counterpart of ``repro/fed/updates.py``; pure numpy, the port's own copy).

``ClientUpdate`` is the one form a client contribution takes on its way
into an aggregation: streamed into the long-lived ``AggregatorServer``
(``launch/aggregator.py``) or realized inside the async engine's buffer
(``fed/async_engine.py``). A frozen dataclass: the client's id, the model
version it fetched (``round_tag``), the staleness realized at aggregation
time, a {0, 1} row weight (0: a straggler, masked out of the SecAgg sum,
the round accounted at the surviving count) and the encoded payload.
Shape and dtype validation live here (``validate``), not on each intake.

The payload travels dense (a (dim,) numpy array of level indices, or
floats for the noise-free baseline) or as a ``core.wire.PackedPayload``,
the same levels packed at the mechanism's minimal width
(``Mechanism.encode_wire``). Both decode to the same integers;
intake reads them through ``payload_array()`` and ``payload_nbytes``.

``StalenessPolicy`` is the FedBuff-style staleness treatment both
surfaces share: updates staler than ``max_staleness`` are not admitted
(the aggregator discards them; the engine's simulated clients refetch,
clamping realized staleness), and the decoded aggregate is scaled by a
scalar ``discount``, post-processing of the privatized release, so the
accounting is untouched. ``UpdateBuffer`` is the staleness-aware FIFO
behind both: admit or discard against the policy at the current model
version, then ``take`` a cohort in arrival order, each update stamped
with its realized staleness.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from repro_torch.core.wire import PackedPayload

WEIGHT_POLICIES = ("uniform", "poly")


@dataclasses.dataclass(frozen=True)
class ClientUpdate:
    """One client's contribution to one aggregation.

    ``payload`` is the mechanism's ``encode`` output for this client —
    integer level indices for the grid mechanisms (dense, or bit-packed
    as a ``wire.PackedPayload`` from ``mech.encode_wire``), floats only
    for the noise-free baseline. ``round_tag`` is the model version the client
    FETCHED before computing (None = unversioned legacy submit);
    ``staleness`` is the realized (aggregation version - round_tag) gap,
    stamped when the update is taken out of a buffer. ``weight`` is a
    {0, 1} participation weight: 0 marks a straggler/dropout whose
    payload is masked out of the SecAgg sum (the round is then accounted
    at the realized surviving count — fewer participants, strictly more
    epsilon). Weights outside {0, 1} are rejected: a
    client contributing w copies of its message would break the
    one-message-per-client sensitivity the accounting assumes.
    """

    payload: Union[np.ndarray, PackedPayload]
    client_id: int = -1
    round_tag: Optional[int] = None
    staleness: int = 0
    weight: int = 1

    def __post_init__(self):
        if not isinstance(self.payload, PackedPayload):
            object.__setattr__(self, "payload", np.asarray(self.payload))
        if self.weight not in (0, 1):
            raise ValueError(
                f"ClientUpdate.weight must be 0 or 1 (one message per "
                f"client is what the DP accounting assumes), got "
                f"{self.weight!r}"
            )
        if self.staleness < 0:
            raise ValueError(
                f"ClientUpdate.staleness must be >= 0, got {self.staleness}"
            )

    @property
    def packed(self) -> bool:
        """True when the payload is in the bit-packed wire form."""
        return isinstance(self.payload, PackedPayload)

    def payload_array(self) -> np.ndarray:
        """The DENSE (dim,) payload, whatever the wire form — the one
        accessor aggregation surfaces read levels through (packed
        payloads unpack exactly)."""
        if self.packed:
            return self.payload.unpack()
        return self.payload

    @property
    def payload_nbytes(self) -> int:
        """Uplink bytes this update's payload occupies as shipped
        (packed words, or the dense array's buffer)."""
        return int(self.payload.nbytes)

    def validate(self, dim: int) -> "ClientUpdate":
        """Shape/dtype validation against a deployment's flat dimension
        (the checks ``AggregatorServer.submit`` used to do inline)."""
        p = self.payload
        if isinstance(p, PackedPayload):
            # word-count-vs-length consistency is PackedPayload's own
            # invariant; here we only pin the deployment dimension
            if p.length != int(dim):
                raise ValueError(
                    f"ClientUpdate packed payload must hold {dim} fields, "
                    f"got {p.length}"
                )
            return self
        if p.ndim != 1 or p.shape[0] != int(dim):
            raise ValueError(
                f"ClientUpdate payload must be ({dim},), got {p.shape}"
            )
        if not (np.issubdtype(p.dtype, np.integer)
                or np.issubdtype(p.dtype, np.floating)):
            raise ValueError(
                f"ClientUpdate payload must be numeric (integer level "
                f"indices, or floats for the noise-free baseline), got "
                f"dtype {p.dtype}"
            )
        return self

    def staleness_at(self, version: int) -> int:
        """Realized staleness if aggregated at model ``version``: the
        version gap since the fetch for versioned updates, the stamped
        staleness for unversioned ones."""
        if self.round_tag is None:
            return int(self.staleness)
        return max(0, int(version) - int(self.round_tag))

    def stamped(self, version: int) -> "ClientUpdate":
        """A copy with ``staleness`` stamped at ``version``."""
        return dataclasses.replace(
            self, staleness=self.staleness_at(version)
        )


def as_updates(obj, *, round_tag: Optional[int] = None) -> list:
    """Normalize an intake batch to ``list[ClientUpdate]``: a single
    ``ClientUpdate``, an iterable of them, or a bare ``(k, dim)`` array
    (one row per client — the legacy ``submit`` form)."""
    if isinstance(obj, ClientUpdate):
        return [obj]
    if isinstance(obj, (list, tuple)) and all(
            isinstance(u, ClientUpdate) for u in obj):
        return list(obj)
    arr = np.asarray(obj)
    if arr.ndim != 2:
        raise ValueError(
            f"updates must be a ClientUpdate, a sequence of ClientUpdate, "
            f"or a (k, dim) array; got array of shape {arr.shape}"
        )
    return [ClientUpdate(payload=row, round_tag=round_tag) for row in arr]


@dataclasses.dataclass(frozen=True)
class StalenessPolicy:
    """The shared staleness treatment of buffered aggregation.

    ``max_staleness=None`` admits everything; an integer bound refuses
    updates whose realized staleness exceeds it. ``weight`` names the
    discount applied to the DECODED aggregate (post-processing of the
    privatized release — never touches the accounting): ``"uniform"``
    (no discount, exactly 1.0) or ``"poly:<a>"`` (the FedBuff polynomial
    ``(1 + s)^-a`` averaged over the buffer's realized stalenesses).
    """

    max_staleness: Optional[int] = None
    weight: str = "uniform"

    def __post_init__(self):
        if self.max_staleness is not None and self.max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0 or None, got "
                f"{self.max_staleness}"
            )
        self._parse_weight()  # validates

    def _parse_weight(self) -> tuple:
        name, _, arg = str(self.weight).partition(":")
        name = name.strip()
        if name not in WEIGHT_POLICIES:
            raise ValueError(
                f"unknown staleness weight {self.weight!r}; expected one "
                f"of {WEIGHT_POLICIES} (e.g. 'uniform' or 'poly:0.5')"
            )
        if name == "uniform":
            if arg.strip():
                raise ValueError(
                    f"staleness weight 'uniform' takes no argument, got "
                    f"{self.weight!r}"
                )
            return name, None
        try:
            a = float(arg) if arg.strip() else 0.5
        except ValueError:
            raise ValueError(
                f"malformed staleness weight {self.weight!r} (expected "
                f"'poly:<exponent>')"
            )
        if a < 0:
            raise ValueError(
                f"poly staleness exponent must be >= 0, got {a}"
            )
        return name, a

    def admit(self, staleness: int) -> bool:
        """Is an update of this realized staleness still aggregatable?"""
        return self.max_staleness is None or staleness <= self.max_staleness

    def discount(self, stalenesses) -> float:
        """The aggregation's scalar staleness discount: exactly 1.0 for
        the uniform policy (the decode-apply path skips the multiply
        entirely), the mean polynomial weight otherwise."""
        name, a = self._parse_weight()
        if name == "uniform":
            return 1.0
        s = np.asarray(stalenesses, dtype=np.float64)
        if s.size == 0:
            return 1.0
        return float(np.mean((1.0 + s) ** (-a)))

    def describe(self) -> str:
        bound = ("unbounded" if self.max_staleness is None
                 else f"<={self.max_staleness}")
        return f"staleness {bound}, weight {self.weight}"


class UpdateBuffer:
    """A staleness-aware FIFO of ``ClientUpdate``s (arrival order).

    ``add`` validates and appends; ``prune(version)`` discards updates
    the policy no longer admits at the current model version (returning
    how many died of staleness); ``take(k, version)`` pops the k oldest
    admissible updates, each stamped with its realized staleness.
    """

    def __init__(self, policy: Optional[StalenessPolicy] = None,
                 dim: Optional[int] = None):
        self.policy = policy or StalenessPolicy()
        self.dim = dim
        self._items: list = []
        self.discarded = 0

    def __len__(self) -> int:
        return len(self._items)

    def add(self, update: ClientUpdate) -> None:
        if self.dim is not None:
            update.validate(self.dim)
        self._items.append(update)

    def extend(self, updates) -> None:
        for u in updates:
            self.add(u)

    def prune(self, version: int) -> int:
        """Discard updates staler than the policy admits at ``version``."""
        kept = [u for u in self._items
                if self.policy.admit(u.staleness_at(version))]
        died = len(self._items) - len(kept)
        self._items = kept
        self.discarded += died
        return died

    def peek(self, k: int, version: int) -> list:
        """The ``k`` oldest admissible updates, stamped, WITHOUT popping
        (prunes first) — the budget-check-before-apply path looks at the
        candidate aggregation's realized size before committing to it."""
        self.prune(version)
        return [u.stamped(version) for u in self._items[:k]]

    def take(self, k: int, version: int) -> list:
        """Pop the ``k`` oldest admissible updates, stamped with their
        realized staleness at ``version`` (prunes first)."""
        taken = self.peek(k, version)
        del self._items[:len(taken)]
        return taken
