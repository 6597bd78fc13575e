"""Calibrate a mechanism to a target privacy budget: the inverse
accountant (counterpart of ``repro/privacy/calibrate.py``).

Given a target (eps, delta), a round count T and a cohort size n, solve
for the mechanism's parameters:

    res = calibrate("rqm", target_eps=8.0, target_delta=1e-5,
                    rounds=200, cohort=40, c=0.02)
    res.mechanism  # a registered RQMMechanism on budget
    res.epsilon    # its composed (eps, delta)-DP eps: <= target, at most
                   # ``tol`` below it

Each family has one monotone knob, the other options fixed by the
caller: RQM's keep probability ``q`` and PBM's bias ``theta`` raise
epsilon as they grow, QMGeo's noise ratio ``r`` lowers it. Bisection
against the exact accountant is then correct, and every epsilon it
evaluates lands in the privacy cache (``privacy/cache.py``).

At fixed options a knob spans a bounded epsilon range: targets outside
[eps(knob_lo), eps(knob_hi)] raise ``CalibrationError`` with the
achievable range. The bisection, its brackets and its messages are the
reference's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.mechanisms import Mechanism, make_mechanism
from repro_torch.core.renyi import RenyiAccountant

# alpha grid of the (eps, delta)-DP conversion: the accountant's span,
# denser in the low orders where the optimum sits for small T
DEFAULT_ALPHAS = (1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 64.0)

# bisection steps before giving up on the window
_MAX_ITER = 60


@dataclasses.dataclass(frozen=True)
class Knob:
    """A mechanism family's scalar privacy knob for bisection."""

    option: str      # the from_options keyword the knob sets
    lo: float
    hi: float
    increasing: bool  # is eps increasing in the knob value?


# one knob per private family
_KNOBS = {
    "rqm": Knob("q", 1e-3, 0.995, increasing=True),
    "pbm": Knob("theta", 1e-3, 0.5, increasing=True),
    "qmgeo": Knob("r", 5e-3, 0.995, increasing=False),
}


def calibration_knobs() -> dict:
    """family name -> Knob (a copy)."""
    return dict(_KNOBS)


class CalibrationError(ValueError):
    """Target epsilon unreachable by the family's knob at the fixed
    options; ``achievable = (eps_min, eps_max)``."""

    def __init__(self, msg: str, achievable: tuple):
        super().__init__(msg)
        self.achievable = achievable


@dataclasses.dataclass
class CalibrationResult:
    mechanism: Mechanism
    epsilon: float          # composed (eps, delta)-DP eps of the T rounds
    alpha: float            # the alpha achieving it
    target_eps: float
    target_delta: float
    rounds: int
    cohort: int
    knob: str               # the option that was bisected
    value: float            # its calibrated value
    iterations: int         # exact-accountant evaluations spent

    def describe(self) -> str:
        return (f"{self.mechanism.describe()} -> eps={self.epsilon:.4f} "
                f"(target {self.target_eps:g}, delta={self.target_delta:g}, "
                f"T={self.rounds}, n={self.cohort}, alpha={self.alpha:g}, "
                f"{self.iterations} accountant evals)")


def composed_dp_epsilon(mech: Mechanism, *, cohort: int, rounds: int, delta: float) -> tuple:
    """(eps, alpha)-DP of ``rounds`` identical rounds of ``mech`` with
    ``cohort`` participating clients, by exact RDP composition over
    ``DEFAULT_ALPHAS``."""
    acc = RenyiAccountant(alphas=DEFAULT_ALPHAS)
    per_round = [mech.per_round_epsilon(cohort, a) for a in DEFAULT_ALPHAS]
    return acc.projected_dp_epsilon(delta, per_round, rounds)


def calibrate(family: str, *, target_eps: float, target_delta: float = 1e-5, rounds: int,
              cohort: int, tol: float = 0.01, **options) -> CalibrationResult:
    """Bisect the family's knob over its bracket until the composed
    (eps, delta)-DP eps of ``rounds`` rounds with ``cohort`` clients lies
    in ``[(1 - tol) * target_eps, target_eps]``. ``options`` are the
    family's other ``from_options`` keywords (not the knob)."""
    knob = _KNOBS.get(family)
    if knob is None:
        raise ValueError(f"no calibration knob for mechanism family {family!r}; "
                         f"calibratable: {', '.join(_KNOBS)}")
    if knob.option in options:
        raise ValueError(f"{knob.option!r} is the calibration knob for {family!r}; "
                         f"pass a target, not a value")
    if not (target_eps > 0 and 0 < target_delta < 1):
        raise ValueError(f"need target_eps > 0 and target_delta in (0, 1), got "
                         f"{target_eps}, {target_delta}")
    if rounds < 1 or cohort < 1:
        raise ValueError(f"need rounds >= 1 and cohort >= 1, got {rounds}, {cohort}")

    evals = 0

    def eps_at(v: float):
        nonlocal evals
        evals += 1
        mech = make_mechanism({"name": family, knob.option: float(v), **options})
        eps, alpha = composed_dp_epsilon(mech, cohort=cohort, rounds=rounds,
                                         delta=target_delta)
        return eps, alpha, mech

    lo, hi = knob.lo, knob.hi
    e_lo, a_lo, m_lo = eps_at(lo)
    e_hi, a_hi, m_hi = eps_at(hi)
    # orient by the knob's monotone direction
    e_min, e_max = (e_lo, e_hi) if knob.increasing else (e_hi, e_lo)
    if not (e_min <= target_eps):
        raise CalibrationError(
            f"target eps={target_eps:g} below the achievable minimum "
            f"{e_min:.4g} for {family!r} at {options} with T={rounds}, "
            f"n={cohort} (achievable [{e_min:.4g}, {e_max:.4g}]); lower T, "
            f"raise n, or change the fixed options (c/delta_ratio/m)",
            achievable=(e_min, e_max))
    if e_max < (1 - tol) * target_eps:
        raise CalibrationError(
            f"target eps={target_eps:g} above the achievable maximum "
            f"{e_max:.4g} for {family!r} at {options} with T={rounds}, "
            f"n={cohort} (achievable [{e_min:.4g}, {e_max:.4g}])",
            achievable=(e_min, e_max))

    def result(eps, alpha, mech, value):
        return CalibrationResult(mechanism=mech, epsilon=eps, alpha=alpha,
                                 target_eps=target_eps, target_delta=target_delta,
                                 rounds=rounds, cohort=cohort, knob=knob.option,
                                 value=float(value), iterations=evals)

    # an endpoint may already lie in the window (a just-reachable target)
    for e, a, m, v in ((e_lo, a_lo, m_lo, lo), (e_hi, a_hi, m_hi, hi)):
        if (1 - tol) * target_eps <= e <= target_eps:
            return result(e, a, m, v)

    # invariant: eps(under) <= target < eps(over)
    under, over = (lo, hi) if knob.increasing else (hi, lo)
    # the tightest point found at or below the target (e_min <= target here)
    best = (e_min,) + ((a_lo, m_lo, lo) if knob.increasing else (a_hi, m_hi, hi))
    for _ in range(_MAX_ITER):
        mid = 0.5 * (under + over)
        e, a, m = eps_at(mid)
        if e <= target_eps:
            under = mid
            if e > best[0]:
                best = (e, a, m, mid)
            if e >= (1 - tol) * target_eps:
                return result(e, a, m, mid)
        else:
            over = mid
    e, a, m, v = best
    if e >= (1 - tol) * target_eps:
        return result(e, a, m, v)
    raise CalibrationError(
        f"bisection stalled at eps={e:.4g} (< (1-tol) * target "
        f"{(1 - tol) * target_eps:.4g}) after {_MAX_ITER} iterations — "
        f"the knob's resolution cannot express the target this tightly; "
        f"loosen tol or adjust the fixed options",
        achievable=(e_min, e_max))
