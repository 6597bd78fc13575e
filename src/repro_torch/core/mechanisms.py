"""The RQM mechanism and the mechanism spec parser (RQM slice of
``repro/core/mechanisms.py``).

``make_mechanism("rqm:c=0.02,m=16,q=0.42")`` builds an ``RQMMechanism``
from the same spec grammar as the reference. The other registered
families of the reference (pbm, qmgeo, none) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Union

import torch

from repro_torch.core import grid
from repro_torch.core.grid import RQMParams

# families of the reference that this package does not carry yet
_NOT_PORTED = {
    "pbm": "ROADMAP.md queue A item 8 (PBM)",
    "qmgeo": "ROADMAP.md queue A item 8 (QMGeo)",
    "none": "ROADMAP.md queue A item 2 (the 'none' baseline)",
}


@dataclasses.dataclass(frozen=True)
class RQMMechanism:
    """The paper's Randomized Quantization Mechanism (Algorithm 2)."""

    params: RQMParams

    @classmethod
    def from_options(cls, c: float, m: int = 16, q: float = 0.42,
                     delta_ratio: float = 1.0, delta: float = None) -> "RQMMechanism":
        # paper defaults: m=16, (delta, q) = (c, 0.42)
        if delta is None:
            delta = delta_ratio * c
        return cls(RQMParams(c=c, delta=delta, m=m, q=q))

    @property
    def clip(self) -> float:
        return self.params.c

    def sum_bound(self, n: int) -> int:
        """Largest value a coordinate of the sum of n messages can take."""
        return n * (self.params.m - 1)

    def quantize_sum_batch(self, g: torch.Tensor, seed: int, *, weights=None,
                           row_offset: int = 0, pack_bits: int | None = None
                           ) -> torch.Tensor:
        """Clip + fused encode-and-sum of a (clients, dim) batch with uint32
        kernel seed ``seed``: the SecAgg sum, packed when ``pack_bits``."""
        from repro_torch.kernels import ops

        return ops.rqm_round_sum(g, seed, self.params, weights=weights,
                                 row_offset=row_offset, pack_bits=pack_bits)

    def decode_sum(self, z_sum: torch.Tensor, n: int) -> torch.Tensor:
        return grid.decode_sum(z_sum, n, self.params)

    def per_round_epsilon(self, n: int, alpha: float) -> float:
        """Exact aggregate-level Renyi-DP epsilon of one round of n clients."""
        from repro_torch.core.renyi import rqm_aggregate_epsilon

        return rqm_aggregate_epsilon(self.params, n, alpha)


def _coerce(text: str):
    """Option value -> bool | int | float | str."""
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def parse_mechanism_spec(spec: Union[str, dict]) -> tuple[str, dict]:
    """``"rqm:c=0.05,m=16"`` -> ("rqm", {"c": 0.05, "m": 16}); a dict
    spec carries its name under ``"name"``."""
    if isinstance(spec, dict):
        opts = dict(spec)
        if "name" not in opts:
            raise ValueError(f"dict spec needs a 'name' key, got {spec!r}")
        return opts.pop("name"), opts
    if not isinstance(spec, str):
        raise TypeError(f"spec must be str | dict | RQMMechanism, got {type(spec)}")
    name, _, body = spec.partition(":")
    opts: dict = {}
    if body.strip():
        for item in body.split(","):
            k, sep, v = item.partition("=")
            if not sep or not k.strip():
                raise ValueError(f"malformed option {item!r} in spec {spec!r} "
                                 f"(expected key=value)")
            opts[k.strip()] = _coerce(v.strip())
    return name.strip(), opts


def make_mechanism(spec, **defaults) -> RQMMechanism:
    """Build a mechanism from a spec string or dict. ``defaults`` fill
    options the spec leaves out (unknown ones are ignored); options in
    the spec must be known."""
    if isinstance(spec, RQMMechanism):
        return spec
    name, explicit = parse_mechanism_spec(spec)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"mechanism {name!r} is not ported yet: {_NOT_PORTED[name]}")
    if name != "rqm":
        raise ValueError(f"unknown mechanism {name!r}; ported: rqm")
    accepted = set(inspect.signature(RQMMechanism.from_options).parameters)
    unknown = set(explicit) - accepted
    if unknown:
        raise ValueError(f"mechanism 'rqm' does not accept option(s) "
                         f"{sorted(unknown)}; accepted: {sorted(accepted)}")
    options = {k: v for k, v in defaults.items() if k in accepted}
    options.update(explicit)
    return RQMMechanism.from_options(**options)
