"""Registry-backed, self-accounting private quantizers (counterpart of
``repro/core/mechanisms.py``).

Each mechanism is a frozen dataclass that carries its parameters and
answers every question the round engine has about itself: the clip-then-
encode dispatch (``quantize_batch``, ``quantize_sum_batch``), the server
decode (``decode_sum``), the sum bound that picks the wire width
(``sum_bound``), and its exact per-round Renyi epsilon
(``per_round_epsilon``). ``make_mechanism`` builds any registered
mechanism from a name, a spec string or a dict, with the reference's
grammar:

    make_mechanism("rqm:c=0.02,m=16,q=0.42")
    make_mechanism({"name": "pbm", "c": 0.02, "theta": 0.25})
    make_mechanism("qmgeo", c=0.02, r=0.6)

Options inline in the spec are explicit (unknown ones raise); keyword
options are defaults (unknown ones are dropped per mechanism).

Seeds replace keys: every encode takes the round's uint32 kernel seed (an
int, or the 1-element int32 device tensor a captured round reads).
The reference's ``use_kernel=False`` path draws from ``jax.random``
(threefry), which this package does not reimplement, so it is refused.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Callable, ClassVar, Dict, Type, Union

import torch

from repro_torch.core import grid, pbm, qmgeo, wire
from repro_torch.core.grid import RQMParams
from repro_torch.core.pbm import PBMParams
from repro_torch.core.qmgeo import QMGeoParams

_REGISTRY: Dict[str, Type["Mechanism"]] = {}


def register_mechanism(name: str) -> Callable[[type], type]:
    """Class decorator: register a Mechanism subclass under ``name``."""

    def deco(cls: type) -> type:
        if not (isinstance(cls, type) and issubclass(cls, Mechanism)):
            raise TypeError(f"{cls!r} must subclass Mechanism")
        existing = _REGISTRY.get(name)
        if existing is not None and existing is not cls:
            raise ValueError(f"mechanism {name!r} already registered to {existing}")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def mechanism_names() -> tuple[str, ...]:
    """Registered mechanism names, in registration order."""
    return tuple(_REGISTRY)


def accepted_options(name: str) -> frozenset:
    """The options ``make_mechanism`` accepts for a registered mechanism
    (its ``from_options`` keywords)."""
    cls = _REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"unknown mechanism {name!r}; registered: {', '.join(_REGISTRY)}")
    return frozenset(inspect.signature(cls.from_options).parameters)


def _require_kernel(mech) -> None:
    if not mech.use_kernel:
        raise NotImplementedError(
            f"{mech.name} with use_kernel=False draws on jax.random (threefry), "
            "which this package does not reimplement; the port encodes with the "
            "counter-based splitmix32 kernels only")


class Mechanism:
    """Base interface and the shared clip -> encode dispatch. Subclasses
    implement ``encode_batch``, ``decode_sum``, ``sum_bound``,
    ``per_round_epsilon``, the ``bits``/``clip`` properties and a
    ``from_options`` classmethod (its signature defines the options the
    spec parser accepts)."""

    name: ClassVar[str] = "?"

    # -- interface (overridden by subclasses) -------------------------------
    def encode_batch(self, x: torch.Tensor, seed, *, row_offset: int = 0) -> torch.Tensor:
        """Messages of a (clients, dim) batch that plays rows
        ``[row_offset, row_offset + clients)`` of the round's batch."""
        raise NotImplementedError

    def encode_sum_batch(self, x: torch.Tensor, seed, *, weights=None,
                         row_offset: int = 0, pack_bits: int | None = None) -> torch.Tensor:
        """``sum_i weights[i] * encode(x[i])`` over the client axis, packed
        into wire words when ``pack_bits`` is set. The default encodes the
        batch and sums it; kernel-backed mechanisms override it with their
        fused round sum, which never materializes the batch."""
        z = self.encode_batch(x, seed, row_offset=row_offset)
        if weights is not None:
            z = z * weights.to(z.dtype)[:, None]
        z_sum = z.sum(0, dtype=z.dtype)
        return z_sum if pack_bits is None else wire.pack_bits(z_sum, pack_bits)

    def decode_sum(self, z_sum: torch.Tensor, n) -> torch.Tensor:
        """g_hat from the SecAgg sum of n clients' messages; ``n`` is an
        int (a fixed cohort) or a 0-d int32 device count (a realized one,
        decoded with the reference's traced-n arithmetic)."""
        raise NotImplementedError

    def sum_bound(self, n: int) -> int:
        """Largest value a coordinate of the sum of n messages can take."""
        raise NotImplementedError

    def per_round_epsilon(self, n: int, alpha: float) -> float:
        """Exact aggregate-level Renyi-DP epsilon of one round of n
        clients (0.0 for non-private mechanisms)."""
        raise NotImplementedError

    @property
    def bits(self) -> float:
        raise NotImplementedError

    @property
    def clip(self) -> float:
        raise NotImplementedError

    @classmethod
    def from_options(cls, **options) -> "Mechanism":
        raise NotImplementedError

    # -- shared clip -> encode dispatch --------------------------------------
    def _clip(self, g: torch.Tensor) -> torch.Tensor:
        return g.to(torch.float32).clamp(-self.clip, self.clip)

    def quantize(self, g: torch.Tensor, seed) -> torch.Tensor:
        """Clip then encode one client's vector (any shape)."""
        return self.encode_batch(self._clip(g).reshape(1, -1), seed).reshape(g.shape)

    def quantize_batch(self, g: torch.Tensor, seed, *, row_offset: int = 0) -> torch.Tensor:
        """Clip then encode a stacked (clients, dim) batch."""
        return self.encode_batch(self._clip(g), seed, row_offset=row_offset)

    def quantize_sum_batch(self, g: torch.Tensor, seed, *, weights=None,
                           row_offset: int = 0, pack_bits: int | None = None) -> torch.Tensor:
        """Clip then the fused encode-and-sum: the SecAgg sum of the batch."""
        return self.encode_sum_batch(self._clip(g), seed, weights=weights,
                                     row_offset=row_offset, pack_bits=pack_bits)

    # -- wire format (core/wire.py) ------------------------------------------
    @property
    def payload_bits(self):
        """Minimal width of one client's message fields, the bit length of
        ``sum_bound(1)`` (RQM m=16: levels reach 15, 4 bits; PBM m=16:
        levels reach m, 5 bits); None for a mechanism whose messages are
        not bounded integers (the noise-free baseline)."""
        b = self.sum_bound(1)
        return wire.sum_bits(b) if b > 0 else None

    def encode_wire(self, g, seed):
        """Clip and encode one client's vector ``g`` (a tensor on any
        device, or an array) with the uint32 ``seed`` (an int, or a 0-d or
        1-element int32 device tensor), packed at the minimal payload
        width: the host-side ``wire.PackedPayload`` a client submits to the
        aggregator. The encode is ``quantize``: row 0 of a one-row batch,
        whose RNG counters are the flat indices, the reference's
        single-leaf encode's counters. On the card the levels are packed
        there (``pack_flat``) and only the words are copied to the host;
        on the CPU the plain codec packs them. A mechanism without a
        packable integer message returns its dense encode as a numpy array
        (the noise-free baseline's floats)."""
        from repro_torch.kernels.pack_kernel import pack_flat

        z = self.quantize(torch.as_tensor(g), seed).reshape(-1)
        b = self.payload_bits
        if b is None or not wire.packable(self.sum_bound(1), b):
            return z.cpu().numpy()
        return wire.PackedPayload(words=pack_flat(z, b).cpu().numpy(), bits=b,
                                  length=z.numel())

    # -- introspection -------------------------------------------------------
    def spec(self) -> dict:
        """Canonical dict spec: ``make_mechanism(mech.spec())`` rebuilds an
        equal mechanism."""
        out = {"name": self.name}
        d = dataclasses.asdict(self)
        out.update(d.pop("params", {}))
        out.update(d)
        return out

    def describe(self) -> str:
        """CLI-readable one-liner, e.g. ``rqm:c=0.05,delta=0.05,m=16,q=0.42,...``."""
        opts = {k: v for k, v in self.spec().items() if k != "name"}
        body = ",".join(f"{k}={v:g}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in opts.items())
        return f"{self.name}:{body}" if body else self.name


@register_mechanism("rqm")
@dataclasses.dataclass(frozen=True)
class RQMMechanism(Mechanism):
    """The paper's Randomized Quantization Mechanism (Algorithm 2)."""

    params: RQMParams
    use_kernel: bool = True

    def __post_init__(self):
        _require_kernel(self)

    @classmethod
    def from_options(cls, c: float, m: int = 16, q: float = 0.42,
                     delta_ratio: float = 1.0, delta: float = None,
                     use_kernel: bool = True) -> "RQMMechanism":
        # paper defaults: m=16, (delta, q) = (c, 0.42)
        if delta is None:
            delta = delta_ratio * c
        return cls(RQMParams(c=c, delta=delta, m=m, q=q), use_kernel=use_kernel)

    def encode_batch(self, x, seed, *, row_offset=0):
        from repro_torch.kernels import ops

        return ops.rqm_batch(x, seed, self.params, row_offset=row_offset)

    def encode_sum_batch(self, x, seed, *, weights=None, row_offset=0, pack_bits=None):
        from repro_torch.kernels import ops

        return ops.rqm_round_sum(x, seed, self.params, weights=weights,
                                 row_offset=row_offset, pack_bits=pack_bits)

    def decode_sum(self, z_sum, n):
        return grid.decode_sum(z_sum, n, self.params)

    def sum_bound(self, n):
        return n * (self.params.m - 1)

    def per_round_epsilon(self, n, alpha):
        from repro_torch.core.renyi import rqm_aggregate_epsilon

        return rqm_aggregate_epsilon(self.params, n, alpha)

    @property
    def bits(self):
        return self.params.bits_per_coordinate

    @property
    def clip(self):
        return self.params.c


@register_mechanism("pbm")
@dataclasses.dataclass(frozen=True)
class PBMMechanism(Mechanism):
    """Poisson Binomial Mechanism baseline (Chen et al., ICML 2022)."""

    params: PBMParams
    use_kernel: bool = True

    def __post_init__(self):
        _require_kernel(self)

    @classmethod
    def from_options(cls, c: float, m: int = 16, theta: float = 0.25,
                     use_kernel: bool = True) -> "PBMMechanism":
        return cls(PBMParams(c=c, m=m, theta=theta), use_kernel=use_kernel)

    def encode_batch(self, x, seed, *, row_offset=0):
        from repro_torch.kernels import ops

        return ops.pbm_batch(x, seed, self.params, row_offset=row_offset)

    def encode_sum_batch(self, x, seed, *, weights=None, row_offset=0, pack_bits=None):
        from repro_torch.kernels import ops

        return ops.pbm_round_sum(x, seed, self.params, weights=weights,
                                 row_offset=row_offset, pack_bits=pack_bits)

    def decode_sum(self, z_sum, n):
        return pbm.decode_sum(z_sum, n, self.params)

    def sum_bound(self, n):
        return n * self.params.m

    def per_round_epsilon(self, n, alpha):
        from repro_torch.core.renyi import pbm_aggregate_epsilon

        return pbm_aggregate_epsilon(self.params, n, alpha)

    @property
    def bits(self):
        return self.params.bits_per_coordinate

    @property
    def clip(self):
        return self.params.c


@register_mechanism("qmgeo")
@dataclasses.dataclass(frozen=True)
class QMGeoMechanism(Mechanism):
    """QMGeo-style truncated-geometric randomized quantizer (core/qmgeo.py)."""

    params: QMGeoParams
    use_kernel: bool = True

    def __post_init__(self):
        _require_kernel(self)

    @classmethod
    def from_options(cls, c: float, m: int = 16, r: float = 0.6,
                     delta_ratio: float = 1.0, delta: float = None,
                     use_kernel: bool = True) -> "QMGeoMechanism":
        if delta is None:
            delta = delta_ratio * c
        return cls(QMGeoParams(c=c, delta=delta, m=m, r=r), use_kernel=use_kernel)

    def encode_batch(self, x, seed, *, row_offset=0):
        from repro_torch.kernels import ops

        return ops.qmgeo_batch(x, seed, self.params, row_offset=row_offset)

    def encode_sum_batch(self, x, seed, *, weights=None, row_offset=0, pack_bits=None):
        from repro_torch.kernels import ops

        return ops.qmgeo_round_sum(x, seed, self.params, weights=weights,
                                   row_offset=row_offset, pack_bits=pack_bits)

    def decode_sum(self, z_sum, n):
        return qmgeo.decode_sum(z_sum, n, self.params)

    def sum_bound(self, n):
        return n * (self.params.m - 1)

    def per_round_epsilon(self, n, alpha):
        from repro_torch.core.renyi import qmgeo_aggregate_epsilon

        return qmgeo_aggregate_epsilon(self.params, n, alpha)

    @property
    def bits(self):
        return self.params.bits_per_coordinate

    @property
    def clip(self):
        return self.params.c


@register_mechanism("none")
@dataclasses.dataclass(frozen=True)
class NoiseFreeMechanism(Mechanism):
    """Noise-free clipped SGD, the paper's non-private upper bound: the
    message is the clipped float gradient itself and the decode averages."""

    c: float

    @classmethod
    def from_options(cls, c: float) -> "NoiseFreeMechanism":
        return cls(c=c)

    def encode_batch(self, x, seed, *, row_offset=0):
        return x.clamp(-self.c, self.c)

    def decode_sum(self, g_sum, n):
        # divide by a device tensor: IEEE division on the card too (a
        # device count, the realized cohort, is converted on the device)
        if isinstance(n, torch.Tensor):
            return g_sum / n.reshape(()).to(g_sum.dtype)
        return g_sum / _cohort_size(n, g_sum.dtype, g_sum.device)

    def sum_bound(self, n):
        return 0

    def per_round_epsilon(self, n, alpha):
        return 0.0

    @property
    def bits(self):
        return 32.0

    @property
    def clip(self):
        return self.c


@functools.lru_cache(maxsize=None)
def _cohort_size(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``n`` as a 0-d tensor, made once per (n, dtype, device): making it
    copies host to device, which a captured round may not do."""
    return torch.tensor(float(n), dtype=dtype, device=device)


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
        raise TypeError(f"spec must be str | dict | Mechanism, got {type(spec)}")
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


def make_mechanism(spec, **defaults) -> Mechanism:
    """Build a registered mechanism from a name, spec string or dict.
    ``defaults`` fill options the spec leaves out (unknown ones are
    ignored); options in the spec must be known. A Mechanism passes
    through unchanged."""
    if isinstance(spec, Mechanism):
        return spec
    name, explicit = parse_mechanism_spec(spec)
    cls = _REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"unknown mechanism {name!r}; registered: {', '.join(_REGISTRY)}")
    accepted = accepted_options(name)
    unknown = set(explicit) - accepted
    if unknown:
        raise ValueError(f"mechanism {name!r} does not accept option(s) "
                         f"{sorted(unknown)}; accepted: {sorted(accepted)}")
    options = {k: v for k, v in defaults.items() if k in accepted}
    options.update(explicit)
    return cls.from_options(**options)


def make_rqm_mechanism(params: RQMParams, *, use_kernel: bool = True) -> Mechanism:
    return RQMMechanism(params, use_kernel=use_kernel)


def make_pbm_mechanism(params: PBMParams, *, use_kernel: bool = True) -> Mechanism:
    return PBMMechanism(params, use_kernel=use_kernel)


def make_qmgeo_mechanism(params: QMGeoParams, *, use_kernel: bool = True) -> Mechanism:
    return QMGeoMechanism(params, use_kernel=use_kernel)


def make_noise_free_mechanism(c: float) -> Mechanism:
    return NoiseFreeMechanism(c=c)
