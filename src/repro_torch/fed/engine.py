"""The round-engine registry: ``@register_engine`` and the ``Engine`` base
(counterpart of ``repro/fed/engine.py``).

An engine is a registered class that turns one FedTrainer's state into
executed Algorithm-1 rounds. The trainer owns what an engine needs (the
mechanism, the config, the staged data, the flat parameters, the server
optimizer's state, the round stream, the accountant); the engine owns how
rounds run: eager rounds, captured blocks, a host loop, or rounds over a
process group. Adding one is one registered class:

    @register_engine("myengine")
    class MyEngine(Engine):
        blocked = True
        @classmethod
        def validate(cls, cfg, mech): ...   # engine-specific checks
        def build(self): ...                # after staging and the optimizer
        def advance(self, rounds): ...      # run rounds and account them

``FedConfig.engine`` takes a registered name or a spec string
(``"shard:shards=1,packed=true"``), parsed by ``make_engine``. The port
registers ``scan``, ``perround``, ``host`` and ``shard`` (in that order,
``fed/engines.py``), then ``async`` (``fed/async_engine.py``), the
reference's order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, Tuple, Type

from repro_torch.core.mechanisms import parse_mechanism_spec

_REGISTRY: Dict[str, Type["Engine"]] = {}


def register_engine(name: str) -> Callable[[type], type]:
    """Class decorator: register an Engine subclass under ``name``."""

    def deco(cls: type) -> type:
        if not (isinstance(cls, type) and issubclass(cls, Engine)):
            raise TypeError(f"{cls!r} must subclass Engine")
        existing = _REGISTRY.get(name)
        if existing is not None and existing is not cls:
            raise ValueError(f"engine {name!r} already registered to {existing}")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def engine_names() -> tuple:
    """Registered engine names, in registration order."""
    return tuple(_REGISTRY)


def get_engine(name: str) -> Type["Engine"]:
    """The registered engine class ``name``."""
    cls = _REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"unknown engine {name!r}; registered: {', '.join(_REGISTRY)}")
    return cls


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """A parsed engine spec: the registered name and its options.
    ``overrides`` maps FedConfig field names (translated from the engine's
    option names) to values; ``apply(cfg)`` returns a copy of ``cfg`` with
    ``engine`` set to the bare name and the overrides set."""

    name: str
    options: Tuple[Tuple[str, object], ...] = ()
    overrides: Tuple[Tuple[str, object], ...] = ()

    def apply(self, cfg):
        return dataclasses.replace(cfg, engine=self.name, **dict(self.overrides))

    def spec(self) -> str:
        """Canonical spec string: ``make_engine(es.spec()) == es``."""
        if not self.options:
            return self.name
        return f"{self.name}:" + ",".join(f"{k}={v}" for k, v in self.options)


def parse_engine_spec(spec: str) -> tuple:
    """``"name:k=v,k=v"`` -> ``(name, options)``, the grammar of mechanism
    and tracker specs."""
    if not isinstance(spec, str):
        raise TypeError(f"engine spec must be a str, got {type(spec)}")
    name, opts = parse_mechanism_spec(spec)
    if not name:
        raise ValueError(f"empty engine name in spec {spec!r}")
    return name, opts


def make_engine(spec) -> EngineSpec:
    """An engine spec string, bare name or EngineSpec as an EngineSpec,
    its options checked against the engine's ``spec_options`` (option
    name -> FedConfig field); unknown options raise with the accepted
    set."""
    if isinstance(spec, EngineSpec):
        get_engine(spec.name)
        return spec
    name, opts = parse_engine_spec(spec)
    cls = get_engine(name)
    unknown = set(opts) - set(cls.spec_options)
    if unknown:
        accepted = sorted(cls.spec_options)
        raise ValueError(f"engine {name!r} does not accept option(s) {sorted(unknown)}; "
                         f"accepted: {accepted if accepted else '(none)'}")
    return EngineSpec(name=name, options=tuple(sorted(opts.items())),
                      overrides=tuple((cls.spec_options[k], v) for k, v in sorted(opts.items())))


class Engine:
    """One way of running Algorithm-1 rounds for a FedTrainer.

    Lifecycle, driven by ``FedTrainer.__init__``:

      1. ``validate(cfg, mech)``: a classmethod that raises on a config the
         engine cannot run, before any state is built;
      2. ``__init__(trainer)``: may claim resources (the shard engine's
         process group) and adjust the trainer's slate, before staging;
      3. ``build()``: the round steps, once the parameters, the staged
         data and the server optimizer exist;
      4. ``advance(rounds)``: run that many rounds, updating ``tr.flat``
         and ``tr.opt_state`` and accounting each round through the
         trainer's ``_account``/``_account_realized``.

    ``blocked`` engines advance in blocks (``FedTrainer.run_block``);
    ``stages_population`` engines get the whole population staged on the
    device before ``build()``; ``supports_streaming`` engines accept
    ``staging="stream"``.
    """

    name: ClassVar[str] = "?"
    blocked: ClassVar[bool] = False
    stages_population: ClassVar[bool] = True
    supports_streaming: ClassVar[bool] = False
    # spec option -> the FedConfig field it sets
    spec_options: ClassVar[Dict[str, str]] = {}

    def __init__(self, trainer):
        self.tr = trainer

    @classmethod
    def validate(cls, cfg, mech) -> None:
        """Engine-specific checks; the base refuses streamed staging on an
        engine that does not support it."""
        if cfg.staging == "stream" and not cls.supports_streaming:
            raise ValueError(f"staging='stream' requires a streaming-capable engine such as "
                             f"'shard'; {cls.name!r} does not support it")

    def build(self) -> None:
        """Build the engine's round steps (optional)."""

    def advance(self, rounds: int) -> None:
        raise NotImplementedError

    # -- the engine's own checkpoint state (fed/checkpointing.py) -----------
    # An engine whose trajectory depends on state beyond (flat, opt_state,
    # the round stream, host_rng), as the async engine's parameter ring
    # and arrival trace, saves it through these hooks under the
    # checkpoint's "engine" leaf: state() a tree of fixed-shape tensors
    # and arrays (None: nothing to save), state_template(steps_done) a
    # tree of the same structure to restore into, load_state(tree) installs
    # a restored one.

    def state(self):
        return None

    def state_template(self, steps_done: int):
        return None

    def load_state(self, tree) -> None:
        raise NotImplementedError(f"engine {self.name!r} has no checkpoint state")
