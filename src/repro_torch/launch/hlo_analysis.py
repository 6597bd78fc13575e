"""Collective accounting, roofline terms and the dry run's counters
(counterpart of ``repro/launch/hlo_analysis.py``; the name is kept so
that a reader finds the counterpart).

The reference compiles each step and reads its numbers off XLA: FLOPs
and bytes from ``cost_analysis``, the peak from ``memory_analysis``, the
collectives from the optimised HLO text. The port compiles nothing. It
runs its eager program once, on PyTorch's meta device in a dry run
(nothing allocated, no data moved), and reads the recorded dispatch:

  * ``recording``: every collective the port issues
    (``models/common.py``: ``all_reduce_``, ``_gather``,
    ``_reduce_scatter``) appends ``(kind, bytes, group size)``, the bytes
    of the tensor reduced, of the whole gathered output, of the whole
    scattered input; ``collective_bytes`` charges each with a ring-model
    cost on its group:

      all-reduce          2 (n-1)/n * bytes     (reduce-scatter + all-gather)
      all-gather            (n-1)/n * bytes     (bytes = full output)
      reduce-scatter        (n-1)/n * bytes     (bytes = full input)
      all-to-all            (n-1)/n * bytes
      collective-permute            1 * bytes

    The result is bytes crossing each rank's links, per rank, as the
    FLOPs and bytes below are per rank.
  * ``counting``: the counters over the dispatched aten ops:
      - FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, the matmuls,
        convolutions and attention products (XLA's ``cost_analysis``
        also counts elementwise FLOPs);
      - bytes: each op's tensor inputs and outputs, views and
        uninitialised allocations (``empty``) left out, plus each
        hand-written kernel's traffic (its inputs read and outputs
        written once), which the kernels' dispatchers report through
        ``kernels/_build.py:charge`` on the card and on meta alike. With
        no fusion this is the traffic the eager program asks for;
      - live bytes: the storages that ops make inside the block, each
        counted from its making until it is freed (a finaliser on the
        storage); their largest sum is the peak above the start, as
        ``torch.cuda.max_memory_allocated()`` minus the bytes allocated
        at the start reads it on a card (which also rounds each block
        up, and holds cuBLAS's workspaces);
      - the collective records, as ``recording``.

A fake process group (``launch/mesh.py:fake_world``) runs the
collectives' code without moving data, so a meta run and a real run
record from one code path.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import _build
from repro_torch.models import common

_aten = torch.ops.aten
# allocations that write nothing: no traffic
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
               _aten.new_empty_strided}


@dataclasses.dataclass
class CollectiveStats:
    by_kind: dict
    total_bytes: float  # ring-model bytes per rank

    def summary(self):
        return {"total_ring_bytes": self.total_bytes, **self.by_kind}


def collective_bytes(records) -> CollectiveStats:
    """The ring-model cost of ``records`` (``(kind, bytes, group size)``
    each), by kind in order of first appearance: count, bytes and ring
    bytes, and their total."""
    by_kind: dict = {}
    total = 0.0
    for kind, size, n in records:
        n = n or 1
        if kind == "all-reduce":
            cost = 2.0 * (n - 1) / max(n, 1) * size
        elif kind == "collective-permute":
            cost = float(size)
        else:
            cost = (n - 1) / max(n, 1) * size
        ent = by_kind.setdefault(kind, {"count": 0, "bytes": 0.0, "ring_bytes": 0.0})
        ent["count"] += 1
        ent["bytes"] += size
        ent["ring_bytes"] += cost
        total += cost
    return CollectiveStats(by_kind=by_kind, total_bytes=total)


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float, hw) -> dict:
    compute_s = flops / hw["peak_flops_bf16"]
    memory_s = hbm_bytes / hw["hbm_bandwidth"]
    collective_s = coll_bytes / hw["ici_link_bandwidth"]
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
    }


def model_flops(cfg, shape, tp: int = 1) -> float:
    """MODEL_FLOPS = 6 * N_active * tokens (train) / 2 * N_active * tokens
    (inference), counting MoE experts at top_k/E utilization. Global (all
    ranks); divide by the rank count to compare with a rank's counted
    FLOPs."""
    from repro_torch.convert import leaves
    from repro_torch.models import model as model_lib

    metas = leaves(model_lib.param_meta(cfg, tp=tp))
    # count UNIQUE logical params: divide duplicated leaves by their sync
    # group, replicated leaves by tp
    sizes = []
    for m in metas:
        n = 1
        for d in m.shape:
            n *= d
        dup = max(1, min(m.sync, tp))
        sizes.append((n, dup))
    n_total = sum(n / dup for n, dup in sizes)

    if cfg.moe is not None:
        # expert leaves: (tp, e_l, D, F) ... identified by utilization factor
        expert_n = 0
        for m in metas:
            if len(m.shape) == 4 and m.shape[1] == cfg.moe.num_experts // tp:
                n = 1
                for d in m.shape:
                    n *= d
                expert_n += n
        n_active = n_total - expert_n * (1 - cfg.moe.top_k / cfg.moe.num_experts)
    else:
        n_active = n_total

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n_active * tokens


@contextlib.contextmanager
def recording():
    """The list of ``(kind, bytes, group size)`` of every collective the
    port issues in the block."""
    records: list = []
    common._recorders.append(records)
    try:
        yield records
    finally:
        common._recorders[:] = [r for r in common._recorders if r is not records]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages under ``tree``'s tensors."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            seen[id(s)] = s.nbytes()
    return sum(seen.values())


class Counts:
    """What ``counting`` read: ``flops``, ``bytes`` (the kernels' charges
    included), ``kernel_bytes`` (by entry), ``peak_bytes`` (live storages
    made in the block, at most), ``ops`` (aten ops dispatched) and
    ``collectives`` (the records)."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.kernel_bytes: collections.Counter = collections.Counter()
        self.peak_bytes = 0
        self.live_bytes = 0
        self.ops = 0
        self.collectives: list = []


class _Dispatch(TorchDispatchMode):
    """Counts bytes and live storages of the ops dispatched under it."""

    def __init__(self, counts: Counts):
        super().__init__()
        self.c = counts
        self._live: dict = {}

    def charge(self, fn: str, nbytes: int) -> None:
        self.c.bytes += nbytes
        self.c.kernel_bytes[fn] += nbytes

    def _free(self, key: int) -> None:
        self.c.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.c.ops += 1
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if not func.is_view and func.overloadpacket not in _NO_TRAFFIC:
            self.c.bytes += sum(_nbytes(t) for t in ins)
            self.c.bytes += sum(_nbytes(t) for t in tree_leaves(out)
                                if isinstance(t, torch.Tensor))
        # storages made by this op: its returns that alias no argument
        returns = func._schema.returns
        outs = out if len(returns) > 1 else (out,)
        made = [t for r, o in zip(returns, outs) if r.alias_info is None
                for t in tree_leaves(o) if isinstance(t, torch.Tensor)]
        if made:
            had = {id(t.untyped_storage()) for t in ins}
            for t in made:
                s = t.untyped_storage()
                key = id(s)
                if key in had or key in self._live:
                    continue
                self._live[key] = s.nbytes()
                self.c.live_bytes += s.nbytes()
                weakref.finalize(s, self._free, key)
            self.c.peak_bytes = max(self.c.peak_bytes, self.c.live_bytes)
        return out


@contextlib.contextmanager
def counting():
    """Count the block's dispatched work (the module docstring): yields a
    ``Counts``, complete when the block ends."""
    from torch.utils.flop_counter import FlopCounterMode

    c = Counts()
    mode = _Dispatch(c)
    flop_mode = FlopCounterMode(display=False)
    _build.traffic_listeners.append(mode.charge)
    try:
        with flop_mode, mode, recording() as records:
            yield c
    finally:
        _build.traffic_listeners.remove(mode.charge)
        mode._live.clear()
    c.flops = flop_mode.get_total_flops()
    c.collectives = list(records)
