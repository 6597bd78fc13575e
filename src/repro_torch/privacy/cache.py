"""Params-keyed memo and disk cache for exact aggregate epsilons
(counterpart of ``repro/privacy/cache.py``; stdlib only).

Every exact aggregate Renyi epsilon is an n-fold pmf convolution then a
divergence, and the same (params, n, alpha) points recur: a calibration
bisects ~40 times over one alpha grid, and every trainer derives its
per-round vector. So:

  * an always-on in-process memo (``EpsilonCache``), keyed by the string
    ``epsilon_key(family, params, n, alpha, seed)``: the inputs that
    determine the value, floats at full precision (``repr(float)``), the
    reference's keys for the same params;
  * an optional JSON disk layer shared across processes:
    ``REPRO_PRIVACY_CACHE=/path/eps.json`` or ``configure(path=...)``;
    written atomically (a temporary file, then ``os.replace``);
  * the stats ``hits``, ``misses``, ``disk_hits`` and ``computes``: a
    repeated calibration computes nothing.

Entries carry ``ACCOUNTING_VERSION``: bump it whenever
``core/distribution.py`` or ``core/renyi.py`` change meaning, and disk
entries of another version are ignored.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Callable, Optional

# Bump when the numeric meaning of distribution.py / renyi.py changes:
# disk entries written under another version are ignored, never served.
ACCOUNTING_VERSION = 1

_ENV_VAR = "REPRO_PRIVACY_CACHE"


def params_key(params) -> tuple:
    """Canonical hashable key of a frozen params dataclass (or mapping):
    sorted (field, value) pairs, floats at full precision."""
    if dataclasses.is_dataclass(params):
        items = sorted(dataclasses.asdict(params).items())
    elif isinstance(params, dict):
        items = sorted(params.items())
    else:  # already canonical (tuple/scalar)
        return (params,)
    return tuple((k, v) for k, v in items)


def epsilon_key(family: str, params, n: int, alpha: float, seed: int = 0) -> str:
    """Flat string key, stable across processes (the disk JSON's keys)."""
    parts = [f"v{ACCOUNTING_VERSION}", family]
    for k, v in params_key(params):
        parts.append(f"{k}={v!r}")
    parts += [f"n={int(n)}", f"alpha={float(alpha)!r}", f"seed={int(seed)}"]
    return "|".join(parts)


class EpsilonCache:
    """Memo + optional JSON disk layer for exact epsilon values;
    ``get_or_compute(key, fn)`` is the whole interface the accounting
    uses."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._mem: dict = {}
        self._disk_loaded = False
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        self.computes = 0  # actual pmf-convolution runs (== misses)

    def _load_disk(self) -> None:
        if self._disk_loaded or not self.path:
            return
        self._disk_loaded = True
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        prefix = f"v{ACCOUNTING_VERSION}|"
        for k, v in data.items():
            if k.startswith(prefix) and k not in self._mem:
                self._mem[k] = float(v)
                self.disk_hits += 1  # entries revived from disk

    def _save_disk(self) -> None:
        """Merge, then replace: re-read the file and write the union with
        this process's entries through a temporary file renamed over it,
        so that processes sharing one file accumulate each other's values
        (an epsilon is deterministic in its key: merge order is moot)."""
        if not self.path:
            return
        merged: dict = {}
        try:
            with open(self.path) as f:
                merged = {k: float(v) for k, v in json.load(f).items()}
        except (OSError, ValueError):
            pass
        merged.update(self._mem)
        folder = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(folder, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(merged, f, indent=0, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def get_or_compute(self, key: str, fn: Callable[[], float]) -> float:
        self._load_disk()
        if key in self._mem:
            self.hits += 1
            return self._mem[key]
        self.misses += 1
        self.computes += 1
        val = float(fn())
        self._mem[key] = val
        self._save_disk()
        return val

    def __len__(self) -> int:
        self._load_disk()
        return len(self._mem)

    def stats(self) -> dict:
        return {"entries": len(self._mem), "hits": self.hits, "misses": self.misses,
                "disk_hits": self.disk_hits, "computes": self.computes, "path": self.path}


_CACHE: Optional[EpsilonCache] = None


def global_cache() -> EpsilonCache:
    """The process-wide cache; its disk layer is ``$REPRO_PRIVACY_CACHE``
    (a JSON path; empty, '0', 'off' or 'none' keep it in memory)."""
    global _CACHE
    if _CACHE is None:
        path = os.environ.get(_ENV_VAR, "").strip()
        if path.lower() in ("", "0", "off", "none"):
            path = None
        _CACHE = EpsilonCache(path=path)
    return _CACHE


def configure(path: Optional[str]) -> EpsilonCache:
    """Replace the global cache (tests; sweeps that want a disk file)."""
    global _CACHE
    _CACHE = EpsilonCache(path=path)
    return _CACHE


def reset() -> EpsilonCache:
    """Drop every memoized value (a fresh memory-only cache)."""
    return configure(None)


def cached_epsilon(family: str, params, n: int, alpha: float, seed: int,
                   fn: Callable[[], float]) -> float:
    """Route one exact-epsilon computation through the global cache."""
    return global_cache().get_or_compute(epsilon_key(family, params, n, alpha, seed), fn)
