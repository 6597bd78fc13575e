"""The privacy-budget service (counterpart of ``repro/privacy``): exact
Renyi accounting as an invertible, composable, cached service.

  * ``repro_torch.privacy.cache``     — the params-keyed memo and disk
    cache every exact aggregate epsilon goes through (core/renyi.py);
  * ``repro_torch.privacy.calibrate`` — the inverse accountant: given a
    target (eps, delta), a round count T and a cohort size n, bisect the
    family's privacy knob (RQM ``q``, PBM ``theta``, QMGeo ``r``) against
    the exact accountant and return a registered Mechanism on budget.

Exports are lazy: ``core.renyi`` imports ``privacy.cache`` at module
scope while ``calibrate`` imports ``core.renyi``, so the package body
touches neither submodule.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "EpsilonCache": "repro_torch.privacy.cache",
    "configure": "repro_torch.privacy.cache",
    "global_cache": "repro_torch.privacy.cache",
    "reset": "repro_torch.privacy.cache",
    "CalibrationResult": "repro_torch.privacy.calibrate",
    "calibrate": "repro_torch.privacy.calibrate",
    "composed_dp_epsilon": "repro_torch.privacy.calibrate",
    "calibration_knobs": "repro_torch.privacy.calibrate",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.privacy' has no attribute {name!r}")
    obj = getattr(importlib.import_module(mod), name)
    # rebind over the submodule attribute the import just set (the
    # ``calibrate`` function shares its submodule's name)
    globals()[name] = obj
    return obj
