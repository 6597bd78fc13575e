"""Mechanisms, grid, wire codec and privacy accounting: the paper's
contribution (RQM), its baselines and their accounting (counterpart of
``repro/core/__init__.py``, whose names it exports)."""
from repro_torch.core.grid import RQMParams, decode_sum, encode_value
from repro_torch.core.mechanisms import (
    Mechanism,
    NoiseFreeMechanism,
    PBMMechanism,
    QMGeoMechanism,
    RQMMechanism,
    make_mechanism,
    make_noise_free_mechanism,
    make_pbm_mechanism,
    make_qmgeo_mechanism,
    make_rqm_mechanism,
    mechanism_names,
    parse_mechanism_spec,
    register_mechanism,
)
from repro_torch.core.pbm import PBMParams
from repro_torch.core.qmgeo import QMGeoParams

__all__ = [
    "RQMParams",
    "PBMParams",
    "QMGeoParams",
    "Mechanism",
    "RQMMechanism",
    "PBMMechanism",
    "QMGeoMechanism",
    "NoiseFreeMechanism",
    "register_mechanism",
    "mechanism_names",
    "parse_mechanism_spec",
    "make_mechanism",
    "make_rqm_mechanism",
    "make_pbm_mechanism",
    "make_qmgeo_mechanism",
    "make_noise_free_mechanism",
    "decode_sum",
    "encode_value",
]
