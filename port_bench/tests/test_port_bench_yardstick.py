"""The frozen yardstick against today's sources at the reference shapes:
the H100's peaks, ``chip_smoke.py:bound``, the RQM encode's needed draws,
the CNN's parameters and FLOPs, and ``model_flops``' 6 N tokens."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from small_cells import ROOT, bench  # noqa: F401  (puts the benchmark on the path)

import yardstick

import sys

sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def test_peaks_are_the_programs_and_chip_smokes():
    from repro_torch.launch.mesh import H100

    assert yardstick.PEAK_BF16_FLOPS == H100["peak_flops_bf16"] == chip_smoke.BF16_FLOPS_PER_S
    assert yardstick.HBM_BYTES_PER_S == H100["hbm_bandwidth"] == chip_smoke.HBM_BYTES_PER_S
    assert yardstick.PEAK_FP32_FLOPS == chip_smoke.F32_FLOPS_PER_S
    for name in ("ALU_OPS_PER_S", "FMA_OPS_PER_S", "ALU_ONLY_OPS_PER_DRAW",
                 "FMA_ONLY_OPS_PER_DRAW", "EITHER_OPS_PER_DRAW"):
        assert getattr(yardstick, name) == getattr(chip_smoke, name)


@pytest.mark.parametrize("nbytes,draws", [(71_044_800, 0), (71_044_800, 49_019_000),
                                          (8, 10**9), (3_358_109_696, 2_316_611_584)])
def test_bound_is_chip_smokes(nbytes, draws):
    assert yardstick.bound_s(nbytes, draws) * 1e3 == pytest.approx(
        chip_smoke.bound(nbytes, draws)[0], rel=1e-12)


def test_rqm_needed_draws_at_the_reference_shapes():
    from repro_torch.core.mechanisms import make_mechanism

    params = make_mechanism(chip_smoke.SPECS["rqm"]).params
    rng = np.random.default_rng(2024)
    c = params.c
    x = torch.from_numpy(rng.uniform(-1.2 * c, 1.2 * c, size=(chip_smoke.ROWS, chip_smoke.DIM))
                         .astype(np.float32))
    seed = int(rng.integers(0, 1 << 32))
    draws = chip_smoke.rqm_needed_draws(torch, x, seed, params)
    assert draws / x.numel() == yardstick.RQM_DRAWS_PER_ELEMENT == 5.518855897851641


def test_cnn_parameters_and_flops():
    from repro_torch.convert import ravel
    from repro_torch.fed.cnn import cnn_apply, cnn_init
    from torch.utils.flop_counter import FlopCounterMode

    params = cnn_init(torch.Generator().manual_seed(0), device="cpu")
    assert ravel(params)[0].numel() == yardstick.cnn_params() == 222_030
    counter = FlopCounterMode(display=False)
    with counter:
        cnn_apply(params, torch.zeros((1, 28, 28)))
    assert counter.get_total_flops() == yardstick.cnn_flops_per_sample() == 6_062_080


def test_mamba2_parameters_and_model_flops():
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.hlo_analysis import model_flops

    conf = bench.load_json(bench.HERE / "configs" / "mamba2-370m-rqm.json")
    n = yardstick.mamba2_params(conf)
    assert n == conf["num_parameters"] == 419_763_712
    cfg = get_config("mamba2-370m")
    shape = InputShape("train-8x1024", 1024, 8, "train")
    assert yardstick.train_flops(n, 8 * 1024) == model_flops(cfg, shape)
