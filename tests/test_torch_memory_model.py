"""The analytical per-rank memory model (``launch/memory_model.py``)
against the reference's ``repro/launch/memory_model.py``, on the CPU:

  * ``estimate`` equals the reference's term for term (relative
    ``TERM_RTOL``) for every architecture of the registry, every
    ``INPUT_SHAPES`` entry, every combination of ``zero1``,
    ``seq_parallel`` and ``kv_quant``, on the reference's meshes
    (``{data: 16, model: 16}`` and ``{pod: 2, data: 16, model: 16}``) and
    two ranks on one card's (``{data: 2, model: 1}``; one rank's in
    ``test_fits_against_the_card_or_none``);
    its ``fits`` (against ``hbm_bytes``) as the reference's ``fits_16g``
    at 16 GiB;
  * ``params_device_bytes`` equals the reference's;
  * the assertions of the reference's ``tests/test_memory_model.py``,
    mirrored.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import pytest

from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.configs.registry import get_config as jget_config
from repro.launch import memory_model as jmm
from repro.models import model as jmodel
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch.memory_model import estimate, params_device_bytes
from repro_torch.models import model

TERM_RTOL = 1e-12
MESH = {"data": 16, "model": 16}
MESH_MP = {"pod": 2, "data": 16, "model": 16}
MESHES = (MESH, MESH_MP, {"data": 2, "model": 1})
GiB16 = 16 * 1024**3


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_estimate_equals_reference_term_for_term(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    n = 0
    for shape in INPUT_SHAPES:
        for mesh in MESHES:
            for zero1 in (False, True):
                for sp in (False, True):
                    for kv in (False, True):
                        kw = dict(zero1=zero1, seq_parallel=sp, kv_quant=kv)
                        want = jmm.estimate(jcfg, JAX_SHAPES[shape], mesh, **kw)
                        got = estimate(cfg, INPUT_SHAPES[shape], mesh, hbm_bytes=GiB16, **kw)
                        assert set(got) == set(want) - {"fits_16g"} | {"fits"}
                        for k, v in want.items():
                            if k == "fits_16g":
                                assert got["fits"] is v, (shape, mesh, kw)
                                continue
                            assert got[k] == pytest.approx(v, rel=TERM_RTOL, abs=0), (
                                shape, mesh, kw, k)
                            n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ("gemma3-4b", "qwen3-moe-30b-a3b", "mamba2-370m"))
def test_params_device_bytes_equal_reference(arch):
    for mesh in MESHES:
        tp = mesh["model"]
        assert params_device_bytes(model.param_meta(get_config(arch), tp=tp), mesh) == \
            jmm.params_device_bytes(jmodel.param_meta(jget_config(arch), tp=tp), mesh)


def test_param_bytes_scale_with_sharding():
    per_dev = params_device_bytes(model.param_meta(get_config("gemma3-4b"), tp=16), MESH)
    # ~4B params f32 / 16-way model sharding ~ 1 GiB (duplication adds some)
    assert 0.7e9 < per_dev < 2.5e9


def test_train_components_positive_and_fit_flags():
    for arch in ("gemma3-4b", "nemotron-4-15b", "qwen3-moe-30b-a3b"):
        est = estimate(get_config(arch), INPUT_SHAPES["train_4k"], MESH, hbm_bytes=GiB16)
        for k, v in est.items():
            if k != "fits":
                assert v >= 0, (arch, k, v)
        assert est["total"] == pytest.approx(
            sum(v for k, v in est.items() if k not in ("total", "fits")))


def test_seq_parallel_reduces_activations():
    cfg = get_config("nemotron-4-15b")
    sp = estimate(cfg, INPUT_SHAPES["train_4k"], MESH, seq_parallel=True)
    nosp = estimate(cfg, INPUT_SHAPES["train_4k"], MESH, seq_parallel=False)
    assert nosp["saved_activations"] == pytest.approx(16 * sp["saved_activations"])


def test_zero1_reduces_total():
    cfg = get_config("qwen3-moe-30b-a3b")
    base = estimate(cfg, INPUT_SHAPES["train_4k"], MESH, hbm_bytes=GiB16)
    z1 = estimate(cfg, INPUT_SHAPES["train_4k"], MESH, zero1=True, hbm_bytes=GiB16)
    assert z1["total"] < base["total"]
    assert z1["fits"]


def test_decode_dominated_by_params_and_caches():
    est = estimate(get_config("nemotron-4-15b"), INPUT_SHAPES["decode_32k"], MESH)
    assert est["params"] > 0 and est["caches"] > 0
    assert est["total"] < GiB16


def test_multipod_not_larger():
    cfg = get_config("nemotron-4-15b")
    sp = estimate(cfg, INPUT_SHAPES["train_4k"], MESH)
    mp = estimate(cfg, INPUT_SHAPES["train_4k"], MESH_MP)
    assert mp["total"] <= sp["total"] + 1e6


def test_fits_against_the_card_or_none():
    """``fits`` is None without a card and no ``hbm_bytes``; the one-card
    gemma3-4b train step of batch 2 x seq 256 (sgd) fits 80 GB at
    42,950,037,504 B, ZeRO-1 over two clients at 33.26 GB a rank."""
    from repro_torch.configs.base import InputShape

    cfg, shape = get_config("gemma3-4b"), InputShape("cli", 256, 2, "train")
    one = estimate(cfg, shape, {"data": 1, "model": 1}, hbm_bytes=80e9)
    assert one["total"] == 42_950_037_504 and one["fits"] is True
    assert estimate(cfg, shape, {"data": 1, "model": 1}, hbm_bytes=40e9)["fits"] is False
    z1 = estimate(cfg, shape, {"data": 2, "model": 1}, zero1=True, hbm_bytes=80e9)
    assert z1["total"] == pytest.approx(33.26e9, rel=1e-3)
    import torch

    if not torch.cuda.is_available():
        assert estimate(cfg, shape, {"data": 1, "model": 1})["fits"] is None
