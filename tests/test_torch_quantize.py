"""The port's per-element quantize (src/repro_torch/kernels: ``rqm_quantize``,
``pbm_quantize``, ``qmgeo_quantize``, the plain versions of rows 5-7 of
PERF.md's kernel table) and its pbm/qmgeo round sums, against the JAX
reference on the CPU.

Inputs are made with numpy and keyed on the uint32 kernel seed (the
goldens' ``kernel_seed_u32``), never on a JAX key. Contracts:

  * RQM and PBM levels and sums: equal, bit for bit, to the reference's
    ``_rqm_block`` / ``_pbm_block`` (jitted), to its Pallas bodies in
    interpret mode, and to tests/golden/encoded_sums.json and
    packed_words.json;
  * QMGeo: the same, within QMGEO_BUDGET. XLA:CPU's ``exp`` and
    PyTorch's are different implementations, so ``cum <= t`` can fall the
    other way where the two are within an ulp. Each mismatch is one
    level; their count goes into the JUnit report.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import dataclasses
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.grid import RQMParams as JaxRQMParams
from repro.core.pbm import PBMParams as JaxPBMParams
from repro.core.qmgeo import QMGeoParams as JaxQMGeoParams
from repro.kernels import fused_round_kernel as jfused
from repro.kernels import pbm_kernel as jpbm
from repro.kernels import qmgeo_kernel as jqmgeo
from repro.kernels import rqm_kernel as jrqm
from repro_torch.core.grid import RQMParams
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.core.pbm import PBMParams
from repro_torch.core.qmgeo import QMGeoParams
from repro_torch.kernels import fused_round_kernel, ops, pbm_kernel, qmgeo_kernel, rqm_kernel

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "scripts"))
from make_goldens import golden_sum_inputs  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SEED = 2216260512
C = 0.02
# name -> (reference params, port params, reference block, reference Pallas
# entry, port quantize)
MECHS = {
    "rqm": (JaxRQMParams(C, C, 16, 0.42), RQMParams(C, C, 16, 0.42),
            jrqm._rqm_block, jrqm.rqm_quantize_2d, rqm_kernel.rqm_quantize),
    "pbm": (JaxPBMParams(C, 16, 0.25), PBMParams(C, 16, 0.25),
            jpbm._pbm_block, jpbm.pbm_quantize_2d, pbm_kernel.pbm_quantize),
    "qmgeo": (JaxQMGeoParams(C, C, 16, 0.6), QMGeoParams(C, C, 16, 0.6),
              jqmgeo._qmgeo_block, jqmgeo.qmgeo_quantize_2d, qmgeo_kernel.qmgeo_quantize),
}
# QMGeo may differ from XLA in at most this share of elements (rounded
# up), by one level each. Measured: 1 element of 8,000,000 at the paper's
# c=0.02, m=16, r=0.6 (and 0 of 6,000,000 at three other (c, r)).
QMGEO_BUDGET = 1e-5


def _batch(rows, dim, seed=0, c=C):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.2 * c, 1.2 * c, size=(rows, dim)).astype(np.float32)


def assert_levels(name, got, want, record_property=None):
    """Exact for RQM and PBM; QMGeo within QMGEO_BUDGET, one level each."""
    got, want = np.asarray(got).astype(np.int64), np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if record_property is not None:
        record_property(f"{name}_mismatches", int(np.count_nonzero(diff)))
    if name != "qmgeo":
        np.testing.assert_array_equal(got, want)
        return
    assert diff.max(initial=0) <= 1
    assert np.count_nonzero(diff) <= math.ceil(QMGEO_BUDGET * diff.size)


def _reference_block(name, x, row_offset):
    """The reference's element-wise body on the flattened batch, jitted:
    element (r, c) draws counter (row_offset + r) * dim + c mod 2**32."""
    params_j, _, block, _, _ = MECHS[name]
    rows, dim = x.shape
    base = jnp.uint32((row_offset * dim) & 0xFFFFFFFF)
    f = jax.jit(lambda v, s, o: block(v.reshape(1, -1), s, o, params_j).reshape(rows, dim))
    return np.asarray(f(jnp.asarray(x), jnp.uint32(SEED), base))


# (rows, dim, row_offset): single element; odd widths; the paper's cohort;
# counters that wrap past 2**32 within the batch
SHAPES = [(1, 1, 0), (7, 127, 3), (40, 3001, 5), (4, 1000, 4_294_967)]


@pytest.mark.parametrize("rows,dim,row_offset", SHAPES,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("name", list(MECHS))
def test_quantize_matches_reference_block(name, rows, dim, row_offset, record_property):
    x = _batch(rows, dim, seed=rows * 7 + dim)
    got = MECHS[name][4](torch.from_numpy(x), SEED, MECHS[name][1], row_offset)
    assert got.dtype == torch.int32
    assert_levels(name, got.numpy(), _reference_block(name, x, row_offset), record_property)


@pytest.mark.parametrize("name", list(MECHS))
def test_quantize_matches_pallas_body(name, record_property):
    """The Pallas kernel in interpret mode on a (rows, 128)-tiled array,
    two (8, 128) blocks: its counters are the flat index, the port's at
    row offset 0 with dim 128."""
    params_j, params_t, _, quantize_2d, quantize = MECHS[name]
    x = _batch(16, 128, seed=11)
    want = quantize_2d(jnp.asarray(x), jnp.full((1, 1), SEED, jnp.uint32), params_j,
                       block_rows=8, interpret=True)
    got = quantize(torch.from_numpy(x), SEED, params_t, 0)
    assert_levels(name, got.numpy(), np.asarray(want), record_property)


@pytest.mark.parametrize("name", list(MECHS))
def test_batch_sum_is_the_round_sum(name):
    """Inside the port: the materialized batch, weighted and summed, equals
    the fused round sum (dense and packed) bit for bit, at any offset."""
    params = MECHS[name][1]
    x = torch.from_numpy(_batch(9, 1000, seed=5))
    w = torch.from_numpy((np.arange(9) % 3 != 0).astype(np.int32))
    batch = getattr(ops, f"{name}_batch")
    round_sum = getattr(ops, f"{name}_round_sum")
    z = batch(x, SEED, params, row_offset=2)
    dense = round_sum(x, SEED, params, weights=w, row_offset=2)
    assert torch.equal((z * w[:, None]).sum(0, dtype=torch.int32), dense)
    packed = round_sum(x, SEED, params, weights=w, row_offset=2, pack_bits=8)
    assert torch.equal(packed, fused_round_kernel.round_sum_packed_plain(
        x, w, SEED, 2, params, 8, name))
    assert torch.equal(z[3:], batch(x[3:], SEED, params, row_offset=5))
    # one client's vector, any shape: the batch's first row
    mech = make_mechanism({"name": name, **dataclasses.asdict(params)})
    assert torch.equal(mech.quantize(x[0].reshape(10, 100), SEED).reshape(-1),
                       batch(x[:1], SEED, params)[0])


@pytest.mark.parametrize("rows,dim", [(1, 1), (7, 127), (40, 3001)], ids=str)
@pytest.mark.parametrize("name", ["pbm", "qmgeo"])
def test_round_sums_match_reference(name, rows, dim, record_property):
    """The pbm and qmgeo encoders of the dense and packed round sums
    against the reference's CPU twins at row offset 3."""
    params_j, params_t = MECHS[name][:2]
    x = _batch(rows, dim, seed=rows + dim)
    w = (np.random.default_rng(dim).uniform(size=rows) > 0.3).astype(np.int32)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.uint32(SEED), jnp.uint32(3), name, params_j,
            jfused.DEFAULT_BLOCK_ROWS)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    dense = fused_round_kernel.round_sum(xt, wt, SEED, 3, params_t, name)
    assert_levels(name, dense.numpy(), np.asarray(jfused.round_sum_jnp(*args)), record_property)
    bits = 10
    packed = fused_round_kernel.round_sum_packed(xt, wt, SEED, 3, params_t, bits, name)
    want = np.asarray(jfused.round_sum_packed_jnp(*args, bits))
    if name == "pbm":
        np.testing.assert_array_equal(packed.numpy(), want)
    else:  # a one-level difference moves a word by 1 << (field * bits)
        assert np.count_nonzero(packed.numpy() != want) <= math.ceil(
            QMGEO_BUDGET * rows * dim)


def test_round_sum_rejects_an_unknown_encoder():
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="unknown encoder"):
        fused_round_kernel.round_sum(x, torch.ones(2, dtype=torch.int32), 0, 0,
                                     MECHS["rqm"][1], "gauss")
    with pytest.raises(ValueError, match="uint32"):
        ops.pbm_batch(x, -1, MECHS["pbm"][1])
    with pytest.raises(ValueError, match="rows, dim"):
        ops.qmgeo_batch(torch.zeros(3), 0, MECHS["qmgeo"][1])
    with pytest.raises(ValueError, match="rows, dim"):
        ops.rqm_round_sum(torch.zeros(3), 0, MECHS["rqm"][1])


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoded_goldens():
    with open(os.path.join(GOLDEN, "encoded_sums.json")) as f:
        return json.load(f)


def _golden_case(goldens, name, variant):
    block = goldens["mechanisms"][name]
    mech = make_mechanism({"name": name, **block["params"]})
    x, weights = golden_sum_inputs(mech.clip)
    w = weights if variant == "sum_weighted" else np.ones_like(weights)
    off = goldens["row_offset"] if variant == "sum_offset" else 0
    return mech, torch.from_numpy(x), torch.from_numpy(w), off, np.asarray(block[variant])


VARIANTS = ["sum", "sum_weighted", "sum_offset"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(MECHS))
def test_golden_sums_through_quantize_batch(encoded_goldens, name, variant, record_property):
    """The materialized path: ``quantize_batch`` then weight and sum."""
    mech, x, w, off, want = _golden_case(encoded_goldens, name, variant)
    z = mech.quantize_batch(x, encoded_goldens["kernel_seed_u32"], row_offset=off)
    assert_levels(name, (z * w[:, None]).sum(0, dtype=torch.int32).numpy(), want,
                  record_property)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", ["pbm", "qmgeo"])
def test_golden_sums_through_round_sums(encoded_goldens, name, variant, record_property):
    """The fused path: ``quantize_sum_batch`` (the RQM case is
    tests/test_torch_kernels.py::test_golden_rqm_sums)."""
    mech, x, w, off, want = _golden_case(encoded_goldens, name, variant)
    got = mech.quantize_sum_batch(x, encoded_goldens["kernel_seed_u32"], weights=w,
                                  row_offset=off)
    assert_levels(name, got.numpy(), want, record_property)


@pytest.mark.parametrize("name", ["pbm", "qmgeo"])
def test_golden_packed_round_sums(encoded_goldens, name):
    """tests/golden/packed_words.json's pbm and qmgeo round sums (the plain
    packed round sum takes every encoder)."""
    with open(os.path.join(GOLDEN, "packed_words.json")) as f:
        block = json.load(f)["round_sums"][name]
    mech, x, w, _, _ = _golden_case(encoded_goldens, name, "sum")
    got = mech.quantize_sum_batch(x, encoded_goldens["kernel_seed_u32"],
                                  pack_bits=block["bits"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(block["words"], np.int32))
