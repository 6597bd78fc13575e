"""The single-leaf encodes of the port (``core/rqm.py``, ``core/pbm.py``
``quantize_with_uniforms``; the ``kernels/ref.py`` oracles; ``ops``'s
``rqm``/``pbm``/``qmgeo`` and ``*_fast``, and ``rqm_tree``) against the
JAX reference on the CPU:

  * ``quantize_with_uniforms`` (RQM, PBM) on injected uniforms, exactly,
    the reference run op by op (a jitted twin may contract into FMAs,
    ROADMAP C6);
  * the oracles at the goldens' pinned ``kernel_seed_u32`` (never
    ``key_seed``, ROADMAP C3), RQM and PBM exactly, QMGeo within
    ``QMGEO_BUDGET`` (XLA's and PyTorch's ``exp`` differ, ROADMAP C4);
  * each single-leaf entry on a 1-D and a 3-D leaf against the
    reference's given the seed its key derives (``ops.key_to_seed``),
    against the port's oracle, and against ``<name>_batch`` row 0;
  * ``rqm_tree`` against the reference's with its per-leaf seeds;
  * ``tests/golden/packed_words.json``'s pbm and qmgeo round sums: the
    dense golden sums packed.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as jgrid
from repro.core import pbm as jpbm
from repro.core import qmgeo as jqmgeo
from repro.core import rqm as jrqm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import pbm, rqm, wire
from repro_torch.core.grid import RQMParams
from repro_torch.core.pbm import PBMParams
from repro_torch.core.qmgeo import QMGeoParams
from repro_torch.kernels import ops, ref

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
QMGEO_BUDGET = 1e-5  # mismatched levels a coordinate, one level each
PARAMS = {  # the paper's defaults, port and reference
    "rqm": (RQMParams(0.02, 0.02, 16, 0.42), jgrid.RQMParams(0.02, 0.02, 16, 0.42)),
    "pbm": (PBMParams(0.02, 16, 0.25), jpbm.PBMParams(0.02, 16, 0.25)),
    "qmgeo": (QMGeoParams(0.02, 0.02, 16, 0.6), jqmgeo.QMGeoParams(0.02, 0.02, 16, 0.6)),
}
SHAPES = [(3001,), (4, 5, 7)]


def _x(shape, seed=0, c=0.02):
    return np.random.default_rng(seed).uniform(-1.3 * c, 1.3 * c, size=shape).astype(np.float32)


def _levels(name, got, want):
    """Exact for RQM and PBM; QMGeo within QMGEO_BUDGET, one level each."""
    got, want = np.asarray(got).astype(np.int64), np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if name != "qmgeo":
        np.testing.assert_array_equal(got, want)
        return
    assert diff.max(initial=0) <= 1
    assert np.count_nonzero(diff) <= math.ceil(QMGEO_BUDGET * diff.size)


@pytest.fixture(scope="module")
def kernel_seed():
    with open(os.path.join(GOLDEN, "encoded_sums.json")) as f:
        return json.load(f)["kernel_seed_u32"]


@pytest.mark.parametrize("m,q", [(16, 0.42), (5, 0.1), (64, 0.5), (2, 0.9)])
def test_rqm_quantize_with_uniforms_matches_reference(m, q):
    p, jp = RQMParams(0.02, 0.013, m, q), jgrid.RQMParams(0.02, 0.013, m, q)
    rng = np.random.default_rng(m)
    x = _x((7, 33), seed=m)
    x[0, :3] = [0.02, -0.02, 0.0]  # the clip's edges
    u_levels = rng.uniform(size=(7, 33, m)).astype(np.float32)
    u_round = rng.uniform(size=(7, 33)).astype(np.float32)
    u_round[1, :4] = [0.0, 0.5, 0.999, 0.25]
    got = rqm.quantize_with_uniforms(torch.from_numpy(x), torch.from_numpy(u_levels),
                                     torch.from_numpy(u_round), p)
    want = jrqm.quantize_with_uniforms(jnp.asarray(x), jnp.asarray(u_levels),
                                       jnp.asarray(u_round), jp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="u_levels shape"):
        rqm.quantize_with_uniforms(torch.from_numpy(x), torch.from_numpy(u_levels[..., :-1]),
                                   torch.from_numpy(u_round), p)


@pytest.mark.parametrize("m,theta", [(16, 0.25), (1, 0.5), (7, 0.05)])
def test_pbm_quantize_with_uniforms_matches_reference(m, theta):
    p, jp = PBMParams(0.02, m, theta), jpbm.PBMParams(0.02, m, theta)
    rng = np.random.default_rng(m)
    x = _x((5, 41), seed=m)
    u = rng.uniform(size=(m, 5, 41)).astype(np.float32)
    got = pbm.quantize_with_uniforms(torch.from_numpy(x), torch.from_numpy(u), p)
    want = jpbm.quantize_with_uniforms(jnp.asarray(x), jnp.asarray(u), jp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rqm_uniforms_match_reference(kernel_seed):
    p, jp = PARAMS["rqm"]
    u_levels, u_round = ref.rqm_uniforms(513, kernel_seed, p, device="cpu")
    ju_levels, ju_round = jref.rqm_uniforms(513, jnp.uint32(kernel_seed), jp)
    np.testing.assert_array_equal(u_levels.numpy(), np.asarray(ju_levels))
    np.testing.assert_array_equal(u_round.numpy(), np.asarray(ju_round))


@pytest.mark.parametrize("name", list(PARAMS))
def test_oracles_match_reference_at_the_pinned_seed(name, kernel_seed):
    p, jp = PARAMS[name]
    x = _x((20_000,), seed=3)
    got = getattr(ref, f"{name}_ref")(torch.from_numpy(x), kernel_seed, p)
    want = getattr(jref, f"{name}_ref")(jnp.asarray(x), jnp.uint32(kernel_seed), jp)
    assert got.dtype == torch.int32
    _levels(name, got.numpy(), want)
    with pytest.raises(ValueError, match="flat input"):
        getattr(ref, f"{name}_ref")(torch.from_numpy(x.reshape(100, 200)), kernel_seed, p)


@pytest.mark.parametrize("shape", SHAPES, ids=["1d", "3d"])
@pytest.mark.parametrize("name", list(PARAMS))
def test_fast_matches_reference_oracle_and_batch_row(name, shape):
    p, jp = PARAMS[name]
    key = jax.random.key(11)
    seed = int(np.asarray(jops.key_to_seed(key)))
    x = _x(shape, seed=4)
    got = getattr(ops, f"{name}_fast")(torch.from_numpy(x), seed, p)
    assert got.shape == shape and got.dtype == torch.int32
    _levels(name, got.numpy(), getattr(jops, f"{name}_fast")(jnp.asarray(x), key, jp))
    # the port's own: the oracle on the flat leaf, and row 0 of a batch
    flat = torch.from_numpy(x.reshape(-1))
    _levels(name, got.reshape(-1).numpy(), getattr(ref, f"{name}_ref")(flat, seed, p).numpy())
    row = getattr(ops, f"{name}_batch")(flat[None], seed, p)[0]
    assert torch.equal(got.reshape(-1), row)
    # the reference's Pallas-entry name is the same encode
    assert getattr(ops, name) is getattr(ops, f"{name}_fast")


def test_rqm_matches_reference_pallas_entry():
    p, jp = PARAMS["rqm"]
    key = jax.random.key(12)
    x = _x((3, 50), seed=5)
    want = jops.rqm(jnp.asarray(x), key, jp, interpret=True)
    got = ops.rqm(torch.from_numpy(x), int(np.asarray(jops.key_to_seed(key))), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rqm_tree_matches_reference_with_per_leaf_seeds():
    p, jp = PARAMS["rqm"]
    rng = np.random.default_rng(6)
    tree = {"w": rng.uniform(-0.03, 0.03, (6, 9)).astype(np.float32),
            "b": {"z": rng.uniform(-0.03, 0.03, (5,)).astype(np.float32),
                  "a": rng.uniform(-0.03, 0.03, (2, 3, 4)).astype(np.float32)},
            "c": (rng.uniform(-0.03, 0.03, (7,)).astype(np.float32),)}
    key = jax.random.key(13)
    want = jops.rqm_tree(jax.tree_util.tree_map(jnp.asarray, tree), key, jp)
    seeds = [int(np.asarray(jops.key_to_seed(k)))
             for k in jax.random.split(key, len(jax.tree_util.tree_leaves(tree)))]
    got = ops.rqm_tree(jax.tree_util.tree_map(torch.from_numpy, tree), seeds, p)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert isinstance(got["c"], tuple) and got["b"]["a"].shape == (2, 3, 4)
    with pytest.raises(ValueError, match="one seed a leaf"):
        ops.rqm_tree(jax.tree_util.tree_map(torch.from_numpy, tree), seeds[:-1], p)


@pytest.mark.parametrize("name", ["pbm", "qmgeo"])
def test_golden_packed_words_round_sums(name):
    """packed_words.json's round sums are the dense golden sums
    (encoded_sums.json) packed at their width."""
    with open(os.path.join(GOLDEN, "encoded_sums.json")) as f:
        dense = np.asarray(json.load(f)["mechanisms"][name]["sum"], np.int32)
    with open(os.path.join(GOLDEN, "packed_words.json")) as f:
        block = json.load(f)["round_sums"][name]
    words = np.asarray(block["words"], np.int32)
    np.testing.assert_array_equal(
        wire.pack_bits(torch.from_numpy(dense), block["bits"]).numpy(), words)
    np.testing.assert_array_equal(
        wire.unpack_bits(torch.from_numpy(words), block["bits"], dense.size).numpy(), dense)
