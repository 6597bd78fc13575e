"""The port's QMGeo encode in the form ``csrc/qmgeo_encode.cuh`` computes it
(``repro_torch/kernels/qmgeo_kernel.py``: ``level_tables``,
``level_search``, ``qmgeo_encode_tabled``) on the CPU.

The kernel builds, once a block, the weights ``W[d] = exp(d log r)``, the
normalisers ``Z[j]`` and, up to m = 64, the running sums ``C[j][k]`` as a
binary-search tree; an element searches its row for ``u_noise * Z[j]``
(beyond m = 64 it walks the running sum over ``W``). Two contracts, on
inputs made with numpy:

  * the search equals the running walk of ``quantize_with_uniforms``
    exactly, given the same weights, for every bin j, at m in {2, 3, 16,
    17, 64, 100} (100 takes the walk) and r in {0.1, 0.6, 0.95}, with
    targets equal to each C entry and one ulp either side, 0, and past
    C[j][m-1];
  * the tabled encode equals the JAX reference's
    ``core.qmgeo.quantize_with_uniforms`` within tests/test_torch_quantize.py's
    QMGEO_BUDGET: XLA:CPU's ``exp`` and PyTorch's are different
    implementations, so ``cum <= t`` can fall the other way where the two
    are within an ulp. Each mismatch is one level; their count goes into
    the JUnit report.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_quantize import QMGEO_BUDGET

from repro.core import qmgeo as jqmgeo
from repro.core.qmgeo import QMGeoParams as JaxQMGeoParams
from repro.kernels import prng as jprng
from repro_torch.core.qmgeo import QMGeoParams
from repro_torch.kernels import qmgeo_kernel

C = DELTA = 0.02
SEED = 2216260512
F32 = np.float32


def _running_sums(weight: np.ndarray, m: int) -> np.ndarray:
    """(m, m) float32 C[j][k]: weight[|i - j|] added for i = 0..k in order,
    the walk's running sum."""
    j = np.arange(m)
    cum = np.zeros(m, F32)
    out = np.empty((m, m), F32)
    for k in range(m):
        cum = (cum + weight[np.abs(k - j)]).astype(F32)
        out[:, k] = cum
    return out


@pytest.mark.parametrize("r", [0.1, 0.6, 0.95])
@pytest.mark.parametrize("m", [2, 3, 16, 17, 64, 100])
def test_level_search_matches_running_walk(m, r):
    params = QMGeoParams(C, DELTA, m, r)
    tables = qmgeo_kernel.level_tables(params)
    weight, norm = tables[0].numpy(), tables[1].numpy()
    assert (tables[2] is None) == (m > qmgeo_kernel.TREE_MAX_M)
    sums = _running_sums(weight, m)
    assert (np.diff(sums, axis=1) >= 0).all()  # nondecreasing: the count is a search
    rng = np.random.default_rng(m * 10 + int(r * 100))
    js, targets = [], []
    for j in range(m):
        row = sums[j]
        t = np.concatenate([
            row, np.nextafter(row, F32(np.inf)), np.nextafter(row, F32(0)),
            [0.0, row[-1] * F32(1.5), np.inf, norm[j]],
            F32(rng.uniform(size=50)) * norm[j],
        ]).astype(F32)
        js.append(np.full(t.size, j))
        targets.append(t)
    j, t = np.concatenate(js), np.concatenate(targets)
    want = np.minimum((sums[j] <= t[:, None]).sum(1), m - 1)
    got = qmgeo_kernel.level_search(tables, torch.from_numpy(j), torch.from_numpy(t), m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # every level is reached, the top one by the clamp
    assert set(np.unique(want)) == set(range(m))


def _edge_inputs(params: QMGeoParams, rng) -> np.ndarray:
    """x at and beyond +-c, on every bin edge and one ulp either side, and
    random across +-1.2c."""
    c = F32(params.c)
    edges = F32(-params.x_max) + np.arange(params.m - 1, dtype=F32) * F32(params.step)
    return np.concatenate([
        np.array([c, -c, 1.5 * c, -1.5 * c, 1e9, -1e9, 0.0, np.inf, -np.inf], F32),
        edges, np.nextafter(edges, F32(np.inf)), np.nextafter(edges, F32(-np.inf)),
        rng.uniform(-1.2 * c, 1.2 * c, 20_000).astype(F32),
    ]).astype(F32)


@pytest.mark.parametrize("r", [0.1, 0.6, 0.95])
@pytest.mark.parametrize("m", [2, 16, 33, 100])
def test_tabled_encode_matches_reference(m, r, record_property):
    params_t, params_j = QMGeoParams(C, DELTA, m, r), JaxQMGeoParams(C, DELTA, m, r)
    rng = np.random.default_rng(m * 1000 + int(r * 100))
    x = _edge_inputs(params_t, rng)
    counter = rng.integers(0, 1 << 32, x.size, dtype=np.uint64).astype(np.uint32)
    counter[:100] = (1 << 32) - 1 - np.arange(100, dtype=np.uint32)
    ctr = jnp.asarray(counter)
    want = np.asarray(jqmgeo.quantize_with_uniforms(
        jnp.asarray(x), jprng.random_uniform(jnp.uint32(SEED), ctr, 0),
        jprng.random_uniform(jnp.uint32(SEED), ctr, 1), params_j)).astype(np.int64)
    got = qmgeo_kernel.qmgeo_encode_tabled(
        torch.from_numpy(x), SEED, torch.from_numpy(counter.astype(np.int64)), params_t)
    assert got.dtype == torch.int32
    diff = np.abs(got.numpy().astype(np.int64) - want)
    record_property(f"qmgeo_m{m}_r{r}_mismatches", int(np.count_nonzero(diff)))
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= math.ceil(QMGEO_BUDGET * diff.size)
    assert len(np.unique(want)) > m // 4  # the levels spread over the grid
