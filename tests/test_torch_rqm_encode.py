"""The port's RQM encode (``repro_torch/kernels/rqm_kernel.py``, the plain
version of ``csrc/rqm_encode.cuh``) against the JAX reference's
``rqm_encode_counters`` on the CPU, exactly.

The port tests a level's keep draw in integers (``bits <= keep_le``, from
K = ceil(float32(q) * 2**24)) and finds the bracket around the bin with bit
scans of a keep mask, 32 levels a word; the reference compares float32
uniforms with q and keeps a running max and min over the levels. Three
contracts, each on inputs made with numpy:

  * the threshold, over all 2**24 values of the uniform's integer k, for
    q at and around the paper's 0.42, at exact multiples of 2**-24, at
    the ends of float32's (0, 1), and where float32(q) rounds to 0 or 1;
  * the encode at edge parameters (m from 2, no interior level, to 64,
    two mask words) and edge inputs (x at, beyond and on the bin edges
    inside +-c; counters near 2**32, where they wrap);
  * the mask bracket against the reference's running form over random
    keep patterns, up to m = 100 (four mask words).
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.grid import RQMParams as JaxRQMParams
from repro.kernels import prng as jprng
from repro.kernels import rqm_kernel as jrqm
from repro_torch.core.grid import RQMParams
from repro_torch.kernels import rqm_kernel

SEEDS = (2216260512, 0xFFFFFFFF)
C = DELTA = 0.02
Q42 = np.float32(0.42)
THRESHOLD_QS = {
    "0.42": 0.42,
    "0.42_below": float(np.nextafter(Q42, np.float32(0))),
    "0.42_above": float(np.nextafter(Q42, np.float32(1))),
    "0.5": 0.5,
    "0.25": 0.25,
    "2^-24": 2.0 ** -24,
    "below_1": float(np.nextafter(np.float32(1), np.float32(0))),
    "f32_rounds_to_1": 1.0 - 1e-9,
    "f32_rounds_to_0": 1e-50,
}


@pytest.mark.parametrize("q", list(THRESHOLD_QS.values()), ids=list(THRESHOLD_QS))
def test_keep_threshold_exhaustive(q):
    """For every k in [0, 2**24): k < K(q) iff float32(k) * 2**-24 <
    float32(q), and the kernel's test on the 32 bits (k << 8 | low, for
    the lowest and highest low byte) agrees with the reference's
    ``uniform01(bits) < q``."""
    k = np.arange(1 << 24, dtype=np.uint32)
    want = np.float32(k) * np.float32(2.0 ** -24) < np.float32(q)
    np.testing.assert_array_equal(k < rqm_kernel.keep_threshold(q), want)
    keep_le, keep_any = rqm_kernel.keep_constants(q)
    for low in (0, 255):
        bits = (k << np.uint32(8)) | np.uint32(low)
        ref = np.asarray(jprng.uniform01(jnp.asarray(bits)) < jnp.float32(q))
        np.testing.assert_array_equal(ref, want)
        np.testing.assert_array_equal((bits <= np.uint32(keep_le)) & bool(keep_any), want)


def _edge_inputs(params: RQMParams, rng) -> np.ndarray:
    """x at and beyond +-c, on every bin edge -x_max + j * step (float32,
    as the encode computes it) and one ulp either side, and random."""
    f32 = np.float32
    c = f32(params.c)
    edges = f32(-params.x_max) + np.arange(params.m - 1, dtype=np.float32) * f32(params.step)
    return np.concatenate([
        np.array([c, -c, 1.5 * c, -1.5 * c, 1e9, -1e9, 0.0, np.inf, -np.inf], np.float32),
        edges, np.nextafter(edges, f32(np.inf)), np.nextafter(edges, f32(-np.inf)),
        rng.uniform(-1.2 * c, 1.2 * c, 4000).astype(np.float32),
    ]).astype(np.float32)


def _counters(n: int, rng) -> np.ndarray:
    """Counters from 0 up, then up to 2**32 - 1, then random."""
    third = n // 3
    return np.concatenate([
        np.arange(third, dtype=np.uint64),
        (1 << 32) - 1 - np.arange(third, dtype=np.uint64),
        rng.integers(0, 1 << 32, n - 2 * third, dtype=np.uint64),
    ]).astype(np.uint32)


@pytest.mark.parametrize("q", [0.3, 0.42, 0.5])
@pytest.mark.parametrize("m", [2, 3, 8, 16, 33, 34, 64])
def test_encode_matches_reference_at_edges(m, q):
    params_t, params_j = RQMParams(C, DELTA, m, q), JaxRQMParams(C, DELTA, m, q)
    rng = np.random.default_rng(m * 1000 + int(q * 100))
    x = _edge_inputs(params_t, rng)
    counter = _counters(x.size, rng)
    for seed in SEEDS:
        want = np.asarray(jrqm.rqm_encode_counters(
            jnp.asarray(x), jnp.uint32(seed), jnp.asarray(counter), params_j))
        got = rqm_kernel.rqm_encode_counters(torch.from_numpy(x), seed,
                                             torch.from_numpy(counter.astype(np.int64)),
                                             params_t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _running_bracket(x, seed, counter, params_j: JaxRQMParams):
    """The reference's bin and running nearest-kept-level search
    (``repro/kernels/rqm_kernel.py:81-90``), in jnp."""
    m = params_j.m
    xc = jnp.clip(jnp.asarray(x), -params_j.c, params_j.c)
    j = jnp.clip(jnp.floor((xc + jnp.float32(params_j.x_max)) / jnp.float32(params_j.step)),
                 0, m - 2).astype(jnp.int32)
    i_lo, i_hi = jnp.zeros_like(j), jnp.full_like(j, m - 1)
    ctr = jnp.asarray(counter)
    for lvl in range(1, m - 1):
        keep = jprng.random_uniform(jnp.uint32(seed), ctr, lvl) < jnp.float32(params_j.q)
        below = jnp.int32(lvl) <= j
        i_lo = jnp.where(keep & below, jnp.int32(lvl), i_lo)
        i_hi = jnp.minimum(i_hi, jnp.where(keep & ~below, jnp.int32(lvl), m - 1))
    return np.asarray(j), np.asarray(i_lo), np.asarray(i_hi)


@pytest.mark.parametrize("q", [0.05, 0.42, 0.95])
@pytest.mark.parametrize("m", [3, 16, 33, 34, 64, 100])
def test_mask_bracket_matches_running_form(m, q):
    """Sparse, paper-like and dense keep patterns: the port's (j, i_lo,
    i_hi) equal the reference's running form for every element."""
    params_t, params_j = RQMParams(C, DELTA, m, q), JaxRQMParams(C, DELTA, m, q)
    rng = np.random.default_rng(m * 7 + int(q * 100))
    x = rng.uniform(-C, C, 6000).astype(np.float32)
    counter = rng.integers(0, 1 << 32, x.size, dtype=np.uint64).astype(np.uint32)
    seed = SEEDS[0]
    want = _running_bracket(x, seed, counter, params_j)
    j, i_lo, i_hi, _ = rqm_kernel.rqm_bracket(
        torch.from_numpy(x), seed, torch.from_numpy(counter.astype(np.int64)), params_t)
    for got, ref in zip((j, i_lo, i_hi), want):
        np.testing.assert_array_equal(got.numpy(), ref)
    # the patterns vary: brackets of more than one width
    assert len(np.unique(want[2] - want[1])) > 1
