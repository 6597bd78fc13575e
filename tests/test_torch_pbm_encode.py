"""The port's PBM encode in the form ``csrc/pbm_encode.cuh`` computes it
(``repro_torch/kernels/pbm_kernel.py``: ``prob_threshold``,
``pbm_encode_threshold``) against the JAX reference's float compare on the
CPU, exactly.

The kernel tests each draw in integers: ``bits <= (K << 8) - 1`` with
K = ceil(p * 2**24) saturated to [0, 2**24] (0 for a NaN p), and a count
of 0 where K is 0; the reference compares each draw's float32 uniform with
p. Two contracts, on inputs made with numpy:

  * the threshold, over all 2**24 values of the uniform's integer k, for p
    at and around 1/4, 1/2 and 3/4, at 2**-24, at 0 and -0, at 1 and just
    below it, and NaN (theta = 1/2 reaches p = 0 and 1 from x = -c, +c);
  * the encode at m in {1, 7, 16, 17} (16 is the kernel's unrolled
    instance) and theta in {1/4, 1/2}, with x at and beyond +-c, infinite
    and NaN, and counters near 2**32, where they wrap.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pbm import PBMParams as JaxPBMParams
from repro.kernels import pbm_kernel as jpbm
from repro.kernels import prng as jprng
from repro_torch.core.pbm import PBMParams
from repro_torch.kernels import pbm_kernel
from repro_torch.kernels.prng import MASK32

SEEDS = (2216260512, 0xFFFFFFFF)
C = 0.02
F32 = np.float32
THRESHOLD_PROBS = {
    "0.25": 0.25,
    "0.25_below": float(np.nextafter(F32(0.25), F32(0))),
    "0.25_above": float(np.nextafter(F32(0.25), F32(1))),
    "0.5": 0.5,
    "0.5_below": float(np.nextafter(F32(0.5), F32(0))),
    "0.5_above": float(np.nextafter(F32(0.5), F32(1))),
    "0.75": 0.75,
    "0.75_below": float(np.nextafter(F32(0.75), F32(0))),
    "0.75_above": float(np.nextafter(F32(0.75), F32(1))),
    "2^-24": 2.0 ** -24,
    "0": 0.0,
    "-0": -0.0,
    "1": 1.0,
    "below_1": float(np.nextafter(F32(1), F32(0))),
    "nan": float("nan"),
}


@pytest.mark.parametrize("prob", list(THRESHOLD_PROBS.values()), ids=list(THRESHOLD_PROBS))
def test_prob_threshold_exhaustive(prob):
    """For every k in [0, 2**24): k < K(p) iff float32(k) * 2**-24 < p, and
    the kernel's test on the 32 bits (k << 8 | low, for the lowest and
    highest low byte) agrees with the reference's ``uniform01(bits) < p``."""
    p = F32(prob)
    k = np.arange(1 << 24, dtype=np.uint32)
    want = F32(k) * F32(2.0 ** -24) < p
    big_k = int(pbm_kernel.prob_threshold(torch.tensor(p)))
    assert 0 <= big_k <= 1 << 24
    np.testing.assert_array_equal(k < big_k, want)
    threshold = np.uint32(((big_k << 8) - 1) & MASK32)
    for low in (0, 255):
        bits = (k << np.uint32(8)) | np.uint32(low)
        ref = np.asarray(jprng.uniform01(jnp.asarray(bits)) < jnp.float32(p))
        np.testing.assert_array_equal(ref, want)
        np.testing.assert_array_equal((bits <= threshold) & (big_k != 0), want)


def _edge_inputs(rng) -> np.ndarray:
    """x at and beyond +-c, infinite, NaN, zero, and random across +-1.2c."""
    c = F32(C)
    return np.concatenate([
        np.array([c, -c, np.nextafter(c, F32(0)), np.nextafter(-c, F32(0)), 1.5 * c,
                  -1.5 * c, 1e9, -1e9, np.inf, -np.inf, np.nan, 0.0, -0.0], np.float32),
        np.full(50, np.nan, np.float32),
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


@pytest.mark.parametrize("theta", [0.25, 0.5])
@pytest.mark.parametrize("m", [1, 7, 16, 17])
def test_threshold_encode_matches_reference(m, theta):
    params_t, params_j = PBMParams(C, m, theta), JaxPBMParams(C, m, theta)
    rng = np.random.default_rng(m * 100 + int(theta * 100))
    x = _edge_inputs(rng)
    counter = _counters(x.size, rng)
    ctr = torch.from_numpy(counter.astype(np.int64))
    for seed in SEEDS:
        want = np.asarray(jpbm.pbm_encode_counters(
            jnp.asarray(x), jnp.uint32(seed), jnp.asarray(counter), params_j))
        got = pbm_kernel.pbm_encode_threshold(torch.from_numpy(x), seed, ctr, params_t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        plain = pbm_kernel.pbm_encode_counters(torch.from_numpy(x), seed, ctr, params_t)
        np.testing.assert_array_equal(plain.numpy(), want)
    # the edges were reached: NaN counts 0; at theta = 1/2, p = 0 and 1
    assert (want[np.isnan(x)] == 0).all()
    if theta == 0.5:
        assert (want[x >= C] == m).all() and (want[x <= -C] == 0).all()
