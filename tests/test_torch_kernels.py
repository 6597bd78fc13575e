"""The port's kernel layer (src/repro_torch/kernels) against the JAX reference.

On the CPU every kernel wrapper runs its plain PyTorch version; the same
inputs, made with numpy, go through the reference's CPU twins
(``round_sum_jnp``, ``round_sum_packed_jnp``, the jnp ``decode_apply_sum``)
and, at tile-aligned sizes, the Pallas bodies in interpret mode.

Contracts:
  * splitmix32 bits and uniforms: equal;
  * round sums (dense and packed), the pinned golden sums at the pinned
    ``kernel_seed_u32``: equal, bit for bit;
  * decode + apply: equal to the jnp path (measured: 0 ULP), and within
    the reference's own 1-ULP bound of its Pallas body (lr * ulp(2 x_max)
    + ulp(output), tests/test_fused_round_kernel.py).

The CUDA kernels run only on a GPU: tests/test_torch_cuda.py checks them
against the plain versions there, and chip_smoke.py at the main path's
full shapes.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as jwire
from repro.core.grid import RQMParams as JaxRQMParams
from repro.kernels import decode_apply_kernel as jdecode
from repro.kernels import fused_round_kernel as jfused
from repro.kernels import pack_kernel as jpack
from repro.kernels import prng as jprng
from repro_torch.core import wire
from repro_torch.core.grid import RQMParams
from repro_torch.kernels import decode_apply_kernel, fused_round_kernel, ops, pack_kernel, prng

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "scripts"))
from make_goldens import golden_sum_inputs  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
PAPER = dict(c=0.02, delta=0.02, m=16, q=0.42)
P_T, P_J = RQMParams(**PAPER), JaxRQMParams(**PAPER)
SEED = 2216260512
ROW_OFFSET = 3


def _cohort(rows, dim, seed=0):
    rng = np.random.default_rng(seed)
    c = PAPER["c"]
    x = rng.uniform(-1.2 * c, 1.2 * c, size=(rows, dim)).astype(np.float32)
    w = (rng.uniform(size=rows) > 0.3).astype(np.int32)
    return x, w


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in units in the last place between float32 arrays."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


# ---------------------------------------------------------------------------
# splitmix32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stream", [0, 1, 14, 16], ids=lambda s: f"stream{s}")
def test_prng_matches_reference(stream):
    """>= 100k counters per seed, streams 1, m-2 and m of the paper's m=16
    (and 0), including counters near 2**32."""
    rng = np.random.default_rng(stream)
    counters = np.concatenate([
        np.arange(100_000, dtype=np.uint32),
        rng.integers(0, 1 << 32, 20_000, dtype=np.uint64).astype(np.uint32),
        np.arange(0xFFFFFF00, 0xFFFFFFFF, dtype=np.uint32),
    ])
    t_ctr = torch.from_numpy(counters.astype(np.int64))
    for seed in (0, SEED, 0xFFFFFFFF):
        want = np.asarray(jprng.random_bits(jnp.uint32(seed), jnp.asarray(counters), stream))
        got = prng.random_bits(seed, t_ctr, stream).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
        want_u = np.asarray(jprng.random_uniform(jnp.uint32(seed), jnp.asarray(counters), stream))
        np.testing.assert_array_equal(prng.random_uniform(seed, t_ctr, stream).numpy(), want_u)


# ---------------------------------------------------------------------------
# fused round sums
# ---------------------------------------------------------------------------

ROWS = [1, 7, 40]
DIMS = [1, 127, 1000, 3001]


@pytest.mark.parametrize("dim", DIMS, ids=lambda d: f"dim{d}")
@pytest.mark.parametrize("rows", ROWS, ids=lambda r: f"rows{r}")
def test_round_sum_dense_matches_reference(rows, dim):
    x, w = _cohort(rows, dim, seed=rows * 10_000 + dim)
    want = np.asarray(jfused.round_sum_jnp(
        jnp.asarray(x), jnp.asarray(w), jnp.uint32(SEED), jnp.uint32(ROW_OFFSET),
        "rqm", P_J, jfused.DEFAULT_BLOCK_ROWS))
    got = fused_round_kernel.round_sum(torch.from_numpy(x), torch.from_numpy(w),
                                       SEED, ROW_OFFSET, P_T)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [4, 10, 16], ids=lambda b: f"bits{b}")
@pytest.mark.parametrize("dim", DIMS, ids=lambda d: f"dim{d}")
@pytest.mark.parametrize("rows", ROWS, ids=lambda r: f"rows{r}")
def test_round_sum_packed_matches_reference(rows, dim, bits):
    """Equal words to ``round_sum_packed_jnp`` at every width (packing is
    arithmetic mod 2**32 on both sides, so even an overflowing field
    agrees); where the bound fits the field, also ``pack_bits`` of the
    dense sum, and the unpack gives the dense sum back."""
    x, w = _cohort(rows, dim, seed=rows * 10_000 + dim)
    want = np.asarray(jfused.round_sum_packed_jnp(
        jnp.asarray(x), jnp.asarray(w), jnp.uint32(SEED), jnp.uint32(ROW_OFFSET),
        "rqm", P_J, jfused.DEFAULT_BLOCK_ROWS, bits))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = fused_round_kernel.round_sum_packed(xt, wt, SEED, ROW_OFFSET, P_T, bits)
    assert got.shape == (wire.packed_words(dim, bits),)
    np.testing.assert_array_equal(got.numpy(), want)
    if wire.packable(rows * (P_T.m - 1), bits):
        dense = fused_round_kernel.round_sum(xt, wt, SEED, ROW_OFFSET, P_T)
        np.testing.assert_array_equal(got.numpy(), jwire.pack_bits_np(dense.numpy(), bits))
        np.testing.assert_array_equal(wire.unpack_bits(got, bits, dim), dense)


@pytest.fixture(scope="module")
def encoded_goldens():
    with open(os.path.join(GOLDEN, "encoded_sums.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("variant", ["sum", "sum_weighted", "sum_offset"])
def test_golden_rqm_sums(encoded_goldens, variant):
    """The pinned RQM releases of tests/golden/encoded_sums.json, keyed
    on its ``kernel_seed_u32`` (the reference derives that seed from a JAX
    key, which this package does not reimplement)."""
    g = encoded_goldens
    block = g["mechanisms"]["rqm"]
    params = RQMParams(**block["params"])
    x, weights = golden_sum_inputs(params.c)
    w = weights if variant == "sum_weighted" else np.ones_like(weights)
    off = g["row_offset"] if variant == "sum_offset" else 0
    got = ops.rqm_round_sum(torch.from_numpy(x), g["kernel_seed_u32"], params,
                            weights=torch.from_numpy(w), row_offset=off)
    np.testing.assert_array_equal(got.numpy(), np.asarray(block[variant]))


def test_golden_packed_rqm_round_sum(encoded_goldens):
    """tests/golden/packed_words.json's RQM round sum: the packed kernel's
    words at the pinned width."""
    with open(os.path.join(GOLDEN, "packed_words.json")) as f:
        block = json.load(f)["round_sums"]["rqm"]
    g = encoded_goldens
    params = RQMParams(**g["mechanisms"]["rqm"]["params"])
    x, _ = golden_sum_inputs(params.c)
    got = ops.rqm_round_sum(torch.from_numpy(x), g["kernel_seed_u32"], params,
                            pack_bits=block["bits"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(block["words"], np.int32))


def test_round_sum_pallas_body_agrees():
    """At a lane-aligned word count the reference's Pallas packed body
    runs (interpret mode); the port's words equal it and the dense body."""
    rows, bits = 3, 6
    dim = 5 * 128  # 5 fields per word at 6 bits: W = 128
    x, w = _cohort(rows, dim, seed=9)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    body = np.asarray(jfused.round_sum(jnp.asarray(x), jnp.uint32(SEED), P_J, "rqm",
                                       weights=jnp.asarray(w), row_offset=ROW_OFFSET,
                                       interpret=True, pack_bits=bits))
    body_dense = np.asarray(jfused.round_sum(jnp.asarray(x), jnp.uint32(SEED), P_J, "rqm",
                                             weights=jnp.asarray(w), row_offset=ROW_OFFSET,
                                             interpret=True))
    got = fused_round_kernel.round_sum_packed(xt, wt, SEED, ROW_OFFSET, P_T, bits)
    np.testing.assert_array_equal(got.numpy(), body)
    np.testing.assert_array_equal(
        fused_round_kernel.round_sum(xt, wt, SEED, ROW_OFFSET, P_T).numpy(), body_dense)


# ---------------------------------------------------------------------------
# decode + apply, dense and packed
# ---------------------------------------------------------------------------

DECODE_CASES = [(0.02, 40, 0.5), (1.5, 6, 1.0), (0.05, 7, 0.1)]


def _decode_inputs(c, n, dim, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, dim).astype(np.float32)
    z = rng.integers(0, n * 15 + 1, dim).astype(np.int32)
    return w, z, RQMParams(c=c, delta=c, m=16, q=0.42), JaxRQMParams(c=c, delta=c, m=16, q=0.42)


def _within_reference_ulp(got, ref, w, params, lr):
    """The reference's 1-ULP contract for its Pallas decode-apply body."""
    out_scale = np.maximum(np.abs(ref), np.abs(w)).astype(np.float32)
    tol = lr * np.spacing(np.float32(2.0 * params.x_max)) + np.spacing(out_scale)
    return bool(np.all(np.abs(ref - got) <= tol))


@pytest.mark.parametrize("c,n,lr", DECODE_CASES)
def test_decode_apply_sum_matches_reference(c, n, lr):
    dim = 5 * 8 * 128  # tiles the reference's (8, 128) Pallas blocks
    w, z, p_t, p_j = _decode_inputs(c, n, dim, seed=n)
    got = decode_apply_kernel.decode_apply_sum(torch.from_numpy(w), torch.from_numpy(z),
                                               p_t, n, lr).numpy()
    ref = np.asarray(jdecode.decode_apply_sum(jnp.asarray(w), jnp.asarray(z), p_j, n, lr))
    assert _ulps(got, ref) == 0
    body = np.asarray(jdecode.decode_apply_sum(jnp.asarray(w), jnp.asarray(z), p_j, n, lr,
                                               interpret=True))
    assert _within_reference_ulp(got, body, w, p_j, lr)


@pytest.mark.parametrize("c,n,lr", DECODE_CASES)
@pytest.mark.parametrize("dim", [1000, 3 * 8 * 128], ids=["unaligned", "aligned"])
def test_unpack_decode_apply_matches_reference(c, n, lr, dim):
    bits = 10
    w, z, p_t, p_j = _decode_inputs(c, n, dim, seed=dim + n)
    words = jwire.pack_bits_np(z, bits)
    got = pack_kernel.unpack_decode_apply(torch.from_numpy(w), torch.from_numpy(words),
                                          p_t, n, lr, pack_bits=bits).numpy()
    ref = np.asarray(jdecode.decode_apply_sum(jnp.asarray(w), jnp.asarray(words), p_j, n,
                                              lr, pack_bits=bits))
    assert _ulps(got, ref) == 0
    dense = decode_apply_kernel.decode_apply_sum(torch.from_numpy(w), torch.from_numpy(z),
                                                 p_t, n, lr).numpy()
    np.testing.assert_array_equal(got, dense)
    body = jpack.unpack_decode_apply(jnp.asarray(w), jnp.asarray(words), p_j, n, lr,
                                     pack_bits=bits, interpret=True)
    if body is not None:  # the Pallas body takes only W % 128 == 0
        assert _within_reference_ulp(got, np.asarray(body), w, p_j, lr)


# ---------------------------------------------------------------------------
# dispatch and validation
# ---------------------------------------------------------------------------


def test_cpu_tensors_run_plain_versions_and_count_nothing():
    ops.reset_launches()
    x, w = _cohort(4, 50)
    ops.rqm_round_sum(torch.from_numpy(x), SEED, P_T)
    ops.rqm_round_sum(torch.from_numpy(x), SEED, P_T, pack_bits=6)
    assert dict(ops.launches) == {}


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(4, 10)
    with pytest.raises(ValueError):
        fused_round_kernel.round_sum(x, torch.ones(3, dtype=torch.int32), 0, 0, P_T)
    with pytest.raises(ValueError):
        fused_round_kernel.round_sum(x, torch.ones(4, dtype=torch.int32), 1 << 32, 0, P_T)
    with pytest.raises(ValueError):
        pack_kernel.unpack_decode_apply(torch.zeros(10), torch.zeros(3, dtype=torch.int32),
                                        P_T, 4, 0.5, pack_bits=10)
    with pytest.raises(ValueError):
        decode_apply_kernel.decode_apply_sum(torch.zeros(10), torch.zeros(10, dtype=torch.int32),
                                             P_T, 0, 0.5)
