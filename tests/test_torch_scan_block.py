"""The port's scan engine runs blocks of rounds from device-resident draws
(``FedConfig(engine="scan")``, ``fed/engines.py``), on the CPU here, where a
block is an eager loop over the same buffers that a captured CUDA graph
replays on the card (tests/test_torch_cuda.py runs the graph).

Contracts:
  * a block draws each round's cohort and then its seed from the
    trainer's generator, in the order ``perround`` draws them and
    ``staging.replay_cohorts`` replays them, and leaves the generator in
    the same state;
  * ``scan_block`` is honoured, and blocks of 2 over 5 rounds give the
    parameters, collected sums and RDP of 5 perround rounds, bit for bit;
  * every plain version takes its seed as an int or as the 1-element int32
    device tensor a captured round reads, with the same levels and sums,
    and equal to the JAX reference's;
  * the noise-free decode's hoisted divisor gives the same bits;
  * the block path's seed, the pinned ``kernel_seed_u32`` of
    tests/golden/encoded_sums.json, reproduces the RQM golden sums;
  * a reference round replayed through the block path gives the
    reference's SecAgg sum and the perround step's parameters.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import collections
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

from repro.core import mechanisms as jmechs
from repro.fed import cohort as jcohort
from repro.fed import rounds as jrounds
from repro.fed.config import FedConfig as JaxFedConfig
from repro.fed.trainer import FedTrainer as JaxFedTrainer
from repro.kernels import fused_round_kernel as jfused
from repro.kernels import ops as jops
from repro_torch.core import mechanisms
from repro_torch.core.grid import RQMParams
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.fed import cohort, engines, rounds, staging
from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer
from repro_torch.kernels import _build, fused_round_kernel, ops, prng
from test_torch_quantize import MECHS, assert_levels

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))
from make_goldens import golden_sum_inputs  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SMALL = dict(num_clients=24, clients_per_round=6, lr=1.0, eval_size=64,
             samples_per_client=8)
SPECS = {"rqm": "rqm:c=0.05,m=16,q=0.42", "pbm": "pbm:c=0.05,m=16,theta=0.25",
         "qmgeo": "qmgeo:c=0.05,m=16,r=0.6", "none": "none:c=0.05"}
# seeds below and above 2**31: the int32 bit pattern of the second is negative
SEEDS = [2216260512 >> 1, 2216260512, 0, (1 << 32) - 1]


def _seed_tensor(seed: int) -> torch.Tensor:
    return torch.tensor([prng.seed_bits(seed)], dtype=torch.int32)


# ---------------------------------------------------------------------------
# block draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", [1, 4])
def test_block_draws_are_perround_draws(length):
    cfg = FedConfig(**SMALL)
    gen_block, gen_round = (torch.Generator().manual_seed(11) for _ in range(2))
    replayed = staging.replay_cohorts(cfg, 6, gen_block, length)
    block = cohort.draw_block(cfg, 6, gen_block, length)
    assert block.dtype == torch.int32 and block.shape == (length, 7)
    for t in range(length):
        ids = cohort.sample_slate(cfg, 6, gen_round)
        seed = cohort.draw_seed(gen_round)
        assert torch.equal(block[t, :6].long(), ids)
        np.testing.assert_array_equal(replayed[t], ids.numpy())
        assert int(block[t, 6]) & prng.MASK32 == seed
        assert int(prng.seed_value(block[t, 6:])) == seed
    assert torch.equal(gen_block.get_state(), gen_round.get_state())


def test_seed_bits_round_trips_and_checks_its_range():
    for seed in SEEDS:
        bits = prng.seed_bits(seed)
        assert -(1 << 31) <= bits < (1 << 31) and bits & prng.MASK32 == seed
    for bad in (-1, 1 << 32):
        with pytest.raises(ValueError, match="uint32"):
            prng.seed_bits(bad)


# ---------------------------------------------------------------------------
# blocks against perround
# ---------------------------------------------------------------------------


def _spy_blocks(monkeypatch) -> list:
    lengths = []
    draw = cohort.draw_block

    def spy(cfg, slate, generator, length):
        lengths.append(length)
        return draw(cfg, slate, generator, length)

    monkeypatch.setattr(cohort, "draw_block", spy)
    return lengths


@pytest.mark.parametrize("name,fused", [
    ("rqm", False), ("pbm", False), ("qmgeo", False), ("none", False),
    ("rqm", True), ("pbm", True), ("qmgeo", True),
], ids=lambda v: str(v))
def test_blocks_of_two_equal_perround(monkeypatch, name, fused):
    """5 rounds in blocks of 2 (2, 2, 1) against 5 perround rounds:
    parameters, collected sums, RDP and the generator's state, bit for bit."""
    cfg = FedConfig(collect_sums=True, fused_rounds=fused, scan_block=2, **SMALL)
    lengths = _spy_blocks(monkeypatch)
    ops.reset_launches()
    scan = FedTrainer(SPECS[name], cfg, device="cpu")
    scan.run_block(5)
    assert lengths == [2, 2, 1]
    per = FedTrainer(SPECS[name], dataclasses.replace(cfg, engine="perround"), device="cpu")
    for _ in range(5):
        per.round()
    assert torch.equal(scan.flat, per.flat)
    assert scan.flat.data_ptr() != scan.engine.flat.data_ptr()  # handed back, not shared
    assert len(scan.round_sums) == 5
    for a, b in zip(scan.round_sums, per.round_sums):
        np.testing.assert_array_equal(a, b)
    assert scan.accountant.rdp_epsilon(8.0) == per.accountant.rdp_epsilon(8.0)
    assert math.isclose(scan.accountant.rdp_epsilon(8.0),
                        5 * scan.mech.per_round_epsilon(6, 8.0), rel_tol=1e-12)
    assert torch.equal(scan.generator.get_state(), per.generator.get_state())
    assert scan.engine.graph is None and dict(ops.launches) == {}  # CPU: eager, plain versions


def test_block_reads_flat_set_between_blocks():
    """A block copies tr.flat in when it starts: parameters set on the
    trainer between blocks are the ones the next block trains."""
    a = FedTrainer(SPECS["rqm"], FedConfig(**SMALL), device="cpu")
    b = FedTrainer(SPECS["rqm"], FedConfig(engine="perround", **SMALL), device="cpu")
    start = torch.linspace(-0.1, 0.1, a.flat.numel())
    a.flat, b.flat = start.clone(), start.clone()
    a.run_block(2)
    b.round()
    b.round()
    assert torch.equal(a.flat, b.flat)


def test_shard_engine_stays_eager():
    assert not issubclass(engines.ShardEngine, engines.ScanEngine)
    assert engines.ShardEngine.blocked and not hasattr(engines.ShardEngine, "graph")


# ---------------------------------------------------------------------------
# tensor seeds in the plain versions
# ---------------------------------------------------------------------------


def _batch(rows=7, dim=131, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.06, 0.06, size=(rows, dim)).astype(np.float32)
    w = (rng.uniform(size=rows) > 0.3).astype(np.int32)
    return x, w


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(MECHS))
def test_tensor_seed_equals_int_seed(name, seed):
    """Each mechanism's quantize and round sums, plain versions, with the
    seed as an int and as a device-seed tensor: the same levels and sums;
    the dense sum also equals the JAX reference's at that uint32 seed
    (QMGeo within its budget)."""
    params_j, params_t = MECHS[name][:2]
    x, w = _batch()
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    st = _seed_tensor(seed)
    quantize = {"rqm": ops.rqm_batch, "pbm": ops.pbm_batch, "qmgeo": ops.qmgeo_batch}[name]
    assert torch.equal(quantize(xt, st, params_t, row_offset=3),
                       quantize(xt, seed, params_t, row_offset=3))
    dense = fused_round_kernel.round_sum_plain(xt, wt, st, 3, params_t, name)
    assert torch.equal(dense, fused_round_kernel.round_sum_plain(xt, wt, seed, 3, params_t, name))
    want = np.asarray(jfused.round_sum_jnp(
        jnp.asarray(x), jnp.asarray(w), jnp.uint32(seed), jnp.uint32(3), name, params_j,
        jfused.DEFAULT_BLOCK_ROWS))
    assert_levels(name, dense.numpy(), want)
    if name in fused_round_kernel.PACKED_KERNELS:
        assert torch.equal(
            fused_round_kernel.round_sum_packed_plain(xt, wt, st, 3, params_t, 10, name),
            fused_round_kernel.round_sum_packed_plain(xt, wt, seed, 3, params_t, 10, name))


def test_tensor_seed_is_checked():
    x = torch.zeros(2, 3)
    for bad in (torch.tensor([1], dtype=torch.int64), torch.tensor([1, 2], dtype=torch.int32),
                torch.tensor([[1]], dtype=torch.int32)[:, :0]):
        with pytest.raises(ValueError, match="tensor seed"):
            ops.rqm_batch(x, bad, RQMParams(c=0.02, delta=0.02, m=16, q=0.42))
    with pytest.raises(ValueError, match="uint32"):
        ops.rqm_batch(x, 1 << 32, RQMParams(c=0.02, delta=0.02, m=16, q=0.42))


def test_noise_free_decode_is_hoisted():
    """The divisor is made once per (n, dtype, device) and divides to the
    bits of a fresh 0-d tensor."""
    mech = make_mechanism("none:c=0.05")
    g = torch.from_numpy(np.random.default_rng(3).normal(0, 0.1, 1000).astype(np.float32))
    got = mech.decode_sum(g, 6)
    assert torch.equal(got, g / torch.tensor(6.0, dtype=torch.float32))
    assert mechanisms._cohort_size(6, torch.float32, g.device) is \
        mechanisms._cohort_size(6, torch.float32, g.device)


# ---------------------------------------------------------------------------
# goldens and the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoded_goldens():
    with open(os.path.join(GOLDEN, "encoded_sums.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("variant", ["sum", "sum_weighted", "sum_offset"])
def test_golden_rqm_sums_from_a_block_seed(encoded_goldens, variant):
    """The pinned ``kernel_seed_u32`` as a block carries it (the last
    column of a draws row) reproduces tests/golden/encoded_sums.json's RQM
    releases through the mechanism's fused sum."""
    g = encoded_goldens
    block = g["mechanisms"]["rqm"]
    params = RQMParams(**block["params"])
    mech = make_mechanism({"name": "rqm", **block["params"]})
    x, weights = golden_sum_inputs(params.c)
    rows = x.shape[0]
    draws = torch.zeros((2, rows + 1), dtype=torch.int32)
    draws[1, rows] = prng.seed_bits(g["kernel_seed_u32"])
    seed = draws[1, rows:]
    w = weights if variant == "sum_weighted" else np.ones_like(weights)
    off = g["row_offset"] if variant == "sum_offset" else 0
    got = mech.quantize_sum_batch(torch.from_numpy(x), seed, weights=torch.from_numpy(w),
                                  row_offset=off)
    np.testing.assert_array_equal(got.numpy(), np.asarray(block[variant]))


@pytest.fixture(scope="module")
def reference_round():
    """One materialized perround RQM round of the reference, with its
    cohort, kernel seed, gradients and SecAgg sum."""
    jtr = JaxFedTrainer(jmechs.make_mechanism(SPECS["rqm"]),
                        JaxFedConfig(engine="perround", collect_sums=True, **SMALL))
    _, k_sample, k_enc = jax.random.split(jtr._key, 3)
    ids, _ = jcohort.sample_slate(jtr.cfg, jtr.slate, k_sample)
    grads = jax.vmap(jtr._client_grad, in_axes=(None, 0))(
        jtr.flat, jrounds.index_batch(jtr.client_data, ids))
    flat0 = np.array(jtr.flat)
    jtr.round()
    return {"ids": np.array(ids), "seed": int(np.asarray(jops.key_to_seed(k_enc))),
            "grads": np.array(grads), "flat0": flat0, "sum": np.array(jtr.round_sums[-1])}


def test_reference_round_replayed_through_a_block(monkeypatch, reference_round):
    """The reference's cohort and seed as a block's draws, its gradients
    handed in: the block path's sum is the reference's, and its parameters
    are the perround step's on the same inputs, bit for bit."""
    ref = reference_round
    handed = torch.from_numpy(ref["grads"])
    draws = torch.tensor([list(ref["ids"]) + [prng.seed_bits(ref["seed"])]], dtype=torch.int32)
    monkeypatch.setattr(cohort, "draw_block", lambda cfg, slate, generator, length: draws)
    cfg = FedConfig(collect_sums=True, **SMALL)
    tr = FedTrainer(SPECS["rqm"], cfg, device="cpu")
    tr.client_grads = lambda flat, batch: handed
    engine = engines.ScanEngine(tr)
    tr.flat = torch.from_numpy(ref["flat0"])
    engine.advance(1)
    np.testing.assert_array_equal(tr.round_sums[-1], ref["sum"])
    step = rounds.make_round_step(tr.mech, dataclasses.replace(cfg, engine="perround"), 6,
                                  lambda flat, batch: handed)
    want, _, _ = step(torch.from_numpy(ref["flat0"]), (), tr.client_data, ids=ref["ids"],
                      seed=ref["seed"])
    assert torch.equal(tr.flat, want)


# ---------------------------------------------------------------------------
# launch counts of captured graphs, and capture errors
# ---------------------------------------------------------------------------


def test_launches_move_to_a_graph_and_count_per_replay():
    """Launches made inside ``moved_to`` go to the graph's record, not to
    ``launches``; each replay adds the record once."""
    ops.reset_launches()
    _build.launches["before"] += 1
    record = collections.Counter()
    with _build.moved_to(record):
        _build.launches["rqm_quantize_dev"] += 1
        _build.launches["unpack_flat"] += 2
    assert dict(ops.launches) == {"before": 1}
    assert dict(record) == {"rqm_quantize_dev": 1, "unpack_flat": 2}
    for _ in range(3):
        _build.replayed(record)
    assert dict(ops.launches) == {"before": 1, "rqm_quantize_dev": 3, "unpack_flat": 6}
    ops.reset_launches()


def test_capture_failure_names_the_first_error_and_its_line():
    """A failed capture raises twice (the op, then the capture's end): the
    message names the first error and the line outside PyTorch that made
    it."""
    try:
        try:
            rounds.index_batch({"a": torch.zeros(3)}, torch.tensor([5]))
        except IndexError:
            raise RuntimeError("capture invalidated")
    except RuntimeError as err:
        msg = engines._first_failure(err)
    assert msg.startswith("IndexError:")
    assert "fed/rounds.py" in msg and "return {k: v[ids]" in msg
