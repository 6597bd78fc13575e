"""The port's CUDA kernels and trainer on a GPU (marked ``cuda``).

Every test needs a CUDA device and skips without one: the kernels have no
CPU mode. This file imports neither JAX nor ``repro``, so it runs on a
GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports the JAX package.)

Each kernel must equal its plain PyTorch version bit for bit, on the card
and against the plain version on the CPU; chip_smoke.py repeats the check
at the main path's full shapes.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import collections
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.core import wire
from repro_torch.core.grid import RQMParams
from repro_torch.core.pbm import PBMParams
from repro_torch.core.qmgeo import QMGeoParams
from repro_torch.fed import rounds
from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer
from repro_torch.kernels import (
    _build,
    decode_apply_kernel,
    fused_round_kernel,
    ops,
    pack_kernel,
    pbm_kernel,
    qmgeo_kernel,
    rqm_kernel,
)

PARAMS = RQMParams(c=0.02, delta=0.02, m=16, q=0.42)
SEED, ROW_OFFSET = 2216260512, 3
# name -> (params, kernel wrapper, plain version)
QUANTIZE = {
    "rqm": (PARAMS, rqm_kernel.rqm_quantize, rqm_kernel.rqm_quantize_plain),
    "pbm": (PBMParams(c=0.02, m=16, theta=0.25), pbm_kernel.pbm_quantize,
            pbm_kernel.pbm_quantize_plain),
    "qmgeo": (QMGeoParams(c=0.02, delta=0.02, m=16, r=0.6), qmgeo_kernel.qmgeo_quantize,
              qmgeo_kernel.qmgeo_quantize_plain),
}
# QMGeo on the card against its plain version on the CPU: CUDA's expf and
# the CPU's exp may round differently, so cum <= t may fall the other way
# in at most this share of elements, by one level each
QMGEO_CPU_BUDGET = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,dim,bits", [(1, 1, 4), (7, 127, 10), (40, 3001, 16)])
def test_kernels_match_plain(cuda, rows, dim, bits):
    rng = np.random.default_rng(dim)
    x = rng.uniform(-0.024, 0.024, size=(rows, dim)).astype(np.float32)
    w = (rng.uniform(size=rows) > 0.3).astype(np.int32)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    ops.reset_launches()
    dense = fused_round_kernel.round_sum(xt, wt, SEED, ROW_OFFSET, PARAMS)
    packed = fused_round_kernel.round_sum_packed(xt, wt, SEED, ROW_OFFSET, PARAMS, bits)
    assert torch.equal(dense, fused_round_kernel.round_sum_plain(xt, wt, SEED, ROW_OFFSET, PARAMS))
    assert torch.equal(packed, fused_round_kernel.round_sum_packed_plain(
        xt, wt, SEED, ROW_OFFSET, PARAMS, bits))
    cpu = fused_round_kernel.round_sum(xt.cpu(), wt.cpu(), SEED, ROW_OFFSET, PARAMS)
    assert torch.equal(dense.cpu(), cpu)
    params = torch.from_numpy(rng.normal(0, 0.05, dim).astype(np.float32)).to(cuda)
    z = dense % (1 << bits)
    words = wire.pack_bits(z, bits)
    out = decode_apply_kernel.decode_apply_sum(params, z, PARAMS, rows, 0.5)
    assert torch.equal(out, decode_apply_kernel.decode_apply_plain(params, z, PARAMS, rows, 0.5))
    assert torch.equal(out.cpu(), decode_apply_kernel.decode_apply_plain(
        params.cpu(), z.cpu(), PARAMS, rows, 0.5))
    out_p = pack_kernel.unpack_decode_apply(params, words, PARAMS, rows, 0.5, pack_bits=bits)
    assert torch.equal(out_p, out)
    assert dict(ops.launches) == {"rqm_round_sum_dense": 1, "rqm_round_sum_packed": 1,
                                  "decode_apply_sum": 1, "unpack_decode_apply": 1}


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 10, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        fused_round_kernel.round_sum(x, torch.ones(4, device=cuda), 0, 0, PARAMS)
    with pytest.raises(ValueError, match="contiguous"):
        fused_round_kernel.round_sum(x.t().contiguous().t(), torch.ones(4, dtype=torch.int32,
                                                                        device=cuda), 0, 0, PARAMS)
    with pytest.raises(ValueError, match="CUDA"):
        decode_apply_kernel.decode_apply_sum(torch.zeros(10, device=cuda),
                                             torch.zeros(10, dtype=torch.int32), PARAMS, 4, 0.5)


@pytest.mark.cuda
def test_trainer_rounds_on_the_card(cuda):
    """Two rounds through the packed kernels; then one round's gradient
    stack through the packed and the dense wire gives identical params."""
    small = dict(num_clients=24, clients_per_round=6, eval_size=64, samples_per_client=8)
    fused = dict(engine="perround", fused_rounds=True)
    tr = FedTrainer("rqm:c=0.05", FedConfig(**fused, **small), device=cuda)
    ops.reset_launches()
    tr.train(rounds=2, eval_every=2, log=lambda msg: None)
    assert dict(ops.launches) == {"rqm_round_sum_packed": 2, "unpack_decode_apply": 2}
    assert torch.isfinite(tr.flat).all()
    ids = torch.arange(6)
    grads = tr.client_grads(tr.flat, rounds.index_batch(tr.client_data, ids.to(cuda)))
    new = {}
    for packed in (None, False):
        cfg = FedConfig(wire_packed=packed, **fused, **small)
        step = rounds.make_round_step(tr.mech, cfg, tr.slate, lambda flat, batch: grads)
        new[packed], _, _ = step(tr.flat, (), tr.client_data, ids=ids, seed=SEED)
    assert torch.equal(new[None], new[False])


def _batch(cuda, rows, dim, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-0.024, 0.024, size=(rows, dim)).astype(np.float32)).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,dim,row_offset", [(1, 1, 0), (7, 127, 3), (40, 3001, 4_294_967)],
                         ids=str)
@pytest.mark.parametrize("name", list(QUANTIZE))
def test_quantize_kernels_match_plain(cuda, name, rows, dim, row_offset):
    """Rows 5-7: each kernel equals its plain version on the card bit for
    bit; on the CPU, RQM and PBM exactly, QMGeo within its budget."""
    params, kernel, plain = QUANTIZE[name]
    x = _batch(cuda, rows, dim, seed=dim)
    ops.reset_launches()
    got = kernel(x, SEED, params, row_offset)
    assert dict(ops.launches) == {f"{name}_quantize": 1}
    assert got.dtype == torch.int32 and got.shape == (rows, dim)
    assert torch.equal(got, plain(x, SEED, params, row_offset))
    diff = (got.cpu().long() - kernel(x.cpu(), SEED, params, row_offset).long()).abs()
    if name == "qmgeo":
        assert int(diff.max()) <= 1
        assert int(diff.count_nonzero()) <= math.ceil(QMGEO_CPU_BUDGET * diff.numel())
    else:
        assert int(diff.max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pbm", "qmgeo"])
def test_round_sum_encoders_match_plain(cuda, name):
    """The pbm and qmgeo encoders of the round sums (rows 1-2): equal to
    their plain versions and to the quantize kernel's batch, summed."""
    params = QUANTIZE[name][0]
    x = _batch(cuda, 40, 3001, seed=1)
    w = torch.from_numpy((np.arange(40) % 4 != 0).astype(np.int32)).to(cuda)
    ops.reset_launches()
    dense = fused_round_kernel.round_sum(x, w, SEED, ROW_OFFSET, params, name)
    assert torch.equal(dense, fused_round_kernel.round_sum_plain(
        x, w, SEED, ROW_OFFSET, params, name))
    z = QUANTIZE[name][1](x, SEED, params, ROW_OFFSET)
    assert torch.equal(dense, (z * w[:, None]).sum(0, dtype=torch.int32))
    want = {f"{name}_round_sum_dense": 1, f"{name}_quantize": 1}
    if name == "qmgeo":
        packed = fused_round_kernel.round_sum_packed(x, w, SEED, ROW_OFFSET, params, 10, name)
        assert torch.equal(packed, fused_round_kernel.round_sum_packed_plain(
            x, w, SEED, ROW_OFFSET, params, 10, name))
        assert torch.equal(packed, wire.pack_bits(dense, 10))
        want["qmgeo_round_sum_packed"] = 1
    else:
        with pytest.raises(ValueError, match="never travels packed"):
            fused_round_kernel.round_sum_packed(x, w, SEED, ROW_OFFSET, params, 10, name)
    assert dict(ops.launches) == want


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 16, 34, 64])
def test_rqm_kernels_at_edge_m(cuda, m):
    """rqm_quantize and both RQM round sums at q=0.5 and m=2 (no interior
    level), 16 (the paper's, one keep-mask word), 34 and 64 (two keep-mask
    words): equal to their plain versions, and to each other."""
    params = RQMParams(c=0.02, delta=0.02, m=m, q=0.5)
    x = _batch(cuda, 40, 3001, seed=m)
    w = torch.from_numpy((np.arange(40) % 5 != 0).astype(np.int32)).to(cuda)
    ops.reset_launches()
    z = rqm_kernel.rqm_quantize(x, SEED, params, ROW_OFFSET)
    dense = fused_round_kernel.round_sum(x, w, SEED, ROW_OFFSET, params)
    packed = fused_round_kernel.round_sum_packed(x, w, SEED, ROW_OFFSET, params, 16)
    assert dict(ops.launches) == {"rqm_quantize": 1, "rqm_round_sum_dense": 1,
                                  "rqm_round_sum_packed": 1}
    assert torch.equal(z, rqm_kernel.rqm_quantize_plain(x, SEED, params, ROW_OFFSET))
    assert int(z.min()) >= 0 and int(z.max()) <= m - 1
    assert torch.equal(dense, fused_round_kernel.round_sum_plain(
        x, w, SEED, ROW_OFFSET, params))
    assert torch.equal(dense, (z * w[:, None]).sum(0, dtype=torch.int32))
    assert torch.equal(packed, fused_round_kernel.round_sum_packed_plain(
        x, w, SEED, ROW_OFFSET, params, 16))
    assert torch.equal(packed, wire.pack_bits(dense, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 17])
def test_pbm_kernels_at_edges(cuda, m):
    """pbm_quantize and pbm_round_sum_dense at theta = 1/2, where x = -c and
    +c give p = 0 and 1 (the integer threshold's two edges), with NaN
    inputs (no draw succeeds), at m = 1, 16 (the unrolled instance) and 17:
    equal to their plain versions, and to each other."""
    params = PBMParams(c=0.02, m=m, theta=0.5)
    x = _batch(cuda, 40, 3001, seed=m)
    x[::7, ::5] = float("nan")
    x[1::7, ::3] = 0.02
    x[2::7, ::3] = -0.02
    w = torch.from_numpy((np.arange(40) % 3 != 0).astype(np.int32)).to(cuda)
    ops.reset_launches()
    z = pbm_kernel.pbm_quantize(x, SEED, params, ROW_OFFSET)
    dense = fused_round_kernel.round_sum(x, w, SEED, ROW_OFFSET, params, "pbm")
    assert dict(ops.launches) == {"pbm_quantize": 1, "pbm_round_sum_dense": 1}
    assert torch.equal(z, pbm_kernel.pbm_quantize_plain(x, SEED, params, ROW_OFFSET))
    assert torch.equal(dense, fused_round_kernel.round_sum_plain(
        x, w, SEED, ROW_OFFSET, params, "pbm"))
    assert torch.equal(dense, (z * w[:, None]).sum(0, dtype=torch.int32))
    assert bool((z[torch.isnan(x)] == 0).all())
    assert bool((z[x >= 0.02] == m).all()) and bool((z[x <= -0.02] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("r", [0.1, 0.6, 0.95])
@pytest.mark.parametrize("m", [2, 16, 33, 64, 100, 5000])
def test_qmgeo_kernels_at_edge_m(cuda, m, r):
    """qmgeo_quantize and both QMGeo round sums at m = 2 (a one-node
    tree), 16 (the unrolled tree), 33 (a tree padded to 64 with +inf), 64
    (the largest tree, 17 KB of tables), 100 (the walk over W) and 5000
    (past the walk's 4096 tabled weights): equal to their plain versions,
    and to each other. 13 rows at m = 5000, so that a 16-bit field holds
    the sum."""
    params = QMGeoParams(c=0.02, delta=0.02, m=m, r=r)
    rows = 40 if m <= 100 else 13
    x = _batch(cuda, rows, 3001, seed=m)
    w = torch.from_numpy((np.arange(rows) % 5 != 0).astype(np.int32)).to(cuda)
    ops.reset_launches()
    z = qmgeo_kernel.qmgeo_quantize(x, SEED, params, ROW_OFFSET)
    dense = fused_round_kernel.round_sum(x, w, SEED, ROW_OFFSET, params, "qmgeo")
    packed = fused_round_kernel.round_sum_packed(x, w, SEED, ROW_OFFSET, params, 16, "qmgeo")
    assert dict(ops.launches) == {"qmgeo_quantize": 1, "qmgeo_round_sum_dense": 1,
                                  "qmgeo_round_sum_packed": 1}
    assert torch.equal(z, qmgeo_kernel.qmgeo_quantize_plain(x, SEED, params, ROW_OFFSET))
    assert int(z.min()) >= 0 and int(z.max()) <= m - 1
    assert torch.equal(dense, fused_round_kernel.round_sum_plain(
        x, w, SEED, ROW_OFFSET, params, "qmgeo"))
    assert torch.equal(dense, (z * w[:, None]).sum(0, dtype=torch.int32))
    assert torch.equal(packed, fused_round_kernel.round_sum_packed_plain(
        x, w, SEED, ROW_OFFSET, params, 16, "qmgeo"))
    assert torch.equal(packed, wire.pack_bits(dense, 16))


def _weights(kind: str, rows: int, rng) -> np.ndarray:
    if kind == "ones":
        return np.ones(rows, np.int32)
    if kind == "zeros_and_large":
        return np.where(np.arange(rows) % 2 == 0, 0, (1 << 20) + 7).astype(np.int32)
    if kind == "large":
        return rng.integers(1000, 5000, rows).astype(np.int32)
    return rng.choice(np.array([0, 1, 2, 1000], np.int32), rows)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,dim,bits,weights", [
    (1, 1, 10, "ones"),              # one word; its other fields are padding
    (1, 2000, 10, "large"),          # one row; 667 words, not a multiple of the tile
    (7, 95, 4, "zeros_and_large"),   # 8 fields a word; row groups of 2, the last of 1
    (23, 3001, 10, "mixed"),         # 1001 words; row groups of 3, the last of 2
    (40, 3001, 16, "large"),         # the top field across the sign bit
], ids=str)
@pytest.mark.parametrize("name", ["rqm", "qmgeo"])
def test_packed_round_sum_ragged(cuda, name, rows, dim, bits, weights):
    """The packed kernel's tiles of 32 words and its row groups at ragged
    edges, with zero and large weights (fields may overflow: the words
    are sums mod 2**32 on both sides): equal to the plain version."""
    params = QUANTIZE[name][0]
    rng = np.random.default_rng(rows * 1000 + dim)
    x = _batch(cuda, rows, dim, seed=dim)
    w = torch.from_numpy(_weights(weights, rows, rng)).to(cuda)
    ops.reset_launches()
    got = fused_round_kernel.round_sum_packed(x, w, SEED, ROW_OFFSET, params, bits, name)
    assert dict(ops.launches) == {f"{name}_round_sum_packed": 1}
    assert got.shape == (wire.packed_words(dim, bits),)
    assert torch.equal(got, fused_round_kernel.round_sum_packed_plain(
        x, w, SEED, ROW_OFFSET, params, bits, name))
    if bits == 16:
        assert bool((got < 0).any())  # a word with the sign bit set
    if weights == "ones":  # no field overflows
        dense = fused_round_kernel.round_sum(x, w, SEED, ROW_OFFSET, params, name)
        assert torch.equal(got, wire.pack_bits(dense, bits))


@pytest.mark.cuda
def test_quantize_refuses_what_the_kernel_does_not_take(cuda):
    params = QUANTIZE["pbm"][0]
    with pytest.raises(ValueError, match="float32"):
        pbm_kernel.pbm_quantize(torch.zeros(4, 10, dtype=torch.float64, device=cuda),
                                SEED, params)
    with pytest.raises(ValueError, match="contiguous"):
        pbm_kernel.pbm_quantize(torch.zeros(10, 4, device=cuda).t(), SEED, params)
    with pytest.raises(ValueError, match="uint32"):
        qmgeo_kernel.qmgeo_quantize(torch.zeros(4, 10, device=cuda), 1 << 32,
                                    QUANTIZE["qmgeo"][0])
    with pytest.raises(ValueError, match="rows, dim"):
        rqm_kernel.rqm_quantize(torch.zeros(10, device=cuda), SEED, PARAMS)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rqm", "pbm", "qmgeo", "none"])
def test_default_round_on_the_card(cuda, name):
    """FedConfig(): the materialized scan round, one quantize launch per
    round; then one round's gradient stack through the materialized and
    the fused round step gives identical parameters."""
    small = dict(num_clients=24, clients_per_round=6, eval_size=64, samples_per_client=8)
    tr = FedTrainer(f"{name}:c=0.05", FedConfig(**small), device=cuda)
    ops.reset_launches()
    tr.run_block(2)
    # the scan engine replays its captured round, which launches the _dev entry
    assert dict(ops.launches) == ({} if name == "none" else {f"{name}_quantize_dev": 2})
    assert torch.isfinite(tr.flat).all()
    ids = torch.arange(6)
    grads = tr.client_grads(tr.flat, rounds.index_batch(tr.client_data, ids.to(cuda)))
    new = {}
    for fused in (False, True):
        cfg = FedConfig(fused_rounds=fused, **small)
        step = rounds.make_round_step(tr.mech, cfg, tr.slate, lambda flat, batch: grads)
        new[fused], _, _ = step(tr.flat, (), tr.client_data, ids=ids, seed=SEED)
    assert torch.equal(new[False], new[True])


@pytest.mark.cuda
@pytest.mark.parametrize("bits,n", [(10, 222_030), (16, 257), (4, 1000), (7, 130), (1, 33),
                                    (16, 222_030), (10, 3 * 4 * 1000), (10, 3 * 4 * 1000 - 2)],
                         ids=str)
def test_codec_kernels_match_plain(cuda, bits, n):
    """Rows 8-9: pack_flat and unpack_flat equal the plain codec on the
    card, on views that start 0 to 3 words past an aligned address (so
    the walk takes every width its word count allows: W = 74,010 = 2 mod
    4, W odd, W = 4000 = 0 mod 4)."""
    values = np.random.default_rng(n).integers(0, 1 << bits, n).astype(np.int32)
    n_words = wire.packed_words(n, bits)
    for offset in range(4):
        buf = torch.zeros(n + offset, dtype=torch.int32, device=cuda)
        z = buf[offset:]
        z.copy_(torch.from_numpy(values))
        ops.reset_launches()
        words = pack_kernel.pack_flat(z, bits)
        wbuf = torch.zeros(n_words + offset, dtype=torch.int32, device=cuda)
        wbuf[offset:] = words
        back = pack_kernel.unpack_flat(wbuf[offset:], bits, n)
        assert dict(ops.launches) == {"pack_flat": 1, "unpack_flat": 1}
        assert torch.equal(words, pack_kernel.pack_flat_plain(z, bits))
        assert torch.equal(words.cpu(), wire.pack_bits(z.cpu(), bits))
        assert torch.equal(back, z)
        addrs = (z.data_ptr(), words.data_ptr())
        assert pack_kernel.built_walk(n, n_words, bits, addrs) == \
            pack_kernel.codec_walk(n, n_words, bits, addrs)
    top = torch.full((n,), (1 << bits) - 1, dtype=torch.int32, device=cuda)
    assert torch.equal(pack_kernel.unpack_flat(pack_kernel.pack_flat(top, bits), bits, n), top)


@pytest.mark.cuda
def test_unpack_flat_replays_in_a_cuda_graph(cuda):
    """unpack_flat captured in a CUDA graph (as the graphed fused packed
    round that keeps its sums runs it): each replay unpacks the words the
    buffer holds then, bit for bit, and counts one launch from the
    capture's record."""
    bits, n = 10, 222_030
    rng = np.random.default_rng(7)
    words = torch.zeros(wire.packed_words(n, bits), dtype=torch.int32, device=cuda)
    pack_kernel.unpack_flat(words, bits, n)  # build and load before the capture
    torch.cuda.synchronize()
    graph, record = torch.cuda.CUDAGraph(), collections.Counter()
    with _build.moved_to(record), torch.cuda.graph(graph):
        out = pack_kernel.unpack_flat(words, bits, n)
    assert dict(record) == {"unpack_flat": 1}
    ops.reset_launches()
    for _ in range(2):
        z = rng.integers(0, 1 << bits, n).astype(np.int32)
        words.copy_(wire.pack_bits(torch.from_numpy(z), bits))
        graph.replay()
        _build.replayed(record)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), torch.from_numpy(z))
    assert dict(ops.launches) == {"unpack_flat": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("bits,n", [(10, 222_030), (16, 222_030), (10, 6301), (16, 4101),
                                    (1, 2235), (10, 1)], ids=str)
def test_decode_kernels_match_plain_on_views(cuda, bits, n):
    """Rows 3-4: decode_apply_sum and unpack_decode_apply equal their plain
    versions, on the card and on the CPU, on views that start 0 to 3 words
    past an aligned address (16 bits: every field 2^16 - 1, the top one
    across the sign bit; W odd at 16 bits, 6301 and 4101); each
    unpack_decode_apply launch takes the walk ``codec_walk`` picks."""
    rng = np.random.default_rng(n + bits)
    w = torch.from_numpy(rng.normal(0, 0.05, n).astype(np.float32))
    z = torch.from_numpy((np.full(n, (1 << bits) - 1) if bits == 16 else
                          rng.integers(0, min(601, 1 << bits), n)).astype(np.int32))
    words = wire.pack_bits(z, bits)
    want = decode_apply_kernel.decode_apply_plain(w, z, PARAMS, 40, 0.5)
    for offset in range(4):
        wv, zv, words_v = (torch.cat([t.new_zeros(offset), t]).to(cuda)[offset:]
                           for t in (w, z, words))
        ops.reset_launches()
        dense = decode_apply_kernel.decode_apply_sum(wv, zv, PARAMS, 40, 0.5)
        packed = pack_kernel.unpack_decode_apply(wv, words_v, PARAMS, 40, 0.5, pack_bits=bits)
        assert dict(ops.launches) == {"decode_apply_sum": 1, "unpack_decode_apply": 1}
        assert torch.equal(dense, decode_apply_kernel.decode_apply_plain(wv, zv, PARAMS, 40, 0.5))
        assert torch.equal(packed, pack_kernel.unpack_decode_apply_plain(
            wv, words_v, PARAMS, 40, 0.5, pack_bits=bits))
        assert torch.equal(dense.cpu(), want) and torch.equal(packed.cpu(), want)
        addrs = (wv.data_ptr(), words_v.data_ptr(), packed.data_ptr())
        assert pack_kernel.built_walk(n, words.numel(), bits, addrs) == \
            pack_kernel.codec_walk(n, words.numel(), bits, addrs)


@pytest.mark.cuda
def test_decode_kernels_replay_in_a_cuda_graph(cuda):
    """Both decode entries captured in one CUDA graph, as the graphed
    fused rounds run them: each replay decodes the sum and the words the
    buffers hold then, bit for bit, and counts one launch of each."""
    bits, n = 10, 222_030
    rng = np.random.default_rng(9)
    w = torch.from_numpy(rng.normal(0, 0.05, n).astype(np.float32)).to(cuda)
    z = torch.zeros(n, dtype=torch.int32, device=cuda)
    words = torch.zeros(wire.packed_words(n, bits), dtype=torch.int32, device=cuda)
    decode_apply_kernel.decode_apply_sum(w, z, PARAMS, 40, 0.5)  # build and load first
    pack_kernel.unpack_decode_apply(w, words, PARAMS, 40, 0.5, pack_bits=bits)
    torch.cuda.synchronize()
    graph, record = torch.cuda.CUDAGraph(), collections.Counter()
    with _build.moved_to(record), torch.cuda.graph(graph):
        dense = decode_apply_kernel.decode_apply_sum(w, z, PARAMS, 40, 0.5)
        packed = pack_kernel.unpack_decode_apply(w, words, PARAMS, 40, 0.5, pack_bits=bits)
    assert dict(record) == {"decode_apply_sum": 1, "unpack_decode_apply": 1}
    ops.reset_launches()
    for _ in range(2):
        levels = torch.from_numpy(rng.integers(0, 601, n).astype(np.int32))
        z.copy_(levels)
        words.copy_(wire.pack_bits(levels, bits))
        graph.replay()
        _build.replayed(record)
        torch.cuda.synchronize()
        want = decode_apply_kernel.decode_apply_plain(w.cpu(), levels, PARAMS, 40, 0.5)
        assert torch.equal(dense.cpu(), want) and torch.equal(packed.cpu(), want)
    assert dict(ops.launches) == {"decode_apply_sum": 2, "unpack_decode_apply": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [70_001, 70_000, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_folded_decode_apply_matches_plain(cuda, dtype, n):
    """Row 10: the folded decode_apply equals its plain version on the
    card and on the CPU, on views that start 0 to 3 elements past an
    aligned address (w, the sum and so the output alike), each launch
    taking the walk ``folded_walk`` picks; captured in a CUDA graph, a
    replay decodes the sum the buffer holds then and counts one launch.
    Its C entry refuses n < 1 and n past INT_MAX less a block of V = 2
    (before it touches memory), and the launch raises on the refusal."""
    rng = np.random.default_rng(n)
    w = torch.from_numpy(rng.normal(0, 0.05, n).astype(np.float32)).to(dtype)
    z = torch.from_numpy(rng.integers(0, 601, n).astype(np.int32))
    want = decode_apply_kernel.decode_apply_ref(w, z, PARAMS, 40, 0.5)
    bf16 = dtype == torch.bfloat16
    for offset in range(4):
        wv, zv = (torch.cat([t.new_zeros(offset), t]).to(cuda)[offset:] for t in (w, z))
        ops.reset_launches()
        out = decode_apply_kernel.decode_apply(wv, zv, PARAMS, 40, 0.5)
        assert dict(ops.launches) == {"decode_apply": 1} and out.dtype == dtype
        assert torch.equal(out, decode_apply_kernel.decode_apply_ref(wv, zv, PARAMS, 40, 0.5))
        assert torch.equal(out.cpu(), want)
        addrs = (wv.data_ptr(), zv.data_ptr(), out.data_ptr())
        assert decode_apply_kernel.built_folded_walk(n, bf16, addrs) == \
            decode_apply_kernel.folded_walk(n, bf16, addrs)
    wc, zc = w.to(cuda), torch.zeros(n, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    graph, record = torch.cuda.CUDAGraph(), collections.Counter()
    with _build.moved_to(record), torch.cuda.graph(graph):
        out = decode_apply_kernel.decode_apply(wc, zc, PARAMS, 40, 0.5)
    assert dict(record) == {"decode_apply": 1}
    zc.copy_(z)
    ops.reset_launches()
    graph.replay()
    _build.replayed(record)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want) and dict(ops.launches) == {"decode_apply": 1}
    shift, scale = decode_apply_kernel.folded_constants(PARAMS, 40, 0.5)
    for bad in (0, -1, decode_apply_kernel.INT_MAX - 2047):
        with pytest.raises(RuntimeError, match="invalid argument"):
            _build.launch("decode_apply", "decode_apply", decode_apply_kernel._FOLDED_ARGS,
                          wc.data_ptr(), zc.data_ptr(), out.data_ptr(), bad, int(bf16), shift,
                          scale, torch.cuda.current_stream().cuda_stream)
        with pytest.raises(ValueError, match="coordinates"):
            decode_apply_kernel.folded_walk(bad, bf16, (0, 0, 0))
    assert decode_apply_kernel.folded_walk(decode_apply_kernel.INT_MAX - 2048, bf16,
                                           (0, 0, 0))[1] > 0
    assert dict(ops.launches) == {"decode_apply": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rqm", "pbm", "none"])
def test_shard_trainer_on_one_nccl_rank(cuda, name):
    """engine='shard' at one NCCL rank: pack_flat -> all_reduce ->
    unpack_flat each round; then one round's gradient stack through the
    shard and the scan round step gives identical sums and parameters."""
    small = dict(num_clients=24, clients_per_round=6, eval_size=64, samples_per_client=8,
                 collect_sums=True)
    tr = FedTrainer(f"{name}:c=0.05", FedConfig(engine="shard", **small), device=cuda)
    ops.reset_launches()
    tr.run_block(2)
    want = {} if name == "none" else {f"{name}_quantize": 2, "pack_flat": 2, "unpack_flat": 2}
    assert dict(ops.launches) == want
    assert tr.shards == 1 and torch.isfinite(tr.flat).all() and len(tr.round_sums) == 2
    ids = torch.arange(6)
    grads = tr.client_grads(tr.flat, rounds.index_batch(tr.client_data, ids.to(cuda)))
    cfg = FedConfig(**small)
    scan = rounds.make_round_step(tr.mech, cfg, 6, lambda flat, batch: grads)
    shard = rounds.make_shard_round_step(tr.mech, dataclasses.replace(cfg, engine="shard"), 6,
                                         1, 0, tr.engine.group, lambda flat, batch: grads)
    (a, _, sa), (b, _, sb) = (step(tr.flat, (), tr.client_data, ids=ids, seed=SEED)
                              for step in (scan, shard))
    assert torch.equal(sa, sb) and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the scan engine's captured round and the _dev entries
# ---------------------------------------------------------------------------

SMALL = dict(num_clients=24, clients_per_round=6, eval_size=64, samples_per_client=8)
SPECS = {"rqm": "rqm:c=0.05", "pbm": "pbm:c=0.05", "qmgeo": "qmgeo:c=0.05",
         "none": "none:c=0.05"}


@pytest.fixture
def deterministic(cuda, monkeypatch):
    """The graph and the eager rounds it is held against must pick the
    same cuBLAS and cuDNN algorithms, in full float32, as chip_smoke.py
    sets them."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    flags = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.use_deterministic_algorithms(flags[0])
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags[1:]


def _dev_launches(name: str, fused: bool, packed, rounds_: int, dev: str) -> dict:
    if name == "none":
        return {}
    if not fused:
        return {f"{name}_quantize{dev}": rounds_}
    if packed is None and name != "pbm":
        return {f"{name}_round_sum_packed{dev}": rounds_, "unpack_decode_apply": rounds_,
                "unpack_flat": rounds_}
    decode = {} if name == "pbm" else {"decode_apply_sum": rounds_}
    return {f"{name}_round_sum_dense{dev}": rounds_, **decode}


@pytest.mark.cuda
@pytest.mark.parametrize("name,fused,packed", [
    ("rqm", False, None), ("pbm", False, None), ("qmgeo", False, None), ("none", False, None),
    ("rqm", True, None), ("rqm", True, False), ("qmgeo", True, None), ("qmgeo", True, False),
    ("pbm", True, None),
], ids=str)
def test_graphed_scan_equals_eager_perround(deterministic, name, fused, packed):
    """5 rounds of the scan engine in blocks of 2, each round a replay of
    the captured graph, against 5 eager perround rounds: parameters,
    collected sums and RDP bit for bit; the graph launched the _dev
    entries once a round, the eager rounds the by-value ones."""
    cfg = FedConfig(collect_sums=True, fused_rounds=fused, wire_packed=packed, scan_block=2,
                    **SMALL)
    scan = FedTrainer(SPECS[name], cfg, device=deterministic)
    ops.reset_launches()
    scan.run_block(5)
    assert dict(ops.launches) == _dev_launches(name, fused, packed, 5, "_dev")
    assert scan.engine.graph is not None
    per = FedTrainer(SPECS[name], dataclasses.replace(cfg, engine="perround"),
                     device=deterministic)
    ops.reset_launches()
    for _ in range(5):
        per.round()
    assert dict(ops.launches) == _dev_launches(name, fused, packed, 5, "")
    assert torch.equal(scan.flat, per.flat)
    assert len(scan.round_sums) == 5
    for a, b in zip(scan.round_sums, per.round_sums):
        np.testing.assert_array_equal(a, b)
    assert scan.accountant.rdp_epsilon(8.0) == per.accountant.rdp_epsilon(8.0)
    assert torch.equal(scan.generator.get_state(), per.generator.get_state())


# entry -> a call of it with the seed as given (the paper's widths, small)
def _seeded_calls(x, w):
    pb, qm = QUANTIZE["pbm"][0], QUANTIZE["qmgeo"][0]
    return {
        "rqm_quantize": lambda s: rqm_kernel.rqm_quantize(x, s, PARAMS, ROW_OFFSET),
        "pbm_quantize": lambda s: pbm_kernel.pbm_quantize(x, s, pb, ROW_OFFSET),
        "qmgeo_quantize": lambda s: qmgeo_kernel.qmgeo_quantize(x, s, qm, ROW_OFFSET),
        "rqm_round_sum_dense": lambda s: fused_round_kernel.round_sum(
            x, w, s, ROW_OFFSET, PARAMS),
        "pbm_round_sum_dense": lambda s: fused_round_kernel.round_sum(
            x, w, s, ROW_OFFSET, pb, "pbm"),
        "qmgeo_round_sum_dense": lambda s: fused_round_kernel.round_sum(
            x, w, s, ROW_OFFSET, qm, "qmgeo"),
        "rqm_round_sum_packed": lambda s: fused_round_kernel.round_sum_packed(
            x, w, s, ROW_OFFSET, PARAMS, 10),
        "qmgeo_round_sum_packed": lambda s: fused_round_kernel.round_sum_packed(
            x, w, s, ROW_OFFSET, qm, 10, "qmgeo"),
    }


_PLAIN = {"rqm_quantize": rqm_kernel.rqm_quantize_plain,
          "pbm_quantize": pbm_kernel.pbm_quantize_plain,
          "qmgeo_quantize": qmgeo_kernel.qmgeo_quantize_plain}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [SEED >> 1, SEED], ids=str)  # the second's bits are negative
@pytest.mark.parametrize("entry", list(_seeded_calls(None, None)))
def test_dev_entry_equals_its_by_value_entry(cuda, entry, seed):
    """Each of the eight _dev entries, given the seed as a device tensor,
    equals its by-value entry given the int, and the plain version."""
    from repro_torch.kernels.prng import seed_bits

    x = _batch(cuda, 40, 3001, seed=7)
    w = torch.from_numpy((np.arange(40) % 3 != 0).astype(np.int32)).to(cuda)
    seed_t = torch.tensor([seed_bits(seed)], dtype=torch.int32, device=cuda)
    call = _seeded_calls(x, w)[entry]
    ops.reset_launches()
    got, want = call(seed_t), call(seed)
    assert dict(ops.launches) == {f"{entry}_dev": 1, entry: 1}
    assert torch.equal(got, want)
    if entry in _PLAIN:
        name = entry.split("_")[0]
        plain = _PLAIN[entry](x, seed_t, QUANTIZE[name][0] if name != "rqm" else PARAMS,
                              ROW_OFFSET)
        assert torch.equal(got, plain)
    elif entry.endswith("_dense"):
        name = entry.split("_")[0]
        params = PARAMS if name == "rqm" else QUANTIZE[name][0]
        assert torch.equal(got, fused_round_kernel.round_sum_plain(
            x, w, seed_t, ROW_OFFSET, params, name))


@pytest.mark.cuda
def test_launches_count_once_per_replay(deterministic):
    """Warm-up and capture launch nothing that counts; each replay adds the
    captured launches once."""
    cfg = FedConfig(fused_rounds=True, **SMALL)
    tr = FedTrainer(SPECS["rqm"], cfg, device=deterministic)
    ops.reset_launches()
    tr.run_block(1)
    assert dict(tr.engine.graph.launches) == {"rqm_round_sum_packed_dev": 1,
                                              "unpack_decode_apply": 1}
    assert dict(ops.launches) == {"rqm_round_sum_packed_dev": 1, "unpack_decode_apply": 1}
    graph = tr.engine.graph
    tr.run_block(3)
    assert tr.engine.graph is graph  # captured once
    assert dict(ops.launches) == {"rqm_round_sum_packed_dev": 4, "unpack_decode_apply": 4}


@pytest.mark.cuda
def test_uncapturable_round_raises_without_fallback(deterministic, monkeypatch):
    """A round op that copies from the host fails the capture: the block
    raises, naming the line, runs no round eagerly instead and leaves the
    generator where it was, so that a retry draws perround's cohorts."""
    from repro_torch.core import mechanisms

    def decode_with_a_host_copy(self, g_sum, n):
        return g_sum / torch.tensor(float(n), dtype=g_sum.dtype, device=g_sum.device)

    monkeypatch.setattr(mechanisms.NoiseFreeMechanism, "decode_sum", decode_with_a_host_copy)
    tr = FedTrainer(SPECS["none"], FedConfig(**SMALL), device=deterministic)
    start, state = tr.flat.clone(), tr.generator.get_state()
    for _ in range(2):  # no graph is kept, and no round runs
        with pytest.raises(RuntimeError, match="cannot be captured") as err:
            tr.run_block(1)
        assert "torch.tensor(float(n)" in str(err.value)
        assert tr.engine.graph is None and tr.accountant.rounds == 0
        assert torch.equal(tr.flat, start)
        assert torch.equal(tr.generator.get_state(), state)


@pytest.mark.cuda
def test_capture_keeps_the_garbage_collector_off(deterministic, monkeypatch):
    """The cyclic collector runs in the warm-up rounds but not while the
    round is captured (a dead trainer's graph that it freed then would
    end the capture), and is on again after."""
    import gc

    from repro_torch.core import mechanisms

    seen, decode = [], mechanisms.NoiseFreeMechanism.decode_sum

    def decode_and_look(self, g_sum, n):
        seen.append(gc.isenabled())
        return decode(self, g_sum, n)

    monkeypatch.setattr(mechanisms.NoiseFreeMechanism, "decode_sum", decode_and_look)
    tr = FedTrainer(SPECS["none"], FedConfig(**SMALL), device=deterministic)
    assert gc.isenabled()
    tr.run_block(1)
    assert seen == [True, True, False] and gc.isenabled()


# ---------------------------------------------------------------------------
# the trainer's services: stateful optimizers, resume and tracking under
# the captured round
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("opt,fused", [("momentum", False), ("adam", False),
                                       ("momentum", True), ("adam", True)], ids=str)
def test_graphed_scan_equals_perround_with_stateful_optimizers(deterministic, opt, fused):
    """The optimizer's state rides the captured round in static buffers:
    5 graphed rounds in blocks of 2 equal 5 eager perround rounds in
    parameters and state, bit for bit, so the warm-up rounds advanced no
    state. A stateful optimizer never takes the fused decode-apply: the
    fused round launches the dense sum alone."""
    cfg = FedConfig(server_opt=opt, fused_rounds=fused, scan_block=2, **SMALL)
    entry = "rqm_round_sum_dense" if fused else "rqm_quantize"
    scan = FedTrainer(SPECS["rqm"], cfg, device=deterministic)
    ops.reset_launches()
    scan.run_block(5)
    assert dict(ops.launches) == {f"{entry}_dev": 5}
    per = FedTrainer(SPECS["rqm"], dataclasses.replace(cfg, engine="perround"),
                     device=deterministic)
    ops.reset_launches()
    for _ in range(5):
        per.round()
    assert dict(ops.launches) == {entry: 5}
    assert torch.equal(scan.flat, per.flat)
    assert sorted(scan.opt_state) == sorted(per.opt_state)
    for k, v in scan.opt_state.items():
        assert v.device.type == "cuda" and torch.equal(v, per.opt_state[k]), k
    if opt == "adam":
        assert int(scan.opt_state["t"]) == 5 and scan.opt_state["t"].dtype == torch.int32


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_graphed_resume_equals_uninterrupted(deterministic, tmp_path, opt):
    """A graphed run restored at round 2 equals the uninterrupted 5 rounds;
    so does a restore into a trainer whose round is already captured (the
    block copies the restored state into the graph's buffers)."""
    cfg = FedConfig(server_opt=opt, ckpt_dir=str(tmp_path), ckpt_every=2, **SMALL)
    quiet = dict(eval_every=5, log=lambda msg: None)
    full = FedTrainer(SPECS["rqm"], cfg, device=deterministic)
    full.train(5, **quiet)
    res = FedTrainer(SPECS["rqm"], cfg, device=deterministic)
    for _ in range(2):
        assert res.restore_checkpoint(2) == 2
        res.train(3, **quiet)
        assert res.engine.graph is not None
        assert torch.equal(res.flat, full.flat)
        for k, v in (res.opt_state.items() if opt != "sgd" else ()):
            assert torch.equal(v, full.opt_state[k]), k
        assert res.accountant.rdp_epsilon(8.0) == full.accountant.rdp_epsilon(8.0)
        assert torch.equal(res.generator.get_state(), full.generator.get_state())


@pytest.mark.cuda
def test_noop_tracker_makes_no_sync_in_a_graphed_block(deterministic, tmp_path):
    """Untracked, a graphed block (adam's state included) synchronises
    nowhere; the json tracker's one synchronisation an advance comes after
    the block, and its run is the same run."""
    cfg = FedConfig(server_opt="adam", **SMALL)
    tr = FedTrainer(SPECS["rqm"], cfg, device=deterministic)
    tr.run_block(1)  # the capture
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.run_block(4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    path = tmp_path / "run.json"
    tracked = FedTrainer(SPECS["rqm"], cfg, device=deterministic, tracker=f"json:{path}")
    tracked.run_block(1)
    tracked.run_block(4)
    tracked.tracker.flush()
    assert torch.equal(tracked.flat, tr.flat)
    import json

    doc = json.loads(path.read_text())
    assert [r["round"] for r in doc["rounds"]] == [1, 2, 3, 4, 5]
    assert doc["meta"]["backend"] == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("bits,count", [(b, k) for b in (10, 11) for k in (0, 1, 29, 82)],
                         ids=str)
def test_dev_decode_entries_match_plain(cuda, bits, count):
    """decode_apply_sum_dev and unpack_decode_apply_dev read the realized
    count from device memory: each equals its plain version on the card
    and on the CPU, and the packed equals the dense; at 0 the parameters
    are returned unchanged; at 29 the traced scale differs from the fixed
    cohort's double, so the by-value entry gives other bits."""
    gen = torch.Generator().manual_seed(bits * 100 + count)
    n = 3001
    w = torch.randn(n, generator=gen) * 0.05
    z = torch.randint(0, 82 * 15 + 1 if bits == 11 else 40 * 15 + 1, (n,), generator=gen,
                      dtype=torch.int32)
    words = wire.pack_bits(z, bits)
    k = torch.tensor([count], dtype=torch.int32)
    want = decode_apply_kernel.decode_apply_plain(w, z, PARAMS, k, 0.5)
    ops.reset_launches()
    got = decode_apply_kernel.decode_apply_sum(w.to(cuda), z.to(cuda), PARAMS, k.to(cuda), 0.5)
    got_p = pack_kernel.unpack_decode_apply(w.to(cuda), words.to(cuda), PARAMS, k.to(cuda), 0.5,
                                            pack_bits=bits)
    assert dict(ops.launches) == {"decode_apply_sum_dev": 1, "unpack_decode_apply_dev": 1}
    assert torch.equal(got.cpu(), want) and torch.equal(got_p.cpu(), want)
    assert torch.equal(got, decode_apply_kernel.decode_apply_plain(
        w.to(cuda), z.to(cuda), PARAMS, k.to(cuda), 0.5))
    if count == 0:
        assert torch.equal(want, w)
    else:
        by_value = decode_apply_kernel.decode_apply_sum(w.to(cuda), z.to(cuda), PARAMS, count,
                                                        0.5)
        assert torch.equal(by_value, got) == (count != 29)


@pytest.mark.cuda
@pytest.mark.parametrize("fused,packed", [(False, None), (True, None), (True, False)],
                         ids=["materialized", "fused packed", "fused dense"])
def test_graphed_poisson_round_equals_perround(deterministic, fused, packed):
    """A Poisson cohort with dropout: 4 graphed scan rounds in blocks of 2
    against 4 eager perround rounds: parameters, sums, realized sizes and
    RDP bit for bit; the graph launched the masked _dev round sum or
    quantize and the _dev decode once a round."""
    cfg = FedConfig(collect_sums=True, fused_rounds=fused, wire_packed=packed, scan_block=2,
                    subsampling="poisson", max_cohort=8, dropout=0.2,
                    **{**SMALL, "clients_per_round": 4})
    scan = FedTrainer(SPECS["rqm"], cfg, device=deterministic)
    ops.reset_launches()
    scan.run_block(4)
    counts = dict(ops.launches)
    per = FedTrainer(SPECS["rqm"], dataclasses.replace(cfg, engine="perround"),
                     device=deterministic)
    for _ in range(4):
        per.round()
    if not fused:
        assert counts == {"rqm_quantize_dev": 4}
    elif packed is None:
        assert counts == {"rqm_round_sum_packed_dev": 4, "unpack_decode_apply_dev": 4,
                          "unpack_flat": 4}
    else:
        assert counts == {"rqm_round_sum_dense_dev": 4, "decode_apply_sum_dev": 4}
    assert scan.realized_n == per.realized_n and scan.slate == 8
    assert torch.equal(scan.flat, per.flat)
    for a, b in zip(scan.round_sums, per.round_sums):
        np.testing.assert_array_equal(a, b)
    assert scan.accountant.rdp_epsilon(8.0) == per.accountant.rdp_epsilon(8.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,spec", [
    ("rqm", "rqm:c=0.02,m=16,q=0.42"), ("pbm", "pbm:c=0.02,m=16,theta=0.25"),
    ("qmgeo", "qmgeo:c=0.02,m=16,r=0.6"), ("rqm", "rqm:c=0.02,m=64,q=0.5"),
], ids=["rqm 4 bits", "pbm 5 bits", "qmgeo 4 bits", "rqm 6 bits"])
def test_encode_wire_on_the_card_equals_the_cpu(cuda, name, spec):
    """A client's packed message: the quantize kernel, then pack_flat on
    the card, only the words copied back; == the plain encode and codec on
    the CPU, word for word (QMGeo within QMGEO_CPU_BUDGET of its levels),
    with an int seed and with a 0-d device seed. An odd length packs one
    word a thread (V = 1), an even one with an even word count two (V = 2);
    the card's levels packed by the host's numpy codec are its words."""
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.kernels.prng import seed_bits

    mech = make_mechanism(spec)
    for dim in (30_001, 30_000):
        g = torch.from_numpy(np.random.default_rng(8).normal(0, 0.02, dim).astype(np.float32))
        want = mech.encode_wire(g, SEED)
        for seed, dev in ((SEED, ""), (torch.tensor(seed_bits(SEED), dtype=torch.int32,
                                                    device=cuda), "_dev")):
            ops.reset_launches()
            got = mech.encode_wire(g.to(cuda), seed)
            assert dict(ops.launches) == {f"{name}_quantize{dev}": 1, "pack_flat": 1}
            assert isinstance(got, wire.PackedPayload) and isinstance(got.words, np.ndarray)
            assert (got.bits, got.length) == (want.bits, want.length) == (mech.payload_bits, dim)
            levels = mech.quantize(g.to(cuda), seed).reshape(-1).cpu().numpy()
            np.testing.assert_array_equal(got.words, wire.pack_bits_np(levels, got.bits))
            if name == "qmgeo":
                diff = got.unpack() - want.unpack()
                assert np.abs(diff).max() <= 1
                assert np.count_nonzero(diff) <= math.ceil(QMGEO_CPU_BUDGET * diff.size)
            else:
                np.testing.assert_array_equal(got.words, want.words)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 16])
def test_aggregator_intake_on_the_card_equals_the_cpu(cuda, bits):
    """The aggregator's SecAgg sum on the card: packed payloads unpacked
    at intake (unpack_flat once a packed payload) and the packed-direct
    word sum (unpack_flat once a round), at 4 bits and at 16 bits with the
    top field across the sign bit; == the server on the CPU (plain codec),
    sums and (at 4 bits, served) parameters bit for bit. A server asked
    for ``cuda`` keeps the index of the card current at construction."""
    import dataclasses as dc

    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.fed.updates import ClientUpdate
    from repro_torch.launch.aggregator import AggregatorServer

    m = 16 if bits == 4 else 32768  # 16 bits: two clients of 32767 fill a field
    mech = make_mechanism(f"rqm:c=0.02,m={m},q=0.42")
    direct_cohort = 1 if bits == 4 else 2
    rng = np.random.default_rng(bits)
    for dim in (30_001, 30_000):  # the codec's walk at V = 1 and V = 2
        for cohort, unpacks in ((direct_cohort, 1), (direct_cohort + 2, direct_cohort + 2)):
            rows = rng.integers(0, m, (2 * cohort, dim)).astype(np.int32)
            rows[:, :64] = m - 1  # at 16 bits the first cohort's sum fills the top field
            # the second cohort's last client is late (weight 0)
            take = [ClientUpdate(payload=wire.PackedPayload.pack(z, bits),
                                 weight=int(i != 2 * cohort - 1)) for i, z in enumerate(rows)]
            servers = [AggregatorServer(mech, dim, cohort=cohort, device=d)
                       for d in (cuda, "cpu")]
            card, cpu = servers
            # the index pinned, so the service thread's guard names this card
            assert card.device == torch.device("cuda", torch.cuda.current_device())
            for srv in servers:
                srv.submit(take)
            for part in (slice(0, cohort), slice(cohort, 2 * cohort)):
                ops.reset_launches()
                z_card = card._secure_sum(take[part])
                assert dict(ops.launches) == {"unpack_flat": unpacks}
                z_cpu = cpu._secure_sum(take[part])
                assert z_card.is_cuda and torch.equal(z_card.cpu(), z_cpu)
                weights = np.asarray([u.weight for u in take[part]])
                np.testing.assert_array_equal(z_cpu.numpy(),
                                              (rows[part] * weights[:, None]).sum(0))
                dense = [dc.replace(u, payload=u.payload_array()) for u in take[part]]
                assert torch.equal(card._secure_sum(dense), z_card)
            if bits == 16:
                continue  # m = 32768's exact accounting is no concern of this test
            for srv in servers:
                assert srv.drain() == 2
            assert torch.equal(card.flat.cpu(), cpu.flat)
            assert card.realized_n == cpu.realized_n


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["materialized", "fused dense"])
def test_async_engine_on_the_card(deterministic, fused):
    """The async engine off its plain corner (stale versions, late
    clients): materialized == fused dense bit for bit, one quantize or
    dense round-sum launch an aggregation, nothing else; the plain corner
    == eager perround."""
    cfg = FedConfig(engine="async:max_staleness=2,staleness_weight=poly:0.5,timeout=1.0",
                    collect_sums=True, **SMALL)
    runs = {}
    for f in (False, True):
        tr = FedTrainer(SPECS["rqm"], dataclasses.replace(cfg, fused_rounds=f),
                        device=deterministic)
        ops.reset_launches()
        for _ in range(4):
            tr.round()
        assert dict(ops.launches) == ({"rqm_round_sum_dense": 4} if f else {"rqm_quantize": 4})
        runs[f] = tr
    a, b = runs[False], runs[True]
    assert a.realized_n == b.realized_n and min(a.realized_n) < 6
    assert torch.equal(a.flat, b.flat) and torch.equal(a.engine.hist, b.engine.hist)
    for x, y in zip(a.round_sums, b.round_sums):
        np.testing.assert_array_equal(x, y)
    plain = FedTrainer(SPECS["rqm"], dataclasses.replace(cfg, engine="async", fused_rounds=fused),
                       device=deterministic)
    per = FedTrainer(SPECS["rqm"], dataclasses.replace(cfg, engine="perround",
                                                       fused_rounds=fused),
                     device=deterministic)
    for _ in range(3):
        plain.round()
        per.round()
    assert torch.equal(plain.flat, per.flat)


LM_FED = dict(num_clients=8, clients_per_round=4, samples_per_client=8)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b", "phi3.5-moe-42b-a6.6b",
                                  "gemma3-4b", "pixtral-12b"])
@pytest.mark.parametrize("fused", [False, True], ids=["materialized", "fused packed"])
def test_lm_graphed_round_equals_perround(deterministic, arch, fused):
    """The lm task (ssm, hybrid with the shared block, moe, windowed and
    prefixed reduced configs): 3 graphed scan rounds == 3 eager perround
    rounds, parameters and sums bit for bit, one quantize (or round-sum,
    unpack + decode-apply and, keeping sums, unpack) launch a round."""
    cfg = FedConfig(task=f"lm:model={arch},seq_len=32,batch=1", collect_sums=True,
                    fused_rounds=fused, **LM_FED)
    scan = FedTrainer(SPECS["rqm"], cfg, device=deterministic)
    ops.reset_launches()
    scan.run_block(3)
    counts = dict(ops.launches)
    per = FedTrainer(SPECS["rqm"], dataclasses.replace(cfg, engine="perround"),
                     device=deterministic)
    for _ in range(3):
        per.round()
    assert counts == ({"rqm_round_sum_packed_dev": 3, "unpack_decode_apply": 3,
                       "unpack_flat": 3} if fused else {"rqm_quantize_dev": 3})
    assert torch.equal(scan.flat, per.flat)
    for a, b in zip(scan.round_sums, per.round_sums):
        np.testing.assert_array_equal(a, b)
    ev = scan.evaluate()
    assert math.isfinite(ev["loss"]) and ev["ppl"] > 1.0


@pytest.mark.cuda
def test_lm_loss_on_the_card_matches_the_cpu(deterministic):
    """Every reduced config's loss and gradient on the card from the CPU's
    parameters, within the tolerances the CPU holds against the JAX
    reference (tests/test_torch_lm_model.py)."""
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.convert import ravel
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.models import model
    from repro_torch.models.common import ParallelCtx

    for arch in ARCH_IDS:
        cfg = get_config(arch, reduced=True)
        flat, unravel = ravel(model.init_params(torch.Generator().manual_seed(1), cfg,
                                                device="cpu"))
        batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(cfg, 64, 2).batch(0).items()}

        def loss(f, b, unravel=unravel, cfg=cfg):
            return model.loss_fn(unravel(f), cfg, ParallelCtx(), b)[0]

        g_cpu, l_cpu = torch.func.grad_and_value(loss)(flat, batch)
        flat_d, unravel_d = ravel(model.init_params(torch.Generator().manual_seed(1), cfg,
                                                    device=deterministic))
        assert torch.equal(flat_d.cpu(), flat)
        g, value = torch.func.grad_and_value(
            lambda f, b: model.loss_fn(unravel_d(f), cfg, ParallelCtx(), b)[0])(
            flat_d, {k: v.to(deterministic) for k, v in batch.items()})
        assert abs(float(value) - float(l_cpu)) <= 2e-6 * abs(float(l_cpu)), arch
        assert float((g.cpu() - g_cpu).abs().max()) <= 1e-5 * float(g_cpu.abs().max()), arch


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3001,), (4, 5, 7)], ids=["1d", "3d"])
@pytest.mark.parametrize("name", list(QUANTIZE))
def test_single_leaf_entries_on_the_card(cuda, name, shape):
    """``ops.<name>_fast`` on a leaf launches its quantize kernel once and
    equals the plain version (the CPU wrapper), ``<name>_batch`` row 0
    and, for rqm, the ``ref.rqm_ref`` oracle, bit for bit (QMGeo against
    the CPU within its budget)."""
    from repro_torch.kernels import ref

    params = QUANTIZE[name][0]
    x = np.random.default_rng(7).uniform(-0.026, 0.026, size=shape).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda)
    ops.reset_launches()
    got = getattr(ops, f"{name}_fast")(xt, SEED, params)
    torch.cuda.synchronize()
    assert dict(ops.launches) == {f"{name}_quantize": 1}
    assert got.shape == shape and got.is_cuda
    row = getattr(ops, f"{name}_batch")(xt.reshape(1, -1), SEED, params)[0]
    assert torch.equal(got.reshape(-1), row)
    plain = QUANTIZE[name][2](xt.reshape(1, -1), SEED, params)[0]
    assert torch.equal(got.reshape(-1), plain)
    cpu = getattr(ops, f"{name}_fast")(torch.from_numpy(x), SEED, params)
    diff = (got.cpu() - cpu).abs()
    if name == "qmgeo":
        assert int(diff.max()) <= 1
        assert int((diff != 0).sum()) <= math.ceil(QMGEO_CPU_BUDGET * diff.numel())
    else:
        assert torch.equal(got.cpu(), cpu)
    if name == "rqm":
        assert torch.equal(got.reshape(-1), ref.rqm_ref(xt.reshape(-1), SEED, params))


@pytest.mark.cuda
def test_rqm_tree_on_the_card(cuda):
    """``ops.rqm_tree`` over the CNN's parameter tree: one rqm_quantize a
    leaf, each leaf == rqm_fast with its seed and == the CPU's."""
    from repro_torch.convert import leaves
    from repro_torch.fed.cnn import cnn_init

    tree = cnn_init(torch.Generator().manual_seed(3), device=cuda)
    seeds = [SEED + 17 * i for i in range(len(leaves(tree)))]
    ops.reset_launches()
    out = ops.rqm_tree(tree, seeds, PARAMS)
    torch.cuda.synchronize()
    assert dict(ops.launches) == {"rqm_quantize": len(seeds)}
    cpu = ops.rqm_tree({k: v.cpu() for k, v in tree.items()}, seeds, PARAMS)
    for leaf, seed, got, want in zip(leaves(tree), seeds, leaves(out), leaves(cpu)):
        assert torch.equal(got, ops.rqm_fast(leaf, seed, PARAMS))
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-4b", "zamba2-1.2b", "qwen3-moe-30b-a3b"])
def test_reduced_serve_on_the_card(deterministic, arch):
    """A reduced config served on the card (prompt 96, longer than gemma3's
    window of 64) from the CPU's parameters: the same greedy tokens as on
    the CPU for prefill and 4 decode steps; prefill == the forward's
    argmax and the first decoded token == the teacher-forced one."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import generate, synthetic_prompt
    from repro_torch.models import model
    from repro_torch.models.common import ParallelCtx, rms_norm

    cfg = get_config(arch, reduced=True)
    if cfg.moe is not None:  # no token dropped by the forward either
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    params = model.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks, pe = synthetic_prompt(cfg, 2, 96, torch.Generator().manual_seed(1), "cpu")
    want = generate(params, cfg, toks, 5, pe)[0]
    params_d = model.init_params(torch.Generator().manual_seed(0), cfg, device=deterministic)
    got = generate(params_d, cfg, toks.to(deterministic), 5,
                   None if pe is None else pe.to(deterministic))[0]
    assert torch.equal(got.cpu(), want)
    seq = torch.cat([toks, want[:, :1]], 1).to(deterministic)
    h, _ = model.forward_hidden(params_d, cfg, ParallelCtx(), seq,
                                None if pe is None else pe.to(deterministic))
    h = rms_norm(h, params_d["final_norm"])
    assert torch.equal(model.lm_head_argmax(params_d, ParallelCtx(), h[:, -2]).cpu(), want[:, 0])
    assert torch.equal(model.lm_head_argmax(params_d, ParallelCtx(), h[:, -1]).cpu(), want[:, 1])


@pytest.mark.cuda
def test_model_axis_collectives_on_a_one_rank_gloo_group(cuda):
    """The model axis's autograd Functions (``models/common.py``) on CUDA
    tensors over a one-rank gloo group: forward and backward the identity
    (a sum, gather or scatter of one), on the card, no copy to the CPU in
    what they return."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import shard_group
    from repro_torch.models import common

    shard_group(None, "cuda")  # a default group, made once if none exists
    group = dist.new_group([dist.get_rank()], backend="gloo")
    x = torch.randn(2, 4, 3, device="cuda", requires_grad=True)
    ct = torch.randn(2, 4, 3, device="cuda")
    for name, y in (("psum", common._Psum.apply(x, group)),
                    ("all_gather", common._AllGather.apply(x, group, 1, 1)),
                    ("psum_scatter", common._PsumScatter.apply(x, group, 1, 1))):
        assert y.is_cuda and torch.equal(y, x), name
        g = torch.autograd.grad(y, x, ct)[0]
        assert g.is_cuda and torch.equal(g, ct), name


@pytest.mark.cuda
def test_model_axis_collectives_on_two_gloo_ranks(cuda, tmp_path):
    """Two gloo ranks on the card (tests/torch_tp_worker.py ``cuda_ops``):
    each collective of a tp = 2 ``ParallelCtx`` and its backward on CUDA
    tensors, equal bit for bit to the same sums made on the CPU from both
    ranks' inputs (a sum of two is exact in either order)."""
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([os.path.join(os.path.dirname(here),
                                                                      "src"), here])}
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "torch_tp_worker.py"),
                               "cuda_ops", str(r), "2", str(tmp_path / "store"), "none",
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "collectives on cuda == their CPU sums" in out, out
