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
import numpy as np
import pytest
import torch

from repro_torch.core import wire
from repro_torch.core.grid import RQMParams
from repro_torch.fed import rounds
from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer
from repro_torch.kernels import decode_apply_kernel, fused_round_kernel, ops, pack_kernel

PARAMS = RQMParams(c=0.02, delta=0.02, m=16, q=0.42)
SEED, ROW_OFFSET = 2216260512, 3


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
    tr = FedTrainer("rqm:c=0.05", FedConfig(**small), device=cuda)
    ops.reset_launches()
    tr.train(rounds=2, eval_every=2, log=lambda msg: None)
    assert dict(ops.launches) == {"rqm_round_sum_packed": 2, "unpack_decode_apply": 2}
    assert torch.isfinite(tr.flat).all()
    ids = torch.arange(6)
    grads = tr.client_grads(tr.flat, rounds.index_batch(tr.client_data, ids.to(cuda)))
    new = {}
    for packed in (None, False):
        cfg = FedConfig(wire_packed=packed, **small)
        step = rounds.make_round_step(tr.mech, cfg, tr.slate, lambda flat, batch: grads)
        new[packed], _ = step(tr.flat, tr.client_data, ids=ids, seed=SEED)
    assert torch.equal(new[None], new[False])
