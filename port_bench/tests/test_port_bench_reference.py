"""The benchmark's plain reference against the program at small sizes on
the CPU: the same inputs re-derived from the seed, the same levels, and
the same parameters after the first rounds and steps."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from small_cells import bench, small

from reference import cohort, emnist, mamba2, rqm

SEEDS = (0, 7, 2**31 + 5)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("row_offset", (0, 3))
def test_rqm_levels_equal_the_program(seed, row_offset):
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.kernels.rqm_kernel import rqm_quantize_plain

    mech = make_mechanism("rqm:c=0.02,m=16,q=0.42")
    p = rqm.RQM(c=0.02, delta=0.02, m=16, q=0.42)
    x = torch.randn((5, 2000), generator=torch.Generator().manual_seed(seed % 1000)) * 0.03
    want = rqm_quantize_plain(x, seed % (1 << 32), mech.params, row_offset=row_offset)
    rows = range(row_offset, row_offset + x.shape[0])
    assert torch.equal(rqm.encode_rows(x, seed % (1 << 32), p, rows), want)


@pytest.mark.parametrize("n", (1, 7, 40, 83))
@pytest.mark.parametrize("device_count", (False, True))
def test_decode_equals_the_program_and_inverts(n, device_count):
    from repro_torch.core.grid import decode_sum
    from repro_torch.core.mechanisms import make_mechanism

    params = make_mechanism("rqm:c=0.02,m=16,q=0.42").params
    p = rqm.RQM(c=0.02, delta=0.02, m=16, q=0.42)
    z = torch.randint(0, 15 * n + 1, (3000,), generator=torch.Generator().manual_seed(n))
    count = torch.tensor(n, dtype=torch.int32) if device_count else n
    want = decode_sum(z.to(torch.int32), count, params)
    got = rqm.decode(z, n, p, device_count)
    assert torch.equal(got, want)
    assert torch.equal(rqm.levels_of(got, n, p, device_count), z)


@pytest.mark.parametrize("seed", SEEDS)
def test_emnist_inputs_are_the_programs(seed):
    from repro_torch.convert import ravel
    from repro_torch.data.federated import FederatedPartition
    from repro_torch.fed.cnn import cnn_init

    part = FederatedPartition(num_clients=30, samples_per_client=5, seed=seed)
    pop = emnist.Population(seed, 30, 5, 0.35, 0.25)
    for cid in (0, 17, 29):
        im, lb = part.client_data(cid)
        im2, lb2 = pop.client(cid)
        assert np.array_equal(im, im2) and np.array_equal(lb, lb2)
    flat, _ = ravel(cnn_init(torch.Generator().manual_seed(seed), device="cpu"))
    assert torch.equal(emnist.flatten(emnist.init(seed)), flat)


@pytest.mark.parametrize("subsampling,dropout", [("fixed", 0.0), ("poisson", 0.1),
                                                 ("poisson", 0.0), ("fixed", 0.3)])
def test_round_stream_is_the_programs(subsampling, dropout):
    from repro_torch.fed import cohort as prog
    from repro_torch.fed.config import FedConfig

    cfg = FedConfig(num_clients=200, clients_per_round=10, subsampling=subsampling,
                    dropout=dropout, seed=11)
    slate = prog.base_slate(cfg)
    g = torch.Generator().manual_seed(cfg.seed + 11)
    stream = cohort.Stream(cfg.seed, 200, 10, subsampling, dropout)
    assert stream.slate == slate
    for _ in range(5):
        ids, seed, part = prog.draw_round(cfg, slate, g)
        ids2, seed2, part2 = stream.next()
        assert torch.equal(ids, ids2) and seed == seed2
        assert torch.equal(torch.ones(slate, dtype=torch.int32) if part is None else part,
                           part2.to(torch.int32))


@pytest.mark.parametrize("name", ["cnn-fixed40", "cnn-poisson40-packed"])
def test_fl_reference_follows_the_programs_rounds(name):
    c = small(name)
    drv = bench.driver("fl_rounds")
    got = drv.sound(c, 2**31 + 1, "cpu")
    assert got["level_mismatch"] == 0.0 and got["counts_mismatch"] == 0.0
    assert bench.verdict(got, c.limits)[0]


def test_mamba2_loss_and_gradient_match_the_program():
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model
    from repro_torch.models.common import ParallelCtx

    c = small("mamba2-train-8x1024")
    tree, _ = mamba2.make_weights(3, c.config, "cpu")
    toks = bench.driver("lm_train").token_batches(3, c.config, c.traffic)[0]
    tokens, labels = torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:])
    loss, grads = mamba2.loss_and_grads(tree, c.config, tokens, labels, rows_per_block=1)
    leaves = [t.detach().clone().requires_grad_() for t in mamba2.leaves(tree)]
    from repro_torch.convert import map_leaves

    prog_tree = map_leaves(lambda i, _: leaves[i], tree)
    want, _ = model.loss_fn(prog_tree, get_config("mamba2-370m", reduced=True), ParallelCtx(),
                            {"tokens": tokens, "labels": labels}, remat=False,
                            compute_dtype=torch.float32)
    want_grads = torch.autograd.grad(want, leaves)
    assert loss == pytest.approx(float(want), rel=1e-6)
    for g, w in zip(grads, want_grads):
        assert torch.allclose(g, w, rtol=1e-4, atol=1e-7)


def test_lm_reference_follows_the_programs_steps():
    c = small("mamba2-train-8x1024")
    got = bench.driver("lm_train").sound(c, 2**31 + 2, "cpu")
    assert got["level_mismatch"] < 1e-5 and got["loss_gap"] < 1e-6
    assert bench.verdict(got, c.limits)[0]
