"""The public names the port shares with the reference, against the
reference's values on the CPU: ``repro_torch.core`` exports every name
of ``repro.core.__all__`` (the mechanism factories, ``encode_value``);
``core/renyi.py``'s ``rqm_pairwise_divergence`` and
``aggregate_renyi_divergence``; ``configs/registry.all_configs``;
``fed/tasks.tree_nbytes``; and ``examples/quickstart_torch.py`` on
``--device cpu``.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import contextlib
import io
import math
import os
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as core
from conftest import SMALL_FED
from repro.configs import registry as jregistry
from repro.core import renyi as jrenyi
from repro.core.distribution import pbm_outcome_distribution as jpbm_pmf
from repro.fed.config import FedConfig as JaxFedConfig
from repro.fed.tasks import make_task as jmake_task
from repro.fed.tasks import tree_nbytes as jtree_nbytes
from repro_torch.configs import registry
from repro_torch.core import renyi
from repro_torch.core.distribution import pbm_outcome_distribution, rqm_outcome_distribution
from repro_torch.fed.config import FedConfig
from repro_torch.fed.tasks import make_task, tree_nbytes

QUICKSTART = os.path.join(os.path.dirname(__file__), "..", "examples", "quickstart_torch.py")
RQM = [(1.5, 1.5, 16, 0.42), (1.5, 3.0, 16, 0.57), (1.0, 0.25, 8, 0.37)]


def test_core_exports_the_reference_names():
    assert list(core.__all__) == list(jcore.__all__)
    for name in jcore.__all__:
        assert hasattr(core, name), name


@pytest.mark.parametrize("c,delta,m,q", RQM)
def test_mechanism_factories_and_encode_value(c, delta, m, q):
    jp, p = jcore.RQMParams(c, delta, m, q), core.RQMParams(c, delta, m, q)
    assert p.epsilon_infinity() == jp.epsilon_infinity()
    pairs = [(core.make_rqm_mechanism(p), jcore.make_rqm_mechanism(jp)),
             (core.make_pbm_mechanism(core.PBMParams(c=c, m=m, theta=0.25)),
              jcore.make_pbm_mechanism(jcore.PBMParams(c=c, m=m, theta=0.25))),
             (core.make_qmgeo_mechanism(core.QMGeoParams(c=c, delta=delta, m=m, r=0.6)),
              jcore.make_qmgeo_mechanism(jcore.QMGeoParams(c=c, delta=delta, m=m, r=0.6))),
             (core.make_noise_free_mechanism(c), jcore.make_noise_free_mechanism(c))]
    for mine, ref in pairs:
        assert mine.describe() == ref.describe()
        assert mine.per_round_epsilon(8, 8.0) == ref.per_round_epsilon(8, 8.0)
    z = np.arange(m, dtype=np.int32)
    got = core.encode_value(torch.from_numpy(z), p)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcore.encode_value(jnp.asarray(z), jp)))


@pytest.mark.parametrize("c,delta,m,q", RQM)
def test_rqm_pairwise_divergence(c, delta, m, q):
    jp, p = jcore.RQMParams(c, delta, m, q), core.RQMParams(c, delta, m, q)
    for alpha in (2.0, 8.0, 32.0, math.inf):
        for x, xp in ((c, -c), (0.3 * c, -0.7 * c)):
            got = renyi.rqm_pairwise_divergence(x, xp, p, alpha)
            assert got == jrenyi.rqm_pairwise_divergence(x, xp, jp, alpha), (alpha, x, xp)
    assert renyi.rqm_pairwise_divergence(c, -c, p, math.inf) <= p.epsilon_infinity() + 1e-9


@pytest.mark.parametrize("n", [1, 5, 12])
def test_aggregate_renyi_divergence(n):
    jp, p = jcore.PBMParams(c=1.0, m=16, theta=0.25), core.PBMParams(c=1.0, m=16, theta=0.25)
    x, xp = renyi.worst_case_inputs(p.c, n, seed=2)
    for alpha in (2.0, 16.0):
        got = renyi.aggregate_renyi_divergence(
            lambda v: pbm_outcome_distribution(v, p.c, p.m, p.theta), x, xp, alpha)
        want = jrenyi.aggregate_renyi_divergence(
            lambda v: jpbm_pmf(v, jp.c, jp.m, jp.theta), x, xp, alpha)
        assert got == want
    # the accountant's epsilon is this divergence at the worst-case inputs
    rp = core.RQMParams(c=0.02, delta=0.02, m=16, q=0.42)
    x, xp = renyi.worst_case_inputs(rp.c, n)
    assert renyi.aggregate_renyi_divergence(lambda v: rqm_outcome_distribution(v, rp), x, xp,
                                            8.0) == renyi.rqm_aggregate_epsilon(rp, n, 8.0)


@pytest.mark.parametrize("reduced", [False, True])
def test_all_configs_in_the_reference_order(reduced):
    got, want = registry.all_configs(reduced), jregistry.all_configs(reduced)
    assert list(got) == list(want) == list(registry.ARCH_IDS)
    for arch, cfg in got.items():
        ref = want[arch]
        for field in ("name", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
                      "vocab_size"):
            assert getattr(cfg, field) == getattr(ref, field), (arch, field)
        assert [(ly.kind, ly.window) for ly in cfg.layers] == \
            [(ly.kind, ly.window) for ly in ref.layers], arch


def test_tree_nbytes():
    s = SMALL_FED["samples_per_client"]
    got = make_task("emnist_cnn", FedConfig(**SMALL_FED), device="cpu").client_batch(0)
    want = jmake_task("emnist_cnn", JaxFedConfig(**SMALL_FED)).client_batch(0)
    assert tree_nbytes(got) == jtree_nbytes(want) == s * (28 * 28 * 4 + 4)
    tree = {"a": (torch.zeros(3, 5), np.zeros(7, np.int8)),
            "b": [torch.zeros(2, dtype=torch.int64)]}
    assert tree_nbytes(tree) == 3 * 5 * 4 + 7 + 2 * 8
    assert tree_nbytes({}) == jtree_nbytes({}) == 0


def test_quickstart_torch_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = runpy.run_path(QUICKSTART)["main"](["--device", "cpu"])
    text = buf.getvalue()
    assert "eps_inf <= 9.01" in text and "registered mechanisms: rqm, pbm, qmgeo, none" in text
    levels = res["levels"]
    assert levels.dtype == torch.int32 and int(levels.min()) >= 0 and int(levels.max()) <= 15
    assert res["decode_err"] < 0.2
    params = core.RQMParams(c=1.0, delta=1.0, m=16, q=0.42)
    for alpha, (e_rqm, e_pbm) in res["eps"].items():
        assert e_rqm == renyi.rqm_aggregate_epsilon(params, 40, alpha) < e_pbm
