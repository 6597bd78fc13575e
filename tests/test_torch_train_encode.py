"""The distributed LM train step's aggregation (``distributed/step.py:
encode_aggregate_decode``) against the JAX reference on the CPU, at
tp = 1:

  * on the reference's gradient tree of a reduced mamba2-370m, at the
    reference's folded per-leaf seeds (``key_to_seed(fold_in(fold_in(key,
    leaf), 0))``: its leaf and model-shard folds), for rqm and none in
    one process: each leaf's levels equal the reference's
    encode run op by op bit for bit (QMGeo within ``QMGEO_BUDGET``,
    ROADMAP C4), and the decoded tree the reference's within 1 ulp;
    (pbm and qmgeo, and four clients' sums: tests/test_torch_train_encode_pbm.py);
  * a consumed list of leaves decodes as the tree does and drops its
    entries; without client axes ``packed`` moves nothing; a seed count
    that is not the leaf count is refused.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import mechanisms as jmechs
from repro.data.lm import TokenPipeline as JaxTokenPipeline
from repro.distributed import step as jstep
from repro.kernels import ops as jops
from repro.models import model as jmodel
from repro.models.common import ParallelCtx as JaxParallelCtx
from repro_torch.configs import registry
from repro_torch.convert import leaves, map_leaves, tree_from_numpy
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.distributed import step as tstep
from repro_torch.models import model
from repro_torch.models.meta import Meta
from repro_torch.models.common import ParallelCtx
from test_torch_quantize import QMGEO_BUDGET

ARCH = "mamba2-370m"
SEQ, BATCH = 32, 2
SPECS = {"rqm": "rqm:c=0.02,m=16,q=0.42", "pbm": "pbm:c=0.02,m=16,theta=0.25",
         "qmgeo": "qmgeo:c=0.02,m=16,r=0.6", "none": "none:c=0.02"}
CLIENT_LEAVES, CLIENT_LEAF = 3, 4096


def ulps(a, b) -> np.ndarray:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def leaf_keys(key, n_leaves: int) -> list:
    """The reference's per-leaf keys at tp = 1 (``step.py:141-142``)."""
    return [jax.random.fold_in(jax.random.fold_in(key, i), 0) for i in range(n_leaves)]


def leaf_seeds(key, n_leaves: int) -> list:
    """The kernel seeds the reference's encode derives from those keys."""
    return [int(np.asarray(jops.key_to_seed(k))) for k in leaf_keys(key, n_leaves)]


def _levels_equal(name, got, want):
    got, want = np.asarray(got).astype(np.int64), np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    if name != "qmgeo":
        np.testing.assert_array_equal(got, want)
        return
    diff = np.abs(got - want)
    assert diff.max(initial=0) <= 1
    assert np.count_nonzero(diff) <= math.ceil(QMGEO_BUDGET * diff.size)


class Recording:
    """A mechanism whose ``quantize`` keeps each leaf's levels."""

    def __init__(self, mech):
        self.mech, self.levels = mech, []

    def __getattr__(self, name):
        return getattr(self.mech, name)

    def quantize(self, g, key):
        z = self.mech.quantize(g, key)
        self.levels.append(np.asarray(z))
        return z


@pytest.fixture(scope="module")
def ref():
    """A reduced mamba2-370m: the reference's gradient tree of one batch
    (jitted), as numpy, and its Meta tree."""
    jcfg = jregistry.get_config(ARCH, reduced=True)
    jparams = jax.jit(lambda k: jmodel.init_params(k, jcfg))(jax.random.key(7))
    batch = {k: jnp.asarray(v) for k, v in
             JaxTokenPipeline(jcfg, SEQ, BATCH, seed=3).batch(5).items()}
    grads = jax.jit(jax.grad(lambda p: jmodel.loss_fn(
        p, jcfg, JaxParallelCtx(), batch, remat=False, compute_dtype=jnp.float32)[0]))(jparams)
    return {"grads": jax.device_get(grads), "jmeta": jmodel.param_meta(jcfg, tp=1),
            "meta": model.param_meta(registry.get_config(ARCH, reduced=True))}


def check_encode_aggregate_decode(ref, name: str) -> None:
    jmech = Recording(jmechs.make_mechanism(SPECS[name]))
    mech = Recording(make_mechanism(SPECS[name]))
    key = jax.random.key(21)
    n = len(jax.tree_util.tree_leaves(ref["grads"]))
    with jax.disable_jit():  # op by op: no contraction into FMAs (ROADMAP C6)
        want = jstep.encode_aggregate_decode(ref["grads"], ref["jmeta"], jmech,
                                             JaxParallelCtx(), key)
    got = tstep.encode_aggregate_decode(list(leaves(tree_from_numpy(ref["grads"], "cpu"))),
                                        ref["meta"], mech, ParallelCtx(), leaf_seeds(key, n))
    assert len(mech.levels) == len(jmech.levels) == n
    for z, w in zip(mech.levels, jmech.levels):
        if name == "none":  # the clipped floats
            np.testing.assert_array_equal(z, w)
        else:
            assert z.dtype == np.int32
            _levels_equal(name, z, w)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got) == n
    for g, w, z, zw in zip(got, want_leaves, mech.levels, jmech.levels):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        same = np.asarray(z) == np.asarray(zw)  # QMGeo: a moved level moves its value
        assert ulps(g.numpy()[same], np.asarray(w)[same]).max(initial=0) <= 1


@pytest.mark.parametrize("name", ["rqm", "none"])
def test_encode_aggregate_decode_matches_reference(ref, name):
    check_encode_aggregate_decode(ref, name)


def client_trees(n_clients: int) -> list:
    """Each client's gradient tree: CLIENT_LEAVES leaves of CLIENT_LEAF
    coordinates (one shape, and few leaves: the op-by-op reference
    compiles each of its operations once a shape, and dispatches some 600
    operations an encode)."""
    rng = np.random.default_rng(11)
    return [[rng.normal(0, 0.015, CLIENT_LEAF).astype(np.float32)
             for _ in range(CLIENT_LEAVES)] for _ in range(n_clients)]


@pytest.mark.parametrize("name", ["rqm", "none"])
def test_consumed_list_and_refusals(name):
    mech = make_mechanism(SPECS[name])
    leaf = Meta((CLIENT_LEAF,), torch.float32, (None,), 1)
    meta_tree = {"a": leaf, "b": (leaf, {"c": leaf})}
    tree = map_leaves(lambda i, m: torch.from_numpy(
        np.random.default_rng(i).normal(0, 0.015, m.shape).astype(np.float32)), meta_tree)
    seeds = [7, 8, 9]
    as_list = list(leaves(tree))
    got = tstep.encode_aggregate_decode(as_list, meta_tree, mech, ParallelCtx(), seeds)
    assert all(x is None for x in as_list)  # consumed, leaf by leaf
    assert [tuple(g.shape) for g in got] == [m.shape for m in leaves(meta_tree)]
    again = tstep.encode_aggregate_decode(list(leaves(tree)), meta_tree, mech, ParallelCtx(),
                                          seeds)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    packed = tstep.encode_aggregate_decode(list(leaves(tree)), meta_tree, mech, ParallelCtx(),
                                           seeds, packed=True)
    assert all(torch.equal(a, b) for a, b in zip(packed, got))
    with pytest.raises(ValueError, match="seeds"):
        tstep.encode_aggregate_decode(list(leaves(tree)), meta_tree, mech, ParallelCtx(),
                                      seeds[:-1])
