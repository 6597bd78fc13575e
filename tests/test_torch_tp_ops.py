"""The port's model axis against the JAX reference on the CPU, below the
layers:

  * ``ParallelCtx``'s model-axis collectives and their backwards
    (``pmax_model``, ``model_index``, ``subgroup_psum``, ``psum_model``,
    ``sp_gather``, ``sp_scatter`` with and without sequence parallelism,
    ``sp_slice``; the backward through ``torch.autograd.grad`` with a
    cotangent a rank) on gloo ranks against the reference's shard_map and
    ``jax.vjp`` on four fake devices (tests/tp_harness.py): bit for bit
    at tp = 2, where a sum of two is exact in either order; at tp = 4
    ``subgroup_psum`` (the reference's recursive doubling) and every op
    that moves values without adding them bit for bit, and the 4-way sums
    (psum, psum_scatter and their transposes) within ``SUM4_RTOL`` of the
    largest value (gloo adds in its own order, XLA in its own);
  * every reduced config's ``param_meta`` at tp = 2 and 4 == the
    reference's (global shape, partition spec, sync group), the port's
    ``init_params(..., tp)`` of those shapes with its duplicated slices
    equal, and ``meta.slicer`` (a rank's slice kept as each leaf is drawn)
    == the slices of the global draw, bit for bit;
  * ``train_seeds`` at shard index 0 == the words of a plan without a
    model axis; ``shard_seed_indices`` == the reference's
    ``_shard_seed_index`` rule.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import numpy as np
import pytest
import torch

import tp_cases
import tp_harness
from repro.configs import registry as jregistry
from repro.models import meta as jmeta
from repro.models import model as jmodel
from repro_torch.configs import registry
from repro_torch.convert import leaves
from repro_torch.distributed.step import shard_seed_indices, train_seeds
from repro_torch.models import meta as meta_lib
from repro_torch.models import model
from repro_torch.models.common import ParallelCtx

SUM4_RTOL = 1e-6
EXACT = ("pmax_model", "model_index", "subgroup_psum_2", "subgroup_psum_4", "sp_gather",
         "sp_slice", "sp_slice_vjp")
OPS = ["pmax_model", "model_index", "subgroup_psum_2", "psum_model", "psum_model_vjp",
       "sp_gather", "sp_gather_vjp", "sp_scatter", "sp_scatter_vjp", "sp_scatter_off",
       "sp_scatter_off_vjp", "sp_slice", "sp_slice_vjp"]


def _ops_inputs() -> dict:
    out = {}
    for name, c in tp_cases.OPS.items():
        rng = np.random.default_rng(5 + c["tp"])
        tp, B, S, D = c["tp"], c["B"], c["S"], c["D"]

        def draw(*shape):
            return rng.normal(size=(tp,) + shape).astype(np.float32)
        out[f"{name}/x"] = draw(B, S, D)
        out[f"{name}/x"][0, 0, 0, 0] = -0.0  # the sign of zero through every op
        out[f"{name}/c_same"] = draw(B, S, D)
        out[f"{name}/c_gather"] = draw(B, S * tp, D)
        out[f"{name}/c_scatter"] = draw(B, S // tp, D)
    return out


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ops")
    src = tmp / "inputs.npz"
    np.savez(src, **_ops_inputs())
    procs = [tp_harness.reference("ops", src, tmp / "ref.npz")]
    procs += tp_harness.ranks("ops", 2, tmp, src) + tp_harness.ranks("ops", 4, tmp, src)
    tp_harness.wait(procs)
    return tp_harness.load(tmp / "ref.npz"), tmp


@pytest.mark.parametrize("tp,op", [(2, op) for op in OPS]
                         + [(4, op) for op in OPS + ["subgroup_psum_4"]])
def test_collective_matches_reference(ops, tp, op):
    ref, tmp = ops
    key = f"ops_tp{tp}/{op}"
    got = np.stack([tp_harness.load(tmp / f"ops_tp{tp}_rank{r}.npz")[key] for r in range(tp)])
    want = ref[key]
    assert got.shape == want.shape
    if tp == 2 or op in EXACT:
        np.testing.assert_array_equal(got.view(np.int32) if got.dtype == np.float32 else got,
                                      want.view(np.int32) if want.dtype == np.float32 else want)
    else:
        tp_harness.close(got, want, SUM4_RTOL, key)


def _ref_meta(arch, tp):
    return jmodel.param_meta(jregistry.get_config(arch, reduced=True), tp=tp)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_layout_matches_reference(arch, tp):
    cfg = registry.get_config(arch, reduced=True)
    mine, ref = leaves(model.param_meta(cfg, tp)), jax.tree_util.tree_leaves(
        _ref_meta(arch, tp), is_leaf=jmeta.is_meta)
    assert len(mine) == len(ref)
    for m, r in zip(mine, ref):
        assert m.shape == tuple(r.shape) and m.sync == r.sync, (m, r)
        assert tuple(m.pspec) == tuple(r.pspec), (m, r)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, jregistry.get_config(
        arch, reduced=True), tp=tp), jax.random.key(0))
    params = model.init_params(torch.Generator().manual_seed(1), cfg, "cpu", tp)
    got = leaves(params)
    assert [tuple(t.shape) for t in got] == [s.shape for s in jax.tree_util.tree_leaves(shapes)]
    for t, m in zip(got, mine):  # the copies of a duplicated slice are equal
        d = meta_lib.model_dim(m)
        if 1 < m.sync < tp and d >= 0:
            blocks = t.chunk(tp, d)
            for j in range(tp):
                assert torch.equal(blocks[j], blocks[j // m.sync * m.sync])


@pytest.mark.parametrize("arch,tp", [("mamba2-370m", 2), ("chatglm3-6b", 4),
                                     ("qwen3-moe-30b-a3b", 2), ("gemma3-4b", 4)])
def test_slicer_keeps_the_ranks_slices(arch, tp):
    cfg = registry.get_config(arch, reduced=True)
    meta = model.param_meta(cfg, tp)
    glob = model.init_params(torch.Generator().manual_seed(3), cfg, "cpu", tp)
    for j in range(tp):
        mine = model.init_params(torch.Generator().manual_seed(3), cfg, "cpu", tp,
                                 keep=meta_lib.slicer(tp, j))
        want = meta_lib.shard_tree(glob, meta, tp, j)
        for a, b, m in zip(leaves(mine), leaves(want), leaves(meta)):
            assert tuple(a.shape) == meta_lib.local_shape(m, tp)
            assert torch.equal(a, b)


def test_train_seeds_unchanged_at_shard_zero():
    for seed, step, client, n in ((0, 0, 0, 5), (3, 7, 2, 31), (2**31, 10**6, 15, 1)):
        words = np.random.SeedSequence((seed, step, client)).generate_state(n, np.uint32)
        want = [int(w) for w in words]
        assert train_seeds(seed, step, client, n) == want
        assert train_seeds(seed, step, client, n, [0] * n) == want
        # a leaf of shard index s > 0 draws from (seed, step, client, s)
        mixed = train_seeds(seed, step, client, n, [i % 3 for i in range(n)])
        for i, s in enumerate(i % 3 for i in range(n)):
            other = np.random.SeedSequence((seed, step, client, s)).generate_state(n, np.uint32)
            assert mixed[i] == (want[i] if s == 0 else int(other[i]))
    with pytest.raises(ValueError, match="shard indices"):
        train_seeds(0, 0, 0, 3, [0, 0])


@pytest.mark.parametrize("arch", ["chatglm3-6b", "gemma3-4b", "mamba2-370m"])
def test_shard_seed_indices_follow_the_reference(arch):
    """The reference folds ``axis_index // max(1, min(sync, tp))``."""
    cfg = registry.get_config(arch, reduced=True)
    for tp in (1, 2, 4):
        metas = jax.tree_util.tree_leaves(_ref_meta(arch, tp), is_leaf=jmeta.is_meta)
        for j in range(tp):
            ctx = (ParallelCtx() if tp == 1 else
                   ParallelCtx(model_axis="model", tp=tp, model_group=object(), model_rank=j))
            got = shard_seed_indices(model.param_meta(cfg, tp), ctx)
            assert got == [j // max(1, min(m.sync, tp)) for m in metas]
