"""The serve steps over a 2x2 mesh (two clients, each tensor-parallel
over two gloo ranks) against the JAX reference's ``make_prefill_step``
and ``make_decode_step`` on four fake CPU devices
(tests/serve_mesh_check.py), float32: reduced gemma3-4b, h2o-danube-3-4b
and zamba2-1.2b (SSM states) at a batch of 4 split over the clients, a
sequence-parallel prefill of 96 tokens into caches of 128 (each
window-64 ring re-laid) and 3 greedy decode steps; and 4 int8 steps
from zero caches.
Tokens equal, int8 codes and bfloat16 scales bit for bit, float32 caches
within ``CACHE_RTOL``. Also: ``lm_head_argmax`` at tp 2 and 4 with ties
across shards, and ``model.cache_meta`` (shapes, dtypes, pspecs) against
the reference's for all ten configs at ``decode_32k`` and ``long_500k``,
tp 1 and 2, float32 and int8 (Metas only; nothing allocated).
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import serve_mesh_check
import tp_cases
from repro.configs import registry as jregistry
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.models import meta as jmeta
from repro.models import model as jmodel
from repro_torch.configs import registry
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.convert import leaves
from repro_torch.models import model

MODE, MESH = "batch", "2x2"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return serve_mesh_check.run(tmp_path_factory.mktemp("serve_mesh"), MODE, [MESH])[MESH]


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "int8"])
@pytest.mark.parametrize("arch", tp_cases.SERVE_ARCHS[MODE])
def test_batch_sharded_serve_matches_reference(runs, arch, quant, record_property):
    ref, ranks = runs
    worst = serve_mesh_check.check(ref, ranks, MODE, MESH, arch, quant)
    record_property("worst_cache_rel_err", worst)


@pytest.mark.parametrize("tp", tp_cases.ARGMAX_TPS)
def test_lm_head_argmax_ties_across_shards(runs, tp):
    ref, ranks = runs
    np.testing.assert_array_equal(ref[f"argmax{tp}"], serve_mesh_check.ARGMAX_WANT)
    for out in ranks:
        assert out[f"argmax{tp}"].dtype == np.int32
        np.testing.assert_array_equal(out[f"argmax{tp}"], ref[f"argmax{tp}"])


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_cache_meta_matches_reference(arch, shape):
    n = 0
    for tp in (1, 2):
        for quant in (False, True):
            for axes in ((), ("data",), ("pod", "data")):
                want = jax.tree_util.tree_leaves(
                    jmodel.cache_meta(jregistry.get_config(arch), tp, JAX_SHAPES[shape], axes,
                                      dtype=jnp.float32, kv_quant=quant),
                    is_leaf=jmeta.is_meta)
                got = leaves(model.cache_meta(registry.get_config(arch), tp, INPUT_SHAPES[shape],
                                              axes, dtype=torch.float32, kv_quant=quant))
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    assert g.shape == tuple(w.shape), (tp, quant, axes, g, w)
                    assert g.dtype == {"float32": torch.float32, "int8": torch.int8,
                                       "bfloat16": torch.bfloat16}[np.dtype(w.dtype).name]
                    assert g.pspec == tuple(w.pspec), (tp, quant, axes, g, w)
                    assert g.sync == w.sync
                    n += 1
    assert n > 0


def test_cache_meta_refuses_other_dtypes():
    """No dtype is refused any more: the caches at the reference's
    default, bfloat16 (K/V and the SSM conv tails; the SSM state ``h``
    float32), equal its Metas, for an attention and an SSM config."""
    for arch in ("gemma3-4b", "zamba2-1.2b"):
        want = jax.tree_util.tree_leaves(
            jmodel.cache_meta(jregistry.get_config(arch, reduced=True), 2,
                              JAX_SHAPES["decode_32k"], ("data",)), is_leaf=jmeta.is_meta)
        got = leaves(model.cache_meta(registry.get_config(arch, reduced=True), 2,
                                      INPUT_SHAPES["decode_32k"], ("data",)))
        assert [(g.shape, g.dtype, g.pspec) for g in got] == [
            (tuple(w.shape), {"float32": torch.float32, "bfloat16": torch.bfloat16}[
                np.dtype(w.dtype).name], tuple(w.pspec)) for w in want]
        assert {g.dtype for g in got} >= {torch.bfloat16}
