"""Flash-decoding over a mesh against the JAX reference
(tests/serve_mesh_check.py): at a batch of 1 the global layers' KV
caches are sharded on their sequence dim over the client ranks, every
rank decodes the one row, and the shards' partial softmaxes combine by
a max and a sum over the clients. Meshes 2x2 (two sequence shards, each
tensor-parallel over two ranks) and 4x1 (four shards); reduced gemma3-4b
(a window-64 ring, whole on every rank, and a global layer) and
h2o-danube-3-4b (rings only): 3 float32 decode steps from the
reference's one-rank caches of 128 at position 96, re-laid and cut by
``convert.cache_from_numpy``, and 4 int8 steps from zero caches. Tokens
equal, int8 codes and bfloat16 scales bit for bit, float32 caches
within ``CACHE_RTOL``.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import pytest

import serve_mesh_check
import tp_cases

MODE = "seq"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return serve_mesh_check.run(tmp_path_factory.mktemp("serve_seq"), MODE,
                                tp_cases.SERVE_MESHES[MODE])


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "int8"])
@pytest.mark.parametrize("arch", tp_cases.SERVE_ARCHS[MODE])
@pytest.mark.parametrize("mesh", tp_cases.SERVE_MESHES[MODE])
def test_seq_sharded_decode_matches_reference(runs, mesh, arch, quant, record_property):
    ref, ranks = runs[mesh]
    worst = serve_mesh_check.check(ref, ranks, MODE, mesh, arch, quant)
    record_property("worst_cache_rel_err", worst)
