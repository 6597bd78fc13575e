"""The clipping helpers (``repro_torch/core/clipping.py``) against the
reference's ``repro/core/clipping.py`` on seeded numpy trees, on the CPU:

  * ``value_clip`` equal bit for bit, float32 and bfloat16 leaves;
  * ``global_norm`` within ``NORM_RTOL``: each leaf's sum of squares is a
    reduction that XLA and torch order differently, so the float32 sums
    differ in their last places (the leaves are added in the same order);
  * ``global_norm_clip`` within ``NORM_RTOL`` of the reference's leaves
    (its scale comes from that norm), each leaf of its own dtype, and
    bit for bit where the norm is below the bound (scale 1).
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clipping as jclip
from repro_torch.convert import leaves
from repro_torch.core import clipping

NORM_RTOL = 1e-6


def _trees(seed: int, bf16: bool):
    rng = np.random.default_rng(seed)
    arrays = {"b": rng.normal(0, 0.05, (7,)), "a": {"w": rng.normal(0, 0.3, (5, 9)),
                                                      "v": rng.normal(0, 1.0, (3, 4, 2))},
              "c": [rng.normal(0, 2.0, (11,)), rng.normal(0, 0.01, (2, 3))]}
    arrays = {k: v for k, v in arrays.items()}

    def to_j(x):
        return jnp.asarray(x, jnp.bfloat16 if bf16 and x.ndim == 2 else jnp.float32)

    def to_t(x):
        t = torch.tensor(x, dtype=torch.float32)
        return t.to(torch.bfloat16) if bf16 and x.ndim == 2 else t

    def build(f, node):
        if isinstance(node, dict):
            return {k: build(f, v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(f, v) for v in node]
        return f(node)

    return build(to_j, arrays), build(to_t, arrays)


def _jleaves(tree):
    import jax

    return [np.asarray(x.astype(jnp.float32)) for x in jax.tree_util.tree_leaves(tree)]


def _tleaves(tree):
    return [t.to(torch.float32).numpy() for t in leaves(tree)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("c", [0.02, 0.5, 3.0])
def test_value_clip_exact(seed, c, bf16):
    jt, tt = _trees(seed, bf16)
    got, want = _tleaves(clipping.value_clip(tt, c)), _jleaves(jclip.value_clip(jt, c))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, t in zip(leaves(clipping.value_clip(tt, c)), leaves(tt)):
        assert g.dtype == t.dtype


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_norm(seed, bf16):
    jt, tt = _trees(seed, bf16)
    got = clipping.global_norm(tt)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(jclip.global_norm(jt)), rtol=NORM_RTOL)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_norm", [0.05, 1.0, 1e4])
def test_global_norm_clip(seed, max_norm, bf16):
    jt, tt = _trees(seed, bf16)
    out = clipping.global_norm_clip(tt, max_norm)
    got, want = _tleaves(out), _jleaves(jclip.global_norm_clip(jt, max_norm))
    for o, t in zip(leaves(out), leaves(tt)):
        assert o.dtype == t.dtype and o.shape == t.shape
    exact = float(clipping.global_norm(tt)) < max_norm
    for g, w in zip(got, want):
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            # a bfloat16 leaf rounds the scaled value to 8 bits: the norm's
            # last-place difference may move it by one bfloat16 ulp
            tol = 2.0 ** -7 if bf16 and g.ndim == 2 else NORM_RTOL
            np.testing.assert_allclose(g, w, rtol=tol, atol=0)
    if not exact:
        np.testing.assert_allclose(float(clipping.global_norm(out)), max_norm, rtol=1e-2)
