"""The model zoo in the port (``configs/``, ``models/model.py``,
``data/lm.py``, ``eval/lm_eval.py``) against the JAX reference, for each
of the ten reduced configs, on the CPU:

  * the configs equal the reference's field for field, full and reduced;
  * ``init_params`` has the reference's tree, shapes and dtypes (its
    values come from a ``torch.Generator``, not ``jax.random``) and its
    special leaves (zero norms, ``A_log = log(1..h)``, ``D_skip = 1``);
  * the nested ``ravel`` of the reference's parameters equals
    ``ravel_pytree`` exactly: the flat order is the RNG counters' meaning;
  * the loss and its gradient from those parameters, at the lm task's
    default shape (seq_len 64, batch 2), within ``LOSS_RTOL`` of the loss
    and ``GRAD_RTOL`` of the largest gradient;
  * ``TokenPipeline`` batches equal the reference's exactly, prefix
    leaves included; ``evaluate_lm`` within ``LOSS_RTOL``.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs import base as jbase
from repro.configs import registry as jregistry
from repro.data import lm as jlm
from repro.data.lm import TokenPipeline as JaxTokenPipeline
from repro.eval.lm_eval import evaluate_lm as jax_evaluate_lm
from repro.models import model as jmodel
from repro.models.common import ParallelCtx as JaxParallelCtx
from repro_torch.configs import registry
from repro_torch.configs.base import INPUT_SHAPES, uniform_layers
from repro_torch.convert import ravel, tree_from_numpy
from repro_torch.data.lm import TokenPipeline, synthetic_token_batch
from repro_torch.eval.lm_eval import evaluate_lm, perplexity
from repro_torch.models import model
from repro_torch.models.common import ParallelCtx

LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-5
SEQ, BATCH = 64, 2  # the lm task's defaults
ARCHS = registry.ARCH_IDS


def _as_dict(obj):
    """A config as nested plain data (the two packages' spec classes differ)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _as_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return tuple(_as_dict(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _as_dict(v) for k, v in obj.items()}
    return obj


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """One reduced config in both packages, the reference's parameters
    (``init_params`` under jit) and a task-shaped batch."""
    name = request.param
    jcfg = jregistry.get_config(name, reduced=True)
    jparams = jax.jit(lambda k: jmodel.init_params(k, jcfg))(jax.random.key(7))
    return {"name": name, "jcfg": jcfg, "cfg": registry.get_config(name, reduced=True),
            "jparams": jparams, "params": tree_from_numpy(jax.device_get(jparams), "cpu"),
            "batch": JaxTokenPipeline(jcfg, SEQ, BATCH, seed=3, branch=4).batch(5)}


def test_registry_and_configs_match_reference():
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    for name in ARCHS:
        for reduced in (False, True):
            assert _as_dict(registry.get_config(name, reduced=reduced)) == \
                _as_dict(jregistry.get_config(name, reduced=reduced)), (name, reduced)
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("gpt-9")
    assert _as_dict(INPUT_SHAPES) == _as_dict(jbase.INPUT_SHAPES)
    assert _as_dict(uniform_layers(3, window=5)) == _as_dict(jbase.uniform_layers(3, window=5))
    cfg = registry.get_config("mamba2-370m")
    assert cfg.padded_vocab(1) == 50304 and cfg.padded_vocab(16) == 51200
    for name in ARCHS:
        mine, ref = registry.get_config(name, reduced=True), jregistry.get_config(name,
                                                                               reduced=True)
        for a, b in zip(mine.layers, ref.layers):
            if a.kind != "ssm":
                assert _as_dict(mine.attn_spec(a)) == _as_dict(ref.attn_spec(b))


def test_init_params_has_the_reference_tree(arch):
    params = model.init_params(torch.Generator().manual_seed(0), arch["cfg"], device="cpu")
    mine = jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, params))
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, arch["jcfg"]), jax.random.key(0))
    want = jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, shapes))
    assert mine == want
    for (path, t), s in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree_util.tree_leaves(shapes)):
        assert tuple(t.shape) == s.shape and str(t.dtype).split(".")[1] == str(s.dtype), path
        key = jax.tree_util.keystr(path)
        if "norm" in key:
            assert not t.any(), key
        jleaf = _leaf(arch["jparams"], path)
        if key.endswith("['A_log']") or key.endswith("['D_skip']"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(jleaf), err_msg=key)
    for layer, spec in zip(params["layers"], arch["cfg"].layers):
        assert (layer == {}) == (spec.kind == "shared_attn")


def _leaf(tree, path):
    for entry in path:
        tree = tree[entry.key if hasattr(entry, "key") else entry.idx]
    return tree


def test_nested_ravel_equals_ravel_pytree(arch):
    flat, unravel = ravel(arch["params"])
    want, _ = ravel_pytree(arch["jparams"])
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    assert unravel.size == flat.numel()
    back = unravel(flat)
    # shared_attn layers ({}) contribute nothing; every leaf is a view
    for layer, spec in zip(back["layers"], arch["cfg"].layers):
        assert (layer == {}) == (spec.kind == "shared_attn")
    leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t, back))
    assert all(t.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
               for t in leaves)


def test_loss_and_gradient_match_reference(arch):
    jcfg, cfg, batch = arch["jcfg"], arch["cfg"], arch["batch"]
    jflat, junravel = ravel_pytree(arch["jparams"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(f):
        return jmodel.loss_fn(junravel(f), jcfg, JaxParallelCtx(), jbatch, remat=False,
                              compute_dtype=jnp.float32)[0]

    want_loss, want_grad = jax.jit(jax.value_and_grad(jloss))(jflat)
    flat, unravel = ravel(arch["params"])
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def loss(f):
        return model.loss_fn(unravel(f), cfg, ParallelCtx(), tbatch, remat=False,
                             compute_dtype=torch.float32)[0]

    got_loss = loss(flat)
    got_grad = torch.func.grad(loss)(flat).numpy()
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=LOSS_RTOL)
    want_grad = np.asarray(want_grad)
    err = np.abs(got_grad - want_grad).max()
    assert err <= GRAD_RTOL * np.abs(want_grad).max(), (arch["name"], err)


def test_token_pipeline_matches_reference(arch):
    jcfg, cfg = arch["jcfg"], arch["cfg"]
    for seq_len, batch, seed, branch in [(SEQ, BATCH, 3, 4), (32, 3, 0, 8)]:
        mine = TokenPipeline(cfg, seq_len, batch, seed=seed, branch=branch)
        ref = JaxTokenPipeline(jcfg, seq_len, batch, seed=seed, branch=branch)
        assert mine.effective_vocab == ref.effective_vocab
        for step in (0, 5, 17):
            got, want = mine.batch(step), ref.batch(step)
            assert set(got) == set(want)
            assert ("prefix_embeds" in got) == (cfg.frontend is not None)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            pfx = cfg.frontend.prefix_len if cfg.frontend else 0
            assert (got["labels"][:, :pfx] == -1).all()
            assert got["labels"].shape == (batch, seq_len)
    want = jlm.synthetic_token_batch(jcfg, 16, 2, seed=4)
    for k, v in synthetic_token_batch(cfg, 16, 2, seed=4).items():
        np.testing.assert_array_equal(v, want[k])


def test_evaluate_lm_matches_reference(arch):
    kw = dict(seq_len=32, batch=2, batches=2, seed=11)
    got = evaluate_lm(arch["params"], arch["cfg"], **kw)
    want = jax_evaluate_lm(arch["jparams"], arch["jcfg"], **kw)
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["ce"], want["ce"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=LOSS_RTOL * 10)
    assert perplexity(100.0) == pytest.approx(np.exp(30.0))


def test_nested_tree_round_trips_through_ravel_as_views():
    """convert.ravel on a nested tree: ravel_pytree's order (sorted keys
    at every level, tuples in order, empty containers and None add
    nothing); Unravel gives views of the flat vector, in the tree's shape;
    a flat dict (the CNN's) keeps its sorted-key layout."""
    rng = np.random.default_rng(0)
    tree = {"z": rng.normal(size=(2, 3)).astype(np.float32),
            "a": ({}, {"k": rng.normal(size=4).astype(np.float32), "b": {}},
                  {"y": rng.normal(size=(1, 2)).astype(np.float32)}),
            "m": {"q": None, "p": np.float32(rng.normal(size=()))}}
    flat, unravel = ravel(tree_from_numpy(tree, "cpu"))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ravel_pytree(tree)[0]))
    assert unravel.shapes == ((4,), (1, 2), (), (2, 3)) and unravel.size == 13
    back = unravel(flat)
    assert back["a"][0] == {} and back["a"][1]["b"] == {} and back["m"]["q"] is None
    assert back["z"].shape == (2, 3) and back["m"]["p"].shape == ()
    back["z"][1, 2] = 7.0  # a view: writes land in the flat vector
    assert float(flat[12]) == 7.0
    with pytest.raises(ValueError, match="flat vector"):
        unravel(flat[:-1])
    cnn = {k: torch.zeros(s) for k, s in
           (("dense1", (2, 2)), ("b1", (2,)), ("conv1", (1, 1, 1, 2)), ("b2", (3,)))}
    _, cnn_unravel = ravel(cnn)
    assert list(cnn_unravel(torch.arange(11.0))) == ["b1", "b2", "conv1", "dense1"]
