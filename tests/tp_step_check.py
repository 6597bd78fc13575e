"""The train step over a model axis against the reference, shared by
tests/test_torch_tp_step.py (mesh 1x2) and tests/test_torch_tp_step_2d.py
(2x2): the inputs (the reference's global parameters at tp from its own
``init_params(key(2), cfg, tp)``, its token batches, its step keys and
every rank's folded per-leaf kernel seeds), the two sides run side by
side (tests/tp_harness.py), and the holds of
tests/test_torch_train_step.py."""
import jax
import numpy as np

import tp_cases
import tp_harness
from repro.configs import registry as jregistry
from repro.data.lm import TokenPipeline as JaxTokenPipeline
from repro.kernels.ops import key_to_seed
from repro.models import meta as jmeta
from repro.models import model as jmodel
from repro_torch.core.mechanisms import make_mechanism
from test_torch_train_step import LOSS_RTOL, MOVED_FRAC, MOVED_LEVELS


def inputs(mesh: str) -> dict:
    """Rank ``c * M + j``'s seed of leaf ``i`` at step ``t`` is the
    reference's ``key_to_seed(fold_in(fold_in(fold_in(key_t, c), i), j //
    max(1, min(sync_i, M))))`` (its ``_client_key``, leaf and
    ``_shard_seed_index`` folds)."""
    D, M = (int(d) for d in mesh.split("x"))
    jcfg = jregistry.get_config(tp_cases.STEP_ARCH, reduced=True)
    init = jax.jit(lambda k: jmodel.init_params(k, jcfg, tp=M))(jax.random.key(2))
    out = {f"params0/{i}": np.asarray(a) for i, a in enumerate(jax.tree_util.tree_leaves(init))}
    pipe = JaxTokenPipeline(jcfg, tp_cases.STEP_SEQ, tp_cases.STEP_BATCH, seed=4)
    syncs = [max(1, min(m.sync, M)) for m in jax.tree_util.tree_leaves(
        jmodel.param_meta(jcfg, tp=M), is_leaf=jmeta.is_meta)]

    @jax.jit
    def seeds(key, c, j):
        ck = jax.random.fold_in(key, c)
        return jax.numpy.stack([key_to_seed(jax.random.fold_in(jax.random.fold_in(ck, i), j // g))
                                for i, g in enumerate(syncs)])

    for t, key in enumerate(jax.random.split(jax.random.key(9), tp_cases.STEP_STEPS)):
        b = pipe.batch(t)
        out[f"tokens{t}"], out[f"labels{t}"] = b["tokens"], b["labels"]
        out[f"key{t}"] = np.asarray(jax.random.key_data(key))
        out[f"seeds{t}"] = np.stack([np.asarray(seeds(key, c, j))
                                     for c in range(D) for j in range(M)])
    return out


def run(tmp, mesh: str, arch: str, *launch_spellings) -> tuple:
    """Both sides of the step at ``mesh``, and the launcher's checks on
    ``arch`` (tests/torch_tp_worker.py ``launch``) on ranks of their own;
    returns (reference outputs, port outputs, the step ranks' lines, the
    launcher ranks' lines)."""
    D, M = (int(d) for d in mesh.split("x"))
    src = tmp / "inputs.npz"
    np.savez(src, **inputs(mesh))
    ref = tp_harness.reference("step", src, tmp / "ref.npz", mesh)
    step = tp_harness.ranks("step", D * M, tmp, src, mesh)
    launch = tp_harness.ranks("launch", D * M, tmp, src, mesh, arch, *launch_spellings)
    outs = tp_harness.wait([ref] + step + launch)
    return (tp_harness.load(tmp / "ref.npz"), tp_harness.load(tmp / f"step_{mesh}.npz"),
            outs[1:1 + D * M], outs[1 + D * M:])


def check(ref: dict, port: dict, record_property) -> None:
    """The losses within LOSS_RTOL; the parameters within a tolerance a
    step of the reference's but at MOVED_FRAC of the coordinates, each
    of those within MOVED_LEVELS decoded levels a step (sgd)."""
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=LOSS_RTOL)
    n = sum(1 for k in ref if k.startswith("params/"))
    got = np.concatenate([port[f"params/{i}"].reshape(-1) for i in range(n)])
    want = np.concatenate([ref[f"params/{i}"].reshape(-1) for i in range(n)])
    mech = make_mechanism(tp_cases.STEP_SPEC)
    x_max, S, lr = mech.params.x_max, tp_cases.STEP_STEPS, tp_cases.STEP_LR
    tol = S * (lr * np.spacing(np.float32(2 * x_max)) + np.spacing(np.abs(want)))
    jump = S * MOVED_LEVELS * lr * 2 * x_max / (mech.params.m - 1)
    diff = np.abs(got - want)
    moved = diff > tol
    record_property("moved_coordinates", int(moved.sum()))
    assert moved.sum() <= MOVED_FRAC * got.size, int(moved.sum())
    assert diff.max() <= jump
