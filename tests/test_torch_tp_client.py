"""The shard engine's per-client release over a model axis against the
JAX reference, on the CPU (tests/tp_cases.py's CLIENT, run by
tests/tp_harness.py: the reference's ``make_client_grad`` inside a
shard_map on fake devices, the port's on gloo ranks, side by side): the
lm task's tensor-parallel gradient (``shard_params``, ``local_loss``,
``gather_grads``) of two clients' batches, at one and two local steps
over tp = 2 on a reduced mamba2-370m (its B/C projection replicated),
and at one over tp = 4 on a reduced chatglm3-6b (its KV heads on aligned
pairs of ranks, summed by ``subgroup_psum``), from the reference's
global parameters at tp; and the task's held-out loss at tp.

Tolerances, tests/test_torch_lm_round.py's: each client's release
within ``GRAD_RTOL`` of its largest unclipped coordinate (float32
einsums summed in another order; at tp = 4 the model axis's psums add
four partials in gloo's order, not XLA's, inside the same bound; the
clip is exact on equal inputs, so the clipped release is held to the
same bound against the reference's release clipped); the held-out loss
within ``LOSS_RTOL``. Every model rank holds the same release, bit for
bit.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

import tp_cases
import tp_harness
from repro.configs import registry as jregistry
from repro.fed import tasks as jtasks
from repro.fed.config import FedConfig as JaxFedConfig
from repro.models import model as jmodel
from repro_torch.core.mechanisms import make_mechanism
from test_torch_lm_round import GRAD_RTOL, LOSS_RTOL


def _inputs() -> dict:
    """Each case's global flat parameters (the reference's
    ``init_params(key(3), cfg, tp)``, raveled) and its clients' batches
    (the reference task's ``client_batch``), stacked over the clients."""
    out = {}
    for name, case in tp_cases.CLIENT.items():
        jcfg = jregistry.get_config(case["model"], reduced=True)
        init = jax.jit(lambda k, c=jcfg, tp=case["tp"]: jmodel.init_params(k, c, tp=tp))
        out[f"{name}/flat"] = np.asarray(ravel_pytree(init(jax.random.key(3)))[0])
        fed = tp_cases.client_fed(case)
        jt = jtasks.make_task(fed["task"], JaxFedConfig(**fed))
        batches = [jt.client_batch(cid) for cid in tp_cases.CLIENT_IDS]
        for k in ("tokens", "labels"):
            out[f"{name}/{k}"] = np.stack([np.asarray(b[k]) for b in batches])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_client")
    src = tmp / "inputs.npz"
    np.savez(src, **_inputs())
    worlds = sorted({case["tp"] for case in tp_cases.CLIENT.values()})
    procs = [tp_harness.reference("client", src, tmp / "ref.npz")]
    for world in worlds:
        procs += tp_harness.ranks("client", world, tmp, src)
    tp_harness.wait(procs)
    port = {w: [tp_harness.load(tmp / f"client_tp{w}_rank{r}.npz") for r in range(w)]
            for w in worlds}
    return tp_harness.load(tmp / "ref.npz"), port


@pytest.mark.parametrize("name", list(tp_cases.CLIENT))
def test_client_release_matches_reference(runs, name):
    ref, port = runs
    ranks = port[tp_cases.CLIENT[name]["tp"]]
    want = ref[f"{name}/raw"]
    clip = make_mechanism(tp_cases.CLIENT_SPEC).clip
    assert want.shape[0] == len(tp_cases.CLIENT_IDS)
    assert (np.abs(want) > clip).any() and np.isfinite(want).all()
    for i in range(want.shape[0]):
        scale = GRAD_RTOL * np.abs(want[i]).max()
        got = ranks[0][f"{name}/raw"][i]
        assert got.shape == want[i].shape
        assert np.abs(got - want[i]).max() <= scale, (i, np.abs(got - want[i]).max(), scale)
        clipped = ranks[0][f"{name}/clipped"][i]
        assert np.abs(clipped).max() <= clip
        assert np.abs(clipped - np.clip(want[i], -clip, clip)).max() <= scale
    for r, other in enumerate(ranks[1:], 1):
        for tag in ("raw", "clipped"):
            np.testing.assert_array_equal(other[f"{name}/{tag}"], ranks[0][f"{name}/{tag}"],
                                          err_msg=f"rank {r} {tag}")


@pytest.mark.parametrize("name", [n for n, c in tp_cases.CLIENT.items()
                                  if c["local_steps"] == 1])
def test_eval_at_tp_matches_reference(runs, name):
    ref, port = runs
    ranks = port[tp_cases.CLIENT[name]["tp"]]
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}/eval_loss"], ref[f"{name}/eval_loss"],
                                   rtol=LOSS_RTOL)
