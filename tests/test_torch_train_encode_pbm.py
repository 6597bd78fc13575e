"""The LM train step's aggregation against the JAX reference on the CPU,
continued from tests/test_torch_train_encode.py (a file of its own, so
that each stays short under the tier-1 run's workers: the reference's
op-by-op encode compiles each operation once a leaf shape):

  * ``encode_aggregate_decode`` on the reference's gradient tree of a
    reduced mamba2-370m for pbm and qmgeo (``check_encode_aggregate_decode``:
    levels bit for bit, QMGeo within ``QMGEO_BUDGET``; decode within 1 ulp);
  * four clients' handed gradient trees summed in one process at the
    reference's client keys ``fold_in(sub, r)`` (plan ``4``) and
    ``fold_in(fold_in(sub, pod), data)`` (plan ``2x2x1``): the sums equal
    the reference's bit for bit, the decode at n = 4 within 1 ulp. This
    is the replay (tests/torch_train_worker.py, ``replay_levels``) that
    four gloo ranks are held against.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mechanisms as jmechs
from repro_torch.core.mechanisms import make_mechanism
from test_torch_train_encode import (  # noqa: F401  (ref: the module's fixture)
    SPECS, check_encode_aggregate_decode, client_trees, leaf_keys, leaf_seeds, ref, ulps,
)
from torch_train_worker import replay_levels


@pytest.mark.parametrize("name", ["pbm", "qmgeo"])
def test_encode_aggregate_decode_matches_reference(ref, name):  # noqa: F811
    check_encode_aggregate_decode(ref, name)


@pytest.mark.parametrize("plan,name", [("4", "rqm"), ("4", "pbm"), ("2x2x1", "rqm")])
def test_four_client_sum_matches_reference(plan, name):
    """Four clients' levels summed in one process at the reference's
    client keys (``_client_key``: fold_in by each client axis index,
    pod-major)."""
    jmech, mech = jmechs.make_mechanism(SPECS[name]), make_mechanism(SPECS[name])
    clients = client_trees(4)
    n = len(clients[0])
    sub = jax.random.key(5)
    keys = ([jax.random.fold_in(sub, r) for r in range(4)] if plan == "4" else
            [jax.random.fold_in(jax.random.fold_in(sub, r // 2), r % 2) for r in range(4)])
    with jax.disable_jit():
        per_client = [[np.asarray(jmech.quantize(jnp.asarray(clients[r][i]), k))
                       for i, k in enumerate(leaf_keys(keys[r], n))] for r in range(4)]
        want_sum = [np.sum([per_client[r][i] for r in range(4)], axis=0, dtype=np.int32)
                    for i in range(n)]
        want_dec = [np.asarray(jmech.decode_sum(jnp.asarray(z), 4)) for z in want_sum]
    got_sum = replay_levels(mech, [[torch.from_numpy(g) for g in c] for c in clients],
                            [leaf_seeds(k, n) for k in keys])
    for i in range(n):
        assert got_sum[i].dtype == torch.int32
        np.testing.assert_array_equal(got_sum[i].numpy(), want_sum[i])
        assert ulps(mech.decode_sum(got_sum[i], 4).numpy(), want_dec[i]).max() <= 1


