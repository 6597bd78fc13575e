"""The train step's precision and memory options over a 2x2 mesh (two
clients, each tensor-parallel over two gloo ranks) against the JAX
reference on four fake CPU devices (tests/tp_reference.py's ``perf``
job, beside tests/torch_tp_worker.py's ranks): the cases of the
reference's ``tests/sharded_checks.py:check_perf_variants`` on reduced
gemma3-4b, float32 compute, 2 steps each on one batch (tp_cases.PERF_*):

  * every variant (base, int16 aggregation, int8 sequence-parallel
    gathers, ZeRO-1 with ``agg_dtype="auto"``) against the reference's
    trajectory (tp_cases.PERF_REFERENCE: int16 and float32 ZeRO-1 against
    its base): the losses within ``LOSS_RTOL`` (``sp_compress``:
    ``SP_LOSS_RTOL``), the parameters as
    tests/test_torch_train_step.py holds the plain step, a coordinate
    moving only where a rounding draw sits on its threshold
    (``MOVED_FRAC``; ``sp_compress``: ``SP_MOVED_FRAC``, an int8 code
    there moving where the float32 forwards differ at a rounding
    boundary);
  * int16 == int32 bit for bit in the port;
  * check_perf_variants' own holds: every run's losses finite and
    falling (both sides), ZeRO-1 within 2e-3 of the base loss;
  * one ZeRO-1 step on given per-rank gradients (both sides'
    ``model.loss_fn`` replaced by ``sum(p * g)``): every rank's summed
    levels (reduce-scattered as int16 lanes) == the reference's op-by-op
    encode's sums exactly, the new master within one float32 ulp of the
    reference's update of those sums (its contract,
    ``decode_apply_kernel.py``), the parameters and master of the
    reference's jitted step the same but where that step contracts a
    draw into an FMA (ROADMAP.md C6);
  * int16 at an unsafe sum bound raises, as the reference does; ZeRO-1
    with Adam raises.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import numpy as np
import pytest
import torch

import tp_cases
import tp_harness
from repro.configs import registry as jregistry
from repro.core.mechanisms import make_mechanism as jax_make_mechanism
from repro.distributed import step as jstep
from repro.kernels.ops import key_to_seed
from repro.models import meta as jmeta
from repro.models import model as jmodel
from repro.models.common import ParallelCtx as JaxParallelCtx
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_config
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.distributed import step as tstep
from repro_torch.models.common import ParallelCtx
from repro_torch.optim import make_optimizer, schedules
from test_torch_train_step import LOSS_RTOL, MOVED_FRAC, MOVED_LEVELS

# sp_compress over its steps: its first step holds as the plain step's
# (measured: the loss equal, 1 coordinate of 1,443,072 moved); after it,
# a parameter a rounding draw moved changes the next forward by a float32
# ulp, which can flip an int8 code at its rounding boundary: a step of
# 1/127 of a token's largest activation, whose gradient moves more levels
# (measured on the CPU: losses 7.9e-5 apart at step 2; 416 coordinates,
# 0.03%, moved, by at most 0.016, 3 levels)
SP_LOSS_RTOL = 1e-3
SP_MOVED_FRAC = 1e-2
SP_MOVED_LEVELS = 4
ZERO1_LOSS_ATOL = 2e-3  # check_perf_variants' own hold
D, M = (int(d) for d in tp_cases.PERF_MESH.split("x"))


def inputs() -> dict:
    """The reference's global parameters at tp (``init_params(key(0))``),
    random token batches, the step keys and every rank's folded per-leaf
    seeds (tests/tp_step_check.py's), and each rank's given gradients."""
    jcfg = jregistry.get_config(tp_cases.PERF_ARCH, reduced=True)
    init = jax.jit(lambda k: jmodel.init_params(k, jcfg, tp=M))(jax.random.key(0))
    out = {f"params0/{i}": np.asarray(a) for i, a in enumerate(jax.tree_util.tree_leaves(init))}
    metas = jax.tree_util.tree_leaves(jmodel.param_meta(jcfg, tp=M), is_leaf=jmeta.is_meta)
    syncs = [max(1, min(m.sync, M)) for m in metas]

    @jax.jit
    def seeds(key, c, j):
        ck = jax.random.fold_in(key, c)
        return jax.numpy.stack([key_to_seed(jax.random.fold_in(jax.random.fold_in(ck, i), j // g))
                                for i, g in enumerate(syncs)])

    rng = np.random.default_rng(5)
    # check_perf_variants' batch: random tokens, the labels the same draw,
    # the same batch at every step
    tokens = rng.integers(0, jcfg.vocab_size, (tp_cases.PERF_BATCH, tp_cases.PERF_SEQ))
    for t, key in enumerate(jax.random.split(jax.random.key(1), tp_cases.PERF_STEPS)):
        out[f"tokens{t}"] = out[f"labels{t}"] = tokens.astype(np.int32)
        out[f"key{t}"] = np.asarray(jax.random.key_data(key))
        out[f"seeds{t}"] = np.stack([np.asarray(seeds(key, c, j))
                                     for c in range(D) for j in range(M)])
    for r in range(D * M):
        for i, m in enumerate(metas):
            local = tuple(s // M if e == "model" else s for s, e in zip(m.shape, m.pspec))
            out[f"grads/{r}/{i}"] = (rng.normal(size=local)
                                     * tp_cases.PERF_GRAD_SCALE).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("perf_variants")
    src = tmp / "inputs.npz"
    np.savez(src, **inputs())
    ref = tp_harness.reference("perf", src, tmp / "ref.npz")
    ranks = tp_harness.ranks("perf", D * M, tmp, src)
    tp_harness.wait([ref] + ranks, timeout=400)
    return (tp_harness.load(tmp / "ref.npz"),
            [tp_harness.load(tmp / f"perf_rank{r}.npz") for r in range(D * M)])


def _n(out: dict, prefix: str) -> int:
    return sum(1 for k in out if k.startswith(prefix))


def _held(got: np.ndarray, want: np.ndarray, moved_frac: float, what: str, *,
          steps: int = tp_cases.PERF_STEPS, levels: int = MOVED_LEVELS) -> int:
    """tests/tp_step_check.py's hold of a trajectory's parameters: within
    a step's rounding but at ``moved_frac`` of the coordinates, each of
    those within ``levels`` decoded levels a step."""
    mech = make_mechanism(tp_cases.PERF_SPEC)
    x_max, S, lr = mech.params.x_max, steps, tp_cases.PERF_LR
    tol = S * (lr * np.spacing(np.float32(2 * x_max)) + np.spacing(np.abs(want)))
    jump = S * levels * lr * 2 * x_max / (mech.params.m - 1)
    diff = np.abs(got - want)
    moved = int((diff > tol).sum())
    assert moved <= moved_frac * got.size, (what, moved, got.size)
    assert diff.max() <= jump, (what, float(diff.max()), jump)
    return moved


@pytest.mark.parametrize("variant", tp_cases.PERF_VARIANTS)
def test_variant_matches_reference(runs, variant, record_property):
    ref, ranks = runs
    port, against = ranks[0], tp_cases.PERF_REFERENCE[variant]
    sp = variant == "sp_compress"
    np.testing.assert_allclose(port[f"{variant}/losses"], ref[f"{against}/losses"],
                               rtol=SP_LOSS_RTOL if sp else LOSS_RTOL)
    n = _n(ref, f"{against}/params/")
    assert n == _n(port, f"{variant}/params/")
    got = np.concatenate([port[f"{variant}/params/{i}"].reshape(-1) for i in range(n)])
    want = np.concatenate([ref[f"{against}/params/{i}"].reshape(-1) for i in range(n)])
    assert got.shape == want.shape, variant
    moved = _held(got, want, SP_MOVED_FRAC if sp else MOVED_FRAC, f"{variant} params",
                  levels=SP_MOVED_LEVELS if sp else MOVED_LEVELS)
    record_property("moved_coordinates", moved)
    if sp:  # the first step as the plain step's
        n = _n(ref, "sp_compress/params1/")
        got = np.concatenate([port[f"sp_compress/params1/{i}"].reshape(-1) for i in range(n)])
        want = np.concatenate([ref[f"sp_compress/params1/{i}"].reshape(-1) for i in range(n)])
        record_property("first_step_moved", _held(got, want, MOVED_FRAC, "sp_compress step 1",
                                                  steps=1))
    for out in ranks[1:]:  # every rank ends with the same global tree
        for i in range(_n(ref, f"{variant}/params/")):
            np.testing.assert_array_equal(out[f"{variant}/params/{i}"],
                                          port[f"{variant}/params/{i}"])


def test_int16_equals_int32_bit_for_bit(runs):
    """In the port; against the reference, test_variant_matches_reference."""
    port = runs[1][0]
    np.testing.assert_array_equal(port["int16/losses"], port["base/losses"])
    for i in range(_n(port, "base/params/")):
        np.testing.assert_array_equal(port[f"int16/params/{i}"], port[f"base/params/{i}"])


def test_losses_fall_and_zero1_tracks_base(runs):
    ref, port = runs[0], runs[1][0]
    for side, variants in ((ref, set(tp_cases.PERF_REFERENCE.values())),
                           (port, tp_cases.PERF_VARIANTS)):
        for variant in variants:
            losses = side[f"{variant}/losses"]
            assert np.isfinite(losses).all() and losses[-1] < losses[0], (variant, losses)
    np.testing.assert_allclose(port["zero1/losses"], port["base/losses"], atol=ZERO1_LOSS_ATOL)


def _off(got: np.ndarray, want: np.ndarray, old: np.ndarray, extra: float = 0.0) -> int:
    """How many coordinates of ``old - lr * ghat`` lie further apart than
    the reference's contract allows (``decode_apply_kernel.py``: FMA
    contraction shifts the result by an ulp): an ulp of the update and an
    ulp of the result, and ``extra``."""
    assert got.shape == want.shape == old.shape
    return int((np.abs(got - want) > np.spacing(np.abs(old - want))
                + np.spacing(np.abs(want)) + extra).sum())


def test_zero1_on_given_gradients_levels_exact(runs, record_property):
    """Each rank's summed levels == the reference's op-by-op ones, every
    leaf; its master shard within the contract of the reference's
    ``master - lr * decode_sum(levels)`` everywhere, and its parameters
    (its model slice) and master within it of the reference's jitted step,
    plus an ulp of the decode's largest term (``2 x_max``: the jitted step
    folds ``lr`` into the decode's scale and contracts its terms), but
    where that step's encode contracts a draw into an FMA and a level
    moves (ROADMAP.md C6: at most MOVED_FRAC of the coordinates,
    recorded)."""
    from repro_torch.convert import leaves
    from repro_torch.models import meta as meta_lib
    from repro_torch.models import model

    ref, ranks = runs
    metas = leaves(model.param_meta(get_config(tp_cases.PERF_ARCH, reduced=True), tp=M))
    contracted, size = 0, 0
    folded = float(np.spacing(np.float32(2 * make_mechanism(tp_cases.PERF_SPEC).params.x_max)))
    for r, out in enumerate(ranks):
        c, j = divmod(r, M)
        for i, m in enumerate(metas):
            np.testing.assert_array_equal(out[f"given/levels/{i}"], ref[f"levels/{r}/{i}"],
                                          err_msg=f"rank {r} leaf {i}")
            mast, mast0 = out[f"given/master/{i}"][0], out[f"given/master0/{i}"][0]
            assert _off(mast, ref[f"given/master_op_by_op/{r}/{i}"], mast0) == 0, (r, i)
            want = meta_lib.shard_leaf(torch.from_numpy(ref[f"given/params/{i}"]), m, M,
                                       j).numpy()
            contracted += _off(out[f"given/params/{i}"], want, out[f"given/params0/{i}"],
                               folded)
            L = mast.size
            contracted += _off(mast, ref[f"given/master/{i}"][j, c * L:(c + 1) * L], mast0,
                               folded)
            size += want.size + L
    record_property("reference_jit_contracted", contracted)
    assert contracted <= MOVED_FRAC * size, (contracted, size)


def test_unsafe_int16_and_zero1_adam_raise():
    spec = "rqm:c=0.05,m=40000"  # a sum bound of 39,999 at one client: past int16
    jmech, mech = jax_make_mechanism(spec), make_mechanism(spec)
    with pytest.raises(ValueError, match="int16 aggregation unsafe: bound 39999"):
        jstep.encode_aggregate_decode({}, {}, jmech, JaxParallelCtx(), None, agg_dtype="int16")
    with pytest.raises(ValueError, match="int16 aggregation unsafe: bound 39999"):
        tstep.encode_aggregate_decode([], {}, mech, ParallelCtx(), [], agg_dtype="int16")
    cfg = get_config(tp_cases.PERF_ARCH, reduced=True)
    lr = schedules.constant(0.1, device="cpu")
    assert tstep.agg_width(mech, 1, "auto") == "int32"
    assert tstep.agg_width(make_mechanism(tp_cases.PERF_SPEC), 2, "auto") == "int16"
    plan = tstep.MeshPlan((2, 1), ("data", "model"), ("data",))
    with pytest.raises(NotImplementedError, match="zero1 currently pairs with sgd"):
        tstep.make_train_step(cfg, plan, mech, make_optimizer("adam"), lr,
                              InputShape("t", 16, 2, "train"), zero1=True)


def test_int16_lanes_round_trip():
    """The int16 wire: levels in [0, 2**15) as two lanes a word, odd
    lengths padded; the words' sum is the lanes' sum, lane by lane."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 1000):
        a = torch.from_numpy(rng.integers(0, 1 << 14, n).astype(np.int32))
        b = torch.from_numpy(rng.integers(0, 1 << 14, n).astype(np.int32))
        words = tstep._int16_words(a) + tstep._int16_words(b)
        assert words.dtype == torch.int32 and words.numel() == (n + 1) // 2
        assert torch.equal(tstep._int16_lanes(words, n), a + b)
        rows = torch.stack([a, b])
        assert torch.equal(tstep._int16_lanes(tstep._int16_words(rows), n), rows)
