"""The shard engine in the port (``FedConfig(engine="shard")``) and its
kernels, against the JAX reference and the port's own scan engine, on
the CPU:

  * ``pack_flat``/``unpack_flat`` equal the reference's Pallas bodies
    (interpret mode) and its jnp codec bit for bit, at the reference
    test's widths, aligned and unaligned, and round-trip a 16-bit top
    field that sets the sign bit;
  * the folded ``decode_apply`` equals the reference's (interpret mode)
    within 1 ULP of the output type, float32 and bfloat16: XLA:CPU may
    contract ``shift + scale * z`` into an FMA;
  * ``secure_sum_bounded`` over a one-rank gloo group equals the plain
    sum; packed equals unpacked; an unpackable bound and the float
    baseline take the plain all_reduce;
  * one reference shard round (1-shard mesh) per mechanism, replayed in
    the port with the reference's cohort, kernel seed and clipped
    gradient stack: the sum exact (QMGeo within its budget), parameters
    within the reference's 1-ULP contract;
  * at one rank, the reference's tests/test_shard_engine.py cases against
    the port's scan engine;
  * at four gloo ranks (tests/torch_shard_worker.py, one process a rank),
    the checks of the reference's tests/shard_engine_checks.py.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import mechanisms as jmechs
from repro.core import wire as jwire
from repro.core.grid import RQMParams as JaxRQMParams
from repro.fed import cohort as jcohort
from repro.fed import rounds as jrounds
from repro.fed.config import FedConfig as JaxFedConfig
from repro.fed.trainer import FedTrainer as JaxFedTrainer
from repro.kernels import decode_apply_kernel as jdecode
from repro.kernels import ops as jops
from repro.kernels import pack_kernel as jpack
from repro.optim.optimizers import sgd as jax_sgd
from repro_torch.core import secagg, wire
from repro_torch.core.grid import RQMParams
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.fed import cohort, rounds, staging
from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer
from repro_torch.kernels import decode_apply_kernel, ops, pack_kernel
from repro_torch.launch.mesh import shard_group
from test_torch_materialized import NONE_ATOL, NONE_RTOL, SPECS, _ulp_tol
from test_torch_quantize import assert_levels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_pack_kernel.py:38-40
ALIGNED = [(4, 1024), (7, 512), (16, 256), (10, 3 * 128 * 3 - 2)]
UNALIGNED = [(4, 1000), (7, 130)]
PARAMS = dict(c=0.02, delta=0.02, m=16, q=0.42)
# the reference's tests/test_shard_engine.py problem
SMALL = dict(num_clients=24, clients_per_round=6, lr=1.0, eval_size=64, samples_per_client=8)
SPEC = SPECS["rqm"]


def _levels(bits, n, seed=0):
    rng = np.random.default_rng(seed + bits)
    return rng.integers(0, 1 << bits, n).astype(np.int32)


def _group():
    return shard_group(1, "cpu")


def _train(spec=SPEC, rounds_=5, **overrides):
    tr = FedTrainer(spec, FedConfig(**{**SMALL, **overrides}), device="cpu")
    tr.train(rounds=rounds_, eval_every=rounds_, log=lambda msg: None)
    return tr


# ---------------------------------------------------------------------------
# the kernels' plain versions against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,n", ALIGNED + UNALIGNED, ids=str)
def test_pack_unpack_flat_match_reference(bits, n):
    z = _levels(bits, n)
    words = pack_kernel.pack_flat(torch.from_numpy(z), bits)
    want = np.asarray(jpack.pack_flat(jnp.asarray(z), bits, interpret=True))
    np.testing.assert_array_equal(words.numpy(), want)
    np.testing.assert_array_equal(words.numpy(), np.asarray(jwire.pack_bits(jnp.asarray(z), bits)))
    back = pack_kernel.unpack_flat(words, bits, n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpack.unpack_flat(jnp.asarray(want), bits, n, interpret=True)))
    np.testing.assert_array_equal(back.numpy(), z)
    assert back.dtype == torch.int32 and words.dtype == torch.int32


def test_pack_unpack_top_field_sign_bit():
    z = torch.full((256,), (1 << 16) - 1, dtype=torch.int32)
    words = pack_kernel.pack_flat(z, 16)
    assert int(words.min()) < 0  # the sign bit is set
    np.testing.assert_array_equal(
        words.numpy(), np.asarray(jpack.pack_flat(jnp.asarray(z.numpy()), 16, interpret=True)))
    assert torch.equal(pack_kernel.unpack_flat(words, 16, 256), z)
    lanes, n = secagg.pack_levels(z)
    assert torch.equal(lanes, words) and torch.equal(secagg.unpack_levels(lanes, n), z)


def test_codec_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError, match="flat"):
        pack_kernel.pack_flat(torch.zeros(2, 3, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="packable field width"):
        pack_kernel.pack_flat(torch.zeros(3, dtype=torch.int32), 17)
    with pytest.raises(ValueError, match="do not fit"):
        pack_kernel.unpack_flat(torch.zeros(3, dtype=torch.int32), 10, 10)


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of each value, in ``x``'s float type, as float64."""
    a = x.abs()
    return (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).to(torch.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n_el", [1, 100, 4096, 70_000])  # tests/test_decode_apply_kernel.py
def test_decode_apply_matches_reference(n_el, dtype, record_property):
    """Within 1 ULP of each rounding: XLA:CPU contracts ``shift + scale * z``
    into an FMA, so the folded step may differ by one float32 ulp of its
    largest value ``|shift|``, and that can move the output's rounding to
    ``w``'s type by one ulp of the output."""
    rng = np.random.default_rng(n_el)
    w = torch.from_numpy(rng.normal(size=n_el).astype(np.float32)).to(dtype)
    z = torch.from_numpy(rng.integers(0, 24 * 15, n_el).astype(np.int32))
    params = RQMParams(**PARAMS)
    got = decode_apply_kernel.decode_apply(w, z, params, 24, 0.5)
    assert got.dtype == dtype and got.shape == w.shape
    assert torch.equal(got, decode_apply_kernel.decode_apply_ref(w, z, params, 24, 0.5))
    jw = jnp.asarray(w.to(torch.float32).numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    ref = jdecode.decode_apply(jw, jnp.asarray(z.numpy()), JaxRQMParams(**PARAMS), n=24,
                               lr=0.5, block_rows=8, interpret=True)
    assert ref.dtype == jw.dtype
    ref = torch.tensor(np.asarray(ref, np.float32)).to(dtype)
    shift, _ = decode_apply_kernel.folded_constants(params, 24, 0.5)
    tol = _ulp(torch.tensor(shift, dtype=torch.float32)) + torch.maximum(_ulp(got), _ulp(ref))
    diff = (got.to(torch.float64) - ref.to(torch.float64)).abs()
    assert bool((diff <= tol).all())
    record_property("outputs_differing_from_reference", int((got != ref).sum()))


def test_decode_apply_folds_lr_into_float32_scalars():
    p = RQMParams(**PARAMS)
    shift, scale = decode_apply_kernel.folded_constants(p, 24, 0.5)
    assert shift == float(np.float32(-0.5 * p.x_max))
    assert scale == float(np.float32(0.5 * 2.0 * p.x_max / (24 * 15)))
    w = torch.ones(7, 13, 5)
    z = torch.full((7, 13, 5), 15 * 8 // 2, dtype=torch.int32)  # mid-grid sum for n=8
    out = decode_apply_kernel.decode_apply(w, z, p, 8, 1.0)
    assert out.shape == w.shape
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-7)
    with pytest.raises(ValueError, match="one shape"):
        decode_apply_kernel.decode_apply(w, z.reshape(-1), p, 8, 1.0)


# ---------------------------------------------------------------------------
# the SecAgg collective on a one-rank group
# ---------------------------------------------------------------------------


class _Recorder:
    """Wraps ``dist.all_reduce`` and keeps the (dtype, numel) it reduced."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = dist.all_reduce

        def all_reduce(t, *args, **kwargs):
            self.calls.append((t.dtype, t.numel()))
            return real(t, *args, **kwargs)

        monkeypatch.setattr(dist, "all_reduce", all_reduce)


def test_secure_sum_bounded_on_one_rank(monkeypatch):
    group = _group()
    rec = _Recorder(monkeypatch)
    z = torch.from_numpy(np.random.default_rng(1).integers(0, 601, (6, 1001)).astype(np.int32))
    packed = secagg.secure_sum_bounded(z, group, 600)
    unpacked = secagg.secure_sum_bounded(z, group, 600, packed=False)
    too_wide = secagg.secure_sum_bounded(z, group, 1 << 20)
    for got in (packed, unpacked, too_wide):
        assert torch.equal(got, z) and got.shape == z.shape
    # 10-bit fields, 3 a word; then the dense int32 sum twice
    assert rec.calls == [(torch.int32, 2002), (torch.int32, 6006), (torch.int32, 6006)]
    g = torch.from_numpy(np.random.default_rng(2).normal(size=1001).astype(np.float32))
    assert torch.equal(secagg.secure_sum_bounded(g, group, 0), g)
    assert rec.calls[-1] == (torch.float32, 1001)
    assert torch.equal(secagg.secure_sum(z[0], group, packed=True), z[0])
    assert rec.calls[-1] == (torch.int32, 501)  # 16-bit lanes, 2 a word


def test_secagg_modular_sum_matches_reference():
    m = np.random.default_rng(3).integers(-(1 << 31), 1 << 31, (5, 64), dtype=np.int64)
    m = m.astype(np.int32)
    got = secagg.secagg_modular_sum(torch.from_numpy(m), 1 << 20)
    from repro.core import secagg as jsecagg

    want = np.asarray(jsecagg.secagg_modular_sum(jnp.asarray(m), 1 << 20))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert secagg.max_clients_for_packing(16) == jsecagg.max_clients_for_packing(16)


def test_shard_group_reuses_the_default_group():
    group = _group()
    assert dist.get_world_size(group) == 1 and shard_group(None, "cpu") is group
    with pytest.raises(ValueError, match="ranks"):
        shard_group(2, "cpu")


# ---------------------------------------------------------------------------
# one reference shard round, replayed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(SPECS))
def reference_shard_round(request):
    """One round of the reference's shard engine on a 1-shard mesh
    (materialized), with everything needed to replay it."""
    name = request.param
    jtr = JaxFedTrainer(jmechs.make_mechanism(SPECS[name]),
                        JaxFedConfig(engine="shard", shards=1, collect_sums=True, **SMALL))
    _, k_sample, k_enc, _ = jcohort.split_round_keys(jtr.cfg, jtr._key)
    ids, _ = jcohort.sample_slate(jtr.cfg, jtr.slate, k_sample)
    grads = jax.vmap(jtr._client_grad, in_axes=(None, 0))(
        jtr.flat, jrounds.index_batch(jtr.client_data, ids))
    flat0 = np.array(jtr.flat)
    jtr.round()
    z_sum = np.array(jtr.round_sums[-1])
    g_hat = jtr.mech.decode_sum(jnp.asarray(z_sum), jtr.cfg.clients_per_round)
    literal, _ = jax_sgd().update(g_hat, (), jnp.asarray(flat0), jtr.cfg.lr)
    return {"name": name, "ids": np.array(ids), "seed": int(np.asarray(jops.key_to_seed(k_enc))),
            "grads": np.array(grads), "flat0": flat0, "flat1": np.array(jtr.flat),
            "sum": z_sum, "literal": np.array(literal), "g_hat": np.array(g_hat),
            "mech": jtr.mech}


def test_reference_shard_round_replayed(reference_shard_round, record_property):
    ref = reference_shard_round
    name = ref["name"]
    mech = make_mechanism(SPECS[name])
    cfg = FedConfig(engine="shard", shards=1, collect_sums=True, **SMALL)
    handed = torch.from_numpy(ref["grads"])
    step = rounds.make_shard_round_step(mech, cfg, 6, 1, 0, _group(),
                                        lambda flat, batch: handed)
    data = {"ids": torch.arange(SMALL["num_clients"])}
    new, _, z_sum = step(torch.from_numpy(ref["flat0"]), (), data, ids=ref["ids"],
                         seed=ref["seed"])
    got = new.numpy()
    if name == "none":
        # held to the stack it was handed: the reference's jitted scan and
        # shard blocks compute float gradients up to 2e-7 away from the
        # eager vmap (its perround round 2.8e-8), and the noise-free sum is
        # those gradients
        np.testing.assert_allclose(z_sum.numpy(), ref["grads"].astype(np.float64).sum(0),
                                   rtol=NONE_RTOL, atol=NONE_ATOL)
        g_hat = ref["mech"].decode_sum(jnp.asarray(z_sum.numpy()), 6)
        literal, _ = jax_sgd().update(g_hat, (), jnp.asarray(ref["flat0"]), SMALL["lr"])
        np.testing.assert_allclose(got, np.asarray(literal), rtol=NONE_RTOL, atol=NONE_ATOL)
        return
    assert_levels(name, z_sum.numpy(), ref["sum"], record_property)
    same = z_sum.numpy() == ref["sum"]
    np.testing.assert_array_equal(got[same], ref["literal"][same])
    tol = _ulp_tol(mech, got, ref["flat0"], ref["g_hat"], SMALL["lr"])
    assert np.all(np.abs(got - ref["flat1"])[same] <= tol[same])
    record_property(f"{name}_params_differing_from_jitted_round",
                    int(np.count_nonzero(got != ref["flat1"])))


# ---------------------------------------------------------------------------
# one rank against the port's scan engine (tests/test_shard_engine.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["rqm", "qmgeo", "none"])
def test_shard_matches_scan_bit_for_bit(name):
    a = _train(SPECS[name])
    b = _train(SPECS[name], engine="shard", shards=1)
    assert b.shards == 1 and a.shards == 1
    assert torch.equal(a.flat, b.flat)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("fused", [False, True], ids=["materialized", "fused"])
def test_encoded_round_sums_match_scan(fused):
    a = _train(rounds_=4, collect_sums=True, fused_rounds=fused)
    b = _train(rounds_=4, engine="shard", collect_sums=True, fused_rounds=fused)
    assert len(a.round_sums) == len(b.round_sums) == 4
    for t, (x, y) in enumerate(zip(a.round_sums, b.round_sums)):
        assert x.dtype == np.int32
        np.testing.assert_array_equal(x, y, err_msg=f"round {t}")
    assert torch.equal(a.flat, b.flat)


def test_block_chunking_is_invariant():
    a = _train(engine="shard", shards=1)
    b = _train(engine="shard", shards=1, scan_block=2)
    assert torch.equal(a.flat, b.flat)


def test_packed_equals_unpacked(monkeypatch):
    rec = _Recorder(monkeypatch)
    a = _train(rounds_=4, engine="shard", shards=1, shard_packed=True)
    words = wire.packed_words(222_030, wire.sum_bits(a.mech.sum_bound(6)))  # 7-bit fields
    assert rec.calls == [(torch.int32, words)] * 4
    b = _train(rounds_=4, engine="shard", shards=1, shard_packed=False)
    assert rec.calls[4:] == [(torch.int32, 222_030)] * 4
    assert torch.equal(a.flat, b.flat)


def test_round_delegates_to_block():
    tr = FedTrainer(SPEC, FedConfig(engine="shard", shards=1, **SMALL), device="cpu")
    tr.round()
    assert tr.accountant.rounds == 1
    tr.run_block(2)
    assert tr.accountant.rounds == 3


def test_streamed_matches_scan_bit_for_bit():
    a = _train(rounds_=4)
    b = _train(rounds_=4, engine="shard", shards=1, staging="stream")
    assert torch.equal(a.flat, b.flat)
    assert b.client_data is None


def test_stream_replays_without_moving_the_generator():
    tr = FedTrainer(SPEC, FedConfig(engine="shard", staging="stream", **SMALL), device="cpu")
    state = tr.generator.get_state()
    ids = staging.replay_cohorts(tr.cfg, 6, tr.generator, 3)
    assert torch.equal(tr.generator.get_state(), state)
    g = torch.Generator()
    g.set_state(state)
    for t in range(3):
        np.testing.assert_array_equal(ids[t], cohort.sample_slate(tr.cfg, 6, g).numpy())
        cohort.draw_seed(g)


def test_staged_bytes_bounded_by_active_cohort():
    """tests/test_shard_engine.py: staged bytes scale with rounds x cohort,
    not with the population size."""
    n, s, rounds_, block = 6, 8, 4, 2
    cohort_bytes = n * s * (28 * 28 * 4 + 4)  # f32 images + i32 labels
    totals = {}
    for num_clients in (2_000, 20_000):
        tr = FedTrainer(SPEC, FedConfig(**{**SMALL, "num_clients": num_clients,
                                           "clients_per_round": n, "samples_per_client": s},
                                        engine="shard", shards=1, staging="stream",
                                        scan_block=block), device="cpu")
        tr.run_block(rounds_)
        totals[num_clients] = tr.staged_bytes_total
        assert tr.staged_bytes_total == rounds_ * cohort_bytes
        assert tr.staged_bytes_last_block == block * cohort_bytes
    assert totals[2_000] == totals[20_000]
    assert totals[20_000] < 20_000 * s * (28 * 28 * 4 + 4) / 50
    full = FedTrainer(SPEC, FedConfig(engine="shard", **SMALL), device="cpu")
    assert full.staged_bytes_total == 24 * 8 * (28 * 28 * 4 + 4)


def test_stream_requires_shard_engine():
    with pytest.raises(ValueError, match="stream.*requires"):
        FedTrainer(SPEC, FedConfig(staging="stream", **SMALL), device="cpu")
    with pytest.raises(ValueError, match="unknown staging"):
        FedTrainer(SPEC, FedConfig(engine="shard", staging="lazy", **SMALL), device="cpu")


def test_epsilon_uses_full_cohort():
    tr = _train(rounds_=3, engine="shard", shards=1)
    full = np.asarray([tr.mech.per_round_epsilon(6, a) for a in tr.cfg.accountant_alphas])
    np.testing.assert_array_equal(tr.per_round_eps, full)
    np.testing.assert_allclose(tr.accountant.rdp_epsilon(8.0),
                               3 * tr.mech.per_round_epsilon(6, 8.0), rtol=1e-12)


@pytest.mark.parametrize("overrides,error,match", [
    (dict(shards=2, clients_per_round=4), ValueError, "ranks"),
    # 4370 x 15 >= 2^16: the sum needs 17 bits (one alpha, streamed: the
    # trainer accounts and stages before the engine refuses)
    (dict(clients_per_round=4_370, num_clients=4_370, shard_packed=True, staging="stream",
          accountant_alphas=(2.0,)), ValueError, "unsafe"),
    (dict(model_shards=2), ValueError, "supports_model_axis"),
    (dict(engine="perround", model_shards=2), ValueError, "requires engine='shard'"),
    (dict(scan_block=0), ValueError, "scan_block"),
], ids=["too-many-shards", "unsafe-forced-packing", "model-shards", "model-shards-perround",
        "scan-block"])
def test_shard_validation(overrides, error, match):
    with pytest.raises(error, match=match):
        FedTrainer(SPEC, FedConfig(**{**SMALL, "engine": "shard", **overrides}), device="cpu")


def test_float_mechanism_never_packs(monkeypatch):
    rec = _Recorder(monkeypatch)
    tr = FedTrainer(SPECS["none"], FedConfig(engine="shard", **SMALL), device="cpu")
    ops.reset_launches()
    tr.run_block(2)
    assert rec.calls == [(torch.float32, 222_030)] * 2
    assert torch.isfinite(tr.flat).all() and dict(ops.launches) == {}


# ---------------------------------------------------------------------------
# four gloo ranks (tests/shard_engine_checks.py)
# ---------------------------------------------------------------------------


def test_four_gloo_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    store = tmp_path / "store"
    worker = os.path.join(ROOT, "tests", "torch_shard_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), "4", str(store)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-3000:]}"
        assert f"rank {r}: ALL SHARD CHECKS PASS" in out
