"""The port's aggregator round-server (``launch/aggregator.py``) against
the JAX reference's on the CPU.

Contracts:
  * the same ``ClientUpdate``s (dense, packed, mixed, bare arrays, stale,
    weight-0) through both servers give the same rounds served, realized
    sizes and eps history, the same snapshot keys and values but uptime,
    and parameters within the reference's 1-ULP contract (its decode is a
    jitted static-n decode, which XLA:CPU contracts into an FMA; ROADMAP
    C5); under an async policy, the same discards and discounts;
  * the smoke deployment's halt: a budget of 40 stops at exactly 8 rounds
    at 36.61 spent, and further submits are refused;
  * the packed-direct word sum (every payload packed at one width within
    the cohort's bound: a cohort of 1 at 4 bits, or payloads packed wide)
    equals the unpack-at-intake sum bit for bit, at 4, 8 and 16 bits, the
    16-bit fields crossing the int32 sign bit; a cohort past the bound
    unpacks at intake;
  * the fingerprint bytes are the reference's, and a checkpoint written by
    either package's server resumes in the other's, continuing as the
    uninterrupted run;
  * the service thread and a blocking producer under a small queue serve
    the same rounds as a synchronous drain.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import dataclasses
import threading
import warnings

import numpy as np
import pytest
import torch

from repro.core import wire as jwire
from repro.core.mechanisms import make_mechanism as jmake_mechanism
from repro.fed import updates as jupdates
from repro.launch import aggregator as jagg
from repro_torch.core import wire
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.fed import updates
from repro_torch.launch import aggregator as agg

DIM = 203  # odd: every packed width leaves a tail
SPEC = "rqm:c=0.02,m=16,q=0.42"  # the CLI's default deployment
SMOKE = dict(dim=64, cohort=4, batch=4, batches=10, queue_limit=4, budget=40.0)


def _levels(rng, k, dim=DIM, m=16):
    return rng.integers(0, m, (k, dim)).astype(np.int32)


def _pair_of_updates(rows, *, packed=False, bits=4, **kw):
    """The same updates for both packages: (port's, reference's)."""
    ours, theirs = [], []
    for i, z in enumerate(rows):
        if packed:
            p, jp = wire.PackedPayload.pack(z, bits), jwire.PackedPayload.pack(z, bits)
        else:
            p = jp = z
        ours.append(updates.ClientUpdate(payload=p, client_id=i, **kw))
        theirs.append(jupdates.ClientUpdate(payload=jp, client_id=i, **kw))
    return ours, theirs


def _servers(spec=SPEC, dim=DIM, **kw):
    return (agg.AggregatorServer(make_mechanism(spec), dim, device="cpu", **kw),
            jagg.AggregatorServer(jmake_mechanism(spec), dim, **kw))


def _ulp_tol(server, before, after, lr):
    """The reference's 1-ULP contract: lr x one ulp of 2 x_max, plus one
    of the output."""
    x_max = server.mech.params.x_max
    return lr * np.spacing(np.float32(2.0 * x_max)) + np.spacing(
        np.maximum(np.abs(before), np.abs(after)).astype(np.float32))


def _same_servers(ours, theirs, lr=0.5, before=None, intake=True):
    assert ours.rounds_served == theirs.rounds_served
    assert ours.realized_n == theirs.realized_n
    assert len(ours.accountant.history) == len(theirs.accountant.history)
    for a, b in zip(ours.accountant.history, theirs.accountant.history):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)
    got, want = ours.flat.numpy(), np.asarray(theirs.flat)
    ref = np.zeros(DIM, np.float32) if before is None else before
    # the 1-ULP contract a round, over the rounds served
    tol = max(ours.rounds_served, 1) * _ulp_tol(ours, ref, want, lr)
    assert np.all(np.abs(got - want) <= tol)
    a, b = ours.snapshot(), theirs.snapshot()
    assert a.keys() == b.keys()
    a.pop("uptime_seconds"), b.pop("uptime_seconds")
    assert a["eps_spent"] == pytest.approx(b["eps_spent"], rel=1e-9)
    a.pop("eps_spent"), b.pop("eps_spent")
    a.pop("eps_remaining"), b.pop("eps_remaining")
    if not intake:  # servers resumed from another's checkpoint took fewer batches
        for k in ("batches_accepted", "batches_rejected"):
            a.pop(k), b.pop(k)
    assert a == b
    # a server resumed from a checkpoint has the extras of its own rounds
    k = min(len(ours.round_extras), len(theirs.round_extras))
    assert ours.round_extras[len(ours.round_extras) - k:] == \
        theirs.round_extras[len(theirs.round_extras) - k:]


def _both(fn, ours, theirs):
    return fn(ours), fn(theirs)


@pytest.mark.parametrize("form", ["dense", "packed", "mixed", "bare"])
def test_forms_aggregate_as_the_reference(form):
    rng = np.random.default_rng(1)
    ours, theirs = _servers(cohort=4, queue_limit=8)
    for b in range(3):
        rows = _levels(rng, 4)
        if form == "bare":
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                assert ours.submit(rows) and theirs.submit(rows)
            continue
        u, ju = _pair_of_updates(rows, packed=form != "dense", round_tag=b)
        if form == "mixed":
            du, dju = _pair_of_updates(rows, round_tag=b)
            u[::2], ju[::2] = du[::2], dju[::2]
        assert ours.submit(u) and theirs.submit(ju)
    assert _both(lambda s: s.drain(), ours, theirs) == (3, 3)
    _same_servers(ours, theirs)
    packed = {"dense": 0, "packed": 4, "mixed": 2, "bare": 0}[form]
    assert [e["packed_payloads"] for e in ours.round_extras] == [packed] * 3
    assert ours.round_extras[0]["uplink_bytes"] == \
        packed * wire.packed_nbytes(DIM, 4) + (4 - packed) * DIM * 4


def test_stale_and_weight_zero_under_an_async_policy():
    rng = np.random.default_rng(2)
    ours, theirs = _servers(cohort=4, engine="async:cadence=3,max_staleness=1,"
                                                  "staleness_weight=poly:0.5")
    assert ours.cohort == theirs.cohort == 3 and ours.engine == "async"
    for b, tag in enumerate((0, 0, 1, 0, 2, 3)):
        u, ju = _pair_of_updates(_levels(rng, 2), packed=b % 2 == 1, round_tag=tag)
        u[0], ju[0] = (dataclasses.replace(u[0], weight=int(b != 3)),
                       dataclasses.replace(ju[0], weight=int(b != 3)))
        ours.submit(u), theirs.submit(ju)
        _both(lambda s: s.drain(), ours, theirs)
        _same_servers(ours, theirs)
    assert ours.buffer.discarded > 0
    assert any(e["staleness_discount"] < 1.0 for e in ours.round_extras)
    assert ours._run_meta().keys() == theirs._run_meta().keys()
    assert ours._run_meta()["staleness_policy"] == theirs._run_meta()["staleness_policy"]


def test_all_weight_zero_releases_nothing():
    ours, theirs = _servers(cohort=2)
    u, ju = _pair_of_updates(_levels(np.random.default_rng(3), 2), packed=True, weight=0)
    ours.submit(u), theirs.submit(ju)
    assert _both(lambda s: s.step(), ours, theirs) == (True, True)
    assert ours.realized_n == [0] and not ours.flat.any()
    _same_servers(ours, theirs)


def test_noise_free_floats_sum_as_the_reference():
    """Float payloads sum row after row (the reference's numpy order) and
    decode as the literal ``g_sum / n``: the port equals that replay
    exactly. The reference's jitted static-n decode is a reciprocal
    multiply (an XLA rewrite): within one ulp of the decode, times lr,
    plus one of the output, a round."""
    rng = np.random.default_rng(4)
    lr, n = 0.3, 5
    ours, theirs = _servers("none:c=0.05", cohort=n, lr=lr)
    literal = np.zeros(DIM, np.float32)
    tol = np.zeros(DIM, np.float32)
    for _ in range(2):
        rows = np.clip(rng.normal(0.0, 0.05, (n, DIM)), -0.05, 0.05).astype(np.float32)
        u, ju = _pair_of_updates(rows)
        ours.submit(u), theirs.submit(ju)
        g_sum = rows[0].copy()
        for row in rows[1:]:
            g_sum = g_sum + row
        g_hat = g_sum / np.float32(n)
        literal = literal - np.float32(lr) * g_hat
        tol += np.float32(lr) * np.spacing(np.abs(g_hat)) + np.spacing(np.abs(literal))
    _both(lambda s: s.drain(), ours, theirs)
    np.testing.assert_array_equal(ours.flat.numpy(), literal)
    assert np.all(np.abs(ours.flat.numpy() - np.asarray(theirs.flat)) <= tol)
    assert ours.realized_n == theirs.realized_n == [n, n]


def test_smoke_deployment_halts_at_eight_rounds():
    s = SMOKE
    ours, theirs = _servers(dim=s["dim"], cohort=s["cohort"], queue_limit=s["queue_limit"],
                            budget_eps=s["budget"])
    rng = np.random.default_rng(0)
    for b in range(s["batches"]):
        rows = rng.integers(0, 16, (s["batch"], s["dim"])).astype(np.int32)
        u, ju = _pair_of_updates(rows, round_tag=b)
        for server, batch in ((ours, u), (theirs, ju)):
            if server.submit(batch, block=False):
                server.drain()
    for server in (ours, theirs):
        snap = server.snapshot()
        assert snap["halted"] and snap["rounds_served"] == 8
        assert round(snap["eps_spent"], 2) == 36.61 and snap["eps_spent"] <= s["budget"]
        assert not server.submit(u if server is ours else ju, block=False)
    assert ours.snapshot()["eps_spent"] == pytest.approx(theirs.snapshot()["eps_spent"],
                                                         rel=1e-12)
    assert ours.realized_n == theirs.realized_n == [4] * 8


def test_cli_smoke_on_the_cpu(capsys):
    agg.main(["--smoke", "--device", "cpu", "--snapshot-every", "100"])
    out = capsys.readouterr().out
    assert "aggregator smoke OK: 8 rounds, halted=True, eps_spent=36.61" in out


@pytest.mark.parametrize("spec,cohort,bits", [
    (SPEC, 1, 4),                      # one RQM m=16 client at its own width
    (SPEC, 4, 8),                      # wide payloads: 4 x 15 < 2**8
    ("rqm:c=0.02,m=32768,q=0.42", 2, 16),  # 2 x 32767 fills 16 bits
])
def test_packed_direct_sum_is_the_unpacked_sum(spec, cohort, bits):
    rng = np.random.default_rng(bits)
    m = make_mechanism(spec).params.m
    server, _ = _servers(spec, cohort=cohort)
    for weights in ([1] * cohort, [0] + [1] * (cohort - 1), [0] * cohort):
        rows = _levels(rng, cohort, m=m)
        if bits == 16:
            rows[:, -8:] = m - 1  # fields of 65534: the top field's sign bit
        take = [updates.ClientUpdate(payload=wire.PackedPayload.pack(z, bits), weight=w)
                for z, w in zip(rows, weights)]
        assert server._packed_bits(take) == bits
        direct = server._secure_sum(take).numpy()
        dense = server._secure_sum([dataclasses.replace(u, payload=u.payload_array())
                                    for u in take])
        assert server._packed_bits([dataclasses.replace(take[0], payload=rows[0])]) is None
        np.testing.assert_array_equal(direct, dense.numpy())
        np.testing.assert_array_equal(direct, (rows * np.asarray(weights)[:, None]).sum(0))
    # one more client than the bound allows: every payload unpacks at intake
    past, _ = _servers(spec, cohort=cohort + 1)
    more = [updates.ClientUpdate(payload=wire.PackedPayload.pack(z, bits))
            for z in _levels(rng, cohort + 1, m=m)]
    if not wire.packable(past.mech.sum_bound(cohort + 1), bits):
        assert past._packed_bits(more) is None
    mixed = more[:1] + [dataclasses.replace(more[1], payload=more[1].payload_array())]
    assert server._packed_bits(mixed) is None


def test_fingerprint_and_cross_package_resume(tmp_path):
    rng = np.random.default_rng(6)
    stream = [_pair_of_updates(_levels(rng, 4), packed=b % 2 == 0, round_tag=b)
              for b in range(5)]
    for writer in ("reference", "port"):
        d = tmp_path / writer
        ours, theirs = _servers(cohort=4, ckpt_dir=str(d), ckpt_every=3)
        assert bytes(ours._fingerprint()) == bytes(theirs._fingerprint())
        assert ours._run_meta()["fingerprint"] == theirs._run_meta()["fingerprint"]
        first = theirs if writer == "reference" else ours
        for u, ju in stream[:3]:
            first.submit(ju if first is theirs else u)
        assert first.drain() == 3  # checkpointed at round 3
        second = ours if first is theirs else theirs
        assert second.resume() == 3
        np.testing.assert_array_equal(np.asarray(second.flat), np.asarray(first.flat))
        assert second.realized_n == first.realized_n
        for u, ju in stream[3:]:
            first.submit(ju if first is theirs else u)
            second.submit(ju if second is theirs else u)
        assert _both(lambda s: s.drain(), first, second) == (2, 2)
        _same_servers(ours, theirs, intake=False)
    other = agg.AggregatorServer(make_mechanism(SPEC), DIM, device="cpu", lr=0.25,
                                 ckpt_dir=str(tmp_path / "port"))
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        other.resume()


def test_float64_init_serves_and_resumes_as_float32(tmp_path):
    """A float64 ``init_flat`` gives float32 parameters, as the reference's
    (x64 off), so the port's checkpoint resumes in the reference's server."""
    rng = np.random.default_rng(9)
    init = rng.normal(0.0, 0.1, DIM)  # float64
    stream = [_pair_of_updates(_levels(rng, 4), round_tag=b) for b in range(3)]
    ours, theirs = _servers(cohort=4, init_flat=init, ckpt_dir=str(tmp_path), ckpt_every=2)
    assert ours.flat.dtype == torch.float32 and np.asarray(theirs.flat).dtype == np.float32
    np.testing.assert_array_equal(ours.flat.numpy(), np.asarray(theirs.flat))
    for u, ju in stream[:2]:
        ours.submit(u)
    assert ours.drain() == 2
    back = jagg.AggregatorServer(jmake_mechanism(SPEC), DIM, cohort=4, init_flat=init,
                                 ckpt_dir=str(tmp_path))
    assert back.resume() == 2
    np.testing.assert_array_equal(np.asarray(back.flat), ours.flat.numpy())
    ours.submit(stream[2][0])
    back.submit(stream[2][1])
    assert _both(lambda s: s.drain(), ours, back) == (1, 1)
    _same_servers(ours, back, before=init.astype(np.float32), intake=False)


def test_service_thread_under_backpressure():
    rng = np.random.default_rng(7)
    batches = [_pair_of_updates(_levels(rng, 2), packed=True, round_tag=0)[0]
               for _ in range(12)]
    served = agg.AggregatorServer(make_mechanism(SPEC), DIM, cohort=4, queue_limit=1,
                                  device="cpu")
    drained = agg.AggregatorServer(make_mechanism(SPEC), DIM, cohort=4, device="cpu")

    def produce():
        for b in batches:
            assert served.submit(b, block=True, timeout=30.0)

    producer = threading.Thread(target=produce)
    served.start(poll=0.001)
    producer.start()
    producer.join(timeout=60)
    served.drain()  # whatever the loop had not reached yet
    served.shutdown()
    for b in batches:
        drained.submit(b)
    drained.drain()
    assert served.rounds_served == drained.rounds_served == 6
    assert torch.equal(served.flat, drained.flat)
    assert served.batches_rejected == 0


def test_simulated_stream_and_validation():
    mech = make_mechanism(SPEC)
    gen = torch.Generator().manual_seed(0)
    dense = agg.simulate_client_updates(mech, DIM, gen, 3, round_tag=2, device="cpu")
    packed = agg.simulate_client_updates(mech, DIM, gen, 3, round_tag=2, packed=True,
                                         device="cpu", first_id=3)
    assert [u.client_id for u in dense + packed] == list(range(6))
    assert all(u.round_tag == 2 and not u.packed and u.payload.shape == (DIM,) for u in dense)
    assert all(u.packed and u.payload.bits == 4 for u in packed)
    assert all(0 <= u.payload_array().min() and u.payload_array().max() <= 15
               for u in dense + packed)
    # the same draws give the same payloads
    again = agg.simulate_client_batch(mech, DIM, torch.Generator().manual_seed(0), 3,
                                      device="cpu")
    np.testing.assert_array_equal(again, np.stack([u.payload for u in dense]))
    for kw, match in ((dict(cohort=0), "cohort must be >= 1"),
                      (dict(queue_limit=0), "queue_limit must be >= 1"),
                      (dict(ckpt_every=2), "ckpt_every requires ckpt_dir"),
                      (dict(init_flat=np.zeros(3, np.float32)), "init_flat shape"),
                      (dict(engine="async:timeout=2.0"), "SIMULATED"),
                      (dict(engine="scan"), "must be 'async'")):
        with pytest.raises(ValueError, match=match):
            agg.AggregatorServer(mech, DIM, device="cpu", **kw)
    server = agg.AggregatorServer(mech, DIM, device="cpu")
    with pytest.raises(ValueError, match=f"must be \\({DIM},\\)"):
        server.submit(updates.ClientUpdate(payload=np.zeros(DIM + 1, np.int32)))
    with pytest.raises(ValueError, match="must hold"):
        server.submit(updates.ClientUpdate(payload=wire.PackedPayload.pack(
            np.zeros(DIM - 1, np.int32), 4)))
    assert server._run_meta()["backend"] == "cpu"


def test_concurrent_producers_lose_no_update():
    """More producer threads than cores, a short switch interval: every
    batch is counted once, every update aggregated once, none left over."""
    import sys

    producers, batches = 16, 10
    server = agg.AggregatorServer(make_mechanism(SPEC), 16, cohort=4, queue_limit=3,
                                  device="cpu")
    update = updates.ClientUpdate(payload=np.zeros(16, np.int32))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        server.start(poll=0.0001)
        threads = [threading.Thread(target=lambda: [server.submit([update], timeout=30.0)
                                                    for _ in range(batches)])
                   for _ in range(producers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        server.shutdown()
    finally:
        sys.setswitchinterval(interval)
    server.drain()
    total = producers * batches
    assert server.batches_accepted == total and server.batches_rejected == 0
    assert server.updates_aggregated == total and server.rounds_served == total // 4
    assert server.buffered_updates() == 0


def test_server_decodes_at_the_fixed_cohort_scale():
    """At n = 3 of c = 0.02 the fixed cohort's double scale and the traced
    one differ: the server decodes its realized count as a Python int (the
    reference's static-n decode), not as a device count."""
    mech = make_mechanism(SPEC)
    server = agg.AggregatorServer(mech, DIM, cohort=4, lr=0.5, device="cpu")
    rows = _levels(np.random.default_rng(10), 4)
    u, _ = _pair_of_updates(rows)
    u[2] = dataclasses.replace(u[2], weight=0)
    server.submit(u)
    assert server.step() and server.realized_n == [3]
    z = torch.from_numpy((rows * np.array([1, 1, 0, 1])[:, None]).sum(0).astype(np.int32))
    fixed = -0.5 * mech.decode_sum(z, 3)
    traced = -0.5 * mech.decode_sum(z, torch.tensor(3, dtype=torch.int32))
    assert torch.equal(server.flat, fixed) and not torch.equal(server.flat, traced)
