"""Where the port records its spans (``telemetry/timing.py:span``): the
scan engine's four block phases and the LM train step's four phases on
the CPU, the step's bits against the same arithmetic without spans; and,
marked ``cuda``, that the spans add no synchronisation on the card. This
file imports neither JAX nor ``repro``:

    PYTHONPATH=src python -m pytest -m cuda --noconftest tests/test_torch_spans.py
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import warnings

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.convert import leaves, map_leaves
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.distributed import step as tstep
from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer
from repro_torch.models import meta as meta_lib
from repro_torch.models import model as model_lib
from repro_torch.models.common import ParallelCtx
from repro_torch.optim import make_optimizer, schedules
from repro_torch.telemetry import timing

SPEC = "rqm:c=0.05,m=16,q=0.42"
SMALL = dict(num_clients=24, clients_per_round=6, lr=1.0, eval_size=64, samples_per_client=4)
BLOCK_PHASES = ["round_block.draw", "round_block.copy_in", "round_block.replay",
                "round_block.finish"]
STEP_PHASES = ["train_step.forward", "train_step.backward", "train_step.encode",
               "train_step.update"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphed block and the kernels have no CPU mode")
    return torch.device("cuda")


def children(log: list, parent) -> list:
    return [s for s in log if s.parent == parent.index]


def inside(child, parent) -> bool:
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


@pytest.mark.parametrize("subsampling,dropout", [("fixed", 0.0), ("poisson", 0.3)])
def test_scan_blocks_log_their_four_phases(subsampling, dropout):
    """One ``round_block`` a ``run_block`` call; under it, each engine
    block's draw, copy_in, replay and finish in that order, carrying the
    accountant's round count at the block's start, its rounds and (finish)
    its realized clients, whose sum is the trainer's. Noise-free, so that
    accounting each realized size costs nothing."""
    cfg = FedConfig(engine="scan", scan_block=3, subsampling=subsampling, dropout=dropout,
                    **SMALL)
    tr = FedTrainer("none:c=0.05", cfg, device="cpu")
    timing.clear_spans()
    tr.run_block(5)  # engine blocks of 3 and 2
    tr.run_block(2)
    log = timing.spans()
    calls = [s for s in log if s.parent is None]
    assert [s.name for s in calls] == ["round_block", "round_block"]
    assert {s.name for s in log} == {"round_block", *BLOCK_PHASES}
    blocks = []
    for call in calls:
        kids = children(log, call)
        assert [k.name for k in kids] == BLOCK_PHASES * (len(kids) // 4)
        assert all(inside(k, call) for k in kids)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        blocks += [kids[i:i + 4] for i in range(0, len(kids), 4)]
    assert [b[0].attrs for b in blocks] == [{"first": 0, "rounds": 3}, {"first": 3, "rounds": 2},
                                            {"first": 5, "rounds": 2}]
    for b in blocks:
        assert all(k.attrs["first"] == b[0].attrs["first"] and
                   k.attrs["rounds"] == b[0].attrs["rounds"] for k in b)
        first, rounds = b[0].attrs["first"], b[0].attrs["rounds"]
        assert b[3].attrs["realized"] == sum(tr.realized_n[first:first + rounds])
    assert sum(b[3].attrs["realized"] for b in blocks) == sum(tr.realized_n)
    assert len(tr.realized_n) == 7


def test_a_build_that_starts_nvcc_is_one_span(monkeypatch, tmp_path):
    """``kernels.build`` with the count of libraries compiled, only when
    nvcc runs: a stand-in compiler that writes its output file."""
    import sys

    from repro_torch.kernels import _build

    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "cuda")
    monkeypatch.setattr(_build, "library_path", lambda name: tmp_path / "cuda" / f"{name}.so")
    timing.clear_spans()
    assert set(_build.build(["pack", "quantize"])) == {"pack", "quantize"}
    assert _build.build(["pack", "quantize"]) == {}
    assert set(_build.build(["pack", "round_sum"])) == {"round_sum"}
    log = timing.spans()
    assert [(s.name, s.attrs, s.parent) for s in log] == [
        ("kernels.build", {"libs": 2}, None), ("kernels.build", {"libs": 1}, None)]


def parent_step(cfg, mech, opt, lr_fn, ctx, params, opt_state, step, batch, seeds):
    """The train step's arithmetic with no span, op for op as
    ``build_train_step_fn``'s step computed it before it recorded any."""
    meta_tree = model_lib.param_meta(cfg, tp=ctx.tp)
    p_leaves = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        total, aux = model_lib.loss_fn(map_leaves(lambda i, _: p_leaves[i], params), cfg, ctx,
                                       batch, remat=False, compute_dtype=torch.float32)
        loss = total / ctx.tp
        grads = list(torch.autograd.grad(loss, p_leaves))
    grads = meta_lib.sync_grads(grads, meta_tree, ctx)
    ghat = tstep.encode_aggregate_decode(grads, meta_tree, mech, ctx, seeds)
    ghat = map_leaves(lambda i, _: ghat[i], params)
    params, opt_state = opt.update(ghat, opt_state, params, lr_fn(step))
    return params, opt_state, loss.detach() * ctx.tp


def small_step(opt_name: str, device="cpu"):
    cfg = registry.get_config("mamba2-370m", reduced=True)
    mech, opt = make_mechanism("rqm:c=0.02,m=16,q=0.42"), make_optimizer(opt_name)
    lr_fn = schedules.warmup_cosine(0.2, 1, 10, device=device)
    params = model_lib.init_params(torch.Generator(device).manual_seed(3), cfg, device=device)
    gen = torch.Generator(device).manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen, device=device)
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    seeds = tstep.train_seeds(5, 1, 0, len(leaves(params)))
    step_fn = tstep.build_train_step_fn(cfg, mech, opt, lr_fn, ParallelCtx(), remat=False,
                                        compute_dtype=torch.float32)
    return cfg, mech, opt, lr_fn, params, batch, seeds, step_fn


def copy_tree(tree):
    return map_leaves(lambda i, p: p.detach().clone(), tree) if tree else tree


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_train_step_logs_its_four_phases_and_keeps_its_bits(opt_name):
    """``train_step`` (its ``step``) over forward, backward, encode (its
    leaves) and update, in order; parameters, optimizer state and loss
    bit for bit those of the same arithmetic with no span."""
    cfg, mech, opt, lr_fn, params, batch, seeds, step_fn = small_step(opt_name)
    state = opt.init(params)
    want_p, want_s, want_loss = parent_step(cfg, mech, opt, lr_fn, ParallelCtx(),
                                            copy_tree(params), copy_tree(state), 1, batch, seeds)
    timing.clear_spans()
    got_p, got_s, metrics = step_fn(copy_tree(params), copy_tree(state), 1, batch, seeds)
    log = timing.spans()
    top = [s for s in log if s.parent is None]
    assert [s.name for s in top] == ["train_step"] and top[0].attrs == {"step": 1}
    kids = children(log, top[0])
    assert [k.name for k in kids] == STEP_PHASES and len(log) == 5
    assert all(inside(k, top[0]) for k in kids)
    assert kids[2].attrs == {"leaves": len(leaves(params))}
    assert torch.equal(metrics["loss"], want_loss)
    for g, w in zip(leaves(got_p), leaves(want_p)):
        assert torch.equal(g, w)
    for g, w in zip(leaves(got_s), leaves(want_s)):
        assert torch.equal(g, w)


def sync_warnings(fn) -> int:
    """The synchronisations ``fn`` makes on the card, as
    ``set_sync_debug_mode("warn")`` reports them (not the mode's own
    warning, once a process, that it "does not yet detect all
    synchronizing operations")."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in seen)


def no_sync(fn) -> None:
    """``fn`` under ``set_sync_debug_mode("error")``: a synchronisation
    raises, naming its line."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_spans_add_no_synchronisation_on_the_card(cuda):
    """A graphed block, the first after the capture among them,
    synchronises nowhere, with its spans off and under a profiler; a train
    step with its spans no more than its arithmetic with none, off and
    under a profiler."""
    from torch.profiler import ProfilerActivity, profile

    tr = FedTrainer(SPEC, FedConfig(**SMALL), device=cuda)
    tr.run_block(1)  # the capture
    no_sync(lambda: tr.run_block(4))
    assert sync_warnings(lambda: torch.zeros(1, device=cuda).item()) == 1  # it sees one
    assert sync_warnings(lambda: tr.run_block(4)) == 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        no_sync(lambda: tr.run_block(4))
        torch.cuda.synchronize()
    assert {"round_block", *BLOCK_PHASES} <= {e.name for e in prof.events()}
    cfg, mech, opt, lr_fn, params, batch, seeds, step_fn = small_step("sgd", cuda)
    state = opt.init(params)
    step_fn(copy_tree(params), copy_tree(state), 1, batch, seeds)  # kernels built, warm
    torch.cuda.synchronize()
    plain = sync_warnings(lambda: parent_step(cfg, mech, opt, lr_fn, ParallelCtx(),
                                              copy_tree(params), copy_tree(state), 1, batch,
                                              seeds))
    assert sync_warnings(lambda: step_fn(copy_tree(params), copy_tree(state), 1, batch,
                                         seeds)) <= plain
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        assert sync_warnings(lambda: step_fn(copy_tree(params), copy_tree(state), 1, batch,
                                             seeds)) <= plain
        torch.cuda.synchronize()
