"""One gloo rank of the port's side of the tensor-parallel parity tests
(tests/test_torch_tp_*.py), on the CPU:

    PYTHONPATH=src:tests python tests/torch_tp_worker.py <job> <rank> <world> \\
        <store file> <inputs.npz> <out dir> [job arguments]

Each rank joins a default group of ``world`` ranks on a FileStore, runs
its job, writes ``<out dir>/<job>_rank<r>.npz`` (or prints its checks)
and exits 0 when every hold passed. Imports no JAX.

  * ``layers``: each case of tp_cases.LAYERS of tp == world, as
    tests/tp_reference.py runs it, this rank's parameters the slices of
    the global ones in ``inputs.npz``;
  * ``ops``: each model-axis collective and its backward (the cotangent
    through ``torch.autograd.grad``), tp == world;
  * ``client``: each case of tp_cases.CLIENT of tp == world, the shard
    engine's per-client release (``rounds.make_client_grad`` over the
    bound lm task's model axis), unclipped and at the spec's clip, from
    the global flat parameters of ``inputs.npz``, and at one local step
    the task's held-out loss;
  * ``step <DxM>``: the train step (``make_train_step``) from the
    reference's global parameters, at its folded per-leaf seeds, its
    batches, for tp_cases.STEP_STEPS steps; the final parameters gathered
    to the global tree; every replicated or duplicated leaf bit-equal
    across its group;
  * ``launch <DxM>``: ``launch/train.py`` at the mesh, packed and plain
    (== bit for bit), ``PxDxM`` spellings of the mesh (==), and at 1x2 a
    run checkpointed at 2 of 4 steps == resumed from it, sgd and adam;
  * ``cuda_ops``: the collectives and their backwards on CUDA tensors
    (the ranks share the card over gloo) against their sums on the CPU;
  * ``fed <SxM>``: the shard engine's 2-D lm round (tests/fed_lm_2d_checks.py's
    problem), its per-round sums and parameters written for the test to
    compare across grids;
  * ``perf``: tests/tp_reference.py's ``perf`` job on this rank: each
    of tp_cases.PERF_VARIANTS through ``make_train_step`` (the port's
    default remat), float32 compute, at the reference's folded seeds; the
    global parameters gathered; then one ZeRO-1 step
    on the given gradients (``model.loss_fn`` replaced by the linear
    loss), its summed levels kept as ``_client_scatter_sum16`` returns
    them, this rank's new parameters and master shard written;
  * ``serve <mode> <DxM>``: tests/tp_reference.py's ``serve`` job on this
    rank: ``make_prefill_step``/``make_decode_step`` at the mesh from the
    one-rank parameters (``convert.shard_from_one_rank``), the caches of
    mode ``seq`` through ``convert.cache_from_numpy``, the int8 ones from
    ``meta.zeros``; this rank's tokens of every step and final caches
    written with its model and client index; in mode ``batch``
    ``lm_head_argmax`` at each of tp_cases.ARGMAX_TPS.
"""
import datetime
import hashlib
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

import tp_cases
from repro_torch.convert import leaves, map_leaves, shard_from_numpy
from repro_torch.launch.mesh import mesh_groups
from repro_torch.models import meta as meta_lib
from repro_torch.models.common import ParallelCtx

# the serve steps at the reference's side's explicit float32 (tp_reference.py)
F32 = dict(compute_dtype=torch.float32, param_dtype=torch.float32)


def model_ctx(tp: int, *, seq_parallel: bool = False) -> ParallelCtx:
    g = GROUPS[tp]
    return ParallelCtx(model_axis="model", tp=tp, model_group=g.model,
                       model_rank=g.model_index, subgroups=g.subgroups,
                       seq_parallel=seq_parallel)


def layer(case):
    """(param_meta, fwd(params, ctx, x, extra) -> (y, aux loss)), as
    tests/tp_reference.py's ``_layer``."""
    from repro_torch.models import attention, mlp, model, moe, ssm

    tp, spec = case["tp"], dict(case["spec"])
    if case["layer"] == "attn":
        s = attention.AttentionSpec(**spec)
        return attention.param_meta(s, tp), lambda p, ctx, x, e: (
            attention.forward(p, s, ctx, x, e["positions"]), 0.0)
    if case["layer"] == "mlp":
        kind = spec.pop("kind")
        return mlp.param_meta(kind, spec["d_model"], spec["d_ff"], tp), lambda p, ctx, x, e: (
            mlp.forward(p, kind, ctx, x), 0.0)
    if case["layer"] == "moe":
        s = moe.MoESpec(**spec)

        def fwd(p, ctx, x, e):
            y, aux = moe.forward(p, s, ctx, x)
            return y, aux["moe_aux_loss"] + 0.1 * aux["moe_drop_frac"]
        return moe.param_meta(s, tp), fwd
    if case["layer"] == "ssm":
        s = ssm.SSMSpec(**spec)
        return ssm.param_meta(s, tp), lambda p, ctx, x, e: (ssm.forward(p, s, ctx, x), 0.0)
    V, D = spec["vocab"], tp_cases.D
    meta = {"embed": meta_lib.Meta((tp, V // tp, D), torch.float32, ("model", None, None), 1),
            "lm_head": meta_lib.Meta((D, tp, V // tp), torch.float32, (None, "model", None), 1)}

    def fwd(p, ctx, x, e):
        h = model.embed(p, None, ctx, e["tokens"]) + x
        return None, model.lm_head_loss(p, None, ctx, h, e["labels"],
                                        seq_chunk=spec["seq_chunk"])[0]
    return meta, fwd


def job_layers(rank, world, inputs, out_dir):
    out = {}
    for name, case in tp_cases.LAYERS.items():
        tp = case["tp"]
        if tp != world:
            continue
        meta, fwd = layer(case)
        ctx = model_ctx(tp, seq_parallel=case["sp"])
        glob = {k: inputs[f"{name}/{k}"] for k in meta}
        params = shard_from_numpy(glob, meta, tp, rank, "cpu")
        p = [t.requires_grad_() for t in leaves(params)]
        x = torch.from_numpy(inputs[f"{name}/x"]).requires_grad_()
        r = torch.from_numpy(inputs[f"{name}/r"])
        B, S = case["B"], case["S"]
        extra = {"positions": torch.arange(S, dtype=torch.int32)[None].expand(B, S)}
        if case["layer"] == "head":
            extra.update(tokens=torch.from_numpy(inputs[f"{name}/tokens"]),
                         labels=torch.from_numpy(inputs[f"{name}/labels"]))
        y, aux = fwd(map_leaves(lambda i, _: p[i], params), ctx, x, extra)
        if y is None:
            loss, y = aux, torch.zeros((B, S, tp_cases.D))
        else:
            y = ctx.sp_gather(y)
            loss = (y * r).sum() + aux
        grads = torch.autograd.grad(loss / tp, p + [x])
        gp = meta_lib.sync_grads(list(grads[:-1]), meta, ctx)
        out[f"{name}/y"], out[f"{name}/loss"] = y.detach().numpy(), loss.detach().numpy()
        out[f"{name}/gx"] = grads[-1].numpy()
        for i, g in enumerate(gp):
            out[f"{name}/grad{i}"] = g.numpy()
    np.savez(os.path.join(out_dir, f"layers_tp{world}_rank{rank}.npz"), **out)


def job_ops(rank, world, inputs, out_dir):
    name = f"ops_tp{world}"
    tp = world
    on, off = model_ctx(tp, seq_parallel=True), model_ctx(tp)
    x_all = inputs[f"{name}/x"]
    cts = {k: torch.from_numpy(inputs[f"{name}/{k}"][rank])
           for k in ("c_same", "c_gather", "c_scatter")}
    x = torch.from_numpy(x_all[rank])
    res = {"pmax_model": off.pmax_model(x), "model_index": torch.tensor([off.model_index()]),
           "subgroup_psum_2": off.subgroup_psum(x, 2)}
    if tp >= 4:
        res["subgroup_psum_4"] = off.subgroup_psum(x, 4)
    fns = {"psum_model": (off.psum_model, "c_same"), "sp_gather": (on.sp_gather, "c_gather"),
           "sp_scatter": (on.sp_scatter, "c_scatter"),
           "sp_scatter_off": (off.sp_scatter, "c_same"), "sp_slice": (on.sp_slice, "c_scatter")}
    for k, (f, c) in fns.items():
        xi = x.clone().requires_grad_()
        y = f(xi)
        res[k] = y.detach()
        res[k + "_vjp"] = torch.autograd.grad(y, xi, cts[c])[0]
    np.savez(os.path.join(out_dir, f"ops_tp{world}_rank{rank}.npz"),
             **{f"{name}/{k}": v.numpy() for k, v in res.items()})


def job_client(rank, world, inputs, out_dir):
    from repro_torch.convert import ravel
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.fed import rounds
    from repro_torch.fed.config import FedConfig
    from repro_torch.fed.tasks import make_task

    ctx, out = model_ctx(world), {}
    for name, case in tp_cases.CLIENT.items():
        if case["tp"] != world:
            continue
        cfg = FedConfig(**tp_cases.client_fed(case))
        task = make_task(cfg.task, cfg, "cpu")
        task.bind_model_axis(ctx)
        like, unravel = ravel(task.init_params(torch.Generator().manual_seed(0)))
        flat = torch.from_numpy(inputs[f"{name}/flat"])
        assert flat.shape == like.shape, (flat.shape, like.shape)
        batch = {k: torch.from_numpy(inputs[f"{name}/{k}"]) for k in ("tokens", "labels")}
        for tag, mech in (("raw", make_mechanism("none:c=1e30")),
                          ("clipped", make_mechanism(tp_cases.CLIENT_SPEC))):
            grads = rounds.make_client_grad(mech, unravel, task, cfg, ctx=ctx)
            out[f"{name}/{tag}"] = grads(flat, batch).numpy()
        if case["local_steps"] == 1:
            out[f"{name}/eval_loss"] = np.asarray(task.evaluate(flat, unravel)["loss"])
    np.savez(os.path.join(out_dir, f"client_tp{world}_rank{rank}.npz"), **out)


def held_copies(params, meta, ctx) -> int:
    """Every leaf duplicated over the model axis (sync > 1) bit-equal
    across its copies: the sha256 of its bytes gathered over the model
    group, equal within each aligned group of ``sync`` ranks. Returns the
    leaves held."""
    n = 0
    for t, m in zip(leaves(params), leaves(meta)):
        if m.sync <= 1:
            continue
        digest = hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()
        every = [None] * ctx.tp
        dist.all_gather_object(every, digest, group=ctx.model_group)
        g = min(m.sync, ctx.tp)
        mine = every[ctx.model_index() // g * g:(ctx.model_index() // g + 1) * g]
        assert len(set(mine)) == 1, (m, every)
        n += 1
    return n


def job_step(rank, world, inputs, out_dir, mesh):
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.distributed.step import make_plan, make_train_step
    from repro_torch.models import model
    from repro_torch.optim import make_optimizer, schedules

    dims = tuple(int(d) for d in mesh.split("x"))
    cfg = get_config(tp_cases.STEP_ARCH, reduced=True)
    mech, opt = make_mechanism(tp_cases.STEP_SPEC), make_optimizer("sgd")
    shape = InputShape("t", tp_cases.STEP_SEQ, tp_cases.STEP_BATCH, "train")
    plan = make_plan(dims, "cpu")
    step_fn, specs = make_train_step(cfg, plan, mech, opt,
                                     schedules.constant(tp_cases.STEP_LR, device="cpu"), shape,
                                     remat=False, compute_dtype=torch.float32)
    meta, ctx = specs["param_meta"], specs["ctx"]
    assert ctx.seq_parallel and ctx.client_index == rank // dims[1]
    glob = map_leaves(lambda i, _: inputs[f"params0/{i}"], meta)
    params = shard_from_numpy(glob, meta, plan.tp, ctx.model_index(), "cpu")
    state, losses = opt.init(params), []
    for t in range(tp_cases.STEP_STEPS):
        batch = {k: torch.from_numpy(inputs[f"{k}{t}"]) for k in ("tokens", "labels")}
        seeds = [int(s) for s in inputs[f"seeds{t}"][rank]]
        params, state, metrics = step_fn(params, state, t, batch, seeds)
        losses.append(float(metrics["loss"]))
    held = held_copies(params, meta, ctx)
    glob = meta_lib.gather_tree(params, meta, ctx)
    if rank == 0:
        np.savez(os.path.join(out_dir, f"step_{mesh}.npz"), losses=np.asarray(losses),
                 **{f"params/{i}": t.numpy() for i, t in enumerate(leaves(glob))})
    print(f"rank {rank}: step {mesh}: {held} duplicated or replicated leaves bit-equal "
          f"across their groups")


def _linear_loss(p, cfg, ctx, batch, remat=True, compute_dtype=None):
    """tests/tp_reference.py's stand-in for ``model.loss_fn``: ``sum(p *
    g)``, g this rank's given gradient leaves (``batch["grads"]``)."""
    total = sum((a * g).sum() for a, g in zip(leaves(p), batch["grads"]))
    return total, {"ce_loss": total, "moe_aux_loss": torch.zeros(())}


def job_perf(rank, world, inputs, out_dir):
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.distributed import step as tstep
    from repro_torch.models import model
    from repro_torch.optim import make_optimizer, schedules

    dims = tuple(int(d) for d in tp_cases.PERF_MESH.split("x"))
    cfg = get_config(tp_cases.PERF_ARCH, reduced=True)
    mech, opt = make_mechanism(tp_cases.PERF_SPEC), make_optimizer("sgd")
    lr_fn = schedules.constant(tp_cases.PERF_LR, device="cpu")
    shape = InputShape("t", tp_cases.PERF_SEQ, tp_cases.PERF_BATCH, "train")
    plan = tstep.make_plan(dims, "cpu")
    meta = model.param_meta(cfg, tp=plan.tp)
    glob = map_leaves(lambda i, _: inputs[f"params0/{i}"], meta)
    out = {}
    for name, kw in tp_cases.PERF_VARIANTS.items():
        step_fn, specs = tstep.make_train_step(cfg, plan, mech, opt, lr_fn, shape,
                                               compute_dtype=torch.float32, **kw)
        ctx = specs["ctx"]
        assert ctx.seq_parallel and ctx.sp_compress == bool(kw.get("sp_compress"))
        params = shard_from_numpy(glob, specs["param_meta"], plan.tp, ctx.model_index(), "cpu")
        state = ({"master": tstep.zero1_master_shard(params, ctx)} if kw.get("zero1")
                 else opt.init(params))
        losses = []
        for t in range(tp_cases.PERF_STEPS):
            batch = {k: torch.from_numpy(inputs[f"{k}{t}"]) for k in ("tokens", "labels")}
            params, state, metrics = step_fn(params, state, t, batch,
                                             [int(s) for s in inputs[f"seeds{t}"][rank]])
            losses.append(float(metrics["loss"]))
            if t == 0 and name == "sp_compress":
                for i, p in enumerate(leaves(meta_lib.gather_tree(params, meta, ctx))):
                    out[f"{name}/params1/{i}"] = p.numpy()
        out[f"{name}/losses"] = np.asarray(losses)
        for i, t in enumerate(leaves(meta_lib.gather_tree(params, meta, ctx))):
            out[f"{name}/params/{i}"] = t.numpy()
    # one ZeRO-1 step on the given gradients
    ctx = plan.ctx()
    params = shard_from_numpy(glob, meta, plan.tp, ctx.model_index(), "cpu")
    master = tstep.zero1_master_shard(params, ctx)
    grads = [torch.from_numpy(inputs[f"grads/{rank}/{i}"]) for i in range(len(leaves(meta)))]
    body = tstep.build_zero1_train_step_fn(cfg, mech, lr_fn, ctx, remat=False,
                                           compute_dtype=torch.float32, agg_dtype="auto")
    kept, scatter16, loss_fn = [], tstep._client_scatter_sum16, model.loss_fn

    def keeping(x, c):
        kept.append(scatter16(x, c))
        return kept[-1]

    params0 = [t.clone() for t in leaves(params)]  # the step updates both in place
    master0 = [t.clone() for t in leaves(master)]
    tstep._client_scatter_sum16, model.loss_fn = keeping, _linear_loss
    try:
        p1, o1, _ = body(params, {"master": master}, 0, {"grads": grads},
                         [int(s) for s in inputs["seeds0"][rank]])
    finally:
        tstep._client_scatter_sum16, model.loss_fn = scatter16, loss_fn
    assert len(kept) == len(grads)
    for i, (z, p, m) in enumerate(zip(kept, leaves(p1), leaves(o1["master"]))):
        out[f"given/levels/{i}"], out[f"given/params/{i}"] = z.numpy(), p.numpy()
        out[f"given/master/{i}"] = m.numpy()
        out[f"given/params0/{i}"] = params0[i].numpy()
        out[f"given/master0/{i}"] = master0[i].numpy()
    np.savez(os.path.join(out_dir, f"perf_rank{rank}.npz"), **out)
    print(f"rank {rank}: perf {tp_cases.PERF_MESH}: {len(tp_cases.PERF_VARIANTS)} variants, "
          f"{len(kept)} leaves' summed levels kept")


def digest(tree) -> str:
    h = hashlib.sha256()
    for t in leaves(tree):
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _train(argv: list) -> dict:
    import contextlib
    import io

    from repro_torch.launch import train

    with contextlib.redirect_stdout(io.StringIO()):
        return train.main(["--device", "cpu", "--seq", "16", "--batch", "2",
                           "--log-every", "100"] + argv)


def same_everywhere(what: str, value: str) -> None:
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, value)
    assert len(set(every)) == 1, (what, every)


def job_launch(rank, world, inputs, out_dir, mesh, arch, *spellings):
    """The launcher at ``mesh`` on reduced ``arch``: plain == packed, ==
    every other spelling of the mesh, bit for bit; the duplicated and
    replicated leaves equal across their groups; at 1x2 also 4 steps ==
    checkpointed at 2 and resumed, sgd and adam."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model

    for arch in (arch,):
        base = ["--arch", arch, "--reduced", "--steps", "2", "--mechanism", "rqm"]
        runs = {"plain": _train(base + ["--mesh-shape", mesh]),
                "packed": _train(base + ["--mesh-shape", mesh, "--packed"])}
        for other in spellings:
            runs[other] = _train(base + ["--mesh-shape", other])
        want = digest(runs["plain"]["params"])
        for tag, out in runs.items():
            assert digest(out["params"]) == want, (arch, tag)
            assert out["losses"] == runs["plain"]["losses"], (arch, tag)
        cfg = get_config(arch, reduced=True)
        tp = int(mesh.split("x")[-1])
        ctx = model_ctx(tp)
        held = held_copies(runs["plain"]["params"], model.param_meta(cfg, tp), ctx)
        print(f"rank {rank}: launch {arch} {mesh}: plain == packed == {list(spellings)} bit for "
              f"bit; {held} duplicated or replicated leaves bit-equal across their groups")
    if mesh != "1x2":
        return
    for opt in ("sgd", "adam"):
        base = ["--arch", "mamba2-370m", "--reduced", "--steps", "4", "--mesh-shape", mesh,
                "--server-opt", opt]
        a, b = os.path.join(out_dir, f"ckpt_{opt}_a"), os.path.join(out_dir, f"ckpt_{opt}_b")
        full = _train(base + ["--ckpt-every", "2", "--ckpt-dir", a])
        dist.barrier()
        if rank == 0:
            os.makedirs(b)
            os.link(os.path.join(a, "step_00000002.npz"), os.path.join(b, "step_00000002.npz"))
        dist.barrier()
        resumed = _train(base + ["--resume", "--ckpt-dir", b])
        assert resumed["start"] == 2
        assert digest(full["params"]) == digest(resumed["params"]), opt
        assert digest(full["opt_state"]) == digest(resumed["opt_state"]), opt
        assert full["losses"][2:] == resumed["losses"], opt
        print(f"rank {rank}: resume {opt} at {mesh}: 4 steps == checkpointed at 2 and resumed, "
              f"bit for bit")


def job_fed(rank, world, inputs, out_dir, grid):
    """tests/fed_lm_2d_checks.py's problem on the shard engine at ``grid``
    (shards x model shards): the trainer's state (its per-round sums, the
    parameters, the realized cohorts, the epsilons) written by rank 0;
    the parameters bit-equal on every rank."""
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.fed.config import FedConfig
    from repro_torch.fed.trainer import FedTrainer

    S, M = (int(d) for d in grid.split("x"))
    tr = FedTrainer(make_mechanism("rqm", c=0.05), FedConfig(
        engine="shard", shards=S, model_shards=M, collect_sums=True, **tp_cases.FED),
        device="cpu")
    assert tr.shards == S and tr.engine.model_shards == M and tr.task.tp == M
    tr.train(rounds=tp_cases.FED["rounds"], eval_every=tp_cases.FED["rounds"],
             log=lambda *_: None)
    same_everywhere("parameters", hashlib.sha256(tr.flat.numpy().tobytes()).hexdigest())
    m = tr.evaluate()
    if rank == 0:
        np.savez(os.path.join(out_dir, f"fed_{grid}.npz"), flat=tr.flat.numpy(),
                 sums=np.stack(tr.round_sums), realized_n=np.asarray(tr.realized_n),
                 per_round_eps=tr.per_round_eps, rdp8=tr.accountant.rdp_epsilon(8.0),
                 loss=m["loss"], ppl=m["ppl"])
    print(f"rank {rank}: fed {grid}: parameters bit-equal on every rank")


def job_serve(rank, world, inputs, out_dir, mode, mesh):
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import cache_from_numpy, shard_from_one_rank
    from repro_torch.distributed.step import make_decode_step, make_plan, make_prefill_step
    from repro_torch.launch.mesh import mesh_groups
    from repro_torch.models import model

    dims = tuple(int(d) for d in mesh.split("x"))
    plan = make_plan(dims, "cpu")
    shape = InputShape("t", tp_cases.SERVE_CAP, tp_cases.SERVE_BATCH[mode], "decode")
    out = {}

    def save(prefix, tokens, caches):
        out[f"{prefix}tokens"] = torch.stack(tokens).numpy()
        for i, c in enumerate(leaves(caches)):
            out[f"{prefix}cache/{i}"] = c.float().numpy() if c.dtype == torch.bfloat16 \
                else c.numpy()

    for arch in tp_cases.SERVE_ARCHS[mode]:
        cfg = get_config(arch, reduced=True)
        dec, specs = make_decode_step(cfg, plan, shape, **F32)
        ctx, rows = specs["ctx"], specs["token_rows"]
        one = map_leaves(lambda i, _: torch.from_numpy(inputs[f"{arch}/params/{i}"]),
                         model.param_meta(cfg, 1))
        params = shard_from_one_rank(one, specs["param_meta"], plan.tp, ctx.model_index())
        pos = tp_cases.SERVE_PROMPT
        if mode == "batch":
            pre, pspecs = make_prefill_step(cfg, plan, shape, seq_parallel=True, **F32)
            assert pspecs["ctx"].seq_parallel == (plan.tp > 1)
            nxt, caches = pre(params, torch.from_numpy(inputs[f"{arch}/tokens"])[rows])
        else:
            ref = map_leaves(lambda i, _: inputs[f"{arch}/cache/{i}"], specs["cache_meta"])
            caches = cache_from_numpy(ref, specs["cache_meta"], plan.tp, ctx.model_index(),
                                      client=ctx.client_index, n_clients=ctx.n_clients,
                                      device="cpu")
            nxt = torch.from_numpy(inputs[f"{arch}/tok"])[rows][:, 0]
        tokens = [nxt]
        for t in range(tp_cases.SERVE_STEPS):
            nxt, caches = dec(params, caches, nxt[:, None], pos + t)
            tokens.append(nxt)
        save(f"{arch}/", tokens, caches)
        dec_q, qspecs = make_decode_step(cfg, plan, shape, kv_quant=True, **F32)
        caches = meta_lib.zeros(qspecs["cache_meta"], plan.tp, ctx.n_clients, "cpu")
        nxt, tokens = torch.from_numpy(inputs[f"{arch}/tok0"])[rows][:, 0], []
        for t in range(tp_cases.SERVE_INT8_STEPS):
            nxt, caches = dec_q(params, caches, nxt[:, None], t)
            tokens.append(nxt)
        save(f"{arch}/q_", tokens, caches)
    if mode == "batch":  # lm_head_argmax at each model axis, ties across shards
        head, h = (torch.from_numpy(inputs[f"argmax/{k}"]) for k in ("head", "h"))
        for tp in tp_cases.ARGMAX_TPS:
            g = mesh_groups(world // tp, tp, "cpu")
            ctx = ParallelCtx(model_axis="model", tp=tp, model_group=g.model,
                              model_rank=g.model_index, subgroups=g.subgroups)
            v_l = head.shape[1] // tp
            mine = {"lm_head": head[:, None, g.model_index * v_l:(g.model_index + 1) * v_l]}
            out[f"argmax{tp}"] = model.lm_head_argmax(mine, ctx, h).numpy()
    out["model_index"] = np.asarray(plan.ctx().model_index())
    out["client_index"] = np.asarray(plan.ctx().client_index)
    np.savez(os.path.join(out_dir, f"serve_{mode}_{mesh}_rank{rank}.npz"), **out)
    print(f"rank {rank}: serve {mode} {mesh}")


def job_cuda_ops(rank, world):
    """Each collective of a tp = ``world`` ParallelCtx and its backward on
    CUDA tensors (gloo; the ranks share the card), against the sums made
    on the CPU from every rank's input, bit for bit."""
    on, off = model_ctx(world, seq_parallel=True), model_ctx(world)
    rng = np.random.default_rng(11)
    xs = torch.from_numpy(rng.normal(size=(world, 2, 4, 3)).astype(np.float32))
    cs = torch.from_numpy(rng.normal(size=(world, 2, 4, 3)).astype(np.float32))
    cg = torch.from_numpy(rng.normal(size=(world, 2, 4 * world, 3)).astype(np.float32))
    cl = torch.from_numpy(rng.normal(size=(world, 2, 4 // world, 3)).astype(np.float32))
    s_l = 4 // world
    want = {"psum_model": (xs.sum(0), cs.sum(0)),
            "sp_gather": (torch.cat(list(xs), 1),
                          cg.sum(0)[:, rank * 4:(rank + 1) * 4]),
            "sp_scatter": (xs.sum(0)[:, rank * s_l:(rank + 1) * s_l],
                           torch.cat(list(cl), 1)),
            "sp_slice": (xs[rank][:, rank * s_l:(rank + 1) * s_l],
                         torch.nn.functional.pad(cl[rank], (0, 0, rank * s_l,
                                                            (world - 1 - rank) * s_l)))}
    cts = {"psum_model": cs, "sp_gather": cg, "sp_scatter": cl, "sp_slice": cl}
    fns = {"psum_model": off.psum_model, "sp_gather": on.sp_gather,
           "sp_scatter": on.sp_scatter, "sp_slice": on.sp_slice}
    for k, f in fns.items():
        x = xs[rank].cuda().requires_grad_()
        y = f(x)
        g = torch.autograd.grad(y, x, cts[k][rank].cuda())[0]
        assert y.is_cuda and g.is_cuda, k
        assert torch.equal(y.detach().cpu(), want[k][0]), k
        assert torch.equal(g.cpu(), want[k][1]), k
    assert torch.equal(off.pmax_model(xs[rank].cuda()).cpu(), xs.max(0).values)
    print(f"rank {rank}: the model-axis collectives on cuda == their CPU sums")


def main():
    job, rank, world, store, src, out_dir = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    inputs = dict(np.load(src)) if os.path.exists(src) else {}
    if job in ("layers", "ops", "client"):
        GROUPS[world] = mesh_groups(1, world, "cpu")
        {"layers": job_layers, "ops": job_ops, "client": job_client}[job](
            rank, world, inputs, out_dir)
    elif job == "cuda_ops":
        torch.cuda.set_device(0)
        GROUPS[world] = mesh_groups(1, world, "cuda")
        job_cuda_ops(rank, world)
    elif job == "step":
        job_step(rank, world, inputs, out_dir, sys.argv[7])
    elif job == "fed":
        job_fed(rank, world, inputs, out_dir, sys.argv[7])
    elif job == "perf":
        job_perf(rank, world, inputs, out_dir)
    elif job == "serve":
        job_serve(rank, world, inputs, out_dir, *sys.argv[7:9])
    elif job == "launch":
        tp = int(sys.argv[7].split("x")[-1])
        GROUPS[tp] = mesh_groups(world // tp, tp, "cpu")
        job_launch(rank, world, inputs, out_dir, *sys.argv[7:])
    else:
        raise SystemExit(f"unknown job {job!r}")
    dist.destroy_process_group()


GROUPS = {}

if __name__ == "__main__":
    main()
