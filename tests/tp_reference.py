"""The JAX reference's side of the tensor-parallel parity tests
(tests/test_torch_tp_*.py), run as a subprocess with four fake CPU
devices:

    PYTHONPATH=src:tests python tests/tp_reference.py <job> <inputs.npz> <outputs.npz>

job ``layers``: each case of tp_cases.LAYERS inside a manual shard_map
over a ("model",) mesh of its tp, at the global parameters, input and
cotangent weights of ``inputs.npz`` (``<case>/<leaf>``, ``<case>/x``,
``<case>/r``, the head case's ``<case>/tokens`` and ``<case>/labels``):
the gathered output, the loss, every rank's synced parameter gradients
and input gradient (stacked over the model axis);

job ``ops``: each model-axis collective of ``ParallelCtx`` and its vjp,
on every rank's own input and cotangent (``<case>/x``, ``<case>/c*``),
stacked over the model axis;

job ``client``: each case of tp_cases.CLIENT, the reference's
``make_client_grad`` at its tp inside a shard_map over a ("model",) mesh,
unclipped (a clip of 1e30), at the global flat parameters of
``inputs.npz`` (``<case>/flat``) for each client's batch
(``<case>/tokens``, ``<case>/labels``, stacked over the clients); and,
at one local step, the lm task's held-out loss at tp (``evaluate``);

job ``step <DxM>``: the reference's jitted ``make_train_step`` on a
reduced tp_cases.STEP_ARCH at the mesh, from the global parameters, the
token batches and the step keys (``key<t>``, key data) of
``inputs.npz``: the losses and the global parameters after;

job ``perf``: the variants of tests/sharded_checks.py's
``check_perf_variants`` that tp_cases.PERF_REFERENCE holds the port's
against (base, int8 sequence-parallel gathers) through the reference's
jitted ``make_train_step`` at tp_cases.PERF_MESH, float32 compute, from
the global parameters, batches and step keys of ``inputs.npz``: each
one's losses and global parameters; then one jitted step of the
reference's ``build_zero1_train_step_fn`` on the given per-rank
gradients ``grads/<rank>/<i>`` (its ``model.loss_fn`` replaced by the
linear loss ``sum(p * g)``, whose gradient is ``g``): the new global
parameters and master; and op by op each rank's summed levels
(``levels/<rank>/<i>``) and new master shard (``_zero1_given``);

job ``precision``: each of tp_cases.PRECISION_ARCHS reduced at bfloat16
(XLA's excess precision off: every op rounded as run op by op): its
parameters (``<arch>/params/<i>``, as float32), ``forward_hidden``'s
hidden states, the loss of ``<arch>/tokens`` and ``<arch>/labels``,
``prefill``'s caches (as float32) and the greedy tokens of prefill and
tp_cases.PRECISION_STEPS decode steps (``<arch>/greedy``);

job ``serve <mode> <DxM>``: for each of tp_cases.SERVE_ARCHS[mode], the
reference's ``make_prefill_step``/``make_decode_step`` at the mesh
(float32 compute and parameters) from the one-rank parameters of
``inputs.npz`` (``<arch>/params/<i>``) re-laid at tp as
``tests/sharded_checks.py`` re-lays them: mode ``batch``, prefill of
``<arch>/tokens`` then SERVE_STEPS greedy decode steps; mode ``seq``,
SERVE_STEPS decode steps from the one-rank caches ``<arch>/cache/<i>``
(re-laid as ``check_flash_decoding`` re-lays them) and token
``<arch>/tok``; both modes, SERVE_INT8_STEPS int8 steps from zero
caches and ``<arch>/tok0``. Out: the tokens of every step and the final
global caches (``<arch>/tokens``, ``<arch>/cache/<i>``, and ``q_``-
prefixed for int8, scales as float32); and ``lm_head_argmax`` at each
of tp_cases.ARGMAX_TPS (``argmax<tp>``) on ``argmax/head``, ``argmax/h``;

job ``dryrun <DxM> [arch ...]``: for each arch (default
tp_cases.DRYRUN_ARCHS) reduced, the reference's ``dryrun.build_step`` at
the mesh on a train shape of tp_cases.DRYRUN_SEQ x DRYRUN_BATCH, lowered
and compiled: ``<arch>/summary``, ``hlo_analysis.collective_bytes`` of
the optimised HLO (JSON), and ``<arch>/operands``, each collective's
operands one by one, ``[kind, bytes, group size]`` (JSON; a combined
tuple all-reduce gives one entry an operand).
"""
import os
import sys

# job ``precision`` rounds every bfloat16 op as its dtype says, as the
# reference run op by op does (jax.disable_jit); XLA's default keeps fused
# chains in float32
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4" + (
    " --xla_allow_excess_precision=false" if sys.argv[1:2] == ["precision"] else "")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import tp_cases  # noqa: E402
from repro.distributed.step import compat_shard_map  # noqa: E402
from repro.models import meta as meta_lib  # noqa: E402
from repro.models.common import ParallelCtx  # noqa: E402


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _layer(case):
    """(param_meta, fwd(params, ctx, x, extra) -> (y, aux loss))."""
    from repro.models import attention, mlp, moe, model, ssm

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
    meta = {"embed": meta_lib.Meta((tp, V // tp, D), jnp.float32, P("model", None, None), 1),
            "lm_head": meta_lib.Meta((D, tp, V // tp), jnp.float32, P(None, "model", None), 1)}

    def fwd(p, ctx, x, e):
        h = model.embed(p, None, ctx, e["tokens"]) + x
        return None, model.lm_head_loss(p, None, ctx, h, e["labels"],
                                        seq_chunk=spec["seq_chunk"])[0]
    return meta, fwd


def layers(inputs: dict) -> dict:
    out = {}
    for name, case in tp_cases.LAYERS.items():
        tp = case["tp"]
        meta, fwd = _layer(case)
        ctx = ParallelCtx(model_axis="model", tp=tp, seq_parallel=case["sp"])
        params = {k: jnp.asarray(inputs[f"{name}/{k}"]) for k in meta}
        x, r = jnp.asarray(inputs[f"{name}/x"]), jnp.asarray(inputs[f"{name}/r"])
        B, S = case["B"], case["S"]
        extra = {"positions": jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))}
        if case["layer"] == "head":
            extra.update(tokens=jnp.asarray(inputs[f"{name}/tokens"]),
                         labels=jnp.asarray(inputs[f"{name}/labels"]))

        def body(p, x, r, extra):
            def loss_fn(p, x):
                y, aux = fwd(p, ctx, x, extra)
                if y is None:
                    return aux / tp, jnp.zeros((B, S, tp_cases.D))
                y = ctx.sp_gather(y)
                return (jnp.sum(y * r) + aux) / tp, y

            (loss, y), (gp, gx) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(p, x)
            gp = meta_lib.sync_grads(gp, meta, ctx)
            return y, loss * tp, jax.tree_util.tree_map(lambda g: g[None], gp), gx[None]

        pspecs = meta_lib.pspecs(meta)
        stacked = jax.tree_util.tree_map(lambda _: P("model"), pspecs)
        mapped = compat_shard_map(
            body, mesh=_mesh((tp,), ("model",)),
            in_specs=(pspecs, P(), P(), jax.tree_util.tree_map(lambda _: P(), extra)),
            out_specs=(P(), P(), stacked, P("model")), check_vma=False)
        y, loss, gp, gx = jax.jit(mapped)(params, x, r, extra)
        out[f"{name}/y"], out[f"{name}/loss"], out[f"{name}/gx"] = y, loss, gx
        for i, g in enumerate(jax.tree_util.tree_leaves(gp)):
            out[f"{name}/grad{i}"] = g
    return out


def ops(inputs: dict) -> dict:
    """Every rank's forward and vjp of each collective, stacked."""
    out = {}
    for name, case in tp_cases.OPS.items():
        tp = case["tp"]
        on = ParallelCtx(model_axis="model", tp=tp, seq_parallel=True)
        off = ParallelCtx(model_axis="model", tp=tp)
        fns = {"psum_model": off.psum_model, "sp_gather": on.sp_gather,
               "sp_scatter": on.sp_scatter, "sp_scatter_off": off.sp_scatter,
               "sp_slice": on.sp_slice}

        def body(x, c_same, c_gather, c_scatter):
            x = x[0]
            res = {"pmax_model": off.pmax_model(x), "model_index": off.model_index()[None],
                   "subgroup_psum_2": off.subgroup_psum(x, 2)}
            if tp >= 4:
                res["subgroup_psum_4"] = off.subgroup_psum(x, 4)
            cts = {"psum_model": c_same, "sp_gather": c_gather, "sp_scatter": c_scatter,
                   "sp_scatter_off": c_same, "sp_slice": c_scatter}
            for k, f in fns.items():
                y, vjp = jax.vjp(f, x)
                res[k] = y
                res[k + "_vjp"] = vjp(cts[k][0])[0]
            return {k: v[None] for k, v in res.items()}

        keys = ["pmax_model", "model_index", "subgroup_psum_2"] + (
            ["subgroup_psum_4"] if tp >= 4 else []) + [
            k + s for k in fns for s in ("", "_vjp")]
        mapped = compat_shard_map(body, mesh=_mesh((tp,), ("model",)),
                                  in_specs=(P("model"),) * 4,
                                  out_specs={k: P("model") for k in keys}, check_vma=False)
        res = jax.jit(mapped)(*(jnp.asarray(inputs[f"{name}/{k}"])
                                for k in ("x", "c_same", "c_gather", "c_scatter")))
        out.update({f"{name}/{k}": v for k, v in res.items()})
    return out


def client(inputs: dict) -> dict:
    from types import SimpleNamespace

    from jax.flatten_util import ravel_pytree

    from repro.fed.config import FedConfig
    from repro.fed.rounds import make_client_grad
    from repro.fed.tasks import make_task

    out = {}
    for name, case in tp_cases.CLIENT.items():
        tp = case["tp"]
        mesh = _mesh((tp,), ("model",))
        ctx = ParallelCtx(model_axis="model", tp=tp)
        cfg = FedConfig(**tp_cases.client_fed(case))
        task = make_task(cfg.task, cfg)
        task.bind_model_axis(ctx, mesh)
        like = jax.eval_shape(task.init_params, jax.random.key(0))
        _, unravel = ravel_pytree(jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), like))
        flat = jnp.asarray(inputs[f"{name}/flat"])
        grad = jax.jit(compat_shard_map(
            make_client_grad(SimpleNamespace(clip=1e30), unravel, cfg, task, ctx),
            mesh=mesh, in_specs=(P(), P()), out_specs=P(), check_vma=False))
        out[f"{name}/raw"] = np.stack([
            np.asarray(grad(flat, {k: jnp.asarray(inputs[f"{name}/{k}"][i])
                                   for k in ("tokens", "labels")}))
            for i in range(len(tp_cases.CLIENT_IDS))])
        if case["local_steps"] == 1:
            out[f"{name}/eval_loss"] = np.asarray(task.evaluate(flat, unravel)["loss"])
    return out


def step(inputs: dict, mesh: str) -> dict:
    from repro.configs import registry
    from repro.configs.base import InputShape
    from repro.core.mechanisms import make_mechanism
    from repro.distributed.step import MeshPlan, make_train_step
    from repro.models import model
    from repro.optim import make_optimizer, schedules

    dims = tuple(int(d) for d in mesh.split("x"))
    cfg = registry.get_config(tp_cases.STEP_ARCH, reduced=True)
    mech, opt = make_mechanism(tp_cases.STEP_SPEC), make_optimizer("sgd")
    shape = InputShape("t", tp_cases.STEP_SEQ, tp_cases.STEP_BATCH, "train")
    jmesh = _mesh(dims, ("data", "model"))
    plan = MeshPlan(mesh=jmesh, client_axes=("data",), model_axis="model")
    step_fn, specs = make_train_step(cfg, plan, mech, opt, schedules.constant(tp_cases.STEP_LR),
                                     shape, remat=False, compute_dtype=jnp.float32)
    like = jax.eval_shape(lambda k: model.init_params(k, cfg, tp=dims[1]), jax.random.key(0))
    treedef = jax.tree_util.tree_structure(like)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(inputs[f"params0/{i}"]) for i in range(treedef.num_leaves)])
    params = jax.device_put(params, meta_lib.shardings(specs["param_meta"], jmesh))
    state, losses = opt.init(params), []
    for t in range(tp_cases.STEP_STEPS):
        batch = {k: jnp.asarray(inputs[f"{k}{t}"]) for k in ("tokens", "labels")}
        key = jax.random.wrap_key_data(jnp.asarray(inputs[f"key{t}"]))
        params, state, m = step_fn(params, state, jnp.int32(t), batch, key)
        losses.append(float(m["loss"]))
    out = {"losses": np.asarray(losses)}
    for i, a in enumerate(jax.tree_util.tree_leaves(params)):
        out[f"params/{i}"] = np.asarray(a)
    return out


def _linear_loss(p, cfg, ctx, batch, remat=True, compute_dtype=None):
    """``model.loss_fn``'s stand-in: ``sum(p * g)`` over the leaves, g the
    rank's given gradient (``batch["grads"]``, a leading axis of 1)."""
    total = sum(jnp.sum(a * g[0]) for a, g in zip(jax.tree_util.tree_leaves(p),
                                                   jax.tree_util.tree_leaves(batch["grads"])))
    return total, {"ce_loss": total, "moe_aux_loss": jnp.float32(0.0)}


def perf(inputs: dict) -> dict:
    from repro.configs import registry
    from repro.configs.base import InputShape
    from repro.core.mechanisms import make_mechanism
    from repro.distributed import step as jstep
    from repro.models import model
    from repro.optim import make_optimizer, schedules

    dims = tuple(int(d) for d in tp_cases.PERF_MESH.split("x"))
    D, M = dims
    cfg = registry.get_config(tp_cases.PERF_ARCH, reduced=True)
    mech, opt = make_mechanism(tp_cases.PERF_SPEC), make_optimizer("sgd")
    lr_fn = schedules.constant(tp_cases.PERF_LR)
    shape = InputShape("t", tp_cases.PERF_SEQ, tp_cases.PERF_BATCH, "train")
    jmesh = _mesh(dims, ("data", "model"))
    plan = jstep.MeshPlan(mesh=jmesh, client_axes=("data",), model_axis="model")
    like = jax.eval_shape(lambda k: model.init_params(k, cfg, tp=M), jax.random.key(0))
    treedef = jax.tree_util.tree_structure(like)
    def params0():  # a fresh tree each time: the steps donate theirs
        return jax.tree_util.tree_unflatten(treedef, [
            jnp.array(inputs[f"params0/{i}"]) for i in range(treedef.num_leaves)])

    meta32 = model.param_meta(cfg, tp=M, dtype=jnp.float32)
    keys = [jax.random.wrap_key_data(jnp.asarray(inputs[f"key{t}"]))
            for t in range(tp_cases.PERF_STEPS)]
    out = {}
    for name in sorted(set(tp_cases.PERF_REFERENCE.values())):
        kw = tp_cases.PERF_VARIANTS[name]
        fn, specs = jstep.make_train_step(cfg, plan, mech, opt, lr_fn, shape, remat=False,
                                          compute_dtype=jnp.float32, **kw)
        params = jax.device_put(params0(), meta_lib.shardings(specs["param_meta"], jmesh))
        if kw.get("zero1"):
            state = jax.device_put({"master": jstep.zero1_init_master(params0(), meta32, M, D)},
                                   meta_lib.shardings(specs["opt_meta"], jmesh))
        else:
            state = opt.init(params)
        losses = []
        for t in range(tp_cases.PERF_STEPS):
            batch = {k: jnp.asarray(inputs[f"{k}{t}"]) for k in ("tokens", "labels")}
            params, state, m = fn(params, state, jnp.int32(t), batch, keys[t])
            losses.append(float(m["loss"]))
            if t == 0 and name == "sp_compress":
                for i, a in enumerate(jax.tree_util.tree_leaves(params)):
                    out[f"{name}/params1/{i}"] = np.asarray(a)
        out[f"{name}/losses"] = np.asarray(losses)
        for i, a in enumerate(jax.tree_util.tree_leaves(params)):
            out[f"{name}/params/{i}"] = np.asarray(a)
        if kw.get("zero1"):
            for i, a in enumerate(jax.tree_util.tree_leaves(state)):
                out[f"{name}/master/{i}"] = np.asarray(a)
    out.update(_zero1_given(inputs, cfg, mech, lr_fn, plan, params0(), meta32, keys[0]))
    return out


def _zero1_given(inputs, cfg, mech, lr_fn, plan, params0, meta32, key) -> dict:
    """One ZeRO-1 step on the given per-rank gradients: the reference's
    jitted ``build_zero1_train_step_fn`` (``model.loss_fn`` replaced by
    ``_linear_loss``), its new global parameters and master; and, op by op
    (``jax.disable_jit``: no contraction into FMAs, ROADMAP.md C6), each
    rank's summed levels (its client's block), from the reference's
    ``rqm_encode_counters`` on the gradient the step encodes (``/ tp``,
    then summed over the model axis for a replicated leaf) at the seeds it
    folds (``seeds0``), all ranks' leaves in one call; and each rank's new
    master shard, ``master - lr * decode_sum(levels)``."""
    from repro.distributed import step as jstep
    from repro.kernels.rqm_kernel import rqm_encode_counters
    from repro.models import model

    D, M = plan.n_clients, plan.tp
    metas = jax.tree_util.tree_leaves(meta32, is_leaf=meta_lib.is_meta)
    n_leaves = len(metas)
    grads = [np.stack([inputs[f"grads/{r}/{i}"] for r in range(D * M)])
             for i in range(n_leaves)]
    treedef = jax.tree_util.tree_structure(params0)
    gtree = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(g) for g in grads])
    body = jstep.build_zero1_train_step_fn(cfg, mech, lr_fn, plan.ctx(), remat=False,
                                           compute_dtype=jnp.float32, agg_dtype="auto")
    opt_meta = {"master": jstep.zero1_master_meta(meta32, M, D, plan.client_axes)}
    pspecs, ospecs = meta_lib.pspecs(meta32), meta_lib.pspecs(opt_meta)
    gspecs = jax.tree_util.tree_map(lambda _: P(("data", "model")), gtree)
    mspecs = {k: P() for k in ("loss", "ce_loss", "moe_aux_loss")}
    mapped = compat_shard_map(body, mesh=plan.mesh,
                              in_specs=(pspecs, ospecs, P(), {"grads": gspecs}, P()),
                              out_specs=(pspecs, ospecs, mspecs), check_vma=False)
    master0 = [np.asarray(a) for a in jax.tree_util.tree_leaves(
        jstep.zero1_init_master(params0, meta32, M, D))]
    real = model.loss_fn
    model.loss_fn = _linear_loss
    try:
        p1, o1, _ = jax.jit(mapped)(params0, {"master": jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(a) for a in master0])}, jnp.int32(0), {"grads": gtree}, key)
    finally:
        model.loss_fn = real
    out = {f"given/params/{i}": np.asarray(a)
           for i, a in enumerate(jax.tree_util.tree_leaves(p1))}
    out.update({f"given/master/{i}": np.asarray(a)
                for i, a in enumerate(jax.tree_util.tree_leaves(o1))})
    # the encoded gradient of rank (c, j), leaf i, and its seed
    xs, seeds, counters, parts = [], [], [], []
    for i, m in enumerate(metas):
        per = grads[i].reshape((D, M) + grads[i].shape[1:]) / np.float32(M)
        if m.sync >= M:
            per = np.broadcast_to(per.sum(1, keepdims=True, dtype=np.float32), per.shape)
        for c in range(D):
            for j in range(M):
                x = per[c, j].reshape(-1)
                xs.append(x)
                seeds.append(np.full(x.size, inputs["seeds0"][c * M + j][i], np.uint32))
                counters.append(np.arange(x.size, dtype=np.uint32))
                parts.append((i, c, j, x.size))
    with jax.disable_jit():
        z = np.asarray(rqm_encode_counters(jnp.asarray(np.concatenate(xs)),
                                           jnp.asarray(np.concatenate(seeds)),
                                           jnp.asarray(np.concatenate(counters)), mech.params))
    levels, at = {}, 0
    for i, c, j, n in parts:
        levels[i, c, j], at = z[at:at + n], at + n
    shards, m0 = [], []
    for i in range(n_leaves):
        for j in range(M):
            total = np.sum([levels[i, c, j] for c in range(D)], axis=0, dtype=np.int64)
            L = master0[i].shape[1] // D
            total = np.pad(total, (0, L * D - total.size)).astype(np.int32)
            for c in range(D):
                out[f"levels/{c * M + j}/{i}"] = total[c * L:(c + 1) * L]
                shards.append((i, c, j, L))
                m0.append(master0[i][j, c * L:(c + 1) * L])
    with jax.disable_jit():
        zc = jnp.asarray(np.concatenate([out[f"levels/{c * M + j}/{i}"]
                                         for i, c, j, _ in shards]))
        new = np.asarray(jnp.asarray(np.concatenate(m0)) - lr_fn(0) * mech.decode_sum(zc, D))
    at = 0
    for i, c, j, L in shards:
        out[f"given/master_op_by_op/{c * M + j}/{i}"], at = new[at:at + L], at + L
    return out


def precision(inputs: dict) -> dict:
    from repro.configs import registry
    from repro.configs.base import InputShape
    from repro.models import model

    ctx, out = ParallelCtx(), {}
    bf16 = dict(compute_dtype=jnp.bfloat16)
    shape = InputShape("t", tp_cases.PRECISION_CAP, tp_cases.PRECISION_BATCH, "decode")
    for arch in tp_cases.PRECISION_ARCHS:
        cfg = registry.get_config(arch, reduced=True)
        params = jax.jit(lambda k: model.init_params(k, cfg, dtype=jnp.bfloat16))(
            jax.random.key(tp_cases.PRECISION_KEY))
        toks, labels = (jnp.asarray(inputs[f"{arch}/{k}"]) for k in ("tokens", "labels"))

        @jax.jit
        def loss(p, t, y):
            h, aux = model.forward_hidden(p, cfg, ctx, t, **bf16)
            return h, model.lm_head_loss(p, cfg, ctx, h, y)[0] + aux["moe_aux_loss"]

        hidden, out[f"{arch}/loss"] = loss(params, toks, labels)
        out[f"{arch}/hidden"] = hidden.astype(jnp.float32)
        nxt, caches = jax.jit(lambda p, t: model.prefill(p, cfg, ctx, t, shape))(params, toks)
        for i, c in enumerate(jax.tree_util.tree_leaves(caches)):
            out[f"{arch}/cache/{i}"] = c.astype(jnp.float32)
        decode = jax.jit(lambda p, c, t, pos: model.decode_step(p, c, cfg, ctx, t, pos))
        tokens = [nxt]
        for t in range(tp_cases.PRECISION_STEPS):
            nxt, caches = decode(params, caches, nxt[:, None],
                                 jnp.int32(tp_cases.PRECISION_PROMPT + t))
            tokens.append(nxt)
        out[f"{arch}/greedy"] = np.stack([np.asarray(t) for t in tokens], 1)
        for i, a in enumerate(jax.tree_util.tree_leaves(params)):
            out[f"{arch}/params/{i}"] = a.astype(jnp.float32)
    return out


def relayout_tp(params1, cfg, tp):
    """tp = 1 parameters -> the global layout at tp (shard/duplicate), as
    tests/sharded_checks.py:relayout_tp does."""
    import jax.tree_util as jtu

    from repro.models import model

    m1 = jtu.tree_leaves(model.param_meta(cfg, tp=1), is_leaf=meta_lib.is_meta)
    mN = jtu.tree_leaves(model.param_meta(cfg, tp=tp), is_leaf=meta_lib.is_meta)
    paths = [jtu.keystr(p) for p, _ in jtu.tree_leaves_with_path(params1)]
    outs = []
    for path, p, a, b in zip(paths, jtu.tree_leaves(params1), m1, mN):
        if a.shape == b.shape:
            outs.append(p)
            continue
        if "w_zx" in path:  # [z | x] streams concatenated: shard separately
            z, x = jnp.split(p, 2, axis=-1)
            per = [jnp.concatenate([zz, xx], axis=-1)
                   for zz, xx in zip(jnp.split(z, tp, axis=-1), jnp.split(x, tp, axis=-1))]
            outs.append(jnp.concatenate(per, axis=1))
            continue
        diff = [i for i, (x_, y_) in enumerate(zip(a.shape, b.shape)) if x_ != y_]
        ax = diff[0]
        if len(diff) == 1:  # pure duplication
            outs.append(jnp.repeat(p, tp, axis=ax))
            continue
        n_distinct = a.shape[diff[1]] // b.shape[diff[1]]
        stacked = jnp.concatenate(jnp.split(p, n_distinct, axis=diff[1]), axis=ax)
        outs.append(jnp.repeat(stacked, tp // n_distinct, axis=ax))
    return jtu.tree_unflatten(jtu.tree_structure(params1), outs)


def relayout_cache(v, target):
    """A one-rank cache leaf -> the global layout ``target`` at tp, as
    tests/sharded_checks.py:check_flash_decoding re-lays it (KV heads
    duplicated where the slice is whole, else split)."""
    if v.shape == target:
        return v
    if v.shape[2] == target[2]:
        return jnp.repeat(v, target[1], axis=1)
    return jnp.stack(jnp.split(jnp.squeeze(v, 1), target[1], axis=1), axis=1)


def serve(inputs: dict, mode: str, mesh: str) -> dict:
    import jax.tree_util as jtu

    from repro.configs import registry
    from repro.configs.base import InputShape
    from repro.distributed.step import MeshPlan, make_decode_step, make_prefill_step
    from repro.models import model

    dims = tuple(int(d) for d in mesh.split("x"))
    jmesh = _mesh(dims, ("data", "model"))
    plan = MeshPlan(mesh=jmesh, client_axes=("data",), model_axis="model")
    B = tp_cases.SERVE_BATCH[mode]
    shape = InputShape("t", tp_cases.SERVE_CAP, B, "decode")
    f32 = dict(compute_dtype=jnp.float32, param_dtype=jnp.float32)
    out = {}

    def save(prefix, tokens, caches):
        out[f"{prefix}tokens"] = np.stack([np.asarray(t) for t in tokens])
        for i, c in enumerate(jtu.tree_leaves(caches)):
            out[f"{prefix}cache/{i}"] = np.asarray(c.astype(jnp.float32)
                                                   if c.dtype == jnp.bfloat16 else c)

    for arch in tp_cases.SERVE_ARCHS[mode]:
        cfg = registry.get_config(arch, reduced=True)
        like = jax.eval_shape(lambda k: model.init_params(k, cfg, tp=1), jax.random.key(0))
        treedef = jax.tree_util.tree_structure(like)
        params1 = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(inputs[f"{arch}/params/{i}"]) for i in range(treedef.num_leaves)])
        params = relayout_tp(params1, cfg, dims[1])
        dec, specs = make_decode_step(cfg, plan, shape, **f32)
        params = jax.device_put(params, meta_lib.shardings(specs["param_meta"], jmesh))
        cmeta = specs["cache_meta"]
        if mode == "batch":
            pre, pspecs = make_prefill_step(cfg, plan, shape, seq_parallel=True, **f32)
            nxt, caches = pre(params, jnp.asarray(inputs[f"{arch}/tokens"]))
            pos = tp_cases.SERVE_PROMPT
        else:
            metas = jtu.tree_leaves(cmeta, is_leaf=meta_lib.is_meta)
            caches = jtu.tree_unflatten(jtu.tree_structure(cmeta, is_leaf=meta_lib.is_meta), [
                relayout_cache(jnp.asarray(inputs[f"{arch}/cache/{i}"]), m.shape)
                for i, m in enumerate(metas)])
            caches = jax.device_put(caches, meta_lib.shardings(cmeta, jmesh))
            nxt, pos = jnp.asarray(inputs[f"{arch}/tok"])[:, 0], tp_cases.SERVE_PROMPT
        tokens = [nxt]
        for t in range(tp_cases.SERVE_STEPS):
            nxt, caches = dec(params, caches, nxt[:, None], jnp.int32(pos + t))
            tokens.append(nxt)
        save(f"{arch}/", tokens, caches)
        dec_q, qspecs = make_decode_step(cfg, plan, shape, kv_quant=True, **f32)
        qmeta = qspecs["cache_meta"]
        caches = jax.device_put(
            jax.tree_util.tree_map(lambda m: jnp.zeros(m.shape, m.dtype), qmeta,
                                   is_leaf=meta_lib.is_meta),
            meta_lib.shardings(qmeta, jmesh))
        nxt, tokens = jnp.asarray(inputs[f"{arch}/tok0"])[:, 0], []
        for t in range(tp_cases.SERVE_INT8_STEPS):
            nxt, caches = dec_q(params, caches, nxt[:, None], jnp.int32(t))
            tokens.append(nxt)
        save(f"{arch}/q_", tokens, caches)
    if mode == "batch":
        out.update(argmax(inputs))
    return out


def argmax(inputs: dict) -> dict:
    """lm_head_argmax over a ("model",) mesh of each tp on the global head."""
    from repro.models import model

    out = {}
    head, h = jnp.asarray(inputs["argmax/head"]), jnp.asarray(inputs["argmax/h"])
    for tp in tp_cases.ARGMAX_TPS:
        ctx = ParallelCtx(model_axis="model", tp=tp)
        V = head.shape[1]
        fn = compat_shard_map(lambda p, h: model.lm_head_argmax(p, ctx, h),
                              mesh=_mesh((tp,), ("model",)),
                              in_specs=({"lm_head": P(None, "model", None)}, P()),
                              out_specs=P(), check_vma=False)
        out[f"argmax{tp}"] = jax.jit(fn)({"lm_head": head.reshape(-1, tp, V // tp)}, h)
    return out


def dryrun(inputs: dict, mesh: str, *archs) -> dict:
    import json
    import re

    flags = os.environ["XLA_FLAGS"]
    from repro.launch import dryrun as dry  # sets XLA_FLAGS at import: put ours back
    os.environ["XLA_FLAGS"] = flags
    from repro.configs import registry
    from repro.configs.base import InputShape
    from repro.distributed.step import MeshPlan
    from repro.launch import hlo_analysis
    from repro.launch.mesh import compat_set_mesh

    dims = tuple(int(d) for d in mesh.split("x"))
    jmesh = _mesh(dims, ("data", "model"))
    plan = MeshPlan(mesh=jmesh, client_axes=("data",))
    shape = InputShape("t", tp_cases.DRYRUN_SEQ, tp_cases.DRYRUN_BATCH, "train")
    out = {}
    for arch in archs or tp_cases.DRYRUN_ARCHS:
        cfg = registry.get_config(arch, reduced=True)
        with compat_set_mesh(jmesh):
            fn, args = dry.build_step(cfg, plan, shape)
            hlo = fn.lower(*args).compile().as_text()
        operands = []
        for line in hlo.splitlines():
            m = re.search(r"\s(all-reduce|all-gather|reduce-scatter|collective-permute|"
                          r"all-to-all)(-start)?\(", line)
            if m is None or " = " not in line or line.strip().startswith("//"):
                continue
            lhs = line[:m.start()].split(" = ", 1)[1]
            n = hlo_analysis._group_size(line) or 1
            operands += [[m.group(1), hlo_analysis._shape_bytes(sig), n]
                         for sig in re.findall(r"\w+\[[\d,]*\]", lhs)]
        out[f"{arch}/summary"] = json.dumps(hlo_analysis.collective_bytes(hlo).summary())
        out[f"{arch}/operands"] = json.dumps(operands)
    return out


if __name__ == "__main__":
    job, src, dst = sys.argv[1:4]
    inputs = dict(np.load(src)) if os.path.exists(src) else {}
    res = {"layers": layers, "ops": ops, "client": client, "step": step,
           "serve": serve, "perf": perf, "precision": precision,
           "dryrun": dryrun}[job](inputs, *sys.argv[4:])
    np.savez(dst, **{k: np.asarray(v) for k, v in res.items()})
    print(f"{job}: {len(res)} arrays")
