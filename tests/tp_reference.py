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
``inputs.npz``: the losses and the global parameters after.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

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


if __name__ == "__main__":
    job, src, dst = sys.argv[1:4]
    inputs = dict(np.load(src)) if os.path.exists(src) else {}
    res = {"layers": layers, "ops": ops, "client": client, "step": step}[job](inputs, *sys.argv[4:])
    np.savez(dst, **{k: np.asarray(v) for k, v in res.items()})
    print(f"{job}: {len(res)} arrays")
