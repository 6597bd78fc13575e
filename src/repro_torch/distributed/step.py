"""The distributed LM train step (counterpart of
``repro/distributed/step.py``), its train half at tp = 1: the paper's
Algorithm 1 over client-parallel ranks.

  * the ('pod', 'data') axes are the FEDERATED CLIENTS: one process a
    client, each computing its gradient on its rows of the global batch;
    the ranks of their process group are the clients, linearized
    pod-major (rank = pod * data_size + data);
  * the pipeline grad -> clip -> randomized quantization (int32 levels)
    -> SecAgg sum over the clients -> affine decode is ``torch.autograd``
    -> ``mech.quantize`` leaf by leaf (the rqm/pbm/qmgeo quantize
    kernels) -> an all_reduce of the levels over the client group ->
    ``mech.decode_sum``. The sum of integer levels IS the SecAgg
    aggregation, the only cross-client collective of the step.

Beyond-paper option (``packed=True``): each leaf's levels cross the
collective packed at the least safe field width (``core/secagg.py``, the
``pack_flat``/``unpack_flat`` kernels).

Seeds, not keys: the reference folds each client axis index into the
step's key, then the leaf index and the model-shard index, and draws
each leaf's kernel seed from that key. The port's step takes this rank's
per-leaf uint32 seeds instead, in the reference's leaf order
(``convert.leaves``: sorted dict keys); ``train_seeds`` derives them as
a pure function of (seed, step, client, leaf), so a resumed run needs no
stored stream. The model axis (tp > 1), ZeRO-1, int16 aggregation,
sequence parallelism and the serve steps are not ported (ROADMAP.md
queue A items 12-14).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.convert import leaves, map_leaves
from repro_torch.core import secagg, wire
from repro_torch.core.mechanisms import Mechanism
from repro_torch.models import meta as meta_lib
from repro_torch.models import model as model_lib
from repro_torch.models.common import ParallelCtx
from repro_torch.optim.optimizers import Optimizer


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Binding of mesh axes to roles: ``dims`` over ``names`` (e.g.
    ``(4, 1)`` over ``('data', 'model')``, ``(2, 2, 1)`` over ``('pod',
    'data', 'model')``), the client axes spanned by the ranks of
    ``group``. A model axis of size 1 (or none) is the pure
    client-parallel plan; above 1 it is refused."""

    dims: tuple
    names: tuple
    client_axes: tuple
    model_axis: Optional[str] = "model"
    group: Optional[dist.ProcessGroup] = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if len(self.dims) != len(self.names):
            raise ValueError(f"mesh dims {self.dims} do not match axes {self.names}")
        if self.tp != 1:
            raise NotImplementedError(
                f"a model axis of {self.tp} (tp > 1) is not ported yet: "
                f"ROADMAP.md queue A item 12")

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.dims))

    @property
    def tp(self) -> int:
        if self.model_axis is None or self.model_axis not in self.shape:
            return 1
        return self.shape[self.model_axis]

    @property
    def n_clients(self) -> int:
        return math.prod(self.shape[a] for a in self.client_axes)

    def ctx(self) -> ParallelCtx:
        return ParallelCtx(client_axes=self.client_axes, n_clients=self.n_clients,
                           client_index=dist.get_rank(self.group), group=self.group)


def make_plan(dims, device) -> MeshPlan:
    """The plan of a mesh of ``dims`` (named ``('pod', 'data', 'model')``
    from the right), its client group made by
    ``launch/mesh.py:client_group`` on ``device``."""
    from repro_torch.launch.mesh import client_group

    dims = tuple(int(d) for d in dims)
    names = ("pod", "data", "model")[-len(dims):]
    plan = MeshPlan(dims, names, tuple(a for a in names if a != "model"))
    return dataclasses.replace(plan, group=client_group(plan.n_clients, device))


def round_privacy(mech: Mechanism, n_clients: int,
                  alphas=(2.0, 4.0, 8.0, 16.0, 32.0)) -> dict[float, float]:
    """Per-step aggregate-level Renyi eps of the train step: one step
    releases one mechanism round over ``n_clients`` participants; the
    launcher composes these additively across steps."""
    return {float(a): float(mech.per_round_epsilon(n_clients, a)) for a in alphas}


def train_seeds(seed: int, step: int, client: int, n_leaves: int) -> list:
    """The uint32 kernel seeds of ``n_leaves`` leaves for one client at
    one step: word ``i`` of ``numpy.random.SeedSequence((seed, step,
    client))``'s state, which depends on (seed, step, client, i) alone."""
    words = np.random.SeedSequence((seed, step, client)).generate_state(n_leaves, np.uint32)
    return [int(w) for w in words]


def encode_aggregate_decode(grads: list, meta_tree, mech: Mechanism, ctx: ParallelCtx, seeds, *,
                            packed: bool = False) -> list:
    """clip -> mechanism encode -> SecAgg sum over the clients -> decode,
    leaf by leaf over the list ``grads`` (``convert.leaves`` order); leaf
    ``i`` encodes at ``seeds[i]``. Returns the decoded update (the mean
    over clients) as a list of leaves. ``grads`` is consumed: each entry
    is set to None once its leaf is taken, so that one leaf's gradient
    and transients live at a time (a full-width tree is 18 GB)."""
    n = max(1, ctx.n_clients)
    metas = leaves(meta_tree)
    if len(grads) != len(metas) or len(seeds) != len(metas):
        raise ValueError(f"{len(grads)} gradient leaves and {len(seeds)} seeds for "
                         f"{len(metas)} parameters")
    out = []
    for i in range(len(metas)):
        g, grads[i] = grads[i], None
        z = mech.quantize(g, seeds[i])  # the shared clip -> encode dispatch
        if mech.name == "none":
            agg = ctx.psum_clients(z)
        elif packed:
            # the shared packing-safety gate + minimal-width codec
            # (core/wire.py): fields as narrow as the bound allows
            wire.check_packable(mech.sum_bound(n), where="packed=True: ")
            flat = z.reshape(-1)
            if ctx.client_axes:
                flat = secagg.secure_sum_bounded(flat, ctx.group, mech.sum_bound(n),
                                                 packed=True)
            agg = flat.reshape(z.shape)
        else:
            agg = ctx.psum_clients(z)
        del z
        out.append(mech.decode_sum(agg, n).to(g.dtype).reshape(g.shape))
        del g, agg
    return out


def build_train_step_fn(cfg: ModelConfig, mech: Mechanism, opt: Optimizer, lr_fn,
                        ctx: ParallelCtx, *, packed: bool = False):
    """The per-rank train step ``train_step(params, opt_state, step,
    batch, seeds) -> (params, opt_state, metrics)``: float32 throughout,
    no remat; ``batch`` is this rank's rows, ``seeds`` its per-leaf
    kernel seeds, ``step`` an int. The metrics are 0-d tensors on the
    device, read back by no one here."""
    meta_tree = model_lib.param_meta(cfg, tp=ctx.tp)

    def train_step(params, opt_state, step, batch, seeds):
        p_leaves = [p.detach().requires_grad_() for p in leaves(params)]
        with torch.enable_grad():
            # the reference differentiates total / tp, a psum
            # self-transpose correction under its manual shard_map: the
            # identity at tp = 1
            total, aux = model_lib.loss_fn(map_leaves(lambda i, _: p_leaves[i], params),
                                           cfg, ctx, batch)
            grads = list(torch.autograd.grad(total, p_leaves))
        del p_leaves
        grads = meta_lib.sync_grads(grads, meta_tree, ctx)  # TP corrections
        ghat = encode_aggregate_decode(grads, meta_tree, mech, ctx, seeds, packed=packed)
        ghat = map_leaves(lambda i, _: ghat[i], params)
        params, opt_state = opt.update(ghat, opt_state, params, lr_fn(step))
        del ghat
        # the three means in one collective
        means = ctx.pmean_clients(torch.stack(
            [total.detach(), aux["ce_loss"].detach(), aux["moe_aux_loss"].detach()]))
        metrics = {"loss": means[0], "ce_loss": means[1], "moe_aux_loss": means[2]}
        return params, opt_state, metrics

    return train_step


def make_train_step(cfg: ModelConfig, plan: MeshPlan, mech: Mechanism, opt: Optimizer,
                    lr_fn, shape: InputShape, *, packed: bool = False):
    """The train step of this rank of ``plan``, called with the GLOBAL
    batch of ``shape``: the rank takes its rows ``[r B/N, (r+1) B/N)``
    (the reference's ``shard_map`` in_spec ``P(client_axes, None)``), and
    a batch that does not divide over the N client ranks is refused.
    Returns ``(step_fn, specs)``; ``specs`` holds the parameters' Meta
    tree."""
    ctx = plan.ctx()
    B, N = shape.global_batch, plan.n_clients
    if B % N:
        raise ValueError(f"global batch {B} does not divide over {N} client ranks "
                         f"(axes {plan.client_axes})")
    lo, hi = ctx.client_index * (B // N), (ctx.client_index + 1) * (B // N)
    body = build_train_step_fn(cfg, mech, opt, lr_fn, ctx, packed=packed)

    def step_fn(params, opt_state, step, batch, seeds):
        return body(params, opt_state, step, {k: v[lo:hi] for k, v in batch.items()}, seeds)

    return step_fn, {"param_meta": model_lib.param_meta(cfg, tp=plan.tp)}
