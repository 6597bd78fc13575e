"""The distributed LM train step (counterpart of
``repro/distributed/step.py``), its train half: the paper's Algorithm 1
over client-parallel ranks, each client tensor-parallel over a model
axis.

  * the ('pod', 'data') axes are the FEDERATED CLIENTS: one process a
    client, each computing its gradient on its rows of the global batch;
    the ranks of their process group are the clients, linearized
    pod-major (rank = pod * data_size + data);
  * the pipeline grad -> clip -> randomized quantization (int32 levels)
    -> SecAgg sum over the clients -> affine decode is ``torch.autograd``
    -> ``mech.quantize`` leaf by leaf (the rqm/pbm/qmgeo quantize
    kernels) -> an all_reduce of the levels over the client group ->
    ``mech.decode_sum``. The sum of integer levels IS the SecAgg
    aggregation, the only cross-client collective of the step;
  * the 'model' axis is Megatron-style tensor parallelism inside each
    client: one process a model rank, explicit collectives in the layers
    over the client's model group (``models/common.py``), the gradient
    synced per ``Meta.sync`` (``models/meta.py``). Global rank = client
    * tp + model index (``launch/mesh.py``).

Beyond-paper option (``packed=True``): each leaf's levels cross the
collective packed at the least safe field width (``core/secagg.py``, the
``pack_flat``/``unpack_flat`` kernels).

Seeds, not keys: the reference folds each client axis index into the
step's key, then the leaf index and the model-shard index, and draws
each leaf's kernel seed from that key. The port's step takes this rank's
per-leaf uint32 seeds instead, in the reference's leaf order
(``convert.leaves``: sorted dict keys); ``train_seeds`` derives them as
a pure function of (seed, step, client, leaf, shard index), so a resumed
run needs no stored stream. A leaf's shard index (``shard_seed_indices``)
is shared by the ranks that hold the same copy of it, so that copies
draw identical levels. ZeRO-1, int16 aggregation and the serve steps are
not ported (ROADMAP.md queue A items 13-14).
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
    ``(4, 1)`` over ``('data', 'model')``, ``(2, 2, 2)`` over ``('pod',
    'data', 'model')``), the client axes spanned by the ranks of
    ``group``, the model axis by those of ``model_groups.model``
    (``launch/mesh.py:MeshGroups``). A model axis of size 1 (or none) is
    the pure client-parallel plan."""

    dims: tuple
    names: tuple
    client_axes: tuple
    model_axis: Optional[str] = "model"
    group: Optional[dist.ProcessGroup] = dataclasses.field(default=None, compare=False)
    model_groups: Optional[object] = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if len(self.dims) != len(self.names):
            raise ValueError(f"mesh dims {self.dims} do not match axes {self.names}")

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

    def ctx(self, *, seq_parallel: bool = False) -> ParallelCtx:
        if self.tp == 1:
            return ParallelCtx(client_axes=self.client_axes, n_clients=self.n_clients,
                               client_index=dist.get_rank(self.group), group=self.group)
        g = self.model_groups
        return ParallelCtx(model_axis=self.model_axis, tp=self.tp,
                           client_axes=self.client_axes, n_clients=self.n_clients,
                           client_index=g.client_index, group=self.group,
                           model_group=g.model, model_rank=g.model_index,
                           subgroups=g.subgroups, seq_parallel=seq_parallel)


def make_plan(dims, device) -> MeshPlan:
    """The plan of a mesh of ``dims`` (named ``('pod', 'data', 'model')``
    from the right), its groups made by ``launch/mesh.py`` on
    ``device``: ``client_group`` at tp = 1, ``mesh_groups`` above."""
    from repro_torch.launch.mesh import client_group, mesh_groups

    dims = tuple(int(d) for d in dims)
    names = ("pod", "data", "model")[-len(dims):]
    plan = MeshPlan(dims, names, tuple(a for a in names if a != "model"))
    if plan.tp == 1:
        return dataclasses.replace(plan, group=client_group(plan.n_clients, device))
    groups = mesh_groups(plan.n_clients, plan.tp, device)
    return dataclasses.replace(plan, group=groups.client, model_groups=groups)


def round_privacy(mech: Mechanism, n_clients: int,
                  alphas=(2.0, 4.0, 8.0, 16.0, 32.0)) -> dict[float, float]:
    """Per-step aggregate-level Renyi eps of the train step: one step
    releases one mechanism round over ``n_clients`` participants; the
    launcher composes these additively across steps."""
    return {float(a): float(mech.per_round_epsilon(n_clients, a)) for a in alphas}


def train_seeds(seed: int, step: int, client: int, n_leaves: int, shards=None) -> list:
    """The uint32 kernel seeds of ``n_leaves`` leaves for one client at
    one step: word ``i`` of ``numpy.random.SeedSequence((seed, step,
    client))``'s state for a leaf of shard index 0, of ``SeedSequence((seed,
    step, client, s))``'s for shard index ``s > 0`` (``shards``, one a
    leaf, ``shard_seed_indices``; all 0 when None). A word depends on
    (seed, step, client, i, s) alone; at shard index 0 it is the one a
    plan without a model axis draws."""
    shards = [0] * n_leaves if shards is None else [int(s) for s in shards]
    if len(shards) != n_leaves:
        raise ValueError(f"{len(shards)} shard indices for {n_leaves} leaves")
    words = {s: np.random.SeedSequence((seed, step, client) + ((s,) if s else ()))
             .generate_state(n_leaves, np.uint32) for s in set(shards)}
    return [int(words[s][i]) for i, s in enumerate(shards)]


def shard_seed_indices(meta_tree, ctx: ParallelCtx) -> list:
    """Each leaf's seed-folding index on the model axis (the reference's
    ``_shard_seed_index``): the model index for a sharded leaf (distinct
    randomness a shard), ``model_index // sync`` for one duplicated over
    aligned subgroups of ``sync``, 0 for a replicated one (identical
    levels, so that the copies stay in sync); all 0 without a model
    axis."""
    mi = ctx.model_index()
    return [mi // max(1, min(m.sync, ctx.tp)) for m in leaves(meta_tree)]


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
    no remat; ``params`` are this rank's (its model slices), ``batch`` its
    client's rows, ``seeds`` its per-leaf kernel seeds, ``step`` an int.
    The metrics are 0-d tensors on the device, read back by no one here.

    Over a model axis, as the reference: the gradient of ``loss / tp``
    (psum's backward is psum, so every cotangent path that crosses a
    model-axis psum carries one factor of tp, which the division cancels;
    a replicated leaf whose paths cross none comes out at its true
    gradient / tp, which its ``sync = tp`` psum in ``sync_grads``
    restores), then ``sync_grads``, then the encode and the SecAgg sum
    over the client group only."""
    meta_tree = model_lib.param_meta(cfg, tp=ctx.tp)

    def train_step(params, opt_state, step, batch, seeds):
        p_leaves = [p.detach().requires_grad_() for p in leaves(params)]
        with torch.enable_grad():
            total, aux = model_lib.loss_fn(map_leaves(lambda i, _: p_leaves[i], params),
                                           cfg, ctx, batch)
            loss = total / ctx.tp  # the psum self-transpose correction
            grads = list(torch.autograd.grad(loss, p_leaves))
        total = loss.detach() * ctx.tp
        del p_leaves, loss
        grads = meta_lib.sync_grads(grads, meta_tree, ctx)  # TP corrections
        ghat = encode_aggregate_decode(grads, meta_tree, mech, ctx, seeds, packed=packed)
        ghat = map_leaves(lambda i, _: ghat[i], params)
        params, opt_state = opt.update(ghat, opt_state, params, lr_fn(step))
        del ghat
        # the three means in one collective
        means = ctx.pmean_clients(torch.stack(
            [total, aux["ce_loss"].detach(), aux["moe_aux_loss"].detach()]))
        metrics = {"loss": means[0], "ce_loss": means[1], "moe_aux_loss": means[2]}
        return params, opt_state, metrics

    return train_step


def make_train_step(cfg: ModelConfig, plan: MeshPlan, mech: Mechanism, opt: Optimizer,
                    lr_fn, shape: InputShape, *, packed: bool = False):
    """The train step of this rank of ``plan``, called with the GLOBAL
    batch of ``shape``: the rank takes its client's rows ``[c B/N, (c+1)
    B/N)`` (the reference's ``shard_map`` in_spec ``P(client_axes,
    None)``; every model rank of a client the same rows), and a batch
    that does not divide over the N clients is refused. Sequence
    parallelism is on whenever the model axis divides the sequence.
    Returns ``(step_fn, specs)``; ``specs`` holds the
    parameters' Meta tree (global shapes) and ``shard_seeds``, the
    rank's per-leaf seed-folding indices (``train_seeds``' ``shards``)."""
    ctx = plan.ctx(seq_parallel=plan.tp > 1 and shape.seq_len % plan.tp == 0)
    B, N = shape.global_batch, plan.n_clients
    if B % N:
        raise ValueError(f"global batch {B} does not divide over {N} client ranks "
                         f"(axes {plan.client_axes})")
    lo, hi = ctx.client_index * (B // N), (ctx.client_index + 1) * (B // N)
    body = build_train_step_fn(cfg, mech, opt, lr_fn, ctx, packed=packed)

    def step_fn(params, opt_state, step, batch, seeds):
        return body(params, opt_state, step, {k: v[lo:hi] for k, v in batch.items()}, seeds)

    meta_tree = model_lib.param_meta(cfg, tp=plan.tp)
    return step_fn, {"param_meta": meta_tree, "ctx": ctx,
                     "shard_seeds": shard_seed_indices(meta_tree, ctx)}
