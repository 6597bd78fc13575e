"""The distributed LM train and serve steps (counterpart of
``repro/distributed/step.py``): the paper's Algorithm 1 over
client-parallel ranks, each client tensor-parallel over a model axis;
and the prefill and decode steps over the same mesh.

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
draw identical levels.

The reference's precision and memory options: ``compute_dtype`` (the
loss, in bfloat16 by default; the parameters of ``param_dtype``, float32,
their gradients too), ``remat`` (each block checkpointed), ``agg_dtype``
(the levels' width on the wire: int16 where the sum bound allows,
``agg_width``), ``sp_compress`` (int8 sequence-parallel gathers) and
``zero1`` (the float32 master flat-sharded over the clients, the levels
reduce-scattered, the parameters all-gathered in the compute dtype;
``build_zero1_train_step_fn``). The lm task and the launchers pass float32
and no remat, as the reference's callers pass float32.

Serve steps (``make_prefill_step``, ``make_decode_step``): a batch above
1 is split over the clients, each client's rows served by its model
ranks; at batch 1 (long-context decode) every rank decodes the one row
and the full-attention caches are sharded on their sequence dim over the
clients (flash-decoding, ``models/attention.py:decode``). A rank's step
takes its parameters, its pieces of the caches (``model.cache_meta``;
``meta.zeros``, ``convert.cache_from_numpy``) and its rows of the tokens
(``specs["token_rows"]``).
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
from repro_torch.models.common import ParallelCtx, _all_gather, _reduce_scatter, all_reduce_
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
        """This rank's ParallelCtx; the seq axis (long-context decode's
        KV sharding) is the client axes, as in the reference."""
        seq = dict(seq_axis=self.client_axes or None,
                   seq_axis_sizes=tuple(self.shape[a] for a in self.client_axes),
                   seq_shards=self.n_clients)
        if self.tp == 1:
            return ParallelCtx(client_axes=self.client_axes, n_clients=self.n_clients,
                               client_index=dist.get_rank(self.group), group=self.group,
                               **seq)
        g = self.model_groups
        return ParallelCtx(model_axis=self.model_axis, tp=self.tp,
                           client_axes=self.client_axes, n_clients=self.n_clients,
                           client_index=g.client_index, group=self.group,
                           model_group=g.model, model_rank=g.model_index,
                           subgroups=g.subgroups, seq_parallel=seq_parallel, **seq)


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


def agg_width(mech: Mechanism, n: int, agg_dtype: str) -> str:
    """The width of the levels on the wire: ``"int32"``, ``"int16"``
    (safe while the sum of ``n`` clients' levels stays below 2**15), or
    ``"auto"``, the narrower of the two that is safe. An unsafe
    ``"int16"`` raises the reference's ValueError."""
    bound = mech.sum_bound(n)
    if agg_dtype == "auto":
        agg_dtype = "int16" if bound < (1 << 15) else "int32"
    if agg_dtype == "int16" and bound >= (1 << 15):
        raise ValueError(f"int16 aggregation unsafe: bound {bound}")
    if agg_dtype not in ("int16", "int32"):
        raise ValueError(f"agg_dtype {agg_dtype!r}: int32, int16 or auto")
    return agg_dtype


def _int16_words(z: torch.Tensor) -> torch.Tensor:
    """Levels (..., L) as int16 lanes, two a 32-bit word: (..., ceil(L /
    2)) int32 (a lane of padding where L is odd). Neither NCCL nor gloo
    sums int16, so int16 levels cross the wire this way: the levels are
    non-negative and their sum below 2**15 (``agg_width``), so a word's
    sum carries nothing from one lane into the other, and each lane of
    the summed words is the int16 sum of its levels."""
    h = z.to(torch.int16)
    if h.shape[-1] % 2:
        h = torch.nn.functional.pad(h, (0, 1))
    return h.contiguous().view(torch.int32)


def _int16_lanes(words: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` int16 lanes of (summed) words, as int32 levels."""
    return words.contiguous().view(torch.int16)[..., :n].to(torch.int32)


def _psum_clients_int16(z: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """The reference's ``psum(z.astype(int16)).astype(int32)`` over the
    client ranks: half the bytes of the int32 sum."""
    if not ctx.client_axes or ctx.n_clients == 1:
        return ctx.psum_clients(z)
    flat = z.reshape(-1)
    words = _int16_words(flat)
    all_reduce_(words, ctx.group)
    return _int16_lanes(words, flat.numel()).reshape(z.shape)


def encode_aggregate_decode(grads: list, meta_tree, mech: Mechanism, ctx: ParallelCtx, seeds, *,
                            packed: bool = False, agg_dtype: str = "int32") -> list:
    """clip -> mechanism encode -> SecAgg sum over the clients -> decode,
    leaf by leaf over the list ``grads`` (``convert.leaves`` order); leaf
    ``i`` encodes at ``seeds[i]``. Returns the decoded update (the mean
    over clients) as a list of leaves, each of its gradient's dtype.
    ``grads`` is consumed: each entry is set to None once its leaf is
    taken, so that one leaf's gradient and transients live at a time (a
    full-width tree is 18 GB). ``agg_dtype``: the levels' width on the
    wire (``agg_width``); ``packed`` takes precedence."""
    n = max(1, ctx.n_clients)
    width = agg_width(mech, n, agg_dtype)
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
        elif width == "int16":
            agg = _psum_clients_int16(z, ctx)
        else:
            agg = ctx.psum_clients(z)
        del z
        out.append(mech.decode_sum(agg, n).to(g.dtype).reshape(g.shape))
        del g, agg
    return out


def _client_scatter_sum(x: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """Reduce-scatter ``x`` (n_clients, L) over the client ranks: this
    client's row of the sum, (L,). The ZeRO-1 form of the SecAgg sum:
    each client ends with the summed levels of ITS master shard (the
    reference's tiled psum_scatter over each client axis in turn, whose
    blocks land pod-major, in client-index order, as here)."""
    if not ctx.client_axes or ctx.n_clients == 1:
        return x.reshape(-1).clone()
    return _reduce_scatter(x, ctx.group, ctx.n_clients, 0).reshape(-1)


def _client_scatter_sum16(x: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """``_client_scatter_sum`` of int32 levels with int16 on the wire
    (``_int16_words``; each row padded to whole words)."""
    if not ctx.client_axes or ctx.n_clients == 1:
        return x.reshape(-1).clone()
    return _int16_lanes(_client_scatter_sum(_int16_words(x), ctx), x.shape[1])


def _client_all_gather(x: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """The client ranks' ``x`` concatenated in client-index order."""
    if not ctx.client_axes or ctx.n_clients == 1:
        return x
    return _all_gather(x, ctx.group, ctx.n_clients, 0)


def _pad_to(n_local: int, n_clients: int) -> int:
    return (n_local + n_clients - 1) // n_clients * n_clients


def zero1_master_meta(meta_tree, tp: int, n_clients: int, client_axes) -> dict:
    """The Meta tree of the float32 master copies: per MODEL shard (dim
    0, so that no cross-model reshuffling is ever needed), each flat,
    padded to a multiple of ``n_clients`` and sharded over the client
    axes (dim 1): the ZeRO-1 partition. A rank holds (1, pad / n_clients)
    a leaf."""

    def leaf(m: meta_lib.Meta) -> meta_lib.Meta:
        n_local = math.prod(meta_lib.local_shape(m, tp))
        return meta_lib.Meta((tp, _pad_to(n_local, n_clients)), torch.float32,
                             ("model", tuple(client_axes)), 0)

    return meta_lib.tree_map(leaf, meta_tree)


def _master_rows(p: torch.Tensor, n_clients: int) -> torch.Tensor:
    """A model shard's leaf flat in float32, zero-padded to a multiple of
    ``n_clients``."""
    f = p.detach().to(torch.float32).reshape(-1)
    return torch.nn.functional.pad(f, (0, _pad_to(f.numel(), n_clients) - f.numel()))


def zero1_init_master(params, meta_tree, tp: int, n_clients: int) -> dict:
    """The GLOBAL master tree (``zero1_master_meta``'s shapes) from GLOBAL
    parameters: each leaf's ``tp`` model blocks (a replicated leaf the
    same ``tp`` times), each flat in float32 and padded, stacked."""

    def leaf(m: meta_lib.Meta, p: torch.Tensor) -> torch.Tensor:
        d = meta_lib.model_dim(m)
        blocks = [p] * tp if d < 0 or tp == 1 else list(p.chunk(tp, d))
        return torch.stack([_master_rows(b, n_clients) for b in blocks])

    return meta_lib.tree_map(leaf, meta_tree, params)


def zero1_master_shard(params, ctx: ParallelCtx) -> dict:
    """This rank's piece of ``zero1_init_master`` from its own (local)
    parameters: its client's block, (1, pad / n_clients) a leaf."""
    n = max(1, ctx.n_clients)
    return map_leaves(lambda i, p: _master_rows(p, n).reshape(n, -1)[ctx.client_index][None]
                      .clone(), params)


def _loss_and_grads(params, cfg: ModelConfig, ctx: ParallelCtx, batch: dict, remat: bool,
                    compute_dtype):
    """The loss (0-d, detached), its aux and the gradient of ``loss / tp``
    in every leaf of ``params`` (``convert.leaves`` order), each of its
    parameter's dtype. Over a model axis, as the reference: psum's
    backward is psum, so every cotangent path that crosses a model-axis
    psum carries one factor of tp, which the division cancels; a
    replicated leaf whose paths cross none comes out at its true gradient
    / tp, which its ``sync = tp`` psum in ``sync_grads`` restores."""
    p_leaves = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        total, aux = model_lib.loss_fn(map_leaves(lambda i, _: p_leaves[i], params), cfg, ctx,
                                       batch, remat=remat, compute_dtype=compute_dtype)
        loss = total / ctx.tp  # the psum self-transpose correction
        grads = list(torch.autograd.grad(loss, p_leaves))
    return loss.detach() * ctx.tp, aux, grads


def _metrics(ctx: ParallelCtx, total, aux) -> dict:
    # the three means in one collective
    means = ctx.pmean_clients(torch.stack(
        [total, aux["ce_loss"].detach(), aux["moe_aux_loss"].detach()]))
    return {"loss": means[0], "ce_loss": means[1], "moe_aux_loss": means[2]}


def build_zero1_train_step_fn(cfg: ModelConfig, mech: Mechanism, lr_fn, ctx: ParallelCtx, *,
                              remat: bool = True, compute_dtype=torch.bfloat16,
                              agg_dtype: str = "auto"):
    """The ZeRO-1 train step ``train_step(params, opt_state, step, batch,
    seeds) -> (params, opt_state, metrics)`` with ``opt_state ==
    {"master": tree}``: the parameters of ``compute_dtype`` (the MoE
    router and the SSM's float32 leaves as ``param_meta`` has them),
    replicated over the clients; the float32 master FLAT-SHARDED over
    them (``zero1_master_meta``; this rank's (1, pad / n) a leaf). Per
    leaf: the encode, the levels padded and reduce-scattered over the
    clients (int16 on the wire where ``agg_width`` allows), ``decode_sum``
    of this rank's slice, ``master - lr * ghat``, then the all_gather of
    the master cast to ``compute_dtype`` (every leaf, as the reference),
    the new parameter its first local-size elements. Per-rank master
    memory drops by n_clients; an all_reduce of levels becomes a
    reduce-scatter of levels and an all_gather of parameters. The master
    shards and every parameter of ``compute_dtype`` are updated IN PLACE
    (the reference's step donates both), so that a full-width step holds
    one copy of each; a float32 leaf under a narrower compute dtype comes
    back as a new leaf of that dtype, as the reference's does."""
    meta_tree = model_lib.param_meta(cfg, tp=ctx.tp, dtype=compute_dtype)
    n = max(1, ctx.n_clients)
    width = agg_width(mech, n, agg_dtype)

    def train_step(params, opt_state, step, batch, seeds):
        total, aux, grads = _loss_and_grads(params, cfg, ctx, batch, remat, compute_dtype)
        grads = meta_lib.sync_grads(grads, meta_tree, ctx)
        masters = leaves(opt_state["master"])
        if len(seeds) != len(grads):
            raise ValueError(f"{len(seeds)} seeds for {len(grads)} parameters")
        lr = lr_fn(step)
        new_params = leaves(params)
        for i in range(len(grads)):
            g, grads[i] = grads[i], None
            mast = masters[i].reshape(-1)  # a view of this rank's shard of the leaf's master
            z = mech.quantize(g, seeds[i]).reshape(-1)
            z = torch.nn.functional.pad(z, (0, mast.numel() * n - z.numel())).reshape(n, -1)
            if mech.name != "none" and width == "int16":
                z_shard = _client_scatter_sum16(z, ctx)
            else:
                z_shard = _client_scatter_sum(z, ctx)
            del z
            mast.sub_(lr * mech.decode_sum(z_shard, n))
            w = _client_all_gather(mast.to(compute_dtype), ctx)[:g.numel()].view(g.shape)
            if new_params[i].dtype == w.dtype:
                new_params[i].copy_(w)
            else:
                new_params[i] = w.clone()
            del g, z_shard, w
        params = map_leaves(lambda i, _: new_params[i], params)
        return params, opt_state, _metrics(ctx, total, aux)

    return train_step


def build_train_step_fn(cfg: ModelConfig, mech: Mechanism, opt: Optimizer, lr_fn,
                        ctx: ParallelCtx, *, remat: bool = True, compute_dtype=torch.bfloat16,
                        packed: bool = False, agg_dtype: str = "int32"):
    """The per-rank train step ``train_step(params, opt_state, step,
    batch, seeds) -> (params, opt_state, metrics)``: the loss computed in
    ``compute_dtype`` (each block checkpointed under ``remat``), its
    gradient in the parameters' own dtype; ``params`` are this rank's
    (its model slices), ``batch`` its client's rows, ``seeds`` its
    per-leaf kernel seeds, ``step`` an int. The metrics are 0-d tensors
    on the device, read back by no one here. Over a model axis, as the
    reference: the gradient of ``loss / tp`` (``_loss_and_grads``), then
    ``sync_grads``, then the encode and the SecAgg sum over the client
    group only (int16 on the wire under ``agg_dtype``, ``agg_width``)."""
    meta_tree = model_lib.param_meta(cfg, tp=ctx.tp)

    def train_step(params, opt_state, step, batch, seeds):
        total, aux, grads = _loss_and_grads(params, cfg, ctx, batch, remat, compute_dtype)
        grads = meta_lib.sync_grads(grads, meta_tree, ctx)  # TP corrections
        ghat = encode_aggregate_decode(grads, meta_tree, mech, ctx, seeds, packed=packed,
                                       agg_dtype=agg_dtype)
        ghat = map_leaves(lambda i, _: ghat[i], params)
        params, opt_state = opt.update(ghat, opt_state, params, lr_fn(step))
        del ghat
        return params, opt_state, _metrics(ctx, total, aux)

    return train_step


def make_train_step(cfg: ModelConfig, plan: MeshPlan, mech: Mechanism, opt: Optimizer,
                    lr_fn, shape: InputShape, *, remat: bool = True,
                    compute_dtype=torch.bfloat16, packed: bool = False,
                    param_dtype=torch.float32, seq_parallel: Optional[bool] = None,
                    sp_compress: bool = False, agg_dtype: str = "int32", zero1: bool = False):
    """The train step of this rank of ``plan``, called with the GLOBAL
    batch of ``shape``: the rank takes its client's rows ``[c B/N, (c+1)
    B/N)`` (the reference's ``shard_map`` in_spec ``P(client_axes,
    None)``; every model rank of a client the same rows), and a batch
    that does not divide over the N clients is refused. ``seq_parallel``
    None: sequence parallelism wherever the model axis divides the
    sequence; ``sp_compress``: its entry gathers int8. ``zero1``: the
    ZeRO-1 step (``build_zero1_train_step_fn``, sgd only), its
    parameters of ``compute_dtype`` and ``opt_state == {"master": ...}``
    (``zero1_master_shard``); else the parameters of ``param_dtype``.
    Returns ``(step_fn, specs)``; ``specs`` holds the parameters' Meta
    tree (global shapes), the optimizer state's (``opt_meta``),
    ``batch_specs``, the rank's ``ctx`` and ``shard_seeds``, its
    per-leaf seed-folding indices (``train_seeds``' ``shards``)."""
    if zero1 and opt.name != "sgd":
        raise NotImplementedError("zero1 currently pairs with sgd")
    if seq_parallel is None:
        seq_parallel = plan.tp > 1 and shape.seq_len % plan.tp == 0
    ctx = plan.ctx(seq_parallel=seq_parallel)
    if sp_compress:
        ctx = dataclasses.replace(ctx, sp_compress=True)
    B, N = shape.global_batch, plan.n_clients
    if B % N:
        raise ValueError(f"global batch {B} does not divide over {N} client ranks "
                         f"(axes {plan.client_axes})")
    lo, hi = ctx.client_index * (B // N), (ctx.client_index + 1) * (B // N)
    if zero1:
        body = build_zero1_train_step_fn(cfg, mech, lr_fn, ctx, remat=remat,
                                         compute_dtype=compute_dtype, agg_dtype=agg_dtype)
        meta_tree = model_lib.param_meta(cfg, tp=plan.tp, dtype=compute_dtype)
        opt_meta = {"master": zero1_master_meta(meta_tree, plan.tp, plan.n_clients,
                                                plan.client_axes)}
    else:
        body = build_train_step_fn(cfg, mech, opt, lr_fn, ctx, remat=remat,
                                   compute_dtype=compute_dtype, packed=packed,
                                   agg_dtype=agg_dtype)
        meta_tree = model_lib.param_meta(cfg, tp=plan.tp, dtype=param_dtype)
        opt_meta = opt.state_meta(meta_tree)

    def step_fn(params, opt_state, step, batch, seeds):
        return body(params, opt_state, step, {k: v[lo:hi] for k, v in batch.items()}, seeds)

    batch_specs = {"tokens": (plan.client_axes, None), "labels": (plan.client_axes, None)}
    if cfg.frontend is not None:
        batch_specs["prefix_embeds"] = (plan.client_axes, None, None)
    return step_fn, {"param_meta": meta_tree, "opt_meta": opt_meta, "batch_specs": batch_specs,
                     "ctx": ctx, "shard_seeds": shard_seed_indices(meta_tree, ctx)}


def batch_structs(cfg: ModelConfig, shape: InputShape) -> dict:
    """One global training batch of ``shape`` as tensors on the meta
    device (shapes and dtypes, nothing allocated): tokens (B, S - P) and
    labels (B, S) int32, a frontend's prefix embeddings (B, P, D)
    bfloat16."""
    B, S = shape.global_batch, shape.seq_len
    pfx = cfg.frontend.prefix_len if cfg.frontend else 0
    out = {"tokens": torch.empty((B, S - pfx), dtype=torch.int32, device="meta"),
           "labels": torch.empty((B, S), dtype=torch.int32, device="meta")}
    if cfg.frontend is not None:
        out["prefix_embeds"] = torch.empty((B, pfx, cfg.d_model), dtype=torch.bfloat16,
                                           device="meta")
    return out


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------


def _token_rows(B: int, ctx: ParallelCtx, *, whole: bool) -> slice:
    """This rank's rows of a global batch of ``B``: its client's block
    (the reference's in_spec ``P(client_axes, None)``), or all of them
    (``whole``: the seq-sharded batch of 1, replicated)."""
    if whole:
        return slice(0, B)
    N = max(1, ctx.n_clients)
    if B % N:
        raise ValueError(f"global batch {B} does not divide over {N} client ranks "
                         f"(axes {ctx.client_axes})")
    return slice(ctx.client_index * (B // N), (ctx.client_index + 1) * (B // N))


def make_decode_step(cfg: ModelConfig, plan: MeshPlan, shape: InputShape, *,
                     compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                     kv_quant: bool = False):
    """One-token decode step against a ``shape.seq_len`` KV cache, on this
    rank of ``plan``: ``fn(params, caches, tokens, pos) -> (next_token,
    caches)``, the caches written in place; ``tokens`` (b, 1) are the
    rank's rows of the global batch (``specs["token_rows"]``), and so are
    the next tokens (equal on a client's model ranks). At batch 1 the
    full-attention caches are sequence-sharded over the client ranks and
    every rank decodes the one row. ``kv_quant``: int8 K/V caches. The
    step computes in ``compute_dtype`` on parameters of ``param_dtype``
    and caches of ``compute_dtype`` (the reference's defaults: both
    bfloat16). Returns ``(fn, specs)``: ``param_meta``, ``cache_meta``
    (also as ``param_specs``/``cache_specs``: each Meta holds its pspec),
    ``token_spec``, ``token_rows`` and this rank's ``ctx``."""
    ctx = plan.ctx()
    seq_sharded = shape.global_batch == 1
    meta_tree = model_lib.param_meta(cfg, tp=ctx.tp, dtype=param_dtype)
    cache_meta = model_lib.cache_meta(cfg, ctx.tp, shape, plan.client_axes, dtype=compute_dtype,
                                      kv_quant=kv_quant)
    rows = _token_rows(shape.global_batch, ctx, whole=seq_sharded)

    def fn(params, caches, tokens, pos):
        return model_lib.decode_step(params, caches, cfg, ctx, tokens, pos,
                                     seq_sharded=seq_sharded, compute_dtype=compute_dtype)

    specs = {"param_meta": meta_tree, "cache_meta": cache_meta,
             "param_specs": meta_tree, "cache_specs": cache_meta,  # each Meta holds its pspec
             "token_spec": (None if seq_sharded else plan.client_axes, None),
             "token_rows": rows, "ctx": ctx}
    return fn, specs


def make_prefill_step(cfg: ModelConfig, plan: MeshPlan, shape: InputShape, *,
                      compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                      seq_parallel: bool = False, sp_compress: bool = False):
    """Prefill a prompt into ``shape.seq_len`` caches and the first token,
    on this rank of ``plan``: ``fn(params, tokens, prefix_embeds=None) ->
    (next_token, caches)`` on the rank's rows of the global batch
    (``specs["token_rows"]``, which must divide over the clients), the
    caches whole on their sequence dim. ``seq_parallel``: the residual
    stream sharded over the model axis (dropped where tp does not divide
    ``shape.seq_len``, as in the reference, and for a prompt it does not
    divide). ``sp_compress``: the sequence-parallel entry gathers as int8
    codes with per-token scales. Computes in ``compute_dtype`` on
    parameters of ``param_dtype`` (both bfloat16 by default, as the
    reference's). Returns ``(fn, specs)``: ``param_meta``,
    ``param_specs``, ``cache_meta``, ``token_spec``, ``token_rows``,
    ``ctx``."""
    if seq_parallel and shape.seq_len % plan.tp != 0:
        seq_parallel = False
    ctx = plan.ctx(seq_parallel=seq_parallel)
    if sp_compress:
        ctx = dataclasses.replace(ctx, sp_compress=True)
    no_sp = plan.ctx()
    meta_tree = model_lib.param_meta(cfg, tp=ctx.tp, dtype=param_dtype)
    rows = _token_rows(shape.global_batch, ctx, whole=False)
    pfx = cfg.frontend.prefix_len if cfg.frontend is not None else 0

    def fn(params, tokens, prefix_embeds=None):
        c = ctx if (pfx + tokens.shape[1]) % ctx.tp == 0 else no_sp
        return model_lib.prefill(params, cfg, c, tokens, shape, prefix_embeds,
                                 compute_dtype=compute_dtype)

    specs = {"param_meta": meta_tree, "param_specs": meta_tree,
             "cache_meta": model_lib.cache_meta(cfg, ctx.tp, shape, plan.client_axes,
                                                dtype=compute_dtype),
             "token_spec": (plan.client_axes, None), "token_rows": rows, "ctx": ctx}
    return fn, specs
