"""The Algorithm-1 round step (counterpart of ``repro/fed/rounds.py``).

One round: draw the cohort slate (and, for a heterogeneous cohort, its
participation mask); per-client clipped gradients (or, with
``local_steps > 1``, clipped negative deltas of local SGD); encode and
SecAgg-sum the (clients, dim) batch, the clients that do not take part
masked out; decode at the cohort size; apply through the server
optimizer. ``FedConfig.fused_rounds`` picks how:

  * materialized (the default): one quantize kernel writes the
    (clients, dim) int32 levels, masked rows are zeroed, ``sum(0)`` makes
    the SecAgg sum, then the mechanism's ``decode_sum`` and the
    optimizer's update;
  * fused: one clip -> encode -> cohort-sum kernel, the mask its row
    weights (its output packed into b-bit wire words when the sum bound
    fits) and, for grid mechanisms under plain SGD with no weight decay,
    one fused (unpack ->) decode -> SGD kernel; other mechanisms and
    optimizers decode and apply as above.

Both give the same parameters bit for bit. A fixed cohort decodes at the
int ``clients_per_round``; a heterogeneous one at its realized size
``n_real = part.sum()``, a 0-d device count, with the reference's
traced-n arithmetic (``core/grid.py``), through the fused kernels'
``_dev`` entries where they apply; an empty round (``n_real == 0``)
moves neither the parameters nor the optimizer's state, with nothing
read back to the host. Every step carries the server optimizer's state
beside the parameters: ``(flat, opt_state)`` in and out, as the
reference's carry. The shard engine's step (``make_shard_round_step``)
runs the same round with one cohort slice per rank and sums the slices'
levels over a process group.
"""
from __future__ import annotations

import torch
from torch.func import grad, vmap

from repro_torch.convert import leaves, map_leaves, ravel
from repro_torch.core import secagg, wire
from repro_torch.core.grid import GridGeometry
from repro_torch.fed import cohort
from repro_torch.kernels.decode_apply_kernel import decode_apply_sum
from repro_torch.kernels.pack_kernel import unpack_decode_apply, unpack_flat
from repro_torch.models.common import all_reduce_
from repro_torch.optim.optimizers import make_optimizer


def index_batch(data: dict, ids: torch.Tensor) -> dict:
    """A round's cohort batch: rows ``ids`` of every staged leaf."""
    return {k: v[ids] for k, v in data.items()}


def use_fused_apply(mech, cfg) -> bool:
    """True when the fused decode -> SGD apply replaces decode_sum ->
    optimizer bit-identically: fused rounds, plain SGD with no weight
    decay (the kernel has no decay term), affine grid."""
    wd = (cfg.server_opt_options or {}).get("weight_decay", 0.0)
    return (cfg.fused_rounds and cfg.server_opt == "sgd" and not wd
            and isinstance(getattr(mech, "params", None), GridGeometry))


def server_optimizer(cfg):
    """``cfg.server_opt`` built with ``cfg.server_opt_options``."""
    return make_optimizer(cfg.server_opt, **(cfg.server_opt_options or {}))


def hot_path_pack_bits(mech, cfg, slate: int) -> int | None:
    """Bits per packed wire field of the fused hot path, or None when the
    round's sum travels dense. ``wire_packed=True`` raises when packing
    is impossible rather than going dense."""
    if cfg.wire_packed is False:
        return None
    if not use_fused_apply(mech, cfg):
        if cfg.wire_packed:
            raise ValueError(
                "wire_packed=True requires the fused hot path it packs: "
                "fused_rounds=True, server_opt='sgd' with no weight_decay "
                "and a grid mechanism")
        return None
    bound = mech.sum_bound(slate)
    if cfg.wire_packed:
        return wire.check_packable(bound, where="wire_packed=True: ")
    return wire.sum_bits(bound) if wire.packable(bound) else None


def make_client_grad(mech, unravel, task, cfg=None, *, per_row: bool = False, ctx=None):
    """Per-client releases of a cohort batch, ``client_grads(flat, batch)
    -> (clients, dim)``, ``vmap`` over the clients axis of every batch
    leaf: the clipped gradient (``local_steps`` 1, Algorithm 1), or the
    clipped negative delta ``flat - flat_new`` after ``cfg.local_steps``
    SGD steps at ``cfg.local_lr`` (FedAvg-RQM). Either is one [-c, c]
    vector a client a round, accounted the same. ``per_row``: ``flat`` is
    (clients, dim), row i the parameters client i computes at (the async
    engine's stale versions), mapped with the batch (``in_dims=(0, 0)``;
    ``unravel`` slices each row into views, so no row is copied).

    When ``ctx`` carries a model axis (the shard engine's 2-D grid, tp >
    1; ``per_row`` is the async engine's, which has none) the gradient
    runs tensor-parallel, client by client (the model axis's collectives
    do not ``vmap``): the task shards the global
    parameters, takes the gradient of its ``local_loss`` (``loss / tp``)
    over its slices, then syncs and all-gathers it back to the global
    layout (``gather_grads``), so that every model rank holds the same
    global clipped vector and encodes it identically."""
    local_steps = cfg.local_steps if cfg is not None else 1
    local_lr = cfg.local_lr if cfg is not None else 0.0
    tp = ctx is not None and ctx.model

    if tp:
        def flat_grad(flat, batch):
            tree = task.shard_params(unravel(flat), ctx)
            local = [t.detach().requires_grad_() for t in leaves(tree)]
            with torch.enable_grad():
                loss = task.local_loss(map_leaves(lambda i, _: local[i], tree), batch, ctx)
                g_local = list(torch.autograd.grad(loss, local))
            return ravel(task.gather_grads(g_local, ctx))[0]
    else:
        def flat_loss(flat, batch):
            return task.loss(unravel(flat), batch)

        flat_grad = grad(flat_loss)

    def client_delta(flat, batch):
        cur = flat
        for _ in range(local_steps):
            cur = cur - local_lr * flat_grad(cur, batch)
        return flat - cur

    one_client = flat_grad if local_steps <= 1 else client_delta
    if tp:
        def per_client(flat, batch):
            n = next(iter(batch.values())).shape[0]
            return torch.stack([one_client(flat, {k: v[i] for k, v in batch.items()})
                                for i in range(n)])
    else:
        per_client = vmap(one_client, in_dims=(0 if per_row else None, 0))

    def client_grads(flat: torch.Tensor, batch: dict) -> torch.Tensor:
        return per_client(flat, batch).clamp(-mech.clip, mech.clip)

    return client_grads


def keep_if(ok: torch.Tensor, new, old):
    """``new`` where the 0-d device bool ``ok`` holds, else ``old``: a
    tensor or an optimizer state (``()`` or a dict of tensors), with
    nothing read back to the host."""
    if isinstance(new, dict):
        return {k: torch.where(ok, v, old[k]) for k, v in new.items()}
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    return new


def make_server_apply(opt, cfg):
    """The decode-then-apply boundary: ``apply(flat, opt_state, g_hat,
    n_real=None) -> (new_flat, new_state)`` through the server optimizer.
    Given the device count ``n_real`` of a heterogeneous round, an empty
    round (``n_real == 0``) moves neither the parameters nor the state."""
    lr = cfg.lr

    def apply(flat: torch.Tensor, opt_state, g_hat: torch.Tensor, n_real=None):
        new, new_state = opt.update(g_hat, opt_state, flat, lr)
        if n_real is not None:
            ok = n_real > 0
            new, new_state = keep_if(ok, new, flat), keep_if(ok, new_state, opt_state)
        return new, new_state

    return apply


def make_decode_apply(mech, cfg, slate: int, opt=None):
    """The server side of a round after its SecAgg sum: ``finish(flat,
    opt_state, z_sum, n_real=None) -> (new_flat, new_state, z_sum)``.
    Decodes at the cohort size (``clients_per_round``, or the device count
    ``n_real`` of a heterogeneous round) and applies through the server
    optimizer, or through the fused (unpack ->) decode -> SGD kernel on
    the fused rounds that have it (stateless: the state passes through;
    at a device count its ``_dev`` entry, which leaves an empty round's
    parameters as they were). The ``z_sum`` returned is dense when
    ``cfg.collect_sums`` (unpacked if it travelled packed), else the
    round's wire form."""
    apply = make_server_apply(opt or server_optimizer(cfg), cfg)
    fused_apply = use_fused_apply(mech, cfg)
    pack_bits = hot_path_pack_bits(mech, cfg, slate)
    n = cfg.clients_per_round

    def finish(flat, opt_state, z_sum, n_real=None):
        if not fused_apply:
            n_dec = n if n_real is None else n_real.clamp(min=1)
            return *apply(flat, opt_state, mech.decode_sum(z_sum, n_dec), n_real), z_sum
        count = n if n_real is None else n_real
        if pack_bits is None:
            return decode_apply_sum(flat, z_sum, mech.params, count, cfg.lr), opt_state, z_sum
        new = unpack_decode_apply(flat, z_sum, mech.params, count, cfg.lr,
                                  pack_bits=pack_bits)
        if cfg.collect_sums:
            z_sum = unpack_flat(z_sum, pack_bits, flat.numel())
        return new, opt_state, z_sum

    return finish


def make_round_step(mech, cfg, slate: int, client_grads, opt=None):
    """``round_step(flat, opt_state, data, generator, *, ids=None,
    seed=None, part=None)`` -> ``(new_flat, new_state, z_sum)``.
    ``generator`` draws what is not given, in the stream's order: the
    cohort ids, the uint32 kernel seed and, for a heterogeneous cohort,
    its participation mask ``part`` (0/1 a slot); tests may inject them
    (the reference's cohort, mask and ``key_to_seed`` of its encode key).
    ``z_sum`` as ``make_decode_apply`` returns it. ``opt`` defaults to
    ``cfg.server_opt``'s."""
    finish = make_decode_apply(mech, cfg, slate, opt)
    pack_bits = hot_path_pack_bits(mech, cfg, slate)

    def round_step(flat, opt_state, data, generator=None, *, ids=None, seed=None, part=None):
        ids, seed, part = cohort.draw_round(cfg, slate, generator, ids, seed, part)
        ids = torch.as_tensor(ids, device=flat.device)
        grads = client_grads(flat, index_batch(data, ids))
        n_real = None
        if part is not None:
            part = torch.as_tensor(part, device=flat.device).to(torch.int32)
            n_real = part.sum(dtype=torch.int32)
        if cfg.fused_rounds:
            z_sum = mech.quantize_sum_batch(grads, seed, weights=part, pack_bits=pack_bits)
        else:
            z = mech.quantize_batch(grads, seed)
            if part is not None:
                z = z * part.to(z.dtype)[:, None]  # those not taking part: 0
            z_sum = z.sum(0, dtype=z.dtype)  # the SecAgg sum
        return finish(flat, opt_state, z_sum, n_real)

    return round_step


def make_shard_round_step(mech, cfg, slate: int, shards: int, rank: int, group,
                          client_grads, opt=None):
    """The shard engine's round step on rank ``rank`` of ``shards``:
    ``round_step(flat, opt_state, data, generator, *, ids=None, seed=None,
    part=None, batch=None) -> (new_flat, new_state, z_sum)``.

    Every rank draws the same cohort, seed and mask from its copy of the
    replicated generator, takes its slice ``[rank n_per, (rank+1)
    n_per)`` of the cohort (``batch``, when streamed staging gathered it
    already) and of the mask, and encodes it at row offset ``rank
    n_per``, so its levels are the rows of the unsharded batch. Its
    partial sum crosses the SecAgg boundary as integers over ``group``:
    the fused packed sum (already wire words) as one plain all_reduce of
    words, any other through ``secagg.secure_sum_bounded`` at the full
    slate's bound. Then the replicated decode + apply of
    ``make_decode_apply``, at the full cohort's realized size. At one
    rank the step still packs, all-reduces and unpacks, as the
    reference's does."""
    finish = make_decode_apply(mech, cfg, slate, opt)
    pack_bits = hot_path_pack_bits(mech, cfg, slate)
    bound = mech.sum_bound(slate)
    packed = cfg.shard_packed is None or cfg.shard_packed
    n_per = slate // shards
    row_offset = rank * n_per

    def round_step(flat, opt_state, data, generator=None, *, ids=None, seed=None,
                   part=None, batch=None):
        ids, seed, part = cohort.draw_round(cfg, slate, generator, ids, seed, part)
        if batch is None:
            mine = torch.as_tensor(ids)[row_offset:row_offset + n_per]
            batch = index_batch(data, mine.to(flat.device))
        grads = client_grads(flat, batch)
        n_real = local = None
        if part is not None:
            part = torch.as_tensor(part, device=flat.device).to(torch.int32)
            n_real = part.sum(dtype=torch.int32)
            local = part[row_offset:row_offset + n_per]
        if cfg.fused_rounds:
            z_part = mech.quantize_sum_batch(grads, seed, weights=local, row_offset=row_offset,
                                             pack_bits=pack_bits)
        else:
            z = mech.quantize_batch(grads, seed, row_offset=row_offset)
            if local is not None:
                z = z * local.to(z.dtype)[:, None]
            z_part = z.sum(0, dtype=z.dtype)  # this rank's partial sum
        if pack_bits is not None:
            # fields add on their own in int32 words (checked against the
            # full slate's bound by hot_path_pack_bits)
            z_sum = z_part
            all_reduce_(z_sum, group)
        else:
            z_sum = secagg.secure_sum_bounded(z_part, group, bound, packed=packed)
        return finish(flat, opt_state, z_sum, n_real)

    return round_step
