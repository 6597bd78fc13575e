"""The Algorithm-1 round step (counterpart of ``repro/fed/rounds.py``).

One round: sample the cohort; per-client clipped gradients; encode and
SecAgg-sum the (clients, dim) batch; decode at the cohort size; apply
through the server optimizer. ``FedConfig.fused_rounds`` picks how:

  * materialized (the default): one quantize kernel writes the
    (clients, dim) int32 levels, ``sum(0)`` makes the SecAgg sum, then
    the mechanism's ``decode_sum`` and the optimizer's update;
  * fused: one clip -> encode -> cohort-sum kernel (its output packed
    into b-bit wire words when the sum bound fits) and, for grid
    mechanisms under plain SGD with no weight decay, one fused (unpack ->)
    decode -> SGD kernel; other mechanisms and optimizers decode and apply
    as above.

Both give the same parameters bit for bit. Every step carries the
server optimizer's state beside the parameters: ``(flat, opt_state)`` in
and out, as the reference's carry. The shard engine's step
(``make_shard_round_step``) runs the same round with one cohort slice
per rank and sums the slices' levels over a process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.func import grad, vmap

from repro_torch.core import secagg, wire
from repro_torch.core.grid import GridGeometry
from repro_torch.fed import cohort
from repro_torch.kernels.decode_apply_kernel import decode_apply_sum
from repro_torch.kernels.pack_kernel import unpack_decode_apply, unpack_flat
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


def make_client_grad(mech, unravel, task):
    """Per-client clipped gradients of a cohort batch,
    ``client_grads(flat, batch) -> (clients, dim)``: ``vmap`` of ``grad``
    over the clients axis of every batch leaf (one clipped gradient per
    client, Algorithm 1 with a single local step)."""

    def flat_loss(flat, batch):
        return task.loss(unravel(flat), batch)

    per_client = vmap(grad(flat_loss), in_dims=(None, 0))

    def client_grads(flat: torch.Tensor, batch: dict) -> torch.Tensor:
        return per_client(flat, batch).clamp(-mech.clip, mech.clip)

    return client_grads


def make_server_apply(opt, cfg):
    """The decode-then-apply boundary: ``apply(flat, opt_state, g_hat) ->
    (new_flat, new_state)`` through the server optimizer."""
    lr = cfg.lr

    def apply(flat: torch.Tensor, opt_state, g_hat: torch.Tensor):
        return opt.update(g_hat, opt_state, flat, lr)

    return apply


def make_decode_apply(mech, cfg, slate: int, opt=None):
    """The server side of a round after its SecAgg sum: ``finish(flat,
    opt_state, z_sum) -> (new_flat, new_state, z_sum)``. Decodes at the
    cohort size and applies through the server optimizer, or through the
    fused (unpack ->) decode -> SGD kernel on the fused rounds that have
    it (stateless: the state passes through). The ``z_sum`` returned is
    dense when ``cfg.collect_sums`` (unpacked if it travelled packed),
    else the round's wire form."""
    apply = make_server_apply(opt or server_optimizer(cfg), cfg)
    fused_apply = use_fused_apply(mech, cfg)
    pack_bits = hot_path_pack_bits(mech, cfg, slate)
    n = cfg.clients_per_round

    def finish(flat, opt_state, z_sum):
        if not fused_apply:
            return *apply(flat, opt_state, mech.decode_sum(z_sum, n)), z_sum
        if pack_bits is None:
            return decode_apply_sum(flat, z_sum, mech.params, n, cfg.lr), opt_state, z_sum
        new = unpack_decode_apply(flat, z_sum, mech.params, n, cfg.lr, pack_bits=pack_bits)
        if cfg.collect_sums:
            z_sum = unpack_flat(z_sum, pack_bits, flat.numel())
        return new, opt_state, z_sum

    return finish


def make_round_step(mech, cfg, slate: int, client_grads, opt=None):
    """``round_step(flat, opt_state, data, generator, *, ids=None,
    seed=None)`` -> ``(new_flat, new_state, z_sum)``. ``generator`` draws
    the cohort ids and then the uint32 kernel seed; tests may inject
    either (the reference's cohort
    and ``key_to_seed`` of its encode key). ``z_sum`` as
    ``make_decode_apply`` returns it. ``opt`` defaults to
    ``cfg.server_opt``'s."""
    finish = make_decode_apply(mech, cfg, slate, opt)
    pack_bits = hot_path_pack_bits(mech, cfg, slate)

    def round_step(flat, opt_state, data, generator=None, *, ids=None, seed=None):
        if ids is None:
            ids = cohort.sample_slate(cfg, slate, generator)
        if seed is None:
            seed = cohort.draw_seed(generator)
        ids = torch.as_tensor(ids, device=flat.device)
        grads = client_grads(flat, index_batch(data, ids))
        if cfg.fused_rounds:
            z_sum = mech.quantize_sum_batch(grads, seed, pack_bits=pack_bits)
        else:
            z = mech.quantize_batch(grads, seed)
            z_sum = z.sum(0, dtype=z.dtype)  # the SecAgg sum
        return finish(flat, opt_state, z_sum)

    return round_step


def make_shard_round_step(mech, cfg, slate: int, shards: int, rank: int, group,
                          client_grads, opt=None):
    """The shard engine's round step on rank ``rank`` of ``shards``:
    ``round_step(flat, opt_state, data, generator, *, ids=None, seed=None,
    batch=None) -> (new_flat, new_state, z_sum)``.

    Every rank draws the same cohort and seed from its copy of the
    replicated generator, takes its slice ``[rank n_per, (rank+1)
    n_per)`` of the cohort (``batch``, when streamed staging gathered it
    already), and encodes it at row offset ``rank n_per``, so its levels
    are the rows of the unsharded batch. Its partial sum crosses the
    SecAgg boundary as integers over ``group``: the fused packed sum
    (already wire words) as one plain all_reduce of words, any other
    through ``secagg.secure_sum_bounded`` at the full cohort's bound.
    Then the replicated decode + apply of ``make_decode_apply``. At one
    rank the step still packs, all-reduces and unpacks, as the
    reference's does."""
    finish = make_decode_apply(mech, cfg, slate, opt)
    pack_bits = hot_path_pack_bits(mech, cfg, slate)
    bound = mech.sum_bound(slate)
    packed = cfg.shard_packed is None or cfg.shard_packed
    n_per = slate // shards
    row_offset = rank * n_per

    def round_step(flat, opt_state, data, generator=None, *, ids=None, seed=None,
                   batch=None):
        if ids is None:
            ids = cohort.sample_slate(cfg, slate, generator)
        if seed is None:
            seed = cohort.draw_seed(generator)
        if batch is None:
            mine = torch.as_tensor(ids)[row_offset:row_offset + n_per]
            batch = index_batch(data, mine.to(flat.device))
        grads = client_grads(flat, batch)
        if cfg.fused_rounds:
            z_part = mech.quantize_sum_batch(grads, seed, row_offset=row_offset,
                                             pack_bits=pack_bits)
        else:
            z = mech.quantize_batch(grads, seed, row_offset=row_offset)
            z_part = z.sum(0, dtype=z.dtype)  # this rank's partial sum
        if pack_bits is not None:
            # fields add on their own in int32 words (checked against the
            # full cohort's bound by hot_path_pack_bits)
            z_sum = z_part
            dist.all_reduce(z_sum, op=dist.ReduceOp.SUM, group=group)
        else:
            z_sum = secagg.secure_sum_bounded(z_part, group, bound, packed=packed)
        return finish(flat, opt_state, z_sum)

    return round_step
