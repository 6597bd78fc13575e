"""The Algorithm-1 round step (counterpart of ``repro/fed/rounds.py``).

One round: sample the cohort; per-client clipped gradients; encode and
SecAgg-sum the (clients, dim) batch; decode at the cohort size; apply
through the server optimizer. ``FedConfig.fused_rounds`` picks how:

  * materialized (the default): one quantize kernel writes the
    (clients, dim) int32 levels, ``sum(0)`` makes the SecAgg sum, then
    the mechanism's ``decode_sum`` and the optimizer's update;
  * fused: one clip -> encode -> cohort-sum kernel (its output packed
    into b-bit wire words when the sum bound fits) and, for grid
    mechanisms under plain SGD, one fused (unpack ->) decode -> SGD
    kernel; other mechanisms decode and apply as above.

Both give the same parameters bit for bit.
"""
from __future__ import annotations

import torch
from torch.func import grad, vmap

from repro_torch.core import wire
from repro_torch.core.grid import GridGeometry
from repro_torch.fed import cohort
from repro_torch.kernels.decode_apply_kernel import decode_apply_sum
from repro_torch.kernels.pack_kernel import unpack_decode_apply
from repro_torch.optim.optimizers import make_optimizer


def index_batch(data: dict, ids: torch.Tensor) -> dict:
    """A round's cohort batch: rows ``ids`` of every staged leaf."""
    return {k: v[ids] for k, v in data.items()}


def use_fused_apply(mech, cfg) -> bool:
    """True when the fused decode -> SGD apply replaces decode_sum ->
    optimizer bit-identically: fused rounds, plain SGD, affine grid."""
    return (cfg.fused_rounds and cfg.server_opt == "sgd"
            and isinstance(getattr(mech, "params", None), GridGeometry))


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
                "fused_rounds=True, server_opt='sgd' and a grid mechanism")
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
    """The decode-then-apply boundary: ``apply(flat, g_hat) -> new_flat``
    through the server optimizer. Only stateless SGD is ported
    (``validate_config`` refuses momentum and adam), so no optimizer
    state is carried between rounds."""
    lr = cfg.lr

    def apply(flat: torch.Tensor, g_hat: torch.Tensor) -> torch.Tensor:
        new, _ = opt.update(g_hat, opt.init(flat), flat, lr)
        return new

    return apply


def make_round_step(mech, cfg, slate: int, client_grads, opt=None):
    """``round_step(flat, data, generator, *, ids=None, seed=None)`` ->
    ``(new_flat, z_sum)``. ``generator`` draws the cohort ids and then the
    uint32 kernel seed; tests may inject either (the reference's cohort
    and ``key_to_seed`` of its encode key). ``z_sum`` is the dense sum
    when ``cfg.collect_sums`` (unpacked if it travelled packed), else
    the round's wire form. ``opt`` defaults to ``cfg.server_opt``'s."""
    apply = make_server_apply(opt or make_optimizer(cfg.server_opt), cfg)
    fused_apply = use_fused_apply(mech, cfg)
    pack_bits = hot_path_pack_bits(mech, cfg, slate)
    n = cfg.clients_per_round

    def round_step(flat, data, generator=None, *, ids=None, seed=None):
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
        if not fused_apply:
            return apply(flat, mech.decode_sum(z_sum, n)), z_sum
        if pack_bits is None:
            return decode_apply_sum(flat, z_sum, mech.params, n, cfg.lr), z_sum
        new = unpack_decode_apply(flat, z_sum, mech.params, n, cfg.lr, pack_bits=pack_bits)
        if cfg.collect_sums:
            z_sum = wire.unpack_bits(z_sum, pack_bits, flat.numel())
        return new, z_sum

    return round_step
