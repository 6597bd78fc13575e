"""The Algorithm-1 round step (counterpart of ``repro/fed/rounds.py``).

One round: sample the cohort; per-client clipped gradients; one fused
clip -> RQM encode -> cohort sum (the SecAgg release, packed into b-bit
wire words when the sum bound fits); one fused unpack -> decode -> SGD
apply at the cohort size.
"""
from __future__ import annotations

import torch
from torch.func import grad, vmap

from repro_torch.core import wire
from repro_torch.core.grid import GridGeometry
from repro_torch.fed import cohort
from repro_torch.kernels.decode_apply_kernel import decode_apply_sum
from repro_torch.kernels.pack_kernel import unpack_decode_apply


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


def make_round_step(mech, cfg, slate: int, client_grads):
    """``round_step(flat, data, generator, *, ids=None, seed=None)`` ->
    ``(new_flat, z_sum)``. ``generator`` draws the cohort ids and then the
    uint32 kernel seed; tests may inject either (the reference's cohort
    and ``key_to_seed`` of its encode key). ``z_sum`` is the dense sum
    when ``cfg.collect_sums`` (unpacked if it travelled packed), else
    the round's wire form."""
    if not use_fused_apply(mech, cfg):
        raise NotImplementedError(
            "only the fused decode -> SGD apply is ported: ROADMAP.md queue A item 5")
    pack_bits = hot_path_pack_bits(mech, cfg, slate)
    n = cfg.clients_per_round

    def round_step(flat, data, generator=None, *, ids=None, seed=None):
        if ids is None:
            ids = cohort.sample_slate(cfg, slate, generator)
        if seed is None:
            seed = cohort.draw_seed(generator)
        ids = torch.as_tensor(ids, device=flat.device)
        grads = client_grads(flat, index_batch(data, ids))
        z_sum = mech.quantize_sum_batch(grads, seed, pack_bits=pack_bits)
        if pack_bits is None:
            new = decode_apply_sum(flat, z_sum, mech.params, n, cfg.lr)
        else:
            new = unpack_decode_apply(flat, z_sum, mech.params, n, cfg.lr,
                                      pack_bits=pack_bits)
            if cfg.collect_sums:
                z_sum = wire.unpack_bits(z_sum, pack_bits, flat.numel())
        return new, z_sum

    return round_step
