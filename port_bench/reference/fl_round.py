"""The paper's round (Algorithm 1), plain: each taking client's mean
cross entropy gradient, clipped to [-c, c]; its RQM levels (row r of the
slate draws counters ``r * dim + c``; the taking rows are encoded in one
batch); their integer sum; the decode at the round's client count; the
server's SGD step ``w - lr * g_hat``. An empty round moves nothing."""
from __future__ import annotations

import torch

from . import emnist, rqm


def client_grad(flat: torch.Tensor, shape_of: dict, images, labels) -> torch.Tensor:
    leaf = {k: v.detach().clone().requires_grad_() for k, v in
            emnist.unflatten(flat, shape_of).items()}
    loss = emnist.loss(leaf, images, labels)
    grads = torch.autograd.grad(loss, [leaf[k] for k in sorted(leaf)])
    return torch.cat([g.reshape(-1) for g in grads])


def run_round(flat, shape_of, population, ids, seed, part, p: rqm.RQM, lr: float,
              device_count: bool, half_batch: bool = False):
    """One round from ``flat``: (new flat, integer sum). ``half_batch``
    plants a fault: the first half of the taking clients alone, their
    mean taken."""
    rows = [r for r in range(len(ids)) if bool(part[r])]
    if half_batch:
        rows = rows[:max(1, len(rows) // 2)]
    if not rows:
        return flat.clone(), torch.zeros(flat.numel(), dtype=torch.int64, device=flat.device)
    grads = []
    for r in rows:
        im, lb = population.client(int(ids[r]))
        grads.append(client_grad(flat, shape_of, torch.from_numpy(im).to(flat.device),
                                 torch.from_numpy(lb).to(flat.device)))
    z = rqm.encode_rows(torch.stack(grads).clamp(-p.c, p.c), seed, p, rows=rows)
    z_sum = z.sum(0, dtype=torch.int64)
    g_hat = rqm.decode(z_sum, len(rows), p, device_count)
    return flat - lr * g_hat, z_sum
