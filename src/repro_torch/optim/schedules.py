"""Learning-rate schedules (counterpart of ``repro/optim/schedules.py``):
pure functions of the integer step.

Each schedule maps a step (an int, or an integer tensor) to the rate as
a 0-d float32 tensor on the ``device`` the schedule was made for (the
card unless the caller asks for the CPU). The rate is computed on the
host, so that the card's run and the CPU's see the same rate and a step
waits for nothing on the card, and copied over without a
synchronisation. The arithmetic is the reference's, op for op, in
float32: ``step / total`` rounded to float32, the clip, ``0.5 * (1 +
cos(pi * frac))``, the ``where`` at ``warmup``; Python scalars enter as
float32, as JAX's weakly typed constants do. torch's float32 ``cos`` and
XLA's may differ in the last place at some steps
(``tests/test_torch_train_meta.py`` records where).
"""
from __future__ import annotations

import math

import torch


def _on_host(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.cpu()
    return torch.tensor(int(step), dtype=torch.int32)


def _to(rate: torch.Tensor, device) -> torch.Tensor:
    return rate.to(device, non_blocking=True)


def _cosine(lr: float, total_steps: int, final_frac: float, step: torch.Tensor):
    frac = torch.clamp(step.to(torch.float32) / total_steps, 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.tensor(lr, dtype=torch.float32) * (final_frac + (1 - final_frac) * cos)


def constant(lr: float, device="cuda"):
    def f(step):
        return _to(torch.tensor(lr, dtype=torch.float32), device)

    return f


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1, device="cuda"):
    def f(step):
        return _to(_cosine(lr, total_steps, final_frac, _on_host(step)), device)

    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1,
                  device="cuda"):
    decay_steps = max(1, total_steps - warmup)

    def f(step):
        step = _on_host(step)
        wu = torch.clamp(step.to(torch.float32) / max(1, warmup), 0.0, 1.0)
        rate = torch.where(step < warmup, torch.tensor(lr, dtype=torch.float32) * wu,
                           _cosine(lr, decay_steps, final_frac, step - warmup))
        return _to(rate, device)

    return f
