"""Dense MLP variants (counterpart of ``repro/models/mlp.py``):
column-parallel in, row-parallel out (``d_ff / tp`` a rank, the output's
psum in ``sp_scatter``).

Kinds:
  swiglu        silu(x Wg) * (x Wu) Wd        (llama/mistral/chatglm/qwen…)
  geglu         gelu(x Wg) * (x Wu) Wd        (gemma)
  squared_relu  relu(x W1)^2 Wd               (nemotron-4)
  gelu          gelu(x W1) Wd                 (musicgen)

GELU is the tanh approximation, ``jax.nn.gelu``'s default; below
float32 both activations follow the reference's formulas op by op
(``common.silu``, ``common.gelu``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParallelCtx, dense_init, gelu, silu, squeeze_tp
from repro_torch.models.meta import Meta

GATED = {"swiglu", "geglu"}


def init_params(generator: torch.Generator, kind: str, d_model: int, d_ff: int,
                device="cuda", tp: int = 1, keep=None, dtype=torch.float32) -> dict:
    """The global parameters at ``tp``, of ``dtype``; ``keep(t, meta)`` as
    in ``attention.init_params``."""
    if d_ff % tp != 0:
        raise ValueError(f"d_ff={d_ff} not divisible by tp={tp}")
    meta = param_meta(kind, d_model, d_ff, tp, dtype)

    def init(name, in_axis):
        t = dense_init(generator, meta[name].shape, in_axis=in_axis, device=device, dtype=dtype)
        return t if keep is None else keep(t, meta[name])

    if kind in GATED:
        p = {"w_gate": init("w_gate", 0), "w_up": init("w_up", 0)}
    else:
        p = {"w_in": init("w_in", 0)}
    p["w_down"] = init("w_down", 1)
    return p


def param_meta(kind: str, d_model: int, d_ff: int, tp: int = 1, dtype=torch.float32) -> dict:
    f_l = d_ff // tp
    m = {"w_down": Meta((tp, f_l, d_model), dtype, ("model", None, None), 1)}
    if kind in GATED:
        m["w_gate"] = Meta((d_model, tp, f_l), dtype, (None, "model", None), 1)
        m["w_up"] = Meta((d_model, tp, f_l), dtype, (None, "model", None), 1)
    else:
        m["w_in"] = Meta((d_model, tp, f_l), dtype, (None, "model", None), 1)
    return m


def forward(params: dict, kind: str, ctx: ParallelCtx, x: torch.Tensor) -> torch.Tensor:
    """x: (..., D) replicated over the model axis -> (..., D) summed over
    it (psum_scattered along the sequence with sequence parallelism)."""
    if kind in GATED:
        g = x @ squeeze_tp(params["w_gate"], 1).to(x.dtype)
        u = x @ squeeze_tp(params["w_up"], 1).to(x.dtype)
        act = silu(g) if kind == "swiglu" else gelu(g)
        h = act * u
    else:
        h = x @ squeeze_tp(params["w_in"], 1).to(x.dtype)
        if kind == "squared_relu":
            h = torch.square(F.relu(h))
        elif kind == "gelu":
            h = gelu(h)
        else:
            raise ValueError(f"unknown mlp kind {kind!r}")
    y = h @ squeeze_tp(params["w_down"], 0).to(h.dtype)
    return ctx.sp_scatter(y)
