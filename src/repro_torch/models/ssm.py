"""Mamba2 (state-space duality / SSD) blocks (counterpart of
``repro/models/ssm.py``): the chunked training / prefill forward and the
recurrent decode step.

Over a model axis of tp the heads are sharded (``heads_local(tp)`` a
rank): the in-projection ``w_zx`` is column-parallel, its global layout
(D, tp, 2 di_l) packing each rank's z and x streams together, and
``w_out`` row-parallel; the shared B/C projection and its conv (ngroups
= 1) are replicated (``sync = tp``). The gated RMSNorm spans the whole
d_inner, its mean square psummed over the axis.

The chunked SSD algorithm (Dao & Gu, 2024) as dense einsums per chunk:
an intra-chunk quadratic form, whose decay is masked to ``-inf`` BEFORE
``exp`` (masking after it would overflow), and the inter-chunk state
recurrence, here a Python loop over the static chunk count (the
reference's ``lax.scan``) that reads nothing back to the host.

Decode is the O(1) recurrent update h' = exp(A dt) h + dt * (B x), on a
state dict of ``h`` (B, tp, h, P, N) and the raw pre-conv tails
``conv_x`` (B, tp, W-1, di) and ``conv_bc`` (B, W-1, 2N), which
``forward(..., return_state=True)`` hands over from a prompt. ``decode``
updates the state's tensors in place (the reference returns new ones):
a state is not to be reused after the step that wrote it.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParallelCtx, dense_init, squeeze_tp
from repro_torch.models.meta import Meta


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_model: int
    state_dim: int          # N
    head_dim: int = 64      # P (mamba2 convention)
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim

    def heads_local(self, tp: int) -> int:
        if self.num_heads % tp != 0:
            raise ValueError(f"ssm heads {self.num_heads} not divisible by tp={tp}")
        return self.num_heads // tp


def init_params(generator: torch.Generator, spec: SSMSpec, device="cuda", tp: int = 1,
                keep=None) -> dict:
    """The global parameters at ``tp`` (each rank's heads numbered from 1
    in ``A_log``, as the reference's); ``keep(t, meta)`` as in
    ``attention.init_params``."""
    h_l = spec.heads_local(tp)
    meta = param_meta(spec, tp)

    def init(name, in_axis=0):
        t = dense_init(generator, meta[name].shape, in_axis=in_axis, device=device)
        return t if keep is None else keep(t, meta[name])

    def put(name, t):
        t = t.to(device)
        return t if keep is None else keep(t, meta[name])

    # dt log-uniform in [dt_min, dt_max]; its bias the inverse softplus
    u = torch.rand((tp, h_l), generator=generator, dtype=torch.float32,
                   device=generator.device)
    dt = torch.exp(u * (math.log(spec.dt_max) - math.log(spec.dt_min)) + math.log(spec.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a_log = torch.log(torch.arange(1, h_l + 1, dtype=torch.float32)[None]).repeat(tp, 1)
    return {
        "w_zx": init("w_zx"),  # z (gate) and x streams, per rank
        "w_bc": init("w_bc"),  # shared B and C projections (ngroups=1)
        "w_dt": init("w_dt"),
        "conv_x": init("conv_x", 1),
        "conv_bc": init("conv_bc"),
        "A_log": put("A_log", a_log),
        "D_skip": put("D_skip", torch.ones((tp, h_l))),
        "dt_bias": put("dt_bias", dt_bias),
        "norm": put("norm", torch.zeros(meta["norm"].shape)),
        "w_out": init("w_out", 1),
    }


def param_meta(spec: SSMSpec, tp: int = 1) -> dict:
    h_l = spec.heads_local(tp)
    di_l = h_l * spec.head_dim
    D, N, W = spec.d_model, spec.state_dim, spec.conv_width
    return {
        "w_zx": Meta((D, tp, 2 * di_l), torch.float32, (None, "model", None), 1),
        "w_bc": Meta((D, 2 * N), torch.float32, (None, None), tp),
        "w_dt": Meta((D, tp, h_l), torch.float32, (None, "model", None), 1),
        "conv_x": Meta((tp, W, di_l), torch.float32, ("model", None, None), 1),
        "conv_bc": Meta((W, 2 * N), torch.float32, (None, None), tp),
        "A_log": Meta((tp, h_l), torch.float32, ("model", None), 1),
        "D_skip": Meta((tp, h_l), torch.float32, ("model", None), 1),
        "dt_bias": Meta((tp, h_l), torch.float32, ("model", None), 1),
        "norm": Meta((tp, di_l), torch.float32, ("model", None), 1),
        "w_out": Meta((tp, di_l, D), torch.float32, ("model", None, None), 1),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gated_rms_norm(y, z, w, ctx: ParallelCtx, eps: float = 1e-6):
    """Mamba2's RMSNormGated over the full d_inner dimension, which is
    head-sharded over the model axis: the mean square is psummed."""
    x = (y * F.silu(z)).to(torch.float32)
    total = ctx.psum_model(x.square().sum(-1, keepdim=True))
    var = total / (x.shape[-1] * (ctx.tp if ctx.model_axis is not None else 1))
    return ((x * torch.rsqrt(var + eps)) * (1.0 + w.to(torch.float32))).to(y.dtype)


def _depthwise_causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (W, C) depthwise causal conv + silu."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + S] * w[i] for i in range(W))
    return F.silu(out)


def _project(params: dict, spec: SSMSpec, ctx: ParallelCtx, x: torch.Tensor):
    """x: (B,S,D) -> z,xs:(B,S,di_l), B,C:(B,S,2N), dt:(B,S,h_l)."""
    zx = x @ squeeze_tp(params["w_zx"], 1).to(x.dtype)
    di_l = zx.shape[-1] // 2
    z, xs = zx[..., :di_l], zx[..., di_l:]
    bc = x @ params["w_bc"].to(x.dtype)
    dt_raw = x @ squeeze_tp(params["w_dt"], 1).to(x.dtype)
    dt = softplus(dt_raw.to(torch.float32) + squeeze_tp(params["dt_bias"], 0))
    return z, xs, bc, dt


def forward(params: dict, spec: SSMSpec, ctx: ParallelCtx, x: torch.Tensor, *,
            return_state: bool = False):
    """Training path (chunked SSD). x: (B, S, D) -> (B, S, D).

    return_state: also return the decode-ready state dict (the final
    recurrent state and the raw conv tails), so prefill can hand off to
    ``decode``."""
    B, S, D = x.shape
    N, P_, Q = spec.state_dim, spec.head_dim, min(spec.chunk, x.shape[1])
    if S % Q != 0:
        Q = S  # irregular (small/test) lengths: single chunk
    nC = S // Q
    z, xs, bc, dt = _project(params, spec, ctx, x)
    h_l = dt.shape[-1]
    xs_raw, bc_raw = xs, bc  # pre-conv streams (decode conv state)

    xs = _depthwise_causal_conv(xs, squeeze_tp(params["conv_x"], 0).to(x.dtype))
    bc = _depthwise_causal_conv(bc, params["conv_bc"].to(x.dtype))
    Bm, Cm = bc[..., :N], bc[..., N:]

    A = -torch.exp(squeeze_tp(params["A_log"], 0))  # (h_l,) negative
    xh = xs.reshape(B, nC, Q, h_l, P_).to(torch.float32)
    dt_c = dt.reshape(B, nC, Q, h_l)
    B_c = Bm.reshape(B, nC, Q, N).to(torch.float32)
    C_c = Cm.reshape(B, nC, Q, N).to(torch.float32)

    da = dt_c * A  # (B, nC, Q, h)  log-decay increments
    cum = torch.cumsum(da, dim=2)  # within-chunk inclusive cumsum
    # intra-chunk: y[i] = sum_{j<=i} exp(cum_i - cum_j) (C_i.B_j) dt_j x_j
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nC,Q_i,Q_j,h)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.where(mask[None, None, :, :, None], decay, -math.inf)
    cb = torch.einsum("bcin,bcjn->bcij", C_c, B_c)  # (B,nC,Q,Q)
    attn = cb[..., None] * torch.exp(decay)  # (B,nC,Q,Q,h)
    y_intra = torch.einsum("bcijh,bcjh,bcjhp->bcihp", attn, dt_c, xh)

    # chunk states: S_c = sum_j exp(cum_end - cum_j) dt_j x_j B_j^T  (h,P,N)
    seg = cum[:, :, -1:, :] - cum  # decay from j to end of chunk
    states = torch.einsum("bcjh,bcjh,bcjhp,bcjn->bchpn", torch.exp(seg), dt_c, xh, B_c)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,nC,h) whole-chunk decay

    # the state entering each chunk: h_0 = 0, h_{c+1} = h_c * decay_c + S_c
    h = torch.zeros((B, h_l, P_, N), dtype=torch.float32, device=x.device)
    before = []
    for c in range(nC):
        before.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_before = torch.stack(before, dim=1)  # (B,nC,h,P,N)

    # inter-chunk: y_inter[i] = exp(cum_i) * C_i . h_entering
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", C_c, h_before, torch.exp(cum))

    y = (y_intra + y_inter).reshape(B, S, h_l, P_)
    y = y + squeeze_tp(params["D_skip"], 0)[None, None, :, None] * xs.reshape(
        B, S, h_l, P_).to(torch.float32)
    y = y.reshape(B, S, h_l * P_).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = _gated_rms_norm(y, z, squeeze_tp(params["norm"], 0), ctx)
    out = ctx.sp_scatter(y @ squeeze_tp(params["w_out"], 0).to(y.dtype))
    if not return_state:
        return out
    W = spec.conv_width
    final = {
        "h": h[:, None],  # (B, 1(tp), h, P, N), the state after the last chunk
        "conv_x": xs_raw[:, S - (W - 1):][:, None],
        "conv_bc": bc_raw[:, S - (W - 1):],
    }
    # each in a buffer of its own: a view of the raw streams would keep the
    # whole (B, S, 2 d_inner) projection alive for as long as the state
    state = {name: final[name].new_empty(shape).copy_(final[name])
             for name, shape in init_state_shape(spec, ctx.tp, B).items()}
    return out, state


def init_state_shape(spec: SSMSpec, tp: int, batch: int) -> dict:
    h_l = spec.num_heads // tp
    return {
        "h": (batch, tp, h_l, spec.head_dim, spec.state_dim),
        "conv_x": (batch, tp, spec.conv_width - 1, h_l * spec.head_dim),
        "conv_bc": (batch, spec.conv_width - 1, 2 * spec.state_dim),
    }


def decode(params: dict, spec: SSMSpec, ctx: ParallelCtx, x: torch.Tensor, state: dict):
    """One recurrent decode step. x: (B, 1, D); state per
    ``init_state_shape``, updated in place. Returns (y (B,1,D), state)."""
    B = x.shape[0]
    N, P_ = spec.state_dim, spec.head_dim
    z, xs, bc, dt = _project(params, spec, ctx, x)  # seq dim = 1
    h_l = dt.shape[-1]

    # rolling conv buffers
    xs_hist = torch.cat([squeeze_tp(state["conv_x"], 1), xs], dim=1)  # (B, W, di_l)
    w_cx = squeeze_tp(params["conv_x"], 0).to(x.dtype)
    xs_t = F.silu(torch.einsum("bwc,wc->bc", xs_hist, w_cx))[:, None]
    bc_hist = torch.cat([state["conv_bc"], bc], dim=1)
    bc_t = F.silu(torch.einsum("bwc,wc->bc", bc_hist, params["conv_bc"].to(x.dtype)))[:, None]
    Bm, Cm = bc_t[..., :N], bc_t[..., N:]

    A = -torch.exp(squeeze_tp(params["A_log"], 0))
    dt_t = dt[:, 0]  # (B, h)
    xh = xs_t.reshape(B, h_l, P_).to(torch.float32)
    dec = torch.exp(dt_t * A)  # (B, h)
    h_prev = squeeze_tp(state["h"], 1)  # (B, h, P, N)
    h_new = h_prev * dec[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt_t, xh, Bm[:, 0].to(torch.float32))
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].to(torch.float32), h_new)
    y = y + squeeze_tp(params["D_skip"], 0)[None, :, None] * xh
    y = y.reshape(B, 1, h_l * P_).to(x.dtype)
    y = _gated_rms_norm(y, z, squeeze_tp(params["norm"], 0), ctx)
    out = ctx.psum_model(y @ squeeze_tp(params["w_out"], 0).to(y.dtype))
    state["h"].copy_(h_new[:, None])
    state["conv_x"].copy_(xs_hist[:, 1:][:, None])
    state["conv_bc"].copy_(bc_hist[:, 1:])
    return out, state
