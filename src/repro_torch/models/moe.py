"""Expert-parallel Mixture-of-Experts with sort-based token dispatch
(counterpart of ``repro/models/moe.py``). Over a model axis of tp a rank
holds ``E / tp`` experts, from ``model_index * E / tp``; the router is
replicated (its gradient summed over the axis, ``sync = tp``), and the
output's psum combines the experts of every rank.

  1. router logits -> top-k experts per token (ties to the lower index,
     as ``lax.top_k``: a stable descending sort);
  2. the (T*k) assignments filtered to the rank's experts and SORTED by
     expert id (stable);
  3. the first CAP survivors gathered into a dense (E, C, D) buffer (slot
     = rank within the expert's run, capacity drops beyond C);
  4. two batched einsums over the experts, SwiGLU inside;
  5. results scatter-added back per token, weighted, and summed over the
     model axis.

The reference's ``.at[...].set(mode="drop")`` writes the dropped
assignments to an out-of-range expert row; here they go to one extra
sentinel row that is sliced off. The expert counts are a one-hot sum
(``bincount`` has no ``vmap`` rule). Nothing reads a tensor back to the
host and every shape is static in T, so the layer runs under ``vmap``
and inside a captured CUDA graph.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import ParallelCtx, dense_init, gelu, silu, squeeze_tp
from repro_torch.models.meta import Meta


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    num_experts: int
    top_k: int
    d_ff_expert: int
    kind: str = "swiglu"  # expert MLP kind
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    def experts_local(self, tp: int) -> int:
        if self.num_experts % tp != 0:
            raise ValueError(f"E={self.num_experts} not divisible by tp={tp}")
        return self.num_experts // tp


def init_params(generator: torch.Generator, spec: MoESpec, device="cuda", tp: int = 1,
                keep=None, dtype=torch.float32) -> dict:
    """The global parameters at ``tp``: the experts of ``dtype``, the
    router float32 always; ``keep(t, meta)`` as in
    ``attention.init_params``."""
    meta = param_meta(spec, tp, dtype)

    def init(name, in_axis):
        t = dense_init(generator, meta[name].shape, in_axis=in_axis, device=device,
                       dtype=meta[name].dtype)
        return t if keep is None else keep(t, meta[name])

    return {"router": init("router", 0), "w_gate": init("w_gate", 2),
            "w_up": init("w_up", 2), "w_down": init("w_down", 2)}


def param_meta(spec: MoESpec, tp: int = 1, dtype=torch.float32) -> dict:
    e_l = spec.experts_local(tp)
    D, F_ = spec.d_model, spec.d_ff_expert
    return {
        "router": Meta((D, spec.num_experts), torch.float32, (None, None), tp),
        "w_gate": Meta((tp, e_l, D, F_), dtype, ("model", None, None, None), 1),
        "w_up": Meta((tp, e_l, D, F_), dtype, ("model", None, None, None), 1),
        "w_down": Meta((tp, e_l, F_, D), dtype, ("model", None, None, None), 1),
    }


def _capacity(spec: MoESpec, n_tokens: int, *, decode: bool) -> int:
    if decode:
        # tiny T: full capacity, no drops
        return max(1, n_tokens * spec.top_k)
    return max(1, int(spec.capacity_factor * n_tokens * spec.top_k / spec.num_experts))


def one_hot(idx: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot`` without a host read (``F.one_hot`` checks its
    range with ``.item()``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: values and indices, ties to the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def forward(params: dict, spec: MoESpec, ctx: ParallelCtx, x: torch.Tensor, *,
            decode: bool = False):
    """x: (B, S, D) replicated over the model axis. Returns (y, aux) with
    aux carrying the load-balance loss and the drop fraction (the drops
    of every rank's experts). ``decode``: every expert takes every
    token (capacity T * top_k), so nothing is dropped."""
    B, S, D = x.shape
    T = B * S
    dev = x.device
    xt = x.reshape(T, D)
    e_l = spec.experts_local(ctx.tp)
    C = _capacity(spec, T, decode=decode)
    CAP = min(e_l * C, T * spec.top_k)

    # --- routing, in float32 (a router that a ZeRO-1 step handed back in
    # the compute dtype promotes to float32, as in the reference) ---
    logits = xt.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, spec.top_k)  # (T, k)
    weights = top_p / top_p.sum(-1, keepdim=True)

    # Switch-style load-balance aux loss (computed on full probs).
    assign_frac = one_hot(top_e, spec.num_experts).sum(1).mean(0) / spec.top_k
    prob_frac = probs.mean(0)
    aux_loss = spec.num_experts * (assign_frac * prob_frac).sum()

    # --- local filter + sort-based dispatch ---
    lo = ctx.model_index() * e_l
    e_flat = top_e.reshape(-1)  # (T*k,)
    w_flat = weights.reshape(-1)
    t_flat = torch.arange(T * spec.top_k, device=dev) // spec.top_k
    local_e = e_flat - lo
    is_local = (local_e >= 0) & (local_e < e_l)
    sort_key = torch.where(is_local, local_e, e_l)  # sentinel e_l
    order = torch.argsort(sort_key, stable=True)
    sel = order[:CAP]
    e_sel = sort_key[sel]  # (CAP,) in [0, e_l], e_l == invalid
    t_sel = t_flat[sel]
    w_sel = w_flat[sel]

    counts = one_hot(sort_key, e_l + 1, torch.int64).sum(0)  # (e_l+1,)
    seg_start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    slot = torch.arange(CAP, device=dev) - seg_start[e_sel]
    valid = (e_sel < e_l) & (slot >= 0) & (slot < C)

    x_sel = torch.where(valid[:, None], xt[t_sel], 0).to(x.dtype)
    # dropped assignments write the sentinel row e_l, sliced off
    e_scatter = torch.where(valid, e_sel, e_l)
    s_scatter = torch.where(valid, slot, 0)
    buf = torch.zeros((e_l + 1, C, D), dtype=x.dtype, device=dev).index_put(
        (e_scatter, s_scatter), x_sel)[:e_l]
    # gather indices: clipped to range, masked by the zeroed weight
    e_c = torch.where(valid, e_sel, 0)
    s_c = torch.where(valid, slot, 0)

    # --- expert compute: batched over local experts ---
    wg = squeeze_tp(params["w_gate"], 0).to(x.dtype)
    wu = squeeze_tp(params["w_up"], 0).to(x.dtype)
    wd = squeeze_tp(params["w_down"], 0).to(x.dtype)
    g = torch.einsum("ecd,edf->ecf", buf, wg)
    u = torch.einsum("ecd,edf->ecf", buf, wu)
    act = silu(g) if spec.kind == "swiglu" else gelu(g)
    y_buf = torch.einsum("ecf,efd->ecd", act * u, wd)

    # --- combine: weighted scatter-add back to tokens, psum over experts ---
    y_sel = y_buf[e_c, s_c] * (w_sel * valid).to(x.dtype)[:, None]
    y = torch.zeros((T, D), dtype=x.dtype, device=dev).index_put((t_sel,), y_sel,
                                                                  accumulate=True)
    y = ctx.sp_scatter(y.reshape(B, S, D))

    n_local = counts[:e_l].sum()
    kept = valid.to(torch.int64).sum()
    # int32 across the model axis, as the reference's count
    dropped = ctx.psum_model((n_local - kept).to(torch.int32)) / (T * spec.top_k)
    aux = {"moe_aux_loss": aux_loss * spec.router_aux_coef, "moe_drop_frac": dropped}
    return y, aux
