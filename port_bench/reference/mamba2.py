"""Mamba-2 (arXiv:2405.21060) language model, plain: the weights the
benchmark makes from the seed, and the mean next-token cross entropy with
its gradient, computed a block of rows at a time.

The SSD layer computes, over blocks of the published chunk (256), the
quadratic ("attention") form inside a block and the recurrent state
between blocks:

    y_i = sum_{j <= i} (C_i . B_j) exp(sum_{j < r <= i} A dt_r) dt_j x_j + D x_i

with dt = softplus(h W_dt + dt_bias), A = -exp(A_log), x and (B, C) each
through a depthwise causal convolution of width 4 and SiLU, then the
gated RMSNorm ``rms(y * silu(z)) * (1 + w)`` over d_inner and the
out-projection. A block is ``x + ssd(rms(x) * (1 + w))``; the head is
untied over the padded vocabulary, whose extra columns take part in the
log-sum-exp. Leaves carry the program's size-1 model-parallel axes, so a
flat coordinate of a leaf is the same weight on both sides.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-6


def dims(cfg: dict) -> dict:
    d = cfg["d_model"]
    di = cfg["expand"] * d
    v = -(-cfg["vocab_size"] // cfg["pad_vocab_size_multiple"]) * cfg["pad_vocab_size_multiple"]
    return {"D": d, "di": di, "N": cfg["d_state"], "P": cfg["headdim"], "h": di // cfg["headdim"],
            "W": cfg["d_conv"], "V": v, "L": cfg["n_layer"],
            "Q": cfg["published"]["chunk_size"]}


def layer_shapes(k: dict) -> dict:
    """A layer's leaves: (shape, fan-in axis, or the name of its fixed
    initial value)."""
    D, di, N, h, W = k["D"], k["di"], k["N"], k["h"], k["W"]
    return {"A_log": ((1, h), "a_log"), "D_skip": ((1, h), "ones"),
            "conv_bc": ((W, 2 * N), 0), "conv_x": ((1, W, di), 1),
            "dt_bias": ((1, h), "dt_bias"), "norm": ((1, di), "zeros"),
            "w_bc": ((D, 2 * N), 0), "w_dt": ((D, 1, h), 0), "w_out": ((1, di, D), 1),
            "w_zx": ((D, 1, 2 * di), 0)}


def leaf_specs(cfg: dict) -> list:
    """(path, shape, init) of every leaf in the flat order: sorted keys,
    layers in order."""
    k = dims(cfg)
    out = [(("embed",), (1, k["V"], k["D"]), 2), (("final_norm",), (k["D"],), "zeros")]
    for i in range(k["L"]):
        out.append((("layers", i, "norm1"), (k["D"],), "zeros"))
        for name, (shape, init) in sorted(layer_shapes(k).items()):
            out.append((("layers", i, "ssm", name), shape, init))
    out.append((("lm_head",), (k["D"], 1, k["V"]), 0))
    return out


def make_weights(seed: int, cfg: dict, device) -> tuple:
    """(tree, flat): one float32 buffer drawn from a generator on
    ``device`` seeded with ``seed`` in one call, each dense leaf a normal
    truncated to 2 standard deviations at 1/sqrt(fan-in); A_log = log(1..h),
    D = 1, dt's bias the inverse softplus of dt spread log-uniformly over
    [1e-3, 1e-1] across the heads, norms 0. The tree's leaves are views
    of ``flat``."""
    specs = leaf_specs(cfg)
    total = sum(math.prod(s) for _, s, _ in specs)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=g).clamp_(-2.0, 2.0)
    k = dims(cfg)
    h = k["h"]
    dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), h, device=device))
    fixed = {"a_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=device)),
             "dt_bias": dt + torch.log(-torch.expm1(-dt))}
    tree: dict = {"layers": [dict(ssm={}) for _ in range(k["L"])]}
    at = 0
    for path, shape, init in specs:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        at += n
        if isinstance(init, int):
            leaf.mul_(1.0 / math.sqrt(shape[init]))
        elif init == "zeros":
            leaf.zero_()
        elif init == "ones":
            leaf.fill_(1.0)
        else:
            leaf.copy_(fixed[init].view(shape))
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    tree["layers"] = tuple(tree["layers"])
    return tree, flat


def leaves(tree) -> list:
    """The tree's leaves in flat order."""
    out = [tree["embed"], tree["final_norm"]]
    for layer in tree["layers"]:
        out += [layer["norm1"]] + [layer["ssm"][k] for k in sorted(layer["ssm"])]
    return out + [tree["lm_head"]]


def rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * (1.0 + w)


def causal_conv_silu(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: out_t = sum_i w[i] x_{t - (W-1) + i}."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return F.silu(sum(xp[:, i:i + S] * w[i] for i in range(W)))


def segsum(a: torch.Tensor) -> torch.Tensor:
    """seg[..., i, j, h] = sum of a[..., r, h] over j < r <= i (-inf above
    the diagonal) for a (..., Q, h), each a sum of only its own terms."""
    Q = a.shape[-2]
    strict = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device), diagonal=-1)
    x = a.unsqueeze(-2).expand(*a.shape[:-2], Q, Q, a.shape[-1])
    seg = torch.cumsum(x.masked_fill(~strict[:, :, None], 0.0), dim=-3)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device))
    return seg.masked_fill(~causal[:, :, None], -math.inf)


def ssd(p: dict, h_in: torch.Tensor, k: dict) -> torch.Tensor:
    """The SSD layer over blocks of ``k["Q"]`` positions (the published
    chunk): the quadratic form inside a block, and the state
    ``h_{c+1} = exp(sum of a over block c) h_c + sum_j exp(a after j) dt_j
    x_j B_j^T`` carried from block to block."""
    B, S, _ = h_in.shape
    di, N, H, P = k["di"], k["N"], k["h"], k["P"]
    Q = min(k["Q"], S)
    nC = S // Q
    zx = h_in @ p["w_zx"][:, 0]
    z, x = zx[..., :di], zx[..., di:]
    bc = causal_conv_silu(h_in @ p["w_bc"], p["conv_bc"])
    x = causal_conv_silu(x, p["conv_x"][0])
    dt = F.softplus(h_in @ p["w_dt"][:, 0] + p["dt_bias"][0])          # (B, S, H)
    a = (dt * -torch.exp(p["A_log"][0])).reshape(B, nC, Q, H)
    Bm = bc[..., :N].reshape(B, nC, Q, N)
    Cm = bc[..., N:].reshape(B, nC, Q, N)
    xh = x.reshape(B, nC, Q, H, P)
    dx = dt.reshape(B, nC, Q, H)[..., None] * xh
    seg = segsum(a)                                                     # (B, nC, Q, Q, H)
    cb = torch.einsum("bcin,bcjn->bcij", Cm, Bm)
    y = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * torch.exp(seg), dx)
    states = torch.einsum("bcjh,bcjhp,bcjn->bchpn", torch.exp(seg[:, :, -1]), dx, Bm)
    decay = torch.exp(a.sum(2))                                         # (B, nC, H)
    cum = torch.cumsum(a, dim=2)
    h = torch.zeros(B, H, P, N, dtype=h_in.dtype, device=h_in.device)
    carried = []
    for c in range(nC):
        carried.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    y = y + torch.einsum("bcin,bchpn,bcih->bcihp", Cm, torch.stack(carried, 1), torch.exp(cum))
    y = (y + p["D_skip"][0][:, None] * xh).reshape(B, S, di)
    return rms(y * F.silu(z), p["norm"][0]) @ p["w_out"][0]


def loss_sum(tree: dict, cfg: dict, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed next-token cross entropy of a block of rows."""
    k = dims(cfg)
    x = tree["embed"][0][tokens.long()]
    for layer in tree["layers"]:
        x = x + ssd(layer["ssm"], rms(x, layer["norm1"]), k)
    logits = rms(x, tree["final_norm"]) @ tree["lm_head"][:, 0]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.long().reshape(-1),
                           reduction="sum")


def loss_and_grads(tree: dict, cfg: dict, tokens, labels, rows_per_block: int = 1):
    """(mean loss, gradient leaves in flat order), a block of rows at a
    time."""
    params = leaves(tree)
    for t in params:
        t.requires_grad_(True)
    grads = [torch.zeros_like(t) for t in params]
    total = 0.0
    n_tok = labels.numel()
    for lo in range(0, tokens.shape[0], rows_per_block):
        part = loss_sum(tree, cfg, tokens[lo:lo + rows_per_block], labels[lo:lo + rows_per_block])
        for acc, g in zip(grads, torch.autograd.grad(part, params)):
            acc += g
        total += float(part.detach())
    for t in params:
        t.requires_grad_(False)
    return total / n_tok, [g / n_tok for g in grads]
