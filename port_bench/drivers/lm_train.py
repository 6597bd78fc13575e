"""The LM training traffic: one client's differentially private train
step, the program's ``build_train_step_fn`` on one rank (gradient, clip,
the per-leaf RQM encode, ``decode_sum``, SGD at the warmup-cosine rate),
float32 without TF32 or remat.

Traffic keys: ``batch`` x ``seq_len`` tokens a step of a seeded order-1
Markov stream over the whole vocabulary (``markov_branch`` successors a
token), ``batches`` distinct batches drawn at set-up and taken in turn,
the schedule (``lr``, ``warmup_steps``, ``total_steps``,
``final_lr_frac``), the reference's ``rows_per_reference_block`` and the
traced stretch's ``profiled_steps``. The benchmark makes the weights
(``reference/mamba2.py:make_weights``), the batches and each step's
per-leaf encode seeds, and hands the same to the program and the
reference.

Set-up: the weights, steps 1-3 (they warm every kernel up; the reference
follows them afterwards). The window calls the step until ``--seconds``
have passed and ends when the device has finished: every step called is
counted, over the time to the last one's end.
"""
from __future__ import annotations

import gc
import time

import numpy as np

import bench
from reference import mamba2, rqm


def program_config(config: dict):
    """The program's configuration of ``port_arch``, held to the file's
    widths."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(config["port_arch"], reduced=config.get("reduced", False))
    have = {"d_model": cfg.d_model, "n_layer": cfg.num_layers, "vocab_size": cfg.vocab_size,
            "pad_vocab_size_multiple": cfg.vocab_pad_to, "d_state": cfg.ssm.state_dim,
            "headdim": cfg.ssm.head_dim, "expand": cfg.ssm.expand, "d_conv": cfg.ssm.conv_width,
            "chunk_size": cfg.ssm.chunk, "tie_embeddings": cfg.tie_embeddings}
    wrong = {k: (v, config[k]) for k, v in have.items() if v != config[k]}
    if wrong:
        raise SystemExit(f"the program's {config['port_arch']} differs from the file: {wrong}")
    return cfg


def token_batches(seed: int, config: dict, traffic: dict) -> np.ndarray:
    """(batches, batch, seq_len + 1) int32 tokens of the Markov stream:
    successors and their Dirichlet(1) weights a token, each row from a
    uniform first token."""
    rng = np.random.default_rng((seed, 1))
    v, br = config["vocab_size"], traffic["markov_branch"]
    succ = rng.integers(0, v, size=(v, br))
    cum = np.cumsum(rng.dirichlet([1.0] * br, size=v), axis=1)
    rows = traffic["batches"] * traffic["batch"]
    s = traffic["seq_len"]
    toks = np.empty((rows, s + 1), np.int64)
    toks[:, 0] = rng.integers(0, v, size=rows)
    r = rng.random((s, rows))
    for t in range(s):
        cur = toks[:, t]
        choice = np.minimum((r[t][:, None] > cum[cur]).sum(axis=1), br - 1)
        toks[:, t + 1] = succ[cur, choice]
    return toks.astype(np.int32).reshape(traffic["batches"], traffic["batch"], s + 1)


def step_seeds(seed: int, step: int, n: int) -> list:
    """The per-leaf uint32 encode seeds of a step."""
    return [int(w) for w in np.random.SeedSequence((seed, step)).generate_state(n, np.uint32)]


def lr_at(step: int, traffic: dict) -> float:
    """The warmup-cosine rate of a step, in float32."""
    import math

    import torch

    lr, warm, total = traffic["lr"], traffic["warmup_steps"], traffic["total_steps"]
    final = traffic["final_lr_frac"]
    s = torch.tensor(step, dtype=torch.int32)
    wu = torch.clamp(s.to(torch.float32) / max(1, warm), 0.0, 1.0)
    frac = torch.clamp((s - warm).to(torch.float32) / max(1, total - warm), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    decay = torch.tensor(lr, dtype=torch.float32) * (final + (1 - final) * cos)
    return float(torch.where(s < warm, torch.tensor(lr, dtype=torch.float32) * wu, decay))


def batch_of(torch, toks, step: int, device) -> dict:
    """Step ``step``'s batch: a view of the batches staged on the device at
    set-up (so that feeding a step waits for nothing)."""
    b = torch.as_tensor(toks[step % toks.shape[0]], device=device)
    return {"tokens": b[:, :-1].contiguous(), "labels": b[:, 1:].contiguous()}


def to_host(torch, tree) -> torch.Tensor:
    leaves = mamba2.leaves(tree)
    out = torch.empty(sum(t.numel() for t in leaves), dtype=torch.float32)
    at = 0
    for t in leaves:
        out[at:at + t.numel()].copy_(t.detach().reshape(-1))
        at += t.numel()
    return out


def build(cell, device="cuda"):
    import torch
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.distributed.step import build_train_step_fn
    from repro_torch.models.common import ParallelCtx
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedules import warmup_cosine

    conf, traffic = cell.config, cell.traffic
    m = conf["mechanism"]
    mech = make_mechanism(f"{m['name']}:c={m['c']},m={m['m']},q={m['q']}")
    opt = make_optimizer(conf["server_optimizer"])
    lr_fn = warmup_cosine(traffic["lr"], traffic["warmup_steps"], traffic["total_steps"],
                          traffic["final_lr_frac"], device=device)
    step = build_train_step_fn(program_config(conf), mech, opt, lr_fn, ParallelCtx(),
                               remat=conf["remat"], compute_dtype=torch.float32)
    return step, opt


def reference(cell, seed: int, toks, keep: dict, device, tf32=False,
              half_batch=False) -> dict:
    """The plain reference over steps 1-3, and the compared numbers;
    ``tf32``, ``half_batch``: the control or a fault put in the program's
    place."""
    import torch

    conf, traffic = cell.config, cell.traffic
    p = rqm.RQM.from_spec(conf["mechanism"])

    def follow(prec_tf32: bool, half: bool, record: bool):
        bench.tf32(torch, prec_tf32)
        tree, flat = mamba2.make_weights(seed, conf, device)
        out = {"loss": [], "p0": None if record else flat.clone()}
        for k in range(3):
            b = batch_of(torch, toks, k, device)
            rows = traffic["batch"] // 2 if half else traffic["batch"]
            loss, grads = mamba2.loss_and_grads(tree, conf, b["tokens"][:rows], b["labels"][:rows],
                                                traffic["rows_per_reference_block"])
            out["loss"].append(loss)
            lr = lr_at(k, traffic)
            seeds = step_seeds(seed, k, len(grads))
            zs, norms = [], []
            for leaf, g, s in zip(mamba2.leaves(tree), grads, seeds):
                z = rqm.encode_rows(g.clamp(-p.c, p.c).reshape(1, -1), s, p)[0]
                g_hat = rqm.decode(z, 1, p).view(leaf.shape)
                if k == 0 and record:
                    zs.append(z.to(torch.int8))
                    norms.append(float(g_hat.double().norm()))
                leaf.sub_(lr * g_hat)
            del grads
            if k == 0:
                out["p1"], out["z1"], out["ghat_norms"] = (None if record else flat.clone()), zs, norms
        out["p3"] = flat
        bench.tf32(torch, False)
        return out

    ref = follow(False, False, True)
    if tf32 or half_batch:
        keep = follow(tf32, half_batch, False)
    return readings(cell, seed, ref, keep, p, device)


def readings(cell, seed, ref, prog, p, device) -> dict:
    """loss_gap: the first step's relative loss gap (``loss_gap_steps``,
    the largest of the three, is shown and not compared); ghat_gap and
    delta_gap: the worst leaf's gap of norms of the first step's decoded
    update and of the change after three steps; level_mismatch: the share
    of coordinates whose first-step level differs."""
    import torch

    conf, traffic = cell.config, cell.traffic
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    tree0, flat0 = mamba2.make_weights(seed, conf, device)
    lr0 = lr_at(0, traffic)
    g_prog, g_ref, d_prog, d_ref = {}, {}, {}, {}
    at, differ = 0, 0
    for i, leaf in enumerate(mamba2.leaves(tree0)):
        n = leaf.numel()
        p0 = flat0[at:at + n]
        ghat = (p0 - prog["p1"][at:at + n].to(device)) / lr0
        z = rqm.levels_of(ghat, 1, p)
        differ += int((z != ref["z1"][i].to(device=device, dtype=torch.int64)).sum())
        g_prog[i] = ghat.double().norm().reshape(1)
        g_ref[i] = torch.tensor([ref["ghat_norms"][i]], dtype=torch.float64, device=device)
        d_prog[i] = (prog["p3"][at:at + n].to(device) - p0).double().norm().reshape(1)
        d_ref[i] = (ref["p3"][at:at + n].to(device) - p0).double().norm().reshape(1)
        at += n
    ghat_gap, ghat_leaf = bench.worst_leaf_gap(g_prog, g_ref)
    delta_gap, delta_leaf = bench.worst_leaf_gap(d_prog, d_ref)
    paths = [".".join(map(str, path)) for path, _, _ in mamba2.leaf_specs(conf)]
    return {"loss_gap": gaps[0], "ghat_gap": ghat_gap, "level_mismatch": differ / at,
            "delta_gap": delta_gap, "loss_gap_steps": max(gaps),
            "ghat_worst_leaf": paths[ghat_leaf], "delta_worst_leaf": paths[delta_leaf]}


def first_steps(torch, cell, seed: int, toks, step_fn, opt, device):
    """The benchmark's weights, then steps 1-3 through the program's step:
    (tree, optimizer state, what the reference is held to)."""
    tree, flat = mamba2.make_weights(seed, cell.config, device)
    del flat
    opt_state = opt.init(tree)
    n_leaves = len(mamba2.leaves(tree))
    keep = {"loss": []}
    for k in range(3):
        tree, opt_state, metrics = step_fn(tree, opt_state, k, batch_of(torch, toks, k, device),
                                           step_seeds(seed, k, n_leaves))
        keep["loss"].append(float(metrics["loss"]))
        if k == 0:
            keep["p1"] = to_host(torch, tree)
    keep["p3"] = to_host(torch, tree)
    return tree, opt_state, keep


def sound(cell, seed: int, device="cuda") -> dict:
    """The readings of the program's first steps, with no window."""
    import torch

    bench.tf32(torch, False)
    toks = token_batches(seed, cell.config, cell.traffic)
    step_fn, opt = build(cell, device)
    tree, opt_state, keep = first_steps(torch, cell, seed, toks, step_fn, opt, device)
    del tree, opt_state
    gc.collect()
    bench.free(torch, device)
    return reference(cell, seed, toks, keep, device)


def planted(cell, seed: int, device="cuda", **fault) -> dict:
    """The readings of the reference put in the program's place with a
    fault or at the control's precision."""
    toks = token_batches(seed, cell.config, cell.traffic)
    return reference(cell, seed, toks, None, device, **fault)


def run(cell, seed: int, seconds: float, trace: bool, started: float,
        device: str = "cuda") -> dict:
    import torch

    bench.tf32(torch, False)
    conf, traffic = cell.config, cell.traffic
    phases = {"imports": time.perf_counter() - started}
    toks = torch.from_numpy(token_batches(seed, conf, traffic)).to(device)
    phases["tokens"] = time.perf_counter() - started
    step_fn, opt = build(cell, device)
    tree, opt_state, keep = first_steps(torch, cell, seed, toks, step_fn, opt, device)
    n_leaves = len(mamba2.leaves(tree))
    metrics = None
    bench.sync(torch, device)
    setup_s = time.perf_counter() - started
    phases["first_steps"] = setup_s
    tokens = traffic["batch"] * traffic["seq_len"]
    step = 3
    t0 = time.perf_counter()
    while True:
        tree, opt_state, metrics = step_fn(tree, opt_state, step,
                                           batch_of(torch, toks, step, device),
                                           step_seeds(seed, step, n_leaves))
        step += 1
        if time.perf_counter() - t0 >= seconds:
            break
    bench.sync(torch, device)
    elapsed = time.perf_counter() - t0
    steps = step - 3
    out = {"metrics": {"setup_s": setup_s, "train_tokens_per_s": steps * tokens / elapsed}}
    run_info = {"window": {"steps": steps, "seconds": elapsed},
                "tokens_per_step": tokens,
                "config": conf,
                "traffic": traffic,
                "leaf_sizes": [t.numel() for t in mamba2.leaves(tree)]}
    if trace:
        def one():
            nonlocal tree, opt_state, step
            tree, opt_state, _ = step_fn(tree, opt_state, step,
                                         batch_of(torch, toks, step, device),
                                         step_seeds(seed, step, n_leaves))
            step += 1

        run_info["host"] = {"steps": traffic["profiled_steps"], "seconds": bench.host_seconds(
            torch, device, one, traffic["profiled_steps"])}

        def stretch():
            for _ in range(traffic["profiled_steps"]):
                one()

        run_info["trace"] = bench.profiled(torch, stretch, one, device)
        run_info["profiled_steps"] = traffic["profiled_steps"]
    peak = bench.peak_bytes(torch, device)
    del tree, opt_state, metrics
    gc.collect()
    bench.free(torch, device)
    t_ref = time.perf_counter()
    out["readings"] = reference(cell, seed, toks, keep, device)
    out["reference_s"] = time.perf_counter() - t_ref
    out.update(run=run_info, attempted=step, failed=0, phases=phases,
               device=bench.device_info(torch, device, peak))
    return out
