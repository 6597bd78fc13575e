"""The FL-round traffic: the program's ``FedTrainer`` on its graphed
``scan`` engine, rounds driven in blocks through ``run_block``.

Traffic keys: ``cohort`` (clients a round), ``subsampling`` ("fixed" or
"poisson"), ``dropout``, ``fused_rounds``, ``wire_packed``, ``block``
(rounds a ``run_block`` call), ``profiled_blocks`` (the traced stretch).
Configuration keys: the population, its data, the CNN's widths, the
mechanism and the server's learning rate.

Set-up: the trainer from ``--seed`` (it stages its population and draws
its weights), rounds 1 and 2-3 through ``run_block`` (the first captures
the round), then one call at the window's own block size, which also
warms the window's call. The window enqueues blocks until ``--seconds``
have passed and ends when the device has finished them: every round
enqueued is counted, over the time to the last one's end. The reference
then follows every round of set-up from the seed: rounds 1-3 and the
whole block after them.
"""
from __future__ import annotations

import gc
import time

import bench
from reference import cohort, emnist, fl_round, rqm


def fed_config(FedConfig, config: dict, traffic: dict, seed: int, **over):
    return FedConfig(
        num_clients=config["num_clients"], clients_per_round=traffic["cohort"],
        lr=config["lr"], seed=seed, samples_per_client=config["samples_per_client"],
        data_deform=config["data_deform"], data_noise=config["data_noise"],
        eval_size=config["eval_size"], engine="scan", scan_block=traffic["block"],
        subsampling=traffic["subsampling"], dropout=traffic["dropout"],
        fused_rounds=traffic["fused_rounds"], wire_packed=traffic["wire_packed"],
        collect_sums=False, server_opt="sgd", task="emnist_cnn", **over)


def mechanism_spec(config: dict) -> str:
    m = config["mechanism"]
    return f"{m['name']}:c={m['c']},m={m['m']},q={m['q']}"


def build(cell, seed: int, device: str = "cuda", **over):
    """The program's trainer of the cell."""
    from repro_torch.fed.config import FedConfig
    from repro_torch.fed.trainer import FedTrainer

    return FedTrainer(mechanism_spec(cell.config),
                      fed_config(FedConfig, cell.config, cell.traffic, seed, **over),
                      device=device)


def first_rounds(torch, tr, block: int) -> dict:
    """The checked rounds through the window's own call: rounds 1 and 2-3,
    then ``block`` rounds in one call at the window's block size. The
    parameters before, after round 1, after round 3 and after the block,
    on the host."""
    keep = {"p0": tr.flat.detach().cpu().clone()}
    tr.run_block(1)
    keep["p1"] = tr.flat.detach().cpu().clone()
    tr.run_block(2)
    keep["p3"] = tr.flat.detach().cpu().clone()
    tr.run_block(block)
    keep["pB"] = tr.flat.detach().cpu().clone()
    return keep


def window(torch, tr, block: int, seconds: float, device) -> dict:
    bench.sync(torch, device)
    rounds = 0
    t0 = time.perf_counter()
    while True:
        tr.run_block(block)
        rounds += block
        if time.perf_counter() - t0 >= seconds:
            break
    bench.sync(torch, device)
    elapsed = time.perf_counter() - t0
    return {"rounds": rounds, "seconds": elapsed}


def reference(cell, seed: int, keep, realized, device, half_batch=False,
              tf32=False) -> dict:
    """The plain reference over the checked rounds, and the compared
    numbers. ``half_batch``, ``tf32``: a fault or the control, put in the
    program's place (the readings then compare it with the sound
    reference)."""
    import torch

    conf, traffic = cell.config, cell.traffic
    p = rqm.RQM.from_spec(conf["mechanism"])
    shape_of = emnist.shapes()
    pop = emnist.Population(seed, conf["num_clients"], conf["samples_per_client"],
                            conf["data_deform"], conf["data_noise"])
    hetero = traffic["subsampling"] == "poisson" or traffic["dropout"] > 0

    def follow(prec_tf32: bool, half: bool):
        bench.tf32(torch, prec_tf32)
        stream = cohort.Stream(seed, conf["num_clients"], traffic["cohort"],
                               traffic["subsampling"], traffic["dropout"])
        flat = emnist.flatten(emnist.init(seed)).to(device)
        out = {"p0": flat.to("cpu", copy=True)}
        for r in range(3 + traffic["block"]):
            ids, s, part = stream.next()
            flat, z = fl_round.run_round(flat, shape_of, pop, ids, s, part, p, conf["lr"],
                                         device_count=hetero, half_batch=half)
            if r == 0:
                out["p1"], out["z1"], out["n1"] = flat.to("cpu", copy=True), z.cpu(), int(part.sum())
            if r == 2:
                out["p3"] = flat.to("cpu", copy=True)
        out["pB"] = flat.to("cpu", copy=True)
        bench.tf32(torch, False)
        return out

    ref = follow(False, False)
    if tf32 or half_batch:
        keep = follow(tf32, half_batch)
    stream = cohort.Stream(seed, conf["num_clients"], traffic["cohort"],
                           traffic["subsampling"], traffic["dropout"])
    want = [int(stream.next()[2].sum()) for _ in range(3 if realized is None else len(realized))]
    realized = want if realized is None else realized
    return readings(conf, ref, keep, realized, want, p, hetero, shape_of)


def readings(conf, ref, prog, realized, want, p, hetero, shape_of) -> dict:
    """ghat_gap: the median leaf's gap of norms of the first round's
    decoded update (``ghat_gap_worst``: the worst leaf's, shown and not
    compared); delta_gap: the worst leaf's gap of norms of the change
    after three rounds; block_gap: the same of the change over the block
    after them, the window's call at its size; level_mismatch: the share
    of coordinates whose first-round integer sum differs; counts_mismatch:
    the share of the run's rounds whose realized cohort size differs."""
    lr = conf["lr"]
    n1 = ref["n1"]
    g_ref = rqm.decode(ref["z1"], n1, p, hetero) if n1 else ref["z1"].float() * 0
    g_prog = (prog["p0"] - prog["p1"]) / lr
    as_tree = lambda flat: emnist.unflatten(flat, shape_of)  # noqa: E731
    worst_ghat, ghat_leaf = bench.worst_leaf_gap(as_tree(g_prog), as_tree(g_ref))
    delta_gap, delta_leaf = bench.worst_leaf_gap(as_tree(prog["p3"] - prog["p0"]),
                                                 as_tree(ref["p3"] - ref["p0"]))
    block_gap, block_leaf = bench.worst_leaf_gap(as_tree(prog["pB"] - prog["p3"]),
                                                 as_tree(ref["pB"] - ref["p3"]))
    z_prog = rqm.levels_of(g_prog, max(n1, 1), p, hetero)
    mismatch = float((z_prog != ref["z1"]).double().mean()) if n1 else 0.0
    counts = sum(a != b for a, b in zip(realized, want)) + abs(len(realized) - len(want))
    return {"ghat_gap": bench.median_leaf_gap(as_tree(g_prog), as_tree(g_ref)),
            "delta_gap": delta_gap, "block_gap": block_gap, "level_mismatch": mismatch,
            "counts_mismatch": float(counts) / max(1, len(want)),
            "ghat_gap_worst": worst_ghat, "ghat_worst_leaf": ghat_leaf,
            "delta_worst_leaf": delta_leaf, "block_worst_leaf": block_leaf}


def sound(cell, seed: int, device="cuda") -> dict:
    """The readings of the program's checked rounds, with no window."""
    import torch

    bench.tf32(torch, False)
    tr = build(cell, seed, device)
    keep = first_rounds(torch, tr, cell.traffic["block"])
    realized = list(tr.realized_n)
    del tr
    gc.collect()
    bench.free(torch, device)
    return reference(cell, seed, keep, realized, device)


def planted(cell, seed: int, device="cuda", **fault) -> dict:
    """The readings of the reference put in the program's place with a
    fault or at the control's precision."""
    return reference(cell, seed, None, None, device, **fault)


def run(cell, seed: int, seconds: float, trace: bool, started: float,
        device: str = "cuda") -> dict:
    import torch

    bench.tf32(torch, False)
    traffic = cell.traffic
    phases = {"imports": time.perf_counter() - started}
    tr = build(cell, seed, device)
    phases["trainer"] = time.perf_counter() - started
    if tr.hetero:
        # the accounting of every cohort size a round can realize, from the
        # program's disk cache after a cell's first run
        for n in range(1, tr.slate + 1):
            for alpha in tr.cfg.accountant_alphas:
                tr.mech.per_round_epsilon(n, alpha)
        phases["accounting"] = time.perf_counter() - started
    keep = first_rounds(torch, tr, traffic["block"])
    bench.sync(torch, device)
    setup_s = time.perf_counter() - started
    phases["checked_rounds"] = setup_s
    before = len(tr.realized_n)
    win = window(torch, tr, traffic["block"], seconds, device)
    win["realized"] = sum(tr.realized_n[before:])
    out = {"metrics": {"setup_s": setup_s, "rounds_per_s": win["rounds"] / win["seconds"]}}
    run_info = {"window": win, "slate": tr.slate, "dim": int(tr.flat.numel()),
                "config": cell.config, "traffic": traffic, "pack_bits": tr.pack_bits}
    if trace:
        run_info["host"] = {"rounds": traffic["profiled_blocks"] * traffic["block"],
                            "seconds": bench.host_seconds(
                                torch, device, lambda: tr.run_block(traffic["block"]),
                                traffic["profiled_blocks"])}
        before = len(tr.realized_n)
        blocks = traffic["profiled_blocks"]
        run_info["trace"] = bench.profiled(
            torch, lambda: [tr.run_block(traffic["block"]) for _ in range(blocks)],
            lambda: tr.run_block(traffic["block"]), device)
        run_info["profiled_rounds"] = blocks * traffic["block"]
        run_info["profiled_realized"] = tr.realized_n[before:before + blocks * traffic["block"]]
    peak = bench.peak_bytes(torch, device)
    realized = list(tr.realized_n)
    run_info["realized"] = realized
    del tr
    gc.collect()
    bench.free(torch, device)
    t_ref = time.perf_counter()
    out["readings"] = reference(cell, seed, keep, realized, device)
    out["reference_s"] = time.perf_counter() - t_ref
    out.update(run=run_info, attempted=len(realized), failed=0, phases=phases,
               device=bench.device_info(torch, device, peak))
    return out
