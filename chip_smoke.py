#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one GPU, end to end.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card
(the kernels are built for sm_90a) and nvcc. Phases, any failure of
which raises and exits non-zero:

  1. environment: torch, CUDA, the card's name and power limit;
  2. build: nvcc compiles src/repro_torch/kernels/csrc into build/cuda,
     one process per source, all at once;
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at the main paths' shapes (a cohort of 40 rows, the CNN's
     222,030 coordinates, 10-bit fields, 74,010 packed words; the quantize
     kernels at row offset 0 and 7; at edge parameters rqm_quantize at
     m=64 and q=0.5 (two keep-mask words), pbm_quantize and its round sum
     at theta=1/2 (p = 0 and 1 reached) and m in {1, 16, 17} with NaN
     inputs, qmgeo_quantize and both its round sums at m in {2, 33, 100,
     5000} (a one-node tree, a padded tree, the walk, the walk past its
     tabled weights); the wire codec also at 16
     bits with the top field across the sign bit, and both its entries on
     views 1 to 3 words past an aligned address at 10 and 16 bits, each
     launch's walk (its width V and grid: the C entry's, which must equal
     ``pack_kernel.codec_walk``'s) recorded; both decode entries on views
     0 to 3 words off at 10 and 16 bits, at n odd and even, W odd and
     even, and n = 1, each unpack_decode_apply launch's walk (the C
     entry's, which must equal ``codec_walk``'s) recorded; the folded
     decode_apply in float32 and bfloat16 on views 0 to 3 elements off at
     n even, odd and 1, each launch's walk (the C entry's, which must
     equal ``decode_apply_kernel.folded_walk``'s) recorded); the two
     decode entries' _dev twins (decode_apply_sum_dev, unpack_decode_apply_dev),
     which read a realized cohort size from device memory, dense and packed
     at 10 and 11 bits, at counts 0, 1, 29, 40 and 82, against their plain
     versions and, where the traced and the fixed-cohort scales agree,
     their by-value entries (and differing from them where not); each
     quantize and round-sum entry's _dev
     twin, which reads the seed from device memory, with the seed as a
     device tensor, against its plain version and its by-value entry:
     results bit-exact; device times from
     torch.profiler (or, should no profiling session hold the kernel, by
     CUDA events around calls queued behind a sleeping kernel), whole-call
     times by CUDA events, and the least time
     the card could take (its bound), each printed as one JSON line after
     phase 7 with its launches; for the codec and decode entries
     (FLOOR_ROWS) also ``floor_ms``, the same entry's device time at n = 1
     (one block: the fixed cost of a launch), beside the bound;
  4. fused path: 5 rounds of the paper's EMNIST configuration through
     FedTrainer with fused rounds, packed and dense wire, on the perround
     engine and on the scan engine (each round a replay of a captured CUDA
     graph): identical parameters and sums;
  5. default path: ``FedTrainer(spec, FedConfig())``, the reference's
     default round (materialized, scan engine, graphed), 5 rounds for each
     Fig. 3 mechanism (rqm, pbm, qmgeo, none), equal in parameters, bit
     for bit, to the same rounds on the perround engine; beside it the
     same round keeping its sums (``collect_sums=True``), equal in
     parameters and sums to the perround engine's and to the fused rounds
     (packed and dense, eager and graphed). Each materialized run must
     launch one quantize kernel per round (the _dev entry under the
     graph, the by-value one eager);
  5b. shard path: ``engine="shard", shards=1``, eager rounds over a
     one-rank NCCL process group, 5 rounds for each
     mechanism, each bit-identical to its graphed run of phase 5 that
     keeps its sums and
     launching pack_flat and unpack_flat once a round around the
     all_reduce (not 'none', whose float sum is never packed); for rqm
     also the unpacked sum, streamed staging, and the fused packed and
     dense rounds under the shard engine, all bit-identical to it;
  5c. host clock: FedConfig()'s rqm round, no profiler running: the eager
     perround round's host ms by stage and wall ms, the graphed scan
     round's host ms against its wall ms (blocks run under
     ``torch.cuda.set_sync_debug_mode("error")``), and rounds/s of both
     over 5 blocks of 20 rounds, median and range;
  5d. the trainer's services at FedConfig()'s widths, rqm: (a) graphed
     scan, materialized, tracked to a JSON document under build/phase5d
     and checkpointed every 5 rounds: 10 rounds against a fresh trainer
     restored at round 5 that trains 5, parameters and accountant history
     bit for bit, the tracked series rounds 1..10 with no duplicate or gap
     and eps_spent equal to the accountant after each round; (b) the same
     with fused packed rounds, every record's wire_bits 32 x 74,010 and
     pack_width 10; (c) momentum and adam, materialized and fused (the
     dense sum, no fused decode-apply), 5 graphed scan rounds against 5
     eager perround rounds and against a run resumed at round 3, parameters
     and optimizer state bit for bit; (d) budget_eps at the eps of 7 rounds
     plus half a round's: train(20) stops after 7; (e) reported, not
     gated: graphed rounds/s with the json tracker (one synchronisation
     an advance) against the noop one, 5 advances of 20 rounds back to
     back a rep, 5 reps each in turns, median and range;
  5e. heterogeneous cohorts at the paper's widths, rqm, collect_sums: (a)
     Poisson subsampling (a slate of 82, 11-bit wire), dropout 0.1, and
     both, each materialized, fused packed and fused dense, 5 rounds on
     graphed scan, eager perround and a one-rank NCCL shard: parameters,
     sums and realized sizes bit for bit, every path equal to the
     materialized one, the mask the fused round sums' weights and the _dev
     decode entries launched once a round; the host engine under each
     mode: realized sizes and eps history equal to scan's, parameters
     within 1e-5 (reported: whether bit for bit); (b) dropout 0.999 for
     2 rounds (momentum materialized, sgd fused packed): an empty round
     moves neither the parameters nor the optimizer's state; (c)
     local_steps=3 under dropout: graphed scan == perround; (d)
     budget_eps (7 nominal rounds' eps) under dropout 0.5: the halt
     overshoots by at most one round; (e) reported, not gated: graphed
     rounds/s of the Poisson round over 5 blocks of 20 (no
     synchronisation inside them), against phase 5c's fixed round;
  5f. the async engine at the paper's widths, rqm, collect_sums: (a)
     ``engine="async"``, cadence 40, max_staleness 0, no timeout (the
     plain corner): 5 rounds == eager perround, parameters and sums bit
     for bit; (b) ``ASYNC_SPEC`` (max_staleness 4, poly:0.5 discount) with
     timeout 2 (late clients), materialized == fused dense bit for bit,
     some weight-0 row and some stale version among the 5 aggregations,
     each aggregation's eps vector == per_round_epsilon at its realized
     size; (c) streamed staging == full; (d) aggregations whose rows all
     time out (momentum) move neither the parameters nor the state, at
     eps 0; (e) 4 checkpointed rounds == resumed at 2 (parameters, ring,
     arrival trace, accountant); (f) reported: rounds/s of the stale
     round, the plain corner and eager perround, in turns, 5 x 20;
  5g. the aggregator round-server at the paper's widths (rqm, 222,030,
     cohort 40): (a) a producer thread makes 6 rounds of 4-bit packed
     uplinks (``simulate_client_updates(packed=True)``: the quantize
     kernel, then pack_flat) and submits them (``block=True``) to a queue
     of 8 batches while ``start()``'s service thread serves: the producer
     must wait on the full queue, each round's SecAgg sum (unpack_flat a
     payload, on the card) == the host's numpy sum, the parameters == a
     CPU replay within the 1-ULP contract; (b) the same levels packed at
     10 bits, where the cohort's bound fits: the packed-direct word sum
     (unpack_flat once a round) == (a)'s sums and parameters bit for bit;
     (c) a budget of 3 rounds: halted after 3, further submits refused;
     (d) resumed from (a)'s checkpoint at round 3: bit for bit; (e)
     reported: rounds served a second, packed and dense uplink, 3 reps,
     and the uplink bytes a round;
  5h. the lm task (``FedConfig(task="lm:model=<arch>")``: the reduced
     model-zoo configs at the task's seq_len 64 and batch 2, rqm, a cohort
     of 40 from 200 clients, 3 rounds a run): (a) each of the ten configs
     fused packed on graphed scan and eager perround, parameters and sums
     bit for bit, the held-out loss finite and its perplexity reported;
     for mamba2-370m also materialized (graphed and eager), a one-rank
     NCCL shard and the async plain corner, all equal to the fused run;
     pbm and qmgeo fused (graphed, eager) and materialized, equal; the
     host engine under dropout 0.1, held to scan as in 5e; graphed
     rounds/s, fused packed and materialized, over 5 blocks of 20 under
     ``set_sync_debug_mode("error")``; (b) the full-width mamba2-370m
     (419,763,712 parameters, random from a seed): one client's loss and
     flat gradient at seq_len 64 and batch 2, timed, with its peak
     memory; two such clipped gradients through rqm_round_sum_dense and
     decode_apply_sum, each equal to its plain version (run in column
     chunks) bit for bit; lines start with [5h], reports "lm" and
     "lm_full_width";
  5i. serving (``models/*``'s decode halves, ``launch/serve.py``) and the
     single-leaf encodes, no gradients: (a) each reduced config (batch 2,
     prompt 64, capacity 96; pixtral and musicgen with prefix
     embeddings; the MoE configs at a capacity that drops nothing),
     prefill then 8 decode steps, and reduced gemma3 at prompt 96 past
     its window of 64: every token in [0, padded_vocab), prefill's token
     == forward_hidden's argmax at the last position, the first decoded
     token == a teacher-forced forward over prompt + 1; (b) gemma3-4b at
     full width (4,550,996,480 parameters from a CUDA generator), batch
     4, prompt 1280 (past the 1024 window: the re-lay and the ring), 32
     tokens, and (c) zamba2-1.2b (1,016,819,712), prompt 512: the same
     gates; init s, prefill ms and tokens/s, decode ms a step (median
     after the first) and tokens/s, the host's dispatch ms and the
     device's busy ms a step, peak memory, beside the step's bound
     (weights but the embedding table, and the caches, read once), and
     one more step's launches by the operator and by the port's source
     line that issued them (torch.profiler, a torch-function mode's
     ranges); (d)
     rqm/pbm/qmgeo_fast on a 1-D and a 3-D leaf and rqm_tree over the
     CNN's tree, counted (rows 5-7), each == its plain version and
     ``_batch`` row 0, rqm_ref == rqm_fast; (e) the paper-cohort
     calibration on the host, timed, a repeat computing 0 epsilons;
     lines start with [5i], reports "serve_reduced", "serve_full_width",
     "single_leaves", "calibration";
  6. profile: device time by kernel over 3 more rounds of FedConfig()'s
     trainer for each mechanism (graphed; phase 5's, and phase 5c's for
     rqm), of phase 5e's graphed Poisson round, of the graphed fused packed
     one, the rqm shard one, the eager perround one and phase 5h's graphed
     fused packed lm round (mamba2-370m; tables in build/profiles/), and
     what the eager round's fill kernels fill;
  7. Fig. 3 report: held-out accuracy and Renyi eps at alpha=8 after 120
     default rounds of benchmarks/fig3_fl_emnist.py's FED settings;
     whether noise-free >= RQM >= PBM held, and the reference's own
     ``tradeoff_ok`` (RQM accuracy >= PBM's - 0.02 and RQM eps < PBM's)
     (reported, not gated).

Every run of phases 4 to 5i (but their reports) sets the kernels' launch counters to 0
just before it and reads them just after. Every kernel must launch on
one of those runs but ``decode_apply``, the folded decode + SGD, which
no round of either package runs (its association is not bit-identical
to decode_sum then SGD); its record has ``"path": null`` and phase 3's
launches. A replayed CUDA graph adds the launches its capture recorded,
so a graphed run too reads ROUNDS launches of each of its kernels. The
second-last lines are one JSON object of per-kernel measurements and the
card's name and power limit; the last line is the run's result. Exits non-zero, printing no result,
when CUDA is unavailable.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# deterministic cuBLAS, so runs that must agree compute identical
# gradients; must be set before CUDA is initialised
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROWS, DIM, BITS = 40, 222_030, 10  # cohort, flat CNN dimension, sum field width
ROW_OFFSET = 7  # the quantize kernels' second check
SPECS = {
    "rqm": "rqm:c=0.02,m=16,q=0.42",
    "pbm": "pbm:c=0.02,m=16,theta=0.25",
    "qmgeo": "qmgeo:c=0.02,m=16,r=0.6",
    "none": "none:c=0.02",
}
ROUNDS = 5
PROFILE_ROUNDS = 3
HOST_ROUNDS = 20  # a block of phase 5c
HOST_REPS = 5
SERVICE_ROUNDS = 10  # phase 5d (a) and (b), checkpointed every half
OPT_ROUNDS, OPT_MID = 5, 3  # phase 5d (c): rounds, and the round resumed
HALT_ROUNDS = 7  # phase 5d (d): the rounds the budget affords
KERNEL_REPS = 30
PLAIN_REPS = 5
PROFILE_TRIES = 3
PROFILE_WATCH = ("quantize_kernel", "round_sum_", "decode_apply", "::pack_flat_kernel",
                 "::unpack_flat_kernel", "nccl")
# benchmarks/fig3_fl_emnist.py:33-34
FIG3_ROUNDS = 120
FIG3_FED = dict(num_clients=300, clients_per_round=20, lr=1.0, eval_size=800,
                samples_per_client=20, data_noise=1.5, data_deform=1.2)

# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s of HBM3, 132 SMs at
# 1.98 GHz. Integer work runs on two pipes of 64 lanes an SM (16 a
# scheduler; CUDA programming guide, compute capability 9.0: 64 results a
# clock an SM for 32-bit integer add, shift, compare, logic and multiply),
# which issue side by side: the ALU pipe (LOP3, SHF, IADD3) and the FMA
# pipe (IMAD, and the VIADD adds). A xor runs on the ALU pipe alone and a
# multiply on the FMA pipe alone; an add (IADD3 or VIADD) and a right shift
# (SHF, or IMAD.HI by 2^(32-k)) run on either. The least time of a draw is
# then the largest of its ALU-only ops on one pipe, its FMA-only ops on the
# other, and all its ops spread over both.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 132 * 64 * 1.98e9
FMA_OPS_PER_S = 132 * 64 * 1.98e9
# operations counted per needed splitmix32 draw: the add of the stream
# salt and mix32's first two rounds, a shift, a xor and a multiply each.
# Not counted, so the bound stays below the least time: mix32's last
# shift-xor (it leaves the top 16 bits as they are, and they decide u < p
# but for 1 draw in 65,536), the compare, and every per-element step (clip,
# the IEEE divisions, the level arithmetic, QMGeo's table search, the
# sum). QMGeo's m+1 expf are made once a block, not an element: no term.
ALU_ONLY_OPS_PER_DRAW = 2  # the xors
FMA_ONLY_OPS_PER_DRAW = 2  # the multiplies
EITHER_OPS_PER_DRAW = 3    # the salt's add, the two shifts
# the entries whose fixed cost phase 3 reads at n = 1 (one block)
FLOOR_ROWS = ("decode_apply_sum", "unpack_decode_apply", "pack_flat", "unpack_flat",
              "decode_apply", "decode_apply_sum_dev", "unpack_decode_apply_dev")
# phase 3's realized counts for the _dev decode entries: an empty round, one
# client, 29 (a size at which the traced scale differs from the fixed
# cohort's double), the paper's cohort and its Poisson slate
DEV_COUNTS = (0, 1, 29, 40, 82)
HETERO_ROUNDS = 2  # phase 5e's empty rounds (dropout 0.999)
# phase 5f: the stale async deployment; a timeout of 2 under the default
# mean latency of 1 makes a client late with probability e^-2 (about 5 of
# 40 an aggregation)
ASYNC_SPEC = "async:cadence=40,max_staleness=4,staleness_weight=poly:0.5"
ASYNC_TIMEOUT = 2.0
ASYNC_EMPTY = 2  # all-timeout aggregations
ASYNC_RESUME = 4  # rounds of the checkpointed run, resumed at half
# phase 5g: rounds served (checkpointed at half), client updates a
# submitted batch, the queue's batches, the rounds the budget affords,
# reps of the clock
AGG_ROUNDS = 6
AGG_BATCH = 4
AGG_QUEUE = 8
AGG_HALT = 3
AGG_REPS = 3
AGG_CYCLES = 15  # the clock's passes over the 6 rounds' payloads: 90 rounds a rep
# phase 5h: the lm task (each reduced model-zoo config through FedTrainer
# at its default seq_len 64 and batch 2, a cohort of 40 from a population
# of LM_CLIENTS), LM_ROUNDS rounds a run; mamba2-370m also at full width
LM_ROUNDS = 3
LM_CLIENTS = 200
LM_ARCH = "mamba2-370m"  # the task's default model
LM_DROPOUT = 0.1  # the host engine's comparison with scan (heterogeneous cohorts)
LM_CLOCK_ROUNDS, LM_CLOCK_REPS = 20, 5
LM_FULL_DIM = 419_763_712  # the full-width mamba2-370m's parameters
LM_FULL_CHUNK = 1 << 24  # columns a chunk of the plain versions at full width
# phase 5i: serving. (a) each reduced config: batch, prompt, capacity and
# decode steps, and reduced gemma3's prompt past its window of 64;
# (b)-(c) full width: (batch, prompt, generated tokens, parameters), the
# decode steps profiled at the end
SERVE_BATCH, SERVE_PROMPT, SERVE_CAP, SERVE_STEPS = 2, 64, 96, 8
SERVE_LONG_PROMPT = 96
SERVE_FULL = {"gemma3-4b": (4, 1280, 32, 4_550_996_480),
              "zamba2-1.2b": (4, 512, 32, 1_016_819_712)}
SERVE_PROFILED = 3
# kernels that no main path runs, and why
NO_PATH = {"decode_apply": "the folded w - (shift + scale z) is not bit-identical to "
                           "decode_sum then SGD, so no round of either package runs it"}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def demangle(symbol: str) -> str:
    """A kernel's C++ name without its parameter list (c++filt, where the
    machine has it)."""
    try:
        out = subprocess.run(["c++filt", symbol], capture_output=True, text=True, timeout=60)
        symbol = out.stdout.strip() or symbol
    except OSError:
        pass
    return symbol.replace("(anonymous namespace)::", "").split("(")[0]


def time_ms(torch, fn, reps: int) -> float:
    """Median time of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(torch, fn, reps: int) -> float:
    """Mean device time per call of ``fn`` by CUDA events around ``reps``
    calls queued behind a sleeping kernel: the host enqueues them all
    while the card sleeps, so they run back to back and the events hold
    no host time, only the gaps between launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at the card's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int, symbol: tuple) -> tuple[float, str]:
    """Mean device time per call of the kernel whose name holds every
    string of ``symbol``, and how it was measured. Unlike CUDA events
    around each call, torch.profiler's CUDA trace over ``reps`` calls
    leaves out the wrapper's host time, which is longer than the short
    elementwise kernels. A profiling session's trace can come back
    without some or all of the kernel's records, so up to PROFILE_TRIES
    sessions are made; when none holds all ``reps`` of them, the time is
    ``queued_ms``'s."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kept = [e for e in prof.key_averages() if all(s in e.key for s in symbol)]
        if sum(e.count for e in kept) == reps:
            return sum(e.device_time_total for e in kept) / reps / 1e3, "profiler"
    return queued_ms(torch, fn, reps), "events"


def bound(nbytes: int, draws: int = 0) -> tuple[float, str]:
    """The larger of the bytes over HBM's rate and the needed draws'
    operations over the integer pipes' rates, scheduled as evenly as each
    operation's pipe allows."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ops = ALU_ONLY_OPS_PER_DRAW + FMA_ONLY_OPS_PER_DRAW + EITHER_OPS_PER_DRAW
    t_ops = draws * max(ALU_ONLY_OPS_PER_DRAW / ALU_OPS_PER_S,
                        FMA_ONLY_OPS_PER_DRAW / FMA_OPS_PER_S,
                        ops / (ALU_OPS_PER_S + FMA_OPS_PER_S)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rqm_needed_draws(torch, x, seed: int, params) -> int:
    """splitmix32 draws that the RQM encode of this (rows, dim) x, at row
    offset 0, needs: from each element's bin j, the interior levels down
    (j, j-1, .., 1) and up (j+1, .., m-2) only as far as the nearest kept
    level on each side, and the rounding draw unless p_up is 0 or 1. The
    kernels draw all m-2 keep streams: that is their algorithm, not work
    the function needs."""
    from repro_torch.kernels.quantize import batch_counters
    from repro_torch.kernels.rqm_kernel import rqm_bracket

    m = params.m
    rows, dim = x.shape
    total = 0
    for r in range(rows):
        counter = batch_counters(r, 1, dim, 0, x.device)[0]
        j, i_lo, i_hi, p_up = rqm_bracket(x[r], seed, counter, params)
        down = torch.where(i_lo > 0, j - i_lo + 1, j)
        up = torch.where(i_hi < m - 1, i_hi - j, m - 2 - j)
        total += int((down + up).sum()) + int(((p_up > 0) & (p_up < 1)).sum())
    return total


def pbm_needed_draws(torch, x, params) -> int:
    """PBM's count of successes needs all m trials of every element whose
    p is strictly inside (0, 1)."""
    from repro_torch.kernels.pbm_kernel import success_prob

    p = success_prob(x, params)
    return params.m * int(((p > 0) & (p < 1)).sum())


def qmgeo_needed_draws(torch, x, seed: int, params) -> int:
    """splitmix32 draws that the QMGeo encode of this (rows, dim) x, at
    row offset 0, needs: the noise draw, and the rounding draw unless p_up
    is 0 or 1. Its exponentials depend on the bin alone: m+1 a block, none
    an element."""
    from repro_torch.core.qmgeo import round_to_level
    from repro_torch.kernels.prng import random_uniform
    from repro_torch.kernels.quantize import batch_counters

    rows, dim = x.shape
    draws = 0
    for r in range(rows):
        counter = batch_counters(r, 1, dim, 0, x.device)[0]
        _, p_up = round_to_level(x[r], random_uniform(seed, counter, 0), params)
        draws += dim + int(((p_up > 0) & (p_up < 1)).sum())
    return draws


def check_kernels(torch, np):
    """Phase 3: every kernel against its plain version at the main paths'
    shapes. Returns one record per kernel, without its launches."""
    from repro_torch.core import wire
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.kernels import (
        decode_apply_kernel,
        fused_round_kernel as frk,
        ops,
        pack_kernel,
        pbm_kernel,
        qmgeo_kernel,
        rqm_kernel,
    )
    from repro_torch.kernels.prng import seed_bits

    params = {name: make_mechanism(SPECS[name]).params for name in ("rqm", "pbm", "qmgeo")}
    rng = np.random.default_rng(2024)
    c = params["rqm"].c
    x = torch.from_numpy(
        rng.uniform(-1.2 * c, 1.2 * c, size=(ROWS, DIM)).astype(np.float32)).cuda()
    w = torch.ones(ROWS, dtype=torch.int32, device="cuda")
    seed = int(rng.integers(0, 1 << 32))
    words = wire.packed_words(DIM, BITS)
    params_w = torch.from_numpy(rng.normal(0, 0.05, DIM).astype(np.float32)).cuda()
    n, lr = ROWS, 0.5
    elems = x.numel()
    draws = {"rqm": rqm_needed_draws(torch, x, seed, params["rqm"]),
             "pbm": pbm_needed_draws(torch, x, params["pbm"]),
             "qmgeo": qmgeo_needed_draws(torch, x, seed, params["qmgeo"])}
    log(f"[kernels] needed draws per element: rqm {draws['rqm'] / elems} "
        f"pbm {draws['pbm'] / elems} qmgeo {draws['qmgeo'] / elems} (the kernels "
        f"make 15, 16 and 2; QMGeo's {params['qmgeo'].m + 1} expf are made once a "
        f"block, none an element)")

    # the seed as a captured round reads it: a 1-element int32 device tensor
    seed_t = torch.tensor([seed_bits(seed)], dtype=torch.int32, device="cuda")
    dense = frk.round_sum(x, w, seed, 0, params["rqm"])
    packed = frk.round_sum_packed(x, w, seed, 0, params["rqm"], BITS)
    in_bytes = elems * 4
    cases = []
    quantize = {"rqm": (rqm_kernel.rqm_quantize, rqm_kernel.rqm_quantize_plain, "RQMEncoder",
                        "src/repro/kernels/rqm_kernel.py:120"),
                "pbm": (pbm_kernel.pbm_quantize, pbm_kernel.pbm_quantize_plain, "PBMEncoder",
                        "src/repro/kernels/pbm_kernel.py:53"),
                "qmgeo": (qmgeo_kernel.qmgeo_quantize, qmgeo_kernel.qmgeo_quantize_plain,
                          "QMGeoEncoder", "src/repro/kernels/qmgeo_kernel.py:59")}
    for name, (kernel, plain, encoder, replaces) in quantize.items():
        p = params[name]
        # row offset ROW_OFFSET here; the case below checks offset 0
        got, want = kernel(x, seed, p, ROW_OFFSET), plain(x, seed, p, ROW_OFFSET)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}_quantize at row offset {ROW_OFFSET}: "
                                 f"{int((got != want).sum())} of {got.numel()} levels "
                                 f"differ from its plain version")
        cases.append(dict(
            name=f"{name}_quantize", symbol=("quantize_kernel", encoder),
            source="src/repro_torch/kernels/csrc/quantize.cu", replaces=replaces,
            kernel=lambda sd, k=kernel, p=p: k(x, sd, p, 0),
            plain=lambda sd, k=plain, p=p: k(x, sd, p, 0),
            nbytes=in_bytes * 2, draws=draws[name], seeded=True))
    check_edges(torch, x, w, seed, params)
    dense_bytes = in_bytes + ROWS * 4 + DIM * 4
    packed_bytes = in_bytes + ROWS * 4 + words * 4
    for name, encoder in (("rqm", "RQMEncoder"), ("pbm", "PBMEncoder"),
                          ("qmgeo", "QMGeoEncoder")):
        p = params[name]
        cases.append(dict(
            name=f"{name}_round_sum_dense", symbol=("round_sum_dense_kernel", encoder),
            source="src/repro_torch/kernels/csrc/round_sum.cu",
            replaces="src/repro/kernels/fused_round_kernel.py:101",
            kernel=lambda sd, p=p, e=name: frk.round_sum(x, w, sd, 0, p, e),
            plain=lambda sd, p=p, e=name: frk.round_sum_plain(x, w, sd, 0, p, e),
            nbytes=dense_bytes, draws=draws[name], seeded=True))
        if name in frk.PACKED_KERNELS:
            cases.append(dict(
                name=f"{name}_round_sum_packed", symbol=("round_sum_packed_kernel", encoder),
                source="src/repro_torch/kernels/csrc/round_sum.cu",
                replaces="src/repro/kernels/fused_round_kernel.py:227",
                kernel=lambda sd, p=p, e=name: frk.round_sum_packed(x, w, sd, 0, p, BITS, e),
                plain=lambda sd, p=p, e=name: frk.round_sum_packed_plain(x, w, sd, 0, p, BITS,
                                                                         e),
                nbytes=packed_bytes, draws=draws[name], seeded=True))
    rqm_params = params["rqm"]
    cases += [
        dict(name="decode_apply_sum", symbol=("decode_apply_sum_kernel",),
             source="src/repro_torch/kernels/csrc/decode_apply.cu",
             replaces="src/repro/kernels/decode_apply_kernel.py:103",
             kernel=lambda d=DIM: decode_apply_kernel.decode_apply_sum(
                 params_w[:d], dense[:d], rqm_params, n, lr),
             plain=lambda d=DIM: decode_apply_kernel.decode_apply_plain(
                 params_w[:d], dense[:d], rqm_params, n, lr),
             nbytes=DIM * 12),
        dict(name="unpack_decode_apply", symbol=("unpack_decode_apply_kernel",),
             source="src/repro_torch/kernels/csrc/decode_apply.cu",
             replaces="src/repro/kernels/pack_kernel.py:138",
             kernel=lambda d=DIM: pack_kernel.unpack_decode_apply(
                 params_w[:d], packed[:wire.packed_words(d, BITS)], rqm_params, n, lr,
                 pack_bits=BITS),
             plain=lambda d=DIM: pack_kernel.unpack_decode_apply_plain(
                 params_w[:d], packed[:wire.packed_words(d, BITS)], rqm_params, n, lr,
                 pack_bits=BITS),
             walk=lambda out, d=DIM: checked_walk(
                 pack_kernel, d, wire.packed_words(d, BITS), BITS,
                 (params_w.data_ptr(), packed.data_ptr(), out.data_ptr())),
             nbytes=DIM * 8 + words * 4),
        dict(name="pack_flat", symbol=("pack_flat_kernel",),
             source="src/repro_torch/kernels/csrc/pack.cu",
             replaces="src/repro/kernels/pack_kernel.py:66",
             kernel=lambda d=DIM: pack_kernel.pack_flat(dense[:d], BITS),
             plain=lambda d=DIM: pack_kernel.pack_flat_plain(dense[:d], BITS),
             walk=lambda out, d=DIM: checked_walk(pack_kernel, d, out.numel(), BITS,
                                                  (dense.data_ptr(), out.data_ptr())),
             nbytes=DIM * 4 + words * 4),
        dict(name="unpack_flat", symbol=("unpack_flat_kernel",),
             source="src/repro_torch/kernels/csrc/pack.cu",
             replaces="src/repro/kernels/pack_kernel.py:102",
             kernel=lambda d=DIM: pack_kernel.unpack_flat(
                 packed[:wire.packed_words(d, BITS)], BITS, d),
             plain=lambda d=DIM: pack_kernel.unpack_flat_plain(
                 packed[:wire.packed_words(d, BITS)], BITS, d),
             walk=lambda out, d=DIM: checked_walk(pack_kernel, d, wire.packed_words(d, BITS),
                                                  BITS, (packed.data_ptr(), out.data_ptr())),
             nbytes=DIM * 4 + words * 4),
        dict(name="decode_apply", symbol=("decode_apply_folded_kernel",),
             source="src/repro_torch/kernels/csrc/decode_apply.cu",
             replaces="src/repro/kernels/decode_apply_kernel.py:33",
             kernel=lambda d=DIM: decode_apply_kernel.decode_apply(
                 params_w[:d], dense[:d], rqm_params, n, lr),
             plain=lambda d=DIM: decode_apply_kernel.decode_apply_ref(
                 params_w[:d], dense[:d], rqm_params, n, lr),
             walk=lambda out, d=DIM: checked_folded_walk(
                 decode_apply_kernel, d, False,
                 (params_w.data_ptr(), dense.data_ptr(), out.data_ptr())),
             nbytes=DIM * 12),
    ]
    # the _dev twins at the realized count n, where their traced scale and
    # the by-value entries' double agree (check_decode_dev: where not)
    count = torch.tensor([n], dtype=torch.int32, device="cuda")
    cases += [
        dict(name="decode_apply_sum_dev", symbol=("decode_apply_sum_dev_kernel",),
             source="src/repro_torch/kernels/csrc/decode_apply.cu",
             replaces="src/repro/kernels/decode_apply_kernel.py:103",
             kernel=lambda d=DIM: decode_apply_kernel.decode_apply_sum(
                 params_w[:d], dense[:d], rqm_params, count, lr),
             plain=lambda d=DIM: decode_apply_kernel.decode_apply_plain(
                 params_w[:d], dense[:d], rqm_params, count, lr),
             twin=lambda: decode_apply_kernel.decode_apply_sum(params_w, dense, rqm_params, n,
                                                               lr),
             nbytes=DIM * 12 + 4),
        dict(name="unpack_decode_apply_dev", symbol=("unpack_decode_apply_dev_kernel",),
             source="src/repro_torch/kernels/csrc/decode_apply.cu",
             replaces="src/repro/kernels/pack_kernel.py:138",
             kernel=lambda d=DIM: pack_kernel.unpack_decode_apply(
                 params_w[:d], packed[:wire.packed_words(d, BITS)], rqm_params, count, lr,
                 pack_bits=BITS),
             plain=lambda d=DIM: pack_kernel.unpack_decode_apply_plain(
                 params_w[:d], packed[:wire.packed_words(d, BITS)], rqm_params, count, lr,
                 pack_bits=BITS),
             twin=lambda: pack_kernel.unpack_decode_apply(params_w, packed, rqm_params, n, lr,
                                                          pack_bits=BITS),
             walk=lambda out, d=DIM: checked_walk(
                 pack_kernel, d, wire.packed_words(d, BITS), BITS,
                 (params_w.data_ptr(), packed.data_ptr(), out.data_ptr())),
             nbytes=DIM * 8 + words * 4 + 4),
    ]
    check_codec(torch, pack_kernel, dense, packed)
    check_decode(torch, pack_kernel, decode_apply_kernel, params_w, dense, rqm_params, n, lr)
    check_decode_dev(torch, pack_kernel, decode_apply_kernel, params_w, rqm_params, lr)
    cases = [c for case in cases for c in seeded(case, seed, seed_t)]
    records = []
    for case in cases:
        ops.reset_launches()
        got, want = case["kernel"](), case["plain"]()
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            differ = int((got != want).sum()) if got.shape == want.shape else "all"
            raise AssertionError(f"{case['name']}: {differ} of {want.numel()} outputs "
                                 f"differ from its plain version")
        if "twin" in case and not torch.equal(got, case["twin"]()):
            raise AssertionError(f"{case['name']} differs from its by-value entry")
        if case["name"].endswith("_round_sum_packed"):
            enc = case["name"].split("_")[0]
            if not torch.equal(got, wire.pack_bits(frk.round_sum(x, w, seed, 0, params[enc],
                                                                 enc), BITS)):
                raise AssertionError(f"{case['name']} differs from pack_bits of the dense sum")
        if case["name"].endswith("_quantize"):
            enc = case["name"].split("_")[0]
            if not torch.equal(got.sum(0, dtype=torch.int32),
                               frk.round_sum(x, w, seed, 0, params[enc], enc)):
                raise AssertionError(f"{case['name']}: the batch's sum differs from the "
                                     f"round sum")
        err = float((got.double() - want.double()).abs().max())
        bound_ms, bound_by = bound(case["nbytes"], case.get("draws", 0))
        dev_ms, ms_by = device_ms(torch, case["kernel"], KERNEL_REPS, case["symbol"])
        extra = {}
        if "walk" in case:  # the width and grid its C entry took
            extra["walk"] = case["walk"](got)
        if case["name"] in FLOOR_ROWS:  # the same entry at n = 1: one block
            one = lambda k=case["kernel"]: k(1)  # noqa: E731
            out1, want1 = one(), case["plain"](1)
            torch.cuda.synchronize()
            if not torch.equal(out1, want1):
                raise AssertionError(f"{case['name']} at n = 1 differs from its plain version")
            extra["floor_ms"], extra["floor_ms_by"] = device_ms(torch, one, KERNEL_REPS,
                                                                case["symbol"])
            if "walk" in case:
                extra["floor_walk"] = case["walk"](out1, 1)
        records.append({
            "name": case["name"], "route": "cuda", "source": case["source"],
            "replaces": case["replaces"], "max_abs_err": err,
            "ms": dev_ms, "ms_by": ms_by,
            # the whole wrapper call, host side included, by CUDA events
            "call_ms": time_ms(torch, case["kernel"], KERNEL_REPS),
            "plain_ms": time_ms(torch, case["plain"], PLAIN_REPS),
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes a mechanism's encode (+ sum),
            # the b-bit wire codec, or either decode-then-SGD association
            "library_ms": None,
            **extra,
        })
        if case["name"] == "decode_apply":
            records[-1].update(decode_apply_bf16(torch, decode_apply_kernel, params_w, dense,
                                                 rqm_params, n, lr))
        records[-1]["phase3_launches"] = ops.launches[case["name"]]
        log(f"[kernels] {case['name']}: bit-exact, {dev_ms} ms on the device ({ms_by})"
            + "".join(f", {k} {v}" for k, v in extra.items() if k != "floor_ms_by"))
    return records


def checked_walk(pack_kernel, n: int, n_words: int, bits: int, addrs) -> dict:
    """The width V and grid of a codec launch (two operands) or an
    unpack_decode_apply launch (three: w, words, out):
    ``pack_kernel.codec_walk``'s, which must equal the built C entry's."""
    want = pack_kernel.codec_walk(n, n_words, bits, addrs)
    got = pack_kernel.built_walk(n, n_words, bits, addrs)
    if got != want:
        raise AssertionError(f"walk of {n} fields in {n_words} words at {bits} bits: the C "
                             f"entry takes (V, blocks) {got}, codec_walk {want}")
    return {"v": want[0], "blocks": want[1]}


def checked_folded_walk(decode_apply_kernel, n: int, bf16: bool, addrs) -> dict:
    """The width V and grid of a decode_apply launch (w, the sum, out):
    ``decode_apply_kernel.folded_walk``'s, which must equal the built C
    entry's."""
    want = decode_apply_kernel.folded_walk(n, bf16, addrs)
    got = decode_apply_kernel.built_folded_walk(n, bf16, addrs)
    if got != want:
        raise AssertionError(f"decode_apply's walk of {n} coordinates (bf16 {bf16}): the C "
                             f"entry takes (V, blocks) {got}, folded_walk {want}")
    return {"v": want[0], "blocks": want[1]}


def seeded(case: dict, seed: int, seed_t) -> list:
    """A case as phase 3 runs it. A seeded case's calls take the seed: its
    by-value entry gets the int, and its ``_dev`` twin, which reads the
    seed from device memory as a captured round does, the tensor; the twin
    must also equal the by-value entry's output."""
    if not case.pop("seeded", False):
        return [case]
    kernel, plain = case["kernel"], case["plain"]
    return [dict(case, kernel=lambda: kernel(seed), plain=lambda: plain(seed)),
            dict(case, name=f"{case['name']}_dev", kernel=lambda: kernel(seed_t),
                 plain=lambda: plain(seed_t), twin=lambda: kernel(seed))]


def check_edges(torch, x, w, seed: int, params: dict) -> None:
    """The encoders' other instances, at the main path's shapes: each
    kernel bit-exact against its plain version. RQM's loop over keep-mask
    words (m=64, q=0.5; m=16 unrolls one word); PBM at theta=1/2, where
    x = -c, +c give p = 0, 1 (the integer threshold's edges), with NaN
    inputs, at m=1, 16 and 17 (16 unrolls); QMGeo at m=2 (a one-node tree),
    33 (a tree padded to 64 with +inf), 100 (the walk over W) and 5000
    (past the walk's 4096 tabled weights; 13 rows, so that a 16-bit field
    holds the packed sum)."""
    from repro_torch.kernels import fused_round_kernel as frk
    from repro_torch.kernels import pbm_kernel, qmgeo_kernel, rqm_kernel

    def same(what, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: {int((got != want).sum())} of {got.numel()} "
                                 f"outputs differ from its plain version")
        log(f"[kernels] {what}: {got.numel()} outputs bit-exact")

    wide = dataclasses.replace(params["rqm"], m=64, q=0.5)
    same("rqm_quantize at m=64, q=0.5", rqm_kernel.rqm_quantize(x, seed, wide),
         rqm_kernel.rqm_quantize_plain(x, seed, wide))
    x_nan = x.clone()
    x_nan[::7, ::5] = float("nan")
    for m in (1, 16, 17):
        p = dataclasses.replace(params["pbm"], m=m, theta=0.5)
        same(f"pbm_quantize at m={m}, theta=0.5, NaN inputs",
             pbm_kernel.pbm_quantize(x_nan, seed, p), pbm_kernel.pbm_quantize_plain(x_nan, seed, p))
        same(f"pbm_round_sum_dense at m={m}, theta=0.5, NaN inputs",
             frk.round_sum(x_nan, w, seed, 0, p, "pbm"),
             frk.round_sum_plain(x_nan, w, seed, 0, p, "pbm"))
    del x_nan
    for m, rows in ((2, ROWS), (33, ROWS), (100, ROWS), (5000, 13)):
        p = dataclasses.replace(params["qmgeo"], m=m)
        xm, wm = x[:rows], w[:rows]
        same(f"qmgeo_quantize at m={m}", qmgeo_kernel.qmgeo_quantize(xm, seed, p),
             qmgeo_kernel.qmgeo_quantize_plain(xm, seed, p))
        same(f"qmgeo_round_sum_dense at m={m}", frk.round_sum(xm, wm, seed, 0, p, "qmgeo"),
             frk.round_sum_plain(xm, wm, seed, 0, p, "qmgeo"))
        same(f"qmgeo_round_sum_packed at m={m}",
             frk.round_sum_packed(xm, wm, seed, 0, p, 16, "qmgeo"),
             frk.round_sum_packed_plain(xm, wm, seed, 0, p, 16, "qmgeo"))


def check_codec(torch, pack_kernel, dense, packed) -> None:
    """The wire codec's identities at the main path's shapes: pack_flat of
    the dense round sum is the fused packed sum, unpack_flat inverts it,
    and a 16-bit top field that sets the sign bit round-trips. Then both
    entries on views that start 1 to 3 words past the tensors' aligned
    addresses, at 4 bits (the uplink's width: 8 fields fill a word), 10
    and 16 bits, bit-exact against their plain versions; each launch's walk
    (V, blocks) as the C entry takes it and as ``codec_walk`` picks it."""
    if not torch.equal(pack_kernel.pack_flat(dense, BITS), packed):
        raise AssertionError("pack_flat of the dense round sum differs from the packed sum")
    if not torch.equal(pack_kernel.unpack_flat(packed, BITS, DIM), dense):
        raise AssertionError("unpack_flat of the packed round sum differs from the dense sum")
    top = torch.full((DIM,), (1 << 16) - 1, dtype=torch.int32, device="cuda")
    words16 = pack_kernel.pack_flat(top, 16)
    if not (int(words16.min()) < 0 and torch.equal(words16,
                                                   pack_kernel.pack_flat_plain(top, 16))):
        raise AssertionError("16-bit pack_flat: sign bit not set or differs from plain")
    back = pack_kernel.unpack_flat(words16, 16, DIM)
    if not (torch.equal(back, top)
            and torch.equal(back, pack_kernel.unpack_flat_plain(words16, 16, DIM))):
        raise AssertionError("16-bit unpack_flat does not round-trip the sign-bit field")
    walks = []
    z4 = dense & 15  # the round sum's low 4 bits: every field of a 4-bit word
    words4 = pack_kernel.pack_flat_plain(z4, 4)
    for bits, z, words in ((4, z4, words4), (BITS, dense, packed), (16, top, words16)):
        for offset in range(4):
            zv, wv = (torch.cat([t.new_zeros(offset), t])[offset:] for t in (z, words))
            got_words = pack_kernel.pack_flat(zv, bits)
            got_z = pack_kernel.unpack_flat(wv, bits, DIM)
            torch.cuda.synchronize()
            if not (torch.equal(got_words, pack_kernel.pack_flat_plain(zv, bits))
                    and torch.equal(got_z, pack_kernel.unpack_flat_plain(wv, bits, DIM))
                    and torch.equal(got_words, words) and torch.equal(got_z, z)):
                raise AssertionError(f"the codec at {bits} bits on views {offset} words "
                                     f"in differs from its plain version")
            walk = [checked_walk(pack_kernel, DIM, words.numel(), bits,
                                 (a.data_ptr(), b.data_ptr()))
                    for a, b in ((zv, got_words), (wv, got_z))]
            walks.append(f"{bits} bits, offset {offset}: pack {walk[0]}, unpack {walk[1]}")
    log(f"[kernels] codec: pack_flat(dense) == packed sum, unpack_flat inverts it, 16-bit "
        f"sign-bit round trip over {words16.numel()} words, views at offsets 0-3 at 4, 10 "
        f"and 16 bits: bit-exact; walks (V, blocks): " + "; ".join(walks))


def check_decode(torch, pack_kernel, decode_apply_kernel, params_w, dense, params, n: int,
                 lr: float) -> None:
    """The three decode entries at the main path's widths. The literal
    ones: the round's sum at BITS and 2^16 - 1 everywhere at 16 bits (the
    top field sets the sign bit), at DIM (W even at BITS, odd at 16), DIM -
    1 (n odd), DIM + 1 (n and W odd) and 1 coordinates, on views that
    start 0 to 3 words past an aligned address (the parameters and the sum
    or words alike), each bit-exact against its plain version,
    unpack_decode_apply also against decode_apply_sum; each
    unpack_decode_apply launch's walk (V, blocks) as the C entry takes it
    and as ``codec_walk`` picks it. The folded decode_apply: the round's
    sum at the same counts, float32 and bfloat16 parameters, on views 0 to
    3 elements off, bit-exact against ``decode_apply_ref``; each launch's
    walk as the C entry takes it and as ``folded_walk`` picks it."""
    w_all = torch.cat([params_w, params_w[:1]])
    z_all = torch.cat([dense, dense[:1]])
    walks, folded = [], []
    for d in (DIM, DIM - 1, DIM + 1, 1):
        for dtype in (torch.float32, torch.bfloat16):
            seen = []
            for offset in range(4):
                wv, zv = (torch.cat([t.new_zeros(offset), t])[offset:]
                          for t in (w_all[:d].to(dtype), z_all[:d]))
                got = decode_apply_kernel.decode_apply(wv, zv, params, n, lr)
                torch.cuda.synchronize()
                if got.dtype != dtype or not torch.equal(
                        got, decode_apply_kernel.decode_apply_ref(wv, zv, params, n, lr)):
                    raise AssertionError(f"decode_apply in {dtype}, {d} coordinates, on views "
                                         f"{offset} elements in differs from decode_apply_ref")
                walk = checked_folded_walk(decode_apply_kernel, d, dtype == torch.bfloat16,
                                           (wv.data_ptr(), zv.data_ptr(), got.data_ptr()))
                seen.append((walk["v"], walk["blocks"]))
            folded.append(f"n {d}, {str(dtype).split('.')[-1]}: {seen}")
        for bits, z in ((BITS, z_all[:d]), (16, torch.full_like(z_all[:d], (1 << 16) - 1))):
            words = pack_kernel.pack_flat_plain(z, bits)
            seen = []
            for offset in range(4):
                wv, zv, words_v = (torch.cat([t.new_zeros(offset), t])[offset:]
                                   for t in (w_all[:d], z, words))
                got = decode_apply_kernel.decode_apply_sum(wv, zv, params, n, lr)
                got_p = pack_kernel.unpack_decode_apply(wv, words_v, params, n, lr,
                                                        pack_bits=bits)
                torch.cuda.synchronize()
                if not (torch.equal(got, decode_apply_kernel.decode_apply_plain(
                            wv, zv, params, n, lr))
                        and torch.equal(got_p, pack_kernel.unpack_decode_apply_plain(
                            wv, words_v, params, n, lr, pack_bits=bits))
                        and torch.equal(got_p, got)):
                    raise AssertionError(f"the decode entries at {bits} bits, {d} coordinates, "
                                         f"on views {offset} words in differ from their plain "
                                         f"versions")
                walk = checked_walk(pack_kernel, d, words.numel(), bits,
                                    (wv.data_ptr(), words_v.data_ptr(), got_p.data_ptr()))
                seen.append((walk["v"], walk["blocks"]))
            walks.append(f"n {d}, {bits} bits: {seen}")
    log("[kernels] decode: decode_apply_sum and unpack_decode_apply == their plain versions "
        "and each other at 10 and 16 bits, views at offsets 0-3; unpack walks (V, blocks) "
        "by offset: " + "; ".join(walks))
    log("[kernels] decode: decode_apply == decode_apply_ref in float32 and bfloat16, views "
        "at offsets 0-3; walks (V, blocks) by offset: " + "; ".join(folded))


def check_decode_dev(torch, pack_kernel, decode_apply_kernel, params_w, params,
                     lr: float) -> None:
    """The _dev decode entries, which read a realized count from device
    memory, at DEV_COUNTS, dense and packed at 10 bits (a cohort of 40's
    sum) and 11 bits (the Poisson slate of 82's), at DIM: each bit-exact
    against its plain version and the packed against the dense; at 0, the
    parameters unchanged; at the other counts against the by-value entry,
    equal where the traced scale f32(2 x_max) / f32(n (m-1)) equals the
    fixed cohort's double rounded to float32 and different where not."""
    import numpy as np

    from repro_torch.core import grid

    gen = torch.Generator(device="cuda").manual_seed(5)
    seen = []
    for bits, slate in ((BITS, ROWS), (BITS + 1, 82)):
        z = torch.randint(0, slate * (params.m - 1) + 1, (DIM,), dtype=torch.int32,
                          device="cuda", generator=gen)
        words = pack_kernel.pack_flat_plain(z, bits)
        for k in DEV_COUNTS:
            count = torch.tensor([k], dtype=torch.int32, device="cuda")
            got = decode_apply_kernel.decode_apply_sum(params_w, z, params, count, lr)
            got_p = pack_kernel.unpack_decode_apply(params_w, words, params, count, lr,
                                                    pack_bits=bits)
            want = decode_apply_kernel.decode_apply_plain(params_w, z, params, count, lr)
            want_p = pack_kernel.unpack_decode_apply_plain(params_w, words, params, count, lr,
                                                           pack_bits=bits)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(got_p, want_p)
                    and torch.equal(got_p, got)):
                raise AssertionError(f"the _dev decode entries at {bits} bits, count {k}, "
                                     f"differ from their plain versions or each other")
            if k == 0:
                if not torch.equal(got, params_w):
                    raise AssertionError(f"the _dev decode at count 0 ({bits} bits) moved "
                                         f"the parameters")
                seen.append(f"{bits} bits n 0: w unchanged")
                continue
            by_value = decode_apply_kernel.decode_apply_sum(params_w, z, params, k, lr)
            agree = float(np.float32(grid.decode_scale(k, params))) == float(
                grid.decode_scale_dev(count, params))
            same = torch.equal(by_value, got)
            if same != agree:
                raise AssertionError(f"count {k} at {bits} bits: scales agree {agree}, "
                                     f"_dev == by-value {same}")
            seen.append(f"{bits} bits n {k}: scales agree {agree}, "
                        f"{int((by_value != got).sum())} coordinates differ from by-value")
    log("[kernels] decode _dev: decode_apply_sum_dev and unpack_decode_apply_dev == their "
        "plain versions and each other; " + "; ".join(seen))


def decode_apply_bf16(torch, decode_apply_kernel, params_w, dense, params, n, lr) -> dict:
    """The folded decode_apply on bfloat16 parameters: bit-exact against
    its plain version at DIM and at n = 1; its times, floor (n = 1), walks
    and bound beside the float32 record's."""
    w16 = params_w.to(torch.bfloat16)
    rec = {}
    for d, key in ((DIM, "bf16_ms"), (1, "bf16_floor_ms")):
        fn = lambda d=d: decode_apply_kernel.decode_apply(  # noqa: E731
            w16[:d], dense[:d], params, n, lr)
        got = fn()
        want = decode_apply_kernel.decode_apply_ref(w16[:d], dense[:d], params, n, lr)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or not torch.equal(got, want):
            raise AssertionError(f"decode_apply (bfloat16, {d} coordinates) differs from its "
                                 f"plain version")
        rec[key], rec[f"{key}_by"] = device_ms(torch, fn, KERNEL_REPS,
                                               ("decode_apply_folded_kernel",))
        rec[key.replace("ms", "walk")] = checked_folded_walk(
            decode_apply_kernel, d, True, (w16.data_ptr(), dense.data_ptr(), got.data_ptr()))
        if d == DIM:
            rec["bf16_max_abs_err"] = float((got.double() - want.double()).abs().max())
            rec["bf16_plain_ms"] = time_ms(torch, lambda: decode_apply_kernel.decode_apply_ref(
                w16, dense, params, n, lr), PLAIN_REPS)
    rec["bf16_bound_ms"], rec["bf16_bound_by"] = bound(DIM * 8)  # 2 B in, 4 B of sum, 2 B out
    log(f"[kernels] decode_apply bfloat16: bit-exact, {rec['bf16_ms']} ms on the device "
        f"({rec['bf16_ms_by']}), floor {rec['bf16_floor_ms']} ms, walks {rec['bf16_walk']} "
        f"and {rec['bf16_floor_walk']}")
    return rec


def profile_rounds(torch, tr, rounds: int, tag: str) -> dict:
    """Device time by kernel over ``rounds`` more rounds of a warm
    trainer, from torch.profiler; the full table goes to
    build/profiles/<tag>.txt (git-ignored). The busy share is summed
    kernel time over the wall time, which the profiler itself inflates.
    Only device events count: a CPU op's own device time is that of the
    kernels it launched, which are events of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tr.round()  # a graphed trainer captures its round in its first block
    for _ in range(PROFILE_TRIES):  # a session's trace can come back empty
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds):
                tr.round()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        avgs = [e for e in prof.key_averages()
                if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
        if avgs:
            break
    else:
        raise AssertionError(f"{tag}: {PROFILE_TRIES} profiles of {rounds} rounds "
                             f"hold no device time")
    avgs.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in avgs) / 1e3
    out_dir = os.path.join(ROOT, "build", "profiles")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    return {
        "run": tag, "rounds": rounds, "wall_ms_per_round": wall_ms / rounds,
        "device_busy_ms_per_round": busy_ms / rounds,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "top_kernels_ms_per_round": {
            e.key[:90]: e.self_device_time_total / 1e3 / rounds for e in avgs[:6]},
        # the port's kernels and the collective, by a piece of their names
        "watched_ms_per_round": {
            w: sum(e.self_device_time_total for e in avgs if w in e.key) / 1e3 / rounds
            for w in PROFILE_WATCH},
        # the SecAgg all_reduce's ops (nested: the outer op's times hold
        # the inner one's): calls, host and device ms per round
        "all_reduce_per_round": {
            e.key: {"calls": e.count / rounds, "host_ms": e.cpu_time_total / 1e3 / rounds,
                    "device_ms": e.device_time_total / 1e3 / rounds}
            for e in prof.key_averages()
            if "allreduce" in e.key.lower() or "all_reduce" in e.key.lower()},
    }


def run_path(torch, spec: str, cfg, expect: dict, tag: str, rounds: int = ROUNDS):
    """``rounds`` rounds through FedTrainer on the card, with the launch
    counters set to 0 just before and read just after; checked by the
    counters, the accountant and finite parameters. Returns the trainer
    and the counts."""
    from repro_torch.fed.trainer import FedTrainer
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    tr = FedTrainer(spec, cfg, device="cuda")
    advance = tr.run_block if tr.engine.blocked else (
        lambda k: [tr.round() for _ in range(k)])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    ops.reset_launches()
    t0 = time.perf_counter()
    advance(1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    advance(rounds - 1)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t1
    counts = dict(ops.launches)

    if counts != expect:
        raise AssertionError(f"{tag}: launch counts {counts}, expected {expect}")
    alpha = 8.0
    if len(tr.realized_n) != rounds or not all(0 <= n <= tr.slate for n in tr.realized_n):
        raise AssertionError(f"{tag}: realized cohort sizes {tr.realized_n}")
    # every round at its realized size (the fixed cohort's at every round)
    want = sum(tr.mech.per_round_epsilon(n, alpha) for n in tr.realized_n if n > 0)
    got = tr.accountant.rdp_epsilon(alpha)
    if not math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0):
        raise AssertionError(f"{tag}: RDP at alpha=8 is {got}, expected {want}")
    if not bool(torch.isfinite(tr.flat).all()):
        raise AssertionError(f"{tag}: parameters are not finite")
    metrics = tr.evaluate()
    log(json.dumps({
        "run": tag, "engine": cfg.engine, "graphed": getattr(tr.engine, "graph", None) is not None,
        "fused_rounds": cfg.fused_rounds, "collect_sums": cfg.collect_sums,
        "pack_bits": tr.pack_bits, "shards": tr.shards, "staging": cfg.staging,
        "staged_bytes_total": tr.staged_bytes_total, "rounds": rounds,
        "slate": tr.slate, "realized_n": tr.realized_n, "setup_s": setup_s,
        "first_round_s": first_s, "steady_rounds_per_s": (rounds - 1) / steady_s,
        "launches": counts, "rdp_alpha8": got, "eval_accuracy": metrics.get("accuracy"),
        "eval_loss": metrics["loss"], "eval_ppl": metrics.get("ppl")}))
    return tr, counts


def same_runs(torch, runs: dict, what: str, sums: bool = True) -> None:
    """Every run has the first one's parameters and, with ``sums``, its
    collected sums, bit for bit."""
    import numpy as np

    (first_tag, first), *rest = runs.items()
    for tag, tr in rest:
        if not torch.equal(tr.flat, first.flat):
            differ = int((tr.flat != first.flat).sum())
            raise AssertionError(f"{what}: {tag} and {first_tag} differ in {differ} "
                                 f"parameters")
        if sums and (len(tr.round_sums) != len(first.round_sums) or not all(
                np.array_equal(a, b) for a, b in zip(tr.round_sums, first.round_sums))):
            raise AssertionError(f"{what}: {tag} and {first_tag} collected different sums")
    log(f"[main] {what}: {', '.join(runs)} bit-identical "
        + (f"({len(first.round_sums)} sums each)" if sums else "(parameters)"))


def host_clock(torch, FedConfig) -> tuple[dict, dict]:
    """Phase 5c: the rqm default round on the host's clock, no profiler
    running, at the paper's widths. The eager perround round, taken apart
    into its stages (each stage's host time to issue its work, and the
    round's wall time to a synchronize after it), then the graphed scan
    round (host time to issue a block against its wall time), each over
    HOST_ROUNDS rounds; then rounds/s of both over HOST_REPS blocks of
    HOST_ROUNDS rounds, as median and range. The graphed blocks run under
    torch.cuda.set_sync_debug_mode("error"), so a synchronisation inside
    one raises. The stage-by-stage rounds must equal the graphed scan's bit
    for bit. Returns the report and both trainers."""
    from repro_torch.fed import cohort, rounds
    from repro_torch.fed.trainer import FedTrainer

    per = FedTrainer(SPECS["rqm"], FedConfig(engine="perround"), device="cuda")
    scan = FedTrainer(SPECS["rqm"], FedConfig(), device="cuda")
    finish = rounds.make_decode_apply(per.mech, per.cfg, per.slate, per.server_opt)

    def staged_round() -> dict:
        """One perround round, stage by stage: the host's ms for each."""
        marks = [("start", time.perf_counter())]

        def mark(stage):
            marks.append((stage, time.perf_counter()))

        ids = cohort.sample_slate(per.cfg, per.slate, per.generator)
        seed = cohort.draw_seed(per.generator)
        mark("cohort draw")
        ids = torch.as_tensor(ids, device=per.flat.device)
        mark("ids copy")
        batch = rounds.index_batch(per.client_data, ids)
        mark("index")
        grads = per.client_grads(per.flat, batch)
        mark("vmap(grad) dispatch")
        z = per.mech.quantize_batch(grads, seed)
        mark("encode")
        z_sum = z.sum(0, dtype=z.dtype)
        mark("sum")
        per.flat, per.opt_state, _ = finish(per.flat, per.opt_state, z_sum)
        mark("decode+apply")
        torch.cuda.synchronize()
        mark("wall")
        out = {stage: (t - marks[i][1]) * 1e3 for i, (stage, t) in enumerate(marks[1:-1])}
        out["wall"] = (marks[-1][1] - marks[0][1]) * 1e3
        return out

    def graphed_block() -> tuple[float, float]:
        """HOST_ROUNDS graphed rounds: host ms to issue them, wall ms."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            scan.run_block(HOST_ROUNDS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3

    scan.run_block(1)  # warm-up and capture
    staged_round()
    stages = [staged_round() for _ in range(HOST_ROUNDS)]
    host_ms, wall_ms = graphed_block()
    if not torch.equal(per.flat, scan.flat):
        raise AssertionError("host clock: the staged perround rounds differ from the graphed "
                             "scan's")
    rates = {"perround": [], "scan": []}
    for _ in range(HOST_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per.engine.advance(HOST_ROUNDS)
        torch.cuda.synchronize()
        rates["perround"].append(HOST_ROUNDS / (time.perf_counter() - t0))
        rates["scan"].append(HOST_ROUNDS * 1e3 / graphed_block()[1])
    if not torch.equal(per.flat, scan.flat):
        raise AssertionError("host clock: perround and graphed scan differ after the reps")
    report = {
        "spec": SPECS["rqm"], "rounds": HOST_ROUNDS,
        "perround_host_ms_per_stage": {
            k: statistics.median(st[k] for st in stages) for k in stages[0] if k != "wall"},
        "perround_wall_ms_per_round": statistics.median(st["wall"] for st in stages),
        "scan_host_ms_per_round": host_ms / HOST_ROUNDS,
        "scan_wall_ms_per_round": wall_ms / HOST_ROUNDS,
        "sync_debug_mode": "error",
        "rounds_per_s": {
            engine: {"median": statistics.median(v), "min": min(v), "max": max(v),
                     "reps": len(v), "each": v}
            for engine, v in rates.items()},
    }
    return report, {"perround": per, "scan": scan}


def same_state(torch, a, b, what: str) -> None:
    """Two trainers hold the same parameters, optimizer state and
    accountant history, bit for bit."""
    import numpy as np

    if not torch.equal(a.flat, b.flat):
        raise AssertionError(f"{what}: parameters differ in {int((a.flat != b.flat).sum())}")
    if isinstance(a.opt_state, dict):
        for k, v in a.opt_state.items():
            if not torch.equal(v, b.opt_state[k]):
                raise AssertionError(f"{what}: optimizer state {k!r} differs")
    elif a.opt_state != b.opt_state:
        raise AssertionError(f"{what}: optimizer states {a.opt_state} and {b.opt_state}")
    if a.realized_n != b.realized_n or len(a.accountant.history) != len(b.accountant.history) \
            or not all(np.array_equal(x, y) for x, y in zip(a.accountant.history,
                                                           b.accountant.history)):
        raise AssertionError(f"{what}: accountant histories differ")


def tracked_series(path: str, tr, rounds: int, what: str) -> dict:
    """The JSON tracker document at ``path``: rounds 1..``rounds`` with no
    duplicate or gap, realized_n the accountant's, and eps_spent the
    accountant's after each round, bit for bit."""
    from repro_torch.core.renyi import RenyiAccountant

    with open(path) as f:
        doc = json.load(f)
    got = [r["round"] for r in doc["rounds"]]
    if got != list(range(1, rounds + 1)):
        raise AssertionError(f"{what}: tracked rounds {got}")
    acc = RenyiAccountant(alphas=tr.cfg.accountant_alphas)
    for rec, vec, n in zip(doc["rounds"], tr.accountant.history, tr.realized_n):
        acc.step(vec)
        if rec["eps_spent"] != acc.dp_epsilon(tr.cfg.budget_delta)[0] or rec["realized_n"] != n:
            raise AssertionError(f"{what}: round {rec['round']}'s record {rec} is not the "
                                 f"accountant's")
    return doc


def services(torch, FedConfig, counted, card: str) -> dict:
    """Phase 5d: the trainer's services on the card at FedConfig()'s
    widths (rqm), each run counted by ``counted(tag, expect, fn)``.
    Returns the report, with (e)'s rates."""
    import shutil

    from repro_torch.core import wire
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.core.renyi import RenyiAccountant
    from repro_torch.fed.trainer import FedTrainer

    out_dir = os.path.join(ROOT, "build", "phase5d")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    spec, quiet = SPECS["rqm"], (lambda msg: None)
    report = {}

    def trainer(cfg, tracker=None):
        return FedTrainer(spec, cfg, device="cuda", tracker=tracker)

    # (a), (b): resume, with the tracked series continued
    R, H = SERVICE_ROUNDS, SERVICE_ROUNDS // 2
    for tag, fused, expect in (
            ("resume", False, lambda k: {"rqm_quantize_dev": k}),
            ("fused packed resume", True,
             lambda k: {"rqm_round_sum_packed_dev": k, "unpack_decode_apply": k})):
        path = os.path.join(out_dir, f"{tag.replace(' ', '_')}.json")
        cfg = FedConfig(fused_rounds=fused, track=f"json:{path}", ckpt_every=H,
                        ckpt_dir=os.path.join(out_dir, f"{tag.replace(' ', '_')}_ckpt"))
        full = trainer(cfg)
        counted(f"{tag}: {R} rounds", expect(R), lambda: full.train(R, eval_every=H, log=quiet))
        res = trainer(cfg, tracker=f"json:{path},append=true")
        if res.restore_checkpoint(H) != H:
            raise AssertionError(f"{tag}: restored the wrong round")
        counted(f"{tag}: resumed at {H}", expect(R - H),
                lambda: res.train(R - H, eval_every=H, log=quiet))
        same_state(torch, full, res, tag)
        doc = tracked_series(path, res, R, tag)
        bits = {(r["wire_bits"], r["pack_width"]) for r in doc["rounds"]}
        if fused and bits != {(32 * wire.packed_words(DIM, BITS), BITS)}:
            raise AssertionError(f"{tag}: records' (wire_bits, pack_width) {bits}")
        report[tag] = {"rounds": R, "resumed_at": H, "tracked_rounds": len(doc["rounds"]),
                       "wire_bits_pack_width": sorted(bits),
                       "eps_spent": doc["rounds"][-1]["eps_spent"],
                       "timings": doc["timings"]}
        log(f"[5d] {tag}: {R} rounds == resumed at {H}, bit for bit; tracked rounds "
            f"1..{R}, eps_spent == the accountant's")
        del full, res

    # (c): stateful optimizers, graphed == eager == resumed
    for opt in ("momentum", "adam"):
        for fused in (False, True):
            tag = f"{opt} {'fused dense' if fused else 'materialized'}"
            entry = "rqm_round_sum_dense" if fused else "rqm_quantize"
            cfg = FedConfig(server_opt=opt, fused_rounds=fused, ckpt_every=OPT_MID,
                            ckpt_dir=os.path.join(out_dir, tag.replace(" ", "_")))
            scan = trainer(cfg)
            if scan.pack_bits is not None:
                raise AssertionError(f"{tag}: a stateful optimizer took the packed wire")
            counted(f"{tag} scan", {f"{entry}_dev": OPT_ROUNDS},
                    lambda: scan.train(OPT_ROUNDS, eval_every=OPT_ROUNDS, log=quiet))
            per = trainer(dataclasses.replace(cfg, engine="perround", ckpt_dir=None,
                                              ckpt_every=0))
            counted(f"{tag} perround", {entry: OPT_ROUNDS},
                    lambda: per.train(OPT_ROUNDS, eval_every=OPT_ROUNDS, log=quiet))
            res = trainer(cfg)
            res.restore_checkpoint(OPT_MID)
            counted(f"{tag} resumed", {f"{entry}_dev": OPT_ROUNDS - OPT_MID},
                    lambda: res.train(OPT_ROUNDS - OPT_MID, eval_every=OPT_ROUNDS, log=quiet))
            same_state(torch, scan, per, f"{tag}: graphed scan and perround")
            same_state(torch, scan, res, f"{tag}: uninterrupted and resumed at {OPT_MID}")
            log(f"[5d] {tag}: graphed scan == perround == resumed at {OPT_MID}, parameters "
                f"and state {sorted(scan.opt_state)} bit for bit")
            report[tag] = {"rounds": OPT_ROUNDS, "resumed_at": OPT_MID,
                           "state": sorted(scan.opt_state)}
            del scan, per, res

    # (d): the budget halt
    cfg = FedConfig()
    mech = make_mechanism(spec)
    per_round = [mech.per_round_epsilon(cfg.clients_per_round, a) for a in cfg.accountant_alphas]
    acc = RenyiAccountant(alphas=cfg.accountant_alphas)
    at, after = (acc.projected_dp_epsilon(cfg.budget_delta, per_round, k)[0]
                 for k in (HALT_ROUNDS, HALT_ROUNDS + 1))
    budget = at + (after - at) / 2
    tr = trainer(dataclasses.replace(cfg, budget_eps=budget))
    afford = tr.accountant.rounds_within_budget(budget, cfg.budget_delta, tr.per_round_eps)
    counted("budget halt", {"rqm_quantize_dev": HALT_ROUNDS},
            lambda: tr.train(20, eval_every=20, log=quiet))
    spent, remaining = tr.budget_spent()
    if not (afford == tr.accountant.rounds == HALT_ROUNDS and spent <= budget):
        raise AssertionError(f"budget halt: {tr.accountant.rounds} rounds (affordable "
                             f"{afford}), spent {spent} of {budget}")
    report["budget halt"] = {"budget_eps": budget, "rounds": tr.accountant.rounds,
                             "eps_spent": spent, "eps_remaining": remaining}
    log(f"[5d] budget halt: {tr.accountant.rounds} rounds, eps_spent {spent} of {budget}")
    del tr

    # (e): the tracked run's price, reported
    tracked = trainer(FedConfig(), tracker=f"json:{os.path.join(out_dir, 'clock.json')}")
    noop = trainer(FedConfig())
    for tr in (tracked, noop):
        tr.run_block(1)  # capture
    rates = {"json": [], "noop": []}
    for _ in range(HOST_REPS):
        for name, tr in (("json", tracked), ("noop", noop)):
            # HOST_REPS advances back to back, one synchronisation after
            # them: the noop run's host issues an advance while the card
            # runs the last one; the tracked run waits for each
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_REPS):
                tr.run_block(HOST_ROUNDS)
            torch.cuda.synchronize()
            rates[name].append(HOST_REPS * HOST_ROUNDS / (time.perf_counter() - t0))
    if not torch.equal(tracked.flat, noop.flat):
        raise AssertionError("tracked and noop runs differ")
    report["tracked_clock"] = {
        "spec": spec, "advance": HOST_ROUNDS, "advances_a_rep": HOST_REPS, "card": card,
        "rounds_per_s": {name: {"median": statistics.median(v), "min": min(v), "max": max(v),
                                "reps": len(v), "each": v} for name, v in rates.items()}}
    return report


def hetero_cohorts(torch, FedConfig, run, counted, clock: dict, card: str) -> dict:
    """Phase 5e: heterogeneous cohorts at the paper's widths, rqm, each run
    counted (``run`` for ROUNDS-round runs, ``counted`` for the others).
    Returns the report and (e)'s graphed Poisson trainer, which phase 6
    profiles."""
    import numpy as np

    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.core.renyi import RenyiAccountant
    from repro_torch.fed import cohort
    from repro_torch.fed.trainer import FedTrainer

    spec, R, quiet = SPECS["rqm"], ROUNDS, (lambda msg: None)
    report = {}
    modes = {"poisson": dict(subsampling="poisson"), "dropout": dict(dropout=0.1),
             "poisson+dropout": dict(subsampling="poisson", dropout=0.1)}
    paths = {"materialized": dict(), "fused packed": dict(fused_rounds=True),
             "fused dense": dict(fused_rounds=True, wire_packed=False)}

    def expect(path, engine):
        dev = "_dev" if engine == "scan" else ""
        codec = {"pack_flat": R, "unpack_flat": R} if engine == "shard" else {}
        if path == "materialized":
            return {f"rqm_quantize{dev}": R, **codec}
        if path == "fused packed":
            return {f"rqm_round_sum_packed{dev}": R, "unpack_decode_apply_dev": R,
                    "unpack_flat": R}
        return {f"rqm_round_sum_dense{dev}": R, "decode_apply_sum_dev": R, **codec}

    # (a) graphed scan == eager perround == one-rank NCCL shard, and the host
    for mode, hk in modes.items():
        scan_sums = None
        for path, pk in paths.items():
            runs = {}
            for engine in ("scan", "perround", "shard"):
                cfg = FedConfig(engine=engine, collect_sums=True, **hk, **pk)
                if engine == "shard":
                    cfg = dataclasses.replace(cfg, shards=1)
                tag = f"[5e] {mode} {path} {engine}"
                runs[tag] = run(spec, cfg, expect(path, engine), tag)
            same_runs(torch, runs, f"[5e] {mode} {path}: graphed scan, perround, shard")
            trs = list(runs.values())
            if any(tr.realized_n != trs[0].realized_n for tr in trs):
                raise AssertionError(f"[5e] {mode} {path}: realized sizes differ")
            want_bits = None if path != "fused packed" else (11 if "poisson" in mode else 10)
            if trs[0].pack_bits != want_bits:
                raise AssertionError(f"[5e] {mode} {path}: wire width {trs[0].pack_bits}, "
                                     f"expected {want_bits}")
            if scan_sums is None:
                scan_sums = trs[0]
            else:
                same_runs(torch, {"materialized": scan_sums, path: trs[0]},
                          f"[5e] {mode}: materialized and {path}")
            report[f"{mode} {path}"] = {"slate": trs[0].slate, "pack_bits": trs[0].pack_bits,
                                        "realized_n": trs[0].realized_n}
            del runs, trs
        host = run(spec, FedConfig(engine="host", collect_sums=True, **hk),
                   {"rqm_quantize": R}, f"[5e] {mode} host")
        if host.realized_n != scan_sums.realized_n or not all(
                np.array_equal(a, b) for a, b in zip(host.accountant.history,
                                                     scan_sums.accountant.history)):
            raise AssertionError(f"[5e] {mode} host: realized sizes or eps history differ "
                                 f"from scan's")
        diff = float((host.flat - scan_sums.flat).abs().max())
        # the reference's own tolerance for its host engine against scan
        if diff > 1e-5:
            raise AssertionError(f"[5e] {mode} host: parameters {diff} from scan's")
        report[f"{mode} host"] = {"max_abs_diff_from_scan": diff,
                                  "bit_for_bit": bool(torch.equal(host.flat, scan_sums.flat)),
                                  "sums_equal": all(np.array_equal(a, b) for a, b in zip(
                                      host.round_sums, scan_sums.round_sums))}
        log(f"[5e] {mode}: host == scan in realized sizes {host.realized_n} and eps history; "
            f"parameters {diff} apart")
        del host, scan_sums

    # (b) empty rounds: nothing moves (momentum, materialized; sgd, fused packed)
    for tag, kw, entries in (
            ("momentum", dict(server_opt="momentum"), {"rqm_quantize_dev": 1}),
            ("sgd fused packed", dict(fused_rounds=True),
             {"rqm_round_sum_packed_dev": 1, "unpack_decode_apply_dev": 1})):
        tr = FedTrainer(spec, FedConfig(dropout=0.999, **kw), device="cuda")
        empty = 0
        for _ in range(HETERO_ROUNDS):
            flat, opt = tr.flat.clone(), {k: v.clone() for k, v in dict(tr.opt_state).items()}
            counted(f"[5e] empty rounds, {tag}", entries, lambda: tr.run_block(1))
            if tr.realized_n[-1] == 0:
                empty += 1
                if not torch.equal(tr.flat, flat) or any(
                        not torch.equal(v, tr.opt_state[k]) for k, v in opt.items()):
                    raise AssertionError(f"[5e] an empty round moved the state ({tag})")
        if empty == 0:
            raise AssertionError(f"[5e] dropout 0.999 gave no empty round ({tag}): "
                                 f"{tr.realized_n}")
        report[f"empty rounds {tag}"] = {"realized_n": tr.realized_n}
        log(f"[5e] empty rounds ({tag}): realized {tr.realized_n}, nothing moved")
        del tr

    # (c) local_steps=3 under dropout: graphed == perround
    ls = FedConfig(local_steps=3, dropout=0.1, collect_sums=True)
    same_runs(torch, {
        "scan": run(spec, ls, {"rqm_quantize_dev": R}, "[5e] local_steps=3 scan"),
        "perround": run(spec, dataclasses.replace(ls, engine="perround"), {"rqm_quantize": R},
                        "[5e] local_steps=3 perround")},
        "[5e] local_steps=3, dropout 0.1: graphed scan and perround")

    # (d) the budget halt under dropout 0.5: an overshoot of at most one round
    cfg = FedConfig(dropout=0.5)
    mech = make_mechanism(spec)
    nominal = [mech.per_round_epsilon(cfg.clients_per_round, a) for a in cfg.accountant_alphas]
    budget = RenyiAccountant(alphas=cfg.accountant_alphas).projected_dp_epsilon(
        cfg.budget_delta, nominal, HALT_ROUNDS)[0]
    tr = FedTrainer(spec, dataclasses.replace(cfg, budget_eps=budget), device="cuda")
    counted("[5e] budget halt, dropout 0.5", None, lambda: tr.train(20, eval_every=20, log=quiet))
    before = RenyiAccountant(alphas=cfg.accountant_alphas)
    for vec in tr.accountant.history[:-1]:
        before.step(vec)
    spent = tr.budget_spent()[0]
    if not (tr.accountant.rounds < 20 and (spent <= budget or
                                          before.dp_epsilon(cfg.budget_delta)[0] <= budget)):
        raise AssertionError(f"[5e] budget halt: {tr.accountant.rounds} rounds, spent {spent} "
                             f"of {budget}")
    report["budget halt"] = {"budget_eps": budget, "rounds": tr.accountant.rounds,
                             "realized_n": list(tr.realized_n), "eps_spent": spent,
                             "overshoot": bool(spent > budget)}
    log(f"[5e] budget halt under dropout 0.5: {tr.accountant.rounds} rounds "
        f"{tr.realized_n}, eps_spent {spent} of {budget}")
    del tr

    # (e) reported: graphed rounds/s of the Poisson round, against 5c's
    tr = FedTrainer(spec, FedConfig(subsampling="poisson"), device="cuda")
    tr.run_block(1)  # capture
    replay = torch.Generator()
    replay.set_state(tr.generator.get_state())
    sizes = set(cohort.realized_counts(tr.cfg, tr.slate, cohort.draw_block(
        tr.cfg, tr.slate, replay, HOST_REPS * HOST_ROUNDS)))
    t0 = time.perf_counter()
    for k in sizes:  # the host's accounting of new sizes is not the round's
        tr._eps_vector(k)
    memo_s = time.perf_counter() - t0
    rates = []
    for _ in range(HOST_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tr.run_block(HOST_ROUNDS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        rates.append(HOST_ROUNDS / (time.perf_counter() - t0))
    report["poisson_clock"] = {
        "spec": spec, "slate": tr.slate, "rounds": HOST_ROUNDS, "card": card,
        "rounds_per_s": {"median": statistics.median(rates), "min": min(rates),
                         "max": max(rates), "reps": len(rates), "each": rates},
        "fixed_round_rounds_per_s_median": clock["rounds_per_s"]["scan"]["median"],
        "distinct_sizes": len(sizes), "accounting_memo_s": memo_s}
    log(f"[5e] graphed Poisson round (slate {tr.slate}): "
        f"{report['poisson_clock']['rounds_per_s']['median']} rounds/s against phase 5c's "
        f"fixed round {clock['rounds_per_s']['scan']['median']}; {len(sizes)} sizes accounted "
        f"in {memo_s} s; nvidia-smi: {card}")
    return report, tr


def async_engine(torch, FedConfig, run, counted, clock: dict, card: str) -> dict:
    """Phase 5f: the async engine at the paper's widths, rqm, each run
    counted (``run`` for ROUNDS-round runs, ``counted`` for the others).
    Returns the report."""
    import shutil

    import numpy as np

    from repro_torch.fed.trainer import FedTrainer

    spec, R, quiet = SPECS["rqm"], ROUNDS, (lambda msg: None)
    report = {}

    # (a) the plain corner is perround's round, bit for bit
    plain = run(spec, FedConfig(engine="async", async_cadence=ROWS, collect_sums=True),
                {"rqm_quantize": R}, "[5f] async plain corner")
    if not plain.engine._plain:
        raise AssertionError("[5f] cadence 40, max_staleness 0, no timeout: not the plain corner")
    per = run(spec, FedConfig(engine="perround", collect_sums=True), {"rqm_quantize": R},
              "[5f] perround")
    same_runs(torch, {"[5f] perround": per, "[5f] async plain corner": plain},
              "[5f] the async plain corner and eager perround")

    # (b) stale versions and late clients: materialized == fused dense, each
    # aggregation accounted at its realized size
    stale = FedConfig(engine=ASYNC_SPEC, async_timeout=ASYNC_TIMEOUT, collect_sums=True)
    tr = run(spec, stale, {"rqm_quantize": R}, "[5f] async stale materialized")
    fused = run(spec, dataclasses.replace(stale, fused_rounds=True), {"rqm_round_sum_dense": R},
                "[5f] async stale fused dense")
    same_runs(torch, {"materialized": tr, "fused dense": fused},
              "[5f] async, max_staleness 4, timeout 2: materialized and fused dense")
    extras = tr.round_extras
    if not any(n < ROWS for n in tr.realized_n) or max(e["staleness_max"] for e in extras) < 1:
        raise AssertionError(f"[5f] no weight-0 row or no stale version: {extras}")
    for vec, n in zip(tr.accountant.history, tr.realized_n):
        want = [tr.mech.per_round_epsilon(n, a) if n else 0.0 for a in tr.cfg.accountant_alphas]
        if not np.array_equal(vec, want):
            raise AssertionError(f"[5f] an aggregation of {n} is not accounted at {n}")
    report["stale"] = {"spec": ASYNC_SPEC, "timeout": ASYNC_TIMEOUT,
                       "realized_n": list(tr.realized_n),
                       "staleness_max": [e["staleness_max"] for e in extras],
                       "staleness_discount": [e["staleness_discount"] for e in extras]}
    log(f"[5f] stale and late: realized {tr.realized_n}, staleness "
        f"{report['stale']['staleness_max']}, materialized == fused dense, accounted at "
        f"the realized sizes")
    del fused

    # (c) streamed staging == full staging
    streamed = run(spec, dataclasses.replace(stale, staging="stream"), {"rqm_quantize": R},
                   "[5f] async stale streamed")
    same_runs(torch, {"full": tr, "streamed": streamed}, "[5f] async: full and streamed staging")
    report["streamed"] = {"staged_bytes_total": streamed.staged_bytes_total,
                          "staged_bytes_last_block": streamed.staged_bytes_last_block}
    del streamed

    # (d) aggregations whose rows all time out move nothing, cost nothing
    empty = FedTrainer(spec, dataclasses.replace(stale, async_timeout=1e-6, server_opt="momentum",
                                                 collect_sums=False), device="cuda")
    flat, m = empty.flat.clone(), empty.opt_state["m"].clone()
    counted("[5f] all-timeout aggregations", {"rqm_quantize": ASYNC_EMPTY},
            lambda: [empty.round() for _ in range(ASYNC_EMPTY)])
    if empty.realized_n != [0] * ASYNC_EMPTY or not torch.equal(empty.flat, flat) or \
            not torch.equal(empty.opt_state["m"], m) or empty.accountant.rdp_epsilon(8.0) != 0.0:
        raise AssertionError(f"[5f] all-timeout aggregations moved the state or cost eps: "
                             f"{empty.realized_n}")
    report["all timeout"] = {"realized_n": empty.realized_n}
    log(f"[5f] all-timeout aggregations: realized {empty.realized_n}, nothing moved")
    del empty

    # (e) a resumed run continues bit for bit
    out_dir = os.path.join(ROOT, "build", "phase5f")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = dataclasses.replace(stale, collect_sums=False, ckpt_dir=out_dir,
                              ckpt_every=ASYNC_RESUME // 2)
    full = FedTrainer(spec, cfg, device="cuda")
    counted("[5f] checkpointed", {"rqm_quantize": ASYNC_RESUME},
            lambda: full.train(ASYNC_RESUME, eval_every=ASYNC_RESUME, log=quiet))
    res = FedTrainer(spec, cfg, device="cuda")
    res.restore_checkpoint(ASYNC_RESUME // 2)
    counted("[5f] resumed", {"rqm_quantize": ASYNC_RESUME - ASYNC_RESUME // 2},
            lambda: res.train(ASYNC_RESUME - ASYNC_RESUME // 2, eval_every=ASYNC_RESUME,
                              log=quiet))
    same_state(torch, full, res, "[5f] async: uninterrupted and resumed")
    if not torch.equal(full.engine.hist, res.engine.hist) or \
            full.engine.sim._agg_times != res.engine.sim._agg_times:
        raise AssertionError("[5f] async: the resumed ring or arrival trace differs")
    log(f"[5f] resumed at {ASYNC_RESUME // 2} of {ASYNC_RESUME}: parameters, ring, arrival "
        f"trace and accountant bit for bit")
    del full, res

    # (f) reported: rounds/s on the host's clock, in turns with eager
    # perround, no sums kept (no read back a round), beside phase 5c's
    runs = {"async stale": tr, "async plain corner": plain, "perround": per}
    rates = {name: [] for name in runs}
    for t in runs.values():
        t.cfg.collect_sums = False
    for _ in range(HOST_REPS):
        for name, t in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.engine.advance(HOST_ROUNDS)
            torch.cuda.synchronize()
            rates[name].append(HOST_ROUNDS / (time.perf_counter() - t0))
    report["clock"] = {
        "rounds": HOST_ROUNDS, "card": card,
        "rounds_per_s": {name: {"median": statistics.median(v), "min": min(v), "max": max(v),
                                "reps": len(v), "each": v} for name, v in rates.items()},
        "phase5c_rounds_per_s_median": {k: v["median"]
                                        for k, v in clock["rounds_per_s"].items()}}
    log(f"[5f] rounds/s (median of {HOST_REPS} x {HOST_ROUNDS}, in turns): async stale "
        f"{report['clock']['rounds_per_s']['async stale']['median']}, async plain corner "
        f"{report['clock']['rounds_per_s']['async plain corner']['median']}, eager perround "
        f"{report['clock']['rounds_per_s']['perround']['median']}; phase 5c eager "
        f"perround {clock['rounds_per_s']['perround']['median']}, graphed scan "
        f"{clock['rounds_per_s']['scan']['median']}; nvidia-smi: {card}")
    return report


def aggregator(torch, counted, card: str) -> dict:
    """Phase 5g: the aggregator round-server at the paper's widths, rqm,
    each gated run counted. Returns the report."""
    import shutil
    import threading

    import numpy as np

    from repro_torch.core import wire
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.core.renyi import RenyiAccountant
    from repro_torch.fed.cohort import draw_seed
    from repro_torch.launch.aggregator import (AggregatorServer, _simulated_grads,
                                               simulate_client_updates)

    mech = make_mechanism(SPECS["rqm"])
    R, H, per_round = AGG_ROUNDS, AGG_ROUNDS // 2, ROWS // AGG_BATCH
    out_dir = os.path.join(ROOT, "build", "phase5g")
    shutil.rmtree(out_dir, ignore_errors=True)
    report = {}

    def server(**kw):
        return AggregatorServer(mech, DIM, cohort=ROWS, device="cuda", **kw)

    def keep_sums(srv) -> list:
        """Each round's SecAgg sum, read back as the server makes it."""
        sums, secure_sum = [], srv._secure_sum

        def kept(take):
            z = secure_sum(take)
            sums.append(z.cpu().numpy())
            return z

        srv._secure_sum = kept
        return sums

    def serve(srv, produce, rounds: int) -> tuple[float, int, list]:
        """The service thread serves while a producer thread runs
        ``produce(submit)``, ``submit`` a blocking submit that records its
        wait; returns the steady seconds, from the first poll that sees a
        round served to the last round (no thread start-up, no first
        round), the rounds served in them, and the waits."""
        waits, errors = [], []

        def submit(batch):
            t0 = time.perf_counter()
            if not srv.submit(batch, block=True, timeout=120.0):
                raise AssertionError("[5g] a blocking submit was refused")
            waits.append(time.perf_counter() - t0)

        def producer():
            try:
                produce(submit)
            except BaseException as err:  # re-raised below
                errors.append(err)

        srv.start(poll=0.0005)
        thread = threading.Thread(target=producer)
        thread.start()
        deadline, t_first, seen = time.perf_counter() + 120.0, 0.0, 0
        while srv.rounds_served < rounds and time.perf_counter() < deadline and not errors:
            if not seen and srv.rounds_served:
                t_first, seen = time.perf_counter(), srv.rounds_served
            time.sleep(0.0002)
        seconds = time.perf_counter() - t_first
        thread.join()
        srv.shutdown()
        if errors:
            raise errors[0]
        if srv.rounds_served != rounds:
            raise AssertionError(f"[5g] served {srv.rounds_served} of {rounds} rounds")
        return seconds, rounds - seen, waits

    # (a) packed uplink through the service thread, with backpressure
    first = server(queue_limit=AGG_QUEUE, ckpt_dir=out_dir, ckpt_every=H)
    sums = keep_sums(first)
    gen = torch.Generator().manual_seed(0)
    batches: list = []

    def produce(submit):
        # every batch made first, then submitted as fast as the queue takes it
        for i in range(R * per_round):
            batches.append(simulate_client_updates(
                mech, DIM, gen, AGG_BATCH, round_tag=i // per_round, first_id=i * AGG_BATCH,
                packed=True, device="cuda"))
        for b in batches:
            submit(b)

    n = R * ROWS
    served = {}
    counted("[5g] packed service", {"rqm_quantize": n, "pack_flat": n, "unpack_flat": n},
            lambda: served.update(zip(("seconds", "timed", "waits"),
                                      serve(first, produce, R))))
    blocked = sum(1 for w in served["waits"] if w > 1e-3)
    if not blocked:
        raise AssertionError("[5g] the producer never waited on the full queue")
    rounds_of = [[u for b in batches[r * per_round:(r + 1) * per_round] for u in b]
                 for r in range(R)]
    for r, take in enumerate(rounds_of):
        host = np.sum([u.payload.unpack().astype(np.int64) for u in take], axis=0)
        if not np.array_equal(sums[r], host):
            raise AssertionError(f"[5g] round {r}'s SecAgg sum is not the host sum")
    if any(u.payload.bits != 4 for take in rounds_of for u in take):
        raise AssertionError("[5g] the uplink is not 4-bit packed")
    # the first batch's words are its levels packed by the host's numpy
    # codec: the clients' gradients and seeds redrawn from the stream
    # (simulate_client_updates' order), quantized on the card again
    replay = torch.Generator().manual_seed(0)
    grads = _simulated_grads(mech, DIM, replay, AGG_BATCH, "cuda")
    for u, g, seed in zip(batches[0], grads, [draw_seed(replay) for _ in range(AGG_BATCH)]):
        levels = mech.quantize(g, seed).reshape(-1).cpu().numpy()
        if not np.array_equal(u.payload.words, wire.pack_bits_np(levels, 4)):
            raise AssertionError("[5g] encode_wire's 4-bit words are not its levels packed")
    # a CPU replay of the port's server on the same payloads
    cpu = AggregatorServer(mech, DIM, cohort=ROWS, device="cpu")
    for b in batches:
        cpu.submit(b)
    cpu.drain()
    got, want = first.flat.cpu().numpy(), cpu.flat.numpy()
    tol = R * (first.lr * np.spacing(np.float32(2.0 * mech.params.x_max))
               + np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(np.float32)))
    if cpu.realized_n != first.realized_n or not np.all(np.abs(got - want) <= tol):
        raise AssertionError("[5g] the card's server and its CPU replay differ")
    report["packed service"] = {
        "rounds": R, "cohort": ROWS, "batch": AGG_BATCH, "queue_limit": AGG_QUEUE,
        "submits_blocked": blocked, "submits": len(served["waits"]), "sums_equal_host": True,
        "words_equal_host_pack": AGG_BATCH,
        "cpu_replay_bit_for_bit": bool(np.array_equal(got, want)),
        "uplink_bytes_a_round": first.round_extras[0]["uplink_bytes"],
        "eps_spent": first.snapshot()["eps_spent"]}
    del cpu

    # (b) packed-direct: the same levels packed at 10 bits, where the cohort
    # of 40's bound (600) fits, add as words and unpack once a round
    wide = [[dataclasses.replace(u, payload=wire.PackedPayload.pack(u.payload.unpack(), BITS))
             for u in b] for b in batches]
    direct = server(queue_limit=len(wide))
    direct_sums = keep_sums(direct)

    def direct_run():
        for b in wide:
            direct.submit(b)
        direct.drain()

    counted("[5g] packed-direct", {"unpack_flat": R}, direct_run)
    if not (all(np.array_equal(a, b) for a, b in zip(direct_sums, sums))
            and len(direct_sums) == R and torch.equal(direct.flat, first.flat)):
        raise AssertionError("[5g] the packed-direct sums differ from the unpacked ones")
    report["packed direct"] = {"bits": BITS, "rounds": R, "bit_for_bit": True,
                               "uplink_bytes_a_round": direct.round_extras[0]["uplink_bytes"]}
    log(f"[5g] packed-direct at {BITS} bits == unpack at intake, bit for bit, {R} rounds")
    del direct

    # (c) the budget halt: exactly at exhaustion, then every submit refused
    acc = RenyiAccountant(alphas=first.accountant.alphas)
    vec = first._eps_vector(ROWS)
    at, after = (acc.projected_dp_epsilon(first.budget_delta, vec, rounds)[0]
                 for rounds in (AGG_HALT, AGG_HALT + 1))
    budget = at + (after - at) / 2
    halting = server(queue_limit=len(batches), budget_eps=budget)

    def halt_run():
        for b in batches:
            halting.submit(b, block=False)
        halting.drain()

    counted("[5g] budget halt", {"unpack_flat": AGG_HALT * ROWS}, halt_run)
    snap = halting.snapshot()
    if not (snap["halted"] and snap["rounds_served"] == AGG_HALT and snap["eps_spent"] <= budget
            and not halting.submit(batches[0], block=False)):
        raise AssertionError(f"[5g] budget halt: {snap}")
    report["budget halt"] = {"budget_eps": budget, "rounds": snap["rounds_served"],
                             "eps_spent": snap["eps_spent"],
                             "batches_rejected": halting.batches_rejected}
    log(f"[5g] budget halt: {snap['rounds_served']} rounds, eps_spent {snap['eps_spent']} of "
        f"{budget}, further submits refused")
    del halting

    # (d) a checkpoint resumes, and the resumed server continues identically
    resumed = server(queue_limit=len(batches), ckpt_dir=out_dir)
    if resumed.resume(H) != H:
        raise AssertionError("[5g] resumed at the wrong round")

    def resume_run():
        for b in batches[H * per_round:]:
            resumed.submit(b)
        resumed.drain()

    counted("[5g] resumed", {"unpack_flat": (R - H) * ROWS}, resume_run)
    if not (torch.equal(resumed.flat, first.flat) and resumed.realized_n == first.realized_n
            and all(np.array_equal(a, b) for a, b in zip(resumed.accountant.history,
                                                       first.accountant.history))):
        raise AssertionError("[5g] the resumed server differs from the uninterrupted one")
    log(f"[5g] resumed at {H} of {R}: parameters and accountant bit for bit")
    del resumed

    # (e) reported: rounds served a second through the service thread in
    # steady serve, packed against dense uplink, the payloads made
    # beforehand and cycled
    forms = {"packed": batches,
             "dense": [[dataclasses.replace(u, payload=u.payload.unpack()) for u in b]
                       for b in batches]}
    rates = {name: [] for name in forms}
    uplink = {}
    clock_rounds = AGG_CYCLES * R
    for _ in range(AGG_REPS):
        for name, form in forms.items():
            srv = server(queue_limit=AGG_QUEUE)
            seconds, timed, _ = serve(
                srv, lambda submit: [submit(b) for b in form * AGG_CYCLES], clock_rounds)
            rates[name].append(timed / seconds)
            uplink[name] = srv.round_extras[0]["uplink_bytes"]
    report["clock"] = {
        "rounds": clock_rounds, "card": card,
        "uplink_bytes_a_round": uplink,
        "rounds_per_s": {name: {"median": statistics.median(v), "min": min(v), "max": max(v),
                                "reps": len(v), "each": v} for name, v in rates.items()}}
    log(f"[5g] packed service {R} rounds: SecAgg sums == host sums, CPU replay within the "
        f"1-ULP contract (bit for bit: {report['packed service']['cpu_replay_bit_for_bit']})")
    log(f"[5g] rounds served/s in steady serve (of {clock_rounds}, the rounds after the "
        f"first a poll sees, median of {AGG_REPS}): packed "
        f"{report['clock']['rounds_per_s']['packed']['median']}, dense "
        f"{report['clock']['rounds_per_s']['dense']['median']}; uplink bytes a round: packed "
        f"{uplink['packed']}, dense {uplink['dense']}; nvidia-smi: {card}")
    return report


def lm_task(torch, FedConfig, run, card: str) -> tuple[dict, object]:
    """Phase 5h (a): the lm task on the card. Each of the ten reduced
    configs, fused packed (rqm, the wire packed on auto), LM_ROUNDS rounds
    on graphed scan and eager perround: parameters and sums bit for bit,
    the held-out loss finite and its perplexity reported. For mamba2-370m
    also: materialized graphed scan, perround, a one-rank NCCL shard and
    the async plain corner, all equal to the fused runs; pbm and qmgeo
    fused (graphed and eager) and materialized (graphed), equal; the host
    engine under dropout, held to scan as phase 5e holds it; and the
    graphed round's rounds/s, fused packed and materialized, over
    LM_CLOCK_REPS blocks of LM_CLOCK_ROUNDS under
    set_sync_debug_mode("error"). Lines start with [5h]. Returns the
    report and the clocked fused packed trainer (phase 6 profiles it)."""
    import numpy as np

    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.fed.trainer import FedTrainer

    R = LM_ROUNDS
    base = FedConfig(num_clients=LM_CLIENTS, fused_rounds=True, collect_sums=True)

    def packed(name, dev):
        return {f"{name}_round_sum_packed{dev}": R, "unpack_decode_apply": R, "unpack_flat": R}

    def check_eval(tr, tag) -> dict:
        ev = tr.evaluate()
        if not (math.isfinite(ev["loss"]) and math.isfinite(ev["ppl"]) and ev["ppl"] > 1.0):
            raise AssertionError(f"{tag}: held-out loss {ev['loss']}, ppl {ev['ppl']}")
        return ev

    report: dict = {"archs": {}, "rounds": R, "clients": LM_CLIENTS,
                    "cohort": base.clients_per_round}
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(base, task=f"lm:model={arch}")
        tag = f"[5h] {arch}"
        scan = run(SPECS["rqm"], cfg, packed("rqm", "_dev"), f"{tag} scan fused packed", R)
        per = run(SPECS["rqm"], dataclasses.replace(cfg, engine="perround"), packed("rqm", ""),
                  f"{tag} perround fused packed", R)
        same_runs(torch, {f"{tag} scan": scan, f"{tag} perround": per},
                  f"{tag}: graphed scan and perround, fused packed")
        ev = check_eval(scan, tag)
        report["archs"][arch] = {"dim": scan.flat.numel(), "pack_bits": scan.pack_bits,
                                 "eval_loss": ev["loss"], "eval_ppl": ev["ppl"],
                                 "eval_tokens": ev["eval_tokens"]}
        log(f"{tag}: dim {scan.flat.numel()}, {R} rounds graphed == eager, held-out loss "
            f"{ev['loss']}, ppl {ev['ppl']}")
        if arch == LM_ARCH:
            fused_scan = scan
        del scan, per

    # mamba2-370m: the other paths, engines and mechanisms, against the fused run
    cfg = dataclasses.replace(base, task=f"lm:model={LM_ARCH}")
    mat = dataclasses.replace(cfg, fused_rounds=False)
    tag = f"[5h] {LM_ARCH}"
    runs = {
        "scan fused packed": fused_scan,
        "scan materialized": run(SPECS["rqm"], mat, {"rqm_quantize_dev": R},
                                 f"{tag} scan materialized", R),
        "perround materialized": run(SPECS["rqm"], dataclasses.replace(mat, engine="perround"),
                                     {"rqm_quantize": R}, f"{tag} perround materialized", R),
        "shard": run(SPECS["rqm"], dataclasses.replace(mat, engine="shard", shards=1),
                     {"rqm_quantize": R, "pack_flat": R, "unpack_flat": R}, f"{tag} shard", R),
        "async plain corner": run(SPECS["rqm"], dataclasses.replace(mat, engine="async"),
                                  {"rqm_quantize": R}, f"{tag} async plain corner", R),
    }
    if not runs["async plain corner"].engine._plain:
        raise AssertionError(f"{tag}: the async run is not the plain corner")
    same_runs(torch, {f"{tag} {k}": v for k, v in runs.items()},
              f"{tag}: fused == materialized, graphed scan == perround == one-rank NCCL shard "
              "== async plain corner")
    del runs
    for name, fused_expect in (("pbm", lambda dev: {f"pbm_round_sum_dense{dev}": R}),
                               ("qmgeo", lambda dev: packed("qmgeo", dev))):
        mech_runs = {
            "scan fused": run(SPECS[name], cfg, fused_expect("_dev"), f"{tag} {name} scan fused", R),
            "perround fused": run(SPECS[name], dataclasses.replace(cfg, engine="perround"),
                                  fused_expect(""), f"{tag} {name} perround fused", R),
            "scan materialized": run(SPECS[name], mat, {f"{name}_quantize_dev": R},
                                     f"{tag} {name} scan materialized", R),
        }
        same_runs(torch, {f"{tag} {name} {k}": v for k, v in mech_runs.items()},
                  f"{tag} {name}: graphed scan == perround, fused == materialized")
        report[f"{name}_eval_loss"] = check_eval(mech_runs["scan fused"], tag)["loss"]
        del mech_runs
    # the host engine replays the round stream's draws under heterogeneous cohorts
    hetero = dataclasses.replace(mat, dropout=LM_DROPOUT)
    scan_h = run(SPECS["rqm"], hetero, {"rqm_quantize_dev": R}, f"{tag} scan dropout", R)
    host = run(SPECS["rqm"], dataclasses.replace(hetero, engine="host"), {"rqm_quantize": R},
               f"{tag} host dropout", R)
    if host.realized_n != scan_h.realized_n or not all(
            np.array_equal(a, b) for a, b in zip(host.accountant.history,
                                                 scan_h.accountant.history)):
        raise AssertionError(f"{tag} host: realized sizes or eps history differ from scan's")
    diff = float((host.flat - scan_h.flat).abs().max())
    if diff > 1e-5:  # phase 5e's tolerance for the host engine against scan
        raise AssertionError(f"{tag} host: parameters {diff} from scan's")
    report["host"] = {"realized_n": host.realized_n, "max_abs_diff_from_scan": diff,
                      "bit_for_bit": bool(torch.equal(host.flat, scan_h.flat))}
    log(f"{tag}: host == scan under dropout {LM_DROPOUT} in realized sizes "
        f"{host.realized_n} and eps history; parameters {diff} apart "
        f"(bit for bit: {report['host']['bit_for_bit']})")
    del host, scan_h

    # rounds/s of the graphed round, no sums kept
    rates, clocked = {}, {}
    for path, c in (("fused packed", cfg), ("materialized", mat)):
        tr = FedTrainer(SPECS["rqm"], dataclasses.replace(
            c, collect_sums=False, scan_block=LM_CLOCK_ROUNDS), device="cuda")
        tr.run_block(1)  # capture
        each = []
        for _ in range(LM_CLOCK_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                tr.run_block(LM_CLOCK_ROUNDS)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            each.append(LM_CLOCK_ROUNDS / (time.perf_counter() - t0))
        rates[path] = {"median": statistics.median(each), "min": min(each), "max": max(each),
                       "reps": len(each), "each": each}
        clocked[path] = tr
        del tr
    report["clock"] = {"arch": LM_ARCH, "rounds": LM_CLOCK_ROUNDS, "sync_debug_mode": "error",
                       "rounds_per_s": rates, "nvidia_smi": card}
    log(f"{tag}: graphed rounds/s (median of {LM_CLOCK_REPS} x {LM_CLOCK_ROUNDS}): fused packed "
        f"{rates['fused packed']['median']}, materialized {rates['materialized']['median']}; "
        f"nvidia-smi: {card}")
    return report, clocked["fused packed"]


def lm_full_width(torch, counted, card: str) -> dict:
    """Phase 5h (b): the full-width mamba2-370m (LM_FULL_DIM parameters,
    random from a seed) on the card: its loss and flat gradient
    (``torch.func.grad``, the round's client gradient) of one client at
    seq_len 64 and batch 2, timed (CUDA events) and its peak memory; then
    two such clipped gradients (two token batches) through the round's
    kernels, counted: rqm_round_sum_dense (RNG counters row * dim + c
    below 2**32 at rows 0-1) and decode_apply_sum, each held bit for bit
    against its plain version run in column chunks of LM_FULL_CHUNK."""
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import ravel
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.eval.lm_eval import batch_to
    from repro_torch.fed import cohort
    from repro_torch.kernels import decode_apply_kernel, rqm_kernel
    from repro_torch.kernels.prng import MASK32
    from repro_torch.models import model
    from repro_torch.models.common import ParallelCtx

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    flat, unravel = ravel(params)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dim = flat.numel()
    if dim != LM_FULL_DIM:
        raise AssertionError(f"[5h] full width: {dim} parameters, expected {LM_FULL_DIM}")
    pipe = TokenPipeline(cfg, 64, 2, seed=0, branch=4)
    batches = [batch_to(pipe.batch(i), "cuda") for i in range(2)]

    def loss(f, batch):
        return model.loss_fn(unravel(f), cfg, ParallelCtx(), batch)[0]

    grad_and_loss = torch.func.grad_and_value(loss)
    mech = make_mechanism(SPECS["rqm"])
    grads, losses, ms, peak_above = [], [], [], []
    for batch in batches:  # the first includes the warm-up
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g, value = grad_and_loss(flat, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        peak_above.append(torch.cuda.max_memory_allocated() - before)
        grads.append(g.clamp_(-mech.clip, mech.clip))
        losses.append(float(value))
        del g
    if not all(math.isfinite(v) for v in losses) or not all(
            bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError(f"[5h] full width: loss {losses} or a gradient is not finite")
    x = torch.stack(grads)
    del grads
    weights = torch.ones(2, dtype=torch.int32, device="cuda")
    seed = cohort.draw_seed(torch.Generator().manual_seed(5))
    lr = 0.5
    out = {}

    def kernels():
        out["sum"] = mech.quantize_sum_batch(x, seed, weights=weights)
        out["new"] = decode_apply_kernel.decode_apply_sum(flat, out["sum"], mech.params, 2, lr)

    counted("[5h] full width", {"rqm_round_sum_dense": 1, "decode_apply_sum": 1}, kernels)
    z_sum, new = out["sum"], out["new"]
    k_ms = {}
    for name, fn in (("rqm_round_sum_dense", lambda: mech.quantize_sum_batch(x, seed,
                                                                             weights=weights)),
                     ("decode_apply_sum", lambda: decode_apply_kernel.decode_apply_sum(
                         flat, z_sum, mech.params, 2, lr))):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        k_ms[name] = start.elapsed_time(end)
    # the plain versions, column chunk by column chunk, on the card
    rows = torch.arange(2, dtype=torch.int64, device="cuda")[:, None]
    if (2 * dim - 1) > MASK32:
        raise AssertionError("[5h] full width: the counters of rows 0-1 pass 2**32")
    t0 = time.perf_counter()
    bad_sum = bad_new = draws = 0
    m = mech.params.m
    for c0 in range(0, dim, LM_FULL_CHUNK):
        c1 = min(c0 + LM_FULL_CHUNK, dim)
        cols = torch.arange(c0, c1, dtype=torch.int64, device="cuda")
        counters = rows * dim + cols[None]
        xc = x[:, c0:c1].contiguous()
        levels = rqm_kernel.rqm_encode_counters(xc, seed, counters, mech.params)
        plain_sum = levels.to(torch.int64).sum(0).to(torch.int32)
        bad_sum += int((plain_sum != z_sum[c0:c1]).sum())
        plain_new = decode_apply_kernel.decode_apply_plain(flat[c0:c1], z_sum[c0:c1],
                                                           mech.params, 2, lr)
        bad_new += int((plain_new != new[c0:c1]).sum())
        for r in range(2):  # the draws the encode needs (rqm_needed_draws, by chunk)
            j, i_lo, i_hi, p_up = rqm_kernel.rqm_bracket(xc[r], seed, counters[r], mech.params)
            down = torch.where(i_lo > 0, j - i_lo + 1, j)
            up = torch.where(i_hi < m - 1, i_hi - j, m - 2 - j)
            draws += int((down + up).sum()) + int(((p_up > 0) & (p_up < 1)).sum())
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if bad_sum or bad_new:
        raise AssertionError(f"[5h] full width: {bad_sum} sums and {bad_new} parameters differ "
                             f"from the plain versions")
    report = {"arch": LM_ARCH, "dim": dim, "leaves": len(unravel.shapes),
              "init_s": init_s, "loss": losses, "grad_ms": ms,
              # each gradient's peak above what was allocated as it began
              "grad_peak_above_bytes": peak_above, "params_bytes": 4 * dim,
              "kernel_ms": k_ms,
              # x and the weights read, the sum written; w and the sum read, w' written
              "bound_ms": {"rqm_round_sum_dense": bound(4 * 2 * dim + 8 + 4 * dim, draws),
                           "decode_apply_sum": bound(12 * dim)},
              "needed_draws": draws, "plain_chunked_s": plain_s, "plain_chunk": LM_FULL_CHUNK,
              "sum_equal": True, "params_equal": True, "nvidia_smi": card}
    log(f"[5h] full width {LM_ARCH}: {dim} parameters, loss {losses}, grad ms {ms}, peak "
        f"above the allocated {peak_above} B; rqm_round_sum_dense "
        f"{k_ms['rqm_round_sum_dense']} ms and decode_apply_sum {k_ms['decode_apply_sum']} ms "
        f"at dim {dim} == their plain versions bit for bit; nvidia-smi: {card}")
    return report


def serve_gates(torch, model, cfg, params, toks, pe, gen, tag: str) -> dict:
    """Phase 5i's gates on one generation ``gen`` (B, k) of prompt
    ``toks`` (+ ``pe``): every token in [0, padded_vocab); the prefill's
    token == the argmax of forward_hidden's last position; the first
    decoded token == the argmax of a teacher-forced forward over prompt +
    1. Returns the two gates' top-2 logit margins (their smallest)."""
    from repro_torch.models.common import ParallelCtx, rms_norm

    ctx = ParallelCtx()
    vocab = cfg.padded_vocab(1)
    if not bool(((gen >= 0) & (gen < vocab)).all()):
        raise AssertionError(f"{tag}: a token outside [0, {vocab})")
    seq = torch.cat([toks, gen[:, :1]], 1)
    h, _ = model.forward_hidden(params, cfg, ctx, seq, pe)
    h = rms_norm(h[:, -2:], params["final_norm"])
    margins = {}
    for i, what in enumerate(("prefill == forward", "decode == teacher-forced")):
        want = model.lm_head_argmax(params, ctx, h[:, i])
        if not torch.equal(want, gen[:, i]):
            raise AssertionError(f"{tag}: {what}: {gen[:, i].tolist()} != {want.tolist()}")
        logits = h[:, i] @ params["lm_head"][:, 0]
        top2 = torch.topk(logits, 2, dim=-1).values
        margins[what] = float((top2[:, 0] - top2[:, 1]).min())
    return margins


def no_drop(cfg):
    """A MoE config at capacity T * top_k: its training forward then drops
    no token, as decode never does (the teacher-forced gate's forward
    would otherwise drop tokens that the decode step keeps)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def serve_reduced(torch, card: str) -> dict:
    """Phase 5i (a): each reduced config served on the card (SERVE_BATCH x
    SERVE_PROMPT, capacity SERVE_CAP, prefill then SERVE_STEPS decode
    steps; pixtral and musicgen with prefix embeddings; the MoE configs
    at a capacity that drops nothing), and reduced gemma3 at a prompt of
    SERVE_LONG_PROMPT past its window of 64 (prefill's re-lay, the ring):
    ``serve_gates`` on each."""
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.launch.serve import generate, synthetic_prompt
    from repro_torch.models import model

    report = {}
    cases = [(arch, SERVE_PROMPT) for arch in ARCH_IDS] + [("gemma3-4b", SERVE_LONG_PROMPT)]
    for arch, prompt in cases:
        cfg = no_drop(get_config(arch, reduced=True))
        tag = f"[5i] {arch} reduced, prompt {prompt}"
        params = model.init_params(torch.Generator("cuda").manual_seed(0), cfg, device="cuda")
        toks, pe = synthetic_prompt(cfg, SERVE_BATCH, prompt,
                                    torch.Generator("cuda").manual_seed(1), "cuda")
        gen, caches, t_prefill, t_decode = generate(
            params, cfg, toks, SERVE_STEPS + 1, pe, capacity=prompt + SERVE_CAP - SERVE_PROMPT)
        windows = [c["k"].shape[3] for c in caches if "k" in c]
        margins = serve_gates(torch, model, cfg, params, toks, pe, gen, tag)
        report[f"{arch}@{prompt}"] = {"tokens": gen.cpu().tolist(), "cache_slots": windows,
                                      "prefill_s": t_prefill, "decode_s": t_decode,
                                      "margins": margins}
        log(f"{tag}: prefill + {SERVE_STEPS} decode steps, cache slots {windows}, gates held "
            f"(top-2 margins {margins})")
        del params, caches
    report["nvidia_smi"] = card
    return report


def issuer_mode(torch):
    """A torch-function mode that runs each torch call made by the port
    inside a profiler range named ``@file:line function`` of its
    innermost ``repro_torch`` frame, so that a trace can say which
    source line issued each kernel (``launches_by_issuer``)."""
    from torch.overrides import TorchFunctionMode

    class Issuer(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            f = sys._getframe(1)
            while f is not None and "repro_torch/" not in f.f_code.co_filename:
                f = f.f_back
            where = ("@outside repro_torch" if f is None else
                     f"@{f.f_code.co_filename.split('repro_torch/')[-1]}:{f.f_lineno} "
                     f"{f.f_code.co_name}")
            with torch.profiler.record_function(where):
                return func(*args, **(kwargs or {}))

    return Issuer()


def launches_by_issuer(prof) -> tuple:
    """The device activities of a CPU + CUDA trace, each kernel counted
    against the outermost operator that launched it and against the
    ``issuer_mode`` range around that operator: (device activities,
    {operator: kernels}, {source line: kernels}), largest first."""
    from collections import Counter

    by_op, by_line, total = Counter(), Counter(), 0
    for e in prof.events():
        if str(e.device_type).endswith("CUDA") and not e.name.startswith("@"):
            total += 1  # not the ranges' own device-side annotations
        if not e.kernels or e.name.startswith("@"):
            continue
        op, up = e.name, e.cpu_parent
        while up is not None and up.name.startswith("aten::"):
            op, up = up.name, up.cpu_parent
        while up is not None and not up.name.startswith("@"):
            up = up.cpu_parent
        by_op[op] += len(e.kernels)
        by_line["no issuer range" if up is None else up.name[1:]] += len(e.kernels)
    return total, dict(by_op.most_common()), dict(by_line.most_common())


def serve_full_width(torch, arch: str, batch: int, prompt: int, gen_len: int, want_params: int,
                     card: str) -> dict:
    """Phase 5i (b), (c): ``arch`` at full width, random from a CUDA
    generator: init seconds, prefill ms and tokens/s, decode ms a step
    (CUDA events, median of the steps after the first) and tokens/s, the
    host's dispatch ms a step (its clock around each call, no
    synchronisation), device busy ms a step (torch.profiler over the last
    SERVE_PROFILED steps, with its launches and largest kernels), peak
    memory above what was allocated as it
    began (parameters included); gate: the first decoded token ==
    the teacher-forced forward over prompt + 1 (and prefill == forward).
    The step's bound: every weight but the embedding table read once, and
    every cache read once, over HBM's rate (its float32 operations, 2 a
    weight a token over 67 TFLOP/s, are below it)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import leaves
    from repro_torch.launch.serve import synthetic_prompt
    from repro_torch.models import model
    from repro_torch.models.common import ParallelCtx

    tag = f"[5i] {arch} full width"
    cfg = get_config(arch)
    ctx = ParallelCtx()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()  # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator("cuda").manual_seed(0), cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    if n_params != want_params:
        raise AssertionError(f"{tag}: {n_params} parameters, expected {want_params}")
    toks, pe = synthetic_prompt(cfg, batch, prompt, torch.Generator("cuda").manual_seed(1), "cuda")
    shape = InputShape("serve", prompt + gen_len, batch, "decode")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(gen_len + 1)]
    ev[0].record()
    nxt, caches = model.prefill(params, cfg, ctx, toks, shape, pe)
    ev[1].record()
    generated, host_ms = [nxt], []
    timed = gen_len - 1 - SERVE_PROFILED
    for i in range(timed):
        h0 = time.perf_counter()
        nxt, caches = model.decode_step(params, caches, cfg, ctx, nxt[:, None], prompt + i)
        host_ms.append((time.perf_counter() - h0) * 1e3)
        ev[i + 2].record()
        generated.append(nxt)
    torch.cuda.synchronize()
    prefill_ms = ev[0].elapsed_time(ev[1])
    step_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(timed)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(timed, gen_len - 1):
            nxt, caches = model.decode_step(params, caches, cfg, ctx, nxt[:, None], prompt + i)
            generated.append(nxt)
        torch.cuda.synchronize()
    by_kernel = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    busy_ms = sum(e.device_time_total for e in by_kernel) / 1e3 / SERVE_PROFILED
    # device activities only: the trace also holds the host's runtime calls
    launches_per_step = sum(str(e.device_type).endswith("CUDA")
                            for e in prof.events()) / SERVE_PROFILED
    top = {demangle(e.key)[:80]: e.device_time_total / 1e3 / SERVE_PROFILED
           for e in by_kernel[:6]}
    # one more step (the caches' last position; its token is not kept):
    # who issues the launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with issuer_mode(torch):
            model.decode_step(params, caches, cfg, ctx, nxt[:, None], prompt + gen_len - 1)
        torch.cuda.synchronize()
    traced, by_op, by_line = launches_by_issuer(prof)
    peak = torch.cuda.max_memory_allocated() - start_bytes  # parameters included
    gen = torch.stack(generated, 1)
    margins = serve_gates(torch, model, cfg, params, toks, pe, gen, tag)
    cache_bytes = sum(t.numel() * t.element_size() for c in caches for t in c.values())
    weight_bytes = 4 * (n_params - params["embed"].numel())
    step_bound = bound(weight_bytes + cache_bytes)
    steady = step_ms[1:]
    decode_ms = statistics.median(steady)
    report = {"arch": arch, "params": n_params, "leaves": len(leaves(params)),
              "batch": batch, "prompt": prompt, "generated": gen_len, "init_s": init_s,
              "prefill_ms": prefill_ms, "prefill_tok_per_s": batch * prompt / prefill_ms * 1e3,
              "decode_ms_per_step": decode_ms, "decode_ms_min": min(steady),
              "decode_ms_max": max(steady), "first_step_ms": step_ms[0],
              "decode_tok_per_s": batch / decode_ms * 1e3,
              "host_dispatch_ms_per_step": statistics.median(host_ms[1:]),
              "device_busy_ms_per_step": busy_ms, "profiled_steps": SERVE_PROFILED,
              "device_launches_per_step": launches_per_step, "top_kernels_ms_per_step": top,
              "layers": len(cfg.layers), "traced_step_launches": traced,
              "launches_by_op": by_op, "launches_by_line": by_line,
              "weight_bytes": weight_bytes, "cache_bytes": cache_bytes,
              "bound_ms": step_bound[0], "bound_by": step_bound[1],
              "peak_bytes_above_start": peak, "margins": margins, "sample": gen[0, :16].tolist(),
              "nvidia_smi": card}
    log(f"{tag}: {n_params} parameters, init {init_s} s; prefill {batch}x{prompt} "
        f"{prefill_ms} ms ({report['prefill_tok_per_s']} tok/s); decode {decode_ms} ms a step "
        f"(median of {len(steady)}; {report['decode_tok_per_s']} tok/s), host dispatch "
        f"{report['host_dispatch_ms_per_step']} ms, device busy {busy_ms} ms in "
        f"{launches_per_step} launches, bound "
        f"{step_bound[0]} ms ({step_bound[1]}: weights {weight_bytes} B + caches "
        f"{cache_bytes} B); peak {peak} B above the start; gates held (margins {margins}); nvidia-smi: {card}")
    log(f"{tag}: one step's {traced} launches over {len(cfg.layers)} layers; by operator "
        f"{dict(list(by_op.items())[:16])}; by source line {dict(list(by_line.items())[:30])}")
    del params, caches
    torch.cuda.empty_cache()
    return report


def serve_single_leaves(torch, counted) -> dict:
    """Phase 5i (d): ``ops.rqm_fast``, ``pbm_fast`` and ``qmgeo_fast`` on a
    1-D leaf (the CNN's flat width) and a 3-D one, and ``rqm_tree`` over
    the CNN's tree (one seed a leaf), counted; then each leaf against its
    plain version on the card and ``<name>_batch`` row 0, and
    ``ref.rqm_ref`` against ``rqm_fast``, bit for bit (those launches
    uncounted)."""
    import numpy as np

    from repro_torch.convert import leaves
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.fed.cnn import cnn_init
    from repro_torch.kernels import ops, pbm_kernel, qmgeo_kernel, ref, rqm_kernel

    rng = np.random.default_rng(11)
    shapes = [(DIM,), (32, 5, 5, 16)]
    xs = [torch.from_numpy(rng.uniform(-0.026, 0.026, size=s).astype(np.float32)).cuda()
          for s in shapes]
    tree = cnn_init(torch.Generator().manual_seed(3), device="cuda")
    seed = int(rng.integers(0, 1 << 32))
    seeds = [(seed + 7919 * i) & 0xFFFFFFFF for i in range(len(leaves(tree)))]
    plains = {"rqm": rqm_kernel.rqm_quantize_plain, "pbm": pbm_kernel.pbm_quantize_plain,
              "qmgeo": qmgeo_kernel.qmgeo_quantize_plain}
    params = {name: make_mechanism(SPECS[name]).params for name in plains}
    out = {}

    def encode():
        for name in plains:
            out[name] = [getattr(ops, f"{name}_fast")(x, seed, params[name]) for x in xs]
        out["tree"] = ops.rqm_tree(tree, seeds, params["rqm"])

    counted("[5i] single leaves", {"rqm_quantize": len(xs) + len(seeds),
                                   "pbm_quantize": len(xs), "qmgeo_quantize": len(xs)}, encode)
    for name, plain in plains.items():
        for x, got in zip(xs, out[name]):
            flat = x.reshape(1, -1)
            if not (got.shape == x.shape
                    and torch.equal(got.reshape(-1), plain(flat, seed, params[name])[0])
                    and torch.equal(got.reshape(-1),
                                    getattr(ops, f"{name}_batch")(flat, seed, params[name])[0])):
                raise AssertionError(f"[5i] {name}_fast on {tuple(x.shape)}: differs from its "
                                     "plain version or the batch's row 0")
    for x, got in zip(xs, out["rqm"]):
        if not torch.equal(ref.rqm_ref(x.reshape(-1), seed, params["rqm"]), got.reshape(-1)):
            raise AssertionError(f"[5i] rqm_ref != rqm_fast on {tuple(x.shape)}")
    for leaf, s, got in zip(leaves(tree), seeds, leaves(out["tree"])):
        want = rqm_kernel.rqm_quantize_plain(leaf.reshape(1, -1), s, params["rqm"])[0]
        if not torch.equal(got.reshape(-1), want):
            raise AssertionError(f"[5i] rqm_tree leaf {tuple(leaf.shape)} != its plain version")
    report = {"shapes": shapes, "tree_leaves": [list(t.shape) for t in leaves(tree)],
              "equal": True}
    log(f"[5i] single leaves: rqm/pbm/qmgeo_fast on {shapes} and rqm_tree over the CNN's "
        f"{len(seeds)} leaves == their plain versions and _batch row 0; rqm_ref == rqm_fast")
    return report


def calibration_report(card: str) -> dict:
    """Phase 5i (e): the paper-cohort calibration on the host (RQM to eps
    20 at delta 1e-5 over 200 rounds of 40, c = 0.02), timed, from an
    empty epsilon cache; a repeat must compute 0 epsilons."""
    from repro_torch.privacy import cache
    from repro_torch.privacy.calibrate import calibrate

    kw = dict(target_eps=20.0, target_delta=1e-5, rounds=200, cohort=40, c=0.02)
    fresh = cache.reset()
    t0 = time.perf_counter()
    res = calibrate("rqm", **kw)
    seconds = time.perf_counter() - t0
    computes = fresh.computes
    t0 = time.perf_counter()
    again = calibrate("rqm", **kw)
    repeat_s = time.perf_counter() - t0
    if fresh.computes != computes or again.value != res.value:
        raise AssertionError(f"[5i] calibration repeat computed {fresh.computes - computes} "
                             "epsilons or moved its value")
    if not 0.99 * 20.0 <= res.epsilon <= 20.0:
        raise AssertionError(f"[5i] calibration missed its window: eps {res.epsilon}")
    report = {"family": "rqm", **kw, "knob": res.knob, "value": res.value, "eps": res.epsilon,
              "alpha": res.alpha, "accountant_evals": res.iterations, "computes": computes,
              "seconds": seconds, "repeat_seconds": repeat_s, "repeat_computes": 0,
              "host": "the chip machine's CPU", "nvidia_smi": card}
    log(f"[5i] calibration: {res.describe()} in {seconds} s ({computes} epsilons computed); "
        f"repeat {repeat_s} s, 0 computed")
    return report


def fill_sources(torch, tr, rounds: int) -> dict:
    """Device ms a round of the fill kernels of an eager round, by the ops
    above each aten::fill_ and its shape (torch.profiler)."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(rounds):
            tr.round()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.events():
        if e.name != "aten::fill_" or not e.device_time_total:
            continue
        chain, parent = [], e.cpu_parent
        while parent is not None and len(chain) < 4:
            chain.append(parent.name)
            parent = parent.cpu_parent
        shape = e.input_shapes[0] if e.input_shapes else None
        out[f"{' < '.join(chain) or 'top'} {shape}"] += e.device_time_total / 1e3 / rounds
    return dict(out.most_common(12))


def fig3_report(torch, FedConfig) -> dict:
    """Phase 7: accuracy and eps(alpha=8) after FIG3_ROUNDS default rounds
    of each mechanism at benchmarks/fig3_fl_emnist.py's FED settings."""
    from repro_torch.fed.trainer import FedTrainer

    out = {}
    for name, spec in SPECS.items():
        t0 = time.perf_counter()
        tr = FedTrainer(spec, FedConfig(**FIG3_FED), device="cuda")
        hist = tr.train(rounds=FIG3_ROUNDS, eval_every=FIG3_ROUNDS, log=lambda msg: None)
        torch.cuda.synchronize()
        out[name] = {"accuracy": hist[-1]["accuracy"], "loss": hist[-1]["loss"],
                     "rdp_eps_alpha8": tr.accountant.rdp_epsilon(8.0),
                     "per_round_eps_alpha8": tr.mech.per_round_epsilon(
                         tr.cfg.clients_per_round, 8.0),
                     "seconds": time.perf_counter() - t0}
        del tr
    acc = {k: v["accuracy"] for k, v in out.items()}
    rqm, pbm = out["rqm"], out["pbm"]
    return {"rounds": FIG3_ROUNDS, "fed": FIG3_FED, "by_mechanism": out,
            "noise_free_ge_rqm_ge_pbm": acc["none"] >= acc["rqm"] >= acc["pbm"],
            # the reference benchmark's own claim (fig3_fl_emnist.py:128)
            "tradeoff_ok": (rqm["accuracy"] >= pbm["accuracy"] - 0.02
                            and rqm["per_round_eps_alpha8"] < pbm["per_round_eps_alpha8"])}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.fed.config import FedConfig
    from repro_torch.kernels import _build, ops

    # full float32 everywhere, and reproducible gradients
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    card = nvidia_smi()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {card}")
    log(f"[env] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {sorted(_build.SOURCES)} in {time.perf_counter() - t0:.3f} s "
        f"({len(logs)} compiled) into {_build.BUILD_DIR}")
    for name, out in logs.items():
        entry = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = demangle(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}: {entry}: {line.strip()}")

    records = check_kernels(torch, np)
    counts: dict = {}  # launches by entry, summed over the main-path runs
    paths: dict = {}  # the runs that launched each entry

    def run(spec, cfg, expect, tag, rounds=ROUNDS):
        tr, run_counts = run_path(torch, spec, cfg, expect, tag, rounds)
        for k, v in run_counts.items():
            counts[k] = counts.get(k, 0) + v
            paths.setdefault(k, []).append(tag)
        return tr

    # Phases 4-5b keep every round's sum (collect_sums), so that runs
    # compare sums as well as parameters, but for phase 5's FedConfig()
    # runs, which compare parameters. The scan engine's runs are graphed
    # and launch the _dev entries; perround and shard run eagerly and
    # launch the by-value ones.
    R = ROUNDS
    kept = FedConfig(collect_sums=True)
    perround = dataclasses.replace(kept, engine="perround")
    fused = dataclasses.replace(perround, fused_rounds=True)
    fused_dense = dataclasses.replace(fused, wire_packed=False)
    scan_fused = dataclasses.replace(kept, fused_rounds=True)
    scan_fused_dense = dataclasses.replace(scan_fused, wire_packed=False)

    def packed_expect(name, dev):
        return {f"{name}_round_sum_packed{dev}": R, "unpack_decode_apply": R, "unpack_flat": R}

    def dense_expect(name, dev):
        return ({f"{name}_round_sum_dense{dev}": R} if name == "pbm" else
                {f"{name}_round_sum_dense{dev}": R, "decode_apply_sum": R})

    # phase 4: the fused paper round, packed and dense wire, perround and scan
    rqm_fused = {
        "rqm fused packed": run(SPECS["rqm"], fused, packed_expect("rqm", ""),
                                "rqm fused packed"),
        "rqm fused dense": run(SPECS["rqm"], fused_dense, dense_expect("rqm", ""),
                               "rqm fused dense"),
        "rqm scan fused packed": run(SPECS["rqm"], scan_fused, packed_expect("rqm", "_dev"),
                                     "rqm scan fused packed"),
        "rqm scan fused dense": run(SPECS["rqm"], scan_fused_dense,
                                    dense_expect("rqm", "_dev"), "rqm scan fused dense"),
    }
    same_runs(torch, rqm_fused, "packed and dense wire, perround and graphed scan")
    fused_profiled = rqm_fused["rqm scan fused packed"]

    # phase 5: the reference's default round for every Fig. 3 mechanism,
    # graphed, against the perround engine; the same round keeping its
    # sums against the perround engine's and the fused rounds the
    # mechanism has, each both eager and graphed
    fused_paths = {
        "pbm": {"pbm fused dense": (fused, dense_expect("pbm", "")),
                "pbm scan fused dense": (scan_fused, dense_expect("pbm", "_dev"))},
        "qmgeo": {"qmgeo fused packed": (fused, packed_expect("qmgeo", "")),
                  "qmgeo fused dense": (fused_dense, dense_expect("qmgeo", "")),
                  "qmgeo scan fused packed": (scan_fused, packed_expect("qmgeo", "_dev")),
                  "qmgeo scan fused dense": (scan_fused_dense, dense_expect("qmgeo", "_dev"))},
    }
    default_trainers, kept_trainers = {}, {}
    for name, spec in SPECS.items():
        quantize = {} if name == "none" else {f"{name}_quantize": R}
        dev = {f"{k}_dev": v for k, v in quantize.items()}
        default = run(spec, FedConfig(), dev, f"{name} default")
        runs = {f"{name} scan sums": run(spec, kept, dev, f"{name} scan sums"),
                f"{name} perround": run(spec, perround, quantize, f"{name} perround")}
        same_runs(torch, {f"{name} default": default, f"{name} perround":
                          runs[f"{name} perround"]}, f"{name}: FedConfig(), graphed scan "
                  "and perround", sums=False)
        others = rqm_fused if name == "rqm" else {
            tag: run(spec, cfg, fused_expect, tag)
            for tag, (cfg, fused_expect) in fused_paths.get(name, {}).items()}
        same_runs(torch, {**runs, **others}, f"{name} keeping sums: graphed scan, perround"
                  + (", materialized and fused" if others else ""))
        if name != "rqm":  # phase 6 profiles them; rqm's default is phase 5c's
            default_trainers[name] = default
        kept_trainers[name] = runs[f"{name} scan sums"]
        del default, runs, others
    del rqm_fused

    # phase 5b: the shard engine at one NCCL rank, against phase 5's runs
    shard = dataclasses.replace(kept, engine="shard", shards=1)
    codec = {"pack_flat": R, "unpack_flat": R}
    shard_profiled = None
    for name, spec in SPECS.items():
        expect = {} if name == "none" else {f"{name}_quantize": R, **codec}
        tr = run(spec, shard, expect, f"{name} shard")
        same_runs(torch, {f"{name} scan sums": kept_trainers[name], f"{name} shard": tr},
                  f"{name}: graphed scan and shard")
        if name == "rqm":
            shard_profiled = tr
        del tr
    rqm_shard = {
        "rqm shard": shard_profiled,
        "rqm shard unpacked": run(SPECS["rqm"], dataclasses.replace(shard, shard_packed=False),
                                  {"rqm_quantize": R}, "rqm shard unpacked"),
        "rqm shard stream": run(SPECS["rqm"], dataclasses.replace(shard, staging="stream"),
                                {"rqm_quantize": R, **codec}, "rqm shard stream"),
        "rqm shard fused packed": run(
            SPECS["rqm"], dataclasses.replace(shard, fused_rounds=True),
            packed_expect("rqm", ""), "rqm shard fused packed"),
        "rqm shard fused dense": run(
            SPECS["rqm"], dataclasses.replace(shard, fused_rounds=True, wire_packed=False),
            {"rqm_round_sum_dense": R, **codec, "decode_apply_sum": R},
            "rqm shard fused dense"),
    }
    same_runs(torch, {"rqm scan sums": kept_trainers["rqm"], **rqm_shard},
              "rqm: graphed scan and shard (packed, unpacked, streamed, fused)")
    del rqm_shard, kept_trainers

    # phase 5c: the round on the host's clock, no profiler running
    clock, clocked = host_clock(torch, FedConfig)
    log(json.dumps({"host_clock": clock}))

    # phase 5d: telemetry, checkpoint/resume, the stateful optimizers and
    # the budget halt, each run counted
    def counted(tag, expect, fn):
        """``fn``'s launches, which must be ``expect`` (any, where None)."""
        ops.reset_launches()
        fn()
        torch.cuda.synchronize()
        got = dict(ops.launches)
        if expect is not None and got != expect:
            raise AssertionError(f"{tag}: launch counts {got}, expected {expect}")
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
            paths.setdefault(k, []).append(tag)

    report = services(torch, FedConfig, counted, card)
    tracked = report.pop("tracked_clock")
    log(json.dumps({"services": report}))
    log(json.dumps({"tracked_clock": tracked}))
    log(f"[5d] tracked vs noop rounds/s (median): json "
        f"{tracked['rounds_per_s']['json']['median']}, noop "
        f"{tracked['rounds_per_s']['noop']['median']}; phase 5c graphed scan "
        f"{clock['rounds_per_s']['scan']['median']}; nvidia-smi: {card}")

    # phase 5e: heterogeneous cohorts, each run counted
    hetero, poisson = hetero_cohorts(torch, FedConfig, run, counted, clock, card)
    log(json.dumps({"hetero": hetero}))

    # phase 5f: the async engine, each run counted
    log(json.dumps({"async": async_engine(torch, FedConfig, run, counted, clock, card)}))

    # phase 5g: the aggregator round-server, each gated run counted
    log(json.dumps({"aggregator": aggregator(torch, counted, card)}))

    # phase 5h: the lm task, every reduced config, and mamba2-370m at full width
    lm_report, lm_profiled = lm_task(torch, FedConfig, run, card)
    log(json.dumps({"lm": lm_report}))
    log(json.dumps({"lm_full_width": lm_full_width(torch, counted, card)}))
    torch.cuda.empty_cache()

    # phase 5i: serving (each reduced config; gemma3-4b and zamba2-1.2b at
    # full width), the single-leaf encodes, calibration
    with torch.no_grad():
        log(json.dumps({"serve_reduced": serve_reduced(torch, card)}))
        for arch, (batch, prompt, gen_len, n_params) in SERVE_FULL.items():
            log(json.dumps({"serve_full_width": serve_full_width(
                torch, arch, batch, prompt, gen_len, n_params, card)}))
    log(json.dumps({"single_leaves": serve_single_leaves(torch, counted)}))
    log(json.dumps({"calibration": calibration_report(card)}))

    # phase 6: where a warm round spends device time, FedConfig()'s round
    # for each mechanism (graphed), the graphed fused packed round, the
    # shard round and, eager, the perround engine's
    profiled = {"rqm_default": clocked["scan"]}
    for name, tr in default_trainers.items():
        profiled[f"{name}_default"] = tr
    profiled["rqm_scan_fused_packed_collected"] = fused_profiled
    profiled["rqm_shard_collected"] = shard_profiled
    profiled["rqm_perround"] = clocked["perround"]
    profiled["rqm_poisson_default"] = poisson
    profiled["lm_mamba2_scan_fused_packed"] = lm_profiled
    for tag, tr in profiled.items():
        log(json.dumps({"round_profile": profile_rounds(torch, tr, PROFILE_ROUNDS, tag)}))
    log(json.dumps({"fill_sources": fill_sources(torch, clocked["perround"], PROFILE_ROUNDS)}))
    del profiled, clocked, fused_profiled, shard_profiled, default_trainers, poisson, lm_profiled

    # phase 7: the paper's comparison, reported
    log(json.dumps({"fig3_report": fig3_report(torch, FedConfig)}))

    kernels = []
    for rec in records:
        name = rec["name"]
        if name in NO_PATH:
            if name in counts:
                raise AssertionError(f"{name} launched on a main path: {paths[name]}")
            launches, path = rec["phase3_launches"], None
            log(f"[main] {name}: on no main path ({NO_PATH[name]}); "
                f"{launches} launches in phase 3")
        else:
            launches, path = counts.get(name, 0), paths.get(name)
            if launches == 0:
                raise AssertionError(f"{name} was never launched on a main path")
        log(json.dumps({**rec, "launches": launches, "path": path}))
        kernels.append({k: rec[k] for k in ("name", "route", "source", "replaces")}
                       | {"launches": launches, "path": path}
                       | {k: rec[k] for k in ("max_abs_err", "ms", "ms_by", "plain_ms",
                                              "bound_ms", "bound_by", "library_ms")}
                       | {"floor_ms": rec.get("floor_ms")}
                       # decode_apply's bfloat16 form: time, floor, walks, bound
                       | {k: v for k, v in rec.items() if k.startswith("bf16_")})
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
