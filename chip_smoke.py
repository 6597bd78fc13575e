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
  5j. distributed LM training at tp = 1 (``launch/train.py`` ->
     ``distributed/step.py``: grad -> clip -> the per-leaf quantize
     kernel -> SecAgg sum over the client group -> decode -> optimizer at
     the warmup-cosine rate): (a) reduced gemma3, mamba2 and qwen3-moe
     through the launcher, 3 steps of the plain run, the one-rank NCCL
     plan (``--mesh-shape 1``) and the one-rank packed plan, parameters
     and losses bit for bit, counted: one quantize launch a leaf a step,
     and under packing one pack_flat and one unpack_flat a leaf a step;
     the plain run's first step's levels of every leaf (kept as the step
     made them) == ``<name>_quantize_plain``, and pack_flat/unpack_flat
     of them == their plain versions; mamba2 also with pbm, qmgeo and
     none; (b) ``--resume`` on reduced
     mamba2: 4 steps checkpointed at 2, resumed, bit for bit (parameters,
     optimizer state, losses), sgd and adam; (c) gemma3-4b at full width
     (4,550,996,480 parameters from a CUDA generator), rqm, sgd, batch 2,
     seq 256, 3 steps: the plain step against the one-rank packed plan's,
     bit for bit by per-leaf digests of the bits and the embedding kept
     whole on the host, the loss finite; step ms by CUDA events, tokens/s,
     host dispatch ms a step, and over one more step under
     torch.profiler the device busy ms, launches and the quantize
     kernel's share; peak memory; the bound (6 x matmul parameters x
     tokens over float32's 67 TFLOP/s, or the parameters read and written
     once over 3.35 TB/s, the larger); one more step's rqm_quantize levels
     of the first leaf of each shape (the 671,088,640-coordinate embedding
     among them) == ``rqm_quantize_plain``, and pack_flat/unpack_flat of
     them == their plain versions, in chunks of 2**24 with the chunk's
     counters; (d) reported, not gated: the
     example's ``--compare`` (none, rqm, pbm) on reduced gemma3 for 30
     steps, each final ce; lines start with [5j], reports "train_reduced",
     "train_resume", "train_full_width", "train_compare";
  5k. the model axis (tp > 1): three launches of ranks, subprocesses of
     ``torch.distributed.run`` running this script with ``--tp-worker``,
     all on the one card over gloo (CUDA tensors; NCCL refuses two ranks
     on one device), each rank's runs counted and their counts added to
     the kernels' line: (a) on 2 ranks mesh 1x2, on 4 ranks 2x2 and 1x4
     (reduced chatglm3-6b, H=8 and kv=2: at tp 4 its KV heads on aligned
     pairs, ``subgroup_psum``; reduced mamba2-370m at 1x2 and 2x2, its
     B/C projection replicated), the launcher, rqm, 2 steps, plain and
     packed: packed == plain bit for bit, every replicated or duplicated
     leaf bit-equal across its group, every leaf's first-step levels on
     every rank == rqm_quantize_plain and pack_flat/unpack_flat == their
     plain versions; (b) the shard engine's 2-D lm round on
     tests/fed_lm_2d_checks.py's problem at shards x model_shards 1x2,
     2x1 (2 ranks) and 2x2 (4 ranks), materialized, fused packed and
     fused dense (== bit for bit; each path's first round's kernels,
     rows 1-5 and 8-9, held against their plain versions at its shapes),
     2x2 == 1x2 bit for bit in every round's sum and the parameters, every
     grid accounted at the full cohort, epsilon equal across tp, and on
     each grid with a model axis the tensor-parallel client release at 1
     and 2 local steps on the card == on CPU tensors within 1e-5 of the
     largest (at 2, plus 2 spacings of the parameter); (c)
     gemma3-4b at full width at 1x2 (4,550,996,480 parameters, each rank
     drawing the global tree leaf by leaf and keeping its half), rqm,
     sgd, batch 2 x seq 256, 3 steps: step ms (CUDA events), tokens/s,
     host dispatch ms, one profiled step's device busy ms and launches,
     the model-axis collectives clocked over one more step and an
     all_reduce timed alone, each rank's peak, the first leaf of each
     shape's levels == rqm_quantize_plain; lines start with [5k], report
     "model_axis", files under build/phase5k;
  5l. serving over a mesh, ranks as 5k's (``--serve-worker``), each run
     counted (the serve path launches none of the port's kernels): (a)
     on 2 ranks meshes 2x1 and 1x2, on 4 ranks 2x2, reduced gemma3-4b
     (a window-64 ring and a global layer), h2o-danube-3-4b and
     zamba2-1.2b (SSM states, the shared attention block), float32 and
     int8 caches: batch 4 split over the clients (``make_prefill_step``,
     sequence parallel, then 8 greedy ``make_decode_step`` steps) and
     batch 1 with caches of 128 after a prompt of 96 (the one-rank
     prefill's caches cut by ``convert.cache_from_numpy``,
     flash-decoding), every token == the one-rank ``decode_step``'s,
     exactly; (b) gemma3-4b at full width at long_500k (sequence 524,288,
     batch 1) over 2x1, the global layers' caches sequence-sharded over
     the two ranks and filled block by block from generators keyed on
     the global position, float32 then int8, 8 steps from position
     524,280: tokens and block sums == a one-rank unsharded decode over
     the whole caches (its own process after the ranks, ``--serve-check``),
     hidden states within 1e-4 of the largest; decode ms a step, bound,
     host dispatch and busy ms, the seq collectives a step, peak a rank;
     (c) gemma3-4b at full width at 1x2, this rank's slices of 5i's tree,
     5i's batch 4 and prompt 1280 prefilled (sequence parallel), decode
     teacher-forced on 5i's tokens: every next token == 5i's; ms a step
     beside 5i's, the model axis's collectives a step; lines start with
     [5l], report "serve_mesh", files under build/phase5l;
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
     (reported, not gated);
  5m. the LM steps at the reference's own precision and memory options,
     last (so that (c)'s two ranks find the card as free as it gets): (a)
     on 4 ranks as 5k's (``--opt-worker variants``), reduced gemma3-4b
     and mamba2-370m at 2x2, float32, tests/sharded_checks.py's
     ``check_perf_variants`` cases (base, int16 aggregation, int8
     sequence-parallel gathers, ZeRO-1 with ``agg_dtype="auto"``), 3
     steps on one batch each, counted (``rqm_quantize`` once a leaf a
     step): int16 == base bit for bit, ZeRO-1 within 2e-3 of base, every
     loss finite and falling; (b) 5j (c)'s full-width step in bfloat16
     with remat (float32 parameters), its first loss within 1e-2 of 5j's
     float32 one: ms a step and tokens/s beside the bfloat16 bound, host
     dispatch, one profiled step's busy ms and launches, peak beside the
     memory model's estimate; (c) on 2 ranks (``--opt-worker zero1
     <layers>``) ZeRO-1 with bfloat16 parameters and compute over 2x1 at
     full width (at 12 layers if twice the estimate a rank and this
     process's memory do not fit the free card, said on the line): losses,
     ms a step, peak a rank beside the estimate; (d) 5i's gemma3-4b
     decode in bfloat16 (parameters, compute, caches): ms a step, peak,
     tokens equal to 5i's float32 ones (reported); lines start with [5m],
     report "opt_steps", files under build/phase5m;
  5n. the dry run (``launch/dryrun.py`` on the meta device) against the
     card: (a) ``python -m repro_torch.launch.dryrun`` at the reference's
     16x16 mesh (a fake group of 256 ranks), one architecture of each
     family (gemma3-4b, qwen3-moe-30b-a3b, mamba2-370m, zamba2-1.2b,
     pixtral-12b) at train_4k and decode_32k and mamba2-370m at
     long_500k, one process each, all at once: each must end ``ok``; its
     roofline terms on the H100, dominant term, useful-FLOPs ratio, meta
     peak and the memory model's total and fit against this card's
     total_memory, a line each; (b) inside 5j (c), on its parameters:
     ``dryrun.build_step``'s one-rank step (rqm, sgd, float32, no remat)
     counted once on the meta device and once on the card: the card's
     FLOPs and dispatched bytes (the kernels' charged traffic included)
     must equal the meta counts exactly; the meta peak beside
     max_memory_allocated above the start, the roofline terms beside the
     measured step (printed); (c) 5m (a)'s ranks record the collectives
     of each variant's first step, which must equal, record for record
     and in order (kind, bytes, group size), those of the same plan's
     step on the meta device (``--dryrun-worker``, a fake group of 4);
     (d) the generalised RQM (``core/rqm_general.py``) on the card at
     m=16 and a q vector from ``optimize_q``: 1,000,000 draws at each of
     x = -1.2, 0.1, 1.4 against ``outcome_distribution`` by a chi-square
     test (p above 1e-4), and ``select_levels`` on the card equal to the
     CPU's bit for bit on the same uniforms; lines start with [5n], report
     "dryrun", files under build/phase5n.

Every run of phases 4 to 5m (but their reports) sets the kernels' launch counters to 0
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

import contextlib
import dataclasses
import gc
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
# phase 5j: LM training. (a) the reduced configs and steps a run; (c)
# full width: (arch, batch, seq, steps, parameters); (d) the example's
# steps; float32's peak outside the tensor cores (NVIDIA data sheet, H100
# SXM)
TRAIN_ARCHS = ("gemma3-4b", "mamba2-370m", "qwen3-moe-30b-a3b")
TRAIN_STEPS = 3
TRAIN_FULL = ("gemma3-4b", 2, 256, 3, 4_550_996_480)
TRAIN_COMPARE_STEPS = 30
TRAIN_DIGEST_CHUNK = 1 << 26
TRAIN_PLAIN_CHUNK = 1 << 24  # elements a chunk of the plain encode and codec at full width
F32_FLOPS_PER_S = 67e12
# phase 5k: the model axis, its ranks subprocesses of torch.distributed.run
# on the one card (gloo over CUDA tensors). (a) the reduced configs, the
# meshes of each launch (ranks: meshes, and the archs at each) and steps
# a run; (b) the shard engine's 2-D lm round (tests/fed_lm_2d_checks.py's
# problem), the grids of each launch; (c) full width at 1x2
TP_STEPS = 2
TP_TRAIN = {2: {"1x2": ("chatglm3-6b", "mamba2-370m")},
            4: {"2x2": ("chatglm3-6b", "mamba2-370m"), "1x4": ("chatglm3-6b",)}}
TP_FED = dict(num_clients=8, clients_per_round=4, rounds=2, lr=0.5, samples_per_client=8,
              task="lm:model=mamba2-370m,seq_len=16,batch=1")
TP_FED_SPEC = "rqm:c=0.05"
# (b) the tensor-parallel client release on the card against the same
# code on CPU tensors (tests/test_torch_tp_client.py holds that against
# the reference): tests/test_torch_lm_round.py's GRAD_RTOL of a client's
# largest coordinate, at each of these local steps; above one step the
# release is the delta ``flat - cur``, and each step's ``cur`` rounds to
# the parameter's spacing on either side, so the bound adds ``steps``
# spacings of the parameter
TP_RELEASE_STEPS = (1, 2)
TP_GRAD_RTOL = 1e-5
TP_FED_GRIDS = {2: ("1x2", "2x1"), 4: ("2x2",)}
TP_FULL = ("gemma3-4b", 2, 256, 3, 4_550_996_480)
TP_TIMEOUT = 900  # seconds a launch of ranks may take
TP_PROBE_REPS = 20  # (c): all_reduces timed alone
# phase 5l: serving over a mesh, its ranks subprocesses of
# torch.distributed.run on the one card (gloo). (a) the reduced configs,
# the meshes of each launch (ranks: meshes), the batch-sharded and the
# seq-sharded shape (batch, prompt, cache), the decode steps; (b) full
# width at the reference's long_500k shape over SERVE_LONG_MESH: the
# decode steps from the cache's last positions, the filled caches'
# generator block (positions), the hidden states' tolerance; (c) full
# width over a model axis at phase 5i's shape, the arch's 5i tokens
SERVE_MESH_ARCHS = ("gemma3-4b", "h2o-danube-3-4b", "zamba2-1.2b")
SERVE_MESH_MESHES = {2: ("2x1", "1x2"), 4: ("2x2",)}
SERVE_MESH_SHAPES = {"batch": (4, 64, 96), "seq": (1, 96, 128)}
SERVE_MESH_STEPS = 8
SERVE_LONG = ("gemma3-4b", "long_500k", 8, 4_550_996_480)
SERVE_LONG_MESH = (2, 1)
SERVE_LONG_BLOCK = 4096
# (b) the sharded decode's final hidden state against the one-rank
# decode's, of the largest entry: the flash-decoding combine sums the
# same exp-weighted values in another order (two partial sums of 262,144
# keys, and the division after the value product, not before), float32;
# its error ~ a few ulps x sqrt(keys) of the attention output, ~1e-6
# relative, carried through 34 residual blocks and the final norm
SERVE_LONG_HIDDEN_RTOL = 1e-4
SERVE_AXIS_ARCH = "gemma3-4b"
SERVE_AXIS_MESH = (1, 2)
# phase 5m: the LM steps at the reference's own precision and memory
# options. (a) tests/sharded_checks.py's check_perf_variants on the reduced
# OPT_ARCHS over OPT_MESH (ranks on the one card, gloo): its variants, its
# batch (one, repeated: random tokens, the labels the same), its spec, rate
# and steps, float32 compute; (b) 5j's full-width step in bfloat16 with
# remat; (c) ZeRO-1 with bfloat16 parameters at full width over
# OPT_ZERO1_MESH, or at OPT_ZERO1_REDUCED_LAYERS where two ranks' estimate
# does not fit the card; (d) 5i's decode in bfloat16. bfloat16's dense
# tensor-core peak (NVIDIA data sheet, H100 SXM); (b)'s first loss against
# 5j's float32 one: bfloat16 rounds the residual stream at 2**-8 of each
# element, over 34 blocks
OPT_ARCHS = ("gemma3-4b", "mamba2-370m")
OPT_MESH = (2, 2)
OPT_BATCH, OPT_SEQ, OPT_STEPS = 8, 128, 3
OPT_SPEC, OPT_LR = "rqm:c=0.05", 0.2
OPT_VARIANTS = {"base": {}, "int16": {"agg_dtype": "int16"}, "sp_compress": {"sp_compress": True},
                "zero1": {"zero1": True, "agg_dtype": "auto"}}
OPT_ZERO1_ATOL = 2e-3
OPT_ZERO1_MESH = (2, 1)
OPT_ZERO1_REDUCED_LAYERS = 12
BF16_FLOPS_PER_S = 989e12
BF16_LOSS_RTOL = 1e-2
# phase 5n: the dry run. (a) the runs at the reference's 16x16 mesh, one
# process each, DRY_WORKERS at once, each within DRY_TIMEOUT seconds; (d)
# the generalised RQM: its base grid, optimize_q's cohort, alpha and
# iterations, the draws at each x, the chi-square test's least p-value,
# the seed, and the elements held bit for bit against the CPU
DRY_RUNS = (("gemma3-4b", "train_4k"), ("gemma3-4b", "decode_32k"),
            ("qwen3-moe-30b-a3b", "train_4k"), ("qwen3-moe-30b-a3b", "decode_32k"),
            ("mamba2-370m", "train_4k"), ("mamba2-370m", "decode_32k"),
            ("mamba2-370m", "long_500k"), ("zamba2-1.2b", "train_4k"),
            ("zamba2-1.2b", "decode_32k"), ("pixtral-12b", "train_4k"),
            ("pixtral-12b", "decode_32k"))
DRY_WORKERS = 8
DRY_TIMEOUT = 600
GRQM_BASE = {"c": 1.5, "delta": 1.5, "m": 16, "q": 0.42}
GRQM_OPTIMIZE = (8, 8.0, 20)  # n, alpha, iters
GRQM_DRAWS, GRQM_XS, GRQM_P_MIN, GRQM_SEED = 1_000_000, (-1.2, 0.1, 1.4), 1e-4, 29
GRQM_EXACT = 1 << 20
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
        return model.loss_fn(unravel(f), cfg, ParallelCtx(), batch, remat=False,
                             compute_dtype=torch.float32)[0]

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
                     card: str, keep: dict = None) -> dict:
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
    weight a token over 67 TFLOP/s, are below it). ``keep``, if given,
    takes the prompt, the generated tokens and the decode ms (phase 5l
    (c) replays them over a model axis)."""
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
    nxt, caches = model.prefill(params, cfg, ctx, toks, shape, pe, compute_dtype=torch.float32)
    ev[1].record()
    generated, host_ms = [nxt], []
    timed = gen_len - 1 - SERVE_PROFILED
    for i in range(timed):
        h0 = time.perf_counter()
        nxt, caches = model.decode_step(params, caches, cfg, ctx, nxt[:, None], prompt + i,
                                        compute_dtype=torch.float32)
        host_ms.append((time.perf_counter() - h0) * 1e3)
        ev[i + 2].record()
        generated.append(nxt)
    torch.cuda.synchronize()
    prefill_ms = ev[0].elapsed_time(ev[1])
    step_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(timed)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(timed, gen_len - 1):
            nxt, caches = model.decode_step(params, caches, cfg, ctx, nxt[:, None], prompt + i,
                                            compute_dtype=torch.float32)
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
            model.decode_step(params, caches, cfg, ctx, nxt[:, None], prompt + gen_len - 1,
                              compute_dtype=torch.float32)
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
    if keep is not None:
        keep.update(toks=toks.cpu(), gen=gen.cpu(), decode_ms=decode_ms)
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


def train_launch(torch, argv: list) -> dict:
    """``launch/train.py``'s ``main(argv)`` on the card, its printed lines
    kept out of this script's output."""
    import io

    from repro_torch.launch import train

    with contextlib.redirect_stdout(io.StringIO()):
        return train.main(argv)


def same_train_runs(torch, runs: dict, what: str) -> None:
    """Every run's parameters, optimizer state and losses bit for bit."""
    from repro_torch.convert import leaves

    (tag0, a), *rest = runs.items()
    for tag, b in rest:
        pa, pb = leaves(a["params"]), leaves(b["params"])
        sa, sb = leaves(a["opt_state"]), leaves(b["opt_state"])
        if len(pa) != len(pb) or not all(torch.equal(x, y) for x, y in zip(pa, pb)):
            raise AssertionError(f"[5j] {what}: {tag}'s parameters differ from {tag0}'s")
        if len(sa) != len(sb) or not all(torch.equal(x, y) for x, y in zip(sa, sb)):
            raise AssertionError(f"[5j] {what}: {tag}'s optimizer state differs from {tag0}'s")
        if a["losses"] != b["losses"]:
            raise AssertionError(f"[5j] {what}: {tag}'s losses {b['losses']} != {a['losses']}")


@contextlib.contextmanager
def recorded_encodes(keep):
    """Within the block, each ``Mechanism.quantize`` call (the train
    step's per-leaf encode; ``i`` counts the block's calls) that
    ``keep(i, g)`` accepts is kept as (mechanism, a copy of the gradient
    leaf, the seed, a copy of the levels), the copies in host memory (a
    full-width step leaves no room on the card for them). Copies launch
    no counted kernel."""
    from repro_torch.core.mechanisms import Mechanism

    quantize, kept, calls = Mechanism.quantize, [], [0]

    def recording(self, g, seed):
        z = quantize(self, g, seed)
        if keep(calls[0], g):
            kept.append((self, g.detach().cpu(), seed, z.cpu()))
        calls[0] += 1
        return z

    Mechanism.quantize = recording
    try:
        yield kept
    finally:
        Mechanism.quantize = quantize


def held_encodes(torch, kept, what: str) -> list:
    """Each kept encode's levels == ``<name>_quantize_plain`` of the
    clipped leaf at its seed (row 0: a coordinate's counter is its flat
    index), and ``pack_flat``/``unpack_flat`` of the levels at the
    one-rank packed plan's width == their plain versions, bit for bit,
    on the card. A leaf past TRAIN_PLAIN_CHUNK runs the plain encode
    chunk by chunk, on the chunk's counters (offset by its first
    coordinate); the plain codec takes the whole leaf (its word ``i``
    holds coordinates ``i, i + W, ...``). These launches are not
    counted. Returns the sizes held."""
    from repro_torch.core import wire
    from repro_torch.kernels import pack_kernel, pbm_kernel, qmgeo_kernel, rqm_kernel

    kernels = {"rqm": rqm_kernel, "pbm": pbm_kernel, "qmgeo": qmgeo_kernel}
    held = []
    while kept:
        mech, g, seed, z = kept.pop(0)  # host copies, each freed once held
        kernel = kernels[mech.name]
        plain = getattr(kernel, f"{mech.name}_quantize_plain")
        encode = getattr(kernel, f"{mech.name}_encode_counters")
        g, z, n = g.reshape(-1), z.reshape(-1), z.numel()
        for c0 in range(0, n, TRAIN_PLAIN_CHUNK):
            c1 = min(c0 + TRAIN_PLAIN_CHUNK, n)
            x, want = mech._clip(g[c0:c1].cuda()), z[c0:c1].cuda()
            if n <= TRAIN_PLAIN_CHUNK:
                levels = plain(x.reshape(1, -1), seed, mech.params)[0]
            else:
                counters = torch.arange(c0, c1, dtype=torch.int64, device=x.device)
                levels = encode(x, seed, counters, mech.params)
            if not torch.equal(levels, want):
                bad = int((levels != want).sum())
                raise AssertionError(f"[5j] {what}: {mech.name}_quantize on a leaf of {n} "
                                     f"coordinates differs from its plain version at {bad} "
                                     f"of coordinates {c0}-{c1}")
        del g, x, want, levels
        z = z.cuda()
        bits = wire.sum_bits(mech.sum_bound(1))
        words = pack_kernel.pack_flat(z, bits)
        if not torch.equal(words, pack_kernel.pack_flat_plain(z, bits)):
            raise AssertionError(f"[5j] {what}: pack_flat at {bits} bits on a leaf of {n} "
                                 "coordinates differs from its plain version")
        back = pack_kernel.unpack_flat(words, bits, n)
        if not (torch.equal(back, pack_kernel.unpack_flat_plain(words, bits, n))
                and torch.equal(back, z)):
            raise AssertionError(f"[5j] {what}: unpack_flat at {bits} bits on a leaf of {n} "
                                 "coordinates differs from its plain version or the levels")
        del words, back
        held.append(n)
    return held


def train_reduced(torch, counted) -> dict:
    """Phase 5j (a): each of TRAIN_ARCHS reduced, through the launcher:
    the plain run, the one-rank NCCL plan and the one-rank packed plan,
    TRAIN_STEPS steps each, bit for bit, each run counted; the plain
    run's first step's per-leaf levels held against their plain versions
    (``held_encodes``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import leaves
    from repro_torch.models import model

    S = TRAIN_STEPS
    report = {}
    for arch in TRAIN_ARCHS:
        n = len(leaves(model.param_meta(get_config(arch, reduced=True))))
        names = ("rqm", "pbm", "qmgeo", "none") if arch == "mamba2-370m" else ("rqm",)
        for name in names:
            quantize = {} if name == "none" else {f"{name}_quantize": S * n}
            codec = {} if name == "none" else {"pack_flat": S * n, "unpack_flat": S * n}
            runs, held = {}, []
            for tag, extra, expect in (("plain", [], quantize),
                                       ("plan 1", ["--mesh-shape", "1"], quantize),
                                       ("plan 1 packed", ["--mesh-shape", "1", "--packed"],
                                        {**quantize, **codec})):
                argv = ["--arch", arch, "--reduced", "--mechanism", name, "--steps", str(S),
                        "--batch", "2", "--seq", "64", "--log-every", str(S)] + extra
                out, kept = {}, []

                def launch():
                    # the plain run keeps its first step's encodes
                    first = (lambda i, g: tag == "plain" and name != "none" and i < n)
                    with recorded_encodes(first) as k:
                        out.update(train_launch(torch, argv))
                    kept.extend(k)

                counted(f"[5j] {arch} {name} {tag}", expect, launch)
                runs[tag] = out
                if kept:
                    held = held_encodes(torch, kept, f"{arch} {name} {tag}")
            same_train_runs(torch, runs, f"{arch} {name}: plain, plan 1, plan 1 packed")
            losses = runs["plain"]["losses"]
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"[5j] {arch} {name}: losses {losses}")
            if name != "none" and len(held) != n:
                raise AssertionError(f"[5j] {arch} {name}: {len(held)} of {n} leaves held")
            report[f"{arch} {name}"] = {"leaves": n, "losses": losses, "held_leaves": len(held),
                                        "launches_per_step": {k: v // S for k, v in
                                                              {**quantize, **codec}.items()}}
            log(f"[5j] {arch} reduced, {name}: plain == plan 1 == plan 1 packed bit for bit "
                f"over {S} steps, losses {losses}; {n} leaves, one quantize launch a leaf a "
                f"step" + ("" if name == "none" else ", one pack_flat and unpack_flat a leaf "
                           "a step packed; the first step's levels of every leaf == "
                           f"{name}_quantize_plain, pack_flat/unpack_flat == their plain "
                           "versions"))
    return report


def train_resume(torch, counted) -> dict:
    """Phase 5j (b): 4 steps of reduced mamba2 checkpointed at 2 ==
    resumed at 2, through the launcher, sgd and adam."""
    import shutil

    report = {}
    for opt in ("sgd", "adam"):
        root = os.path.join(ROOT, "build", "phase5j", opt)
        shutil.rmtree(root, ignore_errors=True)
        base = ["--arch", "mamba2-370m", "--reduced", "--steps", "4", "--batch", "2", "--seq",
                "64", "--log-every", "4", "--server-opt", opt]
        runs = {}
        counted(f"[5j] resume {opt}: uninterrupted", None, lambda: runs.update(
            full=train_launch(torch, base + ["--ckpt-every", "2", "--ckpt-dir",
                                             os.path.join(root, "a")])))
        os.makedirs(os.path.join(root, "b"))
        shutil.copy(os.path.join(root, "a", "step_00000002.npz"), os.path.join(root, "b"))
        counted(f"[5j] resume {opt}: resumed", None, lambda: runs.update(
            resumed=train_launch(torch, base + ["--resume", "--ckpt-dir",
                                                os.path.join(root, "b")])))
        if runs["resumed"]["start"] != 2:
            raise AssertionError(f"[5j] resume {opt}: started at {runs['resumed']['start']}")
        runs["full"]["losses"] = runs["full"]["losses"][2:]
        same_train_runs(torch, runs, f"resume {opt}")
        report[opt] = {"losses": runs["resumed"]["losses"]}
        log(f"[5j] resume {opt}: 4 steps == checkpointed at 2 and resumed, bit for bit")
    return report


def leaf_digest(torch, t) -> tuple:
    """A leaf's bits as two int64 sums (plain and position-weighted),
    wrapping, chunk by chunk on the card."""
    bits = t.detach().reshape(-1).view(torch.int32)
    plain = weighted = 0
    for c0 in range(0, bits.numel(), TRAIN_DIGEST_CHUNK):
        x = bits[c0:c0 + TRAIN_DIGEST_CHUNK].to(torch.int64)
        pos = torch.arange(c0 + 1, c0 + 1 + x.numel(), dtype=torch.int64, device=x.device)
        plain += int(x.sum())
        weighted += int((x * pos).sum())
    return plain, weighted % (1 << 64)


def train_full_width(torch, counted, card: str) -> dict:
    """Phase 5j (c): gemma3-4b at full width, random from a CUDA
    generator, rqm and sgd at the launcher's warmup-cosine rate, batch 2,
    seq 256: TRAIN_FULL's steps of the plain step and of the one-rank
    packed plan's, bit for bit (per-leaf digests; the embedding whole on
    the host), each run counted; step ms by CUDA events, host dispatch ms
    a step (its clock around each call), peak memory above the start;
    then one more plain step under torch.profiler: device busy ms,
    launches (device activities), the quantize kernel's share; then one
    more whose encodes of the first leaf of each shape are held against
    their plain versions (``held_encodes``, in chunks)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import leaves
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.distributed.step import (build_train_step_fn, make_plan, make_train_step,
                                              train_seeds)
    from repro_torch.eval.lm_eval import batch_to
    from repro_torch.models import model
    from repro_torch.models.common import ParallelCtx
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedules import warmup_cosine

    arch, batch, seq, steps, want_params = TRAIN_FULL
    cfg = get_config(arch)
    mech, opt = make_mechanism(SPECS["rqm"]), make_optimizer("sgd")
    lr_fn = warmup_cosine(0.2, warmup=steps // 10 + 1, total_steps=steps, device="cuda")
    pipe = TokenPipeline(cfg, seq, batch, seed=0)
    runs = {}

    def run(tag: str, step_fn, profiled: bool) -> dict:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        start_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init_params(torch.Generator("cuda").manual_seed(1), cfg, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in leaves(params))
        if n_params != want_params:
            raise AssertionError(f"[5j] {arch}: {n_params} parameters, expected {want_params}")
        n_leaves = len(leaves(params))
        state, losses, host_ms = opt.init(params), [], []
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        out = {}

        def go():
            nonlocal params, state
            ev[0].record()
            for step in range(steps):
                b = batch_to(pipe.batch(step), "cuda")
                seeds = train_seeds(0, step, 0, n_leaves)
                h0 = time.perf_counter()
                params, state, metrics = step_fn(params, state, step, b, seeds)
                host_ms.append((time.perf_counter() - h0) * 1e3)
                ev[step + 1].record()
                losses.append(metrics["loss"])

        quantize = {"rqm_quantize": steps * n_leaves}
        codec = {"pack_flat": steps * n_leaves, "unpack_flat": steps * n_leaves}
        counted(f"[5j] {arch} full width {tag}", {**quantize, **(codec if "packed" in tag
                                                                 else {})}, go)
        step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
        peak = torch.cuda.max_memory_allocated() - start_bytes
        losses = [float(v) for v in losses]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"[5j] {arch} {tag}: losses {losses}")
        out = {"init_s": init_s, "losses": losses, "step_ms": step_ms, "host_ms": host_ms,
               "peak_bytes_above_start": peak, "leaves": n_leaves, "params": n_params,
               "digests": [leaf_digest(torch, t) for t in leaves(params)],
               "embed": params["embed"].cpu()}
        if profiled:
            b = batch_to(pipe.batch(steps), "cuda")
            seeds = train_seeds(0, steps, 0, n_leaves)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                h0 = time.perf_counter()
                params, state, _ = step_fn(params, state, steps, b, seeds)
                out["profiled_host_ms"] = (time.perf_counter() - h0) * 1e3
                torch.cuda.synchronize()
            by_kernel = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
            busy = sum(e.device_time_total for e in by_kernel) / 1e3
            quantize_ms = sum(e.device_time_total for e in by_kernel
                              if "quantize_kernel" in e.key) / 1e3
            out.update(
                device_busy_ms=busy,
                device_launches=sum(str(e.device_type).endswith("CUDA")
                                    for e in prof.events()),
                quantize_ms=quantize_ms, quantize_share=quantize_ms / busy,
                top_kernels_ms={demangle(e.key)[:80]: e.device_time_total / 1e3
                                for e in by_kernel[:8]})
            # one more step keeps the first leaf of each shape's encode
            # (the embedding, 671,088,640 coordinates, among them)
            seen = set()

            def first_of_shape(i, g):
                new = tuple(g.shape) not in seen
                seen.add(tuple(g.shape))
                return new

            b = batch_to(pipe.batch(steps + 1), "cuda")
            with recorded_encodes(first_of_shape) as out["kept"]:
                params, state, _ = step_fn(params, state, steps + 1, b,
                                           train_seeds(0, steps + 1, 0, n_leaves))
            # phase 5n (b): the dry run's one-rank step on these parameters
            out["dryrun_one_rank"] = dry_one_rank(
                torch, cfg, params, batch_to(pipe.batch(steps + 2), "cuda"), steps + 2, shape,
                card)
        del params, state
        torch.cuda.empty_cache()
        return out

    shape = InputShape("cli", seq, batch, "train")
    f32 = dict(remat=False, compute_dtype=torch.float32)
    runs["plain"] = run("plain", build_train_step_fn(cfg, mech, opt, lr_fn, ParallelCtx(), **f32),
                        profiled=True)
    dry = runs["plain"].pop("dryrun_one_rank")
    t0 = time.perf_counter()
    held = held_encodes(torch, runs["plain"].pop("kept"), f"{arch} full width")
    held_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    plan_step, _ = make_train_step(cfg, make_plan((1, 1), "cuda"), mech, opt, lr_fn, shape,
                                   packed=True, **f32)
    runs["plan 1 packed"] = run("plan 1 packed", plan_step, profiled=False)
    a, b = runs["plain"], runs["plan 1 packed"]
    if a["digests"] != b["digests"] or not torch.equal(a["embed"], b["embed"]) \
            or a["losses"] != b["losses"]:
        bad = sum(x != y for x, y in zip(a["digests"], b["digests"]))
        raise AssertionError(f"[5j] {arch}: the packed plan differs from the plain run "
                             f"({bad} leaves' digests; losses {a['losses']} vs {b['losses']})")
    n_params = a["params"]
    matmul = n_params - cfg.padded_vocab(1) * cfg.d_model  # all but the embedding table
    tokens = batch * seq
    bound_ops = 6 * matmul * tokens / F32_FLOPS_PER_S * 1e3
    bound_bytes = 2 * 4 * n_params / HBM_BYTES_PER_S * 1e3
    steady = a["step_ms"][1:]
    median = statistics.median(steady)
    report = {"arch": arch, "params": n_params, "leaves": a["leaves"], "batch": batch,
              "seq": seq, "steps": steps, "losses": a["losses"],
              "init_s": {k: r["init_s"] for k, r in runs.items()},
              "step_ms": {k: r["step_ms"] for k, r in runs.items()},
              "step_ms_median_after_first": median, "step_ms_range": [min(steady), max(steady)],
              "tokens_per_s": tokens / median * 1e3,
              "host_dispatch_ms": {k: r["host_ms"] for k, r in runs.items()},
              "profiled_step": {k: a[k] for k in ("profiled_host_ms", "device_busy_ms",
                                                  "device_launches", "quantize_ms",
                                                  "quantize_share", "top_kernels_ms")},
              "peak_bytes_above_start": {k: r["peak_bytes_above_start"]
                                         for k, r in runs.items()},
              "matmul_params": matmul, "bound_ms": max(bound_ops, bound_bytes),
              "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
              "bound_ops_ms": bound_ops, "bound_bytes_ms": bound_bytes,
              "packed_plan_equal": True, "held_leaf_sizes": held, "held_s": held_s,
              "nvidia_smi": card, "dryrun_one_rank": dry}
    log(f"[5j] {arch} full width: {n_params} parameters in {a['leaves']} leaves, batch {batch} "
        f"x seq {seq}, {steps} steps: plain == one-rank packed plan bit for bit (digests, "
        f"embedding, losses {a['losses']}); step ms {a['step_ms']} (plain), {b['step_ms']} "
        f"(packed plan); {report['tokens_per_s']} tokens/s; host dispatch ms {a['host_ms']}; "
        f"profiled step: busy {a['device_busy_ms']} ms, {a['device_launches']} launches, "
        f"quantize {a['quantize_ms']} ms ({a['quantize_share']}); peak "
        f"{report['peak_bytes_above_start']} B above the start; bound {report['bound_ms']} ms "
        f"({report['bound_by']}); a step's rqm_quantize, pack_flat and unpack_flat on the first "
        f"leaf of each shape (sizes {held}) == their plain versions, the encode in chunks of "
        f"{TRAIN_PLAIN_CHUNK}, in {held_s} s; nvidia-smi: {card}")
    return report


def train_compare(torch, counted, card: str) -> dict:
    """Phase 5j (d): examples/train_lm_rqm_torch.py's ``--compare`` on
    reduced gemma3, TRAIN_COMPARE_STEPS steps (reported, not gated)."""
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location(
        "train_lm_rqm_torch", os.path.join(ROOT, "examples", "train_lm_rqm_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    final = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        counted("[5j] the example's --compare", None, lambda: final.update(example.main(
            ["--arch", "gemma3-4b", "--steps", str(TRAIN_COMPARE_STEPS), "--compare"])))
    report = {"arch": "gemma3-4b (reduced)", "steps": TRAIN_COMPARE_STEPS, "final_ce": final,
              "seconds": time.perf_counter() - t0, "nvidia_smi": card}
    log(f"[5j] the example's --compare, reduced gemma3-4b, {TRAIN_COMPARE_STEPS} steps: final "
        f"ce {final} in {report['seconds']} s")
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


# ---------------------------------------------------------------------------
# phase 5k: the model axis (tp > 1). The ranks are subprocesses of
# torch.distributed.run that run this script with ``--tp-worker <part>``
# (tp_worker); each writes build/phase5k/<part>_rank<r>.json.
# ---------------------------------------------------------------------------


def tp_held_calls(torch):
    """A context that keeps the first call of each round-path kernel
    wrapper (the fused round sums, the decodes, the codec, the batch
    quantize), its arguments and result copied, and returns a function
    that holds each against its plain version on the same arguments on
    the card, bit for bit (these plain calls launch no counted kernel).
    Returns (context, check)."""
    from repro_torch.core import secagg
    from repro_torch.fed import rounds
    from repro_torch.kernels import (decode_apply_kernel, fused_round_kernel, ops, pack_kernel,
                                     rqm_kernel)

    targets = [
        (fused_round_kernel, "round_sum", fused_round_kernel.round_sum_plain),
        (fused_round_kernel, "round_sum_packed", fused_round_kernel.round_sum_packed_plain),
        (rounds, "decode_apply_sum", decode_apply_kernel.decode_apply_plain),
        (rounds, "unpack_decode_apply", pack_kernel.unpack_decode_apply_plain),
        (rounds, "unpack_flat", pack_kernel.unpack_flat_plain),
        (secagg, "pack_flat", pack_kernel.pack_flat_plain),
        (secagg, "unpack_flat", pack_kernel.unpack_flat_plain),
        (ops, "rqm_batch", rqm_kernel.rqm_quantize_plain),
    ]
    kept = {}

    def copy(v):
        return v.detach().clone() if isinstance(v, torch.Tensor) else v

    @contextlib.contextmanager
    def recording():
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
        for (mod, name, fn), (_, _, plain) in zip(saved, targets):
            def wrapped(*args, _fn=fn, _key=f"{mod.__name__}.{name}", _plain=plain, **kwargs):
                out = _fn(*args, **kwargs)
                if _key not in kept:
                    kept[_key] = (_plain, [copy(a) for a in args],
                                  {k: copy(v) for k, v in kwargs.items()}, out.clone())
                return out
            setattr(mod, name, wrapped)
        try:
            yield kept
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    def check(what: str) -> list:
        held = []
        for key, (plain, args, kwargs, out) in sorted(kept.items()):
            want = plain(*args, **kwargs)
            if not torch.equal(want, out):
                raise AssertionError(f"[5k] {what}: {key} differs from its plain version at "
                                     f"{int((want != out).sum())} of {out.numel()} entries")
            held.append(f"{key.split('.')[-1]} {tuple(out.shape)}")
        kept.clear()
        return held

    return recording, check


def tp_digests(torch, params) -> list:
    import hashlib

    from repro_torch.convert import leaves

    return [hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
            for t in leaves(params)]


def tp_copies_equal(torch, dist, params, meta, groups, what: str) -> int:
    """Every leaf duplicated over the model axis (sync > 1) bit-equal on
    each aligned group of ``sync`` model ranks (digests gathered over the
    model group). Returns the leaves held."""
    from repro_torch.convert import leaves

    tp, mi = dist.get_world_size(groups.model), groups.model_index
    n = 0
    for d, m in zip(tp_digests(torch, params), leaves(meta)):
        if m.sync <= 1:
            continue
        every = [None] * tp
        dist.all_gather_object(every, d, group=groups.model)
        g = min(m.sync, tp)
        if len(set(every[mi // g * g:(mi // g + 1) * g])) != 1:
            raise AssertionError(f"[5k] {what}: a leaf of sync {m.sync} differs across its "
                                 f"group: {every}")
        n += 1
    return n


def tp_train_reduced(torch, dist, counted, world: int) -> dict:
    """Phase 5k (a) on this rank: each mesh of TP_TRAIN[world] and its
    reduced configs through the launcher, rqm, TP_STEPS steps, plain and
    packed, each run counted: packed == plain bit for bit (parameters,
    losses); every replicated or duplicated leaf bit-equal across its
    group; the plain run's first step's levels of every leaf (this rank's
    slices) == rqm_quantize_plain, pack_flat/unpack_flat of them == their
    plain versions."""
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import leaves
    from repro_torch.launch.mesh import mesh_groups
    from repro_torch.models import model

    S, report = TP_STEPS, {}
    for mesh, archs in TP_TRAIN[world].items():
        D, M = (int(d) for d in mesh.split("x"))
        groups = mesh_groups(D, M, "cuda")
        for arch in archs:
            meta = model.param_meta(get_config(arch, reduced=True), M)
            n = len(leaves(meta))
            quantize = {"rqm_quantize": S * n}
            codec = {"pack_flat": S * n, "unpack_flat": S * n}
            runs, held = {}, []
            for tag, extra, expect in (("plain", [], quantize),
                                       ("packed", ["--packed"], {**quantize, **codec})):
                argv = ["--arch", arch, "--reduced", "--mechanism", "rqm", "--steps", str(S),
                        "--batch", "2", "--seq", "64", "--log-every", str(S), "--mesh-shape",
                        mesh] + extra
                out, kept = {}, []

                def launch():
                    first = (lambda i, g: tag == "plain" and i < n)
                    with recorded_encodes(first) as k:
                        out.update(train_launch(torch, argv))
                    kept.extend(k)

                counted(f"{mesh} {arch} {tag}", expect, launch)
                runs[tag] = out
                if kept:
                    held = held_encodes(torch, kept, f"{mesh} {arch} {tag}")
            same_train_runs(torch, runs, f"{mesh} {arch}: plain, packed")
            losses = runs["plain"]["losses"]
            if not all(math.isfinite(v) for v in losses) or len(held) != n:
                raise AssertionError(f"[5k] {mesh} {arch}: losses {losses}, {len(held)} of {n} "
                                     "leaves held")
            copies = tp_copies_equal(torch, dist, runs["plain"]["params"], meta, groups,
                                     f"{mesh} {arch}")
            report[f"{mesh} {arch}"] = {"leaves": n, "losses": losses, "held_leaves": len(held),
                                        "copies_equal": copies}
    return report


def tp_release_cuda_vs_cpu(torch, tr) -> dict:
    """The shard engine's tensor-parallel client release (``tr``'s task
    bound to its model axis) of the first cohort's clients, unclipped, on
    the card and on CPU tensors over the same gloo groups, at each of
    TP_RELEASE_STEPS local steps: each coordinate within TP_GRAD_RTOL of
    its client's largest, plus, above one step, ``steps`` spacings of its
    parameter. Returns, a step, the worst error relative to the client's
    largest coordinate and the worst share of the bound."""
    import numpy as np

    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.fed import rounds

    none = make_mechanism("none:c=1e30")
    batches = [tr.task.client_batch(c) for c in range(TP_FED["clients_per_round"])]
    batch = {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}
    out = {}
    for steps in TP_RELEASE_STEPS:
        grads = rounds.make_client_grad(none, tr.unravel, tr.task,
                                        dataclasses.replace(tr.cfg, local_steps=steps),
                                        ctx=tr.task_ctx)
        got = grads(tr.flat, {k: v.cuda() for k, v in batch.items()}).cpu()
        want = grads(tr.flat.cpu(), batch)
        err, scale = (got - want).abs(), want.abs().amax(1, keepdim=True)
        bound = TP_GRAD_RTOL * scale
        if steps > 1:
            bound = bound + steps * torch.from_numpy(np.spacing(tr.flat.abs().cpu().numpy()))
        share = (err / bound).max().item()
        if not (torch.isfinite(got).all() and share <= 1.0):
            raise AssertionError(f"[5k] tp release at {steps} local steps: cuda vs cpu "
                                 f"at {share} of the bound")
        out[steps] = {"rel_err": (err / scale).max().item(), "share_of_bound": share}
    return out


def tp_fed_grid(torch, dist, counted, grid: str) -> dict:
    """Phase 5k (b) on this rank: TP_FED on the shard engine at ``grid``
    (shards x model shards), materialized, fused packed and fused dense,
    each run counted, their sums and parameters bit for bit; each path's
    first round's kernels held against their plain versions; rank 0
    saves the materialized run's sums and parameters for the parent to
    hold across grids."""
    from repro_torch.fed.config import FedConfig
    from repro_torch.fed.trainer import FedTrainer

    S, M = (int(d) for d in grid.split("x"))
    R = TP_FED["rounds"]
    base = FedConfig(engine="shard", shards=S, model_shards=M, collect_sums=True, **TP_FED)
    recording, check = tp_held_calls(torch)
    paths = {
        "materialized": (base, {"rqm_quantize": R, "pack_flat": R, "unpack_flat": R}),
        "fused packed": (dataclasses.replace(base, fused_rounds=True),
                         {"rqm_round_sum_packed": R, "unpack_decode_apply": R,
                          "unpack_flat": R}),
        "fused dense": (dataclasses.replace(base, fused_rounds=True, wire_packed=False),
                        {"rqm_round_sum_dense": R, "pack_flat": R, "unpack_flat": R,
                         "decode_apply_sum": R}),
    }
    trainers, report = {}, {}
    for path, (cfg, expect) in paths.items():
        box = {}

        def go():
            tr = FedTrainer(TP_FED_SPEC, cfg, device="cuda")
            with recording():
                tr.run_block(R)
            box["tr"] = tr

        counted(f"fed {grid} {path}", expect, go)
        tr = trainers[path] = box["tr"]
        report[path] = {"held": check(f"fed {grid} {path}")}
        if tr.shards != S or tr.task.tp != M or tr.realized_n != [TP_FED["clients_per_round"]] * R:
            raise AssertionError(f"[5k] fed {grid} {path}: shards {tr.shards}, tp {tr.task.tp}, "
                                 f"realized {tr.realized_n}")
    ref = trainers["materialized"]
    for path, tr in trainers.items():
        if not (torch.equal(tr.flat, ref.flat) and all(
                (a == b).all() for a, b in zip(tr.round_sums, ref.round_sums))):
            raise AssertionError(f"[5k] fed {grid}: {path} differs from materialized")
    digest = tp_digests(torch, ref.flat)[0]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, digest)
    if len(set(every)) != 1:
        raise AssertionError(f"[5k] fed {grid}: parameters differ across the ranks")
    ev = ref.evaluate()
    if not (math.isfinite(ev["loss"]) and ev["ppl"] > 1.0):
        raise AssertionError(f"[5k] fed {grid}: held-out loss {ev['loss']}")
    if dist.get_rank() == 0:
        torch.save({"flat": ref.flat.cpu(), "sums": [torch.from_numpy(z) for z in ref.round_sums],
                    "realized_n": [int(n) for n in ref.realized_n],
                    "per_round_eps": [float(e) for e in ref.per_round_eps],
                    "rdp8": float(ref.accountant.rdp_epsilon(8.0))},
                   os.path.join(ROOT, "build", "phase5k", f"fed_{grid}.pt"))
    report.update(dim=int(ref.flat.numel()), eval_loss=ev["loss"], eval_ppl=ev["ppl"],
                  realized_n=[int(n) for n in ref.realized_n])
    if M > 1:
        report["release_rel_err"] = tp_release_cuda_vs_cpu(torch, ref)
    return report


def tp_full_width(torch, dist, counted, card: str) -> dict:
    """Phase 5k (c) on this rank: TP_FULL's arch at full width at mesh
    1x2, each rank drawing the global tree leaf by leaf from a CUDA
    generator and keeping its slices, rqm and sgd at the launcher's
    warmup-cosine rate, TP_FULL's steps counted: step ms by CUDA events,
    host dispatch ms a step, peak memory above the start; one more step
    under torch.profiler (device busy ms, launches, host ms); one more
    with every model-axis collective clocked (a synchronisation around
    each); one more whose encodes of the first leaf of each shape are
    held against their plain versions (``held_encodes``); and the
    model-axis all_reduce alone, on the card and on the host."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import leaves
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.distributed.step import make_plan, make_train_step, train_seeds
    from repro_torch.eval.lm_eval import batch_to
    from repro_torch.models import common, meta as meta_lib, model
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedules import warmup_cosine

    arch, batch, seq, steps, want_params = TP_FULL
    cfg = get_config(arch)
    mech, opt = make_mechanism(SPECS["rqm"]), make_optimizer("sgd")
    lr_fn = warmup_cosine(0.2, warmup=steps // 10 + 1, total_steps=steps, device="cuda")
    pipe = TokenPipeline(cfg, seq, batch, seed=0)
    plan = make_plan((1, 2), "cuda")
    step_fn, specs = make_train_step(cfg, plan, mech, opt, lr_fn,
                                     InputShape("cli", seq, batch, "train"), remat=False,
                                     compute_dtype=torch.float32)
    meta, ctx, shards = specs["param_meta"], specs["ctx"], specs["shard_seeds"]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator("cuda").manual_seed(1), cfg, device="cuda", tp=2,
                               keep=meta_lib.slicer(2, ctx.model_index()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if meta_lib.param_count(meta) != want_params:
        raise AssertionError(f"[5k] {arch}: {meta_lib.param_count(meta)} parameters")
    n_leaves, n_local = len(leaves(params)), sum(t.numel() for t in leaves(params))
    state, losses, host_ms = opt.init(params), [], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]

    def seeds(step):
        return train_seeds(0, step, ctx.client_index, n_leaves, shards)

    def go():
        nonlocal params, state
        ev[0].record()
        for step in range(steps):
            b = batch_to(pipe.batch(step), "cuda")
            s = seeds(step)
            h0 = time.perf_counter()
            params, state, metrics = step_fn(params, state, step, b, s)
            host_ms.append((time.perf_counter() - h0) * 1e3)
            ev[step + 1].record()
            losses.append(metrics["loss"])

    counted(f"{arch} full width 1x2", {"rqm_quantize": steps * n_leaves}, go)
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"[5k] {arch}: losses {losses}")
    peak = torch.cuda.max_memory_allocated() - start_bytes
    # one profiled step
    b = batch_to(pipe.batch(steps), "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        params, state, _ = step_fn(params, state, steps, b, seeds(steps))
        profiled_host_ms = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - h0) * 1e3
    by_kernel = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in by_kernel) / 1e3
    launches = sum(str(e.device_type).endswith("CUDA") for e in prof.events())
    memcpy_ms = sum(e.device_time_total for e in by_kernel if "Memcpy" in e.key) / 1e3
    # one step with the model-axis collectives clocked
    b = batch_to(pipe.batch(steps + 1), "cuda")

    def clocked_step():
        nonlocal params, state
        params, state, _ = step_fn(params, state, steps + 1, b, seeds(steps + 1))

    clocked = clocked_collectives(torch, clocked_step)
    clocked_step_ms = clocked.pop("step_ms")

    def per_call_ms(x, reps=TP_PROBE_REPS):
        """ms a model-axis all_reduce of ``x`` (mean of ``reps``)."""
        common._all_reduce(x, ctx.model_group)
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        for _ in range(reps):
            common._all_reduce(x, ctx.model_group)
        torch.cuda.synchronize()
        return (time.perf_counter() - c0) / reps * 1e3

    # the collective alone: an activation's all_reduce and a 1-element
    # one, on the card and on the host
    act = (batch, seq, cfg.d_model)
    probe = {"activation_shape": list(act),
             "cuda_activation_ms": per_call_ms(torch.ones(act, device="cuda")),
             "cpu_activation_ms": per_call_ms(torch.ones(act)),
             "cuda_one_ms": per_call_ms(torch.ones(1, device="cuda")),
             "cpu_one_ms": per_call_ms(torch.ones(1))}
    # one more step keeps the first leaf of each shape's encode
    seen = set()

    def first_of_shape(i, g):
        new = tuple(g.shape) not in seen
        seen.add(tuple(g.shape))
        return new

    b = batch_to(pipe.batch(steps + 2), "cuda")
    with recorded_encodes(first_of_shape) as kept:
        params, state, _ = step_fn(params, state, steps + 2, b, seeds(steps + 2))
    del params, state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    held = held_encodes(torch, kept, f"{arch} full width 1x2")
    steady = step_ms[1:]
    median = statistics.median(steady)
    return {"arch": arch, "mesh": "1x2", "params": want_params, "local_params": n_local,
            "leaves": n_leaves, "batch": batch, "seq": seq, "steps": steps, "losses": losses,
            "init_s": init_s, "step_ms": step_ms, "step_ms_median_after_first": median,
            "tokens_per_s": batch * seq / median * 1e3, "host_dispatch_ms": host_ms,
            "profiled_step": {"host_ms": profiled_host_ms, "wall_ms": profiled_wall_ms,
                              "device_busy_ms": busy, "device_launches": launches,
                              "memcpy_ms": memcpy_ms,
                              "top_kernels_ms": {demangle(e.key)[:80]: e.device_time_total / 1e3
                                                 for e in by_kernel[:8]}},
            "collectives": {**clocked, "clocked_step_ms": clocked_step_ms,
                            "share_of_clocked_step": clocked["ms"] / clocked_step_ms,
                            "all_reduce_alone": probe},
            "peak_bytes_above_start": peak, "held_leaf_sizes": held,
            "held_s": time.perf_counter() - t0, "backend": dist.get_backend(),
            "nvidia_smi": card}


def tp_worker(part: str) -> int:
    """One rank of a phase 5k launch (``--tp-worker two|four|full``):
    joins the default group that torch.distributed.run describes (gloo:
    the ranks share the card), runs its part, each run counted (its
    launches reset just before it and read just after, and held to what
    the run must launch), and writes its report to
    build/phase5k/<part>_rank<r>.json. Any failed hold raises: the rank
    exits non-zero."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    device = train._device("cuda")
    train._init_from_env(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    runs = {}

    def counted(tag, expect, fn):
        ops.reset_launches()
        fn()
        torch.cuda.synchronize()
        got = dict(ops.launches)
        if expect is not None and got != expect:
            raise AssertionError(f"[5k] {tag} (rank {rank}): launch counts {got}, "
                                 f"expected {expect}")
        runs[tag] = got

    report = {"rank": rank, "world": world, "backend": dist.get_backend(),
              "device": str(device)}
    if part == "full":
        report["full_width"] = tp_full_width(torch, dist, counted, nvidia_smi())
    else:
        report["train"] = tp_train_reduced(torch, dist, counted, world)
        report["fed"] = {grid: None for grid in TP_FED_GRIDS[world]}
        for grid in TP_FED_GRIDS[world]:
            S, M = (int(d) for d in grid.split("x"))
            if S * M != world:
                raise AssertionError(f"[5k] grid {grid} on {world} ranks")
            report["fed"][grid] = tp_fed_grid(torch, dist, counted, grid)
    report["runs"] = runs
    with open(os.path.join(ROOT, "build", "phase5k", f"{part}_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def tp_launch(part: str, ranks: int, phase: str = "5k", args: tuple = ()) -> list:
    """``ranks`` processes of this script's ``--tp-worker part`` (phase
    5k; 5l: ``--serve-worker part``; 5m: ``--opt-worker part``, then
    ``args``) under torch.distributed.run on the one card; returns their
    reports (any failed rank fails the launch, its output's end printed)."""
    out_dir = os.path.join(ROOT, "build", f"phase{phase}")
    logf = os.path.join(out_dir, f"{part}.log")
    flag = {"5k": "--tp-worker", "5l": "--serve-worker", "5m": "--opt-worker"}[phase]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={ranks}", os.path.abspath(__file__), flag, part, *args]
    t0 = time.perf_counter()
    with open(logf, "w") as f:
        proc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT,
                              timeout=TP_TIMEOUT)
    took = time.perf_counter() - t0
    if proc.returncode:
        with open(logf) as f:
            tail = f.read()[-6000:]
        raise AssertionError(f"[{phase}] {part}: {ranks} ranks exited {proc.returncode}:\n"
                             f"{tail}")
    reports = []
    for r in range(ranks):
        with open(os.path.join(out_dir, f"{part}_rank{r}.json")) as f:
            reports.append(json.load(f))
    log(f"[{phase}] {part}: {ranks} ranks on {reports[0]['device']}, backend "
        f"{reports[0]['backend']}, in {took} s")
    return reports


def tp_phase(torch, counts: dict, paths: dict, card: str) -> dict:
    """Phase 5k: the model axis on the one card, three launches of ranks
    (tp_worker): (a) and (b) on 2 and on 4 ranks, (c) on 2. Adds every
    rank's launches to ``counts``; holds (b)'s sums and parameters across
    grids and its epsilon across tp; returns the report."""
    import shutil

    out_dir = os.path.join(ROOT, "build", "phase5k")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    torch.cuda.empty_cache()
    report = {}
    for part, ranks in (("two", 2), ("four", 4), ("full", 2)):
        reports = tp_launch(part, ranks)
        for rep in reports:
            for tag, got in rep["runs"].items():
                for k, v in got.items():
                    counts[k] = counts.get(k, 0) + v
                    paths.setdefault(k, []).append(f"[5k] {tag} rank {rep['rank']}")
        report[part] = [{k: v for k, v in rep.items() if k != "runs"} for rep in reports]
        if part != "full":
            for key, r in reports[0]["train"].items():
                log(f"[5k] (a) {key}: plain == packed bit for bit over {TP_STEPS} steps, losses "
                    f"{r['losses']}; {r['copies_equal']} replicated or duplicated leaves "
                    f"bit-equal across their groups; the first step's levels of all "
                    f"{r['held_leaves']} leaves of every rank == rqm_quantize_plain, "
                    "pack_flat/unpack_flat == their plain versions")
            for grid, r in reports[0]["fed"].items():
                log(f"[5k] (b) shard engine {grid}: materialized == fused packed == fused dense "
                    f"bit for bit, {TP_FED['rounds']} rounds, held-out loss {r['eval_loss']}, "
                    f"realized {r['realized_n']}; held against their plain versions: "
                    + "; ".join(f"{p}: {', '.join(r[p]['held'])}" for p in
                                ("materialized", "fused packed", "fused dense"))
                    + ("" if "release_rel_err" not in r else
                       f"; the tensor-parallel client release on cuda == on cpu within "
                       f"{TP_GRAD_RTOL} of the largest (+ steps spacings of the parameter "
                       f"above one step), by local steps {r['release_rel_err']}"))
    fed = {g: torch.load(os.path.join(out_dir, f"fed_{g}.pt"))
           for ranks in TP_FED_GRIDS.values() for g in ranks}
    a, b = fed["2x2"], fed["1x2"]
    if not (torch.equal(a["flat"], b["flat"]) and len(a["sums"]) == len(b["sums"])
            and all(torch.equal(x, y) for x, y in zip(a["sums"], b["sums"]))):
        raise AssertionError("[5k] (b) shards=2 x model_shards=2 differs from 1 x 2")
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.fed.config import FedConfig

    mech, n = make_mechanism(TP_FED_SPEC), TP_FED["clients_per_round"]
    full = [mech.per_round_epsilon(n, al) for al in FedConfig().accountant_alphas]
    for g, r in fed.items():
        if r["per_round_eps"] != full or r["realized_n"] != [n] * TP_FED["rounds"]:
            raise AssertionError(f"[5k] (b) {g}: eps {r['per_round_eps']} != {full} or "
                                 f"realized {r['realized_n']}")
    if not math.isclose(a["rdp8"], TP_FED["rounds"] * mech.per_round_epsilon(n, 8.0),
                        rel_tol=1e-12):
        raise AssertionError(f"[5k] (b) 2x2: eps(8) {a['rdp8']}")
    log(f"[5k] (b) shards=2 x model_shards=2 == shards=1 x model_shards=2 bit for bit in every "
        f"round's sum and the parameters; each grid (2x2, 1x2, 2x1) accounted at the full "
        f"cohort of {n}, eps equal across tp: {full}")
    report["fed_equal_across_grids"] = True
    full_width = [r["full_width"] for r in report["full"]]
    f0 = full_width[0]
    log(f"[5k] (c) {f0['arch']} full width at 1x2 ({f0['params']} parameters, "
        f"{[r['local_params'] for r in full_width]} a rank), batch {f0['batch']} x seq "
        f"{f0['seq']}, {f0['steps']} steps, backend {f0['backend']}: losses {f0['losses']}; step "
        f"ms {[r['step_ms'] for r in full_width]} (median after the first "
        f"{[r['step_ms_median_after_first'] for r in full_width]}), tokens/s "
        f"{[r['tokens_per_s'] for r in full_width]}; host dispatch ms "
        f"{[r['host_dispatch_ms'] for r in full_width]}; profiled step busy ms "
        f"{[r['profiled_step']['device_busy_ms'] for r in full_width]}, host ms "
        f"{[r['profiled_step']['host_ms'] for r in full_width]}, device launches "
        f"{[r['profiled_step']['device_launches'] for r in full_width]}; collectives "
        f"{[r['collectives'] for r in full_width]}; peak bytes above the start "
        f"{[r['peak_bytes_above_start'] for r in full_width]}; the first leaf of each shape "
        f"(sizes {f0['held_leaf_sizes']}) == rqm_quantize_plain, pack_flat/unpack_flat == "
        f"their plain versions; nvidia-smi: {card}")
    return report


# ---------------------------------------------------------------------------
# phase 5l: serving over a mesh. The ranks run this script with
# ``--serve-worker <part>`` (serve_worker) as 5k's do, each writing
# build/phase5l/<part>_rank<r>.json; the long shape's one-rank check is a
# process of its own (``--serve-check``, serve_check), started after the
# ranks exit.
# ---------------------------------------------------------------------------


def int8_caches(torch, caches) -> tuple:
    """The int8 layout (``cache_meta(kv_quant=True)``) of float caches:
    each attention cache's k and v as ``attention.quant_kv``'s codes and
    per-token scales; SSM states as they are."""
    from repro_torch.models.attention import quant_kv

    out = []
    for c in caches:
        if "k" in c:
            c = {f"{name}{part}": t for name in ("k", "v")
                 for part, t in zip(("", "_scale"), quant_kv(c[name]))}
        out.append(c)
    return tuple(out)


def serve_mesh_reduced(torch, counted, world: int, device) -> dict:
    """Phase 5l (a) on this rank: each mesh of SERVE_MESH_MESHES[world]
    and each reduced config of SERVE_MESH_ARCHS, in both shapes of
    SERVE_MESH_SHAPES, with float32 and int8 caches. ``batch``: the batch
    split over the clients, ``make_prefill_step`` (sequence parallel)
    then SERVE_MESH_STEPS greedy ``make_decode_step`` steps; ``seq``: a
    batch of 1, the one-rank prefill's caches cut to this rank
    (``convert.cache_from_numpy``: the global layers' on their sequence
    over the clients, KV heads over the model axis), flash-decoding. The
    int8 caches are ``int8_caches`` of the prefill's. Each run counted
    (the serve path launches none of the port's kernels); its tokens
    == the one-rank ``prefill`` + ``decode_step`` over the whole
    parameters and caches, this rank's rows, exactly."""
    F32 = dict(compute_dtype=torch.float32, param_dtype=torch.float32)  # as 5l measured
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import cache_from_numpy, shard_from_one_rank
    from repro_torch.distributed.step import make_decode_step, make_plan, make_prefill_step
    from repro_torch.launch.serve import synthetic_prompt
    from repro_torch.models import model
    from repro_torch.models.common import ParallelCtx

    one, report = ParallelCtx(), {}
    for mesh in SERVE_MESH_MESHES[world]:
        plan = make_plan(tuple(int(d) for d in mesh.split("x")), device)
        for arch in SERVE_MESH_ARCHS:
            cfg = get_config(arch, reduced=True)
            params1 = model.init_params(torch.Generator(device).manual_seed(0), cfg, device=device)
            for mode, (B, prompt, cap) in SERVE_MESH_SHAPES.items():
                shape = InputShape("serve", cap, B, "decode")
                toks, _ = synthetic_prompt(cfg, B, prompt, torch.Generator(device).manual_seed(1),
                                           device)
                for quant in (False, True):
                    tag = f"[5l] (a) {arch} {mesh} {mode} {'int8' if quant else 'float32'}"
                    dec, specs = make_decode_step(cfg, plan, shape, kv_quant=quant, **F32)
                    ctx, rows = specs["ctx"], specs["token_rows"]
                    params = shard_from_one_rank(params1, specs["param_meta"], plan.tp,
                                                 ctx.model_index())
                    nxt1, caches1 = model.prefill(params1, cfg, one, toks, shape,
                                                  compute_dtype=torch.float32)
                    if quant:
                        caches1 = int8_caches(torch, caches1)
                    got = []

                    def go():
                        if mode == "batch":
                            pre, pspecs = make_prefill_step(cfg, plan, shape, seq_parallel=True,
                                                            **F32)
                            nxt, caches = pre(params, toks[rows])
                            if quant:
                                caches = int8_caches(torch, caches)
                        else:
                            caches = cache_from_numpy(
                                caches1, specs["cache_meta"], plan.tp, ctx.model_index(),
                                client=ctx.client_index, n_clients=ctx.n_clients, device=device)
                            nxt = nxt1[rows]
                        got.append(nxt)
                        for t in range(SERVE_MESH_STEPS):
                            nxt, caches = dec(params, caches, nxt[:, None], prompt + t)
                            got.append(nxt)

                    counted(tag, {}, go)
                    want = [nxt1]
                    for t in range(SERVE_MESH_STEPS):
                        nxt1, caches1 = model.decode_step(params1, caches1, cfg, one,
                                                          nxt1[:, None], prompt + t,
                                                          compute_dtype=torch.float32)
                        want.append(nxt1)
                    got, want = torch.stack(got, 1), torch.stack(want, 1)[rows]
                    if not torch.equal(got, want):
                        raise AssertionError(f"{tag}: tokens {got.tolist()} != the one-rank "
                                             f"decode's {want.tolist()}")
                    report[tag[9:]] = {"rows": [rows.start, rows.stop], "tokens": got.tolist(),
                                       "seq_shards": ctx.seq_shards if mode == "seq" else 1,
                                       "tp": plan.tp}
                    del params, caches1
    return report


def long_fill(torch, cache_meta, client: int, n_clients: int, device, block: int):
    """This client's caches of ``cache_meta`` (no model axis), every
    attention cache's k and v drawn block by block of ``block`` sequence
    positions: float32 normals from a generator seeded by (layer, k or v,
    the block's global index), so that any sharding on the sequence
    rebuilds the same global cache (a ring is whole, its slots its
    positions); an int8 cache holds ``quant_kv`` of the same values; SSM
    states zero. Returns (caches, {"layer/name/block": float64 sum of
    the block's float32 values}) for the blocks this client holds."""
    from repro_torch.models import meta as meta_lib
    from repro_torch.models.attention import quant_kv

    caches = meta_lib.zeros(cache_meta, 1, n_clients, device)
    sums = {}
    for layer, (c, m) in enumerate(zip(caches, cache_meta)):
        if "k" not in c:
            continue
        for name in ("k", "v"):
            buf = c[name][:, 0]  # (1, kvl, S_local, hd)
            S = buf.shape[2]
            start = client * S if m[name].pspec[3] is not None else 0
            for lo in range(0, S, block):
                b = (start + lo) // block
                g = torch.Generator(device).manual_seed((layer * 2 + (name == "v")) << 24 | b)
                vals = torch.randn((1,) + tuple(buf.shape[1:2]) + (min(block, S - lo),)
                                   + tuple(buf.shape[3:]), generator=g, device=device)
                sums[f"{layer}/{name}/{b}"] = vals.double().sum()
                if buf.dtype == torch.int8:
                    q, sc = quant_kv(vals)
                    buf[:, :, lo:lo + block] = q
                    c[name + "_scale"][:, 0, :, lo:lo + block] = sc
                else:
                    buf[:, :, lo:lo + block] = vals
    return caches, {k: float(v) for k, v in sums.items()}


@contextlib.contextmanager
def hidden_states(model):
    """Records the final hidden state (B, D) that each decode step hands
    ``model.lm_head_argmax``, a copy a call."""
    kept, saved = [], model.lm_head_argmax

    def recording(params, ctx, h):
        kept.append(h.detach().clone())
        return saved(params, ctx, h)

    model.lm_head_argmax = recording
    try:
        yield kept
    finally:
        model.lm_head_argmax = saved


def clocked_collectives(torch, fn) -> dict:
    """``fn()`` with every collective of ``models/common.py`` clocked (a
    synchronisation around each): calls, bytes in, ms, and the whole
    call's ms."""
    from repro_torch.models import common

    clocked = {"calls": 0, "ms": 0.0, "bytes": 0}
    saved = (common._all_reduce, common._gather, common._reduce_scatter)

    def clock(f):
        def timed(x, *args, **kwargs):
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            out = f(x, *args, **kwargs)
            torch.cuda.synchronize()
            clocked["calls"] += 1
            clocked["ms"] += (time.perf_counter() - c0) * 1e3
            clocked["bytes"] += x.numel() * x.element_size()
            return out
        return timed

    common._all_reduce, common._gather, common._reduce_scatter = map(clock, saved)
    try:
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        clocked["step_ms"] = (time.perf_counter() - c0) * 1e3
    finally:
        common._all_reduce, common._gather, common._reduce_scatter = saved
    return clocked


def decode_clock(torch, step, n: int) -> dict:
    """``step(i)`` for i < n: ms a step by CUDA events, the host's ms a
    call; then one more ``step(n - 1)`` under torch.profiler (device busy
    ms, launches, the largest kernels)."""
    from torch.profiler import ProfilerActivity, profile

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    host = []
    ev[0].record()
    for i in range(n):
        h0 = time.perf_counter()
        step(i)
        host.append((time.perf_counter() - h0) * 1e3)
        ev[i + 1].record()
    torch.cuda.synchronize()
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(n)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(n - 1)
        torch.cuda.synchronize()
    by_kernel = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in by_kernel) / 1e3
    launches = sum(str(e.device_type).endswith("CUDA") for e in prof.events())
    steady = ms[1:]
    return {"step_ms": ms, "median_ms": statistics.median(steady), "min_ms": min(steady),
            "max_ms": max(steady), "host_ms": host, "host_median_ms": statistics.median(host[1:]),
            "profiled_busy_ms": busy, "profiled_launches": launches,
            "top_kernels_ms": {demangle(e.key)[:80]: e.device_time_total / 1e3
                               for e in by_kernel[:5]}}


def serve_long_run(torch, counted, ctx, dec, params, cfg, caches, pos0: int, steps: int,
                   tag: str) -> dict:
    """SERVE_LONG's decode: ``steps`` greedy steps from token 7 at
    ``pos0`` (counted), their tokens and final hidden states; then the
    clocks (``decode_clock`` over the last position again,
    ``clocked_collectives`` of one more step)."""
    from repro_torch.models import model

    got = {}

    def go():
        nxt = torch.full((1,), 7, dtype=torch.int32, device=params["final_norm"].device)
        tokens = []
        with hidden_states(model) as kept:
            for t in range(steps):
                nxt, _ = dec(params, caches, cfg, ctx, nxt[:, None], pos0 + t)
                tokens.append(int(nxt[0]))
        got["tokens"], got["hidden"] = tokens, torch.cat(kept).cpu()

    counted(tag, {}, go)
    last = pos0 + steps - 1
    one = torch.full((1, 1), got["tokens"][-1], dtype=torch.int32,
                     device=params["final_norm"].device)
    clock = decode_clock(torch, lambda i: dec(params, caches, cfg, ctx, one, last), steps)
    clock["collectives"] = clocked_collectives(
        torch, lambda: dec(params, caches, cfg, ctx, one, last))
    return {**got, **clock}


def serve_long_rank(torch, counted, device) -> dict:
    """Phase 5l (b) on this rank of SERVE_LONG_MESH: SERVE_LONG's arch at
    full width (a CUDA generator's tree, whole on each rank) at its input
    shape, a batch of 1: ``make_decode_step`` with the global layers'
    caches sequence-sharded over the client ranks, filled by
    ``long_fill``, float32 then int8; SERVE_LONG's steps from the
    cache's last positions. Per run: tokens, hidden states (to
    build/phase5l), block sums, clocks, peak memory, the bound."""
    F32 = dict(compute_dtype=torch.float32, param_dtype=torch.float32)  # as 5l measured
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import leaves
    from repro_torch.distributed.step import make_decode_step, make_plan
    from repro_torch.models import model

    arch, shape_name, steps, want_params = SERVE_LONG
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    plan = make_plan(SERVE_LONG_MESH, device)
    params = model.init_params(torch.Generator(device).manual_seed(0), cfg, device=device)
    n_params = sum(t.numel() for t in leaves(params))
    if n_params != want_params:
        raise AssertionError(f"[5l] (b) {arch}: {n_params} parameters")
    weight_bytes = 4 * (n_params - params["embed"].numel())
    report = {"arch": arch, "shape": shape_name, "seq": shape.seq_len, "params": n_params}
    for quant in (False, True):
        kind = "int8" if quant else "float32"
        fn, specs = make_decode_step(cfg, plan, shape, kv_quant=quant, **F32)
        ctx = specs["ctx"]
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        start_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        caches, sums = long_fill(torch, specs["cache_meta"], ctx.client_index, ctx.n_clients,
                                 device, SERVE_LONG_BLOCK)
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        cache_bytes = sum(t.numel() * t.element_size() for t in leaves(caches))
        run = serve_long_run(torch, counted, ctx,
                             lambda p, c, cfg_, ctx_, tok, pos: fn(p, c, tok, pos),
                             params, cfg, caches, shape.seq_len - steps, steps,
                             f"[5l] (b) {arch} {kind}")
        hidden = run.pop("hidden")
        torch.save(hidden, os.path.join(ROOT, "build", "phase5l",
                                        f"long_{kind}_rank{torch.distributed.get_rank()}.pt"))
        b = bound(weight_bytes + cache_bytes)
        report[kind] = {**run, "fill_s": fill_s, "block_sums": sums, "cache_bytes": cache_bytes,
                        "weight_bytes": weight_bytes, "bound_ms": b[0], "bound_by": b[1],
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "peak_bytes_above_start": torch.cuda.max_memory_allocated() - start_bytes,
                        "seq_shards": ctx.seq_shards, "client": ctx.client_index}
        del caches
    del params
    torch.cuda.empty_cache()
    return report


def serve_check() -> int:
    """Phase 5l (b)'s one-rank check, a process of its own after the
    ranks exit: SERVE_LONG's arch at full width (the same generator's
    tree), the whole cache of each layer from ``long_fill``, unsharded
    ``model.decode_step`` from the same token and position, float32 then
    int8: tokens, hidden states, block sums, clocks, to
    build/phase5l/check.json (hidden states beside it)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import leaves
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.models.common import ParallelCtx

    arch, shape_name, steps, _ = SERVE_LONG
    cfg, shape, ctx = get_config(arch), INPUT_SHAPES[shape_name], ParallelCtx()
    params = model.init_params(torch.Generator("cuda").manual_seed(0), cfg, device="cuda")
    report = {}

    def counted(tag, expect, fn):
        ops.reset_launches()
        fn()
        torch.cuda.synchronize()
        if dict(ops.launches) != expect:
            raise AssertionError(f"{tag}: launch counts {dict(ops.launches)}")

    for quant in (False, True):
        kind = "int8" if quant else "float32"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        caches, sums = long_fill(torch, model.cache_meta(cfg, 1, shape, (), dtype=torch.float32,
                                                         kv_quant=quant), 0, 1, "cuda",
                                 SERVE_LONG_BLOCK)
        run = serve_long_run(
            torch, counted, ctx, lambda p, c, cfg_, ctx_, tok, pos: model.decode_step(
                p, c, cfg_, ctx_, tok, pos, compute_dtype=torch.float32), params, cfg, caches,
            shape.seq_len - steps, steps,
            f"[5l] (b) one-rank {kind}")
        torch.save(run.pop("hidden"), os.path.join(ROOT, "build", "phase5l", f"long_{kind}_check.pt"))
        report[kind] = {**run, "block_sums": sums,
                        "cache_bytes": sum(t.numel() * t.element_size() for t in leaves(caches)),
                        "peak_bytes": torch.cuda.max_memory_allocated()}
        del caches
    with open(os.path.join(ROOT, "build", "phase5l", "check.json"), "w") as f:
        json.dump(report, f)
    return 0


def serve_axis_rank(torch, counted, device) -> dict:
    """Phase 5l (c) on this rank of SERVE_AXIS_MESH: SERVE_AXIS_ARCH at
    full width, this rank's slices of phase 5i's tree (the same
    generator's one-rank tree, ``convert.shard_from_one_rank``), at 5i's
    batch, prompt and capacity: ``make_prefill_step`` (sequence parallel)
    of 5i's prompt, then ``make_decode_step`` teacher-forced on 5i's
    generated tokens (counted); every next token == 5i's. Clocks as
    (b)'s, over 5i's last position."""
    F32 = dict(compute_dtype=torch.float32, param_dtype=torch.float32)  # as 5l measured
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import leaves, shard_from_one_rank
    from repro_torch.distributed.step import make_decode_step, make_plan, make_prefill_step
    from repro_torch.models import model

    served = torch.load(os.path.join(ROOT, "build", "phase5l", "serve_5i.pt"))
    toks, gen = served["toks"].to(device), served["gen"].to(device)
    B, prompt = toks.shape
    gen_len = gen.shape[1]
    cfg = get_config(SERVE_AXIS_ARCH)
    plan = make_plan(SERVE_AXIS_MESH, device)
    shape = InputShape("serve", prompt + gen_len, B, "decode")
    pre, pspecs = make_prefill_step(cfg, plan, shape, seq_parallel=True, **F32)
    dec, specs = make_decode_step(cfg, plan, shape, **F32)
    ctx, rows = specs["ctx"], specs["token_rows"]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device).manual_seed(0), cfg, device=device)
    params = shard_from_one_rank(params, specs["param_meta"], plan.tp, ctx.model_index())
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    local_params = sum(t.numel() for t in leaves(params))
    toks, gen = toks[rows], gen[rows]
    got = {}

    def go():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        nxt, caches = pre(params, toks)
        ev[1].record()
        torch.cuda.synchronize()
        got["prefill_ms"] = ev[0].elapsed_time(ev[1])
        out = [nxt]
        for i in range(gen_len - 1):
            nxt, caches = dec(params, caches, gen[:, i:i + 1], prompt + i)
            out.append(nxt)
        got["tokens"], got["caches"] = torch.stack(out, 1), caches

    counted(f"[5l] (c) {SERVE_AXIS_ARCH} 1x2", {}, go)
    if not torch.equal(got["tokens"], gen):
        bad = (got["tokens"] != gen).nonzero().tolist()
        raise AssertionError(f"[5l] (c) next tokens differ from phase 5i's at (row, step) {bad}")
    caches, last = got.pop("caches"), prompt + gen_len - 1
    one = gen[:, -1:]
    clock = decode_clock(torch, lambda i: dec(params, caches, one, last), gen_len - 1)
    clock["collectives"] = clocked_collectives(torch, lambda: dec(params, caches, one, last))
    report = {"arch": SERVE_AXIS_ARCH, "mesh": "x".join(map(str, SERVE_AXIS_MESH)),
              "batch": B, "prompt": prompt, "generated": gen_len, "init_s": init_s,
              "local_params": local_params, "prefill_ms": got["prefill_ms"],
              "seq_parallel": pspecs["ctx"].seq_parallel, **clock,
              "tokens_per_s": B / clock["median_ms"] * 1e3,
              "phase_5i_decode_ms": served["decode_ms"],
              "peak_bytes": torch.cuda.max_memory_allocated(),
              "peak_bytes_above_start": torch.cuda.max_memory_allocated() - start_bytes}
    del params, caches
    torch.cuda.empty_cache()
    return report


def serve_worker(part: str) -> int:
    """One rank of a phase 5l launch (``--serve-worker two|four|full``),
    as ``tp_worker``: ``two``/``four`` run (a) at the meshes of their
    ranks, ``full`` runs (b) then (c); each run counted, the report to
    build/phase5l/<part>_rank<r>.json."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    device = train._device("cuda")
    train._init_from_env(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    runs = {}

    def counted(tag, expect, fn):
        ops.reset_launches()
        fn()
        torch.cuda.synchronize()
        got = dict(ops.launches)
        if got != expect:
            raise AssertionError(f"{tag} (rank {rank}): launch counts {got}, expected {expect}")
        runs[tag] = got

    report = {"rank": rank, "world": world, "backend": dist.get_backend(), "device": str(device)}
    if part == "full":
        report["long"] = serve_long_rank(torch, counted, device)
        dist.barrier()
        report["model_axis"] = serve_axis_rank(torch, counted, device)
    else:
        report["reduced"] = serve_mesh_reduced(torch, counted, world, device)
    report["runs"] = runs
    with open(os.path.join(ROOT, "build", "phase5l", f"{part}_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def serve_phase(torch, served: dict, card: str) -> dict:
    """Phase 5l: serving over a mesh on the one card. Writes phase 5i's
    SERVE_AXIS_ARCH tokens for (c); three launches of ranks
    (serve_worker): (a) on 2 and on 4 ranks, (b) and (c) on 2; then
    serve_check. Holds (b)'s ranks against the check: block sums equal,
    tokens equal, hidden states within SERVE_LONG_HIDDEN_RTOL of the
    largest; returns the report."""
    import shutil

    out_dir = os.path.join(ROOT, "build", "phase5l")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    torch.save(served, os.path.join(out_dir, "serve_5i.pt"))
    torch.cuda.empty_cache()
    report = {}
    for part, ranks in (("two", 2), ("four", 4), ("full", 2)):
        reports = tp_launch(part, ranks, phase="5l")
        report[part] = [{k: v for k, v in rep.items() if k != "runs"} for rep in reports]
        if part != "full":
            for key, r in reports[0]["reduced"].items():
                log(f"[5l] (a) {key}: prefill + {SERVE_MESH_STEPS} decode steps on {ranks} ranks "
                    f"== the one-rank decode, every rank's rows: {r['tokens']}")
    t0 = time.perf_counter()
    check = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-check"],
                           cwd=ROOT, capture_output=True, text=True, timeout=TP_TIMEOUT)
    if check.returncode:
        raise AssertionError(f"[5l] (b) one-rank check exited {check.returncode}:\n"
                             f"{(check.stdout + check.stderr)[-6000:]}")
    log(f"[5l] (b) one-rank check in {time.perf_counter() - t0} s")
    with open(os.path.join(out_dir, "check.json")) as f:
        want = json.load(f)
    long = [r["long"] for r in report["full"]]
    for kind in ("float32", "int8"):
        ref = want[kind]
        h_ref = torch.load(os.path.join(out_dir, f"long_{kind}_check.pt"))
        errs = []
        for r, rep in enumerate(long):
            mine = rep[kind]
            for k, v in mine["block_sums"].items():
                if ref["block_sums"][k] != v:
                    raise AssertionError(f"[5l] (b) {kind} rank {r}: block {k} sum {v} != "
                                         f"{ref['block_sums'][k]}")
            if mine["tokens"] != ref["tokens"]:
                raise AssertionError(f"[5l] (b) {kind} rank {r}: tokens {mine['tokens']} != the "
                                     f"one-rank decode's {ref['tokens']}")
            h = torch.load(os.path.join(out_dir, f"long_{kind}_rank{r}.pt"))
            err = float((h - h_ref).abs().max() / h_ref.abs().max())
            if not err <= SERVE_LONG_HIDDEN_RTOL:
                raise AssertionError(f"[5l] (b) {kind} rank {r}: hidden states {err} of the "
                                     f"largest from the one-rank decode's")
            errs.append(err)
        covered = set().union(*(rep[kind].pop("block_sums") for rep in long))
        if covered != set(ref["block_sums"]):  # the rings' blocks on every rank
            raise AssertionError(f"[5l] (b) {kind}: the ranks hold {len(covered)} blocks of "
                                 f"{len(ref['block_sums'])}")
        report.setdefault("long_check", {})[kind] = {
            "tokens": ref["tokens"], "hidden_rel_err": errs,
            "one_rank": {k: ref[k] for k in ("median_ms", "min_ms", "max_ms", "host_median_ms",
                                             "profiled_busy_ms", "profiled_launches",
                                             "top_kernels_ms", "cache_bytes", "peak_bytes")}}
        two = [rep[kind] for rep in long]
        log(f"[5l] (b) {long[0]['arch']} full width ({long[0]['params']} parameters) at "
            f"{long[0]['shape']} (sequence {long[0]['seq']}, batch 1), {kind} caches sharded "
            f"on the sequence over 2 ranks: tokens {ref['tokens']} == the one-rank decode's, "
            f"hidden states within {errs} of the largest (tolerance {SERVE_LONG_HIDDEN_RTOL}); "
            f"decode ms a step, median (min-max) "
            f"{[(t['median_ms'], t['min_ms'], t['max_ms']) for t in two]}; bound ms a rank "
            f"{[t['bound_ms'] for t in two]} ({two[0]['bound_by']}: weights "
            f"{two[0]['weight_bytes']} B + caches {[t['cache_bytes'] for t in two]} B); host "
            f"dispatch ms {[t['host_median_ms'] for t in two]}, busy ms "
            f"{[t['profiled_busy_ms'] for t in two]} in {[t['profiled_launches'] for t in two]} "
            f"launches (largest kernels {two[0]['top_kernels_ms']}); seq collectives a step "
            f"{[t['collectives'] for t in two]}; peak a rank {[t['peak_bytes'] for t in two]} B "
            f"({[t['peak_bytes_above_start'] for t in two]} above the parameters); one-rank "
            f"{ref['median_ms']} ms a step ({ref['min_ms']}-{ref['max_ms']}), busy "
            f"{ref['profiled_busy_ms']} ms (largest kernels {ref['top_kernels_ms']}), peak "
            f"{ref['peak_bytes']} B; nvidia-smi: {card}")
    axis = [r["model_axis"] for r in report["full"]]
    a0 = axis[0]
    log(f"[5l] (c) {a0['arch']} full width at {a0['mesh']} ({[r['local_params'] for r in axis]} "
        f"parameters a rank), batch {a0['batch']}, prompt {a0['prompt']} (sequence parallel "
        f"{a0['seq_parallel']}), {a0['generated']} tokens teacher-forced: every next token == "
        f"phase 5i's; prefill ms {[r['prefill_ms'] for r in axis]}; decode ms a step, median "
        f"(min-max) {[(r['median_ms'], r['min_ms'], r['max_ms']) for r in axis]} against 5i's "
        f"{a0['phase_5i_decode_ms']} at tp = 1; host dispatch ms "
        f"{[r['host_median_ms'] for r in axis]}, busy ms {[r['profiled_busy_ms'] for r in axis]}; "
        f"model-axis collectives a step {[r['collectives'] for r in axis]}; peak a rank "
        f"{[r['peak_bytes'] for r in axis]} B; nvidia-smi: {card}")
    return report


# ---------------------------------------------------------------------------
# phase 5m: the LM steps at the reference's own precision and memory
# options. (a) and (c) run as ranks of this script (``--opt-worker
# variants|zero1``, launched as 5k's), each writing
# build/phase5m/<part>_rank<r>.json; (b) and (d) run in this process.
# ---------------------------------------------------------------------------


def opt_variants(torch, counted) -> dict:
    """Phase 5m (a), on one rank of OPT_MESH: each of OPT_ARCHS reduced,
    each of OPT_VARIANTS through ``make_train_step`` (float32 compute,
    the reference's remat), OPT_STEPS steps on one batch, each run
    counted (``rqm_quantize`` once a leaf a step); holds int16 == base
    bit for bit (parameters and losses), ZeRO-1 within OPT_ZERO1_ATOL of
    the base losses, every run's losses finite and falling."""
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import leaves
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.distributed.step import (make_plan, make_train_step, train_seeds,
                                              zero1_master_shard)
    from repro_torch.launch import hlo_analysis
    from repro_torch.models import meta as meta_lib
    from repro_torch.models import model
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedules import constant

    mech, opt = make_mechanism(OPT_SPEC), make_optimizer("sgd")
    lr_fn = constant(OPT_LR, device="cuda")
    plan = make_plan(OPT_MESH, "cuda")
    shape = InputShape("t", OPT_SEQ, OPT_BATCH, "train")
    report = {}
    for arch in OPT_ARCHS:
        cfg = get_config(arch, reduced=True)
        tokens = torch.randint(0, cfg.vocab_size, (OPT_BATCH, OPT_SEQ), dtype=torch.int32,
                               generator=torch.Generator("cuda").manual_seed(2), device="cuda")
        batch = {"tokens": tokens, "labels": tokens}
        runs = {}
        for name, kw in OPT_VARIANTS.items():
            step_fn, specs = make_train_step(cfg, plan, mech, opt, lr_fn, shape,
                                             compute_dtype=torch.float32, **kw)
            ctx, shards = specs["ctx"], specs["shard_seeds"]
            params = model.init_params(torch.Generator("cuda").manual_seed(1), cfg,
                                       device="cuda", tp=plan.tp,
                                       keep=meta_lib.slicer(plan.tp, ctx.model_index()))
            n = len(leaves(params))
            state = ({"master": zero1_master_shard(params, ctx)} if kw.get("zero1")
                     else opt.init(params))
            losses, collectives = [], []
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(OPT_STEPS + 1)]

            def go():
                nonlocal params, state
                ev[0].record()
                for t in range(OPT_STEPS):
                    # phase 5n (c): the first step's collectives
                    with hlo_analysis.recording() as rec:
                        params, state, m = step_fn(params, state, t, batch,
                                                   train_seeds(0, t, ctx.client_index, n, shards))
                    if t == 0:
                        collectives.extend(list(r) for r in rec)
                    ev[t + 1].record()
                    losses.append(m["loss"])

            counted(f"[5m] (a) {arch} {name}", {"rqm_quantize": OPT_STEPS * n}, go)
            losses = [float(v) for v in losses]
            if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
                raise AssertionError(f"[5m] (a) {arch} {name}: losses {losses}")
            runs[name] = {"losses": losses, "leaves": n,
                          "step_ms": [ev[i].elapsed_time(ev[i + 1]) for i in range(OPT_STEPS)],
                          "digests": tp_digests(torch, params), "collectives": collectives}
            del params, state
        base = runs["base"]
        if runs["int16"]["digests"] != base["digests"] or runs["int16"]["losses"] != base["losses"]:
            raise AssertionError(f"[5m] (a) {arch}: int16 differs from int32")
        gap = max(abs(a - b) for a, b in zip(runs["zero1"]["losses"], base["losses"]))
        if gap > OPT_ZERO1_ATOL:
            raise AssertionError(f"[5m] (a) {arch}: ZeRO-1 {gap} from the base losses")
        report[arch] = {name: {k: v for k, v in r.items() if k != "digests"}
                        for name, r in runs.items()}
        report[arch]["zero1_loss_gap"] = gap
        report[arch]["zero1_params_equal_base"] = runs["zero1"]["digests"] == base["digests"]
    return report


def opt_zero1_rank(torch, counted, layers: int) -> dict:
    """Phase 5m (c), on one rank of OPT_ZERO1_MESH: TRAIN_FULL's arch at
    ``layers`` blocks (all: full width), ZeRO-1 with bfloat16 parameters
    and compute, remat, ``agg_dtype="auto"``, rqm and sgd at 5j's rate,
    its steps on 5j's batches (this client's row), counted; step ms,
    host dispatch ms, peak above the start and the memory model's
    estimate, a rank."""
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import leaves
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.distributed.step import (make_plan, make_train_step, train_seeds,
                                              zero1_master_shard)
    from repro_torch.eval.lm_eval import batch_to
    from repro_torch.launch.memory_model import estimate
    from repro_torch.models import model
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedules import warmup_cosine

    arch, batch, seq, steps, _ = TRAIN_FULL
    cfg = get_config(arch)
    if layers < cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=layers, layers=cfg.layers[:layers])
    mech, opt = make_mechanism(SPECS["rqm"]), make_optimizer("sgd")
    lr_fn = warmup_cosine(0.2, warmup=steps // 10 + 1, total_steps=steps, device="cuda")
    shape = InputShape("cli", seq, batch, "train")
    plan = make_plan(OPT_ZERO1_MESH, "cuda")
    step_fn, specs = make_train_step(cfg, plan, mech, opt, lr_fn, shape, zero1=True,
                                     compute_dtype=torch.bfloat16, agg_dtype="auto")
    ctx = specs["ctx"]
    pipe = TokenPipeline(cfg, seq, batch, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(torch.Generator("cuda").manual_seed(1), cfg, device="cuda",
                               dtype=torch.bfloat16)
    state = {"master": zero1_master_shard(params, ctx)}
    n = len(leaves(params))
    losses, host_ms = [], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]

    def go():
        nonlocal params, state
        ev[0].record()
        for t in range(steps):
            b = batch_to(pipe.batch(t), "cuda")
            h0 = time.perf_counter()
            params, state, m = step_fn(params, state, t, b, train_seeds(0, t, ctx.client_index, n))
            host_ms.append((time.perf_counter() - h0) * 1e3)
            ev[t + 1].record()
            losses.append(m["loss"])

    counted(f"[5m] (c) {arch} ZeRO-1 {layers} layers", {"rqm_quantize": steps * n}, go)
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"[5m] (c): losses {losses}")
    est = estimate(cfg, shape, dict(zip(("data", "model"), OPT_ZERO1_MESH)), zero1=True)
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    return {"arch": arch, "layers": layers, "full_depth": layers == get_config(arch).num_layers,
            "params": sum(t.numel() for t in leaves(params)), "leaves": n,
            "master_bytes": sum(t.numel() * 4 for t in leaves(state["master"])),
            "batch": batch, "seq": seq, "steps": steps, "losses": losses, "step_ms": step_ms,
            "step_ms_median_after_first": statistics.median(step_ms[1:]), "host_ms": host_ms,
            "peak_bytes_above_start": torch.cuda.max_memory_allocated() - start_bytes,
            "estimate": est, "client": ctx.client_index}


def opt_worker(part: str, *args) -> int:
    """One rank of a phase 5m launch (``--opt-worker variants`` on four
    ranks, ``--opt-worker zero1 <layers>`` on two), as 5k's tp_worker:
    each run counted and held to the launches it must make; the report in
    build/phase5m/<part>_rank<r>.json."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    device = train._device("cuda")
    train._init_from_env(device)
    rank = dist.get_rank()
    runs = {}

    def counted(tag, expect, fn):
        ops.reset_launches()
        fn()
        torch.cuda.synchronize()
        got = dict(ops.launches)
        if got != expect:
            raise AssertionError(f"{tag} (rank {rank}): launch counts {got}, expected {expect}")
        runs[tag] = got

    report = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend(),
              "device": str(device)}
    if part == "variants":
        report["variants"] = opt_variants(torch, counted)
    else:
        report["zero1"] = opt_zero1_rank(torch, counted, int(args[0]))
    report["runs"] = runs
    with open(os.path.join(ROOT, "build", "phase5m", f"{part}_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def opt_bf16_full_width(torch, counted, card: str, f32: dict) -> dict:
    """Phase 5m (b): 5j (c)'s step (TRAIN_FULL, the same parameters,
    batches, seeds and rate) in bfloat16 with remat, float32 parameters
    (the reference's ``make_train_step`` defaults), each step counted;
    step ms (CUDA events), host dispatch ms, peak above the start beside
    the memory model's estimate; one more step under torch.profiler
    (busy ms, launches); its bound: the products' operations at bfloat16's
    tensor-core peak, the float32 parameters read, gradients written and
    parameters written over HBM's rate, the larger. Gate: the first loss
    within BF16_LOSS_RTOL of 5j's float32 one (``f32``, 5j's report)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import leaves
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.distributed.step import build_train_step_fn, train_seeds
    from repro_torch.eval.lm_eval import batch_to
    from repro_torch.launch.memory_model import estimate
    from repro_torch.models import model
    from repro_torch.models.common import ParallelCtx
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedules import warmup_cosine

    arch, batch, seq, steps, want_params = TRAIN_FULL
    cfg = get_config(arch)
    mech, opt = make_mechanism(SPECS["rqm"]), make_optimizer("sgd")
    lr_fn = warmup_cosine(0.2, warmup=steps // 10 + 1, total_steps=steps, device="cuda")
    pipe = TokenPipeline(cfg, seq, batch, seed=0)
    step_fn = build_train_step_fn(cfg, mech, opt, lr_fn, ParallelCtx(), remat=True,
                                  compute_dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(torch.Generator("cuda").manual_seed(1), cfg, device="cuda")
    n_params, n = sum(t.numel() for t in leaves(params)), len(leaves(params))
    if n_params != want_params:
        raise AssertionError(f"[5m] (b) {arch}: {n_params} parameters")
    state, losses, host_ms = opt.init(params), [], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]

    def go():
        nonlocal params, state
        ev[0].record()
        for t in range(steps):
            b = batch_to(pipe.batch(t), "cuda")
            h0 = time.perf_counter()
            params, state, m = step_fn(params, state, t, b, train_seeds(0, t, 0, n))
            host_ms.append((time.perf_counter() - h0) * 1e3)
            ev[t + 1].record()
            losses.append(m["loss"])

    counted(f"[5m] (b) {arch} bfloat16 remat", {"rqm_quantize": steps * n}, go)
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    peak = torch.cuda.max_memory_allocated() - start_bytes
    losses = [float(v) for v in losses]
    f32_loss = f32["losses"][0]
    if not all(math.isfinite(v) for v in losses) or \
            abs(losses[0] - f32_loss) > BF16_LOSS_RTOL * abs(f32_loss):
        raise AssertionError(f"[5m] (b): bfloat16 losses {losses} against float32 {f32['losses']}")
    b = batch_to(pipe.batch(steps), "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        params, state, _ = step_fn(params, state, steps, b, train_seeds(0, steps, 0, n))
        profiled_host_ms = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
    by_kernel = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in by_kernel) / 1e3
    quantize_ms = sum(e.device_time_total for e in by_kernel if "quantize_kernel" in e.key) / 1e3
    del params, state
    torch.cuda.empty_cache()
    tokens = batch * seq
    matmul = n_params - cfg.padded_vocab(1) * cfg.d_model  # all but the embedding table
    bound_ops = 6 * matmul * tokens / BF16_FLOPS_PER_S * 1e3
    bound_bytes = 3 * 4 * n_params / HBM_BYTES_PER_S * 1e3
    est = estimate(cfg, InputShape("cli", seq, batch, "train"), {"data": 1, "model": 1})
    median = statistics.median(step_ms[1:])
    report = {"arch": arch, "params": n_params, "leaves": n, "batch": batch, "seq": seq,
              "steps": steps, "losses": losses, "float32_losses": f32["losses"],
              "step_ms": step_ms, "step_ms_median_after_first": median,
              "tokens_per_s": tokens / median * 1e3,
              "float32_step_ms_median_after_first": f32["step_ms_median_after_first"],
              "host_dispatch_ms": host_ms, "profiled_host_ms": profiled_host_ms,
              "device_busy_ms": busy, "quantize_ms": quantize_ms,
              "device_launches": sum(str(e.device_type).endswith("CUDA") for e in prof.events()),
              "top_kernels_ms": {demangle(e.key)[:80]: e.device_time_total / 1e3
                                 for e in by_kernel[:8]},
              "peak_bytes_above_start": peak, "estimate": est,
              "bound_ms": max(bound_ops, bound_bytes),
              "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
              "bound_ops_ms": bound_ops, "bound_bytes_ms": bound_bytes, "nvidia_smi": card}
    log(f"[5m] (b) {arch} full width, bfloat16 compute with remat, float32 parameters, batch "
        f"{batch} x seq {seq}: losses {losses} (5j float32 {f32['losses']}); step ms {step_ms} "
        f"(5j float32 median {f32['step_ms_median_after_first']}); {report['tokens_per_s']} "
        f"tokens/s; host dispatch ms {host_ms}; profiled step busy {busy} ms in "
        f"{report['device_launches']} launches (quantize {quantize_ms} ms), host "
        f"{profiled_host_ms} ms; peak {peak} B above the start, estimate {est['total']} B; "
        f"bound {report['bound_ms']} ms ({report['bound_by']}); nvidia-smi: {card}")
    return report


def opt_bf16_decode(torch, counted, card: str, served: dict) -> dict:
    """Phase 5m (d): 5i's SERVE_AXIS_ARCH decode at its shape (batch,
    prompt, generated; 5i's prompt), on bfloat16 parameters of the same
    draws, bfloat16 compute and caches (the reference's serve defaults):
    prefill ms, decode ms a step (CUDA events, median after the first),
    peak above the start, and how many tokens agree with 5i's float32
    ones (reported, not gated: bfloat16 logits tie and part from float32's
    within a few steps). Counted: serving launches no kernel."""
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model
    from repro_torch.models.common import ParallelCtx

    arch = SERVE_AXIS_ARCH
    batch, prompt, gen_len, _ = SERVE_FULL[arch]
    cfg, ctx = get_config(arch), ParallelCtx()
    toks, want = served["toks"].cuda(), served["gen"]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(torch.Generator("cuda").manual_seed(0), cfg, device="cuda",
                               dtype=torch.bfloat16)
    shape = InputShape("serve", prompt + gen_len, batch, "decode")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(gen_len + 1)]
    out = []

    def go():
        ev[0].record()
        nxt, caches = model.prefill(params, cfg, ctx, toks, shape)
        ev[1].record()
        out.append(nxt)
        for i in range(gen_len - 1):
            nxt, caches = model.decode_step(params, caches, cfg, ctx, nxt[:, None], prompt + i)
            ev[i + 2].record()
            out.append(nxt)

    with torch.no_grad():
        counted(f"[5m] (d) {arch} bfloat16 decode", {}, go)
    peak = torch.cuda.max_memory_allocated() - start_bytes
    gen = torch.stack(out, 1).cpu()
    del params, out
    torch.cuda.empty_cache()
    step_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(gen_len - 1)]
    same = gen == want
    first_diff = [int(row.logical_not().nonzero()[0]) if not row.all() else gen_len
                  for row in same]
    report = {"arch": arch, "batch": batch, "prompt": prompt, "generated": gen_len,
              "prefill_ms": ev[0].elapsed_time(ev[1]), "decode_ms_per_step":
              statistics.median(step_ms[1:]), "decode_ms": step_ms,
              "float32_decode_ms_per_step": served["decode_ms"],
              "peak_bytes_above_start": peak, "tokens_equal": int(same.sum()),
              "tokens": int(same.numel()), "first_difference_by_row": first_diff,
              "nvidia_smi": card}
    log(f"[5m] (d) {arch} decode, bfloat16 parameters, compute and caches, batch {batch}, prompt "
        f"{prompt}, {gen_len} tokens: prefill {report['prefill_ms']} ms, decode "
        f"{report['decode_ms_per_step']} ms a step (5i float32 {served['decode_ms']}); peak "
        f"{peak} B above the start; {report['tokens_equal']} of {report['tokens']} tokens == "
        f"5i's float32 ones (first difference by row {first_diff}); nvidia-smi: {card}")
    return report


def opt_phase(torch, counts: dict, paths: dict, counted, card: str, f32: dict,
              served: dict) -> dict:
    """Phase 5m: (a) on four ranks, (b) here, (c) on two ranks at full
    depth if twice the memory model's estimate a rank plus what this
    process holds fits the card's free memory (else at
    OPT_ZERO1_REDUCED_LAYERS, said on the line), (d) here. Adds every
    rank's launches to ``counts``."""
    import shutil

    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.memory_model import estimate

    out_dir = os.path.join(ROOT, "build", "phase5m")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    report = {}

    def add(reports, what):
        for rep in reports:
            for tag, got in rep["runs"].items():
                for k, v in got.items():
                    counts[k] = counts.get(k, 0) + v
                    paths.setdefault(k, []).append(f"{tag} rank {rep['rank']}")
        return [{k: v for k, v in rep.items() if k != "runs"} for rep in reports]

    torch.cuda.empty_cache()
    report["variants"] = add(tp_launch("variants", 4, "5m"), "(a)")
    for rep in report["variants"]:  # phase 5n (c) reads them from the ranks' files
        for runs in rep["variants"].values():
            for name in OPT_VARIANTS:
                runs[name].pop("collectives")
    for arch, r in report["variants"][0]["variants"].items():
        log(f"[5m] (a) {arch} reduced at {OPT_MESH[0]}x{OPT_MESH[1]}, float32, {OPT_STEPS} steps "
            f"on one batch: losses " + "; ".join(
                f"{name} {r[name]['losses']} ({r[name]['step_ms']} ms)" for name in OPT_VARIANTS)
            + f"; int16 == base bit for bit; ZeRO-1 {r['zero1_loss_gap']} from base (parameters "
            f"equal: {r['zero1_params_equal_base']}); {r['base']['leaves']} rqm_quantize "
            "launches a step a rank")
    report["bf16_full_width"] = opt_bf16_full_width(torch, counted, card, f32)
    arch, batch, seq = TRAIN_FULL[:3]
    est = estimate(get_config(arch), InputShape("cli", seq, batch, "train"),
                   dict(zip(("data", "model"), OPT_ZERO1_MESH)), zero1=True)["total"]
    gc.collect()  # the earlier phases' trainers and graphs, unreachable but not yet freed
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held = torch.cuda.memory_reserved()
    full = 2 * est + held <= free
    layers = get_config(arch).num_layers if full else OPT_ZERO1_REDUCED_LAYERS
    zero1 = add(tp_launch("zero1", 2, "5m", (str(layers),)), "(c)")
    report["zero1"] = {"estimate_total": est, "card_free_bytes": free, "card_total_bytes": total,
                       "parent_reserved_bytes": held,
                       "parent_allocated_bytes": torch.cuda.memory_allocated(),
                       "full_depth": full,
                       "ranks": [r["zero1"] for r in zero1]}
    z = report["zero1"]["ranks"]
    depth = "full depth" if full else (
        f"REDUCED DEPTH, {layers} layers: twice the estimate {est} B and this process's {held} "
        f"B reserved ({report['zero1']['parent_allocated_bytes']} B allocated) do not fit the "
        f"free {free} B")
    log(f"[5m] (c) {arch} ZeRO-1 over {OPT_ZERO1_MESH[0]}x{OPT_ZERO1_MESH[1]} (two ranks sharing "
        f"the card, {zero1[0]['backend']}), bfloat16 parameters and compute, remat, {depth}, "
        f"{z[0]['params']} parameters: losses {[r['losses'] for r in z]}; step ms "
        f"{[r['step_ms'] for r in z]}; host ms {[r['host_ms'] for r in z]}; peak a rank "
        f"{[r['peak_bytes_above_start'] for r in z]} B against the estimate "
        f"{[r['estimate']['total'] for r in z]} B (card {total} B, total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory} B); nvidia-smi: {card}")
    report["bf16_decode"] = opt_bf16_decode(torch, counted, card, served)
    return report


def dry_one_rank(torch, cfg, params, batch: dict, step: int, shape, card: str) -> dict:
    """Phase 5n (b), inside 5j (c) on its parameters: ``dryrun.build_step``'s
    one-rank train step (rqm, sgd, float32, no remat: 5j's
    ``build_train_step_fn`` over a one-rank plan) counted once on the meta
    device, then run twice on the card, one step timed and one counted
    (``hlo_analysis.counting``). The card's FLOPs and dispatched bytes (the
    kernels' charged traffic included) must equal the meta counts exactly;
    the meta peak is reported beside max_memory_allocated above the
    start, the roofline's terms beside the measured step."""
    from repro_torch.distributed.step import make_plan
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import H100

    kw = dict(mechanism=SPECS["rqm"], remat=False, compute_dtype=torch.float32)
    t0 = time.perf_counter()
    fn, args = dryrun.build_step(cfg, make_plan((1, 1), "meta"), shape, **kw)
    with hlo_analysis.counting() as meta:
        out = fn(*args)
    meta_s = time.perf_counter() - t0
    del out, args
    fn, args = dryrun.build_step(cfg, make_plan((1, 1), "cuda"), shape, device="cuda", **kw)
    seeds = args[4]
    del args
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    new = fn(params, (), step, batch, seeds)
    ev[1].record()
    del new
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev[2].record()
    with hlo_analysis.counting() as real:
        new = fn(params, (), step + 1, batch, seeds)
    ev[3].record()
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - start
    del new
    torch.cuda.empty_cache()
    if real.flops != meta.flops or real.bytes != meta.bytes:
        raise AssertionError(
            f"[5n] (b) the card's counts differ from the meta run's: flops {real.flops} vs "
            f"{meta.flops}, bytes {real.bytes} vs {meta.bytes} (kernels {dict(real.kernel_bytes)}"
            f" vs {dict(meta.kernel_bytes)}), ops {real.ops} vs {meta.ops}")
    if dict(real.kernel_bytes) != dict(meta.kernel_bytes) or real.collectives:
        raise AssertionError(f"[5n] (b) kernel charges {dict(real.kernel_bytes)} vs "
                             f"{dict(meta.kernel_bytes)}, collectives {real.collectives}")
    terms = hlo_analysis.roofline_terms(meta.flops, meta.bytes, 0.0, H100)
    f32_compute_s = meta.flops / F32_FLOPS_PER_S
    step_ms = ev[0].elapsed_time(ev[1])
    rep = {"arch": cfg.name, "batch": shape.global_batch, "seq": shape.seq_len,
           "flops": meta.flops, "bytes": meta.bytes, "kernel_bytes": dict(meta.kernel_bytes),
           "ops_meta": meta.ops, "ops_card": real.ops, "meta_s": meta_s,
           "meta_peak_bytes": meta.peak_bytes, "card_peak_bytes_above_start": peak,
           "peak_gap_bytes": peak - meta.peak_bytes, "roofline_h100": terms,
           "compute_s_at_f32_peak": f32_compute_s,
           "largest_term_ms": max(terms["memory_s"], f32_compute_s) * 1e3,
           "step_ms": step_ms, "counted_step_ms": ev[2].elapsed_time(ev[3]),
           "counted_step_host_s": counted_s, "nvidia_smi": card}
    log(f"[5n] (b) {cfg.name} at full width, batch {shape.global_batch} x seq "
        f"{shape.seq_len}, rqm, sgd, float32, no remat, one rank: the card's FLOPs "
        f"{real.flops} and dispatched bytes {real.bytes} (kernels {dict(real.kernel_bytes)}) == "
        f"the meta run's exactly (ops {real.ops} on the card, {meta.ops} on meta; meta run "
        f"{meta_s} s); peak above the start {peak} B on the card, {meta.peak_bytes} B live "
        f"storages on meta (gap {peak - meta.peak_bytes} B); roofline on the H100: compute "
        f"{terms['compute_s'] * 1e3} ms at the bfloat16 peak, {f32_compute_s * 1e3} ms at "
        f"float32's, memory {terms['memory_s'] * 1e3} ms; measured step {step_ms} ms ("
        f"{rep['counted_step_ms']} ms counted); nvidia-smi: {card}")
    return rep


def dryrun_worker() -> int:
    """Phase 5n (c)'s meta side, a process of its own (``--dryrun-worker``):
    under a fake group of OPT_MESH's ranks, as rank 0, each of OPT_ARCHS
    reduced and each of OPT_VARIANTS through ``dryrun.build_step`` at 5m
    (a)'s plan, shape, spec and float32 compute, once on the meta device,
    its collectives recorded; written to build/phase5n/variants_meta.json."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.step import make_plan
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import fake_world

    shape = InputShape("t", OPT_SEQ, OPT_BATCH, "train")
    out = {}
    with fake_world(math.prod(OPT_MESH)):
        plan = make_plan(OPT_MESH, "meta")
        for arch in OPT_ARCHS:
            cfg = get_config(arch, reduced=True)
            for name, kw in OPT_VARIANTS.items():
                fn, args = dryrun.build_step(cfg, plan, shape, mechanism=OPT_SPEC,
                                             compute_dtype=torch.float32, **kw)
                with hlo_analysis.recording() as rec:
                    fn(*args)
                out.setdefault(arch, {})[name] = [list(r) for r in rec]
    with open(os.path.join(ROOT, "build", "phase5n", "variants_meta.json"), "w") as f:
        json.dump(out, f)
    return 0


def grqm_on_card(torch, card: str) -> dict:
    """Phase 5n (d): the generalised RQM on the card at GRQM_BASE's grid and
    the q vector ``optimize_q`` returns: GRQM_DRAWS draws of ``quantize`` at
    each of GRQM_XS against ``outcome_distribution`` (chi-square, p above
    GRQM_P_MIN; no draw where the pmf is 0), and ``select_levels`` on the
    card == on the CPU bit for bit, on GRQM_EXACT elements' uniforms drawn
    on the card."""
    from scipy import stats

    from repro_torch.core import rqm_general as rg
    from repro_torch.core.grid import RQMParams

    n, alpha, iters = GRQM_OPTIMIZE
    t0 = time.perf_counter()
    p, history = rg.optimize_q(RQMParams(**GRQM_BASE), n, alpha, iters=iters, seed=0)
    opt_s = time.perf_counter() - t0
    gen = torch.Generator("cuda").manual_seed(GRQM_SEED)
    tests = {}
    for x in GRQM_XS:
        z = rg.quantize(torch.full((GRQM_DRAWS,), x, device="cuda"), p, gen)
        counts = torch.bincount(z.to(torch.int64), minlength=p.m).cpu().numpy()
        pmf = rg.outcome_distribution(x, p)
        live = pmf > 0
        if counts[~live].sum():
            raise AssertionError(f"[5n] (d) x={x}: draws at levels of probability 0: {counts}")
        _, pval = stats.chisquare(counts[live], pmf[live] / pmf[live].sum() * GRQM_DRAWS)
        if not pval > GRQM_P_MIN:
            raise AssertionError(f"[5n] (d) x={x}: chi-square p {pval} <= {GRQM_P_MIN}: "
                                 f"counts {counts.tolist()}, pmf {pmf.tolist()}")
        tests[str(x)] = {"p_value": float(pval), "counts": counts.tolist()}
    x = (torch.rand(GRQM_EXACT, generator=gen, device="cuda") * 4 - 2)
    x[:4] = torch.tensor([-p.c, p.c, 0.0, 3.0])
    u_levels = torch.rand((GRQM_EXACT, p.m), generator=gen, device="cuda")
    u_round = torch.rand(GRQM_EXACT, generator=gen, device="cuda")
    on_card = rg.select_levels(x, u_levels, u_round, p).cpu()
    on_cpu = rg.select_levels(x.cpu(), u_levels.cpu(), u_round.cpu(), p)
    if not torch.equal(on_card, on_cpu):
        raise AssertionError(f"[5n] (d) select_levels: {int((on_card != on_cpu).sum())} of "
                             f"{GRQM_EXACT} levels differ between the card and the CPU")
    rep = {"q": list(p.q), "eps_history": [h[0] for h in history], "optimize_s": opt_s,
           "chi_square": tests, "select_levels_equal": GRQM_EXACT, "nvidia_smi": card}
    log(f"[5n] (d) generalised RQM at m={p.m}, q from optimize_q (n={n}, alpha={alpha}, "
        f"{iters} iterations, eps {history[0][0]} -> {history[-1][0]}): {GRQM_DRAWS} draws at "
        f"each of {GRQM_XS} against outcome_distribution, chi-square p "
        f"{[tests[str(x)]['p_value'] for x in GRQM_XS]} (> {GRQM_P_MIN}); select_levels on "
        f"the card == the CPU's on {GRQM_EXACT} elements, bit for bit; nvidia-smi: {card}")
    return rep


def dry_phase(torch, card: str, one_rank: dict) -> dict:
    """Phase 5n: (a)'s runs and (c)'s meta side as processes, DRY_WORKERS
    at once, while (d) runs on the card here; then (a)'s records and (c)'s
    comparison; (b)'s report, made inside 5j (c), is ``one_rank``."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    out_dir = os.path.join(ROOT, "build", "phase5n")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def proc(tag, cmd):
        t0 = time.perf_counter()
        with open(os.path.join(out_dir, f"{tag}.log"), "w") as f:
            rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT, env=env,
                                timeout=DRY_TIMEOUT).returncode
        return rc, time.perf_counter() - t0

    jobs = {f"{a}_{s}": [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
                         "--shape", s, "--out-dir", os.path.join(out_dir, "dryrun")]
            for a, s in DRY_RUNS}
    jobs["variants_meta"] = [sys.executable, os.path.abspath(__file__), "--dryrun-worker"]
    report = {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(DRY_WORKERS) as pool:
        futures = {tag: pool.submit(proc, tag, cmd) for tag, cmd in jobs.items()}
        report["grqm"] = grqm_on_card(torch, card)
        done = {tag: f.result() for tag, f in futures.items()}
    procs_s = time.perf_counter() - t0
    for tag, (rc, _) in done.items():
        if rc:
            with open(os.path.join(out_dir, f"{tag}.log")) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"[5n] {tag} exited {rc}:\n{tail}")

    # (a) the reference's production mesh
    total = torch.cuda.get_device_properties(0).total_memory
    report["production"] = []
    for arch, shape in DRY_RUNS:
        with open(os.path.join(out_dir, "dryrun", f"{arch}_{shape}_16x16.json")) as f:
            rec = json.load(f)
        if rec["status"] != "ok":
            raise AssertionError(f"[5n] (a) {arch} {shape} at 16x16: {rec['status']}: "
                                 f"{rec.get('traceback', rec.get('reason'))}")
        mem = rec["memory"]
        line = {"arch": arch, "shape": shape, "mesh": rec["mesh"], **rec["roofline"],
                "useful_flops_ratio": rec["useful_flops_ratio"],
                "per_device_flops": rec["per_device_flops"],
                "per_device_hbm_bytes": rec["per_device_hbm_bytes"],
                "collective_ring_bytes": rec["collective"]["total_ring_bytes"],
                "meta_peak_bytes": mem["meta_peak_bytes"],
                "analytical_total": mem["analytical"]["total"], "hbm_limit": mem["hbm_limit"],
                "fits": mem["fits"], "build_s": rec["build_s"], "run_s": rec["run_s"],
                "process_s": done[f"{arch}_{shape}"][1]}
        if mem["hbm_limit"] != total:
            raise AssertionError(f"[5n] (a) {arch} {shape}: fit against {mem['hbm_limit']} B, "
                                 f"not this card's {total} B")
        log(json.dumps({"dryrun_16x16": line}))
        report["production"].append(line)

    # (c) the ranks' collectives against the meta run's
    with open(os.path.join(out_dir, "variants_meta.json")) as f:
        meta = json.load(f)
    ranks = []
    for r in range(math.prod(OPT_MESH)):
        with open(os.path.join(ROOT, "build", "phase5m", f"variants_rank{r}.json")) as f:
            ranks.append(json.load(f)["variants"])
    report["collectives"] = {}
    for arch in OPT_ARCHS:
        for name in OPT_VARIANTS:
            want = meta[arch][name]
            for r, rank in enumerate(ranks):
                got = rank[arch][name]["collectives"]
                if got != want:
                    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                                 min(len(got), len(want)))
                    raise AssertionError(
                        f"[5n] (c) {arch} {name}: rank {r}'s collectives differ from the meta "
                        f"run's: {len(got)} records against {len(want)}, first at {first}: "
                        f"{got[first:first + 3]} against {want[first:first + 3]}")
            kinds = {}
            for kind, nbytes, n in want:
                k = kinds.setdefault(kind, [0, 0])
                k[0] += 1
                k[1] += nbytes
            report["collectives"][f"{arch} {name}"] = {"records": len(want), "by_kind": kinds}
    log(f"[5n] (c) 5m (a)'s first steps at {OPT_MESH[0]}x{OPT_MESH[1]} (gloo, the card): every "
        f"rank's collectives == the meta run's of the same plan, record for record, in order: "
        + "; ".join(f"{k} {v['records']} ({v['by_kind']})"
                    for k, v in report["collectives"].items()))
    report["one_rank"] = one_rank
    report["processes_s"] = procs_s
    log(f"[5n] (a) {len(DRY_RUNS)} dry runs at 16x16 ok, (c)'s meta side, (d) on the card: "
        f"{procs_s} s; nvidia-smi: {card}")
    return report


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
    served = {}  # SERVE_AXIS_ARCH's prompt and tokens, for phase 5l (c)
    with torch.no_grad():
        log(json.dumps({"serve_reduced": serve_reduced(torch, card)}))
        for arch, (batch, prompt, gen_len, n_params) in SERVE_FULL.items():
            log(json.dumps({"serve_full_width": serve_full_width(
                torch, arch, batch, prompt, gen_len, n_params, card,
                keep=served if arch == SERVE_AXIS_ARCH else None)}))
    log(json.dumps({"single_leaves": serve_single_leaves(torch, counted)}))
    log(json.dumps({"calibration": calibration_report(card)}))

    # phase 5j: distributed LM training at tp = 1 (reduced configs through
    # the launcher, resume, gemma3-4b at full width, the example's compare)
    t5j = time.perf_counter()
    log(json.dumps({"train_reduced": train_reduced(torch, counted)}))
    log(json.dumps({"train_resume": train_resume(torch, counted)}))
    full_f32 = train_full_width(torch, counted, card)
    dry_b = full_f32.pop("dryrun_one_rank")
    log(json.dumps({"train_full_width": full_f32}))
    log(json.dumps({"train_compare": train_compare(torch, counted, card)}))
    log(f"[5j] phase 5j in {time.perf_counter() - t5j} s")
    torch.cuda.empty_cache()

    # phase 5k: the model axis (tp > 1), its ranks on the one card over gloo
    t5k = time.perf_counter()
    log(json.dumps({"model_axis": tp_phase(torch, counts, paths, card)}))
    log(f"[5k] phase 5k in {time.perf_counter() - t5k} s")

    # phase 5l: serving over a mesh (the serve steps, flash-decoding at
    # long_500k, greedy decoding over a model axis), ranks on the one card
    t5l = time.perf_counter()
    log(json.dumps({"serve_mesh": serve_phase(torch, served, card)}))
    log(f"[5l] phase 5l in {time.perf_counter() - t5l} s")

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

    # phase 5m: the LM steps at the reference's precision and memory
    # options (int16, sp_compress, ZeRO-1 over ranks; bfloat16 with remat
    # at full width; ZeRO-1 at full width; bfloat16 decode); last, so
    # that the card is as free as it gets for (c)'s two ranks
    t5m = time.perf_counter()
    log(json.dumps({"opt_steps": opt_phase(torch, counts, paths, counted, card, full_f32,
                                           served)}))
    log(f"[5m] phase 5m in {time.perf_counter() - t5m} s")

    # phase 5n: the dry run against the card ((b) ran inside 5j (c))
    t5n = time.perf_counter()
    log(json.dumps({"dryrun": dry_phase(torch, card, dry_b)}))
    log(f"[5n] phase 5n in {time.perf_counter() - t5n} s")

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
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--serve-worker"]:
        sys.exit(serve_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--opt-worker"]:
        sys.exit(opt_worker(*sys.argv[2:]))
    if sys.argv[1:2] == ["--serve-check"]:
        sys.exit(serve_check())
    if sys.argv[1:2] == ["--dryrun-worker"]:
        sys.exit(dryrun_worker())
    sys.exit(main())
