"""Round engines (counterpart of ``repro/fed/engines.py``). The ported
engines run the same round, so a fixed seed gives bit-identical
parameters under any of them:

  * ``scan`` (the default): blocks of at most ``cfg.scan_block`` rounds,
    as the reference's jitted ``lax.scan`` block. A block's cohorts and
    seeds are drawn on the host and copied to the device once; on CUDA
    each round is one replay of a captured CUDA graph (``RoundGraph``),
    with no host->device copy and no synchronisation inside the block.
    The block keeps its SecAgg sums on the device and accounts its rounds
    when it ends;
  * ``perround``: one eager round per step, accounted as it ends;
  * ``shard``: the perround step over a ``torch.distributed`` process
    group (``launch/mesh.py``), in eager chunks of ``cfg.scan_block``
    rounds, one process per rank: each rank computes and encodes its
    slice of the cohort, and the integer level sums cross the ranks in
    one all_reduce, packed when the bound allows (``core/secagg.py``).
    Every round is accounted at the full cross-shard cohort. At one rank
    it equals ``scan`` bit for bit.

Every engine carries the server optimizer's state beside the parameters.
The reference's other engines are refused, naming their ROADMAP.md item.
"""
from __future__ import annotations

import collections
import gc
import os
import traceback

import torch
import torch.distributed as dist

from repro_torch.core import wire
from repro_torch.fed import cohort, rounds, staging
from repro_torch.kernels import _build
from repro_torch.launch.mesh import shard_group
from repro_torch.optim.optimizers import clone_state, copy_state_

_NOT_PORTED = {
    "host": "queue A item 5",
    "async": "queue A item 10",
}


class PerRoundEngine:
    """Drives the round step once per round and accounts each round at
    the fixed cohort size as it ends."""

    name = "perround"
    blocked = False

    def __init__(self, trainer):
        self.tr = trainer
        tr = trainer
        self.round_step = rounds.make_round_step(
            tr.mech, tr.cfg, tr.slate, tr.client_grads, tr.server_opt)

    def _round(self, **step_args):
        """One round on the device; its SecAgg sum when collected."""
        tr = self.tr
        tr.flat, tr.opt_state, z_sum = self.round_step(
            tr.flat, tr.opt_state, tr.client_data, tr.generator, **step_args)
        return z_sum if tr.cfg.collect_sums else None

    def _finish(self, sums: list) -> None:
        """The host side of finished rounds: keep their sums, account them."""
        tr = self.tr
        for z_sum in sums:
            if z_sum is not None:
                tr.round_sums.append(z_sum.cpu().numpy())
            tr._account(1)

    def advance(self, n_rounds: int) -> None:
        for _ in range(n_rounds):
            self._finish([self._round()])


class ScanEngine(PerRoundEngine):
    """The same round step over blocks of at most ``cfg.scan_block``
    rounds. At the start of a block the host draws every round's cohort and
    seed from ``tr.generator`` in perround's order (``cohort.draw_block``)
    and copies them to the device in one piece; round t then reads its
    ids and seed from row t, at a round index that lives on the device
    and that each round advances. The parameters and the optimizer's
    state live in static buffers: the block copies ``tr.flat`` and
    ``tr.opt_state`` in when it starts (a restore replaces them) and hands
    copies back when it ends. On CUDA the round is captured once as a
    CUDA graph and each round is one replay (``RoundGraph``); on the CPU
    the same round runs eagerly over the same buffers. Nothing returns to
    the host until the block ends: then the collected sums, in one read,
    and the accountant's steps."""

    name = "scan"
    blocked = True

    def __init__(self, trainer):
        super().__init__(trainer)
        self.draws = None  # (scan_block, slate + 1) int32: ids, then the seed's bits
        self.flat = None   # the static parameters
        self.opt = None    # the static optimizer state
        self.t = None      # (1,) int64: the round index within the block
        self.sums = None   # (scan_block, dim): row t is round t's sum, if collected
        self.graph = None  # the captured round, on CUDA

    def advance(self, n_rounds: int) -> None:
        done = 0
        while done < n_rounds:
            length = min(self.tr.cfg.scan_block, n_rounds - done)
            self._block(length)
            done += length

    def _block(self, length: int) -> None:
        tr = self.tr
        cuda = tr.device.type == "cuda"
        if self.draws is None:
            # zeros: client 0 and seed 0 for the warm-up rounds before any draw
            self.draws = torch.zeros((tr.cfg.scan_block, tr.slate + 1), dtype=torch.int32,
                                     device=tr.device)
            self.flat = torch.empty_like(tr.flat)
            self.opt = clone_state(tr.opt_state)
            self.t = torch.zeros(1, dtype=torch.int64, device=tr.device)
        self.flat.copy_(tr.flat)
        copy_state_(self.opt, tr.opt_state)
        self.t.zero_()
        if cuda and self.graph is None:
            # before the block's draws, so that a capture that fails leaves
            # the generator where it was
            self.graph = RoundGraph(self)
        draws = cohort.draw_block(tr.cfg, tr.slate, tr.generator, length)
        # the block's one host->device copy, asynchronous from pinned memory
        self.draws[:length].copy_(draws.pin_memory() if cuda else draws, non_blocking=cuda)
        if cuda:
            for _ in range(length):
                self.graph.replay()
        else:
            for _ in range(length):
                self.step(self.flat, self.opt, self.t)
        tr.flat = self.flat.clone()
        tr.opt_state = clone_state(self.opt)
        # the block's one read of its sums
        self._finish(list(self.sums[:length].to("cpu", copy=True)) if self.sums is not None
                     else [None] * length)

    def round_at(self, flat: torch.Tensor, opt, t: torch.Tensor) -> torch.Tensor:
        """Round ``t`` of the block on the parameters ``flat`` and the
        optimizer state ``opt``, both updated in place (the same bits);
        returns the round's sum."""
        slate = self.tr.slate
        row = self.draws.index_select(0, t)[0]
        new, new_opt, z_sum = self.round_step(flat, opt, self.tr.client_data,
                                              ids=row[:slate], seed=row[slate:])
        flat.copy_(new)
        copy_state_(opt, new_opt)
        return z_sum

    def keep_sums_like(self, z_sum: torch.Tensor) -> None:
        if self.tr.cfg.collect_sums and self.sums is None:
            self.sums = z_sum.new_empty((self.tr.cfg.scan_block,) + tuple(z_sum.shape))

    def step(self, flat: torch.Tensor, opt, t: torch.Tensor) -> None:
        """Round ``t``, its sum kept in row ``t`` when collected; then the
        next round's index."""
        z_sum = self.round_at(flat, opt, t)
        self.keep_sums_like(z_sum)
        if self.sums is not None:
            self.sums.index_copy_(0, t, z_sum[None])
        t.add_(1)


class RoundGraph:
    """One round of the scan engine captured as a CUDA graph.

    Warm-up rounds first run on a side stream, on spare copies of the
    parameters and the optimizer state and a spare round index (so that
    they advance no state of the run), so that cuBLAS and cuDNN set up
    their handles and workspaces and the kernels are built and loaded;
    they run before the first block's draws (on the draws buffer's zeros:
    client 0, seed 0), leave the generator alone and count no launches.
    Then ``engine.step`` on the static buffers is captured: every replay
    runs the round at the device's round index and advances it. The kernels launched in the capture are recorded here and counted
    once per replay. There is no eager fallback: an op that cannot be
    captured (one that synchronises or copies from the host) raises,
    naming the line that made it. The cyclic garbage collector is off
    while the round is captured: an earlier trainer's graph that it freed
    then would end the capture (destroying a graph is not permitted while
    a stream captures)."""

    WARMUP_ROUNDS = 2

    def __init__(self, engine: ScanEngine):
        device = engine.tr.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), _build.moved_to(collections.Counter()):
            flat, opt = engine.flat.clone(), clone_state(engine.opt)
            t = torch.zeros_like(engine.t)
            for _ in range(self.WARMUP_ROUNDS):
                engine.keep_sums_like(engine.round_at(flat, opt, t))
        torch.cuda.current_stream(device).wait_stream(side)
        del flat, opt, t
        self.launches: collections.Counter = collections.Counter()
        self.graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.Stream(device)
        collecting = gc.isenabled()
        gc.disable()
        try:
            # the outer stream context restores the current stream even when
            # ending the capture raises
            with (_build.moved_to(self.launches), torch.cuda.stream(capture),
                  torch.cuda.graph(self.graph, stream=capture)):
                engine.step(engine.flat, engine.opt, engine.t)
        except RuntimeError as err:
            raise RuntimeError(f"the scan engine's round cannot be captured as a CUDA "
                               f"graph: {_first_failure(err)}") from err
        finally:
            if collecting:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()
        _build.replayed(self.launches)


def _first_failure(err: BaseException) -> str:
    """The first error of a failed capture (ending the capture raises its
    own) and the last line outside PyTorch that it passed: the op that
    could not be captured."""
    while err.__context__ is not None:
        err = err.__context__
    torch_dir = os.path.dirname(torch.__file__)
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if not f.filename.startswith(torch_dir)]
    where = f" at {frames[-1].filename}:{frames[-1].lineno}: {frames[-1].line}" if frames else ""
    return f"{type(err).__name__}: {err}{where}"


class ShardEngine(PerRoundEngine):
    """The eager round step over a process group of ``shards`` ranks, in
    chunks of ``cfg.scan_block`` rounds; with ``staging="stream"`` each
    chunk first stages this rank's slices of its cohorts. Not captured:
    its round crosses the ranks in a collective (ROADMAP.md queue A item
    9)."""

    name = "shard"
    blocked = True

    def __init__(self, trainer):
        tr, cfg = trainer, trainer.cfg
        self.tr = tr
        self.group = shard_group(cfg.shards, tr.device)
        self.shards = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        tr.shards = self.shards
        if cfg.clients_per_round % self.shards:
            raise ValueError(f"clients_per_round={cfg.clients_per_round} must "
                             f"divide across {self.shards} shards")
        if cfg.shard_packed:
            wire.check_packable(tr.mech.sum_bound(tr.slate), where="shard_packed=True: ")
        self.round_step = rounds.make_shard_round_step(
            tr.mech, cfg, tr.slate, self.shards, self.rank, self.group,
            tr.client_grads, tr.server_opt)

    def advance(self, n_rounds: int) -> None:
        tr, cfg = self.tr, self.tr.cfg
        done = 0
        while done < n_rounds:
            length = min(cfg.scan_block, n_rounds - done)
            if cfg.staging == "stream":
                with tr.timings.scope("stage"):
                    data, nbytes = staging.stage_stream_block(
                        tr.task, cfg, tr.slate, tr.generator, length, self.rank,
                        self.shards, tr.device)
                tr.staged_bytes_last_block = nbytes
                tr.staged_bytes_total += nbytes
                sums = [self._round(batch={k: v[t] for k, v in data.items()})
                        for t in range(length)]
            else:
                sums = [self._round() for _ in range(length)]
            self._finish(sums)
            done += length


ENGINES = {cls.name: cls for cls in (ScanEngine, PerRoundEngine, ShardEngine)}


def get_engine(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not ported yet: ROADMAP.md {_NOT_PORTED[name]}")
    if name not in ENGINES:
        raise ValueError(f"unknown engine {name!r}; ported: {', '.join(ENGINES)}")
    return ENGINES[name]
