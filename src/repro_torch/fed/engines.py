"""Round engines (counterpart of ``repro/fed/engines.py``), registered in
the reference's order: ``scan``, ``perround``, ``host``, ``shard``. The
device engines (scan, perround, shard) run the same round, so a fixed
seed gives bit-identical parameters under any of them:

  * ``scan`` (the default): blocks of at most ``cfg.scan_block`` rounds,
    as the reference's jitted ``lax.scan`` block. A block's cohorts,
    seeds and (heterogeneous cohorts) participation masks are drawn on
    the host and copied to the device once; on CUDA each round is one
    replay of a captured CUDA graph (``RoundGraph``), with no
    host->device copy and no synchronisation inside the block. The block
    keeps its SecAgg sums on the device and accounts its rounds, at the
    realized sizes its draws hold, when it ends;
  * ``perround``: one eager round per step, accounted as it ends;
  * ``host``: the legacy loop, the reference's benchmark baseline: each
    round's client data stacked on the host (no staged population), and
    for fixed cohorts numpy cohorts (``default_rng(seed + 7)``, the
    reference's own, so its cohorts are the reference's) and one encode
    a client, each with its own seed from the round stream; heterogeneous
    cohorts replay the round stream's draws, so its cohorts and eps are
    the device engines';
  * ``shard``: the perround step over a ``torch.distributed`` process
    group (``launch/mesh.py``), in eager chunks of ``cfg.scan_block``
    rounds, one process per rank: each rank computes and encodes its
    slice of the cohort, and the integer level sums cross the ranks in
    one all_reduce, packed when the bound allows (``core/secagg.py``).
    Every round is accounted at the full cross-shard cohort. At one rank
    it equals ``scan`` bit for bit. With ``model_shards > 1`` its ranks
    form a 2-D grid and each shard's client gradients run
    tensor-parallel over the shard's model ranks.

Every engine carries the server optimizer's state beside the parameters.
The fifth, ``async``, is ``fed/async_engine.py``.
"""
from __future__ import annotations

import collections
import gc
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import wire
from repro_torch.data.federated import sample_clients
from repro_torch.fed import cohort, rounds, staging
from repro_torch.fed.engine import Engine, register_engine
from repro_torch.kernels import _build
from repro_torch.launch.mesh import shard_group
from repro_torch.optim.optimizers import clone_state, copy_state_


class _RoundEngine(Engine):
    """The round step driven once per round, each round's draws taken from
    ``tr.generator`` on the host (``cohort.draw_round``), so that its
    realized size is known there; accounted as its rounds end. An engine
    made outside the trainer builds its step at its first advance."""

    def __init__(self, trainer):
        super().__init__(trainer)
        self.round_step = None

    def _ensure_built(self) -> None:
        if self.round_step is None:
            self.build()

    def build(self) -> None:
        tr = self.tr
        self.round_step = rounds.make_round_step(
            tr.mech, tr.cfg, tr.slate, tr.client_grads, tr.server_opt)

    def _round(self, **step_args):
        """One round on the device: its SecAgg sum when collected, and its
        realized cohort size."""
        tr = self.tr
        ids, seed, part = cohort.draw_round(tr.cfg, tr.slate, tr.generator)
        tr.flat, tr.opt_state, z_sum = self.round_step(
            tr.flat, tr.opt_state, tr.client_data, ids=ids, seed=seed, part=part,
            **step_args)
        n = tr.cfg.clients_per_round if part is None else int(part.sum())
        return (z_sum if tr.cfg.collect_sums else None), n

    def _finish(self, sums: list, ns: list) -> None:
        """The host side of finished rounds: keep their sums, account them
        at their realized sizes."""
        tr = self.tr
        for z_sum in sums:
            if z_sum is not None:
                tr.round_sums.append(z_sum.cpu().numpy())
        if tr.hetero:
            tr._account_realized(ns)
        else:
            tr._account(len(ns))

    def advance(self, n_rounds: int) -> None:
        self._ensure_built()
        for _ in range(n_rounds):
            z_sum, n = self._round()
            self._finish([z_sum], [n])


@register_engine("scan")
class ScanEngine(_RoundEngine):
    """The same round step over blocks of at most ``cfg.scan_block``
    rounds. At the start of a block the host draws every round's cohort,
    seed and mask from ``tr.generator`` in perround's order
    (``cohort.draw_block``), which gives it their realized sizes, and
    copies them to the device in one piece; round t then reads row t, at
    a round index that lives on the device and that each round advances.
    The parameters and the optimizer's state live in static buffers: the
    block copies ``tr.flat`` and ``tr.opt_state`` in when it starts (a
    restore replaces them) and hands copies back when it ends. On CUDA the
    round is captured once as a CUDA graph and each round is one replay
    (``RoundGraph``); on the CPU the same round runs eagerly over the same
    buffers. Nothing returns to the host until the block ends: then the
    collected sums, in one read, and the accountant's steps."""

    blocked = True
    # the reference's "unroll" sets scan_unroll, an XLA-only field
    spec_options = {"block": "scan_block"}

    def __init__(self, trainer):
        super().__init__(trainer)
        self.draws = None  # (scan_block, block width) int32: ids, seed's bits, mask
        self.flat = None   # the static parameters
        self.opt = None    # the static optimizer state
        self.t = None      # (1,) int64: the round index within the block
        self.sums = None   # (scan_block, dim): row t is round t's sum, if collected
        self.graph = None  # the captured round, on CUDA

    def advance(self, n_rounds: int) -> None:
        self._ensure_built()
        done = 0
        while done < n_rounds:
            length = min(self.tr.cfg.scan_block, n_rounds - done)
            self._block(length)
            done += length

    def _block(self, length: int) -> None:
        tr = self.tr
        cuda = tr.device.type == "cuda"
        if self.draws is None:
            # zeros: client 0, seed 0 and (hetero) an empty cohort for the
            # warm-up rounds before any draw
            self.draws = torch.zeros((tr.cfg.scan_block, cohort.block_width(tr.cfg, tr.slate)),
                                     dtype=torch.int32, device=tr.device)
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
        ns = cohort.realized_counts(tr.cfg, tr.slate, draws)
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
                     else [None] * length, ns)

    def round_at(self, flat: torch.Tensor, opt, t: torch.Tensor) -> torch.Tensor:
        """Round ``t`` of the block on the parameters ``flat`` and the
        optimizer state ``opt``, both updated in place (the same bits);
        returns the round's sum."""
        slate = self.tr.slate
        row = self.draws.index_select(0, t)[0]
        part = row[slate + 1:] if self.tr.hetero else None
        new, new_opt, z_sum = self.round_step(flat, opt, self.tr.client_data,
                                              ids=row[:slate], seed=row[slate:slate + 1],
                                              part=part)
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


@register_engine("perround")
class PerRoundEngine(_RoundEngine):
    """Drives the round step once per round, eagerly, and accounts each
    round at its realized size as it ends."""


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


@register_engine("host")
class HostEngine(Engine):
    """The legacy loop (the reference's benchmark baseline): each round's
    client data stacked from ``task.client_batch`` on the host and copied
    to the device (no staged population); fixed cohorts sampled by numpy
    (``data.federated.sample_clients`` on ``tr._rng``, the reference's
    ``default_rng(seed + 7)``) and encoded one client at a time, each with
    its own seed drawn from ``tr.generator`` (one quantize launch a
    client); heterogeneous cohorts drawn from ``tr.generator`` in the
    device engines' order (``cohort.draw_round``), the whole slate encoded
    with the round's seed, so its cohorts and eps are theirs. Its stages
    are separate calls, so it times the reference's scopes ``stage``,
    ``grads``, ``encode``, ``secure_sum`` and ``apply``. Every decode is
    at a device count (the reference decodes in a jit at a traced n)."""

    stages_population = False

    @classmethod
    def validate(cls, cfg, mech) -> None:
        super().validate(cfg, mech)
        if cfg.fused_rounds:
            raise ValueError(
                "engine 'host' does not support fused_rounds=True: the legacy loop is the "
                "materialized-encode benchmark baseline; use the scan/perround/shard "
                "engines for the fused hot path")

    def advance(self, n_rounds: int) -> None:
        for _ in range(n_rounds):
            if self.tr.hetero:
                self._hetero_round()
            else:
                self._fixed_round()

    def _stack(self, ids) -> dict:
        """The clients ``ids``' data, each leaf stacked along a leading
        cohort axis, on the device."""
        tr = self.tr
        batches = [tr.task.client_batch(int(i)) for i in ids]
        return {k: torch.from_numpy(np.stack([b[k] for b in batches])).to(tr.device)
                for k in batches[0]}

    def _count(self, n: int) -> torch.Tensor:
        return torch.tensor(n, dtype=torch.int32, device=self.tr.device)

    def _apply(self, z_sum: torch.Tensor, n: int) -> None:
        tr = self.tr
        with tr.timings.scope("apply"):
            g_hat = tr.mech.decode_sum(z_sum, self._count(n))
            tr.flat, tr.opt_state = tr.server_opt.update(g_hat, tr.opt_state, tr.flat,
                                                         tr.cfg.lr)

    def _keep(self, z_sum: torch.Tensor) -> None:
        if self.tr.cfg.collect_sums:
            self.tr.round_sums.append(z_sum.cpu().numpy())

    def _fixed_round(self) -> None:
        tr, cfg = self.tr, self.tr.cfg
        n = cfg.clients_per_round
        ids = sample_clients(tr._rng, cfg.num_clients, n)
        with tr.timings.scope("stage"):
            data = self._stack(ids)
        with tr.timings.scope("grads"):
            grads = tr.client_grads(tr.flat, data)
        seeds = [cohort.draw_seed(tr.generator) for _ in range(n)]
        with tr.timings.scope("encode"):
            z = torch.stack([tr.mech.quantize(grads[i], s) for i, s in enumerate(seeds)])
        with tr.timings.scope("secure_sum"):
            z_sum = z.sum(0, dtype=z.dtype)  # the SecAgg sum
        self._apply(z_sum, n)
        self._keep(z_sum)
        tr._account(1)

    def _hetero_round(self) -> None:
        tr, cfg = self.tr, self.tr.cfg
        ids, seed, part = cohort.draw_round(cfg, tr.slate, tr.generator)
        with tr.timings.scope("stage"):
            data = self._stack(ids.tolist())
        with tr.timings.scope("grads"):
            grads = tr.client_grads(tr.flat, data)
        with tr.timings.scope("encode"):
            z = tr.mech.quantize_batch(grads, seed)  # the whole slate, as the engines
        n_real = int(part.sum())
        with tr.timings.scope("secure_sum"):
            z = z * part.to(device=z.device, dtype=z.dtype)[:, None]
            z_sum = z.sum(0, dtype=z.dtype)
        if n_real > 0:  # an empty round moves nothing
            self._apply(z_sum, n_real)
        self._keep(z_sum)
        tr._account_realized([n_real])


@register_engine("shard")
class ShardEngine(_RoundEngine):
    """The eager round step over a process group of ``shards`` ranks, in
    chunks of ``cfg.scan_block`` rounds; with ``staging="stream"`` each
    chunk first stages this rank's slices of its cohorts. A Poisson slate
    is rounded up to a multiple of the ranks. Not captured: its round
    crosses the ranks in a collective (ROADMAP.md queue A item 9). With
    ``model_shards > 1`` the ranks form a 2-D grid of shards x model
    shards, each shard's client gradients tensor-parallel over its model
    ranks (``_bind_model_axis``)."""

    blocked = True
    supports_streaming = True
    spec_options = {"shards": "shards", "staging": "staging", "packed": "shard_packed",
                    "model": "model_shards"}

    def __init__(self, trainer):
        super().__init__(trainer)
        tr, cfg = trainer, trainer.cfg
        self.model_shards = int(cfg.model_shards or 1)
        if self.model_shards > 1:
            self._bind_model_axis()
        else:
            self.group = shard_group(cfg.shards, tr.device)
            self.shards = dist.get_world_size(self.group)
            self.rank = dist.get_rank(self.group)
        tr.shards = self.shards
        if cfg.subsampling == "poisson":
            # round the slate up so that it splits evenly across the ranks
            slate = -(-tr.slate // self.shards) * self.shards
            if slate > cfg.num_clients:
                raise ValueError(
                    f"poisson cohort slate {slate} (rounded to {self.shards} shards) "
                    f"exceeds the population {cfg.num_clients}; lower max_cohort or shards")
            tr.slate = slate
        elif cfg.clients_per_round % self.shards:
            raise ValueError(f"clients_per_round={cfg.clients_per_round} must "
                             f"divide across {self.shards} shards")
        # the packing bound covers the worst case, the full slate
        if cfg.shard_packed:
            wire.check_packable(tr.mech.sum_bound(tr.slate), where="shard_packed=True: ")

    def _bind_model_axis(self) -> None:
        """The 2-D ("shard", "model") grid over the default group of shards
        x model_shards ranks (``launch/mesh.py:mesh_groups``, model-minor):
        the SecAgg sum crosses this rank's shard group (the ranks of its
        model index) and carries only integer levels; the model axis runs
        inside each client's gradient, over the task's ctx, which has no
        client axes (a client's loss stays on its own shard)."""
        from repro_torch.launch.mesh import mesh_groups
        from repro_torch.models.common import ParallelCtx

        tr, cfg, tp = self.tr, self.tr.cfg, self.model_shards
        if not tr.task.supports_model_axis:
            raise ValueError(f"model_shards={tp} needs a task with supports_model_axis; "
                             f"task {tr.task.name!r} is single-shard only")
        world = dist.get_world_size() if dist.is_initialized() else 1
        shards = cfg.shards or max(1, world // tp)
        groups = mesh_groups(shards, tp, tr.device)
        self.group, self.shards, self.rank = groups.client, shards, groups.client_index
        tr.task_ctx = ParallelCtx(model_axis="model", tp=tp, model_group=groups.model,
                                  model_rank=groups.model_index, subgroups=groups.subgroups)
        tr.task.bind_model_axis(tr.task_ctx)

    def build(self) -> None:
        tr = self.tr
        self.round_step = rounds.make_shard_round_step(
            tr.mech, tr.cfg, tr.slate, self.shards, self.rank, self.group,
            tr.client_grads, tr.server_opt)

    def advance(self, n_rounds: int) -> None:
        self._ensure_built()
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
                out = [self._round(batch={k: v[t] for k, v in data.items()})
                       for t in range(length)]
            else:
                out = [self._round() for _ in range(length)]
            self._finish([z for z, _ in out], [n for _, n in out])
            done += length
