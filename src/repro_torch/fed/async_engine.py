"""The fifth registered engine: buffered asynchronous rounds under seeded
arrival traffic (counterpart of ``repro/fed/async_engine.py``).

Every other engine barriers a round on its whole cohort. ``"async"``
models production traffic: clients arrive under a seeded Poisson or
diurnal process (``fed/arrivals.py``), compute against the model version
they fetched (integer staleness, bounded by a refetch protocol at
``async_max_staleness``), stragglers whose compute latency exceeds
``async_timeout`` miss the aggregation, and the server aggregates on a
cadence of ``async_cadence`` updates (FedBuff-style buffered
aggregation).

It reuses the integer SecAgg sum, the mechanism's decode, the server
optimizer and the accountant of the synchronous engines. Each
aggregation is accounted at its realized buffer size
(``trainer._account_realized``), known on the host from the arrival
schedule, so nothing is read back from the card. Staleness enters the
round, never the accounting:

  * each buffered client's gradient is taken at the parameter version it
    fetched: a ring ``hist`` of the last ``max_staleness + 1`` parameter
    vectors (row v the parameters v aggregations ago) lives on the
    device, and each slate row gathers its own version
    (``hist.index_select(0, stale)``, then ``vmap(grad, in_dims=(0, 0))``);
  * the staleness-weight policy (``fed/updates.py``) scales the decoded
    aggregate by a scalar, the policy's Python double rounded once to a
    0-d float32 device tensor (post-processing of the release);
  * participation stays a {0, 1} mask inside the SecAgg sum: the fused
    round sums' weights, or the materialized levels' row mask.

An aggregation decodes at the device count ``max(n_real, 1)`` with the
reference's traced-n arithmetic (``core/grid.py``), and one whose rows
all timed out moves neither the parameters nor the optimizer's state
(``rounds.make_server_apply``'s guard).

The plain corner: with ``max_staleness == 0``, no timeout, full staging
and ``cadence == clients_per_round``, the engine runs the ``perround``
engine's round step itself, drawing from the round stream in its order,
so it equals ``perround`` bit for bit by construction. Off that corner
each aggregation draws its ids, then its kernel seed, from the trainer's
``torch.Generator`` in the same order, before the round runs, so
streamed staging (``staging="stream"``) stages exactly the drawn cohort
through a bounded LRU of client datasets: O(cadence) datasets on host and
device whatever ``num_clients`` is.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch.fed import cohort, rounds, staging
from repro_torch.fed.arrivals import ArrivalSimulator, make_arrivals
from repro_torch.fed.checkpointing import pack_host_rng, unpack_host_rng
from repro_torch.fed.engine import register_engine
from repro_torch.fed.engines import _RoundEngine
from repro_torch.fed.updates import ClientUpdate, StalenessPolicy


def _cadence(cfg) -> int:
    return int(cfg.async_cadence or cfg.clients_per_round)


def make_async_round_step(mech, cfg, opt, max_staleness: int, grads_at):
    """The buffered aggregation's round step, ``round_step(hist,
    opt_state, batch, seed, stale, delivered, discount=None) -> (new_hist,
    new_state, z_sum)``: per-row stale parameters (``hist[0]`` for every
    row at ``max_staleness`` 0, else ``hist[stale]``, given to
    ``grads_at(params, batch)``) -> clipped gradients -> the fused or
    materialized encode -> the {0,1}-masked SecAgg sum (``delivered``,
    int32) -> the decode at the device count ``max(n_real, 1)`` -> the
    staleness discount (a 0-d float32 tensor, or None) -> the server
    apply, which an empty aggregation leaves where it was -> the ring
    shift."""
    S, fused = int(max_staleness), cfg.fused_rounds
    apply = rounds.make_server_apply(opt, cfg)

    def round_step(hist, opt_state, batch, seed, stale, delivered, discount=None):
        params = hist[0] if S == 0 else hist.index_select(0, stale)
        grads = grads_at(params, batch)
        if fused:
            z_sum = mech.quantize_sum_batch(grads, seed, weights=delivered)
        else:
            z = mech.quantize_batch(grads, seed)
            z = z * delivered.to(z.dtype)[:, None]  # stragglers: 0
            z_sum = z.sum(0, dtype=z.dtype)
        n_real = delivered.sum(dtype=torch.int32)
        g_hat = mech.decode_sum(z_sum, n_real.clamp(min=1))  # empty: releases nothing
        if discount is not None:
            g_hat = g_hat * discount  # post-processing of the release
        new, new_state = apply(hist[0], opt_state, g_hat, n_real)
        new_hist = new[None] if S == 0 else torch.cat([new[None], hist[:-1]])
        return new_hist, new_state, z_sum

    return round_step


@register_engine("async")
class AsyncEngine(_RoundEngine):
    """Buffered asynchronous aggregation under seeded arrival traffic."""

    stages_population = True
    supports_streaming = True
    # spec option -> the FedConfig field it sets. An arrival process with
    # options of its own ("diurnal:period=24") does not fit the engine
    # spec's grammar: set cfg.async_arrivals for it.
    spec_options = {
        "cadence": "async_cadence",
        "max_staleness": "async_max_staleness",
        "staleness_weight": "async_staleness_weight",
        "arrivals": "async_arrivals",
        "rate": "async_rate",
        "latency": "async_latency",
        "timeout": "async_timeout",
    }

    @classmethod
    def validate(cls, cfg, mech) -> None:
        super().validate(cfg, mech)
        cadence = _cadence(cfg)
        if cadence < 1 or cadence > cfg.num_clients:
            raise ValueError(f"async_cadence={cadence} must be in [1, num_clients="
                             f"{cfg.num_clients}]")
        if cfg.async_max_staleness < 0:
            raise ValueError(f"async_max_staleness must be >= 0, got "
                             f"{cfg.async_max_staleness}")
        if cfg.subsampling != "fixed":
            raise ValueError("engine 'async' realizes its cohort from the arrival process "
                             "(async_arrivals), not from Poisson subsampling; use "
                             "subsampling='fixed'")
        if cfg.dropout > 0:
            raise ValueError("engine 'async' models stragglers with async_timeout "
                             "(arrival-latency timeouts), not i.i.d. dropout; set dropout=0")
        if cfg.async_rate is not None and cfg.async_rate <= 0:
            raise ValueError(f"async_rate must be > 0, got {cfg.async_rate}")
        if cfg.async_timeout is not None and cfg.async_timeout <= 0:
            raise ValueError(f"async_timeout must be > 0, got {cfg.async_timeout}")
        # malformed policy or arrival specs raise as they are built
        StalenessPolicy(max_staleness=cfg.async_max_staleness,
                        weight=cfg.async_staleness_weight)
        make_arrivals(cfg.async_arrivals, rate=float(cadence))

    def __init__(self, trainer):
        super().__init__(trainer)
        cfg = trainer.cfg
        self.cadence = _cadence(cfg)
        # the slate is the aggregation buffer: exactly `cadence` updates
        trainer.slate = self.cadence
        self.max_staleness = int(cfg.async_max_staleness)
        self.policy = StalenessPolicy(max_staleness=self.max_staleness,
                                      weight=cfg.async_staleness_weight)
        self._streamed = cfg.staging == "stream"
        # perround's round step decodes at clients_per_round, hence the
        # cadence condition
        self._plain = (self.max_staleness == 0 and cfg.async_timeout is None
                       and not self._streamed and self.cadence == cfg.clients_per_round)
        self._discounted = self.policy._parse_weight()[0] != "uniform"
        rate = float(cfg.async_rate) if cfg.async_rate is not None else float(self.cadence)
        self.sim = ArrivalSimulator(
            make_arrivals(cfg.async_arrivals, rate=rate), self.cadence, seed=cfg.seed,
            max_staleness=self.max_staleness, mean_latency=cfg.async_latency,
            timeout=cfg.async_timeout)
        self.hist = None  # (max_staleness + 1, dim) parameter ring, off the plain corner
        # the last aggregation's buffer as typed metadata (payloads stay
        # inside the SecAgg sum: only identity, staleness and weight)
        self.last_buffer: list = []
        # streamed staging's bounded LRU of client datasets
        self._data_cache: OrderedDict = OrderedDict()
        self._cache_cap = max(4 * self.cadence, 256)

    def build(self) -> None:
        tr = self.tr
        if self._plain:
            super().build()  # perround's round step
            return
        # max_staleness 0 computes every row at hist[0] (in_dims=(None, 0)),
        # a program of its own, as the reference's
        grads_at = (tr.client_grads if self.max_staleness == 0 else
                    rounds.make_client_grad(tr.mech, tr.unravel, tr.task, tr.cfg, per_row=True))
        self.round_step = make_async_round_step(tr.mech, tr.cfg, tr.server_opt,
                                                self.max_staleness, grads_at)
        # every row starts at the initial parameters (a row older than the
        # run is never selected: realized staleness <= buffer index)
        self.hist = tr.flat[None, :].repeat(self.max_staleness + 1, 1)

    # -- checkpoint state (fed/checkpointing.py's "engine" leaf) -------------
    # Beyond (flat, opt_state, the round stream): the arrival simulator's
    # RNG and aggregation times (staleness is searched against them) and,
    # off the plain corner, the parameter ring.

    def state(self):
        tree = {"sim_rng": pack_host_rng(self.sim._rng),
                "sim_times": np.asarray(self.sim._agg_times, np.float64)}
        if not self._plain:
            tree["hist"] = self.hist
        return tree

    def state_template(self, steps_done: int):
        # one aggregation time per accounted round: checkpoints land on
        # round boundaries
        tree = {"sim_rng": np.zeros(6, np.uint64),
                "sim_times": np.zeros(steps_done, np.float64)}
        if not self._plain:
            tree["hist"] = self.hist
        return tree

    def load_state(self, tree) -> None:
        self.sim._rng = unpack_host_rng(tree["sim_rng"])
        self.sim._agg_times = [float(t) for t in tree["sim_times"]]
        self.sim._next_index = len(self.sim._agg_times)
        if not self._plain:
            self.hist = tree["hist"]

    # -- streamed staging ---------------------------------------------------
    def _client_data_cached(self, cid: int) -> dict:
        cache = self._data_cache
        if cid in cache:
            cache.move_to_end(cid)
            return cache[cid]
        data = self.tr.task.client_batch(cid)
        cache[cid] = data
        if len(cache) > self._cache_cap:
            cache.popitem(last=False)
        return data

    # -- the loop -----------------------------------------------------------
    def advance(self, n_rounds: int) -> None:
        self._ensure_built()
        tr, cfg = self.tr, self.tr.cfg
        for _ in range(n_rounds):
            sched = self.sim.next_buffer()
            ids = None
            if self._plain:
                z_sum, n_real = self._round()
            else:
                z_sum, ids = self._aggregate(sched)
                n_real = sched.realized
            if cfg.collect_sums:
                tr.round_sums.append(z_sum.cpu().numpy())
            # every aggregation at its realized buffer size
            tr._account_realized([n_real])
            self._record_buffer(sched, ids)
            tr.round_extras.append(self._buffer_extras(sched, n_real))

    def _aggregate(self, sched):
        """One aggregation off the plain corner: draws its ids, then its
        seed, from the round stream, and runs the round step on the ring.
        Returns its SecAgg sum and ids."""
        tr, cfg = self.tr, self.tr.cfg
        ids, seed, _ = cohort.draw_round(cfg, tr.slate, tr.generator)
        if self._streamed:
            with tr.timings.scope("stage"):
                batch, nbytes = staging.stage_ids(ids, tr.device, self._client_data_cached)
                tr.staged_bytes_last_block = nbytes
                tr.staged_bytes_total += nbytes
        else:
            batch = rounds.index_batch(tr.client_data, torch.as_tensor(ids, device=tr.device))
        stale = torch.from_numpy(sched.staleness.astype(np.int64)).to(tr.device)
        delivered = torch.from_numpy(sched.delivered.astype(np.int32)).to(tr.device)
        discount = None
        if self._discounted:
            # the policy's double, rounded once to float32
            discount = torch.tensor(self.policy.discount(sched.staleness[sched.delivered]),
                                    dtype=torch.float32, device=tr.device)
        self.hist, tr.opt_state, z_sum = self.round_step(
            self.hist, tr.opt_state, batch, seed, stale, delivered, discount)
        tr.flat = self.hist[0]
        return z_sum, ids

    def _record_buffer(self, sched, ids) -> None:
        """The aggregation's buffer as typed ``ClientUpdate`` metadata (the
        aggregator's intake form); payloads stay inside the SecAgg sum."""
        version = sched.index
        self.last_buffer = [
            ClientUpdate(payload=np.zeros(0),
                         client_id=int(ids[i]) if ids is not None else -1,
                         round_tag=version - int(sched.staleness[i]),
                         staleness=int(sched.staleness[i]),
                         weight=int(sched.delivered[i]))
            for i in range(self.cadence)
        ]

    def _buffer_extras(self, sched, n_real: int) -> dict:
        s = sched.staleness
        extras = {"arrived": int(self.cadence), "delivered": int(n_real),
                  "staleness_mean": float(np.mean(s)), "staleness_max": int(np.max(s)),
                  "sim_time": float(sched.time)}
        if not self._plain and self._discounted:
            extras["staleness_discount"] = float(self.policy.discount(s[sched.delivered]))
        return extras
