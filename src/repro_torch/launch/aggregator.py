"""The long-lived aggregator round-server (counterpart of
``repro/launch/aggregator.py``): streamed client-update batches in,
privately aggregated rounds out, health through the metrics plane.

``AggregatorServer`` is the service-shaped counterpart of ``FedTrainer``:
it accepts already-encoded client updates (``submit``) into a bounded
queue, whose backpressure paces the producers (a blocking ``submit``
waits for room, a non-blocking one is refused and counted), and an
aggregation loop drains it on a cadence: every ``cohort`` buffered
updates become one round, the SecAgg sum in the encoded integer domain,
``mech.decode_sum`` at the realized count, one server-optimizer step,
accounted by the exact Renyi accountant and emitted through the
trainer's ``RoundEmitter``, so a service round's record has a training
round's schema.

On the card the parameters, the optimizer's state and the SecAgg sum
live on the device. Dense payloads are copied there, stacked and
weighted; a packed payload (``core.wire.PackedPayload``) unpacks there
through the ``unpack_flat`` kernel; and when the whole cohort arrived
packed at one width and the cohort's sum bound still fits a field
(``wire.packable``), its words are summed there directly (in int64,
masked to 32 bits: the uint32 sum of the reference) and unpacked once.
The server decodes at its realized count as a Python int, the reference's
static-n decode (the fixed cohort's scale), not the async engine's
device count.

Intake is typed (``fed/updates.py``): ``ClientUpdate`` objects, with the
bare ``(k, dim)`` array form behind a ``DeprecationWarning``. With
``engine="async:..."`` the server runs the async engine's aggregation
policy over the real stream: updates staler than ``max_staleness``
versions are discarded, weight-0 stragglers are masked out of the sum
with the round accounted at the surviving count, and the staleness
weight discounts the decoded aggregate (a 0-d float32 device tensor).

The privacy budget is enforced before a round applies: the round that
would cross ``budget_eps`` is never aggregated, the server halts and
refuses further submits. Checkpoints (``checkpoint/store.py``, the
reference's leaf layout and fingerprint) hold the parameters, the
optimizer state and the accountant's realized history; a checkpoint of
either package resumes in the other's server. ``snapshot()`` is the
health surface (budget remaining, queue depth, rounds served).

CLI (a simulated client stream; the card unless ``--device cpu``):

  PYTHONPATH=src python -m repro_torch.launch.aggregator --smoke
  PYTHONPATH=src python -m repro_torch.launch.aggregator --dim 512 --cohort 8 \\
      --batches 12 --budget-eps 60 --track json:runs/agg.json
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import queue
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.core import wire
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.core.renyi import RenyiAccountant
from repro_torch.fed import async_engine as _async_engine  # noqa: F401  (registers "async")
from repro_torch.fed.cohort import draw_seed
from repro_torch.fed.engine import make_engine
from repro_torch.fed.trainer import resolve_device
from repro_torch.fed.updates import ClientUpdate, StalenessPolicy, UpdateBuffer, as_updates
from repro_torch.kernels.pack_kernel import unpack_flat
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.telemetry import RoundEmitter, Timings, make_tracker

# the aggregation-policy knobs an "async:..." spec may set here; the rest
# of the async surface (arrivals, latency, timeout) is simulation, and
# this server receives real traffic
_POLICY_OPTIONS = ("cadence", "max_staleness", "staleness_weight")


def _resolve_policy(engine: Optional[str], cohort: int):
    """``(engine_label, StalenessPolicy, cohort)`` for an engine spec:
    None (or "aggregator") admits everything with no discount; an
    ``"async[:...]"`` spec takes the async engine's policy, its
    ``cadence`` overriding ``cohort``."""
    if engine is None or engine == "aggregator":
        return "aggregator", StalenessPolicy(), cohort
    espec = make_engine(engine)
    if espec.name != "async":
        raise ValueError(f"AggregatorServer aggregation policy must be 'async' (or None for "
                         f"the legacy cadence), got engine {espec.name!r}")
    opts = dict(espec.options)
    unknown = set(opts) - set(_POLICY_OPTIONS)
    if unknown:
        raise ValueError(f"aggregator engine spec accepts only {_POLICY_OPTIONS} "
                         f"(arrival/latency/timeout options describe SIMULATED traffic; this "
                         f"server receives real traffic), got {sorted(unknown)}")
    cohort = int(opts.get("cadence", cohort))
    max_staleness = opts.get("max_staleness")
    policy = StalenessPolicy(
        max_staleness=int(max_staleness) if max_staleness is not None else None,
        weight=str(opts.get("staleness_weight", "uniform")))
    return "async", policy, cohort


class AggregatorServer:
    """One aggregation endpoint for a fixed (mechanism, dim) deployment,
    on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, mech, dim: int, *, cohort: int = 8, lr: float = 0.5,
                 server_opt: str = "sgd", server_opt_options: Optional[dict] = None,
                 queue_limit: int = 64, budget_eps: Optional[float] = None,
                 budget_delta: float = 1e-5, alphas: tuple = (2.0, 4.0, 8.0, 16.0, 32.0),
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0, tracker=None,
                 init_flat=None, engine: Optional[str] = None, device="cuda"):
        self.engine, self.policy, cohort = _resolve_policy(engine, cohort)
        if cohort < 1:
            raise ValueError(f"cohort must be >= 1, got {cohort}")
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        if ckpt_every and not ckpt_dir:
            raise ValueError("ckpt_every requires ckpt_dir")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # pinned, so the service thread's guard, the tensors and the
            # synchronisations all name the card current at construction
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.mech = make_mechanism(mech)
        self.dim = int(dim)
        self.cohort = int(cohort)
        self.lr = float(lr)
        self.budget_eps = budget_eps
        self.budget_delta = float(budget_delta)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self.server_opt = make_optimizer(server_opt, **(server_opt_options or {}))
        self.flat = (torch.zeros(self.dim, dtype=torch.float32, device=self.device)
                     if init_flat is None else
                     torch.as_tensor(init_flat, dtype=torch.float32, device=self.device))
        if tuple(self.flat.shape) != (self.dim,):
            raise ValueError(f"init_flat shape {tuple(self.flat.shape)} != ({self.dim},)")
        self.opt_state = self.server_opt.init(self.flat)
        self.accountant = RenyiAccountant(alphas=tuple(alphas))
        self.realized_n: list = []
        # the bounded queue is the backpressure: producers never grow the
        # server's memory
        self.queue: queue.Queue = queue.Queue(maxsize=queue_limit)
        # drained updates awaiting a full cohort: the staleness-aware FIFO
        # of the async engine's aggregations
        self.buffer = UpdateBuffer(self.policy)
        self._queued_updates = 0  # rows still inside the queue
        # the intake counters change from producer threads and the service
        # thread: each read-modify-write holds this lock
        self._counts = threading.Lock()
        self.rounds_served = 0
        self.updates_aggregated = 0
        self.batches_accepted = 0
        self.batches_rejected = 0
        self.round_extras: list = []  # per-round staleness and uplink stats
        self.halted = False
        self._eps_by_n: dict = {}
        self._t0 = time.time()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.timings = Timings()
        self.tracker = make_tracker(tracker)
        self._emitter = RoundEmitter(
            self.tracker, engine=self.engine, mechanism=self.mech,
            alphas=self.accountant.alphas, delta=self.budget_delta, budget_eps=budget_eps,
            dim=self.dim)
        self.tracker.run_started(self._run_meta())

    # -- metadata / fingerprint ---------------------------------------------
    def _run_meta(self) -> dict:
        """Run-level tracker metadata, the reference's keys; ``backend``
        is the device type (``"cuda"`` or ``"cpu"``), as the trainer's."""
        return {
            "kind": "aggregator",
            "fingerprint": bytes(self._fingerprint()).hex(),
            "engine": self.engine,
            "staleness_policy": self.policy.describe(),
            "mechanism": self.mech.describe(),
            "mechanism_spec": self.mech.spec(),
            "dim": self.dim,
            "cohort": self.cohort,
            "queue_limit": self.queue.maxsize,
            "server_opt": self.server_opt.name,
            "budget_eps": self.budget_eps,
            "budget_delta": self.budget_delta,
            "accountant_alphas": list(self.accountant.alphas),
            "backend": self.device.type,
        }

    def _fingerprint(self) -> np.ndarray:
        """sha256 of the deployment's trajectory-defining config, the
        reference's blob byte for byte (no RNG family: the server draws
        nothing), so either package's checkpoint resumes in the other."""
        blob = json.dumps({
            "mechanism": self.mech.spec(), "dim": self.dim,
            "alphas": list(self.accountant.alphas), "lr": self.lr,
            "server_opt": self.server_opt.name,
        }, sort_keys=True, default=repr)
        return np.frombuffer(hashlib.sha256(blob.encode()).digest(), np.uint8)

    # -- intake --------------------------------------------------------------
    def current_version(self) -> int:
        """The model version a fetching client stamps into its
        ``ClientUpdate.round_tag``: one version per aggregation served."""
        return self.rounds_served

    def submit(self, updates, block: bool = True, timeout: Optional[float] = None) -> bool:
        """Enqueue one batch of encoded client updates: a ``ClientUpdate``,
        a sequence of them, or (deprecated) a bare ``(k, dim)`` array, one
        row a client. True when accepted. With ``block=True`` a full queue
        waits up to ``timeout``; otherwise the batch is refused at once. A
        halted (budget-exhausted) server refuses everything."""
        if not (isinstance(updates, ClientUpdate)
                or (isinstance(updates, (list, tuple)) and updates
                    and all(isinstance(u, ClientUpdate) for u in updates))):
            warnings.warn(
                "bare-array AggregatorServer.submit() is deprecated; pass ClientUpdate "
                "objects (repro_torch.fed.updates) so the server knows the model version "
                "each client fetched", DeprecationWarning, stacklevel=2)
        updates = [u.validate(self.dim) for u in as_updates(updates)]
        if self.halted:
            with self._counts:
                self.batches_rejected += 1
            return False
        # counted before the (possibly blocking) put, so that a concurrent
        # drain never sees a negative buffer
        with self._counts:
            self._queued_updates += len(updates)
        try:
            self.queue.put(updates, block=block, timeout=timeout)
        except queue.Full:
            with self._counts:
                self._queued_updates -= len(updates)
                self.batches_rejected += 1
            return False
        with self._counts:
            self.batches_accepted += 1
        return True

    def _drain_queue(self) -> None:
        while True:
            try:
                batch = self.queue.get_nowait()
            except queue.Empty:
                return
            self.buffer.extend(batch)
            with self._counts:
                self._queued_updates -= len(batch)

    # -- accounting ----------------------------------------------------------
    def _eps_vector(self, n: int) -> np.ndarray:
        n = int(n)
        if n not in self._eps_by_n:
            if n <= 0:
                # an all-straggler aggregation releases nothing
                v = np.zeros(len(self.accountant.alphas))
            else:
                v = np.asarray([self.mech.per_round_epsilon(n, a)
                                for a in self.accountant.alphas])
            self._eps_by_n[n] = v
        return self._eps_by_n[n]

    def budget_spent(self) -> tuple:
        """(eps spent at budget_delta, remaining eps or None)."""
        spent = float(self.accountant.dp_epsilon(self.budget_delta)[0])
        if self.budget_eps is None:
            return spent, None
        return spent, max(0.0, self.budget_eps - spent)

    def buffered_updates(self) -> int:
        """Updates accepted but not yet aggregated (queued rows and the
        drained partial cohort)."""
        return self._queued_updates + len(self.buffer)

    # -- the encoded-domain cohort sum ---------------------------------------
    def _packed_bits(self, take) -> Optional[int]:
        """The field width at which ``take``'s words add directly: every
        payload packed at one width, and the cohort's sum bound fits it;
        else None."""
        if not take or not all(u.packed for u in take):
            return None
        bits = take[0].payload.bits
        if all(u.payload.bits == bits for u in take) and \
                wire.packable(self.mech.sum_bound(len(take)), bits):
            return bits
        return None

    def _secure_sum(self, take) -> torch.Tensor:
        """The cohort's SecAgg sum on the server's device, over mixed wire
        forms. Packed at one width within the bound: the weighted rows'
        words summed directly and unpacked once (exact: no field
        overflows). Otherwise each packed payload unpacks on the device
        (``unpack_flat``), and the rows are stacked, weighted by their
        {0, 1} weights and summed (floats row after row, the reference's
        order). Either way the dense (dim,) sum is the same."""
        dev = self.device
        bits = self._packed_bits(take)
        if bits is not None:
            words = [u.payload.words for u in take if u.weight]
            stack = (np.stack(words) if words else
                     np.zeros((0, wire.packed_words(self.dim, bits)), np.int32))
            acc = torch.from_numpy(stack).to(dev).to(torch.int64).sum(0) & 0xFFFFFFFF
            return unpack_flat(wire.to_int32(acc), bits, self.dim)
        dtype = np.result_type(*(np.int32 if u.packed else u.payload.dtype for u in take))
        tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        rows = [unpack_flat(torch.from_numpy(u.payload.words).to(dev), u.payload.bits,
                            self.dim).to(tdtype)
                if u.packed else torch.from_numpy(np.asarray(u.payload, dtype)).to(dev)
                for u in take]
        z = torch.stack(rows)
        z = z * torch.tensor([u.weight for u in take], dtype=tdtype, device=dev)[:, None]
        if z.is_floating_point():
            acc = z[0].clone()
            for row in z[1:]:
                acc += row
            return acc.to(torch.float32)
        return z.sum(0, dtype=torch.int32)

    # -- the aggregation cadence ---------------------------------------------
    def step(self) -> bool:
        """Aggregate one round if a full cohort is buffered: the SecAgg sum
        of exactly ``cohort`` updates (FIFO), the decode at the realized
        count, one server-optimizer step, exact accounting, one tracker
        record. False when there is nothing to do: too few updates, or the
        budget check halted the server (the crossing round never
        applies)."""
        with self._lock:
            if self.halted:
                return False
            self._drain_queue()
            version = self.current_version()
            # the policy prunes first (a remote client cannot be made to
            # refetch), then the candidate cohort is peeked, so that the
            # budget check sees its realized size before anything commits
            candidates = self.buffer.peek(self.cohort, version)
            if len(candidates) < self.cohort:
                return False
            n_real = sum(u.weight for u in candidates)
            vec = self._eps_vector(n_real)
            if self.budget_eps is not None and n_real > 0:
                projected, _ = self.accountant.projected_dp_epsilon(self.budget_delta, vec,
                                                                    rounds=1)
                if projected > self.budget_eps + 1e-12:
                    # exactly at exhaustion: this round never aggregates
                    self.halted = True
                    self.publish_snapshot()
                    self.tracker.flush()
                    return False
            take = self.buffer.take(self.cohort, version)
            t0 = time.perf_counter()
            with self.timings.scope("secure_sum"):
                # weight-0 stragglers masked out of the sum; the round is
                # accounted at the surviving count
                z_sum = self._secure_sum(take)
            disc = 1.0
            if n_real > 0:
                with self.timings.scope("apply"):
                    # the deployment's static n: the fixed cohort's scale
                    g_hat = self.mech.decode_sum(z_sum, int(n_real))
                    disc = self.policy.discount([u.staleness for u in take if u.weight])
                    if disc != 1.0:
                        # post-processing of the release, rounded once to float32
                        g_hat = g_hat * torch.tensor(disc, dtype=torch.float32,
                                                     device=self.device)
                    self.flat, self.opt_state = self.server_opt.update(
                        g_hat, self.opt_state, self.flat, self.lr)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
            self.realized_n.append(n_real)
            self.accountant.step(vec)
            self.rounds_served += 1
            self.updates_aggregated += n_real
            stal = [u.staleness for u in take]
            self.round_extras.append({
                "arrived": len(take),
                "delivered": n_real,
                "staleness_mean": float(np.mean(stal)) if stal else 0.0,
                "staleness_max": int(np.max(stal)) if stal else 0,
                "updates_discarded": self.buffer.discarded,
                # bytes this cohort's payloads took as shipped
                "uplink_bytes": int(sum(u.payload_nbytes for u in take)),
                "packed_payloads": int(sum(1 for u in take if u.packed)),
                **({"staleness_discount": float(disc)} if self.engine == "async" else {}),
            })
            self._emitter.emit(self.accountant.history, self.realized_n,
                               time.perf_counter() - t0, extras=self.round_extras)
            if self.ckpt_dir and self.ckpt_every and self.rounds_served % self.ckpt_every == 0:
                self.save_checkpoint()
            return True

    def drain(self, max_rounds: Optional[int] = None) -> int:
        """Aggregate rounds while full cohorts are available (at most
        ``max_rounds``); returns how many were served."""
        served = 0
        while (max_rounds is None or served < max_rounds) and self.step():
            served += 1
        return served

    # -- long-lived service loop ---------------------------------------------
    def _on_device(self):
        """The server's device (its index pinned at construction) as the
        current one (a service thread starts on device 0), so its launches
        go to that device's current stream."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def serve(self, poll: float = 0.005, idle_timeout: Optional[float] = None) -> None:
        """Run the aggregation loop in the calling thread until
        ``shutdown()``, budget exhaustion, or ``idle_timeout`` seconds
        without a full cohort."""
        with self._on_device():
            idle_since = time.time()
            while not self._stop.is_set() and not self.halted:
                if self.step():
                    idle_since = time.time()
                    continue
                if idle_timeout is not None and time.time() - idle_since > idle_timeout:
                    return
                time.sleep(poll)

    def start(self, poll: float = 0.005) -> None:
        """Run ``serve`` on a background thread (producers call ``submit``
        from their own threads; the bounded queue paces them)."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("aggregator already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self.serve, kwargs={"poll": poll}, daemon=True)
        self._thread.start()

    def shutdown(self, final_snapshot: bool = True) -> None:
        """Stop the service loop (if running), publish a final snapshot,
        flush and close the tracker."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if final_snapshot:
            self.publish_snapshot()
        self.tracker.log_timings(self.timings.summary())
        self.tracker.close()

    # -- health / status ------------------------------------------------------
    def snapshot(self) -> dict:
        """Budget remaining, queue depth, rounds served, intake counters
        and uptime."""
        spent, remaining = self.budget_spent()
        return {
            "engine": self.engine,
            "staleness_policy": self.policy.describe(),
            "rounds_served": self.rounds_served,
            "updates_aggregated": self.updates_aggregated,
            "updates_discarded": self.buffer.discarded,
            "queue_depth": self.queue.qsize(),
            "queue_limit": self.queue.maxsize,
            "pending_updates": self.buffered_updates(),
            "batches_accepted": self.batches_accepted,
            "batches_rejected": self.batches_rejected,
            "eps_spent": spent,
            "eps_remaining": remaining,
            "budget_eps": self.budget_eps,
            "halted": self.halted,
            "uptime_seconds": round(time.time() - self._t0, 3),
        }

    def publish_snapshot(self) -> dict:
        snap = self.snapshot()
        self.tracker.log_snapshot(snap)
        return snap

    # -- checkpoint / resume --------------------------------------------------
    def save_checkpoint(self) -> str:
        if not self.ckpt_dir:
            raise ValueError("no checkpoint directory configured (ckpt_dir)")
        hist = self.accountant.history
        tree = {
            "flat": self.flat,
            "opt": self.opt_state,
            "eps_history": (np.stack(hist) if hist
                            else np.zeros((0, len(self.accountant.alphas)))),
            "realized_n": np.asarray(self.realized_n, np.int64),
            "fingerprint": self._fingerprint(),
        }
        return store.save(self.ckpt_dir, self.rounds_served, tree)

    def resume(self, step: Optional[int] = None) -> int:
        """Restore the latest (or given) checkpoint: parameters and
        optimizer state exactly, the accountant replayed from its realized
        history, the tracker's series re-anchored."""
        if not self.ckpt_dir:
            raise ValueError("no checkpoint directory configured (ckpt_dir)")
        if step is None:
            step = store.latest_step(self.ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.ckpt_dir}")
        fp = store.restore(self.ckpt_dir, step, {"fingerprint": np.zeros(32, np.uint8)})
        if not np.array_equal(fp["fingerprint"], self._fingerprint()):
            raise ValueError(
                f"checkpoint step {step} in {self.ckpt_dir} was written by a DIFFERENT "
                f"mechanism/optimizer deployment (fingerprint mismatch); its epsilon "
                f"history does not describe this server")
        alphas = self.accountant.alphas
        data = store.restore(self.ckpt_dir, step, {
            "flat": self.flat,
            "opt": self.opt_state,
            "eps_history": np.zeros((step, len(alphas)), np.float64),
            "realized_n": np.zeros(step, np.int64),
        })
        self.flat = data["flat"]
        self.opt_state = data["opt"]
        self.accountant = RenyiAccountant(alphas=alphas)
        self.realized_n = []
        for n, vec in zip(data["realized_n"], data["eps_history"]):
            self.realized_n.append(int(n))
            self.accountant.step(vec)
        self.rounds_served = step
        self.updates_aggregated = sum(self.realized_n)
        self.halted = False
        self._emitter.sync(self.accountant.total_rdp(), step)
        return step


def _simulated_grads(mech, dim: int, generator: torch.Generator, k: int, device):
    """k clients' gradients, uniform in [-clip, clip], drawn on the CPU
    from ``generator`` and copied to ``device``."""
    grads = torch.empty((k, dim), dtype=torch.float32).uniform_(
        -mech.clip, mech.clip, generator=generator)
    return grads.to(device)


def simulate_client_batch(mech, dim: int, generator: torch.Generator, k: int,
                          device="cuda") -> np.ndarray:
    """k clients' encoded updates for the simulated stream, as a (k, dim)
    numpy array: random bounded gradients from ``generator`` (a CPU
    ``torch.Generator``), then one seed from it, through the batched
    encoder on ``device``."""
    grads = _simulated_grads(mech, dim, generator, k, device)
    return mech.encode_batch(grads, draw_seed(generator)).cpu().numpy()


def simulate_client_updates(mech, dim: int, generator: torch.Generator, k: int, *,
                            round_tag: int, first_id: int = 0, packed: bool = False,
                            device="cuda") -> list:
    """The typed simulated stream: ``ClientUpdate``s stamped with the
    model version the clients fetched. ``packed=True`` ships each payload
    packed (``mech.encode_wire``, one seed a client from ``generator``
    after the gradients), the bandwidth-realistic uplink."""
    if packed:
        grads = _simulated_grads(mech, dim, generator, k, device)
        seeds = [draw_seed(generator) for _ in range(k)]
        return [ClientUpdate(payload=mech.encode_wire(grads[i], seeds[i]),
                             client_id=first_id + i, round_tag=round_tag)
                for i in range(k)]
    rows = simulate_client_batch(mech, dim, generator, k, device)
    return [ClientUpdate(payload=row, client_id=first_id + i, round_tag=round_tag)
            for i, row in enumerate(rows)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Long-lived aggregator round-server over a simulated client-update "
                    "stream")
    ap.add_argument("--mechanism", default="rqm:c=0.02,m=16,q=0.42",
                    help="mechanism spec string (the deployment's codec)")
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--cohort", type=int, default=8, help="updates aggregated per round")
    ap.add_argument("--engine", default=None,
                    help="aggregation policy: None = the synchronous cadence; an async "
                         "engine spec, e.g. 'async:max_staleness=4,staleness_weight=poly:0.5'")
    ap.add_argument("--batch", type=int, default=4, help="client updates per submitted batch")
    ap.add_argument("--batches", type=int, default=16,
                    help="batches the simulated clients stream")
    ap.add_argument("--queue-limit", type=int, default=8)
    ap.add_argument("--packed", action="store_true",
                    help="simulated clients upload packed payloads (mech.encode_wire)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="simulated batch arrivals/sec (0 = as fast as backpressure allows)")
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--server-opt", default="sgd")
    ap.add_argument("--budget-eps", type=float, default=None)
    ap.add_argument("--budget-delta", type=float, default=1e-5)
    ap.add_argument("--track", default=None,
                    help="tracker spec, e.g. json:runs/agg.json or csv:runs/agg.csv")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--snapshot-every", type=float, default=1.0,
                    help="seconds between printed health snapshots")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny stream and a budget that exhausts mid-stream; checks the "
                         "drain, backpressure and halt invariants, exits non-zero on a "
                         "violation")
    args = ap.parse_args(argv)
    if args.smoke:
        args.dim, args.cohort, args.batch = 64, 4, 4
        args.batches, args.queue_limit = 10, 4
        if args.budget_eps is None:
            args.budget_eps = 40.0

    mech = make_mechanism(args.mechanism)
    server = AggregatorServer(
        mech, args.dim, cohort=args.cohort, lr=args.lr, server_opt=args.server_opt,
        queue_limit=args.queue_limit, budget_eps=args.budget_eps,
        budget_delta=args.budget_delta, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        tracker=args.track, engine=args.engine, device=args.device)
    if args.resume:
        print(f"[aggregator] resumed at round {server.resume()}")

    def produce():
        generator = torch.Generator().manual_seed(0)
        for i in range(args.batches):
            # each simulated client stamps the model version it fetched
            batch = simulate_client_updates(
                mech, args.dim, generator, args.batch, round_tag=server.current_version(),
                first_id=i * args.batch, packed=args.packed, device=server.device)
            t0 = time.time()
            accepted = server.submit(batch, block=True, timeout=10.0)
            waited = time.time() - t0
            if not accepted:
                print(f"[client] batch {i} refused "
                      f"({'halted' if server.halted else 'queue full'})")
                if server.halted:
                    return
            elif waited > 0.05:
                print(f"[client] batch {i} backpressured {waited:.2f}s")
            if args.rate:
                time.sleep(1.0 / args.rate)

    producer = threading.Thread(target=produce, daemon=True)
    server.start()
    producer.start()
    t_last = 0.0
    while producer.is_alive():
        producer.join(timeout=0.05)
        if time.time() - t_last >= args.snapshot_every:
            t_last = time.time()
            print(f"[health] {server.publish_snapshot()}")
    # let the loop drain what a full cohort still covers
    deadline = time.time() + 10.0
    while (not server.halted and server.buffered_updates() >= server.cohort
           and time.time() < deadline):
        time.sleep(0.02)
    server.shutdown()
    snap = server.snapshot()
    print(f"[final] {snap}")

    if args.smoke:
        total = args.batches * args.batch
        ok = snap["rounds_served"] >= 1
        if server.halted:
            # halted within the budget, intake refused
            ok &= snap["eps_spent"] <= args.budget_eps + 1e-9
            ok &= not server.submit(np.zeros((args.batch, args.dim), np.int32), block=False)
        else:
            ok &= snap["rounds_served"] == total // args.cohort
        ok &= snap["pending_updates"] < server.cohort or server.halted
        # eps on the wire is the accountant's answer exactly
        ok &= snap["eps_spent"] == server.accountant.dp_epsilon(args.budget_delta)[0]
        if not ok:
            raise SystemExit(f"aggregator smoke FAILED: {snap}")
        print(f"aggregator smoke OK: {snap['rounds_served']} rounds, "
              f"halted={snap['halted']}, eps_spent={snap['eps_spent']:.2f}")


if __name__ == "__main__":
    main()
