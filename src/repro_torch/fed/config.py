"""FedConfig (the fields of ``repro/fed/config.py`` this package runs).

Defaults follow the reference: ``FedConfig()`` is its default round, the
materialized ``scan`` engine. ``validate_config`` makes the
engine-independent checks (each engine's ``Engine.validate`` adds its
own); settings of the reference that the port does not run yet are
refused with NotImplementedError naming the ROADMAP.md item that carries
them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class FedConfig:
    num_clients: int = 3400
    clients_per_round: int = 40
    rounds: int = 200
    lr: float = 0.5
    seed: int = 0
    eval_size: int = 2000
    samples_per_client: int = 20
    accountant_alphas: tuple = (2.0, 4.0, 8.0, 16.0, 32.0)
    data_deform: float = 0.35
    data_noise: float = 0.25
    # 1: one clipped gradient per client per round (Algorithm 1); more:
    # the clipped negative delta of local_steps SGD steps at local_lr
    # (FedAvg-RQM)
    local_steps: int = 1
    # a registered engine name or spec string (fed/engine.py): "scan"
    # (blocks of rounds, each round a replay of a captured CUDA graph on
    # the card, sums kept on the device until the block ends), "perround"
    # (one eager round per call), "host" (the legacy loop: per-round host
    # staging, per-client encode) or "shard" (eager rounds over a process
    # group, one cohort slice per rank) or "async" (buffered aggregation
    # under seeded arrival traffic), e.g. "shard:shards=1,packed=true"
    engine: str = "scan"
    local_lr: float = 0.1
    task: str = "emnist_cnn"
    # the server optimizer at the decode-then-apply boundary
    # (optim/optimizers.py): "sgd" (the paper's w - lr * g_hat), "momentum"
    # or "adam"; server_opt_options are the factory's keyword options
    # (e.g. {"beta": 0.9, "weight_decay": 1e-4}). Its state is carried by
    # every engine and checkpointed with the parameters.
    server_opt: str = "sgd"
    server_opt_options: Optional[dict] = None
    # checkpoint/resume (fed/checkpointing.py): with ckpt_dir set, train()
    # saves the parameters, the optimizer state, the round stream and the
    # accountant's history every ckpt_every rounds (blocks are split to
    # land on the multiples); a restored trainer continues bit for bit
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    # heterogeneous cohorts (fed/cohort.py): "poisson" selects each client
    # at rate clients_per_round / num_clients; dropout drops each selected
    # client with that probability; max_cohort caps a Poisson slate. Each
    # round is accounted at its realized size.
    subsampling: str = "fixed"
    dropout: float = 0.0
    max_cohort: Optional[int] = None
    # privacy budget: with budget_eps set, train() logs the (eps,
    # budget_delta)-DP spent at every eval point and halts after the last
    # round the budget affords
    budget_eps: Optional[float] = None
    budget_delta: float = 1e-5
    # False: encode the (clients, dim) batch, sum it, decode, apply.
    # True: clip -> encode -> sum as one fused kernel and, for grid
    # mechanisms with plain SGD and no weight decay, decode -> apply as
    # another. Both give
    # the same parameters bit for bit.
    fused_rounds: bool = False
    # None: pack the fused SecAgg sum into b-bit wire fields when the
    # cohort's sum bound fits (10 bits, 3 per word, at a cohort of 40
    # with m=16); True: pack or raise; False: keep the dense int32 sum.
    wire_packed: Optional[bool] = None
    # keep each round's dense SecAgg sum on the host (trainer.round_sums)
    collect_sums: bool = False
    # the scan and shard engines advance in blocks of at most scan_block
    # rounds
    scan_block: int = 64
    # shard engine (engine="shard"). shards=None spans the default process
    # group (one rank when there is none); clients_per_round must divide
    # evenly across shards. staging: "full" stages the whole population
    # on every rank once; "stream" stages only each block's cohort slice
    # of this rank, so host and device memory stay
    # O(scan_block * clients_per_round) client datasets whatever
    # num_clients is. shard_packed: None packs the cross-shard level sum
    # at the least safe width when mech.sum_bound(n) fits 16 bits; True
    # packs or raises; False forces the plain all_reduce.
    shards: Optional[int] = None
    staging: str = "full"
    shard_packed: Optional[bool] = None
    # > 1: the reference's 2-D client x model mesh (not ported)
    model_shards: int = 1
    # async engine (engine="async"; fed/async_engine.py): buffered
    # aggregation under a seeded arrival process. async_cadence updates
    # are drained per aggregation (None: clients_per_round);
    # async_max_staleness bounds how many versions old a buffered
    # update's parameters may be (0, no timeout and full staging: the
    # perround round itself); async_staleness_weight scales the decoded
    # aggregate ("uniform" or "poly:<a>", post-processing, the accounting
    # untouched); async_arrivals is an arrival-process spec
    # (fed/arrivals.py: "poisson", "diurnal:period=24,amplitude=0.5");
    # async_rate arrivals per unit of simulated time (None: the cadence);
    # async_latency the mean exponential compute latency; with
    # async_timeout set, clients slower than it are stragglers, masked out
    # of the SecAgg sum, the aggregation accounted at the surviving count.
    async_cadence: Optional[int] = None
    async_max_staleness: int = 0
    async_staleness_weight: str = "uniform"
    async_arrivals: str = "poisson"
    async_rate: Optional[float] = None
    async_latency: float = 1.0
    async_timeout: Optional[float] = None
    # telemetry (telemetry/tracker.py): a tracker spec ("json:runs/a.json",
    # "csv:runs/a.csv", a "+"-joined composite, a list of specs) or a
    # Tracker; None is the noop tracker. The trainer's ``tracker=``
    # argument wins over it.
    track: Optional[object] = None


STAGINGS = ("full", "stream")
SUBSAMPLINGS = ("fixed", "poisson")


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md {item}")


def validate_config(cfg: FedConfig) -> None:
    """Engine-independent checks (``Engine.validate`` adds each engine's)."""
    if cfg.staging not in STAGINGS:
        raise ValueError(f"unknown staging {cfg.staging!r}; expected one of {STAGINGS}")
    if cfg.subsampling not in SUBSAMPLINGS:
        raise ValueError(f"unknown subsampling {cfg.subsampling!r}; expected one of "
                         f"{SUBSAMPLINGS}")
    if not 0.0 <= cfg.dropout < 1.0:
        raise ValueError(f"dropout must be in [0, 1), got {cfg.dropout}")
    if cfg.model_shards < 1:
        raise ValueError(f"model_shards must be >= 1, got {cfg.model_shards}")
    if cfg.model_shards > 1 and cfg.engine != "shard":
        raise ValueError(
            "model_shards > 1 (the 2-D client x model mesh) requires "
            f"engine='shard', got engine={cfg.engine!r}")
    if cfg.model_shards > 1:
        raise _not_ported("model_shards > 1 (the 2-D client x model mesh, which needs "
                          "the lm task)", "queue A item 12")
    if cfg.max_cohort is not None and cfg.subsampling != "poisson":
        raise ValueError("max_cohort only applies to subsampling='poisson'")
    if cfg.ckpt_every < 0:
        raise ValueError(f"ckpt_every must be >= 0, got {cfg.ckpt_every}")
    if cfg.ckpt_every and not cfg.ckpt_dir:
        raise ValueError("ckpt_every requires ckpt_dir")
    if cfg.scan_block < 1:
        raise ValueError(f"scan_block must be >= 1, got {cfg.scan_block}")
    if not 1 <= cfg.clients_per_round <= cfg.num_clients:
        raise ValueError(
            f"clients_per_round={cfg.clients_per_round} must be in "
            f"[1, num_clients={cfg.num_clients}]"
        )
