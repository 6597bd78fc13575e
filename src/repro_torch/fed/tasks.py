"""The client-task registry (counterpart of ``repro/fed/tasks.py``): WHAT
the federated round trains.

A task is a registered class (``@register_task``) built from the shared
``"name:k=v"`` spec grammar (``FedConfig.task``); it owns everything
model- and data-specific about a round:

  * ``init_params(generator)``: the model the server optimizes, drawn
    from a ``torch.Generator`` on the task's device;
  * ``loss(params, batch)``: the per-client objective over an opaque
    batch dict (the engines stage, index and ``vmap`` whole leaves);
  * ``client_batch(cid)``: the client's deterministic local dataset, a
    dict of numpy arrays of fixed shapes across clients;
  * ``evaluate(flat, unravel)``: held-out metrics (must report "loss").

Two registered tasks, in the reference's order:

  * ``"emnist_cnn"`` (default): the paper's EMNIST setup;
  * ``"lm"``: federated private LM fine-tuning, per-client token batches
    from ``data/lm.py`` through a reduced model-zoo config; with
    ``model_shards > 1`` each client's gradient runs tensor-parallel
    (the model-axis hooks below, bound by the shard engine).
"""
from __future__ import annotations

import inspect
from typing import ClassVar, Dict, Type

import numpy as np
import torch

from repro_torch.core.mechanisms import parse_mechanism_spec
from repro_torch.fed import cnn

_TASKS: Dict[str, Type["ClientTask"]] = {}
# the arguments every task takes, which a spec does not set
_FIXED_ARGS = ("self", "cfg", "device")


def register_task(name: str):
    """Class decorator: register a ClientTask subclass under ``name``."""

    def deco(cls: type) -> type:
        if not (isinstance(cls, type) and issubclass(cls, ClientTask)):
            raise TypeError(f"{cls!r} must subclass ClientTask")
        existing = _TASKS.get(name)
        if existing is not None and existing is not cls:
            raise ValueError(f"task {name!r} already registered to {existing}")
        cls.name = name
        _TASKS[name] = cls
        return cls

    return deco


def task_names() -> tuple:
    """Registered task names (stable registration order)."""
    return tuple(_TASKS)


def get_task(name: str) -> Type["ClientTask"]:
    cls = _TASKS.get(name)
    if cls is None:
        raise ValueError(f"unknown task {name!r}; registered: {', '.join(_TASKS)}")
    return cls


def make_task(spec, fed_cfg, device="cuda") -> "ClientTask":
    """Build a registered task from a spec string on ``device``. Explicit
    options are checked against the task's constructor signature."""
    if isinstance(spec, ClientTask):
        return spec
    name, opts = parse_mechanism_spec(spec)
    cls = get_task(name)
    params = inspect.signature(cls.__init__).parameters
    accepted = {p for p in params if p not in _FIXED_ARGS}
    unknown = set(opts) - accepted
    if unknown:
        raise ValueError(
            f"task {name!r} does not accept option(s) {sorted(unknown)}; "
            f"accepted: {sorted(accepted) if accepted else '(none)'}"
        )
    task = cls(fed_cfg, device, **opts)
    task.options = tuple(sorted(opts.items()))
    return task


class ClientTask:
    """One federated client workload (see the module docstring)."""

    name: ClassVar[str] = "?"
    # whether the task can run tensor-parallel over a 2-D ("shard",
    # "model") mesh (model_shards > 1)
    supports_model_axis: ClassVar[bool] = False

    # explicit spec options, set by make_task (canonical fingerprinting)
    options: tuple = ()

    def spec(self) -> str:
        """Canonical spec string: parses back to an equal task."""
        if not self.options:
            return self.name
        body = ",".join(f"{k}={v}" for k, v in self.options)
        return f"{self.name}:{body}"

    def init_params(self, generator: torch.Generator):
        raise NotImplementedError

    def loss(self, params, batch: dict) -> torch.Tensor:
        """Scalar training loss (tp == 1)."""
        raise NotImplementedError

    def client_batch(self, cid: int) -> dict:
        """Client ``cid``'s deterministic local dataset (numpy)."""
        raise NotImplementedError

    def evaluate(self, flat: torch.Tensor, unravel) -> dict:
        """Held-out metrics of the flat parameters; must include "loss"."""
        raise NotImplementedError

    # -- model-axis hooks (2-D mesh; tp > 1) ---------------------------------
    # bind_model_axis(ctx): the model axis (a ParallelCtx without client
    # axes) the task's gradient runs over; shard_params(params, ctx): a
    # global params tree -> this rank's slices; local_loss(local, batch,
    # ctx): the loss over them, divided by tp; gather_grads(local_grads,
    # ctx): the synced local gradient leaves -> the global tree, the same
    # on every model rank
    def bind_model_axis(self, ctx) -> None:
        raise ValueError(
            f"task {self.name!r} does not support a model axis "
            f"(model_shards > 1); only tasks with supports_model_axis "
            f"can run on a 2-D mesh"
        )

    def shard_params(self, params, ctx):
        raise NotImplementedError

    def local_loss(self, local_params, batch, ctx):
        raise NotImplementedError

    def gather_grads(self, local_grads, ctx):
        raise NotImplementedError


@register_task("emnist_cnn")
class EmnistCnnTask(ClientTask):
    """Dirichlet non-iid synthetic EMNIST partition, the ``fed/cnn.py``
    model, accuracy and loss on a held-out split. Eval data lives on
    ``device``."""

    def __init__(self, cfg, device="cuda"):
        from repro_torch.data.federated import FederatedPartition

        self.cfg = cfg
        self.device = torch.device(device)
        self.partition = FederatedPartition(
            num_clients=cfg.num_clients,
            samples_per_client=cfg.samples_per_client,
            seed=cfg.seed,
            deform=cfg.data_deform,
            noise=cfg.data_noise,
        )
        ev_im, ev_lb = self.partition.gen.make_split(
            seed=10_000 + cfg.seed, size=cfg.eval_size
        )
        self.eval_images = torch.from_numpy(ev_im).to(self.device)
        self.eval_labels = torch.from_numpy(ev_lb).to(self.device)

    def init_params(self, generator: torch.Generator) -> dict:
        return cnn.cnn_init(generator, device=self.device)

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        return cnn.cnn_loss(params, batch["images"], batch["labels"])

    def client_batch(self, cid: int) -> dict:
        im, lb = self.partition.client_data(int(cid))
        return {"images": im, "labels": lb}

    @torch.no_grad()
    def evaluate(self, flat: torch.Tensor, unravel) -> dict:
        params = unravel(flat)
        acc = cnn.cnn_accuracy(params, self.eval_images, self.eval_labels)
        loss = cnn.cnn_loss(params, self.eval_images, self.eval_labels)
        return {"accuracy": float(acc), "loss": float(loss)}


@register_task("lm")
class LmTask(ClientTask):
    """Federated private LM fine-tuning over the model zoo.

    Client ``cid``'s local dataset is the ``TokenPipeline`` batch ``cid``
    (Markov token sequences, deterministic per (seed, cid)). The loss is
    the zoo's next-token CE (+ MoE aux) in float32; any registered config
    runs, always its reduced variant, the default a shrunk
    ``mamba2-370m``."""

    supports_model_axis = True

    def __init__(self, cfg, device="cuda", model: str = "mamba2-370m", seq_len: int = 64,
                 batch: int = 2, branch: int = 4, eval_batch: int = 4,
                 eval_batches: int = 2, eval_seed: int = 9_999):
        from repro_torch.configs.registry import get_config
        from repro_torch.data.lm import TokenPipeline

        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model
        self.model_cfg = get_config(model, reduced=True)
        self.seq_len = int(seq_len)
        self.batch = int(batch)
        self.eval_batch = int(eval_batch)
        self.eval_batches = int(eval_batches)
        # client cid's fixed local data is the pipeline's batch(cid):
        # deterministic per (seed, cid), disjoint from the eval stream
        self._pipe = TokenPipeline(self.model_cfg, self.seq_len, self.batch,
                                   seed=cfg.seed, branch=int(branch))
        self._eval_pipe = TokenPipeline(self.model_cfg, self.seq_len, self.eval_batch,
                                        seed=int(eval_seed), branch=int(branch))
        self.tp = 1
        self._ctx = None
        self._meta = None

    def init_params(self, generator: torch.Generator) -> dict:
        """The global tree at the bound tp (``bind_model_axis``)."""
        from repro_torch.models import model as model_lib

        return model_lib.init_params(generator, self.model_cfg, device=self.device, tp=self.tp)

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        from repro_torch.models import model as model_lib
        from repro_torch.models.common import ParallelCtx

        return model_lib.loss_fn(params, self.model_cfg, ParallelCtx(), batch, remat=False,
                                 compute_dtype=torch.float32)[0]

    def client_batch(self, cid: int) -> dict:
        return self._pipe.batch(int(cid))

    def evaluate(self, flat: torch.Tensor, unravel) -> dict:
        """Over a model axis every model rank evaluates its slices
        together."""
        from repro_torch.eval.lm_eval import perplexity, stream_ce
        from repro_torch.models.common import ParallelCtx

        params, ctx = unravel(flat), ParallelCtx()
        if self.tp > 1:
            params, ctx = self.shard_params(params, self._ctx), self._ctx
        ce, tokens = stream_ce(params, self.model_cfg, self._eval_pipe, self.eval_batches,
                               self.device, ctx)
        return {"loss": ce, "ppl": perplexity(ce), "eval_tokens": tokens}

    # -- model-axis hooks (the shard engine's 2-D ("shard", "model") grid) ---
    def bind_model_axis(self, ctx) -> None:
        from repro_torch.models import model as model_lib

        self._ctx = ctx
        self.tp = int(ctx.tp)
        self._meta = model_lib.param_meta(self.model_cfg, tp=self.tp)

    def shard_params(self, params, ctx):
        """GLOBAL param tree -> this model rank's LOCAL slices (views),
        the layout the train step's ranks hold (``meta.shard_leaf``)."""
        from repro_torch.models import meta as meta_lib

        return meta_lib.shard_tree(params, self._meta, ctx.tp, ctx.model_index())

    def local_loss(self, local_params, batch, ctx):
        """Tensor-parallel loss over LOCAL params, divided by tp (the train
        step's psum self-transpose correction, so that ``gather_grads``'s
        sync sums the replicated leaves' partials to their gradient)."""
        from repro_torch.models import model as model_lib

        return model_lib.loss_fn(local_params, self.model_cfg, ctx, batch, remat=False,
                                 compute_dtype=torch.float32)[0] / ctx.tp

    def gather_grads(self, local_grads: list, ctx):
        """LOCAL gradient leaves (``convert.leaves`` order) -> the GLOBAL
        tree, identical on every model rank: ``sync_grads`` (psum for a
        replicated leaf, the subgroup sum for a duplicated one), then a
        tiled all_gather along each leaf's model dim."""
        from repro_torch.convert import map_leaves
        from repro_torch.models import meta as meta_lib

        grads = meta_lib.sync_grads(local_grads, self._meta, ctx)
        return meta_lib.gather_tree(map_leaves(lambda i, _: grads[i], self._meta),
                                    self._meta, ctx)


def tree_nbytes(tree) -> int:
    """Total bytes of a staged tree's leaves (numpy arrays or tensors; the
    staging byte counters)."""
    from repro_torch.convert import leaves

    return int(sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor)
                   else np.asarray(t).nbytes for t in leaves(tree)))
