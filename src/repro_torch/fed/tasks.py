"""The client task a round trains: the paper's EMNIST CNN (the
``emnist_cnn`` task of ``repro/fed/tasks.py``). The ``lm`` task of the
reference is not ported yet (ROADMAP.md queue A item 12)."""
from __future__ import annotations

import torch

from repro_torch.core.mechanisms import parse_mechanism_spec
from repro_torch.fed import cnn


class EmnistCnnTask:
    """Dirichlet non-iid synthetic EMNIST partition, the ``fed/cnn.py``
    model, accuracy and loss on a held-out split. Eval data lives on
    ``device``."""

    def __init__(self, cfg, device):
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

    name = "emnist_cnn"

    def spec(self) -> str:
        """Canonical spec string (the task takes no options)."""
        return self.name

    def init_params(self, generator: torch.Generator) -> dict:
        return cnn.cnn_init(generator, device=self.device)

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        return cnn.cnn_loss(params, batch["images"], batch["labels"])

    def client_batch(self, cid: int) -> dict:
        """Client ``cid``'s deterministic local dataset (numpy)."""
        im, lb = self.partition.client_data(int(cid))
        return {"images": im, "labels": lb}

    @torch.no_grad()
    def evaluate(self, flat: torch.Tensor, unravel) -> dict:
        params = unravel(flat)
        acc = cnn.cnn_accuracy(params, self.eval_images, self.eval_labels)
        loss = cnn.cnn_loss(params, self.eval_images, self.eval_labels)
        return {"accuracy": float(acc), "loss": float(loss)}


def make_task(spec: str, cfg, device) -> EmnistCnnTask:
    name, opts = parse_mechanism_spec(spec)
    if name == "lm":
        raise NotImplementedError(
            "task 'lm' is not ported yet: ROADMAP.md queue A item 12")
    if name != "emnist_cnn":
        raise ValueError(f"unknown task {name!r}; ported: emnist_cnn")
    if opts:
        raise ValueError(f"task 'emnist_cnn' takes no options, got {sorted(opts)}")
    return EmnistCnnTask(cfg, device)
