"""One rank of the LM train launcher's four-rank checks (gloo, CPU), and
the one-process replay they are held against.

Started four times by tests/test_torch_train_ranks.py::test_four_gloo_ranks:

    PYTHONPATH=src python tests/torch_train_worker.py <rank> <world> <store file>

Each rank joins the default process group on a FileStore and runs
``repro_torch.launch.train`` on a reduced mamba2-370m for STEPS steps on
the plans ``4`` (RQM) and ``2x2x1`` (QMGeo, whose plain version is four
times faster on the CPU), packed and not: every run's parameters must be
bit-equal across the ranks (sha256 of their bytes, gathered) and equal
to ``replay``, which runs the same four clients in one process (their
batch rows, their seeds, the summed levels); the noise-free baseline's
float sum over the ranks allclose to its replay; a global batch that
does not divide over the ranks refused. Prints one line per check and
exits 0 when all hold. Imports no JAX.
"""
import datetime
import hashlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config
from repro_torch.convert import leaves, map_leaves
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.data.lm import TokenPipeline
from repro_torch.distributed.step import train_seeds
from repro_torch.eval.lm_eval import batch_to
from repro_torch.launch import train
from repro_torch.models import model
from repro_torch.models.common import ParallelCtx
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import warmup_cosine

ARCH = "mamba2-370m"
STEPS, BATCH, SEQ, SEED, LR = 2, 4, 16, 3, 0.5
SPECS = {"4": "rqm:c=0.02", "2x2x1": "qmgeo:c=0.02"}


def replay_levels(mech, client_grads, client_seeds) -> list:
    """Each leaf's levels summed over the clients: ``client_grads[r][i]``
    encoded at ``client_seeds[r][i]`` (``mech.quantize``), summed in int32
    (the noise-free baseline's floats in float32, client by client)."""
    out = []
    for i in range(len(client_grads[0])):
        z = mech.quantize(client_grads[0][i], client_seeds[0][i])
        for r in range(1, len(client_grads)):
            z = z + mech.quantize(client_grads[r][i], client_seeds[r][i])
        out.append(z)
    return out


def replay(spec: str, n_clients: int, *, server_opt: str = "sgd") -> dict:
    """The launcher's run (``--seed SEED --lr LR --steps STEPS --batch
    BATCH --seq SEQ``) of ``n_clients`` client ranks, replayed in one
    process from the port's parts: each client's gradient of its rows
    (``torch.autograd`` of ``model.loss_fn``), the summed levels, the
    decode at ``n_clients``, the optimizer at the launcher's rate."""
    cfg = get_config(ARCH, reduced=True)
    mech, opt = make_mechanism(spec), make_optimizer(server_opt)
    lr_fn = warmup_cosine(LR, warmup=STEPS // 10 + 1, total_steps=STEPS, device="cpu")
    params = model.init_params(torch.Generator("cpu").manual_seed(SEED + 1), cfg, device="cpu")
    state = opt.init(params)
    pipe = TokenPipeline(cfg, SEQ, BATCH, seed=SEED)
    rows = BATCH // n_clients
    n = len(leaves(params))
    for step in range(STEPS):
        batch = batch_to(pipe.batch(step), "cpu")
        grads = []
        for r in range(n_clients):
            p = [t.detach().requires_grad_() for t in leaves(params)]
            local = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
            loss = model.loss_fn(map_leaves(lambda i, _: p[i], params), cfg, ParallelCtx(),
                                 local)[0]
            grads.append(list(torch.autograd.grad(loss, p)))
        z = replay_levels(mech, grads, [train_seeds(SEED, step, r, n)
                                        for r in range(n_clients)])
        ghat = map_leaves(lambda i, t: mech.decode_sum(z[i], n_clients).to(t.dtype), params)
        params, state = opt.update(ghat, state, params, lr_fn(step))
    return params


def digest(params) -> str:
    h = hashlib.sha256()
    for t in leaves(params):
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _run(plan: str, packed: bool, spec: str):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--mesh-shape", plan,
            "--mechanism", spec, "--steps", str(STEPS), "--batch", str(BATCH),
            "--seq", str(SEQ), "--seed", str(SEED), "--lr", str(LR), "--log-every", "1"]
    return train.main(argv + (["--packed"] if packed else []))["params"]


def main(rank: int, world: int, store_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--mesh-shape", "4",
                    "--steps", "1", "--batch", "3", "--seq", str(SEQ)])
    except ValueError as e:
        assert "does not divide over 4 client ranks" in str(e), e
    else:
        raise AssertionError("a global batch of 3 over 4 ranks was not refused")
    print(f"rank {rank}: a global batch of 3 over {world} ranks refused")
    for plan, spec in SPECS.items():
        want = digest(replay(spec, world))
        for packed in (False, True):
            got = digest(_run(plan, packed, spec))
            every = [None] * world
            dist.all_gather_object(every, got)
            assert len(set(every)) == 1, (plan, packed, every)
            assert got == want, (plan, packed)
            print(f"rank {rank}: plan {plan} {spec} packed={packed}: parameters bit-equal "
                  f"across the {world} ranks and to the one-process replay")
    none = _run("4", False, "none:c=0.02")
    for a, b in zip(leaves(none), leaves(replay("none:c=0.02", world))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
    print(f"rank {rank}: none: the float sum over the ranks allclose to the replay")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
