"""The port's side of tests/test_torch_dryrun.py, run as a subprocess so
that each dry run's fake default group (``launch/mesh.py:fake_world``)
lives and dies in a process of its own, none in the test's worker:

    PYTHONPATH=src:tests python tests/torch_dryrun_worker.py <out_dir> <out.json>

Writes ``{"families": {arch: record}, "mesh": {arch: records}}``: the
records of ``dryrun.run_one`` at 16x16, production widths cut to
FAMILY_LAYERS blocks, for one architecture of each family at each of its
shapes (artifacts under ``out_dir``); and, for each of
tp_cases.DRYRUN_ARCHS reduced, the collectives (``[kind, bytes, group
size]``) of one meta call of ``dryrun.build_step`` at
tp_cases.DRYRUN_MESH, on a train shape of DRYRUN_SEQ x DRYRUN_BATCH.
"""
import json
import math
import sys

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import tp_cases
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_config
from repro_torch.distributed.step import make_plan
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import fake_world

FAMILY_LAYERS = 2
# one architecture of each family: dense, MoE, SSM, hybrid, frontend
FAMILIES = {"gemma3-4b": ("train_4k", "decode_32k"), "qwen3-moe-30b-a3b": ("train_4k",),
            "mamba2-370m": ("train_4k", "long_500k"), "zamba2-1.2b": ("train_4k",),
            "pixtral-12b": ("train_4k",)}


def main(out_dir: str, out_path: str) -> None:
    families = {f"{arch} {shape}": dryrun.run_one(arch, shape, multi_pod=False,
                                                  layers=FAMILY_LAYERS, out_dir=out_dir)
                for arch, shapes in FAMILIES.items() for shape in shapes}
    dims = tuple(int(d) for d in tp_cases.DRYRUN_MESH.split("x"))
    shape = InputShape("t", tp_cases.DRYRUN_SEQ, tp_cases.DRYRUN_BATCH, "train")
    mesh = {}
    for arch in tp_cases.DRYRUN_ARCHS:
        with fake_world(math.prod(dims)):
            fn, args = dryrun.build_step(get_config(arch, reduced=True), make_plan(dims, "meta"),
                                         shape)
            with hlo_analysis.counting() as counts:
                fn(*args)
        mesh[arch] = [list(r) for r in counts.collectives]
    with open(out_path, "w") as f:
        json.dump({"families": families, "mesh": mesh}, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
