"""Runs the tensor-parallel parity tests' two sides side by side: the
JAX reference in a subprocess with four fake CPU devices
(tests/tp_reference.py) and the port's gloo ranks, one subprocess each
(tests/torch_tp_worker.py), all started together on the same inputs
file. Shared by tests/test_torch_tp_*.py."""
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ENV = {**os.environ, "PYTHONPATH": os.pathsep.join([os.path.join(ROOT, "src"), HERE]),
       "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def reference(job: str, src, dst, *args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, os.path.join(HERE, "tp_reference.py"), job,
                             str(src), str(dst), *args], env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def ranks(job: str, world: int, tmp, src, *args) -> list:
    store = os.path.join(str(tmp), f"store_{job}_{world}_{'_'.join(args)}")
    return [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_tp_worker.py"), job,
                              str(r), str(world), store, str(src), str(tmp), *args], env=ENV,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait(procs: list, timeout: float = 200) -> list:
    """Every process's output; each must exit 0."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"{p.args}:\n{out}"
    return outs


def load(path) -> dict:
    with np.load(path) as f:
        return dict(f)


def close(got, want, rtol, what=""):
    """Within ``rtol`` of the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max(initial=0.0)
    scale = np.abs(want).max(initial=0.0)
    assert err <= rtol * scale, f"{what}: max err {err} > {rtol} x {scale}"
