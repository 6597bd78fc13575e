"""The LM training launcher over four gloo client ranks, one process
each (tests/torch_train_worker.py), on the plans ``4`` and ``2x2x1``,
packed and not: every rank's parameters after the run bit-equal across
the ranks and to the one-process replay of the same four clients (their
batch rows, their seeds, the summed levels), which
tests/test_torch_train_encode_pbm.py holds against the reference; the
noise-free baseline's float sum allclose (another reduction order); a
global batch that does not divide over the ranks refused.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_four_gloo_ranks(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([os.path.join(ROOT, "src"),
                                                       os.path.join(ROOT, "tests")])}
    store = tmp_path / "store"
    worker = os.path.join(ROOT, "tests", "torch_train_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), "4", str(store)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
        assert out.count("bit-equal across the 4 ranks") == 4, out
        assert "none: the float sum" in out
        assert "a global batch of 3 over 4 ranks refused" in out
