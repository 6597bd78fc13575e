"""Pins torch's intra-op thread pool for the port's tests.

The tier-1 command runs the suite in several pytest-xdist workers on one
machine. Each worker's torch would otherwise start a pool as wide as the
machine, and the pools contend: the port's tests then take several times
as long as on THREADS threads each. Every ``tests/test_torch_*.py``
imports this module first, and every worker collects every file, so each
worker runs torch on THREADS threads. The subprocesses of
``torch_shard_worker.py`` pin themselves to one as well. Nothing in
``src/repro_torch`` sets a thread count: that is the caller's choice.
"""
import torch

THREADS = 1
torch.set_num_threads(THREADS)
