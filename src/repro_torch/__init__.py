"""PyTorch/CUDA port of the RQM federated-learning system in ``repro``.

The JAX package ``repro`` is the reference; this package reproduces its
synchronous rounds of Algorithm 1 on the EMNIST task — RQM, PBM, QMGeo
and noise-free clipped SGD, materialized (the reference's default) or
with the fused encode+sum and (unpack+)decode+SGD apply, under an sgd,
momentum or adam server, with the reference trainer's telemetry,
checkpoint/resume and budget halt — and the model zoo's lm task, greedy
serving (``launch/serve.py``) and the privacy calibration
(``privacy/``), in PyTorch, with hand-written CUDA kernels for Hopper
(``kernels/csrc``).

Every kernel wrapper takes its plain PyTorch version for CPU tensors and
launches its CUDA kernel for CUDA tensors. Layout mirrors ``repro``:
``repro_torch/core/grid.py`` is the counterpart of ``repro/core/grid.py``
and so on. Nothing here imports JAX or ``repro``.
"""
