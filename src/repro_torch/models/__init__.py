"""The model zoo's layers and assembly (counterpart of ``repro/models/``):
the training forward and loss, tensor-parallel over a model axis, and
greedy serving at tp = 1."""
