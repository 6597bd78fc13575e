"""The model zoo's layers and assembly at tp = 1 (counterpart of
``repro/models/``): the training forward and loss only."""
