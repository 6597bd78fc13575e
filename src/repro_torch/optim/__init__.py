"""Server optimizers: sgd, momentum and adam (``optim/optimizers.py``)."""
from repro_torch.optim.optimizers import Optimizer, adam, make_optimizer, momentum, sgd

__all__ = ["Optimizer", "sgd", "momentum", "adam", "make_optimizer"]
