"""Re-exports of the federated trainer's public names (counterpart of
``repro/fed/loop.py``, the reference's shim for call sites of its former
monolith). New code imports from the submodules:

    from repro_torch.fed.config import FedConfig
    from repro_torch.fed.trainer import FedTrainer
"""
from repro_torch.fed.config import STAGINGS, SUBSAMPLINGS, FedConfig
from repro_torch.fed.engine import engine_names
from repro_torch.fed.trainer import FedTrainer

ENGINES = engine_names()  # populated by fed/engines.py via the trainer's import

__all__ = ["FedConfig", "FedTrainer", "ENGINES", "STAGINGS", "SUBSAMPLINGS"]
