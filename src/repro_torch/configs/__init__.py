"""The model zoo's configurations (counterpart of ``repro/configs/``):
the ten architectures, full and reduced, field for field."""
