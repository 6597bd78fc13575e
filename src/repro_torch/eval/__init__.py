"""Held-out evaluation (counterpart of ``repro/eval/``)."""
